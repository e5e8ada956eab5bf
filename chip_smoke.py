"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one CUDA card (an
H100: the kernels are built for sm_90a).  Every phase raises on failure and
the script then exits non-zero; without a card, or outside the repository,
it exits non-zero before printing any result.

1. card: its name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every ``shgvqa_tpu_torch/csrc/*.cu``, one nvcc each, in parallel,
   with ptxas's registers and spills of every kernel; a spill in a
   bottleneck, FFN-train, out_ln or tokenizer conv kernel fails the run;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths give it, with its time, the plain version's
   time and the bound.  Every kernel, library and yardstick time is the
   median [min-max] of 3 turns of 20 calls (CUDA events; the attention
   kernels' and SDPA's 10 calls a turn); a plain version is timed in one
   turn:
   - the FFN forward (the FFN-train forward's chain of
     ``csrc/ffn_train.cu`` at rate 0; and its autograd backward at a small
     shape), beside a composite-of-library-calls yardstick: two calls on
     the same inputs bit-equal, its device time per call and per stage of
     the chain from torch.profiler;
   - both attention kernels at every attention site of the train step at
     B=2 and B=32: the forward and dQ, dK, dV at rate 0, and at the site's
     dropout rate with the kernels' own keep mask given to the plain
     version; the realised keep rate, and at one site per batch size the
     card's keep mask bit-equal to ``keep_mask_reference``, also at a
     data-parallel rank's group offset (rank 1 of 2) with the forward
     called as that rank against the plain version given that mask; the
     largest
     difference between two backward calls on the same inputs (dQ is
     summed with atomics); the kernels and SDPA with the same additive
     mask (timed only) each at rate 0 and at the site's rate, forward and
     backward, and the kernels' device time per call from torch.profiler;
   - both FFN train kernels (forward and backward, ``csrc/ffn_train.cu``)
     at every FFN site's shape of the train step (M = B * L, L in 40, 177,
     393) at B=2 and B=32: y and every gradient against autograd of the
     plain version at rate 0, and at rate 0.1 with the kernels' own keep
     mask given to the plain version; the realised keep rate; at the
     smallest shape the keep mask bit-equal to ``keep_mask_reference`` at
     row offset 0 and at a data-parallel rank's (rank 1 of 2), the kernels
     called as that rank against the plain version given that mask; two
     forward calls on the same inputs bit-equal at each rate, the
     forward's h
     bit-equal to the backward's recompute, and two backward calls
     bit-equal in all six outputs; the times of the kernels, of the
     weight-gradient products after the backward kernels, of the plain
     version and of the unfused yardstick, and the kernels' device time
     per call and per stage of each chain from torch.profiler;
     ``cuobjdump -sass`` of the built library must list HGMMA (wgmma)
     instructions in each of the two chains' five product kernels;
   - the tokenizer conv kernel (``csrc/tok_conv.cu``) at both convs'
     shapes and the bottleneck kernel (``csrc/bottleneck.cu``) at ragged
     frames and at its three trunk geometries (res_2 block_0 with its
     projection, res_2, res_3), at B=2 and B=32: kernel against plain
     within 2e-2 of max |plain|, the times of the kernel and its device
     time per call, the plain version and a yardstick (F.conv3d in bf16 +
     gelu; the unfused bf16 Bottleneck3D) and the bound; the tokenizer
     conv also at two ragged shapes, two of its calls on the same inputs
     bit-equal; HGMMA instructions in both kernels;
   - the attention-output kernel (``csrc/out_ln.cu``, a cluster per row
     tile) at every AttOutput site's shape (M = B * L, L in 40, 177, 393)
     at B=2 and B=32 and at two ragged M within 3e-2 * max(1, |ref|) of
     ``out_ln_reference`` (and its autograd backward at a small shape),
     two calls on the same inputs bit-equal, the wrapper's plan mirror
     (``out_ln_plan``) equal to the kernel's own, with the times of the
     kernel (events, and its device time per call from torch.profiler),
     the plain version and the unfused yardstick (F.linear, add,
     F.layer_norm) and the bound; HGMMA instructions in the kernel;
   - the head-sliced attention (the attention forward kernel of
     ``csrc/attention.cu`` on the (B, L, 768) projections' strides) at
     every attention site's shape at B=2 and B=32 within 2e-2 of max |ref|
     of ``headsliced_reference`` and bit-equal to the transpose path (the
     same kernel on (B, H, L, 64) views of the same projections), with the
     times of the kernel, the plain version, the transpose path and SDPA
     with the same additive mask (timed only), the kernel's device time per
     call from torch.profiler, and the bound; then the prototype's own A/B
     (``tools/proto_headsliced_attn.py``): B=64, (40, 40), (393, 393),
     (128, 393), a 10% key mask, the max error between the two paths and
     both times, one line per shape;
   - the global matcher's kernel (``csrc/matcher.cu``) at (B, 128, 128)
     and (B, 48, 48), B=32 and 8, costs from seeded logits and labels
     compacted as the set loss compacts them, a batch of ties and one with
     zero targets, one problem at the kernel's largest n: row_to_col and
     the search steps bit-equal to the plain version on the host's copy,
     the total cost within 1e-5 of scipy's; one column more raises naming
     the limit; the kernel's time (events and device), the plain
     version's on the card at B=8 (one turn, bit-equal to the host's),
     scipy on the host with the copy to it (the yardstick), and the
     bound: the longest
     problem's search steps, each a reduction of ceil(log2(n + 1))
     dependent compares of 4 cycles at the card's highest SM clock, or the
     bytes if more;
4. main path: ``entry.entry()`` -- the flagship uint8 frames -> hg_logit
   forward at B=2 -- with every launch count set to 0 just before and read
   just after: with the FFN kernel (18 launches), with no kernel, with
   the FFN, tokenizer and bottleneck kernels (18 + 2 + 6), with the FFN
   and the attention forward at every site (``--pallasAttention``: 18 +
   38), and with the FFN, out_ln and head-sliced kernels (18 + 18 + 38);
   each kernel path's hg_logit against the plain one;
5. throughput: clips/s at B=32 with the FFN kernel, with no kernel, with
   the FFN, tokenizer and bottleneck kernels, with the FFN and attention
   kernels, and with the FFN, out_ln and head-sliced kernels, in turns;
6. train main path: ``entry.train_entry()`` -- three flagship train steps
   at B=32 with the trunk frozen and the tokenizer and bottleneck switches
   on -- with the launch counts set to 0 before each step and read after
   it (38 attention forwards, 34 backwards, 0 FFN, 0 tokenizer, 6
   bottleneck); finite losses; the trainable parameters move, the trunk
   and the disconnected LXRT x-layers and pooler stay bit-identical; the
   eval step at B=2 (18 FFN, 2 tokenizer and 6 bottleneck launches, no
   attention launch); then, with every dropout rate at 0, the attention
   kernels against the plain attention and the FFN train kernels against
   the unfused FFN (loss and gradient norm); the switches off again.
   Then ``entry.train_entry(published=True)``, the published AGQA recipe
   (the trunk trained, RandAugment on the card): three train steps at B=32
   with the same switches on (38 attention forwards, 34 backwards, 0 FFN,
   0 tokenizer, 0 bottleneck: a block whose gradient is required runs its
   convs); finite losses; the trunk's conv weights and BatchNorm weights
   and biases move, its BatchNorm statistics and the LXRT x-layers and
   pooler stay bit-identical; two augmentations from one seed bit-equal;
   then, at dropout 0 without augmentation, the attention kernels against
   the plain attention with the trunk trained;
7. train throughput: clips/s at B=32 with the attention kernels and with
   the plain attention, then with the FFN train kernels and with the
   unfused FFN (in turns), and the steps' splits; then the frozen step and
   the published recipe's step in turns, the published step's split
   (augment, trunk, rest of the forward, losses, backward with the
   trunk's share, optimizer), each step's resident and peak device memory
   (``torch.cuda.max_memory_allocated``) and host syncs, the top kernels
   of a published step and of the trunk's backward alone, and the
   tokenizer convs' forward, input gradient and weight gradient alone;
7b. steps per loop (``--stepsPerLoop``, ``train/graph.py``) with the
   attention kernels, the FFN train kernels and the block switch, (a)
   the trunk frozen (phase 6's train model), (b) the published recipe (a
   fresh one: phase 7's timed steps can leave the random one NaN): at B=8,
   from one saved state (the optimizer restarted) and
   generator seed, 8 single eager steps six times, then four times 8
   steps as 4-step chunks (the first eager, the second captured into a
   CUDA graph and replayed): every loss finite; in the per-step losses
   and in the parameters, the median of the graph runs' distances to the
   eager runs at most 2x the median distance between two eager runs
   (1e-6 relative where eager repeats closer, bit-equal where it repeats
   bit-equal); their generator states bit-equal; the launch counts of
   each capture 4x a step's (38, 34, 0, 18, 14, 0, 6 or 0, 0, 0, 0,
   0); no host sync in a
   replayed chunk; then train clips/s at k=1 and k=4 in turns (frozen and
   published at B=32), each one's device busy share
   (torch.profiler tracing the card, 2 eager steps and one replay), peak
   and reserved memory and host syncs, and the
   published augmentation's device ms on the sub-batch path, the select
   tree and the fixed-capacity path (bit-equal), then the fixed-capacity
   path captured into a CUDA graph (its overflow branches as conditional
   nodes) and replayed on draws under every capacity and on draws over
   them, each bit-equal to the select tree, with the replay's ms.  After
   phase 9, the driver at the published
   flags with ``--pallasFFNTrain --stepsPerLoop 2 --multiGPU`` (on one
   card a process group of one on NCCL: phase ddp (a)) on 96 synthetic
   clips at B=32 for two epochs (3 steps each: a chunk and a single step):
   finite losses at 6 steps, one capture and one replay, 6 steps'
   training launches and two eval forwards', 5 all-reduces a step and 4
   an eval forward, 10 inside the captured chunk, the reserved memory
   after the eager chunk and after the capture and replay, LAST reloaded
   bit-equal, ``--test --multiGPU`` from it with oracle 1.0;
8. the driver: ``cli.agqa_hgqa.main`` at the published flags (no
   ``--freezeBackbone``, ``--augmentType rand_aug``) with
   ``--pallasFFNTrain`` at B=32 on synthetic data under a temporary
   directory, its trunk loaded through ``--backboneWeights`` from the
   file phase 9 writes first (a trunk with BatchNorm statistics calibrated
   on a synthetic batch, as the pretrained trunk the recipe loads): two
   epochs with the launch counts set to 0 before each train
   step and eval forward and read after it (38 attention forwards, 34
   backwards, 18 FFN train forwards, 14 backwards, 0 FFN per train step;
   18 FFN and nothing else per eval forward), finite losses, CURRENT and
   LAST written and LAST reloaded bit-equal; then ``--test`` from
   ``--load LAST`` (oracle score 1.0, the predict files), and again with
   ``--pallasAttention`` (38 attention forwards and 18 FFN per eval
   forward);
9. weights (written before phase 8, which reads the trunk file), at full
   width and depth: one flagship model (its trunk's BatchNorm statistics
   calibrated) written as pytorchvideo's ``SLOW_8x8_R50.pyth``
   (``model_state``, a ``blocks.5`` head) and converted by
   ``python -m shgvqa_tpu_torch.utils.convert_slow_r50``'s ``main``, as a
   reference ``BEST.pth`` (``module.`` prefixes, the x-layers' aliases,
   unread cross variants), as the port's own LAST, and its language tower
   as bert-base's ``pytorch_model.bin`` (12 layers, ``gamma``/``beta``,
   ``bert.``); then the trunk file through ``Trainer.load_backbone``
   bit-equal; ``--test --load <dir>/BEST`` (extensionless) and ``--load``
   of LAST, plain and with ``--pallasAttention``: the driver's state
   bit-equal, identical ``predict.json`` and ``predict_hg.json``, 18 FFN
   (38 attention + 18 FFN) launches per eval forward, the import's seconds
   on the host and to the card and its tensor count; one driver epoch
   without ``--fromScratch`` (embeddings + 5 layers loaded, the pooler
   skipped, finite losses); three B=8 flagship train steps with each of
   ``--optim adam|adamax|rms|sgd`` (finite losses, the trainable tensors
   move, the rest do not);
9b. STAR, after the weight files: ``cli.star.main`` at README.md's STAR
    flags with ``--noCaps --stepsPerLoop 2`` at B=8 on 128 synthetic
    questions (32 of the Interaction type: four steps an epoch) and 16
    valid, the trunk from ``--backboneWeights``, two epochs: the launches
    of every train step run on the host (38 attention forwards, 34
    backwards, 2 matcher) and of each valid forward (18 FFN, 2 matcher),
    one capture and three replays, finite losses, LAST reloaded bit-equal;
    with an hg mask that is not a prefix and with the mask all ones,
    ``--pallasAttention`` and the head-sliced switch against the plain
    path (hg_logit) and the training kernels against the plain attention
    (the training forward's hg_logit and the gradients, dropout 0, on one
    matching), each nearer the masked plain run than the unmasked one,
    moved by the mask, and every hg_logit within half the mask's effect
    of the masked plain run; the loss within 5e-2;
    ``--test`` from LAST (oracle 1.0, ``by_qtype``, both predict files),
    plain and with ``--pallasAttention``;
9c. the AGQA ablations, after STAR: ``cli.agqa_q.main`` (``--taskQ
    --llayers 5 --stepsPerLoop 2``) and ``cli.agqa_vqa.main`` (the
    published flags with ``--taskVQA --pallasFFNTrain``, the trunk from
    ``--backboneWeights``) at B=8 on 32 synthetic clips and 16 valid for
    one epoch: the launches of every train step run on the host (q: 5
    attention forwards and backwards; vqa: 14 attention and 14 FFN-train
    forwards and backwards) and of each valid forward (5 or 14 FFN), for q
    one capture and one replay, finite losses, LAST reloaded bit-equal;
    ``--test`` from LAST (oracle 1.0, both predict files), plain and with
    ``--pallasAttention``; then the head model (``ShgVqaModel`` on random
    trunk features) of 'vhga', 'hgvqa', the 'self', 'cross_self' and 'old'
    layers, untied x-layers, ``--GTHG``, ``--afterCrossAttnFeats`` and
    ``--linearCls`` at flagship widths in bf16, B=8: eval forwards plain,
    with the FFN kernel and with ``--pallasAttention`` (within 5e-2 of the
    plain path; the launch counts), at dropout 0 the attention kernels
    against the plain attention and the FFN-train kernels against the
    unfused FFN (the loss within 5e-2; the gradient vector within 5e-2 or,
    where bf16 moves it further, within 2x the plain bf16 path's distance
    to the f32 plain path of both), the launch counts, the parameters with
    a gradient exactly the connected ones; two optimizer
    steps (the launch counts; outside the trainable mask bit-identical,
    the rest moved); the flagship's head first, as their baseline.  Phase 3 also holds
    both attention kernels to the plain version at the shapes only these
    models give: the joint [visn; lang] sequences of 'self' (433 and 217
    tokens) under their joint key row and the deaf language mask (every
    key masked) at the language, LXRT-cross and HG-cross shapes, B=8 and
    32, with their device time and bound at B=32;
caps. the capsule encoder, after phase quant: ``cli.star.main`` at
    README.md's STAR flags as printed (no ``--noCaps``: 16 frames, 785
    visual tokens, 32 capsules of 4 x 4 by EM routing, no x-layers) with
    ``--stepsPerLoop 2`` at B=8 on 128 synthetic questions (32
    Interaction) and 16 valid for one epoch, the trunk from
    ``--backboneWeights``: the launches of every train step run on the
    host (34 attention forwards, 34 backwards, 2 matcher) and of the valid
    forward (14 FFN, 2 matcher), one capture and one replay, finite
    losses, LAST reloaded bit-equal, ``--test`` from it (oracle 1.0; 14
    FFN, or 34 attention + 14 FFN with ``--pallasAttention``, a forward);
    readings with no limit: EM routing's device ms forward and backward at
    STAR's B=8 and AGQA's B=32, the peak memory of a capsule STAR B=8 and
    AGQA B=32 step, capsule STAR against no-caps STAR in B=8 clips/s, in
    turns; then the head models of capsules, capsules with
    ``--crossAttn``, ``--sharedWeights`` and ``--vitInit`` at flagship
    widths in bf16, B=8, through phase 9c's checks.  Phase 3 also holds
    both attention kernels to the plain version at the capsule encoder's
    shapes: 785 x 785 under a key row, the decoders' 128 x 785 and 48 x
    785 and ``--crossAttn``'s 40 x 785 and 785 x 40, B=8 and 32, with
    their device time and bound at B=32;
trunks. the other video trunks, after phase caps: (a) resnext101 and
    slowfast_r50/r101 on 16 frames, mvit_B and video_swin_impl on 32 (they
    halve time), at full width in bf16, frozen, B=2: the features' shape
    (the trunk's steps, side and channels) and finite values; the same
    topologies at TOY widths in f32, card against CPU within 1e-4 x max
    |CPU|; readings with no limit: device ms a forward at B=8 and its peak
    memory; (b) the tokenizer conv at slowfast's (B, 16, 8, 8, 2304) and
    (B, 12, 8, 8, 768) and the bottleneck at slowfast's slow res_2 and
    res_3 blocks (4 frames a clip), B=8 and 2, against their plain
    versions as in phase 3, with device time and bound; a slowfast_r50
    trunk with the block switch: 5 bottleneck launches a forward, its
    features within 2e-2 x max |ref| of the switch off; (c) ``agqa_hgqa
    --test --backbone slowfast_r50`` on PNG frames of 480 x 360 on disk
    (16 questions, eval B=8) under the default ``--frameLoader auto``: its
    weights a checkpoint whose trunk came through
    ``utils/convert_slowfast``'s CLI; every clip through the native
    decoder where it builds on the host (else PIL with JAX's notice, as
    JAX's rule takes), 18 FFN launches an eval forward, oracle 1.0;
    readings: the loader's clips/s beside the forward's; (d) ``--patches``: the
    flagship head on patches at B=8 through phase 9c's checks (38 / 34
    attention, 18 FFN, 18 / 14 FFN-train launches);
10. the plain path, then two plain train steps, on the card against the
    CPU at tiny size in f32: the flagship task, 'q', 'vhga', 'hgvqa' and
    the 'cross_self' layers (the int8 trunk's case runs in phase quant);
    it runs inside phase ddp, while (b)'s ranks start;
quant. the int8 frozen trunk (``--quantBackbone int8``, after phase 9d,
    the weight files written for its driver): the qconv kernel
    (``csrc/qconv.cu``) bit-equal to ``qconv_reference`` on the operands
    of every one of the flagship trunk's 23 conv cases (27 with their
    epilogues) of a B=2 forward, at three ragged launches and with an
    all-zero scale, two calls bit-equal; its SASS with warpgroup MMA in
    the s8 form (IGMMA) and no IMMA (mma.sync); the int8 trunk's kernel path
    bit-equal to its plain path at B=2; per trunk forward at B=2 and
    B=32 the 52 launches' time (events median [min-max], device), the
    plain version's, ``torch._int_mm`` on the 1x1 stride-1 convs and
    cuDNN bf16 ``F.conv3d`` of the 52 convs (the yardstick) and the
    bound (int8 operations over 1,979 TOP/s or the bytes the taps read
    and write over 3.35 TB/s, per launch); at B=32 the trunk's device time
    in int8, bf16 and bf16 with the block switch, the int8 trunk's device
    time by stage (stem, quantize and pool, weight quantization and the
    rest, qconv), the int8 features against bf16 (relative
    Frobenius, max and mean error of max |ref|); ``entry.entry
    (quant_backbone="int8")`` at B=2 (18 FFN + 52 qconv launches); the
    flagship with the int8 trunk against bf16 at B=32 (hg_logit argmax
    agreement, inference clips/s in turns, a forward's peak memory with
    ``--backboneChunks`` 4 and 1, and a training forward's frames path
    with rand_aug and aug_mix at 4 and 1 and augmented whole with the
    trunk in 4 chunks); a frozen int8 train step at B=8 as
    2-step chunks of the k-step graph (2 x (38, 34, 52) launches while
    eager and while capturing, one capture, 0 host syncs in a replay);
    the ``agqa_hgqa`` driver at the published flags + ``--quantBackbone
    int8 --backboneChunks 2 --stepsPerLoop 2``, B=8, 32 synthetic clips,
    the trunk from ``--backboneWeights``: per step 38 / 34 attention, 18 /
    14 FFN train and 104 qconv launches, finite losses, the scales equal
    to a calibration of the loaded trunk on the example batch, LAST
    reloaded bit-equal with them, ``--test`` from it (18 FFN + 52 qconv
    per forward, + 38 attention with ``--pallasAttention``; oracle 1.0);
    phase 10's int8 case: a tiny f32 model, the card's kernel path
    against the CPU's plain path at quant-step granularity;
ddp. data parallelism (``parallel/``), after quant; NCCL refuses two
    ranks on one device, so: (a) the frozen flagship at B=8, 4 steps as
    2-step chunks of the k-step graph, three runs under an NCCL group of
    one and three without (the normalizers' and the gradient sum's
    all-reduces captured), held by phase 7b's spread rule, then the
    all-reduce's ms and B=8 clips/s with and without the group in turns
    (readings); (a)'s driver run is phase 7b's; (b) two gloo ranks on
    the one card (spawned processes, ``ddp_rank``) against one process:
    frozen-trunk steps of the flagship at B=16 global, dropout 0.1, 38 /
    34 attention launches and 5 all-reduces a step in each rank, the
    ranks' parameters bit-equal after two steps, the loss and gradient
    norm within 5e-2 of one process's, a merged ``predict`` covering the
    16 questions once, hg_logit within 5e-2 of one process's forward;
pretrain. LXMERT pretraining (after phase trunks; ``--only pretrain``):
    (a) ``cli.pretrain`` at the flagship's widths (bf16, ``--noCaps``, 5/2/5
    layers), all five tasks, B=32, 64 synthetic items, 2 epochs, plain and
    with ``--pallasFFNTrain``: 14 / 14 attention launches a step (and 14 /
    14 FFN-train), finite losses with JAX's keys, ``Epoch01_LXRT`` and the
    QA head file bit-equal to the model; readings: each step's ms
    (events), the peak memory, each batch's host seconds; (b) the
    snapshot into ``agqa_hgqa`` at the published flags with
    ``--loadLXMERTQA --remat --stepsPerLoop 2``, B=8, 32 clips: the encoder
    bit-equal to the snapshot after the load, ``logit_fc.fc2``'s rows and
    counts ``answer_head_surgery``'s, one capture and one replay, finite
    losses; (c) a tiny pretraining model in bf16 with the kernels against
    the CPU's f32 plain path at dropout 0 (loss and gradient within 5e-2);
remat. ``--remat`` (``--only remat``): a frozen-trunk flagship step at B=8
    with the sites' dropout and the FFN-train kernels, twice without remat
    and once under each policy from one generator state: 38 / 34 attention
    and 18 / 14 FFN-train launches, + 30 attention forwards under '',
    ``dots``, ``dots_batch`` (none under ``dots_attn``) and + 10 FFN-train
    forwards under each; the generator's state equal; loss and gradient by
    phase 7b's rule; the driver with ``--remat --stepsPerLoop 2`` when run
    alone (else pretrain's (b)); readings: the published B=32 step's peak
    memory and ms without remat, with '' and ``dots``;
tp. tensor parallelism (``--modelParallel``, after ddp; ``--only tp``):
    two gloo ranks on the one card (dp1 x mp2; NCCL refuses two ranks on
    one device), started while phase 10 runs, each the frozen flagship at
    B=8 split by JAX's rules: (a) one forward and backward on the default
    kernels and on the FFN-train kernels at the sites' dropout rates,
    against one process here: a rank's launches one process's at 6 of 12
    heads, its model collectives ``TP_STEP_COLLECTIVES``, the gathered
    gradients bit-equal across the ranks, the loss and gradient within
    bf16's own distance on the step; (b) the attention kernels at a rank's
    heads (the keep mask bit-equal to the one-process mask's heads and to
    ``keep_mask_reference``) and the split FFN chain against the one-call
    chain and the plain version; (c) a ``--test`` forward (18 split FFN
    chains) and ``Trainer.predict`` against one process; readings: a
    rank's step ms, the collectives' share;
11. the card line, one ``{"kernels": [...]}`` line (eleven kernels), the
    phases' seconds, and last ``{"ok": true, "device": {...}}``.

Launch counts are read as a tuple of eleven: (attention forward, attention
backward, FFN, FFN train forward, FFN train backward, tokenizer conv,
bottleneck, out_ln, head-sliced attention, matcher, int8 conv).

TF32 is switched off for f32 matmuls and convolutions (phase 10 compares
f32 results).  ``bound_ms`` is max(operations / 989 TFLOP/s bf16, bytes /
3.35 TB/s): the H100 SXM's published dense peaks, each input read once and
each output written once.  ``--only attention`` (``--only ffn_train``,
``--only tok_block``, ``--only out_ln_headsliced``) runs phases 1-2 and the
attention (FFN train; tokenizer conv and bottleneck; out_ln and head-sliced
attention) checks of phase 3, ``--only ffn`` those of the FFN, ``--only
weights`` phases 1-2, 8 and 9, ``--only steps_per_loop`` phases 1-2 and
7b (the weight files written for its driver run), ``--only matcher``
phases 1-2 and the matcher's checks of phase 3, ``--only star`` phases 1-2
and 9b (the weight files written for its trunk), ``--only tasks`` phases
1-2, the ablation shapes of phase 3, 9c (the weight files written for its
trunk) and the ablations' cases of 10, ``--only quant`` phases 1-2 and
phase quant (the weight files written for its driver), ``--only ddp``
phases 1-2, 7b's driver (the weight files written for it) and ddp,
``--only caps`` phases 1-2 and caps (the weight files written for its
trunk) with phase 3's capsule shapes, ``--only trunks`` phases 1-2 and
trunks, ``--only pretrain`` and ``--only remat`` phases 1-2 and that phase
(a calibrated trunk file written for its driver), ``--only tp`` phases
1-2 and tp, and prints no result lines.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import importlib.util
import io
import itertools
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from shgvqa_tpu_torch import entry
from shgvqa_tpu_torch.cli import agqa_hgqa, agqa_q, agqa_vqa, common, star
from shgvqa_tpu_torch.cli import pretrain as pretrain_cli
from shgvqa_tpu_torch import breakdown
from shgvqa_tpu_torch.bench import (
    BATCH_SIZE,
    card_name_and_power_limit,
    chunked_step,
    clips_per_second,
    count_host_syncs,
    time_ms,
    time_spread,
    train_clips_per_second,
    train_memory_gib,
    train_split_ms,
)
from shgvqa_tpu_torch.configs.config import (
    tiny_test_config,
    torch_dtype,
    trunk_steps,
)
from shgvqa_tpu_torch.convert import is_quant_scale, to_jax_variables
from shgvqa_tpu_torch.data.featurize import situation_causal_mask
from shgvqa_tpu_torch.data import native_loader, synthetic, transforms
from shgvqa_tpu_torch.data.transforms import augment_clips, sample_rand_augment
from shgvqa_tpu_torch.kernels import _build, cond
from shgvqa_tpu_torch.kernels import qconv as qconv_mod
from shgvqa_tpu_torch.kernels.qconv import (
    max_pool_i8,
    qconv,
    qconv_reference,
    quant_sym,
)
from shgvqa_tpu_torch.kernels.bottleneck import (
    bottleneck_reference,
    fused_bottleneck,
)
from shgvqa_tpu_torch.kernels.attention import (
    attention_reference,
    decompose_mask,
    draw_seed,
    fused_attention,
    keep_mask,
    keep_mask_reference,
)
from shgvqa_tpu_torch.kernels import ffn as ffn_kernels
from shgvqa_tpu_torch.kernels.ffn import (
    ffn_reference,
    ffn_train_reference,
    fused_ffn,
    fused_ffn_train,
    fused_out_ln,
    keep_mask as ffn_keep_mask,
    keep_mask_reference as ffn_keep_mask_reference,
    out_ln_reference,
)
from shgvqa_tpu_torch.kernels.headsliced import (
    headsliced_attention,
    headsliced_reference,
)
from shgvqa_tpu_torch.kernels.tok_conv import (
    fused_tok_conv,
    tile_plan as tok_conv_plan,
    tok_conv_reference,
)
from shgvqa_tpu_torch.models import backbones_extra
from shgvqa_tpu_torch.models import mvit as mvit_mod
from shgvqa_tpu_torch.models import video_swin as video_swin_mod
from shgvqa_tpu_torch.models.backbone import (
    GEOMETRY_TRUNKS,
    Bottleneck3D,
    FrozenBatchNorm,
    SlowR50,
    calibrate_frozen_bn,
    calibrate_quant,
    make_backbone,
    set_block_kernel,
)
from shgvqa_tpu_torch.models.layers import (
    FFN,
    Dropout,
    extend_mask,
    gelu,
    init_weights,
    set_attention_kernel,
    set_attention_kernel_eval,
    set_dropout_rate,
    set_ffn_train_kernel,
    set_headsliced_kernel,
    set_out_ln_kernel,
)
from shgvqa_tpu_torch.losses import set_prediction
from shgvqa_tpu_torch.losses.set_prediction import matched_target_grid
from shgvqa_tpu_torch.parallel import distributed, mesh
from shgvqa_tpu_torch.models.cross import _cat_masks
from shgvqa_tpu_torch.models.pretrain import (
    AnswerTable,
    LxmertPretrainModel,
    answer_head_surgery,
)
from shgvqa_tpu_torch.models.remat import POLICIES as REMAT_POLICIES
from shgvqa_tpu_torch.models.remat import set_remat
from shgvqa_tpu_torch.models.shgvqa import ShgVqaModel
from shgvqa_tpu_torch.models.visual import set_tok_kernel
from shgvqa_tpu_torch.ops import matcher
from shgvqa_tpu_torch.ops.matcher import hungarian_square
from shgvqa_tpu_torch.train import loop
from shgvqa_tpu_torch.train.graph import StepChunks
from shgvqa_tpu_torch.train.loop import Trainer
from shgvqa_tpu_torch.train.optimizer import PLAIN_OPTIMIZERS, make_optimizer
from shgvqa_tpu_torch.train.step import (
    compute_losses,
    connected_param_mask,
    make_eval_step,
    make_train_step,
    trainable_mask,
)
from shgvqa_tpu_torch.utils import convert_slow_r50, convert_slowfast
from shgvqa_tpu_torch.utils.flax_msgpack import msgpack_serialize

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
D, FF = 768, 3072
# FFN sites of one flagship forward, as (rows per clip, sites): language
# (5 layers + 2 cross steps + 2 HG-cross steps), visual (5 + 2), HG (2)
FFN_SITES = ((40, 9), (393, 7), (177, 2))
TOL = 3e-2                     # |y - ref| <= TOL * max(1, |ref|), bf16
H, HEAD_DIM, NUM_SITUATIONS = 12, 64, 16
# attention sites of one flagship train step: (site, Lq, Lk, mask, dropout
# rate, forward launches, backward launches).  The LXRT cross layers feed
# only the unsupervised `logit`, so their backward never runs.
ATTN_SITES = (
    ("language self", 40, 40, "key", 0.1, 5, 5),
    ("visual self", 393, 393, "key", 0.1, 5, 5),
    ("LXRT cross lang<-visn", 40, 393, "key", 0.1, 2, 0),
    ("LXRT cross visn<-lang", 393, 40, "key", 0.1, 2, 0),
    ("HG cross lang<-hg", 40, 177, "none", 0.1, 2, 2),
    ("HG cross hg<-lang", 177, 40, "key", 0.1, 2, 2),
    ("rel decoder self", 128, 128, "pane", 0.15, 5, 5),
    ("rel decoder cross", 128, 393, "none", 0.15, 5, 5),
    ("act decoder self", 48, 48, "pane", 0.15, 5, 5),
    ("act decoder cross", 48, 393, "none", 0.15, 5, 5),
)
# max |kernel - plain| <= tol * max |plain| (bf16 operands; the kernels
# round P and dS to bf16 where the plain version keeps f32)
ATTN_TOL, ATTN_GRAD_TOL = 2e-2, 3e-2
# train step, kernel vs plain attention at dropout 0: relative difference of
# the loss and of the gradients' global norm (bf16 through ~40 layers)
TRAIN_TOL = 5e-2
# hg_logit of a kernel path against the plain path, relative Frobenius
# (phase 4's limit; also the data-parallel predict's, phase ddp)
TOL_HG = 5e-2
# FFN sites of one flagship train step: (rows per clip, forward launches,
# backward launches).  The LXRT x-layers' FFNs (2 language, 2 visual) feed
# only the unsupervised `logit`, so their backward never runs.
FFN_TRAIN_SITES = ((40, 9, 7), (393, 7, 5), (177, 2, 2))
FFN_TRAIN_RATE = 0.1                   # the FFN's hidden_dropout
FFN_OPERANDS = ("x", "W1", "b1", "W2", "b2", "gamma", "beta")
# max |kernel grad - autograd of the plain version on f32 copies| <= tol *
# max |ref| (the kernels round do and du to bf16 before their products and
# the weight gradients to bf16)
FFN_GRAD_TOL = 3e-2
# the FFN train forward's and backward's chains in launch order, and their
# product kernels (wgmma)
FFN_FWD_STAGES = ffn_kernels.FWD_STAGES
FFN_BWD_STAGES = ffn_kernels.BWD_STAGES
FFN_PRODUCTS = ("ffn_fwd_u_kernel", "ffn_bwd_u_kernel", "ffn_o_kernel",
                "ffn_bwd_dh_kernel", "ffn_bwd_dx_kernel")
# tokenizer convs of one flagship forward: (site, T in, Ci); Co = 768, 7 x 7
# features, kernel (5, 3, 3)
TOK_SITES = (("conv1", 16, 2048), ("conv2", 12, D))
TOK_HW, TOK_KT = 7, 5
# trunk blocks the fused bottleneck covers in one flagship forward: (site,
# H = W, Ci, Cm, Co, projection, blocks); frames N = 16 * B
BLOCK_SITES = (("res_2 block_0", 56, 64, 64, 256, True, 1),
               ("res_2 blocks 1-2", 56, 256, 64, 256, False, 2),
               ("res_3 blocks 1-3", 28, 512, 128, 512, False, 3))
# max |kernel - plain| <= tol * max |plain| (bf16; the prototypes' own check)
TOK_BLOCK_TOL = 2e-2
# the flagship's published flags (README.md, agqa_hgqa: the trunk trained,
# RandAugment) with the FFN train kernels
DRIVER_FLAGS = ["--taskHGQA", "--noCaps", "--crossAttnType", "cross",
                "--llayers", "5", "--xlayers", "2", "--rlayers", "5",
                "--dlayers", "5", "--backbone", "slow_r50", "--fromScratch",
                "--LossHGPerFrame", "--augmentType", "rand_aug",
                "--pallasFFNTrain"]
# launches of a driver train step, and the eval modes of --test: (extra
# flags, launches per eval forward)
DRIVER_TRAIN_LAUNCHES = (38, 34, 0, 18, 14, 0, 0, 0, 0, 0, 0)
EVAL_MODES = (([], (0, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)),
              (["--pallasAttention"], (38, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)))
# the weight files of phases 8 and 9: their model's seed (not the driver's
# --seed, so an import that misses a tensor shows) and bert-base's depth
WEIGHTS_SEED = 7
BERT_LAYERS = 12


# turns of each event-timed reading (``spread``)
TIMING_TURNS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_SECONDS: dict = {}
_LAP = [time.perf_counter()]

def lap(name: str) -> None:
    """The seconds since the last lap (or the script's start) as phase
    ``name``'s, in ``PHASE_SECONDS``."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = round(now - _LAP[0], 1)
    _LAP[0] = now


def spread(name, fn, **kw):
    """{name: median ms, name + "_range": [min, max]} of ``time_spread``,
    ``TIMING_TURNS`` turns unless ``turns`` is given."""
    kw.setdefault("turns", TIMING_TURNS)
    med, (lo, hi) = time_spread(fn, **kw)
    return {name: med, name + "_range": [lo, hi]}


def bound_ms(flops, nbytes):
    """(ms, bound_by): the larger of operations over the bf16 peak and bytes
    over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ffn_bound(m: int, d: int = D, f: int = FF):
    flops = 4 * m * d * f
    nbytes = 2 * m * d * 2 + 2 * d * f * 2 + (f + 3 * d) * 4
    return bound_ms(flops, nbytes)


def ffn_operands(m: int, d: int = D, f: int = FF, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    return (randn(m, d).to(torch.bfloat16),
            (0.02 * randn(f, d)).to(torch.bfloat16), 0.02 * randn(f),
            (0.02 * randn(d, f)).to(torch.bfloat16), 0.02 * randn(d),
            1.0 + 0.1 * randn(d), 0.1 * randn(d))


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.float() - want.float()).abs()
    bad = err > TOL * want.float().abs().clamp(min=1.0)
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off by more "
                             f"than {TOL} * max(1, |ref|); max |err| "
                             f"{err.max().item()}")
    return err.max().item()


def phase_ffn_kernel(batch_sizes=(2, BATCH_SIZE)):
    """The fused FFN (the FFN-train forward's chain at rate 0) against
    ffn_reference at the main path's shapes (bf16), two calls bit-equal,
    its backward at a small shape, and its times: events, and the device
    time per call and per stage of the chain."""
    rows = {}
    max_err = 0.0
    with torch.inference_mode():
        for bsz in batch_sizes:
            for per_clip, _ in FFN_SITES:
                m = per_clip * bsz
                args = ffn_operands(m, seed=m)
                y = fused_ffn(*args)
                err = check_close(f"fused_ffn M={m}", y, ffn_reference(*args))
                if not torch.equal(y, fused_ffn(*args)):
                    raise AssertionError(f"fused_ffn M={m}: two calls on the "
                                         "same inputs differ")
                max_err = max(max_err, err)
                x, w1t, b1, w2t, b2, gamma, beta = args
                yard = (lambda: F.layer_norm(
                    x + F.linear(F.gelu(F.linear(x, w1t, b1.to(x.dtype))),
                                 w2t, b2.to(x.dtype)),
                    (D,), gamma.to(x.dtype), beta.to(x.dtype), 1e-12))
                bound, bound_by = ffn_bound(m)
                device, _, stages = device_ms(lambda: fused_ffn(*args),
                                              FFN_FWD_STAGES)
                rows[m] = dict(
                    M=m, **spread("kernel_ms", lambda: fused_ffn(*args)),
                    kernel_device_ms=device, stage_device_ms=stages,
                    rerun_bit_equal=True,
                    plain_ms=time_ms(lambda: ffn_reference(*args)),
                    **spread("yardstick_ms", yard), bound_ms=bound,
                    bound_by=bound_by, max_abs_err=err)
                log(f"fused_ffn {json.dumps(rows[m])}")
    # autograd backward at a small shape: recompute through ffn_reference
    ops = [a.detach().requires_grad_(True)
           for a in ffn_operands(64, 128, 256, seed=7)]
    grads = torch.autograd.grad((fused_ffn(*ops).float() ** 2).sum(), ops)
    refs = torch.autograd.grad((ffn_reference(*ops).float() ** 2).sum(), ops)
    for i, (g, r) in enumerate(zip(grads, refs)):
        check_close(f"fused_ffn backward grad {i}", g, r)
    log("fused_ffn backward ok (M=64, D=128, F=256)")
    return rows, max_err


def log_ffn_per_forward(rows, launches=18, cps=None):
    """The fused FFN's times per forward at B=32 and B=2 (each site's
    median times its launches, with the sums of the fastest and slowest
    turns), and its device time by stage of the chain."""
    sites = {b: [(n, rows[per_clip * b]) for per_clip, n in FFN_SITES]
             for b in (BATCH_SIZE, 2)}
    log(f"fused_ffn per forward ({launches} sites; the FFN-train forward's "
        "chain at rate 0; yardstick: F.linear/gelu/layer_norm in bf16; "
        "device: torch.profiler per call; no single library call computes "
        "this block): " + ", ".join(
            f"{k} {weighted_text(sites[b], k)} at b{b}"
            for k in ("kernel_ms", "kernel_device_ms", "plain_ms",
                      "yardstick_ms", "bound_ms")
            for b in (BATCH_SIZE, 2))
        + ("" if cps is None else f"; clips/s b{BATCH_SIZE} "
           f"{json.dumps(cps)}"))
    for b in (BATCH_SIZE, 2):
        if any(row["stage_device_ms"] is None for _, row in sites[b]):
            log(f"fused_ffn stages at b{b}: not measured")
            continue
        log(f"fused_ffn device ms per forward by stage at b{b} "
            "(torch.profiler): " + ", ".join(
                f"{stage} " + ms_text(sum(n * row["stage_device_ms"][stage]
                                          for n, row in sites[b]))
                for stage in FFN_FWD_STAGES))


def per_forward(rows, bsz, key):
    return sum(n * rows[per_clip * bsz][key] for per_clip, n in FFN_SITES)


def ffn_train_bound(m: int, backward: bool, d: int = D, f: int = FF):
    """(ms, bound_by) of one train-kernel call: 4 (forward) or 8 (backward)
    M*D*F products (the JAX cost estimates, ffn.py:290 and :337) over the
    bf16 peak, against its bytes over the memory rate: forward x, y, W1, W2
    and the f32 vectors; backward x, dy, dx, do (M, D), du, h (M, F), W1,
    W2 (bf16) and the f32 vectors, dgamma, dbeta."""
    if backward:
        flops = 8 * m * d * f
        nbytes = (4 * m * d + 2 * m * f + 2 * d * f) * 2 + (f + 4 * d) * 4
    else:
        flops = 4 * m * d * f
        nbytes = (2 * m * d + 2 * d * f) * 2 + (f + 3 * d) * 4
    return bound_ms(flops, nbytes)


def ffn_train_grads_vs_plain(tag, ops, y, dy, rate, keep):
    """Gradients of ``y`` (the kernels' output) at ``dy`` against autograd of
    ffn_train_reference on f32 copies with the same keep mask: the worst
    (max |err|, that over max |ref|) over dx, dW1, db1, dW2, db2, dgamma,
    dbeta."""
    grads = torch.autograd.grad(y, ops, dy, retain_graph=True)
    ref_ops = [o.detach().float().requires_grad_(True) for o in ops]
    ref = ffn_train_reference(*ref_ops, rate, keep)
    refs = torch.autograd.grad(ref, ref_ops, dy.float())
    errs = [rel_max_err(f"{tag} d{name}", gr, rr, FFN_GRAD_TOL)
            for name, gr, rr in zip(FFN_OPERANDS, grads, refs)]
    return max(e for e, _ in errs), max(r for _, r in errs)


def kernel_name(mangled: str) -> str:
    """The kernel's own name in a mangled symbol: the innermost (last
    starting) length-prefixed name ending in ``_kernel`` (the mangled symbol
    when it holds none).  An anonymous namespace's mangled name holds a hash
    of the source's path, whose digits can make an earlier, longer name
    that ends at the same ``_kernel``."""
    found = mangled
    for i in range(len(mangled)):
        digits = re.match(r"\d+", mangled[i:])
        if digits:
            start, n = i + digits.end(), int(digits.group())
            ident = mangled[start:start + n]
            if len(ident) == n and ident.endswith("_kernel"):
                found = ident
    return found


def ptxas_lines(name: str, text: str):
    """ptxas's registers and spills of each kernel in ``text`` (the -v
    output of building csrc/<name>.cu), one line each."""
    func = "?"
    for line in text.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)", line)
        if found:
            func = kernel_name(found.group(1))
        elif "registers" in line or "spill" in line:
            yield f"ptxas {name} {func}: {line.strip()}"


def sass_hgmma(name: str, kernels, op: str = "HGMMA", forbid=()):
    """The ``op`` instructions (warpgroup MMA: HGMMA for bf16 wgmma, IGMMA
    for its s8 form) of each of ``kernels`` in ``cuobjdump -sass`` of the
    built csrc/<name>.cu: {kernel: (count, the first such line)}; raises if
    one of them has none, or has an instruction named in ``forbid`` (e.g.
    IMMA, the mma.sync of the s8 tensor cores)."""
    lib = _build.build(name)[0][name]
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    found, current = {}, None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            current = kernel_name(func.group(1))
        elif current in kernels:
            for bad in forbid:
                if re.search(rf"\b{bad}\b", line):
                    raise AssertionError(
                        f"cuobjdump -sass {lib.name}: {bad} in {current}: "
                        + " ".join(line.split()))
            if re.search(rf"\b{op}\b", line):
                count, first = found.get(current, (0, " ".join(line.split())))
                found[current] = (count + 1, first)
    missing = [k for k in kernels if k not in found]
    if missing:
        raise AssertionError(f"cuobjdump -sass {lib.name}: no {op} "
                             f"instruction in {missing}")
    return found


def check_ffn_offset(tag, ops, dy, seed, keep, rate):
    """The FFN train kernels' keep mask (``keep``, drawn from ``seed`` at row
    offset 0) bit-equal to ``ffn_keep_mask_reference``; at a data-parallel
    rank's row offset (rank 1 of 2: the first global row M) the card's mask
    bit-equal to the reference there and to those rows of the global
    call's mask; the forward and backward kernels, called as that rank,
    against the plain version given that mask."""
    m = ops[0].shape[0]
    row0 = OFFSET_RANK * m
    ref0 = ffn_keep_mask_reference(seed, m, D, rate)
    got = ffn_keep_mask(seed, m, D, rate, row0=row0)
    whole = ffn_keep_mask(seed, OFFSET_WORLD * m, D, rate)
    if not (torch.equal(keep.cpu(), ref0)
            and torch.equal(got.cpu(), ffn_keep_mask_reference(
                seed, m, D, rate, row0=row0))
            and torch.equal(got, whole[row0:row0 + m])):
        raise AssertionError(f"{tag}: keep_mask differs from "
                             "keep_mask_reference at row offset 0 or "
                             f"{row0}, or from the global mask's rows")
    with as_rank(OFFSET_RANK, OFFSET_WORLD):
        g = torch.Generator(device="cuda").manual_seed(19)
        state = g.get_state()
        y = fused_ffn_train(*ops, rate, g)
    g.set_state(state)
    keep = ffn_keep_mask(draw_seed(g, ops[0].device), m, D, rate, row0=row0)
    e = check_close(f"{tag} rate {rate} at row offset {row0}", y,
                    ffn_train_reference(*ops, rate, keep))
    ge, _ = ffn_train_grads_vs_plain(f"{tag} rate {rate} at row offset "
                                     f"{row0}", ops, y, dy, rate, keep)
    log(f"{tag} keep_mask rate {rate}: bit-equal to keep_mask_reference at "
        f"row offset 0 and {row0} (rank {OFFSET_RANK} of {OFFSET_WORLD}) "
        f"and to the global call's rows; the kernels as that rank against "
        f"the plain version with that mask: forward {e:.3e}, gradients "
        f"{ge:.3e}")


def phase_ffn_train_kernels(batch_sizes=(2, BATCH_SIZE)):
    """Both FFN train kernels against the plain version at every main-path
    shape (M = B * L for L in 40, 177, 393): y and every gradient at rate 0,
    and at rate 0.1 with the kernels' own keep mask given to the plain
    version; the realised keep rate; two forward calls bit-equal at each
    rate, the forward's h bit-equal to the backward's, and two backward
    calls bit-equal; the times of the kernels, of the weight-gradient
    products after the backward kernels, of the plain version and of the
    unfused yardstick (F.linear, GeLU, dropout, layer_norm, and its
    autograd backward); the kernels' device time per call and per stage
    of each chain; both chains' products on wgmma (HGMMA in the SASS)."""
    for kernel, (count, first) in sass_hgmma("ffn_train",
                                             FFN_PRODUCTS).items():
        log(f"sass ffn_train {kernel}: {count} HGMMA instructions, e.g. "
            f"`{first}`")
    rows = {}
    max_err = {"fwd": 0.0, "bwd": 0.0}
    rate = FFN_TRAIN_RATE
    for bsz in batch_sizes:
        for per_clip, _, _ in FFN_TRAIN_SITES:
            m = per_clip * bsz
            tag = f"fused_ffn_train M={m}"
            ops = [a.detach().requires_grad_(True)
                   for a in ffn_operands(m, seed=1000 + m)]
            dy = torch.randn(m, D, device="cuda").to(torch.bfloat16)
            # rate 0
            y0 = fused_ffn_train(*ops, 0.0)
            e0 = check_close(f"{tag} rate 0", y0,
                             ffn_train_reference(*ops, 0.0, None))
            if not torch.equal(y0, fused_ffn_train(*ops, 0.0)):
                raise AssertionError(f"{tag}: two forward calls at rate 0 "
                                     "differ")
            g0, r0 = ffn_train_grads_vs_plain(f"{tag} rate 0", ops, y0, dy,
                                              0.0, None)
            # rate > 0: the seed the call draws is read back from a copy of
            # the generator's state, and the kernels' keep mask from it
            gen = torch.Generator(device="cuda").manual_seed(m)
            state = gen.get_state()
            y1 = fused_ffn_train(*ops, rate, gen)
            gen.set_state(state)
            if not torch.equal(y1, fused_ffn_train(*ops, rate, gen)):
                raise AssertionError(f"{tag}: two forward calls at rate "
                                     f"{rate} differ")
            gen.set_state(state)
            keep = ffn_keep_mask(draw_seed(gen, ops[0].device), m, D, rate)
            kept = keep.float().mean().item()
            sigma = math.sqrt(rate * (1 - rate) / keep.numel())
            if abs(kept - (1 - rate)) > 6 * sigma:
                raise AssertionError(f"{tag}: keep rate {kept} vs {1 - rate}"
                                     f" (6 sigma {6 * sigma})")
            e1 = check_close(f"{tag} rate {rate}", y1,
                             ffn_train_reference(*ops, rate, keep))
            g1, r1 = ffn_train_grads_vs_plain(f"{tag} rate {rate}", ops, y1,
                                              dy, rate, keep)
            if m == FFN_TRAIN_SITES[0][0] * batch_sizes[0]:
                gen.set_state(state)
                check_ffn_offset(tag, ops, dy, draw_seed(gen, ops[0].device),
                                 keep, rate)
            max_err["fwd"] = max(max_err["fwd"], e0, e1)
            max_err["bwd"] = max(max_err["bwd"], g0, g1)

            # times
            x2, w1t, b1, w2t, b2, gamma, beta = (o.detach() for o in ops)
            seed = draw_seed(gen, x2.device)
            fwd = ffn_kernels._fwd_buffers(m, D, FF, x2.device)
            ffn_kernels._launch_train_fwd(x2, w1t, b1, w2t, b2, gamma, beta,
                                          seed, rate, 1e-12, fwd)
            spills = ffn_kernels._launch_train_bwd(
                x2, w1t, b1, w2t, b2, gamma, seed, rate, 1e-12, dy)
            # the forward's h is the backward's recompute, bit for bit
            if not torch.equal(fwd["h"], spills[3]):
                raise AssertionError(f"{tag}: the forward's h and the "
                                     "backward's differ")
            del fwd
            # nothing in the backward's chain sums with atomics
            again = ffn_kernels._launch_train_bwd(
                x2, w1t, b1, w2t, b2, gamma, seed, rate, 1e-12, dy)
            if not all(torch.equal(a, b_) for a, b_ in zip(spills, again)):
                raise AssertionError(f"{tag}: two backward calls on the same "
                                     "inputs differ")
            del again
            plain_out = ffn_train_reference(*ops, rate, keep)
            hidden = F.linear(ops[0], ops[1], ops[2].to(torch.bfloat16))
            yard_out = F.layer_norm(
                ops[0] + F.dropout(F.linear(F.gelu(hidden), ops[3],
                                            ops[4].to(torch.bfloat16)), rate),
                (D,), ops[5].to(torch.bfloat16), ops[6].to(torch.bfloat16),
                1e-12)
            with torch.no_grad():
                timed = dict(
                    **spread("kernel_ms", lambda: fused_ffn_train(
                        *ops, rate, gen)),
                    plain_ms=time_ms(lambda: ffn_train_reference(
                        *ops, rate, keep)),
                    **spread("yardstick_ms", lambda: F.layer_norm(
                        x2 + F.dropout(F.linear(F.gelu(F.linear(
                            x2, w1t, b1.to(x2.dtype))), w2t,
                            b2.to(x2.dtype)), rate),
                        (D,), gamma.to(x2.dtype), beta.to(x2.dtype), 1e-12)),
                    **spread("bwd_kernel_ms",
                             lambda: ffn_kernels._launch_train_bwd(
                                 x2, w1t, b1, w2t, b2, gamma, seed, rate,
                                 1e-12, dy)),
                    **spread("wgrad_ms", lambda: ffn_kernels._weight_grads(
                        x2, spills[1], spills[2], spills[3])))
                (timed["kernel_device_ms"], _,
                 timed["fwd_stage_device_ms"]) = device_ms(
                    lambda: fused_ffn_train(*ops, rate, gen),
                    FFN_FWD_STAGES)
                (timed["bwd_kernel_device_ms"], _,
                 timed["bwd_stage_device_ms"]) = device_ms(
                    lambda: ffn_kernels._launch_train_bwd(
                        x2, w1t, b1, w2t, b2, gamma, seed, rate, 1e-12, dy),
                    FFN_BWD_STAGES)
            timed.update(
                bwd_plain_ms=time_ms(lambda: torch.autograd.grad(
                    plain_out, ops, dy, retain_graph=True)),
                **spread("bwd_yardstick_ms", lambda: torch.autograd.grad(
                    yard_out, ops, dy, retain_graph=True)))
            del spills, plain_out, yard_out, hidden
            bound, bound_by = ffn_train_bound(m, False)
            bwd_bound, bwd_bound_by = ffn_train_bound(m, True)
            rows[m] = dict(M=m, keep_rate=kept, err_fwd=max(e0, e1),
                           err_grads=max(g0, g1), rel_err_grads=max(r0, r1),
                           fwd_rerun_bit_equal=True, fwd_h_is_bwd_h=True,
                           bwd_rerun_bit_equal=True,
                           bound_ms=bound, bound_by=bound_by,
                           bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_bound_by,
                           **timed)
            log(f"fused_ffn_train {json.dumps(rows[m])}")
    return rows, max_err


def per_train_step(rows, bsz, key, backward=False):
    """Sum over the FFN sites of one train step of ``key``."""
    return sum((nb if backward else nf) * rows[per_clip * bsz][key]
               for per_clip, nf, nb in FFN_TRAIN_SITES)


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.3f} ms"


def weighted_text(sites, key) -> str:
    """``key`` summed over ``sites`` ((launches, row) pairs) as "x ms", and
    for a timed key with the sums of the sites' fastest and slowest turns,
    "x [lo-hi] ms"; "not measured" where a site has none."""
    if any(row[key] is None for _, row in sites):
        return "not measured"
    text = f"{sum(n * row[key] for n, row in sites):.3f}"
    if all(key + "_range" in row for _, row in sites):
        lo, hi = (sum(n * row[key + "_range"][i] for n, row in sites)
                  for i in (0, 1))
        text += f" [{lo:.3f}-{hi:.3f}]"
    return text + " ms"


def log_stages(rows):
    """One line per chain and batch size: the FFN train forward's and
    backward's device time per train step by stage of the chain
    (torch.profiler)."""
    for name, key, stage_names in (
            ("fused_ffn_train_fwd", "fwd_stage_device_ms", FFN_FWD_STAGES),
            ("fused_ffn_train_bwd", "bwd_stage_device_ms", FFN_BWD_STAGES)):
        backward = key.startswith("bwd")
        for bsz in (BATCH_SIZE, 2):
            stages = [rows[per_clip * bsz][key]
                      for per_clip, _, _ in FFN_TRAIN_SITES]
            if None in stages:
                log(f"{name} stages at b{bsz}: not measured")
                continue
            log(f"{name} device ms per train step by stage at b{bsz} "
                "(torch.profiler): " + ", ".join(
                    f"{stage} " + ms_text(sum(
                        (nb if backward else nf) * st[stage]
                        for (_, nf, nb), st in zip(FFN_TRAIN_SITES, stages)))
                    for stage in stage_names))


def attention_bound(b, lq, lk, key, pane, backward: bool, lse: bool = True):
    """(ms, bound_by) of one call: 4 (forward) or 10 (backward) products of
    g*Lq*Lk*64 (the JAX cost estimates, attention.py:247 and :277) over the
    bf16 peak, against its bytes (bf16 operands and results, f32 masks and
    logsumexp -- none for the head-sliced kernel, ``lse=False`` -- each read
    or written once) over the memory rate."""
    g, d = b * H, HEAD_DIM
    flops = (10 if backward else 4) * g * lq * lk * d
    operands = (2 * g * lq * d + 2 * g * lk * d) * 2        # q, o, k, v
    masks = (0 if key is None else b * lk * 4) + (0 if pane is None
                                                  else lq * lk * 4)
    nbytes = operands + masks + (g * lq * 4 if lse else 0)
    if backward:
        nbytes += (2 * g * lq * d + 2 * g * lk * d) * 2     # do, dq, dk, dv
    return bound_ms(flops, nbytes)


def attention_operands(b, lq, lk, kind, seed):
    """bf16 q, k, v (B, H, L, 64) as views of (B, L, H, 64) buffers (the
    model's layout) and the site's additive mask: a key row with the last
    keys of every other clip masked by -10000, the situation-causal -inf
    pane, or none."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(length):
        return torch.randn(b, length, H, HEAD_DIM, generator=g,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)

    mask = None
    if kind == "key":
        valid = torch.ones(b, lk, device="cuda")
        valid[1::2, lk - max(1, lk // 5):] = 0.0
        mask = extend_mask(valid, torch.bfloat16)
    elif kind == "pane":
        slots = lq // NUM_SITUATIONS
        mask = torch.as_tensor(situation_causal_mask(NUM_SITUATIONS, slots),
                               device="cuda")
    return rand(lq), rand(lk), rand(lk), mask


def rel_max_err(name, got, want, tol):
    """(max |got - want|, that over max |want|), raising if it exceeds
    tol * max |want| or got is not finite."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-6)
    if not torch.isfinite(got.float()).all() or err > tol * scale:
        raise AssertionError(f"{name}: max |err| {err} > {tol} * max |ref| "
                             f"{scale}")
    return err, err / scale


def grad_errors(name, q, k, v, mask, rate, keep, out, do):
    """dQ, dK, dV of ``out`` (the kernels' output) at cotangent ``do``
    against autograd of the plain version on f32 copies: (max |err|, that
    over max |ref|) of the worst."""
    grads = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    q32, k32, v32 = (t.detach().float().requires_grad_(True)
                     for t in (q, k, v))
    ref = attention_reference(q32, k32, v32, mask, rate, keep)
    refs = torch.autograd.grad(ref, (q32, k32, v32), do.float())
    errs = [rel_max_err(f"{name} d{n}", gr, rr, ATTN_GRAD_TOL)
            for n, gr, rr in zip("qkv", grads, refs)]
    return max(e for e, _ in errs), max(r for _, r in errs)


def fwd_and_grads(q, k, v, mask, rate, generator, keep, tag):
    """The forward (at ``rate`` with ``generator``) and dQ, dK, dV against
    the plain version given ``keep``: (out, do, leaves, fwd (max |err|,
    rel), grads (max |err|, rel))."""
    leaves = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
    out = fused_attention(*leaves, mask, rate, generator)
    fwd = rel_max_err(f"attention fwd rate {rate} {tag}", out,
                      attention_reference(q, k, v, mask, rate, keep),
                      ATTN_TOL)
    do = torch.randn(out.shape, device="cuda").to(torch.bfloat16)
    grads = grad_errors(f"attention rate {rate} {tag}", *leaves, mask, rate,
                        keep, out, do)
    return out, do, leaves, fwd, grads


def device_ms(fn, own=(), calls: int = 10, tries: int = 3):
    """Device ms per call of ``fn`` from torch.profiler over ``calls`` + 1
    calls: (the kernels whose names hold one of ``own``, every kernel's,
    {name in ``own``: its kernels'}), each kernel's mean time times its
    launches per call.  The profiler can miss the first kernel of a session
    (so launches per call are rounded) or a whole session (so it tries
    again); (None, None, None) when ``tries`` traces hold no device time or
    ``own`` kernels do not launch once a call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls + 1):
                fn()
            torch.cuda.synchronize()
        mine = total = 0.0
        per_call = {name: 0 for name in own}
        each = {name: 0.0 for name in own}
        for evt in prof.key_averages():
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or not evt.count):
                continue
            n = round(evt.count / (calls + 1))
            ms = evt.device_time_total / evt.count * n / 1e3
            total += ms
            for name in own:
                if name in evt.key:
                    mine += ms
                    per_call[name] += n
                    each[name] += ms
        if total > 0.0 and all(n == 1 for n in per_call.values()):
            return mine, total, each
    log(f"profiler: launches per call {per_call}, {total} ms a call, after "
        f"{tries} traces")
    return None, None, None


# a data-parallel rank's dropout offset in phase 3's checks: rank 1 of 2,
# its first global row the local batch's size
OFFSET_RANK, OFFSET_WORLD = 1, 2


@contextlib.contextmanager
def as_rank(rank: int, world: int):
    """The wrappers see this process as ``rank`` of ``world`` (the draws'
    offsets only; no process group)."""
    saved = distributed.rank, distributed.world_size
    distributed.rank, distributed.world_size = (lambda: rank), (lambda: world)
    try:
        yield
    finally:
        distributed.rank, distributed.world_size = saved


def check_attention_offset(tag, q, k, v, mask, seed, rate):
    """At a data-parallel rank's group offset (rank 1 of 2: the first
    global row B, times H): the card's keep mask bit-equal to
    ``keep_mask_reference`` at that offset and to those groups of the
    global call's mask, and the forward kernel, called as that rank, within
    ATTN_TOL of the plain version given that mask."""
    b, _, lq, _ = q.shape
    lk = k.shape[2]
    group0 = OFFSET_RANK * b * H
    got = keep_mask(seed, b * H, lq, lk, rate, group0=group0)
    want = keep_mask_reference(seed, b * H, lq, lk, rate, group0=group0)
    whole = keep_mask(seed, OFFSET_WORLD * b * H, lq, lk, rate)
    if not (torch.equal(got.cpu(), want)
            and torch.equal(got, whole[group0:group0 + b * H])):
        raise AssertionError(f"{tag}: keep_mask at group offset {group0} "
                             "differs from keep_mask_reference or from the "
                             "global mask's groups")
    with as_rank(OFFSET_RANK, OFFSET_WORLD):
        g = torch.Generator(device="cuda").manual_seed(17)
        state = g.get_state()
        out = fused_attention(q, k, v, mask, rate, g)
    g.set_state(state)
    seed2 = draw_seed(g, q.device)
    keep = keep_mask(seed2, b * H, lq, lk, rate, group0=group0)
    _, err = rel_max_err(f"{tag} at group offset {group0}", out,
                         attention_reference(q, k, v, mask, rate,
                                             keep.view(b, H, lq, lk)),
                         ATTN_TOL)
    log(f"attention keep_mask {tag} rate {rate} at group offset {group0} "
        f"(rank {OFFSET_RANK} of {OFFSET_WORLD}): bit-equal to "
        f"keep_mask_reference and to the global call's groups; the forward "
        f"as that rank within {ATTN_TOL} of the plain version with that "
        f"mask (rel max err {err:.3e})")


# the site whose card keep mask is held bit-equal to keep_mask_reference,
# per batch size
KEEP_CHECK_SITES = {2: "visual self", BATCH_SIZE: "rel decoder self"}


def phase_attention_kernels(batch_sizes=(2, BATCH_SIZE)):
    """Both attention kernels against the plain version at every main-path
    shape: the forward and dQ, dK, dV at rate 0 and at the site's rate with
    the kernels' own keep mask fed to the plain version; the realised keep
    rate, and the card's keep mask bit-equal to keep_mask_reference at one
    site per batch size; the largest difference between two backward calls
    on the same inputs; the times (median [min-max] over 3 turns) of the
    kernels and of SDPA, each at rate 0 and at the site's rate, of SDPA's
    forward and backward in one call (10 calls a turn), of the plain version
    (one turn), and the kernels' device time per call from torch.profiler."""
    rows = {}
    max_err = {"fwd": 0.0, "bwd": 0.0}
    for bsz in batch_sizes:
        for i, (name, lq, lk, kind, rate, _, _) in enumerate(ATTN_SITES):
            q, k, v, mask = attention_operands(bsz, lq, lk, kind, 100 + i)
            key, pane = decompose_mask(mask, bsz, H, lq, lk)
            tag = f"{name} b{bsz} ({lq}, {lk})"
            out0, do0, leaves0, (e0, r0), (e3, r3) = fwd_and_grads(
                q, k, v, mask, 0.0, None, None, tag)
            # rate > 0: the seed the call draws is read back from a copy of
            # the generator's state, and the kernels' keep mask from it
            g = torch.Generator(device="cuda").manual_seed(7 + i)
            state = g.get_state()
            seed = draw_seed(g, q.device)
            g.set_state(state)
            keep = keep_mask(seed, bsz * H, lq, lk, rate).view(bsz, H, lq, lk)
            kept = keep.float().mean().item()
            sigma = math.sqrt(rate * (1 - rate) / keep.numel())
            if abs(kept - (1 - rate)) > 6 * sigma + 1e-9:
                raise AssertionError(f"{tag}: keep rate {kept} vs {1 - rate}"
                                     f" (6 sigma {6 * sigma})")
            if KEEP_CHECK_SITES[bsz] == name:
                want = keep_mask_reference(seed, bsz * H, lq, lk, rate)
                if not torch.equal(keep.view(bsz * H, lq, lk).cpu(), want):
                    raise AssertionError(f"{tag}: keep_mask differs from "
                                         "keep_mask_reference")
                log(f"attention keep_mask {tag} rate {rate}: bit-equal to "
                    f"keep_mask_reference ({keep.numel()} elements)")
                check_attention_offset(tag, q, k, v, mask, seed, rate)
            out, do, leaves, (e1, r1), (e2, r2) = fwd_and_grads(
                q, k, v, mask, rate, g, keep, tag)
            # two backward calls on the same inputs: dQ sums with atomics
            first = torch.autograd.grad(out, leaves, do, retain_graph=True)
            second = torch.autograd.grad(out, leaves, do, retain_graph=True)
            rerun = max((a.float() - b_.float()).abs().max().item()
                        for a, b_ in zip(first, second))
            max_err["fwd"] = max(max_err["fwd"], e0, e1)
            max_err["bwd"] = max(max_err["bwd"], e2, e3)

            # times: kernels and SDPA at rate 0 and at the site's rate, the
            # plain version at the site's rate
            plain_out = attention_reference(*leaves, mask, rate, keep)
            sdpa_mask = sdpa_additive_mask(bsz, lq, lk, key, pane)
            sdpa0 = F.scaled_dot_product_attention(*leaves0, sdpa_mask)
            sdpa1 = F.scaled_dot_product_attention(*leaves, sdpa_mask,
                                                   dropout_p=rate)

            def grad(y, xs, dy):
                return lambda: torch.autograd.grad(y, xs, dy,
                                                   retain_graph=True)

            fns = {
                "kernel0_ms": lambda: fused_attention(q, k, v, mask),
                "kernel_ms": lambda: fused_attention(q, k, v, mask, rate, g),
                "library0_ms": lambda: F.scaled_dot_product_attention(
                    q, k, v, sdpa_mask),
                "library_ms": lambda: F.scaled_dot_product_attention(
                    q, k, v, sdpa_mask, dropout_p=rate),
                "bwd_kernel0_ms": grad(out0, leaves0, do0),
                "bwd_kernel_ms": grad(out, leaves, do),
                "bwd_library0_ms": grad(sdpa0, leaves0, do0),
                "bwd_library_ms": grad(sdpa1, leaves, do),
                # SDPA forward and backward in one call, as a step runs them
                "fwd_bwd_library_ms": lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(*leaves, sdpa_mask,
                                                   dropout_p=rate),
                    leaves, do),
            }
            timed = {}
            for key_ms, fn in fns.items():
                # 10 calls a turn: readings, and the script's time is tight
                timed.update(spread(key_ms, fn, iters=10))
            timed.update(
                plain_ms=time_ms(lambda: attention_reference(
                    q, k, v, mask, rate, keep)),
                bwd_plain_ms=time_ms(grad(plain_out, leaves, do)))
            fwd_own = ("attn_fwd_kernel",)
            bwd_own = ("attn_bwd_prep_kernel", "attn_bwd_kernel",
                       "attn_bwd_dq_kernel")
            # device time at the site's rate only (a profiler session costs
            # the script far more than the calls it traces)
            for key_ms, own in (("kernel_ms", fwd_own),
                                ("bwd_kernel_ms", bwd_own),
                                ("library_ms", ()), ("bwd_library_ms", ())):
                mine, total, _ = device_ms(fns[key_ms], own)
                if own:
                    timed[key_ms.replace("_ms", "_device_ms")] = mine
                timed[key_ms.replace("_ms", "_device_all_ms")] = total
            del plain_out, sdpa0, sdpa1, first, second
            bound, bound_by = attention_bound(bsz, lq, lk, key, pane, False)
            bwd_bound, bwd_bound_by = attention_bound(bsz, lq, lk, key, pane,
                                                      True)
            rows[(name, bsz)] = dict(
                site=name, B=bsz, Lq=lq, Lk=lk, mask=kind, rate=rate,
                keep_rate=kept, err_fwd=max(e0, e1), err_grads=max(e2, e3),
                rel_err_fwd=max(r0, r1), rel_err_grads=max(r2, r3),
                bwd_rerun_max_diff=rerun, bound_ms=bound, bound_by=bound_by,
                bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_bound_by, **timed)
            log(f"fused_attention {json.dumps(rows[(name, bsz)])}")
        rerun = max(rows[(n, bsz)]["bwd_rerun_max_diff"]
                    for n, *_ in ATTN_SITES)
        log(f"attention b{bsz}: largest difference between two backward "
            f"calls on the same inputs (dQ sums with f32 atomics) {rerun}")
    return rows, max_err


def sdpa_additive_mask(bsz, lq, lk, key, pane):
    """The decomposed masks as one bf16 additive mask for SDPA, or None."""
    if key is None and pane is None:
        return None
    mask = torch.zeros(bsz if key is not None else 1, 1, lq, lk,
                       device="cuda")
    if key is not None:
        mask = mask + key[:, None, None, :]
    if pane is not None:
        mask = mask + pane
    return mask.to(torch.bfloat16)


def per_step(rows, bsz, key, backward=False):
    """Sum over the attention sites of one train step of ``key`` (None if a
    site has none)."""
    values = [(nb if backward else nf) * rows[(name, bsz)][key]
              if rows[(name, bsz)][key] is not None else None
              for name, _, _, _, _, nf, nb in ATTN_SITES]
    return None if None in values else sum(values)


def per_step_text(rows, bsz, key, backward=False):
    """``key`` summed over one train step's sites, and for a timed key the
    sums of the sites' fastest and slowest turns: "x [lo-hi] ms"."""
    return weighted_text([(nb if backward else nf, rows[(name, bsz)])
                          for name, _, _, _, _, nf, nb in ATTN_SITES], key)


# per train step keys of the attention rows: kernel and SDPA at rate 0 and
# at the site's rate (timed), the plain version, the bound, and at the
# site's rate the kernels' device time per call (profiler) and every
# kernel's in the kernels' call and in SDPA's
ATTN_STEP_KEYS = ("kernel0_ms", "kernel_ms", "library0_ms", "library_ms",
                  "plain_ms", "bound_ms", "kernel_device_ms",
                  "kernel_device_all_ms", "library_device_all_ms")


def attention_entries(rows, max_err, launches=None, bsz=BATCH_SIZE):
    """The forward and backward kernels' entries of the kernels line (at
    the sites' rates, SDPA at the same rate as the library call), with one
    log line each of their per-step sums at every batch size."""
    entries = []
    sizes = sorted({b for _, b in rows}, reverse=True)
    for backward, (name, line) in enumerate(
            (("fused_attention_fwd", 143), ("fused_attention_bwd", 171))):
        pre = "bwd_" if backward else ""
        widest = max(ATTN_SITES, key=lambda s: (s[6] if backward else s[5])
                     * rows[(s[0], bsz)][pre + "bound_ms"])
        entries.append({
            "name": name, "route": "cuda",
            "source": "shgvqa_tpu_torch/csrc/attention.cu",
            "replaces": f"shgvqa_tpu/kernels/attention.py:{line}",
            "launches": None if launches is None else launches[backward],
            "max_abs_err": max_err["bwd" if backward else "fwd"],
            "ms": per_step(rows, bsz, pre + "kernel_ms", backward),
            "plain_ms": per_step(rows, bsz, pre + "plain_ms", backward),
            "bound_ms": per_step(rows, bsz, pre + "bound_ms", backward),
            "bound_by": rows[(widest[0], bsz)][pre + "bound_by"],
            "library_ms": per_step(rows, bsz, pre + "library_ms", backward),
        })
        keys = [(k, pre + k) for k in ATTN_STEP_KEYS] + (
            [("fwd_bwd_library_ms",) * 2] if backward else [])
        for b in sizes:
            log(f"{name} per train step at b{b} ("
                + ("34" if backward else "38") + " sites; library: SDPA "
                "with the same additive mask; device: torch.profiler per "
                "call, the attention kernels' own / every kernel's): "
                + ", ".join(f"{k} {per_step_text(rows, b, rk, backward)}"
                            for k, rk in keys if rk in rows[(widest[0], b)]))
    return entries


# attention shapes only the AGQA ablations give (phase 3): (site, Lq, Lk,
# key row, dropout rate).  'self' attends over the joint [visn; lang]
# sequence (393 + 40 and 177 + 40 tokens) under the joint key row
# (``models/cross._cat_masks``: zeros on the side without a mask, the
# padded question's keys at -10000); 'vhga' masks every language key
ABLATION_ATTN_SITES = (
    ("self LXRT joint", 433, 433, "joint", 0.1),
    ("self HG joint", 217, 217, "joint", 0.1),
    ("deaf language self", 40, 40, "deaf", 0.1),
    ("deaf LXRT cross visn<-lang", 393, 40, "deaf", 0.1),
    ("deaf HG cross hg<-lang", 177, 40, "deaf", 0.1),
)
ABLATION_ATTN_BATCHES = (8, BATCH_SIZE)


# attention shapes only the capsule encoder gives (phase 3, phase caps):
# every trunk frame is a token, 1 + 16 x 7 x 7 = 785 visual tokens: the
# r-layers' self-attention, the decoders' cross-attention over that memory
# (no mask), and with --crossAttn the LXRT cross layers both ways.  Under
# --sharedWeights the l-layers attend over 40 and 393 tokens, the
# flagship's shapes
CAPS_ATTN_SITES = (
    ("capsule visual self", 785, 785, "key", 0.1),
    ("capsule rel decoder cross", 128, 785, "none", 0.15),
    ("capsule act decoder cross", 48, 785, "none", 0.15),
    ("capsule --crossAttn lang<-visn", 40, 785, "key", 0.1),
    ("capsule --crossAttn visn<-lang", 785, 40, "key", 0.1),
)


def ablation_attention_operands(b, lq, lk, kind, seed):
    """bf16 q, k, v as ``attention_operands`` makes them and the site's
    additive mask: a key row or none as there, the joint key row of
    ``_cat_masks`` (the first side unmasked, the question's last 8 keys
    masked in every other clip) or every key at -10000 (the deaf language
    mask)."""
    if kind in ("key", "none"):
        return attention_operands(b, lq, lk, kind, seed)
    q, k, v, _ = attention_operands(b, lq, lk, "none", seed)
    if kind == "joint":
        lang = torch.ones(b, 40, device="cuda")
        lang[1::2, -8:] = 0.0
        mask = _cat_masks(None, extend_mask(lang, torch.bfloat16), lk - 40,
                          40)
    else:
        mask = extend_mask(torch.zeros(b, lk, device="cuda"), torch.bfloat16)
    return q, k, v, mask


def phase_ablation_attention(sites=ABLATION_ATTN_SITES, what="ablation"):
    """Both attention kernels at the ablations' (or the capsule encoder's,
    ``CAPS_ATTN_SITES``) new shapes and masks, B=8 and 32, against the
    plain version: the forward and dQ, dK, dV at rate 0 and at the site's
    rate with the kernels' own keep mask; the mask must decompose to a key
    row (or be none, as the site's); at B=32 the kernels' device time per
    call (torch.profiler) beside the bound.  Returns the rows."""
    t0 = time.perf_counter()
    rows = {}
    for bsz in ABLATION_ATTN_BATCHES:
        for i, (name, lq, lk, kind, rate) in enumerate(sites):
            q, k, v, mask = ablation_attention_operands(bsz, lq, lk, kind,
                                                        300 + i)
            key, pane = decompose_mask(mask, bsz, H, lq, lk)
            if (key is None) != (kind == "none") or pane is not None:
                raise AssertionError(f"{name}: the mask is not a "
                                     + ("key row" if kind != "none"
                                        else "none"))
            tag = f"{name} b{bsz} ({lq}, {lk})"
            _, _, _, (e0, r0), (e1, r1) = fwd_and_grads(
                q, k, v, mask, 0.0, None, None, tag)
            g = torch.Generator(device="cuda").manual_seed(17 + i)
            state = g.get_state()
            seed = draw_seed(g, q.device)
            g.set_state(state)
            keep = keep_mask(seed, bsz * H, lq, lk, rate).view(bsz, H, lq, lk)
            out, do, leaves, (e2, r2), (e3, r3) = fwd_and_grads(
                q, k, v, mask, rate, g, keep, tag)
            row = dict(site=name, B=bsz, Lq=lq, Lk=lk, mask=kind, rate=rate,
                       err_fwd=max(e0, e2), err_grads=max(e1, e3),
                       rel_err_fwd=max(r0, r2), rel_err_grads=max(r1, r3))
            if bsz == BATCH_SIZE:
                fwd_ms, _, _ = device_ms(
                    lambda: fused_attention(q, k, v, mask, rate, g),
                    ("attn_fwd_kernel",))
                bwd_ms, _, _ = device_ms(
                    lambda: torch.autograd.grad(out, leaves, do,
                                                retain_graph=True),
                    ("attn_bwd_prep_kernel", "attn_bwd_kernel",
                     "attn_bwd_dq_kernel"))
                bound, bound_by = attention_bound(bsz, lq, lk, key, pane,
                                                  False)
                bwd_bound, bwd_by = attention_bound(bsz, lq, lk, key, pane,
                                                    True)
                row.update(kernel_device_ms=fwd_ms, bound_ms=bound,
                           bound_by=bound_by, bwd_kernel_device_ms=bwd_ms,
                           bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by)
            rows[(name, bsz)] = row
            log(f"fused_attention ({what} shape) {json.dumps(row)}")
            del q, k, v, mask, out, do, leaves
    log(f"{what} attention shapes ok: {time.perf_counter() - t0:.1f} s")
    return rows


def phase_tok_kernel(batch_sizes=(2, BATCH_SIZE)):
    """The tokenizer conv kernel against tok_conv_reference at ragged
    shapes and at both convs' shapes (bf16), two calls bit-equal; the times
    of the kernel on a bf16 weight (events, and its device time per call:
    the conv and, where the plan splits the last wave, the sum of the
    partials), of the weight's cast from the f32 parameter (each call of
    the model makes it), of the plain version and of the yardstick (F.conv3d
    in bf16, then the port's gelu, on the same channels-last operands); the
    kernel on wgmma (HGMMA in the SASS)."""
    for kernel, (count, first) in sass_hgmma(
            "tok_conv", ("tok_conv_kernel",)).items():
        log(f"sass tok_conv {kernel}: {count} HGMMA instructions, e.g. "
            f"`{first}`")
    rows, max_err = {}, 0.0
    with torch.inference_mode():
        # ragged: positions past the last clip in the last tile, frames of
        # 5 x 5 and 4 x 4, an input under 128 KB
        for bsz, t_len, hw, ci, kt in ((3, 7, 5, 128, 5), (1, 5, 4, 64, 3)):
            g = torch.Generator(device="cuda").manual_seed(hw)
            x = torch.randn(bsz, t_len, hw, hw, ci, generator=g,
                            device="cuda").to(torch.bfloat16)
            w = (0.05 * torch.randn(256, ci, kt, 3, 3, generator=g,
                                    device="cuda")).to(torch.bfloat16)
            b = 0.1 * torch.randn(256, generator=g, device="cuda")
            tag = f"fused_tok_conv ragged {(bsz, t_len, hw, hw, ci)} kT={kt}"
            y = fused_tok_conv(x, w, b)
            err, _ = rel_max_err(tag, y, tok_conv_reference(x, w, b),
                                 TOK_BLOCK_TOL)
            if not torch.equal(y, fused_tok_conv(x, w, b)):
                raise AssertionError(f"{tag}: two calls differ")
            log(f"{tag}: max |err| {err}")
        for bsz in batch_sizes:
            for site, t_len, ci in TOK_SITES:
                rows[(site, bsz)] = tok_row(site, bsz, t_len, TOK_HW, ci)
                max_err = max(max_err, rows[(site, bsz)]["max_abs_err"])
    return rows, max_err


def tok_row(site, bsz, t_len, hw, ci, seed=None):
    """One tokenizer conv site (B, t_len, hw, hw, Ci) -> Co = 768, kernel
    (5, 3, 3), bf16: the kernel against tok_conv_reference (TOK_BLOCK_TOL),
    two calls bit-equal, and its times (``phase_tok_kernel``)."""
    g = torch.Generator(device="cuda").manual_seed(
        bsz * 10 + ci if seed is None else seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    with torch.inference_mode():
        x = randn(bsz, t_len, hw, hw, ci).to(torch.bfloat16)
        w32 = (0.02 * randn(D, ci, TOK_KT, 3, 3)).contiguous(
            memory_format=torch.channels_last_3d)
        b = 0.02 * randn(D)
        w = w32.to(torch.bfloat16)
        tag = f"fused_tok_conv {site} b{bsz}"
        y = fused_tok_conv(x, w, b)
        err, rel = rel_max_err(tag, y, tok_conv_reference(x, w, b),
                               TOK_BLOCK_TOL)
        if not torch.equal(y, fused_tok_conv(x, w, b)):
            raise AssertionError(f"{tag}: two calls on the same inputs "
                                 "differ")
        del y
        xv = x.permute(0, 4, 1, 2, 3)
        m = bsz * (t_len - TOK_KT + 1) * hw * hw
        k = TOK_KT * 9 * ci
        bound, bound_by = bound_ms(
            2 * m * D * k, (x.numel() + w.numel() + m * D) * 2 + 4 * D)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        conv, every, _ = device_ms(lambda: fused_tok_conv(x, w, b),
                                   ("tok_conv_kernel",))
        row = dict(
            site=site, B=bsz, T=t_len, H=hw, M=m, N=D, K=k, max_abs_err=err,
            rel_err=rel, rerun_bit_equal=True,
            plan=tok_conv_plan(m, D, k, sms),
            bound_ms=bound, bound_by=bound_by,
            **spread("kernel_ms", lambda: fused_tok_conv(x, w, b)),
            kernel_device_ms=every, conv_device_ms=conv,
            **spread("cast_ms", lambda: w32.to(torch.bfloat16)),
            plain_ms=time_ms(lambda: tok_conv_reference(x, w, b),
                             iters=5, warmup=1),
            **spread("yardstick_ms", lambda: gelu(F.conv3d(
                xv, w, b.to(torch.bfloat16), padding=(0, 1, 1))),
                iters=5, warmup=1))
    log(f"fused_tok_conv {json.dumps(row)}")
    return row


def log_tok_per_forward(rows, launches=2):
    """The tokenizer conv's times per forward at B=32 and B=2."""
    sites = {b: [(1, rows[(site, b)]) for site, _, _ in TOK_SITES]
             for b in (BATCH_SIZE, 2)}
    log(f"fused_tok_conv per forward ({launches} sites; yardstick: "
        "F.conv3d in bf16 + the port's gelu; device: torch.profiler per "
        "call, every kernel of the call / the conv kernel; no single library "
        "call computes this function): " + ", ".join(
            f"{k} {weighted_text(sites[b], k)} at b{b}"
            for k in ("kernel_ms", "kernel_device_ms", "conv_device_ms",
                      "plain_ms", "yardstick_ms", "bound_ms")
            for b in (BATCH_SIZE, 2)))


def random_block(ci, cm, co, seed):
    """A bf16 ``Bottleneck3D`` on the card (channels-last, as the model's)
    with seeded random weights and BN statistics."""
    block = init_weights(Bottleneck3D(ci, cm, co, dtype=torch.bfloat16), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in block.named_buffers():
            noise = torch.randn(buf.shape, generator=g)
            buf.copy_(1.0 + 0.2 * noise.abs() if name.endswith("var")
                      else 0.1 * noise)
        for name, prm in block.named_parameters():
            if name.startswith("bn"):
                noise = torch.randn(prm.shape, generator=g)
                prm.copy_(1.0 + 0.1 * noise if name.endswith("weight")
                          else 0.1 * noise)
    return block.to(device="cuda", memory_format=torch.channels_last_3d).eval()


def phase_block_kernel(batch_sizes=(2, BATCH_SIZE)):
    """The fused bottleneck kernel against bottleneck_reference at ragged
    frames and at the three block geometries it covers in the trunk (bf16,
    frames N = 16 B); the times of the kernel (events, and its device time
    per call), of the plain version and of the yardstick (the port's
    unfused bf16 Bottleneck3D on the same weights and frames); the kernel
    on wgmma (HGMMA in the SASS)."""
    for kernel, (count, first) in sass_hgmma(
            "bottleneck", ("bottleneck_kernel",)).items():
        log(f"sass bottleneck {kernel}: {count} HGMMA instructions (its four "
            f"instances), e.g. `{first}`")
    rows, max_err = {}, 0.0
    with torch.inference_mode():
        # ragged frames first: the last band of rows is short
        for hw, ci, cm, co in ((30, 64, 64, 256), (13, 512, 128, 512)):
            block = random_block(ci, cm, co, seed=hw)
            x = torch.relu(torch.randn(3, hw, hw, ci, device="cuda")).to(
                torch.bfloat16)
            ops = block.kernel_operands()
            err, _ = rel_max_err(f"fused_bottleneck {hw}x{hw} Ci={ci}",
                                 fused_bottleneck(x, *ops),
                                 bottleneck_reference(x, *ops), TOK_BLOCK_TOL)
            log(f"fused_bottleneck ragged {hw}x{hw} Ci={ci} Cm={cm} Co={co}: "
                f"max |err| {err}")
        for bsz in batch_sizes:
            for site, hw, ci, cm, co, proj, _ in BLOCK_SITES:
                rows[(site, bsz)] = block_row(site, bsz, 16 * bsz, hw, ci,
                                              cm, co, proj)
                max_err = max(max_err, rows[(site, bsz)]["max_abs_err"])
    return rows, max_err


def block_row(site, bsz, n, hw, ci, cm, co, proj):
    """One bottleneck site, ``n`` frames of (hw, hw, Ci) from B = ``bsz``
    clips, bf16: the kernel against bottleneck_reference (TOK_BLOCK_TOL)
    and its times (``phase_block_kernel``)."""
    block = random_block(ci, cm, co, seed=ci + cm)
    ops = block.kernel_operands()
    g = torch.Generator(device="cuda").manual_seed(bsz + ci)
    with torch.inference_mode():
        x = torch.relu(torch.randn(n, hw, hw, ci, generator=g,
                                   device="cuda")).to(torch.bfloat16)
        xv = x.view(bsz, n // bsz, hw, hw, ci).permute(0, 4, 1, 2, 3)
        tag = f"fused_bottleneck {site} b{bsz}"
        err, rel = rel_max_err(tag, fused_bottleneck(x, *ops),
                               bottleneck_reference(x, *ops), TOK_BLOCK_TOL)
        macs = ci * cm + 9 * cm * cm + cm * co + (ci * co if proj else 0)
        positions = n * hw * hw
        bound, bound_by = bound_ms(
            2 * positions * macs,
            positions * (ci + co) * 2 + macs * 2 + (4 * cm + 4 * co) * 2)
        row = dict(
            site=site, B=bsz, frames=n, H=hw, Ci=ci, Cm=cm, Co=co,
            proj=proj, max_abs_err=err, rel_err=rel, bound_ms=bound,
            bound_by=bound_by,
            **spread("kernel_ms", lambda: fused_bottleneck(x, *ops)),
            kernel_device_ms=device_ms(
                lambda: fused_bottleneck(x, *ops),
                ("bottleneck_kernel",))[0],
            plain_ms=time_ms(lambda: bottleneck_reference(x, *ops),
                             iters=5, warmup=1),
            **spread("yardstick_ms", lambda: block(xv), iters=5, warmup=1))
    log(f"fused_bottleneck {json.dumps(row)}")
    return row


def per_forward_tok(rows, bsz, key):
    return sum(rows[(site, bsz)][key] for site, _, _ in TOK_SITES)


def per_forward_block(rows, bsz, key):
    return sum(n * rows[(site, bsz)][key]
               for site, *_, n in BLOCK_SITES)


def log_block_per_forward(rows, launches=6):
    """The bottleneck's times per forward at B=32 and B=2: each site's
    median times its blocks, with the sums of the fastest and slowest
    turns for the event times."""
    log(f"fused_bottleneck per forward ({launches} sites; yardstick: the "
        "port's unfused bf16 Bottleneck3D; device: torch.profiler per call; "
        "no single library call computes this function): " + ", ".join(
            f"{k} " + weighted_text(
                [(n, rows[(site, b)]) for site, *_, n in BLOCK_SITES], k)
            + f" at b{b}"
            for k in ("kernel_ms", "kernel_device_ms", "plain_ms",
                      "yardstick_ms", "bound_ms")
            for b in (BATCH_SIZE, 2)))


def out_ln_operands(m: int, d: int = D, seed: int = 0):
    """bf16 x (M, D), W (D, D) in nn.Linear layout, f32 b, bf16 residual
    (M, D), f32 gamma, beta."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    return (randn(m, d).to(torch.bfloat16),
            (0.02 * randn(d, d)).to(torch.bfloat16), 0.02 * randn(d),
            randn(m, d).to(torch.bfloat16), 1.0 + 0.1 * randn(d),
            0.1 * randn(d))


def out_ln_bound(m: int, d: int = D):
    """(ms, bound_by) of one call: 2*M*D*D operations over the bf16 peak
    against x, residual, y (M, D) and W (D, D) in bf16 and b, gamma, beta in
    f32 over the memory rate (the JAX cost estimate, ffn.py:519-523, plus
    the vectors)."""
    return bound_ms(2 * m * d * d, (3 * m * d + d * d) * 2 + 3 * d * 4)


def check_out_ln(m: int, d: int, sms: int, seed: int):
    """fused_out_ln against out_ln_reference at (M, D), two calls on the
    same inputs bit-equal, the wrapper's plan mirror equal to the kernel's:
    (operands, max |err|, plan)."""
    args = out_ln_operands(m, d, seed=seed)
    tag = f"fused_out_ln M={m} D={d}"
    y = fused_out_ln(*args)
    err = check_close(tag, y, out_ln_reference(*args))
    if not torch.equal(y, fused_out_ln(*args)):
        raise AssertionError(f"{tag}: two calls on the same inputs differ")
    plan = ffn_kernels.out_ln_plan(m, d, sms)
    if plan != ffn_kernels.out_ln_kernel_plan(m, d, sms):
        raise AssertionError(f"{tag}: out_ln_plan {plan} is not the kernel's "
                             f"{ffn_kernels.out_ln_kernel_plan(m, d, sms)}")
    return args, err, plan


def phase_out_ln_kernel(batch_sizes=(2, BATCH_SIZE)):
    """The attention-output kernel against out_ln_reference at every
    AttOutput site's shape (the FFN sites' rows, bf16) and at two ragged M,
    two calls bit-equal, the plan mirror equal to the kernel's, its autograd
    backward at a small shape; the times of the kernel (events, and its
    device time per call), the plain version and the unfused yardstick
    (F.linear, add, F.layer_norm in bf16); the kernel on wgmma (HGMMA in
    the SASS)."""
    for kernel, (count, first) in sass_hgmma(
            "out_ln", ("out_ln_kernel",)).items():
        log(f"sass out_ln {kernel}: {count} HGMMA instructions, e.g. "
            f"`{first}`")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, max_err = {}, 0.0
    with torch.inference_mode():
        # ragged: one row past a 64-row tile; a 128-row plan's last tile
        for m in (65, 12577):
            _, err, plan = check_out_ln(m, D, sms, seed=m)
            max_err = max(max_err, err)
            log(f"fused_out_ln ragged M={m}: max |err| {err}, plan "
                f"{plan}, two calls bit-equal")
        for bsz in batch_sizes:
            for per_clip, _ in FFN_SITES:
                m = per_clip * bsz
                args, err, plan = check_out_ln(m, D, sms, seed=2000 + m)
                max_err = max(max_err, err)
                x, w, b, res, gamma, beta = args
                bound, bound_by = out_ln_bound(m)
                _, every, _ = device_ms(lambda: fused_out_ln(*args),
                                        ("out_ln",))
                rows[m] = dict(
                    M=m, plan=plan, rerun_bit_equal=True,
                    **spread("kernel_ms", lambda: fused_out_ln(*args)),
                    kernel_device_ms=every,
                    plain_ms=time_ms(lambda: out_ln_reference(*args)),
                    **spread("yardstick_ms", lambda: F.layer_norm(
                        F.linear(x, w, b.to(x.dtype)) + res, (D,),
                        gamma.to(x.dtype), beta.to(x.dtype), 1e-12)),
                    bound_ms=bound, bound_by=bound_by, max_abs_err=err)
                log(f"fused_out_ln {json.dumps(rows[m])}")
    ops = [a.detach().requires_grad_(True)
           for a in out_ln_operands(64, 128, seed=9)]
    grads = torch.autograd.grad((fused_out_ln(*ops).float() ** 2).sum(), ops)
    refs = torch.autograd.grad((out_ln_reference(*ops).float() ** 2).sum(),
                               ops)
    for i, (g, r) in enumerate(zip(grads, refs)):
        check_close(f"fused_out_ln backward grad {i}", g, r)
    log("fused_out_ln backward ok (M=64, D=128)")
    return rows, max_err


def log_out_ln_per_forward(rows, launches=18):
    """The attention-output kernel's times per forward at B=32 and B=2:
    each site's median times its launches, with the sums of the fastest and
    slowest turns for the event times."""
    sites = {b: [(n, rows[per_clip * b]) for per_clip, n in FFN_SITES]
             for b in (BATCH_SIZE, 2)}
    log(f"fused_out_ln per forward ({launches} sites; yardstick: F.linear + "
        "add + F.layer_norm in bf16; device: torch.profiler per call; no "
        "single library call computes this function): " + ", ".join(
            f"{k} {weighted_text(sites[b], k)} at b{b}"
            for k in ("kernel_ms", "kernel_device_ms", "plain_ms",
                      "yardstick_ms", "bound_ms")
            for b in (BATCH_SIZE, 2)))


def split_heads(x2):
    """(B, L, H*64) -> its (B, H, L, 64) view."""
    b, length, _ = x2.shape
    return x2.view(b, length, H, HEAD_DIM).transpose(1, 2)


def transpose_path(q2, k2, v2, mask):
    """The model's attention core before the head-sliced kernel: the fused
    attention forward at rate 0 on (B, H, L, 64) views of the projections,
    its output back to (B, Lq, H*64)."""
    b, lq, _ = q2.shape
    out = fused_attention(split_heads(q2), split_heads(k2), split_heads(v2),
                          mask)
    return out.transpose(1, 2).reshape(b, lq, D)


def phase_headsliced_kernel(batch_sizes=(2, BATCH_SIZE)):
    """The head-sliced attention against headsliced_reference (within
    ATTN_TOL) and the transpose path (bit-equal: one kernel on the same
    bytes) at every attention site's shape (bf16 (B, L, 768) projections,
    the site's mask); the times of the kernel, the plain version, the
    transpose path and SDPA with the same additive mask, and the kernel's
    device time per call."""
    rows, max_err = {}, 0.0
    with torch.inference_mode():
        for bsz in batch_sizes:
            for i, (name, lq, lk, kind, *_) in enumerate(ATTN_SITES):
                q, k, v, mask = attention_operands(bsz, lq, lk, kind, 300 + i)
                q2, k2, v2 = (x.transpose(1, 2).reshape(bsz, -1, D)
                              for x in (q, k, v))
                key, pane = decompose_mask(mask, bsz, H, lq, lk)
                tag = f"{name} b{bsz} ({lq}, {lk})"
                out = headsliced_attention(q2, k2, v2, mask, H)
                err, rel = rel_max_err(
                    f"headsliced {tag}", out, headsliced_reference(
                        q2, k2, v2, key, pane, heads=H), ATTN_TOL)
                if not torch.equal(out, transpose_path(q2, k2, v2, mask)):
                    raise AssertionError(f"headsliced {tag}: not bit-equal "
                                         "to the transpose path")
                max_err = max(max_err, err)
                sdpa_mask = sdpa_additive_mask(bsz, lq, lk, key, pane)
                bound, bound_by = attention_bound(bsz, lq, lk, key, pane,
                                                  False, lse=False)
                rows[(name, bsz)] = dict(
                    site=name, B=bsz, Lq=lq, Lk=lk, mask=kind,
                    max_abs_err=err, rel_err=rel, bit_equal_to_transpose=True,
                    bound_ms=bound, bound_by=bound_by,
                    **spread("kernel_ms", lambda: headsliced_attention(
                        q2, k2, v2, mask, H)),
                    plain_ms=time_ms(lambda: headsliced_reference(
                        q2, k2, v2, key, pane, heads=H)),
                    **spread("transpose_ms", lambda: transpose_path(
                        q2, k2, v2, mask)),
                    **spread("library_ms",
                             lambda: F.scaled_dot_product_attention(
                                 q, k, v, sdpa_mask)),
                    kernel_device_ms=device_ms(
                        lambda: headsliced_attention(q2, k2, v2, mask, H),
                        ("attn_fwd_kernel",))[0])
                log(f"headsliced_attention {json.dumps(rows[(name, bsz)])}")
    return rows, max_err


def phase_headsliced_ab(b=64, shapes=((40, 40), (393, 393), (128, 393))):
    """tools/proto_headsliced_attn.py's A/B on the card: the head-sliced
    kernel against the transpose path at B=64 with a 10% key mask of
    -10000, one line per shape."""
    with torch.inference_mode():
        for lq, lk in shapes:
            g = torch.Generator(device="cuda").manual_seed(lq * 1000 + lk)
            q2, k2, v2 = (torch.randn(b, n, D, generator=g, device="cuda").to(
                torch.bfloat16) for n in (lq, lk, lk))
            mask = torch.where(
                torch.rand(b, 1, 1, lk, generator=g, device="cuda") < 0.1,
                -10000.0, 0.0)
            tag = f"b{b} h{H} {lq}x{lk} d{HEAD_DIM}"
            err, _ = rel_max_err(f"headsliced A/B {tag}",
                                 headsliced_attention(q2, k2, v2, mask, H),
                                 transpose_path(q2, k2, v2, mask), ATTN_TOL)
            hs_ms, hs_range = time_spread(
                lambda: headsliced_attention(q2, k2, v2, mask, H),
                turns=TIMING_TURNS)
            tr_ms, tr_range = time_spread(
                lambda: transpose_path(q2, k2, v2, mask), turns=TIMING_TURNS)
            log("headsliced A/B " + json.dumps(dict(
                shape=tag, max_err_vs_transpose_path=err, headsliced_ms=hs_ms,
                headsliced_ms_range=hs_range, transpose_path_ms=tr_ms,
                transpose_path_ms_range=tr_range, speedup=tr_ms / hs_ms)))


# the global matcher's problems (loss_hg_per_frame off): (name, B, queries,
# targets a situation, classes with the background); one clip a problem of
# 16 situations, the labels compacted as the set loss compacts them
MATCHER_SHAPES = (("relations", 128, 8, 564), ("actions", 48, 3, 112))
MATCHER_BATCHES = (BATCH_SIZE, 8)
# the STAR train step's batch (STAR_FLAGS), at which the plain version is
# timed on the card
STAR_BATCH = 8
# total cost against scipy's linear_sum_assignment (f32 sums of <= 128
# terms in another order)
MATCHER_COST_TOL = 1e-5
# a dependent f32 compare on Hopper takes at least this many cycles: the
# issue latency of dependent arithmetic on the SM
DEPENDENT_CYCLES = 4
# the large path's problems, above the shared-memory path's limit, at the
# STAR step's B=8: (name, n, situations, relations a situation); n = 239 is
# the limit + 1 and n = 1024 dense uniform costs, n = 480 STAR's costs at
# --numSituations 60 --numRel 8 (repeated labels and padded columns: ~7x
# the search steps of uniform costs; at n = 1024 they take the host's plain
# version minutes)
MATCHER_LARGE = (("limit + 1", None, None, None), ("480", 480, 60, 8),
                 ("1024", 1024, None, None))
# at B=32 the first STAR_BATCH problems of each launch are held bit-equal
# to the plain version on the host (B=8 holds all of its own, of the same
# shapes); the large path's problems so held, of the B=8 each launch (and
# its timing) solves: the host's plain version takes seconds a problem at
# n = 480 and 1024.  Every problem of every launch is held to scipy's
# total cost and checked to be a permutation
MATCHER_LARGE_HELD = 2


def max_sm_clock_hz() -> float:
    """``nvidia-smi --query-gpu=clocks.max.sm`` in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def matcher_costs(bsz, n, slots, classes, seed, ties=False, empty=False,
                  situations=NUM_SITUATIONS):
    """(B, n, n) f32 costs of the global matcher from random logits and
    labels: -softmax(logits)[label] over the compacted labels
    (``ops.matcher.compact_labels``), the columns past each clip's count
    padded to 0, as ``assign_padded`` sees them.  ``ties`` rounds the
    probabilities to eighths (many equal costs); ``empty`` gives every clip
    zero targets."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = 2.0 * torch.randn(bsz, n, classes, device="cuda", generator=g)
    labels = torch.randint(1, classes, (bsz, situations, slots),
                           device="cuda", generator=g)
    lengths = torch.randint(0, slots + 1, (bsz, situations),
                            device="cuda", generator=g)
    if empty:
        lengths.zero_()
    flat, valid = matcher.compact_labels(labels, lengths)
    prob = torch.softmax(logits, dim=-1)
    if ties:
        prob = (prob * 8.0).round() / 8.0
    cost = matcher._class_cost(prob, flat)
    cols = torch.arange(n, device="cuda")
    return torch.where(cols < valid[:, None, None], cost, 0.0).contiguous()


def matcher_bound(bsz, n, steps, clock_hz):
    """(ms, arithmetic): the larger of the bytes (the f32 costs read once,
    the int64 rows written once) over the memory rate and the chain of
    dependent search steps: the problems run side by side (one block each,
    B <= 132 SMs), so the longest problem's steps, each at least one
    reduction of ceil(log2(n + 1)) dependent compares of DEPENDENT_CYCLES
    cycles at the card's highest SM clock."""
    t_bytes = (bsz * n * n * 4 + bsz * n * 8) / PEAK_HBM_BYTES
    depth = math.ceil(math.log2(n + 1))
    t_steps = steps * depth * DEPENDENT_CYCLES / clock_hz
    return max(t_bytes, t_steps) * 1e3, (
        f"max({bsz * n * n * 4 + bsz * n * 8} B / 3.35 TB/s, {steps} steps x "
        f"{depth} compares x {DEPENDENT_CYCLES} cycles / "
        f"{clock_hz / 1e6:.0f} MHz)")


def check_matcher(tag, cost, time_plain=False, paths=(None,), held=None):
    """Kernel against the plain version on the host's copy of ``cost`` (the
    CPU runs the card's f32 operations in the same order, and the CPU tests
    hold it to the JAX solver): row_to_col and the search steps bit-equal,
    with ``held`` on the first ``held`` problems of the kernel's launch on
    all of ``cost`` (the host's plain version takes seconds a problem at
    the large path's n); every problem of every launch a permutation at
    scipy's total cost within MATCHER_COST_TOL.  With ``time_plain`` also
    the plain version on the card, bit-equal to the host's, and its ms (one
    turn: it reads the host at every search step).  Returns the kernel's
    steps, max |row_to_col - plain| and the plain version's ms on the card
    (None without ``time_plain``).  Each of ``paths`` (None: the wrapper's
    choice, or one of ``matcher.PATHS``) is held to the same plain run."""
    host = cost.cpu()
    p, _, _, plain_steps = matcher._augmenting_path_solve(host[:held])
    plain = matcher._row_to_col(p)
    c = host.numpy()
    best = []
    for ci in c:
        ri, cj = linear_sum_assignment(ci)
        best.append(float(ci[ri, cj].sum()))
    n = c.shape[-1]
    for path in paths:
        rows, steps = matcher._launch(cost, path)
        every = rows.cpu()
        got = every[:held]
        err = int((got - plain).abs().max())
        if err:
            raise AssertionError(
                f"matcher {tag} ({path or 'auto'}): row_to_col differs from "
                f"the plain version in {int((got != plain).sum())} places")
        if not torch.equal(steps[:held].cpu().long(), plain_steps):
            raise AssertionError(f"matcher {tag} ({path or 'auto'}): search "
                                 f"steps {steps.tolist()}, plain "
                                 f"{plain_steps.tolist()}")
        for i, (ci, row) in enumerate(zip(c, every.numpy())):
            if not np.array_equal(np.sort(row), np.arange(n)):
                raise AssertionError(f"matcher {tag} ({path or 'auto'}): "
                                     f"problem {i} is not a permutation")
            ours = float(ci[np.arange(n), row].sum())
            if abs(ours - best[i]) > MATCHER_COST_TOL:
                raise AssertionError(
                    f"matcher {tag} ({path or 'auto'}): problem {i}'s total "
                    f"cost {ours}, scipy's {best[i]}")
    plain_ms = None
    if time_plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = matcher._row_to_col(matcher._augmenting_path_solve(cost)[0])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(on_card.cpu(), plain):
            raise AssertionError(f"matcher {tag}: the plain version on the "
                                 "card differs from the host's")
    return steps, err, plain_ms


def phase_matcher_kernel():
    """The global matcher's kernel (``csrc/matcher.cu``) against its plain
    version at (B, 128, 128) and (B, 48, 48), B = 32 (the launch's first 8
    problems held bit-equal, all 32 at scipy's cost) and 8, plus a batch
    made of ties and one with zero targets: row_to_col and steps bit-equal,
    scipy's total cost; the kernel's time by events and its device time,
    the plain version's on the card at the STAR step's B=8 (one turn),
    scipy on the host with the copy to the host (the reference's own
    route, ``lxrt/matcher.py:76-80``) as the yardstick, and the bound.  At
    the shared-memory path's largest n one problem launches and agrees.
    Above it the large path (cost in global memory): n = limit + 1, 480
    and 1024 at B=8, the first ``MATCHER_LARGE_HELD`` problems of each
    launch bit-equal, all 8 at scipy's cost, also with its state in a
    workspace, the last two timed (events, device time, bound, scipy); the
    large path forced at the B=8 problems of 128 and 48 too.
    Returns
    the rows (the large path's under ("large", n)) and max |row_to_col -
    plain| over every case."""
    t0 = time.perf_counter()
    clock = max_sm_clock_hz()
    rows, max_err = {}, 0
    for bsz in MATCHER_BATCHES:
        for name, n, slots, classes in MATCHER_SHAPES:
            cost = matcher_costs(bsz, n, slots, classes, seed=bsz + n)
            # at the STAR batch the large path, forced, on the same costs
            steps, err, plain_ms = check_matcher(
                f"{name} b{bsz}", cost, time_plain=bsz == STAR_BATCH,
                paths=(None, "large") if bsz == STAR_BATCH else (None,),
                held=None if bsz == STAR_BATCH else STAR_BATCH)
            max_err = max(max_err, err)
            row = {"steps_max": int(steps.max()), "steps_sum":
                   int(steps.sum()), "plain_ms": plain_ms}
            row["bound_ms"], row["bound"] = matcher_bound(
                bsz, n, row["steps_max"], clock)
            row.update(spread("kernel_ms", lambda: matcher._launch(cost)))
            mine, _, _ = device_ms(lambda: matcher._launch(cost),
                                   own=("hungarian_kernel",))
            row["kernel_device_ms"] = mine
            t1 = time.perf_counter()
            host = cost.cpu().numpy()
            for c in host:
                linear_sum_assignment(c)
            row["scipy_host_ms"] = (time.perf_counter() - t1) * 1e3
            row["bound_by"] = "operations"
            rows[(name, bsz)] = row
            log(f"matcher {name} b{bsz} ({n} x {n}): bit-equal to the plain "
                f"version, scipy's total cost; {json.dumps(row)}")
    for tag, kw in (("ties", dict(ties=True)), ("zero targets",
                                                dict(empty=True))):
        cost = matcher_costs(4, 128, 8, 564, seed=3, **kw)
        max_err = max(max_err, check_matcher(tag, cost)[1])
        log(f"matcher {tag} b4 (128 x 128): bit-equal to the plain version, "
            "scipy's total cost")
    lib = matcher._lib()
    max_n = lib.shgvqa_hungarian_max_n()
    cost = torch.rand(1, max_n, max_n, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(4))
    max_err = max(max_err, check_matcher(f"n={max_n}", cost)[1])
    log(f"matcher n={max_n} (the shared-memory path's limit; the large "
        f"path's state fits shared memory up to n="
        f"{lib.shgvqa_hungarian_large_smem_max_n()}): bit-equal to the "
        "plain version, scipy's total cost")
    for name, n, situations, slots in MATCHER_LARGE:
        t1 = time.perf_counter()
        bsz = STAR_BATCH
        if situations is None:
            n = n or max_n + 1
            cost = -torch.rand(bsz, n, n, device="cuda", generator=torch.
                               Generator(device="cuda").manual_seed(n))
        else:
            cost = matcher_costs(bsz, n, slots, 564, seed=n,
                                 situations=situations)
        if matcher._pick_path(lib, n) != "large":
            raise AssertionError(f"matcher n={n}: the wrapper picks "
                                 f"{matcher._pick_path(lib, n)}")
        steps, err, _ = check_matcher(f"n={n} b{bsz}", cost,
                                      paths=(None, "large_global"),
                                      held=MATCHER_LARGE_HELD)
        max_err = max(max_err, err)
        row = {"n": n, "steps_max": int(steps.max()),
               "steps_sum": int(steps.sum())}
        if name != "limit + 1":
            row["bound_ms"], row["bound"] = matcher_bound(
                bsz, n, row["steps_max"], clock)
            row.update(spread("kernel_ms", lambda: matcher._launch(cost),
                              turns=3, iters=2, warmup=1))
            row["kernel_device_ms"] = device_ms(
                lambda: matcher._launch(cost),
                own=("hungarian_large_kernel",), calls=4)[0]
            t2 = time.perf_counter()
            for c in cost.cpu().numpy():
                linear_sum_assignment(c)
            row["scipy_host_ms"] = (time.perf_counter() - t2) * 1e3
            row["bound_by"] = "operations"
            rows[("large", n)] = row
        log(f"matcher large path {name} (n={n}) b{bsz}: bit-equal to the "
            "plain version, its state in shared memory and in a workspace; "
            f"scipy's total cost; {json.dumps(row)}; "
            f"{time.perf_counter() - t1:.1f} s")
    log(f"matcher phase {time.perf_counter() - t0:.1f} s")
    return rows, max_err


def per_step_matcher(rows, bsz, key):
    """``key`` summed over one train step's two problems at ``bsz``."""
    return sum(rows[(name, bsz)][key] for name, *_ in MATCHER_SHAPES)


def per_forward_attn(rows, bsz, key):
    """Sum over the attention sites of one inference forward of ``key``."""
    return sum(nf * rows[(name, bsz)][key]
               for name, _, _, _, _, nf, _ in ATTN_SITES)


def set_ffn_kernel(model, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, FFN):
            m.use_kernel = on


def set_inference_kernels(model, ffn: bool, tok_block: bool = False,
                          attention: bool = False,
                          out_ln_headsliced: bool = False) -> None:
    """The FFN kernel; the tokenizer and bottleneck kernels; the attention
    forward at every site (``--pallasAttention``); the out_ln and
    head-sliced kernels: each on or off."""
    set_ffn_kernel(model, ffn)
    set_tok_kernel(model, tok_block)
    set_block_kernel(model, tok_block)
    set_attention_kernel_eval(model, attention)
    set_out_ln_kernel(model, out_ln_headsliced)
    set_headsliced_kernel(model, out_ln_headsliced)


# inference modes of phases 4 and 5: name -> set_inference_kernels keywords
MODES = {
    "kernel": dict(ffn=True),
    "plain": dict(ffn=False),
    "tok_block": dict(ffn=True, tok_block=True),
    "attention": dict(ffn=True, attention=True),
    "out_ln_headsliced": dict(ffn=True, out_ln_headsliced=True),
}


# phase 4's forwards: (name, mode, launches per B=2 forward)
MAIN_RUNS = (
    ("FFN kernel", "kernel", (0, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)),
    ("plain", "plain", (0,) * 11),
    ("FFN + tok + block kernels", "tok_block", (0, 0, 18, 0, 0, 2, 6, 0, 0, 0, 0)),
    ("FFN + attention kernels", "attention", (38, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)),
    ("FFN + out_ln + headsliced", "out_ln_headsliced",
     (0, 0, 18, 0, 0, 0, 0, 18, 38, 0, 0)),
)


def phase_main_path():
    """entry.entry() at B=2 with launch counts from 0, on the same weights:
    with the FFN kernel (the default), with every kernel off, with the FFN,
    tokenizer and bottleneck kernels, with the FFN kernel and the attention
    forward at every site (``--pallasAttention``), and with the FFN, out_ln
    and head-sliced kernels; each kernel path's hg_logit against the plain
    one.  Returns the model and each run's launch counts."""
    t0 = time.perf_counter()
    fn, args = entry.entry()
    log(f"main path: flagship model built in {time.perf_counter() - t0:.1f} s")
    model, batch = args
    cfg = model.cfg
    want_shape = (batch["frames"].shape[0], cfg.num_answers)
    runs = {}
    for name, mode, want in MAIN_RUNS:
        set_inference_kernels(model, **MODES[mode])
        reset_counts()
        y = fn(*args)
        torch.cuda.synchronize()
        runs[name] = (y, counts())
        if runs[name][1] != want:
            raise AssertionError(f"{name} forward launched {runs[name][1]}, "
                                 f"expected {want}")
        if tuple(y.shape) != want_shape or not torch.isfinite(y).all():
            raise AssertionError(f"hg_logit ({name}) shape {tuple(y.shape)} "
                                 f"or non-finite values")
    set_inference_kernels(model, **MODES["kernel"])
    plain = runs["plain"][0].float()
    for name, _, _ in MAIN_RUNS:
        if name == "plain":
            continue
        out, launched = runs[name]
        rel = ((out.float() - plain).norm() / plain.norm()).item()
        agree = (out.argmax(-1) == plain.argmax(-1)).float().mean().item()
        log(f"main path ({name}): hg_logit {want_shape}, rel Frobenius vs "
            f"the plain path {rel:.3e}, argmax agreement {agree:.3f}, "
            f"launches ({COUNT_NAMES}) {launched}")
        if rel > 5e-2:
            raise AssertionError(f"hg_logit ({name}) differs from the plain "
                                 f"path by {rel}")
    return model, {name: launched for name, (_, launched) in runs.items()}


def phase_throughput(model):
    """clips/s at B=32 on the same weights, in turns: the FFN kernel
    ("kernel"), no kernel ("plain"), the FFN, tokenizer and bottleneck
    kernels ("tok_block"), the FFN and attention kernels ("attention") and
    the FFN, out_ln and head-sliced kernels ("out_ln_headsliced")."""
    batches = [entry.device_batch(model.cfg, BATCH_SIZE, seed)
               for seed in (0, 1)]
    order = ("kernel", "plain", "tok_block", "attention", "out_ln_headsliced")
    runs = {name: [] for name in order}
    for name in order + order[::-1]:
        set_inference_kernels(model, **MODES[name])
        runs[name].append(clips_per_second(model, batches))
    set_inference_kernels(model, **MODES["kernel"])
    log(f"throughput b{BATCH_SIZE} clips/s: {json.dumps(runs)}")
    return {k: sum(v) / len(v) for k, v in runs.items()}


COUNT_NAMES = ("attention fwd, bwd, ffn, ffn train fwd, bwd, tok, block, "
               "out_ln, headsliced, matcher, qconv")


def reset_counts():
    fused_ffn.launches = 0
    fused_attention.launches = 0
    fused_attention.bwd_launches = 0
    fused_ffn_train.launches = 0
    fused_ffn_train.bwd_launches = 0
    fused_tok_conv.launches = 0
    fused_bottleneck.launches = 0
    fused_out_ln.launches = 0
    headsliced_attention.launches = 0
    hungarian_square.launches = 0
    qconv.launches = 0


def counts():
    """(attention forward, attention backward, FFN, FFN train forward, FFN
    train backward, tokenizer conv, bottleneck, out_ln, head-sliced
    attention, matcher, int8 conv) launches since ``reset_counts``."""
    return (fused_attention.launches, fused_attention.bwd_launches,
            fused_ffn.launches, fused_ffn_train.launches,
            fused_ffn_train.bwd_launches, fused_tok_conv.launches,
            fused_bottleneck.launches, fused_out_ln.launches,
            headsliced_attention.launches, hungarian_square.launches,
            qconv.launches)


def grad_norm(params):
    return torch.linalg.vector_norm(torch.stack(
        [p.grad.float().norm() if p.grad is not None
         else torch.zeros((), device="cuda") for p in params])).item()


def phase_train_main_path():
    """entry.train_entry() at B=32 with the tokenizer and bottleneck
    switches on: three train steps with every launch count set to 0 just
    before each and read just after (the tokenizer trains, so its kernel
    stays off; the frozen trunk's 6 blocks take theirs); the frozen and
    disconnected parameters stay bit-identical, the trainable ones move;
    the eval step at B=2; then the kernel path against the plain path on
    the same weights and batch with every dropout rate at 0.  Returns with
    the two switches off again."""
    t0 = time.perf_counter()
    model, optimizer, generator, batch = entry.train_entry()
    cfg = model.cfg
    log(f"train main path: flagship model and optimizer built in "
        f"{time.perf_counter() - t0:.1f} s")
    set_tok_kernel(model, True)
    set_block_kernel(model, True)
    step = make_train_step(cfg, model, optimizer)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step_counts = []
    for i in range(3):
        reset_counts()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        step_counts.append(counts())
        values = {k: v.item() for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"train step {i}: non-finite {values}")
        log(f"train step {i}: launches ({COUNT_NAMES}) "
            f"{step_counts[-1]}; {json.dumps(values)}")
    if any(c != (38, 34, 0, 0, 0, 0, 6, 0, 0, 0, 0) for c in step_counts):
        raise AssertionError(f"train step launches {step_counts}, expected "
                             "38 attention forward, 34 backward, 0 FFN, 0 "
                             "tokenizer, 6 bottleneck")
    moved, tiny, frozen = moved_or_tiny(model, optimizer, before)
    log(f"train main path: {len(moved)} trainable tensors moved, "
        f"{len(tiny)} with updates below f32 resolution {tiny}; "
        f"{len(frozen)} frozen (trunk) "
        "or disconnected (LXRT x-layers, pooler) tensors bit-identical")
    del before

    reset_counts()
    eval_batch = entry.device_batch(cfg, 2, 1, with_labels=True)
    preds = make_eval_step(cfg, model, with_hg_metrics=True)(eval_batch)
    torch.cuda.synchronize()
    eval_counts = counts()
    if eval_counts != (0, 0, 18, 0, 0, 2, 6, 0, 0, 0, 0):
        raise AssertionError(f"eval step launches {eval_counts}, expected 0 "
                             "attention, 18 FFN, 2 tokenizer, 6 bottleneck")
    log(f"eval step b2: launches {eval_counts}; rel/act class acc "
        f"{preds['rel_class_acc'].item():.2f} / "
        f"{preds['act_class_acc'].item():.2f}")

    # kernel path vs plain path with every dropout rate 0, same weights
    rates = {m: m.rate for m in model.modules() if isinstance(m, Dropout)}
    set_dropout_rate(model, 0.0)
    results = {}
    model.train()
    # (attention kernels, FFN train kernels): the attention kernels against
    # the plain attention, then the FFN train kernels against the unfused
    # FFN with the attention kernels on
    for name, attn, ffn in (("kernel", True, False), ("plain", False, False),
                            ("ffn kernel", True, True)):
        set_attention_kernel(model, attn)
        set_ffn_train_kernel(model, ffn)
        optimizer.zero_grad()
        loss, _ = compute_losses(cfg, model(batch, generator), batch)
        loss.backward()
        results[name] = (loss.item(), grad_norm(optimizer.params))
    optimizer.zero_grad()
    set_attention_kernel(model, True)
    set_ffn_train_kernel(model, False)
    set_tok_kernel(model, False)
    set_block_kernel(model, False)
    for m, rate in rates.items():
        m.rate = rate
    for what, (name, ref) in (("attention", ("kernel", "plain")),
                              ("FFN", ("ffn kernel", "kernel"))):
        (lk, gk), (lp, gp) = results[name], results[ref]
        rel_loss, rel_grad = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
        log(f"train kernel vs plain {what} (dropout 0, b{BATCH_SIZE}): loss "
            f"{lk:.6f} vs {lp:.6f} (rel {rel_loss:.2e}), grad norm {gk:.6f} "
            f"vs {gp:.6f} (rel {rel_grad:.2e})")
        if rel_loss > TRAIN_TOL or rel_grad > TRAIN_TOL:
            raise AssertionError(f"kernel and plain {what} train paths "
                                 f"differ: loss rel {rel_loss}, grad norm "
                                 f"rel {rel_grad}")
    return model, optimizer, generator, batch, step_counts[-1]


def moved_or_tiny(model, optimizer, before):
    """(moved, tiny, frozen) parameter names after training from
    ``before``: a trainable tensor must move unless its last update is
    below f32 resolution everywhere (with random weights the gradients'
    global norm is ~5e6, so the clip scales them by ~1e-6 and, with Adam's
    eps, the early updates of small-gradient tensors vanish in f32); a
    tensor outside the optimizer must not change."""
    trainable = {id(p) for p in optimizer.params}
    lr_t = optimizer.lr_at(optimizer.step_count - 1)
    state = {id(p): (m, v) for p, m, v in zip(
        optimizer.params, optimizer.m, optimizer.v)}
    moved, tiny, frozen = [], [], []
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        if id(p) not in trainable:
            if not same:
                raise AssertionError(f"frozen or disconnected parameter "
                                     f"{name} changed")
            frozen.append(name)
            continue
        if not same:
            moved.append(name)
            continue
        m, v = state[id(p)]
        update = lr_t * (m / (v.sqrt() + optimizer.eps)
                         + optimizer.weight_decay * p.detach())
        if (update.abs() > 0.5 * torch.finfo(torch.float32).eps
                * p.detach().abs()).any():
            raise AssertionError(f"trainable parameter {name} did not move")
        tiny.append(name)
    return moved, tiny, frozen


def phase_train_published():
    """entry.train_entry(published=True) at B=32, the published AGQA recipe
    (the trunk trained in the graph, RandAugment on the card), with the
    tokenizer and bottleneck switches on: three train steps with every
    launch count set to 0 just before each and read just after (no
    bottleneck launch: every block's gradient is required); the trunk's
    conv weights and BatchNorm weights and biases move, its BatchNorm
    statistics and the LXRT x-layers and pooler stay bit-identical; two
    augmentations from one seed bit-equal; then, at dropout 0 without
    augmentation, the attention kernels against the plain attention.
    Returns with the switches off."""
    t0 = time.perf_counter()
    model, optimizer, generator, batch = entry.train_entry(published=True)
    cfg = model.cfg
    log(f"published recipe: model and optimizer built in "
        f"{time.perf_counter() - t0:.1f} s (freeze_backbone "
        f"{cfg.freeze_backbone}, augment_type {cfg.data.augment_type})")
    set_tok_kernel(model, True)
    set_block_kernel(model, True)
    step = make_train_step(cfg, model, optimizer)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    step_counts = []
    for i in range(3):
        reset_counts()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        step_counts.append(counts())
        values = {k: v.item() for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"published step {i}: non-finite {values}")
        log(f"published step {i}: launches ({COUNT_NAMES}) "
            f"{step_counts[-1]}; {json.dumps(values)}")
    if any(c != (38, 34, 0, 0, 0, 0, 0, 0, 0, 0, 0) for c in step_counts):
        raise AssertionError(f"published step launches {step_counts}, "
                             "expected 38 attention forward, 34 backward, 0 "
                             "FFN, 0 tokenizer, 0 bottleneck")
    moved, tiny, frozen = moved_or_tiny(model, optimizer, before)
    trunk = [n for n, _ in model.named_parameters()
             if n.startswith("backbone.")]
    bn = {f"backbone.{n}.{k}" for n, m in model.backbone.named_modules()
          if isinstance(m, FrozenBatchNorm) for k in ("weight", "bias")}
    trunk_moved = {"conv": sum(n in moved for n in trunk if n not in bn),
                   "bn": sum(n in moved for n in bn)}
    if any(n in frozen for n in trunk) or not all(trunk_moved.values()):
        raise AssertionError(f"the trained trunk: {trunk_moved} tensors "
                             f"moved of {len(trunk)}")
    for name, value in model.named_buffers():
        if name in stats and not torch.equal(value, stats[name]):
            raise AssertionError(f"BatchNorm statistic {name} changed")
    log(f"published recipe: {len(moved)} trainable tensors moved (trunk: "
        f"{trunk_moved['conv']} conv weights, {trunk_moved['bn']} BatchNorm "
        f"weights and biases of {len(trunk)}), {len(tiny)} with updates "
        f"below f32 resolution {tiny}; {len(frozen)} disconnected (LXRT "
        f"x-layers, pooler) tensors and {len(stats)} BatchNorm statistics "
        "bit-identical")
    del before

    augmented = [model.normalize_frames(
        batch["frames"], torch.Generator(device="cuda").manual_seed(7))
        for _ in range(2)]
    model.eval()
    plain = model.normalize_frames(batch["frames"])
    model.train()
    if not torch.equal(augmented[0], augmented[1]):
        raise AssertionError("two augmentations from one seed differ")
    if torch.equal(augmented[0], plain):
        raise AssertionError("the augmentation left the frames alone")
    log(f"published recipe: two RandAugment calls from one seed bit-equal "
        f"({tuple(plain.shape)} {plain.dtype}); "
        f"{(augmented[0] != plain).float().mean().item():.3f} of the "
        "values changed")
    del augmented, plain

    # kernel vs plain attention with every dropout rate 0, no augmentation
    rates = {m: m.rate for m in model.modules() if isinstance(m, Dropout)}
    set_dropout_rate(model, 0.0)
    published_cfg = model.cfg
    model.cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                     augment_type="no_aug"))
    results = {}
    for name, attn in (("kernel", True), ("plain", False)):
        set_attention_kernel(model, attn)
        optimizer.zero_grad()
        loss, _ = compute_losses(cfg, model(batch, generator), batch)
        loss.backward()
        results[name] = (loss.item(), grad_norm(optimizer.params))
    optimizer.zero_grad()
    model.cfg = published_cfg
    set_attention_kernel(model, True)
    set_tok_kernel(model, False)
    set_block_kernel(model, False)
    for m, rate in rates.items():
        m.rate = rate
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    rel_loss, rel_grad = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
    log(f"published recipe, kernel vs plain attention (dropout 0, no_aug, "
        f"trunk trained, b{BATCH_SIZE}): loss {lk:.6f} vs {lp:.6f} (rel "
        f"{rel_loss:.2e}), grad norm {gk:.6f} vs {gp:.6f} (rel "
        f"{rel_grad:.2e})")
    if rel_loss > TRAIN_TOL or rel_grad > TRAIN_TOL:
        raise AssertionError(f"kernel and plain attention differ with the "
                             f"trunk trained: loss rel {rel_loss}, grad norm "
                             f"rel {rel_grad}")
    return model, optimizer, generator, batch, step_counts[-1]


def phase_train_published_throughput(frozen, published):
    """The frozen step and the published recipe's step at B=32 in turns
    (clips/s), the published step's split, each step's resident and peak
    device memory and host syncs, the top kernels of a published step and
    of the trunk's backward alone, and the tokenizer convs' forward, input
    gradient and weight gradient alone.  ``frozen`` and ``published`` are
    (model, optimizer, generator, batch)."""
    steps = {name: (make_train_step(m.cfg, m, o), b, g)
             for name, (m, o, g, b) in (("frozen", frozen),
                                         ("published", published))}
    runs = {"frozen": [], "published": []}
    for name in ("frozen", "published", "published", "frozen"):
        step, b, g = steps[name]
        runs[name].append(train_clips_per_second(step, b, g, **TRAIN_TURN))
    model, optimizer, generator, batch = published
    split = train_split_ms(model, optimizer, batch, generator)
    memory = {name: train_memory_gib(*steps[name]) for name in steps}
    syncs = {name: count_host_syncs(lambda s=steps[name]: s[0](s[1], s[2]))
             for name in steps}
    step, b, g = steps["published"]
    top, busy = breakdown.top_kernels(lambda: step(b, g), top=15)
    log(f"train throughput b{BATCH_SIZE} clips/s, frozen step vs the "
        f"published recipe (trunk trained, rand_aug): {json.dumps(runs)}; "
        f"published step split ms {json.dumps(split)}; device memory GiB "
        f"{json.dumps(memory)}; host syncs a step {json.dumps(syncs)}")
    log(f"published step: device busy {busy:.2f} ms; top kernels "
        f"{json.dumps(top)}")
    log(f"trunk backward alone (b{BATCH_SIZE}): "
        f"{json.dumps(breakdown.trunk_backward(model, batch['frames']))}")
    log(f"tokenizer convs alone (b{BATCH_SIZE}): "
        f"{json.dumps(breakdown.tok_conv_grads(model, batch['frames']))}")
    return {f"{k} (trunk {'trained, rand_aug' if k == 'published' else 'frozen'})":
            sum(v) / len(v) for k, v in runs.items()}, memory


# a turn of the train steps' clips/s readings (phases 7 and 9d): one
# warm-up step, then two timed (readings in turns, not checks)
TRAIN_TURN = dict(iters=2, warmup=1)


def phase_train_throughput(model, optimizer, generator, batch):
    """Train clips/s at B=32: kernel and plain attention in turns (unfused
    FFN), then the FFN train kernels and the unfused FFN in turns
    (attention kernels on); the step split of the attention-kernel step
    with each FFN."""
    step = make_train_step(model.cfg, model, optimizer)
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        set_attention_kernel(model, name == "kernel")
        runs[name].append(train_clips_per_second(step, batch, generator,
                                                 **TRAIN_TURN))
    set_attention_kernel(model, True)
    split = train_split_ms(model, optimizer, batch, generator)
    ffn_runs = {"ffn_kernel": [], "ffn_plain": []}
    for name in ("ffn_kernel", "ffn_plain", "ffn_plain", "ffn_kernel"):
        set_ffn_train_kernel(model, name == "ffn_kernel")
        ffn_runs[name].append(train_clips_per_second(step, batch, generator,
                                                     **TRAIN_TURN))
    set_ffn_train_kernel(model, True)
    ffn_split = train_split_ms(model, optimizer, batch, generator)
    set_ffn_train_kernel(model, False)
    log(f"train throughput b{BATCH_SIZE} clips/s: {json.dumps(runs)}; "
        f"kernel step split ms {json.dumps(split)}")
    log(f"train throughput b{BATCH_SIZE} clips/s, FFN train kernels vs "
        f"unfused FFN (attention kernels on): {json.dumps(ffn_runs)}; step "
        f"split ms with the FFN train kernels {json.dumps(ffn_split)}")
    runs.update(ffn_runs)
    return {k: sum(v) / len(v) for k, v in runs.items()}


# --stepsPerLoop (train/graph.py): k of the phase's chunks, and the steps of
# each equivalence run (chunk 1 eager, chunk 2 captured and replayed)
SPL_K, SPL_STEPS = 4, 8
# launches of one step of each recipe with the phase's switches on (the
# attention kernels, the FFN train kernels, the block switch): a published
# step's blocks run their convs under a gradient
SPL_LAUNCHES = {"frozen": (38, 34, 0, 18, 14, 0, 6, 0, 0, 0, 0),
                "published": (38, 34, 0, 18, 14, 0, 0, 0, 0, 0, 0)}
# the graph runs may differ from eager by no more than 2x eager's own spread
# (medians: of each graph run's distances to each eager run, and of the
# eager runs' distances to each other), and by 1e-6 relative where eager
# repeats to within that.  The samples are many because the dQ atomics'
# noise compounds step by step, and one graph run against three eager runs
# lay beyond 2x by chance (loss 3.5e-4 against a spread of 1.3e-4)
SPL_EAGER_RUNS, SPL_GRAPH_RUNS, SPL_SPREAD, SPL_FLOOR = 6, 4, 2.0, 1e-6
# the equivalence runs' batch: the same graph and steps as at B=32, each
# run's steps a quarter of the time (the clips/s readings stay at B=32)
SPL_EQ_BATCH = 8


def spl_batches(cfg, bsz, n):
    """``n`` distinct batches made on the card from one ``device_batch``:
    batch i's frames drawn anew (uint8, from seed 100 + i), its other
    fields rolled by i clips (numpy's frames of eight flagship batches
    take seconds on the host)."""
    base = entry.device_batch(cfg, bsz, 100, with_labels=True)
    batches = []
    for i in range(n):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        batch = {k: v.roll(i, 0) for k, v in base.items() if k != "frames"}
        batch["frames"] = torch.randint(0, 256, base["frames"].shape,
                                        dtype=torch.uint8, device="cuda",
                                        generator=g)
        batches.append(batch)
    return batches


def spl_state(model, optimizer, generator):
    """A copy of what a train step changes: the model's state, the moments,
    the step count and the generator's state."""
    return ({k: v.clone() for k, v in model.state_dict().items()},
            [t.clone() for t in optimizer.m + optimizer.v],
            optimizer.step_count, generator.get_state())


def spl_restore(model, optimizer, generator, state):
    params, moments, count, gen = state
    model.load_state_dict(params)
    with torch.no_grad():
        for dst, src in zip(optimizer.m + optimizer.v, moments):
            dst.copy_(src)
    optimizer.step_count = count
    optimizer.zero_grad()
    generator.set_state(gen)


def spl_eager(model, optimizer, generator, batches):
    """``len(batches)`` single train steps: their losses, the trainable
    parameters after and the generator's state."""
    step = make_train_step(model.cfg, model, optimizer)
    losses = torch.stack([step(b, generator)["total_loss"].detach()
                          for b in batches])
    return (losses.cpu(), [p.detach().clone() for p in optimizer.params],
            generator.get_state())


def spl_graph(model, optimizer, generator, batches):
    """The same steps as ``SPL_K``-step chunks (``train/graph.py``, the
    augmentation on its fixed-capacity path): chunk 1 eager, then one
    capture and one replay, with the launch counts of the chunk that
    captures.  Returns (losses, parameters, generator state), the counts
    and the ``StepChunks`` with its graph."""
    chunks = StepChunks(model, make_train_step(model.cfg, model, optimizer),
                        optimizer, generator, SPL_K)
    losses = [chunks.run(batches[:SPL_K])["total_loss"].clone()]
    torch.cuda.synchronize()
    reset_counts()
    losses.append(chunks.run(batches[SPL_K:])["total_loss"].clone())
    captured = counts()
    torch.cuda.synchronize()
    out = (torch.cat(losses).cpu(),
           [p.detach().clone() for p in optimizer.params],
           generator.get_state())
    if (chunks.captures, chunks.replays) != (1, 1):
        raise AssertionError(f"{chunks.captures} captures and "
                             f"{chunks.replays} replays, expected 1 and 1")
    return out, captured, chunks


def spl_distance(a, b):
    """(max relative difference of the per-step losses, relative Frobenius
    difference of all trainable parameters, generator states equal)."""
    (la, pa, ga), (lb, pb, gb) = a, b
    loss = ((la - lb).abs() / lb.abs()).max().item()
    num = sum((x - y).float().square().sum() for x, y in zip(pa, pb))
    den = sum(y.float().square().sum() for y in pb)
    return loss, (num / den).sqrt().item(), torch.equal(ga, gb)


def spl_equivalence(name, model, optimizer, generator, bsz=SPL_EQ_BATCH):
    """``SPL_STEPS`` steps from one saved state (the optimizer restarted)
    and generator seed: ``SPL_EAGER_RUNS`` times as single eager steps,
    then ``SPL_GRAPH_RUNS`` times as ``SPL_K``-step chunks through a graph
    (a capture each); every loss finite.  The attention backward sums dQ
    with atomics, so eager does not repeat its bits.  In their per-step
    losses and in their parameters, the graph runs' median distance to the
    eager runs may be at most ``SPL_SPREAD`` x the median distance between
    two eager runs, at least ``SPL_FLOOR``; where eager repeats bit-equal
    the graph must too.  Each graph run ends with the generator's state of
    every eager run; each chunk that captures launches ``SPL_K`` steps'
    kernels.  Returns the last ``StepChunks`` with its graph."""
    batches = spl_batches(model.cfg, bsz, SPL_STEPS)
    # the optimizer restarts, as after a weight import: the earlier phases'
    # steps on one batch at the schedule's peak leave the random model near
    # divergence, where eager and graph runs alike may turn NaN
    with torch.no_grad():
        for t in optimizer.m + optimizer.v:
            t.zero_()
    optimizer.step_count = 0
    generator.manual_seed(11)
    start = spl_state(model, optimizer, generator)
    t0 = time.perf_counter()
    eager = []
    for _ in range(SPL_EAGER_RUNS):
        spl_restore(model, optimizer, generator, start)
        eager.append(spl_eager(model, optimizer, generator, batches))
    graphs, chunks = [], None
    want = tuple(SPL_K * c for c in SPL_LAUNCHES[name])
    for _ in range(SPL_GRAPH_RUNS):
        del chunks
        gc.collect()
        spl_restore(model, optimizer, generator, start)
        graph_run, captured, chunks = spl_graph(model, optimizer, generator,
                                                batches)
        graphs.append(graph_run)
        log(f"steps per loop, {name}: launches while capturing "
            f"({COUNT_NAMES}) {captured}")
        if captured != want:
            raise AssertionError(f"{name}: capture launched {captured}, "
                                 f"expected {want}")
    spl_restore(model, optimizer, generator, start)
    del start, batches
    pairs = [spl_distance(eager[i], eager[j])
             for i in range(len(eager)) for j in range(i + 1, len(eager))]
    gaps = [spl_distance(g, e) for g in graphs for e in eager]
    log(f"steps per loop, {name} b{bsz}: {SPL_STEPS} steps, k={SPL_K}, "
        f"{time.perf_counter() - t0:.1f} s; "
        f"losses eager {[e[0].tolist() for e in eager]}, graph "
        f"{[g[0].tolist() for g in graphs]}; eager pairs (loss, parameters, "
        f"generator equal) {pairs}; each graph run vs each eager run {gaps}")
    if not all(torch.isfinite(run[0]).all() for run in eager + graphs):
        raise AssertionError(f"{name}: a non-finite loss")
    if not all(g[2] for g in gaps + pairs):
        raise AssertionError(f"{name}: the generator's state after the "
                             "graph run differs from eager")
    for i, what in enumerate(("loss", "parameters")):
        if max(p[i] for p in pairs) == 0.0 and max(g[i] for g in gaps):
            raise AssertionError(f"{name}: eager repeats its {what} "
                                 f"bit-equal, the graph differs by "
                                 f"{[g[i] for g in gaps]}")
        spread = statistics.median(p[i] for p in pairs)
        near = statistics.median(g[i] for g in gaps)
        log(f"steps per loop, {name}: {what}, median graph-eager {near}, "
            f"median eager-eager {spread}")
        if near > max(SPL_SPREAD * spread, SPL_FLOOR):
            raise AssertionError(f"{name}: the graph's {what} differ by "
                                 f"{near} (median), eager's own spread "
                                 f"{spread} (median)")
    return chunks


def busy_share(fn, tries: int = 3):
    """(device busy ms, host ms, busy share) of one ``fn()`` under
    torch.profiler, tracing the card only (a trace can miss every kernel:
    it tries again); None where no trace holds device time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        if busy > 0.0:
            return busy, wall, busy / wall
    return None


def spl_throughput(name, model, optimizer, generator, batch, chunks=None):
    """Train clips/s at k=1 (2 steps) and k=``SPL_K`` (a replay), one turn
    each, on ``batch``, through ``chunks`` (a ``StepChunks`` whose
    graph holds these shapes) or a graph captured here first; the device
    busy share of 2 eager steps and of one replay; the host syncs, peak
    memory and reserved memory of a step and of a replayed chunk."""
    t0 = time.perf_counter()
    bsz = batch["frames"].shape[0]
    cfg = model.cfg
    step = make_train_step(cfg, model, optimizer)
    if chunks is None:
        chunked = chunked_step(model, optimizer, generator, SPL_K)
        for _ in range(2):                  # the eager chunk, the capture
            chunked(batch, generator)
        chunks = chunked.chunks

    def chunked(b, _g=None):
        return chunks.run([b] * SPL_K)

    runs = {"k=1": [], f"k={SPL_K}": []}
    for k in (1, SPL_K):
        if k == 1:
            runs["k=1"].append(train_clips_per_second(
                step, batch, generator, iters=2, warmup=1))
        else:
            runs[f"k={k}"].append(train_clips_per_second(
                chunked, batch, generator, iters=1, warmup=0, steps=k))

    def eager_chunk():
        for _ in range(2):
            step(batch, generator)

    busy = {"k=1": busy_share(eager_chunk),
            f"k={SPL_K}": busy_share(lambda: chunked(batch, generator))}
    memory, syncs = {}, {}
    for k, fn in (("k=1", step), (f"k={SPL_K}", chunked)):
        # one call: its host syncs, and the allocator's peak and reserved
        # memory (a graph's pool is reserved, its tensors' peak unseen)
        torch.cuda.reset_peak_memory_stats()
        syncs[k] = count_host_syncs(lambda: fn(batch, generator))
        memory[k] = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}
    log(f"steps per loop, {name} b{bsz}: train clips/s {json.dumps(runs)}; "
        f"device busy ms, host ms, share (2 eager steps; one replay) "
        f"{json.dumps(busy)}; device memory GiB {json.dumps(memory)}; host "
        f"syncs {json.dumps(syncs)}; {time.perf_counter() - t0:.1f} s")
    if syncs[f"k={SPL_K}"]["count"]:
        raise AssertionError(f"{name} b{bsz}: a replayed chunk synced the "
                             "host")
    del chunked, chunks
    optimizer.zero_grad()
    gc.collect()
    torch.cuda.empty_cache()
    return {k: sum(v) / len(v) for k, v in runs.items()}


def spl_augment_ms(model, batch):
    """The published augmentation alone at the batch's size (its two
    RandAugment layers at apply 0.5): device ms by events with the
    sub-batch path, with the select tree and with the fixed-capacity path
    eagerly (median [min, max] of 3 turns of 5 calls), the three bit-equal
    from one seed; then the fixed-capacity path captured into a CUDA graph
    (its overflow branches as conditional nodes) on static draws, replayed
    with draws under every class's capacity and with draws where every clip
    rotates (over the capacities): each replay bit-equal to the select tree
    on the same draws, and the replay's device ms."""
    data = model.cfg.data
    x = batch["frames"].to(torch_dtype(data.aug_dtype
                                       or model.cfg.compute_dtype)) / 255.0
    kind = data.augment_type
    paths = {"sub-batch": "subbatch", "select tree": "select",
             "fixed capacity eager": "capacity"}
    out, ms = {}, {}
    for key, path in paths.items():
        out[key] = augment_clips(x, kind, torch.Generator(
            device="cuda").manual_seed(7), path)
        g = torch.Generator(device="cuda").manual_seed(7)
        ms.update(spread(key, lambda: augment_clips(x, kind, g, path),
                         turns=3, iters=5, warmup=1))
    if not (torch.equal(out["sub-batch"], out["select tree"])
            and torch.equal(out["fixed capacity eager"],
                            out["select tree"])):
        raise AssertionError("the augmentation's three paths differ")
    ms.update(spl_augment_graph(x))
    log(f"steps per loop: augment b{x.shape[0]} ms {json.dumps(ms)}; the "
        "three paths bit-equal")
    return ms


def spl_augment_graph(x, layers=2, prob=0.5):
    """The fixed-capacity RandAugment of ``x`` captured on static draws and
    replayed with and without overflow (``spl_augment_ms``)."""
    bsz, dev = x.shape[0], x.device
    g = torch.Generator(device=dev).manual_seed(21)
    op, apply, sign = (t.clone() for t in sample_rand_augment(
        bsz, layers, prob, g, dev))

    def run():
        return transforms._augment(x, op, apply, sign, 9, 8, "capacity",
                                   prob)

    def over_capacity(draw):
        o = torch.where(draw[1], draw[0], torch.zeros_like(draw[0]))
        caps = [(ids, transforms._class_cap(bsz, prob * len(ids) / 14.0))
                for _, ids in transforms._GATHERED]
        return any(int(sum((o[:, layer] == i).sum() for i in ids)) > cap
                   for ids, cap in caps for layer in range(layers))

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side), cond.warm_up():
        run()                              # the warm-up: both branches
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    nodes = cond.branch.nodes
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        y = run()
    nodes = cond.branch.nodes - nodes
    ms = {}
    rotate = (torch.full_like(op, transforms._GEO_ROT),
              torch.ones_like(apply), torch.ones_like(sign))
    for case, draw in (("no overflow", None), ("overflow", rotate)):
        while draw is None or (case == "no overflow" and
                               over_capacity(draw)):
            draw = sample_rand_augment(bsz, layers, prob, g, dev)
        if over_capacity(draw) != (case == "overflow"):
            raise AssertionError(f"augment graph: the {case} draws")
        for dst, src in zip((op, apply, sign), draw):
            dst.copy_(src)
        graph.replay()
        want = transforms._augment(x, op, apply, sign, 9, 8, "select")
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"augment graph, {case}: the replay "
                                 "differs from the select tree")
        ms.update(spread(f"fixed capacity graph, {case}", graph.replay,
                         turns=3, iters=5, warmup=1))
    log(f"steps per loop: the fixed-capacity augmentation captured with "
        f"{nodes} conditional nodes; replays with and without overflow "
        "bit-equal to the select tree")
    del graph
    return ms


def phase_steps_per_loop(name, recipe):
    """``--stepsPerLoop``'s k-step CUDA graph (``train/graph.py``) on the
    flagship with the attention kernels, the FFN train kernels and the
    block switch, for ``name`` "frozen" (the trunk frozen) or "published"
    (the published recipe): the graph against eager steps at B=8
    (``spl_equivalence``), then clips/s at k=1 and k=``SPL_K`` in turns at
    B=32 (``spl_throughput``, its own capture), published also the
    augmentation's two paths (``spl_augment_ms``).  ``recipe`` is (model,
    optimizer, generator, batch); the switches are off again after."""
    model, optimizer, generator, batch = recipe
    out = {}
    t0 = time.perf_counter()
    set_block_kernel(model, True)
    set_ffn_train_kernel(model, True)
    try:
        spl_equivalence(name, model, optimizer, generator)
        out[f"{name} b{batch['frames'].shape[0]}"] = spl_throughput(
            name, model, optimizer, generator, batch)
        if name == "published":
            out["augment ms"] = spl_augment_ms(model, batch)
    finally:
        set_block_kernel(model, False)
        set_ffn_train_kernel(model, False)
    log(f"steps per loop, {name}: {time.perf_counter() - t0:.1f} s")
    return out


class _Recorded(loop.Trainer):
    """The driver's Trainer, kept for the checks after its run."""

    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _Recorded.made.append(self)


# the driver of phase 7b runs as data parallelism's NCCL group of one
# (--multiGPU on one card, phase ddp (a)): 2 epochs of 96 clips at B=32 (a
# 2-step chunk and a single step each), 8 valid clips (one eval forward an
# epoch, AGQA's eval batch a quarter of the train batch)
SPL_DRIVER_STEPS, SPL_DRIVER_EVALS = 6, 2
# all-reduces of a train step (per-frame matching: each set loss's
# normalizer and its accuracy's counts, then one flat buffer of the
# gradients and the metrics' shares) and of a valid forward with labels
# (its class accuracy: the set losses' four)
DDP_STEP_ALL_REDUCES, DDP_EVAL_ALL_REDUCES = 5, 4


def phase_driver_steps_per_loop(tmp: str, files: dict):
    """The driver at the published flags with ``--pallasFFNTrain
    --stepsPerLoop 2 --multiGPU`` on 96 synthetic clips at B=32 (3 steps an
    epoch: a chunk of 2 and a single step), its trunk from
    ``--backboneWeights``, two epochs, on one card: a process group of one
    on NCCL (phase ddp (a)); finite losses at 6 steps, one capture and one
    replay, the launches of 6 steps run on the host (the eager chunk, the
    capture and two single steps), ``DDP_STEP_ALL_REDUCES`` all-reduces a
    step and ``DDP_EVAL_ALL_REDUCES`` an eval forward, 2 steps' all-reduces
    inside the captured chunk, the reserved device memory after each chunk
    (the eager one; the capture, which empties the allocator's cache, and
    its replay); LAST reloaded bit-equal; ``--test --multiGPU`` from it
    (oracle 1.0, the NCCL group)."""
    t0 = time.perf_counter()
    out, data = os.path.join(tmp, "spl"), os.path.join(tmp, "spl_data")
    os.makedirs(data, exist_ok=True)
    argv = DRIVER_FLAGS + [
        "--syntheticData", "96", "--syntheticValid", "8", "--batchSize",
        str(BATCH_SIZE), "--logFreq", "1", "--output", out, "--dataDir",
        data, "--epochs", "2", "--stepsPerLoop", "2", "--backboneWeights",
        files["trunk"], "--multiGPU"]
    saved, _Recorded.made = common.Trainer, []
    common.Trainer = _Recorded
    run, capture, reserved, in_graph = StepChunks.run, StepChunks._capture, \
        [], []

    def recorded(chunks, batches):
        out = run(chunks, batches)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved() / 2 ** 30)
        return out

    def counted_capture(chunks):
        before = distributed.all_reduce_sum_.launches
        capture(chunks)
        in_graph.append(distributed.all_reduce_sum_.launches - before)

    StepChunks.run, StepChunks._capture = recorded, counted_capture
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()
        before = distributed.all_reduce_sum_.launches
        result, _, seconds = run_main(argv)
        launched = counts()
        reduces = distributed.all_reduce_sum_.launches - before
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        common.Trainer, StepChunks.run, StepChunks._capture = (saved, run,
                                                               capture)
    trainer = _Recorded.made[-1]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    chunks = trainer.chunks
    steps = SPL_DRIVER_STEPS
    if result.get("process_group") != {"backend": "nccl", "world": 1,
                                       "rank": 0}:
        raise AssertionError(f"driver --multiGPU on one card: process group "
                             f"{result.get('process_group')}")
    if (result["steps"], len(losses)) != (steps, steps) or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"driver at --stepsPerLoop 2: {result['steps']} "
                             f"steps, losses {losses}")
    if chunks is None or (chunks.captures, chunks.replays) != (1, 1):
        raise AssertionError("driver at --stepsPerLoop 2: not one capture "
                             "and one replay")
    want = tuple(steps * t + SPL_DRIVER_EVALS * e for t, e in
                 zip(DRIVER_TRAIN_LAUNCHES, EVAL_MODES[0][1]))
    if launched != want:
        raise AssertionError(f"driver at --stepsPerLoop 2 launched "
                             f"{launched}, expected {want} ({steps} steps, "
                             f"{SPL_DRIVER_EVALS} eval forwards)")
    want_reduces = (steps * DDP_STEP_ALL_REDUCES
                    + SPL_DRIVER_EVALS * DDP_EVAL_ALL_REDUCES)
    if reduces != want_reduces or in_graph != [2 * DDP_STEP_ALL_REDUCES]:
        raise AssertionError(f"driver --multiGPU: {reduces} all-reduces "
                             f"(expected {want_reduces}), {in_graph} while "
                             f"capturing (expected "
                             f"{[2 * DDP_STEP_ALL_REDUCES]})")
    reload_bit_equal(trainer.model, os.path.join(out, "LAST"), "")
    del trainer, chunks, _Recorded.made[:]
    gc.collect()
    torch.cuda.empty_cache()
    test_out = os.path.join(tmp, "spl_test")
    argv_test = [a if a != out else test_out for a in argv] + [
        "--test", "test", "--load", os.path.join(out, "LAST")]
    test, stdout, test_seconds = run_main(argv_test)
    if "Oracle score: 1.0000" not in stdout or test.get(
            "process_group", {}).get("backend") != "nccl":
        raise AssertionError("--test --multiGPU from the --stepsPerLoop 2 "
                             "LAST: oracle score not 1.0, or no NCCL group")
    log(f"driver --stepsPerLoop 2 --multiGPU: process group "
        f"{json.dumps(result['process_group'])}; {steps} steps, losses "
        f"{losses}, 1 capture and 1 replay, launches ({COUNT_NAMES}) "
        f"{launched} ({steps} steps on the host and {SPL_DRIVER_EVALS} eval "
        f"forwards), all-reduces {reduces} ({DDP_STEP_ALL_REDUCES} a step, "
        f"{DDP_EVAL_ALL_REDUCES} an eval forward), {in_graph[0]} in the "
        f"captured chunk; reserved GiB after the eager chunk and after the "
        f"capture and replay {reserved}, peak allocated GiB {peak}, LAST "
        f"reloads bit-equal, --test --multiGPU oracle 1.0; {seconds:.1f} s "
        f"and {test_seconds:.1f} s, {time.perf_counter() - t0:.1f} s in all")
    return losses


def reload_bit_equal(model, path: str, tag: str):
    """A fresh model of ``model``'s config, built with other random weights,
    loads the checkpoint at ``path`` through ``Trainer.load``; every tensor
    of its state must equal ``model``'s bit for bit.  Returns the fresh
    model."""
    cfg = model.cfg
    fresh = entry.build_model(cfg, "cuda", seed=cfg.seed + 1)
    Trainer(cfg, 1, fresh, trainable_mask(fresh, cfg)).load(path)
    trained = model.state_dict()
    for name, value in fresh.state_dict().items():
        if not torch.equal(value, trained[name]):
            raise AssertionError(f"{tag}LAST reloads {name} differently")
    return fresh


class _Counted:
    """Wraps the train and eval steps the driver's Trainer builds so that
    every launch count is set to 0 just before each step and read just
    after it; keeps the driver's model.  With ``sync`` off (steps that a
    CUDA graph captures) it neither synchronizes nor reads the loss.  The
    attention dumps (``--outputAttn``) are counted the same way, a whole
    dump at a time: ``dumps`` holds (launches, the dump's summary)."""

    def __init__(self, sync: bool = True):
        self.train, self.eval, self.losses, self.model = [], [], [], None
        self.dumps = []
        self.sync = sync

    def __enter__(self):
        self._saved = (loop.make_train_step, loop.make_eval_step,
                       common._dump_attentions)
        make_train, make_eval, dump = self._saved

        def counted_dump(*a, **kw):
            torch.cuda.synchronize()
            reset_counts()
            summary = dump(*a, **kw)
            torch.cuda.synchronize()
            self.dumps.append((counts(), summary))
            return summary

        common._dump_attentions = counted_dump

        def counted(make, sink, keep_loss):
            def build(cfg, model, *args, **kw):
                fn = make(cfg, model, *args, **kw)
                self.model = model

                def run(*a):
                    if self.sync:
                        torch.cuda.synchronize()
                    reset_counts()
                    out = fn(*a)
                    sink.append(counts())
                    if self.sync:
                        torch.cuda.synchronize()
                        if keep_loss:
                            self.losses.append(out["total_loss"].item())
                    return out
                return run
            return build

        loop.make_train_step = counted(make_train, self.train, True)
        loop.make_eval_step = counted(make_eval, self.eval, False)
        return self

    def __exit__(self, *exc):
        (loop.make_train_step, loop.make_eval_step,
         common._dump_attentions) = self._saved


def run_main(argv, main=agqa_hgqa.main):
    """``main(argv)`` (the agqa_hgqa driver's by default) on the card; its
    stdout is captured, then printed.  Returns (result, stdout, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            result = main(argv)
    finally:
        for line in out.getvalue().splitlines():
            log(f"  | {line}")
    return result, out.getvalue(), time.perf_counter() - t0


# a dumps forward: the FFN kernel at its 18 sites and no attention kernel;
# globally matched grids add the matcher's two problems
DUMPS_LAUNCHES = (0, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)
# the HG cross encoder's tokens: CLS + 16 situations x (3 actions + 8
# relations)
HG_TOKENS = 1 + NUM_SITUATIONS * (3 + 8)


def driver_argv(tmp: str, out: str, *extra: str):
    """The published flags on synthetic data at B=32 (eval B=8)."""
    return DRIVER_FLAGS + ["--syntheticData", "64", "--syntheticValid", "32",
                           "--batchSize", str(BATCH_SIZE), "--logFreq", "1",
                           "--output", out, "--dataDir", tmp, *extra]


def phase_driver(tmp: str, files: dict):
    """The agqa_hgqa driver at the published flags with --pallasFFNTrain at
    B=32 on synthetic data, its trunk from ``--backboneWeights`` (the
    calibrated trunk file of ``write_weight_files``): two epochs (launch
    counts per train step and per eval forward, finite losses,
    checkpoints, LAST reloaded bit-equal), then the test protocol from
    --load LAST (oracle 1.0, predict files)."""
    out = os.path.join(tmp, "train")
    argv = driver_argv(tmp, out, "--epochs", "2", "--backboneWeights",
                       files["trunk"])
    with _Counted() as counted:
        result, stdout, seconds = run_main(argv)
    if f"Loaded pretrained backbone from {files['trunk']}" not in stdout:
        raise AssertionError("the driver did not load --backboneWeights")
    want_train, want_eval = DRIVER_TRAIN_LAUNCHES, EVAL_MODES[0][1]
    if len(counted.train) != 4 or any(c != want_train for c in counted.train):
        raise AssertionError(f"driver train steps launched {counted.train}, "
                             f"expected 4 x {want_train}")
    if len(counted.eval) != 8 or any(c != want_eval for c in counted.eval):
        raise AssertionError(f"driver eval forwards launched {counted.eval}, "
                             f"expected 8 x {want_eval}")
    if not all(math.isfinite(v) for v in counted.losses):
        raise AssertionError(f"driver losses {counted.losses}")
    names = set(os.listdir(out))
    if not {"CURRENT", "LAST", "log.log", "metrics.jsonl"} <= names:
        raise AssertionError(f"driver output {sorted(names)}")
    epochs = [float(s) for s in re.findall(r"Epoch \d+: \d+ steps in "
                                           r"([\d.]+)s", stdout)]
    log(f"driver: {result['steps']} steps, launches per train step "
        f"({COUNT_NAMES}) {counted.train[0]}, "
        f"per eval forward {counted.eval[0]}; losses {counted.losses}; "
        f"epochs {epochs} s; history {result['history']}; files "
        f"{sorted(names)}; {seconds:.1f} s")

    train_counts = counted.train
    # LAST reloads bit-equal into a fresh model
    reload_bit_equal(counted.model, os.path.join(out, "LAST"), "")
    del counted
    gc.collect()
    torch.cuda.empty_cache()
    log("driver: LAST reloads bit-equal")

    # the test protocol from LAST, then again with --pallasAttention (the
    # attention forward kernel at every site of each eval forward)
    for extra, want in EVAL_MODES:
        test_out = os.path.join(tmp, "test" + "".join(extra))
        argv_test = [a if a != out else test_out for a in argv] + [
            "--test", "test", "--load", os.path.join(out, "LAST")] + extra
        with _Counted() as counted:
            result, stdout, seconds = run_main(argv_test)
        if "Oracle score: 1.0000" not in stdout:
            raise AssertionError(f"the test protocol's oracle score {extra} "
                                 "is not 1.0")
        if len(counted.eval) != 4 or any(c != want for c in counted.eval):
            raise AssertionError(f"test forwards {extra} launched "
                                 f"{counted.eval}, expected 4 x {want}")
        for name in ("predict.json", "predict_hg.json"):
            with open(os.path.join(test_out, name)) as f:
                if len(json.load(f)) != 32:
                    raise AssertionError(f"{name} does not hold 32 answers")
        log(f"driver --test {' '.join(extra)}: oracle 1.0, predict files of "
            f"32 answers, launches per eval forward {counted.eval[0]}, "
            f"{seconds:.1f} s")
    # --outputAttn: the attention dumps of a test split of 8 questions, one
    # batch (its zero label grids matched per frame by the subset DP, not
    # the matcher kernel), every attention on the plain path
    test_out = os.path.join(tmp, "test_attn")
    argv_test = [a if a != out else test_out for a in argv] + [
        "--test", "test", "--load", os.path.join(out, "LAST"),
        "--outputAttn", "--syntheticValid", "8"]
    with _Counted() as counted:
        result, stdout, seconds = run_main(argv_test)
    check_dumps("driver --test --outputAttn", counted, test_out, 8,
                DUMPS_LAUNCHES, hg_tokens=HG_TOKENS, grids=True)
    if counted.eval != [EVAL_MODES[0][1]]:
        raise AssertionError(f"driver --test --outputAttn forwards launched "
                             f"{counted.eval}")
    log(f"driver --test --outputAttn: {seconds:.1f} s")
    return train_counts, epochs


def check_dumps(tag, counted, out, questions, want, hg_tokens, grids,
                per_choice=False):
    """One ``--outputAttn`` dump of ``questions`` questions under ``out``:
    ``want`` launches per batch (no attention kernel), both JSON files with
    an entry a question, each attention (heads, ``hg_tokens``), the grids
    (S, slots) where ``grids``, the npz maps' keys (under per-choice the HG
    encoder's maps with 4 rows a clip).  Logs the dump's host seconds."""
    if len(counted.dumps) != 1:
        raise AssertionError(f"{tag}: {len(counted.dumps)} dumps")
    launched, summary = counted.dumps[0]
    batches = summary["batches"]
    if launched != tuple(batches * w for w in want):
        raise AssertionError(f"{tag}: the dump launched {launched}, "
                             f"expected {batches} x {want}")
    for name in ("val_attentions_cross_2.json",
                 "hg_val_attentions_cross_2.json"):
        with open(os.path.join(out, name)) as f:
            entries = json.load(f)
        if len(entries) != questions:
            raise AssertionError(f"{tag}: {name} holds {len(entries)} "
                                 f"entries, expected {questions}")
        for e in entries:
            if np.asarray(e["attention"]).shape != (H, hg_tokens):
                raise AssertionError(f"{tag}: an attention of shape "
                                     f"{np.asarray(e['attention']).shape}")
            if "rel_pred" in e and np.asarray(e["rel_pred"]).shape != (
                    NUM_SITUATIONS, 8):
                raise AssertionError(f"{tag}: a rel grid of shape "
                                     f"{np.asarray(e['rel_pred']).shape}")
        if name.startswith("val") and grids != ("rel_pred" in entries[0]):
            raise AssertionError(f"{tag}: grids {'rel_pred' in entries[0]},"
                                 f" expected {grids}")
    with np.load(os.path.join(out, "attentions", "batch000.npz")) as maps:
        keys = set(maps.files)
        need = {"ques_ids", "attn.encoder.lang.4", "attn.encoder.visn.4",
                "attn.encoder.cross.1.xl", "attn.encoder.cross.1.xv",
                "attn.hgq.1.xl", "attn.hgq.1.xv"}
        if not need <= keys:
            raise AssertionError(f"{tag}: npz keys {sorted(keys)}")
        rows = maps["attn.hgq.1.xl"].shape[0]
        clips = len(maps["ques_ids"])
        if rows != clips * (4 if per_choice else 1):
            raise AssertionError(f"{tag}: the HG maps have {rows} rows for "
                                 f"{clips} clips")
    log(f"{tag}: {questions} questions in {batches} batches, launches per "
        f"batch ({COUNT_NAMES}) {want}, {len(keys) - 1} maps a batch, dump "
        f"host seconds {summary['seconds']:.2f}")
    return summary["seconds"]


# README.md's STAR line (cli/star.py) with --noCaps, at --stepsPerLoop 2
STAR_FLAGS = ["--taskHGQA", "--useHGMask", "--qType", "Interaction",
              "--qaArrangeType", "add_sep_all", "--batchSize", "8",
              "--noCaps", "--stepsPerLoop", "2"]
# --qType Interaction keeps one synthetic question in four: 128 give four
# B=8 steps an epoch (two 2-step chunks), 16 valid one eval forward of 4
STAR_DATA = ["--syntheticData", "128", "--syntheticValid", "16",
             "--logFreq", "1", "--epochs", "2"]
# launches of a STAR train step (the trunk frozen, the global matcher) and
# of a valid forward with labels (its class accuracy matched globally);
# the eval modes of --test (no labels: no matching)
STAR_TRAIN_LAUNCHES = (38, 34, 0, 0, 0, 0, 0, 0, 0, 2, 0)
# under the hg mask, a kernel path's output may differ from the masked plain
# run by at most this share of the mask's effect on the plain path, and the
# mask must move the kernel path by at least this share of that effect
# (star_mask_kernels): between the kernels' noise (hg_logit ~4.6e-3 of an
# effect of ~2.5e-2 on an NVIDIA H100 80GB HBM3 at 700 W) and the whole
# effect, where a kernel that dropped the mask lands
MASK_SHARE = 0.5
STAR_VALID_LAUNCHES = (0, 0, 18, 0, 0, 0, 0, 0, 0, 2, 0)
STAR_TEST_MODES = (([], (0, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)),
                   (["--pallasAttention"], (38, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)))


@contextlib.contextmanager
def matchings(replay=None):
    """While it lasts, the set losses' matchings (``set_prediction``'s
    ``match_targets_global`` and ``match_targets_per_frame``) are recorded,
    in call order, into the list it yields; given ``replay`` (such a list),
    each call returns the recorded result of its place instead."""
    saved = (set_prediction.match_targets_global,
             set_prediction.match_targets_per_frame)
    got = []

    def wrap(real):
        def match(*args, **kwargs):
            if replay is not None:
                got.append(replay[len(got)])
            else:
                got.append(tuple(t.clone() for t in real(*args, **kwargs)))
            return got[-1]
        return match

    set_prediction.match_targets_global = wrap(saved[0])
    set_prediction.match_targets_per_frame = wrap(saved[1])
    try:
        yield got
    finally:
        (set_prediction.match_targets_global,
         set_prediction.match_targets_per_frame) = saved


def star_mask_kernels(trainer):
    """The attention paths under ``--useHGMask`` with an hg mask that is not
    a prefix, on the STAR driver's model (its calibrated trunk) at B=8:
    the eval forward's hg_logit with ``--pallasAttention`` (38 attention
    forwards) and with the head-sliced switch (38 head-sliced), and a train
    step's loss and gradients with the training kernels at dropout 0.
    Each runs with the mask and with the mask all ones, on the kernel path
    and on the plain path; the mask's effect is the plain path's change.
    Every kernel path must be nearer the masked plain run than the
    unmasked one, within TRAIN_TOL of it (phases 4 and 6), and moved by
    the mask itself by at least ``MASK_SHARE`` of the effect; hg_logit and
    the loss must also be within ``MASK_SHARE`` of the effect of the masked
    plain run.  The gradients are not held to that share: through the
    bf16 backward their distance to plain is about half the effect.  A
    kernel that dropped the mask would not move
    with it and would land a whole effect away.  Each train run matches
    its own set predictions; a reading (no limit) gives the masked kernel
    run's loss on the masked plain run's matching, the loss terms, and the
    slots the two runs' own matchings assign differently."""
    model, cfg = trainer.model, trainer.model.cfg
    batch = entry.device_batch(cfg, 8, 5, with_labels=True)
    g = torch.Generator(device="cuda").manual_seed(5)
    mask = torch.rand(batch["hg_mask"].shape, device="cuda", generator=g)
    batch["hg_mask"] = (mask < 0.6).to(torch.int32)
    batch["hg_mask"][:, :, 0] = 0                   # a hole at every start
    inputs = {True: batch, False: dict(
        batch, hg_mask=torch.ones_like(batch["hg_mask"]))}
    model.eval()
    outs = {}
    for name, switch, at in (("plain", None, None),
                             ("pallasAttention", set_attention_kernel_eval,
                              0),
                             ("headsliced", set_headsliced_kernel, 8)):
        for masked, b in inputs.items():
            if switch is not None:
                switch(model, True)
            reset_counts()
            outs[(name, masked)] = entry.hg_logit_forward(model, b).float()
            launched = counts()
            if switch is not None:
                switch(model, False)
                if launched[at] != 38:
                    raise AssertionError(f"STAR hg mask, {name}: launches "
                                         f"{launched}")
    rates = {m: m.rate for m in model.modules() if isinstance(m, Dropout)}
    set_dropout_rate(model, 0.0)
    model.train()
    train, terms, matched = {}, {}, {}
    for name, attn in (("kernel", True), ("plain", False)):
        set_attention_kernel(model, attn)
        for masked, b in inputs.items():
            trainer.optimizer.zero_grad()
            with matchings() as matched[(name, masked)]:
                loss, metrics = compute_losses(cfg, model(b, g), b)
            loss.backward()
            train[(name, masked)] = (
                loss.detach().float().reshape(1), torch.cat(
                    [p.grad.float().flatten() for p in trainer.optimizer.params
                     if p.grad is not None]))
            terms[(name, masked)] = [
                round(float(metrics[k]), 6)
                for k in ("hgqa_loss", "rel_loss", "act_loss")]
    trainer.optimizer.zero_grad()
    set_attention_kernel(model, True)
    with matchings(matched[("plain", True)]):
        forced = compute_losses(cfg, model(batch, g), batch)[0].detach()
    for m, rate in rates.items():
        m.rate = rate
    model.eval()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    # (tag, kernel with the mask, kernel with ones, plain with the mask,
    # plain with ones, held to MASK_SHARE of the effect)
    cases = [(f"hg_logit {name}", outs[(name, True)], outs[(name, False)],
              outs[("plain", True)], outs[("plain", False)], True)
             for name in ("pallasAttention", "headsliced")]
    cases += [(f"train {what}", train[("kernel", True)][i],
               train[("kernel", False)][i], train[("plain", True)][i],
               train[("plain", False)][i], i == 0)
              for i, what in enumerate(("loss", "gradients"))]
    report, faults = [], []
    for tag, got, got_ones, masked, ones, share in cases:
        near, far = rel(got, masked), rel(got, ones)
        effect, own = rel(ones, masked), rel(got_ones, got)
        report.append(f"{tag}: rel to masked plain {near:.3e}, to unmasked "
                      f"plain {far:.3e}, the mask's effect {effect:.3e} on "
                      f"plain and {own:.3e} on the kernel path")
        limit = min(TRAIN_TOL, MASK_SHARE * effect) if share else TRAIN_TOL
        if (effect == 0.0 or near > limit or near >= far
                or own < MASK_SHARE * effect):
            faults.append(tag)
    differ = [f"{int((k[0] != p[0]).sum())} of {k[0].numel()}" for k, p in
              zip(matched[("kernel", True)], matched[("plain", True)])]
    log(f"STAR hg mask (not a prefix, b8), kernel paths vs the plain path "
        f"(relative Frobenius; limits: {MASK_SHARE} x the effect for "
        f"hg_logit and the loss, {TRAIN_TOL}; the kernel's own effect at "
        f"least {MASK_SHARE} x plain's): " + "; ".join(report))
    forced = rel(forced.float().reshape(1), train[("plain", True)][0])
    log(f"STAR hg mask, train loss readings (no limit): the masked kernel "
        f"run on the masked plain run's matching {forced:.3e} from the "
        f"masked plain run; the two runs' own matchings assign "
        f"{', '.join(differ)} (relation, action) target slots differently; "
        f"(hg, relation, action) loss terms "
        + json.dumps({f"{n} {'masked' if m else 'ones'}": v
                      for (n, m), v in terms.items()}))
    if faults:
        raise AssertionError(f"STAR hg mask: {faults} not held to the "
                             "masked plain run")


def phase_star_driver(tmp: str, files: dict):
    """``cli.star.main`` at README.md's STAR flags with ``--noCaps
    --stepsPerLoop 2`` at B=8 on synthetic STAR, its trunk from
    ``--backboneWeights``, two epochs of four steps: the launch counts of
    every step run on the host (the eager chunk and the capture; a replay
    runs no Python) and of every valid forward, one capture and three
    replays, finite losses, LAST reloaded bit-equal; then ``--test`` from
    LAST (oracle 1.0, ``by_qtype``, both predict files), plain and with
    ``--pallasAttention``; between them ``star_mask_kernels`` on the
    trained model.  Returns the launches of the first train step."""
    t0 = time.perf_counter()
    out, data = os.path.join(tmp, "star"), os.path.join(tmp, "star_data")
    os.makedirs(data, exist_ok=True)
    argv = STAR_FLAGS + STAR_DATA + ["--output", out, "--dataDir", data,
                                     "--backboneWeights", files["trunk"]]
    saved = common.Trainer, common.build_model
    _Recorded.made = []
    common.Trainer = _Recorded
    common.build_model = lambda cfg, dev, seed=0: host_init_model(cfg, seed)
    try:
        with _Counted(sync=False) as counted:
            result, stdout, seconds = run_main(argv, star.main)
    finally:
        common.Trainer, common.build_model = saved
    trainer = _Recorded.made[-1]
    chunks = trainer.chunks
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    if "star driver: task=hgqa" not in stdout or (
            f"Loaded pretrained backbone from {files['trunk']}" not in stdout):
        raise AssertionError("the STAR driver did not start or did not load "
                             "--backboneWeights")
    if (result["steps"], len(losses)) != (8, 8) or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"STAR driver: {result['steps']} steps, losses "
                             f"{losses}")
    if chunks is None or (chunks.captures, chunks.replays) != (1, 3):
        raise AssertionError("STAR driver: not one capture and three "
                             "replays")
    if counted.train != [STAR_TRAIN_LAUNCHES] * 4:
        raise AssertionError(f"STAR train steps launched {counted.train}, "
                             f"expected 4 x {STAR_TRAIN_LAUNCHES}")
    train_launches = counted.train[0]
    if counted.eval != [STAR_VALID_LAUNCHES] * 2:
        raise AssertionError(f"STAR valid forwards launched {counted.eval}, "
                             f"expected 2 x {STAR_VALID_LAUNCHES}")
    cfg = trainer.model.cfg
    if cfg.loss_hg_per_frame or not cfg.use_hg_mask:
        raise AssertionError("STAR driver: not the global matcher with the "
                             "hg mask")
    reload_bit_equal(trainer.model, os.path.join(out, "LAST"), "STAR ")
    del chunks
    star_mask_kernels(trainer)
    del trainer, _Recorded.made[:]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"STAR driver: 8 steps, losses {losses}, 1 capture and 3 replays, "
        f"launches ({COUNT_NAMES}) per train step run on the host "
        f"{counted.train[0]}, per valid forward {counted.eval[0]}; history "
        f"{result['history']}; LAST reloads bit-equal; {seconds:.1f} s")
    for extra, want in STAR_TEST_MODES:
        test_out = os.path.join(tmp, "star_test" + "".join(extra))
        argv_test = [a if a != out else test_out for a in argv] + [
            "--test", "test", "--load", os.path.join(out, "LAST")] + extra
        with _Counted() as counted:
            result, stdout, test_seconds = run_main(argv_test, star.main)
        if "Oracle score: 1.0000" not in stdout:
            raise AssertionError(f"STAR --test {extra}: oracle score not "
                                 "1.0")
        if not counted.eval or any(c != want for c in counted.eval):
            raise AssertionError(f"STAR --test {extra} forwards launched "
                                 f"{counted.eval}, expected {want} each")
        if set(result["by_qtype"]) != {"Interaction", "Sequence",
                                       "Prediction", "Feasibility"}:
            raise AssertionError(f"STAR --test by_qtype {result['by_qtype']}")
        for name in ("predict.json", "predict_hg.json"):
            with open(os.path.join(test_out, name)) as f:
                if len(json.load(f)) != 4:
                    raise AssertionError(f"STAR {name} does not hold 4 "
                                         "answers")
        log(f"STAR --test {' '.join(extra)}: oracle 1.0, acc {result['acc']}"
            f", hg_acc {result['hg_acc']}, by_qtype {result['by_qtype']}, "
            f"predict files of 4 answers, launches per eval forward "
            f"{counted.eval[0]}, {test_seconds:.1f} s")
    log(f"STAR phase: {time.perf_counter() - t0:.1f} s")
    return train_launches


# phase 9c: the AGQA ablation drivers at B=8 on 32 synthetic clips (4
# steps) and 16 valid, one epoch: the question-only driver at the
# language stack's flagship depth, two steps a launch; the video-QA driver
# at the published flags with --pallasFFNTrain
TASK_DATA = ["--syntheticData", "32", "--syntheticValid", "16",
             "--batchSize", "8", "--logFreq", "1", "--epochs", "1"]
Q_FLAGS = ["--taskQ", "--noCaps", "--llayers", "5", "--fromScratch",
           "--stepsPerLoop", "2"]
VQA_FLAGS = ["--taskVQA" if a == "--taskHGQA" else a for a in DRIVER_FLAGS]
# (flags, launches per train step, per eval forward plain and with
# --pallasAttention): q 5 language layers; vqa 5 + 5 + 2 x 2 cross sites
TASK_DRIVERS = {
    "q": (Q_FLAGS, (5, 5, 0, 0, 0, 0, 0, 0, 0, 0, 0),
          (0, 0, 5, 0, 0, 0, 0, 0, 0, 0, 0), (5, 0, 5, 0, 0, 0, 0, 0, 0, 0, 0)),
    "vqa": (VQA_FLAGS, (14, 14, 0, 14, 14, 0, 0, 0, 0, 0, 0),
            (0, 0, 14, 0, 0, 0, 0, 0, 0, 0, 0),
            (14, 0, 14, 0, 0, 0, 0, 0, 0, 0, 0)),
}
# the head-model variants: (name, config, encoder and decoder overrides,
# attention forward and backward launches per train step, FFN launches
# per eval forward, FFN-train forward and backward launches per train
# step).  The backward skips what the loss does not reach: the LXRT
# x-layers under hgqa / vhga (4 attention sites, 4 FFN; 2 and 2 for
# 'self', 6 and 2 for 'cross_self') unless --afterCrossAttnFeats; under
# --GTHG also the visual stream (5 r-layers) and the decoders (20 sites,
# no FFN); under 'old' the HG encoder's last language attention and FFN
# (its single-CLS pooler reads the hg stream only)
TASK_VARIANTS = (
    ("hgqa (flagship)", {}, {}, {}, 38, 34, 18, 18, 14),
    ("vhga", dict(task="vhga"), {}, {}, 38, 34, 18, 18, 14),
    ("hgvqa", dict(task="hgvqa"), {}, {}, 38, 38, 18, 18, 18),
    ("self", {}, dict(cross_attn_type="self"), {}, 34, 32, 14, 14, 12),
    ("cross_self", {}, dict(cross_attn_type="cross_self"), {}, 42, 36, 14,
     14, 12),
    ("old", {}, dict(cross_attn_type="old"), {}, 38, 33, 18, 18, 13),
    ("untied", {}, dict(tie_x_layers=False), {}, 38, 34, 18, 18, 14),
    ("gt_hg", dict(gt_hg=True), {}, {}, 18, 9, 18, 18, 9),
    ("after_cross", dict(after_cross_attn_feats=True), {}, {}, 38, 38, 18,
     18, 18),
    ("linear_cls", {}, {}, dict(linear_cls=True), 38, 34, 18, 18, 14),
)
TASK_BATCH = 8
# a kernel path's gradient vector may sit this many times the plain bf16
# path's distance to the plain f32 path away from either, where that is
# more than TRAIN_TOL (phase 9c)
GRAD_NOISE = 2.0


def phase_task_driver(tmp: str, files: dict, name: str):
    """``cli.agqa_q.main`` / ``cli.agqa_vqa.main`` on TASK_DATA (the video
    driver's trunk from ``--backboneWeights``): the launch counts of every
    train step run on the host and of every valid forward, finite losses,
    for 'q' one capture and one replay, LAST reloaded bit-equal; then
    ``--test`` from LAST (oracle 1.0, both predict files of 16 answers),
    plain and with ``--pallasAttention``.  Returns its seconds."""
    t0 = time.perf_counter()
    flags, train_want, eval_want, attn_want = TASK_DRIVERS[name]
    main = agqa_q.main if name == "q" else agqa_vqa.main
    out, data = os.path.join(tmp, name), os.path.join(tmp, f"{name}_data")
    os.makedirs(data, exist_ok=True)
    argv = flags + TASK_DATA + ["--output", out, "--dataDir", data]
    if name != "q":
        argv += ["--backboneWeights", files["trunk"]]
    saved, _Recorded.made = common.Trainer, []
    common.Trainer = _Recorded
    try:
        with _Counted(sync=name != "q") as counted:
            result, stdout, seconds = run_main(argv, main)
    finally:
        common.Trainer = saved
    trainer = _Recorded.made[-1]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    if f"agqa driver: task={name}" not in stdout or (
            name != "q" and f"Loaded pretrained backbone from "
            f"{files['trunk']}" not in stdout):
        raise AssertionError(f"{name} driver did not start or did not load "
                             "--backboneWeights")
    if (result["steps"], len(losses)) != (4, 4) or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"{name} driver: {result['steps']} steps, "
                             f"losses {losses}")
    chunks = trainer.chunks
    if name == "q" and (chunks is None
                        or (chunks.captures, chunks.replays) != (1, 1)):
        raise AssertionError("q driver: not one capture and one replay")
    if counted.train != [train_want] * 4:
        raise AssertionError(f"{name} train steps launched {counted.train}, "
                             f"expected 4 x {train_want}")
    if counted.eval != [eval_want] * 8:
        raise AssertionError(f"{name} valid forwards launched "
                             f"{counted.eval}, expected 8 x {eval_want}")
    reload_bit_equal(trainer.model, os.path.join(out, "LAST"), f"{name} ")
    del trainer, chunks, _Recorded.made[:]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{name} driver: 4 steps, losses {losses}, launches "
        f"({COUNT_NAMES}) per train step run on the host {counted.train[0]}"
        f", per valid forward {counted.eval[0]}; history "
        f"{result['history']}; LAST reloads bit-equal; {seconds:.1f} s")
    for extra, want in (([], eval_want), (["--pallasAttention"],
                                          attn_want)):
        test_out = os.path.join(tmp, f"{name}_test" + "".join(extra))
        argv_test = [a if a != out else test_out for a in argv] + [
            "--test", "test", "--load", os.path.join(out, "LAST")] + extra
        with _Counted() as counted:
            result, stdout, test_seconds = run_main(argv_test, main)
        if "Oracle score: 1.0000" not in stdout:
            raise AssertionError(f"{name} --test {extra}: oracle score not "
                                 "1.0")
        if counted.eval != [want] * 8:
            raise AssertionError(f"{name} --test {extra} forwards launched "
                                 f"{counted.eval}, expected 8 x {want}")
        for fname in ("predict.json", "predict_hg.json"):
            with open(os.path.join(test_out, fname)) as f:
                if len(json.load(f)) != 16:
                    raise AssertionError(f"{name} {fname} does not hold 16 "
                                         "answers")
        log(f"{name} --test {' '.join(extra)}: oracle 1.0, predict files of "
            f"16 answers, launches per eval forward {counted.eval[0]}, "
            f"{test_seconds:.1f} s")
    return time.perf_counter() - t0


def variant_batch(cfg, bsz: int, seed: int):
    """A labelled featurized batch of the flagship head on the card: random
    trunk features (B, 16, 7, 7, 2048 or, under --patches, 8 frames of 3072
    patch values) in place of frames, a padded question in every other
    clip, and under GT-HG the label ids."""
    batch = entry.example_batch(cfg, bsz, seed, with_labels=True)
    del batch["frames"]
    e = cfg.encoder
    batch["input_mask"][1::2, cfg.data.max_seq_length - 8:] = 0
    batch["visual_feats"] = np.random.RandomState(seed).randn(
        bsz, e.frames_t, e.visual_hw, e.visual_hw, e.visual_feat_dim
    ).astype(np.float32)
    if cfg.gt_hg:
        batch["rel_tgt_ids"] = batch["rel_labels"].reshape(bsz, -1)
        batch["act_tgt_ids"] = batch["act_labels"].reshape(bsz, -1)
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def grads_of(model, params, cfg, batch, generator):
    """(loss, the gradient vector, the names with a gradient) of one
    training forward and backward, with the launch counts it made."""
    model.zero_grad(set_to_none=True)
    reset_counts()
    loss, _ = compute_losses(cfg, model(batch, generator), batch)
    loss.backward()
    torch.cuda.synchronize()
    launched = counts()
    reached = {n for n, p in params if p.grad is not None}
    vec = torch.cat([p.grad.float().flatten() for _, p in params
                     if p.grad is not None])
    return loss.item(), vec, reached, launched


def phase_task_variants():
    """Each head-model variant of TASK_VARIANTS (the flagship first, as the
    others' baseline) at flagship widths in bf16
    on a B=8 featurized batch (random trunk features; the trunk is the
    same for every variant): eval forwards plain, with the FFN kernel and
    with ``--pallasAttention`` (hg_logit, or logit, within 5e-2 relative
    Frobenius of the plain path; the launch counts); at dropout 0, as
    phase 6, the attention kernels against the plain attention and the
    FFN-train kernels against the unfused FFN: the loss within TRAIN_TOL,
    the whole gradient vector within TRAIN_TOL or, where bf16 itself moves
    it further, within GRAD_NOISE x the plain bf16 path's distance to the
    plain path in f32 (same weights) of both (each distance and the three
    tensors with the largest share of it logged); the launch counts; the
    parameters with a gradient exactly ``connected_param_mask``'s; two
    runs of the attention kernels (dQ by atomics); two
    optimizer steps at the flagship's dropout (launch counts, finite
    losses; outside ``trainable_mask`` bit-identical, the rest moved).
    Returns its seconds."""
    t0 = time.perf_counter()
    base = entry.flagship_cfg()
    for (name, top, enc, dec, *want) in TASK_VARIANTS:
        cfg = base.replace(**top, encoder=dataclasses.replace(
            base.encoder, **enc), decoder=dataclasses.replace(
                base.decoder, **dec))
        check_head_variant(name, cfg, variant_batch(cfg, TASK_BATCH, 11),
                           *want)
    return time.perf_counter() - t0


def check_head_variant(name, cfg, batch, attn_f, attn_b, ffn_n, ffn_f,
                       ffn_b, match=0):
    """Phase 9c's checks of one head model (``phase_task_variants``) on
    ``batch``, with its expected launches: attention forward and backward
    per train step, FFN per eval forward, FFN-train forward and backward
    per train step, and the matcher's per train forward (``match``: 2
    under the global matcher)."""
    t1 = time.perf_counter()
    model = init_weights(ShgVqaModel(cfg).to("cuda"), seed=11).eval()
    outs = {}
    for mode, ffn, attn, want in (
            ("plain", False, False, (0,) * 11),
            ("FFN kernel", True, False,
             (0, 0, ffn_n, 0, 0, 0, 0, 0, 0, 0, 0)),
            ("attention kernel", True, True,
             (attn_f, 0, ffn_n, 0, 0, 0, 0, 0, 0, 0, 0))):
        set_ffn_kernel(model, ffn)
        set_attention_kernel_eval(model, attn)
        reset_counts()
        with torch.inference_mode():
            y = model(batch)
        torch.cuda.synchronize()
        if counts() != want:
            raise AssertionError(f"{name} {mode} forward launched "
                                 f"{counts()}, expected {want}")
        key = "hg_logit" if "hg_logit" in y else "logit"
        if not torch.isfinite(y[key]).all():
            raise AssertionError(f"{name} {mode}: non-finite {key}")
        outs[mode] = y[key].float()
    set_ffn_kernel(model, True)
    set_attention_kernel_eval(model, False)
    fwd_rel = {m: ((o - outs["plain"]).norm()
                   / outs["plain"].norm()).item()
               for m, o in outs.items() if m != "plain"}
    if max(fwd_rel.values()) > 5e-2:
        raise AssertionError(f"{name}: {key} differs from the plain "
                             f"path by {fwd_rel}")

    rates = {m: m.rate for m in model.modules() if isinstance(m, Dropout)}
    set_dropout_rate(model, 0.0)
    model.train()
    params = list(model.named_parameters())
    generator = torch.Generator(device="cuda").manual_seed(11)
    # (attention kernels, FFN train kernels), as phase 6: the attention
    # kernels against the plain attention, then the FFN train kernels
    # against the unfused FFN with the attention kernels on; the
    # attention kernels twice (dQ is summed with atomics); and the
    # plain path in f32 on the same weights, the yardstick of bf16
    results = {}
    for mode, attn, ffn in (("kernel", True, False),
                            ("kernel again", True, False),
                            ("plain", False, False),
                            ("ffn kernel", True, True)):
        set_attention_kernel(model, attn)
        set_ffn_train_kernel(model, ffn)
        results[mode] = grads_of(model, params, cfg, batch, generator)
    ref = ShgVqaModel(cfg.replace(compute_dtype="float32")).to("cuda")
    ref.load_state_dict(model.state_dict())
    ref.train()
    set_dropout_rate(ref, 0.0)
    set_attention_kernel(ref, False)
    results["plain f32"] = grads_of(ref, list(ref.named_parameters()),
                                    cfg, batch, generator)
    del ref
    want_train = (attn_f, attn_b, 0, ffn_f, ffn_b, 0, 0, 0, 0, match, 0)
    want_attn = (attn_f, attn_b) + (0,) * 7 + (match, 0)
    want_plain = (0,) * 9 + (match, 0)
    launched = {m: r[3] for m, r in results.items()}
    if launched != {"kernel": want_attn, "kernel again": want_attn,
                    "plain": want_plain, "ffn kernel": want_train,
                    "plain f32": want_plain}:
        raise AssertionError(f"{name} train forward and backward "
                             f"launched {launched}, expected "
                             f"{want_train} (both kernels)")
    connected = {n for n, c in connected_param_mask(model, cfg).items()
                 if c}
    if any(r[2] != connected for r in results.values()):
        raise AssertionError(f"{name}: the backward reaches other "
                             "parameters than connected_param_mask's")
    names = [n for n, _ in params if n in connected]
    sizes = [p.numel() for n, p in params if n in connected]
    train_rel = {}
    for what, (a, b) in (("attention", ("kernel", "plain")),
                         ("FFN", ("ffn kernel", "kernel")),
                         ("rerun", ("kernel again", "kernel")),
                         ("plain vs f32", ("plain", "plain f32")),
                         ("kernel vs f32", ("kernel", "plain f32")),
                         ("ffn kernel vs f32", ("ffn kernel",
                                                "plain f32"))):
        (la, ga, _, _), (lb, gb, _, _) = results[a], results[b]
        # the tensors with the largest share of the squared difference,
        # each with its own relative difference
        parts = sorted(
            (((x - y).square().sum().item(),
              ((x - y).norm() / y.norm().clamp_min(1e-30)).item(), n)
             for n, x, y in zip(names, ga.split(sizes),
                                gb.split(sizes))), reverse=True)
        total = max(sum(p[0] for p in parts), 1e-30)
        train_rel[what] = dict(
            loss=abs(la - lb) / abs(lb),
            grad=((ga - gb).norm() / gb.norm()).item(),
            grad_norm=abs(ga.norm() - gb.norm()).item() / gb.norm().item(),
            worst_tensors=[(n, round(sq / total, 4), round(r, 4))
                           for sq, r, n in parts[:3]])
    log(f"variant {name} train kernel vs plain (dropout 0): "
        f"{json.dumps(train_rel)}")
    # the loss within TRAIN_TOL of the plain path; the gradient vector
    # within TRAIN_TOL of it or, where bf16 itself moves the vector
    # further (a few tensors' gradients are sums that cancel), within
    # GRAD_NOISE x the plain bf16 path's distance to f32 of both the
    # plain bf16 path and the f32 one
    noise = GRAD_NOISE * train_rel["plain vs f32"]["grad"]
    for what, to_f32 in (("attention", "kernel vs f32"),
                         ("FFN", "ffn kernel vs f32")):
        loss, grad = train_rel[what]["loss"], train_rel[what]["grad"]
        grad_f32 = train_rel[to_f32]["grad"]
        if loss > TRAIN_TOL or (grad > TRAIN_TOL and (
                grad > noise or grad_f32 > noise)):
            raise AssertionError(f"{name}: kernel and plain {what} "
                                 f"train paths differ: {train_rel}")
    lk, lp = results["kernel"][0], results["plain"][0]
    rel_loss = train_rel["attention"]["loss"]
    rel_grad = {w: train_rel[w]["grad"] for w in train_rel}
    del results
    model.zero_grad(set_to_none=True)
    for m, rate in rates.items():
        m.rate = rate
    set_attention_kernel(model, True)
    set_ffn_train_kernel(model, True)
    o = cfg.optim
    optimizer = make_optimizer(
        model, o.lr, entry.TRAIN_T_TOTAL, o.warmup, o.schedule, o.b1,
        o.b2, o.eps, o.weight_decay, o.grad_clip,
        trainable_mask(model, cfg), o.optim)
    step = make_train_step(cfg, model, optimizer)
    before = {n: p.detach().clone() for n, p in params}
    losses = []
    for _ in range(2):
        reset_counts()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        if counts() != want_train:
            raise AssertionError(f"{name} train step launched "
                                 f"{counts()}, expected {want_train}")
        losses.append(metrics["total_loss"].item())
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: train losses {losses}")
    moved, tiny, frozen = moved_or_tiny(model, optimizer, before)
    log(f"variant {name}: eval launches FFN {ffn_n}, attention "
        f"{attn_f}; {key} rel Frobenius vs plain {json.dumps(fwd_rel)}; "
        f"train launches ({COUNT_NAMES}) {want_train}; kernel vs plain "
        f"(dropout 0) loss {lk:.6f} vs {lp:.6f} (rel {rel_loss:.2e}), "
        f"gradient vector rel {json.dumps(rel_grad)}; losses {losses}; "
        f"{len(moved)} tensors moved, {len(tiny)} below f32 resolution, "
        f"{len(frozen)} outside the optimizer bit-identical; "
        f"{time.perf_counter() - t1:.1f} s")
    set_ffn_train_kernel(model, False)
    del model, optimizer, step, before, batch, params
    gc.collect()
    torch.cuda.empty_cache()
def phase_tasks(tmp: str, files: dict):
    """Phase 9c: both ablation drivers, then the head-model variants.
    Returns the seconds of each part."""
    t0 = time.perf_counter()
    seconds = {name: phase_task_driver(tmp, files, name)
               for name in TASK_DRIVERS}
    clear_outputs(tmp, files["trunk"])
    seconds["variants"] = phase_task_variants()
    seconds["phase"] = time.perf_counter() - t0
    log(f"phase 9c (AGQA ablations) seconds {json.dumps(seconds)}")
    return seconds


# phase 9d: per-choice STAR QA (README.md's STAR line with --noCaps
# --qaArrangeType add_sep at --stepsPerLoop 2, B=8): 128
# synthetic questions (32 Interaction: four steps, two 2-step chunks, so
# one capture and one replay) and 16 valid (4 Interaction), one epoch
PER_CHOICE_FLAGS = [("add_sep" if a == "add_sep_all" else a)
                    for a in STAR_FLAGS]
PER_CHOICE_DATA = ["--syntheticData", "128", "--syntheticValid", "16",
                   "--logFreq", "1", "--epochs", "1"]
# launches (COUNT_NAMES) of a per-choice train step, a valid forward with
# labels and a dumps batch (test items carry zero label grids, so their
# dumps match globally too, as JAX's do); the eval modes of --test
PER_CHOICE_TRAIN = (38, 34, 0, 0, 0, 0, 0, 0, 0, 2, 0)
PER_CHOICE_VALID = (0, 0, 18, 0, 0, 0, 0, 0, 0, 2, 0)
PER_CHOICE_DUMPS = (0, 0, 18, 0, 0, 0, 0, 0, 0, 2, 0)
# (--test's extra flags, launches per eval forward); the dumps run once,
# with --pallasAttention on, where they must still launch no attention
# kernel, at an eval batch of 4 clips (a dump writes every map of the
# padded batch: 16 HG rows, not 32)
PER_CHOICE_TEST_MODES = (([], (0, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)),
                         (["--pallasAttention", "--outputAttn",
                           "--batchSize", "4"],
                          (38, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)))
# the head models of phase 9d: (task, arrangement, attention forward and
# backward per train step, FFN per eval forward, FFN-train forward and
# backward per train step); under 'hgvqa' the fusion head reads the pooled
# output, so the LXRT x-layers' backward runs
PER_CHOICE_VARIANTS = (("hgqa", "add_sep", 38, 34, 18, 18, 14),
                       ("hgqa", "no_sep", 38, 34, 18, 18, 14),
                       ("hgvqa", "add_sep", 38, 38, 18, 18, 18),
                       ("hgvqa", "no_sep", 38, 38, 18, 18, 18))
NUM_CHOICES = 4


def per_choice_batch(cfg, bsz: int, seed: int, arrange: str):
    """``variant_batch`` with four (question, choice) encodings a clip: the
    question's ids, under add_sep a [SEP] (id 102), the choice's ids; the
    masks cover each pair; 4-way targets."""
    batch = variant_batch(cfg, bsz, seed)
    rng = np.random.RandomState(seed + 1)
    lt = cfg.data.max_seq_length
    ids = batch["input_ids"].cpu().numpy()
    qlen = 12
    pairs = np.zeros((bsz, NUM_CHOICES, lt), np.int32)
    masks = np.zeros((bsz, NUM_CHOICES, lt), np.int32)
    for c in range(NUM_CHOICES):
        tail = rng.randint(1000, cfg.encoder.vocab_size, (bsz, 6))
        sep = [np.full((bsz, 1), 102)] if arrange == "add_sep" else []
        row = np.concatenate([ids[:, :qlen]] + sep + [tail], axis=1)
        pairs[:, c, :row.shape[1]] = row
        masks[:, c, :row.shape[1]] = 1
    batch["choice_input_ids"] = torch.as_tensor(pairs, device="cuda")
    batch["choice_input_mask"] = torch.as_tensor(masks, device="cuda")
    batch["choice_segment_ids"] = torch.zeros_like(batch["choice_input_ids"])
    target = np.eye(NUM_CHOICES, dtype=np.float32)[rng.randint(
        0, NUM_CHOICES, bsz)]
    batch["target"] = torch.as_tensor(target, device="cuda")
    return batch


def per_choice_step_ms(model, cfg):
    """Eager train steps, attention kernels on, in turns: the per-choice
    STAR model ``model`` (the driver's LAST, its trunk frozen) at B=8 (32
    language rows) and the flagship frozen-trunk step at B=32
    (``entry.train_entry``); ms a step, each one turn of ``TRAIN_TURN``
    steps, and the per-choice step's split."""
    o = cfg.optim
    model.train()
    optimizer = make_optimizer(
        model, o.lr, entry.TRAIN_T_TOTAL, o.warmup, o.schedule, o.b1, o.b2,
        o.eps, o.weight_decay, o.grad_clip, trainable_mask(model, cfg),
        o.optim)
    batch = per_choice_batch(cfg, STAR_BATCH, 17, "add_sep")
    batch.pop("visual_feats")
    batch["frames"] = entry.device_batch(cfg, STAR_BATCH, 17)["frames"]
    generator = torch.Generator(device="cuda").manual_seed(17)
    flag = entry.train_entry()
    steps = {"per_choice_b8": (make_train_step(cfg, model, optimizer), batch,
                               generator),
             "flagship_b32": (make_train_step(flag.model.cfg, flag.model,
                                              flag.optimizer), flag.batch,
                              flag.generator)}
    ms = {k: [] for k in steps}
    for name in ("per_choice_b8", "flagship_b32"):
        step, b, g = steps[name]
        ms[name].append(b["frames"].shape[0] * 1e3
                        / train_clips_per_second(step, b, g, **TRAIN_TURN))
    out = {k: sum(v) / len(v) for k, v in ms.items()}
    out["per_choice_split"] = train_split_ms(model, optimizer, batch,
                                             generator)
    log(f"train step ms, eager, attention kernels (per-choice B=8 vs the "
        f"flagship frozen B=32, in turns): {json.dumps(ms)}; per-choice "
        f"split {json.dumps(out['per_choice_split'])}")
    del flag, steps, optimizer
    return out


def phase_per_choice(tmp: str, files: dict):
    """Phase 9d: per-choice STAR QA at full width in bf16.  ``cli.star
    .main`` at PER_CHOICE_FLAGS on PER_CHOICE_DATA, its trunk from
    ``--backboneWeights``: the launch counts of every step run on the host
    (the eager chunk and the capture) and of the valid forward, one
    capture and one replay, finite losses, LAST reloaded bit-equal;
    ``--test`` from LAST, plain and with ``--pallasAttention
    --outputAttn`` (oracle 1.0, ``by_qtype``, both predict files; of the
    dumps both files, the npz maps, no attention kernel in a dump);
    then the head models of PER_CHOICE_VARIANTS through
    ``check_head_variant`` on random trunk features at B=8.  Returns the
    seconds of each part."""
    t0 = time.perf_counter()
    out, data = os.path.join(tmp, "pc"), os.path.join(tmp, "pc_data")
    os.makedirs(data, exist_ok=True)
    argv = PER_CHOICE_FLAGS + PER_CHOICE_DATA + [
        "--output", out, "--dataDir", data, "--backboneWeights",
        files["trunk"]]
    saved, _Recorded.made = common.Trainer, []
    common.Trainer = _Recorded
    try:
        with _Counted(sync=False) as counted:
            result, stdout, seconds = run_main(argv, star.main)
    finally:
        common.Trainer = saved
    trainer = _Recorded.made[-1]
    chunks = trainer.chunks
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    if (result["steps"], len(losses)) != (4, 4) or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"per-choice driver: {result['steps']} steps, "
                             f"losses {losses}")
    if chunks is None or (chunks.captures, chunks.replays) != (1, 1):
        raise AssertionError("per-choice driver: not one capture and one "
                             "replay")
    if counted.train != [PER_CHOICE_TRAIN] * 4:
        raise AssertionError(f"per-choice train steps launched "
                             f"{counted.train}, expected 4 x "
                             f"{PER_CHOICE_TRAIN}")
    if counted.eval != [PER_CHOICE_VALID]:
        raise AssertionError(f"per-choice valid forwards launched "
                             f"{counted.eval}, expected {PER_CHOICE_VALID}")
    dump_s = {}
    cfg = trainer.model.cfg
    if cfg.data.qa_arrange_type != "add_sep" or cfg.loss_hg_per_frame:
        raise AssertionError("per-choice driver: not add_sep with the "
                             "global matcher")
    fresh = reload_bit_equal(trainer.model, os.path.join(out, "LAST"),
                             "per-choice ")
    epoch_s = [float(x) for x in re.findall(
        r"Epoch \d+: \d+ steps in ([\d.]+)s", stdout)]
    del chunks, trainer, _Recorded.made[:]
    step_ms = per_choice_step_ms(fresh, cfg)
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    log(f"per-choice STAR driver: 4 steps (B=8 clips, 32 language rows), "
        f"losses {losses}, 1 capture and 1 replay, launches ({COUNT_NAMES}) "
        f"per train step run on the host {counted.train[0]}, per valid "
        f"forward {counted.eval[0]}; epoch {epoch_s} s; history "
        f"{result['history']}; LAST reloads bit-equal; {seconds:.1f} s")
    for extra, want in PER_CHOICE_TEST_MODES:
        test_out = os.path.join(tmp, "pc_test" + "".join(extra))
        argv_test = [a if a != out else test_out for a in argv] + [
            "--test", "test", "--load", os.path.join(out, "LAST")] + extra
        with _Counted() as counted:
            result, stdout, test_seconds = run_main(argv_test, star.main)
        if "Oracle score: 1.0000" not in stdout:
            raise AssertionError(f"per-choice --test {extra}: oracle score "
                                 "not 1.0")
        if not counted.eval or any(c != want for c in counted.eval):
            raise AssertionError(f"per-choice --test {extra} forwards "
                                 f"launched {counted.eval}, expected {want}")
        if set(result["by_qtype"]) != {"Interaction", "Sequence",
                                       "Prediction", "Feasibility"}:
            raise AssertionError(f"per-choice --test by_qtype "
                                 f"{result['by_qtype']}")
        for name in ("predict.json", "predict_hg.json"):
            with open(os.path.join(test_out, name)) as f:
                if len(json.load(f)) != 4:
                    raise AssertionError(f"per-choice {name} does not hold "
                                         "4 answers")
        if "--outputAttn" in extra:
            dump_s["test" + "".join(extra)] = check_dumps(
                f"per-choice --test {' '.join(extra)}", counted, test_out, 4,
                PER_CHOICE_DUMPS, HG_TOKENS, grids=True, per_choice=True)
        log(f"per-choice --test {' '.join(extra)}: oracle 1.0, acc "
            f"{result['acc']}, hg_acc {result['hg_acc']}, by_qtype "
            f"{result['by_qtype']}, launches per eval forward "
            f"{counted.eval[0]}, {test_seconds:.1f} s")
    seconds = {"driver": time.perf_counter() - t0, "dumps": dump_s,
               "step_ms": step_ms}
    t1 = time.perf_counter()
    base = entry.flagship_cfg()
    for task, arrange, *want in PER_CHOICE_VARIANTS:
        cfg = base.replace(task=task, num_answers=NUM_CHOICES,
                           use_hg_mask=True, loss_hg_per_frame=False,
                           data=dataclasses.replace(
                               base.data, dataset="star",
                               qa_arrange_type=arrange))
        check_head_variant(f"per-choice {task} {arrange}", cfg,
                           per_choice_batch(cfg, TASK_BATCH, 13, arrange),
                           *want, match=2)
    seconds["variants"] = time.perf_counter() - t1
    seconds["phase"] = time.perf_counter() - t0
    log(f"phase 9d (per-choice STAR) seconds {json.dumps(seconds)}")
    return seconds


def clear_outputs(tmp: str, keep: str) -> None:
    """Delete everything the phases wrote under ``tmp`` but ``keep`` (the
    trunk file the later phases load).  The card machine's disk keeps every
    block once written, deleted or not, and checkpoints are ~4 GB each:
    blocks freed here are written again by the next phase, so the disk
    grows by the largest phase rather than by their sum."""
    for name in os.listdir(tmp):
        path = os.path.join(tmp, name)
        if path == keep:
            continue
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)


def weight_file_writers():
    """``tests/test_torch_reference_writer.py`` (numpy and the port only),
    loaded by its path: no weight file of these kinds is in the repository
    or can be fetched, so the script writes its own."""
    path = Path(__file__).resolve().parent / "tests" / (
        "test_torch_reference_writer.py")
    spec = importlib.util.spec_from_file_location(
        "test_torch_reference_writer", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_init_model(cfg, seed: int):
    """``entry.build_model(cfg, "cuda", seed)`` with the random init drawn
    by the host's generator (``entry.build_model(cfg, "cpu", seed)``), then
    moved to the card: the weights the trunk file and phase 9b's driver
    model are made of, the inputs phase 9b's hg-mask check (PERF.md §7,
    open) has been run on, whatever the card's own generator draws."""
    return entry.channels_last_convs(
        entry.build_model(cfg, "cpu", seed).to("cuda"))


def write_weight_files(tmp: str) -> dict:
    """The files a user of the published recipe has, written from one
    flagship model (seed ``WEIGHTS_SEED``, its trunk's BatchNorm statistics
    calibrated on a synthetic batch, as a pretrained trunk's normalize its
    activations): its slow_r50 trunk as pytorchvideo's ``{"model_state":
    ...}`` with a ``blocks.5`` head, converted by
    ``utils/convert_slow_r50``'s CLI; the whole model as a reference
    ``BEST.pth`` (``module.`` prefixes, the x-layers' aliases, an unread
    cross variant of ``pooler_dict`` and ``cross_attn_layer``); the same
    weights as the port's own LAST; its language tower as bert-base's
    ``pytorch_model.bin`` (12 layers, ``gamma``/``beta``, ``bert.``)."""
    writer = weight_file_writers()
    # the driver's config: the published flags, the synthetic answers
    cfg, extras = common.parse_reference_flags_with_extras(
        driver_argv(tmp, os.path.join(tmp, "own")), dataset="agqa")
    cfg = common.resolve_num_answers(cfg, common.build_data(
        cfg, extras, cfg.data.train_split))
    model = host_init_model(cfg, WEIGHTS_SEED)
    frames = entry.device_batch(cfg, BATCH_SIZE, WEIGHTS_SEED)["frames"]
    calibrate_frozen_bn(model.backbone, model.normalize_frames(frames))
    v = to_jax_variables(model.state_dict())
    files = {"trunk_pyth": os.path.join(tmp, "SLOW_8x8_R50.pyth"),
             "trunk": os.path.join(tmp, "slow_r50_flax.msgpack"),
             "reference": os.path.join(tmp, "ref", "BEST"),
             "own": os.path.join(cfg.output, "LAST"),
             "bert": os.path.join(tmp, "bert", "pytorch_model.bin")}
    trunk = writer.pytorchvideo_state_dict(v["params"]["backbone"],
                                           v["batch_stats"]["backbone"],
                                           head_classes=400)
    torch.save({"model_state": {k: torch.from_numpy(x)
                                for k, x in trunk.items()}},
               files["trunk_pyth"])
    with contextlib.redirect_stdout(io.StringIO()):
        convert_slow_r50.main([files["trunk_pyth"], files["trunk"]])
    for name in ("reference", "bert"):
        os.makedirs(os.path.dirname(files[name]), exist_ok=True)
    writer.save_torch(writer.reference_state_dict(v, model.head.cfg,
                                                  prefix="module."),
                      files["reference"] + ".pth")
    writer.save_torch(writer.bert_state_dict(
        v["params"]["head"]["lxrt"],
        extra_layers=BERT_LAYERS - cfg.encoder.l_layers), files["bert"])
    trainer = Trainer(cfg, 1, model)
    trainer.ckpt.save("LAST", trainer.state_dict())
    files["trunk_state"] = {k: t.cpu() for k, t in
                            model.backbone.state_dict().items()}
    files["cfg"] = cfg
    del trainer, model, v
    gc.collect()
    torch.cuda.empty_cache()
    sizes = {k: os.path.getsize(files[k] + (".pth" if k == "reference"
                                            else ""))
             for k in ("trunk_pyth", "trunk", "reference", "own", "bert")}
    files["bytes"] = sizes
    log(f"weight files (bytes): {json.dumps(sizes)}")
    return files


def phase_weights_import(tmp: str, files: dict):
    """The weight imports on the card at full width and depth: the trunk
    file through ``Trainer.load_backbone`` bit-equal (BatchNorm statistics
    included); ``--test`` from the reference ``BEST.pth`` (the
    extensionless ``--load path/BEST``) and from the port's LAST of the
    same weights, plain and with ``--pallasAttention``: identical
    predictions, the launch counts per eval forward, the import's seconds
    on the host and to the card and its tensor count; one driver epoch
    without ``--fromScratch`` loading bert-base's names (embeddings + 5
    layers, the pooler skipped); three B=8 train steps with each of
    ``--optim adam|adamax|rms|sgd``."""
    cfg = files["cfg"].replace(output=os.path.join(tmp, "bb"))
    model = entry.build_model(cfg, "cuda", seed=cfg.seed)
    t0 = time.perf_counter()
    Trainer(cfg, 1, model).load_backbone(files["trunk"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for name, value in model.backbone.state_dict().items():
        if not torch.equal(value.cpu(), files["trunk_state"][name]):
            raise AssertionError(f"--backboneWeights loads {name} "
                                 "differently")
    log(f"weights: the trunk file loads bit-equal "
        f"({len(files['trunk_state'])} tensors, BatchNorm statistics "
        f"included) in {load_s:.2f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    imports = {}
    for extra, want in EVAL_MODES:
        preds, states = {}, {}
        for source in ("reference", "own"):
            out = os.path.join(tmp, f"test_{source}" + "".join(extra))
            argv = driver_argv(tmp, out, "--test", "test", "--load",
                               files[source], *extra)
            with _Counted() as counted:
                _, stdout, seconds = run_main(argv)
            if "Oracle score: 1.0000" not in stdout:
                raise AssertionError(f"--test from {source} {extra}: the "
                                     "oracle score is not 1.0")
            if len(counted.eval) != 4 or any(c != want
                                             for c in counted.eval):
                raise AssertionError(f"--test from {source} {extra} "
                                     f"launched {counted.eval}, expected "
                                     f"4 x {want}")
            states[source] = {k: t.cpu() for k, t in
                              counted.model.state_dict().items()}
            del counted
            preds[source] = {}
            for name in ("predict.json", "predict_hg.json"):
                with open(os.path.join(out, name)) as f:
                    preds[source][name] = json.load(f)
            found = re.search(r"Imported reference checkpoint \S+: (\d+) "
                              r"tensors in ([\d.]+) s on the host, "
                              r"([\d.]+) s to \w+", stdout)
            if source == "reference":
                if not found:
                    raise AssertionError("no reference import logged")
                imports[" ".join(extra) or "plain"] = {
                    "tensors": int(found.group(1)),
                    "host_s": float(found.group(2)),
                    "to_card_s": float(found.group(3)),
                    "test_run_s": round(seconds, 2)}
        for name, value in states["own"].items():
            if not torch.equal(value, states["reference"][name]):
                raise AssertionError(f"--test {extra}: BEST.pth imports "
                                     f"{name} differently from LAST")
        if preds["reference"] != preds["own"]:
            raise AssertionError(f"--test {extra}: the reference .pth and "
                                 "the port's LAST of the same weights "
                                 "predict differently")
        answers = {p["prediction"] for p in preds["own"]["predict_hg.json"]}
        log(f"weights: --test {' '.join(extra) or '(plain)'} from BEST.pth "
            f"and from LAST: the driver's {len(states['own'])} tensors "
            f"bit-equal, identical predict.json and predict_hg.json "
            f"({len(answers)} distinct hg answers), launches per eval "
            f"forward {want}")
        del states
    log(f"weights: reference import {json.dumps(imports)}; BEST.pth "
        f"{files['bytes']['reference']} bytes")

    out = os.path.join(tmp, "bert_run")
    argv = [a for a in driver_argv(tmp, out, "--epochs", "1",
                                   "--backboneWeights", files["trunk"],
                                   "--bertWeights", files["bert"])
            if a != "--fromScratch"]
    with _Counted() as counted:
        _, stdout, seconds = run_main(argv)
    loaded = (f"Loaded BERT pretrained weights from {files['bert']} into "
              "'lxrt': 85 tensors; skipped 1")
    if loaded not in stdout:
        raise AssertionError("the driver did not load bert-base's "
                             "embeddings and 5 layers")
    if (not counted.losses
            or not all(math.isfinite(x) for x in counted.losses)):
        raise AssertionError(f"driver losses after the imports "
                             f"{counted.losses}")
    log(f"weights: one driver epoch without --fromScratch: {loaded}; "
        f"losses {counted.losses}; {seconds:.1f} s")

    te = entry.train_entry("cuda", batch_size=8)
    model, generator, batch = te.model, te.generator, te.batch
    mask = trainable_mask(model, model.cfg)
    o = model.cfg.optim
    for name in PLAIN_OPTIMIZERS:
        opt = make_optimizer(model, o.lr, 100, trainable_mask=mask,
                             grad_clip=o.grad_clip, name=name)
        step = make_train_step(model.cfg, model, opt)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        losses = [step(batch, generator)["total_loss"].item()
                  for _ in range(3)]
        trained = {id(p) for p in opt.params}
        moved, still = 0, []
        for n, p in model.named_parameters():
            same = torch.equal(p.detach(), before[n])
            if id(p) not in trained:
                if not same:
                    raise AssertionError(f"--optim {name}: frozen {n} "
                                         "changed")
                continue
            moved += not same
            # adam, adamax and rms step ~lr in every element with a
            # gradient; sgd's lr * g can fall below f32 resolution
            if same and p.grad is not None and p.grad.any():
                still.append(n)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"--optim {name}: losses {losses}")
        if moved == 0 or (name != "sgd" and still):
            raise AssertionError(f"--optim {name}: {moved} of "
                                 f"{len(opt.params)} trainable tensors "
                                 f"moved; with a gradient and still: {still}")
        log(f"weights: --optim {name}, 3 flagship train steps at B=8: "
            f"losses {[round(x, 4) for x in losses]}, {moved} of "
            f"{len(opt.params)} trainable tensors moved")
        del opt, step, before
    del te, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return imports


# phase 10's tiny configurations: the flagship's, and one per ablation
# task and for the cross_self layers
CARD_VS_CPU = {
    "hgqa": dict(task="hgqa"), "q": dict(task="q"),
    "vhga": dict(task="vhga"), "hgvqa": dict(task="hgvqa"),
    "cross_self": dict(task="hgqa", cross_attn_type="cross_self"),
}


def card_vs_cpu_cfg(name, **kw):
    over = dict(CARD_VS_CPU[name])
    cat = over.pop("cross_attn_type", "cross")
    cfg = tiny_test_config(**over, **kw)
    return cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                   cross_attn_type=cat))


def phase_plain_train_step_card_vs_cpu(case="hgqa", device="cuda"):
    """Two plain train steps of the tiny f32 model (dropout 0) on the card
    against the CPU: the metrics of each step, and the parameters after
    (the first step's lr is 0, the second's is not)."""
    cfg = card_vs_cpu_cfg(case, use_pallas_ffn=False,
                          use_pallas_attention_train=False)
    cpu = entry.build_model(cfg, "cpu", seed=2).train()
    gpu = copy.deepcopy(cpu).to(device)
    rng = np.random.RandomState(3)
    d, e = cfg.data, cfg.encoder
    batch = entry.example_batch(cfg, 2, 3, with_labels=True)
    batch.pop("visual_mask")
    batch["frames"] = rng.randint(0, 255, (2, e.visual_t + 8, d.image_size,
                                           d.image_size, 3)).astype(np.uint8)
    o = cfg.optim
    runs = {}
    for dev, model in (("cpu", cpu), (device, gpu)):
        set_dropout_rate(model, 0.0)
        opt = make_optimizer(model, o.lr, 10, o.warmup, o.schedule, o.b1,
                             o.b2, o.eps, o.weight_decay, o.grad_clip,
                             trainable_mask(model, cfg))
        step = make_train_step(cfg, model, opt)
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        before = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        mets = [{k: v.item() for k, v in step(tb).items()} for _ in range(2)]
        runs[dev] = (mets, before, model, opt)
    (_, before, cpu_model, cpu_opt), (gpu_mets, _, gpu_model, _) = (
        runs["cpu"], runs[device])
    worst_metric = max(abs(a[k] - b[k]) / max(abs(b[k]), 1.0)
                       for a, b in zip(gpu_mets, runs["cpu"][0]) for k in b)
    rms_m = torch.cat([m.flatten() for m in cpu_opt.m]).square().mean().sqrt()
    moments = dict(zip(map(id, cpu_opt.params), cpu_opt.m))
    worst_param = 0.0
    for (name, pc), pg in zip(cpu_model.named_parameters(),
                              gpu_model.parameters()):
        dc, dg = pc.detach() - before[name], pg.detach().cpu() - before[name]
        real = (moments[id(pc)].abs() >= 1e-5 * rms_m if id(pc) in moments
                else torch.ones_like(dc, dtype=torch.bool))
        if dc[real].norm() > 0:
            worst_param = max(worst_param, ((dg - dc)[real].norm()
                                            / dc[real].norm()).item())
    log(f"plain train step card vs CPU ({case}, tiny, f32, 2 steps): max "
        f"rel metric "
        f"error {worst_metric:.2e}, max rel parameter-update error "
        f"{worst_param:.2e}")
    if worst_metric > 1e-4 or worst_param > 1e-3:
        raise AssertionError(f"card and CPU train steps disagree: metrics "
                             f"{worst_metric}, updates {worst_param}")


def phase_plain_path_card_vs_cpu(case="hgqa"):
    """The tiny f32 model's plain path on the card against the CPU."""
    cfg = card_vs_cpu_cfg(case, use_pallas_ffn=False)
    cpu = entry.build_model(cfg, "cpu", seed=1)
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.RandomState(0)
    d, e = cfg.data, cfg.encoder
    batch = {
        "input_ids": rng.randint(1, e.vocab_size, (2, d.max_seq_length)),
        "input_mask": np.ones((2, d.max_seq_length), np.int32),
        "segment_ids": np.zeros((2, d.max_seq_length), np.int32),
        "frames": rng.randint(0, 255, (2, e.visual_t + 8, d.image_size,
                                       d.image_size, 3)).astype(np.uint8),
    }
    with torch.inference_mode():
        want = cpu({k: torch.as_tensor(v) for k, v in batch.items()})
        got = gpu({k: torch.as_tensor(v, device="cuda")
                   for k, v in batch.items()})
    worst = max(((got[k].cpu() - want[k]).abs().max()
                 / want[k].abs().max()).item() for k in want)
    log(f"plain path card vs CPU ({case}, tiny, f32): max rel error "
        f"{worst:.2e}")
    if worst > 1e-4:
        raise AssertionError(f"card and CPU disagree by {worst}")


def phase_per_choice_card_vs_cpu():
    """A tiny f32 per-choice STAR model ('hgqa', add_sep, the global
    matcher, the hg mask) on the card against the CPU: one forward from
    frames (every output), then one dumps forward (``output_attentions``:
    every probability map of the LXRT and the HG encoder, and the global
    grids of ``matched_target_grid``)."""
    cfg = tiny_test_config(task="hgqa", num_answers=NUM_CHOICES,
                           use_hg_mask=True, loss_hg_per_frame=False,
                           use_pallas_ffn=False)
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, dataset="star", qa_arrange_type="add_sep"))
    cpu = entry.build_model(cfg, "cpu", seed=4)
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.RandomState(5)
    d, e = cfg.data, cfg.encoder
    batch = entry.example_batch(cfg, 2, 5, with_labels=True)
    batch.pop("visual_mask")
    batch["frames"] = rng.randint(0, 255, (2, e.visual_t + 8, d.image_size,
                                           d.image_size, 3)).astype(np.uint8)
    lt = d.max_seq_length
    batch["choice_input_ids"] = rng.randint(1, e.vocab_size,
                                            (2, NUM_CHOICES, lt))
    batch["choice_input_mask"] = np.ones((2, NUM_CHOICES, lt), np.int32)
    batch["choice_input_mask"][1, :, lt // 2:] = 0
    batch["choice_segment_ids"] = np.zeros((2, NUM_CHOICES, lt), np.int32)
    worst = {}
    for attn in (False, True):
        outs = []
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            with torch.inference_mode():
                y = model(tb, output_attentions=attn)
                if attn:
                    y["rel_grid"] = matched_target_grid(
                        y["rel_preds"], tb["rel_labels"], tb["rel_lengths"],
                        False, d.num_situations)
            outs.append(common._flatten_attentions(y))
        want, got = outs
        if want.keys() != got.keys():
            raise AssertionError("per-choice card vs CPU: other outputs")
        if attn and not any(".attentions.hgq." in k for k in want):
            raise AssertionError("per-choice dumps forward: no HG maps")
        if attn and not np.array_equal(want["attn.rel_grid"],
                                       got["attn.rel_grid"]):
            raise AssertionError("per-choice card vs CPU: global grids "
                                 "differ")
        worst["dumps" if attn else "forward"] = max(
            float(np.abs(got[k] - want[k]).max() / max(np.abs(
                want[k]).max(), 1e-30)) for k in want)
        if attn and got["attn.logit"].shape != (2, NUM_CHOICES):
            raise AssertionError("per-choice logits of shape "
                                 f"{got['attn.logit'].shape}")
    log(f"per-choice card vs CPU (tiny, f32, add_sep, global grids): max "
        f"rel error {json.dumps(worst)} over every output and map")
    if max(worst.values()) > 1e-4:
        raise AssertionError(f"card and CPU disagree by {worst}")


# ---------------------------------------------------------------------------
# Phase caps: the capsule encoder (README.md's STAR command as printed, no
# --noCaps), --sharedWeights and --vitInit at full width

# README.md's STAR line as printed (the capsule encoder: 16 frames, 785
# visual tokens, no x-layers) at --stepsPerLoop 2
CAPS_STAR_FLAGS = [a for a in STAR_FLAGS if a != "--noCaps"]
# 128 synthetic questions (32 Interaction: four B=8 steps, two 2-step
# chunks, so one capture and one replay), 16 valid, one epoch
CAPS_STAR_DATA = ["--syntheticData", "128", "--syntheticValid", "16",
                  "--logFreq", "1", "--epochs", "1"]
# a capsule STAR train step: 5 language + 5 visual (785 tokens) + 2 x 2
# HG cross + 20 decoder attention sites, each with a backward (there are
# no x-layers), and the global matcher's 2; a valid forward: 14 FFN (5 + 2
# language, 5 visual, 2 HG) and the matcher's 2; --test's eval modes
CAPS_STAR_TRAIN = (34, 34, 0, 0, 0, 0, 0, 0, 0, 2, 0)
CAPS_STAR_VALID = (0, 0, 14, 0, 0, 0, 0, 0, 0, 2, 0)
CAPS_STAR_TEST_MODES = (
    ([], (0, 0, 14, 0, 0, 0, 0, 0, 0, 0, 0)),
    (["--pallasAttention"], (34, 0, 14, 0, 0, 0, 0, 0, 0, 0, 0)))
# the head models at flagship widths (phase 9c's checks,
# ``check_head_variant``): (name, encoder overrides, attention forward and
# backward launches per train step, FFN per eval forward, FFN-train
# forward and backward per train step).  Capsules: the STAR step's
# sites; with --crossAttn the x-layers (4 attention, 4 FFN sites), whose
# backward never runs under hgqa; --sharedWeights: the flagship's sites,
# the l-layers called by both streams; --vitInit: the 5 ViT r-layers run
# no kernel
CAPS_VARIANTS = (
    ("capsules", dict(no_caps=False, visual_t=16), 34, 34, 14, 14, 14),
    ("capsules --crossAttn", dict(no_caps=False, visual_t=16,
                                  caps_cross_attn=True), 38, 34, 18, 18, 14),
    ("--sharedWeights", dict(shared_weights=True), 38, 34, 18, 18, 14),
    ("--vitInit", dict(vit_init=True), 33, 29, 13, 13, 9),
)


def caps_flagship_cfg():
    """The flagship with the capsule encoder, as the CLI sets it without
    --noCaps: every one of the 16 frames is a token."""
    base = entry.flagship_cfg()
    return base.replace(encoder=dataclasses.replace(
        base.encoder, no_caps=False, visual_t=base.data.clip_len))


def caps_train_parts(cfg, bsz: int, seed: int, model=None):
    """(model, step, batch, generator) of an eager frozen-trunk train step
    of ``cfg`` at ``bsz`` with the attention kernels (the model built and
    its trunk's BatchNorm statistics calibrated on the batch, unless
    given)."""
    batch = entry.device_batch(cfg, bsz, seed, with_labels=True)
    if model is None:
        model = entry.build_model(cfg, "cuda", seed)
        calibrate_frozen_bn(model.backbone,
                            model.normalize_frames(batch["frames"]))
    model.train()
    o = cfg.optim
    optimizer = make_optimizer(
        model, o.lr, entry.TRAIN_T_TOTAL, o.warmup, o.schedule, o.b1, o.b2,
        o.eps, o.weight_decay, o.grad_clip, trainable_mask(model, cfg),
        o.optim)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    return model, make_train_step(cfg, model, optimizer), batch, generator


def caps_routing_ms(model, bsz: int, seed: int):
    """EM routing's device ms (torch.profiler, every kernel of the call) a
    forward and a backward (the gradients of the poses, the activations
    and the routing's parameters), on the primary capsules of random bf16
    trunk features of ``bsz`` clips."""
    tok = model.head.lxrt.encoder.caps_tokenizer
    e = model.head.cfg.encoder
    g = torch.Generator(device="cuda").manual_seed(seed)
    feats = torch.randn(bsz, e.visual_t, e.visual_hw, e.visual_hw,
                        e.visual_feat_dim, generator=g, device="cuda")
    with torch.no_grad():
        poses, acts = tok.primary_caps(tok.visn_fc(feats))
    n = bsz * e.visual_t * e.visual_hw * e.visual_hw
    poses = poses.reshape(n, e.num_prim_caps, -1).requires_grad_(True)
    acts = acts.reshape(n, e.num_prim_caps).requires_grad_(True)
    routing = tok.conv_caps
    with torch.no_grad():
        fwd = device_ms(lambda: routing(poses, acts), calls=5)[1]
    outs = routing(poses, acts)
    cot = tuple(torch.randn_like(o) for o in outs)
    leaves = (poses, acts) + tuple(routing.parameters())
    bwd = device_ms(lambda: torch.autograd.grad(outs, leaves, cot,
                                                retain_graph=True),
                    calls=5)[1]
    del outs, cot, leaves, poses, acts, feats
    return {"positions": n, "fwd_ms": fwd, "bwd_ms": bwd}


def caps_readings(star_model, star_cfg):
    """Readings, no limit: EM routing's device ms at STAR's B=8 and AGQA's
    B=32; the peak memory of a capsule STAR B=8 step (the driver's model)
    and of a capsule AGQA B=32 step (the flagship with the capsule
    encoder); capsule STAR against phase 9b's no-caps STAR (the same
    trunk) in clips/s at B=8, eager steps with the attention kernels, in
    turns."""
    out = {"routing_star_b8": caps_routing_ms(star_model, STAR_BATCH, 21)}
    nocaps_cfg = star_cfg.replace(encoder=dataclasses.replace(
        star_cfg.encoder, no_caps=True,
        visual_t=star_cfg.data.clip_len - 8))
    nocaps = entry.build_model(nocaps_cfg, "cuda", seed=21)
    nocaps.backbone.load_state_dict(star_model.backbone.state_dict())
    steps = {"capsules": caps_train_parts(star_cfg, STAR_BATCH, 21,
                                          star_model),
             "no_caps": caps_train_parts(nocaps_cfg, STAR_BATCH, 21,
                                         nocaps)}
    cps = {k: [] for k in steps}
    for name in ("capsules", "no_caps", "no_caps", "capsules"):
        _, step, batch, g = steps[name]
        cps[name].append(train_clips_per_second(step, batch, g,
                                                **TRAIN_TURN))
    out["star_b8_clips_per_s"] = cps
    out["star_b8_memory"] = {k: train_memory_gib(*v[1:])
                             for k, v in steps.items()}
    del steps, nocaps
    gc.collect()
    torch.cuda.empty_cache()
    agqa = caps_flagship_cfg()
    model, step, batch, g = caps_train_parts(agqa, BATCH_SIZE, 22)
    step(batch, g)
    out["agqa_b32_memory"] = train_memory_gib(step, batch, g)
    out["routing_agqa_b32"] = caps_routing_ms(model, BATCH_SIZE, 22)
    del model, step, batch, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_caps_driver(tmp: str, files: dict):
    """``cli.star.main`` at README.md's STAR flags as printed (the capsule
    encoder) with ``--stepsPerLoop 2`` at B=8 on synthetic STAR, its trunk
    from ``--backboneWeights``, one epoch of four steps: the launch counts
    of every step run on the host (the eager chunk and the capture) and of
    the valid forward, one capture and one replay, finite losses, the
    capsule encoder's geometry, LAST reloaded bit-equal; ``--test`` from
    LAST (oracle 1.0, ``by_qtype``, both predict files), plain and with
    ``--pallasAttention``.  Returns (the reloaded model, its config, the
    driver's seconds)."""
    out, data = os.path.join(tmp, "caps"), os.path.join(tmp, "caps_data")
    os.makedirs(data, exist_ok=True)
    argv = CAPS_STAR_FLAGS + CAPS_STAR_DATA + [
        "--output", out, "--dataDir", data, "--backboneWeights",
        files["trunk"]]
    saved, _Recorded.made = common.Trainer, []
    common.Trainer = _Recorded
    try:
        with _Counted(sync=False) as counted:
            result, stdout, seconds = run_main(argv, star.main)
    finally:
        common.Trainer = saved
    trainer = _Recorded.made[-1]
    chunks = trainer.chunks
    cfg = trainer.model.cfg
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    e = cfg.encoder
    enc = trainer.model.head.lxrt.encoder
    if (e.no_caps or e.caps_cross_attn or e.visual_seq_length != 785
            or enc.x_names or enc.caps_tokenizer.caps_dim != 544):
        raise AssertionError("the STAR driver at README.md's flags did not "
                             "build the capsule encoder of 785 tokens")
    if f"Loaded pretrained backbone from {files['trunk']}" not in stdout:
        raise AssertionError("capsule STAR: --backboneWeights not loaded")
    if (result["steps"], len(losses)) != (4, 4) or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"capsule STAR driver: {result['steps']} "
                             f"steps, losses {losses}")
    if chunks is None or (chunks.captures, chunks.replays) != (1, 1):
        raise AssertionError("capsule STAR driver: not one capture and one "
                             "replay")
    if counted.train != [CAPS_STAR_TRAIN] * 4:
        raise AssertionError(f"capsule STAR train steps launched "
                             f"{counted.train}, expected 4 x "
                             f"{CAPS_STAR_TRAIN}")
    if counted.eval != [CAPS_STAR_VALID]:
        raise AssertionError(f"capsule STAR valid forwards launched "
                             f"{counted.eval}, expected {CAPS_STAR_VALID}")
    fresh = reload_bit_equal(trainer.model, os.path.join(out, "LAST"),
                             "capsule STAR ")
    del chunks, trainer, enc, _Recorded.made[:]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"capsule STAR driver (README.md's flags as printed + "
        f"--stepsPerLoop 2): 4 steps, losses {losses}, 1 capture and 1 "
        f"replay, launches ({COUNT_NAMES}) per train step run on the host "
        f"{counted.train[0]}, per valid forward {counted.eval[0]}; history "
        f"{result['history']}; LAST reloads bit-equal; {seconds:.1f} s")
    for extra, want in CAPS_STAR_TEST_MODES:
        test_out = os.path.join(tmp, "caps_test" + "".join(extra))
        argv_test = [a if a != out else test_out for a in argv] + [
            "--test", "test", "--load", os.path.join(out, "LAST")] + extra
        with _Counted() as counted:
            result, stdout, test_seconds = run_main(argv_test, star.main)
        if "Oracle score: 1.0000" not in stdout:
            raise AssertionError(f"capsule STAR --test {extra}: oracle "
                                 "score not 1.0")
        if not counted.eval or any(c != want for c in counted.eval):
            raise AssertionError(f"capsule STAR --test {extra} forwards "
                                 f"launched {counted.eval}, expected {want}")
        if set(result["by_qtype"]) != {"Interaction", "Sequence",
                                       "Prediction", "Feasibility"}:
            raise AssertionError(f"capsule STAR --test by_qtype "
                                 f"{result['by_qtype']}")
        for name in ("predict.json", "predict_hg.json"):
            with open(os.path.join(test_out, name)) as f:
                if len(json.load(f)) != 4:
                    raise AssertionError(f"capsule STAR {name} does not "
                                         "hold 4 answers")
        log(f"capsule STAR --test {' '.join(extra)}: oracle 1.0, acc "
            f"{result['acc']}, hg_acc {result['hg_acc']}, launches per eval "
            f"forward {counted.eval[0]}, {test_seconds:.1f} s")
    return fresh, cfg, seconds


def phase_caps(tmp: str, files: dict):
    """Phase caps: (a) the capsule STAR driver (``phase_caps_driver``);
    (b) the head models of CAPS_VARIANTS at flagship widths in bf16 on
    random trunk features at B=8, through phase 9c's
    ``check_head_variant`` (hg_logit of the FFN kernel and of
    --pallasAttention within 5e-2 of the plain path; at dropout 0 the
    attention and FFN-train kernels against plain in the loss and the
    whole gradient vector; exact launch counts; the backward reaches
    exactly ``connected_param_mask``); (c) readings with no limit
    (``caps_readings``).  The attention kernels at the capsule encoder's
    shapes run in phase 3 (``CAPS_ATTN_SITES``).  Returns the seconds of
    each part and the readings."""
    t0 = time.perf_counter()
    seconds = {}
    model, cfg, seconds["driver_run"] = phase_caps_driver(tmp, files)
    seconds["driver"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    readings = caps_readings(model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    seconds["readings"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    base = entry.flagship_cfg()
    for name, enc, *want in CAPS_VARIANTS:
        vcfg = base.replace(encoder=dataclasses.replace(base.encoder, **enc))
        check_head_variant(name, vcfg, variant_batch(vcfg, TASK_BATCH, 23),
                           *want)
    seconds["variants"] = time.perf_counter() - t1
    seconds["phase"] = time.perf_counter() - t0
    log(f"capsule readings (no limit; {card_name_and_power_limit()}): "
        f"{json.dumps(readings)}")
    log(f"phase caps seconds {json.dumps(seconds)}")
    return seconds, readings


# ---------------------------------------------------------------------------
# Phase quant: the int8 frozen trunk (--quantBackbone int8, csrc/qconv.cu)

PEAK_INT8_OPS = 1979e12
# qconv launches of one trunk forward: 16 blocks x 3 convs + 4 projections
QCONV_PER_FORWARD = 52
# the trunk's distinct (Ci, Co, kernel, stride, side) conv cases at 224^2
QCONV_CASES = 23
QUANT_DRIVER_BATCH = 8
# a frozen int8 train step (the attention kernels at 38 / 34 sites) and
# an eval forward, with the int8 trunk
QUANT_STEP_LAUNCHES = (38, 34, 0, 0, 0, 0, 0, 0, 0, 0, QCONV_PER_FORWARD)
QUANT_EVAL_MODES = (
    ([], (0, 0, 18, 0, 0, 0, 0, 0, 0, 0, QCONV_PER_FORWARD)),
    (["--pallasAttention"], (38, 0, 18, 0, 0, 0, 0, 0, 0, 0,
                             QCONV_PER_FORWARD)))
QUANT_FLAGS = ["--quantBackbone", "int8"]
# a driver step at --backboneChunks 2 with --pallasFFNTrain, and a valid
# forward there (two chunks of the trunk each)
QUANT_DRIVER_LAUNCHES = (38, 34, 0, 18, 14, 0, 0, 0, 0, 0,
                         2 * QCONV_PER_FORWARD)
QUANT_VALID_LAUNCHES = (0, 0, 18, 0, 0, 0, 0, 0, 0, 0, 2 * QCONV_PER_FORWARD)


@contextlib.contextmanager
def qconv_calls(calls=None, plain=False):
    """While open, every ``qconv`` kernel launch appends its operands (those
    of ``qconv_reference``) to ``calls`` when given and, with ``plain``,
    runs the plain version on the card in its place (not counted)."""
    launch = qconv_mod._launch

    def spy(*args):
        if calls is not None:
            calls.append(args)
        return qconv_reference(*args) if plain else launch(*args)

    qconv_mod._launch = spy
    try:
        yield
    finally:
        qconv_mod._launch = launch


def qconv_case(args):
    """(Ci, Co, kernel, stride, side, epilogue) of a launch's operands."""
    x_q, w_k, _, _, stride, s_out, residual, _ = args
    return (x_q.shape[-1], w_k.shape[0], tuple(w_k.shape[1:4]), stride,
            x_q.shape[2], qconv_mod._mode(s_out, residual))


def taps_read(size: int, k: int, stride: int) -> int:
    """Input positions along a side of ``size`` that a conv of kernel k,
    padding k // 2 and ``stride`` reads (a 1x1 conv of stride 2 one in
    two)."""
    n = qconv_mod.out_side(size, k, stride)
    return len({o * stride + d - k // 2 for o in range(n)
                for d in range(k)} & set(range(size)))


def qconv_bound(args):
    """(ms, bound_by) of one launch: 2 M N K int8 operations over 1,979
    TOP/s, or the bytes (the input positions the taps read, the int8
    weight, the output, the residual, scale and shift, each once) over
    3.35 TB/s."""
    x_q, w_k, scale, _, stride, s_out, residual, _ = args
    b, t, h, w, ci = x_q.shape
    co, k = w_k.shape[0], w_k[0].numel()
    kt, kh, kw = w_k.shape[1:4]
    m = (b * t * qconv_mod.out_side(h, kh, stride)
         * qconv_mod.out_side(w, kw, stride))
    x_bytes = (b * taps_read(t, kt, 1) * taps_read(h, kh, stride)
               * taps_read(w, kw, stride) * ci)
    nbytes = (x_bytes + w_k.numel() + 2 * co * scale.element_size()
              + m * co * (scale.element_size() if s_out is None else 1)
              + (0 if residual is None
                 else residual.numel() * residual.element_size()))
    t_ops, t_bytes = 2 * m * co * k / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def quant_trunks(bsz, seed=0):
    """The flagship trunk in int8 and in bf16 on the same random weights
    (``seed``), the BatchNorm statistics and then the int8 scales
    calibrated on ``bsz`` random clips; returns (int8 trunk, bf16 trunk,
    the normalized clips)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randint(0, 256, (bsz, 16, 224, 224, 3), dtype=torch.uint8,
                           device="cuda", generator=g)
    mean, std = transforms.NORM_STATS["slow_r50"]
    x = transforms.normalize_clip(frames.to(torch.bfloat16) / 255.0, mean,
                                  std)
    trunks = []
    for quant in (True, False):
        trunk = SlowR50(torch.bfloat16, quant=quant)
        if quant:
            init_weights(trunk, seed)
        else:
            trunk.load_state_dict(trunks[0].state_dict())
        trunks.append(trunk.to("cuda", memory_format=torch.channels_last_3d)
                      .eval())
        if quant:
            calibrate_frozen_bn(trunks[0], x)
            calibrate_quant(trunks[0], x)
    return trunks[0], trunks[1], x


def random_qconv_args(shape, co, kernel, stride, mode, dtype, seed):
    """Random operands of one launch (int8 values in [-127, 127], the
    scales from a seeded generator)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, device="cuda",
                             generator=g)

    b, t, h, w, ci = shape
    out = (b, t, qconv_mod.out_side(h, kernel[1], stride),
           qconv_mod.out_side(w, kernel[2], stride), co)
    scale = (torch.rand(co, device="cuda", generator=g) * 1e-3).to(dtype)
    shift = torch.randn(co, device="cuda", generator=g).to(dtype)
    s_out = (None if mode == qconv_mod.MODE_DEQ
             else torch.rand((), device="cuda", generator=g))
    residual = s_res = None
    if mode == qconv_mod.MODE_RES:
        residual = torch.randn(out, device="cuda", generator=g).to(dtype)
    elif mode == qconv_mod.MODE_RES_Q:
        residual = i8(*out)
        s_res = torch.rand((), device="cuda", generator=g) * 0.1
    return (i8(*shape), i8(co, *kernel, ci), scale, shift, stride, s_out,
            residual, s_res)


# ragged launches: (x shape, Co, kernel, stride, epilogue, dtype)
QCONV_RAGGED = (
    ((1, 3, 9, 11, 64), 128, (1, 3, 3), 2, qconv_mod.MODE_QUANT,
     torch.bfloat16),
    ((2, 5, 7, 7, 192), 64, (3, 1, 1), 1, qconv_mod.MODE_RES_Q,
     torch.bfloat16),
    ((1, 2, 6, 6, 64), 64, (1, 1, 1), 2, qconv_mod.MODE_DEQ, torch.float32),
)


def check_qconv(tag, args):
    """The kernel twice and the plain version on one launch's operands:
    bit-equal.  Returns (the output, max |kernel - plain|)."""
    want = qconv_reference(*args)
    got = qconv_mod._launch(*args)
    again = qconv_mod._launch(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"qconv {tag}: two calls differ")
    if got.dtype != want.dtype:
        raise AssertionError(f"qconv {tag}: kernel gives {got.dtype}, the "
                             f"plain version {want.dtype}")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if not torch.equal(got, want):
        raise AssertionError(
            f"qconv {tag}: kernel differs from the plain version at "
            f"{int((diff > 0).sum())} of {diff.numel()} elements, max {err}")
    return got, err


def qconv_kernel_checks(calls):
    """The kernel against its plain version, bit-equal, on the operands of
    every distinct case of ``calls`` (a B=2 trunk forward's launches), at
    the ragged launches and with an all-zero scale (its 1e-12 floor).
    Returns the largest |kernel - plain| over all of them."""
    cases = {}
    for args in calls:
        cases.setdefault(qconv_case(args), args)
    # a conv_c and a projection of one shape are two cases
    shapes = {case[:5] + (case[5] == qconv_mod.MODE_DEQ,) for case in cases}
    if len(shapes) != QCONV_CASES:
        raise AssertionError(f"the trunk's conv cases: {len(shapes)}, "
                             f"expected {QCONV_CASES}")
    errs = [check_qconv(case, args)[1] for case, args in cases.items()]
    for i, (shape, co, kernel, stride, mode, dt) in enumerate(QCONV_RAGGED):
        errs.append(check_qconv(f"ragged {shape} -> {co}", random_qconv_args(
            shape, co, kernel, stride, mode, dt, seed=i))[1])
    args = list(next(a for c, a in cases.items()
                     if c[5] == qconv_mod.MODE_QUANT))
    zero = torch.zeros((), device="cuda")
    args[5] = zero
    y, err = check_qconv("s_out = 0", args)
    errs.append(err)
    if not bool((y.abs() == 127).any()):
        raise AssertionError("qconv with s_out = 0 does not saturate")
    args[2] = (args[2] * 0).contiguous()           # scale 0: shift only
    errs.append(check_qconv("scale 0, s_out = 0", args)[1])
    log(f"qconv: bit-equal to qconv_reference at the trunk's "
        f"{len(shapes)} conv cases ({len(cases)} with their epilogues) at "
        f"B=2, {len(QCONV_RAGGED)} ragged launches and an all-zero scale "
        f"(max |kernel - plain| {max(errs)}); two calls bit-equal")
    return max(errs)


def quant_times(calls, bsz):
    """Per trunk forward at ``bsz`` (the 52 launches of ``calls``): the
    kernel's time (events median [min-max] of 3 turns, device time by
    torch.profiler, and the 52 launches as one CUDA graph's replay), the
    plain version's (one turn), torch._int_mm on the
    1x1 stride-1 convs (the same s32 product, no epilogue), cuDNN bf16
    F.conv3d of the 52 convs (the yardstick), and the bound."""
    def kernels():
        for args in calls:
            qconv_mod._launch(*args)

    def plain():
        for args in calls:
            qconv_reference(*args)

    mm_ops = []
    conv_ops = []
    for args in calls:
        x_q, w_k, _, _, stride, *_ = args
        kt, kh, kw = w_k.shape[1:4]
        if (kt, kh, kw, stride) == (1, 1, 1, 1):
            mm_ops.append((x_q.reshape(-1, x_q.shape[-1]),
                           w_k.reshape(w_k.shape[0], -1).t()))
        conv_ops.append((x_q.to(torch.bfloat16).permute(0, 4, 1, 2, 3),
                         w_k.to(torch.bfloat16).permute(0, 4, 1, 2, 3),
                         (1, stride, stride), (kt // 2, kh // 2, kw // 2)))

    def int_mm():
        for a, b in mm_ops:
            torch._int_mm(a, b)

    def cudnn():
        for x, w, st, pad in conv_ops:
            F.conv3d(x, w, None, st, pad)

    row = spread("kernel_ms", kernels, iters=3)
    row["kernel_device_ms"] = device_ms(kernels, calls=3)[1]
    row["kernel_graph_ms"] = graph_ms(kernels)
    row["plain_ms"] = time_ms(plain, iters=1, warmup=1)
    row["int_mm_ms"] = time_ms(int_mm, iters=3)
    row["int_mm_convs"] = len(mm_ops)
    row["cudnn_bf16_ms"] = time_ms(cudnn, iters=3)
    bounds = [qconv_bound(args) for args in calls]
    row["bound_ms"] = sum(ms for ms, _ in bounds)
    by_ops = sum(ms for ms, by in bounds if by == "operations")
    row["bound_by"] = ("operations" if by_ops >= row["bound_ms"] / 2
                       else "bytes")
    row["launches"] = len(calls)
    del conv_ops, mm_ops
    log(f"qconv per trunk forward at b{bsz}: {json.dumps(row)}")
    if bsz != 2:
        # each launch alone (events, 3 calls), summed by case, beside its
        # bound: where the kernel stands farthest from it
        cases = {}
        for args, (bound, by) in zip(calls, bounds):
            ms = time_ms(lambda: qconv_mod._launch(*args), iters=3,
                         warmup=1)
            case = cases.setdefault(str(qconv_case(args)),
                                    [0, 0.0, 0.0, by])
            case[0] += 1
            case[1] += ms
            case[2] += bound
        log(f"qconv b{bsz} by case (launches, ms, bound ms, bound by): "
            + json.dumps(cases))
    return row


def graph_ms(fn, iters: int = 5) -> float:
    """ms per call of ``fn()`` captured once as a CUDA graph and replayed
    (CUDA events over ``iters`` replays): its kernels back to back without
    the host's launch gaps, where a long session's profiler trace can lose
    kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        fn()
    ms = time_ms(graph.replay, iters=iters, warmup=1)
    del graph
    return ms


def quant_stages(trunk, x):
    """Device ms of the int8 trunk's forward on ``x`` outside the qconv
    kernels, by stage, each a CUDA graph's replay (``graph_ms``): the stem
    (bf16 conv, BN, ReLU), its quantize and the int8 pool, and the rest
    (each launch's ``quant_weight``, scale fold and weight permute, and the
    last dequantize: the forward with each kernel launch replaced by its
    recorded output, less the first two)."""
    outs = []
    launch = qconv_mod._launch

    def record(*args):
        outs.append(launch(*args))
        return outs[-1]

    qconv_mod._launch = record
    try:
        trunk(x)
        replay = itertools.cycle(outs)
        qconv_mod._launch = lambda *args: next(replay)
        outside = graph_ms(lambda: trunk(x))
    finally:
        qconv_mod._launch = launch
    del outs, replay
    h = x.to(trunk.dtype).permute(0, 4, 1, 2, 3)

    def stem():
        return torch.relu(trunk.stem_bn(trunk.stem_conv(h)))

    stem_ms = graph_ms(stem)
    y = stem()
    pool_ms = graph_ms(lambda: max_pool_i8(
        quant_sym(y, trunk.s_stem).permute(0, 2, 3, 4, 1)))
    return {"outside qconv": outside, "stem": stem_ms,
            "quantize + pool": pool_ms,
            "weights, fold, dequantize": outside - stem_ms - pool_ms}


def trunk_device_ms(trunk, x):
    with torch.inference_mode():
        return device_ms(lambda: trunk(x), calls=3)[1]


def phase_quant_trunk(bsz):
    """At ``bsz`` clips: the int8 trunk's launches captured (52), at B=2
    the kernel checks and the kernel path bit-equal to the plain int8
    path; the times of the 52 launches (``quant_times``); at B=32 the
    trunk's device time in int8, in bf16 and in bf16 with the block
    switch, and the int8 features against the bf16 ones.  Returns the
    row of ``quant_times``."""
    trunk_q, trunk_f, x = quant_trunks(bsz)
    calls = []
    with torch.inference_mode():
        reset_counts()
        with qconv_calls(calls):
            feats = trunk_q(x)
        torch.cuda.synchronize()
        if qconv.launches != QCONV_PER_FORWARD:
            raise AssertionError(f"an int8 trunk forward launched qconv "
                                 f"{qconv.launches} times")
        if bsz == 2:
            err = qconv_kernel_checks(calls)
            with qconv_calls(plain=True):
                plain = trunk_q(x)
            trunk_err = (feats.float() - plain.float()).abs().max().item()
            if not torch.equal(feats, plain):
                raise AssertionError("the int8 trunk's kernel path differs "
                                     "from its plain path by up to "
                                     f"{trunk_err}")
            log("int8 trunk b2: the kernel path bit-equal to the plain int8 "
                f"path, features {tuple(feats.shape)}")
        row = quant_times(calls, bsz)
        if bsz == 2:
            row["max_abs_err"] = max(err, trunk_err)
        del calls
        if bsz != 2:
            ref = trunk_f(x).float()
            err = (feats.float() - ref).abs()
            scale = ref.abs().max()
            row["features"] = {
                "rel_frobenius": ((feats.float() - ref).norm()
                                  / ref.norm()).item(),
                "max_err": (err.max() / scale).item(),
                "mean_err": (err.mean() / scale).item()}
            row["trunk_device_ms"] = {"int8": trunk_device_ms(trunk_q, x),
                                      "bf16": trunk_device_ms(trunk_f, x)}
            set_block_kernel(trunk_f, True)
            row["trunk_device_ms"]["bf16 + block kernel"] = trunk_device_ms(
                trunk_f, x)
            set_block_kernel(trunk_f, False)
            row["stages_device_ms"] = quant_stages(trunk_q, x)
            row["stages_device_ms"]["qconv"] = row["kernel_graph_ms"]
            top, busy = breakdown.top_kernels(lambda: trunk_q(x), top=40)
            log(f"int8 trunk b{bsz}: {busy:.3f} device ms, top kernels "
                + json.dumps(top))
            log(f"int8 trunk b{bsz}: device ms by stage "
                + json.dumps(row["stages_device_ms"]))
            log(f"int8 trunk b{bsz}: features against bf16 "
                f"{json.dumps(row['features'])}; trunk device ms "
                f"{json.dumps(row['trunk_device_ms'])}")
    del trunk_q, trunk_f, x, feats
    gc.collect()
    torch.cuda.empty_cache()
    return row


def peak_gib(fn) -> float:
    """Peak device memory allocated by ``fn()`` under inference mode above
    what was allocated before it, GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def phase_quant_model(bsz=BATCH_SIZE):
    """``entry.entry(quant_backbone="int8")`` at B=2 with the counts from 0
    (18 FFN + 52 qconv); then at ``bsz`` the flagship with the int8 trunk
    against the bf16 trunk on the same weights: hg_logit argmax agreement
    (as ``tools/quant_numerics.py``), inference clips/s in turns, and the
    int8 model's peak device memory in a forward with ``--backboneChunks
    4`` against 1, and in a training forward's frames path with rand_aug
    and aug_mix: chunks 4 against 1, and the batch augmented whole with the
    trunk alone in 4 chunks.  Returns (the main path's launches, the
    clips/s)."""
    fn, (model, batch) = entry.entry(quant_backbone="int8")
    reset_counts()
    y = fn(model, batch)
    torch.cuda.synchronize()
    launched = counts()
    want = (0, 0, 18, 0, 0, 0, 0, 0, 0, 0, QCONV_PER_FORWARD)
    if launched != want or not torch.isfinite(y).all():
        raise AssertionError(f"int8 main path launched {launched}, expected "
                             f"{want}, or non-finite hg_logit")
    log(f"main path (int8 trunk): hg_logit {tuple(y.shape)}, launches "
        f"({COUNT_NAMES}) {launched}")
    del fn, model, batch, y
    model_q = entry.build_model(entry.trunk_cfg(entry.flagship_cfg(),
                                                "int8"), "cuda")
    batches = [entry.device_batch(model_q.cfg, bsz, seed)
               for seed in (0, 1)]
    calibrate_frozen_bn(model_q.backbone,
                        model_q.normalize_frames(batches[0]["frames"]))
    model_q.calibrate_quant(batches[0]["frames"])
    model_f = entry.build_model(entry.flagship_cfg(), "cuda")
    model_f.load_state_dict(model_q.state_dict())
    with torch.inference_mode():
        agree = [(model_q(b)["hg_logit"].argmax(-1)
                  == model_f(b)["hg_logit"].argmax(-1)).float().mean().item()
                 for b in batches]
    runs = {"int8": [], "bf16": []}
    for name in ("int8", "bf16", "bf16", "int8"):
        runs[name].append(clips_per_second(
            model_q if name == "int8" else model_f, batches))
    base_cfg = model_q.cfg
    peak = {}
    for chunks in (1, 4):
        model_q.cfg = base_cfg.replace(backbone_chunks=chunks)
        peak[f"chunks {chunks}"] = peak_gib(lambda: model_q(batches[0]))
    # a training forward's frames path (augment, normalize, trunk): the
    # whole path in chunks, and the batch augmented whole with the trunk
    # alone in 4 chunks
    frames, g = batches[0]["frames"], torch.Generator(device="cuda")
    model_q.train()
    for aug in ("rand_aug", "aug_mix"):
        for chunks in (1, 4):
            model_q.cfg = base_cfg.replace(
                backbone_chunks=chunks,
                data=dataclasses.replace(base_cfg.data, augment_type=aug))
            peak[f"train {aug}, chunks {chunks}"] = peak_gib(
                lambda: model_q.encode_frames(frames, g.manual_seed(0)))
        peak[f"train {aug}, augmented whole, trunk in 4 chunks"] = peak_gib(
            lambda: torch.cat([model_q.backbone(c) for c in
                               model_q.normalize_frames(
                                   frames, g.manual_seed(0)).chunk(4)]))
    model_q.eval()
    model_q.cfg = base_cfg
    log(f"int8 vs bf16 trunk, flagship b{bsz}: hg_logit argmax agreement "
        f"{agree}; inference clips/s {json.dumps(runs)}; peak device memory "
        f"above the resident GiB {json.dumps(peak)}")
    del model_q, model_f, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launched, {k: sum(v) / len(v) for k, v in runs.items()}


def phase_quant_graph(bsz=QUANT_DRIVER_BATCH):
    """A frozen int8 train step (``entry.train_entry(quant_backbone="int8")``,
    the attention kernels) as 2-step chunks of the k-step graph: the eager
    chunk and the capture launch 2 x (38, 34, 52 qconv) each, one capture,
    finite losses, 0 host syncs in a replayed chunk."""
    model, optimizer, generator, batch = entry.train_entry(
        batch_size=bsz, quant_backbone="int8")
    step = chunked_step(model, optimizer, generator, 2)
    launched = []
    for _ in range(2):           # the eager chunk, the capture and replay
        reset_counts()
        step(batch, generator)
        launched.append(counts())
    chunks = step.chunks
    replays = [chunks.replays]
    syncs = count_host_syncs(lambda: step(batch, generator))
    replays.append(chunks.replays)
    torch.cuda.synchronize()
    losses = chunks.metrics["total_loss"].tolist()
    want = tuple(2 * c for c in QUANT_STEP_LAUNCHES)
    if launched != [want, want] or chunks.captures != 1 or replays != [
            1, 2] or syncs["count"] or not all(map(math.isfinite, losses)):
        raise AssertionError(
            f"int8 train chunks: launches {launched} (expected 2 x {want}), "
            f"{chunks.captures} captures, replays {replays}, host "
            f"syncs {syncs}, losses {losses}")
    log(f"int8 frozen train step b{bsz} in the 2-step graph: launches of the "
        f"eager chunk and of the capture {launched[0]}, 1 capture, a "
        f"replayed chunk's host syncs 0, losses {losses}")
    del model, optimizer, generator, batch, step, chunks
    gc.collect()
    torch.cuda.empty_cache()


def quant_example_frames(argv):
    """The frames of the driver's example batch (the first of the train
    split's epoch 0), rebuilt from its flags."""
    cfg, extras = common.parse_reference_flags_with_extras(argv,
                                                           dataset="agqa")
    data = common.build_data(cfg, extras, cfg.data.train_split)
    cfg = common.resolve_num_answers(cfg, data)
    tokenizer = common.build_tokenizer(
        cfg, extras, [x["question"] for x in data.datums])
    src = common.build_item_source(cfg, extras, data, tokenizer)
    batcher = common.Batcher(src, num_items=len(src),
                             batch_size=cfg.optim.batch_size, shuffle=True,
                             drop_last=True, seed=cfg.seed)
    return torch.from_numpy(next(batcher.epoch(0))["frames"]).cuda()


def phase_quant_driver(tmp: str, files: dict):
    """The agqa_hgqa driver at the published flags + ``--quantBackbone int8
    --backboneChunks 2 --pallasFFNTrain --stepsPerLoop 2``, the trunk from
    ``--backboneWeights``, B=8 on 32 synthetic clips, one epoch: the
    launches of each step run on the host (38 / 34 attention, 18 / 14 FFN
    train, 104 qconv), finite losses, the scales equal to a calibration of
    the loaded trunk on the example batch, LAST reloaded bit-equal with
    its scales; ``--test`` from LAST (18 FFN + 52 qconv per forward, with
    ``--pallasAttention`` + 38 attention; oracle 1.0)."""
    t0 = time.perf_counter()
    out = os.path.join(tmp, "quant")
    base = DRIVER_FLAGS + QUANT_FLAGS + [
        "--syntheticData", "32", "--syntheticValid", "8", "--batchSize",
        str(QUANT_DRIVER_BATCH), "--logFreq", "1", "--epochs", "1",
        "--dataDir", tmp, "--backboneWeights", files["trunk"]]
    argv = base + ["--output", out, "--backboneChunks", "2",
                   "--stepsPerLoop", "2"]
    with _Counted(sync=False) as counted:
        result, stdout, seconds = run_main(argv)
    want, want_eval = QUANT_DRIVER_LAUNCHES, QUANT_VALID_LAUNCHES
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    if (counted.train != [want] * 4 or not counted.eval
            or any(c != want_eval for c in counted.eval)
            or len(losses) != 4 or not all(map(math.isfinite, losses))):
        raise AssertionError(f"int8 driver: train launches {counted.train} "
                             f"(4 x {want}), eval {counted.eval}, losses "
                             f"{losses}")
    model = counted.model
    trunk = model.backbone
    fresh = entry.build_model(model.cfg, "cuda", seed=model.cfg.seed + 1)
    Trainer(model.cfg, 1, fresh).load_backbone(files["trunk"])
    if fresh.backbone.calibrated:
        raise AssertionError("a trunk file set the int8 scales")
    fresh.calibrate_quant(quant_example_frames(argv))
    state = trunk.state_dict()
    scales = [k for k in state if is_quant_scale(k)]
    for k, v in fresh.backbone.state_dict().items():
        if not torch.equal(v, state[k]):
            raise AssertionError(f"int8 driver: {k} is not the loaded "
                                 "trunk's calibration on the example batch")
    fresh = entry.build_model(model.cfg, "cuda", seed=model.cfg.seed + 2)
    Trainer(model.cfg, 1, fresh, trainable_mask(fresh, model.cfg)).load(
        os.path.join(out, "LAST"))
    trained = model.state_dict()
    for k, v in fresh.state_dict().items():
        if not torch.equal(v, trained[k]):
            raise AssertionError(f"int8 LAST reloads {k} differently")
    if not fresh.backbone.calibrated:
        raise AssertionError("int8 LAST did not restore the scales")
    del fresh, trained, model, trunk, state, counted
    gc.collect()
    torch.cuda.empty_cache()
    log(f"int8 driver: {result['steps']} steps, launches per train step "
        f"({COUNT_NAMES}) {want}, per valid forward {want_eval}; losses "
        f"{losses}; {len(scales)} scales = the loaded trunk's calibration on "
        f"the example batch; LAST reloads bit-equal with them; "
        f"{seconds:.1f} s")
    test_s = []
    for extra, want in QUANT_EVAL_MODES:
        test_out = os.path.join(tmp, "quant_test" + "".join(extra))
        argv_test = base + ["--output", test_out, "--test", "test", "--load",
                            os.path.join(out, "LAST")] + extra
        with _Counted() as counted:
            _, stdout, seconds = run_main(argv_test)
        if "Oracle score: 1.0000" not in stdout:
            raise AssertionError(f"int8 --test {extra}: oracle not 1.0")
        if not counted.eval or any(c != want for c in counted.eval):
            raise AssertionError(f"int8 --test {extra} forwards launched "
                                 f"{counted.eval}, expected {want}")
        test_s.append(seconds)
    log(f"int8 driver --test from LAST: oracle 1.0, launches per forward "
        f"{[w for _, w in QUANT_EVAL_MODES]}; {test_s} s; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return want


def phase_quant_card_vs_cpu():
    """A tiny f32 hgqa model with the int8 trunk: the card (the qconv
    kernel in f32) against the CPU (the plain int8 path), both from one set
    of weights and scales calibrated on the CPU, held at quant-step
    granularity (the stem's float conv may flip a rounding): correlation
    > 0.999 and max |error| < 0.05 max |CPU| for the features, logit and
    hg_logit (the JAX test's own criterion)."""
    cfg = tiny_test_config(task="hgqa", quant_backbone="int8",
                           freeze_backbone=True, use_pallas_ffn=False)
    cpu = entry.build_model(cfg, "cpu", seed=6)
    rng = np.random.RandomState(6)
    d, e = cfg.data, cfg.encoder
    batch = {
        "input_ids": rng.randint(1, e.vocab_size, (2, d.max_seq_length)),
        "input_mask": np.ones((2, d.max_seq_length), np.int32),
        "segment_ids": np.zeros((2, d.max_seq_length), np.int32),
        "frames": rng.randint(0, 255, (2, e.visual_t + 8, d.image_size,
                                       d.image_size, 3)).astype(np.uint8),
    }
    frames = torch.as_tensor(batch["frames"])
    calibrate_frozen_bn(cpu.backbone, cpu.normalize_frames(frames))
    cpu.calibrate_quant(frames)
    gpu = copy.deepcopy(cpu).to("cuda")
    worst = {}
    reset_counts()
    with torch.inference_mode():
        outs = []
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            y = model(tb)
            y["features"] = model.encode_frames(tb["frames"])
            outs.append({k: y[k].double().cpu() for k in
                         ("features", "logit", "hg_logit")})
    if qconv.launches != 2 * QCONV_PER_FORWARD:
        raise AssertionError(f"card forwards launched qconv {qconv.launches}")
    want, got = outs
    for k in want:
        a, b = want[k].ravel(), got[k].ravel()
        corr = float(np.corrcoef(a.numpy(), b.numpy())[0, 1])
        err = ((a - b).abs().max() / a.abs().max().clamp_min(1e-6)).item()
        worst[k] = {"corr": corr, "max_err": err,
                    "equal": bool(torch.equal(a, b))}
        if corr <= 0.999 or err >= 0.05:
            raise AssertionError(f"int8 card vs CPU {k}: {worst[k]}")
    log(f"int8 trunk card (kernel) vs CPU (plain), tiny, f32: "
        f"{json.dumps(worst)}")


def phase_quant(tmp=None, files=None):
    """Phase quant (``--only quant``): the qconv kernel's checks and times
    at B=2 and B=32, the int8 main path and model, the k-step graph, the
    driver (the weight files written first when none are given) and the
    tiny card vs CPU check.  Returns (the kernels line's entry fields: the
    rows at B=32 and B=2 and the main path's launches), the clips/s."""
    t0 = time.perf_counter()
    for kernel, (count, first) in sass_hgmma(
            "qconv", ["qconv_kernel"], op="IGMMA", forbid=("IMMA",)).items():
        log(f"sass qconv {kernel}: {count} IGMMA (wgmma .s8) instructions "
            f"over its instances, no IMMA (mma.sync), e.g. `{first}`")
    rows = {b: phase_quant_trunk(b) for b in (2, BATCH_SIZE)}
    launched, cps = phase_quant_model()
    phase_quant_graph()
    if files is None:
        with tempfile.TemporaryDirectory() as own:
            phase_quant_driver(own, write_weight_files(own))
    else:
        phase_quant_driver(tmp, files)
    phase_quant_card_vs_cpu()
    log(f"phase quant: {time.perf_counter() - t0:.1f} s")
    return rows, launched, cps


# ---------------------------------------------------------------------------
# Phase ddp: data parallelism (``parallel/``, ``--multiGPU``, the SHGVQA_*
# launch).  The card host has one H100 and NCCL refuses two ranks on one
# device: (a) runs NCCL with one rank (its driver run is phase 7b's,
# ``phase_driver_steps_per_loop``), (b) gloo with two ranks on the card.

# (a) the frozen flagship's steps at B=8 as 2-step chunks of the graph (chunk 1 eager,
# chunk 2 captured and replayed) with the NCCL group of one and without any,
# each way DDP_RUNS times from one state, held by phase 7b's spread rule
DDP_BATCH, DDP_STEPS, DDP_RUNS, DDP_K = 8, 4, 3, 2
# (b) gloo, two ranks on the one card: frozen-trunk steps of the flagship
# in bf16 at dropout 0.1, B=16 global, 8 a rank
DDP_GLOO_WORLD, DDP_GLOO_BATCH, DDP_GLOO_STEPS = 2, 16, 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_graph_runs(model, optimizer, generator, batches, start, runs):
    """``runs`` runs of ``DDP_STEPS`` steps from ``start`` as
    ``DDP_K``-step chunks (chunk 1 eager, chunk 2 captured and replayed):
    [(losses, parameters, generator state)].  The train step sums over the
    ranks if a process group runs when it is made."""
    out = []
    for _ in range(runs):
        spl_restore(model, optimizer, generator, start)
        chunks = StepChunks(model, make_train_step(model.cfg, model,
                                                   optimizer),
                            optimizer, generator, DDP_K)
        losses = [chunks.run(batches[i:i + DDP_K])["total_loss"].clone()
                  for i in range(0, DDP_STEPS, DDP_K)]
        torch.cuda.synchronize()
        if (chunks.captures, chunks.replays) != (1, 1):
            raise AssertionError("ddp graph run: not one capture and one "
                                 "replay")
        out.append((torch.cat(losses).cpu(),
                    [p.detach().clone() for p in optimizer.params],
                    generator.get_state()))
        del chunks
        gc.collect()
    return out


def phase_ddp_steps():
    """(a) at step level: the frozen flagship at B=8, ``DDP_STEPS`` steps
    as ``DDP_K``-step chunks in the graph, ``DDP_RUNS`` times without a
    process group and ``DDP_RUNS`` times under an NCCL group of one (the
    gradient sum and the normalizers' all-reduces captured): in the
    per-step losses and in the parameters, the median distance of the
    group's runs to the plain runs at most ``SPL_SPREAD`` x the median
    distance between two plain runs (floor ``SPL_FLOOR``), every loss
    finite, the generator states equal.  Then the readings, in turns: a
    replayed chunk with and without the group (train clips/s), and one
    all-reduce of the flat buffer of the trainable parameters (ms, CUDA
    events).  Returns the readings."""
    t0 = time.perf_counter()
    model, optimizer, generator, _ = entry.train_entry(batch_size=DDP_BATCH)
    batches = spl_batches(model.cfg, DDP_BATCH, DDP_STEPS)
    generator.manual_seed(11)
    start = spl_state(model, optimizer, generator)
    plain = ddp_graph_runs(model, optimizer, generator, batches, start,
                           DDP_RUNS)
    plain_step = StepChunks(model, make_train_step(model.cfg, model,
                                                   optimizer),
                            optimizer, generator, DDP_K)
    distributed.maybe_initialize_distributed(f"127.0.0.1:{free_port()}", 1,
                                             0, device="cuda")
    try:
        if distributed.backend() != "nccl":
            raise AssertionError(f"ddp: backend {distributed.backend()}")
        grouped = ddp_graph_runs(model, optimizer, generator, batches, start,
                                 DDP_RUNS)
        pairs = [spl_distance(plain[i], plain[j]) for i in range(DDP_RUNS)
                 for j in range(i + 1, DDP_RUNS)]
        gaps = [spl_distance(g, p) for g in grouped for p in plain]
        if not all(torch.isfinite(r[0]).all() for r in plain + grouped):
            raise AssertionError("ddp: a non-finite loss")
        if not all(x[2] for x in pairs + gaps):
            raise AssertionError("ddp: the generator's state differs")
        for i, what in enumerate(("loss", "parameters")):
            spread_ = statistics.median(p[i] for p in pairs)
            near = statistics.median(g[i] for g in gaps)
            log(f"ddp (a) steps with an NCCL group of one vs none, {what}: "
                f"median group-plain {near}, median plain-plain {spread_}")
            if near > max(SPL_SPREAD * spread_, SPL_FLOOR):
                raise AssertionError(f"ddp: the group's {what} differ by "
                                     f"{near} (median), the plain runs' own "
                                     f"spread {spread_} (median)")
        # readings: a replayed chunk with and without the group, in turns
        spl_restore(model, optimizer, generator, start)
        group_step = StepChunks(model, make_train_step(model.cfg, model,
                                                       optimizer),
                                optimizer, generator, DDP_K)
        for chunks in (plain_step, group_step):      # eager, then capture
            chunks.run(batches[:DDP_K])
            chunks.run(batches[:DDP_K])
        cps = {"without": [], "with the all-reduce": []}
        for name, chunks in (("without", plain_step),
                             ("with the all-reduce", group_step),
                             ("with the all-reduce", group_step),
                             ("without", plain_step)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(3):
                chunks.run(batches[:DDP_K])
            torch.cuda.synchronize()
            cps[name].append(3 * DDP_K * DDP_BATCH
                             / (time.perf_counter() - t1))
        n = sum(p.numel() for p in optimizer.params) + 8
        flat = torch.zeros(n, device="cuda")
        reduce_ms = time_ms(lambda: distributed.all_reduce_sum_(flat))
    finally:
        distributed.shutdown()
    readings = {"train_clips_per_s_b8_k2": cps,
                "all_reduce_ms_a_step": reduce_ms,
                "all_reduce_bytes": n * 4}
    log(f"ddp (a) readings (no limit): {json.dumps(readings)}; "
        f"{time.perf_counter() - t0:.1f} s")
    del plain_step, group_step, model, optimizer, plain, grouped
    gc.collect()
    torch.cuda.empty_cache()
    return readings


def ddp_rank(rank: int, world: int, port: int, out: str) -> None:
    """(b) one rank, in its own process, of a gloo group on the one card:
    the flagship's ``train_entry`` at B=16 (every rank builds the same
    global batch, so the trunk's statistics calibrate alike), this rank's
    8 rows; a ``Trainer.predict`` merged over the ranks and this rank's
    hg_logit, before any step; then ``DDP_GLOO_STEPS`` eager frozen-trunk
    steps at dropout 0.1 with the launch counts and all-reduces of each,
    the global loss and gradient norm, and a digest of the parameters
    after.  Writes ``{out}/rank{rank}.pt``."""
    import hashlib

    distributed.maybe_initialize_distributed(
        f"127.0.0.1:{port}", world, rank, device="cuda", backend="gloo")
    try:
        model, optimizer, generator, batch = entry.train_entry(
            batch_size=DDP_GLOO_BATCH)
        set_dropout_rate(model, 0.1)
        cfg = model.cfg.replace(output=os.path.join(out, f"out{rank}"))
        local = {k: mesh.local_rows(v) for k, v in batch.items()}
        qids = mesh.local_rows([f"q{i}" for i in range(DDP_GLOO_BATCH)])
        trainer = Trainer(cfg, 1, model)
        with torch.inference_mode():
            model.eval()
            hg_logit = model(local)["hg_logit"].float().cpu()
        q2a, hg_q2a = trainer.predict([dict(local, ques_id=qids,
                                            n_valid=len(qids))])
        del trainer
        model.train()
        step = make_train_step(cfg, model, optimizer)
        rows = []
        for _ in range(DDP_GLOO_STEPS):
            torch.cuda.synchronize()
            reset_counts()
            before = distributed.all_reduce_sum_.launches
            metrics = step(local, generator)
            torch.cuda.synchronize()
            rows.append({"launches": counts(),
                         "all_reduces": distributed.all_reduce_sum_.launches
                         - before,
                         "loss": metrics["total_loss"].item(),
                         "grad_norm": metrics["grad_norm"].item()})
        flat = torch.cat([p.detach().float().flatten()
                          for p in optimizer.params]).cpu().numpy()
        torch.save({"hg_logit": hg_logit, "q2a": q2a, "hg_q2a": hg_q2a,
                    "steps": rows, "digest":
                    hashlib.sha256(flat.tobytes()).hexdigest()},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def start_ddp_gloo():
    """(b)'s ranks, started: ``DDP_GLOO_WORLD`` processes, each
    ``ddp_rank`` on the one card.  Returns (their output directory, the
    processes) for ``phase_ddp_gloo``; they spend their first seconds
    importing and building on the host, which the caller may overlap."""
    out = tempfile.TemporaryDirectory()
    port = free_port()
    code = ("import sys, chip_smoke; chip_smoke.ddp_rank("
            "*map(int, sys.argv[1:4]), sys.argv[4])")
    root = str(Path(__file__).resolve().parent)
    procs = []
    for r in range(DDP_GLOO_WORLD):
        # each rank's output to a file: a pipe nobody reads meanwhile fills
        with open(os.path.join(out.name, f"rank{r}.log"), "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(r), str(DDP_GLOO_WORLD),
                 str(port), out.name], cwd=root, stdout=f,
                stderr=subprocess.STDOUT))
    return out, procs


def phase_ddp_gloo(gloo):
    """(b) Two ranks on the one card over gloo (``gloo``: the output
    directory and processes of ``start_ddp_gloo``), against one process
    here on the global batch: every
    rank's exit code 0; per step 38 / 34 attention launches and
    ``DDP_STEP_ALL_REDUCES`` all-reduces in each rank; the parameters
    after the steps bit-equal across the ranks (digest); each step's loss
    and gradient norm within TRAIN_TOL (phase 6's) of one process's at
    B=16 (the masks are the global batch's rows, so this holds the
    kernels' offsets too; dQ's atomics keep eager runs from repeating
    bit-equal); the merged predict covers each of the 16 questions once,
    the ranks' maps alike, and their hg_logit rows within TOL_HG (phase
    4's) of one process's forward."""
    t0 = time.perf_counter()
    out, procs = gloo
    with out:
        try:
            # one process on the global batch meanwhile
            model, optimizer, generator, batch = entry.train_entry(
                batch_size=DDP_GLOO_BATCH)
            set_dropout_rate(model, 0.1)
            with torch.inference_mode():
                model.eval()
                want_hg = model(batch)["hg_logit"].float().cpu()
            model.train()
            step = make_train_step(model.cfg, model, optimizer)
            want = []
            for _ in range(DDP_GLOO_STEPS):
                metrics = step(batch, generator)
                want.append((metrics["total_loss"].item(),
                             metrics["grad_norm"].item()))
            del model, optimizer, batch, step
            gc.collect()
            torch.cuda.empty_cache()
            for p in procs:
                p.wait(timeout=900)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            with open(os.path.join(out.name, f"rank{r}.log")) as f:
                for line in f.read().splitlines()[-20:]:
                    log(f"  | rank {r}: {line}")
            if p.returncode:
                raise AssertionError(f"ddp (b): rank {r} exited "
                                     f"{p.returncode}")
        ranks = [torch.load(os.path.join(out.name, f"rank{r}.pt"),
                            weights_only=False)
                 for r in range(DDP_GLOO_WORLD)]
    for r, res in enumerate(ranks):
        for i, row in enumerate(res["steps"]):
            if (row["launches"][:2] != DRIVER_TRAIN_LAUNCHES[:2]
                    or row["all_reduces"] != DDP_STEP_ALL_REDUCES):
                raise AssertionError(f"ddp (b) rank {r} step {i}: launches "
                                     f"{row['launches']}, all-reduces "
                                     f"{row['all_reduces']}")
            for what, got, ref in (("loss", row["loss"], want[i][0]),
                                   ("grad norm", row["grad_norm"],
                                    want[i][1])):
                if not abs(got - ref) <= TRAIN_TOL * abs(ref):
                    raise AssertionError(f"ddp (b) rank {r} step {i}: {what} "
                                         f"{got}, one process {ref}")
    if len({res["digest"] for res in ranks}) != 1:
        raise AssertionError("ddp (b): the ranks' parameters differ after "
                             "the steps")
    qids = {f"q{i}" for i in range(DDP_GLOO_BATCH)}
    for res in ranks:
        if (set(res["q2a"]) != qids or set(res["hg_q2a"]) != qids
                or res["q2a"] != ranks[0]["q2a"]):
            raise AssertionError("ddp (b): the merged predict does not cover "
                                 "every question once")
    got_hg = torch.cat([res["hg_logit"] for res in ranks])
    hg_err = ((got_hg - want_hg).norm() / want_hg.norm()).item()
    if hg_err > TOL_HG:
        raise AssertionError(f"ddp (b): hg_logit {hg_err} from one process")
    log(f"ddp (b) gloo, {DDP_GLOO_WORLD} ranks on one card, B="
        f"{DDP_GLOO_BATCH} global: per step and rank launches "
        f"{[[row['launches'] for row in res['steps']] for res in ranks]}, "
        f"all-reduces {[[row['all_reduces'] for row in res['steps']] for res in ranks]}; "
        f"loss, grad norm {[[(row['loss'], row['grad_norm']) for row in res['steps']] for res in ranks]} "
        f"against one process {want}; parameters bit-equal across ranks; "
        f"the merged predict {len(qids)} questions once each; hg_logit rel "
        f"Frobenius {hg_err:.3e} from one process; "
        f"{time.perf_counter() - t0:.1f} s")
    return time.perf_counter() - t0


def phase_ddp(overlap=None):
    """Phase ddp: (a) at step level (its readings first, the card to
    itself), then (b), whose ranks build on the host while ``overlap()``
    runs (phase 10 in the full run: checks, no timing); returns the
    readings.  (a)'s driver run is phase 7b's
    (``phase_driver_steps_per_loop``)."""
    t0 = time.perf_counter()
    readings = phase_ddp_steps()
    gloo = start_ddp_gloo()
    try:
        if overlap is not None:
            overlap()
    except BaseException:
        for p in gloo[1]:
            p.kill()
            p.wait()
        gloo[0].cleanup()
        raise
    phase_ddp_gloo(gloo)
    log(f"phase ddp: {time.perf_counter() - t0:.1f} s")
    return readings


# ---------------------------------------------------------------------------
# Phase tp: tensor parallelism (--modelParallel 2, JAX's _TP_RULES) as two
# gloo ranks on the one card (NCCL refuses two ranks on one device)

TP_WORLD, TP_BATCH = 2, 8
# the runs of (a): the default kernels, and the FFN-train kernels on
# (--pallasFFNTrain), each one forward and backward from one generator
# state at the sites' dropout rates
TP_RUNS = (("default", False), ("pallasFFNTrain", True))
# a rank's launches in one step of each run: one process's (each attention
# site at 6 of 12 heads, each FFN site's split chain one forward and one
# backward launch); in one --test forward the split FFN inference chain at
# the 18 FFN sites
TP_TRAIN_LAUNCHES = {"default": (38, 34, 0, 0, 0, 0, 0, 0, 0, 0, 0),
                     "pallasFFNTrain": (38, 34, 0, 18, 14, 0, 0, 0, 0, 0, 0)}
TP_EVAL_LAUNCHES = (0, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)
# a rank's model-group collectives in one forward and backward of the
# frozen flagship hgqa step (no optimizer step), by function
# (``distributed.model_collectives``), derived from the code:
# - gather_from_model, a forward all-gather per BERT attention call: 5 l +
#   5 r + 2 x 2 LXRT cross + 2 x 2 HG cross = 18;
# - reduce_from_model, a forward all-reduce per row-split product: 18 FFN,
#   20 decoder out_proj, 10 decoder linear2, 4 MLPHead fc2 (logit_fc twice,
#   for logit and hg_logit, class_embed, action_embed) = 52;
# - sum_over_model, the split LayerNorms' two row sums: 4 MLPHead calls x 2
#   forward, and backward 2 each for the 3 calls the loss reaches (the
#   logit call feeds no loss) = 14;
# - copy_to_model, a backward all-reduce per distinct input of a split
#   module the backward reaches: 10 self attentions x 1 + 4 HG cross x 2
#   (the LXRT x-layers feed only the unsupervised logit) = 18, 14 FFN
#   (the 4 LXRT cross FFNs unreached), 20 decoder self attentions and
#   cross attentions x 2 distinct inputs, but the first layer's self
#   attention, whose value (a zero target) needs no gradient: 40 - 2 = 38,
#   10 decoder FFNs, 3 MLPHeads = 83;
# - model_sum_ (the clip's): 0 (no optimizer step).
TP_STEP_COLLECTIVES = {"copy_to_model": 83, "reduce_from_model": 52,
                       "sum_over_model": 14, "gather_from_model": 18,
                       "model_sum_": 0}
# the rule of (a): the median distance of the tensor-parallel run to the
# one-process runs (loss, gradient vector) at most bf16's own distance on
# the same step (the one-process step on the plain paths in bf16 against an
# f32 twin of the same weights, the same dropout draws).  A rank rounds its
# partial products to bf16 before the cross-rank sum, so the split step is
# one process's arithmetic reassociated in bf16: phase 7b's rule (2x the
# plain runs' own distance, which is 0 for the loss, the forward being
# deterministic) cannot hold for it.  Phase 7b's ratio is logged beside.
TP_READING_STEPS = 3
# (b): the attention kernels at a rank's heads (6 of 12, head0 6) at B=2,
# and the split FFN chain (two halves of F) at M = 2 x 393
TP_ATTN_SITES = (("visual self", 393, 393, "key", 0.1),
                 ("rel decoder self", 128, 128, "pane", 0.15))
TP_FFN_M = 2 * 393


def tp_bf16_distance(model, optimizer, generator, batch, start):
    """bf16's own (loss, gradient) distance on the step: the one-process
    step on the plain paths (no kernel) in bf16 against an f32 twin of the
    same weights and statistics, from the generator state ``start`` (the
    plain dropout draws do not depend on the dtype: both drop the same
    elements)."""
    set_attention_kernel(model, False)
    bf16 = tp_gradients(model, optimizer, generator, batch, start)
    set_attention_kernel(model, True)
    twin = entry.build_model(model.cfg.replace(compute_dtype="float32"),
                             "cuda", seed=0)
    twin.load_state_dict(model.state_dict())
    set_attention_kernel(twin.train(), False)
    names = {id(p): n for n, p in model.named_parameters()}
    twins = dict(twin.named_parameters())
    params = [twins[names[id(p)]] for p in optimizer.params]
    holder = SimpleNamespace(params=params, zero_grad=lambda: [
        setattr(p, "grad", None) for p in params])
    f32 = tp_gradients(twin, holder, generator, batch, start)
    del twin, holder, params
    gc.collect()
    return remat_distance(bf16, f32)


def tp_gradients(model, optimizer, generator, batch, start):
    """One forward and backward of the train step's loss from the
    generator state ``start``: (loss, the gradient vector of the trainable
    parameters as one process holds them (split ones gathered), launches,
    model collectives by function)."""
    generator.set_state(start)
    optimizer.zero_grad()
    torch.cuda.synchronize()
    reset_counts()
    before = distributed.model_collectives()
    loss, _ = compute_losses(model.cfg, model(batch, generator), batch)
    loss.backward()
    torch.cuda.synchronize()
    launched = counts()
    issued = {k: v - before[k]
              for k, v in distributed.model_collectives().items()}
    grads = []
    for p in optimizer.params:
        g = p.grad.detach() if p.grad is not None else torch.zeros_like(p)
        if getattr(p, "tp_split", None) is not None:
            g = mesh.whole_of(g, p.tp_split)
        grads.append(g.float().flatten())
    optimizer.zero_grad()
    return loss.item(), torch.cat(grads).cpu(), launched, issued


@contextlib.contextmanager
def collective_clock(ms: list):
    """While open, every model-group collective's wall time (synchronized
    before and after) is appended to ``ms``."""
    saved = distributed._model_sum, distributed._model_gather

    def timed(fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    distributed._model_sum, distributed._model_gather = map(timed, saved)
    try:
        yield
    finally:
        distributed._model_sum, distributed._model_gather = saved


def tp_step_readings(model, optimizer, generator, batch):
    """Readings: the eager train step's ms (one step to warm, then the
    median of ``TP_READING_STEPS``, synchronized), and under tensor
    parallelism the model collectives' ms a step and their share."""
    model.train()
    step = make_train_step(model.cfg, model, optimizer)
    step(batch, generator)
    steps, coll = [], []
    for _ in range(TP_READING_STEPS):
        mine = []
        with collective_clock(mine) if distributed.model_size() > 1 \
                else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch, generator)
            torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        coll.append(sum(mine))
    ms, cms = statistics.median(steps), statistics.median(coll)
    return {"step_ms": ms, "step_ms_all": steps, "collectives_ms": cms,
            "collectives_share": cms / ms, "collectives_a_step": len(mine)}


def tp_rank(rank: int, world: int, port: int, out: str) -> None:
    """(a) and (c) as one rank, in its own process, of a gloo group of
    dp1 x mp2 on the one card: the frozen flagship's ``train_entry`` at
    B=8 (every rank builds the one-process model and splits it), the runs
    of ``TP_RUNS`` with their launches and collectives, then a --test
    forward (its launches and hg_logit) and ``Trainer.predict``; after
    ``{out}/go`` appears, the step readings.  Writes
    ``{out}/tp{rank}.pt``."""
    distributed.maybe_initialize_distributed(
        f"127.0.0.1:{port}", world, rank, device="cuda", backend="gloo")
    distributed.set_model_parallel(world)
    try:
        model, optimizer, generator, batch = entry.train_entry(
            batch_size=TP_BATCH)
        res = {"runs": {}, "split": len(mesh.sharded_parameters(model))}
        start = generator.get_state()
        for name, ffn_on in TP_RUNS:
            set_ffn_train_kernel(model, ffn_on)
            res["runs"][name] = tp_gradients(model, optimizer, generator,
                                             batch, start)
        set_ffn_train_kernel(model, False)
        model.eval()
        reset_counts()
        with torch.inference_mode():
            res["hg_logit"] = model(batch)["hg_logit"].float().cpu()
        torch.cuda.synchronize()
        res["eval_launches"] = counts()
        cfg = model.cfg.replace(output=os.path.join(out, f"out{rank}"))
        trainer = Trainer(cfg, 1, model)
        qids = [f"q{i}" for i in range(TP_BATCH)]
        res["q2a"], res["hg_q2a"] = trainer.predict(
            [dict(batch, ques_id=qids, n_valid=len(qids))])
        del trainer
        gc.collect()
        go = os.path.join(out, "go")
        while not os.path.exists(go):
            time.sleep(0.05)
        res["readings"] = tp_step_readings(model, optimizer, generator,
                                           batch)
        torch.save(res, os.path.join(out, f"tp{rank}.pt"))
    finally:
        distributed.shutdown()


def start_tp_gloo():
    """The ranks of phase tp, started: ``TP_WORLD`` processes, each
    ``tp_rank`` on the one card.  Returns (their output directory, the
    processes) for ``phase_tp``."""
    out = tempfile.TemporaryDirectory()
    port = free_port()
    code = ("import sys, chip_smoke; chip_smoke.tp_rank("
            "*map(int, sys.argv[1:4]), sys.argv[4])")
    root = str(Path(__file__).resolve().parent)
    procs = []
    for r in range(TP_WORLD):
        with open(os.path.join(out.name, f"rank{r}.log"), "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(r), str(TP_WORLD),
                 str(port), out.name], cwd=root, stdout=f,
                stderr=subprocess.STDOUT))
    return out, procs


def stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def tp_attention_check(site, lq, lk, kind, rate, b=2):
    """(b) The attention kernels at a tensor-parallel rank's heads: the
    keep mask at Hl = 6 of Hg = 12 heads from head0 = 6 bit-equal to the
    one-process mask's heads 6-11 and to ``keep_mask_reference`` with those
    arguments; the forward and dQ, dK, dV called with ``heads=(6, 12)``
    against the plain version given that mask (phase 3's tolerances).
    Returns the worst relative error."""
    hl = H // TP_WORLD
    q, k, v, mask = attention_operands(b, lq, lk, kind, seed=23)
    q, k, v = (t[:, hl:] for t in (q, k, v))
    seed = draw_seed(torch.Generator(device="cuda").manual_seed(29), "cuda")
    got = keep_mask(seed, b * hl, lq, lk, rate, heads=hl, heads_global=H,
                    head0=hl)
    whole = keep_mask(seed, b * H, lq, lk, rate).view(b, H, lq, lk)
    want = keep_mask_reference(seed, b * hl, lq, lk, rate, heads=hl,
                               heads_global=H, head0=hl)
    if not (torch.equal(got.view(b, hl, lq, lk), whole[:, hl:])
            and torch.equal(got.cpu(), want)):
        raise AssertionError(f"tp {site}: the keep mask at heads {hl}-"
                             f"{H - 1} differs from the one-process mask's "
                             "or from keep_mask_reference")
    g = torch.Generator(device="cuda").manual_seed(31)
    state = g.get_state()
    leaves = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
    out = fused_attention(*leaves, mask, rate, g, heads=(hl, H))
    g.set_state(state)
    keep = keep_mask(draw_seed(g, "cuda"), b * hl, lq, lk, rate, heads=hl,
                     heads_global=H, head0=hl).view(b, hl, lq, lk)
    _, fwd = rel_max_err(f"tp {site} fwd", out, attention_reference(
        q, k, v, mask, rate, keep), ATTN_TOL)
    do = torch.randn(out.shape, device="cuda").to(torch.bfloat16)
    _, grads = grad_errors(f"tp {site}", *leaves, mask, rate, keep, out, do)
    log(f"tp (b) attention {site} b{b} rate {rate} at heads {hl}-{H - 1} "
        f"of {H}: keep mask bit-equal to the one-process mask's heads and "
        f"to keep_mask_reference; forward rel max err {fwd:.3e}, dQ/dK/dV "
        f"{grads:.3e}")
    return max(fwd, grads)


def tp_ffn_check(rate, m=TP_FFN_M):
    """(b) The split FFN chain on one card: the two halves of F's products
    (``_FFNProducts``, F / 2 = 1536 columns each), their partials summed,
    the row pass (``_FFNRows``) from one seed, against the one-call chain
    from that seed and against ``ffn_train_reference`` with the kernels'
    keep mask, forward (within TOL) and backward (dx = dr + the halves'
    partials through autograd; every gradient within FFN_GRAD_TOL of the
    plain version's).  Returns the worst relative error."""
    ops = tuple(t.detach().requires_grad_(True) for t in ffn_operands(m))
    x, w1t, b1, w2t, b2, gamma, beta = ops
    seed = draw_seed(torch.Generator(device="cuda").manual_seed(37), "cuda")
    f = FF // TP_WORLD
    what = "fused_ffn_train"
    parts = [ffn_kernels._FFNProducts.apply(
        x, w1t[i * f:(i + 1) * f].contiguous(), b1[i * f:(i + 1) * f],
        w2t[:, i * f:(i + 1) * f].contiguous(), what)
        for i in range(TP_WORLD)]
    y = ffn_kernels._FFNRows.apply(parts[0] + parts[1], x, b2, gamma, beta,
                                   seed if rate > 0 else None, rate, 1e-12,
                                   0, what)
    one = ffn_kernels._FusedFFNTrain.apply(*(o.detach() for o in ops),
                                           seed if rate > 0 else None, rate,
                                           1e-12, 0)
    keep = ffn_keep_mask(seed, m, D, rate) if rate > 0 else None
    e_one = check_close(f"tp split FFN rate {rate} vs the one-call chain", y,
                        one)
    e_ref = check_close(f"tp split FFN rate {rate}", y,
                        ffn_train_reference(*ops, rate, keep))
    dy = torch.randn(m, D, device="cuda").to(torch.bfloat16)
    _, grads = ffn_train_grads_vs_plain(f"tp split FFN rate {rate}", ops, y,
                                        dy, rate, keep)
    log(f"tp (b) split FFN chain M={m} rate {rate} (F / 2 = {f} columns a "
        f"half): forward max err {e_one:.3e} vs the one-call chain, "
        f"{e_ref:.3e} vs ffn_train_reference; gradients rel max err "
        f"{grads:.3e}")
    return grads


def phase_tp_kernels():
    """(b) The kernels alone at a tensor-parallel rank's shapes."""
    errs = [tp_attention_check(*site) for site in TP_ATTN_SITES]
    errs += [tp_ffn_check(rate) for rate in (0.0, FFN_TRAIN_RATE)]
    return max(errs)


def phase_tp(gloo):
    """Phase tp (``--only tp``): the ranks of ``start_tp_gloo`` (``gloo``:
    their output directory and processes) against one process here, the
    frozen flagship at B=8 from the same weights and generator state:

    (a) every rank's exit code 0; each run's launches ``TP_TRAIN_LAUNCHES``
        and model collectives ``TP_STEP_COLLECTIVES`` in each rank; the
        gathered gradients bit-equal across the ranks; the loss and the
        gradient vector's median distance to the one-process runs at most
        bf16's own on the step (``tp_bf16_distance``);
    (b) ``phase_tp_kernels`` (here, while the ranks run);
    (c) the --test forward's launches ``TP_EVAL_LAUNCHES`` and hg_logit
        within TOL_HG (phase 4's) of one process's; ``Trainer.predict``'s
        merged answers one process's argmax wherever its top two logits
        are further apart than the ranks' largest logit error, every
        question once;

    then the readings (no limit): the step's ms a rank (the ranks alone on
    the card) and one process's, the collectives' ms and share.  Returns
    the readings."""
    t0 = time.perf_counter()
    out, procs = gloo
    with out:
        try:
            model, optimizer, generator, batch = entry.train_entry(
                batch_size=TP_BATCH)
            start = generator.get_state()
            plain = {}
            for name, ffn_on in TP_RUNS:
                set_ffn_train_kernel(model, ffn_on)
                plain[name] = [tp_gradients(model, optimizer, generator,
                                            batch, start) for _ in range(2)]
                if plain[name][0][2] != TP_TRAIN_LAUNCHES[name]:
                    raise AssertionError(f"tp one process {name}: launches "
                                         f"{plain[name][0][2]}")
            set_ffn_train_kernel(model, False)
            bf16 = tp_bf16_distance(model, optimizer, generator, batch,
                                    start)
            model.eval()
            with torch.inference_mode():
                want = model(batch)
            want_hg = want["hg_logit"].float().cpu()
            want_logit = want["logit"].float().cpu()
            del want
            kernel_err = phase_tp_kernels()
            Path(out.name, "go").touch()
            for p in procs:
                p.wait(timeout=600)
            one = tp_step_readings(model, optimizer, generator, batch)
        finally:
            stop(procs)
        for r, p in enumerate(procs):
            with open(os.path.join(out.name, f"rank{r}.log")) as f:
                for line in f.read().splitlines()[-20:]:
                    log(f"  | tp rank {r}: {line}")
            if p.returncode:
                raise AssertionError(f"tp: rank {r} exited {p.returncode}")
        ranks = [torch.load(os.path.join(out.name, f"tp{r}.pt"),
                            weights_only=False) for r in range(TP_WORLD)]
    del model, optimizer, batch
    gc.collect()
    torch.cuda.empty_cache()
    gaps = {}
    for name, _ in TP_RUNS:
        runs = [res["runs"][name] for res in ranks]
        for r, run in enumerate(runs):
            if (run[2] != TP_TRAIN_LAUNCHES[name]
                    or run[3] != TP_STEP_COLLECTIVES):
                raise AssertionError(f"tp {name} rank {r}: launches {run[2]}"
                                     f", collectives {run[3]}")
            if not torch.equal(run[1], runs[0][1]) or run[0] != runs[0][0]:
                raise AssertionError(f"tp {name}: rank {r}'s gradients or "
                                     "loss differ from rank 0's")
            if not (math.isfinite(run[0]) and torch.isfinite(run[1]).all()):
                raise AssertionError(f"tp {name}: a non-finite loss or "
                                     "gradient")
        spread = remat_distance(plain[name][0], plain[name][1])
        dist = [remat_distance(runs[0], p) for p in plain[name]]
        gaps[name] = {"plain": spread, "tp": dist}
    log(f"tp (a) distances (loss, gradient): {json.dumps(gaps)}; bf16's "
        f"own (plain paths, bf16 vs f32): {bf16}")
    for name, gap in gaps.items():
        for i, what in enumerate(("loss", "gradient")):
            near = statistics.median(d[i] for d in gap["tp"])
            log(f"tp (a) {name} {what}: {near} from one process (median), "
                f"bf16's own {bf16[i]}; phase 7b's ratio to the plain runs' "
                f"own {gap['plain'][i]}: "
                f"{near / gap['plain'][i] if gap['plain'][i] else 'inf'}")
            if not near <= bf16[i]:
                raise AssertionError(f"tp {name}: the {what} differs by "
                                     f"{near} (median) from one process, "
                                     f"more than bf16's own {bf16[i]}")
    for r, res in enumerate(ranks):
        if res["eval_launches"] != TP_EVAL_LAUNCHES:
            raise AssertionError(f"tp --test rank {r}: launches "
                                 f"{res['eval_launches']}")
    got_hg = ranks[0]["hg_logit"]
    hg_err = ((got_hg - want_hg).norm() / want_hg.norm()).item()
    if hg_err > TOL_HG or not all(torch.equal(res["hg_logit"], got_hg)
                                  for res in ranks):
        raise AssertionError(f"tp --test: hg_logit {hg_err} from one "
                             "process, or the ranks' differ")
    qids = [f"q{i}" for i in range(TP_BATCH)]
    ties = 0
    for key, logits in (("q2a", want_logit), ("hg_q2a", want_hg)):
        top = logits.topk(2, dim=-1)
        for res in ranks:
            if set(res[key]) != set(qids):
                raise AssertionError(f"tp --test: {key} does not cover "
                                     "every question once")
        for i, q in enumerate(qids):
            decisive = (top.values[i, 0] - top.values[i, 1]).item() > (
                2 * (got_hg - want_hg).abs().max().item())
            ties += not decisive
            if decisive and ranks[0][key][q] != int(top.indices[i, 0]):
                raise AssertionError(f"tp --test: {key} {q} answered "
                                     f"{ranks[0][key][q]}, one process "
                                     f"{int(top.indices[i, 0])}")
    readings = {"ranks": [res["readings"] for res in ranks],
                "one_process": one, "split_params": ranks[0]["split"]}
    log(f"tp (a) dp1 x mp2 gloo, 2 ranks on one card, B={TP_BATCH}, frozen "
        f"flagship: launches a rank {json.dumps({k: v[2] for k, v in ranks[0]['runs'].items()})}, "
        f"collectives a rank {json.dumps(TP_STEP_COLLECTIVES)}; gathered "
        f"gradients bit-equal across ranks; distances (loss, gradient) "
        f"{json.dumps(gaps)}, bf16's own {bf16}; (b) worst kernel rel err {kernel_err:.3e}; "
        f"(c) --test launches {ranks[0]['eval_launches']}, hg_logit rel "
        f"Frobenius {hg_err:.3e}, answers one process's ({ties} near-ties "
        f"excused); readings (no limit) {json.dumps(readings)}; "
        f"{time.perf_counter() - t0:.1f} s ({card_name_and_power_limit()})")
    return readings


# ---------------------------------------------------------------------------
# Phase trunks: the other video trunks (models/backbones_extra.py, mvit.py,
# video_swin.py), the native frame decoder and --patches

# each trunk's clip at full width: (name, frames, side); mvit_B and
# video_swin_impl halve time, so they run at --clipLEN 32
TRUNK_CLIPS = (("resnext101", 16, 224), ("slowfast_r50", 16, 256),
               ("slowfast_r101", 16, 256), ("mvit_B", 32, 224),
               ("video_swin_impl", 32, 224))
# the same topologies at TOY widths for card against CPU (f32, TF32 off):
# (class, its overrides, frames of 32 pixels)
TRUNK_TOYS = (
    ("resnext101", backbones_extra.ResNeXt101,
     dict(depths=(2, 1, 1, 1), groups=4, width_per_group=2, stem_width=8,
          outs=(16, 32, 64, 128)), 2),
    ("slowfast", backbones_extra.SlowFastR50,
     dict(depths=(2, 1, 1, 1), stem_width=16, mids=(8, 16, 32, 64),
          outs=(32, 64, 128, 256)), 8),
    ("mvit_B", mvit_mod.MViTB,
     dict(frames=8, image_size=32, embed_dim=8, depth=4, num_heads=1,
          stage_blocks=(1, 3), kv_stride=(1, 4, 4)), 8),
    ("video_swin_impl", video_swin_mod.VideoSwin,
     dict(embed_dim=8, depths=(1, 2, 1), heads=(1, 2, 4),
          window=(2, 2, 2)), 8))
TRUNK_TOY_TOL = 1e-4
TRUNK_READING_BATCH = 8
# slowfast's tokenizer convs (16 steps of 8 x 8 features, 2304 channels)
# and the bottleneck blocks its switch routes: slow res_2 blocks 1-2 and
# res_3 blocks 1-3 on 4 frames a clip (16 / alpha), the fast pathway's and
# slow res_2 block 0's (Ci = 64 + 16) not
SLOWFAST_HW = 8
SLOWFAST_TOK_SITES = (("slowfast conv1", 16, 2304), ("slowfast conv2", 12, D))
SLOWFAST_BLOCK_SITES = (
    ("slowfast res_2 blocks 1-2", 64, 256, 64, 256, False, 2),
    ("slowfast res_3 blocks 1-3", 32, 512, 128, 512, False, 3))
SLOWFAST_BLOCKS = 5
# the real-frame --test run: the flagship's flags with the slowfast trunk on
# PNG frames of the dataset's size, 16 questions at eval B=8 (--batchSize
# 32 // 4), each eval forward with the FFN kernel at its 18 sites
TRUNK_DRIVER_FLAGS = ["--taskHGQA", "--noCaps", "--crossAttnType", "cross",
                      "--llayers", "5", "--xlayers", "2", "--rlayers", "5",
                      "--dlayers", "5", "--backbone", "slowfast_r50",
                      "--batchSize", str(BATCH_SIZE), "--buildVocab"]
TRUNK_DRIVER_QUESTIONS = 16
TRUNK_EVAL_LAUNCHES = (0, 0, 18, 0, 0, 0, 0, 0, 0, 0, 0)
# --patches: the flagship head on 8 frames of 7 x 7 patches of 32 x 32 x 3,
# the same attention and FFN sites as the flagship
PATCHES_VARIANT = ("--patches", dict(patches=True, visual_feat_dim=3072),
                   38, 34, 18, 18, 14)


def slowfast_hub_state_dict(trunk) -> dict:
    """The pytorchvideo ``slowfast_r50`` state_dict of ``trunk`` (the
    inverse of ``utils/convert_slowfast.convert``'s mapping)."""
    v = to_jax_variables(trunk.state_dict())
    params, stats = v["params"], v["batch_stats"]
    sd = {}

    def conv(dst, kernel):
        sd[dst + ".weight"] = torch.from_numpy(np.ascontiguousarray(
            kernel.transpose(4, 3, 0, 1, 2)))

    def bn(dst, p, st):
        for key, value in (("weight", p["scale"]), ("bias", p["bias"]),
                           ("running_mean", st["mean"]),
                           ("running_var", st["var"])):
            sd[f"{dst}.{key}"] = torch.from_numpy(value)

    for pi, path in enumerate(("slow", "fast")):
        src = f"blocks.0.multipathway_blocks.{pi}"
        conv(f"{src}.conv", params[f"{path}_stem_conv"]["kernel"])
        bn(f"{src}.norm", params[f"{path}_stem_bn"], stats[f"{path}_stem_bn"])
    for b in range(4):
        src = f"blocks.{b}.multipathway_fusion"
        conv(f"{src}.conv_fast_to_slow", params[f"fuse_{b}_conv"]["kernel"])
        bn(f"{src}.norm", params[f"fuse_{b}_bn"], stats[f"fuse_{b}_bn"])
    for stage in range(4):
        for pi, path in enumerate(("slow", "fast")):
            name = f"{path}_res_{stage + 2}"
            for blk, p in params[name].items():
                st = stats[name][blk]
                bb = (f"blocks.{stage + 1}.multipathway_blocks.{pi}."
                      f"res_blocks.{int(blk.split('_')[1])}")
                if "conv_proj" in p:
                    conv(f"{bb}.branch1_conv", p["conv_proj"]["kernel"])
                    bn(f"{bb}.branch1_norm", p["bn_proj"], st["bn_proj"])
                for t in "abc":
                    conv(f"{bb}.branch2.conv_{t}", p[f"conv_{t}"]["kernel"])
                    bn(f"{bb}.branch2.norm_{t}", p[f"bn_{t}"], st[f"bn_{t}"])
    return sd


def trunk_full_width(name, frames, side, seed):
    """(a) One trunk at full width, bf16, frozen, on the card (random
    weights, the BatchNorm statistics calibrated on the clip): the B=2
    forward's shape (the trunk's own steps, side and channels) and finite
    values; readings with no limit: device ms a forward at B=8 (events,
    one turn) and its peak memory."""
    geometry = ({"frames": frames, "image_size": side}
                if name in GEOMETRY_TRUNKS else {})
    trunk = entry.channels_last_convs(init_weights(make_backbone(
        name, torch.bfloat16, **geometry).to("cuda"), seed).eval())
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(2, frames, side, side, 3, generator=g, device="cuda")
    calibrate_frozen_bn(trunk, x)
    with torch.inference_mode():
        y = trunk(x)
    torch.cuda.synchronize()
    hw = trunk.spatial_out(side)
    want = (2, trunk_steps(name, frames), hw, hw, trunk.out_channels)
    if tuple(y.shape) != want or trunk.temporal_out(frames) != want[1]:
        raise AssertionError(f"trunk {name}: features {tuple(y.shape)}, "
                             f"expected {want}")
    if not torch.isfinite(y.float()).all():
        raise AssertionError(f"trunk {name}: non-finite features")
    del y
    bsz = TRUNK_READING_BATCH
    x = torch.randn(bsz, frames, side, side, 3, generator=g, device="cuda")

    def forward():
        with torch.inference_mode():
            return trunk(x)

    row = {"features": list(want),
           "params_m": sum(p.numel() for p in trunk.parameters()) / 1e6,
           f"forward_ms_b{bsz}": time_ms(forward, iters=3, warmup=1),
           f"peak_gib_b{bsz}": peak_gib(forward)}
    log(f"trunk {name} ({frames} x {side}^2, bf16, frozen): {json.dumps(row)}")
    del trunk, x
    gc.collect()
    torch.cuda.empty_cache()
    return row


def trunk_toy_card_vs_cpu(name, cls, toy, frames, seed=5):
    """(a) The trunk at TOY widths in f32: the card's forward within
    TRUNK_TOY_TOL x max |CPU's| of the CPU's on the same weights and
    frames (BatchNorm statistics calibrated on the CPU)."""
    cpu = init_weights(cls(torch.float32, **toy), seed).eval()
    x = torch.randn(2, frames, 32, 32, 3,
                    generator=torch.Generator().manual_seed(seed))
    calibrate_frozen_bn(cpu, x)
    card = copy.deepcopy(cpu).to("cuda")
    with torch.no_grad():
        want = cpu(x)
        got = card(x.cuda()).cpu()
    err = ((got - want).abs().max() / want.abs().max()).item()
    log(f"trunk {name} TOY f32 card vs CPU: features {tuple(want.shape)}, "
        f"max |err| / max |CPU| {err:.3e}")
    if not err <= TRUNK_TOY_TOL:
        raise AssertionError(f"trunk {name} TOY: card vs CPU {err}")
    return err


def slowfast_block_switch(seed=9):
    """(b) The block switch on a full-width slowfast_r50 trunk (bf16, B=2,
    statistics calibrated): a forward launches the bottleneck kernel at
    exactly the SLOWFAST_BLOCKS blocks it takes, and each of those blocks'
    kernel output is within TOK_BLOCK_TOL x max |ref| of the same block's
    convs on the same input (phase 3's rule, at the trunk's own
    activations).  The whole trunk's features: each kernel block rounds
    where the convs round otherwise and the difference grows through the
    blocks after it, so the kernel path may sit at most GRAD_NOISE x as far
    (relative Frobenius) from the same trunk in f32 (TF32 off) as the
    switch-off bf16 trunk does; the distance to the switch-off features is
    logged."""
    trunk = entry.channels_last_convs(init_weights(make_backbone(
        "slowfast_r50", torch.bfloat16).to("cuda"), seed).eval())
    x = torch.randn(2, 16, 256, 256, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed))
    calibrate_frozen_bn(trunk, x)
    ref = entry.channels_last_convs(make_backbone(
        "slowfast_r50", torch.float32).to("cuda").eval())
    ref.load_state_dict(trunk.state_dict())
    routed = []
    hooks = [m.register_forward_hook(
        lambda m, args, out: routed.append((m, args[0], out)))
        for m in trunk.modules()
        if isinstance(m, Bottleneck3D) and m.fits_kernel]
    with torch.inference_mode():
        f32 = ref(x).float()
        del ref
        want = trunk(x).float()
        routed.clear()
        set_block_kernel(trunk, True)
        torch.cuda.synchronize()
        reset_counts()
        got = trunk(x).float()
        torch.cuda.synchronize()
        launched = counts()
        for h in hooks:
            h.remove()
        if launched != (0,) * 6 + (SLOWFAST_BLOCKS,) + (0,) * 4:
            raise AssertionError(f"slowfast block switch launched "
                                 f"{launched}, expected {SLOWFAST_BLOCKS} "
                                 "bottlenecks")
        names = {m: n for n, m in trunk.named_modules()}
        block_err = {}
        set_block_kernel(trunk, False)
        for m, h_in, h_out in routed:
            block_err[names[m]] = rel_max_err(
                f"slowfast {names[m]} kernel vs convs", h_out, m(h_in),
                TOK_BLOCK_TOL)[1]
    if len(block_err) != SLOWFAST_BLOCKS:
        raise AssertionError(f"slowfast block switch routed {block_err}")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    dist = {"on vs off": rel(got, want), "on vs f32": rel(got, f32),
            "off vs f32": rel(want, f32),
            "max |on - off| / max |off|": ((got - want).abs().max()
                                           / want.abs().max()).item()}
    log(f"slowfast_r50 trunk with set_block_kernel: {SLOWFAST_BLOCKS} "
        f"bottleneck launches a forward, each block's max |err| / max |ref| "
        f"against its convs {json.dumps(block_err)}; features, relative "
        f"Frobenius {json.dumps(dist)}")
    if not (torch.isfinite(got).all()
            and dist["on vs f32"] <= GRAD_NOISE * dist["off vs f32"]):
        raise AssertionError(f"slowfast trunk, block switch on vs off: "
                             f"{dist}")
    return launched[6], {"blocks": block_err, **dist}


def trunk_driver(tmp: str):
    """(c) ``agqa_hgqa --test`` with the slowfast trunk on real files
    (``data.synthetic.write_agqa_files``: 16 questions, 4 videos of 16
    480 x 360 PNG frames) under the default ``--frameLoader auto``: its
    weights a checkpoint of the flagship with a random head and the trunk
    from a trunk file that ``utils/convert_slowfast``'s CLI wrote from a
    pytorchvideo-named state dict (a random trunk with calibrated
    statistics); the loader JAX's ``make_frame_loader`` rule takes on this
    host (every clip through the native decoder where it builds, else PIL
    with JAX's notice: a host without libpng's and libjpeg's headers
    builds neither package's decoder), each eval forward's launches,
    oracle 1.0, a predict file of 16 answers.  Readings: that loader's
    clips/s on this host (the decoder's threads at ``--numWorkers``'s
    default) beside the model's forward clips/s at B=8."""
    t0 = time.perf_counter()
    data_dir, frame_dir = (os.path.join(tmp, "sf_data"),
                           os.path.join(tmp, "sf_frames"))
    out = os.path.join(tmp, "sf_test")
    ckpt = os.path.join(tmp, "sf_model.pt")
    synthetic.write_agqa_files(data_dir, frame_dir, "test",
                               n=TRUNK_DRIVER_QUESTIONS, frames_per_video=16)
    argv = TRUNK_DRIVER_FLAGS + ["--dataDir", data_dir, "--frameDir",
                                 frame_dir, "--output", out, "--test",
                                 "test", "--load", ckpt]
    cfg, extras = common.parse_reference_flags_with_extras(argv, "agqa")
    data = common.build_data(cfg, extras, "test")
    cfg = common.resolve_num_answers(cfg, data)

    # the trunk file, through the port's converter CLI
    trunk = init_weights(make_backbone("slowfast_r50", torch.bfloat16).to(
        "cuda"), WEIGHTS_SEED).eval()
    calibrate_frozen_bn(trunk, torch.randn(
        2, 16, 256, 256, 3, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(WEIGHTS_SEED)))
    hub, trunk_file = os.path.join(tmp, "sf.pth"), os.path.join(
        tmp, "slowfast_r50_flax.msgpack")
    torch.save(slowfast_hub_state_dict(trunk), hub)
    with contextlib.redirect_stdout(io.StringIO()):
        convert_slowfast.main([hub, trunk_file])
    model = entry.build_model(cfg, "cuda", seed=WEIGHTS_SEED)
    logged = []
    Trainer.load_backbone(SimpleNamespace(
        model=model, metrics=SimpleNamespace(log=logged.append),
        _reset_opt=lambda: None), trunk_file)
    for key, value in trunk.state_dict().items():
        if not torch.equal(model.backbone.state_dict()[key], value):
            raise AssertionError(f"trunk file: {key} differs after the "
                                 "convert and load")
    torch.save({"params": model.state_dict(), "step": 0}, ckpt)
    del model, trunk
    gc.collect()
    torch.cuda.empty_cache()
    prep_s = time.perf_counter() - t0

    clips = []
    decode = native_loader.decode_clip

    def counted_decode(paths, h, w):
        clips.append((len(paths), h, w))
        return decode(paths, h, w)

    native_loader.decode_clip = counted_decode
    try:
        with _Counted() as counted:
            result, stdout, seconds = run_main(argv)
    finally:
        native_loader.decode_clip = decode
    # the loader JAX's rule takes on this host: the native decoder when it
    # builds here, else PIL with JAX's notice
    native = native_loader.get_lib() is not None
    notice = "native frame decoder unavailable; using PIL" in stdout
    want_clips = ([(16, 256, 256)] * TRUNK_DRIVER_QUESTIONS if native
                  else [])
    if notice == native or clips != want_clips:
        raise AssertionError(f"the driver's loader: native decoder built "
                             f"{native}, PIL notice {notice}, native decoder "
                             f"calls {clips}")
    if "Oracle score: 1.0000" not in stdout:
        raise AssertionError("the real-frame test run's oracle is not 1.0")
    bsz = cfg.optim.eval_batch_size
    if (len(counted.eval) != TRUNK_DRIVER_QUESTIONS // bsz
            or any(c != TRUNK_EVAL_LAUNCHES for c in counted.eval)):
        raise AssertionError(f"real-frame test forwards launched "
                             f"{counted.eval}, expected "
                             f"{TRUNK_DRIVER_QUESTIONS // bsz} x "
                             f"{TRUNK_EVAL_LAUNCHES}")
    with open(os.path.join(out, "predict.json")) as f:
        if len(json.load(f)) != TRUNK_DRIVER_QUESTIONS:
            raise AssertionError("predict.json does not hold 16 answers")

    with contextlib.redirect_stdout(io.StringIO()):
        loader = common.make_frame_loader(cfg, data.frame_ids, extras)
    vids = [d["video_id"] for d in data.datums]
    t1 = time.perf_counter()
    for vid in vids:
        loader(vid)
    decode_cps = len(vids) / (time.perf_counter() - t1)
    batch = entry.device_batch(cfg, bsz, seed=3)
    forward_cps = clips_per_second(counted.model, [batch], iters=3, warmup=1)
    readings = {"loader": "native" if native else "PIL",
                "loader_clips_per_s": decode_cps,
                "decoder_threads": cfg.data.num_workers,
                f"forward_clips_per_s_b{bsz}": forward_cps,
                "prep_s": prep_s, "driver_s": seconds}
    log(f"slowfast --test on PNG frames: the {readings['loader']} loader "
        f"(native decoder built here: {native}) for "
        f"{TRUNK_DRIVER_QUESTIONS} clips, launches per eval forward "
        f"({COUNT_NAMES}) {counted.eval[0]}, oracle 1.0; readings "
        f"{json.dumps(readings)}")
    del counted, batch
    gc.collect()
    torch.cuda.empty_cache()
    return readings


def phase_trunks(tmp: str):
    """Phase trunks: (a) each trunk of TRUNK_CLIPS at full width (bf16,
    frozen, B=2: shape and finite values; readings at B=8) and the TOY
    topologies card against CPU in f32; (b) the tokenizer conv and the
    bottleneck kernels at slowfast's shapes against their plain versions
    (B=8 and 2; device time and bound) and the block switch on a slowfast
    trunk (``slowfast_block_switch``); (c) the real-frame ``--test`` run
    (``trunk_driver``); (d) the --patches head at flagship widths through
    phase 9c's ``check_head_variant``.  Returns the readings."""
    t0 = time.perf_counter()
    readings = {"trunks": {}}
    for i, (name, frames, side) in enumerate(TRUNK_CLIPS):
        readings["trunks"][name] = trunk_full_width(name, frames, side, i)
    toy_err = max(trunk_toy_card_vs_cpu(name, cls, toy, frames)
                  for name, cls, toy, frames in TRUNK_TOYS)
    t1 = time.perf_counter()
    tok_rows, block_rows = {}, {}
    for bsz in (TRUNK_READING_BATCH, 2):
        for site, t_len, ci in SLOWFAST_TOK_SITES:
            tok_rows[(site, bsz)] = tok_row(site, bsz, t_len, SLOWFAST_HW,
                                            ci)
        for site, hw, ci, cm, co, proj, _ in SLOWFAST_BLOCK_SITES:
            block_rows[(site, bsz)] = block_row(site, bsz, 4 * bsz, hw, ci,
                                                cm, co, proj)
    err = max(r["max_abs_err"] for r in (*tok_rows.values(),
                                         *block_rows.values()))
    launched, switch_err = slowfast_block_switch()
    for what, rows, sites, n in (
            ("fused_tok_conv", tok_rows, SLOWFAST_TOK_SITES, None),
            ("fused_bottleneck", block_rows, SLOWFAST_BLOCK_SITES, -1)):
        log(f"{what} per slowfast forward ({card_name_and_power_limit()}): "
            + ", ".join(
                f"{k} " + weighted_text(
                    [(1 if n is None else s[n], rows[(s[0], b)])
                     for s in sites], k) + f" at b{b}"
                for k in ("kernel_ms", "kernel_device_ms", "plain_ms",
                          "yardstick_ms", "bound_ms")
                for b in (TRUNK_READING_BATCH, 2)))
    kernels_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    readings["driver"] = trunk_driver(tmp)
    driver_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    base = entry.flagship_cfg()
    name, enc, *want = PATCHES_VARIANT
    pcfg = base.replace(encoder=dataclasses.replace(base.encoder, **enc))
    check_head_variant(name, pcfg, variant_batch(pcfg, TASK_BATCH, 29),
                       *want)
    readings["seconds"] = {"trunks": t1 - t0 - kernels_s - driver_s,
                           "kernels": kernels_s, "driver": driver_s,
                           "patches": time.perf_counter() - t1}
    log(f"phase trunks (no limit on the readings; "
        f"{card_name_and_power_limit()}): {json.dumps(readings)}; TOY card "
        f"vs CPU max {toy_err:.3e}; kernels at slowfast's shapes max |err| "
        f"{err}, block switch {launched} launches, features {switch_err}")
    return readings


# -- phase pretrain -----------------------------------------------------------

# the pretraining driver at the flagship's widths: bf16, the LXRT's 5/2/5
# layers, all five tasks, B=32 on 64 synthetic items, 2 epochs (2 steps each)
PRETRAIN_FLAGS = ["--noCaps", "--crossAttnType", "cross", "--llayers", "5",
                  "--xlayers", "2", "--rlayers", "5", "--computeDtype",
                  "bfloat16", "--taskMaskLM", "--taskMatched", "--taskQA",
                  "--taskContrastive", "--taskObjPredict", "--syntheticData",
                  "64", "--batchSize", str(BATCH_SIZE), "--epochs", "2",
                  "--lr", "1e-4"]
PRETRAIN_STEPS = 4
PRETRAIN_KEYS = {"lm_loss", "matched_loss", "qa_loss", "contrastive_loss",
                 "visn_loss", "total_loss"}
# a pretraining step: the LXRT's 14 attention sites (5 l, 5 r, 2 x 2
# cross) and 14 FFN blocks (5 l, 5 r, 2 x 2 cross), every one reached by
# the losses (lm: lang, visn_head: visn, matched / QA: the pooled pair)
PRETRAIN_LAUNCHES = {
    "plain": (14, 14, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    "ffn_train": (14, 14, 0, 14, 14, 0, 0, 0, 0, 0, 0)}
# the driver runs of phases pretrain (b) and remat: B=8, one epoch of 32
# synthetic clips (an eager 2-step chunk, then one capture and one replay)
REMAT_BATCH = 8
REMAT_DRIVER_FLAGS = ["--remat", "--stepsPerLoop", "2", "--syntheticData",
                      "32", "--syntheticValid", "8", "--batchSize",
                      str(REMAT_BATCH), "--logFreq", "1", "--epochs", "1"]


def trunk_file(tmp: str) -> str:
    """A calibrated slow_r50 trunk as a ``--backboneWeights`` file (the
    msgpack ``utils/convert_slow_r50`` writes), for the phases run alone:
    the flagship trunk at seed ``WEIGHTS_SEED``, its BatchNorm statistics
    calibrated on a synthetic batch, as ``write_weight_files`` makes it."""
    cfg = entry.flagship_cfg()
    trunk = entry.build_model(cfg, "cuda", WEIGHTS_SEED)
    frames = entry.device_batch(cfg, 8, WEIGHTS_SEED)["frames"]
    calibrate_frozen_bn(trunk.backbone, trunk.normalize_frames(frames))
    v = to_jax_variables(trunk.backbone.state_dict())
    path = os.path.join(tmp, "slow_r50_flax.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_serialize(v))
    del trunk
    gc.collect()
    torch.cuda.empty_cache()
    return path


def pretrain_driver_run(tmp: str, name: str, extra):
    """One run of ``python -m shgvqa_tpu_torch.cli.pretrain`` at
    ``PRETRAIN_FLAGS`` + ``extra``: every step's launches (counts set to 0
    just before it and read just after), ms (events) and metrics, the last
    step's device busy ms and share (torch.profiler), each batch's host
    seconds, the peak memory; the checks on them and on the snapshots.
    Returns (readings, the last snapshot's path)."""
    out = os.path.join(tmp, f"pretrain_{name}")
    argv = PRETRAIN_FLAGS + ["--output", out, "--dataDir",
                             os.path.join(tmp, "pretrain_data"), *extra]
    make_step, make_batch = (pretrain_cli.make_pretrain_step,
                             pretrain_cli.make_batch)
    models, steps, host, device = [], [], [], []

    def timed_batch(*args):
        t0 = time.perf_counter()
        batch = make_batch(*args)
        host.append(time.perf_counter() - t0)
        return batch

    def counted_step(model, optimizer, pt):
        models.append(model)
        inner = make_step(model, optimizer, pt)

        def step(batch, generator):
            torch.cuda.synchronize()
            reset_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            out = {}

            def run():
                start.record()
                out["metrics"] = inner(batch, generator)
                end.record()

            if len(steps) == PRETRAIN_STEPS - 1:
                # the last step's device busy time (one trace, no retry:
                # a second try would train a fifth step)
                device.append(busy_share(run, tries=1))
            else:
                run()
            torch.cuda.synchronize()
            steps.append((counts(), start.elapsed_time(end),
                          {k: v.item() for k, v in out["metrics"].items()}))
            return out["metrics"]

        return step

    pretrain_cli.make_pretrain_step = counted_step
    pretrain_cli.make_batch = timed_batch
    torch.cuda.reset_peak_memory_stats()
    try:
        last, _, seconds = run_main(argv, main=pretrain_cli.main)
    finally:
        pretrain_cli.make_pretrain_step = make_step
        pretrain_cli.make_batch = make_batch
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = PRETRAIN_LAUNCHES[name]
    if len(steps) != PRETRAIN_STEPS or any(c != want for c, _, _ in steps):
        raise AssertionError(f"pretraining ({name}): step launches "
                             f"{[c for c, _, _ in steps]}, expected "
                             f"{PRETRAIN_STEPS} x {want}")
    if set(last) != PRETRAIN_KEYS or not all(
            math.isfinite(v) for _, _, m in steps for v in m.values()):
        raise AssertionError(f"pretraining ({name}): metrics "
                             f"{[m for _, _, m in steps]}")
    model = models[0]
    snap = os.path.join(out, "Epoch01_LXRT")
    saved = torch.load(snap, map_location="cuda", weights_only=True)["lxrt"]
    own = model.lxrt.state_dict()
    if saved.keys() != own.keys() or not all(
            torch.equal(saved[k], own[k]) for k in own):
        raise AssertionError(f"pretraining ({name}): Epoch01_LXRT is not "
                             "the model's LXRT")
    fc2 = model.heads.qa_head.fc2
    with np.load(os.path.join(out, "Epoch01_qa_head.npz")) as qa:
        if not (np.array_equal(qa["weight"], fc2.weight.detach().cpu()
                               .numpy())
                and np.array_equal(qa["bias"],
                                   fc2.bias.detach().cpu().numpy())):
            raise AssertionError(f"pretraining ({name}): the QA head file "
                                 "is not the model's fc2")
    busy = device[0] if device else None
    readings = {"step_ms": [round(ms, 3) for _, ms, _ in steps],
                "last_step_device_ms": busy and busy[0],
                "last_step_busy_share": busy and busy[2],
                "peak_gib": peak, "batch_host_s": [round(s, 3) for s in host],
                "seconds": seconds, "last": last}
    log(f"pretraining driver ({name}, b{BATCH_SIZE}, flagship widths): "
        f"launches a step ({COUNT_NAMES}) {want}; snapshots bit-equal; "
        f"{json.dumps(readings)}")
    del models[:], model, own, saved
    gc.collect()
    torch.cuda.empty_cache()
    return readings, snap


class _QaRecorded(_Recorded):
    """The driver's Trainer, kept, with what ``load_lxmert_qa`` loaded."""

    loads: list = []

    def load_lxmert_qa(self, path, label2ans):
        out = super().load_lxmert_qa(path, label2ans)
        head = self._head()
        _QaRecorded.loads.append((out, dict(label2ans), {
            k: v.clone() for k, v in head.lxrt.state_dict().items()},
            head.logit_fc.fc2.weight.detach().cpu().clone().numpy(),
            head.logit_fc.fc2.bias.detach().cpu().clone().numpy()))
        return out


def lxmert_qa_driver(tmp: str, snap: str, trunk: str):
    """(b) the ``agqa_hgqa`` driver at the published flags with
    ``--loadLXMERTQA snap``, B=8, one epoch of 32 synthetic clips, also
    phase remat's driver run (``--remat --stepsPerLoop 2``): the encoder
    after the load bit-equal to the snapshot, ``logit_fc.fc2``'s rows and
    the loaded / zeroed counts ``answer_head_surgery``'s of the snapshot's
    QA head file, finite losses; ``check_remat_driver``'s checks."""
    out, data = os.path.join(tmp, "lxmertqa"), os.path.join(tmp, "lxmertqa_d")
    os.makedirs(data, exist_ok=True)
    argv = DRIVER_FLAGS + REMAT_DRIVER_FLAGS + [
        "--output", out, "--dataDir", data, "--backboneWeights", trunk,
        "--loadLXMERTQA", snap]
    saved, _QaRecorded.loads, _Recorded.made = common.Trainer, [], []
    common.Trainer = _QaRecorded
    try:
        result, _, seconds = run_main(argv)
    finally:
        common.Trainer = saved
    losses = check_remat_driver(out, result)
    (counts_, label2ans, encoder, w, b), = _QaRecorded.loads
    _QaRecorded.loads = []
    snapshot = torch.load(snap, map_location="cuda", weights_only=True)
    if snapshot["lxrt"].keys() != encoder.keys() or not all(
            torch.equal(encoder[k], v) for k, v in snapshot["lxrt"].items()):
        raise AssertionError("--loadLXMERTQA: the encoder after the load is "
                             "not the snapshot")
    with np.load(snap[:-len("_LXRT")] + "_qa_head.npz") as qa:
        want_w, want_b, loaded, zeroed = answer_head_surgery(
            qa["weight"], qa["bias"], w, b, label2ans,
            AnswerTable([str(a) for a in qa["answers"]]))
    if not (np.array_equal(w, want_w) and np.array_equal(b, want_b)
            and counts_ == (loaded, zeroed) == result["load_lxmert_qa"]):
        raise AssertionError(
            f"--loadLXMERTQA: the head's rows (equal: "
            f"{np.array_equal(w, want_w)}, {np.array_equal(b, want_b)}) or "
            f"counts {counts_} (driver {result['load_lxmert_qa']}) differ "
            f"from the surgery's {(loaded, zeroed)}")
    log(f"agqa_hgqa --loadLXMERTQA --remat --stepsPerLoop 2 "
        f"(b{REMAT_BATCH}): encoder bit-equal to the snapshot "
        f"({len(encoder)} tensors), {loaded} answers loaded and {zeroed} "
        f"zeroed as answer_head_surgery, 1 capture, 1 replay, losses "
        f"{losses}; {seconds:.1f} s")
    return {"loaded": loaded, "zeroed": zeroed, "losses": losses,
            "seconds": seconds}


def pretrain_card_vs_cpu():
    """(c) a tiny pretraining model (64-wide heads, f32 weights), every
    dropout rate 0: the card in bf16 with the attention and FFN-train
    kernels against the CPU's f32 plain path on the same weights and
    batch; the loss and the whole gradient within ``TRAIN_TOL``."""
    base = tiny_test_config(use_pallas_ffn_train=True)
    base = base.replace(encoder=dataclasses.replace(
        base.encoder, hidden_size=128, num_heads=2, intermediate_size=256,
        hidden_dropout=0.0, attention_dropout=0.0))
    cpu = init_weights(LxmertPretrainModel(base, 5), 4).train()
    gpu = LxmertPretrainModel(base.replace(compute_dtype="bfloat16"),
                              5).cuda().train()
    gpu.load_state_dict(cpu.state_dict())
    e = base.encoder
    rng = np.random.RandomState(4)
    n, lt = 8, base.data.max_seq_length
    feats = rng.randn(n, e.visual_t + 8, e.visual_hw, e.visual_hw,
                      e.visual_feat_dim).astype(np.float32)
    items = pretrain_cli.PretrainItems(
        enc={"input_ids": rng.randint(5, e.vocab_size, (n, lt)).astype(
                 np.int32),
             "input_mask": np.ones((n, lt), np.int32),
             "segment_ids": np.zeros((n, lt), np.int32)},
        answers=rng.randint(5, size=n).astype(np.int32),
        feats=lambda i: feats[i], mask_id=3, vocab_size=e.vocab_size,
        visual_t=e.visual_t)
    pt = pretrain_cli.default_tasks({t: True for t in pretrain_cli.TASKS}
                                    | {"visual_losses": "feat",
                                       "word_mask_rate": 0.15,
                                       "obj_mask_rate": 0.15})
    batch = pretrain_cli.make_batch(np.arange(4), rng, items, pt)
    runs = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        reset_counts()
        out = model({k: tb[k] for k in pretrain_cli.MODEL_INPUTS},
                    torch.Generator(device=dev).manual_seed(0))
        loss, _ = pretrain_cli.pretrain_losses(pt, out, tb)
        loss.backward()
        grads = torch.cat([p.grad.detach().float().cpu().flatten()
                           for p in model.parameters()])
        runs[dev] = (loss.item(), grads, counts())
    (lc, gc_, _), (lg, gg, launched) = runs["cpu"], runs["cuda"]
    rel_loss = abs(lg - lc) / abs(lc)
    rel_grad = ((gg - gc_).norm() / gc_.norm()).item()
    log(f"pretraining card (bf16, kernels) vs CPU (f32, plain), tiny: loss "
        f"{lg:.6f} vs {lc:.6f} (rel {rel_loss:.2e}), gradient rel "
        f"Frobenius {rel_grad:.2e}; card launches ({COUNT_NAMES}) "
        f"{launched}")
    sites = e.l_layers + e.r_layers + 2 * e.x_layers
    if launched[:5] != (sites, sites, 0, sites, sites):
        raise AssertionError(f"tiny pretraining on the card launched "
                             f"{launched}, expected {sites} attention and "
                             f"FFN-train forwards and backwards")
    if rel_loss > TRAIN_TOL or rel_grad > TRAIN_TOL:
        raise AssertionError(f"pretraining card vs CPU: loss rel "
                             f"{rel_loss}, gradient rel {rel_grad}")
    return {"loss_rel": rel_loss, "grad_rel": rel_grad}


def phase_pretrain(tmp: str, trunk: str):
    """Phase pretrain (``--only pretrain``): (a) the pretraining driver at
    the flagship's widths, plain and with ``--pallasFFNTrain``; (b) its
    snapshot into the ``agqa_hgqa`` driver through ``--loadLXMERTQA``,
    with ``--remat --stepsPerLoop 2`` (phase remat's driver run); (c) a
    tiny model card against CPU.  Returns the readings."""
    t0 = time.perf_counter()
    readings = {}
    for name, extra in (("plain", []), ("ffn_train", ["--pallasFFNTrain"])):
        readings[name], snap = pretrain_driver_run(tmp, name, extra)
    readings["lxmert_qa"] = lxmert_qa_driver(tmp, snap, trunk)
    readings["card_vs_cpu"] = pretrain_card_vs_cpu()
    readings["seconds"] = time.perf_counter() - t0
    log(f"phase pretrain ({card_name_and_power_limit()}): "
        f"{json.dumps(readings)}")
    return readings


# -- phase remat ----------------------------------------------------------------

# a frozen-trunk flagship step with --pallasFFNTrain: 38 / 34 attention and
# 18 / 14 FFN-train launches; remat runs the l- and r-layers (10 attention
# sites, 10 FFN blocks) and the decoders' layers (2 x 5 x 2 attention
# sites) again, the attention forward only where the policy does not save
# its (o, lse), the FFN-train forward under every policy
REMAT_PLAIN = (38, 34, 0, 18, 14, 0, 0, 0, 0, 0, 0)
REMAT_AGAIN = {"": 30, "dots": 30, "dots_batch": 30, "dots_attn": 0}
REMAT_FFN_AGAIN = 10
REMAT_SPREAD, REMAT_FLOOR = 2.0, 1e-6


def remat_launches(policy):
    want = list(REMAT_PLAIN)
    if policy is not None:
        want[0] += REMAT_AGAIN[policy]
        want[3] += REMAT_FFN_AGAIN
    return tuple(want)


def remat_gradients(model, optimizer, generator, batch, start, policy):
    """One forward and backward of the train step's loss under ``policy``
    from the generator state ``start``: (loss, gradient vector, the
    generator's state after, launches, the peak GiB above what was
    allocated before)."""
    set_remat(model, policy)
    generator.set_state(start)
    optimizer.zero_grad()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss, _ = compute_losses(model.cfg, model(batch, generator), batch)
    loss.backward()
    torch.cuda.synchronize()
    launched = counts()
    grads = torch.cat([p.grad.detach().float().flatten()
                       if p.grad is not None else p.new_zeros(p.numel())
                       for p in optimizer.params])
    return (loss.item(), grads, generator.get_state(), launched,
            (torch.cuda.max_memory_allocated() - resident) / 2 ** 30)


def remat_distance(a, b):
    return (abs(a[0] - b[0]) / abs(b[0]),
            ((a[1] - b[1]).norm() / b[1].norm()).item())


def remat_published_readings():
    """The published recipe's B=32 step (the trunk trained) without remat,
    with ``--remat`` '' and ``dots``: the peak memory of one step and the
    step's ms (events, the step after it)."""
    model, optimizer, generator, batch = entry.train_entry(published=True)
    step = make_train_step(model.cfg, model, optimizer)
    readings = {}
    for policy in (None, "", "dots"):
        set_remat(model, policy)
        memory = train_memory_gib(step, batch, generator)
        ms = time_ms(lambda: step(batch, generator), iters=1, warmup=0)
        readings["none" if policy is None else repr(policy)] = {
            "peak_gib": memory["peak_gib"], "step_ms": ms}
    set_remat(model, None)
    del model, optimizer, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return readings


def check_remat_driver(out: str, result: dict):
    """The driver run of ``REMAT_DRIVER_FLAGS`` into ``out`` (its Trainer
    the last of ``_Recorded.made``): 4 steps, finite losses, one capture
    and one replay.  Returns the losses."""
    chunks = _Recorded.made[-1].chunks
    _Recorded.made = []
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    if (result["steps"], len(losses)) != (4, 4) or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"driver --remat --stepsPerLoop 2: "
                             f"{result['steps']} steps, losses {losses}")
    if chunks is None or (chunks.captures, chunks.replays) != (1, 1):
        raise AssertionError("driver --remat --stepsPerLoop 2: not one "
                             "capture and one replay")
    return losses


def remat_driver(tmp: str, trunk: str):
    """The ``agqa_hgqa`` driver at the published flags +
    ``REMAT_DRIVER_FLAGS`` (phase remat alone; a whole run checks this in
    phase pretrain's (b), which adds ``--loadLXMERTQA``)."""
    out, data = os.path.join(tmp, "remat"), os.path.join(tmp, "remat_d")
    os.makedirs(data, exist_ok=True)
    argv = DRIVER_FLAGS + REMAT_DRIVER_FLAGS + [
        "--output", out, "--dataDir", data, "--backboneWeights", trunk]
    saved, _Recorded.made = common.Trainer, []
    common.Trainer = _Recorded
    try:
        result, _, seconds = run_main(argv)
    finally:
        common.Trainer = saved
    losses = check_remat_driver(out, result)
    log(f"driver --remat --stepsPerLoop 2 (b{REMAT_BATCH}): 1 capture, 1 "
        f"replay, losses {losses}; {seconds:.1f} s")
    return {"losses": losses, "seconds": seconds}


def phase_remat(tmp: str, trunk: str, driver: bool = True):
    """Phase remat (``--only remat``): (a) a frozen-trunk flagship step at
    B=8 with the sites' dropout rates and the FFN-train kernels, two runs
    without remat and one under each policy from one generator state: the
    launches (``remat_launches``), the generator's state after each run
    equal, the loss and gradient's median distance to the plain runs at
    most ``REMAT_SPREAD`` x the plain runs' own (floor ``REMAT_FLOOR``: the
    attention backward sums dQ with atomics); (b) the driver with
    ``--remat --stepsPerLoop 2`` (unless ``driver`` is off: a whole run
    checks it in phase pretrain's (b)); (c) the published step's peak
    memory and ms without remat, with '' and ``dots`` (readings).  Returns
    the readings."""
    t0 = time.perf_counter()
    model, optimizer, generator, batch = entry.train_entry(
        batch_size=REMAT_BATCH)
    set_ffn_train_kernel(model, True)
    start = generator.get_state()
    plain = [remat_gradients(model, optimizer, generator, batch, start,
                             None) for _ in range(2)]
    runs = {p: remat_gradients(model, optimizer, generator, batch, start, p)
            for p in REMAT_POLICIES}
    set_remat(model, None)
    optimizer.zero_grad()
    spread = remat_distance(plain[0], plain[1])
    readings = {"step_peak_gib_b8": {"none": plain[0][4]}}
    for policy, run in [(None, r) for r in plain] + list(runs.items()):
        if run[3] != remat_launches(policy):
            raise AssertionError(f"remat {policy!r}: launches {run[3]}, "
                                 f"expected {remat_launches(policy)}")
        if not torch.equal(run[2], plain[0][2]):
            raise AssertionError(f"remat {policy!r}: the generator's state "
                                 "differs from a step without remat")
        if not (math.isfinite(run[0]) and torch.isfinite(run[1]).all()):
            raise AssertionError(f"remat {policy!r}: a non-finite loss or "
                                 "gradient")
    gaps = {}
    for policy, run in runs.items():
        dist = [remat_distance(run, p) for p in plain]
        gaps[policy] = dist
        readings["step_peak_gib_b8"][repr(policy)] = run[4]
        for i, what in enumerate(("loss", "gradient")):
            near = statistics.median(d[i] for d in dist)
            if near > max(REMAT_SPREAD * spread[i], REMAT_FLOOR):
                raise AssertionError(f"remat {policy!r}: the {what} differs "
                                     f"by {near} (median) from no remat, "
                                     f"whose runs differ by {spread[i]}")
    log(f"remat b{REMAT_BATCH} frozen trunk, FFN-train kernels: launches "
        f"({COUNT_NAMES}) " + ", ".join(
            f"{p!r} {remat_launches(p)}" for p in (None,) + REMAT_POLICIES)
        + f"; generator states equal; plain runs' distance (loss, "
        f"gradient) {spread}, each policy to the plain runs "
        f"{json.dumps({repr(k): v for k, v in gaps.items()})}")
    del model, optimizer, batch, plain, runs
    gc.collect()
    torch.cuda.empty_cache()
    if driver:
        readings["driver"] = remat_driver(tmp, trunk)
    readings["published_b32"] = remat_published_readings()
    readings["seconds"] = time.perf_counter() - t0
    log(f"phase remat ({card_name_and_power_limit()}): "
        f"{json.dumps(readings)}")
    return readings


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=("attention", "ffn", "ffn_train",
                                           "tok_block", "out_ln_headsliced",
                                           "weights", "steps_per_loop",
                                           "matcher", "star", "tasks",
                                           "per_choice", "quant", "ddp",
                                           "caps", "trunks", "pretrain",
                                           "remat", "tp"),
                        help="build and run only this kernel phase (no "
                             "result lines)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power_limit()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    libs, build_logs = _build.build()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    lap("1, 2 build")
    for name, text in build_logs.items():
        for line in ptxas_lines(name, text):
            log(f"  {line}")
    # the wgmma kernels hold their accumulators in registers: no spill
    spills = [line for name in ("bottleneck", "ffn_train", "out_ln",
                                "tok_conv")
              for line in ptxas_lines(name, build_logs.get(name, ""))
              if re.search(r"[1-9]\d* bytes spill", line)]
    if spills:
        raise AssertionError("register spills: " + "; ".join(spills))

    if args.only == "attention":
        attn_rows, attn_err = phase_attention_kernels()
        attention_entries(attn_rows, attn_err)
        log(f"attention kernels ok; max errors {json.dumps(attn_err)}")
        return 0
    if args.only == "ffn":
        rows, max_err = phase_ffn_kernel()
        log_ffn_per_forward(rows)
        log(f"FFN kernel ok; max error {max_err}")
        return 0
    if args.only == "ffn_train":
        train_rows, train_err = phase_ffn_train_kernels()
        log_stages(train_rows)
        log(f"FFN train kernels ok; max errors {json.dumps(train_err)}")
        return 0
    if args.only == "tok_block":
        tok_rows, tok_err = phase_tok_kernel()
        log_tok_per_forward(tok_rows)
        block_rows, block_err = phase_block_kernel()
        log_block_per_forward(block_rows)
        log(f"tokenizer conv and bottleneck kernels ok; max errors {tok_err}, "
            f"{block_err}")
        return 0
    if args.only == "weights":
        with tempfile.TemporaryDirectory() as tmp:
            files = write_weight_files(tmp)
            phase_driver(tmp, files)
            phase_weights_import(tmp, files)
        log("weight files, driver and imports ok")
        return 0
    if args.only == "steps_per_loop":
        spl_cps = phase_steps_per_loop("frozen", entry.train_entry())
        gc.collect()
        torch.cuda.empty_cache()
        spl_cps.update(phase_steps_per_loop(
            "published", entry.train_entry(published=True)))
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            phase_driver_steps_per_loop(tmp, write_weight_files(tmp))
        log(f"steps per loop ok; {json.dumps(spl_cps)}")
        return 0
    if args.only == "matcher":
        _, err = phase_matcher_kernel()
        log(f"matcher kernel ok; max |row_to_col - plain| {err}")
        return 0
    if args.only == "star":
        with tempfile.TemporaryDirectory() as tmp:
            phase_star_driver(tmp, write_weight_files(tmp))
        log("STAR driver ok")
        return 0
    if args.only == "tasks":
        phase_ablation_attention()
        with tempfile.TemporaryDirectory() as tmp:
            phase_tasks(tmp, write_weight_files(tmp))
        for name in CARD_VS_CPU:
            phase_plain_path_card_vs_cpu(name)
            phase_plain_train_step_card_vs_cpu(name)
        log("AGQA ablations ok")
        return 0
    if args.only == "per_choice":
        with tempfile.TemporaryDirectory() as tmp:
            phase_per_choice(tmp, write_weight_files(tmp))
        phase_per_choice_card_vs_cpu()
        log("per-choice STAR ok")
        return 0
    if args.only == "quant":
        phase_quant()
        log("int8 trunk ok")
        return 0
    if args.only == "caps":
        with tempfile.TemporaryDirectory() as tmp:
            phase_caps(tmp, write_weight_files(tmp))
        phase_ablation_attention(CAPS_ATTN_SITES, "capsule")
        log("capsule encoder ok")
        return 0
    if args.only == "trunks":
        with tempfile.TemporaryDirectory() as tmp:
            phase_trunks(tmp)
        log("trunks ok")
        return 0
    if args.only in ("pretrain", "remat"):
        phase = phase_pretrain if args.only == "pretrain" else phase_remat
        with tempfile.TemporaryDirectory() as tmp:
            phase(tmp, trunk_file(tmp))
        log(f"phase {args.only} ok")
        return 0
    if args.only == "ddp":
        with tempfile.TemporaryDirectory() as tmp:
            phase_driver_steps_per_loop(tmp, write_weight_files(tmp))
        log(f"data parallelism ok; readings {json.dumps(phase_ddp())} "
            f"({card})")
        return 0
    if args.only == "tp":
        readings = phase_tp(start_tp_gloo())
        log(f"tensor parallelism ok; readings {json.dumps(readings)} "
            f"({card})")
        return 0
    if args.only == "out_ln_headsliced":
        out_ln_rows, out_ln_err = phase_out_ln_kernel()
        log_out_ln_per_forward(out_ln_rows)
        _, hs_err = phase_headsliced_kernel()
        phase_headsliced_ab()
        log(f"out_ln and head-sliced attention kernels ok; max errors "
            f"{out_ln_err}, {hs_err}")
        return 0

    rows, max_err = phase_ffn_kernel()
    lap("3 ffn")
    attn_rows, attn_err = phase_attention_kernels()
    lap("3 attention")
    phase_ablation_attention()
    lap("3 ablation attention")
    phase_ablation_attention(CAPS_ATTN_SITES, "capsule")
    lap("3 capsule attention")
    train_rows, train_err = phase_ffn_train_kernels()
    lap("3 ffn_train")
    tok_rows, tok_err = phase_tok_kernel()
    block_rows, block_err = phase_block_kernel()
    lap("3 tok, block")
    out_ln_rows, out_ln_err = phase_out_ln_kernel()
    hs_rows, hs_err = phase_headsliced_kernel()
    phase_headsliced_ab()
    lap("3 out_ln, headsliced")
    matcher_rows, matcher_err = phase_matcher_kernel()
    lap("3 matcher")
    model, main_launches = phase_main_path()
    launches = main_launches["FFN + tok + block kernels"]
    olhs_launches = main_launches["FFN + out_ln + headsliced"]
    cps = phase_throughput(model)
    lap("4, 5")
    del model
    train_model, optimizer, generator, batch, _ = phase_train_main_path()
    published = phase_train_published()
    train_launches = published[4]
    train_cps = phase_train_throughput(train_model, optimizer, generator,
                                       batch)
    published_cps, train_memory = phase_train_published_throughput(
        (train_model, optimizer, generator, batch), published[:4])
    train_cps.update(published_cps)
    lap("6, 7")
    spl_cps = phase_steps_per_loop(
        "frozen", (train_model, optimizer, generator, batch))
    del train_model, optimizer, batch, published
    gc.collect()
    torch.cuda.empty_cache()
    # a fresh published model, as --only steps_per_loop: phase 7's timed
    # steps on one batch at the schedule's peak can leave the random one NaN
    spl_cps.update(phase_steps_per_loop(
        "published", entry.train_entry(published=True)))
    lap("7b")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        files = write_weight_files(tmp)
        lap("9 weight files")
        driver_counts, epoch_s = phase_driver(tmp, files)
        imports = phase_weights_import(tmp, files)
        lap("8, 9")
        clear_outputs(tmp, files["trunk"])
        phase_driver_steps_per_loop(tmp, files)
        lap("7b driver, ddp (a) driver")
        clear_outputs(tmp, files["trunk"])
        star_launches = phase_star_driver(tmp, files)
        lap("9b")
        clear_outputs(tmp, files["trunk"])
        phase_tasks(tmp, files)
        lap("9c")
        clear_outputs(tmp, files["trunk"])
        per_choice_s = phase_per_choice(tmp, files)
        lap("9d")
        clear_outputs(tmp, files["trunk"])
        quant_rows, quant_launched, quant_cps = phase_quant(tmp, files)
        lap("quant")
        clear_outputs(tmp, files["trunk"])
        phase_caps(tmp, files)
        lap("caps")
        clear_outputs(tmp, files["trunk"])
        phase_trunks(tmp)
        lap("trunks")
        clear_outputs(tmp, files["trunk"])
        phase_pretrain(tmp, files["trunk"])
        lap("pretrain")
        clear_outputs(tmp, files["trunk"])
        phase_remat(tmp, files["trunk"], driver=False)
        lap("remat")
        weight_bytes = files["bytes"]
        del files
    tp = []

    def phase_10():
        # phase tp's ranks build and run (a) and (c) meanwhile
        tp.append(start_tp_gloo())
        for name in CARD_VS_CPU:
            phase_plain_path_card_vs_cpu(name)
            phase_plain_train_step_card_vs_cpu(name)
        phase_per_choice_card_vs_cpu()

    try:
        ddp_readings = phase_ddp(phase_10)
    except BaseException:
        for out, procs in tp:
            stop(procs)
            out.cleanup()
        raise
    lap("10, ddp")
    tp_readings = phase_tp(tp[0])
    lap("tp")

    bsz = BATCH_SIZE
    widest = max(FFN_SITES, key=lambda s: s[1] * rows[s[0] * bsz]["bound_ms"])
    kernels = [{
        "name": "fused_ffn", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/ffn_train.cu",
        "replaces": "shgvqa_tpu/kernels/ffn.py:98",
        "launches": launches[2], "max_abs_err": max_err,
        "ms": per_forward(rows, bsz, "kernel_ms"),
        "plain_ms": per_forward(rows, bsz, "plain_ms"),
        "bound_ms": per_forward(rows, bsz, "bound_ms"),
        "bound_by": rows[widest[0] * bsz]["bound_by"], "library_ms": None,
    }]
    log_ffn_per_forward(rows, launches[2], cps)
    kernels += attention_entries(attn_rows, attn_err, train_launches)
    for backward, (name, line) in enumerate(
            (("fused_ffn_train_fwd", 200), ("fused_ffn_train_bwd", 214))):
        pre = "bwd_" if backward else ""
        widest = max(FFN_TRAIN_SITES, key=lambda s: s[1 + backward]
                     * train_rows[s[0] * bsz][pre + "bound_ms"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "shgvqa_tpu_torch/csrc/ffn_train.cu",
            "replaces": f"shgvqa_tpu/kernels/ffn.py:{line}",
            "launches": driver_counts[-1][3 + backward],
            "max_abs_err": train_err["bwd" if backward else "fwd"],
            "ms": per_train_step(train_rows, bsz, pre + "kernel_ms",
                                 backward),
            "plain_ms": per_train_step(train_rows, bsz, pre + "plain_ms",
                                       backward),
            "bound_ms": per_train_step(train_rows, bsz, pre + "bound_ms",
                                       backward),
            "bound_by": train_rows[widest[0] * bsz][pre + "bound_by"],
            "library_ms": None,
        })
        keys = ("kernel_ms", "kernel_device_ms", "plain_ms", "yardstick_ms",
                "bound_ms") + (("wgrad_ms",) if backward else ())
        log(f"{name} per train step ({driver_counts[-1][3 + backward]} "
            f"sites; yardstick: the unfused F.linear/GeLU/dropout/layer_norm"
            + (" autograd backward" if backward else "") + "; "
            + ("wgrad: the weight-gradient products after the kernels; "
               if backward else "") + "device: torch.profiler per call; no "
            "single library call computes this block): " + ", ".join(
                f"{k} " + weighted_text(
                    [(nb if backward else nf, train_rows[per_clip * b])
                     for per_clip, nf, nb in FFN_TRAIN_SITES],
                    (pre if k != "wgrad_ms" else "") + k) + f" at b{b}"
                for k in keys for b in (bsz, 2)))
    log_stages(train_rows)
    kernels.append({
        "name": "fused_tok_conv", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/tok_conv.cu",
        "replaces": "tools/proto_tok_kernel.py:43",
        "launches": launches[5], "max_abs_err": tok_err,
        "ms": per_forward_tok(tok_rows, bsz, "kernel_ms"),
        "plain_ms": per_forward_tok(tok_rows, bsz, "plain_ms"),
        "bound_ms": per_forward_tok(tok_rows, bsz, "bound_ms"),
        "bound_by": tok_rows[("conv1", bsz)]["bound_by"], "library_ms": None,
    })
    kernels.append({
        "name": "fused_bottleneck", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/bottleneck.cu",
        "replaces": "tools/proto_block_kernel.py:41",
        "launches": launches[6], "max_abs_err": block_err,
        "ms": per_forward_block(block_rows, bsz, "kernel_ms"),
        "plain_ms": per_forward_block(block_rows, bsz, "plain_ms"),
        "bound_ms": per_forward_block(block_rows, bsz, "bound_ms"),
        "bound_by": block_rows[("res_2 blocks 1-2", bsz)]["bound_by"],
        "library_ms": None,
    })
    log_tok_per_forward(tok_rows, launches[5])
    log_block_per_forward(block_rows, launches[6])
    widest = max(FFN_SITES,
                 key=lambda s: s[1] * out_ln_rows[s[0] * bsz]["bound_ms"])
    kernels.append({
        "name": "fused_out_ln", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/out_ln.cu",
        "replaces": "shgvqa_tpu/kernels/ffn.py:479",
        "launches": olhs_launches[7], "max_abs_err": out_ln_err,
        "ms": per_forward(out_ln_rows, bsz, "kernel_ms"),
        "plain_ms": per_forward(out_ln_rows, bsz, "plain_ms"),
        "bound_ms": per_forward(out_ln_rows, bsz, "bound_ms"),
        "bound_by": out_ln_rows[widest[0] * bsz]["bound_by"],
        "library_ms": None,
    })
    log_out_ln_per_forward(out_ln_rows, olhs_launches[7])
    widest = max(ATTN_SITES,
                 key=lambda s: s[5] * hs_rows[(s[0], bsz)]["bound_ms"])
    kernels.append({
        "name": "headsliced_attention", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/attention.cu",
        "replaces": "tools/proto_headsliced_attn.py:41",
        "launches": olhs_launches[8], "max_abs_err": hs_err,
        "ms": per_forward_attn(hs_rows, bsz, "kernel_ms"),
        "plain_ms": per_forward_attn(hs_rows, bsz, "plain_ms"),
        "bound_ms": per_forward_attn(hs_rows, bsz, "bound_ms"),
        "bound_by": hs_rows[(widest[0], bsz)]["bound_by"],
        "library_ms": per_forward_attn(hs_rows, bsz, "library_ms"),
    })
    log(f"headsliced_attention per forward ({olhs_launches[8]} sites; "
        "library: SDPA with the same additive mask; transpose: the fused "
        "attention forward on (B, H, L, 64) views; device: torch.profiler per "
        "call): " + ", ".join(
            f"{k} " + weighted_text(
                [(nf, hs_rows[(site, b)])
                 for site, _, _, _, _, nf, _ in ATTN_SITES], k) + f" at b{b}"
            for k in ("kernel_ms", "kernel_device_ms", "plain_ms",
                      "transpose_ms", "library_ms", "bound_ms")
            for b in (bsz, 2)))
    star_bsz = STAR_BATCH
    kernels.append({
        "name": "hungarian_square", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/matcher.cu",
        "replaces": "shgvqa_tpu/ops/matcher.py:37",
        "launches": star_launches[9], "max_abs_err": matcher_err,
        "ms": per_step_matcher(matcher_rows, star_bsz, "kernel_ms"),
        "plain_ms": per_step_matcher(matcher_rows, star_bsz, "plain_ms"),
        "bound_ms": per_step_matcher(matcher_rows, star_bsz, "bound_ms"),
        "bound_by": "operations", "library_ms": None,
    })
    log(f"hungarian_square per STAR train step ({star_launches[9]} "
        "launches: relations 128 x 128, actions 48 x 48; yardstick: scipy's "
        "linear_sum_assignment on the host with the copy; no PyTorch call "
        "solves an assignment): " + ", ".join(
            f"{k} {per_step_matcher(matcher_rows, b, k)} at b{b}"
            for k in ("kernel_ms", "kernel_device_ms", "plain_ms",
                      "scipy_host_ms", "bound_ms")
            for b in MATCHER_BATCHES
            if all(matcher_rows[(n, b)][k] is not None
                   for n, *_ in MATCHER_SHAPES)))
    log("hungarian_square large path (cost in global memory) at b"
        f"{STAR_BATCH}: " + "; ".join(
            f"n={n} " + json.dumps({k: v for k, v in row.items()
                                    if k != "bound"})
            for (kind, n), row in matcher_rows.items() if kind == "large"))
    q32, q2 = quant_rows[bsz], quant_rows[2]
    kernels.append({
        "name": "qconv", "route": "cuda",
        "source": "shgvqa_tpu_torch/csrc/qconv.cu",
        "replaces": "shgvqa_tpu/models/backbone.py:167",
        "launches": quant_launched[10], "max_abs_err": q2["max_abs_err"],
        "ms": q32["kernel_ms"], "plain_ms": q32["plain_ms"],
        "bound_ms": q32["bound_ms"], "bound_by": q32["bound_by"],
        "library_ms": None,
    })
    log(f"qconv per trunk forward ({quant_launched[10]} launches; "
        "port-only, replaces no Pallas kernel; no one library call computes "
        "it: int_mm is torch._int_mm on the 1x1 stride-1 convs alone, the "
        "yardstick cuDNN bf16 F.conv3d of the 52 convs; device: "
        "torch.profiler; graph: one CUDA graph of the 52 launches): " + ", ".join(
            f"{k} {row[k]} at b{b}" for b, row in ((bsz, q32), (2, q2))
            for k in ("kernel_ms", "kernel_ms_range", "kernel_device_ms",
                      "kernel_graph_ms", "plain_ms", "int_mm_ms",
                      "cudnn_bf16_ms", "bound_ms"))
        + f"; inference clips/s int8 vs bf16 trunk {json.dumps(quant_cps)}")
    log(f"phase 9d seconds {json.dumps(per_choice_s)}")
    log(f"train clips/s b{bsz}: {json.dumps(train_cps)}; train step device "
        f"memory GiB {json.dumps(train_memory)}; driver epochs {epoch_s} s")
    log(f"steps per loop (k=1 vs a {SPL_K}-step graph) train clips/s: "
        f"{json.dumps(spl_cps)}")
    log(f"weight import: BEST.pth {weight_bytes['reference']} bytes, "
        f"{json.dumps(imports)} ({card})")
    log(f"data parallelism (phase ddp; no limit): {json.dumps(ddp_readings)} "
        f"({card})")
    log(f"tensor parallelism (phase tp; no limit): {json.dumps(tp_readings)} "
        f"({card})")
    log(f"phase seconds {json.dumps(PHASE_SECONDS)}, "
        f"{sum(PHASE_SECONDS.values()):.1f} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
