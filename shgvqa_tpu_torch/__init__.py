"""shgvqa_tpu_torch: the PyTorch + CUDA port of ``shgvqa_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module paths and class names, so each
module here has its counterpart under ``shgvqa_tpu/``.  It imports ``torch``
and numpy only; it never imports ``jax``, ``flax`` or ``shgvqa_tpu`` and keeps
its own copy of what it needs from them.

Ported so far: flagship HGQA inference from uint8 frames to the answer
(``models/shgvqa.py``), with the fused FFN block as a hand-written CUDA
chain of kernels (the FFN-train forward of ``csrc/ffn_train.cu`` at rate 0,
wrapper ``kernels/ffn.py``); and the flagship
train step (``train/step.py``: dropout-bearing forward, per-frame Hungarian
matching on the device in ``ops/matcher.py``, the losses in ``losses/``,
backward, global-norm clip and BertAdam in ``train/optimizer.py``), with
the fused attention forward and backward as hand-written CUDA kernels
(``csrc/attention.cu``, wrapper ``kernels/attention.py``); and the
``agqa_hgqa`` driver (``cli/``: the reference's flags, synthetic or file
AGQA data, the ``Trainer`` of ``train/loop.py`` with validation,
checkpoints and the test protocol), whose ``--pallasFFNTrain`` runs the
fused FFN train pair, forward and backward, as hand-written CUDA kernels
(``csrc/ffn_train.cu``, wrapper ``kernels/ffn.py``); the ``agqa_vqa``,
``agqa_q`` and ``star`` drivers, and the AGQA ablations (tasks 'q',
'vhga', 'hgvqa', the cross-layer variants of ``models/cross.py``); the
int8 frozen trunk (``--quantBackbone int8``) on the hand-written int8
convolution of ``csrc/qconv.cu`` (wrapper ``kernels/qconv.py``), and
``--backboneChunks``.
Options the port does not run yet raise ``NotImplementedError``
(``configs/config.check_ported``).
"""
