"""k train steps per launch (``--stepsPerLoop k``): the port of the JAX
package's scanned multi-step (``shgvqa_tpu/train/loop.py:245-250``,
``:333-400``; ``train/flat_state.make_flat_multi_step``), as a CUDA graph.

``StepChunks.run(batches)`` trains one chunk of k steps, each on its own
batch and with its own draws from the trainer's generator, as k calls of
the train step would:

- the k batches are copied into k static slots on the current stream and
  the k learning rates (``BertAdam.lr_at``, double then f32) into a static
  (k,) tensor, through pinned memory on a card;
- on a CUDA device the first chunk runs eagerly, on the stream the capture
  uses: its steps are real steps of the trajectory, and they are the
  warm-up that capture needs (kernel builds, cuBLAS and cuDNN handles and
  workspaces, autograd's device thread and its streams).  The second chunk
  is captured once into a ``torch.cuda.CUDAGraph`` of the k whole steps
  (forward from uint8 frames, augmentation included, matching, losses,
  backward, clip and BertAdam) and replayed; every later chunk is one
  replay.  The generator is registered with the graph, so each replay
  draws what the eager steps would have drawn from its state;
- on the CPU every chunk runs the same body eagerly: the graph's plain
  version;
- step i's metrics land in row i of static (k,) tensors.

Capture runs in ``"thread_local"`` mode: the input pipeline's prefetch
thread (``data/pipeline.prefetch``) goes on pinning and copying the next
batches on its own stream meanwhile, and under the default ``"global"``
mode those calls would break the capture.  The step body itself makes no
host sync and no copy from host memory (the set losses' class weights
are filled on the device, the normalization statistics and the learning
rates are device tensors made outside it; the augmentation runs its
full-batch select tree, which the trainer chooses for k > 1).

A capture or replay that fails raises, naming ``--stepsPerLoop``: nothing
falls back to eager steps on a card.  The graph keeps the addresses of the
parameters, the moments and the gradients; every weight load copies in
place (``Trainer.load``, ``_reset_opt`` and the imports), and a chunk that
finds a parameter or moment at another address captures again.  The
kernels' launch counters tick when a wrapper runs: k steps' launches
while capturing, none at a replay.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch import nn


def use_select_tree(model: nn.Module) -> None:
    """Switch ``model``'s training augmentation to its full-batch select
    tree (``data.aug_subbatch`` off): the sub-batch path's bits, with no
    host read and shapes that do not change, as a captured graph needs."""
    cfg = getattr(model, "cfg", None)
    if cfg is not None:
        model.cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, aug_subbatch=False))


class StepChunks:
    """Runs chunks of ``k`` steps of ``train_step(batch, generator, lr)``
    (``train.step.make_train_step`` over a ``BertAdam``), drawing from
    ``generator``; ``captures`` and ``replays`` count the graph's."""

    def __init__(self, train_step: Callable, optimizer,
                 generator: torch.Generator, k: int):
        self.train_step, self.optimizer = train_step, optimizer
        self.generator, self.k = generator, k
        self.device = optimizer.params[0].device
        self.lrs = torch.zeros(k, dtype=torch.float32, device=self.device)
        self.slots: Optional[List[Dict[str, torch.Tensor]]] = None
        self.metrics: Optional[Dict[str, torch.Tensor]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = self.replays = 0
        self._warm = False
        self._addresses: List[int] = []
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def run(self, batches: List[Dict[str, torch.Tensor]]
            ) -> Dict[str, torch.Tensor]:
        """Train one chunk on ``batches`` (k dicts of tensors on the
        device); returns the metrics, each (k,) with row i from step i,
        overwritten by the next chunk."""
        self._stage(batches)
        if self._stream is None:
            self._body()
        elif not self._warm:
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                self._body()
            current.wait_stream(self._stream)
            self._warm = True
        else:
            if self.graph is not None and self._addresses != self._state():
                self.graph = None
            if self.graph is None:
                self._capture()
            self._replay()
        return self.metrics

    def _state(self) -> List[int]:
        opt = self.optimizer
        return [t.data_ptr() for t in opt.params + opt.m + opt.v]

    def _stage(self, batches) -> None:
        if len(batches) != self.k:
            raise ValueError(f"--stepsPerLoop {self.k}: a chunk takes "
                             f"{self.k} batches, got {len(batches)}")
        if self.slots is None:
            self.slots = [{key: v.clone() for key, v in b.items()}
                          for b in batches]
        else:
            for slot, batch in zip(self.slots, batches):
                if slot.keys() != batch.keys():
                    raise ValueError(
                        f"--stepsPerLoop {self.k}: batch fields "
                        f"{sorted(batch)}, the chunk's {sorted(slot)}")
                for key, value in batch.items():
                    if (value.shape, value.dtype) != (slot[key].shape,
                                                      slot[key].dtype):
                        raise ValueError(
                            f"--stepsPerLoop {self.k}: a graph replays "
                            f"static shapes; {key} is {tuple(value.shape)} "
                            f"{value.dtype}, the chunk's "
                            f"{tuple(slot[key].shape)} {slot[key].dtype}")
                    slot[key].copy_(value)
        opt = self.optimizer
        host = torch.tensor([opt.lr_at(opt.step_count + i)
                             for i in range(self.k)], dtype=torch.float32)
        if self._stream is not None:
            host = host.pin_memory()
        self.lrs.copy_(host, non_blocking=True)

    def _body(self) -> None:
        for i, batch in enumerate(self.slots):
            metrics = self.train_step(batch, self.generator, self.lrs[i])
            with torch.no_grad():
                if self.metrics is None:
                    self.metrics = {key: v.new_empty((self.k,) + v.shape)
                                    for key, v in metrics.items()}
                for key, value in metrics.items():
                    self.metrics[key][i].copy_(value)

    def _capture(self) -> None:
        opt = self.optimizer
        count = opt.step_count
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        opt.zero_grad()
        try:
            # entering, torch.cuda.graph synchronizes and empties the
            # allocator's cache: the eager chunk's free blocks go back to
            # the card before the graph's private pool is filled
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                self._body()
        except RuntimeError as e:
            raise RuntimeError(
                f"--stepsPerLoop {self.k}: capturing {self.k} train steps "
                f"into a CUDA graph failed: {e}") from e
        finally:
            opt.step_count = count        # capturing trains nothing
        self.graph, self._addresses = graph, self._state()
        self.captures += 1

    def _replay(self) -> None:
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"--stepsPerLoop {self.k}: replaying the "
                               f"{self.k}-step CUDA graph failed: {e}") from e
        self.optimizer.step_count += self.k
        self.replays += 1
