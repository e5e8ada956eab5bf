"""Batching and the host -> device pipeline: the port of
``shgvqa_tpu/data/pipeline.py``.

Per-item featurization is numpy (questions tokenized once up front), and
``Batcher`` stacks items into contiguous numpy batches, bit-identical to the
JAX package's: the same shuffle order per (seed, epoch), the same static
shapes.  The last partial batch is padded with repeats of its last item up
to ``batch_size`` and carries ``n_valid`` so evaluation drops the pad rows.
With ``host_shard=(index, count)`` (a data-parallel run's rank and world
size) the shuffle order and the batch boundaries stay global, the trailing
batch is padded globally, and the rank builds only its rows of each batch
(``parallel/distributed.process_batch_slice``), with its own ``n_valid``:
the rows of the JAX ``Batcher(host_shard=...)``.

``prefetch`` runs the upstream iterator in a thread that keeps ``depth``
batches ready; given a CUDA ``device`` the thread also stages every array on
the card from pinned memory with ``non_blocking`` copies on a side stream,
and the consumer's stream waits on each batch's copies before it is used,
so transfers overlap compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from shgvqa_tpu_torch.parallel.distributed import process_batch_slice


def stack_items(items: List[Dict], pad_to: Optional[int] = None) -> Dict:
    """Stack per-item dicts; non-array fields (e.g. ques_id) become lists.
    Pads with repeats of the last item up to ``pad_to`` and records
    ``n_valid``."""
    n = len(items)
    if pad_to is not None and n < pad_to:
        items = items + [items[-1]] * (pad_to - n)
    out: Dict = {}
    for k in items[0]:
        v0 = items[0][k]
        numeric_scalar = np.isscalar(v0) and not isinstance(v0, (str, bytes))
        if isinstance(v0, np.ndarray) or numeric_scalar:
            out[k] = np.stack([np.asarray(it[k]) for it in items], axis=0)
        else:
            out[k] = [it[k] for it in items]
    out["n_valid"] = n
    return out


class Batcher:
    """Deterministic shuffled batching over an indexable item source."""

    def __init__(self, items, num_items: Optional[int] = None,
                 batch_size: int = 8, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 9595,
                 host_shard: Optional[tuple] = None):
        self._get = items.__getitem__
        self.num_items = num_items if num_items is not None else len(items)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.host_shard = host_shard
        if host_shard is not None and batch_size % host_shard[1]:
            raise ValueError(f"batch size {batch_size} not divisible by "
                             f"{host_shard[1]} processes")

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_items // self.batch_size
        return -(-self.num_items // self.batch_size)

    def epoch(self, epoch: int = 0, sharded: bool = True) -> Iterator[Dict]:
        """The batches of ``epoch``; with ``sharded`` off a host-sharded
        batcher yields the global batches (the int8 trunk's calibration
        batch)."""
        order = np.arange(self.num_items)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        bs = self.batch_size
        for start in range(0, self.num_items, bs):
            chunk = order[start : start + bs]
            if len(chunk) < bs and self.drop_last:
                return
            if self.host_shard is None or not sharded:
                yield stack_items([self._get(int(i)) for i in chunk],
                                  pad_to=bs)
                continue
            idx, cnt = self.host_shard
            n = len(chunk)
            if n < bs:
                # global padding (repeats of the last valid item) before
                # the slice: the padded global batch is the one-process one
                chunk = np.concatenate(
                    [chunk, np.full(bs - n, chunk[-1], chunk.dtype)])
            sl = process_batch_slice(bs, index=idx, count=cnt)
            batch = stack_items([self._get(int(i)) for i in chunk[sl]])
            per = bs // cnt
            batch["n_valid"] = int(np.clip(n - idx * per, 0, per))
            yield batch


def _to_device(batch: Dict, device: torch.device,
               stream: Optional[torch.cuda.Stream]) -> Dict:
    """The batch with every numpy array as a tensor on ``device`` (non-array
    fields as they are); on a CUDA device the copies are enqueued on
    ``stream`` from pinned memory."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
        elif stream is None:
            out[k] = torch.from_numpy(v).to(device)
        else:
            with torch.cuda.stream(stream):
                out[k] = torch.from_numpy(v).pin_memory().to(
                    device, non_blocking=True)
    return out


def prefetch(iterator: Iterable[Dict], depth: int = 2,
             device=None) -> Iterator[Dict]:
    """Run the upstream iterator in a thread, keeping ``depth`` batches
    ready; with ``device`` the thread also stages the arrays there (CUDA:
    pinned memory, ``non_blocking`` copies on a side stream that the
    consumer's current stream waits on)."""
    dev = None if device is None else torch.device(device)
    stream = (torch.cuda.Stream(dev) if dev is not None and dev.type == "cuda"
              else None)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in iterator:
                event = None
                if dev is not None:
                    item = _to_device(item, dev, stream)
                    if stream is not None:
                        event = torch.cuda.Event()
                        event.record(stream)
                q.put((item, event))
        except BaseException as e:  # noqa: BLE001 -- propagate to consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        got = q.get()
        if got is sentinel:
            t.join()
            if err:
                raise err[0]
            return
        item, event = got
        if event is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(event)
            for v in item.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
        yield item
