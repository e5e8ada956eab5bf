"""A branch on a device flag, as ``jax.lax.cond``: eagerly by a host read,
and inside a CUDA graph being captured as two IF conditional nodes.

``branch(flag, if_true, if_false, out)`` leaves in ``out`` what
``if_true()`` returns where the 0-dim bool ``flag`` holds, else what
``if_false()`` returns; neither may draw from a generator (a replay would
then draw at a Philox offset fixed at capture whichever branch runs).

- On the CPU, and on a card outside a capture, it reads ``flag`` on the
  host and runs one branch.  Inside ``warm_up()`` on a card it first runs
  the other one too, both on the stream the capture's bodies use: that is
  the warm-up a later capture needs (kernel builds, library handles and
  workspaces, allocator blocks).  ``train/graph.StepChunks`` enters it for
  its eager first chunk only, so no other call pays for both.
- While the current stream is capturing it reads nothing: for each branch
  ``csrc/cond_node.cu`` adds to the captured graph a one-thread kernel that
  sets a condition from ``flag`` (negated for ``if_false``) and an IF node
  on it, and the branch is captured into the node's body from a second
  stream.  The body's allocations come from a private memory pool kept for
  the process, so their addresses stay the graph's; the two bodies run in
  stream order, so they may share its blocks.  A replay runs exactly one
  body.  Nothing falls back: a failed node raises.

``branch.nodes`` counts the conditional nodes captured.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Iterator

import torch

from shgvqa_tpu_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/cond_node.cu`` with its C signatures declared."""
    lib = _build.load("cond_node")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.shgvqa_cond_if_begin.argtypes = [ptr, ptr, i32, ptr]
    lib.shgvqa_cond_if_begin.restype = i32
    lib.shgvqa_cond_if_end.argtypes = [ptr]
    lib.shgvqa_cond_if_end.restype = i32
    lib.shgvqa_cond_error_string.argtypes = [i32]
    lib.shgvqa_cond_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _body_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


@functools.lru_cache(maxsize=None)
def _body_pool(device: torch.device):
    return torch.cuda.graph_pool_handle()


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} failed: CUDA error {err} "
            f"({_lib().shgvqa_cond_error_string(err).decode()})")


def _capture_branches(flag: torch.Tensor, bodies, out: torch.Tensor) -> None:
    """Two IF nodes on the capturing stream, one per (negate, body)."""
    dev = out.device
    lib = _lib()
    stream = torch.cuda.current_stream(dev)
    body_stream, pool = _body_stream(dev), _body_pool(dev)
    flag = flag.to(torch.bool).contiguous()
    for negate, body in bodies:
        _raise_on(lib.shgvqa_cond_if_begin(
            stream.cuda_stream, flag.data_ptr(), int(negate),
            body_stream.cuda_stream), "adding a conditional graph node")
        try:
            with torch.cuda.stream(body_stream):
                # the body stream's allocations come from the pool until
                # _cuda_endAllocateToPool
                torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index,
                                                                pool)
                try:
                    out.copy_(body())
                finally:
                    torch._C._cuda_endAllocateToPool(dev.index, pool)
        finally:
            _raise_on(lib.shgvqa_cond_if_end(body_stream.cuda_stream),
                      "capturing a conditional node's body")
        branch.nodes += 1


@contextlib.contextmanager
def warm_up() -> Iterator[None]:
    """While it lasts, an eager ``branch`` on a card runs both branches on
    the capture's body stream (module docstring)."""
    before, branch.warming = branch.warming, True
    try:
        yield
    finally:
        branch.warming = before


def branch(flag: torch.Tensor, if_true: Callable[[], torch.Tensor],
           if_false: Callable[[], torch.Tensor],
           out: torch.Tensor) -> torch.Tensor:
    """``out`` <- ``if_true()`` where ``flag`` holds, else ``if_false()``
    (module docstring); returns ``out``."""
    if _capturing(out.device):
        _capture_branches(flag, ((False, if_true), (True, if_false)), out)
        return out
    taken = bool(flag)
    if out.device.type != "cuda" or not branch.warming:
        return out.copy_((if_true if taken else if_false)())
    current = torch.cuda.current_stream(out.device)
    body_stream = _body_stream(out.device)
    body_stream.wait_stream(current)
    with torch.cuda.stream(body_stream):
        out.copy_((if_false if taken else if_true)())
        out.copy_((if_true if taken else if_false)())
    current.wait_stream(body_stream)
    return out


branch.nodes = 0
branch.warming = False
