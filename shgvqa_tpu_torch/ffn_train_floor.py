"""Where the FFN chains spend their time on the card.

    python -m shgvqa_tpu_torch.ffn_train_floor

Rebuilds ``csrc/ffn_train.cu`` (beside a copy of the ``csrc/*.cuh``
headers) as variants, each one edit of a copy of the source, and times the
backward's and the forward's chain (at rate 0, as ``fused_ffn`` runs it)
of each at the flagship D=768, F=3072 and the row counts of a B=32 step
(M = 1280, 12576 and 5664, launched 7, 5 and 2 times a train step's
backward; 9, 7 and 2 times a forward), in turns (the variants, then again
in reverse order): CUDA events (median and range of 5 turns of 20 calls)
and each stage's device time per call (torch.profiler over 10 calls).

- ``as built``;
- ``o: 64 wide``: the o stage on its 64-wide tiles at every M, where the
  build takes 192-wide tiles where they fill the SMs' waves (M = 12576);
- ``u: 256 wide``: the u stage (both chains) on 256-wide tiles, a ring of
  4 stages and one block an SM, at every M, where the build has 128-wide
  tiles, 3 stages and two blocks an SM;
- ``4-stage ring``: the 128-wide products (u, dh) on a ring of 4 stages
  and one block an SM, where the build has 3 stages and two blocks share
  an SM;
- ``u: no gelu'(u) store`` and ``u: no stores``: the u stage's epilogue
  without its f32 gelu'(u) store, and without its stores (a store is kept
  only for h == 12345, so that h stays computed);
- ``dh: no gelu'(u) load`` and ``dh: no load or store``: the dh stage's
  epilogue without its gelu'(u) load, and without the load and the du
  store.

The last four give wrong results: they time what a part of an epilogue
costs.  Prints one JSON line per variant, turn and size, one line per
variant and turn of the per-step (backward) and per-forward sums, then the
card's name and power limit.  The builds go to the git-ignored ``shgvqa_tpu_torch/_build/``; it
needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import torch

from shgvqa_tpu_torch.bench import card_name_and_power_limit, time_spread
from shgvqa_tpu_torch.breakdown import top_kernels
from shgvqa_tpu_torch.entry import resolve_device
from shgvqa_tpu_torch.kernels import _build, ffn

D, FF = 768, 3072
# (M, backward launches a B=32 train step, forward launches a B=32 forward)
SITES = ((1280, 7, 9), (12576, 5, 7), (5664, 2, 2))
U_STORES = """        *reinterpret_cast<uint32_t*>(p.h + off) = pack_bf16(h0, h1);
        if (kGrad) *reinterpret_cast<float2*>(p.gd + off) = gd;
"""
DH_LOAD = ("return __ldg(reinterpret_cast<const float2*>(p.gd + "
           "static_cast<size_t>(row) * p.f + col));")
DH_STORE = """        *reinterpret_cast<uint32_t*>(p.du + static_cast<size_t>(row) * p.f + col) =
            pack_bf16(a0 * gd.x, a1 * gd.y);
"""
NO_DH_STORE = """        if (a0 == 12345.0f) p.du[static_cast<size_t>(row) * p.f + col] = __float2bfloat16(a1);
"""
# (variant, its edits of csrc/ffn_train.cu as (text, replacement) pairs)
VARIANTS = (
    ("as built", ()),
    ("o: 64 wide", (("err = o_takes_wide_tiles(p.m, p.d, sms)",
                     "err = false"),)),
    ("u: 256 wide", (
        ("  float acc[kWideN / 2];\n"
         "  if (!gemm_mainloop<kWideN, false, kWideStages>(xmap, w1map, p.d, "
         "acc)) return;\n  gemm_epilogue<kWideN>(",
         "  float acc[128];\n"
         "  if (!gemm_mainloop<256, false, 4>(xmap, w1map, p.d, acc)) "
         "return;\n  gemm_epilogue<256>("),
        ("__launch_bounds__(kGemmThreads, 2)\nffn_fwd_u_kernel",
         "__launch_bounds__(kGemmThreads, 1)\nffn_fwd_u_kernel"),
        ("__launch_bounds__(kGemmThreads, 2)\nffn_bwd_u_kernel",
         "__launch_bounds__(kGemmThreads, 1)\nffn_bwd_u_kernel"),
        ("gemm_launch<kWideN, kWideStages>(kGrad ? ffn_bwd_u_kernel",
         "gemm_launch<256, 4>(kGrad ? ffn_bwd_u_kernel"))),
    ("4-stage ring", (
        ("constexpr int kWideStages = 3;", "constexpr int kWideStages = 4;"),
        ("__launch_bounds__(kGemmThreads, 2)\nffn_bwd_u_kernel",
         "__launch_bounds__(kGemmThreads, 1)\nffn_bwd_u_kernel"),
        ("__launch_bounds__(kGemmThreads, 2)\nffn_bwd_dh_kernel",
         "__launch_bounds__(kGemmThreads, 1)\nffn_bwd_dh_kernel"))),
    ("u: no gelu'(u) store", ((U_STORES, U_STORES.splitlines(True)[0]),)),
    ("u: no stores", ((U_STORES, "        if (h0 == 12345.0f) p.h[off] = "
                                 "__float2bfloat16(h1);\n"),)),
    ("dh: no gelu'(u) load", ((DH_LOAD, "return make_float2(1.0f, 1.0f);"),)),
    ("dh: no load or store", ((DH_LOAD, "return make_float2(1.0f, 1.0f);"),
                              (DH_STORE, NO_DH_STORE))),
)


def _build_variants():
    """{variant: its library, signatures declared}, one nvcc each, all
    started together; raises on an edit that does not apply once or a
    failed build."""
    source = (_build.CSRC_DIR / "ffn_train.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit of {old!r} does not "
                                   "apply once to csrc/ffn_train.cu")
            text = text.replace(old, new)
        out = _build.BUILD_DIR / "ffn_train_floor" / str(i)
        out.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, out)
        (out / "ffn_train.cu").write_text(text)
        lib = out / "libffn_train.so"
        procs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(out / "ffn_train.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        libs[name] = ffn.declare_train(ctypes.CDLL(str(lib)))
    return libs


def _backward(lib, x, w1t, b1, w2t, b2, gamma, dy, stream):
    """One call of the library's backward chain at rate 0."""
    m, d = x.shape
    f = w1t.shape[0]
    buf = ffn._bwd_buffers(m, d, f, lib.shgvqa_ffn_train_bwd_rows(), x.device)
    err = lib.shgvqa_ffn_train_bwd_bf16(
        x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
        b2.data_ptr(), gamma.data_ptr(), None, dy.data_ptr(),
        *(t.data_ptr() for t in buf.values()), m, d, f, 1e-12, 0, 1.0, 0, 0,
        stream)
    if err:
        raise RuntimeError(f"backward launch failed: CUDA error {err}")


def _forward(lib, x, w1t, b1, w2t, b2, gamma, beta, stream):
    """One call of the library's forward chain at rate 0."""
    m, d = x.shape
    f = w1t.shape[0]
    buf = ffn._fwd_buffers(m, d, f, x.device)
    err = lib.shgvqa_ffn_train_fwd_bf16(
        x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
        b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), None,
        *(t.data_ptr() for t in buf.values()), m, d, f, 1e-12, 0, 1.0, 0, 0,
        stream)
    if err:
        raise RuntimeError(f"forward launch failed: CUDA error {err}")


def _time(run, stage_names):
    """(events median, [min, max], device ms per call, {stage: ms})."""
    events, (lo, hi) = time_spread(run)
    kernels, _ = top_kernels(lambda: [run() for _ in range(10)])
    stages = {stage: sum(k["ms"] for k in kernels if stage in k["kernel"]) / 10
              for stage in stage_names}
    return events, [lo, hi], sum(stages.values()), stages


def main() -> None:
    resolve_device("cuda")
    libs = _build_variants()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device="cuda")

    w1t, w2t = (randn(FF, D, scale=0.02).bfloat16(),
                randn(D, FF, scale=0.02).bfloat16())
    b1, b2 = randn(FF, scale=0.02), randn(D, scale=0.02)
    gamma = 1.0 + randn(D, scale=0.1)
    beta = randn(D, scale=0.1)
    order = [name for name, _ in VARIANTS]
    order += order[::-1]
    steps = {}
    for m, launches, fwd_launches in SITES:
        x, dy = randn(m, D).bfloat16(), randn(m, D).bfloat16()
        for turn, name in enumerate(order):
            lib = libs[name]
            events, spread, device, stages = _time(
                lambda: _backward(lib, x, w1t, b1, w2t, b2, gamma, dy, stream),
                ffn.BWD_STAGES)
            f_events, f_spread, f_device, f_stages = _time(
                lambda: _forward(lib, x, w1t, b1, w2t, b2, gamma, beta,
                                 stream), ffn.FWD_STAGES)
            key = (name, turn >= len(VARIANTS))
            total = steps.setdefault(key, [0.0, 0.0, 0.0, 0.0])
            total[0] += launches * events
            total[1] += launches * device
            total[2] += fwd_launches * f_events
            total[3] += fwd_launches * f_device
            print(json.dumps({"variant": name, "turn": turn, "M": m,
                              "events_ms": events, "events_range": spread,
                              "device_ms": device, "stage_ms": stages,
                              "fwd_events_ms": f_events,
                              "fwd_events_range": f_spread,
                              "fwd_device_ms": f_device,
                              "fwd_stage_ms": f_stages}), flush=True)
    for (name, second), (events, device, f_events, f_device) in steps.items():
        print(json.dumps({"variant": name, "turn": int(second),
                          "per_b32_step_events_ms": events,
                          "per_b32_step_device_ms": device,
                          "per_b32_forward_events_ms": f_events,
                          "per_b32_forward_device_ms": f_device}), flush=True)
    print(card_name_and_power_limit())


if __name__ == "__main__":
    main()
