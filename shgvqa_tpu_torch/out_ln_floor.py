"""Where the attention-output kernel spends its time on the card.

    python -m shgvqa_tpu_torch.out_ln_floor

Rebuilds ``csrc/out_ln.cu`` as variants, each one edit of a copy of the
source, and times each at the AttOutput shapes of a forward (M = B * L for
L in 40, 393, 177, launched 9, 7 and 2 times, at B=32 and B=2), in turns
(the variants, then again in reverse order): CUDA events (median and range
of 5 turns of 20 calls) and the kernel's device time per call
(torch.profiler over 10 calls).

- ``as built``;
- ``no exchange``: each CTA normalizes its slab alone (the two exchanges'
  cluster barriers and distributed-shared-memory reads removed);
- ``no epilogue``: the consumers stop after the products and the
  residual's load (no LayerNorm, no y);
- ``no residual``: the producer lands no residual tile;
- ``no y store``: y is written to shared memory and not stored;
- ``64-row tiles`` and ``128-row tiles``: that row tile at every M, where
  the build picks it from M.

The first and the last two give the kernel's results; the others time
what a part costs.  Prints one JSON line per variant, turn and shape, one
line per variant and turn of the per-forward sums, then the card's name
and power limit.  The builds go to the git-ignored
``shgvqa_tpu_torch/_build/``; it needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import torch

from shgvqa_tpu_torch.bench import card_name_and_power_limit, time_spread
from shgvqa_tpu_torch.breakdown import top_kernels
from shgvqa_tpu_torch.entry import resolve_device
from shgvqa_tpu_torch.kernels import _build, ffn

D = 768
# (rows per clip, launches a forward): language, visual, HG AttOutput sites
SITES = ((40, 9), (393, 7), (177, 2))
BATCHES = (32, 2)
EXCHANGE = """  cluster_sync();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float total = 0.0f;
    for (int k = 0; k < cs; ++k) total += ld_cluster_f32(part + 4 * (r0 + 8 * h), k);
    s[h] = total;
  }
"""
PRODUCER = "for (int i = 0; i < 3; ++i) cluster_sync();"
ROWS = "return ctas >= sms && 4 * ctas >= 3 * waves * sms ? kGemmBM : kNarrowRows;"
RES_TMA = "tma_2d(res + (cb * kBM + rb * 64) * 128, &rmap,"
# (variant, its edits as (text, replacement) pairs)
VARIANTS = (
    ("as built", ()),
    ("no exchange", ((EXCHANGE, ""), (PRODUCER, "cluster_sync();"))),
    ("no epilogue", (("  mbar_wait(res_bar, 0);\n",
                      "  mbar_wait(res_bar, 0);\n  if (d > 0) {\n"
                      "    cluster_sync();\n    return;\n  }\n"),
                     (PRODUCER, "cluster_sync();"))),
    ("no residual", (("mbar_expect_tx(res_bar, kBM * BN * 2);",
                      "mbar_expect_tx(res_bar, 0);"),
                     (RES_TMA, "if (false) " + RES_TMA))),
    ("no y store", (("tma_store_2d(&ymap,", "if (false) tma_store_2d(&ymap,"),)),
    ("64-row tiles", ((ROWS, "return kNarrowRows;"),)),
    ("128-row tiles", ((ROWS, "return kGemmBM;"),)),
)


def _build_variants():
    """{variant: its declared library}, one nvcc each, all started
    together; raises on an edit that does not apply once or a failed
    build."""
    source = (_build.CSRC_DIR / "out_ln.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit of {old!r} does not "
                                   "apply once to csrc/out_ln.cu")
            text = text.replace(old, new)
        out = _build.BUILD_DIR / "out_ln_floor" / str(i)
        out.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, out)
        (out / "out_ln.cu").write_text(text)
        lib = out / "libout_ln.so"
        procs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(out / "out_ln.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        libs[name] = ffn.declare_out_ln(ctypes.CDLL(str(lib)))
    return [name for name, _ in VARIANTS], libs


def _operands(m, g):
    """Seeded bf16 x, W, residual and f32 b, gamma, beta on the card."""
    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    return (randn(m, D).bfloat16(), (0.02 * randn(D, D)).bfloat16(),
            0.02 * randn(D), randn(m, D).bfloat16(), 1.0 + 0.1 * randn(D),
            0.1 * randn(D))


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    resolve_device("cuda")
    names, libs = _build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    order = names + names[::-1]
    sums = {}
    with torch.inference_mode():
        for bsz in BATCHES:
            for per_clip, launches in SITES:
                m = per_clip * bsz
                ops = _operands(m, g)
                for turn, name in enumerate(order):
                    def run():
                        ffn._launch_out_ln(*ops, 1e-12, lib=libs[name])

                    events, (lo, hi) = time_spread(run)
                    kernels, _ = top_kernels(lambda: [run() for _ in range(10)])
                    device = sum(k["ms"] for k in kernels
                                 if "out_ln" in k["kernel"]) / 10
                    key = (name, bsz, turn >= len(names))
                    total = sums.setdefault(key, [0.0, 0.0])
                    total[0] += launches * events
                    total[1] += launches * device
                    print(json.dumps({"variant": name, "turn": turn, "B": bsz,
                                      "M": m, "events_ms": events,
                                      "events_range": [lo, hi],
                                      "device_ms": device}), flush=True)
                del ops
    for (name, bsz, second), (events, device) in sums.items():
        print(json.dumps({"variant": name, "B": bsz, "turn": int(second),
                          "per_forward_events_ms": events,
                          "per_forward_device_ms": device}), flush=True)
    print(card_name_and_power_limit())


if __name__ == "__main__":
    main()
