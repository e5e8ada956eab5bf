"""Where the fused bottleneck spends its time on the card.

    python -m shgvqa_tpu_torch.bottleneck_floor

Rebuilds ``csrc/bottleneck.cu`` as variants, each one edit of a copy of
the source, and times each at the three trunk geometries of a B=32
forward (512 frames: res_2 block_0 with its projection, res_2 blocks 1-2,
res_3 blocks 1-3, launched 1, 2 and 3 times a forward), in turns (the
variants, then again in reverse order): CUDA events (median and range of
5 turns of 20 calls) and the kernel's device time per call
(torch.profiler over 10 calls).

- ``as built``;
- ``no conv_a``, ``no conv_b``, ``no conv_c``: that product's matrix
  instructions removed (the producer still streams the weights; the
  epilogue after it still runs, on zeros);
- ``no y store``: the last epilogue computes y into shared memory and
  issues no TMA store;
- ``no wb loads`` and ``no x loads``: the producer lands no conv_b
  weights, or no x (conv_a's window and the residual); the consumers run
  on what the stages hold;
- ``4-stage ring``: a ring of 4 stages where the build has 5 (the spans
  grow to fill the room).

All but the first and the last give wrong results: they time what a part
costs.  Prints one JSON line per variant, turn and site, one line per
variant and turn of the per-forward sums, then the card's name and power
limit.  The builds go to the git-ignored ``shgvqa_tpu_torch/_build/``; it
needs a CUDA card and ``nvcc``.
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
from shgvqa_tpu_torch.kernels import _build, bottleneck

FRAMES = 512                                     # B=32 clips of 16 frames
# (site, H = W, Ci, Cm, Co, projection, launches a forward)
SITES = (("res_2 block_0", 56, 64, 64, 256, True, 1),
         ("res_2 blocks 1-2", 56, 256, 64, 256, False, 2),
         ("res_3 blocks 1-3", 28, 512, 128, 512, False, 3))
WGMMA_Y_STORE = "tma_store_2d(ymap, "
# (variant, its edits as (text, replacement) pairs)
VARIANTS = (
    ("as built", ()),
    ("no conv_a", (("if (on) ss_group<CM>(acc,", "if (false) ss_group<CM>(acc,"),)),
    ("no conv_b", (("if (on) conv_b_stage<CM>(", "if (false) conv_b_stage<CM>("),)),
    ("no conv_c", (("rs_issue<kNC>(accc, bfrag", "if (false) rs_issue<kNC>(accc, bfrag"),)),
    ("no y store", ((WGMMA_Y_STORE, "if (false) " + WGMMA_Y_STORE),)),
    ("no wb loads", (("r.acquire(CM * kBK * 2);", "r.acquire(0);"),
                     ("tma_2d(st + kXBytes + j * kBoxBytes, wbmap,",
                      "if (false) tma_2d(st + kXBytes + j * kBoxBytes, wbmap,"))),
    ("no x loads", (
        ("r.acquire(kXBytes + CM * kBK * 2);\n        tma_2d(st, xmap,",
         "r.acquire(CM * kBK * 2);\n        if (false) tma_2d(st, xmap,"),
        ("r.acquire(kBoxBytes + (res ? kXBytes : 0));\n          if (res) tma_2d(",
         "r.acquire(kBoxBytes);\n          if (false) tma_2d("))),
    ("4-stage ring", (("constexpr int kStages = 5;", "constexpr int kStages = 4;"),)),
)


def _build_variants():
    """{variant: its library, signatures declared}, one nvcc each, all
    started together; raises on an edit that does not apply once or a
    failed build."""
    source = (_build.CSRC_DIR / "bottleneck.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit of {old!r} does not "
                                   "apply once to csrc/bottleneck.cu")
            text = text.replace(old, new)
        out = _build.BUILD_DIR / "bottleneck_floor" / str(i)
        out.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, out)
        (out / "bottleneck.cu").write_text(text)
        lib = out / "libbottleneck.so"
        procs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(out / "bottleneck.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        libs[name] = bottleneck.declare(ctypes.CDLL(str(lib)))
    return [name for name, _ in VARIANTS], libs


def _operands(hw, ci, cm, co, proj, g):
    """Seeded bf16 frames, weights and folded BN vectors on the card."""
    def randn(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=g,
                                            device="cuda")).bfloat16()

    x = torch.relu(torch.randn(FRAMES, hw, hw, ci, generator=g,
                               device="cuda")).bfloat16()
    args = [x, randn(cm, ci, scale=ci ** -0.5), randn(cm, scale=0.1, shift=1),
            randn(cm, scale=0.1), randn(cm, cm, 3, 3, scale=(9 * cm) ** -0.5),
            randn(cm, scale=0.1, shift=1), randn(cm, scale=0.1),
            randn(co, cm, scale=cm ** -0.5), randn(co, scale=0.1, shift=1),
            randn(co, scale=0.1)]
    pr = None
    if proj:
        pr = (randn(co, ci, scale=ci ** -0.5), randn(co, scale=0.1, shift=1),
              randn(co, scale=0.1))
    return args, pr


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    resolve_device("cuda")
    names, libs = _build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    order = names + names[::-1]
    sums = {}
    with torch.inference_mode():
        for site, hw, ci, cm, co, proj, launches in SITES:
            ops, pr = _operands(hw, ci, cm, co, proj, g)
            for turn, name in enumerate(order):
                def run():
                    bottleneck.launch(libs[name], ops, pr)

                events, (lo, hi) = time_spread(run)
                kernels, _ = top_kernels(lambda: [run() for _ in range(10)])
                device = sum(k["ms"] for k in kernels
                             if "bottleneck" in k["kernel"]) / 10
                key = (name, turn >= len(names))
                total = sums.setdefault(key, [0.0, 0.0])
                total[0] += launches * events
                total[1] += launches * device
                print(json.dumps({"variant": name, "turn": turn,
                                  "site": site, "events_ms": events,
                                  "events_range": [lo, hi],
                                  "device_ms": device}), flush=True)
            del ops, pr
    for (name, second), (events, device) in sums.items():
        print(json.dumps({"variant": name, "turn": int(second),
                          "per_b32_forward_events_ms": events,
                          "per_b32_forward_device_ms": device}), flush=True)
    print(card_name_and_power_limit())


if __name__ == "__main__":
    main()
