"""Where a block of the fused FFN kernel spends its time on the card.

    python -m shgvqa_tpu_torch.ffn_floor

Builds ``csrc/ffn.cu`` four times, with ``-DSHGVQA_FFN_PRODUCTS=3, 1, 2,
0`` (both products, only the first, only the second, neither: the TMA
weight ring, barriers and epilogue alone), and times each at the flagship
D=768, F=3072 with M=80 (3 blocks: one block's duration) and M=12576 (the
visual sites at B=32).  Prints one JSON line per build and size, then the
card's name and power limit.  The builds go to the git-ignored
``shgvqa_tpu_torch/_build/``; it needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from shgvqa_tpu_torch.bench import card_name_and_power_limit, time_ms
from shgvqa_tpu_torch.entry import resolve_device
from shgvqa_tpu_torch.kernels import _build

D, FF = 768, 3072
BUILDS = ((3, "both products"), (1, "first product only"),
          (2, "second product only"), (0, "neither"))


def _build_variant(bits: int):
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f"libffn-products{bits}.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                    f"-DSHGVQA_FFN_PRODUCTS={bits}", "-o", str(lib),
                    str(_build.CSRC_DIR / "ffn.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).shgvqa_fused_ffn_bf16
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def main() -> None:
    resolve_device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    w1t = (0.02 * torch.randn(FF, D, generator=g, device="cuda")).bfloat16()
    w2t = (0.02 * torch.randn(D, FF, generator=g, device="cuda")).bfloat16()
    b1 = torch.zeros(FF, device="cuda")
    vec = torch.zeros(D, device="cuda")
    xs = {m: torch.randn(m, D, generator=g, device="cuda").bfloat16()
          for m in (80, 12576)}
    for bits, what in BUILDS:
        fn = _build_variant(bits)
        for m, x in xs.items():
            y = torch.empty_like(x)

            def launch():
                err = fn(x.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                         w2t.data_ptr(), vec.data_ptr(), vec.data_ptr(),
                         vec.data_ptr(), y.data_ptr(), m, D, FF, 1e-12, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            print(json.dumps({"products": what, "M": m,
                              "ms": time_ms(launch)}), flush=True)
    print(card_name_and_power_limit())


if __name__ == "__main__":
    main()
