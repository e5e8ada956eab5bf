"""pytorchvideo slowfast_r50 / slowfast_r101 weights -> the trunk file both
packages read: the port of ``tools/convert_slowfast.py`` (``convert`` and
the CLI).

    python -m shgvqa_tpu_torch.utils.convert_slowfast SLOWFAST_8x8_R50.pyth \\
        slowfast_r50_flax.msgpack
    python -m shgvqa_tpu_torch.utils.convert_slowfast --depth 101 \\
        SLOWFAST_8x8_R101.pyth slowfast_r101_flax.msgpack

writes the bytes the JAX tool writes for the same input, so the file loads
through ``--backboneWeights`` in either package.  The CLI unwraps
``{"model_state": ...}``, drops ``blocks.5`` (pool) and ``blocks.6`` (head)
and reads with ``torch.load(weights_only=True)``.

Mapping (pytorchvideo ``Net``, pathway 0 slow, 1 fast ->
``models/backbones_extra.SlowFastR50``):
- blocks.0.multipathway_blocks.{p}.conv / .norm -> {slow,fast}_stem_{conv,bn};
- blocks.{0..3}.multipathway_fusion.conv_fast_to_slow / .norm ->
  fuse_{b}_{conv,bn} (no fusion after stage 4);
- blocks.{1..4}.multipathway_blocks.{p}.res_blocks.{i}.branch1_conv / _norm
  -> {slow,fast}_res_{s}/block_{i}/conv_proj, bn_proj; branch2.conv_{a,b,c}
  / norm_{a,b,c} -> conv_{a,b,c} / bn_{a,b,c};
- conv weight (O, I, kT, kH, kW) -> kernel (kT, kH, kW, I, O); BatchNorm
  {weight, bias} -> {scale, bias}, running_{mean, var} -> batch_stats.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

from shgvqa_tpu_torch.utils.flax_msgpack import msgpack_serialize

PATHWAYS = ("slow", "fast")
DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def convert(state_dict: Dict[str, np.ndarray], depths=DEPTHS[50]) -> dict:
    """pytorchvideo slowfast state_dict (numpy) -> {"params",
    "batch_stats"} in the JAX layout."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    def conv_kernel(w):
        # (O, I, kT, kH, kW) -> (kT, kH, kW, I, O)
        return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))

    def bn(prefix, dst):
        put(params, dst + ("scale",),
            np.asarray(state_dict[prefix + ".weight"]))
        put(params, dst + ("bias",), np.asarray(state_dict[prefix + ".bias"]))
        put(stats, dst + ("mean",),
            np.asarray(state_dict[prefix + ".running_mean"]))
        put(stats, dst + ("var",),
            np.asarray(state_dict[prefix + ".running_var"]))

    for p, path in enumerate(PATHWAYS):
        src = f"blocks.0.multipathway_blocks.{p}"
        put(params, (f"{path}_stem_conv", "kernel"),
            conv_kernel(np.asarray(state_dict[f"{src}.conv.weight"])))
        bn(f"{src}.norm", (f"{path}_stem_bn",))

    for b in range(4):
        src = f"blocks.{b}.multipathway_fusion"
        put(params, (f"fuse_{b}_conv", "kernel"),
            conv_kernel(np.asarray(
                state_dict[f"{src}.conv_fast_to_slow.weight"])))
        bn(f"{src}.norm", (f"fuse_{b}_bn",))

    for stage in range(4):
        for p, path in enumerate(PATHWAYS):
            sb = f"blocks.{stage + 1}.multipathway_blocks.{p}"
            sname = f"{path}_res_{stage + 2}"
            for i in range(depths[stage]):
                bb = f"{sb}.res_blocks.{i}"
                dst = (sname, f"block_{i}")
                if f"{bb}.branch1_conv.weight" in state_dict:
                    put(params, dst + ("conv_proj", "kernel"),
                        conv_kernel(np.asarray(
                            state_dict[f"{bb}.branch1_conv.weight"])))
                    bn(f"{bb}.branch1_norm", dst + ("bn_proj",))
                for tag in ("a", "b", "c"):
                    put(params, dst + (f"conv_{tag}", "kernel"),
                        conv_kernel(np.asarray(
                            state_dict[f"{bb}.branch2.conv_{tag}.weight"])))
                    bn(f"{bb}.branch2.norm_{tag}", dst + (f"bn_{tag}",))

    return {"params": params, "batch_stats": stats}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("torch_ckpt", help=".pyth/.pth slowfast checkpoint")
    ap.add_argument("out", help="output msgpack path")
    ap.add_argument("--depth", type=int, default=50, choices=(50, 101))
    args = ap.parse_args(argv)

    import torch

    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("model_state", ckpt)
    state_dict = {k: v for k, v in state_dict.items()
                  if not k.startswith(("blocks.5", "blocks.6"))}
    tree = convert({k: v.numpy() for k, v in state_dict.items()},
                   depths=DEPTHS[args.depth])
    with open(args.out, "wb") as f:
        f.write(msgpack_serialize(tree))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
