"""pytorchvideo slow_r50 weights -> the trunk file both packages read: the
port of ``tools/convert_slow_r50.py`` (``convert`` and the CLI, without
``--check``, which needs flax).

    python -m shgvqa_tpu_torch.utils.convert_slow_r50 SLOW_8x8_R50.pyth \\
        slow_r50_flax.msgpack

writes the bytes the JAX tool writes for the same input, so a machine
without flax makes the file that ``--backboneWeights`` (or
``{dataDir}/slow_r50_flax.msgpack``) loads in either package.  The CLI
unwraps ``{"model_state": ...}`` and drops the ``blocks.5`` classifier
head.  It reads the checkpoint with ``torch.load(weights_only=True)``: a
file that pickles objects other than tensors and plain containers is
refused by torch.

Mapping (pytorchvideo ``Net`` blocks -> ``models/backbone.py`` modules):
- blocks.0 (stem): conv / norm -> stem_conv / stem_bn;
- blocks.{1..4} (res2..res5): res_blocks.{i}.branch1_{conv,norm} ->
  res_{s}/block_{i}/conv_proj, bn_proj; branch2.conv_{a,b,c} /
  norm_{a,b,c} -> conv_{a,b,c} / bn_{a,b,c};
- conv weight (O, I, kT, kH, kW) -> kernel (kT, kH, kW, I, O); BatchNorm
  {weight, bias} -> {scale, bias}, running_{mean, var} -> batch_stats
  {mean, var}.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

from shgvqa_tpu_torch.utils.flax_msgpack import msgpack_serialize

DEPTHS = (3, 4, 6, 3)


def convert(state_dict: Dict[str, np.ndarray]) -> dict:
    """pytorchvideo slow_r50 state_dict (numpy) -> {"params",
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
        put(params, dst + ("scale",), np.asarray(state_dict[prefix + ".weight"]))
        put(params, dst + ("bias",), np.asarray(state_dict[prefix + ".bias"]))
        put(stats, dst + ("mean",),
            np.asarray(state_dict[prefix + ".running_mean"]))
        put(stats, dst + ("var",),
            np.asarray(state_dict[prefix + ".running_var"]))

    put(params, ("stem_conv", "kernel"),
        conv_kernel(np.asarray(state_dict["blocks.0.conv.weight"])))
    bn("blocks.0.norm", ("stem_bn",))

    for stage in range(4):
        sb = f"blocks.{stage + 1}"
        sname = f"res_{stage + 2}"
        for i in range(DEPTHS[stage]):
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
    ap.add_argument("torch_ckpt", help=".pyth/.pth slow_r50 checkpoint")
    ap.add_argument("out", help="output msgpack path")
    args = ap.parse_args(argv)

    import torch

    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("model_state", ckpt)
    state_dict = {k: v for k, v in state_dict.items()
                  if not k.startswith("blocks.5")}  # drop the classifier head
    tree = convert({k: v.numpy() for k, v in state_dict.items()})
    with open(args.out, "wb") as f:
        f.write(msgpack_serialize(tree))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
