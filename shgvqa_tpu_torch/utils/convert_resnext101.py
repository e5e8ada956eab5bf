"""timm / torchvision ResNeXt-101 32x8d weights -> the trunk file both
packages read: the port of ``tools/convert_resnext101.py`` (``convert`` and
the CLI).

    python -m shgvqa_tpu_torch.utils.convert_resnext101 \\
        resnext101_32x8d.pth resnext101_flax.msgpack

writes the bytes the JAX tool writes for the same input, so the file loads
through ``--backboneWeights`` in either package.  The CLI unwraps
``{"state_dict": ...}`` or ``{"model": ...}``, drops the ``fc.`` classifier
and reads with ``torch.load(weights_only=True)``.

Mapping (timm ResNet -> ``models/backbones_extra.ResNeXt101``):
- conv1 / bn1 -> stem_conv / stem_bn;
- layer{s}.{i}.conv{1,2,3} / bn{1,2,3} -> layer{s}_block{i}/conv{c}, bn{c};
  downsample.0 / .1 -> downsample_conv / downsample_bn;
- conv weight (O, I / groups, kH, kW) -> kernel (kH, kW, I / groups, O)
  (flax's ``feature_group_count`` layout); BatchNorm {weight, bias} ->
  {scale, bias}, running_{mean, var} -> batch_stats.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

from shgvqa_tpu_torch.utils.flax_msgpack import msgpack_serialize

DEPTHS = (3, 4, 23, 3)


def convert(state_dict: Dict[str, np.ndarray], depths=DEPTHS) -> dict:
    """timm resnext101_32x8d state_dict (numpy) -> {"params",
    "batch_stats"} in the JAX layout."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    def conv_kernel(w):
        # (O, I, kH, kW) -> (kH, kW, I, O)
        return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))

    def bn(prefix, dst):
        put(params, dst + ("scale",),
            np.asarray(state_dict[prefix + ".weight"]))
        put(params, dst + ("bias",), np.asarray(state_dict[prefix + ".bias"]))
        put(stats, dst + ("mean",),
            np.asarray(state_dict[prefix + ".running_mean"]))
        put(stats, dst + ("var",),
            np.asarray(state_dict[prefix + ".running_var"]))

    put(params, ("stem_conv", "kernel"),
        conv_kernel(np.asarray(state_dict["conv1.weight"])))
    bn("bn1", ("stem_bn",))

    for s in range(4):
        for i in range(depths[s]):
            src = f"layer{s + 1}.{i}"
            dst = (f"layer{s + 1}_block{i}",)
            for c in ("1", "2", "3"):
                put(params, dst + (f"conv{c}", "kernel"),
                    conv_kernel(np.asarray(
                        state_dict[f"{src}.conv{c}.weight"])))
                bn(f"{src}.bn{c}", dst + (f"bn{c}",))
            if f"{src}.downsample.0.weight" in state_dict:
                put(params, dst + ("downsample_conv", "kernel"),
                    conv_kernel(np.asarray(
                        state_dict[f"{src}.downsample.0.weight"])))
                bn(f"{src}.downsample.1", dst + ("downsample_bn",))

    return {"params": params, "batch_stats": stats}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("torch_ckpt", help=".pth resnext101_32x8d checkpoint")
    ap.add_argument("out", help="output msgpack path")
    args = ap.parse_args(argv)

    import torch

    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("state_dict", ckpt.get("model", ckpt))
    state_dict = {k: v for k, v in state_dict.items()
                  if not k.startswith("fc.")}
    tree = convert({k: v.numpy() for k, v in state_dict.items()})
    with open(args.out, "wb") as f:
        f.write(msgpack_serialize(tree))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
