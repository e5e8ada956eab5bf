"""Official Video Swin (SwinTransformer3D, mmaction) weights -> the trunk
file both packages read: the port of ``tools/convert_video_swin.py``
(``convert`` and the CLI).

    python -m shgvqa_tpu_torch.utils.convert_video_swin \\
        swin_base_patch244_window877_kinetics400_22k.pth swin_flax.msgpack

writes the bytes the JAX tool writes for the same input, so the file loads
through ``--backboneWeights --backbone video_swin_impl`` in either package.
The CLI unwraps ``{"state_dict": ...}`` or ``{"model": ...}``, strips the
``backbone.`` prefix, drops the ``relative_position_index`` buffers (the
models recompute them) and the ``cls_head`` / ``head``, and reads with
``torch.load(weights_only=True)``.

Mapping (-> ``models/video_swin.VideoSwin``): patch_embed.proj / .norm ->
patch_embed / patch_norm; layers.{i}.blocks.{j}.{norm1, norm2, attn.qkv,
attn.proj, attn.relative_position_bias_table, mlp.fc1, mlp.fc2} ->
layer_{i}_block_{j}/{norm1, norm2, attn/qkv, attn/proj,
attn/relative_position_bias_table, mlp_fc1, mlp_fc2};
layers.{i}.downsample.{norm, reduction} -> downsample_{i}_{norm,
reduction}; norm -> norm.  Linear (out, in) -> kernel (in, out); conv
(C, 3, 2, 4, 4) -> (2, 4, 4, 3, C); LayerNorm weight -> scale.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

from shgvqa_tpu_torch.utils.flax_msgpack import msgpack_serialize


def convert(state_dict: Dict[str, np.ndarray]) -> dict:
    """SwinTransformer3D state_dict (numpy, no ``backbone.`` prefix) ->
    {"params"} in the JAX layout."""
    params: dict = {}

    def put(path, value):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    def dense(src, dst):
        put(dst + ("kernel",),
            np.ascontiguousarray(np.asarray(state_dict[src + ".weight"]).T))
        if src + ".bias" in state_dict:
            put(dst + ("bias",), np.asarray(state_dict[src + ".bias"]))

    def ln(src, dst):
        put(dst + ("scale",), np.asarray(state_dict[src + ".weight"]))
        put(dst + ("bias",), np.asarray(state_dict[src + ".bias"]))

    put(("patch_embed", "kernel"),
        np.ascontiguousarray(np.transpose(
            np.asarray(state_dict["patch_embed.proj.weight"]),
            (2, 3, 4, 1, 0))))
    put(("patch_embed", "bias"),
        np.asarray(state_dict["patch_embed.proj.bias"]))
    ln("patch_embed.norm", ("patch_norm",))

    n_layers = 1 + max(int(k.split(".")[1]) for k in state_dict
                       if k.startswith("layers."))
    for i in range(n_layers):
        blocks = {int(k.split(".")[3]) for k in state_dict
                  if k.startswith(f"layers.{i}.blocks.")}
        for j in sorted(blocks):
            src = f"layers.{i}.blocks.{j}"
            dst = (f"layer_{i}_block_{j}",)
            ln(f"{src}.norm1", dst + ("norm1",))
            ln(f"{src}.norm2", dst + ("norm2",))
            dense(f"{src}.attn.qkv", dst + ("attn", "qkv"))
            dense(f"{src}.attn.proj", dst + ("attn", "proj"))
            put(dst + ("attn", "relative_position_bias_table"),
                np.asarray(
                    state_dict[f"{src}.attn.relative_position_bias_table"]))
            dense(f"{src}.mlp.fc1", dst + ("mlp_fc1",))
            dense(f"{src}.mlp.fc2", dst + ("mlp_fc2",))
        if f"layers.{i}.downsample.reduction.weight" in state_dict:
            ln(f"layers.{i}.downsample.norm", (f"downsample_{i}_norm",))
            dense(f"layers.{i}.downsample.reduction",
                  (f"downsample_{i}_reduction",))

    ln("norm", ("norm",))
    return {"params": params}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("torch_ckpt", help=".pth SwinTransformer3D checkpoint")
    ap.add_argument("out", help="output msgpack path")
    args = ap.parse_args(argv)

    import torch

    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v.numpy()
          for k, v in sd.items()
          if "relative_position_index" not in k
          and not k.startswith(("cls_head", "head"))}
    tree = convert(sd)
    with open(args.out, "wb") as f:
        f.write(msgpack_serialize(tree))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
