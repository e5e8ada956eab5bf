"""pytorchvideo mvit_base_32x3 weights -> the trunk file both packages
read: the port of ``tools/convert_mvit.py`` (``convert`` and the CLI).

    python -m shgvqa_tpu_torch.utils.convert_mvit MVIT_B_32x3.pyth \\
        mvit_flax.msgpack

writes the bytes the JAX tool writes for the same input, so the file loads
through ``--backboneWeights`` in either package (its positional embeddings
are the 32-frame, 224-pixel clip's: run the trunk at ``--clipLEN 32``).
The CLI unwraps ``{"model_state": ...}``, drops the ``head.`` classifier
and reads with ``torch.load(weights_only=True)``.

Mapping (``MultiscaleVisionTransformers`` -> ``models/mvit.MViTB``):
- patch_embed.patch_model -> patch_embed; cls_positional_encoding.{cls_token,
  pos_embed_spatial, pos_embed_temporal, pos_embed_class} -> the same names,
  their leading broadcast axis dropped;
- blocks.{i}.norm1 / norm2 / mlp.fc1 / mlp.fc2 / proj -> block_{i}/norm1,
  norm2, mlp_fc1, mlp_fc2, proj; blocks.{i}.attn.{qkv, proj, pool_{q,k,v},
  norm_{q,k,v}} -> block_{i}/attn/...; norm_embed -> norm_embed;
- Linear (out, in) -> kernel (in, out); the fused qkv (3 * dim, dim) ->
  ``DenseGeneral`` kernel (dim, 3, heads, head_dim) (separate q / k / v
  Linears are concatenated first); the depthwise pool conv (hd, 1, kT, kH,
  kW) -> (kT, kH, kW, 1, hd); LayerNorm weight -> scale.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Sequence

import numpy as np

from shgvqa_tpu_torch.models.mvit import mvit_schedule
from shgvqa_tpu_torch.utils.flax_msgpack import msgpack_serialize


def convert(state_dict: Dict[str, np.ndarray],
            heads_per_block: Sequence[int]) -> dict:
    """mvit state_dict (numpy) -> {"params"} in the JAX layout;
    ``heads_per_block`` reshapes the fused qkv kernels."""
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
            np.asarray(state_dict["patch_embed.patch_model.weight"]),
            (2, 3, 4, 1, 0))))
    if "patch_embed.patch_model.bias" in state_dict:
        put(("patch_embed", "bias"),
            np.asarray(state_dict["patch_embed.patch_model.bias"]))

    cpe = "cls_positional_encoding."
    for name in ("cls_token", "pos_embed_spatial", "pos_embed_temporal",
                 "pos_embed_class"):
        put((name,), np.asarray(state_dict[cpe + name])[0])

    n_blocks = 1 + max(int(k.split(".")[1]) for k in state_dict
                       if k.startswith("blocks."))
    for i in range(n_blocks):
        src = f"blocks.{i}"
        dst = (f"block_{i}",)
        h = heads_per_block[i]
        ln(f"{src}.norm1", dst + ("norm1",))
        ln(f"{src}.norm2", dst + ("norm2",))
        dense(f"{src}.mlp.fc1", dst + ("mlp_fc1",))
        dense(f"{src}.mlp.fc2", dst + ("mlp_fc2",))
        if f"{src}.proj.weight" in state_dict:
            dense(f"{src}.proj", dst + ("proj",))

        a = f"{src}.attn"
        ad = dst + ("attn",)
        if f"{a}.qkv.weight" in state_dict:
            w = np.asarray(state_dict[f"{a}.qkv.weight"])      # (3d, d)
            b = state_dict.get(f"{a}.qkv.bias")
        else:                                   # separate q / k / v
            w = np.concatenate([np.asarray(state_dict[f"{a}.{t}.weight"])
                                for t in "qkv"], axis=0)
            bs = [state_dict.get(f"{a}.{t}.bias") for t in "qkv"]
            b = (np.concatenate([np.asarray(x) for x in bs], axis=0)
                 if bs[0] is not None else None)
        d = w.shape[1]
        put(ad + ("qkv", "kernel"),
            np.ascontiguousarray(w.T.reshape(d, 3, h, d // h)))
        if b is not None:
            put(ad + ("qkv", "bias"), np.asarray(b).reshape(3, h, d // h))
        dense(f"{a}.proj", ad + ("proj",))
        for tag in "qkv":
            pk = f"{a}.pool_{tag}.weight"
            if pk in state_dict:
                put(ad + (f"pool_{tag}",),
                    np.ascontiguousarray(np.transpose(
                        np.asarray(state_dict[pk]), (2, 3, 4, 1, 0))))
                ln(f"{a}.norm_{tag}", ad + (f"norm_{tag}",))

    ln("norm_embed", ("norm_embed",))
    return {"params": params}


def default_heads(depth: int = 16, num_heads: int = 1,
                  stage_blocks=(1, 3, 14)):
    """Each block's head count in the MViT-B schedule."""
    return [row[2] for row in mvit_schedule(depth, 96, num_heads,
                                            stage_blocks, (1, 8, 8))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("torch_ckpt", help=".pyth/.pth mvit_base checkpoint")
    ap.add_argument("out", help="output msgpack path")
    args = ap.parse_args(argv)

    import torch

    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("model_state", ckpt)
    state_dict = {k: v.numpy() for k, v in state_dict.items()
                  if not k.startswith("head.")}
    tree = convert(state_dict, default_heads())
    with open(args.out, "wb") as f:
        f.write(msgpack_serialize(tree))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
