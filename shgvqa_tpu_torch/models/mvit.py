"""MViT-B video trunk (Multiscale Vision Transformers, pytorchvideo
``mvit_base_32x3`` without its head): the port of
``shgvqa_tpu/models/mvit.py``.  Module and parameter names are the JAX
ones, so ``convert.py`` maps the trees.

- patch embed: conv (3, 7, 7) / stride (2, 4, 4) / pad (1, 3, 3) to 96
  channels; tokens flattened with a prepended cls token;
- separable positional embeddings: ``pos_embed_spatial`` (H*W, C) tiled
  over T plus ``pos_embed_temporal`` (T, C) repeated over H*W, and
  ``pos_embed_class`` on the cls token; their shapes follow the clip's
  frames and side, so the trunk is built for them (``frames``,
  ``image_size``);
- 16 blocks (``mvit_schedule``): the channel width doubles in the block
  before each stage block (1, 3, 14), the heads double at it, so the head
  width stays 96; Q is pooled with stride (1, 2, 2) at the stage blocks
  and K/V at every block by the adaptive stride (1, 8, 8) divided by each
  Q stride;
- pooling attention: per-head depthwise (3, 3, 3) convs, bias-free, with
  the heads folded into the batch; the cls token bypasses the pooling;
  LayerNorm (eps 1e-6) after it; scores softmax(q k^T / sqrt(hd)) in f32,
  no residual-q add (that is MViTv2); the attention stays plain PyTorch
  (``csrc/attention.cu`` takes 64-wide heads, these are 96);
- a max-pooled residual (kernel (1, 3, 3), the cls token bypassing) at the
  Q-stride blocks; MLP fc1 (4x) -> exact erf GELU -> fc2, which carries the
  width change, and the residual replaced by ``proj(norm2(x))`` there;
- a final LayerNorm ``norm_embed``.

(B, T, H, W, 3) -> (B, ceil(T/2), H/32, W/32, 768).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shgvqa_tpu_torch.configs.config import trunk_steps
from shgvqa_tpu_torch.models.backbone import Trunk, halve
from shgvqa_tpu_torch.models.layers import (
    Conv3d,
    Dense,
    LayerNorm,
    empty_param,
    gelu,
    trunc_normal_,
)

_LN_EPS = 1e-6


def _depthwise_pool(x: torch.Tensor, kernel: torch.Tensor,
                    stride: Tuple[int, int, int], dtype) -> torch.Tensor:
    """Depthwise conv over a (N, T, H, W, C) grid, padding k // 2;
    ``kernel`` in the JAX layout (kT, kH, kW, 1, C)."""
    w = kernel.to(dtype).permute(4, 3, 0, 1, 2)
    y = F.conv3d(x.to(dtype).permute(0, 4, 1, 2, 3), w, None, stride,
                 tuple(k // 2 for k in kernel.shape[:3]), groups=x.shape[-1])
    return y.permute(0, 2, 3, 4, 1)


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` onto (3, heads, head_dim): weight
    (3, heads, head_dim, in), bias (3, heads, head_dim)."""

    def __init__(self, in_features: int, heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = empty_param(3, heads, head_dim, in_features)
        self.bias = empty_param(3, heads, head_dim)
        self.dtype = dtype

    def init_params(self, g):
        fan_in = self.weight.shape[-1]
        trunc_normal_(self.weight, 1.0 / math.sqrt(fan_in) / .87962566103423978,
                      g)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.weight.to(dt).reshape(-1, self.weight.shape[-1])
        y = F.linear(x.to(dt), w, self.bias.to(dt).reshape(-1))
        return y.reshape(*x.shape[:-1], *self.weight.shape[:3])


class PoolingAttention(nn.Module):
    """MultiScaleAttention: fused qkv, per-head depthwise conv pooling with
    a post-pool LayerNorm, the cls token bypassing the pooling.  ``pool_q``
    and ``norm_q`` exist only at a Q-stride block, ``pool_k`` / ``pool_v``
    at every block (pytorchvideo keeps them at stride 1)."""

    def __init__(self, dim: int, num_heads: int,
                 pool_kernel: Tuple[int, int, int] = (3, 3, 3),
                 q_stride: Tuple[int, int, int] = (1, 1, 1),
                 kv_stride: Tuple[int, int, int] = (1, 1, 1),
                 has_q_pool: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hd = dim // num_heads
        self.num_heads, self.head_dim = num_heads, hd
        self.q_stride, self.kv_stride = tuple(q_stride), tuple(kv_stride)
        self.dtype = dtype
        self.qkv = DenseGeneral(dim, num_heads, hd, dtype)
        self.tags = ("q", "k", "v") if has_q_pool else ("k", "v")
        for tag in self.tags:
            setattr(self, f"pool_{tag}", empty_param(*pool_kernel, 1, hd))
            setattr(self, f"norm_{tag}", LayerNorm(hd, _LN_EPS, dtype))
        self.proj = Dense(dim, dim, dtype)

    def init_params(self, g):
        for tag in self.tags:
            w = getattr(self, f"pool_{tag}")
            trunc_normal_(w, 1.0 / math.sqrt(w[..., 0, 0].numel())
                          / .87962566103423978, g)

    def _pool(self, x, thw, stride, tag):
        """x (B, h, 1 + T*H*W, hd) -> pooled tokens and their (t, h, w)."""
        b, h, _, hd = x.shape
        t, hh, ww = thw
        cls_tok, grid = x[:, :, :1], x[:, :, 1:]
        grid = _depthwise_pool(grid.reshape(b * h, t, hh, ww, hd),
                               getattr(self, f"pool_{tag}"), stride,
                               self.dtype)
        nt, nh, nw = grid.shape[1:4]
        out = torch.cat([cls_tok, grid.reshape(b, h, nt * nh * nw, hd)], 2)
        return getattr(self, f"norm_{tag}")(out), (nt, nh, nw)

    def forward(self, x, thw):
        b, _, d = x.shape
        qkv = self.qkv(x)                               # (B, L, 3, h, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        q_thw = thw
        if "q" in self.tags:
            q, q_thw = self._pool(q, thw, self.q_stride, "q")
        k, _ = self._pool(k, thw, self.kv_stride, "k")
        v, _ = self._pool(v, thw, self.kv_stride, "v")
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
        scores = scores / math.sqrt(self.head_dim)
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.matmul(probs, v).transpose(1, 2)
        return self.proj(out.reshape(b, out.shape[1], d)), q_thw


class MViTBlock(nn.Module):
    """MultiScaleBlock: attention at ``dim``; the MLP's fc2 carries the
    width change, and then the residual is ``proj(norm2(x))``."""

    def __init__(self, dim: int, out_dim: int, num_heads: int,
                 mlp_ratio: float = 4.0,
                 pool_kernel: Tuple[int, int, int] = (3, 3, 3),
                 q_stride: Tuple[int, int, int] = (1, 1, 1),
                 kv_stride: Tuple[int, int, int] = (1, 1, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.q_stride = tuple(q_stride)
        self.norm1 = LayerNorm(dim, _LN_EPS, dtype)
        self.attn = PoolingAttention(dim, num_heads, pool_kernel, q_stride,
                                     kv_stride, max(q_stride) > 1, dtype)
        self.norm2 = LayerNorm(dim, _LN_EPS, dtype)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), out_dim, dtype)
        self.has_proj = out_dim != dim
        if self.has_proj:
            self.proj = Dense(dim, out_dim, dtype)

    def forward(self, x, thw):
        attn_out, new_thw = self.attn(self.norm1(x), thw)
        if max(self.q_stride) > 1:
            # skip-path max-pool: kernel s + 1 where s > 1, cls bypassing
            b, _, d = x.shape
            t, hh, ww = thw
            win = tuple(s + 1 if s > 1 else s for s in self.q_stride)
            grid = x[:, 1:].reshape(b, t, hh, ww, d).permute(0, 4, 1, 2, 3)
            grid = F.max_pool3d(grid, win, self.q_stride,
                                tuple(w // 2 for w in win))
            res = torch.cat([x[:, :1], grid.flatten(2).transpose(1, 2)], 1)
        else:
            res = x
        x = res + attn_out
        xn = self.norm2(x)
        hmid = self.mlp_fc2(gelu(self.mlp_fc1(xn)))
        if self.has_proj:
            x = self.proj(xn)
        return x + hmid, new_thw


def mvit_schedule(depth: int, embed_dim: int, num_heads: int,
                  stage_blocks: Sequence[int],
                  kv_stride: Tuple[int, int, int]):
    """Per-block (dim, dim_out, heads, q_stride, kv_stride): the width
    doubles in the block before each stage block, the heads at it; the
    adaptive KV stride is divided by each Q stride as it occurs (the same
    block included)."""
    stage = set(stage_blocks)
    rows = []
    dim, heads = embed_dim, num_heads
    kv = list(kv_stride)
    for i in range(depth):
        if i in stage:
            heads *= 2
            dim *= 2
        qs = (1, 2, 2) if i in stage else (1, 1, 1)
        kv = [max(s // q, 1) for s, q in zip(kv, qs)]
        dim_out = dim * 2 if (i + 1) in stage else dim
        rows.append((dim, dim_out, heads, qs, tuple(kv)))
    return rows


class MViTB(Trunk):
    """MViT-B trunk for clips of ``frames`` frames of side ``image_size``
    (module docstring); the width and depth overrides run the same
    topology at toy size in tests."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 frames: int = 32, image_size: int = 224,
                 embed_dim: int = 96, depth: int = 16, num_heads: int = 1,
                 stage_blocks: Sequence[int] = (1, 3, 14),
                 kv_stride: Tuple[int, int, int] = (1, 8, 8),
                 pool_kernel: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        self.dtype = dtype
        self.stages = len(stage_blocks)
        self.patch_embed = Conv3d(3, embed_dim, (3, 7, 7), (2, 4, 4),
                                  (1, 3, 3), bias=True, dtype=dtype,
                                  init="he_normal")
        t, hw = self.temporal_out(frames), -(-image_size // 4)
        self.pos_embed_spatial = empty_param(hw * hw, embed_dim)
        self.pos_embed_temporal = empty_param(t, embed_dim)
        self.pos_embed_class = empty_param(1, embed_dim)
        self.cls_token = empty_param(1, embed_dim)
        self.names = []
        for i, (dim, dim_out, heads, qs, kv) in enumerate(mvit_schedule(
                depth, embed_dim, num_heads, stage_blocks, kv_stride)):
            setattr(self, f"block_{i}", MViTBlock(
                dim, dim_out, heads, pool_kernel=pool_kernel, q_stride=qs,
                kv_stride=kv, dtype=dtype))
            self.names.append(f"block_{i}")
        self.norm_embed = LayerNorm(dim_out, _LN_EPS, dtype)
        self.out_channels = dim_out

    def init_params(self, g):
        for p in (self.pos_embed_spatial, self.pos_embed_temporal,
                  self.pos_embed_class):
            trunc_normal_(p, 0.02, g)
        self.cls_token.zero_()

    def spatial_out(self, size: int) -> int:
        """The patch embed's stride 4, then each stage block's Q stride
        2, rounding up."""
        return halve(-(-size // 4), self.stages)

    @staticmethod
    def temporal_out(frames: int) -> int:
        """The patch embed's temporal stride 2 (``trunk_steps``)."""
        return trunk_steps("mvit_B", frames)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, H, W, 3) normalized frames -> (B, T/2, H/32, W/32, C)."""
        dt = self.dtype
        x = self.patch_embed(x.to(dt).permute(0, 4, 1, 2, 3))
        b, d, t, hh, ww = x.shape
        thw = (t, hh, ww)
        x = x.flatten(2).transpose(1, 2)
        pos = (self.pos_embed_spatial.repeat(t, 1)
               + self.pos_embed_temporal.repeat_interleave(hh * ww, dim=0))
        x = x + pos[None].to(dt)
        cls_col = (self.cls_token + self.pos_embed_class).to(dt)
        x = torch.cat([cls_col[None].expand(b, 1, d), x], dim=1)
        for name in self.names:
            x, thw = getattr(self, name)(x, thw)
        x = self.norm_embed(x)
        t, hh, ww = thw
        return x[:, 1:].reshape(b, t, hh, ww, x.shape[-1])
