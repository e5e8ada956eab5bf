"""Pre-LN ViT encoder block (timm ``vit_base_patch32_224`` layout): the
port of ``shgvqa_tpu/models/vit.py``.

``--vitInit`` makes the visual stream's r-layers these blocks, loadable
from a timm ViT-B/32 checkpoint (``utils/torch_import.vit_to_r_layers``,
``Trainer.load_vit_layers``), and calls them without an attention mask, as
the reference does:

    x = x + proj(attn(norm1(x)));  x = x + fc2(gelu(fc1(norm2(x))))

LayerNorm eps 1e-6, one fused qkv product, scores in the compute dtype
scaled by ``head_dim ** -0.5``, an f32 softmax cast back, the exact-erf
GeLU, xavier-uniform weights.  No mask, no dropout and the plain attention:
the JAX block runs no Pallas kernel, so no kernel switch reaches it.
The dense layers are plain flax ``nn.Dense`` there (no ``Dense_0`` level;
``convert.py`` knows them by their place under ``r_{i}``).  Tensor
parallelism (``tp``) splits the MLP as JAX's rules do: ``fc1`` over
columns, ``fc2`` over rows (``layers.row_split``); ``qkv`` and ``proj``
stay whole.
"""

from __future__ import annotations

import torch
from torch import nn

from shgvqa_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    copy_to_model,
    gelu,
    row_split,
)


class ViTBlock(nn.Module):
    """timm ``vision_transformer.Block`` with ``BertLayer``'s call
    signature: ``forward(x, mask=None, g=None, return_probs=False)``; the
    mask and the generator are accepted and ignored."""

    TP_SPLITS = {"fc1.weight": (0, 1), "fc1.bias": (0, 1),
                 "fc2.weight": (1, 1)}

    def __init__(self, hidden_size: int, num_heads: int = 12,
                 head_dim: int = 64, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = num_heads * head_dim
        self.norm1 = LayerNorm(hidden_size, eps=1e-6, dtype=dtype)
        self.qkv = Dense(hidden_size, 3 * d, dtype, init="xavier")
        self.proj = Dense(d, hidden_size, dtype, init="xavier")
        self.norm2 = LayerNorm(hidden_size, eps=1e-6, dtype=dtype)
        self.fc1 = Dense(hidden_size, mlp_ratio * d, dtype, init="xavier")
        self.fc2 = Dense(mlp_ratio * d, hidden_size, dtype, init="xavier")
        self.num_heads, self.head_dim = num_heads, head_dim
        self.dtype = dtype
        self.tp = None

    def forward(self, x, mask=None, g=None, return_probs: bool = False):
        b, l, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        qkv = self.qkv(self.norm1(x)).reshape(b, l, 3, h, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scores = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, h * hd)
        x = x + self.proj(ctx)
        if self.tp is None:
            x = x + self.fc2(gelu(self.fc1(self.norm2(x))))
        else:
            x = x + row_split(self.fc2, gelu(self.fc1(copy_to_model(
                self.norm2(x)))))
        return (x, probs) if return_probs else x
