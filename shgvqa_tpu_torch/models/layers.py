"""Core transformer building blocks: the port of ``shgvqa_tpu/models/layers.py``.

Training mode (``module.train()``) adds every dropout site of the JAX
blocks, each a ``Dropout`` module drawing its mask from the
``torch.Generator`` the caller passes down the forward (``g``); in eval
mode nothing is dropped.

Semantics kept from the JAX package:
- parameters are f32 and every block computes in its ``dtype`` (the
  config's ``compute_dtype``): inputs, weights and biases are cast to it
  before each product, as flax's ``Dense(dtype=...)`` does;
- GeLU is the exact erf form computed in f32; LayerNorm runs in f32 (eps
  1e-12) and returns ``dtype``;
- attention scores and softmax are f32 with an ADDITIVE mask (-10000 on
  masked slots, built by ``extend_mask`` in the compute dtype);
- ``FFN`` runs the fused inference kernel (``kernels/ffn.py``
  ``fused_ffn``) when enabled and not training, the fused train kernels
  (``fused_ffn_train``, dropout inside) when training with
  ``train_kernel`` (the config's ``use_pallas_ffn_train``), else the
  unfused block;
- ``Attention`` runs the fused attention kernels (``kernels/attention.py``,
  with the probabilities' dropout inside) when training with
  ``kernel_train`` (the config's ``use_pallas_attention_train``) and, with
  ``kernel_eval`` (``use_pallas_attention``, ``--pallasAttention``), the
  forward kernel at rate 0 outside training too, as the JAX ``Attention``
  does; otherwise the plain path (``attend``), which drops the
  probabilities after their cast to the compute dtype.  With
  ``return_probs`` (the attention dumps, ``--outputAttn``) every site takes
  the plain path whatever the switches say, since the kernels return no
  probabilities, and gives (output, probabilities in the compute dtype),
  as the JAX ``Attention(return_probs=True)`` does; ``SelfAttLayer``,
  ``CrossAttLayer`` and ``BertLayer`` pass them on.  A dumps forward runs
  under ``plain_attention()``, so the sites that return no probabilities
  (the decoders') take the plain path too;
- two switches the JAX package wires into no model, off by default and
  read outside training only: ``set_headsliced_kernel`` sends every
  attention site's projections as they are, (B, L, H*D), to
  ``kernels/headsliced.py``'s kernel (no transposes); ``set_out_ln_kernel``
  runs every ``AttOutput`` as one call of ``kernels/ffn.py``'s
  ``fused_out_ln`` (its f32 bias and unrounded product are a departure
  from the plain block's compute-dtype ``dense``);
- embedding lookups have torch ``padding_idx=0`` semantics: row 0 gets no
  gradient (the JAX ``Embed`` stop_gradient).

Tensor parallelism (``parallel/mesh.shard_model_`` sets ``tp`` = (model
index, mp) on the modules it splits; each names its split tensors in
``TP_SPLITS``, torch dim and parts):
- ``Attention``: ``copy_to_model`` of its inputs, q, k, v over this rank's
  H / mp heads (their biases shards too), the core on those heads (the
  kernels' dropout counter and the plain path's mask are the one-process
  mask's heads), then ``gather_from_model`` of the context before
  ``AttOutput``, which stays whole as JAX's rules leave it;
- ``FFN``: ``copy_to_model``, ``intermediate`` over F / mp columns, GeLU,
  ``output`` over those rows, the partial summed over the model group
  (``reduce_from_model``, in f32), then b2 once, dropout, the residual and
  LN; with a kernel switch on, ``kernels/ffn.fused_ffn_split``;
- ``MLPHead``: ``fc1`` over columns, GeLU, the LayerNorm over the split
  hidden (its statistics summed over the model group, two-pass, its affine
  shards), ``fc2`` over rows, the reduce, then the bias.
A row-split product (``row_split``) adds its bias after the reduce: with
the bias on every rank's partial it would be counted mp times.

Parameter names follow the flax names with ``kernel``/``scale``/
``embedding`` renamed to ``weight`` (``convert.py`` maps one onto the other).
Parameters are allocated empty; ``init_weights`` fills a whole model from
one seeded ``torch.Generator`` on the model's device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from shgvqa_tpu_torch.kernels.attention import fused_attention
from shgvqa_tpu_torch.kernels.ffn import (
    fused_ffn,
    fused_ffn_split,
    fused_ffn_train,
    fused_out_ln,
)
from shgvqa_tpu_torch.kernels.headsliced import headsliced_attention
from shgvqa_tpu_torch.models.remat import replayable
from shgvqa_tpu_torch.parallel.distributed import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    sum_over_model,
)
from shgvqa_tpu_torch.parallel.mesh import global_rows

NEG_MASK = -10000.0
BERT_STD = 0.02


class Dropout(nn.Module):
    """flax ``nn.Dropout`` in training mode: keep each element with
    probability 1 - rate, scale kept ones by 1 / (1 - rate); the mask comes
    from the generator ``g`` (the device's default one when None).  In a
    data-parallel run the draw is the global batch's and the rank keeps its
    rows of it (``parallel/mesh.global_rows``); ``split`` = (dim, start,
    size) says that ``x`` holds entries start .. of ``size`` along ``dim``
    (a tensor-parallel rank's heads or columns), and the rank keeps those
    of the whole draw.  Under remat the recompute reads the forward's mask
    back (``models/remat.replayable``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, g: Optional[torch.Generator] = None,
                split: Optional[Sequence[int]] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        first, total = global_rows(x.shape[0])
        shape = [total] + list(x.shape[1:])
        index = [slice(first, first + x.shape[0])]
        if split is not None:
            dim, start, size = split
            dim %= x.dim()
            shape[dim] = size
            index += [slice(None)] * (dim - 1) + [
                slice(start, start + x.shape[dim])]
        keep = replayable(lambda: torch.rand(
            shape, generator=g, device=x.device)[tuple(index)] >= self.rate)
        return torch.where(keep, x / (1.0 - self.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_rate(model: nn.Module, rate: float) -> None:
    """Set the rate of every dropout site of ``model``, the attention
    probabilities' included."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = rate


def set_attention_kernel(model: nn.Module, on: bool) -> None:
    """Route every training attention site of ``model`` through the fused
    kernels (on) or the plain path (off)."""
    for m in model.modules():
        if hasattr(m, "kernel_train"):
            m.kernel_train = on


def set_attention_kernel_eval(model: nn.Module, on: bool) -> None:
    """Route every attention site of ``model`` outside training through the
    fused forward kernel at rate 0 (on; ``--pallasAttention``) or the plain
    path (off)."""
    for m in model.modules():
        if hasattr(m, "kernel_eval"):
            m.kernel_eval = on


def set_headsliced_kernel(model: nn.Module, on: bool) -> None:
    """Route every attention site of ``model`` outside training through the
    head-sliced kernel on the (B, L, H*D) projections (on) or the path the
    other switches choose (off)."""
    for m in model.modules():
        if hasattr(m, "headsliced"):
            m.headsliced = on


def set_out_ln_kernel(model: nn.Module, on: bool) -> None:
    """Route every ``AttOutput`` of ``model`` outside training through
    ``fused_out_ln`` (on) or the unfused block (off)."""
    for m in model.modules():
        if isinstance(m, AttOutput):
            m.use_kernel = on


def set_ffn_train_kernel(model: nn.Module, on: bool) -> None:
    """Route every FFN block of ``model`` in training through the fused
    train kernels (on) or the unfused block (off)."""
    for m in model.modules():
        if isinstance(m, FFN):
            m.train_kernel = on


def empty_param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


def trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator):
    """Normal(0, std) truncated to +-2 std (inverse CDF), as flax's
    ``truncated_normal``."""
    bound = math.erf(math.sqrt(2.0))
    t.uniform_(-bound, bound, generator=g).erfinv_().mul_(std * math.sqrt(2.0))


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize every parameter and buffer of ``model`` from one seeded
    generator on the model's device (the CPU's for a model on the CPU; on
    a card its own generator, so one seed draws other values there), module
    by module in registration order: normal(0.02) for dense layers and
    embeddings, xavier-uniform for packed ``in_proj``, he-normal for the
    trunk's convs, zeros for biases and CLS tokens, ones/zeros for norms,
    (0, 1, 1, 0) for frozen BatchNorm."""
    first = next(model.parameters(), None)
    g = torch.Generator(device=first.device if first is not None
                        else "cpu").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "init_params"):
                m.init_params(g)
    return model


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GeLU computed in f32, returned in x's dtype."""
    x32 = x.float()
    return (x32 * 0.5 * (1.0 + torch.erf(x32 * 0.7071067811865476))).to(x.dtype)


def extend_mask(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """{0,1} (B, L) -> additive (B, 1, 1, L) with -10000 on masked slots,
    built in ``dtype``."""
    m = mask.to(dtype)
    return ((1.0 - m) * NEG_MASK)[:, None, None, :]


def attend(q, k, v, mask, dtype, drop: Optional[Dropout] = None, g=None,
           return_probs: bool = False, heads=None):
    """Heads-first attention core, (B, H, Lq, hd) over (B, H, Lk, hd): f32
    scores scaled by 1/sqrt(hd), the additive mask added in f32, f32
    softmax, probabilities cast to ``dtype`` (then dropped by ``drop``; with
    ``heads`` = (head0, Hg) by those heads of an Hg-head mask) for the
    product with v.  With ``return_probs`` also the probabilities before
    dropout, (B, H, Lq, Lk)."""
    scores = torch.matmul(q, k.transpose(-1, -2)).float()
    scores = scores / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(dtype)
    if drop is None:
        dropped = probs
    else:
        dropped = drop(probs, g) if heads is None else drop(probs, g,
                                                            (1, *heads))
    out = torch.matmul(dropped, v)
    return (out, probs) if return_probs else out


_PLAIN = [0]


@contextlib.contextmanager
def plain_attention():
    """Every attention site inside takes the plain path, whatever its
    switches say (the attention dumps' forward)."""
    _PLAIN[0] += 1
    try:
        yield
    finally:
        _PLAIN[0] -= 1


def kernels_allowed() -> bool:
    """False inside ``plain_attention()``."""
    return not _PLAIN[0]


def attention_core(q, k, v, mask, dtype, drop: Dropout, kernel_train: bool,
                   g=None, kernel_eval: bool = False,
                   return_probs: bool = False, heads=None):
    """The attention core of a site: the fused kernels in training with
    ``kernel_train``, the fused forward at rate 0 outside training with
    ``kernel_eval``, else ``attend``.  Returns (B, H, Lq, hd); with
    ``return_probs`` always ``attend``'s (output, probabilities).
    ``heads`` = (head0, Hg): a tensor-parallel rank's heads of Hg."""
    if return_probs or not kernels_allowed():
        return attend(q, k, v, mask, dtype, drop, g, return_probs, heads)
    kw = {} if heads is None else {"heads": heads}
    if drop.training and kernel_train:
        return fused_attention(q, k, v, mask, drop.rate, g, **kw)
    if not drop.training and kernel_eval:
        return fused_attention(q, k, v, mask, 0.0, **kw)
    return attend(q, k, v, mask, dtype, drop, g, heads=heads)


def row_split(dense: "Dense", x: torch.Tensor) -> torch.Tensor:
    """``dense`` (its weight this rank's rows of W, its bias whole) on
    ``x``: the partial product summed over the model group in f32, then
    the bias once, in ``dense``'s dtype."""
    dt = dense.dtype
    y = reduce_from_model(F.linear(x.to(dt), dense.weight.to(dt)).float())
    if dense.bias is not None:
        y = y + dense.bias.float()
    return y.to(dt)


def split_layer_norm(ln: "LayerNorm", x: torch.Tensor,
                     count: int) -> torch.Tensor:
    """``ln`` over a last dim split ``count`` ways over the model group (x
    and ln's affine this rank's shards): two-pass in f32, the row sums
    summed over the model group; returns ``ln.dtype``."""
    x32 = x.float()
    n = x.shape[-1] * count
    mean = sum_over_model(x32.sum(-1, keepdim=True)) / n
    dev = x32 - mean
    var = sum_over_model(dev.square().sum(-1, keepdim=True)) / n
    y = dev * torch.rsqrt(var + ln.eps) * ln.weight + ln.bias
    return y.to(ln.dtype)


def tp_inputs(*xs):
    """``copy_to_model`` of each distinct tensor of ``xs`` (one collective
    backward for a tensor passed twice), in order."""
    seen = {}
    return [seen.setdefault(id(x), copy_to_model(x)) for x in xs]


class Dense(nn.Module):
    """y = x W^T + b in the compute dtype; weight (out, in) f32.

    ``init`` is 'normal' (normal(0.02), the BERT init) or 'xavier';
    ``bias=False`` drops b (Swin's patch-merging reduction)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, init: str = "normal",
                 bias: bool = True):
        super().__init__()
        self.weight = empty_param(out_features, in_features)
        self.bias = empty_param(out_features) if bias else None
        self.dtype = dtype
        self.init = init

    def init_params(self, g):
        if self.init == "xavier":
            fan_out, fan_in = self.weight.shape
            a = math.sqrt(6.0 / (fan_in + fan_out))
            self.weight.uniform_(-a, a, generator=g)
        else:
            self.weight.normal_(0.0, BERT_STD, generator=g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """LayerNorm in f32, output in ``dtype``."""

    def __init__(self, features: int, eps: float = 1e-12,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = empty_param(features)
        self.bias = empty_param(features)
        self.eps = eps
        self.dtype = dtype

    def init_params(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.dtype)


class Embed(nn.Module):
    """Embedding table; ``forward(None)`` reads the whole table (the HG
    queries).  ``zero_init_pad`` zeroes row 0 at init (torch
    ``padding_idx=0`` tables left at their construction init)."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 zero_init_pad: bool = False):
        super().__init__()
        self.weight = empty_param(num_embeddings, features)
        self.dtype = dtype
        self.zero_init_pad = zero_init_pad

    def init_params(self, g):
        self.weight.normal_(0.0, BERT_STD, generator=g)
        if self.zero_init_pad:
            self.weight[0].zero_()

    def forward(self, ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``ids`` -> rows (row 0 gets no gradient); None -> the whole table
        (every row trains, as a direct read of a torch table does)."""
        table = self.weight.to(self.dtype)
        return table if ids is None else F.embedding(ids, table,
                                                     padding_idx=0)


class Conv3d(nn.Module):
    """NCDHW 3-D convolution in the compute dtype; weight (O, I, kT, kH, kW).

    ``init`` is 'normal' (normal(0.02), the tokenizer) or 'he_normal'
    (the trunk)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: Sequence[int] = (1, 1, 1),
                 padding: Sequence[int] = (0, 0, 0), bias: bool = True,
                 dtype: torch.dtype = torch.float32, init: str = "normal"):
        super().__init__()
        self.weight = empty_param(out_ch, in_ch, *kernel)
        self.bias = empty_param(out_ch) if bias else None
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.dtype = dtype
        self.init = init

    def init_params(self, g):
        if self.init == "he_normal":
            fan_in = self.weight[0].numel()
            trunc_normal_(self.weight,
                          math.sqrt(2.0 / fan_in) / .87962566103423978, g)
        else:
            self.weight.normal_(0.0, BERT_STD, generator=g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv3d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding)


class Conv2d(Conv3d):
    """NCHW 2-D convolution in the compute dtype (ResNeXt's per-frame
    trunk); weight (O, I / groups, kH, kW)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: Sequence[int] = (1, 1),
                 padding: Sequence[int] = (0, 0), bias: bool = True,
                 dtype: torch.dtype = torch.float32, init: str = "normal",
                 groups: int = 1):
        super().__init__(in_ch // groups, out_ch, kernel, stride, padding,
                         bias, dtype, init)
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, groups=self.groups)


class Attention(nn.Module):
    """Multi-head attention of ``hidden`` over ``context`` (BertAttention):
    separate q/k/v dense layers, f32 scores and softmax, additive mask,
    dropout on the probabilities in training.  ``kernel_train``,
    ``kernel_eval`` and ``headsliced`` choose the kernels (module
    docstring)."""

    TP_SPLITS = {f"{n}.{leaf}": (0, 1) for n in ("query", "key", "value")
                 for leaf in ("weight", "bias")}
    TP_HEADS = True

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 kernel_train: bool = False):
        super().__init__()
        all_head = num_heads * head_dim
        self.query = Dense(hidden_size, all_head, dtype)
        self.key = Dense(hidden_size, all_head, dtype)
        self.value = Dense(hidden_size, all_head, dtype)
        self.probs_dropout = Dropout(dropout)
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.kernel_train = kernel_train
        self.kernel_eval = False
        self.headsliced = False
        self.tp = None

    def forward(self, hidden, context, mask=None, g=None,
                return_probs: bool = False):
        """(B, Lq, H*hd); with ``return_probs`` (output, probabilities
        (B, H, Lq, Lk)) from the plain path."""
        b, lq, _ = hidden.shape
        lk = context.shape[1]
        h, hd = self.num_heads, self.head_dim
        heads = None
        if self.tp is not None:
            index, count = self.tp
            h //= count
            heads = (index * h, self.num_heads)
            hidden, context = tp_inputs(hidden, context)
        q, k, v = (self.query(hidden), self.key(context),
                   self.value(context))
        if (self.headsliced and not self.training and not return_probs
                and kernels_allowed()):
            return gather_from_model(headsliced_attention(q, k, v, mask, h))
        out = attention_core(q.view(b, lq, h, hd).transpose(1, 2),
                             k.view(b, lk, h, hd).transpose(1, 2),
                             v.view(b, lk, h, hd).transpose(1, 2), mask,
                             self.dtype, self.probs_dropout,
                             self.kernel_train, g, self.kernel_eval,
                             return_probs, heads)
        if return_probs:
            out, probs = out
            probs = gather_from_model(probs.movedim(1, -1)).movedim(-1, 1)
            return gather_from_model(
                out.transpose(1, 2).reshape(b, lq, h * hd)), probs
        return gather_from_model(out.transpose(1, 2).reshape(b, lq, h * hd))


class AttOutput(nn.Module):
    """dense -> dropout -> LN(+ residual) (BertAttOutput).

    With ``use_kernel`` (``set_out_ln_kernel``; off by default, as the JAX
    package wires its kernel into no model) and not training, the block is
    one call of ``kernels.ffn.fused_out_ln`` on the ``nn.Linear`` weights
    as they are."""

    def __init__(self, hidden_size: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size, dtype)
        self.dropout = Dropout(dropout)
        self.ln = LayerNorm(hidden_size, dtype=dtype)
        self.use_kernel = False

    def forward(self, hidden, residual, g=None):
        if self.use_kernel and not self.training:
            return fused_out_ln(hidden.to(self.dense.dtype), self.dense.weight,
                                self.dense.bias, residual, self.ln.weight,
                                self.ln.bias, self.ln.eps)
        return self.ln(self.dropout(self.dense(hidden), g) + residual)


class SelfAttLayer(nn.Module):
    """Self-attention + residual output (BertSelfattLayer)."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, attn_dropout: float = 0.1,
                 hidden_dropout: float = 0.1, kernel_train: bool = False):
        super().__init__()
        self.self = Attention(hidden_size, num_heads, head_dim, dtype,
                              attn_dropout, kernel_train)
        self.output = AttOutput(hidden_size, dtype, hidden_dropout)

    def forward(self, x, mask=None, g=None, return_probs: bool = False):
        if return_probs:
            out, probs = self.self(x, x, mask, g, True)
            return self.output(out, x, g), probs
        return self.output(self.self(x, x, mask, g), x, g)


class CrossAttLayer(nn.Module):
    """Cross-attention + residual output (BertCrossattLayer)."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, attn_dropout: float = 0.1,
                 hidden_dropout: float = 0.1, kernel_train: bool = False):
        super().__init__()
        self.att = Attention(hidden_size, num_heads, head_dim, dtype,
                             attn_dropout, kernel_train)
        self.output = AttOutput(hidden_size, dtype, hidden_dropout)

    def forward(self, x, context, ctx_mask=None, g=None,
                return_probs: bool = False):
        if return_probs:
            out, probs = self.att(x, context, ctx_mask, g, True)
            return self.output(out, x, g), probs
        return self.output(self.att(x, context, ctx_mask, g), x, g)


class FFN(nn.Module):
    """intermediate (GeLU) -> output dense -> dropout -> LN(+ residual).

    With ``use_kernel`` (the config's ``use_pallas_ffn``) and not training,
    the whole block is one call of ``kernels.ffn.fused_ffn``; in training
    with ``train_kernel`` (``use_pallas_ffn_train``, off by default as in
    JAX) it is one call of ``fused_ffn_train`` at the block's dropout rate.
    Both get the ``nn.Linear`` weights as they are.  Otherwise the block
    runs unfused.  Split (``tp``), each path runs on F / mp columns, the
    kernels through ``fused_ffn_split``."""

    TP_SPLITS = {"intermediate.weight": (0, 1), "intermediate.bias": (0, 1),
                 "output.weight": (1, 1)}

    def __init__(self, hidden_size: int, intermediate_size: int,
                 dtype: torch.dtype = torch.float32, use_kernel: bool = False,
                 dropout: float = 0.1):
        super().__init__()
        self.intermediate = Dense(hidden_size, intermediate_size, dtype)
        self.output = Dense(intermediate_size, hidden_size, dtype)
        self.dropout = Dropout(dropout)
        self.ln = LayerNorm(hidden_size, dtype=dtype)
        self.use_kernel = use_kernel
        self.train_kernel = False
        self.tp = None

    def forward(self, x, g=None):
        weights = (self.intermediate.weight, self.intermediate.bias,
                   self.output.weight, self.output.bias, self.ln.weight,
                   self.ln.bias)
        if self.tp is not None:
            return self._split_forward(x, weights, g)
        if self.use_kernel and not self.training:
            return fused_ffn(x, *weights, self.ln.eps)
        if self.train_kernel and self.training:
            return fused_ffn_train(x, *weights, self.dropout.rate, g,
                                   self.ln.eps)
        h = self.output(gelu(self.intermediate(x)))
        return self.ln(self.dropout(h, g) + x)

    def _split_forward(self, x, weights, g):
        if self.use_kernel and not self.training:
            return fused_ffn_split(x, *weights, 0.0, None, self.ln.eps,
                                   "fused_ffn")
        if self.train_kernel and self.training:
            return fused_ffn_split(x, *weights, self.dropout.rate, g,
                                   self.ln.eps)
        h = row_split(self.output, gelu(self.intermediate(copy_to_model(x))))
        return self.ln(self.dropout(h, g) + x)


class BertLayer(nn.Module):
    """Self-attention block + FFN block (BertLayer)."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 intermediate_size: int, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False, attn_dropout: float = 0.1,
                 hidden_dropout: float = 0.1, kernel_train: bool = False):
        super().__init__()
        self.attention = SelfAttLayer(hidden_size, num_heads, head_dim, dtype,
                                      attn_dropout, hidden_dropout,
                                      kernel_train)
        self.ffn = FFN(hidden_size, intermediate_size, dtype, use_kernel,
                       hidden_dropout)

    def forward(self, x, mask=None, g=None, return_probs: bool = False):
        if return_probs:
            x, probs = self.attention(x, mask, g, True)
            return self.ffn(x, g), probs
        return self.ffn(self.attention(x, mask, g), g)


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LN -> dropout."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 max_position_embeddings: int = 512,
                 type_vocab_size: int = 2,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        self.word_embeddings = Embed(vocab_size, hidden_size, dtype)
        self.position_embeddings = Embed(max_position_embeddings,
                                         hidden_size, dtype)
        self.token_type_embeddings = Embed(type_vocab_size, hidden_size,
                                           dtype)
        self.ln = LayerNorm(hidden_size, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, input_ids, token_type_ids=None, g=None):
        b, l = input_ids.shape
        pos_ids = torch.arange(l, device=input_ids.device).expand(b, l)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.ln(x), g)


class Pooler(nn.Module):
    """CLS -> dense -> tanh (BertPooler)."""

    def __init__(self, hidden_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size, dtype)

    def forward(self, hidden_states):
        return torch.tanh(self.dense(hidden_states[:, 0]))


class Pooler2(nn.Module):
    """concat(CLS_a, CLS_b) -> dense -> tanh (BertPooler2)."""

    def __init__(self, hidden_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense2 = Dense(2 * hidden_size, hidden_size, dtype)

    def forward(self, hidden_a, hidden_b):
        x = torch.cat([hidden_a[:, 0], hidden_b[:, 0]], dim=-1)
        return torch.tanh(self.dense2(x))


class MLPHead(nn.Module):
    """Linear -> GeLU -> LN -> Linear (logit_fc / class_embed /
    action_embed).  Split (``tp``): ``fc1`` over columns, the LN over the
    split hidden (``split_layer_norm``), ``fc2`` over rows."""

    TP_SPLITS = {"fc1.weight": (0, 1), "fc1.bias": (0, 1),
                 "ln.weight": (0, 1), "ln.bias": (0, 1),
                 "fc2.weight": (1, 1)}

    def __init__(self, in_dim: int, out_dim: int, hidden_mult: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_dim, in_dim * hidden_mult, dtype)
        self.ln = LayerNorm(in_dim * hidden_mult, dtype=dtype)
        self.fc2 = Dense(in_dim * hidden_mult, out_dim, dtype)
        self.tp = None

    def forward(self, x):
        if self.tp is None:
            return self.fc2(self.ln(gelu(self.fc1(x))))
        h = split_layer_norm(self.ln, gelu(self.fc1(copy_to_model(x))),
                             self.tp[1])
        return row_split(self.fc2, h)
