"""Matrix-capsule visual tokenizer with EM routing: the port of
``shgvqa_tpu/models/capsules.py`` (the path without ``--noCaps``).

- ``PrimaryCaps``: two dense layers turn each position's features into
  ``num_caps`` P x P pose matrices and activations; the sigmoid of the
  activations is taken in f32, then cast to the compute dtype.
- ``EMRouting``: C_in capsules -> C_out capsules per position.  The votes
  V_ij = pose_i @ W_ij and every step of the routing run in f32, whatever
  the compute dtype; mu and the activations are cast back at the end.
  ``variant='hinton'`` (the default) is the matrix-capsule procedure with
  the scheduled lambda ``final_lambda * (1 - 0.95 ** (it + 1))``, eps 1e-8
  and no e-step after the last m-step; ``variant='reference'`` is
  ``_em_routing_reference``, the reference's own math with its quirks
  (r normalized over the outputs, then over the inputs; beta_u per
  (C_out, P*P); a fixed lambda of 1e-6; a cost "stdv" that is
  identically sqrt(eps)).  Neither has data-dependent control flow, so a
  CUDA graph captures them.
- ``CapsuleVisualTokenizer``: ``visn_fc`` -> primary caps -> EM routing ->
  tokens ``[mu || a_out]`` of width ``num_vis_caps * (P*P + 1)`` (544 at
  the reference's 32 capsules of 4 x 4), a zero-init CLS token, a learned
  position table of ``seq_length`` rows (1 + T*H*W: every trunk frame is
  kept, 785 tokens at 16 x 7 x 7) and dropout.
- ``LanguageCapsuleMask``: a softmax over the capsule types from the
  language CLS scales each capsule's (pose, activation) unit of every
  visual token but the CLS; with ``skip_connection`` the unmasked tokens
  are added back.

EM routing is plain PyTorch here, as it is plain einsums in the JAX
package: no Pallas kernel computes it.  Its votes are (N, C_in, C_out, P*P)
f32 with N = B*T*H*W positions (411 MB at B=8 and the reference's
shapes), and autograd keeps several such tensors per iteration.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from shgvqa_tpu_torch.models.layers import (
    BERT_STD,
    Dense,
    Dropout,
    empty_param,
)


class PrimaryCaps(nn.Module):
    """Per-position primary capsules: poses (..., num_caps, P*P) in the
    compute dtype, activations (..., num_caps) in [0, 1]."""

    def __init__(self, in_features: int, num_caps: int, pose_dim: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pose = Dense(in_features, num_caps * pose_dim * pose_dim, dtype)
        self.act = Dense(in_features, num_caps, dtype)
        self.num_caps = num_caps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        lead = x.shape[:-1]
        poses = self.pose(x)
        act = torch.sigmoid(self.act(x).float()).to(self.dtype)
        return poses.reshape(*lead, self.num_caps, -1), act


class EMRouting(nn.Module):
    """C_in capsules -> C_out capsules per position by EM routing
    (``variant`` 'hinton' or 'reference', see the module docstring)."""

    def __init__(self, c_in: int, c_out: int, pose_dim: int = 4,
                 iters: int = 3, eps: float = 1e-8,
                 final_lambda: float = 1e-2, variant: str = "hinton",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in ("hinton", "reference"):
            raise ValueError(f"unknown EM routing variant {variant!r}")
        p = pose_dim
        self.w = empty_param(c_in, c_out, p, p)
        self.beta_u = empty_param(*((c_out, p * p) if variant == "reference"
                                    else (c_out,)))
        self.beta_a = empty_param(c_out)
        self.c_out, self.pose_dim, self.iters = c_out, pose_dim, iters
        self.eps, self.final_lambda = eps, final_lambda
        self.variant = variant
        self.dtype = dtype

    def init_params(self, g):
        self.w.normal_(0.0, BERT_STD, generator=g)
        self.beta_u.zero_()
        self.beta_a.zero_()

    def votes(self, poses: torch.Tensor) -> torch.Tensor:
        """poses (N, C_in, P*P) -> f32 votes (N, C_in, C_out, P*P): each
        pose matrix times its transform matrices."""
        n, c_in, p2 = poses.shape
        p = self.pose_dim
        pm = poses.reshape(n, c_in, p, p).float()
        votes = torch.einsum("nipq,ijqr->nijpr", pm, self.w.float())
        return votes.reshape(n, c_in, self.c_out, p2)

    def forward(self, poses: torch.Tensor, acts: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """poses (N, C_in, P*P), acts (N, C_in) -> mu (N, C_out, P*P),
        a_out (N, C_out), both in the compute dtype."""
        votes = self.votes(poses)
        if self.variant == "reference":
            mu, a_out = _em_routing_reference(
                votes, acts.float(), self.beta_u, self.beta_a,
                iters=self.iters, eps=self.eps)
            return mu.to(self.dtype), a_out.to(self.dtype)
        n, c_in, _, _ = votes.shape
        eps = self.eps
        a_in = acts.float()[:, :, None]                      # (N, C_in, 1)
        r = torch.full((n, c_in, self.c_out), 1.0 / self.c_out,
                       device=votes.device)
        for it in range(self.iters):
            lam = self.final_lambda * (1.0 - 0.95 ** (it + 1))
            # m-step
            rw = r * a_in                                    # (N, C_in, C_out)
            denom = (rw.sum(dim=1, keepdim=True) + eps).transpose(1, 2)
            mu = torch.einsum("nij,nijh->njh", rw, votes) / denom
            diff2 = (votes - mu[:, None]) ** 2
            sigma2 = torch.einsum("nij,nijh->njh", rw, diff2) / denom + eps
            cost = (self.beta_u[None, :, None] + 0.5 * torch.log(sigma2)) \
                * denom
            a_out = torch.sigmoid(lam * (self.beta_a[None]
                                         - cost.sum(dim=-1)))
            # e-step (none after the last m-step)
            if it < self.iters - 1:
                log_p = -0.5 * (torch.log(2 * math.pi * sigma2[:, None])
                                + diff2 / sigma2[:, None]).sum(dim=-1)
                log_ra = torch.log(a_out[:, None] + eps) + log_p
                r = torch.softmax(log_ra, dim=-1)
        return mu.to(self.dtype), a_out.to(self.dtype)


def _em_routing_reference(votes, a_in, beta_u, beta_a, iters=3, eps=1e-8,
                          lam=1e-6):
    """The reference's ``ConvCaps.caps_em_routing`` with its quirks (the
    JAX ``_em_routing_reference``): votes (N, B, C, P*P), a_in (N, B) f32
    -> mu (N, C, P*P), a_out (N, C)."""
    n, b_in, c, p2 = votes.shape
    ln_2pi = math.log(2 * math.pi)
    r = torch.full((n, b_in, c), 1.0 / c, device=votes.device)
    a3 = a_in[:, :, None]
    for it in range(iters):
        rw = r * a3
        rw = rw / (rw.sum(dim=2, keepdim=True) + eps)
        r_sum = rw.sum(dim=1, keepdim=True)                  # (N, 1, C)
        coeff = (rw / (r_sum + eps))[..., None]              # (N, B, C, 1)
        mu = (coeff * votes).sum(dim=1, keepdim=True)        # (N, 1, C, P*P)
        sigma_sq = (coeff * (votes - mu) ** 2).sum(dim=1, keepdim=True) + eps
        cost_h = (beta_u[None] + torch.log(torch.sqrt(
            sigma_sq.reshape(n, c, p2)))) * r_sum.reshape(n, c, 1)
        cost_h = cost_h.sum(dim=2)                           # (N, C)
        cost_mean = cost_h.mean(dim=1, keepdim=True)
        cost_stdv = torch.sqrt(
            (cost_h - cost_mean).sum(dim=1, keepdim=True) ** 2 / c + eps)
        a_out = torch.sigmoid(
            lam * (beta_a[None] - (cost_mean - cost_h) / (cost_stdv + eps)))
        if it < iters - 1:
            ln_p = (-((votes - mu) ** 2) / (2 * sigma_sq)
                    - torch.log(torch.sqrt(sigma_sq)) - 0.5 * ln_2pi)
            ln_ap = ln_p.sum(dim=3) + torch.log(eps + a_out[:, None, :])
            r = torch.softmax(ln_ap, dim=2)
    return mu.reshape(n, c, p2), a_out


class CapsuleVisualTokenizer(nn.Module):
    """Trunk features (B, T, H, W, C) -> (B, 1 + T*H*W, caps_dim) capsule
    tokens with the CLS token and learned positions (``seq_length`` must
    be 1 + T*H*W); dropout in training."""

    def __init__(self, feat_dim: int, hidden_size: int, seq_length: int,
                 num_prim_caps: int = 32, num_vis_caps: int = 32,
                 pose_dim: int = 4, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.caps_dim = num_vis_caps * (pose_dim * pose_dim + 1)
        self.visn_fc = Dense(feat_dim, hidden_size, dtype)
        self.primary_caps = PrimaryCaps(hidden_size, num_prim_caps, pose_dim,
                                        dtype)
        self.conv_caps = EMRouting(num_prim_caps, num_vis_caps, pose_dim,
                                   dtype=dtype)
        self.cls_token = empty_param(1, 1, self.caps_dim)
        self.pos_embedding = empty_param(seq_length, self.caps_dim)
        self.dropout = Dropout(dropout)
        self.num_prim_caps, self.num_vis_caps = num_prim_caps, num_vis_caps
        self.dtype = dtype

    def init_params(self, g):
        self.cls_token.zero_()
        self.pos_embedding.normal_(0.0, BERT_STD, generator=g)

    def forward(self, feats: torch.Tensor, g=None) -> torch.Tensor:
        b, t, h, w, _ = feats.shape
        n = b * t * h * w
        x = self.visn_fc(feats.to(self.dtype))
        poses, acts = self.primary_caps(x)
        mu, a_out = self.conv_caps(poses.reshape(n, self.num_prim_caps, -1),
                                   acts.reshape(n, self.num_prim_caps))
        tokens = torch.cat([mu.reshape(n, -1), a_out.reshape(n, -1)],
                           dim=-1).reshape(b, t * h * w, self.caps_dim)
        cls = self.cls_token.to(self.dtype).expand(b, 1, self.caps_dim)
        x = torch.cat([cls, tokens], dim=1)
        return self.dropout(x + self.pos_embedding.to(self.dtype)[None], g)


class LanguageCapsuleMask(nn.Module):
    """Capsule tokens (B, L, C*(P*P+1)) scaled per capsule type by a
    softmax (f32, then the compute dtype) of ``mask_capsules`` on the
    language CLS (B, D); the CLS token (index 0) is kept as it is."""

    def __init__(self, hidden_size: int, num_vis_caps: int,
                 skip_connection: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_capsules = Dense(hidden_size, num_vis_caps, dtype)
        self.num_vis_caps = num_vis_caps
        self.skip_connection = skip_connection
        self.dtype = dtype

    def forward(self, caps_tokens: torch.Tensor, lang_cls: torch.Tensor
                ) -> torch.Tensor:
        b, l, caps_dim = caps_tokens.shape
        c = self.num_vis_caps
        mask = torch.softmax(self.mask_capsules(lang_cls).float(),
                             dim=-1).to(self.dtype)
        body = caps_tokens[:, 1:].reshape(b, l - 1, c, caps_dim // c)
        body = (body * mask[:, None, :, None]).reshape(b, l - 1, caps_dim)
        if self.skip_connection:
            body = body + caps_tokens[:, 1:]
        return torch.cat([caps_tokens[:, :1], body], dim=1)
