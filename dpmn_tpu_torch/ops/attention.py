"""Multi-head attention with torch.nn.MultiheadAttention's weight layout.

Counterpart of dpmn_tpu/ops/attention.py: packed in_proj (3E, E) and bias,
an out_proj Linear, scaled dot-product and head-averaged weights.
Batch-first (B, L, E).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, need_weights: bool = True):
        """(B, Lq, E), (B, Lk, E), (B, Lk, E) → (out (B, Lq, E), weights (B, Lq, Lk)),
        the head-averaged weights None without `need_weights`."""
        e, h = self.embed_dim, self.num_heads
        dk = e // h
        w, b = self.in_proj_weight, self.in_proj_bias
        q = query @ w[:e].T + b[:e]
        k = key @ w[e : 2 * e].T + b[e : 2 * e]
        v = value @ w[2 * e :].T + b[2 * e :]

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], h, dk).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
        scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(dk)
        attn = torch.softmax(scores, dim=-1)
        out = (attn @ vh).transpose(1, 2).reshape(query.shape[0], -1, e)
        return self.out_proj(out), attn.mean(dim=1) if need_weights else None
