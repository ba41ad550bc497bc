"""TATT PSN (TSRN_TL_TRANS), eval: TSRN skeleton + transformer text-prior interpreter.

Counterpart of dpmn_tpu/models/tatt.py (reference model/tatt.py:575-691,
:154-223 and model/transformer_v2.py:154-244), NCHW, without the STN (which
the reference applies in training only).

Faithful quirk: InfoTransformer's `gru_encoding` is a GRU built with
batch_first=True but fed a (W, bs, d_model*H) tensor (transformer_v2.py:
215-221), so its recurrence runs along the *batch* axis — each sample's query
embedding depends on its position in the batch, and on B.  `faithful=True`
reproduces it; `faithful=False` scans along W.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import MultiHeadAttention
from ..ops.gru import BiGRU
from ..ops.torch_compat import LN_EPS
from .tsrn import PSN, RecurrentResidualBlock


def positional_encoding_1d(d_model: int, max_len: int = 5000) -> np.ndarray:
    """(max_len, d_model) sinusoidal code (transformer_v2.py:22-41)."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(0, max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class TransformerEncoderLayer(nn.Module):
    """Post-norm DETR encoder layer (transformer_v2.py:448-520)."""

    def __init__(self, d_model, nhead, dim_feedforward):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos):
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src)[0])
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class TransformerDecoderLayerTP(nn.Module):
    """Cross-attention-only decoder layer (transformer_v2.py:775-869)."""

    def __init__(self, d_model, nhead, dim_feedforward):
        super().__init__()
        self.multihead_attn = MultiHeadAttention(d_model, nhead)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, pos, query_pos):
        attn, weights = self.multihead_attn(tgt + query_pos, memory + pos, memory)
        tgt = self.norm2(tgt + attn)
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt)))), weights


class InfoTransformer(nn.Module):
    """Encoder over the text tokens, decoder over the image tokens."""

    def __init__(self, d_model=64, nhead=4, num_encoder_layers=1, num_decoder_layers=2,
                 dim_feedforward=64, feat_height=16, feat_width=64, faithful=True):
        super().__init__()
        self.h, self.w, self.c, self.faithful = feat_height, feat_width, d_model, faithful
        self.init_factor = nn.Parameter(torch.empty(feat_height * feat_width, d_model))
        hc = feat_height * d_model
        self.gru_encoding = BiGRU(hc, hc // 2)
        self.encoder = nn.ModuleList(
            [TransformerEncoderLayer(d_model, nhead, dim_feedforward) for _ in range(num_encoder_layers)])
        self.decoder = nn.ModuleList(
            [TransformerDecoderLayerTP(d_model, nhead, dim_feedforward) for _ in range(num_decoder_layers)])
        self.decoder_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, tgt, pos_embed):
        """src (B, L, C) text tokens; tgt (B, HW, C) image tokens → (num_dec, B, HW, C)."""
        bs = src.shape[0]
        h, w, c = self.h, self.w, self.c
        qe = self.init_factor.reshape(h, w, c).transpose(0, 1).reshape(w, 1, h * c)
        if self.faithful:
            # recurrence along the batch axis: (sequences=W, time=bs), the
            # same input at every step
            qe_out = self.gru_encoding(qe, steps=bs)  # (W, bs, H*C)
            query_embed = qe_out.reshape(w, bs, h, c).permute(1, 2, 0, 3).reshape(bs, h * w, c)
        else:
            qe_out = self.gru_encoding(qe.transpose(0, 1))[0]  # recurrence along W: (W, H*C)
            query_embed = qe_out.reshape(w, h, c).transpose(0, 1).reshape(1, h * w, c).expand(bs, -1, -1)
        memory = src
        for layer in self.encoder:
            memory = layer(memory, pos_embed)
        out, weights, intermediate = tgt, None, []
        for layer in self.decoder:
            out, weights = layer(out, memory, pos_embed, query_embed)
            intermediate.append(self.decoder_norm(out))
        return torch.stack(intermediate), weights


class TPInterpreter(nn.Module):
    """Text-prior interpreter (tatt.py:154-223)."""

    def __init__(self, t_emb=37, out_text_channels=64, output_size=(16, 64), faithful=True):
        super().__init__()
        d = out_text_channels
        self.fc_in = nn.Linear(t_emb, d)
        self.activation = nn.PReLU()
        self.register_buffer("pe", torch.from_numpy(positional_encoding_1d(d)[:64]), persistent=False)
        self.transformer = InfoTransformer(d_model=d, nhead=4, num_encoder_layers=1, num_decoder_layers=2,
                                           dim_feedforward=d, feat_height=output_size[0],
                                           feat_width=output_size[1], faithful=faithful)

    def forward(self, image_feature, tp_input):
        """image_feature (B, C, H, W); tp_input (B, 37, 1, L) → (B, d, H, W), weights."""
        b, c, h, w = image_feature.shape
        x_im = image_feature.permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.activation(self.fc_in(tp_input[:, :, 0].transpose(1, 2)))  # (B, L, d)
        # the float32 table cast to the activations' dtype (tatt.py:168-171)
        pos = self.pe[None, : x.shape[1]].to(x.dtype).expand(b, -1, -1)
        hs, weights = self.transformer(x, x_im, pos)
        text_prior = hs.mean(0)  # (B, HW, d)
        return text_prior.reshape(b, h, w, -1).permute(0, 3, 1, 2), weights


class TSRN_TL_TRANS(PSN):
    """The --arch tatt PSN (tatt.py:575-691), eval."""

    def __init__(self, scale_factor=2, width=128, height=32, srb_nums=5, mask=True, hidden_units=32,
                 text_emb=37, out_text_channels=64, faithful=True):
        super().__init__()
        ch = self._stem(mask, hidden_units)
        self.infoGen = TPInterpreter(text_emb, out_text_channels, (height // scale_factor, width // scale_factor),
                                     faithful)
        self.srbs = nn.ModuleList([RecurrentResidualBlock(ch, out_text_channels) for _ in range(srb_nums)])
        self._trunk(ch, scale_factor)

    def forward(self, x, text_emb):
        """x (B, 4, h, w) LR image, text_emb (B, 37, 1, L) → (tanh SR (B, 4, 2h, 2w), weights)."""
        b1 = self._head(x)
        tp_map, weights = self.infoGen(b1, text_emb)
        feat = b1
        for srb in self.srbs:
            feat = srb(feat, tp_map)
        return self._tail(b1, feat), weights
