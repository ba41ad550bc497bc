"""PGRM — Prior-Guided Refinement Module.

Counterpart of dpmn_tpu/models/pgrm.py (reference model/pgrm.py).  The query
is the prior image (2-channel glyph render or 3-channel binarized mask), key
and value the current SR image; channels split into len(window_size) groups,
each attending inside its own (shifted) window with a learned relative
position bias, fused by SKConv; an Mlp with a depthwise conv completes each
block.  In eval every block's attention + SKConv + residual runs in one call
of `window_attention_block` (kernel K1 on the card).  In train mode (the
module's `training` flag) the attention runs in one of three cores with a
backward, chosen by `train_core` as dpmn_tpu/models/pgrm.py:378-510 chooses
(`resolve_train_core`):
  * "block": LN + projections + attention in `window_attention_block_core`
    (kernel K3), SKConv in PyTorch after it;
  * "attention": LN and the q / kv projections in PyTorch, the attention in
    `window_attention_core` (kernel K4), SKConv in PyTorch after it;
  * "full": all of it, SKConv included, in `window_attention_full_core`
    (kernel K5); faithful layout only, "block" runs in its place otherwise.
Dropout, attention dropout and drop path draw from the step's `TrainRng`.
On bf16 tokens (the bf16 AMP step, the system's `train_dtype`) every block
runs in bf16 and each core takes bf16 tokens with float32 bias tables, as
the JAX package passes them (dpmn_tpu/models/pgrm.py:405-407, :488-490): K3,
K4 and K5 on bf16 io.  Under "attention" the LayerNorm and the projections
before K4 follow the JAX package's XLA side on bf16: `_layer_norm`'s float32
statistics rounded to bf16 once (dpmn_tpu/ops/pallas_window.py:191-202),
and flax `nn.Dense` on bf16 operands, the product rounded to bf16 and the
bias added in bf16 (`_dense_bf16`); k and v reach K4 as the halves of the
kv projection, uncopied.

Faithful quirks (`faithful=True`, the default): the attention output's
window-major rows are read back as raster rows (model/pgrm.py:263), and the
Mlp views its (B, HW, hidden) buffer as (B, hidden, s, s) in C order
(model/pgrm.py:34), a free `.view` here (`ops/mlp_convs.py`
`mlp_convs_plain`, the plain version of kernel K6, which the Mlp runs).
`faithful=False` gives the spatially correct variant of both.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dropout import TrainRng, drop_path, dropout
from ..ops.mlp_convs import mlp_convs_plain
from ..ops.torch_compat import LN_EPS, weak
from ..ops.window_attention import layer_norm, skconv, window_attention_block
from ..ops.window_attention_core import window_attention_core
from ..ops.window_attention_full import window_attention_full_core
from ..ops.window_attention_train import corrected_relayout, window_attention_block_core

TRAIN_CORES = ("block", "attention", "full")


def resolve_train_core(train_core: Optional[str] = None) -> str:
    """The training core of WindowAttention.  None reads the JAX package's two
    switches with its defaults and precedence (dpmn_tpu/models/pgrm.py:61-65,
    :378-447): DPMN_TPU_FUSE_QKV other than "1" (default "1") selects
    "attention"; else DPMN_TPU_FUSE_SKCONV = "1" (default "0") selects
    "full"; else "block"."""
    if train_core is None:
        if os.environ.get("DPMN_TPU_FUSE_QKV", "1") != "1":
            return "attention"
        return "full" if os.environ.get("DPMN_TPU_FUSE_SKCONV", "0") == "1" else "block"
    if train_core not in TRAIN_CORES:
        raise ValueError(f"train_core {train_core!r}: one of {TRAIN_CORES} or None")
    return train_core


def _relative_position_index(ws: int) -> np.ndarray:
    """Static (ws*ws, ws*ws) index into the (2ws-1)^2 bias table (ref :133-145)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Static (nW, N, N) additive -100 mask for shifted windows (ref :152-173)."""
    img_mask = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    mw = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class SKConv(nn.Module):
    """Selective-kernel fusion of the M window-size groups (ref :62-96)."""

    def __init__(self, dim: int, m: int, r: int = 2):
        super().__init__()
        channel = dim // m
        d = channel // r
        self.m = m
        self.proj = nn.Linear(dim, dim)
        self.fc1 = nn.Linear(dim, d)
        self.fc2 = nn.Linear(d, m * channel)
        self.proj_head = nn.Linear(channel, dim)

    def weights(self) -> tuple:
        """proj, fc1, fc2, proj_head weight and bias, in `skconv`'s order."""
        return tuple(t for lin in (self.proj, self.fc1, self.fc2, self.proj_head) for t in (lin.weight, lin.bias))

    def forward(self, x):
        """x: (B, L, dim), the concat of the m groups → (B, L, dim).  K1 (eval)
        and K5 (train_core "full") fuse the same computation."""
        return skconv(x, *self.weights(), self.m)


class WindowAttention(nn.Module):
    """Grouped multi-window cross attention (ref :108-271)."""

    def __init__(self, dim: int, window_size: Sequence[int], shift_size: Sequence[int], num_heads: int,
                 input_resolution: Tuple[int, int], qk_scale: float = None, attn_drop: float = 0.0,
                 faithful: bool = True, train_core: Optional[str] = None):
        super().__init__()
        h, w = input_resolution
        n_group = len(window_size)
        self.dim, self.faithful, self.attn_drop = dim, faithful, attn_drop
        # "full" runs SKConv on the faithful row order inside the kernel, so
        # the corrected layout takes "block" (dpmn_tpu/models/pgrm.py:418-421)
        core = resolve_train_core(train_core)
        self.train_core = "block" if core == "full" and not faithful else core
        self.hw = (h, w)
        self.gnum_heads = num_heads // n_group
        gchannel = dim // n_group // self.gnum_heads
        self.scale = qk_scale or gchannel**-0.5
        # effective window / shift after the min-resolution clamp (ref :147-150)
        self.win, self.shf = [], []
        for ws, sh in zip(window_size, shift_size):
            if min(input_resolution) <= ws:
                self.win.append(min(input_resolution))
                self.shf.append(0)
            else:
                self.win.append(int(ws))
                self.shf.append(int(sh))
        if any(h % ws or w % ws for ws in self.win):
            raise ValueError(f"windows {self.win} must divide the {h}x{w} token grid")
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        for i, (ws, sh) in enumerate(zip(self.win, self.shf)):
            self.register_parameter(f"relative_position_bias_table_{i}",
                                    nn.Parameter(torch.zeros((2 * ws - 1) ** 2, self.gnum_heads)))
            self.register_buffer(f"rel_index_{i}", torch.from_numpy(_relative_position_index(ws).reshape(-1)),
                                 persistent=False)
            mask = torch.from_numpy(_shift_attn_mask(h, w, ws, sh)) if sh > 0 else torch.zeros(0)
            self.register_buffer(f"shift_mask_{i}", mask, persistent=False)
        self.SKConv = SKConv(dim, n_group)

    def biases(self):
        out = []
        for i, ws in enumerate(self.win):
            n = ws * ws
            table = getattr(self, f"relative_position_bias_table_{i}")
            idx = getattr(self, f"rel_index_{i}")
            out.append(table[idx].reshape(n, n, self.gnum_heads).permute(2, 0, 1).contiguous())
        return out

    def masks(self):
        return [getattr(self, f"shift_mask_{i}") if sh > 0 else None for i, sh in enumerate(self.shf)]

    def block_args(self, ln=None) -> dict:
        """The keyword arguments of `window_attention_block` for this module;
        `ln` holds the norm1_q / norm1_kv parameters (qs, qb, ks, kb)."""
        names = ("proj_w", "proj_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "ph_w", "ph_b")
        weights = {"q_w": self.q.weight, "q_b": self.q.bias, "kv_w": self.kv.weight, "kv_b": self.kv.bias,
                   **dict(zip(names, self.SKConv.weights()))}
        return dict(weights=weights, biases=self.biases(), masks=self.masks(), window_sizes=self.win,
                    shifts=self.shf, gnum_heads=self.gnum_heads, scale=self.scale, hw_shape=self.hw, ln=ln,
                    layout="faithful" if self.faithful else "corrected")

    def forward(self, x_q, x_kv, ln=None, rng: TrainRng = None):
        """x_q, x_kv: (B, L, dim) tokens, pre-norm when `ln` is given.  Eval:
        with `ln` the x_kv residual is included.  Train mode (needs `ln`):
        the attention output after SKConv, without the residual, through the
        core `train_core` names."""
        if not self.training:
            return window_attention_block(x_q, x_kv, **self.block_args(ln))
        biases = self.biases()
        bf16 = x_q.dtype == torch.bfloat16
        if bf16:
            biases = [bb.float() for bb in biases]
        keep = 1.0 - self.attn_drop
        seed = rng.kernel_seed() if keep < 1.0 else 0
        tail = (biases, self.masks(), seed, keep, self.win, self.shf, self.gnum_heads, self.scale, self.hw)
        if self.train_core == "full":
            return window_attention_full_core(x_q, x_kv, ln["qs"], ln["qb"], ln["ks"], ln["kb"], self.q.weight,
                                              self.q.bias, self.kv.weight, self.kv.bias, *self.SKConv.weights(),
                                              *tail)
        if self.train_core == "attention":
            if bf16:
                q = _dense_bf16(_layer_norm_bf16(x_q, ln["qs"], ln["qb"]), self.q)
                kv = _dense_bf16(_layer_norm_bf16(x_kv, ln["ks"], ln["kb"]), self.kv)
                out = window_attention_core(q, kv[..., :self.dim], kv[..., self.dim:], *tail)
            else:
                q = self.q(layer_norm(x_q, ln["qs"], ln["qb"]))
                kv = self.kv(layer_norm(x_kv, ln["ks"], ln["kb"]))
                out = window_attention_core(q, kv[..., :self.dim].contiguous(), kv[..., self.dim:].contiguous(),
                                            *tail)
        else:
            out = window_attention_block_core(x_q, x_kv, ln["qs"], ln["qb"], ln["ks"], ln["kb"], self.q.weight,
                                              self.q.bias, self.kv.weight, self.kv.bias, *tail)
        if not self.faithful:
            out = corrected_relayout(out, self.win, self.shf, self.hw)
        return self.SKConv(out)


def _layer_norm_bf16(x, scale, bias):
    """`layer_norm` on bf16 tokens as the JAX package's `_layer_norm` computes
    it: float32 statistics and affine on the widened values, rounded to bf16
    once."""
    return layer_norm(x.float(), scale.float(), bias.float()).to(torch.bfloat16)


def _dense_bf16(x, lin: nn.Linear):
    """flax `nn.Dense` on bf16 operands: the product (float32 sums) rounded to
    bf16, then the bias added in bf16."""
    return torch.matmul(x, lin.weight.T) + lin.bias


class Mlp(nn.Module):
    """fc → gelu → depthwise 3x3 conv → pointwise conv → fc (ref :16-41)."""

    def __init__(self, dim: int, hidden: int, grid: Tuple[int, int], drop: float = 0.0, faithful: bool = True):
        super().__init__()
        self.hidden, self.grid, self.drop, self.faithful = hidden, grid, drop, faithful
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.pwconv = nn.Conv2d(hidden, hidden, 1)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, rng: TrainRng = None):
        b, hw, _ = x.shape
        drop = self.drop if self.training else 0.0
        x = dropout(F.gelu(self.fc1(x)), drop, rng)
        if self.faithful:
            # QUIRK (ref :33-38): a C-order view of the (B, HW, hidden) buffer
            x = mlp_convs_plain(x, self.dwconv.weight, self.dwconv.bias, self.pwconv.weight, self.pwconv.bias)
        else:
            gh, gw = self.grid
            xg = x.reshape(b, gh, gw, self.hidden).permute(0, 3, 1, 2)
            xg = self.pwconv(F.gelu(self.dwconv(xg)))
            x = xg.permute(0, 2, 3, 1).reshape(b, hw, self.hidden)
        return dropout(self.fc2(x), drop, rng)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, input_resolution, num_heads, window_size, shift_size, mlp_ratio=4.0, drop=0.0,
                 attn_drop=0.0, drop_path=0.0, faithful=True, train_core=None):
        super().__init__()
        self.drop_path = drop_path
        self.norm1_q = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm1_kv = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window_size, shift_size, num_heads, input_resolution,
                                    attn_drop=attn_drop, faithful=faithful, train_core=train_core)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), input_resolution, drop, faithful)

    def ln_params(self) -> dict:
        return {"qs": self.norm1_q.weight, "qb": self.norm1_q.bias,
                "ks": self.norm1_kv.weight, "kb": self.norm1_kv.bias}

    def forward(self, x_q, x_kv, rng: TrainRng = None):
        # norm1_q / norm1_kv run inside the attention call; in eval so does
        # the shortcut add (ref :620-633)
        if not self.training:
            x_kv = self.attn(x_q, x_kv, ln=self.ln_params())
            return x_q, x_kv + self.mlp(self.norm2(x_kv))
        x_kv = x_kv + drop_path(self.attn(x_q, x_kv, self.ln_params(), rng), self.drop_path, rng)
        x_kv = x_kv + drop_path(self.mlp(self.norm2(x_kv), rng), self.drop_path, rng)
        return x_q, x_kv


class BasicLayer(nn.Module):
    """Two Swin blocks: unshifted, then shifted by window//2 (ref :347-384)."""

    def __init__(self, dim, input_resolution, num_heads, window_size, mlp_ratio=4.0, drop=0.0, attn_drop=0.0,
                 drop_path=(0.0, 0.0), faithful=True, train_core=None):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, input_resolution, num_heads, list(window_size),
                                 [0] * len(window_size) if i == 0 else [ws // 2 for ws in window_size],
                                 mlp_ratio, drop, attn_drop, float(drop_path[min(i, len(drop_path) - 1)]),
                                 faithful, train_core)
            for i in range(2)
        ])

    def forward(self, x_q, x_kv, rng: TrainRng = None):
        for blk in self.blocks:
            x_q, x_kv = blk(x_q, x_kv, rng)
        return x_q, x_kv


class PGRM(nn.Module):
    """The refiner (ref :460-565), NCHW: x_q (B, 2 or 3, H, W) prior, x_kv
    (B, 3, H, W) image; residual_list of earlier (B, 3, H, W) outputs.
    `train_core` picks every block's training core (`resolve_train_core`).

    The drop-path schedule spans sum(depths) * 2 positions across all cascade
    iterations (`depths_total`); this module's layers take the slice at
    `depths_before` * 2 (ref :499-512)."""

    def __init__(self, img_size=(32, 128), patch_size=2, embed_dim=96, num_layers=1, num_heads=(6,),
                 window_size=(2, 4, 8), mlp_ratio=4.0, drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.1,
                 iter=0, graphic_mode=False, hidden_size=3, depths_total=0, depths_before=0, faithful=True,
                 train_core=None):
        super().__init__()
        self.img_size, self.patch_size, self.embed_dim = tuple(img_size), patch_size, embed_dim
        self.hidden_size, self.graphic_mode, self.drop_rate = hidden_size, graphic_mode, drop_rate
        ph, pw = self.img_size[0] // patch_size, self.img_size[1] // patch_size
        self.grid = (ph, pw)
        if graphic_mode:
            # glyph prior (lower + upper renders) → 3 channels (ref :471,547-548)
            self.prior_fusion = nn.Conv2d(2, 3, 3, padding=1)
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        total = depths_total or num_layers
        before = min(depths_before, max(total - num_layers, 0))
        dpr = np.linspace(0.0, drop_path_rate, max(total, num_layers) * 2)[before * 2:(before + num_layers) * 2]
        self.layers = nn.ModuleList([
            BasicLayer(embed_dim * 2**i, (ph // 2**i, pw // 2**i), num_heads[i], window_size, mlp_ratio,
                       drop_rate, attn_drop_rate, tuple(dpr[i * 2:(i + 1) * 2]), faithful, train_core)
            for i in range(num_layers)
        ])
        up_ch = hidden_size * patch_size**2
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, up_ch, 3, padding=1), nn.Conv2d(up_ch, up_ch, 3, padding=1)
        )
        # iter+1 residual weights are registered (ref :496-497); the combine
        # loop starts at 1, so residual_list[0] and the last weight go unused
        self.weight_list = nn.ParameterList(
            [nn.Parameter(torch.ones(1, hidden_size, *self.img_size)) for _ in range(iter + 1)]
        )

    def forward(self, x_q, x_kv, residual_list=(), rng: TrainRng = None):
        if x_q.shape[1] == 2:
            x_q = self.prior_fusion(x_q)

        def embed(img):
            return self.patch_norm(self.patch_embed(img).flatten(2).transpose(1, 2))

        drop = self.drop_rate if self.training else 0.0
        x_q, x_kv = dropout(embed(x_q), drop, rng), dropout(embed(x_kv), drop, rng)  # pos_drop
        for layer in self.layers:
            x_q, x_kv = layer(x_q, x_kv, rng)
        ph, pw = self.grid
        x = x_kv.transpose(1, 2).reshape(-1, self.embed_dim, ph, pw)  # patch_unembed (ref :450-453)
        x = F.leaky_relu(self.conv_before_upsample(x), weak(0.01, x.dtype))
        x = F.pixel_shuffle(x, self.patch_size)
        x = x * self.weight_list[0]
        for i in range(1, len(residual_list)):
            x = x + residual_list[i] * self.weight_list[i]
        return x
