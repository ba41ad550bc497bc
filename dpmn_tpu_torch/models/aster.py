"""ASTER recognizer: TPS-STN → 31-layer ResNet + 2-layer BiLSTM → attention
GRU decoder with width-5 beam search.

Counterpart of dpmn_tpu/models/aster.py (reference model/recognizer/:
recognizer_builder.py:27-104, resnet_aster.py:37-128,
attention_recognition_head.py:11-268).  Parameter names are the reference's
(`stn_head.*`, `encoder.layer{0..5}.*`, `encoder.rnn.*`,
`decoder.decoder.{attention_unit,tgt_embedding,gru,fc}.*`), so a reference
checkpoint loads with a strict `load_state_dict`.

Beam search keeps the JAX package's semantics exactly: every step's top-k
over the k·C candidates takes the lower index first among equal scores (a
stable descending sort; `torch.topk` orders exact ties arbitrarily, PARITY.md
"ASTER beam-search tie order"), all `max_len_labels` steps run, and the
backtrack keeps the reference's EOS replacement scheme
(attention_recognition_head.py:127-173).  The step loop never waits for the
device; symbols, predecessors and scores come to the host once, where the
backtrack runs in numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize
from .stn import STNHead
from .tps import TPSSpatialTransformer


class AsterBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride=(1, 1), downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                                         nn.BatchNorm2d(planes)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetAster(nn.Module):
    """31-conv ResNet + 2-layer BiLSTM (resnet_aster.py:64-128): (B, 3, 32,
    100) → (B, 25, 512)."""

    def __init__(self):
        super().__init__()
        self.layer0 = nn.Sequential(nn.Conv2d(3, 32, 3, padding=1, bias=False), nn.BatchNorm2d(32), nn.ReLU())
        inplanes = 32
        for i, (planes, blocks, stride) in enumerate(((32, 3, (2, 2)), (64, 4, (2, 2)), (128, 6, (2, 1)),
                                                      (256, 6, (2, 1)), (512, 3, (2, 1))), start=1):
            layer = [AsterBlock(inplanes, planes, stride, downsample=True)]
            layer += [AsterBlock(planes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{i}", nn.Sequential(*layer))
            inplanes = planes
        self.rnn = nn.LSTM(512, 256, num_layers=2, bidirectional=True, batch_first=True)

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f"layer{i}")(x)
        return self.rnn(x[:, :, 0].transpose(1, 2))[0]  # (B, 512, 1, W') → (B, W', 512)


class AttentionUnit(nn.Module):
    def __init__(self, s_dim: int, x_dim: int, att_dim: int):
        super().__init__()
        self.sEmbed = nn.Linear(s_dim, att_dim)
        self.xEmbed = nn.Linear(x_dim, att_dim)
        self.wEmbed = nn.Linear(att_dim, 1)


class DecoderUnit(nn.Module):
    """One attention-GRU decode step (attention_recognition_head.py:209-268)."""

    def __init__(self, s_dim: int, x_dim: int, y_dim: int, att_dim: int):
        super().__init__()
        self.attention_unit = AttentionUnit(s_dim, x_dim, att_dim)
        self.tgt_embedding = nn.Embedding(y_dim + 1, att_dim)
        self.gru = nn.GRU(x_dim + att_dim, s_dim, batch_first=True)
        self.fc = nn.Linear(s_dim, y_dim)

    def forward(self, x, x_proj, state, y_prev):
        """x (N, T, C) and its projection x_proj = xEmbed(x), hoisted out of
        the step loop; state (N, s_dim); y_prev (N,) → (logits, state)."""
        au = self.attention_unit
        e = au.wEmbed(torch.tanh(au.sEmbed(state)[:, None, :] + x_proj))[..., 0]  # (N, T)
        alpha = torch.softmax(e, dim=1)
        context = torch.bmm(alpha[:, None, :], x)[:, 0]
        y_proj = self.tgt_embedding(y_prev)
        out, _ = self.gru(torch.cat([y_proj, context], dim=1)[:, None, :], state[None])
        state = out[:, 0]
        return self.fc(state), state


class AttentionRecognitionHead(nn.Module):
    def __init__(self, num_classes: int, in_planes: int, s_dim: int = 512, att_dim: int = 512,
                 max_len_labels: int = 100):
        super().__init__()
        self.num_classes = num_classes
        self.s_dim = s_dim
        self.max_len_labels = max_len_labels
        self.decoder = DecoderUnit(s_dim, in_planes, num_classes, att_dim)

    def forward(self, x, targets, num_steps: int = None):
        """Teacher-forced forward → (B, num_steps, num_classes) logits."""
        num_steps = num_steps or self.max_len_labels
        b = x.shape[0]
        x_proj = self.decoder.attention_unit.xEmbed(x)
        bos = torch.full((b, 1), self.num_classes, dtype=torch.long, device=x.device)
        y_in = torch.cat([bos, targets[:, : num_steps - 1].long()], dim=1)
        state = x.new_zeros(b, self.s_dim)
        logits = []
        for y_prev in y_in.unbind(1):
            out, state = self.decoder(x, x_proj, state, y_prev)
            logits.append(out)
        return torch.stack(logits, dim=1)

    def sample(self, x):
        """Greedy decode → (ids (B, L), scores (B, L))."""
        b = x.shape[0]
        x_proj = self.decoder.attention_unit.xEmbed(x)
        state = x.new_zeros(b, self.s_dim)
        y_prev = torch.full((b,), self.num_classes, dtype=torch.long, device=x.device)
        ids, scores = [], []
        for _ in range(self.max_len_labels):
            logits, state = self.decoder(x, x_proj, state, y_prev)
            probs = torch.softmax(logits, dim=1)
            y_prev = probs.argmax(dim=1)  # the first maximum, as jnp.argmax
            ids.append(y_prev)
            scores.append(probs.amax(dim=1))
        return torch.stack(ids, dim=1), torch.stack(scores, dim=1)

    def beam_search_steps(self, x, beam_width: int, eos: int):
        """The forward half of the beam search: every step's emitted symbols,
        predecessors (rows of the B·k batch) and scores before the ended
        beams are masked, each (T, B·k)."""
        b, k, nc = x.shape[0], beam_width, self.num_classes
        x_inf = x.repeat_interleave(k, dim=0)  # ABC → AABBCC
        x_proj = self.decoder.attention_unit.xEmbed(x_inf)
        pos_index = (torch.arange(b, device=x.device) * k)[:, None]
        scores_c = torch.full((b * k, 1), float("-inf"), dtype=x.dtype, device=x.device)
        scores_c[::k] = 0.0
        state = x.new_zeros(b * k, self.s_dim)
        y_prev = torch.full((b * k,), nc, dtype=torch.long, device=x.device)
        symbols, preds, stored = [], [], []
        for _ in range(self.max_len_labels):
            logits, state = self.decoder(x_inf, x_proj, state, y_prev)
            cand = (scores_c + torch.log_softmax(logits, dim=1)).reshape(b, k * nc)
            # top-k with exact ties to the lower index, as lax.top_k
            scores, candidates = torch.sort(cand, dim=1, descending=True, stable=True)
            scores, candidates = scores[:, :k], candidates[:, :k]
            y_prev = (candidates % nc).reshape(b * k)
            predecessors = (candidates // nc + pos_index).reshape(b * k)
            state = state[predecessors]
            scores_c = scores.reshape(b * k, 1)
            symbols.append(y_prev)
            preds.append(predecessors)
            stored.append(scores_c[:, 0])
            scores_c = scores_c.masked_fill((y_prev == eos)[:, None], float("-inf"))
        return torch.stack(symbols), torch.stack(preds), torch.stack(stored)

    def beam_search(self, x, beam_width: int, eos: int):
        """Beam search → (ids (B, max_len_labels), ones) as numpy int arrays."""
        symbols, preds, stored = (t.cpu().numpy() for t in self.beam_search_steps(x, beam_width, eos))
        ids = beam_backtrack(symbols, preds, stored, x.shape[0], beam_width, eos)
        return ids, np.ones_like(ids)


def beam_backtrack(symbols: np.ndarray, preds: np.ndarray, stored: np.ndarray, b: int, k: int, eos: int) -> np.ndarray:
    """The reference's backtracking (attention_recognition_head.py:127-173)
    over the forward half's (T, B·k) arrays → ids (B, T).  Walking t
    backwards, every EOS emission replaces return slot k-1-(count % k)
    (count per batch entry; within a step in descending slot order), scored
    -inf or not; the last write wins, slots never written keep the sorted
    final-step beams, and the answer is the best slot (ties to the lower
    slot).  The same arithmetic as dpmn_tpu's vectorised form."""
    t_max = symbols.shape[0]
    pos_index = (np.arange(b) * k)[:, None]
    sym = symbols.reshape(t_max, b, k)
    prd = preds.reshape(t_max, b, k) - pos_index[None]  # slot within the beam
    sco = stored.reshape(t_max, b, k)
    # enumeration order e = (T-1-t)*k + (k-1-slot): t descending, slot descending
    sym_e = sym[::-1, :, ::-1].transpose(1, 0, 2).reshape(b, t_max * k)
    sco_e = sco[::-1, :, ::-1].transpose(1, 0, 2).reshape(b, t_max * k)
    mask_e = sym_e == eos
    cnt_before = np.cumsum(mask_e, axis=1) - mask_e
    res_slot = (k - 1) - (cnt_before % k)
    e_idx = np.arange(t_max * k)[None, :, None]
    write = mask_e[:, :, None] & (res_slot[:, :, None] == np.arange(k)[None, None, :])
    last_e = np.max(np.where(write, e_idx, -1), axis=1)  # (B, k)
    replaced = last_e >= 0
    safe_e = np.maximum(last_e, 0)
    t_rep = (t_max - 1) - safe_e // k
    slot_rep = (k - 1) - safe_e % k
    score_rep = np.take_along_axis(sco_e, safe_e, axis=1)
    # the final step's beams sorted as lax.top_k sorts: ties to the lower slot
    final_idx = np.argsort(-sco[t_max - 1], axis=1, kind="stable")
    final_scores = np.take_along_axis(sco[t_max - 1], final_idx, axis=1)
    s_final = np.where(replaced, score_rep, final_scores)
    ar = np.arange(b)
    winner = np.argmax(s_final, axis=1)  # ties to the lower slot
    win_rep = replaced[ar, winner]
    t_sel = np.where(win_rep, t_rep[ar, winner], t_max - 1)
    k_sel = np.where(win_rep, slot_rep[ar, winner], final_idx[ar, winner])
    slot, active = np.zeros(b, np.int64), np.zeros(b, bool)
    ids = np.empty((b, t_max), np.int64)
    for t in range(t_max - 1, -1, -1):
        start = t == t_sel
        slot = np.where(start, k_sel, slot)
        active |= start
        ids[:, t] = np.where(active, sym[t, ar, slot], eos)
        slot = np.where(active, prd[t, ar, slot], slot)
    return ids


class RecognizerBuilder(nn.Module):
    """Full ASTER (recognizer_builder.py:27-104) with its STN on, as every
    caller has it: images (B, 3, H, W) in [-1, 1]; eval → {"pred_rec": ids
    (B, max_len_labels), "pred_rec_score": ones}, train mode →
    teacher-forced logits."""

    def __init__(self, rec_num_classes: int = 97, s_dim: int = 512, att_dim: int = 512, max_len_labels: int = 100,
                 eos: int = 94, beam_width: int = 5):
        super().__init__()
        self.eos = eos
        self.beam_width = beam_width
        self.stn_head = STNHead(3, 20, variant="recognizer")
        self.tps = TPSSpatialTransformer((32, 100), 20, (0.05, 0.05))
        self.encoder = ResNetAster()
        self.decoder = AttentionRecognitionHead(rec_num_classes, 512, s_dim, att_dim, max_len_labels)

    def rectify(self, x):
        """The STN's control points on a 32x64 bilinear (align_corners) resize,
        and x warped by TPS to 32x100 → (rectified, ctrl_points)."""
        _, ctrl = self.stn_head(resize(x, (32, 64), mode="bilinear", align_corners=True))
        return self.tps(x, ctrl)[0], ctrl

    def forward(self, images, rec_targets=None):
        feats = self.encoder(self.rectify(images)[0])
        if self.training:
            if rec_targets is None:
                raise ValueError("train mode needs rec_targets")
            return self.decoder(feats, rec_targets)
        ids, scores = self.decoder.beam_search(feats, self.beam_width, self.eos)
        return {"pred_rec": ids, "pred_rec_score": scores}


def parse_aster_input(imgs: torch.Tensor) -> torch.Tensor:
    """RGB NCHW in [0, 1] → [-1, 1] (interfaces/base.py:441-450)."""
    return imgs[:, :3] * 2.0 - 1.0
