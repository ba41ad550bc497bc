"""Carry a dpmn_tpu state into the port's modules.

`from_jax(state, system)` takes the JAX package's state — the `params`,
`batch_stats` and `frozen` trees of DPMNSystem.init_state, as nested dicts of
numpy arrays — and copies every leaf into the port's DPMNSystem:
  * flax Dense kernel (in, out) → torch Linear weight (out, in);
  * Conv kernel HWIO → OIHW; the JAX ConvTranspose2dTorch kernel
    (kh, kw, out, in) → torch ConvTranspose2d (in, out, kh, kw);
  * BatchNorm scale/bias → weight/bias, batch_stats mean/var → running stats;
  * LayerNorm scale/bias → weight/bias;
  * BiGRU / BiLSTM gate blocks w_ih_fw (I, G*H) → weight_ih_l0 (G*H, I) and
    *_bw → *_l0_reverse (gate order kept: [r; z; n] and [i; f; g; o]);
  * the PGRM residual weights (1, H, W, 3) → (1, 3, H, W).
It raises on a leaf of the JAX state that no port tensor takes, on a port
parameter or buffer that no leaf fills, and on any shape mismatch.  The
distill modules come over with the rest; the optimizer state is not read.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn


class _Leaves:
    """The flattened JAX tree; `take` pops a leaf, `left` lists the rest."""

    def __init__(self, tree, prefix=""):
        self.flat = {}
        self._flatten(tree, prefix)

    def _flatten(self, tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                self._flatten(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            self.flat[prefix] = np.asarray(tree)

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"from_jax: the JAX state has no leaf {path!r}")
        return self.flat.pop(path)

    def left(self):
        return sorted(self.flat)


class _Copier:
    def __init__(self, leaves: _Leaves):
        self.leaves = leaves
        self.filled = set()

    def put(self, tensor: torch.Tensor, value: np.ndarray, path: str):
        value = torch.as_tensor(np.asarray(value), dtype=tensor.dtype)
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"from_jax: {path}: shape {tuple(value.shape)} does not fit {tuple(tensor.shape)}")
        with torch.no_grad():
            tensor.copy_(value)
        self.filled.add(id(tensor))

    def raw(self, tensor, path, fn=lambda v: v):
        self.put(tensor, fn(self.leaves.take(path)), path)

    def dense(self, lin: nn.Linear, path: str):
        self.raw(lin.weight, f"{path}/kernel", lambda v: v.T)
        if lin.bias is not None:
            self.raw(lin.bias, f"{path}/bias")

    def conv(self, conv, path: str):
        # HWIO → OIHW for Conv2d; (kh, kw, out, in) → (in, out, kh, kw) for
        # ConvTranspose2d: the same axis permutation
        self.raw(conv.weight, f"{path}/kernel", lambda v: v.transpose(3, 2, 0, 1))
        if conv.bias is not None:
            self.raw(conv.bias, f"{path}/bias")

    def ln(self, ln: nn.LayerNorm, path: str):
        self.raw(ln.weight, f"{path}/scale")
        self.raw(ln.bias, f"{path}/bias")

    def bn(self, bn: nn.BatchNorm2d, p: str, s: str):
        self.raw(bn.weight, f"{p}/scale")
        self.raw(bn.bias, f"{p}/bias")
        self.raw(bn.running_mean, f"{s}/mean")
        self.raw(bn.running_var, f"{s}/var")

    def rnn(self, mod, path: str):
        for tag, sfx in (("fw", "l0"), ("bw", "l0_reverse")):
            self.raw(getattr(mod, f"weight_ih_{sfx}"), f"{path}/w_ih_{tag}", lambda v: v.T)
            self.raw(getattr(mod, f"weight_hh_{sfx}"), f"{path}/w_hh_{tag}", lambda v: v.T)
            self.raw(getattr(mod, f"bias_ih_{sfx}"), f"{path}/b_ih_{tag}")
            self.raw(getattr(mod, f"bias_hh_{sfx}"), f"{path}/b_hh_{tag}")


def _mha(c: _Copier, m, path):
    c.raw(m.in_proj_weight, f"{path}/in_proj_weight")
    c.raw(m.in_proj_bias, f"{path}/in_proj_bias")
    c.dense(m.out_proj, f"{path}/out_proj")


def _psn(c: _Copier, psn, p, s):
    c.conv(psn.conv_in, f"{p}/Conv_0")
    c.raw(psn.prelu.weight, f"{p}/PReLU_0/a")
    ig = f"{p}/infoGen"
    c.dense(psn.infoGen.fc_in, f"{ig}/fc_in")
    c.raw(psn.infoGen.activation.weight, f"{ig}/PReLU_0/a")
    tr, t = psn.infoGen.transformer, f"{ig}/upsample_transformer"
    c.raw(tr.init_factor, f"{t}/init_factor")
    c.rnn(tr.gru_encoding, f"{t}/gru_encoding")
    for i, layer in enumerate(tr.encoder):
        e = f"{t}/encoder_{i}"
        _mha(c, layer.self_attn, f"{e}/MultiHeadAttention_0")
        for name in ("linear1", "linear2"):
            c.dense(getattr(layer, name), f"{e}/{name}")
        for name in ("norm1", "norm2"):
            c.ln(getattr(layer, name), f"{e}/{name}")
    for i, layer in enumerate(tr.decoder):
        d = f"{t}/decoder_{i}"
        _mha(c, layer.multihead_attn, f"{d}/MultiHeadAttention_0")
        for name in ("linear1", "linear2"):
            c.dense(getattr(layer, name), f"{d}/{name}")
        for name in ("norm2", "norm3"):
            c.ln(getattr(layer, name), f"{d}/{name}")
    c.ln(tr.decoder_norm, f"{t}/decoder_norm")
    for i, srb in enumerate(psn.srbs):
        q, r = f"{p}/RecurrentResidualBlockTL_{i}", f"{s}/RecurrentResidualBlockTL_{i}"
        c.conv(srb.conv1, f"{q}/Conv_0")
        c.conv(srb.conv2, f"{q}/Conv_1")
        c.bn(srb.bn1, f"{q}/BatchNorm_0", f"{r}/BatchNorm_0")
        c.bn(srb.bn2, f"{q}/BatchNorm_1", f"{r}/BatchNorm_1")
        for j, gb in enumerate((srb.gru1, srb.gru2)):
            c.conv(gb.conv1, f"{q}/GruBlock_{j}/Conv_0")
            c.rnn(gb.gru, f"{q}/GruBlock_{j}/BiGRU_0")
    c.conv(psn.conv_mid, f"{p}/Conv_1")
    c.bn(psn.bn_mid, f"{p}/BatchNorm_0", f"{s}/BatchNorm_0")
    for i, conv in enumerate(psn.upsample):
        c.conv(conv, f"{p}/Conv_{2 + i}")
    c.conv(psn.conv_out, f"{p}/Conv_{2 + len(psn.upsample)}")


def _crnn(c: _Copier, crnn, p, s):
    for i, conv in enumerate(crnn.convs):
        c.conv(conv, f"{p}/Conv_{i}")
    for j, i in enumerate((2, 4, 6)):
        c.bn(crnn.bns[str(i)], f"{p}/BatchNorm_{j}", f"{s}/BatchNorm_{j}")
    for j, blk in enumerate((crnn.rnn1, crnn.rnn2)):
        c.rnn(blk.rnn, f"{p}/BidirectionalLSTM_{j}/BiLSTM_0")
        c.dense(blk.embedding, f"{p}/BidirectionalLSTM_{j}/Dense_0")


def _student(c: _Copier, vl, p, s):
    bb, pb, sb = vl.backbone, f"{p}/backbone", f"{s}/backbone"
    c.conv(bb.conv1, f"{pb}/Conv_0")
    c.bn(bb.bn1, f"{pb}/BatchNorm_0", f"{sb}/BatchNorm_0")
    for i, blk in enumerate(bb.blocks):
        q, r = f"{pb}/BasicBlockVL_{i}", f"{sb}/BasicBlockVL_{i}"
        c.conv(blk.conv1, f"{q}/Conv_0")
        c.conv(blk.conv2, f"{q}/Conv_1")
        c.bn(blk.bn1, f"{q}/BatchNorm_0", f"{r}/BatchNorm_0")
        c.bn(blk.bn2, f"{q}/BatchNorm_1", f"{r}/BatchNorm_1")
        if blk.downsample is not None:
            c.conv(blk.downsample[0], f"{q}/Conv_2")
            c.bn(blk.downsample[1], f"{q}/BatchNorm_2", f"{r}/BatchNorm_2")
    seq = vl.SequenceModeling
    for i, layer in enumerate(seq.layers):
        q = f"{p}/SequenceModeling/layer_{i}"
        for name in ("w_qs", "w_ks", "w_vs", "fc", "w_1", "w_2"):
            c.dense(getattr(layer, name), f"{q}/{name}")
        c.ln(layer.attn_norm, f"{q}/attn_norm")
        c.ln(layer.ffn_norm, f"{q}/ffn_norm")
    c.ln(seq.norm, f"{p}/SequenceModeling/norm")
    c.raw(vl.pp.f0_embedding.weight, f"{p}/pp/f0_embedding/embedding")
    for name in ("w0", "wv", "we"):
        c.dense(getattr(vl.pp, name), f"{p}/pp/{name}")
    c.dense(vl.w_vrm, f"{p}/w_vrm")


def _swin_block(c: _Copier, blk, q):
    for name in ("norm1_q", "norm1_kv", "norm2"):
        c.ln(getattr(blk, name), f"{q}/{name}")
    _window_attention(c, blk.attn, f"{q}/WindowAttention_0")
    _mlp(c, blk.mlp, f"{q}/Mlp_0")


def _mlp(c: _Copier, mlp, ml):
    c.dense(mlp.fc1, f"{ml}/Dense_0")
    c.dense(mlp.fc2, f"{ml}/Dense_1")
    c.conv(mlp.dwconv, f"{ml}/dw")  # dw_kernel / dw_bias
    c.conv(mlp.pwconv, f"{ml}/pw")


def _window_attention(c: _Copier, wa, w):
    c.dense(wa.q, f"{w}/q")
    c.dense(wa.kv, f"{w}/kv")
    for i in range(len(wa.win)):
        c.raw(getattr(wa, f"relative_position_bias_table_{i}"), f"{w}/relative_position_bias_table_{i}")
    for j, name in enumerate(("proj", "fc1", "fc2", "proj_head")):
        c.dense(getattr(wa.SKConv, name), f"{w}/SKConv_0/Dense_{j}")


def _pgrm(c: _Copier, m, p):
    if m.graphic_mode:
        c.conv(m.prior_fusion, f"{p}/prior_fusion")
    c.conv(m.patch_embed, f"{p}/patch_embed")
    c.ln(m.patch_norm, f"{p}/patch_norm")
    for li, layer in enumerate(m.layers):
        for bi, blk in enumerate(layer.blocks):
            _swin_block(c, blk, f"{p}/BasicLayer_{li}/SwinTransformerBlock_{bi}")
    c.conv(m.conv_before_upsample[0], f"{p}/Conv_0")
    c.conv(m.conv_before_upsample[1], f"{p}/Conv_1")
    for i, wl in enumerate(m.weight_list):
        c.raw(wl, f"{p}/weight_list_{i}", lambda v: v.transpose(0, 3, 1, 2))


def _cmm(c: _Copier, m, p, s):
    for tag in ("1", "2"):
        c.conv(getattr(m, f"en_1_{tag}"), f"{p}/en_1_{tag}")
        for k in (2, 3, 4, 5):
            blk, q, r = getattr(m, f"en_{k}_{tag}"), f"{p}/en_{k}_{tag}", f"{s}/en_{k}_{tag}"
            c.conv(blk.conv1, f"{q}/Conv_0")
            c.conv(blk.conv2, f"{q}/Conv_1")
            c.bn(blk.bn1, f"{q}/BatchNorm_0", f"{r}/BatchNorm_0")
            c.bn(blk.bn2, f"{q}/BatchNorm_1", f"{r}/BatchNorm_1")
        c.conv(getattr(m, f"en_6_{tag}"), f"{p}/en_6_{tag}")
    c.dense(m.fc_1, f"{p}/fc_1")
    c.dense(m.fc_2, f"{p}/fc_2")
    c.conv(m.de_6_conv, f"{p}/de_6_conv")
    c.bn(m.de_6_bn, f"{p}/BatchNorm_0", f"{s}/BatchNorm_0")
    for k in (5, 4, 3, 2):
        blk, q, r = getattr(m, f"de_{k}"), f"{p}/de_{k}", f"{s}/de_{k}"
        c.conv(blk.deconv1, f"{q}/ConvTranspose2dTorch_0")
        c.conv(blk.deconv2, f"{q}/ConvTranspose2dTorch_1")
        c.bn(blk.bn1, f"{q}/BatchNorm_0", f"{r}/BatchNorm_0")
        c.bn(blk.bn2, f"{q}/BatchNorm_1", f"{r}/BatchNorm_1")
    c.conv(m.de_1_conv, f"{p}/de_1_conv")


def _distill(c: _Copier, m, p, s):
    c.conv(m.conv_cat_feature, f"{p}/conv_cat_feature")
    c.conv(m.conv_feature, f"{p}/conv_feature")
    c.bn(m.bn_1, f"{p}/bn_1", f"{s}/bn_1")
    c.bn(m.bn_2, f"{p}/bn_2", f"{s}/bn_2")


def _rename_mlp_convs(leaves: _Leaves):
    """The JAX Mlp stores its convs as dw_kernel/dw_bias/pw_kernel/pw_bias;
    give them the kernel/bias leaf names the conv copier reads (inside a
    block's Mlp_0, or at the top of an Mlp's own tree)."""
    for path in [k for k in leaves.flat if "/Mlp_0/" in k or k.rsplit("/", 1)[0] == "params"]:
        head, leaf = path.rsplit("/", 1)
        if leaf.startswith(("dw_", "pw_")):
            leaves.flat[f"{head}/{leaf[:2]}/{leaf[3:]}"] = leaves.flat.pop(path)


def _check_all(leaves: _Leaves, c: _Copier, module: nn.Module) -> None:
    if leaves.left():
        raise KeyError(f"from_jax: {len(leaves.left())} JAX leaves have no port tensor, e.g. {leaves.left()[:5]}")
    missing = [n for n, t in list(module.named_parameters()) + list(module.named_buffers())
               if id(t) not in c.filled and not _derived_buffer(n)]
    if missing:
        raise KeyError(f"from_jax: {len(missing)} port tensors were not filled, e.g. {missing[:5]}")


def from_jax(state: dict, system) -> None:
    """Copy the JAX state into `system` (a dpmn_tpu_torch DPMNSystem) in
    place.  Raises on a missing or extra leaf, or a shape mismatch."""
    leaves = _Leaves({k: state[k] for k in ("params", "batch_stats", "frozen") if k in state})
    _rename_mlp_convs(leaves)
    c = _Copier(leaves)
    for i, m in enumerate(system.pgrms):
        _pgrm(c, m, f"params/pgrm_{i}")
    _cmm(c, system.cmm, "params/cmm", "batch_stats/cmm")
    for i, d in enumerate(system.distills):
        _distill(c, d, f"params/distill_{i}", f"batch_stats/distill_{i}")
    _psn(c, system.psn, "frozen/psn/params", "frozen/psn/batch_stats")
    _crnn(c, system.crnn_psn, "frozen/crnn_psn/params", "frozen/crnn_psn/batch_stats")
    for k, st in enumerate(system.students):
        _student(c, st, f"frozen/student_{k}/params", f"frozen/student_{k}/batch_stats")
    _check_all(leaves, c, system)


def module_from_jax(module: nn.Module, variables: dict) -> None:
    """Copy one flax module's variables ({"params": ..., "batch_stats": ...},
    numpy leaves) into the port module of the same model, in place; raises
    like `from_jax`."""
    from .models.cmm import CMM
    from .models.crnn import CRNN
    from .models.distill import DistillModule
    from .models.pgrm import PGRM, Mlp, SwinTransformerBlock, WindowAttention
    from .models.tatt import TSRN_TL_TRANS
    from .models.visionlan import VisionLAN
    from .ops.gru import BiGRU

    leaves = _Leaves({k: v for k, v in variables.items() if k in ("params", "batch_stats")})
    _rename_mlp_convs(leaves)
    c = _Copier(leaves)
    p, s = "params", "batch_stats"
    table = {
        PGRM: lambda: _pgrm(c, module, p),
        SwinTransformerBlock: lambda: _swin_block(c, module, p),
        WindowAttention: lambda: _window_attention(c, module, p),
        Mlp: lambda: _mlp(c, module, p),
        CMM: lambda: _cmm(c, module, p, s),
        TSRN_TL_TRANS: lambda: _psn(c, module, p, s),
        CRNN: lambda: _crnn(c, module, p, s),
        VisionLAN: lambda: _student(c, module, p, s),
        BiGRU: lambda: c.rnn(module, p),
        DistillModule: lambda: _distill(c, module, p, s),
    }
    if type(module) not in table:
        raise TypeError(f"module_from_jax: no mapping for {type(module).__name__}")
    table[type(module)]()
    _check_all(leaves, c, module)


def _derived_buffer(name: str) -> bool:
    """Buffers the port derives from the geometry, not from weights."""
    last = name.rsplit(".", 1)[-1]
    return last in ("num_batches_tracked", "pe", "table", "sel", "cell_of_s", "off_of_s") or last.startswith(
        ("rel_index_", "shift_mask_"))
