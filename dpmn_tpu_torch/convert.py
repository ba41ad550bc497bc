"""The reference's torch checkpoints (.pth) → the port's modules.

Counterpart of dpmn_tpu/convert.py, convert_psn.py and convert_zoo.py for the
models the driver loads: the four PSN skeletons (TSRN for `tsrn` / `tg`,
TSRN_TL, TBSRN, TATT), CRNN, VisionLAN (its eval subset), PGRM and CMM.
Both sides are torch, so no tensor is transposed: only names change, with
two exceptions, TBSRN's four cloned attention linears (the first three
concatenated into the packed in_proj_weight / in_proj_bias, convert_psn.py:
30-38) and VisionLAN's Conv1d feed-forward kernels (O, I, 1), read as the
port's Linear (O, I).

`key_map(module)` lists, for the module's geometry, the reference key of
every port parameter and persistent buffer, the reference keys the eval tree
knows to be dead, and the reference buffers the port derives from the
geometry.  The load is strict: each key of a file is mapped onto a port
tensor, or on the module's list of dead families, or a derived buffer equal
to the port's own table; any other key raises KeyError naming it, and so
does a port tensor that no key fills, a shape mismatch raises ValueError
naming the key, and a derived buffer that differs from the port's table
raises ValueError.  The dead families:
  * BatchNorm's num_batches_tracked, everywhere;
  * a PSN's STN (`stn_head.*` and the TPS buffers `tps.*`): the frozen PSN
    runs in eval for good, and every PSN applies the STN in training only
    (dpmn_tpu/weights.py:50-56), so --STN changes no path;
  * TBSRN's unused head (`conv`, `bn`) and each SRB's gru1 / gru2, which
    its forward never calls (convert_psn.py:3-8);
  * TATT's decoder-layer self_attn / norm1, commented out of the forward
    (same lines);
  * VisionLAN's training branch `MLM_VRM.MLM.*`, `Prediction.pp_share.*`
    and `Prediction.w_share.*` (convert_zoo.py:206-216).
PGRM's relative_position_index_{i} and attn_mask_{i} are derived: the port
builds the same tables from the window geometry and holds the file's copies
equal to them.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

# the globals a reference checkpoint dict may need beyond tensors: its
# `info`, `best_history_res`, `converge` ... entries can hold numpy scalars,
# pickled as numpy's `scalar` (under numpy.core in numpy 1, numpy._core in
# numpy 2) of a dtype, which is rebuilt through its class
_scalar = (np._core if hasattr(np, "_core") else np.core).multiarray.scalar
SAFE_GLOBALS = [(_scalar, "numpy.core.multiarray.scalar"), (_scalar, "numpy._core.multiarray.scalar"),
                np.dtype] + [type(np.dtype(t)) for t in "?bhilqBHILQefd"]

NUM_BATCHES = r".*num_batches_tracked"  # BatchNorm's count: no model reads it


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a reference checkpoint (dpmn_tpu/convert.py:30-38):
    under "state_dict_G" (a PSN's or a PGRM's file), then under "state_dict"
    (ASTER's .pth.tar), or at the top (MORAN, CRNN), DataParallel "module."
    prefixes removed.  Read with weights_only=True, the numpy scalars of the
    checkpoint's bookkeeping entries allowed and nothing else."""
    with torch.serialization.safe_globals(SAFE_GLOBALS):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict_G", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
    return {k.removeprefix("module."): v for k, v in obj.items()}


def crnn_port_key(key: str) -> str:
    """The reference CRNN's names (model/crnn/crnn.py: cnn.conv{i},
    cnn.batchnorm{2,4,6}, rnn.{0,1}) → the port's (convs.{i}, bns.{i},
    rnn{1,2}); any other key is kept, so a strict load refuses it."""
    for pattern, repl in ((r"cnn\.conv(\d)\.", r"convs.\1."), (r"cnn\.batchnorm(\d)\.", r"bns.\1.")):
        if re.match(pattern, key):
            return re.sub(pattern, repl, key, count=1)
    m = re.match(r"rnn\.([01])\.", key)
    return f"rnn{int(m.group(1)) + 1}.{key[m.end():]}" if m else key


class Slot(NamedTuple):
    """Where a reference tensor goes: the port tensor `port`, whole or its
    `part`-th of `parts` row blocks; `squeeze`: the file's tensor has a
    trailing axis of 1 that the port's lacks."""

    port: str
    part: int = 0
    parts: int = 1
    squeeze: bool = False


class KeyMap(NamedTuple):
    slots: Dict[str, Slot]  # reference key → slot
    dead: Tuple[str, ...]  # patterns (re.fullmatch) of reference keys the eval tree has no place for
    derived: Dict[str, torch.Tensor]  # reference key → the port's table its value must equal


def _targets(module: nn.Module):
    """The port tensors a checkpoint fills: the state dict but BatchNorm's
    num_batches_tracked."""
    return [k for k in module.state_dict() if not re.fullmatch(NUM_BATCHES, k)]


def _rules(rules) -> Callable[[str], str]:
    """A renaming by the first matching (pattern, replacement) of `rules`."""
    def rename(key):
        for pattern, repl in rules:
            new, n = re.subn(pattern, repl, key, count=1)
            if n:
                return new
        return key
    return rename


def _slots(module: nn.Module, rename, squeeze: str = None) -> Dict[str, Slot]:
    """Reference key → slot for every target of `module`; `rename` gives a
    port key's reference key, or a tuple of keys whose tensors are its row
    blocks; reference keys matching `squeeze` carry a trailing axis of 1."""
    slots = {}
    for pk in _targets(module):
        refs = rename(pk)
        refs = (refs,) if isinstance(refs, str) else refs
        for i, rk in enumerate(refs):
            slots[rk] = Slot(pk, i, len(refs), bool(squeeze and re.search(squeeze, rk)))
    return slots


# ------------------------------------------------------------------ the PSNs

_TATT_INFOGEN = _rules([
    (r"^infoGen\.transformer\.init_factor$", "infoGen.init_factor.weight"),
    (r"^infoGen\.transformer\.(encoder|decoder)\.(\d+)\.", r"infoGen.upsample_transformer.\1.layers.\2."),
    (r"^infoGen\.transformer\.decoder_norm\.", "infoGen.upsample_transformer.decoder.norm."),
    (r"^infoGen\.transformer\.", "infoGen.upsample_transformer."),
])
_TBSRN_SRB = _rules([
    (r"^feature_enhancer\.(w_[12])\.", r"feature_enhancer.pff.\1."),
    (r"^feature_enhancer\.multihead\.out_proj\.", "feature_enhancer.multihead.linears.3."),
])


def _psn_map(psn) -> KeyMap:
    """The skeleton every PSN shares (convert.py:118-148, convert_psn.py):
    conv_in ← block1.0, prelu ← block1.1, srbs.{i} ← block{i+2},
    conv_mid / bn_mid ← block{n+2}.0 / .1, upsample.{j} ← block{n+3}.{j}.conv,
    conv_out ← block{n+3}.{n_up}; TSRN_TL's infoGen under its own names,
    TATT's TPInterpreter under the reference's."""
    from .models.tatt import TSRN_TL_TRANS
    from .models.tbsrn import TBSRN

    n, n_up = len(psn.srbs), len(psn.upsample)
    fixed = {"conv_in": "block1.0", "prelu": "block1.1", "conv_mid": f"block{n + 2}.0",
             "bn_mid": f"block{n + 2}.1", "conv_out": f"block{n + 3}.{n_up}"}

    def rename(pk):
        head, _, rest = pk.partition(".")
        if head in fixed:
            return f"{fixed[head]}.{rest}"
        if head == "upsample":
            j, _, rest = rest.partition(".")
            return f"block{n + 3}.{j}.conv.{rest}"
        if head == "srbs":
            i, _, rest = rest.partition(".")
            if rest.startswith("feature_enhancer.multihead.in_proj_"):
                leaf = rest.rsplit("_", 1)[1]  # weight / bias
                return tuple(f"block{int(i) + 2}.feature_enhancer.multihead.linears.{k}.{leaf}" for k in range(3))
            return f"block{int(i) + 2}.{_TBSRN_SRB(rest)}"
        return _TATT_INFOGEN(pk) if isinstance(psn, TSRN_TL_TRANS) else pk

    dead = (NUM_BATCHES, r"stn_head\..*", r"tps\..*")
    if isinstance(psn, TBSRN):
        dead += (r"conv\.(weight|bias)", r"bn\..*", r"block\d+\.gru[12]\..*")
    if isinstance(psn, TSRN_TL_TRANS):
        dead += (r"infoGen\.upsample_transformer\.decoder\.layers\.\d+\.(self_attn|norm1)\..*",)
    return KeyMap(_slots(psn, rename), dead, {})


# ------------------------------------------------------- CRNN, VisionLAN

def _crnn_map(crnn) -> KeyMap:
    rename = _rules([(r"^convs\.(\d)\.", r"cnn.conv\1."), (r"^bns\.(\d)\.", r"cnn.batchnorm\1."),
                     (r"^rnn1\.", "rnn.0."), (r"^rnn2\.", "rnn.1.")])
    return KeyMap(_slots(crnn, rename), (NUM_BATCHES,), {})


VISIONLAN_LAYERS = (3, 4, 6, 6, 3)  # ResNet45's blocks per layer (convert_zoo.py:184)


def _visionlan_map(vl) -> KeyMap:
    """backbone.conv1 ← backbone.conv1_new, the flat blocks ←
    backbone.layer{1..5}.{j}, the encoder ← MLM_VRM.SequenceModeling
    (layer_stack.{i}.slf_attn / pos_ffn), pp and w_vrm ← MLM_VRM.Prediction
    (convert_zoo.py:180-205)."""
    layer_of = [(li, j) for li, nb in enumerate(VISIONLAN_LAYERS, start=1) for j in range(nb)]
    seq = "MLM_VRM.SequenceModeling"
    rules = _rules([
        (r"^backbone\.conv1\.", "backbone.conv1_new."),
        (r"^backbone\.blocks\.(\d+)\.", lambda m: "backbone.layer%d.%d." % layer_of[int(m[1])]),
        (r"^SequenceModeling\.layers\.(\d+)\.(w_qs|w_ks|w_vs|fc)\.", rf"{seq}.layer_stack.\1.slf_attn.\2."),
        (r"^SequenceModeling\.layers\.(\d+)\.attn_norm\.", rf"{seq}.layer_stack.\1.slf_attn.layer_norm."),
        (r"^SequenceModeling\.layers\.(\d+)\.(w_1|w_2)\.", rf"{seq}.layer_stack.\1.pos_ffn.\2."),
        (r"^SequenceModeling\.layers\.(\d+)\.ffn_norm\.", rf"{seq}.layer_stack.\1.pos_ffn.layer_norm."),
        (r"^SequenceModeling\.norm\.", f"{seq}.layer_norm."),
        (r"^(pp|w_vrm)\.", r"MLM_VRM.Prediction.\1."),
    ])
    dead = (NUM_BATCHES, r"MLM_VRM\.MLM\..*", r"MLM_VRM\.Prediction\.(pp_share|w_share)\..*")
    return KeyMap(_slots(vl, rules, squeeze=r"pos_ffn\.w_[12]\.weight$"), dead, {})


# ------------------------------------------------------------- PGRM, CMM

def _pgrm_map(pgrm) -> KeyMap:
    """patch_embed ← patch_embed.proj, patch_norm ← patch_embed.norm, each
    block's SKConv ← attn.sknet and its Mlp convs ← mlp.depthwise_conv /
    pointwise_conv, weight_list.{i} ← weight_list_{i} (convert_zoo.py:
    262-299); the attention's relative_position_index_{i} and attn_mask_{i}
    held equal to the port's rel_index_{i} and shift_mask_{i}."""
    rename = _rules([
        (r"^patch_embed\.", "patch_embed.proj."), (r"^patch_norm\.", "patch_embed.norm."),
        (r"\.attn\.SKConv\.", ".attn.sknet."), (r"\.mlp\.dwconv\.", ".mlp.depthwise_conv."),
        (r"\.mlp\.pwconv\.", ".mlp.pointwise_conv."), (r"^weight_list\.(\d+)$", r"weight_list_\1"),
    ])
    derived = {}
    for li, layer in enumerate(pgrm.layers):
        for bi, blk in enumerate(layer.blocks):
            a, att = f"layers.{li}.blocks.{bi}.attn", blk.attn
            for i, (ws, shift) in enumerate(zip(att.win, att.shf)):
                derived[f"{a}.relative_position_index_{i}"] = getattr(att, f"rel_index_{i}").reshape(ws * ws, ws * ws)
                if shift > 0:
                    derived[f"{a}.attn_mask_{i}"] = getattr(att, f"shift_mask_{i}")
    return KeyMap(_slots(pgrm, rename), (NUM_BATCHES,), derived)


def _cmm_map(cmm) -> KeyMap:
    """en_{k}_{t}.conv1 / bn1 / conv2 / bn2 ← .encode.1 / .2 / .4 / .5,
    en_6_{t} ← en_6_{t}.1, de_6_conv / de_6_bn ← de_6.1 / .2, de_{k}'s
    deconv1 / bn1 / deconv2 / bn2 ← .decode.1 / .2 / .4 / .5, de_1_conv ←
    de_1.1 (convert_zoo.py:232-260)."""
    seq = {"conv1": 1, "bn1": 2, "conv2": 4, "bn2": 5, "deconv1": 1, "deconv2": 4}
    rename = _rules([
        (r"^(en_[2-5]_[12])\.(conv1|bn1|conv2|bn2)\.", lambda m: f"{m[1]}.encode.{seq[m[2]]}."),
        (r"^(de_[2-5])\.(deconv1|bn1|deconv2|bn2)\.", lambda m: f"{m[1]}.decode.{seq[m[2]]}."),
        (r"^(en_6_[12])\.", r"\1.1."), (r"^de_6_conv\.", "de_6.1."), (r"^de_6_bn\.", "de_6.2."),
        (r"^de_1_conv\.", "de_1.1."),
    ])
    return KeyMap(_slots(cmm, rename), (NUM_BATCHES,), {})


def key_map(module: nn.Module) -> KeyMap:
    """The reference key map of a PSN, CRNN, VisionLAN, PGRM or CMM at its
    geometry."""
    from .models.cmm import CMM
    from .models.crnn import CRNN
    from .models.pgrm import PGRM
    from .models.tsrn import PSN
    from .models.visionlan import VisionLAN

    for cls, fn in ((PSN, _psn_map), (CRNN, _crnn_map), (VisionLAN, _visionlan_map), (PGRM, _pgrm_map),
                    (CMM, _cmm_map)):
        if isinstance(module, cls):
            return fn(module)
    raise TypeError(f"no reference key map for {type(module).__name__}")


# --------------------------------------------------------------- loading

def convert_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor], source: str = "checkpoint",
                       kmap: KeyMap = None) -> Dict[str, torch.Tensor]:
    """The reference state dict `sd` as the port's tensors for `module`
    (port key → tensor), checked strictly against the module's key map;
    `source` names the file in the errors."""
    kmap = kmap or key_map(module)
    port = module.state_dict()
    parts: Dict[str, dict] = {}
    for rk, v in sd.items():
        if rk in kmap.slots:
            s = kmap.slots[rk]
            want = list(port[s.port].shape)
            want[0] //= s.parts
            want += [1] if s.squeeze else []
            if list(v.shape) != want:
                raise ValueError(f"{source}: {rk} has shape {tuple(v.shape)}; the port's {s.port} takes "
                                 f"{tuple(want)}")
            parts.setdefault(s.port, {})[s.part] = v[..., 0] if s.squeeze else v
        elif rk in kmap.derived:
            table = kmap.derived[rk]
            if tuple(v.shape) != tuple(table.shape) or not torch.equal(v.to(table.device, table.dtype), table):
                raise ValueError(f"{source}: {rk} differs from the table the port derives from the geometry")
        elif not any(re.fullmatch(p, rk) for p in kmap.dead):
            raise KeyError(f"{source}: unexpected key {rk!r}: no tensor of the port's {type(module).__name__} "
                           "takes it")
    missing = [rk for rk, s in kmap.slots.items() if s.part not in parts.get(s.port, {})]
    if missing:
        raise KeyError(f"{source}: missing key {missing[0]!r}" + (f" and {len(missing) - 1} more" if
                                                                   len(missing) > 1 else ""))
    return {pk: torch.cat([ps[i] for i in range(len(ps))]) if len(ps) > 1 else ps[0] for pk, ps in parts.items()}


def load_into(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy port-keyed tensors (from `convert_state_dict`) into `module` in
    place, cast to its dtype and device."""
    live = module.state_dict(keep_vars=True)
    with torch.no_grad():
        for k, v in state.items():
            live[k].copy_(v)


def load_reference(module: nn.Module, sd: Dict[str, torch.Tensor], source: str = "checkpoint") -> None:
    """`convert_state_dict` then `load_into`: nothing is written unless the
    whole file checks out."""
    load_into(module, convert_state_dict(module, sd, source))


def _reference_state_dict(module: nn.Module, dead: bool = True) -> Dict[str, torch.Tensor]:
    """The inverse of the key map: `module`'s tensors under the reference's
    names (CPU copies), the derived tables beside them and, with `dead`, one
    tensor of each dead family the module's map names (each BatchNorm's
    num_batches_tracked; a PSN's STN; TBSRN's head and GRUs; TATT's decoder
    self-attention; VisionLAN's MLM branch) — a file as the reference writes
    it, for checks of the loader."""
    kmap = key_map(module)
    port = module.state_dict()
    sd = {}
    for rk, s in kmap.slots.items():
        t = port[s.port].detach().cpu()
        t = t.chunk(s.parts)[s.part] if s.parts > 1 else t
        sd[rk] = (t[..., None] if s.squeeze else t).clone()
    sd.update({rk: t.detach().cpu().clone() for rk, t in kmap.derived.items()})
    if dead:
        sd.update({rk: torch.tensor(7) for rk in port if re.fullmatch(NUM_BATCHES, rk)})
        for pattern, key in ((r"stn_head\..*", "stn_head.stn_fc2.weight"), (r"tps\..*", "tps.inverse_kernel"),
                             (r"bn\..*", "bn.running_mean"), (r"conv\.(weight|bias)", "conv.weight"),
                             (r"block\d+\.gru[12]\..*", "block2.gru1.gru.weight_hh_l0"),
                             (r"infoGen\.upsample_transformer\.decoder\.layers\.\d+\.(self_attn|norm1)\..*",
                              "infoGen.upsample_transformer.decoder.layers.0.self_attn.in_proj_weight"),
                             (r"MLM_VRM\.MLM\..*", "MLM_VRM.MLM.pos_embedding.weight"),
                             (r"MLM_VRM\.Prediction\.(pp_share|w_share)\..*", "MLM_VRM.Prediction.w_share.weight")):
            if pattern in kmap.dead:
                sd[key] = torch.linspace(-1.0, 1.0, 12).reshape(3, 4)
    return sd
