"""Configuration: the YAML file and the CLI with the reference's flag surface.

Counterpart of dpmn_tpu/config.py: every field of TrainCfg and Args, the
YAML loader and the argument parser (reference main.py:36-71 and
config/super_resolution.yaml), plus one flag of the port's own, `--device`
(the card unless "cpu" is asked for).  The YAML file is read by a small
reader of the subset the repository's configs use (`read_yaml`), so the
port needs no PyYAML.  The PGRM hyper-parameter strings are comma lists
parsed with eval() semantics, window sizes grouped by `window_num` per
layer and num_heads grouped by depth (reference interfaces/base.py:64-82).
"""

from __future__ import annotations

import argparse
import re
from dataclasses import dataclass, field
from typing import List, Optional


def _eval_list(s: str) -> list:
    v = eval(s)  # noqa: S307 — parity with the reference's base.py:64-82
    return list(v) if isinstance(v, (tuple, list)) else [v]


ARCHS = ["tsrn", "tbsrn", "tg", "tpgsr", "tatt"]  # the PSNs --arch names (main.py:37)


@dataclass
class TrainCfg:
    train_data_dir: List[str] = field(default_factory=list)
    batch_size: int = 1024
    width: int = 128
    height: int = 32
    epochs: int = 42000
    ngpu: int = 1
    workers: int = 16
    resume: str = ""
    ckpt_dir: str = "./ckpt"
    voc_type: str = "all"
    saveInterval: int = 20
    displayInterval: int = 20
    lr: float = 0.001
    optimizer: str = "Adam"  # "Adam" | "AdamW"
    beta1: float = 0.5
    manualSeed: int = 2
    max_len: int = 100
    down_sample_scale: int = 2
    val_data_dir: List[str] = field(default_factory=list)
    n_vis: int = 10
    vis_dir: str = "./vis"
    valInterval: int = 80
    rec_pretrained: str = ""
    moran_pretrained: str = ""
    crnn_pretrained: str = ""
    visionlan_pretrained: str = ""


@dataclass
class Args:
    """The 31 reference CLI flags (main.py:36-68), dpmn_tpu's extras and the
    port's `device`."""

    arch: str = "tsrn"
    test: bool = False
    # relative to the working directory (dpmn_tpu's default is an absolute path)
    test_data_dir: str = "data/TextZoom/test/easy"
    batch_size: Optional[int] = None
    resume: Optional[str] = None
    vis_dir: Optional[str] = None
    rec: str = "aster"
    mask: bool = False
    gradient: bool = False
    hd_u: int = 32
    srb: int = 5
    STN: bool = False
    patch_size: str = "4,"
    embed_dim: str = "96,"
    window_size: str = "2,"
    depths: str = "1,"
    num_heads: str = "6,"
    mlp_ratio: str = "4,"
    drop_rate: str = "0,"
    attn_drop_rate: str = "0,"
    drop_path_rate: str = "0.1,"
    rotate_train: float = 0.0
    rotate_test: float = 0.0
    stu_iter_b1: int = 1
    stu_iter_b2: int = 1
    tpg: str = "visionlan"
    rec_path: Optional[str] = None
    font_path: Optional[str] = None
    sr_share: bool = False
    alpha: float = 0.5
    window_num: int = 3
    # dpmn_tpu's extras (not in the reference surface)
    synthetic_data: bool = False
    faithful: bool = True  # reproduce the reference's layout quirks
    data_parallel: int = 0
    debug_nans: bool = False  # torch.autograd anomaly detection
    # microbatches per optimizer step (batch_size is the global batch)
    grad_accum: int = 1
    # the port's own: the device entry points run on (None: the card)
    device: Optional[str] = None


@dataclass
class PGRMHParams:
    """Parsed per-iteration PGRM hyper-parameters (base.py:64-82)."""

    depths: list
    patch_size: list
    embed_dim: list
    window_size: list  # list (per iter) of lists (per-layer window group)
    num_heads: list  # list (per iter) of per-layer head counts
    mlp_ratio: list
    drop_rate: list
    attn_drop_rate: list
    drop_path_rate: list


def parse_pgrm_hparams(args: Args) -> PGRMHParams:
    depths = _eval_list(args.depths)
    window_size_temp = _eval_list(args.window_size)
    window_size, pre = [], 0
    for _ in depths:
        window_size.append(window_size_temp[pre : pre + args.window_num])
        pre += args.window_num
    num_heads_temp = _eval_list(args.num_heads)
    num_heads, pre = [], 0
    for layer_num in depths:
        num_heads.append(num_heads_temp[pre : pre + layer_num])
        pre += layer_num
    return PGRMHParams(
        depths=depths,
        patch_size=_eval_list(args.patch_size),
        embed_dim=_eval_list(args.embed_dim),
        window_size=window_size,
        num_heads=num_heads,
        mlp_ratio=_eval_list(args.mlp_ratio),
        drop_rate=_eval_list(args.drop_rate),
        attn_drop_rate=_eval_list(args.attn_drop_rate),
        drop_path_rate=_eval_list(args.drop_path_rate),
    )


def flagship_args(**overrides) -> Args:
    """The flagship configuration: TATT PSN + DPMN dual 3+3 branch at embed 96
    with windows 2/4/8 and 6 heads (the reference README's training command;
    what the JAX package's bench runs, __graft_entry__.py:34-55), with its
    training flags: the gradient-prior loss and drop / attn_drop / drop_path
    rates of 0.1.  Eval ignores them."""
    base = dict(
        arch="tatt",
        mask=True,
        gradient=True,
        stu_iter_b1=3,
        stu_iter_b2=3,
        patch_size="2,2,2,2,2,2,",
        embed_dim="96,96,96,96,96,96,",
        window_size="2,4,8,2,4,8,2,4,8,2,4,8,2,4,8,2,4,8,",
        depths="1,1,1,1,1,1,",
        num_heads="6,6,6,6,6,6,",
        mlp_ratio="4,4,4,4,4,4,",
        drop_rate="0.1,0.1,0.1,0.1,0.1,0.1,",
        attn_drop_rate="0.1,0.1,0.1,0.1,0.1,0.1,",
        drop_path_rate="0.1,0.1,0.1,0.1,0.1,0.1,",
        alpha=0.5,
    )
    base.update(overrides)
    return Args(**base)


# The JAX package's two small geometries (__graft_entry__.py:180-193), on the
# flagship's flags: one SRB of 4 hidden units, 1 + 1 PGRMs.  "mid" runs the
# real 32x128 image at embed 48, 6 heads over windows 2 / 4 / 8 (head dim
# 8); "toy" a 32x32 image (TrainCfg(width=32, height=32)) at embed 16, 2
# heads over windows 2 / 4 (head dim 8).
_SMALL = dict(stu_iter_b1=1, stu_iter_b2=1, srb=1, hd_u=4, patch_size="2,", depths="1,", mlp_ratio="4,",
              drop_rate="0.1,", attn_drop_rate="0.1,", drop_path_rate="0.1,")


def mid_args(**overrides) -> Args:
    """The "mid" geometry: embed 48, windows 2 / 4 / 8, 6 heads."""
    return flagship_args(**{**_SMALL, "embed_dim": "48,", "num_heads": "6,", "window_size": "2,4,8,",
                            "window_num": 3, **overrides})


def toy_args(**overrides) -> Args:
    """The "toy" geometry: embed 16, windows 2 / 4, 2 heads (32x32 images)."""
    return flagship_args(**{**_SMALL, "embed_dim": "16,", "num_heads": "2,", "window_size": "2,4,",
                            "window_num": 2, **overrides})


# ------------------------------------------------------------------ YAML

_BOOLS = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
          **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False)}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?")
# plain scalars PyYAML would read as something this reader does not: other
# int bases, sexagesimal numbers, inf / nan, timestamps, merge keys
_OTHER = re.compile(r"[-+]?0[0-7_]+|[-+]?0[bx].*|.*:[0-5]?[0-9]|[-+]?\.(?:inf|Inf|INF|nan|NaN|NAN)|"
                    r"\d{4}-\d\d?-\d\d?.*|<<")


class YamlSubsetError(ValueError):
    """The file uses YAML this reader does not handle."""


def _strip_comment(line: str) -> str:
    """The line without a trailing `# comment` (a '#' at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str):
    """One scalar as yaml.safe_load resolves it (YAML 1.1 core types)."""
    t = text.strip()
    if t[:1] == "'":
        if len(t) < 2 or t[-1] != "'":
            raise YamlSubsetError(f"unterminated quoted scalar {t!r}")
        body = t[1:-1]
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise YamlSubsetError(f"bad single-quoted scalar {t!r}")
        return body.replace("''", "'")
    if t[:1] == '"':
        if len(t) < 2 or t[-1] != '"':
            raise YamlSubsetError(f"unterminated quoted scalar {t!r}")
        body = t[1:-1]
        if "\\" in body or '"' in body:
            raise YamlSubsetError(f"escapes in double-quoted scalars are not supported: {t!r}")
        return body
    if t[:1] in tuple("[]{}&*!|>%@`") or t == "-" or t.startswith("- "):
        raise YamlSubsetError(f"unsupported YAML value {t!r}")
    if t in _NULLS:
        return None
    if t in _BOOLS:
        return _BOOLS[t]
    if _INT.fullmatch(t):
        return int(t.replace("_", ""))
    if _FLOAT.fullmatch(t):
        return float(t.replace("_", ""))
    if _OTHER.fullmatch(t) or ": " in t or t.endswith(":"):
        raise YamlSubsetError(f"unsupported YAML value {t!r}")
    return t


def _split_flow(body: str) -> list:
    """The items of a flow list's body: commas outside quotes split it."""
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur)
            cur = ""
        elif ch in "[]{}":
            raise YamlSubsetError("nested flow collections are not supported")
        else:
            cur += ch
    if quote:
        raise YamlSubsetError("unterminated quoted scalar in a flow list")
    items.append(cur)
    if items and not items[-1].strip():  # a trailing comma, or an empty list
        items.pop()
    if any(not it.strip() for it in items):
        raise YamlSubsetError("empty entry in a flow list")
    return [_scalar(it) for it in items]


def read_yaml(text: str):
    """Parse the YAML subset the repository's configs use: block mappings
    nested by indentation, plain / single-quoted / double-quoted scalars
    (without escapes), flow lists of scalars that may run over several
    lines, and comments.  Anything else raises YamlSubsetError."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"line {n}: tab indentation")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.strip() in ("---", "...") or body.lstrip().startswith("%"):
            raise YamlSubsetError(f"line {n}: documents and directives are not supported")
        lines.append((n, len(body) - len(body.lstrip()), body.strip()))
    if not lines:
        return None
    pos = 0

    def mapping(indent: int) -> dict:
        nonlocal pos
        out = {}
        while pos < len(lines):
            n, ind, body = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"line {n}: unexpected indentation")
            m = re.fullmatch(r"([A-Za-z_][\w.-]*)\s*:(?:\s+(.*))?|([A-Za-z_][\w.-]*):", body)
            if not m:
                raise YamlSubsetError(f"line {n}: not a 'key: value' line: {body!r}")
            key, value = m.group(1) or m.group(3), (m.group(2) or "").strip()
            if key in out:
                raise YamlSubsetError(f"line {n}: duplicate key {key!r}")
            pos += 1
            if value.startswith("["):
                text_ = value
                while text_.count("[") > text_.count("]") and pos < len(lines):
                    text_ += " " + lines[pos][2]
                    pos += 1
                if not text_.endswith("]") or text_.count("[") != 1 or text_.count("]") != 1:
                    raise YamlSubsetError(f"line {n}: malformed flow list")
                out[key] = _split_flow(text_[1:-1])
            elif value:
                out[key] = _scalar(value)
            elif pos < len(lines) and lines[pos][1] > indent:
                out[key] = mapping(lines[pos][1])
            else:
                out[key] = None
        return out

    result = mapping(lines[0][1])
    if pos != len(lines):
        raise YamlSubsetError(f"line {lines[pos][0]}: unexpected dedent")
    return result


def load_train_cfg(path: str = None) -> TrainCfg:
    cfg = TrainCfg()
    if path:
        with open(path) as f:
            raw = read_yaml(f.read()) or {}
        tr = raw.get("TRAIN", {}) or {}
        val = tr.pop("VAL", {}) or {}
        for k, v in {**tr, **val}.items():
            if hasattr(cfg, k) and v is not None:
                setattr(cfg, k, v)
    return cfg


# ------------------------------------------------------------------- CLI

def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dpmn_tpu_torch")
    p.add_argument("--arch", default="tsrn", choices=ARCHS)
    p.add_argument("--test", action="store_true", default=False)
    p.add_argument("--test_data_dir", type=str, default=Args.test_data_dir)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--vis_dir", type=str, default=None)
    p.add_argument("--rec", default="aster", choices=["aster", "moran", "crnn"])
    p.add_argument("--mask", action="store_true", default=False)
    p.add_argument("--gradient", action="store_true", default=False)
    p.add_argument("--hd_u", type=int, default=32)
    p.add_argument("--srb", type=int, default=5)
    p.add_argument("--STN", action="store_true", default=False)
    p.add_argument("--patch_size", type=str, default="4,")
    p.add_argument("--embed_dim", type=str, default="96,")
    p.add_argument("--window_size", type=str, default="2,")
    p.add_argument("--depths", type=str, default="1,")
    p.add_argument("--num_heads", type=str, default="6,")
    p.add_argument("--mlp_ratio", type=str, default="4,")
    p.add_argument("--drop_rate", type=str, default="0,")
    p.add_argument("--attn_drop_rate", type=str, default="0,")
    p.add_argument("--drop_path_rate", type=str, default="0.1,")
    p.add_argument("--rotate_train", type=float, default=0.0)
    p.add_argument("--rotate_test", type=float, default=0.0)
    p.add_argument("--stu_iter_b1", type=int, default=1)
    p.add_argument("--stu_iter_b2", type=int, default=1)
    p.add_argument("--tpg", default="visionlan", type=str, choices=["aster", "moran", "crnn", "visionlan"])
    p.add_argument("--rec_path", type=str, default=None)
    p.add_argument("--font_path", type=str, default=None)
    p.add_argument("--sr_share", action="store_true", default=False)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--window_num", type=int, default=3)
    p.add_argument("--config", type=str, default="config/super_resolution.yaml")
    p.add_argument("--synthetic_data", action="store_true", default=False)
    p.add_argument("--corrected", action="store_true", default=False, help="disable faithful quirks")
    p.add_argument("--data_parallel", type=int, default=0)
    p.add_argument("--debug_nans", action="store_true", default=False)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step (batch_size is global)")
    p.add_argument("--device", type=str, default=None,
                   help="the device to run on: the card unless 'cpu' is asked for")
    return p


def args_from_namespace(ns) -> Args:
    a = Args()
    for k in vars(a):
        if hasattr(ns, k):
            setattr(a, k, getattr(ns, k))
    if getattr(ns, "corrected", False):
        a.faithful = False
    return a
