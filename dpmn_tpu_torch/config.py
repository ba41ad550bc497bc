"""Configuration dataclasses and the PGRM hyper-parameter parser.

Counterpart of dpmn_tpu/config.py for the eval path and the train step: the
fields they read, without the YAML loader and the CLI, which this port does
not carry yet (the Trainer's and the data's fields come with the slices
that read them).  The PGRM hyper-parameter strings are comma
lists parsed with eval() semantics, window sizes grouped by `window_num` per
layer and num_heads grouped by depth (reference interfaces/base.py:64-82).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def _eval_list(s: str) -> list:
    v = eval(s)  # noqa: S307 — parity with the reference's base.py:64-82
    return list(v) if isinstance(v, (tuple, list)) else [v]


@dataclass
class TrainCfg:
    """The fields of dpmn_tpu's TrainCfg that the eval path and the train
    step read."""

    batch_size: int = 1024
    width: int = 128
    height: int = 32
    down_sample_scale: int = 2
    lr: float = 0.001
    optimizer: str = "Adam"  # "Adam" | "AdamW"
    beta1: float = 0.5


@dataclass
class Args:
    """The fields of the reference CLI (main.py:36-68) that the eval path and
    the train step read, plus dpmn_tpu's `faithful`."""

    arch: str = "tsrn"
    mask: bool = False
    gradient: bool = False
    hd_u: int = 32
    srb: int = 5
    patch_size: str = "4,"
    embed_dim: str = "96,"
    window_size: str = "2,"
    depths: str = "1,"
    num_heads: str = "6,"
    mlp_ratio: str = "4,"
    drop_rate: str = "0,"
    attn_drop_rate: str = "0,"
    drop_path_rate: str = "0.1,"
    stu_iter_b1: int = 1
    stu_iter_b2: int = 1
    font_path: Optional[str] = None
    sr_share: bool = False
    alpha: float = 0.5
    window_num: int = 3
    faithful: bool = True  # reproduce the reference's layout quirks


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
