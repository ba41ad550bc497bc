"""The geometries the hand-written kernels take, checked without a card.

One plain function per kernel family, called by its wrappers before any
launch and by the CPU tests:

  * `check_window_geometry`: the window-attention kernels (K1's eval block,
    the training cores K3, K4, K5, and K7's grouped attention), whose
    forward and backward run csrc/window_common.cuh and
    csrc/window_train_common.cuh;
  * `check_gru_hidden`: the GRU scan (K2, csrc/gru_scan.cu).

K8's tiles and K9's masks check theirs in their own modules
(`ops/window_tile_attention.py` `check_tile_geometry`, `ops/dropout_mask.py`
`_launch_geometry`).  Each raises ValueError naming the limit it hit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HEAD_DIMS = (8, 16, 32)  # the head dims the attention kernels are built for (template HD)
WINDOWS = (2, 4, 8)  # window sizes: 2x2 on the CUDA cores, 4x4 and 8x8 on the tensor cores
MAX_DIM = 96  # the widest D the LN + projection and SKConv kernels hold a tile of (multiples of 16)
MAX_GROUPS = 6  # MAX_ATTN_GROUPS of csrc/window_common.cuh
TOKEN_TILE = 64  # tokens a tile of the token-tile kernels (TOK)
SMEM_BYTES = 232448  # dynamic shared memory a block may take on an H100 (227 KiB)
MAX_HIDDEN = 512  # the largest GRU hidden size (LMAX_H of csrc/gru_scan.cu)


def row_backward_smem(n: int, gnum_heads: int, head_dim: int) -> Tuple[int, int]:
    """(threads, shared bytes) of a block of the thread-per-row attention
    backward (window_attn_bwd_kernel), which windows of n = 16 or 64 tokens
    take with more than 2 heads a group."""
    wpb = 1 if n * gnum_heads >= 128 else 128 // (n * gnum_heads)
    floats = 4 * wpb * n * gnum_heads * head_dim + 2 * wpb * gnum_heads * n * (n + 1) + gnum_heads * n * n
    return wpb * gnum_heads * n, 4 * floats


def check_window_geometry(what: str, hw_shape: Sequence[int], l: int, dim: int, window_sizes: Sequence[int],
                          gnum_heads: int, backward: bool = False) -> int:
    """Raise ValueError unless the window-attention kernels take this block:
    L = H*W a multiple of 64, D a multiple of 16 up to 96 in 1 to 6 groups
    (one a window size), each of gnum_heads heads of 8, 16 or 32 channels,
    windows of 2, 4 or 8 dividing the grid; with `backward`, the
    thread-per-row attention backward's block (more than 2 heads a group)
    within the card's threads and shared memory.  Returns the head dim."""
    h, w = hw_shape
    n_group = len(window_sizes)
    if l != h * w or l % TOKEN_TILE:
        raise ValueError(f"{what} kernel: L={l} on a {h}x{w} grid; it takes L = H*W a multiple of {TOKEN_TILE}")
    if dim % 16 or not 16 <= dim <= MAX_DIM:
        raise ValueError(f"{what} kernel: D={dim}; it takes a multiple of 16 up to {MAX_DIM}")
    if not 1 <= n_group <= MAX_GROUPS or dim % n_group:
        raise ValueError(f"{what} kernel: D={dim} in {n_group} groups; it takes 1 to {MAX_GROUPS} groups "
                         f"that divide D")
    channel = dim // n_group
    if gnum_heads < 1 or channel % gnum_heads or channel // gnum_heads not in HEAD_DIMS:
        raise ValueError(f"{what} kernel: head dim {channel}/{gnum_heads}; it takes head dims "
                         f"{', '.join(map(str, HEAD_DIMS))}")
    head_dim = channel // gnum_heads
    for ws in window_sizes:
        if ws not in WINDOWS or h % ws or w % ws:
            raise ValueError(f"{what} kernel: window {ws} on a {h}x{w} grid; it takes windows "
                             f"{', '.join(map(str, WINDOWS))} dividing the grid")
    if backward and gnum_heads > 2:
        for ws in sorted(set(window_sizes) - {2}):
            threads, smem = row_backward_smem(ws * ws, gnum_heads, head_dim)
            if threads > 1024 or smem > SMEM_BYTES:
                raise ValueError(f"{what} kernel: the attention backward of {gnum_heads} heads of {head_dim} on "
                                 f"{ws}x{ws} windows needs {threads} threads and {smem} bytes of shared memory a "
                                 f"block; it takes at most 1024 and {SMEM_BYTES}")
    return head_dim


def check_gru_hidden(hidden: int) -> None:
    """Raise ValueError unless the GRU scan takes hidden size `hidden`: any
    from 1 to 512 (up to 32 the register regime, above it the cooperative
    one)."""
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"gru kernel: hidden size {hidden}; it takes 1 to {MAX_HIDDEN}")
