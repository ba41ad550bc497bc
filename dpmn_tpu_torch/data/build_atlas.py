"""Build the glyph atlas tables that the device glyph prior composes from.

The tables are rendered once on a host with pygame, which the machine with
the card does not have, and committed as `dpmn_tpu_torch/assets/
glyph_atlas_32x128.npz`.  This is the JAX package's `_render_char_native` /
`build_atlas` (dpmn_tpu/data/glyph_atlas.py:64-151) with the font path as an
argument; the committed file is built from the JAX package's default font:

    python -m dpmn_tpu_torch.data.build_atlas --font dpmn_tpu/assets/arial.ttf \\
        --out dpmn_tpu_torch/assets/glyph_atlas_32x128.npz

Every cell value is an integer alpha of at most 255, so the cells are stored
as uint8; the ink bands, advances and em-unit selection tables are stored as
they are computed.
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np

from ..utils.labels import DIC_36
from .glyph_atlas import NCELL, SIZE_MAX, SIZE_MIN, SIZE_REF


@functools.lru_cache(maxsize=1)
def _pygame():
    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    import pygame
    from pygame import freetype

    pygame.init()
    freetype.init()
    return pygame, freetype


def _render_char_native(font, ch: str, size: int):
    """One char at `size` on a fixed baseline in a native (NCELL, NCELL) cell.

    Returns (cell, top, bot, adv, ink_l, ink_r, ascent) in native px."""
    pygame, _ = _pygame()
    import pygame.locals

    font.size = int(size)
    band_h = min(max(int(round(size / 0.72)), 4), NCELL)
    baseline = int(band_h * 0.78)
    x0 = band_h
    metrics = font.get_metrics(ch)
    adv = max(int(round(metrics[0][4])) if metrics and metrics[0] else 1, 1)
    adv = min(adv, NCELL)
    surf = pygame.Surface((x0 + 3 * band_h + adv, 2 * band_h), pygame.locals.SRCALPHA, 32)
    font.render_to(surf, (x0, baseline), ch)
    arr = pygame.surfarray.pixels_alpha(surf).swapaxes(0, 1)[:band_h].astype(np.float32)
    box = arr[:, x0 : x0 + adv]
    cell = np.zeros((NCELL, NCELL), np.float32)
    cell[:band_h, :adv] = box
    ink = np.where(box > 20)
    if ink[0].size == 0:
        return cell, NCELL // 2, NCELL // 2 + 1, float(adv), 0.0, float(adv), 0.0
    top, bot = int(ink[0].min()), int(ink[0].max()) + 1
    ink_l, ink_r = float(ink[1].min()), float(ink[1].max()) + 1.0
    return cell, top, bot, float(adv), ink_l, ink_r, float(baseline - top)


def build_atlas(font_path: str) -> dict:
    """The atlas tables for `font_path`, keyed as in the .npz file."""
    _, freetype = _pygame()
    font = freetype.Font(font_path)
    font.antialiased = True
    font.origin = True
    n = len(DIC_36)
    n_sizes = SIZE_MAX - SIZE_MIN + 1
    atlas = np.zeros((n_sizes, 2, n + 1, NCELL, NCELL), np.float32)
    tops = np.full((n_sizes, 2, n + 1), NCELL, np.int32)  # blank = neutral band
    bots = np.zeros((n_sizes, 2, n + 1), np.int32)
    advs = np.ones((n_sizes, 2, n + 1), np.float32)
    inkls = np.zeros((n_sizes, 2, n + 1), np.float32)
    inkrs = np.ones((n_sizes, 2, n + 1), np.float32)
    sel = np.zeros((4, 2, n + 1), np.float32)  # ascent, adv, inkl, inkr in em units
    sel[1] = sel[3] = 1.0 / SIZE_REF
    for i, ch in enumerate(DIC_36):
        for case, c in ((0, ch), (1, ch.upper())):
            for si, size in enumerate(range(SIZE_MIN, SIZE_MAX + 1)):
                cell, top, bot, adv, ink_l, ink_r, _ = _render_char_native(font, c, size)
                atlas[si, case, i + 1] = cell
                tops[si, case, i + 1], bots[si, case, i + 1] = top, bot
                advs[si, case, i + 1], inkls[si, case, i + 1], inkrs[si, case, i + 1] = adv, ink_l, ink_r
            _, _, _, adv_r, inkl_r, inkr_r, asc_r = _render_char_native(font, c, SIZE_REF)
            sel[:, case, i + 1] = np.array([asc_r, adv_r, inkl_r, inkr_r], np.float32) / SIZE_REF
    if not (np.array_equal(atlas, np.round(atlas)) and atlas.min() >= 0 and atlas.max() <= 255):
        raise ValueError("atlas cells are not uint8 values")
    return {"atlas": atlas.astype(np.uint8), "tops": tops, "bots": bots, "advs": advs, "inkls": inkls,
            "inkrs": inkrs, "sel": sel}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--font", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    np.savez_compressed(a.out, **build_atlas(a.font))


if __name__ == "__main__":
    main()
