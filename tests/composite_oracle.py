"""Numpy reference for the painter's-order composite (ops/composite.py).

Independent of the device code: one tile at a time, one painter slot at a
time, over the plan's FULL per-tile op table (before occlusion culling,
static-clip resolution and bucketing), from the entries' winding planes.
Semantics (vg.cpp:1162-1287 + src/shaders/*.sc): fill rule -> coverage,
non-AA threshold, textured quads carry coverage in their color tile,
pixel-centre scissor, solid / gradient / vertex-colour / texture shading,
clip add / commit / reset as a stencil mask, coverage averaged over ss
sub-rows, premultiplied src-over.
"""

from __future__ import annotations

import numpy as np

from vgtpu.raster.binning import (
    K_CLIP_ADD,
    K_CLIP_COMMIT,
    K_CLIP_RESET,
    K_DRAW,
    P_GRADIENT,
    P_IMAGE,
    P_TEXTURE,
    P_TRI,
)


def _sdroundrect(ux, uy, ex, ey, rad):
    dx = np.abs(ux) - (ex - rad)
    dy = np.abs(uy) - (ey - rad)
    return (np.minimum(np.maximum(dx, dy), 0.0)
            + np.hypot(np.maximum(dx, 0.0), np.maximum(dy, 0.0)) - rad)


def composite_image(plan, entry_w, color_tiles, background, ss: int = 1,
                    tie: float = 1e-4):
    """plan: FramePlan; entry_w: (NE, TH, TW) winding incl. backdrop, TH in
    sub-rows; color_tiles: (NCT, TH/ss, TW, 4).

    Returns ((H, W, 4) f64 image, (H, W) bool mask of pixels where a non-AA
    threshold met coverage within `tie` of 1/2: there the decision turns on
    the last bits of a winding sum, which the device computes in its own
    order)."""
    th, tw = plan.tile_h, plan.tile_w
    th_o = th // ss
    w_all = np.asarray(entry_w, np.float64)
    ct_all = np.asarray(color_tiles, np.float64)
    bg = np.asarray(background, np.float64)
    iy, ix = np.mgrid[0:th, 0:tw].astype(np.float64)
    iy_o, ix_o = np.mgrid[0:th_o, 0:tw].astype(np.float64)
    img = np.zeros((plan.nty * th_o, plan.ntx * tw, 4))
    ties = np.zeros((plan.nty * th_o, plan.ntx * tw), bool)
    for t in range(plan.ntx * plan.nty):
        ox, oy = (t % plan.ntx) * tw, (t // plan.ntx) * th
        pxc, pyc = ox + ix + 0.5, oy + iy + 0.5
        px_o, py_o = ox + ix_o + 0.5, oy / ss + iy_o + 0.5
        fb = np.broadcast_to(bg, (th_o, tw, 4)).copy()
        mask = np.ones((th, tw))
        accum = np.zeros((th, tw))
        tied = np.zeros((th, tw), bool)
        for e in plan.tile_entries[t]:
            if e < 0:
                continue
            w = w_all[e]
            kind, rule = plan.entry_kind[e], plan.entry_rule[e]
            pk, paint = plan.entry_paint_kind[e], plan.entry_paint[e].astype(np.float64)
            if rule == 0:
                cov = np.minimum(np.abs(w), 1.0)
            else:
                cov = 1.0 - np.abs(np.mod(w, 2.0) - 1.0)
            if not plan.entry_aa[e]:
                tied |= np.abs(cov - 0.5) < tie
                cov = (cov >= 0.5).astype(np.float64)
            if pk == P_TEXTURE:
                cov = np.ones_like(cov)
            x0, y0, x1, y1 = plan.entry_scissor[e]
            cov = cov * ((pxc >= x0) & (pyc >= y0) & (pxc < x1) & (pyc < y1))
            if kind == K_CLIP_ADD:
                accum = accum + cov
            elif kind == K_CLIP_COMMIT:
                mask = (accum > 0.5) if rule == 0 else ~(accum > 0.5)
                mask = mask.astype(np.float64)
                accum = np.zeros_like(accum)
            elif kind == K_CLIP_RESET:
                mask = np.ones_like(mask)
            if kind != K_DRAW:
                continue
            inner, outer = paint[10:14], paint[14:18]
            col = np.broadcast_to(inner, (th_o, tw, 4))
            if pk == P_GRADIENT:
                m = paint[0:6]
                ux = m[0] * px_o + m[2] * py_o + m[4]
                uy = m[1] * px_o + m[3] * py_o + m[5]
                feather = max(paint[9], 1e-6)
                d = np.clip((_sdroundrect(ux, uy, paint[6], paint[7], paint[8])
                             + feather * 0.5) / feather, 0.0, 1.0)[..., None]
                col = inner * (1.0 - d) + outer * d
            elif pk == P_TRI:
                col = (paint[0:4] * px_o[..., None] + paint[4:8] * py_o[..., None]
                       + paint[8:12])
            c = (cov * mask).reshape(th_o, ss, tw).mean(axis=1)
            cti = plan.entry_color_tile[e]
            if cti >= 0 and pk in (P_TEXTURE, P_IMAGE):
                src_a, src_rgb = ct_all[cti][..., 3], ct_all[cti][..., 0:3]
            else:
                src_a, src_rgb = col[..., 3], col[..., 0:3] * col[..., 3:4]
            a = src_a * c
            fb[..., 0:3] = src_rgb * c[..., None] + fb[..., 0:3] * (1.0 - a)[..., None]
            fb[..., 3] = a + fb[..., 3] * (1.0 - a)
        ty, tx = t // plan.ntx, t % plan.ntx
        img[ty * th_o:(ty + 1) * th_o, tx * tw:(tx + 1) * tw] = fb
        ties[ty * th_o:(ty + 1) * th_o, tx * tw:(tx + 1) * tw] = (
            tied.reshape(th_o, ss, tw).any(axis=1))
    return img[: plan.height, : plan.width], ties[: plan.height, : plan.width]
