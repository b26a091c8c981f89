"""Painter's-order shading + compositing over screen tiles (device).

Replaces the reference's end() render loop (vg.cpp:1076-1288): the per-tile
entry table plays the role of the draw-command list, the clip-mask carry plays
the role of the stencil buffer (REPLACE/EQUAL semantics of vg.cpp:1193-1215),
and the four bgfx shader programs (src/shaders/*.sc) become masked lanes of one
shading expression:

  - solid color  (fs_textured with white-pixel UV)
  - gradient     (fs_color_gradient's sdroundrect mix — exact same math)
  - image pattern / texture quads: pre-sampled premultiplied color tiles

Blending is premultiplied src-over, equivalent to the reference's
BLEND(SRC_ALPHA, INV_SRC_ALPHA) on straight-alpha vertex colors.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

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
    """fs_color_gradient.sc:12-18."""
    ex2 = ex - rad
    ey2 = ey - rad
    dx = jnp.abs(ux) - ex2
    dy = jnp.abs(uy) - ey2
    mx = jnp.maximum(dx, 0.0)
    my = jnp.maximum(dy, 0.0)
    return jnp.minimum(jnp.maximum(dx, dy), 0.0) + jnp.sqrt(mx * mx + my * my) - rad


def _apply_rule(w, rule, aa, is_texture):
    """winding -> coverage: NonZero = min(|w|,1); EvenOdd = triangle fold."""
    cov_nz = jnp.minimum(jnp.abs(w), 1.0)
    cov_eo = 1.0 - jnp.abs(jnp.mod(w, 2.0) - 1.0)
    cov = jnp.where(rule == 0, cov_nz, cov_eo)
    cov = jnp.where(aa != 0, cov, (cov >= 0.5).astype(jnp.float32))
    return jnp.where(is_texture, 1.0, cov)


def composite_tiles_body(
    entry_w: jax.Array,        # (NE, TH, TW) winding incl. backdrop
    tile_entries: jax.Array,   # (T, MAX_OPS) i32, -1 padded
    tile_ids: jax.Array,       # (T,) i32 flat tile index (row*ntx+col)
    entry_kind: jax.Array,     # (NE,)
    entry_rule: jax.Array,
    entry_aa: jax.Array,
    entry_paint_kind: jax.Array,
    entry_paint: jax.Array,    # (NE, 18)
    entry_scissor: jax.Array,  # (NE, 4)
    entry_color_tile: jax.Array,  # (NE,)
    color_tiles: jax.Array,    # (NCT, TH, TW, 4) premultiplied
    background: jax.Array,     # (4,) premultiplied RGBA
    *,
    ntx: int,
    tile_h: int,
    tile_w: int,
    max_ops: int,
    lane_flags: tuple = (True, True, True, True, True, True, True),
    ss: int = 1,
    origin_shift=None,
    init_tiles=None,
) -> jax.Array:
    """Returns (T, TH_OUT, TW, 4) premultiplied RGBA tiles (TH_OUT =
    tile_h // ss).  Unjitted body so the sharded renderer (vgtpu/parallel)
    can call it inside shard_map.

    lane_flags = (gradient, tri, texture, clip, evenodd, non_aa): statically
    disables shading/state lanes that no entry in this call uses — the
    per-bucket specialization that replaces the reference's four separate
    shader programs (src/shaders/*.sc) with compiled variants.

    ss > 1: winding/coverage/clip live on tile_h SUB-rows; the fill rule,
    AA select, scissor and clip mask apply per sub-row, then coverage
    averages down to output rows before shading + blending — self-
    intersection pixels get mesh-equivalent (conflation-free) alpha in y.

    origin_shift = traced (sx, sy) scalars added to the pixel positions used
    for scissor / gradient / tri shading — the sub-tile residual of a
    retained-scene pan (raster/retained.py), where each output tile shows its
    scene tile's content shifted left/up by (sx, sy).

    init_tiles = (T, TH_OUT, TW, 4) per-tile initial framebuffer values
    (a resident static layer, api/context layer memo) replacing the
    broadcast background."""
    has_grad, has_tri, has_tex, has_clip, has_eo, has_noaa = lane_flags[:6]
    has_scissor = lane_flags[6] if len(lane_flags) > 6 else True
    th_out = tile_h // ss
    T = tile_entries.shape[0]
    tid = tile_ids.astype(jnp.int32)
    ox = ((tid % ntx) * tile_w).astype(jnp.float32)
    oy = ((tid // ntx) * tile_h).astype(jnp.float32)
    if origin_shift is not None:
        ox = ox + origin_shift[0]
        oy = oy + origin_shift[1]
    ix = jax.lax.broadcasted_iota(jnp.float32, (tile_h, tile_w), 1)
    iy = jax.lax.broadcasted_iota(jnp.float32, (tile_h, tile_w), 0)
    # sub-row sample centers, scaled space: (T, TH, TW) — scissors are scaled
    pxc = ox[:, None, None] + ix + 0.5
    pyc = oy[:, None, None] + iy + 0.5
    if ss == 1:
        pxc_o, pyc_o = pxc, pyc
    else:
        # output-pixel centers for shading (paints are pixel-space)
        ix_o = jax.lax.broadcasted_iota(jnp.float32, (th_out, tile_w), 1)
        iy_o = jax.lax.broadcasted_iota(jnp.float32, (th_out, tile_w), 0)
        pxc_o = ox[:, None, None] + ix_o + 0.5
        pyc_o = (oy / ss)[:, None, None] + iy_o + 0.5

    if init_tiles is None:
        fb0 = jnp.broadcast_to(background, (T, th_out, tile_w, 4)).astype(jnp.float32)
    else:
        fb0 = init_tiles.astype(jnp.float32)
    mask0 = jnp.ones((T, tile_h, tile_w), jnp.float32)
    accum0 = jnp.zeros((T, tile_h, tile_w), jnp.float32)

    def one_slot(carry, s):
        fb, mask, accum = carry
        eid = tile_entries[:, s]                       # (T,)
        valid = eid >= 0
        e = jnp.maximum(eid, 0)

        w = entry_w[e]                                 # (T, TH, TW)
        kind = entry_kind[e][:, None, None]
        rule = entry_rule[e][:, None, None]
        aa = entry_aa[e][:, None, None]
        pk = entry_paint_kind[e][:, None, None]
        paint = entry_paint[e]                         # (T, 18)
        sc = entry_scissor[e]                          # (T, 4)

        is_quad_tex = pk == P_TEXTURE          # coverage lives in the color tile
        if has_tex:
            has_ctile = (entry_color_tile[e] >= 0)[:, None, None]
            use_ctile = has_ctile & (is_quad_tex | (pk == P_IMAGE))
        cov_nz = jnp.minimum(jnp.abs(w), 1.0)
        if has_eo:
            cov_eo = 1.0 - jnp.abs(jnp.mod(w, 2.0) - 1.0)
            cov = jnp.where(rule == 0, cov_nz, cov_eo)
        else:
            cov = cov_nz
        if has_noaa:
            cov = jnp.where(aa != 0, cov, (cov >= 0.5).astype(jnp.float32))
        if has_tex:
            cov = jnp.where(is_quad_tex, 1.0, cov)

        if has_scissor:
            # scissor (pixel-center test, like the GPU scissor rect)
            inside = (
                (pxc >= sc[:, 0][:, None, None])
                & (pyc >= sc[:, 1][:, None, None])
                & (pxc < sc[:, 2][:, None, None])
                & (pyc < sc[:, 3][:, None, None])
            )
            cov = cov * inside.astype(jnp.float32)

        # ---- shading (each lane statically gated by bucket usage) ----
        inner = paint[:, 10:14]
        solid = jnp.broadcast_to(inner[:, None, None, :], (inner.shape[0], th_out, tile_w, 4))
        col = solid
        if has_grad:
            # gradient uv via inverse paint matrix (vg.cpp:3712-3880)
            m = paint[:, 0:6]
            uxg = m[:, 0][:, None, None] * pxc_o + m[:, 2][:, None, None] * pyc_o + m[:, 4][:, None, None]
            uyg = m[:, 1][:, None, None] * pxc_o + m[:, 3][:, None, None] * pyc_o + m[:, 5][:, None, None]
            ex = paint[:, 6][:, None, None]
            ey = paint[:, 7][:, None, None]
            rad = paint[:, 8][:, None, None]
            feather = jnp.maximum(paint[:, 9][:, None, None], 1e-6)
            d = jnp.clip((_sdroundrect(uxg, uyg, ex, ey, rad) + feather * 0.5) / feather, 0.0, 1.0)
            outer = paint[:, 14:18]
            grad = (
                inner[:, None, None, :] * (1.0 - d[..., None])
                + outer[:, None, None, :] * d[..., None]
            )
            col = jnp.where((pk == P_GRADIENT)[..., None], grad, col)
        if has_tri:
            # per-vertex-color triangles: rgba(x,y) = A*x + B*y + C
            tri = (
                paint[:, 0:4][:, None, None, :] * pxc_o[..., None]
                + paint[:, 4:8][:, None, None, :] * pyc_o[..., None]
                + paint[:, 8:12][:, None, None, :]
            )
            col = jnp.where((pk == P_TRI)[..., None], tri, col)

        if has_tex:
            # textured entries: pre-sampled premultiplied tiles (text/patterns)
            ct = color_tiles[jnp.maximum(entry_color_tile[e], 0)]    # (T,TH,TW,4)
            src_a_vec = jnp.where(use_ctile, ct[..., 3], col[..., 3])
            src_rgb_pre = jnp.where(
                use_ctile[..., None], ct[..., 0:3], col[..., 0:3] * col[..., 3:4]
            )
        else:
            src_a_vec = col[..., 3]
            src_rgb_pre = col[..., 0:3] * col[..., 3:4]

        # ---- op-kind state machine ----
        if has_clip:
            is_draw = valid[:, None, None] & (kind == K_DRAW)
            c = jnp.where(is_draw, cov * mask, 0.0)
        else:
            c = jnp.where(valid[:, None, None], cov, 0.0)
        if ss > 1:
            # average rule-applied sub-row coverage down to output rows
            c = jnp.mean(c.reshape(c.shape[0], th_out, ss, tile_w), axis=2)
        a = src_a_vec * c
        fb = jnp.concatenate(
            [
                src_rgb_pre * c[..., None] + fb[..., 0:3] * (1.0 - a)[..., None],
                (a + fb[..., 3] * (1.0 - a))[..., None],
            ],
            axis=-1,
        )

        if has_clip:
            is_cadd = valid[:, None, None] & (kind == K_CLIP_ADD)
            is_ccommit = valid[:, None, None] & (kind == K_CLIP_COMMIT)
            is_creset = valid[:, None, None] & (kind == K_CLIP_RESET)
            accum = jnp.where(is_cadd, accum + cov, accum)
            committed = jnp.where(rule == 0, (accum > 0.5), ~(accum > 0.5)).astype(jnp.float32)
            mask = jnp.where(is_ccommit, committed, mask)
            accum = jnp.where(is_ccommit, 0.0, accum)
            mask = jnp.where(is_creset, 1.0, mask)

        return (fb, mask, accum)

    unroll = 2 if max_ops % 2 == 0 else 1

    def slot_group(carry, s0):
        # several painter slots per scan step: cuts sequential-step overhead
        for k in range(unroll):
            carry = one_slot(carry, s0 + k)
        return carry, None

    if unroll > 1:
        (fb, _, _), _ = jax.lax.scan(
            slot_group, (fb0, mask0, accum0),
            jnp.arange(0, max_ops, unroll, dtype=jnp.int32)
        )
    else:
        def slot_step(carry, s):
            return one_slot(carry, s), None

        (fb, _, _), _ = jax.lax.scan(
            slot_step, (fb0, mask0, accum0), jnp.arange(max_ops, dtype=jnp.int32)
        )
    return fb


def composite_bucketed_body(
    entry_w,
    buckets,            # list of (tile_entries_b (Nb,MOb), tile_ids_b (Nb,))
    entry_kind,
    entry_rule,
    entry_aa,
    entry_paint_kind,
    entry_paint,
    entry_scissor,
    entry_color_tile,
    color_tiles,
    background,
    *,
    ntx: int,
    tile_h: int,
    tile_w: int,
    num_tiles: int,
    bucket_flags: tuple | None = None,
    ss: int = 1,
    origin_shift=None,
    init_tiles=None,
):
    """Composite with tiles grouped by op-count bucket: each group scans only
    as many painter slots as its busiest tile needs; op-free tiles never run.
    Output row num_tiles is a scratch target for bucket padding.

    init_tiles: optional (num_tiles, TH_OUT, TW, 4) per-tile initial values
    (resident static layer) instead of the broadcast background."""
    if init_tiles is None:
        fb = jnp.broadcast_to(
            background, (num_tiles + 1, tile_h // ss, tile_w, 4)).astype(jnp.float32)
    else:
        fb = jnp.concatenate([
            init_tiles.astype(jnp.float32),
            jnp.broadcast_to(background, (1, tile_h // ss, tile_w, 4)).astype(jnp.float32),
        ])
    if bucket_flags is None:
        bucket_flags = tuple((True,) * 7 for _ in buckets)
    for (te_b, ids_b), flags in zip(buckets, bucket_flags):
        # pre-gather the bucket's entries ONCE (one large gather instead of a
        # gather per painter slot inside the scan)
        nb, mo = te_b.shape
        e = jnp.maximum(te_b, 0)
        ef = e.reshape(-1)
        ew_b = entry_w[ef]                                  # (Nb*MO, TH, TW)
        flat_ids = jnp.arange(nb * mo, dtype=jnp.int32).reshape(nb, mo)
        flat_ids = jnp.where(te_b >= 0, flat_ids, -1)
        fb_b = composite_tiles_body(
            ew_b, flat_ids, ids_b,
            entry_kind[ef], entry_rule[ef], entry_aa[ef], entry_paint_kind[ef],
            entry_paint[ef], entry_scissor[ef], entry_color_tile[ef],
            color_tiles, background,
            ntx=ntx, tile_h=tile_h, tile_w=tile_w, max_ops=mo,
            lane_flags=tuple(flags), ss=ss, origin_shift=origin_shift,
            init_tiles=None if init_tiles is None else fb[ids_b],
        )
        fb = fb.at[ids_b].set(fb_b)
    return fb[:num_tiles]


@functools.partial(
    jax.jit,
    static_argnames=("ntx", "tile_h", "tile_w", "max_ops", "num_tiles"),
)
def composite_tiles(
    entry_w,
    tile_entries,
    entry_kind,
    entry_rule,
    entry_aa,
    entry_paint_kind,
    entry_paint,
    entry_scissor,
    entry_color_tile,
    color_tiles,
    background,
    *,
    ntx: int,
    tile_h: int,
    tile_w: int,
    max_ops: int,
    num_tiles: int,
):
    tile_ids = jnp.arange(num_tiles, dtype=jnp.int32)
    return composite_tiles_body(
        entry_w, tile_entries, tile_ids,
        entry_kind, entry_rule, entry_aa, entry_paint_kind, entry_paint,
        entry_scissor, entry_color_tile, color_tiles, background,
        ntx=ntx, tile_h=tile_h, tile_w=tile_w, max_ops=max_ops,
    )


@functools.partial(jax.jit, static_argnames=("ntx", "nty", "tile_h", "tile_w", "width", "height"))
def tiles_to_image(fb_tiles, *, ntx, nty, tile_h, tile_w, width, height):
    """(T, TH, TW, 4) -> (H, W, 4) cropped framebuffer."""
    img = fb_tiles.reshape(nty, ntx, tile_h, tile_w, 4)
    img = jnp.transpose(img, (0, 2, 1, 3, 4)).reshape(nty * tile_h, ntx * tile_w, 4)
    return img[:height, :width]
