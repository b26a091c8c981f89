"""Device-side texture sampling: color tiles for image-pattern fills and
textured text quads computed ON DEVICE (VERDICT round-1 item #3).

Replaces the host numpy sampler (raster/sampling.py) in the per-frame path:
the reference computes pattern UVs in-shader from the inverse paint matrix
(src/shaders/vs_image_pattern.sc, rationale vg.cpp:104-111) and samples
per-fragment; here each tile/quad gets a bilinear SAMPLING MATRIX pair —
hat-function interpolation weights contracted against the texture as two
matrix products:

    tile(r, c) = sum_h sum_w  Wr[r, h] * tex[h, w] * Wc[c, w]

The products run at full f32 precision (a GPU would otherwise take them in
TF32, which keeps ~3 decimal digits).  The separable form requires an
axis-aligned UV mapping — the overwhelmingly common case (unrotated text and
patterns); rotated content takes a per-pixel gather, chosen statically per
group at plan build.  Which formulation is faster on a GPU is not yet
measured.

The host sampler remains the oracle (tests/test_sampling_device.py compares
both pixel-for-pixel across wrap modes, filters and rotations).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from vgtpu.core import ImageFlags
from vgtpu.raster.binning import FramePlan, P_IMAGE, P_TEXTURE

_IW_CHUNK = 1024      # weight-matrix lane chunk: caps W materialization


@dataclass
class SampleGroup:
    """One statically-shaped sampling batch: same image, same flags, same
    kind (quad / pattern), same path (separable / gather)."""

    image_id: int
    flags: int
    kind: int                   # P_TEXTURE (quads) or P_IMAGE (pattern)
    separable: bool
    ct: np.ndarray              # (K,) i32 target color-tile index
    params: np.ndarray          # (K, 12) f32, see _build below
    color: np.ndarray           # (K, 4) f32 straight-alpha modulation color


@dataclass
class SamplingPlan:
    groups: list = field(default_factory=list)
    num_tiles: int = 0          # NCT
    tex_tile_mask: np.ndarray | None = None   # (NCT,) tiles that clip to 1


def _bucket(n: int, minimum: int = 8) -> int:
    from vgtpu.raster.binning import _bucket as _b

    return _b(n, minimum=minimum)


def build_sampling_plan(plan: FramePlan, ops, images,
                        pan_margin: bool = False) -> SamplingPlan:
    """Host pass (no sampling): assigns entry_color_tile and produces padded
    per-group parameter arrays for the device sampler.  `images` maps
    image id -> (data u8, flags[, generation]).

    pan_margin: generate (entry, quad) pairs for the tile's whole REACHABLE
    sample window [ox, ox+2*tw) x [oy, oy+2*th) — retained-pan scenes shift
    content left/up by sub-tile residuals (raster/retained.py), so a quad
    can enter a tile it does not overlap at rest."""
    ss = plan.supersample
    th, tw = plan.tile_h // ss, plan.tile_w   # OUTPUT-space tile rows
    n = plan.n_real_entries
    pk = plan.entry_paint_kind[:n]
    need = np.nonzero((pk == P_IMAGE) | (pk == P_TEXTURE))[0]
    sp = SamplingPlan()
    if len(need) == 0:
        return sp

    # color-tile ids in `need` order (vectorized; same assignment as the old
    # per-entry loop)
    nct = len(need)
    plan.entry_color_tile[need] = np.arange(nct, dtype=np.int32)
    sp.num_tiles = nct
    sp.tex_tile_mask = pk[need] == P_TEXTURE

    raw: dict = {}   # (img, flags, kind, separable) -> [(ct, params, color)]
    tiles = plan.entry_tile[need]
    oxs = ((tiles % plan.ntx) * tw).astype(np.float64)
    oys = ((tiles // plan.ntx) * th).astype(np.float64)
    eop = plan.entry_op[need]
    # entries are op-major, so one pass per textured OP keeps the original
    # (entry, quad) row order while vectorizing the per-entry work that made
    # this pass ~4 ms/frame on text-heavy scenes
    starts = np.concatenate([[0], np.nonzero(np.diff(eop))[0] + 1, [len(need)]])
    for si in range(len(starts) - 1):
        a, b = int(starts[si]), int(starts[si + 1])
        ei0 = need[a]
        kind = int(pk[ei0])
        img_id = int(plan.entry_image[ei0])
        flags = int(images[img_id][1]) if img_id in images else 0
        paint = plan.entry_paint[ei0]
        col = np.asarray(paint[10:14], np.float32)
        cts = np.arange(a, b, dtype=np.int64)
        ox = oxs[a:b]
        oy = oys[a:b]

        if kind == P_IMAGE:
            m = np.asarray(paint[0:6], np.float64)
            separable = abs(float(m[1])) < 1e-12 and abs(float(m[2])) < 1e-12
            pr = np.zeros((b - a, 12), np.float64)
            pr[:, 0] = ox
            pr[:, 1] = oy
            pr[:, 2:8] = m[None, :]
            key = (img_id, flags, P_IMAGE, separable)
            g = raw.setdefault(key, {"ct": [], "params": [], "color": []})
            g["ct"].append(cts)
            g["params"].append(pr)
            g["color"].append(np.broadcast_to(col, (b - a, 4)))
            continue

        # P_TEXTURE: (entry, quad) pairs by bbox overlap.  note: these are
        # the caller's ORIGINAL ops (y unscaled) — only tile origins needed
        # output-space correction under supersampling
        q = np.asarray(ops[int(eop[a])].tex_quads, np.float64)
        cxs = np.stack([q[:, 0], q[:, 0] + q[:, 2], q[:, 0] + q[:, 4],
                        q[:, 0] + q[:, 2] + q[:, 4]])
        cys = np.stack([q[:, 1], q[:, 1] + q[:, 3], q[:, 1] + q[:, 5],
                        q[:, 1] + q[:, 3] + q[:, 5]])
        qx0, qx1 = cxs.min(axis=0), cxs.max(axis=0)
        qy0, qy1 = cys.min(axis=0), cys.max(axis=0)
        exx, exy, eyx, eyy = q[:, 2], q[:, 3], q[:, 4], q[:, 5]
        q_ok = np.abs(exx * eyy - exy * eyx) >= 1e-12
        reach = 2 if pan_margin else 1
        overlap = (
            (qx0[None, :] < (ox + reach * tw + 1)[:, None])
            & (qx1[None, :] > (ox - 1)[:, None])
            & (qy0[None, :] < (oy + reach * th + 1)[:, None])
            & (qy1[None, :] > (oy - 1)[:, None])
            & q_ok[None, :]
        )
        pe, pq = np.nonzero(overlap)             # row-major = entry-major
        if not len(pe):
            continue
        q_sep = (np.abs(exy) < 1e-12) & (np.abs(eyx) < 1e-12)
        for separable in (False, True):
            m2 = q_sep[pq] == separable
            if not m2.any():
                continue
            e2, q2 = pe[m2], pq[m2]
            pr = np.zeros((len(e2), 12), np.float64)
            pr[:, 0] = ox[e2]
            pr[:, 1] = oy[e2]
            pr[:, 2:12] = q[q2, 0:10]
            key = (img_id, flags, P_TEXTURE, bool(separable))
            g = raw.setdefault(key, {"ct": [], "params": [], "color": []})
            g["ct"].append(cts[e2])
            g["params"].append(pr)
            g["color"].append(np.broadcast_to(col, (len(e2), 4)))

    for (img_id, flags, kind, separable), g in sorted(raw.items()):
        cti = np.concatenate(g["ct"])
        k = len(cti)
        kp = _bucket(k)
        ct = np.full(kp, nct, np.int32)          # pad -> scratch tile row NCT
        ct[:k] = cti
        params = np.zeros((kp, 12), np.float32)
        params[:k] = np.concatenate(g["params"]).astype(np.float32)
        if kind == P_TEXTURE:
            params[k:, 4] = 1.0                  # exx/eyy nonzero on pad rows
            params[k:, 7] = 1.0
        else:
            params[k:, 2] = 1.0                  # m0/m3
            params[k:, 5] = 1.0
        color = np.zeros((kp, 4), np.float32)
        color[:k] = np.concatenate(g["color"])
        sp.groups.append(SampleGroup(img_id, flags, kind, separable, ct, params, color))
    return sp


# ---------------------------------------------------------------------------
# device sampler
# ---------------------------------------------------------------------------

def _axis_weights(t, cov, size: int, w0: int, wn: int, flags: int, clamp_flag: int,
                  nearest: bool):
    """Hat (bilinear) or indicator (nearest) weights of texel coordinates t
    (K, P) against texel indices [w0, w0+wn): returns (K, P, wn).

    Matches raster/sampling.py's _bilinear: x = t - 0.5; taps floor(x),
    floor(x)+1 with clamp or repeat wrap; `cov` (K, P) multiplies in."""
    x = t - 0.5
    tx = (w0 + jnp.arange(wn, dtype=jnp.float32))[None, None, :]
    if nearest:
        xr = jnp.round(x)
        if flags & clamp_flag:
            xr = jnp.clip(xr, 0.0, size - 1.0)
            d = xr[..., None] - tx
            w = (jnp.abs(d) < 0.5).astype(jnp.float32)
        else:
            d = jnp.mod(xr[..., None] - tx, float(size))
            w = ((d < 0.5) | (d > size - 0.5)).astype(jnp.float32)
        return w * cov[..., None]
    if flags & clamp_flag:
        xc = jnp.clip(x, 0.0, size - 1.0)
        d = xc[..., None] - tx
        w = jnp.maximum(0.0, 1.0 - jnp.abs(d))
        # exact-edge double-count guard: at xc integer the hat gives weight 1
        # at one texel and 0 elsewhere, same as the two-tap form
    else:
        d = jnp.mod(x[..., None] - tx, float(size))
        w = jnp.maximum(0.0, 1.0 - d) + jnp.maximum(0.0, 1.0 - (float(size) - d))
    return w * cov[..., None]


def _sample_separable(tex_f32, tu, tv, flags: int, th: int, tw: int):
    """tu (K, TW), tv (K, TH) texel coords -> (K, TH, TW, C) samples (quad
    coverage is applied by the caller)."""
    ih, iw = tex_f32.shape[0], tex_f32.shape[1]
    nearest = (not (flags & ImageFlags.Filter_LinearUV)) and bool(flags & ImageFlags.Filter_NearestUV)
    ones_r = jnp.ones_like(tv)
    ones_c = jnp.ones_like(tu)
    wr = _axis_weights(tv, ones_r, ih, 0, ih, flags, ImageFlags.Clamp_V, nearest)  # (K,TH,IH)
    out = None
    for w0 in range(0, iw, _IW_CHUNK):
        wn = min(_IW_CHUNK, iw - w0)
        wc = _axis_weights(tu, ones_c, iw, w0, wn, flags, ImageFlags.Clamp_U, nearest)  # (K,TW,wn)
        t = jnp.einsum("krh,hwc->krwc", wr, tex_f32[:, w0 : w0 + wn],
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        part = jnp.einsum("kcw,krwz->krcz", wc, t,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        out = part if out is None else out + part
    return out  # (K, TH, TW, C)


def _sample_gather(tex_f32, u, v, flags: int):
    """Exact per-pixel bilinear/nearest gather (the rotated-content
    fallback)."""
    ih, iw = tex_f32.shape[0], tex_f32.shape[1]
    x = u - 0.5
    y = v - 0.5

    def wrapx(i):
        return jnp.clip(i, 0, iw - 1) if (flags & ImageFlags.Clamp_U) else jnp.mod(i, iw)

    def wrapy(i):
        return jnp.clip(i, 0, ih - 1) if (flags & ImageFlags.Clamp_V) else jnp.mod(i, ih)

    nearest = (not (flags & ImageFlags.Filter_LinearUV)) and bool(flags & ImageFlags.Filter_NearestUV)
    if nearest:
        return tex_f32[wrapy(jnp.round(y).astype(jnp.int32)), wrapx(jnp.round(x).astype(jnp.int32))]
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    p00 = tex_f32[wrapy(y0), wrapx(x0)]
    p10 = tex_f32[wrapy(y0), wrapx(x0 + 1)]
    p01 = tex_f32[wrapy(y0 + 1), wrapx(x0)]
    p11 = tex_f32[wrapy(y0 + 1), wrapx(x0 + 1)]
    return (p00 * (1 - fx) * (1 - fy) + p10 * fx * (1 - fy)
            + p01 * (1 - fx) * fy + p11 * fx * fy)


def sample_color_tiles_device(sp: SamplingPlan, textures: dict,
                              tile_h: int, tile_w: int) -> jax.Array | None:
    """Run all sample groups on device -> (NCT, TH, TW, 4) premultiplied
    color tiles.  `textures` maps image id -> f32 device array (h, w, C in
    [0,1]; C=1 for A8).  Scratch row NCT absorbs pad lanes.

    ONE jitted program per (group-signature, shapes): eager dispatch would
    pay the per-dispatch cost for each of its ~50 ops."""
    if sp.num_tiles == 0:
        return None
    meta = tuple((g.kind, g.separable, g.flags) for g in sp.groups)
    arrs = tuple(
        (jnp.asarray(g.params), jnp.asarray(g.color), jnp.asarray(g.ct))
        for g in sp.groups
    )
    texs = tuple(textures[g.image_id] for g in sp.groups)
    clipmask = (jnp.asarray(np.concatenate([sp.tex_tile_mask, [False]]))
                if sp.tex_tile_mask is not None else None)
    return _sample_jit(arrs, texs, clipmask, meta=meta, th=tile_h, tw=tile_w,
                       num_tiles=sp.num_tiles)


@functools.partial(jax.jit, static_argnames=("meta", "th", "tw", "num_tiles"))
def _sample_jit(arrs, texs, clipmask, *, meta, th, tw, num_tiles):
    tile_h, tile_w = th, tw
    tiles = jnp.zeros((num_tiles + 1, th, tw, 4), jnp.float32)
    ixc = jnp.arange(tw, dtype=jnp.float32) + 0.5
    iyc = jnp.arange(th, dtype=jnp.float32) + 0.5

    for (kind_, separable_, flags_), (params_, color_, ct_), tex in zip(meta, arrs, texs):
        g = SampleGroup(0, flags_, kind_, separable_, ct_, params_, color_)
        ih, iw = tex.shape[0], tex.shape[1]
        a8 = tex.shape[-1] == 1
        p = jnp.asarray(g.params)
        col = jnp.asarray(g.color)
        ct = jnp.asarray(g.ct)
        ox, oy = p[:, 0:1], p[:, 1:2]

        if g.kind == P_TEXTURE:
            p0x, p0y = p[:, 2:3], p[:, 3:4]
            exx, exy, eyx, eyy = p[:, 4], p[:, 5], p[:, 6], p[:, 7]
            u0, v0, u1, v1 = p[:, 8:9], p[:, 9:10], p[:, 10:11], p[:, 11:12]
            det = exx * eyy - exy * eyx
            i00 = (eyy / det)[:, None]
            i01 = (-eyx / det)[:, None]
            i10 = (-exy / det)[:, None]
            i11 = (exx / det)[:, None]
            wa = jnp.maximum(jnp.hypot(i00, i01), 1e-9)
            wb = jnp.maximum(jnp.hypot(i10, i11), 1e-9)
            if g.separable:
                rx = ox + ixc[None, :] - p0x                 # (K, TW)
                ry = oy + iyc[None, :] - p0y                 # (K, TH)
                a = i00 * rx                                 # i01 == 0
                b = i11 * ry                                 # i10 == 0
                cov_a = jnp.clip((0.5 - jnp.abs(a - 0.5)) / wa + 0.5, 0.0, 1.0)
                cov_b = jnp.clip((0.5 - jnp.abs(b - 0.5)) / wb + 0.5, 0.0, 1.0)
                tu = (u0 + jnp.clip(a, 0, 1) * (u1 - u0)) * iw
                tv = (v0 + jnp.clip(b, 0, 1) * (v1 - v0)) * ih
                s = _sample_separable(tex, tu, tv, g.flags, th, tw)
                qcov = cov_b[:, :, None] * cov_a[:, None, :]
            else:
                rx = ox[..., None] + ixc[None, None, :] - p0x[..., None]   # (K,1,TW)
                ry = oy[..., None] + iyc[None, :, None] - p0y[..., None]   # (K,TH,1)
                a = i00[..., None] * rx + i01[..., None] * ry              # (K,TH,TW)
                b = i10[..., None] * rx + i11[..., None] * ry
                cov_a = jnp.clip((0.5 - jnp.abs(a - 0.5)) / wa[..., None] + 0.5, 0.0, 1.0)
                cov_b = jnp.clip((0.5 - jnp.abs(b - 0.5)) / wb[..., None] + 0.5, 0.0, 1.0)
                tu = (u0[..., None] + jnp.clip(a, 0, 1) * (u1 - u0)[..., None]) * iw
                tv = (v0[..., None] + jnp.clip(b, 0, 1) * (v1 - v0)[..., None]) * ih
                s = _sample_gather(tex, tu, tv, g.flags)
                qcov = cov_a * cov_b
            if a8:
                alpha = s[..., 0]
                rgb = jnp.broadcast_to(col[:, None, None, 0:3], alpha.shape + (3,))
                av = alpha * col[:, None, None, 3]
            else:
                rgba = s * col[:, None, None, :]
                rgb = rgba[..., 0:3]
                av = rgba[..., 3]
            aq = av * qcov
            contrib = jnp.concatenate([rgb * aq[..., None], aq[..., None]], axis=-1)
            tiles = tiles.at[ct].add(contrib)
        else:  # P_IMAGE pattern fill
            m0, m1, m2 = p[:, 2], p[:, 3], p[:, 4]
            m3, m4, m5 = p[:, 5], p[:, 6], p[:, 7]
            if g.separable:
                tu = (m0[:, None] * (ox + ixc[None, :]) + m4[:, None]) * iw  # (K,TW)
                tv = (m3[:, None] * (oy + iyc[None, :]) + m5[:, None]) * ih  # (K,TH)
                s = _sample_separable(tex, tu, tv, g.flags, th, tw)
            else:
                pxc = ox[..., None] + ixc[None, None, :]
                pyc = oy[..., None] + iyc[None, :, None]
                tu = (m0[:, None, None] * pxc + m2[:, None, None] * pyc + m4[:, None, None]) * iw
                tv = (m1[:, None, None] * pxc + m3[:, None, None] * pyc + m5[:, None, None]) * ih
                s = _sample_gather(tex, jnp.broadcast_to(tu, (tu.shape[0], th, tw)),
                                   jnp.broadcast_to(tv, (tv.shape[0], th, tw)), g.flags)
            if a8:
                s = jnp.concatenate([jnp.ones(s.shape[:-1] + (3,), jnp.float32), s], axis=-1)
            rgba = s * col[:, None, None, :]
            tile = jnp.concatenate(
                [rgba[..., 0:3] * rgba[..., 3:4], rgba[..., 3:4]], axis=-1)
            tiles = tiles.at[ct].set(tile)

    # textured-quad tiles saturate like the host sampler (sum then clip)
    if clipmask is not None:
        cm = clipmask[:, None, None, None]
        tiles = jnp.where(cm, jnp.clip(tiles, 0.0, 1.0), tiles)
    return tiles[:num_tiles]
