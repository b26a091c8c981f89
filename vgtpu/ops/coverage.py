"""Analytic winding-coverage accumulation (device).

This replaces libtess2's sweep-line tessellation (SURVEY.md
§2 #7) *and* the AA-fringe mesh expansion (stroker.cpp AA variants): instead of
producing triangles with alpha ramps, each edge's exact box-filtered signed-area
contribution is accumulated per pixel (see ARCHITECTURE.md for the derivation).

Input layout (from vgtpu.raster.binning):
  chunk_edges: (NC, CHUNK, 4) f32 — edge segments, tile-origin-relative
  chunk_entry: (NC,) i32          — which (tile,op) entry each chunk feeds

The accumulation is linear, so chunks of the same entry sum independently —
that's what makes the computation perfectly uniform: every chunk is CHUNK edges
by TH*TW pixels, no ragged shapes anywhere on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-6


def _edge_contribution(px, py, x0, y0, x1, y1):
    """Signed pixel-area contribution of one edge batch to pixel grid (px,py).

    px,py: (..., TH, TW) pixel corner coordinates.
    x0..y1: broadcastable edge coordinates.
    Exact integral of clamp(px+1 - x(y), 0, 1) over the pixel's y-slab.

    Division-free per pixel: with u(y) = px+1-x(y) linear (du/dy = -m),
       ∫ clamp(u) dy = (G(u0) - G(u1)) / m,      G(u) = c·(u - c/2),
    where c = clamp(u,0,1) — G needs no piecewise selects.  1/m is a
    per-EDGE scalar; near-vertical edges (|m| tiny) use the constant-u
    midpoint rule instead (error ≤ |m|·h/2 ≤ 0.005 coverage).

    Pixels right of the edge (u0 + u1 > 1) use the reflection
    G(u) = u - 1/2 + G(1-u): G(u0) - G(u1) = m·h + G(1-u0) - G(1-u1), so
    the m·h part divides out exactly.  Evaluated directly, a pixel far right
    of a steep edge (u ≫ 1) differences two large values and 1/m amplifies
    their rounding; reflected, its contribution is exactly s·h.
    """
    ymin = jnp.minimum(y0, y1)
    ymax = jnp.maximum(y0, y1)
    s = jnp.sign(y1 - y0)
    dy = y1 - y0
    m = (x1 - x0) / jnp.where(jnp.abs(dy) < _EPS, 1.0, dy)
    steep = jnp.abs(m) < 0.01
    s_over_m = s / jnp.where(steep, 1.0, m)     # per-edge scalars

    # per-pixel part
    ytop = jnp.maximum(ymin, py)
    h = jnp.maximum(jnp.minimum(ymax, py + 1.0) - ytop, 0.0)
    u0 = (px + 1.0) - (x0 + m * (ytop - y0))
    u1 = u0 - m * h

    right = u0 + u1 > 1.0
    w0 = jnp.where(right, 1.0 - u0, u0)
    w1 = jnp.where(right, 1.0 - u1, u1)
    c0 = jnp.clip(w0, 0.0, 1.0)
    c1 = jnp.clip(w1, 0.0, 1.0)
    g0 = c0 * (w0 - 0.5 * c0)
    g1 = c1 * (w1 - 0.5 * c1)
    general = (g0 - g1) * s_over_m + jnp.where(right, s * h, 0.0)
    vertical = s * h * jnp.clip(u0, 0.0, 1.0)
    return jnp.where(steep, vertical, general)


def coverage_chunks_body(chunk_edges: jax.Array, tile_h: int = 8, tile_w: int = 128) -> jax.Array:
    """(NC, CH, 4) edges -> (NC, TH, TW): a scan over the CH edge slots.
    The plain reference the other formulations are checked against; it
    writes the whole accumulator back to memory at every slot."""
    nc, ch, _ = chunk_edges.shape
    px = jax.lax.broadcasted_iota(jnp.float32, (tile_h, tile_w), 1)
    py = jax.lax.broadcasted_iota(jnp.float32, (tile_h, tile_w), 0)

    def step(acc, edges_e):
        # edges_e: (NC, 4) — one edge per chunk this step
        x0 = edges_e[:, 0][:, None, None]
        y0 = edges_e[:, 1][:, None, None]
        x1 = edges_e[:, 2][:, None, None]
        y1 = edges_e[:, 3][:, None, None]
        acc = acc + _edge_contribution(px, py, x0, y0, x1, y1)
        return acc, None

    init = jnp.zeros((nc, tile_h, tile_w), jnp.float32)
    edges_by_step = jnp.transpose(chunk_edges, (1, 0, 2))  # (CHUNK, NC, 4)
    acc, _ = jax.lax.scan(step, init, edges_by_step)
    return acc


def coverage_chunks_broadcast(chunk_edges: jax.Array, tile_h: int = 8,
                              tile_w: int = 128) -> jax.Array:
    """(NC, CH, 4) edges -> (NC, TH*TW): the CH slot terms summed in slot
    order as one elementwise expression, which XLA fuses into a single
    kernel — the accumulator stays in registers and (NC, TH*TW) is written
    once.  Same terms, same order as coverage_chunks_body."""
    nc, ch, _ = chunk_edges.shape
    px = jax.lax.broadcasted_iota(jnp.float32, (tile_h, tile_w), 1)
    py = jax.lax.broadcasted_iota(jnp.float32, (tile_h, tile_w), 0)
    e = chunk_edges[:, :, :, None, None]
    acc = None
    for j in range(ch):
        term = _edge_contribution(px, py, e[:, j, 0], e[:, j, 1], e[:, j, 2],
                                  e[:, j, 3])
        acc = term if acc is None else acc + term
    return acc.reshape(nc, tile_h * tile_w)


def chunk_coverage(chunk_edges: jax.Array, tile_h: int, tile_w: int) -> jax.Array:
    """(NC, CH, 4) edges -> (NC, TH*TW): the formulation every frame uses."""
    return coverage_chunks_broadcast(chunk_edges, tile_h, tile_w)


def build_cov_gather_map(chunk_pools, num_entries: int) -> dict:
    """Host-side (numpy) inverse of the chunk->entry map.

    Most entries own exactly ONE chunk (single-chunk pools cover the bulk of
    the edge-count histogram), so the chunk->entry reduction is a
    near-permutation: entry coverage = one GATHER of each entry's primary
    chunk + a small scatter-add of the leftover chunks of multi-chunk
    entries, which replaces most of the general segment-sum scatter with a
    gather (the retained pan's entry coverage).

    Returns numpy arrays:
      primary (NE,) i32   — global chunk id per entry (dead id = all-zeros)
      extra_chunk (K,)    — leftover chunk ids (padded with the dead id)
      extra_entry (K,)    — their entries (padded with NE-1, a pad entry)
    """
    cents = [np.asarray(cent) for _ce, cent in chunk_pools]
    cent_all = np.concatenate(cents) if cents else np.zeros(0, np.int64)
    total = len(cent_all)
    # liveness: a chunk with only zero-height edges contributes exactly zero
    alive = np.concatenate([
        (np.abs(np.asarray(ce)[:, :, 3] - np.asarray(ce)[:, :, 1]) > 1e-12).any(axis=1)
        for ce, _cent in chunk_pools
    ]) if cents else np.zeros(0, bool)

    dead_id = total             # index of the appended all-zeros row
    primary = np.full(num_entries, dead_id, np.int32)
    # first chunk per entry without a sort: reversed assignment makes the
    # FIRST occurrence win (np.unique cost ~1 ms/frame on dynamic scenes)
    valid = (cent_all >= 0) & (cent_all < num_entries)
    idxs = np.arange(total, dtype=np.int32)
    primary[cent_all[valid][::-1]] = idxs[valid][::-1]
    is_first = np.zeros(total, bool)
    first_idx = primary[cent_all[valid]]
    is_first[first_idx] = True
    em = alive & ~is_first
    extra_chunk = np.nonzero(em)[0].astype(np.int32)
    extra_entry = cent_all[em].astype(np.int32)
    k = _next_bucket(max(len(extra_chunk), 1))
    ec = np.full(k, dead_id, np.int32)
    ee = np.full(k, num_entries - 1, np.int32)   # pad entry: zero adds land there
    ec[: len(extra_chunk)] = extra_chunk
    ee[: len(extra_entry)] = extra_entry
    return {
        "primary": primary,
        "extra_chunk": ec,
        "extra_entry": ee,
    }


def _next_bucket(n: int, minimum: int = 8) -> int:
    from vgtpu.raster.binning import _bucket

    return _bucket(n, minimum=minimum)


def _cov_all(chunk_pools, tile_h: int, tile_w: int) -> jax.Array:
    """All pools' per-chunk coverage as ONE (NC+1, NPX) array (last row is
    the all-zeros 'dead chunk' that chunkless entries index)."""
    covs = [chunk_coverage(ce, tile_h, tile_w) for ce, _cent in chunk_pools]
    covs.append(jnp.zeros((1, tile_h * tile_w), jnp.float32))   # dead chunk row
    return jnp.concatenate(covs, axis=0)                         # (NC+1, NPX)


def entry_coverage_gather(chunk_pools, cov_map: dict, num_entries: int,
                          tile_h: int, tile_w: int) -> jax.Array:
    """Entry coverage via the inverse-permutation gather (build_cov_gather_map).
    Matches entry_coverage_from_pools up to float reassociation across a
    multi-chunk entry's adds (same chunk order, so identical for the
    single-chunk majority; tests compare both paths pixel-wise)."""
    cov_all = _cov_all(chunk_pools, tile_h, tile_w)
    w = cov_all[cov_map["primary"]]
    w = w.at[cov_map["extra_entry"]].add(cov_all[cov_map["extra_chunk"]])
    return w.reshape(num_entries, tile_h, tile_w)


def entry_coverage_from_pools(chunk_pools, num_entries: int,
                              tile_h: int, tile_w: int) -> jax.Array:
    """Pooled coverage: chunk buffers come in several chunk sizes (entries
    with few edges use small chunks — measured 47%→66% slot fill on the
    benchmark scene).  Coverage is additive, so pools sum independently.

    The reduction runs on FLAT (chunks, pixels) 2D arrays.  On a GPU the
    segment-sum is a scatter-add whose float order may change from run to
    run, so comparisons against it carry a tolerance."""
    acc = None
    for ce, cent in chunk_pools:
        cov_flat = chunk_coverage(ce, tile_h, tile_w)
        part = jax.ops.segment_sum(cov_flat, cent, num_segments=num_entries)
        acc = part if acc is None else acc + part
    return acc.reshape(num_entries, tile_h, tile_w)
