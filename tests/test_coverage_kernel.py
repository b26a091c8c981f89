"""The frame's per-chunk coverage formulation (ops/coverage.chunk_coverage)
across the binner's pool sizes, chunk counts of all kinds, tile shapes
8x128 and 16x128 and supersampling 1 and 2: against a numpy float32
evaluation of the same per-slot formula summed in slot order, against the
XLA scan, against the brute-force oracle, and through the chunk->entry
reduction."""

import numpy as np
import pytest

import jax.numpy as jnp

from vgtpu.ops.coverage import (
    chunk_coverage,
    coverage_chunks_body,
    entry_coverage_from_pools,
)
from vgtpu.oracle import coverage_oracle

POOLS = (2, 4, 6, 8, 12, 24)
TILES = ((8, 128), (16, 128))


def _edges(rng, nc, ch, th, tw):
    """Chunks of edges in tile-local coordinates: spans that cross the tile,
    start and end inside it, and zero-height slots (the binner's padding)."""
    e = np.empty((nc, ch, 4), np.float32)
    e[..., 0] = rng.uniform(-20, tw + 20, (nc, ch))
    e[..., 2] = e[..., 0] + rng.normal(0, 30, (nc, ch))
    e[..., 1] = rng.uniform(-2, th + 2, (nc, ch))
    e[..., 3] = rng.uniform(-2, th + 2, (nc, ch))
    pad = rng.uniform(size=(nc, ch)) < 0.2
    e[..., 3] = np.where(pad, e[..., 1], e[..., 3])
    return e


def _scan(e, th, tw):
    return np.asarray(coverage_chunks_body(jnp.asarray(e), th, tw)).reshape(len(e), -1)


def slot_sum_f32(e, th, tw):
    """ops/coverage._edge_contribution in numpy float32, one operation at a
    time (no fused multiply-add), summed over the slots in order."""
    f = np.float32
    py, px = np.mgrid[0:th, 0:tw].astype(f)
    acc = np.zeros((len(e), th, tw), f)
    for j in range(e.shape[1]):
        x0, y0, x1, y1 = (e[:, j, k].astype(f)[:, None, None] for k in range(4))
        ymin, ymax = np.minimum(y0, y1), np.maximum(y0, y1)
        s, dy = np.sign(y1 - y0), y1 - y0
        m = (x1 - x0) / np.where(np.abs(dy) < f(1e-6), f(1), dy)
        steep = np.abs(m) < f(0.01)
        s_over_m = s / np.where(steep, f(1), m)
        ytop = np.maximum(ymin, py)
        h = np.maximum(np.minimum(ymax, py + f(1)) - ytop, f(0))
        u0 = (px + f(1)) - (x0 + m * (ytop - y0))
        u1 = u0 - m * h
        right = u0 + u1 > f(1)
        w0, w1 = np.where(right, f(1) - u0, u0), np.where(right, f(1) - u1, u1)
        c0, c1 = np.clip(w0, f(0), f(1)), np.clip(w1, f(0), f(1))
        g0, g1 = c0 * (w0 - f(0.5) * c0), c1 * (w1 - f(0.5) * c1)
        general = (g0 - g1) * s_over_m + np.where(right, s * h, f(0))
        vertical = s * h * np.clip(u0, f(0), f(1))
        acc = acc + np.where(steep, vertical, general)
    return acc.reshape(len(e), -1)


@pytest.mark.parametrize("ss", [1, 2])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("nc", [3, 13])
@pytest.mark.parametrize("ch", POOLS)
def test_chunk_coverage_matches_formula(ch, nc, tile, ss):
    th, tw = tile[0] * ss, tile[1]        # ss>1 bins on th*ss sub-rows
    e = _edges(np.random.default_rng(ch * 100 + nc + th), nc, ch, th, tw)
    got = np.asarray(chunk_coverage(jnp.asarray(e), th, tw))
    assert got.shape == (nc, th * tw)
    np.testing.assert_allclose(got, slot_sum_f32(e, th, tw), atol=1e-5)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("ch", POOLS)
def test_scan_matches_formula(ch, tile):
    """The scan reference evaluates the same terms; XLA's CPU code for the
    loop body rounds a few of them differently (last bits of x at the slab
    top, amplified by 1/m), hence a limit of a few float32 ulps of the
    summed winding."""
    th, tw = tile
    e = _edges(np.random.default_rng(ch + 7), 13, ch, th, tw)
    np.testing.assert_allclose(_scan(e, th, tw), slot_sum_f32(e, th, tw),
                               atol=5e-5)


def _polygon_chunks(pts, ch):
    """One closed polygon's edges packed into ceil(E/ch) chunks of ch slots
    (zero-height padding)."""
    p = np.asarray(pts, np.float64)
    e = np.concatenate([p, np.roll(p, -1, axis=0)], axis=1)
    n = -(-len(e) // ch)
    out = np.zeros((n * ch, 4), np.float32)
    out[: len(e)] = e
    return out.reshape(n, ch, 4), e.astype(np.float32)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("ch", POOLS)
def test_chunk_coverage_matches_oracle(ch, tile):
    """A concave polygon's chunks summed per pixel, NonZero rule applied,
    against point-sampled coverage (tests/test_coverage.py tolerance)."""
    th, tw = tile
    rng = np.random.default_rng(ch + th)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
    rad = rng.uniform(0.4, 1.0, 9)
    pts = np.stack([64 + 60 * rad * np.cos(ang),
                    th / 2 + (th / 2 + 1) * rad * np.sin(ang)], 1)
    chunks, edges = _polygon_chunks(pts, ch)
    cov = np.asarray(chunk_coverage(jnp.asarray(chunks), th, tw)).sum(axis=0)
    got = np.minimum(np.abs(cov), 1.0).reshape(th, tw)
    want = coverage_oracle(edges, tw, th, samples=16)
    assert np.abs(got - want).max() < 0.05


def test_zero_height_padding_adds_nothing():
    e = np.zeros((5, 6, 4), np.float32)
    e[..., 0] = np.linspace(-10, 150, 30).reshape(5, 6)
    e[..., 1] = e[..., 3] = 3.5              # y0 == y1: pad slots
    assert not np.asarray(chunk_coverage(jnp.asarray(e), 8, 128)).any()


@pytest.mark.parametrize("ss", [1, 2])
def test_entry_coverage_sums_chunks_per_entry(ss):
    """Pools of several chunk sizes reduce onto their entries: each entry's
    coverage is the sum of its chunks' (numpy reference)."""
    th, tw = 8 * ss, 128
    rng = np.random.default_rng(ss)
    ne = 7
    pools = []
    want = np.zeros((ne, th * tw))
    for ch, nc in ((2, 9), (6, 5), (24, 3)):
        e = _edges(rng, nc, ch, th, tw)
        ent = rng.integers(0, ne, nc).astype(np.int32)
        pools.append((jnp.asarray(e), jnp.asarray(ent)))
        np.add.at(want, ent, _scan(e, th, tw))
    got = np.asarray(entry_coverage_from_pools(tuple(pools), ne, th, tw))
    assert got.shape == (ne, th, tw)
    np.testing.assert_allclose(got.reshape(ne, -1), want, atol=2e-5)
