#!/usr/bin/env python
"""Device-binning prototype: measure the core primitive on the device (VERDICT r2
next-round item #6 — scope device binning with a design note + microbench,
go/no-go before building).

The host binner (native/vg_native.cpp bin_frame) turns per-op edge arrays
into: op-major chunk pools (fixed-size edge groups per (op,tile) entry),
the per-tile entry table, and per-entry backdrops.  A device formulation
must produce the same artifacts with STATIC shapes under jit:

  1. span expansion  — each edge emits one record per tile it can touch
     (x-span x y-span, padded to a per-frame max span; invalid slots get a
     sentinel key).  Data-independent shapes: E x max_span records.
  2. stable key sort — records sort by packed key (op-major, then tile),
     carrying the edge index: ONE lax.sort over (keys, edge_idx).  The
     sorted order IS the chunk-pool layout (op-major like the native
     binner), so materializing pools is one gather of edge rows.
  3. segmentation    — entry boundaries (key change), entry ids (cumsum),
     per-entry ranks (iota - segment start): elementwise + cumsum.
  4. table scatter   — tile_entries (T, MAX_OPS) filled by ONE scatter at
     (tile, rank-of-entry-within-tile); backdrops are a per-(row,op)
     segment-sum of crossing contributions of edges LEFT of each tile
     (prototype: the winding sum primitive, same sort/segment machinery).

Everything is sort/cumsum/gather/scatter — no atomics.
This script times stages 1-4 at benchmark-frame scale (75k edges, 2025
tiles, 355 ops, ~2.4 tiles/edge like the real expansion) with the
chained-loop method (raster/benchloop.py rationale).

Run: python tools/proto_device_bin.py  (GPU; CPU works for smoke tests)
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def synth_edges(rng, E=75_000, T=2025, OPS=355, ntx=15):
    """Benchmark-scale synthetic frame: edges clustered per op (real ops
    average ~200 edges), short spans like flattened curve segments."""
    op_of = np.sort(rng.integers(0, OPS, E)).astype(np.int32)
    x0 = rng.uniform(0, 1920, E).astype(np.float32)
    y0 = rng.uniform(0, 1080, E).astype(np.float32)
    dx = rng.normal(0, 30, E).astype(np.float32)
    dy = rng.normal(0, 10, E).astype(np.float32)
    edges = np.stack([x0, y0, x0 + dx, y0 + dy], 1)
    return edges, op_of


def main() -> None:
    import jax
    import jax.numpy as jnp

    E, T, OPS, ntx = 75_000, 2025, 355, 15
    TW, TH = 128.0, 8.0
    MAX_SPAN = 6            # (x-span<=3) x (y-span<=2) covers curve segments
    MAX_OPS = 32
    rng = np.random.default_rng(0)
    edges_h, op_h = synth_edges(rng, E, T, OPS, ntx)
    edges = jnp.asarray(edges_h)
    op_of = jnp.asarray(op_h)
    nty = T // ntx

    SENTINEL = jnp.int32(OPS * T)   # sorts after every real key

    def expand(edges, op_of):
        """Stage 1: E x MAX_SPAN (key, edge_idx) records."""
        x0 = jnp.minimum(edges[:, 0], edges[:, 2])
        x1 = jnp.maximum(edges[:, 0], edges[:, 2])
        y0 = jnp.minimum(edges[:, 1], edges[:, 3])
        y1 = jnp.maximum(edges[:, 1], edges[:, 3])
        tx0 = jnp.clip((x0 // TW).astype(jnp.int32), 0, ntx - 1)
        tx1 = jnp.clip((x1 // TW).astype(jnp.int32), 0, ntx - 1)
        ty0 = jnp.clip((y0 // TH).astype(jnp.int32), 0, nty - 1)
        ty1 = jnp.clip((y1 // TH).astype(jnp.int32), 0, nty - 1)
        nx = tx1 - tx0 + 1                       # x tiles touched
        ny = ty1 - ty0 + 1
        # slot s of MAX_SPAN maps to (sx, sy) = (s % 3, s // 3)
        s = jnp.arange(MAX_SPAN, dtype=jnp.int32)
        sx = (s % 3)[None, :]
        sy = (s // 3)[None, :]
        valid = (sx < nx[:, None]) & (sy < ny[:, None])
        tile = ((ty0[:, None] + sy) * ntx + tx0[:, None] + sx).astype(jnp.int32)
        key = jnp.where(valid, op_of[:, None] * T + tile, SENTINEL)
        eidx = jnp.broadcast_to(
            jnp.arange(E, dtype=jnp.int32)[:, None], (E, MAX_SPAN))
        return key.reshape(-1), eidx.reshape(-1), valid.reshape(-1)

    def sort_records(key, eidx):
        """Stage 2: op-major stable sort carrying the edge index."""
        return jax.lax.sort((key, eidx), num_keys=1, is_stable=True)

    def segment(key_s):
        """Stage 3: entry boundaries + ids + in-entry ranks."""
        prev = jnp.concatenate([jnp.full((1,), -1, key_s.dtype), key_s[:-1]])
        new_entry = (key_s != prev) & (key_s != SENTINEL)
        entry_id = jnp.cumsum(new_entry.astype(jnp.int32)) - 1
        idx = jnp.arange(key_s.shape[0], dtype=jnp.int32)
        start = jnp.where(new_entry, idx, 0)
        seg_start = jax.lax.associative_scan(jnp.maximum, start)
        rank = idx - seg_start
        return entry_id, rank, new_entry

    def pools_and_table(key_s, eidx_s, entry_id, rank, new_entry, edges):
        """Stage 4: gather pool edges + scatter the (T, MAX_OPS) table."""
        pool_edges = edges[eidx_s]                       # ONE gather
        # tile_entries: first record of each entry scatters entry_id at
        # (tile, rank-of-entry-within-tile).  Entry rank within tile needs a
        # second (tile-major) ordering: prototype reuses the sort machinery.
        tile = (key_s % T).astype(jnp.int32)
        tkey = jnp.where(key_s == SENTINEL, SENTINEL,
                         tile * jnp.int32(OPS * 64) + entry_id)
        tkey_first = jnp.where(new_entry, tkey, SENTINEL)
        tkey_s, ent_s = jax.lax.sort((tkey_first, entry_id), num_keys=1,
                                     is_stable=True)
        prev_t = jnp.concatenate(
            [jnp.full((1,), -1, tkey_s.dtype), tkey_s[:-1]])
        new_tile = ((tkey_s // jnp.int32(OPS * 64))
                    != (prev_t // jnp.int32(OPS * 64))) & (tkey_s != SENTINEL)
        idx = jnp.arange(tkey_s.shape[0], dtype=jnp.int32)
        tstart = jax.lax.associative_scan(
            jnp.maximum, jnp.where(new_tile, idx, 0))
        trank = jnp.minimum(idx - tstart, MAX_OPS - 1)
        ttile = (tkey_s // jnp.int32(OPS * 64)).astype(jnp.int32)
        ttile = jnp.where(tkey_s == SENTINEL, T, jnp.minimum(ttile, T))
        table = jnp.full((T + 1, MAX_OPS), -1, jnp.int32)
        table = table.at[ttile, trank].set(ent_s)       # ONE scatter
        return pool_edges, table[:T]

    @functools.partial(jax.jit, static_argnames=("n", "stage"))
    def loop(edges, op_of, n, stage):
        def body(i, acc):
            e = edges + acc * 1e-9
            key, eidx, valid = expand(e, op_of)
            if stage == "expand":
                return jnp.sum(key % 97).astype(jnp.float32) * 1e-9
            key_s, eidx_s = sort_records(key, eidx)
            if stage == "sort":
                return jnp.sum(key_s % 97).astype(jnp.float32) * 1e-9
            entry_id, rank, new_entry = segment(key_s)
            if stage == "segment":
                return jnp.sum(rank).astype(jnp.float32) * 1e-9
            pool, table = pools_and_table(key_s, eidx_s, entry_id, rank,
                                          new_entry, e)
            return (jnp.sum(pool[:, 0]) + jnp.sum(table)) * 1e-9

        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    def timeit(stage):
        lo, hi = 3, 24
        float(np.asarray(loop(edges, op_of, lo, stage)))
        float(np.asarray(loop(edges, op_of, hi, stage)))
        t0 = time.perf_counter()
        float(np.asarray(loop(edges, op_of, lo, stage)))
        t1 = time.perf_counter()
        float(np.asarray(loop(edges, op_of, hi, stage)))
        t2 = time.perf_counter()
        return ((t2 - t1) - (t1 - t0)) / (hi - lo) * 1e3

    import jax

    print(f"platform: {jax.devices()[0].platform}  "
          f"records: {E}x{MAX_SPAN} = {E * MAX_SPAN}")
    for stage in ("expand", "sort", "segment", "full"):
        print(f"  {stage:8s}: {timeit(stage):7.3f} ms")


if __name__ == "__main__":
    main()
