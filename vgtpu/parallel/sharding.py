"""Multi-chip frame rendering over a jax.sharding.Mesh — collective-free.

The reference has no distributed anything (SURVEY.md §2, explicit); scaling is
a new capability: the screen-tile grid is the data axis.

Ownership is a tree: each edge CHUNK feeds exactly one (tile,op) ENTRY
(raster/binning.py builds chunk_entry that way) and each entry belongs to
exactly one TILE (entry_tile).  So a single partition of the tile rows
induces a partition of entries and chunks under which every stage of the
frame is device-local:

  - tiles shard contiguously: device k owns tiles [k*Ts, (k+1)*Ts);
  - entries are PERMUTED host-side so device k's entries are contiguous,
    and tile_entries is rewritten to device-LOCAL entry ids;
  - chunks are grouped host-side by the device that owns their entry, with
    chunk_entry rewritten to local entry ids;
  - coverage, the chunk->entry segment-sum, and the composite then all run
    on local shards with NO collective anywhere in the frame (the previous
    layout psum'd the full (NE, TH, TW) entry coverage — ~74 MB of
    interconnect traffic per 1080p benchmark frame);
  - the framebuffer comes back tile-sharded; assembling the (H, W, 4)
    image is the one unavoidable output gather (XLA inserts it when the
    caller requests the replicated image).

The per-entry adds keep their order (stable grouping), so on the CPU the
sharded frame is BIT-EQUAL to the single-device render (asserted by
__graft_entry__'s dryrun and tests/test_parallel.py); on a GPU the
segment-sum is a scatter-add whose order may vary, so the card-side check
(chip_smoke.py --four-cards) compares within a float tolerance.

Cost of locality is load imbalance: per-device chunk/entry counts are padded
to the max across devices.  Tiles are assigned to devices by LPT greedy on
per-tile chunk load (contiguous blocks correlate with scene density —
measured chunk balance 0.65 at n=8 vs ~0.99 balanced) and the tile rows
permuted device-contiguous; the output gather unpermutes.
partition_plan_for_mesh returns the measured imbalance
(docs/multichip.md).

Everything runs in ONE jitted shard_map program per frame.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vgtpu.ops.composite import composite_tiles_body, tiles_to_image
from vgtpu.ops.coverage import entry_coverage_from_pools


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return jax.make_mesh((n,), ("tiles",), devices=devs[:n])


def _bucket_up(n: int, minimum: int = 8) -> int:
    """Pad a per-device count to a stable bucket: 128-multiples above 128
    (few distinct shapes), small power-of-two-ish buckets below."""
    from vgtpu.raster.binning import _bucket

    if n >= 128:
        return -(-n // 128) * 128
    return _bucket(max(n, 1), minimum=minimum)


def partition_plan_for_mesh(d: dict, plan, n: int) -> tuple[dict, dict]:
    """Co-partition tiles, entries and chunks for an n-device mesh.

    Returns (arrays, meta): arrays holds the permuted/padded host arrays
    (first axis of every sharded array is n * per-device-count, ready for
    P('tiles') in_specs); meta holds static shapes + imbalance stats.
    """
    te0 = np.asarray(d["tile_entries"])
    T = te0.shape[0]
    ts = -(-T // n)                       # tile rows per device
    t_pad = ts * n

    entry_tile = np.asarray(plan.entry_tile).astype(np.int64)
    ne = np.asarray(d["entry_backdrop"]).shape[0]

    # --- tile -> device assignment: LPT greedy on per-tile chunk load ---
    # contiguous blocks correlate with scene density (the busy region lands
    # on one device: measured chunk balance 0.65 at n=8); assigning the
    # heaviest tiles first to the least-loaded device with spare capacity
    # gets balance close to 1.0.  The tile rows are then PERMUTED so each
    # device's tiles are contiguous (shard_map splits axis 0); tile_ids
    # carries the original flat index (pixel positions derive from it) and
    # the output gather unpermutes.
    load = np.zeros(T, np.int64)
    for ce, cent in d["chunk_pools"]:
        ce = np.asarray(ce)
        cent = np.asarray(cent).astype(np.int64)
        alive = (np.abs(ce[:, :, 3] - ce[:, :, 1]) > 0).any(axis=1)
        tl = entry_tile[np.clip(cent[alive], 0, ne - 1)]
        np.add.at(load, np.clip(tl, 0, T - 1), 1)
    order_t = np.argsort(-load, kind="stable")
    dev_of_tile = np.empty(T, np.int64)
    dev_load = np.zeros(n, np.int64)
    dev_count = np.zeros(n, np.int64)
    for t in order_t:
        cands = np.nonzero(dev_count < ts)[0]
        k = cands[np.argmin(dev_load[cands])]
        dev_of_tile[t] = k
        dev_load[k] += load[t]
        dev_count[k] += 1
    # row layout: device-grouped, original order within a device, padded
    # with empty rows to ts per device
    rows = np.full(t_pad, -1, np.int64)          # original tile id per row
    row_of_tile = np.empty(T, np.int64)
    for k in range(n):
        mine = np.nonzero(dev_of_tile == k)[0]
        rows[k * ts: k * ts + len(mine)] = mine
        row_of_tile[mine] = k * ts + np.arange(len(mine))
    te = np.full((t_pad, te0.shape[1]), -1, te0.dtype)
    te[rows >= 0] = te0[rows[rows >= 0]]
    tile_ids = np.where(rows >= 0, rows, 0).astype(np.int32)

    # owner device per entry follows its tile.  PADDING entries (rows
    # n_real..ne of the bucket-padded arrays) carry entry_tile=0 and are
    # never referenced by any tile row — spreading them to the devices with
    # the fewest real entries equalizes NE_dev (leaving them on tile 0's
    # device measured entry balance 0.55 at n=4: one device's shard was
    # mostly dead rows that the segment-sum still scattered into)
    owner_e = dev_of_tile[np.clip(entry_tile[:ne], 0, T - 1)]
    n_real = getattr(plan, "n_real_entries", 0) or ne
    if n_real < ne:
        counts_real = np.bincount(owner_e[:n_real], minlength=n)
        order_fill = np.argsort(counts_real, kind="stable")
        deficit = counts_real.max() - counts_real
        pads = ne - n_real
        # top up the emptiest devices first, then round-robin the rest
        assign = np.full(pads, -1, np.int64)
        pos = 0
        for k in order_fill:
            t = int(min(deficit[k], pads - pos))
            assign[pos: pos + t] = k
            pos += t
        if pos < pads:
            assign[pos:] = np.arange(pads - pos) % n
        owner_e[n_real:] = assign
    # contract check: every entry a tile references is owned by that tile
    valid = te >= 0
    if valid.any():
        ref_dev = np.repeat(np.arange(t_pad) // ts, te.shape[1])[valid.ravel()]
        assert (owner_e[te[valid]] == ref_dev).all(), \
            "tile_entries references an entry owned by another tile shard"

    counts_e = np.bincount(owner_e, minlength=n)
    ne_dev = _bucket_up(int(counts_e.max()))
    # stable grouping by owner: order within a device (hence within every
    # entry) is preserved -> per-entry float adds keep their order
    order_e = np.argsort(owner_e, kind="stable")
    # local id of each (global) entry: position within its device's group
    local_of = np.empty(ne, np.int64)
    local_of[order_e] = np.concatenate([np.arange(c) for c in counts_e])

    def scatter_entries(a, fill=0):
        a = np.asarray(a)
        out = np.full((n * ne_dev,) + a.shape[1:], fill, a.dtype)
        out[owner_e * ne_dev + local_of] = a[:ne]
        return out

    # tile tables -> local entry ids
    te_local = np.where(valid, local_of[np.maximum(te, 0)], -1).astype(np.int32)

    # chunks: group by owner device, preserving order (stable) so multi-chunk
    # entries sum in the same order as the single-device frame
    pools = []
    chunk_counts = []
    for ce, cent in d["chunk_pools"]:
        ce = np.asarray(ce)
        cent = np.asarray(cent).astype(np.int64)
        nc, chunk_sz = ce.shape[0], ce.shape[1]
        alive = (np.abs(ce[:, :, 3] - ce[:, :, 1]) > 0).any(axis=1)
        owner_c = np.where(alive, owner_e[np.clip(cent, 0, ne - 1)], 0)
        order_c = np.argsort(np.where(alive, owner_c, n), kind="stable")
        keep = order_c[alive[order_c]]            # dead chunks dropped (cov == 0)
        counts_c = np.bincount(owner_c[keep], minlength=n)
        nc_dev = _bucket_up(int(counts_c.max()))
        ce_out = np.zeros((n * nc_dev, chunk_sz, 4), ce.dtype)
        cent_out = np.zeros(n * nc_dev, np.int32)  # pad: local entry 0, zero edges
        base = np.repeat(np.arange(n) * nc_dev, counts_c)
        slot = base + np.concatenate([np.arange(c) for c in counts_c])
        ce_out[slot] = ce[keep]
        cent_out[slot] = local_of[cent[keep]].astype(np.int32)
        pools.append((ce_out, cent_out))
        chunk_counts.append(counts_c)

    arrays = {
        "chunk_pools": tuple(pools),
        "entry_backdrop": scatter_entries(d["entry_backdrop"]),
        "entry_kind": scatter_entries(d["entry_kind"]),
        "entry_rule": scatter_entries(d["entry_rule"]),
        "entry_aa": scatter_entries(d["entry_aa"]),
        "entry_paint_kind": scatter_entries(d["entry_paint_kind"]),
        "entry_paint": scatter_entries(d["entry_paint"]),
        "entry_scissor": scatter_entries(d["entry_scissor"]),
        "entry_color_tile": scatter_entries(d["entry_color_tile"]),
        "color_tiles": np.asarray(d["color_tiles"]),      # replicated
        "tile_entries": te_local,
        "tile_ids": tile_ids,
    }
    live = [int(c.sum()) for c in chunk_counts]
    padded = [len(pools[i][1]) for i in range(len(pools))]
    meta = {
        "t_pad": t_pad,
        "ne_dev": ne_dev,
        "row_of_tile": row_of_tile,    # output gather: fb[row_of_tile]
        "entries_per_dev": counts_e.tolist(),
        "chunks_per_dev": [c.tolist() for c in chunk_counts],
        # fraction of padded chunk slots that are real work on the busiest
        # device vs the mean: 1.0 = perfectly balanced
        "chunk_balance": (
            float(np.mean([c.mean() / max(c.max(), 1) for c in chunk_counts]))
            if chunk_counts else 1.0),
        # REAL-entry balance (pad rows are spread to equalize NE_dev and
        # carry no work that matters beyond the scatter's dead adds)
        "entry_balance": float(
            np.bincount(owner_e[:n_real], minlength=n).mean()
            / max(np.bincount(owner_e[:n_real], minlength=n).max(), 1)),
        "chunk_slots_live": live,
        "chunk_slots_padded": padded,
        "collective_bytes_per_frame": 0,   # no collective in the frame body
    }
    return arrays, meta


def make_sharded_frame_fn(mesh: Mesh, plan, ne_dev: int, t_pad: int,
                          n_pools: int = 1):
    """Builds the jitted sharded frame function for fixed static shapes.
    All inputs arrive pre-partitioned (partition_plan_for_mesh); every
    stage runs on device-local shards — no collective in the body."""
    ntx, tile_h, tile_w = plan.ntx, plan.tile_h, plan.tile_w
    max_ops = plan.tile_entries.shape[1]
    ss = plan.supersample   # tile_h counts SUB-rows when ss > 1

    def local_frame(
        chunk_pools,
        entry_backdrop, entry_kind, entry_rule, entry_aa,
        entry_paint_kind, entry_paint, entry_scissor, entry_color_tile,
        color_tiles, tile_entries, tile_ids, background,
    ):
        # local chunks cover exactly the local entries: no psum needed
        entry_cov = entry_coverage_from_pools(chunk_pools, ne_dev, tile_h, tile_w)
        entry_w = entry_cov + entry_backdrop[:, :, None]
        fb = composite_tiles_body(
            entry_w, tile_entries, tile_ids,
            entry_kind, entry_rule, entry_aa, entry_paint_kind, entry_paint,
            entry_scissor, entry_color_tile, color_tiles, background,
            ntx=ntx, tile_h=tile_h, tile_w=tile_w, max_ops=max_ops, ss=ss,
        )
        return fb

    sharded = jax.shard_map(
        local_frame,
        mesh=mesh,
        in_specs=(
            tuple((P("tiles"), P("tiles")) for _ in range(n_pools)),
            P("tiles"), P("tiles"), P("tiles"), P("tiles"),
            P("tiles"), P("tiles"), P("tiles"), P("tiles"),
            P(), P("tiles"), P("tiles"), P(),
        ),
        out_specs=P("tiles"),
        check_vma=False,
    )

    @jax.jit
    def frame_fn(*args):
        return sharded(*args)

    return frame_fn


def render_frame_sharded(plan, device_arrays: dict, mesh: Mesh,
                         background=(1, 1, 1, 1), return_meta: bool = False):
    """Full sharded frame -> (H, W, 4) premultiplied image (gathered)."""
    n = mesh.devices.size
    arrays, meta = partition_plan_for_mesh(device_arrays, plan, n)
    fn = make_sharded_frame_fn(mesh, plan, meta["ne_dev"], meta["t_pad"],
                               n_pools=len(arrays["chunk_pools"]))
    bg = jnp.asarray(np.asarray(background, np.float32))
    fb = fn(
        tuple((jnp.asarray(ce), jnp.asarray(cent))
              for ce, cent in arrays["chunk_pools"]),
        jnp.asarray(arrays["entry_backdrop"]), jnp.asarray(arrays["entry_kind"]),
        jnp.asarray(arrays["entry_rule"]), jnp.asarray(arrays["entry_aa"]),
        jnp.asarray(arrays["entry_paint_kind"]), jnp.asarray(arrays["entry_paint"]),
        jnp.asarray(arrays["entry_scissor"]), jnp.asarray(arrays["entry_color_tile"]),
        jnp.asarray(arrays["color_tiles"]), jnp.asarray(arrays["tile_entries"]),
        jnp.asarray(arrays["tile_ids"]), bg,
    )
    # all-gather the tile-sharded framebuffer before image assembly (the
    # output transfer — the only cross-device movement in the whole frame),
    # then unpermute the LPT-balanced row layout back to tile order
    fb = jax.device_put(fb, NamedSharding(mesh, P()))
    fb = fb[jnp.asarray(meta["row_of_tile"])]
    img = tiles_to_image(
        fb, ntx=plan.ntx, nty=plan.nty,
        tile_h=plan.tile_h // plan.supersample, tile_w=plan.tile_w,
        width=plan.width, height=plan.height,
    )
    if return_meta:
        return img, meta
    return img
