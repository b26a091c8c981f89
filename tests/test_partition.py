"""Host-side invariants of the collective-free mesh partition
(parallel/sharding.partition_plan_for_mesh) — cheap numpy checks that
complement the end-to-end pixel tests in test_parallel.py."""

from __future__ import annotations

import numpy as np
import pytest

import vgtpu as vg
from vgtpu.parallel.sharding import partition_plan_for_mesh


def _plan(draw):
    ctx = vg.createContext()
    vg.begin(ctx, 0, 384, 256, 1.0)
    draw(ctx)
    vg.end(ctx, background=(1, 1, 1, 1))
    plan = ctx.last_plan
    d = {
        "chunk_pools": tuple((np.asarray(ce), np.asarray(cent))
                             for ce, cent in plan.chunk_pools),
        "entry_backdrop": plan.entry_backdrop,
        "entry_kind": plan.entry_kind,
        "entry_rule": plan.entry_rule,
        "entry_aa": plan.entry_aa,
        "entry_paint_kind": plan.entry_paint_kind,
        "entry_paint": plan.entry_paint,
        "entry_scissor": plan.entry_scissor,
        "entry_color_tile": plan.entry_color_tile,
        "color_tiles": np.zeros((1, plan.tile_h, plan.tile_w, 4), np.float32),
        "tile_entries": plan.tile_entries,
    }
    return plan, d


def _busy(ctx):
    rng = np.random.default_rng(3)
    for i in range(24):
        vg.beginPath(ctx)
        vg.circle(ctx, *rng.uniform(10, 360, 2), rng.uniform(4, 60))
        vg.fillPath(ctx, vg.color4ub(*rng.integers(0, 255, 3), 200),
                    vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 10, 240)
    vg.cubicTo(ctx, 100, 10, 250, 400, 370, 100)
    vg.strokePath(ctx, vg.Colors.Black, 4.0, vg.StrokeFlags.RoundRoundAA)


@pytest.mark.parametrize("n", (2, 4, 8))
def test_partition_invariants(n):
    plan, d = _plan(_busy)
    arrays, meta = partition_plan_for_mesh(d, plan, n)

    t_pad = meta["t_pad"]
    ne_dev = meta["ne_dev"]
    ts = t_pad // n
    te = arrays["tile_entries"]
    assert te.shape[0] == t_pad

    # every referenced LOCAL entry id fits the device shard
    assert te.max() < ne_dev
    # local coverage completeness: each device's chunks reference only
    # local entry ids (cent is already local)
    for ce, cent in arrays["chunk_pools"]:
        nc_dev = ce.shape[0] // n
        for k in range(n):
            loc = cent[k * nc_dev:(k + 1) * nc_dev]
            assert loc.min() >= 0 and loc.max() < ne_dev
    # live-edge conservation: partition drops only dead (zero-height) chunks
    def live_edges(pools):
        tot = 0
        for ce, _c in pools:
            ce = np.asarray(ce)
            tot += int((np.abs(ce[:, :, 3] - ce[:, :, 1]) > 0).sum())
        return tot
    assert live_edges(arrays["chunk_pools"]) == live_edges(d["chunk_pools"])

    # output unpermute is a bijection over the real tiles
    row = meta["row_of_tile"]
    assert len(np.unique(row)) == plan.ntx * plan.nty

    # pad entries spread: per-device TOTAL entry rows are exactly ne_dev,
    # and real entries are balanced within the LPT guarantee
    assert meta["entry_balance"] >= 0.5
    assert meta["collective_bytes_per_frame"] == 0


def test_partition_single_tile_scene():
    """Degenerate case: content in one tile still partitions (other devices
    carry only pads)."""
    def draw(ctx):
        vg.beginPath(ctx)
        vg.rect(ctx, 4, 4, 40, 3)
        vg.fillPath(ctx, vg.Colors.Red, vg.FillFlags.ConvexAA)

    plan, d = _plan(draw)
    arrays, meta = partition_plan_for_mesh(d, plan, 4)
    assert meta["t_pad"] % 4 == 0
    assert meta["collective_bytes_per_frame"] == 0
