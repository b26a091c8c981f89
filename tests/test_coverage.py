"""The central correctness property: the device's analytic winding coverage
must match brute-force supersampled fill-rule coverage on arbitrary
(self-intersecting, multi-contour) polygons — this is the behavior contract
that replaces libtess2 (SURVEY.md §2 #7)."""

import numpy as np
import pytest

from vgtpu.oracle import coverage_oracle
from vgtpu.raster.binning import RasterOp, bin_frame, make_solid_paint, K_CLIP_ADD, K_CLIP_COMMIT, K_CLIP_RESET
from vgtpu.raster.frame import execute_plan


def _poly_edges(pts):
    pts = np.asarray(pts, np.float64)
    nxt = np.roll(pts, -1, axis=0)
    return np.concatenate([pts, nxt], axis=1).astype(np.float32)


def render_coverage(edges, w, h, rule=0, aa=True):
    """Render white-on-transparent; the alpha channel IS the coverage."""
    op = RasterOp(
        edges=edges,
        fill_rule=rule,
        aa=aa,
        paint=make_solid_paint(np.array([1, 1, 1, 1], np.float32)),
    )
    plan = bin_frame([op], w, h)
    img = execute_plan(plan, background=(0, 0, 0, 0))
    return np.asarray(img)[..., 3]


def test_triangle_matches_oracle():
    pts = [(3.2, 2.1), (28.7, 5.4), (10.1, 25.6)]
    e = _poly_edges(pts)
    got = render_coverage(e, 32, 32)
    want = coverage_oracle(e, 32, 32, samples=16)
    assert np.abs(got - want).max() < 0.05


@pytest.mark.parametrize("rule", [0, 1])
def test_self_intersecting_star(rule):
    # 5-point star drawn as a single self-intersecting loop.
    # At pixels crossed by two contour edges at once the analytic rasterizer
    # conflates (rule applied to the averaged winding) — same artifact as
    # Skia/FreeType/stb; allow a handful of such pixels, nothing more.
    ang = -np.pi / 2 + np.arange(5) * (4 * np.pi / 5)
    pts = np.stack([32 + 28 * np.cos(ang), 32 + 28 * np.sin(ang)], axis=1)
    e = _poly_edges(pts)
    got = render_coverage(e, 64, 64, rule=rule)
    want = coverage_oracle(e, 64, 64, fill_rule=rule, samples=16)
    d = np.abs(got - want)
    assert d.mean() < 2e-3
    assert (d > 0.1).sum() <= 8
    # EvenOdd must hollow the pentagon core
    if rule == 1:
        assert got[32, 32] < 0.01
    else:
        assert got[32, 32] > 0.99


def test_multi_contour_hole():
    # outer CCW square, inner CW square -> NonZero hole
    outer = _poly_edges([(4, 4), (60, 4), (60, 60), (4, 60)])
    inner = _poly_edges([(20, 20), (20, 44), (44, 44), (44, 20)])  # reversed winding
    e = np.concatenate([outer, inner])
    got = render_coverage(e, 64, 64)
    want = coverage_oracle(e, 64, 64, samples=16)
    assert np.abs(got - want).max() < 0.05
    assert got[32, 32] < 0.01
    assert got[10, 10] > 0.99


def test_wide_shape_backdrop_across_tiles():
    # spans multiple 128-wide tiles: interior tiles are pure backdrop
    pts = [(5.3, 3.7), (311.9, 8.2), (300.4, 27.5), (9.1, 22.8)]
    e = _poly_edges(pts)
    got = render_coverage(e, 320, 32)
    want = coverage_oracle(e, 320, 32, samples=16)
    assert np.abs(got - want).max() < 0.05
    # middle of the quad, inside second tile
    assert got[15, 160] > 0.99


def test_tall_shape_across_tile_rows():
    pts = [(10.5, 2.3), (100.2, 40.1), (60.7, 120.9), (5.9, 90.2)]
    e = _poly_edges(pts)
    got = render_coverage(e, 128, 128)
    want = coverage_oracle(e, 128, 128, samples=16)
    assert np.abs(got - want).max() < 0.05


def test_random_polygons_both_rules():
    # random polygons are usually self-intersecting: allow the conflation
    # pixels at edge crossings, bound their count and the mean error
    rng = np.random.default_rng(7)
    for rule in (0, 1):
        for _ in range(6):
            pts = rng.uniform(2, 62, (rng.integers(3, 12), 2))
            e = _poly_edges(pts)
            got = render_coverage(e, 64, 64, rule=rule)
            want = coverage_oracle(e, 64, 64, fill_rule=rule, samples=16)
            d = np.abs(got - want)
            assert d.mean() < 4e-3
            assert (d > 0.1).sum() <= 30


def test_non_aa_binarizes():
    pts = [(3.2, 2.1), (28.7, 5.4), (10.1, 25.6)]
    e = _poly_edges(pts)
    got = render_coverage(e, 32, 32, aa=False)
    assert set(np.unique(got)).issubset({0.0, 1.0})


def test_scissor_rect():
    e = _poly_edges([(0, 0), (64, 0), (64, 64), (0, 64)])
    op = RasterOp(edges=e, paint=make_solid_paint(np.array([1, 1, 1, 1], np.float32)),
                  scissor=(10, 12, 40, 50))
    plan = bin_frame([op], 64, 64)
    img = np.asarray(execute_plan(plan, background=(0, 0, 0, 0)))[..., 3]
    assert img[30, 30] == 1.0
    assert img[30, 5] == 0.0   # left of scissor
    assert img[5, 30] == 0.0   # above scissor
    assert img[30, 45] == 0.0  # right of scissor x1=40


def test_clip_in_out():
    big = _poly_edges([(0, 0), (64, 0), (64, 64), (0, 64)])
    clip_shape = _poly_edges([(16, 16), (48, 16), (48, 48), (16, 48)])
    white = make_solid_paint(np.array([1, 1, 1, 1], np.float32))

    def run(rule_in):
        ops = [
            RasterOp(kind=K_CLIP_ADD, edges=clip_shape, paint=white, aa=False),
            RasterOp(kind=K_CLIP_COMMIT, fill_rule=0 if rule_in else 1),
            RasterOp(edges=big, paint=white),
        ]
        plan = bin_frame(ops, 64, 64)
        return np.asarray(execute_plan(plan, background=(0, 0, 0, 0)))[..., 3]

    img_in = run(True)
    assert img_in[32, 32] == 1.0 and img_in[5, 5] == 0.0
    img_out = run(False)
    assert img_out[32, 32] == 0.0 and img_out[5, 5] == 1.0

    # resetClip restores full drawing
    ops = [
        RasterOp(kind=K_CLIP_ADD, edges=clip_shape, paint=white, aa=False),
        RasterOp(kind=K_CLIP_COMMIT, fill_rule=0),
        RasterOp(kind=K_CLIP_RESET),
        RasterOp(edges=big, paint=white),
    ]
    plan = bin_frame(ops, 64, 64)
    img = np.asarray(execute_plan(plan, background=(0, 0, 0, 0)))[..., 3]
    assert img[5, 5] == 1.0


def test_painter_order_blend():
    red = make_solid_paint(np.array([1, 0, 0, 1], np.float32))
    blue_half = make_solid_paint(np.array([0, 0, 1, 0.5], np.float32))
    sq = _poly_edges([(0, 0), (32, 0), (32, 32), (0, 32)])
    ops = [RasterOp(edges=sq, paint=red), RasterOp(edges=sq, paint=blue_half)]
    plan = bin_frame(ops, 32, 32)
    img = np.asarray(execute_plan(plan, background=(0, 0, 0, 0)))
    np.testing.assert_allclose(img[16, 16], [0.5, 0.0, 0.5, 1.0], atol=1e-5)


def test_pallas_kernel_matches_xla():
    """The frame's coverage formulation (ops/coverage.chunk_coverage) must
    agree with the per-slot formula evaluated in float32 numpy, summed in
    slot order, to float rounding."""
    import jax.numpy as jnp

    from vgtpu.ops.coverage import chunk_coverage

    from tests.test_coverage_kernel import slot_sum_f32

    rng = np.random.default_rng(11)
    edges = rng.uniform(-40, 170, (64, 8, 4)).astype(np.float32)
    a = slot_sum_f32(edges, 8, 128)
    b = np.asarray(chunk_coverage(jnp.asarray(edges), 8, 128))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_occlusion_culling_correctness():
    """An opaque full-cover layer culls entries below it (composite depth
    shrinks) without changing pixels; a translucent cover must NOT cull."""
    from vgtpu.raster.binning import compute_tile_buckets

    def plan_for(alpha):
        sq = _poly_edges([(0, 0), (200, 0), (200, 64), (0, 64)])
        ops = [
            RasterOp(edges=sq, paint=make_solid_paint(np.array([1, 0, 0, 1], np.float32))),
            RasterOp(edges=sq, paint=make_solid_paint(np.array([0, 1, 0, 1], np.float32))),
            RasterOp(edges=sq, paint=make_solid_paint(np.array([0, 0, 1, alpha], np.float32))),
        ]
        return bin_frame(ops, 200, 64), ops

    def live_slots(plan):
        buckets = compute_tile_buckets(
            plan.tile_entries, plan.tile_entries.shape[0], plan.entry_kind, plan
        )
        return sum(int((te >= 0).sum()) for te, _ids, _f in buckets)

    p_opaque, _ = plan_for(1.0)
    p_trans, _ = plan_for(0.5)
    assert live_slots(p_opaque) < live_slots(p_trans)

    img = np.asarray(execute_plan(p_opaque, background=(0, 0, 0, 0)))
    np.testing.assert_allclose(img[32, 64], [0, 0, 1, 1], atol=1e-5)  # top layer
    img_t = np.asarray(execute_plan(p_trans, background=(0, 0, 0, 0)))
    np.testing.assert_allclose(img_t[32, 64], [0, 0.5, 0.5, 1], atol=1e-5)  # blended


def test_fuzz_full_scenes_vs_oracle():
    """Randomized mixed scenes (fills both rules, strokes, scissors) through
    the FULL pipeline vs the supersampled oracle applied op-by-op."""
    import vgtpu as vg

    rng = np.random.default_rng(31)
    for trial in range(3):
        ctx = vg.createContext()
        vg.begin(ctx, 0, 96, 96, 1.0)
        oracle_img = np.zeros((96, 96, 4))

        def blend_oracle(cov, rgba):
            nonlocal oracle_img
            a = cov * rgba[3]
            oracle_img[..., :3] = (rgba[None, None, :3] * a[..., None]
                                   + oracle_img[..., :3] * (1 - a[..., None]))
            oracle_img[..., 3] = a + oracle_img[..., 3] * (1 - a)

        from vgtpu.geometry.stroker import contours_to_edges, stroke_outline

        for _ in range(5):
            rgba = rng.uniform(0.2, 1.0, 4)
            color = vg.color4f(*rgba[:3], rgba[3])
            if rng.uniform() < 0.6:
                pts = rng.uniform(4, 92, (int(rng.integers(3, 8)), 2))
                rule = int(rng.integers(0, 2))
                vg.beginPath(ctx)
                vg.moveTo(ctx, *pts[0])
                for q in pts[1:]:
                    vg.lineTo(ctx, *q)
                vg.closePath(ctx)
                vg.fillPath(ctx, color, vg.fill_flags(vg.PathType.Concave, rule, True))
                e = _poly_edges(pts)
                cov = coverage_oracle(e, 96, 96, fill_rule=rule, samples=8)
            else:
                pts = rng.uniform(8, 88, (int(rng.integers(2, 5)), 2))
                w = float(rng.uniform(2, 8))
                vg.beginPath(ctx)
                vg.moveTo(ctx, *pts[0])
                for q in pts[1:]:
                    vg.lineTo(ctx, *q)
                vg.strokePath(ctx, color, w, vg.StrokeFlags.ButtMiterAA)
                contours = stroke_outline(pts.astype(np.float32), False, w,
                                          vg.LineCap.Butt, vg.LineJoin.Miter)
                cov = coverage_oracle(contours_to_edges(contours), 96, 96, 0, samples=8)
            # quantize color like the engine (u8 round-trip)
            q = np.array([vg.colorGetRed(color), vg.colorGetGreen(color),
                          vg.colorGetBlue(color), vg.colorGetAlpha(color)]) / 255.0
            blend_oracle(cov, q)

        img = np.asarray(vg.end(ctx, background=(0, 0, 0, 0)))
        d = np.abs(img - oracle_img)
        assert d.mean() < 6e-3, (trial, d.mean())
        assert (d.max(axis=-1) > 0.12).mean() < 0.01, trial


def test_pallas_transposed_kernel_matches_xla():
    """The frame's coverage formulation across pool sizes the binner uses."""
    import jax.numpy as jnp

    from vgtpu.ops.coverage import chunk_coverage

    from tests.test_coverage_kernel import slot_sum_f32

    rng = np.random.default_rng(13)
    for ch in (2, 6, 24):
        edges = rng.uniform(-40, 170, (256, ch, 4)).astype(np.float32)
        a = slot_sum_f32(edges, 8, 128)
        b = np.asarray(chunk_coverage(jnp.asarray(edges), 8, 128))
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=str(ch))


def test_entry_coverage_gather_matches_segment_sum():
    """The inverse-permutation gather path must match the general
    segment-sum reduction on a real multi-pool plan."""
    import jax.numpy as jnp

    import vgtpu as vg
    from vgtpu.ops.coverage import (
        build_cov_gather_map,
        entry_coverage_from_pools,
        entry_coverage_gather,
    )
    from vgtpu.raster.binning import bin_frame

    rng = np.random.default_rng(5)
    ctx = vg.createContext()
    vg.begin(ctx, 0, 384, 192, 1.0)
    for _ in range(25):
        vg.beginPath(ctx)
        pts = rng.uniform(-10, 380, (int(rng.integers(3, 60)), 2))
        vg.polyline(ctx, pts)
        vg.closePath(ctx)
        vg.fillPath(ctx, vg.color4ub(*rng.integers(0, 256, 3), 255),
                    vg.FillFlags.ConcaveNonZeroAA)
    ctx._finalize_ops()
    plan = bin_frame(ctx.ops, 384, 192)
    ne = plan.entry_backdrop.shape[0]
    pools = tuple((jnp.asarray(ce), jnp.asarray(cent)) for ce, cent in plan.chunk_pools)
    ref = np.asarray(entry_coverage_from_pools(pools, ne, plan.tile_h, plan.tile_w))
    m = build_cov_gather_map(plan.chunk_pools, ne)
    got = np.asarray(entry_coverage_gather(
        pools, {k: jnp.asarray(v) for k, v in m.items()}, ne, plan.tile_h, plan.tile_w))
    np.testing.assert_allclose(got, ref, atol=1e-5)
