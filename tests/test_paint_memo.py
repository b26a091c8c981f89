"""Paint-only frame memoization (ContextConfig.paint_memo).

When an app re-records a geometry-identical frame where only solid/gradient
paint VALUES changed (color/alpha animation — fades, hover highlights,
pulsing), the engine patches the resident plan's paint tables instead of
re-binning and re-uploading (context._paint_only_update).  The patched frame
must be pixel-identical to a from-scratch render, and the one plan-shaping
use of paint values — occlusion culling of solid alpha>=1 covers
(binning.compute_tile_buckets) — must force the full path whenever the
opacity class of a changed row flips.
"""

from __future__ import annotations

import numpy as np
import pytest

import vgtpu as vg

W, H = 320, 160

from tests.fontdata import FONT_DATA  # shared discovery

BG = (0.1, 0.1, 0.12, 1.0)


def draw_scene(ctx, font, *, rect_col, circ_col, grad=((250, 60, 40, 255), (40, 60, 250, 255)),
               grad_geo=(20.0, 20.0, 200.0, 90.0), alpha=1.0, text_col=(255, 255, 255, 255),
               stroke_col=(20, 220, 120, 255)):
    vg.setGlobalAlpha(ctx, alpha)
    g = vg.createLinearGradient(ctx, *grad_geo,
                                vg.color4ub(*grad[0]), vg.color4ub(*grad[1]))
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 15, 15, 120, 80, 12)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.circle(ctx, 200, 60, 38)
    vg.fillPath(ctx, vg.color4ub(*circ_col), vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.rect(ctx, 170, 30, 110, 70)
    vg.fillPath(ctx, vg.color4ub(*rect_col), vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 20, 140)
    vg.cubicTo(ctx, 90, 100, 180, 150, 300, 115)
    vg.strokePath(ctx, vg.color4ub(*stroke_col), 4.0, vg.StrokeFlags.RoundRoundAA)
    if font is not None and text_col is not None:
        cfg = vg.makeTextConfig(ctx, "sans", 20.0,
                                vg.TextAlign.Left | vg.TextAlign.Top,
                                vg.color4ub(*text_col))
        vg.text(ctx, cfg, 30, 110, "paint memo")


def fresh_render(**kw):
    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    font = (vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
            if FONT_DATA is not None else None)
    draw_scene(ctx, font, **kw)
    vg.end(ctx, background=BG)
    return np.asarray(ctx.frame_image)


def animated_ctx():
    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    font = (vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
            if FONT_DATA is not None else None)
    return ctx, font


def rerecord(ctx, font, **kw):
    draw_scene(ctx, font, **kw)
    vg.end(ctx, background=BG)
    img = np.asarray(ctx.frame_image)
    vg.begin(ctx, 0, W, H, 1.0)
    return img


BASE = dict(rect_col=(90, 140, 220, 160), circ_col=(250, 210, 60, 255))


def test_solid_recolor_takes_fast_path_and_matches():
    ctx, font = animated_ctx()
    rerecord(ctx, font, **BASE)
    kw = dict(BASE, rect_col=(220, 70, 50, 160))
    got = rerecord(ctx, font, **kw)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 1
    np.testing.assert_allclose(got, fresh_render(**kw), atol=2e-5)


def test_gradient_value_and_geometry_change_take_fast_path():
    ctx, font = animated_ctx()
    rerecord(ctx, font, **BASE)
    kw = dict(BASE, grad=((30, 230, 90, 255), (240, 240, 40, 200)),
              grad_geo=(40.0, 10.0, 120.0, 140.0))
    got = rerecord(ctx, font, **kw)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 1
    np.testing.assert_allclose(got, fresh_render(**kw), atol=2e-5)


def test_global_alpha_fade_takes_fast_path():
    """A global fade resolves into every solid/gradient row (vg.cpp:3070
    alpha modulation happens at record time here too) — geometry fingerprint
    is unchanged, so the whole fade animates on the patch path.  With text
    present the modulated text color is a texture-row value: it patches via
    the resample path."""
    ctx, font = animated_ctx()
    base = dict(BASE, alpha=0.9, circ_col=(250, 210, 60, 230))
    rerecord(ctx, font, **base)
    hits = 0
    for a in (0.75, 0.6, 0.45):
        kw = dict(base, alpha=a)
        got = rerecord(ctx, font, **kw)
        hits += 1
        assert ctx.profiler.counters.get("memo_paint_hits", 0) == hits
        np.testing.assert_allclose(got, fresh_render(**kw), atol=2e-5)


def test_opacity_class_flip_falls_back_and_uncovers():
    """The opaque rect occludes part of the circle (occlusion culling may
    have dropped the covered entries); making it translucent must NOT take
    the patch path — the circle has to show through again."""
    ctx, font = animated_ctx()
    rerecord(ctx, font, rect_col=(90, 140, 220, 255), circ_col=(250, 210, 60, 255))
    kw = dict(rect_col=(90, 140, 220, 120), circ_col=(250, 210, 60, 255))
    got = rerecord(ctx, font, **kw)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 0
    np.testing.assert_allclose(got, fresh_render(**kw), atol=2e-5)


def test_opaque_to_opaque_recolor_of_cover_is_fast():
    ctx, font = animated_ctx()
    rerecord(ctx, font, rect_col=(90, 140, 220, 255), circ_col=(250, 210, 60, 255))
    kw = dict(rect_col=(20, 200, 180, 255), circ_col=(250, 210, 60, 255))
    got = rerecord(ctx, font, **kw)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 1
    np.testing.assert_allclose(got, fresh_render(**kw), atol=2e-5)


@pytest.mark.skipif(FONT_DATA is None, reason="no font available")
def test_text_recolor_takes_fast_path_and_matches():
    """Text color modulates the color tiles in the TEXTURES stage
    (sampling paint[10:14]): the patch re-runs sampling against the
    resident plan instead of re-binning."""
    ctx, font = animated_ctx()
    rerecord(ctx, font, **BASE)
    kw = dict(BASE, text_col=(255, 120, 40, 255))
    got = rerecord(ctx, font, **kw)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 1
    np.testing.assert_allclose(got, fresh_render(**kw), atol=2e-5)


def _pattern_scene(ctx, h, *, cx, cy, angle=0.0, rect_col=(90, 140, 220, 160)):
    p = vg.createImagePattern(ctx, cx, cy, 96.0, 96.0, angle, h)
    vg.beginPath(ctx)
    vg.rect(ctx, 10, 10, 220, 120)
    vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.rect(ctx, 200, 30, 100, 100)
    vg.fillPath(ctx, vg.color4ub(*rect_col), vg.FillFlags.ConvexAA)


def _checker():
    img = np.zeros((64, 64, 4), np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    c = ((yy // 8 + xx // 8) % 2).astype(np.uint8)
    img[..., 0] = 40 + 180 * c
    img[..., 1] = 200 - 120 * c
    img[..., 2] = 90 + 60 * c
    img[..., 3] = 255
    return img


@pytest.mark.parametrize("device_sampling", [False, True])
def test_pattern_pan_takes_fast_path(device_sampling):
    """Animating the pattern's paint matrix (cx/cy pan — the reference feeds
    the same inverse matrix as a per-draw uniform, vs_image_pattern.sc)
    changes only the P_IMAGE paint row: the patch resamples color tiles
    against the resident plan and skips bin/upload."""
    img = _checker()

    def frame(ctx, h, cx, cy, angle=0.0):
        _pattern_scene(ctx, h, cx=cx, cy=cy, angle=angle)
        vg.end(ctx, background=BG)
        out = np.asarray(ctx.frame_image)
        vg.begin(ctx, 0, W, H, 1.0)
        return out

    def fresh(cx, cy, angle=0.0):
        c2 = vg.createContext(vg.ContextConfig(device_sampling=device_sampling))
        vg.begin(c2, 0, W, H, 1.0)
        h2 = vg.createImage(c2, 64, 64, 0, img)
        _pattern_scene(c2, h2, cx=cx, cy=cy, angle=angle)
        vg.end(c2, background=BG)
        return np.asarray(c2.frame_image)

    ctx = vg.createContext(vg.ContextConfig(device_sampling=device_sampling))
    vg.begin(ctx, 0, W, H, 1.0)
    h = vg.createImage(ctx, 64, 64, 0, img)
    frame(ctx, h, 40.0, 20.0)
    hits = 0
    for cx, cy in ((52.0, 26.0), (64.0, 33.0), (17.0, 5.0)):
        got = frame(ctx, h, cx, cy)
        hits += 1
        assert ctx.profiler.counters.get("memo_paint_hits", 0) == hits
        np.testing.assert_allclose(got, fresh(cx, cy), atol=2e-5,
                                   err_msg=f"pan ({cx},{cy})")
    # rotation flips the separable/gather sampling-path choice per group —
    # the resample rebuilds groups from scratch, so it must still match
    got = frame(ctx, h, 40.0, 20.0, angle=0.4)
    hits += 1
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == hits
    np.testing.assert_allclose(got, fresh(40.0, 20.0, angle=0.4), atol=2e-5)


@pytest.mark.parametrize("device_sampling", [False, True])
def test_updateImage_takes_fast_path(device_sampling):
    """The video-pattern case: updateImage + a geometry-identical re-record
    patches the resident plan (texel content is consumed only by the
    TEXTURES resample; the image generation rides the texture signature)."""
    img = _checker()

    def content(step):
        out = img.copy()
        out[:, :, 0] = (out[:, :, 0].astype(int) + 40 * step) % 256
        return out

    def fresh(step):
        c2 = vg.createContext(vg.ContextConfig(device_sampling=device_sampling))
        vg.begin(c2, 0, W, H, 1.0)
        h2 = vg.createImage(c2, 64, 64, 0, content(step))
        _pattern_scene(c2, h2, cx=40.0, cy=20.0)
        vg.end(c2, background=BG)
        return np.asarray(c2.frame_image)

    ctx = vg.createContext(vg.ContextConfig(device_sampling=device_sampling))
    vg.begin(ctx, 0, W, H, 1.0)
    h = vg.createImage(ctx, 64, 64, 0, content(0))
    _pattern_scene(ctx, h, cx=40.0, cy=20.0)
    vg.end(ctx, background=BG)
    for step in (1, 2):
        vg.begin(ctx, 0, W, H, 1.0)
        vg.updateImage(ctx, h, 0, 0, 64, 64, content(step))
        _pattern_scene(ctx, h, cx=40.0, cy=20.0)
        vg.end(ctx, background=BG)
        got = np.asarray(ctx.frame_image)
        assert ctx.profiler.counters.get("memo_paint_hits", 0) == step
        np.testing.assert_allclose(got, fresh(step), atol=2e-5,
                                   err_msg=f"updateImage step {step}")


def test_textured_trilist_updateImage_takes_full_path():
    """Regression: a textured indexedTriList op has paint=None (its values
    live in tri_paints / per-triangle pseudo-ops), so it must NOT enter the
    value-patch signatures — updateImage on its image has to force the full
    path (a broken patch here NaN-corrupted the resident paint rows)."""
    img = _checker()

    def tri_frame(ctx, h):
        pos = [(20, 20), (120, 20), (120, 100), (20, 100)]
        uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
        vg.indexedTriList(ctx, pos, uv, 4, [vg.Colors.White], 1,
                          [0, 1, 2, 0, 2, 3], 6, h)
        vg.end(ctx, background=BG)
        out = np.asarray(ctx.frame_image)
        vg.begin(ctx, 0, W, H, 1.0)
        return out

    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    h = vg.createImage(ctx, 64, 64, 0, img)
    first = tri_frame(ctx, h)
    assert np.isfinite(first).all()

    img2 = img.copy()
    img2[..., 0] = 255
    vg.updateImage(ctx, h, 0, 0, 64, 64, img2)
    got = tri_frame(ctx, h)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 0
    assert np.isfinite(got).all()
    assert not np.allclose(got, first)  # new texels actually rendered

    c2 = vg.createContext()
    vg.begin(c2, 0, W, H, 1.0)
    h2 = vg.createImage(c2, 64, 64, 0, img2)
    np.testing.assert_allclose(got, tri_frame(c2, h2), atol=2e-5)


def test_pattern_and_solid_recolor_combined_fast_path():
    """A frame delta touching BOTH kinds of value rows (solid recolor +
    pattern pan) patches both in one pass."""
    img = _checker()

    ctx = vg.createContext(vg.ContextConfig(device_sampling=True))
    vg.begin(ctx, 0, W, H, 1.0)
    h = vg.createImage(ctx, 64, 64, 0, img)
    _pattern_scene(ctx, h, cx=40.0, cy=20.0)
    vg.end(ctx, background=BG)
    vg.begin(ctx, 0, W, H, 1.0)
    _pattern_scene(ctx, h, cx=55.0, cy=31.0, rect_col=(250, 60, 60, 200))
    vg.end(ctx, background=BG)
    got = np.asarray(ctx.frame_image)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 1

    c2 = vg.createContext(vg.ContextConfig(device_sampling=True))
    vg.begin(c2, 0, W, H, 1.0)
    h2 = vg.createImage(c2, 64, 64, 0, img)
    _pattern_scene(c2, h2, cx=55.0, cy=31.0, rect_col=(250, 60, 60, 200))
    vg.end(c2, background=BG)
    np.testing.assert_allclose(got, np.asarray(c2.frame_image), atol=2e-5)


def test_paint_memo_disabled_still_matches():
    ctx = vg.createContext(vg.ContextConfig(paint_memo=False))
    vg.begin(ctx, 0, W, H, 1.0)
    font = (vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
            if FONT_DATA is not None else None)
    rerecord(ctx, font, **BASE)
    kw = dict(BASE, rect_col=(220, 70, 50, 160))
    got = rerecord(ctx, font, **kw)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 0
    np.testing.assert_allclose(got, fresh_render(**kw), atol=2e-5)


def test_supersample_recolor_fast_path():
    cfg = vg.ContextConfig(coverage_supersample=4)
    ctx = vg.createContext(cfg)
    vg.begin(ctx, 0, W, H, 1.0)
    font = None
    kw0 = dict(BASE)
    draw_scene(ctx, font, **kw0)
    vg.end(ctx, background=BG)
    vg.begin(ctx, 0, W, H, 1.0)
    kw = dict(BASE, rect_col=(250, 40, 160, 200), stroke_col=(240, 240, 40, 255))
    draw_scene(ctx, font, **kw)
    vg.end(ctx, background=BG)
    got = np.asarray(ctx.frame_image)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 1

    ctx2 = vg.createContext(vg.ContextConfig(coverage_supersample=4))
    vg.begin(ctx2, 0, W, H, 1.0)
    draw_scene(ctx2, None, **kw)
    vg.end(ctx2, background=BG)
    np.testing.assert_allclose(got, np.asarray(ctx2.frame_image), atol=2e-5)


def test_fuzz_random_recolors_match_fresh_renders():
    """A long animation of random solid+gradient value mutations: every
    patched frame equals a from-scratch render of the same content."""
    rng = np.random.default_rng(5)

    def kwargs(step):
        return dict(
            rect_col=tuple(int(v) for v in rng.integers(0, 256, 3)) + (160,),
            circ_col=tuple(int(v) for v in rng.integers(0, 256, 4)),
            grad=(tuple(int(v) for v in rng.integers(0, 256, 4)),
                  tuple(int(v) for v in rng.integers(0, 256, 4))),
            grad_geo=(float(rng.uniform(0, 60)), float(rng.uniform(0, 40)),
                      float(rng.uniform(100, 250)), float(rng.uniform(60, 150))),
            text_col=tuple(int(v) for v in rng.integers(0, 256, 3)) + (255,),
            stroke_col=tuple(int(v) for v in rng.integers(0, 256, 4)),
        )

    ctx, font = animated_ctx()
    rerecord(ctx, font, **BASE)
    for step in range(6):
        kw = kwargs(step)
        got = rerecord(ctx, font, **kw)
        np.testing.assert_allclose(
            got, fresh_render(**kw), atol=2e-5,
            err_msg=f"fuzz step {step} diverged")
    # the rect alpha stays at 160 and every other alpha stays < 255
    # opaque-flip-free -> all six frames should have taken the fast path
    assert ctx.profiler.counters.get("memo_paint_hits", 0) >= 4
