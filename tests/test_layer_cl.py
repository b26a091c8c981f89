"""Translated cached-list layer (api/command_list._layer_submit): a
Cacheable command list re-submitted under a translation-only delta renders
as a retained-scene layer (zero host replay / rebin of the artwork) with the
frame's remaining ops composited over it — this engine's analogue of the
reference's clCacheRender re-transforming cached meshes under any new
matrix (vg.cpp:5845-6120, invalidation rule vg.cpp:4287-4300).

Parity is float-level (like the reference's re-transformed meshes vs
retessellation), checked against a context with layer_memo disabled."""

from __future__ import annotations

import numpy as np
import pytest

import vgtpu as vg

W, H = 384, 160
BG = (0.10, 0.12, 0.15, 1.0)


def _artwork(ctx):
    """The cached 'tiger': fills, a stroke, a gradient, concave geometry."""
    vg.beginPath(ctx)
    vg.circle(ctx, 60, 50, 34)
    vg.fillPath(ctx, vg.color4ub(220, 120, 40, 255), vg.FillFlags.ConvexAA)
    g = vg.createLinearGradient(ctx, 90, 20, 190, 90,
                                vg.Colors.Red, vg.Colors.Blue)
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 95, 22, 90, 60, 10)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 40, 100)
    vg.lineTo(ctx, 150, 120)
    vg.lineTo(ctx, 80, 85)
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(60, 180, 90, 220),
                vg.FillFlags.ConcaveNonZeroAA)
    vg.beginPath(ctx)
    vg.circle(ctx, 170, 105, 18)
    vg.strokePath(ctx, vg.Colors.Black, 3.0, vg.StrokeFlags.RoundRoundAA)


def _ui(ctx, t, col=(250, 220, 60, 230)):
    vg.beginPath(ctx)
    vg.rect(ctx, 260 + 10 * t, 110, 60, 30)
    vg.fillPath(ctx, vg.color4ub(*col), vg.FillFlags.ConvexAA)


def _make(layer=True):
    ctx = vg.createContext(vg.ContextConfig(layer_memo=layer))
    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    vg.beginCommandList(ctx, cl)
    _artwork(ctx)
    vg.endCommandList(ctx)
    return ctx, cl


def _frame(ctx, cl, off, t, bg=BG, ui_col=(250, 220, 60, 230)):
    vg.begin(ctx, 0, W, H, 1.0)
    vg.pushState(ctx)
    vg.transformTranslate(ctx, off[0], off[1])
    vg.submitCommandList(ctx, cl)
    vg.popState(ctx)
    _ui(ctx, t, ui_col)
    vg.end(ctx, background=bg)
    return np.asarray(ctx.frame_image)


OFFSETS = [(0.0, 0.0), (0.0, 0.0), (6.0, 4.0), (13.5, -3.0), (-9.0, 10.0),
           (25.25, 7.0)]


def test_translated_cached_list_matches_direct():
    ctx, cl = _make(True)
    ref_ctx, ref_cl = _make(False)
    for k, off in enumerate(OFFSETS):
        img = _frame(ctx, cl, off, 0.3 * k)
        exp = _frame(ref_ctx, ref_cl, off, 0.3 * k)
        np.testing.assert_allclose(img, exp, atol=3e-4,
                                   err_msg=f"frame {k} offset {off}")
    c = ctx.profiler.counters
    assert c.get("layer_cl_bakes", 0) == 1, c
    # offsets 3..5 (after the bake at the first MOVED submit) hit the layer
    assert c.get("layer_cl_hits", 0) >= 2, c


def test_fractional_vertical_pan_falls_back():
    """dy off the pixel grid is not representable in the retained
    formulation — the submit must fall back to host replay, still exact."""
    ctx, cl = _make(True)
    ref_ctx, ref_cl = _make(False)
    for off in [(0, 0), (0, 0), (4, 2), (8, 4), (3.0, 2.5), (3.0, 3.5)]:
        img = _frame(ctx, cl, off, 0.1)
        exp = _frame(ref_ctx, ref_cl, off, 0.1)
        np.testing.assert_allclose(img, exp, atol=3e-4, err_msg=f"{off}")


def test_scale_change_invalidates_scene():
    """avgScale change invalidates the cache (vg.cpp:4287-4300); the layer
    scene must not survive into the rebuilt cache."""
    ctx, cl = _make(True)
    ref_ctx, ref_cl = _make(False)
    for off in [(0, 0), (0, 0), (5, 3), (9, 6)]:
        np.testing.assert_allclose(_frame(ctx, cl, off, 0.2),
                                   _frame(ref_ctx, ref_cl, off, 0.2),
                                   atol=3e-4)

    def scaled(c, l, off):
        vg.begin(c, 0, W, H, 1.0)
        vg.pushState(c)
        vg.transformTranslate(c, off[0], off[1])
        vg.transformScale(c, 1.3, 1.3)
        vg.submitCommandList(c, l)
        vg.popState(c)
        _ui(c, 0.2)
        vg.end(c, background=BG)
        return np.asarray(c.frame_image)

    for off in [(0, 0), (4, 2), (7, 5)]:
        np.testing.assert_allclose(scaled(ctx, cl, off),
                                   scaled(ref_ctx, ref_cl, off), atol=3e-4)


def test_paint_memo_composes_with_pending_layer():
    """At a FIXED translated offset, a suffix paint-value-only delta takes
    the paint-memo patch (the layer token rides the structural hash)."""
    ctx, cl = _make(True)
    ref_ctx, ref_cl = _make(False)
    for off in [(0, 0), (0, 0), (5, 3), (12, 6), (12, 6)]:
        np.testing.assert_allclose(_frame(ctx, cl, off, 0.4),
                                   _frame(ref_ctx, ref_cl, off, 0.4),
                                   atol=3e-4)
    assert ctx.profiler.counters.get("layer_cl_hits", 0) >= 1
    hits0 = ctx.profiler.counters.get("memo_paint_hits", 0)
    for col in ((40, 220, 90, 230), (220, 90, 200, 230)):
        img = _frame(ctx, cl, (12, 6), 0.4, ui_col=col)
        exp = _frame(ref_ctx, ref_cl, (12, 6), 0.4, ui_col=col)
        np.testing.assert_allclose(img, exp, atol=3e-4)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == hits0 + 2


def test_background_change_with_pending_layer():
    ctx, cl = _make(True)
    ref_ctx, ref_cl = _make(False)
    seq = [((0, 0), BG), ((0, 0), BG), ((5, 3), BG), ((10, 6), BG),
           ((10, 6), (0.3, 0.1, 0.1, 1.0)), ((15, 9), (0.3, 0.1, 0.1, 1.0))]
    for off, bg in seq:
        np.testing.assert_allclose(_frame(ctx, cl, off, 0.2, bg=bg),
                                   _frame(ref_ctx, ref_cl, off, 0.2, bg=bg),
                                   atol=3e-4, err_msg=f"{off} {bg}")


def test_translated_list_dpr2():
    """devicePixelRatio 2: the layer offset is dpr-scaled (framebuffer
    pixels), and half-pixel LOGICAL vertical offsets land on integer
    framebuffer rows."""
    def frame(ctx, cl, off, t):
        vg.begin(ctx, 0, W, H, 2.0)
        vg.pushState(ctx)
        vg.transformTranslate(ctx, off[0], off[1])
        vg.submitCommandList(ctx, cl)
        vg.popState(ctx)
        _ui(ctx, t)
        vg.end(ctx, background=BG)
        return np.asarray(ctx.frame_image)

    ctx, cl = _make(True)
    ref_ctx, ref_cl = _make(False)
    for k, off in enumerate([(0, 0), (0, 0), (4, 2.5), (9.25, -1.5),
                             (3.0, 5.0)]):
        np.testing.assert_allclose(frame(ctx, cl, off, 0.2 * k),
                                   frame(ref_ctx, ref_cl, off, 0.2 * k),
                                   atol=3e-4, err_msg=f"frame {k} {off}")
    assert ctx.profiler.counters.get("layer_cl_hits", 0) >= 2


def test_text_in_translated_list():
    """Textured artwork (glyph color tiles) pans through the retained
    resample path."""
    from tests.fontdata import FONT_DATA

    if FONT_DATA is None:
        pytest.skip("no test font available")

    def make(layer):
        ctx = vg.createContext(vg.ContextConfig(layer_memo=layer))
        f = vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
        cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
        vg.beginCommandList(ctx, cl)
        _artwork(ctx)
        cfg = vg.makeTextConfig(ctx, f, 20.0, vg.TextAlign.BaselineLeft,
                                vg.color4ub(240, 240, 255, 255))
        vg.text(ctx, cfg, 30, 140, "cached label")
        vg.endCommandList(ctx)
        return ctx, cl

    ctx, cl = make(True)
    ref_ctx, ref_cl = make(False)
    for k, off in enumerate(OFFSETS):
        img = _frame(ctx, cl, off, 0.2 * k)
        exp = _frame(ref_ctx, ref_cl, off, 0.2 * k)
        np.testing.assert_allclose(img, exp, atol=3e-3,
                                   err_msg=f"frame {k} offset {off}")
    assert ctx.profiler.counters.get("layer_cl_hits", 0) >= 2


def test_translated_list_supersampled():
    """The layer path composes with conflation-free coverage
    (coverage_supersample=2): the cached artwork bakes as a supersampled
    retained scene, pans at whole sub-rows (half-pixel dy here), and the
    supersampled suffix plan composites over its output-domain tiles."""
    def make(layer):
        ctx = vg.createContext(vg.ContextConfig(
            layer_memo=layer, coverage_supersample=2))
        cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
        vg.beginCommandList(ctx, cl)
        _artwork(ctx)
        vg.endCommandList(ctx)
        return ctx, cl

    ctx, cl = make(True)
    ref_ctx, ref_cl = make(False)
    offs = [(0.0, 0.0), (0.0, 0.0), (6.0, 4.0), (13.5, -3.5), (-9.0, 10.0)]
    for k, off in enumerate(offs):
        img = _frame(ctx, cl, off, 0.3 * k)
        exp = _frame(ref_ctx, ref_cl, off, 0.3 * k)
        np.testing.assert_allclose(img, exp, atol=3e-4,
                                   err_msg=f"frame {k} offset {off}")
    c = ctx.profiler.counters
    assert c.get("layer_cl_bakes", 0) == 1, c
    assert c.get("layer_cl_hits", 0) >= 2, c


def test_text_in_translated_list_supersampled():
    """Text (P_TEXTURE) through the SUPERSAMPLED layer path: the cached
    list bakes as an ss=2 retained scene whose sampler must see unscaled
    (output-pixel) quad params.  Regression for the bake path that fed
    y-scaled ops to build_sampling_plan (glyphs vanished/mis-sampled)."""
    from tests.fontdata import FONT_DATA

    if FONT_DATA is None:
        pytest.skip("no test font available")

    def make(layer):
        ctx = vg.createContext(vg.ContextConfig(
            layer_memo=layer, coverage_supersample=2))
        f = vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
        cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
        vg.beginCommandList(ctx, cl)
        _artwork(ctx)
        cfg = vg.makeTextConfig(ctx, f, 20.0, vg.TextAlign.BaselineLeft,
                                vg.color4ub(240, 240, 255, 255))
        vg.text(ctx, cfg, 30, 140, "cached ss label")
        vg.endCommandList(ctx)
        return ctx, cl

    ctx, cl = make(True)
    ref_ctx, ref_cl = make(False)
    offs = [(0.0, 0.0), (0.0, 0.0), (6.0, 4.0), (13.5, -3.5), (-9.0, 10.0)]
    for k, off in enumerate(offs):
        img = _frame(ctx, cl, off, 0.2 * k)
        exp = _frame(ref_ctx, ref_cl, off, 0.2 * k)
        np.testing.assert_allclose(img, exp, atol=3e-3,
                                   err_msg=f"frame {k} offset {off}")
    assert ctx.profiler.counters.get("layer_cl_hits", 0) >= 2


def test_static_ui_overlay_layer_over_pan():
    """A frame-static UI block ABOVE the panned list bakes as a TRANSPARENT
    overlay (context._layer_split transparent form) blended over the pan
    tiles in-trace (retained.PendingPanLayer.over_tiles); only the dynamic
    tail re-bins.  Pixel parity vs the layer-disabled reference across
    moving offsets, then a paint patch on the dynamic tail at a paused
    offset with the overlay resident."""
    def chrome(c):
        for i in range(18):           # >= layer_min_prefix static ops
            vg.beginPath(c)
            vg.rect(c, 8 + 20 * i, 4, 16, 10)
            vg.fillPath(c, vg.color4ub(30 + 10 * i, 80, 120, 200),
                        vg.FillFlags.ConvexAA)

    def frame(c, l, off, t, col=(250, 220, 60, 230)):
        vg.begin(c, 0, W, H, 1.0)
        vg.pushState(c)
        vg.transformTranslate(c, off[0], off[1])
        vg.submitCommandList(c, l)
        vg.popState(c)
        chrome(c)
        _ui(c, t, col)
        vg.end(c, background=BG)
        return np.asarray(c.frame_image)

    ctx, cl = _make(True)
    ref_ctx, ref_cl = _make(False)
    for off in [(0, 0), (0, 0), (5, 3), (9, 6), (14, -2), (20, 4)]:
        np.testing.assert_allclose(frame(ctx, cl, off, 0.2),
                                   frame(ref_ctx, ref_cl, off, 0.2),
                                   atol=3e-4, err_msg=f"off {off}")
    c = ctx.profiler.counters
    assert c.get("layer_bakes", 0) >= 1   # the transparent overlay baked
    assert c.get("layer_cl_hits", 0) >= 2
    # paint-value patch on the dynamic tail, overlay + pan layer resident
    np.testing.assert_allclose(
        frame(ctx, cl, (20, 4), 0.2),
        frame(ref_ctx, ref_cl, (20, 4), 0.2), atol=3e-4)
    hits0 = c.get("memo_paint_hits", 0)
    img = frame(ctx, cl, (20, 4), 0.2, col=(60, 200, 220, 230))
    exp = frame(ref_ctx, ref_cl, (20, 4), 0.2, col=(60, 200, 220, 230))
    np.testing.assert_allclose(img, exp, atol=3e-4)
    assert c.get("memo_paint_hits", 0) == hits0 + 1


def test_background_change_with_overlay_layer():
    """Changing the frame background while BOTH the pan layer and the
    transparent static-UI overlay are resident: the overlay bake is
    bg-independent (transparent), the pan tiles take the new background,
    and the memo guard forces the full path — pixels must match the
    layer-disabled reference at every step."""
    def chrome(c):
        for i in range(18):
            vg.beginPath(c)
            vg.rect(c, 8 + 20 * i, 4, 16, 10)
            vg.fillPath(c, vg.color4ub(30 + 10 * i, 80, 120, 200),
                        vg.FillFlags.ConvexAA)

    def frame(c, l, off, bg):
        vg.begin(c, 0, W, H, 1.0)
        vg.pushState(c)
        vg.transformTranslate(c, off[0], off[1])
        vg.submitCommandList(c, l)
        vg.popState(c)
        chrome(c)
        _ui(c, 0.2)
        vg.end(c, background=bg)
        return np.asarray(c.frame_image)

    ctx, cl = _make(True)
    ref_ctx, ref_cl = _make(False)
    bg2 = (0.3, 0.1, 0.1, 1.0)
    seq = [((0, 0), BG), ((0, 0), BG), ((5, 3), BG), ((9, 6), BG),
           ((14, -2), BG), ((14, -2), bg2), ((20, 4), bg2)]
    for off, bg in seq:
        np.testing.assert_allclose(frame(ctx, cl, off, bg),
                                   frame(ref_ctx, ref_cl, off, bg),
                                   atol=3e-4, err_msg=f"{off} {bg}")
    assert ctx.profiler.counters.get("layer_bakes", 0) >= 1
