"""Device-resident retained-scene panning (raster/retained.py): a baked
scene rendered at an integer view offset must match re-recording the frame
with the inverse translate and rendering directly — across whole-tile and
sub-tile residuals, both signs, fills (both rules), strokes, gradients,
clip groups, scissors, and tri batches."""

from __future__ import annotations

import numpy as np
import pytest

import vgtpu as vg
from vgtpu.raster.retained import RetainedScene

W, H = 384, 160


def _scene(ctx):
    # background card
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 8, 8, 200, 120, 12)
    vg.fillPath(ctx, vg.color4ub(40, 90, 160, 255), vg.FillFlags.ConvexAA)
    # self-intersecting star, even-odd
    vg.beginPath(ctx)
    pts = [(60 + 50 * np.cos(a), 70 + 50 * np.sin(a))
           for a in np.linspace(-np.pi / 2, 1.5 * np.pi, 6)[:-1][::2].repeat(1)]
    star = [(60 + 50 * np.cos(-np.pi / 2 + k * 4 * np.pi / 5),
             70 + 50 * np.sin(-np.pi / 2 + k * 4 * np.pi / 5)) for k in range(5)]
    vg.moveTo(ctx, *star[0])
    for p in star[1:]:
        vg.lineTo(ctx, *p)
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(250, 200, 40, 200), vg.FillFlags.ConcaveEvenOddAA)
    # gradient bar
    g = vg.createLinearGradient(ctx, 220, 20, 360, 20,
                                vg.color4ub(255, 0, 80, 255),
                                vg.color4ub(0, 220, 255, 255))
    vg.beginPath(ctx)
    vg.rect(ctx, 220, 20, 140, 40)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    # stroked curve
    vg.beginPath(ctx)
    vg.moveTo(ctx, 230, 90)
    vg.cubicTo(ctx, 260, 60, 320, 140, 360, 100)
    vg.strokePath(ctx, vg.color4ub(240, 240, 240, 255), 3.0,
                  vg.StrokeFlags.RoundRoundAA)
    # clipped checker under scissor
    vg.pushState(ctx)
    vg.setScissor(ctx, 20, 96, 160, 40)
    vg.beginClip(ctx, vg.ClipRule.In)
    vg.beginPath(ctx)
    vg.circle(ctx, 80, 116, 30)
    vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.ConvexAA)
    vg.endClip(ctx)
    for i in range(4):
        vg.beginPath(ctx)
        vg.rect(ctx, 30 + i * 30, 100, 20, 32)
        vg.fillPath(ctx, vg.color4ub(30 + 60 * i, 200, 90, 255),
                    vg.FillFlags.ConvexAA)
    vg.resetClip(ctx)
    vg.popState(ctx)
    # tri batch (color wheel wedge)
    pos = np.array([[300, 120], [340, 120], [320, 150]], np.float32)
    col = np.array([vg.color4ub(255, 0, 0, 255), vg.color4ub(0, 255, 0, 255),
                    vg.color4ub(0, 0, 255, 255)], np.uint32)
    vg.indexedTriList(ctx, pos, None, 3, col, 3,
                      np.array([0, 1, 2], np.uint16), 3, None)


def _bake(background=(0.1, 0.1, 0.12, 1.0)):
    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    _scene(ctx)
    return RetainedScene.bake(ctx, background=background)


def _direct(view, background=(0.1, 0.1, 0.12, 1.0)):
    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    vg.pushState(ctx)
    vg.transformTranslate(ctx, -view[0], -view[1])
    _scene(ctx)
    vg.popState(ctx)
    return np.asarray(vg.end(ctx, background=background))


VIEWS = [(0, 0), (37, 5), (128, 8), (129, 9), (-45, -13), (300, 100),
         (-127, -7), (5, -3)]


@pytest.mark.parametrize("view", VIEWS)
def test_pan_matches_direct(view):
    scene = _bake()
    got = np.asarray(scene.render(*view))
    want = _direct(view)
    np.testing.assert_allclose(got, want, atol=2e-4)


def _scene_colored(ctx, card, star, g0, g1, stroke):
    """_scene with parameterized solid/gradient VALUES (structure fixed)."""
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 8, 8, 200, 120, 12)
    vg.fillPath(ctx, vg.color4ub(*card), vg.FillFlags.ConvexAA)
    pts = [(60 + 50 * np.cos(-np.pi / 2 + k * 4 * np.pi / 5),
            70 + 50 * np.sin(-np.pi / 2 + k * 4 * np.pi / 5)) for k in range(5)]
    vg.beginPath(ctx)
    vg.moveTo(ctx, *pts[0])
    for p in pts[1:]:
        vg.lineTo(ctx, *p)
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(*star), vg.FillFlags.ConcaveEvenOddAA)
    g = vg.createLinearGradient(ctx, 220, 20, 360, 20,
                                vg.color4ub(*g0), vg.color4ub(*g1))
    vg.beginPath(ctx)
    vg.rect(ctx, 220, 20, 140, 40)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 230, 90)
    vg.cubicTo(ctx, 260, 60, 320, 140, 360, 100)
    vg.strokePath(ctx, vg.color4ub(*stroke), 3.0, vg.StrokeFlags.RoundRoundAA)


COLORS_A = dict(card=(40, 90, 160, 255), star=(250, 200, 40, 200),
                g0=(255, 0, 80, 255), g1=(0, 220, 255, 255),
                stroke=(240, 240, 240, 255))
COLORS_B = dict(card=(160, 40, 90, 255), star=(40, 250, 160, 140),
                g0=(80, 255, 0, 255), g1=(255, 0, 220, 255),
                stroke=(20, 20, 220, 255))


def test_update_paint_values_matches_fresh_bake():
    """Pan + color animation: patching new solid/gradient values into a
    retained scene must render exactly like a fresh bake of those values."""
    bg = (0.1, 0.1, 0.12, 1.0)
    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, **COLORS_A)
    scene = RetainedScene.bake(ctx, background=bg)
    before = np.asarray(scene.render(37, 5))

    vg.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, **COLORS_B)
    scene.update_paint_values(ctx)

    ctx2 = vg.createContext()
    vg.begin(ctx2, 0, W, H, 1.0)
    _scene_colored(ctx2, **COLORS_B)
    want_scene = RetainedScene.bake(ctx2, background=bg)

    for view in [(0, 0), (37, 5), (-45, -13)]:
        got = np.asarray(scene.render(*view))
        want = np.asarray(want_scene.render(*view))
        np.testing.assert_allclose(got, want, atol=2e-6,
                                   err_msg=f"view {view}")
    assert np.abs(np.asarray(scene.render(37, 5)) - before).max() > 0.05


def test_update_paint_values_rejects_structure_and_opacity_flip():
    bg = (0.1, 0.1, 0.12, 1.0)
    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, **COLORS_A)
    scene = RetainedScene.bake(ctx, background=bg)

    vg.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, **COLORS_A)
    vg.beginPath(ctx)
    vg.circle(ctx, 300, 30, 9)
    vg.fillPath(ctx, vg.Colors.Red, vg.FillFlags.ConvexAA)
    with pytest.raises(ValueError, match="structure"):
        scene.update_paint_values(ctx)

    vg.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, **dict(COLORS_A, card=(40, 90, 160, 120)))
    with pytest.raises(ValueError, match="opacity"):
        scene.update_paint_values(ctx)


def test_update_paint_values_evenodd_alpha_flip_allowed():
    """Only NonZero solids can be occlusion covers (binner solid_opaque
    test), so an even-odd fill may cross the alpha>=1 boundary freely."""
    bg = (0.1, 0.1, 0.12, 1.0)
    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, **COLORS_A)             # star alpha 200 (even-odd)
    scene = RetainedScene.bake(ctx, background=bg)

    new = dict(COLORS_A, star=(250, 200, 40, 255))   # crosses the class
    vg.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, **new)
    scene.update_paint_values(ctx)

    ctx2 = vg.createContext()
    vg.begin(ctx2, 0, W, H, 1.0)
    _scene_colored(ctx2, **new)
    want = RetainedScene.bake(ctx2, background=bg)
    np.testing.assert_allclose(np.asarray(scene.render(11, 3)),
                               np.asarray(want.render(11, 3)), atol=2e-6)


def test_textured_scene_views_and_paint_update():
    """render_views and update_paint_values on a scene WITH sampling groups:
    the in-trace resample runs under lax.scan, and solid patches coexist
    with byte-identical texture draws."""
    bg = (0.08, 0.08, 0.1, 1.0)
    rng = np.random.default_rng(11)
    img_data = rng.integers(0, 256, (16, 16, 4), np.uint8)
    img_data[..., 3] = 255

    def scene_fn(ctx, h, rect_col):
        # NB: the image handle is created ONCE per context — re-creating it
        # per record would be a structural delta (new image id), as it is
        # in the frame path's fingerprint
        p = vg.createImagePattern(ctx, 40, 20, 64, 64, 0.0, h)
        vg.beginPath(ctx)
        vg.roundedRect(ctx, 30, 15, 200, 90, 10)
        vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
        vg.beginPath(ctx)
        vg.rect(ctx, 250, 30, 80, 60)
        vg.fillPath(ctx, vg.color4ub(*rect_col), vg.FillFlags.ConvexAA)

    ctx = vg.createContext()
    himg = vg.createImage(ctx, 16, 16, 0, img_data)
    vg.begin(ctx, 0, W, H, 1.0)
    scene_fn(ctx, himg, (200, 60, 40, 255))
    s = RetainedScene.bake(ctx, background=bg)
    assert s.samp_meta is not None
    views = [(0, 0), (41, 6), (-23, -11)]
    stack = np.asarray(s.render_views(views))
    for k, view in enumerate(views):
        np.testing.assert_allclose(stack[k], np.asarray(s.render(*view)),
                                   atol=2e-6, err_msg=f"view {view}")

    vg.begin(ctx, 0, W, H, 1.0)
    scene_fn(ctx, himg, (40, 200, 160, 255))
    s.update_paint_values(ctx)
    ctx2 = vg.createContext()
    himg2 = vg.createImage(ctx2, 16, 16, 0, img_data)
    vg.begin(ctx2, 0, W, H, 1.0)
    scene_fn(ctx2, himg2, (40, 200, 160, 255))
    want = RetainedScene.bake(ctx2, background=bg)
    for view in views:
        np.testing.assert_allclose(np.asarray(s.render(*view)),
                                   np.asarray(want.render(*view)),
                                   atol=2e-6, err_msg=f"view {view}")


def test_fractional_x_pan_matches_direct():
    """Smooth horizontal scrolling: FRACTIONAL view_x offsets render exactly
    (backdrop rows are x-shift-invariant; coverage is analytic in edge
    position).  Fractional view_y is rejected (piecewise-linear backdrops)."""
    scene = _bake()
    for view in [(37.5, 5), (12.25, 0), (-3.75, -13)]:
        got = np.asarray(scene.render(*view))
        want = _direct(view)
        np.testing.assert_allclose(got, want, atol=2e-4,
                                   err_msg=f"view {view}")
    # multi-view with fractional x
    stack = np.asarray(scene.render_views([(37.5, 5), (12.25, 0)]))
    np.testing.assert_allclose(stack[0], _direct((37.5, 5)), atol=2e-4)
    np.testing.assert_allclose(stack[1], _direct((12.25, 0)), atol=2e-4)
    with pytest.raises(ValueError, match="view_y"):
        scene.render(0, 2.5)
    with pytest.raises(ValueError, match="view_y"):
        scene.render_views([(0, 2.5)])


def test_fractional_x_pan_textured_matches_direct():
    """Fractional x through the in-trace texture resample: bilinear sampling
    at a fractional shift must equal the direct translated render (sample
    positions differ by exactly the translation)."""
    bg = (0.08, 0.08, 0.1, 1.0)
    rng = np.random.default_rng(11)
    img_data = rng.integers(0, 256, (16, 16, 4), np.uint8)
    img_data[..., 3] = 255

    def scene(ctx):
        h = vg.createImage(ctx, 16, 16, 0, img_data)
        p = vg.createImagePattern(ctx, 40, 20, 64, 64, 0.0, h)
        vg.beginPath(ctx)
        vg.roundedRect(ctx, 30, 15, 200, 90, 10)
        vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)

    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    scene(ctx)
    s = RetainedScene.bake(ctx, background=bg)
    assert s.samp_meta is not None
    for view in [(41.5, 6), (-22.75, -11)]:
        got = np.asarray(s.render(*view))
        ctx2 = vg.createContext()
        vg.begin(ctx2, 0, W, H, 1.0)
        vg.pushState(ctx2)
        vg.transformTranslate(ctx2, -view[0], -view[1])
        scene(ctx2)
        vg.popState(ctx2)
        want = np.asarray(vg.end(ctx2, background=bg))
        np.testing.assert_allclose(got, want, atol=3e-3,
                                   err_msg=f"view {view}")


def test_render_views_matches_per_view():
    """Multi-view serving (minimap/main-view, K pan clients): V viewports in
    one dispatch must each match their single-view render."""
    scene = _bake()
    stack = np.asarray(scene.render_views(VIEWS))
    assert stack.shape[0] == len(VIEWS)
    for k, view in enumerate(VIEWS):
        np.testing.assert_allclose(stack[k], np.asarray(scene.render(*view)),
                                   atol=2e-6, err_msg=f"view {view}")


def test_pan_off_scene_is_background():
    scene = _bake()
    img = np.asarray(scene.render(5000, 5000))
    bg = np.asarray([0.1, 0.1, 0.12, 1.0], np.float32)
    np.testing.assert_allclose(img, np.broadcast_to(bg, img.shape), atol=1e-6)


def test_empty_scene_renders_background():
    ctx = vg.createContext()
    vg.begin(ctx, 0, 256, 64, 1.0)
    s = RetainedScene.bake(ctx, background=(0.2, 0.3, 0.4, 1.0))
    img = np.asarray(s.render(10, -5))
    assert img.shape == (64, 256, 4)
    np.testing.assert_allclose(
        img, np.broadcast_to(np.array([0.2, 0.3, 0.4, 1.0], np.float32),
                             img.shape), atol=1e-6)


def test_pan_image_pattern_matches_direct():
    """Image-pattern fills in a retained scene: color tiles resample
    in-trace at the shifted view; integer shifts of bilinear sampling are
    exact, so pan == direct."""
    bg = (0.08, 0.08, 0.1, 1.0)
    rng = np.random.default_rng(11)
    img_data = rng.integers(0, 256, (16, 16, 4), np.uint8)
    img_data[..., 3] = 255

    def scene(ctx):
        h = vg.createImage(ctx, 16, 16, 0, img_data)
        p = vg.createImagePattern(ctx, 40, 20, 64, 64, 0.0, h)
        vg.beginPath(ctx)
        vg.roundedRect(ctx, 30, 15, 200, 90, 10)
        vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)

    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    scene(ctx)
    s = RetainedScene.bake(ctx, background=bg)
    for view in [(0, 0), (41, 6), (-23, -11), (130, 9)]:
        got = np.asarray(s.render(*view))
        ctx2 = vg.createContext()
        vg.begin(ctx2, 0, W, H, 1.0)
        vg.pushState(ctx2)
        vg.transformTranslate(ctx2, -view[0], -view[1])
        scene(ctx2)
        vg.popState(ctx2)
        want = np.asarray(vg.end(ctx2, background=bg))
        np.testing.assert_allclose(got, want, atol=3e-3,
                                   err_msg=f"view {view}")


def test_pan_text_matches_direct():
    """Text in a retained scene pans exactly (atlas quads resampled at the
    shifted origins)."""
    from vgtpu.scenes.demo_ui import _font

    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    f = _font(ctx)
    if f is None:
        pytest.skip("no UI font available")
    bg = (0.1, 0.1, 0.12, 1.0)

    def scene(c, fh):
        cfg = vg.makeTextConfig(c, fh, 20.0, vg.TextAlign.TopLeft,
                                vg.color4ub(240, 240, 200, 255))
        vg.text(c, cfg, 24, 40, "Pan me exactly!")
        vg.beginPath(c)
        vg.rect(c, 20, 70, 160, 30)
        vg.fillPath(c, vg.color4ub(40, 80, 160, 255), vg.FillFlags.ConvexAA)

    scene(ctx, f)
    s = RetainedScene.bake(ctx, background=bg)
    for view in [(0, 0), (37, 5), (-19, -6)]:
        got = np.asarray(s.render(*view))
        ctx2 = vg.createContext()
        vg.begin(ctx2, 0, W, H, 1.0)
        f2 = _font(ctx2)
        vg.pushState(ctx2)
        vg.transformTranslate(ctx2, -view[0], -view[1])
        scene(ctx2, f2)
        vg.popState(ctx2)
        want = np.asarray(vg.end(ctx2, background=bg))
        np.testing.assert_allclose(got, want, atol=3e-3,
                                   err_msg=f"view {view}")


def test_explicit_viewport_scissor_rides_scene():
    """An EXPLICIT setScissor exactly equal to the viewport is a real
    scene-space clip (the reference transforms scissors at set time) —
    only the implicit default is screen-space."""
    bg = (0.05, 0.05, 0.05, 1.0)

    def scene(ctx):
        vg.setScissor(ctx, 0, 0, W, H)
        vg.beginPath(ctx)
        vg.rect(ctx, -60, -40, W + 120, H + 80)
        vg.fillPath(ctx, vg.color4ub(200, 120, 40, 255), vg.FillFlags.ConvexAA)

    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    scene(ctx)
    s = RetainedScene.bake(ctx, background=bg)
    for view in [(-30, -20), (25, 7)]:
        got = np.asarray(s.render(*view))
        ctx2 = vg.createContext()
        vg.begin(ctx2, 0, W, H, 1.0)
        vg.pushState(ctx2)
        vg.transformTranslate(ctx2, -view[0], -view[1])
        scene(ctx2)
        vg.popState(ctx2)
        want = np.asarray(vg.end(ctx2, background=bg))
        np.testing.assert_allclose(got, want, atol=2e-4)


def test_cached_replay_default_scissor_pans():
    """Ops emitted by a CACHED command-list replay must also carry the
    None default scissor (reviewer repro: the replay stamped the viewport
    rect, clipping panned-in content after bake)."""
    bg = (0.05, 0.05, 0.05, 1.0)
    ctx = vg.createContext()
    vg.begin(ctx, 0, 128, 96, 1.0)
    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    vg.beginCommandList(ctx, cl)
    vg.beginPath(ctx)
    vg.rect(ctx, -60, -40, 128 + 120, 96 + 80)
    vg.fillPath(ctx, vg.color4ub(220, 130, 40, 255), vg.FillFlags.ConvexAA)
    vg.endCommandList(ctx)
    vg.submitCommandList(ctx, cl)      # builds the cache
    vg.end(ctx, background=bg)
    vg.begin(ctx, 0, 128, 96, 1.0)
    vg.submitCommandList(ctx, cl)      # cached replay
    assert all(op.scissor is None for op in ctx.ops)
    scene = RetainedScene.bake(ctx, background=bg)
    img = np.asarray(scene.render(-30, -20))
    # panned-in region (was off-viewport) must show the fill, not background
    assert img[5, 5, 0] > 0.5


def test_pan_dpr2_matches_direct():
    """Retained panning under devicePixelRatio=2: view offsets are in
    FRAMEBUFFER pixels (the baked plan's space); the direct equivalent is a
    logical translate of view/dpr."""
    bg = (0.1, 0.1, 0.1, 1.0)

    def scene(ctx):
        vg.beginPath(ctx)
        vg.circle(ctx, 60, 40, 25)
        vg.fillPath(ctx, vg.color4ub(200, 80, 40, 255), vg.FillFlags.ConvexAA)
        vg.beginPath(ctx)
        vg.moveTo(ctx, 20, 70)
        vg.lineTo(ctx, 180, 30)
        vg.strokePath(ctx, vg.Colors.White, 3.0, vg.StrokeFlags.RoundRoundAA)

    ctx = vg.createContext()
    vg.begin(ctx, 0, 200, 100, 2.0)
    scene(ctx)
    s = RetainedScene.bake(ctx, background=bg)
    for view in [(17, 9), (-40, 12)]:
        got = np.asarray(s.render(*view))
        ctx2 = vg.createContext()
        vg.begin(ctx2, 0, 200, 100, 2.0)
        vg.pushState(ctx2)
        vg.transformTranslate(ctx2, -view[0] / 2.0, -view[1] / 2.0)
        scene(ctx2)
        vg.popState(ctx2)
        want = np.asarray(vg.end(ctx2, background=bg))
        np.testing.assert_allclose(got, want, atol=3e-4)


# ---------------------------------------------------------------------------
# supersampled retained scenes (conflation-free coverage + device panning)
# ---------------------------------------------------------------------------

def _bake_ss(ss, background=(0.1, 0.1, 0.12, 1.0)):
    ctx = vg.createContext(vg.ContextConfig(coverage_supersample=ss))
    vg.begin(ctx, 0, W, H, 1.0)
    _scene(ctx)
    return RetainedScene.bake(ctx, background=background)


def _direct_ss(ss, view, background=(0.1, 0.1, 0.12, 1.0)):
    ctx = vg.createContext(vg.ContextConfig(coverage_supersample=ss))
    vg.begin(ctx, 0, W, H, 1.0)
    vg.pushState(ctx)
    vg.transformTranslate(ctx, -view[0], -view[1])
    _scene(ctx)
    vg.popState(ctx)
    return np.asarray(vg.end(ctx, background=background))


@pytest.mark.parametrize("ss", [2, 4])
@pytest.mark.parametrize("view", [(0, 0), (37, 5), (-45, -13), (128.5, 8)])
def test_ss_pan_matches_direct(ss, view):
    """A supersampled bake panned on device == the supersampled direct
    render of the translated scene (sub-row binning + per-sub-row rule +
    average must all commute with the residual shift)."""
    scene = _bake_ss(ss)
    assert scene.ss == ss
    got = np.asarray(scene.render(*view))
    want = _direct_ss(ss, view)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_ss_subpixel_y_pan():
    """ss=4 scenes scroll at exact quarter-pixel y granularity (whole
    sub-rows) — beyond the reference, which re-tessellates for any subpixel
    motion; other fractions are rejected loudly."""
    scene = _bake_ss(4)
    got = np.asarray(scene.render(5, -3.25))
    want = _direct_ss(4, (5, -3.25))
    np.testing.assert_allclose(got, want, atol=2e-4)
    with pytest.raises(ValueError, match="sub-rows"):
        scene.render(0, 0.1)
    with pytest.raises(ValueError, match="sub-rows"):
        scene.render_views([(0, 0), (0, 0.1)])


def test_ss_textured_views_match_render():
    """Supersampled retained scenes with sampling groups: the in-trace
    resample shifts by ry/ss OUTPUT pixels; render_views == render."""
    bg = (0.08, 0.08, 0.1, 1.0)
    rng = np.random.default_rng(7)
    img_data = rng.integers(0, 256, (16, 16, 4), np.uint8)
    img_data[..., 3] = 255
    ctx = vg.createContext(vg.ContextConfig(coverage_supersample=2))
    himg = vg.createImage(ctx, 16, 16, 0, img_data)
    vg.begin(ctx, 0, W, H, 1.0)
    p = vg.createImagePattern(ctx, 40, 20, 64, 64, 0.0, himg)
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 30, 15, 200, 90, 10)
    vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.rect(ctx, 250, 30, 80, 60)
    vg.fillPath(ctx, vg.color4ub(200, 60, 40, 255), vg.FillFlags.ConvexAA)
    s = RetainedScene.bake(ctx, background=bg)
    assert s.samp_meta is not None and s.ss == 2
    views = [(0, 0), (41, 6), (-23, -11.5)]
    stack = np.asarray(s.render_views(views))
    for k, view in enumerate(views):
        np.testing.assert_allclose(stack[k], np.asarray(s.render(*view)),
                                   atol=2e-6, err_msg=f"view {view}")
    # against a direct supersampled render of the translated scene
    ctx2 = vg.createContext(vg.ContextConfig(coverage_supersample=2))
    himg2 = vg.createImage(ctx2, 16, 16, 0, img_data)
    vg.begin(ctx2, 0, W, H, 1.0)
    vg.pushState(ctx2)
    vg.transformTranslate(ctx2, -41, -6)
    p2 = vg.createImagePattern(ctx2, 40, 20, 64, 64, 0.0, himg2)
    vg.beginPath(ctx2)
    vg.roundedRect(ctx2, 30, 15, 200, 90, 10)
    vg.fillPath(ctx2, p2, vg.Colors.White, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx2)
    vg.rect(ctx2, 250, 30, 80, 60)
    vg.fillPath(ctx2, vg.color4ub(200, 60, 40, 255), vg.FillFlags.ConvexAA)
    vg.popState(ctx2)
    want = np.asarray(vg.end(ctx2, background=bg))
    np.testing.assert_allclose(np.asarray(s.render(41, 6)), want, atol=2e-4)


def test_ss_text_matches_direct():
    """Text (P_TEXTURE tex_quads) in a SUPERSAMPLED retained scene: bake
    must hand the sampler the UNSCALED op list (quad bboxes/params live in
    output-pixel space, ops/sampling_device.py) even though coverage
    geometry is y-scaled into sub-rows.  Regression test for the ss>1 bake
    path that previously fed scale_ops_y output to build_sampling_plan."""
    from vgtpu.scenes.demo_ui import _font

    bg = (0.1, 0.1, 0.12, 1.0)

    def scene(c, fh):
        cfg = vg.makeTextConfig(c, fh, 20.0, vg.TextAlign.TopLeft,
                                vg.color4ub(240, 240, 200, 255))
        vg.text(c, cfg, 24, 40, "Supersampled pan")
        vg.beginPath(c)
        vg.rect(c, 20, 70, 160, 30)
        vg.fillPath(c, vg.color4ub(40, 80, 160, 255), vg.FillFlags.ConvexAA)

    ctx = vg.createContext(vg.ContextConfig(coverage_supersample=2))
    vg.begin(ctx, 0, W, H, 1.0)
    f = _font(ctx)
    if f is None:
        pytest.skip("no UI font available")
    scene(ctx, f)
    s = RetainedScene.bake(ctx, background=bg)
    assert s.samp_meta is not None and s.ss == 2
    for view in [(0, 0), (37, 5), (-19, -6.5)]:
        got = np.asarray(s.render(*view))
        ctx2 = vg.createContext(vg.ContextConfig(coverage_supersample=2))
        vg.begin(ctx2, 0, W, H, 1.0)
        f2 = _font(ctx2)
        vg.pushState(ctx2)
        vg.transformTranslate(ctx2, -view[0], -view[1])
        scene(ctx2, f2)
        vg.popState(ctx2)
        want = np.asarray(vg.end(ctx2, background=bg))
        np.testing.assert_allclose(got, want, atol=3e-3,
                                   err_msg=f"view {view}")


@pytest.mark.parametrize("view", [(37.5, 5), (128.25, -3.5), (-45, -13.5),
                                  (37, 5.5)])
def test_ss2_pan_scissor_fractional_views_match_direct(view):
    """ss=2 pans at fractional x and half-pixel y: the scissor and the
    clip move with the content by the exact residual, sub-row for sub-row,
    as the direct render of the translated scene places them."""
    scene = _bake_ss(2)
    got = np.asarray(scene.render(*view))
    np.testing.assert_allclose(got, _direct_ss(2, view), atol=2e-4,
                               err_msg=f"view {view}")


def test_ss2_render_views_match_render():
    scene = _bake_ss(2)
    views = [(37, 5), (-45, -13.5), (300, 100)]
    stack = np.asarray(scene.render_views(views))
    for k, view in enumerate(views):
        np.testing.assert_allclose(stack[k], np.asarray(scene.render(*view)),
                                   atol=2e-6, err_msg=f"view {view}")
