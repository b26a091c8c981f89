"""Batched variant rendering (raster/batch.py): K value-variants of one
structural plan render in ONE device dispatch.  Each variant frame must be
pixel-identical to the ordinary per-frame path (the reference renders frames
strictly one at a time, vg.cpp:1076-1288; batching is a capability of this engine
with no reference semantics beyond per-frame equality)."""

from __future__ import annotations

import numpy as np
import pytest

import vgtpu as vg
from tests.fontdata import FONT_DATA
from tests.test_paint_memo import BG, H, W, draw_scene
from vgtpu.raster.batch import VariantBatch, measure_batch_ms_per_frame

VARIANTS = [
    dict(rect_col=(90, 140, 220, 160), circ_col=(250, 210, 60, 255)),
    dict(rect_col=(220, 90, 140, 160), circ_col=(60, 250, 210, 255),
         grad=((40, 250, 60, 255), (250, 40, 60, 255)),
         text_col=(255, 220, 40, 255)),
    dict(rect_col=(140, 220, 90, 160), circ_col=(210, 60, 250, 255),
         grad_geo=(40.0, 10.0, 160.0, 110.0),
         stroke_col=(220, 20, 120, 255)),
]


def _fresh_font(ctx):
    return (vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
            if FONT_DATA is not None else None)


def _draw_variant(c, font, p):
    draw_scene(c, font, **p)
    # corner probes: content in flat tile 0 AND the last tile, so batch-axis
    # scatter bookkeeping (pad-row scratch ids, k*T offsets) is constrained
    # by the per-frame oracle — a pad row mis-scattered into a neighboring
    # variant's tile 0 clobbers the first probe (regression: round-5 review)
    col = p["circ_col"]
    vg.beginPath(c)
    vg.rect(c, 1, 1, 40, 5)
    vg.fillPath(c, vg.color4ub(col[0], col[1], col[2], 200),
                vg.FillFlags.ConvexAA)
    vg.beginPath(c)
    vg.rect(c, W - 30, H - 6, 26, 5)
    vg.fillPath(c, vg.color4ub(col[2], col[0], col[1], 200),
                vg.FillFlags.ConvexAA)


def _oracles(dpr=1.0):
    out = []
    for p in VARIANTS:
        ctx = vg.createContext()
        vg.begin(ctx, 0, W, H, dpr)
        _draw_variant(ctx, _fresh_font(ctx), p)
        vg.end(ctx, background=BG)
        out.append(np.asarray(ctx.frame_image))
    return out


def _bake(ctx=None, dpr=1.0):
    if ctx is None:
        ctx = vg.createContext()
    font = _fresh_font(ctx)
    fns = [lambda c, p=p: _draw_variant(c, font, p) for p in VARIANTS]
    return VariantBatch.bake(ctx, fns, W, H, dpr=dpr, background=BG)


def test_folded_batch_matches_per_frame():
    """Portable (XLA) batch path: every variant bit-matches its own frame."""
    vb = _bake()
    imgs = np.asarray(vb.render(background=BG))
    assert imgs.shape == (len(VARIANTS), H, W, 4)
    for k, ref in enumerate(_oracles()):
        np.testing.assert_allclose(imgs[k], ref, atol=3e-6,
                                   err_msg=f"variant {k}")


def test_folded_batch_update_values_matches_per_frame():
    """Bake, compare against the per-frame oracles, then update_values and
    re-check (the value-table rebuild against the baked structure)."""
    ctx = vg.createContext()
    font = _fresh_font(ctx)
    vb = VariantBatch.bake(
        ctx, [lambda c, p=p: _draw_variant(c, font, p) for p in VARIANTS],
        W, H, background=BG)
    imgs = np.asarray(vb.render(background=BG))
    for k, ref in enumerate(_oracles()):
        np.testing.assert_allclose(imgs[k], ref, atol=3e-6,
                                   err_msg=f"variant {k}")
    vb.update_values(
        [lambda c, p=p: _draw_variant(c, font, p) for p in VARIANTS2])
    imgs = np.asarray(vb.render(background=BG))
    for k, p in enumerate(VARIANTS2):
        c2 = vg.createContext()
        vg.begin(c2, 0, W, H, 1.0)
        _draw_variant(c2, _fresh_font(c2), p)
        vg.end(c2, background=BG)
        np.testing.assert_allclose(imgs[k], np.asarray(c2.frame_image),
                                   atol=3e-6, err_msg=f"variant {k}")


def test_folded_batch_full_cover_bucket_matches_per_frame():
    """A 128-tile bucket (1024x128 canvas = 8x16 tiles of 128x8, fully
    covered by one rect) folded over K variants: each variant's tiles
    scatter to their own block of the batch framebuffer."""
    w, h = 1024, 128
    # alphas equal across variants: an opacity-class flip (occlusion culling's
    # solid alpha>=1 cover test) is structural and correctly rejected
    cols = [(200, 60, 40, 220), (40, 200, 60, 220), (60, 40, 200, 220)]

    def variant(k):
        def f(c):
            vg.beginPath(c)
            vg.rect(c, -4, -4, w + 8, h + 8)   # covers every tile: 1 bucket
            vg.fillPath(c, vg.color4ub(*cols[k]), vg.FillFlags.ConvexAA)
            vg.beginPath(c)
            vg.circle(c, 100 + 10 * 0, 60, 40)
            vg.fillPath(c, vg.color4ub(*cols[(k + 1) % 3]),
                        vg.FillFlags.ConvexAA)
        return f

    K = 3
    vb = VariantBatch.bake(vg.createContext(), [variant(k) for k in range(K)],
                           w, h, background=BG)
    imgs = np.asarray(vb.render(background=BG))
    for k in range(K):
        ctx = vg.createContext()
        vg.begin(ctx, 0, w, h, 1.0)
        variant(k)(ctx)
        vg.end(ctx, background=BG)
        np.testing.assert_allclose(imgs[k], np.asarray(ctx.frame_image),
                                   atol=3e-6, err_msg=f"variant {k}")


def test_structural_variant_raises():
    """A variant that changes geometry (not just paint values) is rejected."""
    ctx = vg.createContext()
    font = _fresh_font(ctx)

    def base(c):
        draw_scene(c, font, **VARIANTS[0])

    def extra(c):
        draw_scene(c, font, **VARIANTS[0])
        vg.beginPath(c)
        vg.circle(c, 60, 60, 10)
        vg.fillPath(c, vg.Colors.Red, vg.FillFlags.ConvexAA)

    with pytest.raises(ValueError, match="structure"):
        VariantBatch.bake(ctx, [base, extra], W, H, background=BG)


def test_opacity_class_flip_raises():
    """Flipping a solid's opacity class changes occlusion culling = frame
    structure; the bake must refuse rather than silently mis-render."""
    ctx = vg.createContext()
    font = _fresh_font(ctx)
    a = dict(VARIANTS[0])
    b = dict(VARIANTS[0], circ_col=(250, 210, 60, 120))  # opaque -> translucent

    with pytest.raises(ValueError, match="structure"):
        VariantBatch.bake(ctx,
                          [lambda c: draw_scene(c, font, **a),
                           lambda c: draw_scene(c, font, **b)],
                          W, H, background=BG)


def test_sharded_batch_matches_per_frame():
    """Variant-axis sharding over the virtual 8-device mesh: every variant
    frame matches its per-frame oracle (K pads to the mesh size internally;
    the program contains no collectives — pure serving data-parallelism)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device platform")
    mesh = jax.make_mesh((len(jax.devices()),), ("variants",))
    vb = _bake()
    imgs = np.asarray(vb.render_sharded(mesh, background=BG))
    assert imgs.shape == (len(VARIANTS), H, W, 4)
    for k, ref in enumerate(_oracles()):
        np.testing.assert_allclose(imgs[k], ref, atol=3e-6,
                                   err_msg=f"variant {k}")


def test_batch_dpr2_matches_per_frame():
    """dpr=2 bake: the framebuffer-space fold must match per-frame renders
    (the dpr viewport scale rides _render_transform into the recorded ops)."""
    vb = _bake(dpr=2.0)
    imgs = np.asarray(vb.render(background=BG))
    assert imgs.shape == (len(VARIANTS), 2 * H, 2 * W, 4)
    for k, ref in enumerate(_oracles(dpr=2.0)):
        np.testing.assert_allclose(imgs[k], ref, atol=3e-6,
                                   err_msg=f"variant {k}")


def test_chained_measure_runs():
    """The chained throughput loop compiles and yields a finite number."""
    vb = _bake()
    ms = measure_batch_ms_per_frame(vb, background=BG, reps_hi=3, reps_lo=1)
    assert np.isfinite(ms)


VARIANTS2 = [
    dict(rect_col=(30, 30, 200, 160), circ_col=(10, 250, 110, 255)),
    dict(rect_col=(180, 180, 40, 160), circ_col=(250, 10, 110, 255),
         grad=((250, 250, 60, 255), (60, 250, 250, 255))),
    dict(rect_col=(90, 90, 90, 160), circ_col=(250, 250, 250, 255),
         stroke_col=(40, 40, 220, 255)),
]


def test_update_values_refreshes_in_place():
    """The per-tick serving loop: update_values swaps the K variants' paint
    values without rebuilding static tables; render matches fresh oracles,
    and the sharded path re-uploads the new values."""
    import jax

    ctx = vg.createContext()
    font = _fresh_font(ctx)
    vb = VariantBatch.bake(
        ctx, [lambda c, p=p: _draw_variant(c, font, p) for p in VARIANTS],
        W, H, background=BG)
    if len(jax.devices()) >= 2:
        mesh = jax.make_mesh((len(jax.devices()),), ("variants",))
        np.asarray(vb.render_sharded(mesh, background=BG))  # prime cache
    else:
        mesh = None

    vb.update_values(
        [lambda c, p=p: _draw_variant(c, font, p) for p in VARIANTS2])
    refs = []
    for p in VARIANTS2:
        c2 = vg.createContext()
        vg.begin(c2, 0, W, H, 1.0)
        _draw_variant(c2, _fresh_font(c2), p)
        vg.end(c2, background=BG)
        refs.append(np.asarray(c2.frame_image))
    imgs = np.asarray(vb.render(background=BG))
    for k, ref in enumerate(refs):
        np.testing.assert_allclose(imgs[k], ref, atol=3e-6,
                                   err_msg=f"variant {k}")
    if mesh is not None:
        sh = np.asarray(vb.render_sharded(mesh, background=BG))
        for k, ref in enumerate(refs):
            np.testing.assert_allclose(sh[k], ref, atol=3e-6,
                                       err_msg=f"sharded variant {k}")


def test_update_values_rejects_structural_delta():
    ctx = vg.createContext()
    font = _fresh_font(ctx)
    vb = VariantBatch.bake(
        ctx, [lambda c, p=p: _draw_variant(c, font, p) for p in VARIANTS],
        W, H, background=BG)

    def structural(c):
        _draw_variant(c, font, VARIANTS[0])
        vg.beginPath(c)
        vg.circle(c, 77, 77, 9)
        vg.fillPath(c, vg.Colors.Red, vg.FillFlags.ConvexAA)

    good = [lambda c, p=p: _draw_variant(c, font, p) for p in VARIANTS]
    with pytest.raises(ValueError, match="structure"):
        vb.update_values([good[0], structural, good[2]])


def test_batch_supersample_matches_per_frame():
    """Conflation-free plans (coverage_supersample=2) through the batch fold:
    sub-row coverage, ss-averaged output, per-variant shading."""
    cfg = vg.ContextConfig(coverage_supersample=2)

    def fresh():
        return vg.createContext(cfg)

    refs = []
    for p in VARIANTS:
        ctx = fresh()
        vg.begin(ctx, 0, W, H, 1.0)
        _draw_variant(ctx, _fresh_font(ctx), p)
        vg.end(ctx, background=BG)
        refs.append(np.asarray(ctx.frame_image))

    ctx = fresh()
    font = _fresh_font(ctx)
    vb = VariantBatch.bake(
        ctx, [lambda c, p=p: _draw_variant(c, font, p) for p in VARIANTS],
        W, H, background=BG)
    imgs = np.asarray(vb.render(background=BG))
    for k, ref in enumerate(refs):
        np.testing.assert_allclose(imgs[k], ref, atol=3e-6,
                                   err_msg=f"variant {k}")


def test_batch_clip_scissor_pattern_matches_per_frame():
    """Clip mask + scissor + an image-pattern fill whose tint varies per
    variant: the texture rows ride the TEXTURES resample in the value patch
    and the per-variant color tiles must stack correctly in the fold."""
    rng = np.random.default_rng(5)
    img_data = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    img_data[..., 3] = 255
    tints = [(255, 255, 255, 255), (255, 160, 80, 255), (90, 200, 255, 200)]

    def draw(c, img, tint):
        vg.beginClip(c, vg.ClipRule.In)
        vg.beginPath(c)
        vg.circle(c, 120, 80, 70)
        vg.fillPath(c, vg.Colors.Black, vg.FillFlags.Convex)
        vg.endClip(c)
        p = vg.createImagePattern(c, 40, 20, 160, 120, 0.0, img)
        vg.beginPath(c)
        vg.rect(c, 40, 20, 160, 120)
        vg.fillPath(c, p, vg.color4ub(*tint), vg.FillFlags.ConvexAA)
        vg.resetClip(c)
        vg.setScissor(c, 180, 40, 120, 100)
        vg.beginPath(c)
        vg.rect(c, 160, 30, 150, 120)
        vg.fillPath(c, vg.color4ub(tint[0], tint[2], tint[1], 220),
                    vg.FillFlags.ConvexAA)
        vg.resetScissor(c)

    refs = []
    for tint in tints:
        ctx = vg.createContext()
        img = vg.createImage(ctx, 16, 16, 0, img_data)
        vg.begin(ctx, 0, W, H, 1.0)
        draw(ctx, img, tint)
        vg.end(ctx, background=BG)
        refs.append(np.asarray(ctx.frame_image))

    ctx = vg.createContext()
    img = vg.createImage(ctx, 16, 16, 0, img_data)
    vb = VariantBatch.bake(
        ctx, [lambda c, t=t: draw(c, img, t) for t in tints],
        W, H, background=BG)
    imgs = np.asarray(vb.render(background=BG))
    for k, ref in enumerate(refs):
        np.testing.assert_allclose(imgs[k], ref, atol=3e-6,
                                   err_msg=f"variant {k}")


# ---------------------------------------------------------------------------
# multi-canvas: K DIFFERENT scenes, one dispatch (renderFrames)
# ---------------------------------------------------------------------------

def test_render_frames_multi_canvas():
    """Heterogeneous contexts (different sizes + scenes) fused into one
    device program must each match their individually-dispatched render."""
    def scene_a(c):
        vg.beginPath(c)
        vg.roundedRect(c, 10, 10, 150, 90, 18)
        vg.fillPath(c, vg.color4ub(200, 80, 40, 255), vg.FillFlags.ConvexAA)

    def scene_b(c):
        vg.beginPath(c)
        vg.circle(c, 100, 60, 45)
        vg.fillPath(c, vg.color4ub(40, 80, 200, 180), vg.FillFlags.ConvexAA)
        vg.strokePath(c, vg.Colors.White, 3.0, vg.StrokeFlags.RoundRoundAA)

    sizes = [(256, 128), (320, 160)]
    scenes = [scene_a, scene_b]
    refs = []
    for (w, h), fn in zip(sizes, scenes):
        ctx = vg.createContext()
        vg.begin(ctx, 0, w, h, 1.0)
        fn(ctx)
        vg.end(ctx, background=BG)
        refs.append(np.asarray(ctx.frame_image))

    ctxs = []
    for (w, h), fn in zip(sizes, scenes):
        ctx = vg.createContext()
        vg.begin(ctx, 0, w, h, 1.0)
        fn(ctx)
        out = vg.end(ctx, background=BG, dispatch=False)
        assert out is None and ctx.frame_image is None
        ctxs.append(ctx)
    imgs = vg.renderFrames(ctxs)
    for ctx, img, ref, (w, h) in zip(ctxs, imgs, refs, sizes):
        assert np.asarray(img).shape == (h, w, 4)
        assert ctx.frame_image is img
        np.testing.assert_allclose(np.asarray(img), ref, atol=3e-6)


def test_render_frames_requires_resident_plan():
    ctx = vg.createContext()
    with pytest.raises(ValueError, match="resident"):
        vg.renderFrames([ctx])


def test_render_frames_rejects_stale_plan():
    """begin() without end() leaves the resident plan stale — serving the
    previous frame silently would be a correctness trap."""
    ctx = vg.createContext()
    vg.begin(ctx, 0, 128, 64, 1.0)
    vg.beginPath(ctx)
    vg.rect(ctx, 5, 5, 40, 30)
    vg.fillPath(ctx, vg.Colors.Red, vg.FillFlags.Convex)
    vg.end(ctx, background=BG, dispatch=False)
    vg.renderFrames([ctx])          # fine: prepared
    vg.begin(ctx, 0, 128, 64, 1.0)  # new recording, no end(): STALE
    with pytest.raises(ValueError, match="STALE"):
        vg.renderFrames([ctx])


def test_render_frames_backgrounds_length_checked():
    ctx = vg.createContext()
    vg.begin(ctx, 0, 128, 64, 1.0)
    vg.beginPath(ctx)
    vg.rect(ctx, 5, 5, 40, 30)
    vg.fillPath(ctx, vg.Colors.Red, vg.FillFlags.Convex)
    vg.end(ctx, background=BG, dispatch=False)
    with pytest.raises(ValueError, match="backgrounds"):
        vg.renderFrames([ctx], backgrounds=[BG, BG])


# ---------------------------------------------------------------------------
# fuzz: random structure, per-variant colors
# ---------------------------------------------------------------------------

def _fuzz_scene(rng):
    """Random structure: a list of shape records whose COLORS are resolved
    per variant (alpha class is structural, chosen here, so every variant
    stays value-patch eligible).  Exercises varied bucket/pool/pad layouts
    under the batch fold — the pad-row scatter bug class is layout-dependent."""
    shapes = []
    for _ in range(int(rng.integers(8, 16))):
        kind = rng.choice(["rect", "circle", "rrect", "stroke", "gradrect",
                           "star"])
        x, y = rng.uniform(-10, W - 5), rng.uniform(-10, H - 5)
        w, h = rng.uniform(4, 120), rng.uniform(4, 70)
        opaque = bool(rng.uniform() < 0.5)
        shapes.append(dict(kind=str(kind), x=x, y=y, w=w, h=h, opaque=opaque,
                           r=rng.uniform(2, 30), sw=rng.uniform(0.4, 9),
                           aa=bool(rng.uniform() < 0.8)))
    return shapes


def _draw_fuzz(ctx, shapes, crng):
    """Render the structure with colors drawn from crng (per-variant)."""
    def col(opaque):
        a = 255 if opaque else int(crng.integers(40, 230))
        return vg.color4ub(*(int(v) for v in crng.integers(0, 256, 3)), a)

    for s in shapes:
        fill = (vg.FillFlags.ConvexAA if s["aa"] else vg.FillFlags.Convex)
        vg.beginPath(ctx)
        if s["kind"] == "rect":
            vg.rect(ctx, s["x"], s["y"], s["w"], s["h"])
        elif s["kind"] == "circle":
            vg.circle(ctx, s["x"], s["y"], s["r"])
        elif s["kind"] == "rrect":
            vg.roundedRect(ctx, s["x"], s["y"], s["w"], s["h"],
                           min(s["r"], s["w"] / 2, s["h"] / 2))
        elif s["kind"] == "star":
            ang = -np.pi / 2 + np.arange(5) * (4 * np.pi / 5)
            vg.moveTo(ctx, s["x"] + s["r"] * np.cos(ang[0]),
                      s["y"] + s["r"] * np.sin(ang[0]))
            for a in ang[1:]:
                vg.lineTo(ctx, s["x"] + s["r"] * np.cos(a),
                          s["y"] + s["r"] * np.sin(a))
            vg.closePath(ctx)
            fill = (vg.FillFlags.ConcaveEvenOddAA if s["aa"]
                    else vg.FillFlags.ConcaveEvenOdd)
        elif s["kind"] == "gradrect":
            g = vg.createLinearGradient(ctx, s["x"], s["y"],
                                        s["x"] + s["w"], s["y"] + s["h"],
                                        col(False), col(False))
            vg.rect(ctx, s["x"], s["y"], s["w"], s["h"])
            vg.fillPath(ctx, g, fill)
            continue
        if s["kind"] == "stroke":
            vg.moveTo(ctx, s["x"], s["y"])
            vg.cubicTo(ctx, s["x"] + s["w"] / 3, s["y"] + s["h"],
                       s["x"] + 2 * s["w"] / 3, s["y"] - s["h"] / 2,
                       s["x"] + s["w"], s["y"] + s["h"] / 3)
            vg.strokePath(ctx, col(s["opaque"]), s["sw"],
                          vg.StrokeFlags.RoundRoundAA if s["aa"]
                          else vg.StrokeFlags.ButtMiter)
        else:
            vg.fillPath(ctx, col(s["opaque"]), fill)


@pytest.mark.parametrize("seed", [3, 17, 41])
def test_fuzz_batch_matches_per_frame(seed):
    K = 3
    shapes = _fuzz_scene(np.random.default_rng(seed))

    def variant_fn(k):
        return lambda c: _draw_fuzz(c, shapes,
                                    np.random.default_rng(1000 * seed + k))

    refs = []
    for k in range(K):
        ctx = vg.createContext()
        vg.begin(ctx, 0, W, H, 1.0)
        variant_fn(k)(ctx)
        vg.end(ctx, background=BG)
        refs.append(np.asarray(ctx.frame_image))

    vb = VariantBatch.bake(vg.createContext(),
                           [variant_fn(k) for k in range(K)], W, H,
                           background=BG)
    imgs = np.asarray(vb.render(background=BG))
    for k in range(K):
        np.testing.assert_allclose(imgs[k], refs[k], atol=3e-6,
                                   err_msg=f"seed {seed} variant {k}")


def test_render_frames_after_paint_patch_repromotes():
    """A paint-patched resident plan dispatched through renderFrames must
    render the PATCHED colors."""
    def scene(c, col):
        vg.beginPath(c)
        vg.roundedRect(c, 10, 10, 150, 90, 18)
        vg.fillPath(c, vg.color4ub(*col), vg.FillFlags.ConvexAA)
        vg.beginPath(c)
        vg.circle(c, 210, 64, 40)
        vg.fillPath(c, vg.color4ub(40, 80, 200, 180),
                    vg.FillFlags.ConvexAA)

    ctx = vg.createContext()
    vg.begin(ctx, 0, 256, 128, 1.0)
    scene(ctx, (200, 80, 40, 200))
    vg.end(ctx, background=BG, dispatch=False)
    vg.begin(ctx, 0, 256, 128, 1.0)
    scene(ctx, (40, 200, 90, 200))      # values-only delta: patch path
    vg.end(ctx, background=BG, dispatch=False)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 1

    (img,) = vg.renderFrames([ctx])

    ref = vg.createContext()
    vg.begin(ref, 0, 256, 128, 1.0)
    scene(ref, (40, 200, 90, 200))
    vg.end(ref, background=BG)
    np.testing.assert_allclose(np.asarray(img),
                               np.asarray(ref.frame_image), atol=2e-5)
