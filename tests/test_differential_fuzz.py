"""Differential fuzz: ONE random program, EVERY execution path, same pixels.

The engine has several ways to execute the same sequence of vg.* calls:

  1. direct immediate-mode calls with deferred geometry (the default —
     draws record recipes, one native vg_frame_geom call at end()),
  2. direct calls with immediate per-draw geometry (ctx._immediate_geom,
     the path clip recording and cache builds use),
  3. recorded into a command list and submitted (the vg.cpp:4332
     interpreter analogue),
  4. a Cacheable list submitted twice — the second submit replays the
     tessellation cache (vg.cpp:5843-6211 semantics),
  5. a list serialized to disk and loaded into a FRESH context
     (saveCommandList/loadCommandList, the checkpoint/resume analogue),
  6. prepared with end(dispatch=False) and rendered through the fused
     multi-canvas dispatch (renderFrames).

All six must produce the same frame.  Each historical divergence here was a
real bug (first-draw transform capture, cached thin-stroke alpha, clip-state
replay kind, dpr rebase), so this fuzzer pins the whole equivalence class at
once, across paints (solid/gradient/pattern), both fill rules, strokes with
every cap/join, clip groups, scissors, state push/pop, text and tri-lists.
"""

from __future__ import annotations

import numpy as np
import pytest

import vgtpu as vg

W, H = 288, 144

from tests.fontdata import FONT_DATA  # shared discovery


def _checker_image(rng):
    img = np.zeros((16, 16, 4), np.uint8)
    img[:8, :8] = img[8:, 8:] = rng.integers(60, 256, 4, dtype=np.uint8)
    img[:8, 8:] = img[8:, :8] = rng.integers(60, 256, 4, dtype=np.uint8)
    img[..., 3] = 255
    return img


def build_program(rng):
    """A random scene as a list of (fn_name, args) records.  Handles created
    during emission (gradients/patterns) are referenced positionally via
    'G<n>' placeholders resolved at apply time, so the same program drives a
    direct context and a command-list recording identically."""
    steps = []
    n_grad = 0
    depth = 0
    clip_open = False

    def color(a=None):
        if a is None:
            a = 255 if rng.uniform() < 0.5 else int(rng.integers(40, 256))
        return vg.color4ub(*(int(v) for v in rng.integers(0, 256, 3)), int(a))

    def random_paint():
        nonlocal n_grad
        r = rng.uniform()
        if r < 0.55:
            return color()
        n_grad += 1
        kind = rng.uniform()
        x0, y0 = rng.uniform(0, W), rng.uniform(0, H)
        if kind < 0.4:
            steps.append(("createLinearGradient",
                          (x0, y0, x0 + rng.uniform(20, 150),
                           y0 + rng.uniform(-40, 40), color(255), color())))
        elif kind < 0.7:
            steps.append(("createRadialGradient",
                          (x0, y0, rng.uniform(2, 15), rng.uniform(25, 90),
                           color(255), color())))
        elif kind < 0.9 or FONT_DATA is None:
            steps.append(("createBoxGradient",
                          (x0, y0, rng.uniform(20, 90), rng.uniform(15, 60),
                           rng.uniform(1, 12), rng.uniform(2, 30),
                           color(255), color())))
        else:
            steps.append(("createImagePattern",
                          (x0, y0, rng.uniform(24, 80), rng.uniform(24, 80),
                           rng.uniform(-0.6, 0.6), "IMG0")))
        return f"G{n_grad - 1}"

    def random_shape():
        steps.append(("beginPath", ()))
        kind = rng.uniform()
        if kind < 0.15:
            steps.append(("rect", (rng.uniform(-20, W - 30), rng.uniform(-20, H - 30),
                                   rng.uniform(10, 120), rng.uniform(10, 80))))
        elif kind < 0.3:
            steps.append(("roundedRectVarying",
                          (rng.uniform(0, W - 80), rng.uniform(0, H - 50),
                           rng.uniform(30, 80), rng.uniform(20, 50),
                           *(rng.uniform(0, 14) for _ in range(4)))))
        elif kind < 0.45:
            steps.append(("circle", (rng.uniform(0, W), rng.uniform(0, H),
                                     rng.uniform(4, 50))))
        elif kind < 0.55:
            steps.append(("ellipse", (rng.uniform(0, W), rng.uniform(0, H),
                                      rng.uniform(8, 60), rng.uniform(6, 35))))
        elif kind < 0.7:
            pts = rng.uniform((-20, -20), (W + 20, H + 20),
                              (int(rng.integers(4, 10)), 2))
            steps.append(("polyline", (pts,)))
            steps.append(("closePath", ()))
        elif kind < 0.85:
            steps.append(("moveTo", (rng.uniform(0, W), rng.uniform(0, H))))
            for _ in range(int(rng.integers(2, 5))):
                v = rng.uniform()
                if v < 0.4:
                    steps.append(("cubicTo", tuple(rng.uniform((0, 0) * 3, (W, H) * 3))))
                elif v < 0.7:
                    steps.append(("quadraticTo", tuple(rng.uniform((0, 0) * 2, (W, H) * 2))))
                else:
                    steps.append(("lineTo", (rng.uniform(0, W), rng.uniform(0, H))))
            if rng.uniform() < 0.5:
                steps.append(("closePath", ()))
        else:
            steps.append(("arc", (rng.uniform(20, W - 20), rng.uniform(20, H - 20),
                                  rng.uniform(8, 40), rng.uniform(0, 6.2),
                                  rng.uniform(0, 6.2),
                                  int(rng.uniform() < 0.5))))

    fill_flag_pool = [vg.FillFlags.Convex, vg.FillFlags.ConvexAA,
                      vg.FillFlags.ConcaveNonZeroAA, vg.FillFlags.ConcaveEvenOddAA]
    caps = [vg.LineCap.Butt, vg.LineCap.Round, vg.LineCap.Square]
    joins = [vg.LineJoin.Miter, vg.LineJoin.Round, vg.LineJoin.Bevel]

    for _ in range(int(rng.integers(10, 22))):
        r = rng.uniform()
        if r < 0.06 and depth < 3:
            steps.append(("pushState", ()))
            depth += 1
        elif r < 0.1 and depth > 0:
            steps.append(("popState", ()))
            depth -= 1
        elif r < 0.16:
            t = rng.uniform()
            if t < 0.4:
                steps.append(("transformTranslate",
                              (rng.uniform(-30, 30), rng.uniform(-20, 20))))
            elif t < 0.7:
                steps.append(("transformRotate", (rng.uniform(-0.5, 0.5),)))
            else:
                steps.append(("transformScale",
                              (rng.uniform(0.6, 1.6), rng.uniform(0.6, 1.6))))
        elif r < 0.22:
            s = rng.uniform()
            if s < 0.45:
                steps.append(("setScissor", (rng.uniform(0, 80), rng.uniform(0, 50),
                                             rng.uniform(60, 200), rng.uniform(40, 90))))
            elif s < 0.7:
                steps.append(("intersectScissor",
                              (rng.uniform(0, 60), rng.uniform(0, 40),
                               rng.uniform(80, 220), rng.uniform(50, 100))))
            else:
                steps.append(("resetScissor", ()))
        elif r < 0.26:
            steps.append(("setGlobalAlpha", (float(rng.uniform(0.4, 1.0)),)))
        elif r < 0.32 and not clip_open:
            steps.append(("beginClip",
                          (vg.ClipRule.In if rng.uniform() < 0.7 else vg.ClipRule.Out,)))
            random_shape()
            steps.append(("fillPath", (vg.Colors.Black, vg.FillFlags.ConvexAA)))
            steps.append(("endClip", ()))
            clip_open = True
        elif r < 0.36 and clip_open:
            steps.append(("resetClip", ()))
            clip_open = False
        elif r < 0.42 and FONT_DATA is not None:
            cfg = (float(rng.uniform(9, 26)),
                   int(rng.choice([vg.TextAlign.Left | vg.TextAlign.Top,
                                   vg.TextAlign.Center | vg.TextAlign.Middle,
                                   vg.TextAlign.Right | vg.TextAlign.Baseline])),
                   color(255))
            steps.append(("TEXT", (cfg, rng.uniform(0, W - 60), rng.uniform(10, H),
                                   str(rng.choice(["Fuzz!", "vg 123", "GPU raster",
                                                   "käse & ø"])))))
        elif r < 0.46:
            tris = int(rng.integers(1, 4))
            pos = rng.uniform((0, 0), (W, H), (3 * tris, 2)).astype(np.float32)
            cols = np.array([color() for _ in range(3 * tris)], np.uint32)
            idx = np.arange(3 * tris, dtype=np.uint16)
            steps.append(("TRILIST", (pos, cols, idx)))
        elif r < 0.72:
            random_shape()
            steps.append(("fillPath",
                          (random_paint(), int(rng.choice(fill_flag_pool)))))
        else:
            random_shape()
            flags = vg.stroke_flags(int(rng.choice(caps)), int(rng.choice(joins)),
                                    aa=bool(rng.uniform() < 0.8))
            steps.append(("strokePath",
                          (random_paint(), float(rng.uniform(0.3, 9.0)), flags)))

    while depth > 0:
        steps.append(("popState", ()))
        depth -= 1
    if clip_open:
        steps.append(("resetClip", ()))
    return steps


def apply_program(ctx, steps, font, img_handle):
    """Drive the program against a context (direct mode or while a command
    list is being recorded — the call surface is identical by design)."""
    grads = []

    def resolve(v):
        if isinstance(v, str):
            if v.startswith("G"):
                return grads[int(v[1:])]
            if v == "IMG0":
                return img_handle
        return v

    for name, args in steps:
        if name.startswith("create") and ("Gradient" in name or "Pattern" in name):
            grads.append(getattr(vg, name)(ctx, *(resolve(a) for a in args)))
        elif name == "TEXT":
            (size, align, col), x, y, s = args
            cfg = vg.makeTextConfig(ctx, "sans", size, align, col)
            vg.text(ctx, cfg, x, y, s)
        elif name == "TRILIST":
            pos, cols, idx = args
            vg.indexedTriList(ctx, pos, None, len(pos), cols, len(cols),
                              idx, len(idx), None)
        else:
            rargs = [resolve(a) for a in args]
            if (name in ("fillPath", "strokePath")
                    and isinstance(rargs[0], vg.ImagePatternHandle)):
                # pattern overload carries a modulate color (vg.h fillPath
                # image-pattern signature); the generator emits the handle
                rargs.insert(1, vg.Colors.White)
            getattr(vg, name)(ctx, *rargs)


def fresh_ctx(rng_img, dpr=1.0):
    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, dpr)
    font = None
    if FONT_DATA is not None:
        font = vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
    img = vg.createImage(ctx, 16, 16, 0, _checker_image(rng_img))
    return ctx, font, img


BG = (0.12, 0.1, 0.14, 1.0)


def render_direct(steps, seed, immediate=False, dpr=1.0):
    ctx, font, img = fresh_ctx(np.random.default_rng(seed), dpr)
    ctx._immediate_geom = immediate
    apply_program(ctx, steps, font, img)
    vg.end(ctx, background=BG)
    return np.asarray(ctx.frame_image)


def render_command_list(steps, seed, flags=0, submits=1, dpr=1.0):
    ctx, font, img = fresh_ctx(np.random.default_rng(seed), dpr)
    cl = vg.createCommandList(ctx, flags)
    vg.beginCommandList(ctx, cl)
    apply_program(ctx, steps, font, img)
    vg.endCommandList(ctx)
    out = None
    for _ in range(submits):
        vg.submitCommandList(ctx, cl)
        vg.end(ctx, background=BG)
        out = np.asarray(ctx.frame_image)
        vg.begin(ctx, 0, W, H, dpr)
    return out


def render_deferred_dispatch(steps, seed, dpr=1.0):
    """Execution path 6: prepare with end(dispatch=False), then render
    through the fused multi-canvas dispatch (renderFrames)."""
    ctx, font, img = fresh_ctx(np.random.default_rng(seed), dpr)
    apply_program(ctx, steps, font, img)
    assert vg.end(ctx, background=BG, dispatch=False) is None
    (out,) = vg.renderFrames([ctx])
    assert ctx.frame_image is out
    return np.asarray(out)


def render_save_load(steps, seed, tmpdir, dpr=1.0):
    ctx, font, img = fresh_ctx(np.random.default_rng(seed), dpr)
    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    vg.beginCommandList(ctx, cl)
    apply_program(ctx, steps, font, img)
    vg.endCommandList(ctx)
    path = str(tmpdir / f"fuzz_{seed}.vgcl")
    assert vg.saveCommandList(ctx, cl, path)
    # fresh context: same font/image creation order -> same handle ids
    ctx2, font2, img2 = fresh_ctx(np.random.default_rng(seed), dpr)
    cl2 = vg.loadCommandList(ctx2, path)
    vg.submitCommandList(ctx2, cl2)
    vg.end(ctx2, background=BG)
    return np.asarray(ctx2.frame_image)


@pytest.mark.parametrize("seed", [11, 23, 37, 58])
def test_fuzz_all_execution_paths_agree(seed, tmp_path):
    rng = np.random.default_rng(seed)
    steps = build_program(rng)

    ref = render_direct(steps, seed)
    paths = {
        "immediate_geom": render_direct(steps, seed, immediate=True),
        "cl_replay": render_command_list(steps, seed),
        "cl_cached_2nd": render_command_list(
            steps, seed, flags=vg.CommandListFlags.Cacheable, submits=2),
        "save_load": render_save_load(steps, seed, tmp_path),
        "deferred_dispatch": render_deferred_dispatch(steps, seed),
    }
    for name, img in paths.items():
        np.testing.assert_allclose(
            img, ref, atol=2e-4,
            err_msg=f"seed {seed}: {name} diverged from direct render")


@pytest.mark.parametrize("seed", [71, 92])
def test_fuzz_all_execution_paths_agree_dpr2(seed, tmp_path):
    """Same equivalence class at devicePixelRatio 2 (the dpr rebase bugs of
    ADVICE rounds 1-2 lived exactly here)."""
    rng = np.random.default_rng(seed)
    steps = build_program(rng)

    ref = render_direct(steps, seed, dpr=2.0)
    paths = {
        "immediate_geom": render_direct(steps, seed, immediate=True, dpr=2.0),
        "cl_replay": render_command_list(steps, seed, dpr=2.0),
        "cl_cached_2nd": render_command_list(
            steps, seed, flags=vg.CommandListFlags.Cacheable, submits=2, dpr=2.0),
        "save_load": render_save_load(steps, seed, tmp_path, dpr=2.0),
        "deferred_dispatch": render_deferred_dispatch(steps, seed, dpr=2.0),
    }
    for name, img in paths.items():
        np.testing.assert_allclose(
            img, ref, atol=2e-4,
            err_msg=f"seed {seed}: {name} diverged from direct render (dpr=2)")
