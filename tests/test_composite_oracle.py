"""The XLA composite (ops/composite.py, through raster/frame.execute_plan)
against the numpy painter's-order reference (tests/composite_oracle.py) on
real scene plans: solids, gradients, strokes, both fill rules, non-AA,
clips, scissors, vertex-colour triangles, image patterns and text, at
supersampling 1, 2 and 4 — the four shader programs and stencil semantics of
the reference, src/shaders/*.sc + vg.cpp:1162-1287."""

import numpy as np
import pytest

import vgtpu as vg
from vgtpu.ops.coverage import entry_coverage_from_pools
from vgtpu.raster.binning import bin_frame
from vgtpu.raster.frame import execute_plan, plan_to_device

from tests.composite_oracle import composite_image
from tests.fontdata import FONT_DATA

BG = (0.1, 0.2, 0.3, 1.0)


def _scene_full(ctx):
    g = vg.createLinearGradient(ctx, 10, 10, 200, 150, vg.Colors.Red, vg.Colors.Blue)
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 10, 10, 190, 140, 25)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.circle(ctx, 300, 80, 60)
    vg.fillPath(ctx, vg.color4ub(255, 200, 0, 255), vg.FillFlags.ConvexAA)
    vg.strokePath(ctx, vg.Colors.Black, 5.0, vg.StrokeFlags.RoundRoundAA)
    # star: concave + even-odd
    ang = -np.pi / 2 + np.arange(5) * (4 * np.pi / 5)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 420 + 50 * np.cos(ang[0]), 80 + 50 * np.sin(ang[0]))
    for a in ang[1:]:
        vg.lineTo(ctx, 420 + 50 * np.cos(a), 80 + 50 * np.sin(a))
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(40, 220, 120, 200), vg.FillFlags.ConcaveEvenOddAA)
    # clip + scissor + non-AA
    vg.beginClip(ctx, vg.ClipRule.In)
    vg.beginPath(ctx)
    vg.circle(ctx, 140, 200, 55)
    vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.Convex)
    vg.endClip(ctx)
    vg.setScissor(ctx, 60, 150, 400, 100)
    vg.beginPath(ctx)
    vg.rect(ctx, 60, 150, 200, 100)
    vg.fillPath(ctx, vg.color4ub(30, 120, 230, 255), vg.FillFlags.Convex)
    vg.resetScissor(ctx)
    vg.resetClip(ctx)
    # per-vertex-color triangles
    pos = np.array([[330, 160], [470, 170], [400, 250]], np.float32)
    cols = np.array([vg.Colors.Red, vg.Colors.Green, vg.Colors.Blue], np.uint32)
    vg.indexedTriList(ctx, pos, None, 3, cols, 3, np.array([0, 1, 2], np.uint16), 3, None)


def _scene_text(ctx):
    f = vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
    cfg = vg.makeTextConfig(ctx, f, 26.0, vg.TextAlign.MiddleLeft, vg.Colors.White)
    vg.text(ctx, cfg, 8, 64, "composite parity")
    vg.beginPath(ctx)
    vg.rect(ctx, 0, 0, 384, 40)
    vg.fillPath(ctx, vg.color4ub(200, 60, 60, 160), vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.circle(ctx, 300, 70, 40)
    vg.fillPath(ctx, vg.color4ub(40, 220, 120, 180), vg.FillFlags.ConvexAA)


def _scene_pattern(ctx):
    rng = np.random.default_rng(4)
    tex = rng.integers(0, 256, (16, 16, 4), np.uint8)
    tex[..., 3] = rng.integers(120, 256, (16, 16))
    himg = vg.createImage(ctx, 16, 16, 0, tex)
    p = vg.createImagePattern(ctx, 30, 20, 48, 48, 0.0, himg)
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 20, 10, 200, 100, 12)
    vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
    g = vg.createBoxGradient(ctx, 200, 30, 150, 70, 10, 12,
                             vg.color4ub(255, 255, 255, 200), vg.color4ub(0, 0, 0, 0))
    vg.beginPath(ctx)
    vg.rect(ctx, 180, 10, 190, 110)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)


def _scene_random(seed):
    def draw(ctx):
        rng = np.random.default_rng(seed)
        for _ in range(8):
            vg.beginPath(ctx)
            x, y = rng.uniform(0, 220), rng.uniform(0, 100)
            if rng.uniform() < 0.4:
                vg.circle(ctx, x, y, rng.uniform(5, 40))
            else:
                vg.rect(ctx, x, y, rng.uniform(10, 80), rng.uniform(10, 60))
            col = vg.color4ub(*rng.integers(0, 256, 3), rng.integers(60, 256))
            flags = (vg.FillFlags.ConvexAA if rng.uniform() < 0.7
                     else vg.FillFlags.Convex)
            vg.fillPath(ctx, col, flags)
            if rng.uniform() < 0.3:
                vg.strokePath(ctx, vg.Colors.Black, rng.uniform(0.5, 6.0),
                              vg.StrokeFlags.ButtMiterAA)
    return draw


# name -> (draw, width, height, tile_h)
SCENES = {
    "full": (_scene_full, 512, 256, 8),
    "text": (_scene_text, 384, 128, 8),
    "pattern": (_scene_pattern, 384, 128, 8),
    "random7": (_scene_random(7), 256, 128, 8),
    "random8": (_scene_random(8), 256, 128, 8),
    "full_tile_h16": (_scene_full, 256, 128, 16),
}


def _check(name, ss):
    import jax.numpy as jnp

    draw, w, h, tile_h = SCENES[name]
    ctx = vg.createContext(vg.ContextConfig(tile_h=tile_h))
    vg.begin(ctx, 0, w, h, 1.0)
    draw(ctx)
    ctx._finalize_ops()
    plan = bin_frame(ctx.ops, w, h, tile_h=tile_h, tile_w=ctx.cfg.tile_w,
                     supersample=ss)
    ctx._fill_textures(plan)
    d = plan_to_device(plan)
    got = np.asarray(execute_plan(plan, background=BG, device_arrays=d))
    ne = plan.entry_backdrop.shape[0]
    entry_w = (entry_coverage_from_pools(d["chunk_pools"], ne, plan.tile_h,
                                         plan.tile_w)
               + jnp.asarray(plan.entry_backdrop)[:, :, None])
    want, ties = composite_image(plan, entry_w, plan.color_tiles, BG, ss=ss)
    assert ties.mean() < 1e-3, f"{ties.sum()} non-AA ties"
    np.testing.assert_allclose(got[~ties], want[~ties], atol=2e-5)


@pytest.mark.parametrize("ss", [1, 2])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_xla_composite_matches_numpy_oracle(name, ss):
    _check(name, ss)


def test_xla_composite_matches_numpy_oracle_ss4():
    _check("full", 4)
