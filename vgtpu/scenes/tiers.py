"""The five capability tiers of BASELINE.json as drawable scenes — the
golden-image regression set (tests/goldens/<name>.npz holds each one's
committed u8 render)."""

from __future__ import annotations

import numpy as np

import vgtpu as vg


def tier1_rects_noaa(ctx) -> None:
    for i in range(6):
        vg.beginPath(ctx)
        vg.roundedRect(ctx, 10 + i * 40, 16, 34, 96, 6 + i)
        vg.strokePath(ctx, vg.Colors.White, 3.0, vg.StrokeFlags.ButtMiter)


def tier2_curves_aa(ctx) -> None:
    caps = [vg.LineCap.Butt, vg.LineCap.Round, vg.LineCap.Square]
    joins = [vg.LineJoin.Miter, vg.LineJoin.Round, vg.LineJoin.Bevel]
    for i, (cap, join) in enumerate(zip(caps, joins)):
        vg.beginPath(ctx)
        vg.moveTo(ctx, 20 + i * 80, 100)
        vg.cubicTo(ctx, 40 + i * 80, 20, 60 + i * 80, 180, 80 + i * 80, 30)
        vg.strokePath(ctx, vg.colorHSB(i / 3, 0.8, 1.0), 8.0,
                      vg.stroke_flags(cap, join, True))


def tier3_winding(ctx) -> None:
    for rule, x0 in ((vg.FillFlags.ConcaveNonZeroAA, 0),
                     (vg.FillFlags.ConcaveEvenOddAA, 128)):
        vg.beginPath(ctx)
        ang = -np.pi / 2 + np.arange(5) * (4 * np.pi / 5)
        vg.moveTo(ctx, x0 + 64 + 50 * np.cos(ang[0]), 64 + 50 * np.sin(ang[0]))
        for a in ang[1:]:
            vg.lineTo(ctx, x0 + 64 + 50 * np.cos(a), 64 + 50 * np.sin(a))
        vg.closePath(ctx)
        vg.fillPath(ctx, vg.color4ub(255, 160, 20, 255), rule)


def tier4_text(ctx) -> None:
    from vgtpu.fonts import default_font_data

    data = default_font_data()
    f = vg.createFont(ctx, "sans", data, len(data), 0)
    cfg = vg.makeTextConfig(ctx, f, 24.0, vg.TextAlign.MiddleLeft, vg.Colors.White)
    vg.text(ctx, cfg, 8, 32, "Glyph cache AA")


def tier5_full(ctx) -> None:
    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    vg.beginCommandList(ctx, cl)
    g = vg.createRadialGradient(ctx, 128, 128, 20, 100,
                                vg.color4ub(255, 255, 200, 255),
                                vg.color4ub(180, 40, 0, 255))
    vg.beginPath(ctx)
    vg.circle(ctx, 128, 128, 100)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.endCommandList(ctx)
    vg.submitCommandList(ctx, cl)

    vg.beginClip(ctx, vg.ClipRule.Out)
    vg.beginPath(ctx)
    vg.circle(ctx, 380, 128, 60)
    vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.Convex)
    vg.endClip(ctx)
    vg.beginPath(ctx)
    vg.rect(ctx, 280, 28, 200, 200)
    vg.fillPath(ctx, vg.color4ub(30, 120, 220, 255), vg.FillFlags.ConvexAA)
    vg.resetClip(ctx)

    from vgtpu.scenes.demo_ui import draw_color_wheel

    draw_color_wheel(ctx, 380, 128, 50, 30)


# name -> (draw, width, height, background)
TIERS = {
    "tier1_rects_noaa": (tier1_rects_noaa, 256, 128, (0, 0, 0, 1)),
    "tier2_curves_aa": (tier2_curves_aa, 256, 128, (0, 0, 0, 1)),
    "tier3_winding": (tier3_winding, 256, 128, (0, 0, 0, 1)),
    "tier4_text": (tier4_text, 256, 64, (0, 0, 0, 1)),
    "tier5_full": (tier5_full, 512, 256, (0.1, 0.1, 0.1, 1)),
}


def render_tier(name: str) -> np.ndarray:
    """One tier rendered through vg.begin/end -> (H, W, 4) u8."""
    draw, w, h, bg = TIERS[name]
    ctx = vg.createContext()
    vg.begin(ctx, 0, w, h, 1.0)
    draw(ctx)
    vg.end(ctx, background=bg)
    return np.asarray(ctx.readback_u8())


def golden_diff(want: np.ndarray, got: np.ndarray) -> tuple[float, float]:
    """(mean |Δ|, share of pixels off by more than 32 levels) of two u8
    renders — the golden criterion is mean < 2.0 and share < 1%."""
    diff = np.abs(want.astype(np.int32) - got.astype(np.int32))
    return float(diff.mean()), float((diff > 32).mean())
