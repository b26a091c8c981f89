#!/usr/bin/env python
"""Side-by-side visual comparison against the reference's README renders
(VERDICT round-1 item #5: a documented visual-diff artifact).

The reference ships no test assets, only screenshots
(/root/reference/img/*.png, README.md:51-67), and its demo scenes live in the
author's external bgfx fork — so pixel-level diffs are impossible; the
comparison is a like-for-like EYEBALL check of the same capability classes:

  colorwheel : per-vertex-color triangle ring + text labels
               vs img/vgrenderer_colorwheel.png
  tiger      : dense concave multi-path artwork (the real tiger SVG is not
               sourceable offline — scenes/tiger.py renders a tiger-class
               procedural artwork with matching structural statistics)
               vs img/vgrenderer_tiger.png
  demo       : widget UI (panels, gradients, text, clips)
               vs img/vgrenderer_demo.png

Writes docs/visual/<name>_vs_reference.png (left: this engine, right: the
reference screenshot).  Runs on any backend (CPU fine).

Usage: python tools/visual_compare.py [outdir]
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = "/root/reference/img"


def _render(draw, w, h, bg):
    import vgtpu as vg
    from vgtpu.raster.frame import image_to_u8

    ctx = vg.createContext()
    vg.begin(ctx, 0, w, h, 1.0)
    draw(ctx)
    vg.end(ctx, background=bg)
    return image_to_u8(np.asarray(ctx.frame_image))[..., :3]


def _side_by_side(ours: np.ndarray, ref_path: str, out_path: str) -> None:
    from PIL import Image

    ref = np.asarray(Image.open(ref_path).convert("RGB"))
    h = max(ours.shape[0], ref.shape[0])
    w = ours.shape[1] + ref.shape[1] + 8
    canvas = np.full((h, w, 3), 24, np.uint8)
    canvas[: ours.shape[0], : ours.shape[1]] = ours
    canvas[: ref.shape[0], ours.shape[1] + 8 :] = ref
    Image.fromarray(canvas).save(out_path)
    print(f"wrote {out_path}  (left: vgtpu, right: reference screenshot)")


def main() -> None:
    import vgtpu as vg
    from vgtpu.scenes.demo_ui import draw_color_wheel, draw_demo_ui, _font
    from vgtpu.scenes.tiger import draw_tiger

    outdir = sys.argv[1] if len(sys.argv) > 1 else "docs/visual"
    os.makedirs(outdir, exist_ok=True)

    def wheel(ctx):
        draw_color_wheel(ctx, 216, 142, 110, 62)
        f = _font(ctx)
        if f is not None:
            cfg = vg.makeTextConfig(ctx, f, 16.0, vg.TextAlign.MiddleCenter,
                                    vg.color4ub(220, 220, 220, 255))
            vg.text(ctx, cfg, 216, 142, "hue wheel")

    _side_by_side(_render(wheel, 433, 285, (0.16, 0.16, 0.18, 1.0)),
                  f"{REF}/vgrenderer_colorwheel.png",
                  f"{outdir}/colorwheel_vs_reference.png")

    def tiger(ctx):
        draw_tiger(ctx, 30, 10, 0.95)

    _side_by_side(_render(tiger, 920, 873, (0.95, 0.95, 0.95, 1.0)),
                  f"{REF}/vgrenderer_tiger.png",
                  f"{outdir}/tiger_vs_reference.png")

    _side_by_side(_render(_capability_matrix, 1370, 720, (1.0, 1.0, 1.0, 1.0)),
                  f"{REF}/vgrenderer_demo.png",
                  f"{outdir}/demo_vs_reference.png")


def _capability_matrix(ctx):
    """Recreates the reference demo screenshot's feature grid
    (img/vgrenderer_demo.png): {solid, gradient, image pattern, clip-out} x
    {convex, concave, stroke}, a stroke-width ramp, and cap/join samples."""
    import vgtpu as vg
    from vgtpu.scenes.demo_ui import _font

    f = _font(ctx)
    black = vg.Colors.Black

    def label(x, y, s, align=None):
        if f is None:
            return
        cfg = vg.makeTextConfig(
            ctx, f, 16.0, align or (vg.TextAlign.Center | vg.TextAlign.Top), black)
        vg.text(ctx, cfg, x, y, s)

    checker = np.zeros((32, 32, 4), np.uint8)
    yy, xx = np.mgrid[0:32, 0:32]
    cells = ((xx // 16 + yy // 16) % 2).astype(bool)
    checker[cells] = (255, 0, 255, 255)       # magenta
    checker[~cells] = (0, 255, 255, 255)      # cyan
    img = vg.createImage(ctx, 32, 32, 0, checker)

    def paints(cx, cy, w):
        grad = vg.createLinearGradient(ctx, cx - w / 2, cy - w / 2,
                                       cx + w / 2, cy + w / 2,
                                       vg.color4ub(220, 80, 0, 255),
                                       vg.color4ub(70, 170, 0, 255))
        patt = vg.createImagePattern(ctx, cx, cy, 64, 64, 0.0, img)
        return grad, patt

    def star_path(cx, cy, r):
        ang = -np.pi / 2 + np.arange(5) * (4 * np.pi / 5)
        vg.beginPath(ctx)
        vg.moveTo(ctx, cx + r * np.cos(ang[0]), cy + r * np.sin(ang[0]))
        for a in ang[1:]:
            vg.lineTo(ctx, cx + r * np.cos(a), cy + r * np.sin(a))
        vg.closePath(ctx)

    def s_curve(x, y, w):
        vg.beginPath(ctx)
        vg.moveTo(ctx, x, y)
        vg.cubicTo(ctx, x + w * 0.65, y, x + w * 0.35, y + 55, x + w, y + 55)

    cols = [150, 300, 450]   # solid, gradient, pattern
    label(cols[0], 8, "Solid Color")
    label(cols[1], 8, "Color Gradient")
    label(cols[2], 8, "Image Pattern")
    label(605, 8, "Clip Out")
    la = vg.TextAlign.Right | vg.TextAlign.Middle
    label(78, 92, "Convex", la)
    label(78, 268, "Concave", la)
    label(78, 448, "Stroke", la)

    for i, cx in enumerate(cols):
        grad, patt = paints(cx, 92, 76)
        vg.beginPath(ctx)
        vg.rect(ctx, cx - 38, 54, 76, 76)
        if i == 0:
            vg.fillPath(ctx, vg.Colors.Blue, vg.FillFlags.ConvexAA)
        elif i == 1:
            vg.fillPath(ctx, grad, vg.FillFlags.ConvexAA)
        else:
            vg.fillPath(ctx, patt, vg.Colors.White, vg.FillFlags.ConvexAA)

        grad, patt = paints(cx, 268, 130)
        star_path(cx, 272, 72)
        if i == 0:
            vg.fillPath(ctx, vg.Colors.Blue, vg.FillFlags.ConcaveNonZeroAA)
        elif i == 1:
            vg.fillPath(ctx, grad, vg.FillFlags.ConcaveNonZeroAA)
        else:
            vg.fillPath(ctx, patt, vg.Colors.White, vg.FillFlags.ConcaveNonZeroAA)

        grad, patt = paints(cx, 448, 110)
        s_curve(cx - 55, 420, 110)
        if i == 0:
            vg.strokePath(ctx, vg.Colors.Blue, 9.0, vg.StrokeFlags.ButtMiterAA)
        elif i == 1:
            vg.strokePath(ctx, grad, 9.0, vg.StrokeFlags.ButtMiterAA)
        else:
            vg.strokePath(ctx, patt, vg.Colors.White, 9.0, vg.StrokeFlags.ButtMiterAA)

    # clip-out column: magenta panel with white holes punched by ClipRule.Out
    # (square fill, star fill, stroked curve — like the reference demo)
    vg.beginClip(ctx, vg.ClipRule.Out)
    vg.beginPath(ctx)
    vg.rect(ctx, 575, 64, 60, 56)
    vg.fillPath(ctx, black, vg.FillFlags.Convex)
    star_path(605, 272, 62)
    vg.fillPath(ctx, black, vg.FillFlags.ConcaveNonZero)
    s_curve(550, 420, 110)
    vg.strokePath(ctx, black, 10.0, vg.StrokeFlags.ButtMiter)
    vg.endClip(ctx)
    vg.beginPath(ctx)
    vg.rect(ctx, 545, 36, 120, 480)
    vg.fillPath(ctx, vg.color4ub(255, 0, 255, 255), vg.FillFlags.ConvexAA)
    vg.resetClip(ctx)

    # stroke-width ramp 0.5 .. 19.0
    for k in range(20):
        w = 0.5 if k == 0 else float(k)
        y = 40 + k * 24
        vg.beginPath(ctx)
        vg.moveTo(ctx, 700, y + 10)
        vg.lineTo(ctx, 880, y)
        vg.strokePath(ctx, black, w, vg.StrokeFlags.ButtMiterAA)
        label(900, y - 8, f"{w:.1f}", vg.TextAlign.Left | vg.TextAlign.Top)

    # caps / joins
    for k, (flags, name) in enumerate([
        (vg.StrokeFlags.ButtMiterAA, "Butt/Miter"),
        (vg.StrokeFlags.RoundRoundAA, "Round/Round"),
        (vg.stroke_flags(vg.LineCap.Square, vg.LineJoin.Bevel, True), "Square/Bevel"),
    ]):
        x, y = 1030, 60 + k * 120
        vg.beginPath(ctx)
        vg.moveTo(ctx, x, y)
        vg.lineTo(ctx, x + 55, y + 18)
        vg.lineTo(ctx, x + 40, y + 95)
        vg.strokePath(ctx, black, 14.0, flags)
        label(x + 120, y + 40, name, vg.TextAlign.Left | vg.TextAlign.Top)


if __name__ == "__main__":
    main()
