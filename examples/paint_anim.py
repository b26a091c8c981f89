"""Paint-value animation on a resident scene (ContextConfig.paint_memo).

The app re-records the same frame every tick with different solid/gradient
COLORS (a fade + hue cycle).  Geometry is unchanged, so the engine patches
the resident device plan's paint tables (~KB upload) instead of re-binning
and re-uploading the scene — the common UI pattern (hover highlights,
pulsing accents, theme fades) renders at close to memo-hit cost.

    python examples/paint_anim.py [frames]
"""

import colorsys
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import vgtpu as vg

W, H = 640, 360


def draw(ctx, t: float) -> None:
    hue = (0.08 * t) % 1.0
    r, g, b = (int(255 * v) for v in colorsys.hsv_to_rgb(hue, 0.75, 0.95))
    pulse = 0.55 + 0.45 * np.sin(1.7 * t)

    grad = vg.createLinearGradient(
        ctx, 40, 40, 420, 250,
        vg.color4ub(r, g, b, 255),
        vg.color4ub(255 - r, 255 - g, b, 220))
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 40, 40, 380, 220, 24)
    vg.fillPath(ctx, grad, vg.FillFlags.ConvexAA)

    vg.beginPath(ctx)
    vg.circle(ctx, 500, 150, 80)
    vg.fillPath(ctx, vg.color4ub(r, 200, 255 - r, int(120 + 100 * pulse)),
                vg.FillFlags.ConvexAA)

    vg.beginPath(ctx)
    vg.moveTo(ctx, 60, 320)
    vg.cubicTo(ctx, 200, 260, 380, 350, 600, 290)
    vg.strokePath(ctx, vg.color4ub(255 - r, g, r, 255), 6.0,
                  vg.StrokeFlags.RoundRoundAA)


def main(frames: int = 120) -> None:
    if frames < 1:
        print(f"nothing to animate (frames={frames})")
        return
    ctx = vg.createContext()
    vg.begin(ctx, 0, W, H, 1.0)
    draw(ctx, 0.0)
    vg.end(ctx, background=(0.09, 0.09, 0.11, 1.0))  # full bin once

    t0 = time.perf_counter()
    for k in range(1, frames + 1):
        vg.begin(ctx, 0, W, H, 1.0)
        draw(ctx, 0.12 * k)
        img = vg.end(ctx, background=(0.09, 0.09, 0.11, 1.0))
    img.block_until_ready()
    dt = (time.perf_counter() - t0) * 1e3 / frames

    hits = ctx.profiler.counters.get("memo_paint_hits", 0)
    print(f"{frames} animated frames: {dt:.2f} ms/frame host wall-clock, "
          f"{hits} paint-patch hits "
          f"({100.0 * hits / frames:.0f}% skipped bin+upload)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 120)
