"""Minimal vgtpu usage: shapes, paints, text, readback to PNG.

    python examples/basic.py out.png
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import vgtpu as vg


def main(out_path: str = "/tmp/vgtpu_basic.png") -> None:
    ctx = vg.createContext()
    vg.begin(ctx, 0, 640, 360, 1.0)

    # gradient card
    g = vg.createLinearGradient(ctx, 40, 40, 300, 200, vg.Colors.Red, vg.Colors.Blue)
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 40, 40, 260, 160, 24)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.strokePath(ctx, vg.Colors.Black, 3.0, vg.StrokeFlags.RoundRoundAA)

    # even-odd star
    ang = -np.pi / 2 + np.arange(5) * (4 * np.pi / 5)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 470 + 90 * np.cos(ang[0]), 150 + 90 * np.sin(ang[0]))
    for a in ang[1:]:
        vg.lineTo(ctx, 470 + 90 * np.cos(a), 150 + 90 * np.sin(a))
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(250, 180, 30, 255), vg.FillFlags.ConcaveEvenOddAA)

    # text (the DejaVu Sans the package ships)
    from vgtpu.fonts import default_font_data

    data = default_font_data()
    f = vg.createFont(ctx, "sans", data, len(data), 0)
    cfg = vg.makeTextConfig(ctx, f, 28.0, vg.TextAlign.BottomLeft, vg.Colors.White)
    vg.text(ctx, cfg, 40, 330, "vgtpu: vector graphics on JAX")

    vg.end(ctx, background=(0.12, 0.12, 0.14, 1.0))
    from PIL import Image

    Image.fromarray(ctx.readback_u8(), "RGBA").save(out_path)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(*sys.argv[1:2])
