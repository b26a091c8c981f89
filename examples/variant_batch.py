"""Batched variant rendering: an animation burst in ONE device dispatch.

The reference renders frames strictly one at a time (vg.cpp:1076-1288).
`VariantBatch` is the batched serving mode: K paint-value variants of one
scene — here a K-step fade/hue-cycle burst — bake once and render as a single
compiled program.  Coverage (the winding stage) is computed once and shared;
per-variant shading folds into the composite's entry and tile axes, so the
per-bucket launch overhead is paid once per BATCH instead of once per frame.

    python examples/variant_batch.py [K]
"""

import colorsys
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import vgtpu as vg

W, H = 640, 360
BG = (0.07, 0.07, 0.1, 1.0)


def draw(ctx, t: float) -> None:
    hue = (0.11 * t) % 1.0
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


def main() -> None:
    K = int(sys.argv[1]) if len(sys.argv) > 1 else 8

    ctx = vg.createContext()
    t0 = time.perf_counter()
    vb = vg.VariantBatch.bake(
        ctx, [lambda c, k=k: draw(c, 0.35 * k) for k in range(K)],
        W, H, background=BG)
    print(f"baked K={K} variants ({vb._mode} mode) "
          f"in {time.perf_counter() - t0:.2f} s")

    imgs = np.asarray(vb.render(background=BG))
    print(f"rendered batch -> {imgs.shape}")

    ms = vg.measure_batch_ms_per_frame(vb, background=BG)
    print(f"chained throughput: {ms:.3f} ms per variant frame")

    # the per-tick serving loop: refresh the K variants' VALUES in place
    # (statics + compiled programs reused), then render the new burst
    t0 = time.perf_counter()
    vb.update_values([lambda c, k=k: draw(c, 0.35 * k + 1.7)
                      for k in range(K)])
    imgs = np.asarray(vb.render(background=BG))
    print(f"update_values tick (K records + value bake + render): "
          f"{time.perf_counter() - t0:.3f} s")

    # multi-canvas: two UNRELATED contexts fused into one dispatch
    ctx_a, ctx_b = vg.createContext(), vg.createContext()
    vg.begin(ctx_a, 0, 320, 180, 1.0)
    draw(ctx_a, 0.2)
    vg.end(ctx_a, background=BG, dispatch=False)
    vg.begin(ctx_b, 0, 480, 270, 1.0)
    draw(ctx_b, 2.9)
    vg.end(ctx_b, background=BG, dispatch=False)
    a, b = vg.renderFrames([ctx_a, ctx_b])
    print(f"renderFrames fused 2 canvases: {np.asarray(a).shape} "
          f"+ {np.asarray(b).shape}")

    try:
        from PIL import Image

        from vgtpu.raster.frame import image_to_u8

        outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "out")
        os.makedirs(outdir, exist_ok=True)
        for k in (0, K // 2, K - 1):
            path = os.path.join(outdir, f"variant_{k:02d}.png")
            Image.fromarray(image_to_u8(imgs[k])).save(path)
            print("wrote", path)
    except ImportError:
        pass


if __name__ == "__main__":
    main()
