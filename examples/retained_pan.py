#!/usr/bin/env python
"""Device-resident retained-scene panning: bake the benchmark artwork once,
then scroll it entirely on device — no re-record, no re-bin, no upload.

The reference's closest analogue is a Cacheable command list re-submitted
with a translated transform (vg.cpp:4287-4300), which re-walks host memory
and re-uploads vertices every frame.  Here a pan is ONE jitted device
program over the resident plan (raster/retained.py).

Writes a few panned frames to /tmp/vgtpu_pan_*.png and reports ms/frame.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import vgtpu as vg  # noqa: E402
from vgtpu.raster.retained import RetainedScene  # noqa: E402


def _draw_scene(ctx, t: float = 0.0) -> None:
    # artwork larger than the viewport: the tiger plus surrounding cards
    from vgtpu.scenes.tiger import draw_tiger

    draw_tiger(ctx, 40, 40, 0.9)
    ph = int(80 * (0.5 + 0.5 * np.sin(3.0 * t)))
    for i in range(6):
        x, y = 650 + (i % 2) * 220, 60 + (i // 2) * 220
        g = vg.createLinearGradient(ctx, x, y, x + 180, y + 180,
                                    vg.color4ub(min(255, 40 + 30 * i + ph),
                                                120,
                                                max(0, 255 - 30 * i - ph),
                                                255),
                                    vg.color4ub(255, 160, 40 + ph, 255))
        vg.beginPath(ctx)
        vg.roundedRect(ctx, x, y, 180, 180, 18)
        vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
        vg.beginPath(ctx)
        vg.circle(ctx, x + 90, y + 90, 60)
        vg.strokePath(ctx, vg.color4ub(255 - ph, 255, 255, 200), 4.0,
                      vg.StrokeFlags.RoundRoundAA)


def main() -> None:
    ctx = vg.createContext()
    out_w, out_h = 960, 540
    vg.begin(ctx, 0, out_w, out_h, 1.0)
    _draw_scene(ctx)

    t0 = time.perf_counter()
    scene = RetainedScene.bake(ctx, scene_width=1400, scene_height=800,
                               background=(0.09, 0.09, 0.11, 1.0))
    bake_ms = (time.perf_counter() - t0) * 1e3
    print(f"bake: {bake_ms:.0f} ms  "
          f"(entries={scene.plan.stats['entries']}, "
          f"chunks={scene.plan.stats['chunks']})")

    # a few frames to PNG
    try:
        from PIL import Image
    except Exception:  # noqa: BLE001
        Image = None
    for k, (vx, vy) in enumerate([(0, 0), (200, 60), (430, 170)]):
        img = np.asarray(scene.render(vx, vy))
        if Image is not None:
            a = np.clip(img, 0, 1)
            rgb = np.where(a[..., 3:] > 1e-6, a[..., :3] / np.maximum(a[..., 3:], 1e-6), 0)
            Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
                f"/tmp/vgtpu_pan_{k}.png")
    print("wrote /tmp/vgtpu_pan_*.png")

    # timing: a dispatch loop over a scrolling path (the fetch consumes a
    # scalar from every frame)
    import jax.numpy as jnp

    views = [(int(37 * k % 400), int(23 * k % 240)) for k in range(16)]
    for v in views[:3]:
        scene.render(*v)  # warm both residual classes
    t0 = time.perf_counter()
    acc = jnp.float32(0)
    n = 48
    for k in range(n):
        img = scene.render(*views[k % len(views)])
        acc = acc + img[..., 3].sum()
    float(acc)
    ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"pan dispatch loop: {ms:.2f} ms/frame (includes per-call host "
          f"dispatch)")

    from vgtpu.raster.retained import measure_pan_ms_per_frame

    ms = measure_pan_ms_per_frame(scene, reps_hi=32, reps_lo=2)
    print(f"pan render: {ms:.2f} ms/frame on {out_w}x{out_h} "
          f"({1e3 / ms:.0f} fps), all on device (chained loop)")

    # multi-view serving: V viewports of the resident scene, one dispatch
    stack = scene.render_views([(0, 0), (200, 60), (430, 170)])
    print(f"render_views: {np.asarray(stack).shape} in one dispatch")

    # pan + color animation: re-record with new colors, patch the values in
    # place (plan, coverage chunks, compiled pan programs all reused)
    t0 = time.perf_counter()
    vg.begin(ctx, 0, out_w, out_h, 1.0)
    _draw_scene(ctx, t=0.8)
    scene.update_paint_values(ctx)
    np.asarray(scene.render(200, 60))
    print(f"paint-update tick (re-record + patch + render): "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")


if __name__ == "__main__":
    main()
