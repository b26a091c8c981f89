#!/usr/bin/env python
"""Panning a Cacheable command list under a live UI — the reference's
primary retained pattern (clCacheRender, vg.cpp:5845-6120: cached meshes
re-transformed per submit) on this engine.

The app simply re-submits the list under a new translation each frame; the
engine detects the translation-only delta (api/command_list._layer_submit),
bakes the list ONCE as a retained scene, and renders every later offset as
device-resident layer tiles — no host replay, no rebin of the artwork.  The
immediate-mode UI on top bins as a small suffix plan over those tiles.

Writes frames to examples/out/cached_pan_*.png and reports ms/frame.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import vgtpu as vg  # noqa: E402


def main() -> None:
    from vgtpu.raster.frame import image_to_u8
    from vgtpu.scenes.tiger import draw_tiger

    bg = (0.12, 0.12, 0.13, 1.0)
    ctx = vg.createContext()
    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    vg.beginCommandList(ctx, cl)
    draw_tiger(ctx, 20, 40, 0.8)
    vg.endCommandList(ctx)

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
    os.makedirs(out_dir, exist_ok=True)

    def frame(k: int):
        vg.begin(ctx, 0, 960, 540, 1.0)
        vg.pushState(ctx)
        # fractional horizontal pan is exact; vertical pans in whole pixels
        vg.transformTranslate(ctx, 12.5 * k, 6 * k)
        vg.submitCommandList(ctx, cl)
        vg.popState(ctx)
        # immediate-mode HUD on top
        vg.beginPath(ctx)
        vg.roundedRect(ctx, 700, 470, 240, 50, 9)
        vg.fillPath(ctx, vg.color4ub(30, 30, 40, 210), vg.FillFlags.ConvexAA)
        vg.beginPath(ctx)
        vg.circle(ctx, 730 + 8 * (k % 6), 495, 12)
        vg.fillPath(ctx, vg.color4ub(250, 200, 40, 255), vg.FillFlags.ConvexAA)
        img = vg.end(ctx, background=bg)
        img.block_until_ready()
        return img

    frame(0)          # builds the list's geometry cache
    frame(0)          # cached replay (op-list memo)
    frame(1)          # translation moved: one replay + retained-scene bake
    ts = []
    for k in range(2, 10):
        t0 = time.perf_counter()
        img = frame(k)
        ts.append((time.perf_counter() - t0) * 1e3)
        if k < 5:
            from PIL import Image

            Image.fromarray(image_to_u8(np.asarray(img))).save(
                os.path.join(out_dir, f"cached_pan_{k}.png"))
    c = ctx.profiler.counters
    print(f"pan frames: {[round(t, 1) for t in ts]} ms  "
          f"median {sorted(ts)[len(ts) // 2]:.1f} ms")
    print(f"layer_cl_bakes={c.get('layer_cl_bakes', 0)} "
          f"layer_cl_hits={c.get('layer_cl_hits', 0)}")


if __name__ == "__main__":
    main()
