"""Retained-mode rendering: Cacheable command lists + frame memoization.

The reference's retained path is `CommandListFlags::Cacheable` (vg.cpp:249-272,
:5674-6211): record once, replay the cached tessellation every frame with only
the transform changing.  vgtpu keeps the same API and adds a second retained
layer the reference cannot have — when a re-recorded frame fingerprints
identical to the previous one (ContextConfig.frame_memo), the entire resident
DEVICE plan is reused: no re-bake, no re-bin, no host->device upload.

    python examples/retained_scene.py        # prints per-frame timings
"""

import time
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import vgtpu as vg


def record_widget(ctx, cl):
    """A small vector widget recorded into a cacheable command list."""
    vg.beginCommandList(ctx, cl)
    vg.clBeginPath(ctx, cl)
    vg.clRoundedRect(ctx, cl, -60, -40, 120, 80, 12)
    vg.clFillPath(ctx, cl, vg.color4ub(40, 90, 200, 255), vg.FillFlags.ConvexAA)
    vg.clStrokePath(ctx, cl, vg.Colors.White, 2.0, vg.StrokeFlags.ButtRoundAA)
    vg.clBeginPath(ctx, cl)
    vg.clCircle(ctx, cl, 0, 0, 18)
    vg.clFillPath(ctx, cl, vg.color4ub(250, 200, 60, 255), vg.FillFlags.ConvexAA)
    vg.endCommandList(ctx)


def draw_frame(ctx, cl, t):
    """Submit the SAME cached widget 48 times under different transforms —
    the stroker/tessellation work is skipped on every replay (clCacheRender,
    vg.cpp:5845-6120 analogue)."""
    for i in range(48):
        row, col = divmod(i, 8)
        vg.pushState(ctx)
        vg.transformTranslate(ctx, 100 + col * 150, 90 + row * 120)
        vg.transformRotate(ctx, t * (0.2 + 0.01 * i))
        vg.submitCommandList(ctx, cl)
        vg.popState(ctx)


def main():
    ctx = vg.createContext()
    vg.begin(ctx, 0, 1280, 720, 1.0)
    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    record_widget(ctx, cl)
    draw_frame(ctx, cl, 0.0)
    img = vg.end(ctx, background=(0.1, 0.1, 0.12, 1.0))
    # keep the image on device; pull back only a scalar probe (a full-frame
    # readback would swamp the timings with the PCIe transfer)
    print(f"cold frame     : {img.shape}, mean={float(img.mean()):.4f}")

    # Animated frames: cached meshes replayed under new transforms; geometry
    # is re-binned because the content actually changed.
    for k in range(3):
        t0 = time.perf_counter()
        vg.begin(ctx, 0, 1280, 720, 1.0)
        draw_frame(ctx, cl, 0.1 * (k + 1))
        probe = float(vg.end(ctx, background=(0.1, 0.1, 0.12, 1.0)).mean())
        print(f"animated frame : {(time.perf_counter()-t0)*1e3:7.1f} ms "
              f"(cached-list replay, content changed; probe={probe:.4f})")

    # Static frames: identical re-records hit the frame memo — the resident
    # device plan is reused, skipping finalize/bin/sample/upload entirely.
    for _ in range(3):
        t0 = time.perf_counter()
        vg.begin(ctx, 0, 1280, 720, 1.0)
        draw_frame(ctx, cl, 0.3)
        probe = float(vg.end(ctx, background=(0.1, 0.1, 0.12, 1.0)).mean())
        print(f"static frame   : {(time.perf_counter()-t0)*1e3:7.1f} ms "
              f"(frame-memo hit, device plan reused; probe={probe:.4f})")

    rep = ctx.profiler.report()
    print(f"stats          : {ctx.getStats()}")
    print(f"memo hits      : {rep['counters'].get('memo_hits', 0)}")
    print("host ms/frame  :", {k: round(v, 1) for k, v in rep['ms_per_frame'].items()})


if __name__ == "__main__":
    main()
