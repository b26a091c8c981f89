"""Host-stage profile of the bench anim pattern (paint-only animation on the
full benchmark scene -> context._value_only_update patch path).

Attributes what the anim loop costs beyond a plain redraw: record /
fingerprint / paint_patch / dispatch, plus a cProfile of the patch itself.

Usage: JAX_PLATFORMS=cpu python tools/profile_anim.py [--cprofile]
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import vgtpu as vg
from vgtpu.scenes.demo_ui import draw_benchmark_frame


def main() -> None:
    bg = (0.12, 0.12, 0.13, 1.0)
    ctx = vg.createContext()

    def frame_with_overlay(k):
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        draw_benchmark_frame(ctx, 0.0)
        vg.beginPath(ctx)
        vg.rect(ctx, 1800, 1000, 60, 40)
        vg.fillPath(ctx, vg.color4ub(50 + 17 * (k % 12), 120, 200, 180),
                    vg.FillFlags.ConvexAA)
        return vg.end(ctx, background=bg)

    for k in range(3):
        np.asarray(frame_with_overlay(k)[0, 0])

    ctx.profiler.reset()
    N = 10
    rec_ms = 0.0
    imgs = []
    t_all = time.perf_counter()
    for k in range(N):
        t0 = time.perf_counter()
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        draw_benchmark_frame(ctx, 0.0)
        vg.beginPath(ctx)
        vg.rect(ctx, 1800, 1000, 60, 40)
        vg.fillPath(ctx, vg.color4ub(50 + 17 * ((k + 3) % 12), 120, 200, 180),
                    vg.FillFlags.ConvexAA)
        rec_ms += (time.perf_counter() - t0) * 1e3
        imgs.append(vg.end(ctx, background=bg))
    np.asarray(imgs[-1][0, 0])
    wall = (time.perf_counter() - t_all) * 1e3 / N

    rep = ctx.profiler.report()
    print(f"frames={rep['frames']}  record={rec_ms/N:.2f} ms  wall={wall:.2f} ms")
    for k, v in sorted(rep["ms_per_frame"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:18s} {v:8.2f} ms")
    print("counters:", {k: v for k, v in rep["counters"].items()
                        if "memo" in k or "hits" in k})

    if "--cprofile" in sys.argv:
        import cProfile
        import pstats

        pr = cProfile.Profile()
        pr.enable()
        for k in range(5):
            frame_with_overlay(k)
        pr.disable()
        pstats.Stats(pr).sort_stats("cumulative").print_stats(25)


if __name__ == "__main__":
    main()
