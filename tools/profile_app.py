"""Host-stage profile of the bench app pattern (cached tiger list +
immediate UI) — where does the steady app frame's host time go?

Runs on the CPU platform (JAX_PLATFORMS=cpu) so device dispatch is local;
the interesting output is the per-stage HOST ms (record / layer / bin /
textures / upload / dispatch).  Host times vary between machines;
compare runs made on one machine.

Usage: JAX_PLATFORMS=cpu python tools/profile_app.py
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import vgtpu as vg
from vgtpu.scenes.demo_ui import draw_demo_ui
from vgtpu.scenes.tiger import draw_tiger


def main() -> None:
    bg = (0.12, 0.12, 0.13, 1.0)
    ctx = vg.createContext()
    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    vg.beginCommandList(ctx, cl)
    draw_tiger(ctx, 20, 60, 1.06)
    vg.endCommandList(ctx)

    def app_frame(k, eps=0.0):
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        t0 = time.perf_counter()
        vg.submitCommandList(ctx, cl)
        t1 = time.perf_counter()
        draw_demo_ui(ctx, 0.3 + 0.05 * k + eps)
        t2 = time.perf_counter()
        img = vg.end(ctx, background=bg)
        return img, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    # warm: cache build + layer bake settle + shape compiles
    for k in range(6):
        img, _, _ = app_frame(k)
        np.asarray(img[0, 0])

    ctx.profiler.reset()
    sub_ms = ui_ms = 0.0
    N = 10
    imgs = []
    for k in range(N):
        img, s, u = app_frame(k, eps=1e-4)
        sub_ms += s
        ui_ms += u
        imgs.append(img)
    # fetch once at the end — steady host cost is what we're profiling
    np.asarray(imgs[-1][0, 0])

    rep = ctx.profiler.report()
    print(f"frames={rep['frames']}  submitCL={sub_ms/N:.2f} ms  "
          f"drawUI={ui_ms/N:.2f} ms")
    total = 0.0
    for k, v in sorted(rep["ms_per_frame"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:18s} {v:8.2f} ms")
        total += v
    print(f"  {'TOTAL(end)':18s} {total:8.2f} ms")
    print("counters:", {k: v for k, v in rep["counters"].items()
                        if "layer" in k or "bin" in k or "memo" in k})
    n_ops = len(ctx.ops)
    print(f"ops/frame={n_ops}  layer_prefix={ctx._layer_used}")


if __name__ == "__main__":
    main()
