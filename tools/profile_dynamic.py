#!/usr/bin/env python
"""Break down the dynamic-frame (changed content) cost: record / geometry /
bin / sampling / upload / dispatch.  Run from the repository root on the
GPU (python tools/profile_dynamic.py)."""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import vgtpu as vg
from vgtpu.scenes.demo_ui import draw_benchmark_frame


def main() -> None:
    ctx = vg.createContext()
    bg = (0.12, 0.12, 0.13, 1.0)

    # warm: resident plan + compiled programs
    for k in range(3):
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        draw_benchmark_frame(ctx, 0.05 * k)
        vg.end(ctx, background=bg).block_until_ready()

    prof = ctx.profiler
    prof.reset()
    reps = 10
    t0 = time.perf_counter()
    rec_ms = end_ms = 0.0
    for k in range(reps):
        ta = time.perf_counter()
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        draw_benchmark_frame(ctx, 0.3 + 0.05 * k)
        tb = time.perf_counter()
        img = vg.end(ctx, background=bg)
        img.block_until_ready()
        tc = time.perf_counter()
        rec_ms += (tb - ta) * 1e3
        end_ms += (tc - tb) * 1e3
        print(f"  rep {k}: record={1e3 * (tb - ta):6.1f}  end={1e3 * (tc - tb):7.1f} ms")
    total = (time.perf_counter() - t0) * 1e3 / reps
    print(f"dynamic total      : {total:.1f} ms/frame")
    print(f"  record (python)  : {rec_ms / reps:.1f} ms")
    print(f"  end() total      : {end_ms / reps:.1f} ms")
    for name, ms in sorted(prof.times_ms.items()):
        print(f"    {name:<22}: {ms / reps:6.1f} ms")
    for name, v in sorted(prof.counters.items()):
        print(f"    {name:<22}= {v}")


if __name__ == "__main__":
    main()
