"""Host-side stage attribution for the pan-vs-app gap (VERDICT r05 #3).

Runs the bench's exact app pattern (static tiger list + dynamic demo UI)
and pan pattern (translated tiger list + the same UI) on ANY platform and
prints per-steady-frame profiler stages + counters.  The host stages
(record / fingerprint / finalize / bin / textures / upload-prep) run on the
host whatever the device; only upload.put and device_dispatch need the GPU
for their times.

Usage: python tools/pan_app_host_probe.py
"""
from __future__ import annotations

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np
import vgtpu as vg
from vgtpu.scenes.demo_ui import draw_demo_ui
from vgtpu.scenes.tiger import draw_tiger

BG = (0.12, 0.12, 0.13, 1.0)
STEADY = 5


def run(pattern: str) -> dict:
    ctx = vg.createContext()
    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    vg.beginCommandList(ctx, cl)
    draw_tiger(ctx, 20, 60, 1.06)
    vg.endCommandList(ctx)

    def frame(k):
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        if pattern == "pan":
            vg.pushState(ctx)
            vg.transformTranslate(ctx, 2.5 * k, 2 * k)
            vg.submitCommandList(ctx, cl)
            vg.popState(ctx)
            draw_demo_ui(ctx, 0.3 + 0.05 * k)
        else:
            vg.submitCommandList(ctx, cl)
            draw_demo_ui(ctx, 0.3 + 0.05 * k + 1e-4)
        return vg.end(ctx, background=BG)

    for k in range(6):
        np.asarray(frame(k)[0, 0])

    t_all = ctx.profiler.times_ms.copy()
    c_all = ctx.profiler.counters.copy()
    t0 = time.perf_counter()
    per_frame_ops = []
    for k in range(STEADY):
        frame(k + 6)
        per_frame_ops.append(len(ctx.ops))
    wall = (time.perf_counter() - t0) * 1e3 / STEADY
    stages = {k: round((v - t_all.get(k, 0.0)) / STEADY, 2)
              for k, v in ctx.profiler.times_ms.items()
              if v - t_all.get(k, 0.0) > 0.005 * STEADY}
    counters = {k: v - c_all.get(k, 0)
                for k, v in ctx.profiler.counters.items()
                if v != c_all.get(k, 0)}
    # finalize detail: how many suffix ops still carry deferred geometry
    ctx2_ops = ctx.ops
    deferred = sum(1 for op in ctx2_ops if op.geom is not None)
    return {
        "pattern": pattern,
        "wall_ms_per_frame": round(wall, 2),
        "stages_ms": dict(sorted(stages.items(), key=lambda kv: -kv[1])),
        "counters_per_loop": counters,
        "ops_per_frame": per_frame_ops[-1],
        "suffix_ops_deferred_geom": deferred,
    }


if __name__ == "__main__":
    for pat in ("app", "pan"):
        print(json.dumps(run(pat)), flush=True)
