#!/usr/bin/env python
"""Benchmark: SVG tiger + demo UI @ 1080p (BASELINE.json north star).

Needs a GPU: without one it exits non-zero.  Everything runs in ONE JAX
process on the card; the optional CPU baseline runs in a child process with
JAX_PLATFORMS=cpu, which never touches the card.

Prints ONE JSON line:
  {"metric": ..., "value": ms_per_frame, "unit": "ms", "vs_baseline": x,
   "device_kind": ..., ...}

value    = steady-state device ms/frame of the resident scene (chained frames,
           raster/benchloop.py): full on-device raster (coverage + shade +
           composite) — the analogue of the reference's per-frame GPU
           submit+draw with Cacheable command lists.
baseline = the same steady-state frame on the CPU (XLA host backend, child
           process); the reference publishes no numbers (BASELINE.md).
vs_baseline = baseline_ms / value  (>1 means faster than the CPU baseline).

Cold-frame breakdown goes to stderr.  Per-layer cells and their spread are
not measured here yet.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


_PROBES = {}


def _probe_fn(n: int):
    """Jitted n-image fetch probe (one scalar depending on every frame);
    cached per n so its trace+compile never lands inside a timed loop."""
    import jax

    if n not in _PROBES:
        _PROBES[n] = jax.jit(lambda ims: sum(im[0, 0, 0] for im in ims))
    return _PROBES[n]


def run_loop(frame_fn, n: int, warm_img=None) -> float:
    """Pipelined render-loop timing: issue n frames back-to-back with NO
    per-frame host sync (render loops present asynchronously — the
    reference's bgfx swap is async too), then ONE fetch that depends on
    every frame's image.  Per-frame host work overlaps device execution of
    earlier frames, exactly as a production loop would run; the per-frame
    cost is the loop's throughput, not latency.  Returns mean ms/frame.

    warm_img: a same-shape image used to compile the fetch probe outside
    the timed window."""
    import numpy as np

    probe = _probe_fn(n)
    if warm_img is not None:
        np.asarray(probe([warm_img] * n))
    imgs = []
    t0 = time.perf_counter()
    for k in range(n):
        imgs.append(frame_fn(k))
    np.asarray(probe(imgs))
    return (time.perf_counter() - t0) * 1e3 / n


BG = (0.12, 0.12, 0.13, 1.0)


def measure(reps: int = 32, warmup: int = 3) -> dict:
    import numpy as np
    import vgtpu as vg
    from vgtpu.raster.benchloop import measure_device_ms_per_frame
    from vgtpu.scenes.demo_ui import draw_benchmark_frame

    # build-system warm-up OUTSIDE the timed record: the on-demand g++
    # builds (ctypes lib + CPython path recorder) cost 5-15 s on a fresh
    # checkout and are one-time artifacts, not per-frame engine work
    from vgtpu.native import available as _native_available, pathrec as _pathrec

    _native_available()
    _pathrec()

    ctx = vg.createContext()

    t0 = time.perf_counter()
    vg.begin(ctx, 0, 1920, 1080, 1.0)
    draw_benchmark_frame(ctx, 0.0)
    t1 = time.perf_counter()
    img = vg.end(ctx, background=BG)
    t_end = time.perf_counter()
    img.block_until_ready()
    t2 = time.perf_counter()
    # cold-start breakdown: device_dispatch covers the jit trace+compile
    # (persistent cache hits show up as a collapse there), first-wait is the
    # first execute after the upload
    stages = {k: round(v, 1) for k, v in ctx.profiler.times_ms.items()}
    cold_mb = ctx.profiler.counters.get("upload_bytes", 0) / 1e6
    print(f"[bench] cold breakdown: record={(t1 - t0) * 1e3:.0f} ms  "
          f"end-call={(t_end - t1) * 1e3:.0f} ms {stages}  "
          f"first-wait={(t2 - t_end) * 1e3:.0f} ms  "
          f"compile_cache={'off' if os.environ.get('VGTPU_NO_COMPILE_CACHE') else 'on'}  "
          f"scene_upload={cold_mb:.1f} MB", file=sys.stderr)

    plan = ctx.last_plan
    d = ctx.last_device_arrays

    # full dynamic frame (CHANGED content per frame -> frame-memo misses):
    # re-record + re-bin + re-upload + render (the reference's analogue is
    # CPU retessellation of non-cached content)
    def dyn_frame(k, eps=0.0):
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        draw_benchmark_frame(ctx, 0.05 * (k + 1) + eps)
        return vg.end(ctx, background=BG)

    # warm EVERY timed frame's padded bucket shapes first: animation sweeps
    # entry counts across {2^k, 1.5*2^k} bucket boundaries, and one
    # fresh-shape compile inside the timed loop would swamp the steady
    # throughput this stage measures.  The timed pass perturbs t by 1e-4 — a
    # distinct content fingerprint (frame-memo MISS, full
    # record+bin+upload per frame) with the same padded shapes.
    wimg = None
    for k in range(5):
        wimg = dyn_frame(k)
        wimg.block_until_ready()
    dynamic_ms = run_loop(lambda k: dyn_frame(k, eps=1e-4), 5, warm_img=wimg)

    # identical-content redraw (frame-memo hits): record + fingerprint +
    # resident-plan dispatch — the common app pattern
    def redraw_frame(_k):
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        draw_benchmark_frame(ctx, 0.0)
        return vg.end(ctx, background=BG)

    redraw_frame(0).block_until_ready()
    redraw_ms = run_loop(redraw_frame, 5, warm_img=wimg)

    # paint-only animation (color/alpha values change, geometry does not):
    # the paint_memo patch path — record + fingerprint + ~KB paint upload +
    # dispatch, no bin/sample/upload (context._value_only_update)
    def frame_with_overlay(k):
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        draw_benchmark_frame(ctx, 0.0)
        vg.beginPath(ctx)
        vg.rect(ctx, 1800, 1000, 60, 40)
        vg.fillPath(ctx, vg.color4ub(50 + 17 * k, 120, 200, 180),
                    vg.FillFlags.ConvexAA)
        return vg.end(ctx, background=BG)

    frame_with_overlay(0).block_until_ready()   # new geometry: full bin
    frame_with_overlay(-3).block_until_ready()  # first patch frame
    paint_hits0 = ctx.profiler.counters.get("memo_paint_hits", 0)
    anim_ms = run_loop(lambda k: frame_with_overlay(k + 1), 5, warm_img=wimg)
    anim_hits = ctx.profiler.counters.get("memo_paint_hits", 0) - paint_hits0

    # app pattern (the reference's intended usage, vg.cpp:4287-4300): static
    # artwork in a Cacheable command list, dynamic UI immediate — cached
    # replay + incremental rebin do the heavy lifting
    from vgtpu.scenes.demo_ui import draw_demo_ui
    from vgtpu.scenes.tiger import draw_tiger

    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    vg.beginCommandList(ctx, cl)
    draw_tiger(ctx, 20, 60, 1.06)
    vg.endCommandList(ctx)

    def app_frame(k, eps=0.0):
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        vg.submitCommandList(ctx, cl)
        draw_demo_ui(ctx, 0.3 + 0.05 * k + eps)
        return vg.end(ctx, background=BG)

    for k in range(6):   # cache build + layer bake settle + shape warm
        app_frame(k).block_until_ready()
    app_ms = run_loop(lambda k: app_frame(k, eps=1e-4), 6, warm_img=wimg)

    # chained on-device loop (raster/benchloop.py)
    frame_ms = measure_device_ms_per_frame(plan, d, BG, reps_hi=reps, reps_lo=warmup)
    return {
        "record_ms": (t1 - t0) * 1e3,
        "cold_bin_exec_ms": (t2 - t1) * 1e3,
        "frame_ms": frame_ms,
        "dynamic_ms": dynamic_ms,
        "redraw_ms": redraw_ms,
        "anim_ms": anim_ms,
        "anim_paint_hits": anim_hits,
        "app_ms": app_ms,
        "cold_upload_mb": cold_mb,
        "stats": plan.stats,
    }


def pan_ms() -> dict:
    """Translated cached list: the tiger list submitted under a moving
    translation with the demo UI on top -> {"pan_ms", "layer_cl_hits"}."""
    import vgtpu as vg
    from vgtpu.scenes.demo_ui import draw_demo_ui
    from vgtpu.scenes.tiger import draw_tiger

    ctx = vg.createContext()
    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    vg.beginCommandList(ctx, cl)
    draw_tiger(ctx, 20, 60, 1.06)
    vg.endCommandList(ctx)

    def frame(k):
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        vg.pushState(ctx)
        vg.transformTranslate(ctx, 2.5 * k, 2 * k)
        vg.submitCommandList(ctx, cl)
        vg.popState(ctx)
        # UI content CYCLES over warmed values: the moving view alone makes
        # every frame's fingerprint fresh (layer token), so cycling keeps
        # padded bucket shapes warm — an unbounded 0.05*k sweep can cross a
        # {2^k,1.5*2^k} boundary and compile INSIDE the timed loop
        draw_demo_ui(ctx, 0.3 + 0.05 * (k % 4))
        return vg.end(ctx, background=BG)

    # frames 0-3 cover cache build, first cached replay, the moved replay
    # that requests the bake, and the bake+compile frame; frames 4-7 settle
    # the static-UI overlay layer (two stable-prefix frames -> transparent
    # bake -> first blended dispatch compile) — steady is 8+
    wimg = None
    for k in range(8):
        wimg = frame(k)
        wimg.block_until_ready()
    return {"pan_ms": run_loop(lambda k: frame(k + 8), 5, warm_img=wimg),
            "layer_cl_hits": ctx.profiler.counters.get("layer_cl_hits", 0)}


def ss2_ms() -> float:
    """Parity-mode (coverage_supersample=2) steady-state frame: the
    conflation-free mode whose output matches the reference's mesh
    semantics.  Median of 3 chained device measurements."""
    import vgtpu as vg
    from vgtpu.raster.benchloop import measure_device_ms_per_frame
    from vgtpu.scenes.demo_ui import draw_benchmark_frame

    ctx = vg.createContext(vg.ContextConfig(coverage_supersample=2))
    vg.begin(ctx, 0, 1920, 1080, 1.0)
    draw_benchmark_frame(ctx, 0.0)
    vg.end(ctx, background=BG).block_until_ready()
    runs = sorted(
        measure_device_ms_per_frame(ctx.last_plan, ctx.last_device_arrays,
                                    BG, reps_hi=64, reps_lo=3)
        for _ in range(3))
    return runs[1]


def batch_ms(k: int = 6, reps_hi: int = 8) -> float:
    """K overlay-colour variants of the benchmark frame in one program:
    chained device ms per variant frame."""
    import vgtpu as vg
    from vgtpu.raster.batch import VariantBatch, measure_batch_ms_per_frame
    from vgtpu.scenes.demo_ui import draw_benchmark_frame

    def variant(k):
        def f(c):
            draw_benchmark_frame(c, 0.0)
            vg.beginPath(c)
            vg.rect(c, 1800, 1000, 60, 40)
            vg.fillPath(c, vg.color4ub(50 + 17 * k, 120, 200, 180),
                        vg.FillFlags.ConvexAA)
        return f

    vb = VariantBatch.bake(vg.createContext(), [variant(i) for i in range(k)],
                           1920, 1080, background=BG)
    return measure_batch_ms_per_frame(vb, background=BG, reps_hi=reps_hi,
                                      reps_lo=2)


def main() -> None:
    if "--cpu-baseline" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        print(json.dumps(measure(reps=5, warmup=2)))
        return

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"[bench] needs a GPU; JAX found {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()

    # CPU baseline: a child pinned to the CPU backend, so this process
    # stays the only one on the card
    cpu_ms = None
    if "--no-cpu-baseline" not in sys.argv:
        try:
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--cpu-baseline"],
                capture_output=True, text=True, timeout=1800, env=env,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            )
            if out.returncode != 0:
                raise RuntimeError(
                    f"baseline subprocess rc={out.returncode}: {out.stderr[-800:]}")
            cpu_ms = json.loads(out.stdout.strip().splitlines()[-1])["frame_ms"]
            print(f"[bench] cpu baseline frame={cpu_ms:.3f} ms", file=sys.stderr)
        except Exception as e:  # noqa: BLE001 - the card numbers still stand
            print(f"[bench] cpu baseline failed: {e}", file=sys.stderr)

    r = measure()
    r["ss2_ms"] = ss2_ms()
    r["batch_ms"] = batch_ms()
    r.update(pan_ms())
    print(f"[bench] {dev.device_kind} ({smi}) frame={r['frame_ms']:.3f} ms  "
          f"ss2={r['ss2_ms']:.3f} ms  batch={r['batch_ms']:.3f} ms/variant  "
          f"dynamic={r['dynamic_ms']:.1f} ms  app={r['app_ms']:.1f} ms  "
          f"redraw={r['redraw_ms']:.1f} ms  anim={r['anim_ms']:.1f} ms "
          f"(paint hits {r['anim_paint_hits']}/5)  pan={r['pan_ms']:.1f} ms "
          f"(layer hits {r['layer_cl_hits']})  record={r['record_ms']:.1f} ms  "
          f"cold={r['cold_bin_exec_ms']:.1f} ms  stats={r['stats']}",
          file=sys.stderr)
    vs = None if cpu_ms is None else cpu_ms / r["frame_ms"]
    print(json.dumps({
        "metric": "ms/frame SVG-tiger+demo-UI 1080p, on-device raster (steady-state)",
        "value": round(r["frame_ms"], 3),
        "unit": "ms",
        "vs_baseline": round(vs, 3) if vs is not None else None,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi": smi,
        # parity-mode (conflation-free, reference-mesh-equivalent) frame
        "frame_ms_ss2": round(r["ss2_ms"], 3),
        "batch_ms": round(r["batch_ms"], 3),
        "cold_upload_mb": round(r["cold_upload_mb"], 1),
        "cold_ms": round(r["cold_bin_exec_ms"], 1),
        **{f"{k}_ms": round(r[f"{k}_ms"], 1)
           for k in ("record", "dynamic", "redraw", "anim", "app", "pan")},
        "pan_layer_hits": r["layer_cl_hits"],
    }))


if __name__ == "__main__":
    main()
