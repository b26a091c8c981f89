#!/usr/bin/env python
"""Coverage formulations timed on the benchmark frame's real chunk pools.

  scan       the lax.scan over edge slots (ops/coverage.coverage_chunks_body):
             the accumulator goes back to memory after every slot;
  fused      the slot terms summed in slot order as one elementwise
             expression (ops/coverage.coverage_chunks_broadcast — the one
             the frame uses);
  reduction  all (chunk, slot, pixel) terms broadcast and summed with one
             jnp.sum over the slot axis (XLA picks the summation order).

For the 1920x1080 benchmark frame at coverage_supersample 1 and 2 it prints
the time of each formulation alone (ten evaluations chained in one jit,
summed over the frame's pools) and the median time of the whole frame
program with each formulation substituted into ops/coverage.chunk_coverage,
in interleaved rounds.  Needs a GPU.  Run from the repo root:

    python tools/exp_coverage.py [--rounds 8] [--out exp_coverage.json]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time


def _median_ms(fn, reps: int, per_call: int = 1) -> float:
    fn().block_until_ready()              # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        ts.append((time.perf_counter() - t0) * 1e3 / per_call)
    return statistics.median(ts)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--out", help="also write the whole record here as JSON")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax
    import jax.numpy as jnp
    import numpy as np

    import vgtpu as vg
    from vgtpu import chipcheck as cc
    from vgtpu.ops import coverage as cov
    from vgtpu.raster import frame as frame_mod
    from vgtpu.scenes.demo_ui import draw_benchmark_frame

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    rec = {"device_kind": dev.device_kind, "nvidia_smi": cc.nvidia_smi(),
           "jax": jax.__version__}
    print(json.dumps(rec), flush=True)

    def reduction(ce, th, tw):
        px = jax.lax.broadcasted_iota(jnp.float32, (th, tw), 1)
        py = jax.lax.broadcasted_iota(jnp.float32, (th, tw), 0)
        e = ce[:, :, :, None, None]
        terms = cov._edge_contribution(px, py, e[:, :, 0], e[:, :, 1],
                                       e[:, :, 2], e[:, :, 3])
        return jnp.sum(terms, axis=1).reshape(ce.shape[0], th * tw)

    forms = {
        "scan": lambda ce, th, tw: cov.coverage_chunks_body(ce, th, tw).reshape(
            ce.shape[0], -1),
        "fused": cov.coverage_chunks_broadcast,
        "reduction": reduction,
    }
    for ss in (1, 2):
        ctx = vg.createContext(vg.ContextConfig(coverage_supersample=ss))
        vg.begin(ctx, 0, 1920, 1080, 1.0)
        draw_benchmark_frame(ctx, 0.0)
        vg.end(ctx, background=cc.BG)
        plan, d = ctx.last_plan, ctx.last_device_arrays
        th, tw = plan.tile_h, plan.tile_w
        pools = [ce for ce, _ in d["chunk_pools"]]

        alone = {}
        for name, f in forms.items():
            def chain(ce, f=f):
                def body(i, eps):
                    return jnp.sum(f(ce + eps, th, tw)[:, ::97]) * 1e-9
                return jax.lax.fori_loop(0, 10, body, jnp.float32(0.0))
            jf = jax.jit(chain)
            alone[name] = sum(_median_ms(lambda ce=ce: jf(ce), 15, per_call=10)
                              for ce in pools)
        row = {"ss": ss, "pools": [list(ce.shape) for ce in pools],
               "alone_ms_sum_over_pools": alone}

        statics = dict(frame_mod._plan_statics(plan, d))
        fargs = (d["chunk_pools"], d["entry_backdrop"],
                 frame_mod.composite_arrays(d),
                 jnp.asarray(np.asarray(cc.BG, np.float32)))
        compiled = {}
        orig = cov.chunk_coverage
        try:
            for name, f in forms.items():
                cov.chunk_coverage = f
                compiled[name] = jax.jit(functools.partial(
                    frame_mod._frame_body, **statics)).lower(*fargs).compile()
        finally:
            cov.chunk_coverage = orig
        ref = np.asarray(compiled["scan"](*fargs))
        row["frame_max_diff_vs_scan"] = {
            n: float(np.abs(np.asarray(f(*fargs)) - ref).max())
            for n, f in compiled.items()}
        runs = {n: [] for n in forms}
        for rnd in range(args.rounds):
            order = list(forms) if rnd % 2 == 0 else list(forms)[::-1]
            for n in order:
                runs[n].append(_median_ms(lambda n=n: compiled[n](*fargs), 40))
        row["frame_ms_rounds"] = runs
        row["frame_ms_median"] = {n: statistics.median(v) for n, v in runs.items()}
        rec[f"ss{ss}"] = row
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
