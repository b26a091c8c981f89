"""Device timing of the frame program: N chained frames in one jitted
fori_loop.

Every iteration perturbs the edge buffer with a scalar derived from the
previous frame's pixels — a true serial dependency through the ENTIRE
pipeline (coverage included), so XLA can neither hoist loop-invariant stages
nor dedupe frames, and the final scalar fetch forces completion of all N
frames.  Two loop lengths difference out the dispatch and fetch overhead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vgtpu.ops.coverage import entry_coverage_from_pools


@functools.partial(
    jax.jit,
    static_argnames=("n_frames", "ntx", "num_tiles", "tile_h", "tile_w",
                     "num_entries", "bucket_flags", "ss"),
)
def chained_frames(
    chunk_pools, entry_backdrop, d, background,
    *, n_frames: int, ntx: int, num_tiles: int, tile_h: int, tile_w: int,
    num_entries: int, bucket_flags=None, ss: int = 1,
):
    from vgtpu.raster.frame import _frame_fn

    nty = num_tiles // ntx
    # tile_h counts SUB-rows when supersampling; the image is output-res
    width, height = ntx * tile_w, nty * (tile_h // ss)

    def body(i, eps):
        pools = tuple((ce + eps, cent) for ce, cent in chunk_pools)
        # the PRODUCTION frame program (incl. image assembly), not a
        # lookalike
        img = _frame_fn(
            pools, entry_backdrop, d, background + eps,
            num_entries=num_entries, ntx=ntx, nty=nty, tile_h=tile_h,
            tile_w=tile_w, width=width, height=height,
            bucket_flags=bucket_flags, ss=ss,
        )
        # fold EVERY pixel back into the next frame's inputs: a single-tile
        # probe lets XLA dead-code-eliminate buckets that tile does not touch
        return jnp.sum(img[..., 3]) * 1e-9

    return jax.lax.fori_loop(0, n_frames, body, jnp.float32(0.0))


def measure_device_ms_per_frame(plan, d, background, reps_hi=32, reps_lo=2) -> float:
    """Run chained loops of two lengths and difference out fixed overhead."""
    import time

    import numpy as np

    from vgtpu.raster.frame import composite_arrays

    args = (
        d["chunk_pools"], d["entry_backdrop"], composite_arrays(d),
        jnp.asarray(np.asarray(background, np.float32)),
    )
    kw = dict(
        ntx=plan.ntx, num_tiles=plan.tile_entries.shape[0],
        tile_h=plan.tile_h, tile_w=plan.tile_w,
        num_entries=d["entry_backdrop"].shape[0],
        bucket_flags=d["bucket_flags"], ss=plan.supersample,
    )

    def run(n):
        out = chained_frames(*args, n_frames=n, **kw)
        return float(np.asarray(out))  # scalar fetch = full sync

    run(reps_lo)  # compile both variants
    run(reps_hi)
    t0 = time.perf_counter()
    run(reps_lo)
    t1 = time.perf_counter()
    run(reps_hi)
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (reps_hi - reps_lo) * 1e3
