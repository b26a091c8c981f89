"""Frame executor: FramePlan -> framebuffer (the device side of end(),
vg.cpp:1076-1288, minus bgfx: upload arrays once, run the jitted pipeline)."""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from vgtpu.ops.composite import composite_bucketed_body, tiles_to_image
from vgtpu.ops.coverage import entry_coverage_from_pools
from vgtpu.raster.binning import FramePlan, compute_tile_buckets


def _frame_body(
    chunk_pools, entry_backdrop, d, background,
    *, num_entries, ntx, nty, tile_h, tile_w, width, height, bucket_flags=None,
    ss=1, init_tiles=None,
):
    """The whole device frame (unjitted body — _frame_fn compiles it alone;
    execute_plans compiles several plans' bodies into one program)."""
    fb = _frame_tiles_body(
        chunk_pools, entry_backdrop, d, background,
        num_entries=num_entries, ntx=ntx, nty=nty, tile_h=tile_h,
        tile_w=tile_w, bucket_flags=bucket_flags, ss=ss,
        init_tiles=init_tiles,
    )
    return tiles_to_image(fb, ntx=ntx, nty=nty, tile_h=tile_h // ss,
                          tile_w=tile_w, width=width, height=height)


def _frame_tiles_body(
    chunk_pools, entry_backdrop, d, background,
    *, num_entries, ntx, nty, tile_h, tile_w, bucket_flags=None,
    ss=1, init_tiles=None,
):
    """Frame pipeline up to (T, TH//ss, TW, 4) tiles (no image assembly) —
    the layer-memo bake keeps these resident and later frames composite
    their dynamic suffix over them (init_tiles): entry coverage, then the
    XLA composite."""
    entry_cov = entry_coverage_from_pools(chunk_pools, num_entries, tile_h,
                                          tile_w)
    entry_w = entry_cov + entry_backdrop[:, :, None]
    return composite_bucketed_body(
        entry_w, d["tile_buckets"],
        d["entry_kind"], d["entry_rule"], d["entry_aa"], d["entry_paint_kind"],
        d["entry_paint"], d["entry_scissor"], d["entry_color_tile"],
        d["color_tiles"], background,
        ntx=ntx, tile_h=tile_h, tile_w=tile_w, num_tiles=ntx * nty,
        bucket_flags=bucket_flags, ss=ss, init_tiles=init_tiles,
    )


_frame_fn = functools.partial(
    jax.jit,
    static_argnames=("num_entries", "ntx", "nty", "tile_h", "tile_w", "width",
                     "height", "bucket_flags", "ss"),
)(_frame_body)

_frame_tiles_fn = functools.partial(
    jax.jit,
    static_argnames=("num_entries", "ntx", "nty", "tile_h", "tile_w",
                     "bucket_flags", "ss"),
)(_frame_tiles_body)


@functools.partial(jax.jit, static_argnames=("statics_t",))
def _frames_fn(groups, backgrounds, *, statics_t):
    """K independent resident frames compiled into ONE program (multi-canvas
    serving): one dispatch instead of K.  backgrounds: one (K, 4) array (a single
    upload; K separate puts would eat the saving)."""
    return tuple(
        _frame_body(pools, ebd, d, backgrounds[i], init_tiles=init,
                    **dict(st))
        for i, ((pools, ebd, d, init), st) in enumerate(zip(groups, statics_t)))


_COMPOSITE_KEYS = (
    "tile_buckets", "entry_kind", "entry_rule", "entry_aa", "entry_paint_kind",
    "entry_paint", "entry_scissor", "entry_color_tile", "color_tiles",
)


def composite_arrays(d: dict) -> dict:
    """The array-only sub-dict the composite consumes (jit pytree)."""
    return {k: d[k] for k in _COMPOSITE_KEYS if k in d}


def _plan_statics(plan: FramePlan, d: dict) -> tuple:
    """The frame body's static kwargs as a hashable sorted tuple — the ONE
    definition shared by execute_plan and execute_plans (drift between the
    two paths would make fused renders diverge from single renders)."""
    return tuple(sorted(dict(
        num_entries=d["chunk_entry_num"], ntx=plan.ntx, nty=plan.nty,
        tile_h=plan.tile_h, tile_w=plan.tile_w,
        width=plan.width, height=plan.height,
        bucket_flags=d["bucket_flags"], ss=plan.supersample,
    ).items()))


def execute_plan(plan: FramePlan, background=(1.0, 1.0, 1.0, 1.0),
                 device_arrays=None, init_tiles=None) -> jax.Array:
    """Run the device pipeline; returns (H, W, 4) premultiplied f32 RGBA.

    init_tiles: optional resident static layer (execute_plan_tiles output)
    the plan composites over instead of the background."""
    d = device_arrays if device_arrays is not None else plan_to_device(plan)
    args = (d["chunk_pools"], d["entry_backdrop"], composite_arrays(d),
            jnp.asarray(np.asarray(background, np.float32)))
    statics = dict(_plan_statics(plan, d))
    return _frame_fn(*args, init_tiles=init_tiles, **statics)


def execute_plan_tiles(plan: FramePlan, background=(1.0, 1.0, 1.0, 1.0),
                       device_arrays=None) -> jax.Array:
    """Render a plan to its (T, TH//ss, TW, 4) tile framebuffer — the
    layer-memo bake (api/context): later frames pass this as init_tiles."""
    d = device_arrays if device_arrays is not None else plan_to_device(plan)
    statics = dict(_plan_statics(plan, d))
    statics.pop("width")
    statics.pop("height")
    return _frame_tiles_fn(
        d["chunk_pools"], d["entry_backdrop"], composite_arrays(d),
        jnp.asarray(np.asarray(background, np.float32)),
        **statics,
    )


def execute_plans(plans_arrays, backgrounds, init_tiles=None) -> tuple:
    """Render K resident (plan, device_arrays) pairs as ONE device program
    -> tuple of (H_k, W_k, 4) images.  The multi-canvas serving analogue of
    execute_plan: the scenes are independent (different geometry, sizes,
    configs), but fusing their dispatch pays the per-dispatch cost once,
    and XLA schedules the K pipelines together."""
    plans_arrays = list(plans_arrays)
    backgrounds = list(backgrounds)
    if len(backgrounds) != len(plans_arrays):
        raise ValueError(f"{len(backgrounds)} backgrounds for "
                         f"{len(plans_arrays)} plans")
    if init_tiles is None:
        init_tiles = [None] * len(plans_arrays)
    groups, statics = [], []
    for (plan, d), init in zip(plans_arrays, init_tiles):
        groups.append((d["chunk_pools"], d["entry_backdrop"],
                       composite_arrays(d), init))
        statics.append(_plan_statics(plan, d))
    bgs = jnp.asarray(np.asarray(backgrounds, np.float32))   # one (K,4) put
    return _frames_fn(tuple(groups), bgs, statics_t=tuple(statics))


@functools.partial(jax.jit, static_argnames=("sig",))
def _arena_unpack(arena, *, sig):
    """Slice the packed upload arena back into per-leaf device arrays.
    sig: tuple of (flat_offset, shape, dtype_str) — static, so one compiled
    program per plan shape signature ({2^k,1.5*2^k} bucketing keeps the
    signature count bounded)."""
    outs = []
    for off, shape, dstr in sig:
        n = 1
        for s in shape:
            n *= s
        seg = jax.lax.slice(arena, (off,), (off + n,))
        dt = np.dtype(dstr)
        if dt != arena.dtype:
            seg = jax.lax.bitcast_convert_type(seg, dt)
        outs.append(seg.reshape(shape))
    return outs


def _arena_put(host):
    """Single-transfer upload of a plan's host pytree: every 4-byte numpy
    leaf ships inside ONE int32 arena (one host-to-device copy instead of
    ~40 for a dynamic frame's plan), then one jitted unpack slices the
    leaves back out on device.  Device-resident leaves
    (e.g. device-sampled color tiles) and odd-size dtypes pass through a
    plain device_put.  Opt out with VGTPU_NO_ARENA_PUT=1."""
    import os

    leaves, treedef = jax.tree_util.tree_flatten(host)
    np_idx = [i for i, x in enumerate(leaves)
              if isinstance(x, np.ndarray) and x.dtype.itemsize == 4]
    if len(np_idx) < 8 or os.environ.get("VGTPU_NO_ARENA_PUT"):
        return jax.device_put(host)
    metas = []
    chunks = []
    off = 0
    for i in np_idx:
        x = leaves[i]
        flat = np.ascontiguousarray(x).reshape(-1).view(np.int32)
        metas.append((off, x.shape, x.dtype.str))
        chunks.append(flat)
        off += flat.size
    arena = np.concatenate(chunks)
    unpacked = _arena_unpack(arena, sig=tuple(metas))
    for i, dev in zip(np_idx, unpacked):
        leaves[i] = dev
    rest = [i for i in range(len(leaves)) if i not in set(np_idx)
            and not isinstance(leaves[i], jax.Array)]
    if rest:
        put = jax.device_put([leaves[i] for i in rest])
        for i, dev in zip(rest, put):
            leaves[i] = dev
    return jax.tree_util.tree_unflatten(treedef, leaves)


def plan_to_device(plan: FramePlan, profiler=None) -> dict:
    """Upload the plan's arrays once (command lists / caches stay resident)
    in ONE packed transfer (_arena_put).

    profiler: optional FrameProfiler for sub-stage attribution (upload.*)."""
    import contextlib

    stage = profiler.stage if profiler is not None else (
        lambda _n: contextlib.nullcontext())
    with stage("upload.buckets"):
        if plan.tile_buckets is None:
            plan.tile_buckets = compute_tile_buckets(
                plan.tile_entries, plan.tile_entries.shape[0], plan.entry_kind,
                plan
            )
    with stage("upload.compact"):
        _compact_culled_chunks(plan)
    host = {
        "chunk_pools": tuple((ce, cent) for ce, cent in plan.chunk_pools),
        "entry_backdrop": plan.entry_backdrop,
        "entry_kind": plan.entry_kind,
        "entry_rule": plan.entry_rule,
        "entry_aa": plan.entry_aa,
        "entry_paint_kind": plan.entry_paint_kind,
        "entry_paint": plan.entry_paint,
        "entry_scissor": plan.entry_scissor,
        "entry_color_tile": plan.entry_color_tile,
        "color_tiles": plan.color_tiles,
        "tile_entries": plan.tile_entries,
        "tile_buckets": tuple(
            (te, ids) for te, ids, _fl in plan.tile_buckets
        ),
    }
    if profiler is not None:
        # honest cold/dynamic accounting: bytes that actually cross the
        # host->device link this frame (device-resident leaves are free)
        leaves = jax.tree_util.tree_leaves(host)
        profiler.count("upload_bytes", sum(
            x.nbytes for x in leaves
            if isinstance(x, np.ndarray)))
    with stage("upload.put"):
        d = _arena_put(host)
    d["chunk_entry_num"] = plan.entry_backdrop.shape[0]
    d["bucket_flags"] = tuple(fl for _te, _ids, fl in plan.tile_buckets)
    return d


def _bucket128(n: int) -> int:
    """128-aligned pool size with PROPORTIONAL quantization: the step grows
    with the size (128 up to 1k, 256 to 2k, 512 to 4k, then 1024) — at most
    8 sizes per octave, padding waste typically a few % (worst ~50% only for
    tiny pools just over 128; raw {2^k,1.5*2^k} buckets waste up to 33% of
    coverage slots) while bounding
    the number of distinct jit signatures a drifting dynamic scene can mint
    (raw 128-multiples mint one per boundary crossing)."""
    n = max(n, 1)
    step = 128
    while step * 8 < n:
        step *= 2
    return -(-n // step) * step


def _compact_culled_chunks(plan: FramePlan) -> None:
    """Drop chunks whose entry no bucket references (occlusion / static-clip
    culled draws): their coverage would be computed and never gathered.
    Pads pools to 128-chunk multiples (_bucket128); pad chunks are all-zero
    edges -> exactly zero coverage by the binning invariant, so pointing
    them at any entry is harmless."""
    if plan.stats.get("chunks_compacted"):
        return
    plan.stats["chunks_compacted"] = True
    ne = plan.entry_backdrop.shape[0]
    ref = np.zeros(ne, bool)
    for te_b, _ids, _fl in plan.tile_buckets:
        ref[te_b[te_b >= 0]] = True
    new_pools = []
    live = 0
    for ce, cent in plan.chunk_pools:
        ce = np.asarray(ce)
        cent = np.asarray(cent)
        keep = (cent >= 0) & (cent < ne) & ref[np.clip(cent, 0, ne - 1)]
        ce2, cent2 = ce[keep], cent[keep]
        live += len(ce2)
        # 128-aligned proportional-step padding (see _bucket128): a relaxed
        # form of the {2^k, 1.5*2^k} invariant for compacted pools only —
        # raw buckets waste up to 33% of coverage slots here
        nc = _bucket128(len(ce2))
        cep = np.zeros((nc,) + ce.shape[1:], ce.dtype)
        cep[: len(ce2)] = ce2
        centp = np.full(nc, ne - 1, cent.dtype)
        centp[: len(cent2)] = cent2
        new_pools.append((cep, centp))
    plan.stats["chunks_live"] = live
    plan.chunk_pools = new_pools


def image_to_u8(img) -> np.ndarray:
    """Premultiplied f32 -> straight u8 RGBA."""
    img = np.asarray(img)
    a = np.maximum(img[..., 3:4], 1e-6)
    rgb = np.clip(img[..., 0:3] / a, 0.0, 1.0)
    out = np.concatenate([rgb, np.clip(img[..., 3:4], 0.0, 1.0)], axis=-1)
    return (out * 255.0 + 0.5).astype(np.uint8)
