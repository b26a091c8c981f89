"""Batched variant rendering: K value-variants of one scene in ONE program.

The serving / throughput mode.  The reference renders frames strictly one at
a time (vg.cpp:1076-1288 submits each frame's command list to bgfx); an
accelerator wants the opposite — big, batched, launch-amortized work.  Here
the batch axis folds into the composite's ENTRY and TILE axes, which the
engine already treats as fully independent:

  * geometry is identical across variants, so chunk coverage — the whole
    winding stage — is computed ONCE and tiled K times;
  * per-entry value tables (the analogue of per-draw uniforms,
    fs_color_gradient.sc / vs_image_pattern.sc) concatenate per variant, so
    each composite bucket runs once over K variants' tiles;
  * color tiles (text / pattern pre-samples) stack per variant.

What may vary between variants is exactly what the paint-value memo patch
(Context._value_only_update) accepts: solid/gradient paint rows (same
opacity class) and texture/pattern/text-color values — i.e. color, alpha,
gradient geometry, pattern transform/tint, updated image content.  Geometry,
draw order, clips and scissors are shared.  Use cases: animation bursts
(fades, hue cycles), theme/colorway variants, A/B render farms.

Bake protocol: each draw_fn records its variant through the ordinary API;
frame 0 establishes the structural plan and every later frame must hit the
value-patch (or full-memo) fast path — anything structural raises.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from vgtpu.ops.composite import (
    composite_bucketed_body,
    composite_tiles_body,
    tiles_to_image,
)
from vgtpu.ops.coverage import entry_coverage_from_pools


# --------------------------------------------------------------------------
# entry-axis folding
# --------------------------------------------------------------------------

def _host_folded_tables(plan, snaps):
    """K-folded dense entry tables + bucket tables for the XLA composite.

    Entry ids offset by k*NE, scatter tile ids by k*T; the composite's
    shading origins must use the UNOFFSET tile id (pixel positions are
    per-variant screen space), so buckets carry both id arrays."""
    K = len(snaps)
    ne = plan.entry_backdrop.shape[0]
    T = plan.tile_entries.shape[0]
    nct = plan.color_tiles.shape[0]
    ek = np.tile(plan.entry_kind, K)
    er = np.tile(plan.entry_rule, K)
    ea = np.tile(plan.entry_aa, K)
    epk = np.tile(plan.entry_paint_kind, K)
    esc = np.tile(plan.entry_scissor, (K, 1))
    ep = np.concatenate([s["entry_paint"] for s in snaps])
    ect = np.concatenate([
        np.where(plan.entry_color_tile >= 0,
                 plan.entry_color_tile + k * nct, -1)
        for k in range(K)
    ])
    ct = np.concatenate([np.asarray(s["color_tiles"], np.float32)
                         for s in snaps])
    buckets = []
    for te_b, ids_b, _fl in plan.tile_buckets:
        te_K = np.concatenate([
            np.where(te_b >= 0, te_b + k * ne, -1) for k in range(K)])
        # pad rows carry scatter id == T (compute_tile_buckets): route them
        # to the batch scratch row K*T, not T + k*T (variant k+1's tile 0)
        ids32 = ids_b.astype(np.int32)
        ids_sc = np.concatenate([np.where(ids32 >= T, K * T, ids32 + k * T)
                                 for k in range(K)])
        ids_or = np.tile(np.minimum(ids32, T - 1), K)
        buckets.append((te_K, ids_sc, ids_or))
    return dict(ek=ek, er=er, ea=ea, epk=epk, esc=esc, ep=ep, ect=ect, ct=ct,
                buckets=tuple(buckets))


def _folded_batch_body(chunk_pools, ebd, tabs, background,
                       *, K, num_entries, tile_h, tile_w, ntx, nty,
                       width, height, bucket_flags, ss):
    T = ntx * nty
    th_out = tile_h // ss
    cov = entry_coverage_from_pools(chunk_pools, num_entries, tile_h, tile_w)
    ew = cov + ebd[:, :, None]
    ew_K = jnp.tile(ew, (K, 1, 1))
    fb = jnp.broadcast_to(
        background, (K * T + 1, th_out, tile_w, 4)).astype(jnp.float32)
    for (te_b, ids_sc, ids_or), flags in zip(tabs["buckets"], bucket_flags):
        nb, mo = te_b.shape
        e = jnp.maximum(te_b, 0)
        ef = e.reshape(-1)
        flat_ids = jnp.arange(nb * mo, dtype=jnp.int32).reshape(nb, mo)
        flat_ids = jnp.where(te_b >= 0, flat_ids, -1)
        fb_b = composite_tiles_body(
            ew_K[ef], flat_ids, ids_or,
            tabs["ek"][ef], tabs["er"][ef], tabs["ea"][ef], tabs["epk"][ef],
            tabs["ep"][ef], tabs["esc"][ef], tabs["ect"][ef], tabs["ct"],
            background,
            ntx=ntx, tile_h=tile_h, tile_w=tile_w, max_ops=mo,
            lane_flags=tuple(flags), ss=ss,
        )
        fb = fb.at[ids_sc].set(fb_b)
    tiles = fb[: K * T].reshape(K, T, th_out, tile_w, 4)
    return jax.vmap(
        lambda t: tiles_to_image(t, ntx=ntx, nty=nty, tile_h=th_out,
                                 tile_w=tile_w, width=width, height=height)
    )(tiles)


_render_folded = jax.jit(
    _folded_batch_body,
    static_argnames=("K", "num_entries", "tile_h", "tile_w", "ntx", "nty",
                     "width", "height", "bucket_flags", "ss"),
)


# --------------------------------------------------------------------------
# multi-chip: variant-axis sharding over a device mesh
# --------------------------------------------------------------------------

def _vmapped_batch_body(chunk_pools, ebd, ek, er, ea, epk, esc, ect, buckets,
                        ep_K, ct_K, background,
                        *, num_entries, tile_h, tile_w, ntx, nty,
                        width, height, bucket_flags, ss):
    """Leading-K formulation: coverage is variant-invariant (computed once,
    replicated by GSPMD); only the per-variant value tables (ep_K, ct_K)
    carry a K axis, which shards across the mesh — serving parallelism with
    ZERO collectives (each device renders its variants independently)."""
    cov = entry_coverage_from_pools(chunk_pools, num_entries, tile_h, tile_w)
    ew = cov + ebd[:, :, None]
    T = ntx * nty
    th_out = tile_h // ss

    def one(ep, ct):
        fb = composite_bucketed_body(
            ew, buckets, ek, er, ea, epk, ep, esc, ect, ct, background,
            ntx=ntx, tile_h=tile_h, tile_w=tile_w, num_tiles=T,
            bucket_flags=bucket_flags, ss=ss)
        return tiles_to_image(fb, ntx=ntx, nty=nty, tile_h=th_out,
                              tile_w=tile_w, width=width, height=height)

    return jax.vmap(one)(ep_K, ct_K)


def _make_sharded_batch_fn(mesh, axis, n_pools, n_buckets, statics):
    """jitted shard_map over the variant axis: per-variant value tables
    shard, everything structural replicates, each device runs the local-K
    vmapped body — no collective in the program (GSPMD's sharding-in-types
    cannot propagate through the image-assembly reshape, so the split is
    explicit here, like the tile-sharded frame in vgtpu/parallel)."""
    from jax.sharding import PartitionSpec as P

    def local_batch(chunk_pools, ebd, ek, er, ea, epk, esc, ect, buckets,
                    ep_K, ct_K, background):
        return _vmapped_batch_body(
            chunk_pools, ebd, ek, er, ea, epk, esc, ect, buckets,
            ep_K, ct_K, background, **statics)

    sharded = jax.shard_map(
        local_batch,
        mesh=mesh,
        in_specs=(
            tuple((P(), P()) for _ in range(n_pools)),
            P(), P(), P(), P(), P(), P(), P(),
            tuple((P(), P()) for _ in range(n_buckets)),
            P(axis), P(axis), P(),
        ),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(sharded)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def _record_snaps(ctx, draw_fns, width, height, dpr, background,
                  expect_plan=None, expect_d=None):
    """Record the K variants through the ordinary API and snapshot the
    value tables after each frame.  Every frame after the first (or ALL
    frames, when re-recording against an existing bake via expect_plan)
    must leave the resident plan object untouched — i.e. hit the memo or
    paint-value-patch path — or ValueError."""
    snaps = []
    plan0, d0 = expect_plan, expect_d
    # the batch body renders plans WITHOUT layer tiles: prefix-layer
    # splitting is suppressed for the bake records (full single plans);
    # a translated-cached-list layer cannot be suppressed — reject it
    suppress0 = getattr(ctx, "_suppress_layer", False)
    ctx._suppress_layer = True
    try:
        for k, fn in enumerate(draw_fns):
            ctx.begin(0, width, height, dpr)
            fn(ctx)
            # only the resident plan + paint tables are needed; skip the K
            # per-variant device renders (their images are never read)
            ctx.end(background=background, dispatch=False)
            if ctx._layer_render is not None:
                raise ValueError(
                    "a translated cached-list layer is active on this "
                    "context's frames — layered frames cannot bake into a "
                    "VariantBatch (the batch body renders plans without "
                    "layer tiles)")
            plan = ctx.last_plan
            if plan0 is None:
                plan0, d0 = plan, ctx.last_device_arrays
            elif plan is not plan0 or ctx.last_device_arrays is not d0:
                raise ValueError(
                    f"variant {k} changed the frame structure (geometry, "
                    "draw order, clips, texture topology or an opacity "
                    "class); only paint/texture VALUES may differ")
            ct = plan.color_tiles
            snaps.append({
                "entry_paint": plan.entry_paint.copy(),
                "pop_paint": (None if plan.pop is None
                              else plan.pop["paint"].copy()),
                "color_tiles": (ct.copy() if isinstance(ct, np.ndarray)
                                else ct),
            })
    finally:
        ctx._suppress_layer = suppress0
    return plan0, d0, snaps


class VariantBatch:
    """K baked value-variants of one structural plan; render() produces all
    K frames in one device dispatch -> (K, H, W, 4) premultiplied f32."""

    def __init__(self, K, args, statics):
        self.K = K
        self._args = args
        self._statics = statics
        self._plan = None     # host plan + snapshots, kept for render_sharded
        self._snaps = None
        self._d = None        # resident device arrays (update_values checks)
        self._record = None   # (ctx, w, h, dpr, background) from bake

    @staticmethod
    def bake(ctx, draw_fns, width: int, height: int, dpr: float = 1.0,
             background=(0.0, 0.0, 0.0, 1.0)) -> "VariantBatch":
        """Record each variant through the ordinary API and fold the batch.

        draw_fns: sequence of callables f(ctx); each records ONE variant
        frame.  The first defines the structure; every later one must be a
        value-only delta (the paint-memo eligibility rules) or ValueError.
        Bake cost is K ordinary frames; render() amortizes from then on."""
        draw_fns = list(draw_fns)
        if not draw_fns:
            raise ValueError("need at least one variant")
        if not (ctx.cfg.frame_memo and ctx.cfg.paint_memo):
            raise ValueError("VariantBatch.bake requires frame_memo and "
                             "paint_memo enabled (they gate the value-patch "
                             "path the bake snapshots)")
        plan0, d0, snaps = _record_snaps(ctx, draw_fns, width, height, dpr,
                                         background)
        vb = VariantBatch._build(plan0, d0, snaps)
        vb._record = (ctx, width, height, dpr, background)
        return vb

    @staticmethod
    def _build(plan, d, snaps) -> "VariantBatch":
        K = len(snaps)
        statics = dict(
            K=K, num_entries=plan.entry_backdrop.shape[0],
            tile_h=plan.tile_h, tile_w=plan.tile_w, ntx=plan.ntx,
            nty=plan.nty, width=plan.width, height=plan.height,
            bucket_flags=d["bucket_flags"], ss=plan.supersample,
        )
        tabs = _host_folded_tables(plan, snaps)
        args = (d["chunk_pools"], d["entry_backdrop"], jax.device_put(tabs))
        vb = VariantBatch(K, args, statics)
        vb._plan, vb._snaps, vb._d = plan, snaps, d
        return vb

    def update_values(self, draw_fns) -> None:
        """Refresh the K variants' VALUES in place — the per-tick serving
        loop.  Re-records each variant (every frame must hit the memo or
        paint-value-patch path against the baked structure, else ValueError)
        and rebuilds only the value planes: the static tables (chunk pools,
        bucket tables, compiled programs) are reused, so
        a tick costs K records + one value bake instead of a full rebake."""
        if self._record is None:
            raise ValueError("update_values needs a bake()-built batch")
        draw_fns = list(draw_fns)
        if len(draw_fns) != self.K:
            raise ValueError(f"{len(draw_fns)} draw_fns for K={self.K}")
        ctx, w, h, dpr, bg = self._record
        _plan, _d, snaps = _record_snaps(ctx, draw_fns, w, h, dpr, bg,
                                         expect_plan=self._plan,
                                         expect_d=self._d)
        self._snaps = snaps
        tabs = _host_folded_tables(self._plan, snaps)
        self._args = self._args[:2] + (jax.device_put(tabs),)
        for entry in (getattr(self, "_sharded_fns", None) or {}).values():
            entry["ep"] = entry["ct"] = None   # re-upload on next render

    def render(self, background=(0.0, 0.0, 0.0, 1.0)) -> jax.Array:
        """All K variant frames in one dispatch -> (K, H, W, 4)."""
        bg = jnp.asarray(np.asarray(background, np.float32))
        return _render_folded(*self._args, bg, **self._statics)

    def render_sharded(self, mesh, background=(0.0, 0.0, 0.0, 1.0)) -> jax.Array:
        """All K variants data-parallel over a 1-D device mesh -> (K,H,W,4).

        The serving-at-scale mode: the K axis shards across the mesh; the
        structural plan (geometry, buckets, entry tables) replicates, each
        device computes coverage locally and renders only its variants — no
        collective anywhere in the program (contrast the tile-sharded frame
        in vgtpu/parallel/sharding.py, which psums partial coverage).  K pads
        to a mesh-size multiple by repeating the last variant; pad frames are
        rendered and discarded."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        plan, snaps = self._plan, self._snaps
        if plan is None or snaps is None:
            raise ValueError("render_sharded needs the baked host plan "
                             "(use VariantBatch.bake)")
        axis = mesh.axis_names[0]
        repl = NamedSharding(mesh, P())
        # everything except the background is bake-static: upload once per
        # mesh and cache alongside the compiled fn (re-uploading the plan
        # per call would make serving upload-bound)
        key = (id(mesh), axis)
        cache = getattr(self, "_sharded_fns", None)
        if cache is None:
            cache = self._sharded_fns = {}
        entry = cache.get(key)
        if entry is None:
            host_repl = dict(
                pools=tuple((np.asarray(ce), np.asarray(cent))
                            for ce, cent in plan.chunk_pools),
                ebd=plan.entry_backdrop, ek=plan.entry_kind,
                er=plan.entry_rule, ea=plan.entry_aa,
                epk=plan.entry_paint_kind, esc=plan.entry_scissor,
                ect=plan.entry_color_tile,
                buckets=tuple((te, ids)
                              for te, ids, _fl in plan.tile_buckets),
            )
            statics = dict(
                num_entries=plan.entry_backdrop.shape[0],
                tile_h=plan.tile_h, tile_w=plan.tile_w, ntx=plan.ntx,
                nty=plan.nty, width=plan.width, height=plan.height,
                bucket_flags=tuple(fl for _te, _ids, fl in plan.tile_buckets),
                ss=plan.supersample)
            entry = cache[key] = {
                "fn": _make_sharded_batch_fn(
                    mesh, axis, len(host_repl["pools"]),
                    len(host_repl["buckets"]), statics),
                "r": jax.device_put(host_repl, repl),
                "ep": None, "ct": None,   # value tables upload lazily
            }
        if entry["ep"] is None:
            n = mesh.devices.size
            Kp = -(-self.K // n) * n
            snaps_p = list(snaps) + [snaps[-1]] * (Kp - self.K)
            ep_K = np.stack([s["entry_paint"] for s in snaps_p])
            ct_K = np.stack([np.asarray(s["color_tiles"], np.float32)
                             for s in snaps_p])
            entry["ep"], entry["ct"] = jax.device_put(
                (ep_K, ct_K), NamedSharding(mesh, P(axis)))
        fn, r = entry["fn"], entry["r"]
        bg = jax.device_put(np.asarray(background, np.float32), repl)
        out = fn(r["pools"], r["ebd"], r["ek"], r["er"], r["ea"], r["epk"],
                 r["esc"], r["ect"], r["buckets"], entry["ep"], entry["ct"],
                 bg)
        if out.shape[0] == self.K:
            # no pad variants: return the stack VARIANT-SHARDED.  The old
            # unconditional replicate-to-drop-pads was an implicit
            # all-gather — every device received all K frames (K*33 MB at
            # 1080p, n^2 traffic growth across the mesh).  Consumers fetch
            # the variants they need; a host np.asarray gathers each shard
            # once.
            return out
        # pad variants present: all-gather before dropping them (slicing
        # across the sharded axis is ambiguous for GSPMD)
        return jax.device_put(out, repl)[: self.K]


def _chained_body(args, background, statics, n_frames):
    chunk_pools = args[0]
    rest = args[1:]

    def body(i, eps):
        pools = tuple((ce + eps, cent) for ce, cent in chunk_pools)
        imgs = _folded_batch_body(pools, *rest, background + eps, **statics)
        # fold every pixel of every variant back in: DCE-proof (benchloop)
        return jnp.sum(imgs[..., 3]) * 1e-9

    return jax.lax.fori_loop(0, n_frames, body, jnp.float32(0.0))


@functools.partial(jax.jit, static_argnames=("statics_t", "n_frames"))
def _chained_jit(args, background, *, statics_t, n_frames):
    return _chained_body(args, background, dict(statics_t), n_frames)


def measure_batch_ms_per_frame(vb: VariantBatch, background=(0, 0, 0, 1),
                               reps_hi: int = 16, reps_lo: int = 2) -> float:
    """Chained-dispatch device ms per VARIANT FRAME (total / (reps * K)):
    the honest throughput number to compare against the single-frame
    benchloop ms/frame."""
    import time

    bg = jnp.asarray(np.asarray(background, np.float32))
    statics_t = tuple(sorted(vb._statics.items()))

    def run(n):
        out = _chained_jit(vb._args, bg, statics_t=statics_t, n_frames=n)
        return float(np.asarray(out))

    run(reps_lo)
    run(reps_hi)
    t0 = time.perf_counter()
    run(reps_lo)
    t1 = time.perf_counter()
    run(reps_hi)
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (reps_hi - reps_lo) / vb.K * 1e3
