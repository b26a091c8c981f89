"""Device-resident retained scenes with on-device panning.

The reference's retained path is a command list + tessellation cache replayed
on the CPU each frame (vg.cpp:4273-4637, :5843-6211); every transform change
re-walks host memory.  Here the analogous retained artifact — the binned
frame plan — lives ON DEVICE, and a translated view re-renders with ZERO host
work: no re-record, no re-bin, no upload.

This closes the retained-transform problem for the translation
case.  Binning ties edges to screen tiles, so a general transform needs
dynamic scatter.  Translation decomposes into static-shape device work:

  view origin (Vx, Vy)  =  whole tiles (vx, vy)  +  residual (rx, ry)

  * whole tiles  -> a RELABEL of the scatter ids: output tile (ty,tx) gathers
    scene tile (ty+vy, tx+vx).  Pure index arithmetic, traced, no recompile.
  * residual rx in [0, tile_w), ry in [0, tile_h)  -> content shifts LEFT/UP
    by less than one tile.  The scene is binned with a pan margin
    (bin_frame_numpy(pan_margin=True)): every edge is also assigned to the
    tile column left / row above its span, so after the shift each tile's
    chunk set still contains every edge that can touch it; the analytic
    coverage kernel is exact for any edge position, so shifting is ONE
    elementwise subtract on the chunk-edge array.  Backdrops (winding from
    far-left edges) are x-shift-invariant by construction and carry a
    2*tile_h row window so the y-residual is a dynamic row slice.
  * scissors, gradient/tri paints evaluate in scene space; the composite
    takes the residual as a traced origin_shift.

Everything per-frame is inside one jit with static shapes: renders at ANY
integer offset share one compiled program.

Textured/text layers: color tiles are tile-local pre-samples, so the bake
uploads the sampling-group params (with reachable-window entry/quad pairs)
and device textures instead, and each render RESAMPLES the tiles in-trace
with the residual added to the tile origins — integer shifts of bilinear
sampling are exact, so panned text/patterns match direct renders bit-close.
The atlas/textures are snapshot at bake (later glyph bakes don't mutate a
baked scene).

Supersampled coverage (ContextConfig.coverage_supersample > 1) bakes and
pans like everything else: the scene is binned in the sub-row domain
(y geometry scaled by ss, tile_h*ss sub-rows, 2*tile_h*ss backdrop window
rows), view offsets resolve to whole sub-rows — integer-pixel pans are
always representable, and ss=4 scenes additionally scroll at exact
quarter-pixel y granularity — and the composite applies the fill rule per
sub-row before averaging, exactly as direct supersampled frames do.

Limitations (documented, enforced at bake):
  * all per-tile optimizations run in view-invariant form
    (compute_tile_buckets(view_static=True)): static clip resolution and
    trailing-control pruning are per-tile draw-order facts; occlusion
    culling requires opaque cover over the whole backdrop window with no
    edges in the margin-inflated chunk set.
"""

from __future__ import annotations

import copy
import functools

import numpy as np

import jax
import jax.numpy as jnp

from vgtpu.raster.binning import (
    P_GRADIENT,
    P_IMAGE,
    P_TRI,
    RasterOp,
    bin_frame_numpy,
    compute_tile_buckets,
)


def translate_ops(ops: list[RasterOp], dx: float, dy: float) -> list[RasterOp]:
    """Translate recorded ops by (dx, dy) in screen space: geometry, scissor
    AND paints move together (unlike scale_ops_y, which keeps paints in pixel
    space).  Gradient/pattern paints store the INVERSE transform u = M.p + t
    (vg.cpp:3712-3931), so a scene translate is t -= M.d; tri paints store
    color planes c(p) = A.x + B.y + C, so C -= A*dx + B*dy."""
    out = []
    for op in ops:
        o = copy.copy(op)
        if o.edges is not None and len(o.edges):
            e = np.asarray(o.edges, np.float32).copy()
            e[:, 0] += dx
            e[:, 2] += dx
            e[:, 1] += dy
            e[:, 3] += dy
            o.edges = e
        if o.scissor is not None:
            s = o.scissor
            o.scissor = (s[0] + dx, s[1] + dy, s[2] + dx, s[3] + dy)
        if o.tex_quads is not None and len(o.tex_quads):
            q = np.asarray(o.tex_quads, np.float32).copy()
            q[:, 0] += dx    # p0; ex/ey direction vectors and uvs unchanged
            q[:, 1] += dy
            o.tex_quads = q

        def shift_paint(p, kind):
            p = np.asarray(p, np.float32).copy()
            if kind in (P_GRADIENT, P_IMAGE):
                # inverse paint transform u = M.p + t  ->  t -= M.d
                p[4] -= p[0] * dx + p[2] * dy
                p[5] -= p[1] * dx + p[3] * dy
            elif kind == P_TRI:
                p[8:12] -= p[0:4] * dx + p[4:8] * dy
            return p

        if o.paint is not None:
            o.paint = shift_paint(o.paint, o.paint_kind)
        if o.tri_paints is not None and len(o.tri_paints):
            tp = np.asarray(o.tri_paints, np.float32).copy()
            tp[:, 8:12] -= tp[:, 0:4] * dx + tp[:, 4:8] * dy
            o.tri_paints = tp
        out.append(o)
    return out


def _op_fingerprints(ops) -> list:
    """Per-op (structural_crc, paint_crc) pairs over PRE-translate ops —
    update_paint_values' structural-identity check (collisions are not
    adversarial here, same argument as Context._frame_fingerprint)."""
    import zlib

    out = []
    for op in ops:
        c = 0
        for a in (op.edges, op.tex_quads, op.tri_paints):
            if a is not None:
                a = np.asarray(a)
                if not a.flags.c_contiguous:
                    a = np.ascontiguousarray(a)
                c = zlib.crc32(a, c)
        c ^= hash((op.kind, op.fill_rule, op.aa, op.paint_kind,
                   op.image_id, op.scissor)) & 0xFFFFFFFF
        p = 0
        if op.paint is not None:
            p = zlib.crc32(np.ascontiguousarray(
                np.asarray(op.paint, np.float32)))
        out.append((c, p))
    return out


def _repack_ladder(chunk_pools, num_entries: int, ladder=(2, 4, 8, 24)):
    """Repack the numpy binner's single fixed-size chunk pool into the
    finer slot ladder the coverage kernels like (one-time, at bake): each
    entry's live edges are regrouped greedily into the largest-fitting
    chunk sizes.  Order within an entry may change — coverage is a sum."""
    from vgtpu.raster.binning import _bucket

    # per-entry live edges, in (chunk, slot) order
    per_entry: list[list[np.ndarray]] = [[] for _ in range(num_entries)]
    for ce, cent in chunk_pools:
        live = np.abs(ce[:, :, 3] - ce[:, :, 1]) > 1e-12
        for ci in range(len(ce)):
            e = int(cent[ci])
            if 0 <= e < num_entries and live[ci].any():
                per_entry[e].append(ce[ci][live[ci]])
    ladder = sorted(ladder)
    pools: dict[int, tuple[list, list]] = {s: ([], []) for s in ladder}

    def best_size(n):
        for s in ladder:
            if n <= s:
                return s
        return ladder[-1]

    for e, parts in enumerate(per_entry):
        if not parts:
            continue
        edges = np.concatenate(parts, axis=0)
        i, n = 0, len(edges)
        while i < n:
            rem = n - i
            s = ladder[-1] if rem > ladder[-1] else best_size(rem)
            blk = np.zeros((s, 4), np.float32)
            take = min(s, rem)
            blk[:take] = edges[i : i + take]
            pools[s][0].append(blk)
            pools[s][1].append(e)
            i += take
    out = []
    for s in ladder:
        blocks, ents = pools[s]
        nc = _bucket(max(len(blocks), 1))
        ce = np.zeros((nc, s, 4), np.float32)
        cent = np.full(nc, num_entries - 1, np.int32)
        if blocks:
            ce[: len(blocks)] = np.stack(blocks)
            cent[: len(ents)] = np.asarray(ents, np.int32)
        out.append((ce, cent))
    return out


class RetainedScene:
    """A baked, device-resident scene renderable at any view offset without
    host work — integer (or fractional-x: smooth horizontal scrolling)
    offsets in both render() and render_views().  Build with `bake(ctx)`
    after recording a frame (begin ... draw calls ... bake instead of
    end)."""

    def __init__(self, plan, device, out_w: int, out_h: int, background,
                 off=(0, 0)):
        self.plan = plan
        self.d = device
        self.out_w = out_w
        self.out_h = out_h
        self.background = jnp.asarray(np.asarray(background, np.float32))
        self.tile_w = plan.tile_w
        self.tile_h = plan.tile_h      # SUB-rows (pixel rows * supersample)
        self.ss = int(plan.supersample)
        self.off = off          # baked-grid origin in view coords (PIXEL tile-multiples)
        self.samp_meta = None   # sampling-group signature (textured scenes)
        self.samp_nct = 0
        self._ops_fp = None       # per-op (structural, paint) crc pairs
        self._op_solid_cls = None  # per-op solid alpha>=1 class at bake

    @staticmethod
    def bake(ctx, scene_width: int | None = None, scene_height: int | None = None,
             background=(1.0, 1.0, 1.0, 1.0), ops=None) -> "RetainedScene":
        """Bin the recorded frame over the scene bounds with pan margins and
        upload.  The scene may be larger than the viewport (content scrolled
        into view must be binned); view offsets beyond it show background.

        ops: optional already-FINALIZED op list to bake instead of ctx.ops
        (the translated-layer path bakes a cached command list's op slice;
        ctx still provides config + texture/font access)."""
        from vgtpu.ops.coverage import build_cov_gather_map
        from vgtpu.raster.binning import expand_tri_batches, scale_ops_y

        ss = int(ctx.cfg.coverage_supersample)
        if ops is None:
            ctx._finalize_ops()
            ops = ctx.ops
        scene_w = int(scene_width or ctx.fb_width)
        scene_h = int(scene_height or ctx.fb_height)
        tw, th = ctx.cfg.tile_w, ctx.cfg.tile_h
        ops = expand_tri_batches(ops)
        for op in ops:
            if isinstance(op.edges, list):
                op.edges = np.concatenate(op.edges, axis=0)
        # ops recorded while the scissor was the untouched viewport default
        # carry scissor=None (Context._op_scissor): the reference's default
        # scissor is the screen, which the pan output crop models, so those
        # draws pan freely.  Explicit setScissor rects (even viewport-sized
        # ones) are transformed at set time in the reference (updateScissor)
        # and correctly ride scene space here.
        # the baked grid covers the CONTENT bbox, not just the viewport:
        # everything recorded is retained and pans into view exactly (plus a
        # 1-tile border so sub-tile residuals at the edges stay in-grid)
        xmin = ymin = 0.0
        xmax, ymax = float(scene_w), float(scene_h)
        for o in ops:
            if o.edges is not None and len(o.edges):
                e = np.asarray(o.edges)
                xmin = min(xmin, float(e[:, [0, 2]].min()) - 2.0)
                xmax = max(xmax, float(e[:, [0, 2]].max()) + 2.0)
                ymin = min(ymin, float(e[:, [1, 3]].min()) - 2.0)
                ymax = max(ymax, float(e[:, [1, 3]].max()) + 2.0)
            if o.tex_quads is not None and len(o.tex_quads):
                q = np.asarray(o.tex_quads, np.float64)
                cx = np.concatenate([q[:, 0], q[:, 0] + q[:, 2],
                                     q[:, 0] + q[:, 4],
                                     q[:, 0] + q[:, 2] + q[:, 4]])
                cy = np.concatenate([q[:, 1], q[:, 1] + q[:, 3],
                                     q[:, 1] + q[:, 5],
                                     q[:, 1] + q[:, 3] + q[:, 5]])
                xmin = min(xmin, float(cx.min()) - 2.0)
                xmax = max(xmax, float(cx.max()) + 2.0)
                ymin = min(ymin, float(cy.min()) - 2.0)
                ymax = max(ymax, float(cy.max()) + 2.0)
        offx = tw * (1 + int(np.ceil(-xmin / tw)))
        offy = th * (1 + int(np.ceil(-ymin / th)))
        # fingerprints are taken PRE-translate so per-tick re-records
        # (update_paint_values) compare without re-translating the scene;
        # paint alpha (row 13) is translate-invariant, so the solid class
        # can be captured here too
        ops_fp = _op_fingerprints(ops)
        solid_cls = [
            (op.paint is not None
             and float(np.asarray(op.paint)[13]) >= 1.0)
            for op in ops
        ]
        ops = translate_ops(ops, float(offx), float(offy))
        # supersampled scenes (conflation-free coverage): translate in PIXEL
        # space first (paints stay pixel-space, ops/composite.py), then scale
        # y geometry into sub-row units exactly as the frame path does
        # (bin_frame) and bin on tile_h*ss sub-rows; plan.height stays the
        # pixel height with plan.supersample recording the factor (the
        # view-static bucket passes read height*supersample for the scissor
        # viewport).  Backdrop pan windows, residual slices and the tile
        # relabel all live in the sub-row domain unchanged.
        plan_h = int(np.ceil(ymax)) + offy
        # the sampler consumes quad bboxes/params in OUTPUT-pixel space
        # (sampling_device.py — the frame path passes the unscaled ops,
        # api/context.py); keep the pre-scale list for build_sampling_plan
        # below (scale_ops_y preserves indices 1:1)
        ops_px = ops
        if ss > 1:
            ops = scale_ops_y(ops, ss)
        plan = bin_frame_numpy(
            ops, int(np.ceil(xmax)) + offx, plan_h * ss,
            tile_h=th * ss, tile_w=tw,
            chunk=ctx.cfg.edges_per_chunk, pan_margin=True)
        plan.height = plan_h
        plan.supersample = ss
        if ss > 1 and plan.color_tiles.shape[1] != th:
            # output-domain placeholder, as bin_frame's remap does
            plan.color_tiles = np.zeros((1, th, tw, 4), np.float32)
        # view_static: lane specialization, static-clip resolution and
        # trailing-control pruning as usual (per-tile draw-order facts, which
        # panning preserves); occlusion culling switches to its view-invariant
        # tests (whole backdrop window, margin-inflated edge sets, reach-2
        # scissor containment — see compute_tile_buckets)
        plan.tile_buckets = compute_tile_buckets(
            plan.tile_entries, plan.tile_entries.shape[0], plan.entry_kind,
            plan=plan, view_static=True)
        ne = plan.entry_backdrop.shape[0]
        plan.chunk_pools = _repack_ladder(
            plan.chunk_pools, ne, ladder=ctx.cfg.chunk_pools)
        plan.stats["chunks"] = sum(len(ce) for ce, _ in plan.chunk_pools)
        # textured/text layers: color tiles must be RESAMPLED per view (they
        # are tile-local), so bake uploads the sampling-group params (with
        # the reachable-window pair set) + device textures and the render
        # samples in-trace with the residual added to the tile origins
        sp = samp = None
        n_real = plan.n_real_entries
        if ((plan.entry_paint_kind[:n_real] == 2).any()
                or (plan.entry_paint_kind[:n_real] == 3).any()):
            from vgtpu.ops.sampling_device import build_sampling_plan

            image_map = {
                idx: (img.data, img.flags, img.generation)
                for idx, img in ctx.images.items()
            }
            if ctx.font_system is not None:
                image_map.update(ctx.font_system.atlas_image_map())
            sp = build_sampling_plan(plan, ops_px, image_map, pan_margin=True)
            if sp.num_tiles:
                tex = ctx._device_textures(
                    image_map, {g.image_id for g in sp.groups})
                samp = {
                    "arrs": tuple(
                        (jnp.asarray(g.params), jnp.asarray(g.color),
                         jnp.asarray(g.ct)) for g in sp.groups),
                    "texs": tuple(tex[g.image_id] for g in sp.groups),
                    "clipmask": (jnp.asarray(np.concatenate(
                        [sp.tex_tile_mask, [False]]))
                        if sp.tex_tile_mask is not None else None),
                    "meta": tuple((g.kind, g.separable, g.flags)
                                  for g in sp.groups),
                    "nct": sp.num_tiles,
                }
        cov_map = build_cov_gather_map(plan.chunk_pools, ne)
        host = {
            "chunk_pools": tuple((ce, cent) for ce, cent in plan.chunk_pools),
            "entry_backdrop_pan": plan.entry_backdrop_pan,
            "entry_kind": plan.entry_kind,
            "entry_rule": plan.entry_rule,
            "entry_aa": plan.entry_aa,
            "entry_paint_kind": plan.entry_paint_kind,
            "entry_paint": plan.entry_paint,
            "entry_scissor": plan.entry_scissor,
            "entry_color_tile": plan.entry_color_tile,
            "color_tiles": plan.color_tiles,
            "cov_map": cov_map,
            "tile_buckets": tuple(
                (te, ids) for te, ids, _fl in plan.tile_buckets),
        }
        d = jax.device_put(host)
        d["bucket_flags"] = tuple(fl for _te, _ids, fl in plan.tile_buckets)
        if samp is not None:
            d["samp_arrs"] = samp["arrs"]
            d["samp_texs"] = samp["texs"]
            d["samp_clipmask"] = samp["clipmask"]
        scene = RetainedScene(plan, d, ctx.fb_width, ctx.fb_height, background,
                              off=(offx, offy))
        scene._ops_fp = ops_fp
        scene._op_solid_cls = solid_cls
        if samp is not None:
            scene.samp_meta = samp["meta"]
            scene.samp_nct = samp["nct"]
        return scene

    def update_paint_values(self, ctx) -> None:
        """Patch solid/gradient paint VALUES into the baked scene — the
        pan-plus-color-animation pattern (scrolling map with pulsing
        markers).  Record the scene again through the same context (same
        geometry, draw order, scissors, texture content; only solid/gradient
        paint values may differ — the retained analogue of the frame path's
        paint memo, Context._value_only_update), then call this instead of
        re-baking: the binned plan, coverage chunks, sampling groups and
        compiled pan programs are all reused; only the paint table
        refreshes (one small upload).  The structural check is per-op crc
        fingerprints, so an unchanged-scene tick costs O(scene crc), not
        O(scene copies)."""
        from vgtpu.raster.binning import (
            K_DRAW,
            P_GRADIENT,
            P_SOLID,
            expand_tri_batches,
            patch_entry_paint,
        )

        if self._ops_fp is None:
            raise ValueError("this scene was baked without retained "
                             "fingerprints")
        ctx._finalize_ops()
        ops2 = expand_tri_batches(ctx.ops)
        for op in ops2:
            if isinstance(op.edges, list):
                op.edges = np.concatenate(op.edges, axis=0)
        fp2 = _op_fingerprints(ops2)
        old = self._ops_fp
        if len(fp2) != len(old):
            raise ValueError(
                f"scene structure changed: {len(old)} -> {len(fp2)} draws")
        changed = []
        for i, ((s1, p1), (s2, p2)) in enumerate(zip(old, fp2)):
            if s1 != s2:
                raise ValueError(f"draw {i} changed structurally; only "
                                 "solid/gradient paint values may differ")
            if p1 == p2:
                continue
            op = ops2[i]
            if not (op.kind == K_DRAW
                    and op.paint_kind in (P_SOLID, P_GRADIENT)
                    and op.paint is not None):
                raise ValueError(
                    f"draw {i}: only solid/gradient paint VALUES can be "
                    "patched into a retained scene (texture/text tints need "
                    "a re-bake)")
            # occlusion covers are NonZero solids with alpha>=1 (the
            # binner's solid_opaque test): only those classes must hold
            if (op.paint_kind == P_SOLID and op.fill_rule == 0
                    and self._op_solid_cls[i]
                    != (float(np.asarray(op.paint)[13]) >= 1.0)):
                raise ValueError(
                    f"draw {i}: opacity-class flip would invalidate the "
                    "bake's view-invariant occlusion culling")
            changed.append(i)
        self._ops_fp = fp2
        if not changed:
            return
        # translate ONLY the changed ops (gradient rows carry scene-space
        # inverse transforms; solid rows are translate-invariant)
        tr = translate_ops([ops2[i] for i in changed],
                           float(self.off[0]), float(self.off[1]))
        new_rows = np.stack([np.asarray(o.paint, np.float32) for o in tr])
        patch_entry_paint(self.plan, len(ops2), changed, new_rows)
        self.d["entry_paint"] = jax.device_put(self.plan.entry_paint)

    def render(self, view_x: float = 0, view_y: float = 0) -> jax.Array:
        """Premultiplied (out_h, out_w, 4) of the scene viewed at offset
        (view_x, view_y): output pixel (x, y) shows scene point
        (view_x + x, view_y + y).  All device work; one compiled program
        serves every offset.

        view_x may be FRACTIONAL (smooth horizontal scrolling/marquees):
        backdrop rows are x-shift-invariant and the coverage kernel is
        analytic in edge position, so subpixel x-offsets render exactly
        (verified vs direct translated renders to float tolerance).
        view_y must be a multiple of 1/supersample — the per-row backdrop
        windows are piecewise-linear in y, so only whole SUB-row vertical
        offsets are representable (integer pixels at ss=1; quarter-pixel
        scrolling at ss=4)."""
        tw, th = self.tile_w, self.tile_h
        vy, ry = self._view_y_subrows(view_y)
        # baked-grid origin offset (content bbox + 1-tile border)
        ox = float(view_x) + self.off[0]
        vx = int(np.floor(ox / tw))
        rx = ox - vx * tw
        return _render_pan(
            self.d, self.background,
            np.int32(vx), np.int32(vy), np.float32(rx), np.int32(ry),
            **self._pan_statics(),
        )

    def render_tiles(self, view_x: float = 0, view_y: float = 0,
                     background=None) -> jax.Array:
        """The view as its OUTPUT TILE GRID (nty_o*ntx_o, th, tw, 4) —
        execute_plan's init_tiles contract: when this scene's output dims
        equal a frame's, a dynamic suffix plan composites straight over the
        panned artwork (the translated cached-list layer,
        api/command_list).  Same offset semantics as render().

        background: off-scene tiles show this (defaults to the bake
        background) — pass the FRAME background so layer edges match."""
        tw = self.tile_w
        vy, ry = self._view_y_subrows(view_y)
        bg = jnp.asarray(np.asarray(
            self.background if background is None else background,
            np.float32))
        ox = float(view_x) + self.off[0]
        vx = int(np.floor(ox / tw))
        rx = ox - vx * tw
        return _render_pan(
            self.d, bg,
            np.int32(vx), np.int32(vy), np.float32(rx), np.int32(ry),
            tiles_only=True, **self._pan_statics(),
        )

    def _view_y_subrows(self, view_y) -> tuple[int, int]:
        """(whole-tile, sub-row residual) of a pixel-space vertical offset.
        Representable offsets are whole SUB-rows: multiples of 1/ss pixels
        (backdrop row windows are per sub-row; coverage/backdrop shifts are
        exact there, and the texture resample shifts by ry/ss output pixels,
        identical to what a direct render of the moved quads would sample)."""
        oys = (float(view_y) + self.off[1]) * self.ss
        if abs(oys - round(oys)) > 1e-6:
            raise ValueError(
                "fractional view_y is only representable in whole sub-rows "
                f"(multiples of 1/{self.ss} px at coverage_supersample="
                f"{self.ss}); backdrop row windows are piecewise-linear in y")
        return divmod(int(round(oys)), self.tile_h)

    def _pan_statics(self) -> dict:
        tw, th = self.tile_w, self.tile_h
        th_px = th // self.ss
        return dict(
            NTX=self.plan.ntx, NTY=self.plan.nty, th=th, tw=tw,
            ntx_o=-(-self.out_w // tw), nty_o=-(-self.out_h // th_px),
            out_w=self.out_w, out_h=self.out_h, ss=self.ss,
            bucket_flags=self.d["bucket_flags"],
            ne=self.plan.entry_backdrop.shape[0],
            samp_meta=self.samp_meta, samp_nct=self.samp_nct,
        )

    def render_views(self, views) -> jax.Array:
        """V viewports of the scene in ONE device dispatch
        -> (V, out_h, out_w, 4).  views: sequence of (view_x, view_y)
        offsets, same semantics as render() — view_x may be fractional,
        view_y in whole sub-rows (multiples of 1/ss px).  The multi-view
        serving pattern (minimap + main view; K pan clients sharing one
        resident scene): the scene stays resident, only 2V offset scalars
        upload, and the per-dispatch cost is paid once."""
        tw, th = self.tile_w, self.tile_h
        views = np.asarray(views, np.float64)
        if views.ndim != 2 or views.shape[1] != 2 or not len(views):
            raise ValueError(
                "views must be a non-empty sequence of (view_x, view_y) pairs")
        oys = (views[:, 1] + self.off[1]) * self.ss
        if not np.all(np.abs(oys - np.round(oys)) <= 1e-6):
            raise ValueError(
                "fractional view_y is only representable in whole sub-rows "
                f"(multiples of 1/{self.ss} px at coverage_supersample="
                f"{self.ss}); backdrop row windows are piecewise-linear in y")
        ox = views[:, 0] + self.off[0]   # view_x may be fractional (render())
        vxs = np.floor(ox / tw).astype(np.int64)
        rxs = ox - vxs * tw
        vys, rys = np.divmod(np.round(oys).astype(np.int64), th)
        return _render_pan_views(
            self.d, self.background,
            vxs.astype(np.int32), vys.astype(np.int32),
            rxs.astype(np.float32), rys.astype(np.int32),
            **self._pan_statics(),
        )


def _render_pan_body(d, bg, vx, vy, rx, ry, *, NTX, NTY, th, tw, ntx_o, nty_o,
                     out_w, out_h, bucket_flags, ne, ss=1,
                     samp_meta=None, samp_nct=0, tiles_only=False):
    """th and ry are in SUB-rows (== pixel rows when ss == 1); coverage,
    backdrops and the residual shift all live in the sub-row domain, the
    composite applies the fill rule per sub-row and averages (ss semantics
    of ops/composite.py), and tiles/image assembly are output-domain."""
    from vgtpu.ops.composite import composite_bucketed_body, tiles_to_image
    from vgtpu.ops.coverage import entry_coverage_gather

    th_out = th // ss
    rxf = rx.astype(jnp.float32)
    ryf = ry.astype(jnp.float32)
    shift = jnp.stack([rxf, ryf, rxf, ryf])
    # residual: content moves left/up by (rx, ry) — pad rows keep y0 == y1,
    # so they still contribute exactly zero
    pools = tuple((ce - shift, cent) for ce, cent in d["chunk_pools"])
    bd = jax.lax.dynamic_slice_in_dim(d["entry_backdrop_pan"], ry, th, axis=1)
    nt = NTX * NTY
    if samp_meta is not None:
        # resample color tiles at the shifted view: tile origins in the
        # group params take the residual (quads/paint matrices are
        # scene-space constants)
        from vgtpu.ops.sampling_device import _sample_jit

        # the sampler works in the OUTPUT pixel domain: y residual is
        # ry/ss output pixels (== ry when ss == 1)
        shift12 = (jnp.zeros((12,), jnp.float32)
                   .at[0].set(rxf).at[1].set(ryf / ss))
        arrs = tuple((p + shift12, c, ci) for (p, c, ci) in d["samp_arrs"])
        color_tiles = _sample_jit(arrs, d["samp_texs"], d["samp_clipmask"],
                                  meta=samp_meta, th=th_out, tw=tw,
                                  num_tiles=samp_nct)
    else:
        color_tiles = d["color_tiles"]
    cov = entry_coverage_gather(pools, d["cov_map"], ne, th, tw)
    entry_w = cov + bd[:, :, None]
    fb = composite_bucketed_body(
        entry_w, d["tile_buckets"],
        d["entry_kind"], d["entry_rule"], d["entry_aa"],
        d["entry_paint_kind"], d["entry_paint"], d["entry_scissor"],
        d["entry_color_tile"], color_tiles, bg,
        ntx=NTX, tile_h=th, tile_w=tw, num_tiles=nt,
        bucket_flags=bucket_flags, ss=ss, origin_shift=(rxf, ryf),
    )
    return _pan_epilogue(fb, bg, vx, vy, NTX=NTX, NTY=NTY, nt=nt,
                         ntx_o=ntx_o, nty_o=nty_o, th_out=th_out, tw=tw,
                         out_w=out_w, out_h=out_h, tiles_only=tiles_only)


def _pan_epilogue(fb, bg, vx, vy, *, NTX, NTY, nt, ntx_o, nty_o, th_out, tw,
                  out_w, out_h, tiles_only):
    """Viewport window: the whole-tile part of the pan is a gather relabel;
    off-scene tiles read the appended background row."""
    from vgtpu.ops.composite import tiles_to_image

    bg_tile = jnp.broadcast_to(bg.astype(jnp.float32), (1, th_out, tw, 4))
    fb = jnp.concatenate([fb, bg_tile], axis=0)
    ty = jnp.arange(nty_o, dtype=jnp.int32)[:, None] + vy
    tx = jnp.arange(ntx_o, dtype=jnp.int32)[None, :] + vx
    valid = (ty >= 0) & (ty < NTY) & (tx >= 0) & (tx < NTX)
    sid = jnp.where(valid, ty * NTX + tx, nt).reshape(-1)
    if tiles_only:
        # execute_plan's init_tiles contract (the translated cached-list
        # layer): the OUTPUT TILE GRID, no image assembly — a dynamic
        # suffix plan composites straight over these
        return fb[sid]
    return tiles_to_image(fb[sid], ntx=ntx_o, nty=nty_o, tile_h=th_out,
                          tile_w=tw, width=out_w, height=out_h)


_render_pan = jax.jit(
    _render_pan_body,
    static_argnames=("NTX", "NTY", "th", "tw", "ntx_o", "nty_o",
                     "out_w", "out_h", "bucket_flags", "ne", "ss",
                     "samp_meta", "samp_nct", "tiles_only"),
)


@functools.partial(
    jax.jit,
    static_argnames=("NTX", "NTY", "th", "tw", "ntx_o", "nty_o",
                     "out_w", "out_h", "bucket_flags", "ne", "ss",
                     "samp_meta", "samp_nct"),
)
def _render_pan_views(d, bg, vxs, vys, rxs, rys, *, NTX, NTY, th, tw,
                      ntx_o, nty_o, out_w, out_h, bucket_flags, ne, ss=1,
                      samp_meta=None, samp_nct=0):
    """V viewports of one retained scene in ONE compiled dispatch
    -> (V, out_h, out_w, 4).  A lax.scan over the traced offsets: the win
    here is dispatch fusion (minimap+main-view UIs, K pan clients of one
    scene), and a scan keeps one view's intermediates live at a time."""
    def one(carry, v):
        vx, vy, rx, ry = v
        img = _render_pan_body(
            d, bg, vx, vy, rx, ry, NTX=NTX, NTY=NTY, th=th, tw=tw,
            ntx_o=ntx_o, nty_o=nty_o, out_w=out_w, out_h=out_h,
            bucket_flags=bucket_flags, ne=ne, ss=ss,
            samp_meta=samp_meta, samp_nct=samp_nct)
        return carry, img

    _, imgs = jax.lax.scan(one, jnp.float32(0.0), (vxs, vys, rxs, rys))
    return imgs


@functools.partial(
    jax.jit,
    static_argnames=("n_frames", "NTX", "NTY", "th", "tw", "ntx_o", "nty_o",
                     "out_w", "out_h", "bucket_flags", "ne", "ss",
                     "offx_t", "offy_t", "samp_meta", "samp_nct"),
)
def _chained_pans(d, bg, *, n_frames, NTX, NTY, th, tw, ntx_o, nty_o,
                  out_w, out_h, bucket_flags, ne, ss=1, offx_t=1, offy_t=1,
                  samp_meta=None, samp_nct=0):
    """N pans of a scrolling view inside one fori_loop, serially chained
    through the pixels (raster/benchloop.py)."""
    span_x = max(NTX - ntx_o, 1) * tw
    span_y = max(NTY - nty_o, 1) * th

    def body(i, eps):
        view_x = (i * 37) % span_x
        view_y = (i * 23) % span_y
        vx = view_x // tw + offx_t     # baked-grid origin (tiles)
        vy = view_y // th + offy_t
        img = _render_pan_body(
            {**d, "chunk_pools": tuple(
                (ce + eps, cent) for ce, cent in d["chunk_pools"])},
            bg, vx, vy, (view_x % tw).astype(jnp.float32), view_y % th,
            NTX=NTX, NTY=NTY, th=th, tw=tw, ntx_o=ntx_o, nty_o=nty_o,
            out_w=out_w, out_h=out_h, bucket_flags=bucket_flags, ne=ne,
            ss=ss, samp_meta=samp_meta, samp_nct=samp_nct)
        return jnp.sum(img[..., 3]) * 1e-9

    return jax.lax.fori_loop(0, n_frames, body, jnp.float32(0.0))


def measure_pan_ms_per_frame(scene: RetainedScene, reps_hi=32, reps_lo=2) -> float:
    """Two chained loop lengths, difference out the fixed overhead."""
    import time

    tw, th = scene.tile_w, scene.tile_h
    th_px = th // scene.ss
    static = dict(
        NTX=scene.plan.ntx, NTY=scene.plan.nty, th=th, tw=tw,
        ntx_o=-(-scene.out_w // tw), nty_o=-(-scene.out_h // th_px),
        out_w=scene.out_w, out_h=scene.out_h, ss=scene.ss,
        bucket_flags=scene.d["bucket_flags"],
        ne=scene.plan.entry_backdrop.shape[0],
        offx_t=scene.off[0] // tw, offy_t=scene.off[1] // th_px,
        samp_meta=scene.samp_meta, samp_nct=scene.samp_nct,
    )

    def run(n):
        out = _chained_pans(scene.d, scene.background, n_frames=n, **static)
        return float(np.asarray(out))

    run(reps_lo)
    run(reps_hi)
    t0 = time.perf_counter()
    run(reps_lo)
    t1 = time.perf_counter()
    run(reps_hi)
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (reps_hi - reps_lo) * 1e3


def _blend_over_tiles(over, base):
    """Premultiplied src-over of a baked transparent layer over per-frame
    tiles: out = over + base * (1 - over_alpha)."""
    return over + base * (1.0 - over[..., 3:4])


@functools.partial(jax.jit, static_argnames=("pan_st", "frame_st"))
def _pan_frame_fused(scene_d, layer_bg, vx, vy, rx, ry,
                     pools, ebd, comp_d, background, over, *,
                     pan_st, frame_st):
    """Panned-layer render + dynamic-suffix composite as ONE program: the
    translated cached-list frame previously dispatched render_tiles and
    execute_plan separately — two jit calls, with the
    (T, th, tw, 4) layer tiles round-tripping HBM between them.  Fusing
    halves the per-frame dispatch overhead and lets XLA schedule the layer
    composite and the suffix coverage together.

    over: optional resident transparent-baked static-UI tiles blended over
    the pan tiles before the suffix composites (api/context._layer_split
    transparent form — src-over associativity makes this exact)."""
    from vgtpu.raster.frame import _frame_body

    tiles = _render_pan_body(scene_d, layer_bg, vx, vy, rx, ry,
                             **dict(pan_st))
    if over is not None:
        tiles = _blend_over_tiles(over, tiles)
    return _frame_body(pools, ebd, comp_d, background, init_tiles=tiles,
                       **dict(frame_st))


class PendingPanLayer:
    """Lazy stand-in for the translated cached-list layer's tile grid
    (api/context end()): carries (scene, view) so _maybe_dispatch can fuse
    the pan render into the frame program (_pan_frame_fused) instead of
    materializing tiles in a separate dispatch.  materialize() is the
    fallback for paths that need the actual array (renderFrames).

    Trade-off: a pan LOOP saves one jit
    dispatch + one HBM tile round-trip per frame; an identical-content
    REDRAW under an unchanged pan re-renders the layer in-trace (~the
    layer's device cost) where the old path reused the materialized tiles.
    Pan loops change the view every frame, so the loop is the common case.
    """

    def __init__(self, scene, view, background, over_tiles=None):
        self.scene = scene
        self.view = tuple(view)
        self.background = tuple(background)
        # resident transparent-baked static-UI tiles (context._layer_split
        # transparent form), blended over the pan tiles in-trace
        self.over_tiles = over_tiles

    def _offsets(self):
        s = self.scene
        vy, ry = s._view_y_subrows(self.view[1])
        ox = float(self.view[0]) + s.off[0]
        vx = int(np.floor(ox / s.tile_w))
        rx = ox - vx * s.tile_w
        return (np.int32(vx), np.int32(vy), np.float32(rx), np.int32(ry))

    def materialize(self) -> jax.Array:
        tiles = self.scene.render_tiles(view_x=self.view[0],
                                        view_y=self.view[1],
                                        background=self.background)
        if self.over_tiles is not None:
            tiles = _blend_over_tiles(self.over_tiles, tiles)
        return tiles

    def execute_over(self, plan, device_arrays, background) -> jax.Array:
        """Fused dispatch: the frame plan composites its dynamic suffix over
        this layer, rendered in-trace at the pending view offset."""
        from vgtpu.raster.frame import _plan_statics, composite_arrays

        s = self.scene
        d = device_arrays
        vx, vy, rx, ry = self._offsets()
        pan_st = s._pan_statics()
        pan_st["tiles_only"] = True
        return _pan_frame_fused(
            s.d, jnp.asarray(np.asarray(self.background, np.float32)),
            vx, vy, rx, ry,
            d["chunk_pools"], d["entry_backdrop"], composite_arrays(d),
            jnp.asarray(np.asarray(background, np.float32)),
            self.over_tiles,
            pan_st=tuple(sorted(pan_st.items())),
            frame_st=_plan_statics(plan, d),
        )
