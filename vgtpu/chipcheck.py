"""Checks of the frame pipeline on a GPU against references it can trust:
the same frame rendered on the CPU in the same process, the committed golden
images, fresh renders of the same content, and the brute-force oracle.

chip_smoke.py runs them as its phases and the tests marked `gpu` call them
in-process; each returns a dict of what it measured and raises
AssertionError when a limit is broken.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time

import numpy as np

# f32 image limit between two devices or two paths: scatter-add order and
# FMA contraction move the last bits of winding sums
TOL_F32 = 1e-4
TOL_U8 = 1            # the same, after u8 quantisation
TOL_KERNEL = 1e-5     # coverage vs the XLA scan: same terms, same order
# Non-AA draws and clip masks threshold coverage at exactly 1/2, so where a
# pixel's coverage lies within TIE of 1/2 the last bits of its winding sum
# decide between 0 and 1; such pixels are left out of image comparisons
# (and must stay under MAX_TIE_SHARE of the image).
TIE = 1e-3
MAX_TIE_SHARE = 1e-3
BG = (0.12, 0.12, 0.13, 1.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def _on(device):
    import jax

    return jax.default_device(device) if device is not None else (
        contextlib.nullcontext())


def render(draw, w: int, h: int, *, ss: int = 1, dpr: float = 1.0,
           device=None, bg=BG, **cfg):
    """A fresh context draws one frame through vg.begin/end.
    Returns (f32 (H, W, 4) image, u8 readback, context)."""
    import vgtpu as vg

    with _on(device):
        ctx = vg.createContext(vg.ContextConfig(coverage_supersample=ss, **cfg))
        vg.begin(ctx, 0, w, h, dpr)
        draw(ctx)
        img = np.asarray(vg.end(ctx, background=bg))
        return img, np.asarray(ctx.readback_u8()), ctx


def threshold_ties(ctx) -> np.ndarray:
    """(H, W) mask of the pixels of ctx's last frame where a non-AA draw or
    a clip shape has coverage within TIE of the 1/2 threshold."""
    from vgtpu.ops.coverage import entry_coverage_from_pools
    from vgtpu.raster.binning import K_CLIP_ADD

    plan, d = ctx.last_plan, ctx.last_device_arrays
    ne = plan.entry_backdrop.shape[0]
    w = np.asarray(entry_coverage_from_pools(d["chunk_pools"], ne, plan.tile_h,
                                             plan.tile_w))
    w = w + plan.entry_backdrop[:, :, None]
    cov = np.where(plan.entry_rule[:, None, None] == 0,
                   np.minimum(np.abs(w), 1.0),
                   1.0 - np.abs(np.mod(w, 2.0) - 1.0))
    thresholded = (plan.entry_aa == 0) | (plan.entry_kind == K_CLIP_ADD)
    tie_e = thresholded[:, None, None] & (np.abs(cov - 0.5) < TIE)
    te = plan.tile_entries
    tie_t = np.zeros((te.shape[0], plan.tile_h, plan.tile_w), bool)
    for slot in range(te.shape[1]):
        e = te[:, slot]
        tie_t |= tie_e[np.maximum(e, 0)] & (e >= 0)[:, None, None]
    ss = plan.supersample
    th_o = plan.tile_h // ss
    tie_t = tie_t.reshape(plan.nty, plan.ntx, th_o, ss, plan.tile_w).any(axis=3)
    img = tie_t.transpose(0, 2, 1, 3).reshape(plan.nty * th_o, plan.ntx * plan.tile_w)
    return img[: plan.height, : plan.width]


def compare(a, b, what: str, tol_f32: float = TOL_F32, a_u8=None, b_u8=None,
            ties=None) -> dict:
    """Max |difference| of two images, leaving out `ties` (threshold_ties)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}"
    assert np.isfinite(a).all() and np.isfinite(b).all(), f"{what}: non-finite"
    keep = np.ones(a.shape[:2], bool) if ties is None else ~ties
    out = {"ties": int((~keep).sum())}
    assert out["ties"] <= MAX_TIE_SHARE * keep.size, (
        f"{what}: {out['ties']} threshold ties")
    d32 = float(np.abs(a - b)[keep].max())
    out["max_f32"] = d32
    assert d32 <= tol_f32, f"{what}: max |f32 diff| {d32} > {tol_f32}"
    if a_u8 is not None:
        du8 = int(np.abs(a_u8.astype(np.int32) - b_u8.astype(np.int32))[keep].max())
        out["max_u8"] = du8
        assert du8 <= TOL_U8, f"{what}: max |u8 diff| {du8} > {TOL_U8}"
    return out


def _median_ms(fn, reps: int = 20) -> float:
    fn().block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


# ---- phases ----------------------------------------------------------------

def device_info() -> dict:
    import jax

    devs = jax.devices()
    assert devs and all(d.platform == "gpu" for d in devs), (
        f"no GPU: JAX sees {[d.platform for d in devs]}")
    cpus = jax.devices("cpu")      # raises when the CPU backend is missing
    assert cpus, "no CPU device for the reference renders"
    return {
        "jax": jax.__version__, "device_kind": devs[0].device_kind,
        "count": len(devs), "nvidia_smi": nvidia_smi(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": jax.config.jax_compilation_cache_dir,
    }


def native_engine() -> dict:
    from vgtpu import native

    assert native.available(), "native engine fell back to numpy"
    assert native.pathrec() is not None, "path recorder fell back to Python"
    src = os.path.join(REPO, "native", "vg_native.cpp")
    lib = os.path.abspath(native._LIB)
    assert lib.startswith(REPO + os.sep), f"library {lib} is outside the checkout"
    assert os.path.getmtime(lib) >= os.path.getmtime(src), "stale library"
    return {"lib": os.path.relpath(lib, REPO)}


def main_frame(ss: int) -> dict:
    """The 1920x1080 benchmark frame on the GPU vs the CPU, one process."""
    import jax

    from vgtpu.scenes.demo_ui import draw_benchmark_frame

    def draw(c):
        draw_benchmark_frame(c, 0.0)

    t0 = time.perf_counter()
    g, g8, ctx = render(draw, 1920, 1080, ss=ss)
    cold_s = time.perf_counter() - t0
    glyphs = len(ctx.font_system.atlas.glyphs) if ctx.font_system else 0
    assert glyphs > 0, "benchmark frame rendered without its text"
    c, c8, cctx = render(draw, 1920, 1080, ss=ss, device=jax.devices("cpu")[0])
    out = compare(g, c, f"1080p frame ss={ss} gpu vs cpu", a_u8=g8, b_u8=c8,
                  ties=threshold_ties(ctx))
    out.update(ss=ss, glyphs=glyphs, gpu_first_frame_s=round(cold_s, 2),
               chunks=int(ctx.last_plan.stats.get("chunks", 0)))
    return out


def goldens() -> dict:
    from vgtpu.scenes.tiers import TIERS, golden_diff, render_tier

    out = {}
    for name in TIERS:
        want = np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npz"))["img"]
        got = render_tier(name)
        mean, far = golden_diff(want, got)
        assert mean < 2.0 and far < 0.01, (
            f"golden {name}: mean |diff| {mean}, share > 32 levels {far}")
        out[name] = round(mean, 4)
    return out


def _overlay(k):
    import vgtpu as vg
    from vgtpu.scenes.demo_ui import draw_benchmark_frame

    def draw(c):
        draw_benchmark_frame(c, 0.0)
        vg.beginPath(c)
        vg.rect(c, 1800, 1000, 60, 40)
        vg.fillPath(c, vg.color4ub(50 + 17 * k, 120, 200, 180),
                    vg.FillFlags.ConvexAA)
    return draw


def serving_paths(W: int = 1920, H: int = 1080) -> dict:
    """Each serving fast path against a fresh render of the same content."""
    import jax

    import vgtpu as vg
    from vgtpu.raster.batch import VariantBatch
    from vgtpu.raster.retained import RetainedScene
    from vgtpu.scenes.demo_ui import draw_benchmark_frame, draw_demo_ui
    from vgtpu.scenes.tiger import draw_tiger

    out = {}

    def frame(ctx, draw):
        vg.begin(ctx, 0, W, H, 1.0)
        draw(ctx)
        img = np.asarray(vg.end(ctx, background=BG))
        return img, np.asarray(ctx.readback_u8())

    # frame memo: an identical redraw reuses the resident plan
    ctx = vg.createContext()
    frame(ctx, _overlay(0))
    got, got8 = frame(ctx, _overlay(0))
    assert ctx.profiler.counters.get("memo_hits", 0) >= 1, "no frame-memo hit"
    want, want8, fresh = render(_overlay(0), W, H)
    out["frame_memo"] = compare(got, want, "frame-memo redraw", a_u8=got8,
                                b_u8=want8, ties=threshold_ties(fresh))

    # paint memo: only a fill colour changes
    got, got8 = frame(ctx, _overlay(3))
    assert ctx.profiler.counters.get("memo_paint_hits", 0) >= 1, "no paint-memo hit"
    want, want8, fresh = render(_overlay(3), W, H)
    out["paint_memo"] = compare(got, want, "paint-memo frame", a_u8=got8,
                                b_u8=want8, ties=threshold_ties(fresh))

    # layer memo: cached tiger list + immediate UI (the app pattern); the
    # fresh render submits the same list once, before any layer exists
    def app(t):
        def draw(c):
            cl = getattr(c, "_smoke_cl", None)
            if cl is None:
                cl = c._smoke_cl = vg.createCommandList(
                    c, vg.CommandListFlags.Cacheable)
                vg.beginCommandList(c, cl)
                draw_tiger(c, 20, 60, 1.06)
                vg.endCommandList(c)
            vg.submitCommandList(c, cl)
            draw_demo_ui(c, t)
        return draw

    ctx = vg.createContext()
    for k in range(6):
        got, got8 = frame(ctx, app(0.3 + 0.05 * k))
    assert ctx.profiler.counters.get("layer_hits", 0) >= 1, "no layer-memo hit"
    want, want8, fresh = render(app(0.3 + 0.05 * 5), W, H)
    out["layer_memo"] = compare(got, want, "layer-memo app frame", a_u8=got8,
                                b_u8=want8, ties=threshold_ties(fresh))

    # renderFrames: three canvases of different sizes in one dispatch
    sizes = [(W // 3, H // 3), (2 * W // 3, 2 * H // 3), (W, H)]
    draws = [lambda c: draw_demo_ui(c, 0.1, x0=40.0, y0=10.0),
             lambda c: draw_tiger(c, 10, 10, 0.8),
             lambda c: draw_benchmark_frame(c, 0.2)]
    ctxs = []
    for (w, h), draw in zip(sizes, draws):
        c = vg.createContext()
        vg.begin(c, 0, w, h, 1.0)
        draw(c)
        vg.end(c, background=BG, dispatch=False)
        ctxs.append(c)
    imgs = vg.renderFrames(ctxs)
    out["render_frames"] = {}
    for (w, h), draw, img in zip(sizes, draws, imgs):
        want, _, fresh = render(draw, w, h)
        out["render_frames"][f"{w}x{h}"] = compare(
            img, want, f"renderFrames {w}x{h}", ties=threshold_ties(fresh))

    # VariantBatch, K=4 paint variants of the benchmark frame
    vb = VariantBatch.bake(vg.createContext(), [_overlay(k) for k in range(4)],
                           W, H, background=BG)
    stack = np.asarray(vb.render(background=BG))
    out["variant_batch"] = []
    for k in range(4):
        want, _, fresh = render(_overlay(k), W, H)
        out["variant_batch"].append(compare(
            stack[k], want, f"VariantBatch variant {k}",
            ties=threshold_ties(fresh)))

    # RetainedScene: pan at an integer and a fractional x, against the same
    # pan on the CPU and against a direct render of the moved scene.  The
    # direct render resamples text at other positions than the panned
    # scene's in-trace resample, so that comparison keeps the 3e-3 limit
    # tests/test_retained.py holds textured pans to.
    def bake(device=None):
        with _on(device):
            c = vg.createContext()
            vg.begin(c, 0, W, H, 1.0)
            draw_benchmark_frame(c, 0.0)
            return RetainedScene.bake(c, background=BG)

    scene, scene_cpu = bake(), bake(jax.devices("cpu")[0])
    out["retained_pan"] = {}
    for view in ((37, 5), (12.5, 3)):
        got = np.asarray(scene.render(*view))
        with _on(jax.devices("cpu")[0]):
            cpu = np.asarray(scene_cpu.render(*view))

        def moved(c, view=view):
            vg.pushState(c)
            vg.transformTranslate(c, -view[0], -view[1])
            draw_benchmark_frame(c, 0.0)
            vg.popState(c)
        want, _, fresh = render(moved, W, H)
        ties = threshold_ties(fresh)
        out["retained_pan"][str(view)] = {
            "vs_cpu": compare(got, cpu, f"pan at {view} gpu vs cpu", ties=ties),
            "vs_direct": compare(got, want, f"pan at {view} vs direct",
                                 tol_f32=3e-3, ties=ties)}

    # image pattern: the device sampler vs the host sampler, both on the GPU
    rng = np.random.default_rng(3)
    tex = rng.integers(0, 256, (64, 64, 4), np.uint8)
    tex[..., 3] = 255

    def pattern(c):
        himg = vg.createImage(c, 64, 64, 0, tex)
        p = vg.createImagePattern(c, 100, 80, 150, 120, 0.3, himg)
        vg.beginPath(c)
        vg.roundedRect(c, 60, 40, 900, 500, 30)
        vg.fillPath(c, p, vg.Colors.White, vg.FillFlags.ConvexAA)
    dev, dev8, _ = render(pattern, 1024, 576)
    host, host8, fresh = render(pattern, 1024, 576, device_sampling=False)
    out["image_pattern"] = compare(dev, host, "image pattern device vs host "
                                   "sampler", a_u8=dev8, b_u8=host8,
                                   ties=threshold_ties(fresh))
    return out


def coverage_kernel(reps: int = 20) -> dict:
    """The frame's coverage formulation (ops/coverage.chunk_coverage)
    against the XLA scan on the 1080p benchmark frame's pools and against
    the oracle on a small polygon, and the median time of each formulation
    over those pools."""
    import jax

    from vgtpu.ops import coverage as cov
    from vgtpu.oracle import coverage_oracle
    from vgtpu.scenes.demo_ui import draw_benchmark_frame

    _, _, ctx = render(lambda c: draw_benchmark_frame(c, 0.0), 1920, 1080)
    th, tw = ctx.last_plan.tile_h, ctx.last_plan.tile_w
    pools = [ce for ce, _ in ctx.last_device_arrays["chunk_pools"]]
    forms = {
        "scan": jax.jit(lambda ce: cov.coverage_chunks_body(ce, th, tw).reshape(
            ce.shape[0], -1)),
        "frame": jax.jit(lambda ce: cov.chunk_coverage(ce, th, tw)),
    }
    worst = 0.0
    for ce in pools:
        ref = np.asarray(forms["scan"](ce))
        worst = max(worst, float(np.abs(np.asarray(forms["frame"](ce)) - ref).max()))
    assert worst <= TOL_KERNEL, f"coverage vs scan: max |diff| {worst}"
    times = {name: round(sum(_median_ms(lambda f=f, ce=ce: f(ce), reps)
                             for ce in pools), 4)
             for name, f in forms.items()}

    # a small polygon against the supersampled oracle (tests/test_coverage)
    pts = np.array([(3.2, 2.1), (28.7, 5.4), (10.1, 25.6)], np.float64)
    edges = np.concatenate([pts, np.roll(pts, -1, axis=0)], axis=1)
    chunk = np.zeros((1, 4, 4), np.float32)
    chunk[0, :3] = edges
    got = np.asarray(cov.chunk_coverage(chunk, 8, 128)).reshape(8, 128)
    want = coverage_oracle(edges.astype(np.float32), 128, 8, samples=16)
    oracle_diff = float(np.abs(np.minimum(np.abs(got), 1.0) - want).max())
    assert oracle_diff < 0.05, f"coverage vs oracle: max |diff| {oracle_diff}"
    return {"vs_scan_max": worst, "vs_oracle_max": oracle_diff,
            "pools": [list(ce.shape) for ce in pools],
            "median_ms_sum_over_pools": times}


def four_cards(w: int = 1920, h: int = 1080) -> dict:
    """The tile-sharded frame at 2x (3840x2160 by default) and a K=8 variant
    batch at w x h spread over four devices, each against the same work on
    one device."""
    import jax

    import vgtpu as vg
    from vgtpu.parallel.sharding import make_mesh, render_frame_sharded
    from vgtpu.raster.batch import VariantBatch
    from vgtpu.raster.frame import execute_plan
    from vgtpu.scenes.demo_ui import draw_benchmark_frame

    devs = jax.devices()
    assert len(devs) >= 4, f"needs four devices, found {len(devs)}"
    out = {}
    _, _, ctx = render(lambda c: draw_benchmark_frame(c, 0.0), w, h, dpr=2.0)
    plan, d = ctx.last_plan, ctx.last_device_arrays
    assert (plan.width, plan.height) == (2 * w, 2 * h)
    mesh = make_mesh(4)
    sharded = np.asarray(render_frame_sharded(plan, d, mesh, background=BG))
    single = np.asarray(execute_plan(plan, background=BG, device_arrays=d))
    out["sharded_4k"] = compare(sharded, single, "tile-sharded 4K frame",
                                ties=threshold_ties(ctx))

    vb = VariantBatch.bake(vg.createContext(), [_overlay(k) for k in range(8)],
                           w, h, background=BG)
    vmesh = jax.make_mesh((4,), ("variants",), devices=devs[:4])
    stack = np.asarray(vb.render_sharded(vmesh, background=BG))
    assert stack.shape == (8, h, w, 4)
    out["variant_batch_k8"] = []
    for k in range(8):
        want, _, fresh = render(_overlay(k), w, h)
        out["variant_batch_k8"].append(compare(
            stack[k], want, f"sharded variant {k}",
            ties=threshold_ties(fresh))["max_f32"])
    return out
