"""SVG loader, benchmark scenes, vgpp wrapper, and the five BASELINE.json
capability tiers as golden-image regression tests."""

from pathlib import Path

import numpy as np
import pytest

import vgtpu as vg
from vgtpu.helpers.vgpp import Renderer
from vgtpu.scenes.svg import load_svg, render_svg
from vgtpu.scenes.tiers import golden_diff, render_tier
from vgtpu.scenes.tiger import tiger_svg_text

GOLDEN_DIR = Path(__file__).parent / "goldens"


def _check_golden(name: str, img_u8: np.ndarray, tol=2.0):
    """Compare against a committed golden.  A missing golden FAILS under
    CI=1 / VGTPU_STRICT_GOLDENS=1 (a deleted golden must not silently turn a
    regression test into a no-op); interactively it is (re)created once."""
    import os

    GOLDEN_DIR.mkdir(exist_ok=True)
    path = GOLDEN_DIR / f"{name}.npz"
    if not path.exists():
        if os.environ.get("CI") or os.environ.get("VGTPU_STRICT_GOLDENS"):
            pytest.fail(f"golden {name} missing (strict mode refuses to regenerate)")
        np.savez_compressed(path, img=img_u8)
        pytest.skip(f"golden {name} created")
    want = np.load(path)["img"]
    assert want.shape == img_u8.shape
    mean, far = golden_diff(want, img_u8)
    assert mean < tol, f"golden {name}: mean diff {mean}"
    assert far < 0.01, f"golden {name}: too many changed pixels"


def _ctx(w, h):
    ctx = vg.createContext()
    vg.begin(ctx, 0, w, h, 1.0)
    return ctx


# ---- SVG loader ------------------------------------------------------------

def test_svg_parse_basic():
    doc = load_svg(
        '<svg width="100" height="50">'
        '<path d="M10 10 L90 10 L90 40 Z" fill="#ff0000"/>'
        '<g transform="translate(5,5)">'
        '<path d="M0 0 C10 0 10 10 0 10 Z" fill="none" stroke="rgb(0,0,255)" stroke-width="2"/>'
        "</g></svg>"
    )
    assert doc.width == 100 and doc.height == 50
    assert len(doc.paths) == 2
    assert doc.paths[0].fill == vg.color4ub(255, 0, 0, 255)
    assert doc.paths[1].fill is None
    assert doc.paths[1].stroke == vg.color4ub(0, 0, 255, 255)
    np.testing.assert_allclose(doc.paths[1].transform[4:6], [5, 5])


def test_svg_renders():
    ctx = _ctx(100, 50)
    doc = load_svg('<svg width="100" height="50">'
                   '<path d="M10 10 H90 V40 H10 Z" fill="#00ff00"/></svg>')
    render_svg(ctx, doc)
    vg.end(ctx, background=(0, 0, 0, 1))
    img = np.asarray(ctx.frame_image)
    assert img[25, 50, 1] > 0.9


def test_svg_arc_command():
    ctx = _ctx(100, 100)
    doc = load_svg('<svg width="100" height="100">'
                   '<path d="M50 10 A40 40 0 1 1 49.9 10 Z" fill="#ffffff"/></svg>')
    render_svg(ctx, doc)
    vg.end(ctx, background=(0, 0, 0, 1))
    img = np.asarray(ctx.frame_image)
    assert img[50, 50, 0] > 0.9     # circle interior
    assert img[12, 12, 0] < 0.1     # corner outside


def test_tiger_scene_statistics():
    doc = load_svg(tiger_svg_text())
    assert len(doc.paths) == 240
    n_curves = sum(p.d.count("C") for p in doc.paths)
    assert n_curves > 1500


def test_real_tiger_asset_renders():
    """The real Ghostscript tiger, WHEN the asset is provided: unsourceable
    in this zero-egress environment (PARITY.md), so the test skips unless
    assets/tiger.svg exists — the moment it lands, the parity claim becomes
    concrete: the scene must load through the hook, render non-trivially,
    and reproduce a committed CRC (assets/tiger.crc, written on first run)."""
    import os
    import zlib

    from vgtpu.scenes.tiger import ASSET, draw_tiger, load_tiger

    if not os.path.exists(ASSET):
        pytest.skip("assets/tiger.svg not provided (see PARITY.md)")
    doc = load_tiger()
    assert len(doc.paths) > 100          # the real tiger has 240 paths
    ctx = vg.createContext()
    vg.begin(ctx, 0, 640, 640, 1.0)
    draw_tiger(ctx, 20, 20, 0.55)
    img = np.asarray(vg.end(ctx, background=(1, 1, 1, 1)))
    assert np.isfinite(img).all()
    # non-trivial coverage: the tiger body must darken a real pixel area
    dark = (img[..., :3].sum(axis=-1) < 1.5).mean()
    assert dark > 0.05
    crc = zlib.crc32((img * 255).astype(np.uint8).tobytes())
    crc_path = ASSET.replace(".svg", ".crc")
    if os.path.exists(crc_path):
        committed = int(open(crc_path).read().strip())
        assert crc == committed, (
            f"real-tiger render changed: crc {crc} != committed {committed}")
    else:
        with open(crc_path, "w") as f:
            f.write(str(crc))


# ---- vgpp wrapper ----------------------------------------------------------

def test_vgpp_renderer_roundtrip():
    r = Renderer()
    r.begin_frame(128, 64)
    r.begin_path().rounded_rect(10, 10, 60, 40, 8).fill(vg.color4ub(255, 0, 0, 255))
    shape = r.create_shape()
    with shape:
        vg.beginPath(r.ctx)
        vg.circle(r.ctx, 100, 32, 20)
        vg.fillPath(r.ctx, vg.Colors.Blue, vg.FillFlags.ConvexAA)
    r.submit(shape)
    r.end_frame(background=(1, 1, 1, 1))
    img = np.asarray(r.ctx.frame_image)
    assert img[30, 30, 0] > 0.9    # red rect
    assert img[32, 100, 2] > 0.9   # blue circle via shape


# ---- the five capability tiers (BASELINE.json configs) ---------------------

def test_tier1_flatten_polyline_stroke_no_aa():
    _check_golden("tier1_rects_noaa", render_tier("tier1_rects_noaa"))


def test_tier2_curves_aa_joins_caps():
    _check_golden("tier2_curves_aa", render_tier("tier2_curves_aa"))


def test_tier3_concave_fills_winding():
    _check_golden("tier3_winding", render_tier("tier3_winding"))


def test_tier4_text_atlas():
    _check_golden("tier4_text", render_tier("tier4_text"))


def test_tier5_full_frame():
    _check_golden("tier5_full", render_tier("tier5_full"))


def test_svg_clip_path():
    """<clipPath> defs + clip-path=url(#id) route through the engine clip."""
    doc = load_svg(
        '<svg width="64" height="64">'
        '<defs><clipPath id="c"><path d="M0 0 H32 V64 H0 Z"/></clipPath></defs>'
        '<path clip-path="url(#c)" d="M8 8 H56 V56 H8 Z" fill="#00ff00"/>'
        "</svg>"
    )
    assert "c" in doc.clips and doc.paths[0].clip_id == "c"
    ctx = _ctx(64, 64)
    render_svg(ctx, doc)
    vg.end(ctx, background=(0, 0, 0, 1))
    img = np.asarray(ctx.frame_image)
    assert img[32, 16, 1] > 0.9    # left half: green (inside clip)
    assert img[32, 48, 1] < 0.1    # right half: clipped away


def test_real_matplotlib_logo_renders():
    import glob

    srcs = glob.glob("/root/.cache/uv/**/mpl-data/images/matplotlib.svg", recursive=True)
    if not srcs:
        pytest.skip("matplotlib svg not present")
    doc = load_svg(srcs[0])
    assert len(doc.paths) > 10
    ctx = _ctx(128, 128)
    vg.transformScale(ctx, 128 / max(doc.width, 1), 128 / max(doc.height, 1))
    render_svg(ctx, doc)
    vg.end(ctx, background=(1, 1, 1, 1))
    img = np.asarray(ctx.frame_image)
    # the logo has colored wedges: some saturated non-gray pixels must exist
    sat = np.abs(img[..., 0] - img[..., 1]) + np.abs(img[..., 1] - img[..., 2])
    assert (sat > 0.4).sum() > 100
