"""Text subsystem: fonts, atlas packing, glyph/string caches, layout
(reference seams: fontstash.h atlas + caches, vg.cpp text layout)."""

import numpy as np
import pytest

import vgtpu as vg
from vgtpu.fonts.fontstash import SkylineAtlas
from vgtpu.fonts.system import FontSystem

from tests.fontdata import FONT_DATA, MONO_PATH  # shared fonts (re-exported)


def make_ctx(w=256, h=96):
    ctx = vg.createContext()
    vg.begin(ctx, 0, w, h, 1.0)
    return ctx


def add_font(ctx, name="sans", data=FONT_DATA):
    return vg.createFont(ctx, name, data, len(data), 0)


def test_skyline_packer_fills_without_overlap():
    at = SkylineAtlas(64, 64)
    rng = np.random.default_rng(0)
    used = np.zeros((64, 64), bool)
    placed = 0
    for _ in range(60):
        w, h = rng.integers(4, 16, 2)
        spot = at.add_rect(int(w), int(h))
        if spot is None:
            continue
        x, y = spot
        region = used[y : y + h, x : x + w]
        assert not region.any(), "overlapping placement"
        region[:] = True
        placed += 1
    assert placed > 10


def test_create_font_and_lookup():
    ctx = make_ctx()
    f = add_font(ctx)
    assert vg.isValid(f)
    assert vg.getFontByName(ctx, "sans") == f
    assert not vg.isValid(vg.getFontByName(ctx, "nope"))


def test_measure_text_sane_metrics():
    ctx = make_ctx()
    f = add_font(ctx)
    cfg = vg.makeTextConfig(ctx, f, 20.0, vg.TextAlign.BaselineLeft, vg.Colors.Black)
    w1, b1 = vg.measureText(ctx, cfg, 0, 0, "i")
    w2, b2 = vg.measureText(ctx, cfg, 0, 0, "WWW")
    assert 0 < w1 < w2
    assert b2[2] > b2[0]
    lh = vg.getTextLineHeight(ctx, cfg)
    assert 18 < lh < 30


def test_mono_font_advances_uniform():
    ctx = make_ctx()
    data = MONO_PATH.read_bytes()
    f = vg.createFont(ctx, "mono", data, len(data), 0)
    cfg = vg.makeTextConfig(ctx, f, 16.0, vg.TextAlign.BaselineLeft, vg.Colors.Black)
    wi, _ = vg.measureText(ctx, cfg, 0, 0, "iiii")
    ww, _ = vg.measureText(ctx, cfg, 0, 0, "WWWW")
    assert abs(wi - ww) < 0.01


def test_kerning_applied():
    fs = FontSystem()
    fi = fs.add_font("sans", FONT_DATA)
    a = fs.bake_string(fi, 40.0, "A").width
    v = fs.bake_string(fi, 40.0, "V").width
    av = fs.bake_string(fi, 40.0, "AV").width
    assert av < a + v - 0.2, "kern pair AV must tighten"


def test_glyph_cache_hits():
    fs = FontSystem()
    fi = fs.add_font("sans", FONT_DATA)
    fs.bake_string(fi, 20.0, "abcabc")
    n1 = len(fs.atlas.glyphs)
    fs.bake_string(fi, 20.0, "cabbag")
    n2 = len(fs.atlas.glyphs)
    assert n2 == n1 + 1  # only 'g' is new
    # same glyphs at a different size are distinct cache entries
    fs.bake_string(fi, 21.0, "abc")
    assert len(fs.atlas.glyphs) == n2 + 3


def test_string_cache_invalidated_by_atlas_generation():
    fs = FontSystem()
    fi = fs.add_font("sans", FONT_DATA)
    b1 = fs.bake_string(fi, 20.0, "hello")
    b2 = fs.bake_string(fi, 20.0, "hello")
    assert b1 is b2  # cache hit (FONSstring atlasID behavior)
    fs.atlas.generation += 1
    b3 = fs.bake_string(fi, 20.0, "hello")
    assert b3 is not b1


def test_text_renders_pixels():
    ctx = make_ctx()
    f = add_font(ctx)
    cfg = vg.makeTextConfig(ctx, f, 32.0, vg.TextAlign.TopLeft, vg.Colors.Black)
    vg.text(ctx, cfg, 10, 10, "Hi")
    vg.end(ctx, background=(1, 1, 1, 1))
    img = np.asarray(ctx.frame_image)
    # dark pixels must exist in the text area
    region = img[10:50, 10:60, 0]
    assert region.min() < 0.3
    assert (region < 0.5).sum() > 20


def test_min_font_size_culls():
    ctx = make_ctx()
    f = add_font(ctx)
    cfg = vg.makeTextConfig(ctx, f, 3.0, vg.TextAlign.TopLeft, vg.Colors.Black)
    vg.text(ctx, cfg, 10, 10, "tiny")
    assert len(ctx.ops) == 0  # < 4px culled (vg.cpp:4184)


def test_alignment_offsets():
    ctx = make_ctx()
    f = add_font(ctx)
    for align, cmp in [
        (vg.TextAlign.BaselineLeft, lambda b: b[0] >= 99),
        (vg.TextAlign.BaselineRight, lambda b: b[2] <= 101),
        (vg.TextAlign.BaselineCenter, lambda b: abs((b[0] + b[2]) / 2 - 100) < 2),
    ]:
        cfg = vg.makeTextConfig(ctx, f, 24.0, align, vg.Colors.Black)
        _w, b = vg.measureText(ctx, cfg, 100, 50, "word")
        assert cmp(b), (align, b)


def test_text_break_lines():
    ctx = make_ctx()
    f = add_font(ctx)
    cfg = vg.makeTextConfig(ctx, f, 16.0, vg.TextAlign.TopLeft, vg.Colors.Black)
    s = "the quick brown fox\njumps"
    rows = vg.textBreakLines(ctx, cfg, s, None, 70.0, 100)
    assert len(rows) >= 3
    # hard newline honored
    texts = [s[r.start : r.end] for r in rows]
    assert "jumps" in texts
    for r in rows:
        assert r.width <= 75.0


def test_text_box_renders_multiple_rows():
    ctx = make_ctx(256, 128)
    f = add_font(ctx)
    cfg = vg.makeTextConfig(ctx, f, 16.0, vg.TextAlign.TopLeft, vg.Colors.Black)
    vg.textBox(ctx, cfg, 8, 8, 90.0, "alpha beta gamma delta", None, 0)
    assert len(ctx.ops) >= 2  # wrapped into multiple rows


def test_glyph_positions():
    ctx = make_ctx()
    f = add_font(ctx)
    cfg = vg.makeTextConfig(ctx, f, 20.0, vg.TextAlign.BaselineLeft, vg.Colors.Black)
    pos = vg.textGlyphPositions(ctx, cfg, 5, 0, "abc")
    assert len(pos) == 3
    assert pos[0].x == 5
    assert pos[0].x < pos[1].x < pos[2].x


def test_fallback_font():
    ctx = make_ctx()
    f = add_font(ctx)
    data = MONO_PATH.read_bytes()
    f2 = vg.createFont(ctx, "mono", data, len(data), 0)
    assert vg.setFallbackFont(ctx, f, f2)


def test_atlas_grow_bumps_generation():
    """Growing the atlas rescales normalized UVs, so it must invalidate baked
    strings via the generation counter (reference: new atlasID on realloc,
    fontstash.h:768)."""
    from vgtpu.fonts.fontstash import GlyphAtlas

    atlas = GlyphAtlas()
    g0 = atlas.generation
    atlas._grow()
    assert atlas.generation == g0 + 1


class _StubFont:
    """Deterministic rasterizer: size-px square filled with a glyph hash."""

    def rasterize(self, gid, size, pad=1):
        n = int(size)
        bm = np.full((n, n), (hash(gid) % 200) + 30, np.uint8)
        return bm, 0, -n, n, n, float(n)


def test_atlas_gc_compaction(monkeypatch):
    """A max-size atlas that overflows compacts: glyphs used this frame or
    the last keep their pixels (relocated, no re-rasterization), stale ones
    are evicted, and the generation bump rebakes cached strings (the
    reference's frame() keeps only the biggest atlas, vg.cpp:1290-1328)."""
    from vgtpu.fonts import fontstash

    monkeypatch.setattr(fontstash, "ATLAS_INITIAL", 64)
    monkeypatch.setattr(fontstash, "ATLAS_MAX", 64)
    at = fontstash.GlyphAtlas()
    f = _StubFont()
    hot = at.get_or_bake(0, f, 1, 16.0)
    hot_pixels = at.bitmap[hot.atlas_y : hot.atlas_y + 16,
                           hot.atlas_x : hot.atlas_x + 16].copy()
    gen0 = at.generation

    gid = 100
    for _frame in range(6):
        at.get_or_bake(0, f, 1, 16.0)      # keep the hot glyph alive
        for _ in range(4):                        # churn unique stale glyphs
            at.get_or_bake(0, f, gid, 16.0)
            gid += 1
        at.end_frame()

    assert at.generation > gen0                   # compaction happened
    gi = at.glyphs[(0, fontstash.glyph_code(1, 160))]
    assert np.array_equal(
        at.bitmap[gi.atlas_y : gi.atlas_y + 16, gi.atlas_x : gi.atlas_x + 16],
        hot_pixels)
    assert (0, fontstash.glyph_code(100, 160)) not in at.glyphs  # evicted
