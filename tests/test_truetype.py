"""The in-repo TrueType reader (vgtpu/fonts/truetype.py) against fontTools
(installed on development machines only; the package never imports it):
cmap, advances, kern pairs and every glyph's pen operations, composites
included."""

import io

import numpy as np
import pytest

from vgtpu.fonts.truetype import Font, TrueTypeReader

from tests.fontdata import FONT_DATA, MONO_PATH


def _fonts():
    out = [("DejaVuSans", FONT_DATA)]
    if MONO_PATH is not None:
        out.append(("DejaVuSansMono", MONO_PATH.read_bytes()))
    return out


def _ops(seq):
    return [(op, tuple(None if p is None else (float(p[0]), float(p[1]))
                       for p in args)) for op, args in seq]


@pytest.fixture(scope="module", params=[n for n, _ in _fonts()])
def pair(request):
    tt = pytest.importorskip("fontTools.ttLib")
    data = dict(_fonts())[request.param]
    ref = tt.TTFont(io.BytesIO(data), lazy=True)
    return TrueTypeReader(data), ref


def test_metrics_cmap_and_advances_match_fonttools(pair):
    r, ref = pair
    order = ref.getGlyphOrder()
    gid = {n: i for i, n in enumerate(order)}
    assert r.num_glyphs == len(order)
    assert r.units_per_em == ref["head"].unitsPerEm
    hh = ref["hhea"]
    assert (r.ascent, r.descent, r.line_gap) == (hh.ascent, hh.descent, hh.lineGap)
    assert r.cmap == {cp: gid[n] for cp, n in ref.getBestCmap().items()}
    hm = ref["hmtx"]
    assert [int(a) for a in r.advance] == [hm[n][0] for n in order]
    assert [int(b) for b in r.lsb] == [hm[n][1] for n in order]


def test_kern_pairs_match_fonttools(pair):
    r, ref = pair
    gid = {n: i for i, n in enumerate(ref.getGlyphOrder())}
    want = {}
    if "kern" in ref:
        for sub in ref["kern"].kernTables:
            if getattr(sub, "format", None) == 0:
                want.update({(gid[a], gid[b]): v
                             for (a, b), v in sub.kernTable.items()})
    assert r.kern == want


def test_every_glyph_outline_matches_fonttools(pair):
    from fontTools.pens.recordingPen import DecomposingRecordingPen

    r, ref = pair
    gs = ref.getGlyphSet()
    composites = 0
    for i, name in enumerate(ref.getGlyphOrder()):
        pen = DecomposingRecordingPen(gs)
        gs[name].draw(pen)
        want, got = _ops(pen.value), _ops(r.outline_ops(i))
        assert [op for op, _ in got] == [op for op, _ in want], name
        for (_, a), (_, b) in zip(got, want):
            assert len(a) == len(b), name
            for p, q in zip(a, b):
                assert (p is None) == (q is None), name
                if p is not None:
                    np.testing.assert_allclose(p, q, atol=1e-9, err_msg=name)
        composites += ref["glyf"][name].isComposite()
    if "DejaVuSans" in ref["name"].getDebugName(4):
        assert composites > 1000        # the accented Latin range


def test_font_api_on_glyph_indices():
    f = Font("sans", FONT_DATA)
    a, v = f.glyph_index(ord("A")), f.glyph_index(ord("V"))
    assert a and v and f.glyph_index(0x10FFFF) is None
    assert f.kern_u(a, v) < 0            # the AV pair tightens
    assert f.advance_u(a) > 0
    bm, x0, y0, w, h, adv = f.rasterize(a, 24.0)
    assert bm.shape == (h, w) and bm.max() == 255 and adv > 0
    # a composite glyph (e-acute) rasterizes with its accent
    e, ea = f.glyph_index(ord("e")), f.glyph_index(0xE9)
    _, _, ye, _, he, _ = f.rasterize(e, 24.0)
    _, _, yea, _, hea, _ = f.rasterize(ea, 24.0)
    assert yea < ye and hea > he


def test_reader_rejects_non_truetype():
    with pytest.raises(ValueError, match="not a TrueType-outline font"):
        TrueTypeReader(b"\0\1\0\0\0\0" + b"\0" * 64)
