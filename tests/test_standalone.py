"""Standalone path/stroker API (include/vg/path.h, include/vg/stroker.h):
the reference's renderer-independent geometry seam, exposed in this engine's form
(outline contours + winding edges instead of triangle meshes)."""

import numpy as np

import vgtpu as vg


def test_vg_header_symbol_parity():
    """Every function name in the reference's public headers exists here."""
    import glob
    import re

    names = set()
    for f in (glob.glob("/root/reference/include/vg/*.h")
              + glob.glob("/root/reference/include/vg/*.inl")):
        src = open(f, errors="replace").read()
        for m in re.finditer(
            r"\b(?:void|bool|float|uint32_t|uint16_t|Color|GradientHandle|"
            r"ImagePatternHandle|ImageHandle|FontHandle|CommandListHandle|int)"
            r"\s+(\w+)\s*\(", src):
            names.add(m.group(1))
    names -= {"if", "for", "while", "switch", "sizeof"}
    missing = sorted(n for n in names if n not in dir(vg))
    assert not missing, f"missing vg.h symbols: {missing}"


def test_standalone_path_flatten():
    p = vg.createPath()
    vg.pathReset(p, 1.0, 0.25)
    vg.pathMoveTo(p, 10, 10)
    vg.pathCubicTo(p, 40, 0, 80, 60, 110, 30)
    vg.pathLineTo(p, 110, 80)
    vg.pathClose(p)
    vg.pathCircle(p, 60, 60, 20)
    verts = vg.pathGetVertices(p)
    subs = vg.pathGetSubPaths(p)
    assert vg.pathGetNumVertices(p) == len(verts) > 10
    assert vg.pathGetNumSubPaths(p) == len(subs) == 2
    assert subs[0].m_IsClosed and subs[1].m_IsClosed
    assert subs[0].m_FirstVertexID == 0
    # flattened curve stays within the hull's bbox
    sub0 = verts[: subs[0].m_NumVertices]
    assert sub0[:, 0].min() >= 9.9 and sub0[:, 0].max() <= 110.1


def test_standalone_stroker_polyline():
    s = vg.createStroker()
    vg.strokerReset(s, 1.0, 0.25, 1.0)
    pts = np.array([[10, 10], [90, 10], [90, 60]], np.float32)
    m = vg.strokerPolylineStroke(s, vg.Mesh(pos=np.zeros((0, 2), np.float32)),
                                 pts, 3, False, 8.0, vg.LineCap.Round,
                                 vg.LineJoin.Round)
    assert len(m.contours) == 1 and len(m.pos) > 8
    assert m.edges is not None and len(m.edges) == len(m.pos)
    # outline stays within stroke-width distance of the polyline bbox
    assert m.pos[:, 0].min() > 10 - 4.5 and m.pos[:, 0].max() < 90 + 4.5

    m2 = vg.strokerPolylineStrokeAA(s, None, pts, 3, True, 0xFF0000FF, 8.0,
                                    vg.LineCap.Butt, vg.LineJoin.Miter)
    assert len(m2.contours) == 2          # closed stroke = outer + inner ring
    assert m2.colors is not None and (m2.colors == 0xFF0000FF).all()

    m3 = vg.strokerPolylineStrokeAAThin(s, None, pts, 3, False, 0xFFFFFFFF,
                                        vg.LineCap.Butt, vg.LineJoin.Miter)
    # thin strokes expand at fringe width
    assert m3.pos[:, 1].min() >= 10 - 0.51


def test_standalone_convex_fill_fan():
    s = vg.createStroker()
    sq = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], np.float32)
    m = vg.strokerConvexFill(s, None, sq, 4)
    assert m.indices.tolist() == [0, 1, 2, 0, 2, 3]   # reference fan order
    np.testing.assert_array_equal(m.pos, sq)
    m2 = vg.strokerConvexFillAA(s, None, sq, 4, 0x80FFFFFF)
    assert (m2.colors == 0x80FFFFFF).all()


def test_standalone_concave_fill():
    s = vg.createStroker()
    assert vg.strokerConcaveFillBegin(s)
    outer = np.array([[0, 0], [60, 0], [60, 60], [0, 60]], np.float32)
    hole = np.array([[20, 20], [20, 40], [40, 40], [40, 20]], np.float32)
    vg.strokerConcaveFillAddContour(s, outer, 4)
    vg.strokerConcaveFillAddContour(s, hole, 4)
    m = vg.strokerConcaveFillEnd(s, None, vg.FillRule.NonZero)
    assert len(m.contours) == 2 and len(m.edges) == 8
    assert m.fill_rule == vg.FillRule.NonZero

    # the edges render a ring via the engine's coverage (hole preserved)
    from vgtpu.raster.binning import RasterOp, bin_frame, make_solid_paint
    from vgtpu.raster.frame import execute_plan

    op = RasterOp(edges=m.edges,
                  paint=make_solid_paint(np.array([1, 1, 1, 1], np.float32)))
    img = np.asarray(execute_plan(bin_frame([op], 64, 64),
                                  background=(0, 0, 0, 0)))[..., 3]
    assert img[10, 10] > 0.99 and img[30, 30] < 0.01


def test_cl_reset_alias():
    ctx = vg.createContext()
    vg.begin(ctx, 0, 64, 64, 1.0)
    cl = vg.createCommandList(ctx, 0)
    vg.clBeginPath(ctx, cl)
    vg.clRect(ctx, cl, 5, 5, 20, 20)
    vg.clFillPath(ctx, cl, vg.Colors.White, vg.FillFlags.ConvexAA)
    vg.clReset(ctx, cl)                  # the vg.h name
    vg.submitCommandList(ctx, cl)
    assert len(ctx.ops) == 0
