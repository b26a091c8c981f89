"""TrueType font loading + glyph rasterization (replaces stb_truetype,
SURVEY.md §2 #9).

Parsing is a small reader over the sfnt tables the text path needs (head,
hhea, maxp, cmap formats 4 and 12, hmtx, loca, glyf simple and composite,
kern format 0), built on `struct` and numpy; rasterization is OUR engine:
glyph quadratic outlines are flattened with the same Wang-formula machinery
as paths and rasterized with the same exact analytic winding coverage as
the main pipeline (numpy port of ops/coverage.py) — the engine eats its own
dog food for glyphs, like the reference feeding FontStash from
stb_truetype's raster.

Glyphs are identified by glyph index.  Scale convention follows
stb/FontStash: pixel scale = size / (ascent-descent)
(stbtt_ScaleForPixelHeight semantics, used via fons__tt_getPixelHeightScale).
"""

from __future__ import annotations

import struct

import numpy as np


def _edge_coverage_np(edges: np.ndarray, w: int, h: int) -> np.ndarray:
    """Exact analytic box-filter winding coverage, NonZero |w| clamp.
    Same formula as vgtpu.ops.coverage._edge_contribution, dense numpy."""
    if len(edges) == 0:
        return np.zeros((h, w), np.float32)
    px = np.arange(w, dtype=np.float64)[None, :, None]
    py = np.arange(h, dtype=np.float64)[:, None, None]
    x0, y0, x1, y1 = (edges[:, i].astype(np.float64) for i in range(4))
    keep = np.abs(y1 - y0) > 1e-12
    x0, y0, x1, y1 = x0[keep], y0[keep], x1[keep], y1[keep]
    if len(x0) == 0:
        return np.zeros((h, w), np.float32)

    ymin = np.minimum(y0, y1)
    ymax = np.maximum(y0, y1)
    ytop = np.maximum(ymin, py)
    ybot = np.minimum(ymax, py + 1.0)
    hh = np.maximum(ybot - ytop, 0.0)
    s = np.sign(y1 - y0)
    m = (x1 - x0) / (y1 - y0)
    xa = x0 + m * (ytop - y0)
    xb = x0 + m * (ybot - y0)
    u0 = (px + 1.0) - xa
    u1 = (px + 1.0) - xb

    def G(u):
        return np.where(u <= 0.0, 0.0, np.where(u >= 1.0, u - 0.5, 0.5 * u * u))

    du = u1 - u0
    near = np.abs(du) < 1e-6
    k = np.where(
        near,
        np.clip(0.5 * (u0 + u1), 0.0, 1.0),
        (G(u1) - G(u0)) / np.where(near, 1.0, du),
    )
    wnd = (s * hh * k).sum(axis=-1)
    return np.minimum(np.abs(wnd), 1.0).astype(np.float32)


# composite-glyph component flags (OpenType glyf spec)
_ARG_WORDS = 0x0001
_ARGS_XY = 0x0002
_HAVE_SCALE = 0x0008
_MORE = 0x0020
_HAVE_XY_SCALE = 0x0040
_HAVE_2X2 = 0x0080
_SCALED_OFFSET = 0x0800
# cmap subtables in preference order (platform, encoding): the full Unicode
# repertoire first, then the BMP
_CMAP_PREF = ((3, 10), (0, 6), (0, 4), (3, 1), (0, 3), (0, 2), (0, 1), (0, 0))


class TrueTypeReader:
    """The sfnt tables of one TrueType font (the first of a collection).

    Raises ValueError on data that is not a TrueType-outline font."""

    def __init__(self, data: bytes) -> None:
        self.data = data = bytes(data)
        base = 0
        if data[:4] == b"ttcf":
            base = struct.unpack_from(">I", data, 12)[0]
        num_tables = struct.unpack_from(">H", data, base + 4)[0]
        self.tables = {}
        for i in range(num_tables):
            tag, _ck, off, length = struct.unpack_from(
                ">4sIII", data, base + 12 + 16 * i)
            self.tables[tag.decode("latin-1")] = (off, length)
        for need in ("head", "hhea", "maxp", "cmap", "hmtx", "loca", "glyf"):
            if need not in self.tables:
                raise ValueError(f"not a TrueType-outline font: no {need!r} table")
        head = self.tables["head"][0]
        self.units_per_em = struct.unpack_from(">H", data, head + 18)[0]
        loca_long = struct.unpack_from(">h", data, head + 50)[0] == 1
        hhea = self.tables["hhea"][0]
        self.ascent, self.descent, self.line_gap = struct.unpack_from(
            ">hhh", data, hhea + 4)
        n_hmetrics = struct.unpack_from(">H", data, hhea + 34)[0]
        self.num_glyphs = struct.unpack_from(
            ">H", data, self.tables["maxp"][0] + 4)[0]
        hmtx = self.tables["hmtx"][0]
        hm = np.frombuffer(data, ">u2", 2 * n_hmetrics, hmtx).astype(np.int64)
        extra = self.num_glyphs - n_hmetrics
        self.advance = np.concatenate(
            [hm[0::2], np.full(extra, hm[-2], np.int64)])
        lsb = hm[1::2].astype(np.int16).astype(np.int64)
        self.lsb = np.concatenate([lsb, np.frombuffer(
            data, ">i2", extra, hmtx + 4 * n_hmetrics).astype(np.int64)])
        loca = self.tables["loca"][0]
        if loca_long:
            self.loca = np.frombuffer(
                data, ">u4", self.num_glyphs + 1, loca).astype(np.int64)
        else:
            self.loca = np.frombuffer(
                data, ">u2", self.num_glyphs + 1, loca).astype(np.int64) * 2
        self.cmap = self._read_cmap()
        self.kern = self._read_kern()

    def _read_cmap(self) -> dict[int, int]:
        """codepoint -> glyph index of the preferred Unicode subtable;
        codepoints that map to glyph 0 (.notdef) are left out."""
        data = self.data
        cmap = self.tables["cmap"][0]
        n = struct.unpack_from(">H", data, cmap + 2)[0]
        subs = {}
        for i in range(n):
            pid, eid, off = struct.unpack_from(">HHI", data, cmap + 4 + 8 * i)
            fmt = struct.unpack_from(">H", data, cmap + off)[0]
            if fmt in (4, 12):
                subs.setdefault((pid, eid), (fmt, cmap + off))
        for key in _CMAP_PREF:
            if key in subs:
                fmt, off = subs[key]
                return (self._cmap12 if fmt == 12 else self._cmap4)(off)
        return {}

    def _cmap12(self, off: int) -> dict[int, int]:
        n = struct.unpack_from(">I", self.data, off + 12)[0]
        groups = np.frombuffer(self.data, ">u4", 3 * n, off + 16).reshape(n, 3)
        out = {}
        for start, end, gid in groups.tolist():
            for cp in range(start, end + 1):
                if gid + cp - start:
                    out[cp] = gid + cp - start
        return out

    def _cmap4(self, off: int) -> dict[int, int]:
        data = self.data
        seg = struct.unpack_from(">H", data, off + 6)[0] // 2
        ends = np.frombuffer(data, ">u2", seg, off + 14).tolist()
        starts = np.frombuffer(data, ">u2", seg, off + 16 + 2 * seg).tolist()
        deltas = np.frombuffer(data, ">i2", seg, off + 16 + 4 * seg).tolist()
        ro_base = off + 16 + 6 * seg
        ranges = np.frombuffer(data, ">u2", seg, ro_base).tolist()
        out = {}
        for i in range(seg):
            for cp in range(starts[i], ends[i] + 1):
                if cp == 0xFFFF:
                    continue
                if ranges[i] == 0:
                    g = (cp + deltas[i]) & 0xFFFF
                else:
                    at = ro_base + 2 * i + ranges[i] + 2 * (cp - starts[i])
                    g = struct.unpack_from(">H", data, at)[0]
                    g = (g + deltas[i]) & 0xFFFF if g else 0
                if g:
                    out[cp] = g
        return out

    def _read_kern(self) -> dict[tuple[int, int], int]:
        """Pairs of every format-0 subtable of a version-0 kern table."""
        out: dict[tuple[int, int], int] = {}
        if "kern" not in self.tables:
            return out
        data = self.data
        off = self.tables["kern"][0]
        version, n = struct.unpack_from(">HH", data, off)
        if version != 0:
            return out
        at = off + 4
        for _ in range(n):
            _v, length, coverage = struct.unpack_from(">HHH", data, at)
            if coverage >> 8 == 0:
                npairs = struct.unpack_from(">H", data, at + 6)[0]
                pairs = np.frombuffer(data, ">u2", 3 * npairs, at + 14)
                pairs = pairs.reshape(npairs, 3).astype(np.int64)
                vals = pairs[:, 2].astype(np.int16).tolist()
                out.update(zip(zip(pairs[:, 0].tolist(), pairs[:, 1].tolist()),
                               vals))
            at += length
        return out

    def glyph_points(self, gid: int, depth: int = 0):
        """(xy (N, 2) float64, contour end indices, on-curve flags) of a
        glyph, composites flattened with their component transforms (the
        Microsoft convention: offsets are not scaled)."""
        if depth > 16:
            raise ValueError("recursive composite glyph")
        data = self.data
        start, end = self.loca[gid], self.loca[gid + 1]
        if end <= start:
            return np.zeros((0, 2)), [], np.zeros(0, bool)
        off = self.tables["glyf"][0] + start
        ncont = struct.unpack_from(">h", data, off)[0]
        if ncont >= 0:
            return self._simple(off, ncont)
        pts, ends, onc = [], [], []
        n_pts = 0
        at = off + 10
        while True:
            flags, comp = struct.unpack_from(">HH", data, at)
            at += 4
            if flags & _ARG_WORDS:
                fmt = ">hh" if flags & _ARGS_XY else ">HH"
                a1, a2 = struct.unpack_from(fmt, data, at)
                at += 4
            else:
                fmt = ">bb" if flags & _ARGS_XY else ">BB"
                a1, a2 = struct.unpack_from(fmt, data, at)
                at += 2
            m = None
            if flags & _HAVE_SCALE:
                sc = struct.unpack_from(">h", data, at)[0] / 16384.0
                m = np.array([[sc, 0.0], [0.0, sc]])
                at += 2
            elif flags & _HAVE_XY_SCALE:
                sx, sy = struct.unpack_from(">hh", data, at)
                m = np.array([[sx / 16384.0, 0.0], [0.0, sy / 16384.0]])
                at += 4
            elif flags & _HAVE_2X2:
                v = struct.unpack_from(">hhhh", data, at)
                m = np.array(v, np.float64).reshape(2, 2) / 16384.0
                at += 8
            cxy, cends, con = self.glyph_points(comp, depth + 1)
            cxy = cxy.copy()
            if flags & _ARGS_XY:
                move = np.array([a1, a2], np.float64)
                if m is not None and flags & _SCALED_OFFSET:
                    cxy = (cxy + move) @ m
                else:
                    if m is not None:
                        cxy = cxy @ m
                    cxy = cxy + move
            else:
                # point matching: the component's point a2 lands on the
                # already-placed point a1
                if m is not None:
                    cxy = cxy @ m
                placed = np.concatenate(pts) if pts else np.zeros((0, 2))
                cxy = cxy + (placed[a1] - cxy[a2])
            pts.append(cxy)
            onc.append(con)
            ends.extend(e + n_pts for e in cends)
            n_pts += len(cxy)
            if not flags & _MORE:
                break
        if not pts:
            return np.zeros((0, 2)), [], np.zeros(0, bool)
        return np.concatenate(pts), ends, np.concatenate(onc)

    def _simple(self, off: int, ncont: int):
        data = self.data
        ends = np.frombuffer(data, ">u2", ncont, off + 10).astype(np.int64)
        n = int(ends[-1]) + 1 if ncont else 0
        at = off + 10 + 2 * ncont
        at += 2 + struct.unpack_from(">H", data, at)[0]   # skip instructions
        flags = np.empty(n, np.uint8)
        i = 0
        while i < n:
            f = data[at]
            at += 1
            flags[i] = f
            i += 1
            if f & 0x08:
                r = data[at]
                at += 1
                flags[i:i + r] = f
                i += r
        coords = []
        for short, same in ((0x02, 0x10), (0x04, 0x20)):
            d = np.zeros(n, np.int64)
            for k in range(n):
                f = flags[k]
                if f & short:
                    d[k] = data[at] if f & same else -data[at]
                    at += 1
                elif not f & same:
                    d[k] = struct.unpack_from(">h", data, at)[0]
                    at += 2
            coords.append(np.cumsum(d))
        xy = np.stack(coords, axis=1).astype(np.float64)
        return xy, ends.tolist(), (flags & 1).astype(bool)

    def _lsb_shift(self, gid: int) -> float:
        """lsb - xMin of a simple glyph (0 for composites and empty glyphs),
        the horizontal shift applied when drawing it."""
        start, end = self.loca[gid], self.loca[gid + 1]
        if end <= start:
            return 0.0
        ncont, x_min = struct.unpack_from(
            ">hh", self.data, self.tables["glyf"][0] + start)
        return float(self.lsb[gid] - x_min) if ncont >= 0 else 0.0

    def outline_ops(self, gid: int) -> list:
        """Pen operations of a glyph as (op, points) pairs — moveTo, lineTo,
        qCurveTo (TrueType runs of off-curve points; a final None closes an
        all-off-curve contour) and closePath — in the order the usual glyf
        pen protocol emits them, simple glyphs shifted by lsb - xMin."""
        xy, ends, onc = self.glyph_points(gid)
        if not len(ends):
            return []
        dx = self._lsb_shift(gid)
        pts = [(float(x) + dx, float(y)) for x, y in xy] if dx else [
            (float(x), float(y)) for x, y in xy]
        ops = []
        start = 0
        for end in ends:
            end += 1
            contour = pts[start:end]
            cflags = onc[start:end].tolist()
            start = end
            if True not in cflags:
                ops.append(("qCurveTo", tuple(contour) + (None,)))
            else:
                first = cflags.index(True) + 1
                contour = contour[first:] + contour[:first]
                cflags = cflags[first:] + cflags[:first]
                ops.append(("moveTo", (contour[-1],)))
                while contour:
                    nxt = cflags.index(True) + 1
                    if nxt == 1:
                        if len(contour) > 1:
                            ops.append(("lineTo", (contour[0],)))
                    else:
                        ops.append(("qCurveTo", tuple(contour[:nxt])))
                    contour = contour[nxt:]
                    cflags = cflags[nxt:]
            ops.append(("closePath", ()))
        return ops


class Font:
    """One loaded TrueType font."""

    def __init__(self, name: str, data: bytes) -> None:
        self.name = name
        self.tt = TrueTypeReader(data)
        self.units_per_em = self.tt.units_per_em
        self.ascent_u = self.tt.ascent
        self.descent_u = self.tt.descent          # negative
        self.line_gap_u = self.tt.line_gap

    # stb-style pixel-height scale: pixels per font unit for a given size
    def pixel_scale(self, size_px: float) -> float:
        return size_px / float(self.ascent_u - self.descent_u)

    def glyph_index(self, codepoint: int) -> int | None:
        """Glyph index of a codepoint, None when the font lacks it."""
        return self.tt.cmap.get(codepoint)

    def advance_u(self, gid: int) -> float:
        if 0 <= gid < self.tt.num_glyphs:
            return float(self.tt.advance[gid])
        return 0.0

    def kern_u(self, g1: int, g2: int) -> float:
        """Kern-table pair adjustment in font units (the reference caches
        these aggressively, fontstash.h:397-484; a dict serves here)."""
        return float(self.tt.kern.get((g1, g2), 0.0))

    def outline_contours(self, gid: int, scale_px: float = 1.0) -> list[np.ndarray]:
        """Flattened closed contours in FONT UNITS (y-up); flattening density
        targets ~0.5px error at `scale_px` pixels per font unit."""
        from vgtpu.geometry.path import PathBuilder

        if not 0 <= gid < self.tt.num_glyphs:
            return []
        pb = PathBuilder()
        pb.reset(scale=scale_px, tess_tol=0.25)
        cur = (0.0, 0.0)
        for op, args in self.tt.outline_ops(gid):
            if op == "moveTo":
                cur = args[0]
                pb.move_to(*cur)
            elif op == "lineTo":
                cur = args[0]
                pb.line_to(*cur)
            elif op == "qCurveTo":
                # TrueType: run of off-curve points with implied on-curve
                # midpoints; final point on-curve (may be None = closed blob)
                pts = list(args)
                if pts[-1] is None:
                    pts[-1] = cur
                prev_off = None
                for q in pts[:-1]:
                    if prev_off is not None:
                        mid = ((prev_off[0] + q[0]) / 2, (prev_off[1] + q[1]) / 2)
                        pb.quadratic_to(*prev_off, *mid)
                    prev_off = q
                if prev_off is not None:
                    pb.quadratic_to(*prev_off, *pts[-1])
                else:
                    pb.line_to(*pts[-1])
                cur = pts[-1]
            elif op == "closePath":
                pb.close()
        verts, subs = pb.bake()
        return [verts[f : f + c] for f, c, _cl in subs if c >= 3]

    def rasterize(self, gid: int, size_px: float, pad: int = 1):
        """Rasterize a glyph at pixel size; returns (bitmap u8 (h,w),
        x0, y0, w, h, advance_px) where (x0,y0) is the bitmap's top-left
        offset from the pen position (y-down screen convention)."""
        s = self.pixel_scale(size_px)
        contours = self.outline_contours(gid, scale_px=s)
        adv = self.advance_u(gid) * s
        if not contours:
            return None, 0, 0, 0, 0, adv

        # font units (y-up) -> pixels (y-down)
        pts = np.concatenate(contours, axis=0)
        xs = pts[:, 0] * s
        ys = -pts[:, 1] * s
        x0 = int(np.floor(xs.min())) - pad
        y0 = int(np.floor(ys.min())) - pad
        x1 = int(np.ceil(xs.max())) + pad
        y1 = int(np.ceil(ys.max())) + pad
        w, h = x1 - x0, y1 - y0
        if w <= 0 or h <= 0 or w > 4096 or h > 4096:
            return None, 0, 0, 0, 0, adv

        segs = []
        for c in contours:
            p = np.stack([c[:, 0] * s - x0, -c[:, 1] * s - y0], axis=1)
            nxt = np.roll(p, -1, axis=0)
            segs.append(np.concatenate([p, nxt], axis=1))
        edges = np.concatenate(segs, axis=0)
        cov = _edge_coverage_np(edges, w, h)
        bitmap = (cov * 255.0 + 0.5).astype(np.uint8)
        return bitmap, x0, y0, w, h, adv
