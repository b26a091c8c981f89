/* Fast path-verb recorder: a CPython extension type that replaces the
 * per-verb Python bookkeeping of vgtpu/geometry/path.py:PathBuilder with C
 * appends (the recording half only; bake/flatten stays in vg_native.cpp /
 * numpy, fed from this recorder's buffers).
 *
 * Reference seam: include/vg/path.h:19-38 (pathMoveTo/LineTo/...); the verb
 * STREAM this produces is bit-identical to PathBuilder's (same verb codes,
 * same argument layout, same arcTo/rounded-rect expansion math, ported from
 * path.cpp:203-273/:288-559 via path.py) — tests/test_pathrec.py asserts
 * array equality against the Python recorder over fuzzed verb programs.
 *
 * The point is Python-call overhead: Context binds these methods as instance
 * attributes, so vg.lineTo(ctx,x,y) is one Python frame + one C call instead
 * of three Python frames (measured ~4x on the tiger re-record).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#define VG_EPSILON 1e-5
#define PI2 (2.0 * M_PI)

/* verb codes — MUST match vgtpu/geometry/path.py */
enum { V_MOVE = 0, V_LINE = 1, V_CUBIC = 2, V_ARC = 3, V_CLOSE = 4, V_POLY = 5 };

/* packed-replay opcodes (appendPackedPath) */
enum { R_MOVE = 0, R_LINE = 1, R_CUBIC = 2, R_QUAD = 3, R_ARC = 4,
       R_CLOSE = 5, R_ARCTO = 6 };

typedef struct {
    char *data;
    size_t len;    /* bytes used */
    size_t cap;    /* bytes allocated */
} Buf;

static int buf_reserve(Buf *b, size_t extra) {
    if (b->len + extra <= b->cap) return 0;
    size_t cap = b->cap ? b->cap : 256;
    while (cap < b->len + extra) cap *= 2;
    char *p = (char *)realloc(b->data, cap);
    if (!p) return -1;
    b->data = p;
    b->cap = cap;
    return 0;
}

static inline void buf_i32(Buf *b, int32_t v) {
    memcpy(b->data + b->len, &v, 4);
    b->len += 4;
}
static inline void buf_f64(Buf *b, double v) {
    memcpy(b->data + b->len, &v, 8);
    b->len += 8;
}
static inline void buf_f32(Buf *b, float v) {
    memcpy(b->data + b->len, &v, 4);
    b->len += 4;
}
static inline void buf_i64(Buf *b, int64_t v) {
    memcpy(b->data + b->len, &v, 8);
    b->len += 8;
}

typedef struct {
    PyObject_HEAD
    Buf verbs;      /* int32 */
    Buf sf;         /* double pairs (MOVE/LINE x,y) */
    Buf cf;         /* double x8 per cubic */
    Buf af;         /* double x6 per arc */
    Buf pa;         /* int64 pairs (offset, count) */
    Buf pp;         /* float pairs (poly pool) */
    int64_t poly_pool_len;   /* points in pp */
    double cur_x, cur_y;
    int subpath_open;
    int64_t subpath_nverts;
    uint64_t version;        /* bumps on EVERY mutation incl. reset; never resets */
} PathRec;

static inline int64_t nverbs(PathRec *s) { return (int64_t)(s->verbs.len / 4); }

/* ---------------- core verb appends (exact PathBuilder parity) ----------- */

static int rec_move(PathRec *s, double x, double y) {
    if (buf_reserve(&s->verbs, 4) || buf_reserve(&s->sf, 16)) return -1;
    buf_i32(&s->verbs, V_MOVE);
    buf_f64(&s->sf, x);
    buf_f64(&s->sf, y);
    s->cur_x = x; s->cur_y = y;
    s->subpath_open = 1;
    s->subpath_nverts = 1;
    s->version++;
    return 0;
}

static int rec_line(PathRec *s, double x, double y) {
    if (buf_reserve(&s->verbs, 4) || buf_reserve(&s->sf, 16)) return -1;
    buf_i32(&s->verbs, V_LINE);
    buf_f64(&s->sf, x);
    buf_f64(&s->sf, y);
    s->cur_x = x; s->cur_y = y;
    s->subpath_nverts += 1;
    s->version++;
    return 0;
}

static int rec_cubic(PathRec *s, double c1x, double c1y, double c2x, double c2y,
                     double x, double y) {
    if (buf_reserve(&s->verbs, 4) || buf_reserve(&s->cf, 64)) return -1;
    buf_i32(&s->verbs, V_CUBIC);
    buf_f64(&s->cf, s->cur_x); buf_f64(&s->cf, s->cur_y);
    buf_f64(&s->cf, c1x); buf_f64(&s->cf, c1y);
    buf_f64(&s->cf, c2x); buf_f64(&s->cf, c2y);
    buf_f64(&s->cf, x); buf_f64(&s->cf, y);
    s->cur_x = x; s->cur_y = y;
    s->subpath_nverts += 2;
    s->version++;
    return 0;
}

static int rec_quad(PathRec *s, double cx, double cy, double x, double y) {
    /* quad -> cubic elevation (path.cpp:195-198) */
    double x0 = s->cur_x, y0 = s->cur_y;
    double c1x = x0 + (2.0 / 3.0) * (cx - x0);
    double c1y = y0 + (2.0 / 3.0) * (cy - y0);
    double c2x = x + (2.0 / 3.0) * (cx - x);
    double c2y = y + (2.0 / 3.0) * (cy - y);
    return rec_cubic(s, c1x, c1y, c2x, c2y, x, y);
}

static int rec_close(PathRec *s) {
    if (buf_reserve(&s->verbs, 4)) return -1;
    buf_i32(&s->verbs, V_CLOSE);
    s->version++;
    return 0;
}

/* _emit_arc: records LINE/MOVE to the arc start + an ARC verb */
static int rec_emit_arc(PathRec *s, double cx, double cy, double rx, double ry,
                        double a0, double a1) {
    double sx = cx + rx * cos(a0), sy = cy + ry * sin(a0);
    if (s->subpath_open && s->subpath_nverts > 0) {
        if (buf_reserve(&s->verbs, 4) || buf_reserve(&s->sf, 16)) return -1;
        buf_i32(&s->verbs, V_LINE);
        buf_f64(&s->sf, sx); buf_f64(&s->sf, sy);
        s->subpath_nverts += 1;
    } else {
        s->subpath_open = 1;
        if (buf_reserve(&s->verbs, 4) || buf_reserve(&s->sf, 16)) return -1;
        buf_i32(&s->verbs, V_MOVE);
        buf_f64(&s->sf, sx); buf_f64(&s->sf, sy);
        s->subpath_nverts = 1;
    }
    if (buf_reserve(&s->verbs, 4) || buf_reserve(&s->af, 48)) return -1;
    buf_i32(&s->verbs, V_ARC);
    buf_f64(&s->af, cx); buf_f64(&s->af, cy);
    buf_f64(&s->af, rx); buf_f64(&s->af, ry);
    buf_f64(&s->af, a0); buf_f64(&s->af, a1);
    s->cur_x = cx + rx * cos(a1);
    s->cur_y = cy + ry * sin(a1);
    s->subpath_nverts += 2;
    s->version++;
    return 0;
}

static int rec_arc(PathRec *s, double cx, double cy, double r, double a0,
                   double a1, long direction) {
    /* path.cpp:633-682 angle normalization; Winding.CCW == 0 in core.py */
    while (a0 > PI2) a0 -= PI2;
    while (a1 > PI2) a1 -= PI2;
    if (direction == 0) {           /* CCW */
        while (a0 < a1) a0 += PI2;
    } else {
        while (a1 < a0) a1 += PI2;
    }
    return rec_emit_arc(s, cx, cy, r, r, a0, a1);
}

static int rec_arc_to(PathRec *s, double x1, double y1, double x2, double y2,
                      double r) {
    double x0 = s->cur_x, y0 = s->cur_y;
    double dx0 = x0 - x1, dy0 = y0 - y1;
    double dx1 = x2 - x1, dy1 = y2 - y1;
    double l0 = dx0 * dx0 + dy0 * dy0;
    if (l0 >= VG_EPSILON) {
        double inv = 1.0 / sqrt(l0);
        dx0 *= inv; dy0 *= inv;
    } else { dx0 = 0.0; dy0 = 0.0; }
    double l1 = dx1 * dx1 + dy1 * dy1;
    if (l1 >= VG_EPSILON) {
        double inv = 1.0 / sqrt(l1);
        dx1 *= inv; dy1 *= inv;
    } else { dx1 = 0.0; dy1 = 0.0; }

    double dot = dx0 * dx1 + dy0 * dy1;
    if (dot > 1.0) dot = 1.0;
    if (dot < -1.0) dot = -1.0;
    double a = acos(dot);
    double ta = tan(a / 2.0);
    double d = (fabs(ta) > 1e-12) ? r / ta : 1e9;
    if (d > 10000.0) return rec_line(s, x1, y1);

    double cross = dx1 * dy0 - dx0 * dy1;
    double cx, cy, a0, a1;
    long direction;
    if (cross > 0.0) {
        cx = x1 + dx0 * d + dy0 * r;
        cy = y1 + dy0 * d - dx0 * r;
        a0 = atan2(dx0, -dy0);
        a1 = atan2(-dx1, dy1);
        direction = 1;              /* Winding.CW */
    } else {
        cx = x1 + dx0 * d - dy0 * r;
        cy = y1 + dy0 * d + dx0 * r;
        a0 = atan2(-dx0, dy0);
        a1 = atan2(dx1, -dy1);
        direction = 0;              /* Winding.CCW */
    }
    return rec_arc(s, cx, cy, r, a0, a1, direction);
}

static int rec_rect(PathRec *s, double x, double y, double w, double h) {
    if (fabs(w) < VG_EPSILON || fabs(h) < VG_EPSILON) return 0;
    if (rec_move(s, x, y)) return -1;
    if (rec_line(s, x, y + h)) return -1;
    if (rec_line(s, x + w, y + h)) return -1;
    if (rec_line(s, x + w, y)) return -1;
    return rec_close(s);
}

static int rec_ellipse(PathRec *s, double cx, double cy, double rx, double ry) {
    /* path.py ellipse: move + raw ARC verb (no connect) + close */
    if (rec_move(s, cx + rx, cy)) return -1;
    if (buf_reserve(&s->verbs, 4) || buf_reserve(&s->af, 48)) return -1;
    buf_i32(&s->verbs, V_ARC);
    buf_f64(&s->af, cx); buf_f64(&s->af, cy);
    buf_f64(&s->af, rx); buf_f64(&s->af, ry);
    buf_f64(&s->af, 0.0); buf_f64(&s->af, -PI2);
    s->cur_x = cx + rx; s->cur_y = cy;
    s->subpath_nverts += 3;
    s->version++;
    return rec_close(s);
}

static int rec_rrect_varying(PathRec *s, double x, double y, double w, double h,
                             double rtl, double rtr, double rbr, double rbl) {
    if (rtl < 0.1 && rbl < 0.1 && rbr < 0.1 && rtr < 0.1)
        return rec_rect(s, x, y, w, h);
    double halfw = w * 0.5, halfh = h * 0.5;
    double m = halfw < halfh ? halfw : halfh;
    if (rtl > m) rtl = m;
    if (rtr > m) rtr = m;
    if (rbl > m) rbl = m;
    if (rbr > m) rbr = m;
    double pi_h = M_PI * 0.5;
    if (rtl < 0.1) {
        if (rec_move(s, x, y)) return -1;
    } else {
        if (rec_move(s, x + rtl, y)) return -1;
        if (rec_emit_arc(s, x + rtl, y + rtl, rtl, rtl, -pi_h, -M_PI)) return -1;
    }
    if (rbl < 0.1) {
        if (rec_line(s, x, y + h)) return -1;
    } else {
        if (rec_line(s, x, y + h - rbl)) return -1;
        if (rec_emit_arc(s, x + rbl, y + h - rbl, rbl, rbl, -M_PI, -1.5 * M_PI))
            return -1;
    }
    if (rbr < 0.1) {
        if (rec_line(s, x + w, y + h)) return -1;
    } else {
        if (rec_line(s, x + w - rbr, y + h)) return -1;
        if (rec_emit_arc(s, x + w - rbr, y + h - rbr, rbr, rbr, -1.5 * M_PI, -PI2))
            return -1;
    }
    if (rtr < 0.1) {
        if (rec_line(s, x + w, y)) return -1;
    } else {
        if (rec_line(s, x + w, y + rtr)) return -1;
        if (rec_emit_arc(s, x + w - rtr, y + rtr, rtr, rtr, 0.0, -pi_h))
            return -1;
    }
    return rec_close(s);
}

static int rec_rrect(PathRec *s, double x, double y, double w, double h,
                     double r) {
    if (r < 0.1) return rec_rect(s, x, y, w, h);
    double aw = fabs(w), ah = fabs(h);
    double max_r = (aw < ah ? aw : ah) * 0.5;
    if (w == h && r >= max_r - VG_EPSILON)
        return rec_ellipse(s, x + max_r, y + max_r, max_r, max_r);
    return rec_rrect_varying(s, x, y, w, h, r, r, r, r);
}

/* ---------------- Python method wrappers (METH_FASTCALL) ------------------ */

static inline int get_doubles(PyObject *const *args, Py_ssize_t n, double *out) {
    for (Py_ssize_t i = 0; i < n; i++) {
        out[i] = PyFloat_AsDouble(args[i]);
        if (out[i] == -1.0 && PyErr_Occurred()) return -1;
    }
    return 0;
}

#define CHECK_NARGS(name, want)                                              \
    if (nargs != (want)) {                                                   \
        PyErr_SetString(PyExc_TypeError, name ": wrong number of arguments"); \
        return NULL;                                                         \
    }

static PyObject *py_move_to(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("move_to", 2);
    double a[2];
    if (get_doubles(args, 2, a)) return NULL;
    if (rec_move(s, a[0], a[1])) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_line_to(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("line_to", 2);
    double a[2];
    if (get_doubles(args, 2, a)) return NULL;
    if (rec_line(s, a[0], a[1])) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_cubic_to(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("cubic_to", 6);
    double a[6];
    if (get_doubles(args, 6, a)) return NULL;
    if (rec_cubic(s, a[0], a[1], a[2], a[3], a[4], a[5])) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_quadratic_to(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("quadratic_to", 4);
    double a[4];
    if (get_doubles(args, 4, a)) return NULL;
    if (rec_quad(s, a[0], a[1], a[2], a[3])) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_arc_to(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("arc_to", 5);
    double a[5];
    if (get_doubles(args, 5, a)) return NULL;
    if (rec_arc_to(s, a[0], a[1], a[2], a[3], a[4])) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_arc(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("arc", 6);
    double a[5];
    if (get_doubles(args, 5, a)) return NULL;
    long direction = PyLong_AsLong(args[5]);
    if (direction == -1 && PyErr_Occurred()) {
        PyErr_Clear();
        direction = (long)PyFloat_AsDouble(args[5]);
        if (PyErr_Occurred()) return NULL;
    }
    if (rec_arc(s, a[0], a[1], a[2], a[3], a[4], direction))
        return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_rect(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("rect", 4);
    double a[4];
    if (get_doubles(args, 4, a)) return NULL;
    if (rec_rect(s, a[0], a[1], a[2], a[3])) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_rounded_rect(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("rounded_rect", 5);
    double a[5];
    if (get_doubles(args, 5, a)) return NULL;
    if (rec_rrect(s, a[0], a[1], a[2], a[3], a[4])) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_rounded_rect_varying(PathRec *s, PyObject *const *args,
                                         Py_ssize_t nargs) {
    CHECK_NARGS("rounded_rect_varying", 8);
    double a[8];
    if (get_doubles(args, 8, a)) return NULL;
    if (rec_rrect_varying(s, a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7]))
        return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_circle(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("circle", 3);
    double a[3];
    if (get_doubles(args, 3, a)) return NULL;
    if (rec_ellipse(s, a[0], a[1], a[2], a[2])) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_ellipse(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("ellipse", 4);
    double a[4];
    if (get_doubles(args, 4, a)) return NULL;
    if (rec_ellipse(s, a[0], a[1], a[2], a[3])) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_close(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    (void)args;
    CHECK_NARGS("close", 0);
    if (rec_close(s)) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

/* polyline(buffer): contiguous float32 (n,2) — converted by the wrapper */
static PyObject *py_polyline(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("polyline", 1);
    Py_buffer view;
    if (PyObject_GetBuffer(args[0], &view, PyBUF_CONTIG_RO)) return NULL;
    if (view.len % 8 != 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "polyline: expected float32 (n,2)");
        return NULL;
    }
    int64_t n = (int64_t)(view.len / 8);   /* points */
    if (buf_reserve(&s->verbs, 4) || buf_reserve(&s->pa, 16) ||
        buf_reserve(&s->pp, (size_t)view.len)) {
        PyBuffer_Release(&view);
        return PyErr_NoMemory();
    }
    buf_i32(&s->verbs, V_POLY);
    buf_i64(&s->pa, s->poly_pool_len);
    buf_i64(&s->pa, n);
    memcpy(s->pp.data + s->pp.len, view.buf, (size_t)view.len);
    s->pp.len += (size_t)view.len;
    s->poly_pool_len += n;
    if (n > 0) {
        const float *last = (const float *)((const char *)view.buf + view.len - 8);
        s->cur_x = (double)last[0];
        s->cur_y = (double)last[1];
    }
    s->subpath_nverts += n;
    s->version++;
    PyBuffer_Release(&view);
    Py_RETURN_NONE;
}

/* replay(verbs_i32_buffer, args_f64_buffer): packed program, 8 f64 per verb.
 * Opcodes R_* above; arc's 6th slot is the winding direction.  This is the
 * engine's analogue of the reference's command-list byte-stream
 * interpreter (vg.cpp:4332-4625) specialized to path verbs. */
static PyObject *py_replay(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    CHECK_NARGS("replay", 2);
    Py_buffer vv, av;
    if (PyObject_GetBuffer(args[0], &vv, PyBUF_CONTIG_RO)) return NULL;
    if (PyObject_GetBuffer(args[1], &av, PyBUF_CONTIG_RO)) {
        PyBuffer_Release(&vv);
        return NULL;
    }
    int64_t n = (int64_t)(vv.len / 4);
    if ((int64_t)(av.len / 64) < n) {
        PyBuffer_Release(&vv); PyBuffer_Release(&av);
        PyErr_SetString(PyExc_ValueError, "replay: args shorter than verbs");
        return NULL;
    }
    const int32_t *ops = (const int32_t *)vv.buf;
    const double *a = (const double *)av.buf;
    int rc = 0;
    for (int64_t i = 0; i < n && rc == 0; i++, a += 8) {
        switch (ops[i]) {
        case R_MOVE:  rc = rec_move(s, a[0], a[1]); break;
        case R_LINE:  rc = rec_line(s, a[0], a[1]); break;
        case R_CUBIC: rc = rec_cubic(s, a[0], a[1], a[2], a[3], a[4], a[5]); break;
        case R_QUAD:  rc = rec_quad(s, a[0], a[1], a[2], a[3]); break;
        case R_ARC:   rc = rec_arc(s, a[0], a[1], a[2], a[3], a[4], (long)a[5]); break;
        case R_CLOSE: rc = rec_close(s); break;
        case R_ARCTO: rc = rec_arc_to(s, a[0], a[1], a[2], a[3], a[4]); break;
        default:
            PyBuffer_Release(&vv); PyBuffer_Release(&av);
            PyErr_Format(PyExc_ValueError, "replay: bad opcode %d", ops[i]);
            return NULL;
        }
    }
    PyBuffer_Release(&vv);
    PyBuffer_Release(&av);
    if (rc) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyObject *py_reset(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    (void)args;
    CHECK_NARGS("reset", 0);
    s->verbs.len = 0;
    s->sf.len = 0;
    s->cf.len = 0;
    s->af.len = 0;
    s->pa.len = 0;
    s->pp.len = 0;
    s->poly_pool_len = 0;
    s->cur_x = 0.0; s->cur_y = 0.0;
    s->subpath_open = 0;
    s->subpath_nverts = 0;
    s->version++;
    Py_RETURN_NONE;
}

/* packed() -> (blob_bytes, (len_verbs, len_sf, len_cf, len_af, len_pa,
 * len_pp)) with byte lengths: ONE allocation + copy for the whole snapshot
 * (numpy slices it zero-copy; the frame fingerprint crcs it in one call). */
static PyObject *py_packed(PathRec *s, PyObject *const *args, Py_ssize_t nargs) {
    (void)args;
    CHECK_NARGS("packed", 0);
    Buf *bufs[6] = {&s->verbs, &s->sf, &s->cf, &s->af, &s->pa, &s->pp};
    size_t total = 0;
    for (int i = 0; i < 6; i++) total += bufs[i]->len;
    PyObject *blob = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)total);
    if (!blob) return NULL;
    char *dst = PyBytes_AS_STRING(blob);
    PyObject *lens = PyTuple_New(6);
    if (!lens) { Py_DECREF(blob); return NULL; }
    for (int i = 0; i < 6; i++) {
        if (bufs[i]->len)             /* data may be NULL while len == 0 */
            memcpy(dst, bufs[i]->data, bufs[i]->len);
        dst += bufs[i]->len;
        PyObject *l = PyLong_FromSize_t(bufs[i]->len);
        if (!l) { Py_DECREF(blob); Py_DECREF(lens); return NULL; }
        PyTuple_SET_ITEM(lens, i, l);
    }
    PyObject *t = PyTuple_New(2);
    if (!t) { Py_DECREF(blob); Py_DECREF(lens); return NULL; }
    PyTuple_SET_ITEM(t, 0, blob);
    PyTuple_SET_ITEM(t, 1, lens);
    return t;
}

static PyObject *get_version(PathRec *s, void *closure) {
    (void)closure;
    return PyLong_FromUnsignedLongLong(s->version);
}

static PyObject *get_n_verbs(PathRec *s, void *closure) {
    (void)closure;
    return PyLong_FromLongLong(nverbs(s));
}

static void PathRec_dealloc(PathRec *s) {
    free(s->verbs.data);
    free(s->sf.data);
    free(s->cf.data);
    free(s->af.data);
    free(s->pa.data);
    free(s->pp.data);
    Py_TYPE(s)->tp_free((PyObject *)s);
}

static PyObject *PathRec_new(PyTypeObject *type, PyObject *args, PyObject *kwds) {
    (void)args; (void)kwds;
    PathRec *s = (PathRec *)type->tp_alloc(type, 0);
    if (!s) return NULL;
    memset(&s->verbs, 0, sizeof(Buf));
    memset(&s->sf, 0, sizeof(Buf));
    memset(&s->cf, 0, sizeof(Buf));
    memset(&s->af, 0, sizeof(Buf));
    memset(&s->pa, 0, sizeof(Buf));
    memset(&s->pp, 0, sizeof(Buf));
    s->poly_pool_len = 0;
    s->cur_x = 0.0; s->cur_y = 0.0;
    s->subpath_open = 0;
    s->subpath_nverts = 0;
    s->version = 0;
    return (PyObject *)s;
}

static PyMethodDef PathRec_methods[] = {
    {"move_to", (PyCFunction)py_move_to, METH_FASTCALL, NULL},
    {"line_to", (PyCFunction)py_line_to, METH_FASTCALL, NULL},
    {"cubic_to", (PyCFunction)py_cubic_to, METH_FASTCALL, NULL},
    {"quadratic_to", (PyCFunction)py_quadratic_to, METH_FASTCALL, NULL},
    {"arc_to", (PyCFunction)py_arc_to, METH_FASTCALL, NULL},
    {"arc", (PyCFunction)py_arc, METH_FASTCALL, NULL},
    {"rect", (PyCFunction)py_rect, METH_FASTCALL, NULL},
    {"rounded_rect", (PyCFunction)py_rounded_rect, METH_FASTCALL, NULL},
    {"rounded_rect_varying", (PyCFunction)py_rounded_rect_varying, METH_FASTCALL, NULL},
    {"circle", (PyCFunction)py_circle, METH_FASTCALL, NULL},
    {"ellipse", (PyCFunction)py_ellipse, METH_FASTCALL, NULL},
    {"polyline", (PyCFunction)py_polyline, METH_FASTCALL, NULL},
    {"close", (PyCFunction)py_close, METH_FASTCALL, NULL},
    {"replay", (PyCFunction)py_replay, METH_FASTCALL, NULL},
    {"reset", (PyCFunction)py_reset, METH_FASTCALL, NULL},
    {"packed", (PyCFunction)py_packed, METH_FASTCALL, NULL},
    {NULL, NULL, 0, NULL},
};

static PyGetSetDef PathRec_getset[] = {
    {"version", (getter)get_version, NULL, NULL, NULL},
    {"n_verbs", (getter)get_n_verbs, NULL, NULL, NULL},
    {NULL, NULL, NULL, NULL, NULL},
};

static PyTypeObject PathRecType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_vgpathrec.PathRec",
    .tp_basicsize = sizeof(PathRec),
    .tp_dealloc = (destructor)PathRec_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_methods = PathRec_methods,
    .tp_getset = PathRec_getset,
    .tp_new = PathRec_new,
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_vgpathrec", NULL, -1, NULL, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__vgpathrec(void) {
    if (PyType_Ready(&PathRecType) < 0) return NULL;
    PyObject *m = PyModule_Create(&moduledef);
    if (!m) return NULL;
    Py_INCREF(&PathRecType);
    if (PyModule_AddObject(m, "PathRec", (PyObject *)&PathRecType) < 0) {
        Py_DECREF(&PathRecType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
