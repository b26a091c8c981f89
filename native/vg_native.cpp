// vg_native: host-side geometry engine for vgtpu.
//
// Native implementation of the coarse rasterizer (edge -> tile binning with
// per-row backdrops and chunked edge buffers) plus stroke expansion and path
// flattening.  Mirrors the semantics of vgtpu/raster/binning.py and
// vgtpu/geometry/{path,stroker}.py exactly — the Python/numpy versions remain
// as the test oracle.  This plays the role the CPU tessellation pipeline
// (src/path.cpp, src/stroker.cpp, libtess2) plays in the reference, feeding
// the device raster instead of a GPU triangle pipeline.
//
// C ABI, consumed via ctypes (vgtpu/native/__init__.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct EntrySOA {
    std::vector<int32_t> tile;
    std::vector<float>   backdrop;   // n * tile_h
    std::vector<int32_t> kind, rule, aa, paint_kind, image, op;
    std::vector<float>   paint;      // n * 18
    std::vector<float>   scissor;    // n * 4
    size_t size() const { return tile.size(); }
};

struct ChunkSOA {
    std::vector<float>   edges;      // n * chunk * 4
    std::vector<int32_t> entry;
    size_t size() const { return entry.size(); }
};

static const int MAX_POOLS = 6;

inline int ifloordiv(double a, double b) { return (int)std::floor(a / b); }

} // namespace

extern "C" {

struct BinResult {
    // chunk pools (one per chunk size; see vg_bin_frame pool_sizes)
    float*   chunk_edges[6]; // n_chunks[p] * pool_sizes[p] * 4
    int32_t* chunk_entry[6]; // n_chunks[p]
    int64_t  n_chunks[6];
    int32_t  n_pools;
    // entries
    int32_t* entry_tile;
    float*   entry_backdrop; // n_entries * tile_h
    int32_t* entry_kind;
    int32_t* entry_rule;
    int32_t* entry_aa;
    int32_t* entry_paint_kind;
    float*   entry_paint;    // n_entries * 18
    float*   entry_scissor;  // n_entries * 4
    int32_t* entry_image;
    int32_t* entry_op;
    int64_t  n_entries;
    // per-tile table
    int32_t* tile_entries;   // T * max_ops (-1 padded)
    int32_t  max_ops;
};

void vg_free_result(BinResult* r) {
    for (int p = 0; p < MAX_POOLS; ++p) { std::free(r->chunk_edges[p]); std::free(r->chunk_entry[p]); }
    std::free(r->entry_tile); std::free(r->entry_backdrop);
    std::free(r->entry_kind); std::free(r->entry_rule); std::free(r->entry_aa);
    std::free(r->entry_paint_kind); std::free(r->entry_paint);
    std::free(r->entry_scissor); std::free(r->entry_image); std::free(r->entry_op);
    std::free(r->tile_entries);
    std::memset(r, 0, sizeof(*r));
}

// kinds/paints mirrored from vgtpu/raster/binning.py
enum { K_DRAW = 0, K_CLIP_ADD = 1, K_CLIP_COMMIT = 2, K_CLIP_RESET = 3 };
enum { P_SOLID = 0, P_GRADIENT = 1, P_IMAGE = 2, P_TEXTURE = 3, P_TRI = 4 };
static const int PAINT_NF = 18;

int vg_bin_frame(
    const float* edges,             // all ops' edges concatenated, (Etot,4)
    const int64_t* op_edge_off,     // n_ops+1 offsets into edges
    const float* quads,             // all ops' tex quads concatenated, (Qtot,12)
    const int64_t* op_quad_off,     // n_ops+1
    const int32_t* op_kind,
    const int32_t* op_rule,
    const int32_t* op_aa,
    const int32_t* op_paint_kind,
    const float* op_paint,          // n_ops*18
    const float* op_scissor,        // n_ops*4 (x0,y0,x1,y1); caller resolves defaults
    const int32_t* op_image,
    int32_t n_ops,
    int32_t width, int32_t height,
    int32_t tile_h, int32_t tile_w,
    const int32_t* pool_sizes, int32_t n_pools,
    BinResult* out)
{
    n_pools = std::min(n_pools, MAX_POOLS);
    const int ntx = (width + tile_w - 1) / tile_w;
    const int nty = (height + tile_h - 1) / tile_h;
    const int T = ntx * nty;

    EntrySOA E;
    ChunkSOA C[MAX_POOLS];

    // scratch reused across ops
    std::vector<int> tile_edge_count, tile_edge_start, tile_fill_pos;
    std::vector<double> bgrid;            // nty_op*ntx_op*tile_h backdrop
    std::vector<int64_t> pair_tile;       // CSR fill: edge ids per tile
    std::vector<int64_t> entry_of_tile;

    auto append_entry = [&](int tile, const double* bd, int op_i) -> int64_t {
        int64_t id = (int64_t)E.size();
        E.tile.push_back(tile);
        for (int r = 0; r < tile_h; ++r)
            E.backdrop.push_back(bd ? (float)bd[r] : 0.0f);
        E.kind.push_back(op_kind[op_i]);
        E.rule.push_back(op_rule[op_i]);
        E.aa.push_back(op_aa[op_i]);
        E.paint_kind.push_back(op_paint_kind[op_i]);
        for (int k = 0; k < PAINT_NF; ++k) E.paint.push_back(op_paint[op_i*PAINT_NF + k]);
        for (int k = 0; k < 4; ++k) E.scissor.push_back(op_scissor[op_i*4 + k]);
        E.image.push_back(op_image[op_i]);
        E.op.push_back(op_i);
        return id;
    };

    for (int op_i = 0; op_i < n_ops; ++op_i) {
        const int kind = op_kind[op_i];
        const float* sc = &op_scissor[op_i*4];

        if (kind == K_CLIP_COMMIT || kind == K_CLIP_RESET) {
            for (int t = 0; t < T; ++t) append_entry(t, nullptr, op_i);
            continue;
        }

        if (op_paint_kind[op_i] == P_TEXTURE) {
            const int64_t q0 = op_quad_off[op_i], q1 = op_quad_off[op_i+1];
            if (q1 <= q0) continue;
            std::vector<uint8_t> grid((size_t)T, 0);
            for (int64_t q = q0; q < q1; ++q) {
                const float* Q = &quads[q*12];
                double xs[4] = { Q[0], Q[0]+Q[2], Q[0]+Q[4], Q[0]+Q[2]+Q[4] };
                double ys[4] = { Q[1], Q[1]+Q[3], Q[1]+Q[5], Q[1]+Q[3]+Q[5] };
                double xmn = *std::min_element(xs, xs+4) - 1.0;
                double xmx = *std::max_element(xs, xs+4) + 1.0;
                double ymn = *std::min_element(ys, ys+4) - 1.0;
                double ymx = *std::max_element(ys, ys+4) + 1.0;
                double qx0 = std::max(xmn, std::max(0.0, (double)sc[0]));
                double qy0 = std::max(ymn, std::max(0.0, (double)sc[1]));
                double qx1 = std::min(xmx, std::min((double)width,  (double)sc[2]));
                double qy1 = std::min(ymx, std::min((double)height, (double)sc[3]));
                if (qx1 <= qx0 || qy1 <= qy0) continue;
                int tx0 = (int)(qx0 / tile_w), tx1 = (int)std::ceil(qx1 / tile_w) - 1;
                int ty0 = (int)(qy0 / tile_h), ty1 = (int)std::ceil(qy1 / tile_h) - 1;
                for (int ty = ty0; ty <= ty1; ++ty)
                    for (int tx = tx0; tx <= tx1; ++tx)
                        grid[(size_t)ty*ntx + tx] = 1;
            }
            for (int t = 0; t < T; ++t)
                if (grid[t]) append_entry(t, nullptr, op_i);
            continue;
        }

        // --- edge ops -------------------------------------------------------
        const int64_t e0 = op_edge_off[op_i], e1 = op_edge_off[op_i+1];
        if (e1 <= e0) continue;

        // live-edge filter + bbox
        double gxmin = 1e30, gxmax = -1e30, gymin = 1e30, gymax = -1e30;
        std::vector<int64_t> live;
        live.reserve(e1 - e0);
        for (int64_t e = e0; e < e1; ++e) {
            const float* P = &edges[e*4];
            if (!std::isfinite(P[0]) || !std::isfinite(P[1]) ||
                !std::isfinite(P[2]) || !std::isfinite(P[3])) continue;
            if (std::fabs((double)P[3] - (double)P[1]) <= 1e-9) continue;
            live.push_back(e);
            gxmin = std::min(gxmin, (double)std::min(P[0], P[2]));
            gxmax = std::max(gxmax, (double)std::max(P[0], P[2]));
            gymin = std::min(gymin, (double)std::min(P[1], P[3]));
            gymax = std::max(gymax, (double)std::max(P[1], P[3]));
        }
        if (live.empty()) continue;

        double rx0 = std::max(0.0, (double)sc[0]);
        double ry0 = std::max(std::max(0.0, (double)sc[1]), std::floor(gymin));
        double rx1 = std::min(std::min((double)width,  (double)sc[2]), std::ceil(gxmax));
        double ry1 = std::min(std::min((double)height, (double)sc[3]), std::ceil(gymax));
        if (rx1 <= rx0 || ry1 <= ry0) continue;
        const int tx0 = (int)(rx0 / tile_w);
        const int tx1 = (int)std::ceil(rx1 / tile_w) - 1;
        const int ty0 = (int)(ry0 / tile_h);
        const int ty1 = (int)std::ceil(ry1 / tile_h) - 1;
        const int ntx_op = tx1 - tx0 + 1, nty_op = ty1 - ty0 + 1;
        const size_t ngrid = (size_t)ntx_op * nty_op;

        tile_edge_count.assign(ngrid, 0);
        bgrid.assign(ngrid * tile_h, 0.0);

        // pass 1: count edge-class pairs per tile + accumulate backdrops
        std::vector<double> ov(tile_h);  // per-row overlap scratch (tile_h is unbounded above)
        for (int64_t li = 0; li < (int64_t)live.size(); ++li) {
            const float* P = &edges[live[li]*4];
            double exmin = std::min(P[0], P[2]), exmax = std::max(P[0], P[2]);
            double eymin = std::min(P[1], P[3]), eymax = std::max(P[1], P[3]);
            double sgn = (P[3] > P[1]) ? 1.0 : -1.0;
            int ety_lo = std::max(ifloordiv(eymin, tile_h), ty0);
            int ety_hi = std::min(ifloordiv(std::ceil(eymax) - 1.0, tile_h), ty1);
            if (ety_lo > ety_hi) continue;
            int etx_lo = std::max(ifloordiv(exmin - 1.0, tile_w), tx0);
            if (etx_lo > tx1) continue;
            int etx_hi = std::min(ifloordiv(std::ceil(exmax) - 1.0, tile_w), tx1);

            for (int ty = ety_lo; ty <= ety_hi; ++ty) {
                if (etx_hi >= etx_lo)
                    for (int tx = etx_lo; tx <= etx_hi; ++tx)
                        tile_edge_count[(size_t)(ty - ty0)*ntx_op + (tx - tx0)]++;
                int b_lo = std::max(etx_hi + 1, tx0);
                if (b_lo <= tx1) {
                    // row overlaps, added to [b_lo, tx1] (flat accumulate)
                    for (int r = 0; r < tile_h; ++r) {
                        double rowy = (double)ty * tile_h + r;
                        double o = std::min(eymax, rowy + 1.0) - std::max(eymin, rowy);
                        ov[r] = sgn * std::max(0.0, std::min(o, 1.0));
                    }
                    for (int tx = b_lo; tx <= tx1; ++tx) {
                        double* B = &bgrid[((size_t)(ty - ty0)*ntx_op + (tx - tx0))*tile_h];
                        for (int r = 0; r < tile_h; ++r) B[r] += ov[r];
                    }
                }
            }
        }

        // CSR over tiles (edge ids in edge order)
        tile_edge_start.assign(ngrid + 1, 0);
        for (size_t g = 0; g < ngrid; ++g)
            tile_edge_start[g+1] = tile_edge_start[g] + tile_edge_count[g];
        const int64_t total_pairs = tile_edge_start[ngrid];
        pair_tile.assign(total_pairs, 0);
        tile_fill_pos.assign(ngrid, 0);
        for (int64_t li = 0; li < (int64_t)live.size(); ++li) {
            const float* P = &edges[live[li]*4];
            double exmin = std::min(P[0], P[2]), exmax = std::max(P[0], P[2]);
            double eymin = std::min(P[1], P[3]), eymax = std::max(P[1], P[3]);
            int ety_lo = std::max(ifloordiv(eymin, tile_h), ty0);
            int ety_hi = std::min(ifloordiv(std::ceil(eymax) - 1.0, tile_h), ty1);
            if (ety_lo > ety_hi) continue;
            int etx_lo = std::max(ifloordiv(exmin - 1.0, tile_w), tx0);
            if (etx_lo > tx1) continue;
            int etx_hi = std::min(ifloordiv(std::ceil(exmax) - 1.0, tile_w), tx1);
            if (etx_hi < etx_lo) continue;
            for (int ty = ety_lo; ty <= ety_hi; ++ty)
                for (int tx = etx_lo; tx <= etx_hi; ++tx) {
                    size_t g = (size_t)(ty - ty0)*ntx_op + (tx - tx0);
                    pair_tile[tile_edge_start[g] + tile_fill_pos[g]++] = live[li];
                }
        }

        // entries + chunks, row-major over the op grid
        entry_of_tile.assign(ngrid, -1);
        for (size_t g = 0; g < ngrid; ++g) {
            bool has_edges = tile_edge_count[g] > 0;
            bool has_bd = false;
            for (int r = 0; r < tile_h && !has_bd; ++r)
                if (std::fabs(bgrid[g*tile_h + r]) > 1e-9) has_bd = true;
            if (!has_edges && !has_bd) continue;
            int ty = (int)(g / ntx_op) + ty0, tx = (int)(g % ntx_op) + tx0;
            int64_t id = append_entry(ty*ntx + tx, &bgrid[g*tile_h], op_i);
            entry_of_tile[g] = id;

            if (has_edges) {
                const double ox = (double)tx * tile_w, oy = (double)ty * tile_h;
                int n_e = tile_edge_count[g];
                // mixed-size chunk spill: cover the entry's edge count with
                // the largest pool chunks, then route the remainder to the
                // smallest chunk that fits it (an entry of 7 edges with
                // pools {2,6,24} packs as 6+2 = 8 slots, not one 24-slot
                // chunk — measured fill 0.62 -> ~0.85 on the benchmark)
                int k = 0;
                while (k < n_e) {
                    int rem = n_e - k;
                    // A: smallest chunk that fits the remainder whole;
                    // B: largest chunk <= remainder (zero waste, loop again).
                    // Take A when its padding is small (<= rem/4 + 1), else B.
                    int poolA = -1, poolB = -1;
                    for (int p = 0; p < n_pools; ++p)
                        if (rem <= pool_sizes[p]) { poolA = p; break; }
                    for (int p = n_pools - 1; p >= 0; --p)
                        if (pool_sizes[p] <= rem) { poolB = p; break; }
                    int pool;
                    if (poolA >= 0 &&
                        (poolB < 0 || pool_sizes[poolA] - rem <= (rem >> 2) + 1))
                        pool = poolA;
                    else
                        pool = (poolB >= 0 ? poolB : poolA);
                    const int chunk = pool_sizes[pool];
                    ChunkSOA& CP = C[pool];
                    size_t base = CP.edges.size();
                    CP.edges.resize(base + (size_t)chunk*4, 0.0f);
                    int hi = std::min(n_e, k + chunk);
                    for (int j = k; j < hi; ++j) {
                        const float* P = &edges[pair_tile[tile_edge_start[g] + j]*4];
                        float* D = &CP.edges[base + (size_t)(j - k)*4];
                        D[0] = (float)((double)P[0] - ox);
                        D[1] = (float)((double)P[1] - oy);
                        D[2] = (float)((double)P[2] - ox);
                        D[3] = (float)((double)P[3] - oy);
                    }
                    CP.entry.push_back((int32_t)id);
                    k = hi;
                }
            }
        }
    }

    // ---- per-tile draw-ordered table --------------------------------------
    std::vector<int32_t> tcount((size_t)T, 0);
    for (size_t i = 0; i < E.size(); ++i) tcount[E.tile[i]]++;
    int32_t max_ops = 0;
    for (int t = 0; t < T; ++t) max_ops = std::max(max_ops, tcount[t]);
    int32_t MO = 4; while (MO < max_ops) MO *= 2;     // pow2 bucket (min 4)

    int32_t* tile_entries = (int32_t*)std::malloc((size_t)T * MO * sizeof(int32_t));
    for (int64_t i = 0; i < (int64_t)T * MO; ++i) tile_entries[i] = -1;
    std::vector<int32_t> tpos((size_t)T, 0);
    for (size_t i = 0; i < E.size(); ++i) {
        int t = E.tile[i];
        tile_entries[(size_t)t * MO + tpos[t]++] = (int32_t)i;
    }

    // ---- export -----------------------------------------------------------
    auto dupf = [](const std::vector<float>& v) {
        float* p = (float*)std::malloc(std::max<size_t>(v.size(), 1) * sizeof(float));
        if (!v.empty()) std::memcpy(p, v.data(), v.size()*sizeof(float));
        return p;
    };
    auto dupi = [](const std::vector<int32_t>& v) {
        int32_t* p = (int32_t*)std::malloc(std::max<size_t>(v.size(), 1) * sizeof(int32_t));
        if (!v.empty()) std::memcpy(p, v.data(), v.size()*sizeof(int32_t));
        return p;
    };

    for (int p = 0; p < MAX_POOLS; ++p) {
        if (p < n_pools) {
            out->chunk_edges[p] = dupf(C[p].edges);
            out->chunk_entry[p] = dupi(C[p].entry);
            out->n_chunks[p] = (int64_t)C[p].size();
        } else {
            out->chunk_edges[p] = nullptr;
            out->chunk_entry[p] = nullptr;
            out->n_chunks[p] = 0;
        }
    }
    out->n_pools = n_pools;
    out->entry_tile = dupi(E.tile);
    out->entry_backdrop = dupf(E.backdrop);
    out->entry_kind = dupi(E.kind);
    out->entry_rule = dupi(E.rule);
    out->entry_aa = dupi(E.aa);
    out->entry_paint_kind = dupi(E.paint_kind);
    out->entry_paint = dupf(E.paint);
    out->entry_scissor = dupf(E.scissor);
    out->entry_image = dupi(E.image);
    out->entry_op = dupi(E.op);
    out->n_entries = (int64_t)E.size();
    out->tile_entries = tile_entries;
    out->max_ops = MO;
    return 0;
}

// ---------------------------------------------------------------------------
// Stroke expansion (mirrors vgtpu/geometry/stroker.py)
// ---------------------------------------------------------------------------

struct StrokeResult {
    float* pts;        // concatenated contour points (n,2)
    int64_t* contour_off; // n_contours+1
    int64_t n_pts;
    int32_t n_contours;
};

void vg_free_stroke(StrokeResult* r) {
    std::free(r->pts); std::free(r->contour_off);
    std::memset(r, 0, sizeof(*r));
}

namespace {

struct V2 { double x, y; };
inline V2 vsub(V2 a, V2 b) { return {a.x-b.x, a.y-b.y}; }
inline V2 norm_guard(V2 d) {
    double l2 = d.x*d.x + d.y*d.y;
    if (l2 < 1e-5) return {0.0, 0.0};
    double inv = 1.0 / std::sqrt(l2);
    return {d.x*inv, d.y*inv};
}
inline V2 perp_ccw(V2 d) { return {-d.y, d.x}; }

// one side's points for one joint (mirrors _joint_points lanes)
void joint_points(std::vector<V2>& out, V2 p, V2 d01, V2 d12,
                  double hsw, int join, double da, double side)
{
    double cross = d12.x*d01.y - d12.y*d01.x;
    V2 p01 = perp_ccw(d01), p12 = perp_ccw(d12);
    V2 v;
    if (std::fabs(cross) > 0.01) v = { (d01.x-d12.x)/cross, (d01.y-d12.y)/cross };
    else v = p01;
    V2 extr = { p.x + side*v.x*hsw, p.y + side*v.y*hsw };
    bool left_inner = (d12.x*v.x + d12.y*v.y) >= 0.0;
    bool is_inner = side > 0 ? left_inner : !left_inner;

    if (join == 0 /*miter*/ || is_inner) { out.push_back(extr); return; }

    V2 l0 = { side*p01.x, side*p01.y }, l1 = { side*p12.x, side*p12.y };
    double a0 = std::atan2(l0.y, l0.x), a1 = std::atan2(l1.y, l1.x);
    double delta = std::fmod(a1 - a0 + M_PI, 2.0*M_PI);
    if (delta < 0) delta += 2.0*M_PI;
    delta -= M_PI;
    int n_arc = (join == 2 /*bevel*/) ? 1
        : std::min<int>(64, std::max<int>(2, (int)(std::fabs(delta)/da)));
    for (int k = 0; k <= n_arc; ++k) {
        double a = a0 + delta * ((double)k / n_arc);
        out.push_back({ p.x + hsw*std::cos(a), p.y + hsw*std::sin(a) });
    }
}

} // namespace

int vg_stroke_outline(
    const float* pts_in, int64_t n, int32_t closed,
    float stroke_width, int32_t cap, int32_t join,
    float scale, float tol,
    StrokeResult* out)
{
    if (n < 2) { std::memset(out, 0, sizeof(*out)); return 0; }
    const double hsw = stroke_width * 0.5;
    double sr = (double)scale * std::max(hsw, 1e-6);
    double da = 2.0 * std::acos(std::min(1.0, std::max(-1.0, sr / (sr + tol))));
    int n_half = std::max(2, (int)std::ceil(M_PI / da));

    std::vector<V2> P((size_t)n);
    for (int64_t i = 0; i < n; ++i) P[i] = { pts_in[i*2], pts_in[i*2+1] };

    std::vector<std::vector<V2>> contours;

    if (closed) {
        std::vector<V2> d((size_t)n);
        for (int64_t i = 0; i < n; ++i) d[i] = norm_guard(vsub(P[(i+1)%n], P[i]));
        std::vector<V2> a, b;
        for (int64_t i = 0; i < n; ++i) {
            V2 d01 = d[(i+n-1)%n], d12 = d[i];
            joint_points(a, P[i], d01, d12, hsw, join, da, +1.0);
            joint_points(b, P[i], d01, d12, hsw, join, da, -1.0);
        }
        std::reverse(b.begin(), b.end());
        contours.push_back(std::move(a));
        contours.push_back(std::move(b));
    } else {
        std::vector<V2> d((size_t)n-1);
        for (int64_t i = 0; i+1 < n; ++i) d[i] = norm_guard(vsub(P[i+1], P[i]));
        V2 la0 = perp_ccw(d[0]), la1 = perp_ccw(d[n-2]);
        double sh0x = 0, sh0y = 0, sh1x = 0, sh1y = 0;
        if (cap == 2 /*square*/) {
            sh0x = -d[0].x*hsw;   sh0y = -d[0].y*hsw;
            sh1x =  d[n-2].x*hsw; sh1y =  d[n-2].y*hsw;
        }
        std::vector<V2> fwd, bwd;
        fwd.push_back({ P[0].x + la0.x*hsw + sh0x, P[0].y + la0.y*hsw + sh0y });
        bwd.push_back({ P[0].x - la0.x*hsw + sh0x, P[0].y - la0.y*hsw + sh0y });
        for (int64_t i = 1; i+1 < n; ++i) {
            joint_points(fwd, P[i], d[i-1], d[i], hsw, join, da, +1.0);
            joint_points(bwd, P[i], d[i-1], d[i], hsw, join, da, -1.0);
        }
        fwd.push_back({ P[n-1].x + la1.x*hsw + sh1x, P[n-1].y + la1.y*hsw + sh1y });
        bwd.push_back({ P[n-1].x - la1.x*hsw + sh1x, P[n-1].y - la1.y*hsw + sh1y });

        std::vector<V2> contour = fwd;
        if (cap == 1 /*round*/) {   // end cap A->B, angle decreasing by pi
            double a0 = std::atan2(la1.y, la1.x);
            for (int k = 1; k < n_half-1; ++k) {
                double a = a0 - (double)k * M_PI / (n_half-1);
                contour.push_back({ P[n-1].x + hsw*std::cos(a), P[n-1].y + hsw*std::sin(a) });
            }
        }
        for (int64_t i = (int64_t)bwd.size()-1; i >= 0; --i) contour.push_back(bwd[i]);
        if (cap == 1) {             // start cap B->A
            double a0 = std::atan2(la0.y, la0.x);
            for (int k = n_half-2; k >= 1; --k) {
                double a = a0 + (double)k * M_PI / (n_half-1);
                contour.push_back({ P[0].x + hsw*std::cos(a), P[0].y + hsw*std::sin(a) });
            }
        }
        contours.push_back(std::move(contour));
    }

    int64_t total = 0;
    for (auto& c : contours) total += (int64_t)c.size();
    out->pts = (float*)std::malloc(std::max<int64_t>(total,1)*2*sizeof(float));
    out->contour_off = (int64_t*)std::malloc((contours.size()+1)*sizeof(int64_t));
    out->n_pts = total;
    out->n_contours = (int32_t)contours.size();
    int64_t w = 0;
    out->contour_off[0] = 0;
    for (size_t c = 0; c < contours.size(); ++c) {
        for (auto& p : contours[c]) { out->pts[w*2] = (float)p.x; out->pts[w*2+1] = (float)p.y; ++w; }
        out->contour_off[c+1] = w;
    }
    return 0;
}

} // extern "C"

// ---------------------------------------------------------------------------
// Path baking (mirrors vgtpu/geometry/path.py::PathBuilder.bake)
// ---------------------------------------------------------------------------

extern "C" {

struct BakeResult {
    float*   verts;       // (V,2)
    int32_t* subpaths;    // (S,3): first, count, closed
    int64_t  n_verts;
    int32_t  n_subpaths;
};

void vg_free_bake(BakeResult* r) {
    std::free(r->verts); std::free(r->subpaths);
    std::memset(r, 0, sizeof(*r));
}

enum { V_MOVE = 0, V_LINE = 1, V_CUBIC = 2, V_ARC = 3, V_CLOSE = 4, V_POLY = 5 };
static const double VG_EPS = 1e-5;   // VG_EPSILON (dist^2 dedupe)

int vg_bake_path(
    const int32_t* verbs, int32_t n_verbs,
    const double* simple_flat,       // MOVE/LINE xy in verb order
    const double* cubic_flat,        // 8 per cubic
    const double* arc_flat,          // 6 per arc
    const int64_t* poly_args,        // 2 per poly: offset,count
    const float* poly_pool,
    float scale_f, float tol_f,
    BakeResult* out)
{
    const double scale = scale_f, tol = tol_f;
    if (n_verbs == 0) { std::memset(out, 0, sizeof(*out)); return 0; }

    // pass 1: per-verb emission counts
    std::vector<int64_t> counts((size_t)n_verbs, 0);
    std::vector<int64_t> cub_n, arc_n;
    {
        const double tol_d = std::sqrt(tol) / std::max(scale, 1e-6);
        int ci = 0, ai = 0, pi = 0;
        for (int i = 0; i < n_verbs; ++i) {
            switch (verbs[i]) {
            case V_MOVE: case V_LINE: counts[i] = 1; break;
            case V_CUBIC: {
                const double* p = &cubic_flat[(size_t)ci*8];
                double d1x = p[0]-2*p[2]+p[4], d1y = p[1]-2*p[3]+p[5];
                double d2x = p[2]-2*p[4]+p[6], d2y = p[3]-2*p[5]+p[7];
                double m = std::max(std::hypot(d1x,d1y), std::hypot(d2x,d2y));
                double nn = std::ceil(std::sqrt(std::max(3.0*m/(4.0*tol_d), 1.0)));
                int64_t n = (int64_t)std::min(std::max(nn, 1.0), 1024.0);
                counts[i] = n; cub_n.push_back(n); ++ci;
            } break;
            case V_ARC: {
                const double* a = &arc_flat[(size_t)ai*6];
                double avg_r = (std::fabs(a[2]) + std::fabs(a[3])) * 0.5;
                double sr = scale * std::max(avg_r, 1e-6);
                double da = std::acos(std::min(1.0, std::max(-1.0, sr/(sr+tol)))) * 2.0;
                int64_t n = (int64_t)std::max(2.0, std::ceil(std::fabs(a[5]-a[4]) / da));
                n = std::min<int64_t>(n, 4096);
                counts[i] = n; arc_n.push_back(n); ++ai;
            } break;
            case V_POLY: counts[i] = poly_args[(size_t)pi*2+1]; ++pi; break;
            default: break; // CLOSE: 0
            }
        }
    }
    std::vector<int64_t> offs((size_t)n_verbs + 1, 0);
    for (int i = 0; i < n_verbs; ++i) offs[i+1] = offs[i] + counts[i];
    const int64_t total = offs[n_verbs];

    std::vector<float> v((size_t)total * 2);
    // pass 2: fill
    {
        int ci = 0, ai = 0, pi = 0, si = 0;
        for (int i = 0; i < n_verbs; ++i) {
            float* dst = &v[(size_t)offs[i]*2];
            switch (verbs[i]) {
            case V_MOVE: case V_LINE:
                dst[0] = (float)simple_flat[(size_t)si*2];
                dst[1] = (float)simple_flat[(size_t)si*2+1];
                ++si; break;
            case V_CUBIC: {
                const double* p = &cubic_flat[(size_t)ci*8];
                int64_t n = cub_n[(size_t)ci];
                for (int64_t k = 0; k < n; ++k) {
                    double t = (double)(k+1) / (double)n, mt = 1.0 - t;
                    double w0 = mt*mt*mt, w1 = 3*mt*mt*t, w2 = 3*mt*t*t, w3 = t*t*t;
                    dst[k*2]   = (float)(w0*p[0] + w1*p[2] + w2*p[4] + w3*p[6]);
                    dst[k*2+1] = (float)(w0*p[1] + w1*p[3] + w2*p[5] + w3*p[7]);
                }
                ++ci;
            } break;
            case V_ARC: {
                const double* a = &arc_flat[(size_t)ai*6];
                int64_t n = arc_n[(size_t)ai];
                for (int64_t k = 0; k < n; ++k) {
                    double th = a[4] + (a[5]-a[4]) * (double)(k+1) / (double)n;
                    dst[k*2]   = (float)(a[0] + a[2]*std::cos(th));
                    dst[k*2+1] = (float)(a[1] + a[3]*std::sin(th));
                }
                ++ai;
            } break;
            case V_POLY: {
                int64_t off = poly_args[(size_t)pi*2], cnt = poly_args[(size_t)pi*2+1];
                std::memcpy(dst, &poly_pool[(size_t)off*2], (size_t)cnt*2*sizeof(float));
                ++pi;
            } break;
            default: break;
            }
        }
    }

    // subpath table (MOVE/CLOSE walk, python parity)
    struct Sub { int64_t first, count; int closed; };
    std::vector<Sub> subs;
    {
        int64_t cur_first = 0; bool cur_open = false;
        for (int i = 0; i < n_verbs; ++i) {
            int vb = verbs[i];
            if (vb == V_MOVE) {
                if (cur_open && offs[i] > cur_first)
                    subs.push_back({cur_first, offs[i]-cur_first, 0});
                cur_first = offs[i]; cur_open = true;
            } else if (vb == V_CLOSE) {
                if (cur_open && offs[i] > cur_first) {
                    subs.push_back({cur_first, offs[i]-cur_first, 1});
                    cur_open = false; cur_first = offs[i];
                }
            } else if (!cur_open) { cur_open = true; cur_first = offs[i]; }
        }
        if (cur_open && total > cur_first)
            subs.push_back({cur_first, total-cur_first, 0});
    }

    // dedupe (consecutive within subpath + closing pair), python parity
    std::vector<uint8_t> keep((size_t)total, 1);
    for (int64_t k = 1; k < total; ++k) {
        double dx = (double)v[k*2]   - v[(k-1)*2];
        double dy = (double)v[k*2+1] - v[(k-1)*2+1];
        keep[(size_t)k] = (dx*dx + dy*dy) >= VG_EPS;
    }
    for (auto& s : subs) keep[(size_t)s.first] = 1;   // subpath firsts survive

    std::vector<Sub> out_subs; out_subs.reserve(subs.size());
    for (auto& s : subs) {
        int64_t c = 0, first_k = -1, last_k = -1;
        for (int64_t k = s.first; k < s.first + s.count; ++k)
            if (keep[(size_t)k]) { ++c; if (first_k < 0) first_k = k; last_k = k; }
        if (s.closed && c > 1) {
            double dx = (double)v[last_k*2]   - v[first_k*2];
            double dy = (double)v[last_k*2+1] - v[first_k*2+1];
            if (dx*dx + dy*dy < VG_EPS) { keep[(size_t)last_k] = 0; --c; }
        }
        int closed = (s.closed && c > 2) ? 1 : 0;
        if (c > 0) out_subs.push_back({0, c, closed});   // first fixed below
    }

    int64_t vkept = 0;
    for (int64_t k = 0; k < total; ++k) vkept += keep[(size_t)k];
    out->verts = (float*)std::malloc(std::max<int64_t>(vkept,1)*2*sizeof(float));
    int64_t w = 0;
    for (int64_t k = 0; k < total; ++k)
        if (keep[(size_t)k]) { out->verts[w*2] = v[k*2]; out->verts[w*2+1] = v[k*2+1]; ++w; }
    out->n_verts = vkept;
    out->subpaths = (int32_t*)std::malloc(std::max<size_t>(out_subs.size(),1)*3*sizeof(int32_t));
    int64_t run = 0;
    for (size_t si2 = 0; si2 < out_subs.size(); ++si2) {
        out->subpaths[si2*3]   = (int32_t)run;
        out->subpaths[si2*3+1] = (int32_t)out_subs[si2].count;
        out->subpaths[si2*3+2] = out_subs[si2].closed;
        run += out_subs[si2].count;
    }
    out->n_subpaths = (int32_t)out_subs.size();
    return 0;
}

} // extern "C"

// ---------------------------------------------------------------------------
// Batched frame geometry: bake + transform + fill/stroke edge assembly for
// EVERY deferred draw of a frame in ONE call (the per-path ctypes round-trips
// measured ~30 ms/frame of marshalling on the 1080p tiger re-record).
// Mirrors Context.fillPath/strokePath edge assembly exactly; the Python
// helpers remain the oracle (tests/test_native.py).
// ---------------------------------------------------------------------------

namespace {

inline double shoelace(const float* pts, int64_t n) {
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t j = (i + 1 == n) ? 0 : i + 1;
        s += (double)pts[i*2] * pts[j*2+1] - (double)pts[j*2] * pts[i*2+1];
    }
    return 0.5 * s;
}

// closed-loop edges of polygon pts (n,2), optionally reversed
inline void emit_loop_edges(std::vector<float>& out, const float* pts,
                            int64_t n, bool reversed) {
    if (n < 2) return;
    if (!reversed) {
        for (int64_t i = 0; i < n; ++i) {
            int64_t j = (i + 1 == n) ? 0 : i + 1;
            out.push_back(pts[i*2]); out.push_back(pts[i*2+1]);
            out.push_back(pts[j*2]); out.push_back(pts[j*2+1]);
        }
    } else {
        // python reverses the POINT order then emits loops: edge k connects
        // reversed[k] -> reversed[k+1], i.e. pts[n-1-k] -> pts[n-2-k]
        for (int64_t i = 0; i < n; ++i) {
            int64_t a = n - 1 - i;
            int64_t b = (i + 1 == n) ? n - 1 : a - 1;
            out.push_back(pts[a*2]); out.push_back(pts[a*2+1]);
            out.push_back(pts[b*2]); out.push_back(pts[b*2+1]);
        }
    }
}

} // namespace

extern "C" {

struct GeomResult {
    float*   edges;       // (E,4)
    int64_t* piece_off;   // (n_pieces+1) edge offsets
    int32_t* piece_draw;  // (n_pieces) owning draw index
    int64_t  n_edges;
    int64_t  n_pieces;
};

void vg_free_geom(GeomResult* r) {
    std::free(r->edges); std::free(r->piece_off); std::free(r->piece_draw);
    std::memset(r, 0, sizeof(*r));
}

// draw modes
enum { GM_FILL_NORM = 0, GM_FILL_RAW = 1, GM_STROKE = 2 };

int vg_frame_geom(
    // paths: concatenated verb streams, offsets in ELEMENT counts
    const int32_t* verbs, const int64_t* verbs_off,       // (P+1)
    const double* simple_flat, const int64_t* simple_off, // xy pairs
    const double* cubic_flat, const int64_t* cubic_off,   // cubics (8 dbl)
    const double* arc_flat, const int64_t* arc_off,       // arcs (6 dbl)
    const int64_t* poly_args, const int64_t* poly_off,    // polys (2 i64, abs pool offsets)
    const float* poly_pool,
    const float* path_scale, const float* path_tol,
    int32_t n_paths,
    // draws
    const int32_t* draw_path, const int32_t* draw_mode,
    const float* draw_xform,                              // (D,6) a,b,c,d,e,f
    const float* draw_width, const int32_t* draw_cap, const int32_t* draw_join,
    const float* draw_scale,                              // stroke render scale
    float stroke_tol,
    int32_t n_draws,
    GeomResult* out)
{
    std::vector<BakeResult> baked((size_t)n_paths);
    std::memset(baked.data(), 0, sizeof(BakeResult) * n_paths);
    for (int p = 0; p < n_paths; ++p) {
        vg_bake_path(
            verbs + verbs_off[p], (int32_t)(verbs_off[p+1] - verbs_off[p]),
            simple_flat + simple_off[p]*2, cubic_flat + cubic_off[p]*8,
            arc_flat + arc_off[p]*6, poly_args + poly_off[p]*2, poly_pool,
            path_scale[p], path_tol[p], &baked[p]);
    }

    std::vector<float> edges;
    std::vector<int64_t> piece_off(1, 0);
    std::vector<int32_t> piece_draw;
    std::vector<float> xpts;            // transformed verts scratch
    edges.reserve(1 << 16);

    for (int d = 0; d < n_draws; ++d) {
        const BakeResult& B = baked[(size_t)draw_path[d]];
        const float* X = &draw_xform[(size_t)d*6];
        xpts.resize((size_t)B.n_verts * 2);
        for (int64_t k = 0; k < B.n_verts; ++k) {
            double x = B.verts[k*2], y = B.verts[k*2+1];
            xpts[k*2]   = (float)(X[0]*x + X[2]*y + X[4]);
            xpts[k*2+1] = (float)(X[1]*x + X[3]*y + X[5]);
        }
        const int mode = draw_mode[d];
        for (int s = 0; s < B.n_subpaths; ++s) {
            int64_t first = B.subpaths[s*3], count = B.subpaths[s*3+1];
            int closed = B.subpaths[s*3+2];
            const float* sp = &xpts[(size_t)first*2];
            if (mode == GM_STROKE) {
                if (count < 2) continue;
                StrokeResult sr;
                vg_stroke_outline(sp, count, closed, draw_width[d],
                                  draw_cap[d], draw_join[d], draw_scale[d],
                                  stroke_tol, &sr);
                if (sr.n_contours == 0) { continue; }
                // orientation normalization across THIS subpath's contours
                // (_normalize_orientation: dominant |area| decides the flip)
                double best = 0.0; int flip = 0;
                for (int c = 0; c < sr.n_contours; ++c) {
                    int64_t o = sr.contour_off[c], e = sr.contour_off[c+1];
                    double a = shoelace(sr.pts + o*2, e - o);
                    if (std::fabs(a) > std::fabs(best)) best = a;
                }
                flip = best < 0.0;
                bool any = false;
                for (int c = 0; c < sr.n_contours; ++c) {
                    int64_t o = sr.contour_off[c], e = sr.contour_off[c+1];
                    if (e - o >= 2) { emit_loop_edges(edges, sr.pts + o*2, e - o, flip); any = true; }
                }
                vg_free_stroke(&sr);
                if (!any) continue;
            } else {
                if (count < 3) continue;
                bool rev = (mode == GM_FILL_NORM) && shoelace(sp, count) < 0.0;
                emit_loop_edges(edges, sp, count, rev);
            }
            piece_off.push_back((int64_t)edges.size() / 4);
            piece_draw.push_back(d);
        }
    }

    for (int p = 0; p < n_paths; ++p) vg_free_bake(&baked[p]);

    int64_t ne = (int64_t)edges.size() / 4;
    int64_t np_ = (int64_t)piece_draw.size();
    out->edges = (float*)std::malloc(std::max<int64_t>(ne,1)*4*sizeof(float));
    std::memcpy(out->edges, edges.data(), (size_t)ne*4*sizeof(float));
    out->piece_off = (int64_t*)std::malloc((np_+1)*sizeof(int64_t));
    std::memcpy(out->piece_off, piece_off.data(), (size_t)(np_+1)*sizeof(int64_t));
    out->piece_draw = (int32_t*)std::malloc(std::max<int64_t>(np_,1)*sizeof(int32_t));
    std::memcpy(out->piece_draw, piece_draw.data(), (size_t)np_*sizeof(int32_t));
    out->n_edges = ne;
    out->n_pieces = np_;
    return 0;
}

// ---------------------------------------------------------------------------
// per-tile entry resolution (the host side of compute_tile_buckets minus the
// bucket grouping): static clip resolution, trailing-control pruning,
// occlusion culling, depth cap, per-tile fancy flag.  Mirrors the numpy
// implementation in vgtpu/raster/binning.py exactly (parity-tested).
// Entry kinds/paints as in binning.py: K_DRAW=0 CLIP_ADD=1 COMMIT=2 RESET=3;
// P_SOLID=0.
// ---------------------------------------------------------------------------

int vg_resolve_tiles(
    int32_t* te,                 // (T, MO) in/out
    int64_t T, int32_t MO,
    const int32_t* entry_kind, const int32_t* entry_rule,
    const int32_t* entry_pk, const float* entry_paint,    // (NE,18)
    const float* entry_scissor,                           // (NE,4)
    const float* entry_backdrop,                          // (NE, bd_rows)
    int32_t bd_rows,
    const uint8_t* entry_has_edges,                       // (NE,)
    int64_t NE,
    int32_t width, int32_t height_ss, int32_t tile_w, int32_t tile_h,
    int32_t ntx, int32_t cap, int32_t view_static, int32_t static_clip,
    uint8_t* tile_fancy)                                  // (T,) out
{
    int capped = 0;
    // per-entry opaque-full-cover flag
    std::vector<uint8_t> covers((size_t)NE, 0);
    for (int64_t e = 0; e < NE; ++e) {
        if (entry_pk[e] != 0 || entry_kind[e] != 0 || entry_rule[e] != 0) continue;
        if (entry_paint[e*18 + 13] < 1.0f) continue;
        if (entry_has_edges[e]) continue;
        bool full = true;
        for (int r = 0; r < bd_rows; ++r)
            if (std::fabs(entry_backdrop[e*bd_rows + r]) < 1.0f) { full = false; break; }
        if (full) covers[(size_t)e] = 1;
    }
    const int reach = view_static ? 2 : 1;

    std::vector<int32_t> row((size_t)MO);
    for (int64_t t = 0; t < T; ++t) {
        int32_t* slots = te + t * MO;
        int n = 0;
        bool has_cadd = false;
        for (int s = 0; s < MO; ++s) {
            int32_t e = slots[s];
            if (e < 0) continue;         // hole-tolerant like the numpy oracle
            row[(size_t)n++] = e;
            if (entry_kind[e] == 1) has_cadd = true;
        }
        if (!n) { tile_fancy[t] = 0; continue; }

        // 1. static clip resolution (clip-add-free tiles only)
        if (static_clip && !has_cadd) {
            int m = 0, mask = 1;
            for (int s = 0; s < n; ++s) {
                int32_t e = row[(size_t)s];
                int k = entry_kind[e];
                if (k == 0) { if (mask) row[(size_t)m++] = e; }
                else mask = (k == 2 && entry_rule[e] == 0) ? 0 : 1;  // commit(In)=0
            }
            n = m;
        }

        // 2. trailing-control prune: drop everything after the last draw
        int last_draw = -1;
        for (int s = n - 1; s >= 0; --s)
            if (entry_kind[row[(size_t)s]] == 0) { last_draw = s; break; }
        n = last_draw + 1;

        // 3. occlusion: keep from the LAST covering entry onward (clip-free
        //    tiles with the scissor containing the reachable window)
        if (n) {
            bool tile_has_clip = false;
            for (int s = 0; s < n; ++s)
                if (entry_kind[row[(size_t)s]] != 0) { tile_has_clip = true; break; }
            if (!tile_has_clip) {
                float tx0 = (float)((t % ntx) * tile_w);
                float ty0 = (float)((t / ntx) * tile_h);
                float tx1 = std::min(tx0 + (float)(reach * tile_w), (float)width);
                float ty1 = std::min(ty0 + (float)(reach * tile_h), (float)height_ss);
                for (int s = n - 1; s > 0; --s) {
                    int32_t e = row[(size_t)s];
                    if (!covers[(size_t)e]) continue;
                    const float* sc = entry_scissor + e*4;
                    if (sc[0] <= tx0 && sc[1] <= ty0 && sc[2] >= tx1 && sc[3] >= ty1) {
                        // drop everything before s
                        for (int i = s; i < n; ++i) row[(size_t)(i - s)] = row[(size_t)i];
                        n -= s;
                        break;
                    }
                }
            }
        }

        // 4. depth cap: drop the OLDEST draws only (controls preserved)
        if (cap > 0 && n > cap) {
            ++capped;
            int draws = 0;
            for (int s = 0; s < n; ++s) if (entry_kind[row[(size_t)s]] == 0) ++draws;
            int to_drop = std::min(n - cap, draws);
            int m = 0, seen = 0;
            for (int s = 0; s < n; ++s) {
                int32_t e = row[(size_t)s];
                if (entry_kind[e] == 0 && seen < to_drop) { ++seen; continue; }
                row[(size_t)m++] = e;
            }
            n = m;
            if (n > cap) n = cap;   // pathological: >cap controls
        }

        // 5. fancy flag + writeback
        uint8_t fancy = 0;
        for (int s = 0; s < n; ++s) {
            int32_t e = row[(size_t)s];
            slots[s] = e;
            if (entry_pk[e] != 0 || entry_kind[e] != 0) fancy = 1;
        }
        for (int s = n; s < MO; ++s) slots[s] = -1;
        tile_fancy[t] = fancy;
    }
    return capped;
}

} // extern "C"
