// The fused dual contact solve and its stage kernels, one thread block per
// env.
//
// Replaces four Pallas kernels of flybody_tpu/ops/solver_kernels.py, all
// on the same row form and the same device code below:
//   solve_rows        (_solve_rows_kernel)    steps 1-7
//   upsolve_build_yd  (_upsolve_build_kernel) steps 1-3, writes (Yd, b)
//   upsolve_yd        (_upsolve_kernel)       steps 2-3 on a given J^T
//   apgd_iterate      (_apgd_kernel)          steps 4-6 on a given Yd,
//                                             writes (f, Yd f, v)
// Same math as the Pallas kernels:
//   1. J^T (nv, R) from the compact row form
//        J[r, v] = (d6[v] . u6[r]) * (maskd[b2_r, v] - maskd[b1_r, v])
//                  + lim_sign[r] * [v == lim_dadr[r]]
//   2. b = -bcoef (J qvel) - kcoef posr - J qacc_smooth
//   3. Yd = D^{-1/2} L^{-T} J^T: the tree up-sweep as (i, e, j) triplets
//   4. warm power-iteration Lipschitz of the scaled operator
//   5. APGD on Yd^T Yd + diag(rreg): cone-uniform Jacobi scaling, Nesterov
//      momentum with gradient restart, elliptic cone projection
//   6. 2 * noslip tangential sweeps with the normals frozen
//   7. qfrc = L^T D^{1/2} y*, dqacc = L^{-1} D^{-1/2} y*, y* = Yd f.
//
// Work at walk_on_ball shapes (nv 105, R 152, nM 586, 481 up and 481
// down triplets, 20 APGD iterations, noslip 3, 3 power iterations on a
// fresh substep) per env:
//   J build 15 nv R, rhs 4 nv R, up-solve 2 * 481 R, scale + diag 3 nv R,
//   29 applications of Yd^T Yd (4 nv R each: Yd x, then Yd^T y), final
//   Yd f 2 nv R, output sweeps 4 * 481
//   = 140 nv R + 962 R + 1924 ~ 2.38 MFLOP per env, 9.7 GFLOP at B=4096.
// Bytes moved (each input read once, each output written once): 18.7 kB
// per env, 77 MB at B=4096. Bound on an H100 SXM: 9.7 GFLOP / 67 TFLOP/s
// (float32, no tensor cores) = 0.15 ms against 77 MB / 3.35 TB/s =
// 0.023 ms, so solve_rows is bound by float32 arithmetic. The stage
// kernels write or read Yd (261 MB at B=4096, 0.08 ms), so
// upsolve_build_yd and upsolve_yd are bound by bytes and apgd_iterate,
// with its 29 applications, by arithmetic (ops/solver_kernels.*_work).
// At walk_imitation's shapes (the free fly: nv 108, R 176, nM 1213, 1105
// up and 1105 down triplets) solve_rows is 3.05 MFLOP per env, 12.5
// GFLOP at B=4096, a 0.187 ms bound, again by arithmetic.
//
// Design. 256 threads (8 warps) per env; registers allow two blocks per
// SM (the narrow instance, below). Inputs arrive batch-minor (env axis
// last), so one env's values sit B apart and are read strided, one
// 32-byte sector per word (~0.6 GB of sectors at B=4096); the wrappers
// make no env-major copies.
//  - Steps 1-3, column per thread: thread r builds column r of J^T in
//    shared memory (odd row stride R | 1, conflict-free) with the rhs dots
//    in the same pass, then runs the up-sweep down its column. The body
//    masks arrive as bits (4 words per body, one 16-byte load per row end,
//    no per-element gather); the triplet tables, packed i | j << 7 | e << 14
//    into one word, and sqrt(dinv) are staged in shared memory once, and
//    the up-sweep's entries are decoded once per block into L[e] and the
//    row offset of i. The up-sweep pulls: dof j, last to first, sums its
//    descendants' final values, so no step waits on another step's store
//    and a step is two independent shared loads and an FMA.
//  - Steps 4-6 with Yd in registers: warp w holds dofs 14 w .. 14 w + 13,
//    lane l columns l, l + 32, ..., l + 32 (CPL - 1) (14 CPL floats a
//    thread, so nv <= 112 and R <= 32 CPL; the ragged edges hold zeros).
//    Yd x is 14 CPL register FMAs a thread and a 16-shuffle
//    reduce-scatter inside the warp (no block barrier: a warp's dofs see
//    every column); Yd^T y reuses the same registers and sums the 8
//    warps' partials through shared memory. No Yd element is loaded from
//    shared memory in the loop.
//  - Two instances of every kernel, by the register tile's width: CPL 5
//    (R <= 160, walk_on_ball's 152 rows; registers and shared memory let
//    two blocks share an SM) and CPL 6 (R <= 192, walk_imitation's 176
//    rows; its ~118 kB of shared memory leave one block per SM, so it is
//    built for one and its 84 tile floats a thread fit without spilling).
//    The launchers pick the narrower instance that takes R; the row
//    vectors and the warp partials are sized by the instance's 32 CPL.
//  - The row vectors (z, z - z_prev, s, ...) live in shared memory; thread
//    u < kl + kc owns a unit, one limit row or one cone's three rows, so
//    the projection needs no exchange. The restart test's and the power
//    iteration's sums are warp partials, summed after the next barrier.
//    Barriers: two per power, APGD and noslip iteration (after the warp
//    partials of Yd^T y; after the new row vectors and sums).
//  - Step 7 in parallel: y* / sqrt(d) and y* sqrt(d) for every dof, then
//    L^T by one thread per dof over its entries (a table grouped by the
//    target dof, in the up-sweep's order) on warps 0-3, and L^{-1} level
//    by level on warp 4 (one lane per dof of a level).
// What bounds it now (PERF.md): latency more than throughput, with
// 16 warps per SM (registers; 8 in the wide instance) to hide it: the two barriers and the serial
// owner step of each of the 29 applications (~0.64 ms of the 1.36 ms at
// walk_on_ball shapes), the strided input loads, and the up-sweep's chain
// of 105 dependent dof updates per column. The sums are taken in another
// order than the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int NWARP = 8;
constexpr int NT = 32 * NWARP;        // threads per block
constexpr int DPW = 14;               // dofs per warp in the register tile
constexpr int MAX_NV = NWARP * DPW;   // 112
constexpr int CPL_NARROW = 5;         // columns per lane: R <= 160
constexpr int CPL_WIDE = 6;           // R <= 192
constexpr int YW = 16;                // y slots per warp (DPW padded)
constexpr int NRED = 4 * NWARP;       // four sets of warp partials
constexpr unsigned FULL = 0xffffffffu;

// Rows an instance takes: one column per lane and tile column.
template <int CPL>
__host__ __device__ constexpr int max_r() { return 32 * CPL; }

static_assert(MAX_NV <= 128, "dof indices are packed in 7 bits, masks in "
                             "4 words");
static_assert(max_r<CPL_WIDE>() <= NT && MAX_NV <= NT,
              "one thread per column or dof");

__device__ __forceinline__ int trip_i(int p) { return p & 127; }
__device__ __forceinline__ int trip_j(int p) { return (p >> 7) & 127; }
__device__ __forceinline__ int trip_e(int p) { return p >> 14; }

__device__ __forceinline__ float warp_sum(float x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
}

// Lane 0 of each warp writes the warp's sum of x to red[w]; every warp
// must call.
__device__ __forceinline__ void part_write(float x, float* red) {
    x = warp_sum(x);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
}

// The block's sum of what part_write left in red, read after a barrier
// (the same order in every thread).
__device__ __forceinline__ float part_sum(const float* red) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += red[w];
    return s;
}

struct Rows {
    int R, kl, kc, S;
};

// The packed tables (ops/solver_kernels.pack_tables), in this order:
// [cptr nv+1 | cidx n_up | dn n_down | sptr nseg+1 | lptr nlev+1]
struct Tab {
    const int *cptr, *cidx, *dn, *sptr, *lptr;
};

__device__ Tab tab_at(const int* t, int nv, int n_up, int n_down,
                      int nseg) {
    Tab q;
    q.cptr = t;
    q.cidx = q.cptr + nv + 1;
    q.dn = q.cidx + n_up;
    q.sptr = q.dn + n_down;
    q.lptr = q.sptr + nseg + 1;
    return q;
}

// The block's dynamic shared memory, the same carve-up for every kernel
// here, with MR = max_r<CPL>() of the instance
// (ops/solver_kernels.smem_bytes mirrors it).
struct Smem {
    float *ys, *gpart, *red, *d6, *Yd, *ld, *qv, *qs, *sqd, *sqm, *ystar,
        *xq;
    // row vectors: diag + rreg; b, then s b; rreg, then s^2 rreg; active;
    // v0, then v; f0, then z; z - z_prev; s
    float *dsh, *bs, *s2r, *act, *vs, *zs, *dz, *ss;
    int* tab;
    // the up-sweep's entries in table order (cidx): L[e] and i * S
    float* ldv;
    int* ioff;
};

template <int CPL>
__device__ Smem carve(float* sm, int nv, int S, int nM, int ntab,
                      int n_up) {
    constexpr int MR = max_r<CPL>();
    Smem p;
    p.ys = sm;                        // NWARP * YW (16-byte aligned)
    p.gpart = p.ys + NWARP * YW;      // NWARP * MR
    p.red = p.gpart + NWARP * MR;     // NRED
    p.d6 = p.red + NRED;              // 6 nv (8-byte aligned)
    p.Yd = p.d6 + 6 * nv;             // nv * S
    p.ld = p.Yd + nv * S;             // nM
    p.qv = p.ld + nM;                 // nv each
    p.qs = p.qv + nv;
    p.sqd = p.qs + nv;
    p.sqm = p.sqd + nv;
    p.ystar = p.sqm + nv;
    p.xq = p.ystar + nv;
    p.dsh = p.xq + nv;                // MR each
    p.bs = p.dsh + MR;
    p.s2r = p.bs + MR;
    p.act = p.s2r + MR;
    p.vs = p.act + MR;
    p.zs = p.vs + MR;
    p.dz = p.zs + MR;
    p.ss = p.dz + MR;
    p.tab = reinterpret_cast<int*>(p.ss + MR);       // ntab
    p.ldv = reinterpret_cast<float*>(p.tab + ntab);  // n_up
    p.ioff = p.tab + ntab + n_up;                    // n_up
    return p;
}

// n words of src (stride B from offset b) into dst, four loads in flight
// per thread.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int B, int b) {
    int k = threadIdx.x;
    for (; k + 3 * NT < n; k += 4 * NT) {
        float x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = src[(k + u * NT) * B + b];
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[k + u * NT] = x[u];
    }
    for (; k < n; k += NT) dst[k] = src[k * B + b];
}

// Stage env b's factor, dof vectors, d6 (may be null) and ntab words of
// tables, whose cptr | cidx head (S the Yd row stride) is decoded into
// ldv and ioff. Ends with a barrier.
__device__ void stage_env(const Smem& p, const float* ld, const float* d6,
                          const float* qvel, const float* qacc_smooth,
                          const float* dinv, const int* tab, int ntab,
                          int nv, int nM, int n_up, int S, int B, int b) {
    const int t = threadIdx.x;
    stage(p.ld, ld, nM, B, b);
    if (d6 != nullptr) stage(p.d6, d6, nv * 6, B, b);
    for (int v = t; v < nv; v += NT) {
        p.qv[v] = qvel[v * B + b];
        p.qs[v] = qacc_smooth[v * B + b];
        const float d = dinv[v * B + b];
        p.sqd[v] = sqrtf(d);
        p.sqm[v] = sqrtf(fmaxf(d, 1e-30f));
    }
    for (int k = t; k < ntab; k += NT) p.tab[k] = __ldg(tab + k);
    __syncthreads();
    const int* cidx = p.tab + nv + 1;
    for (int q = t; q < n_up; q += NT) {
        const int pk = cidx[q];
        p.ldv[q] = p.ld[trip_e(pk)];
        p.ioff[q] = trip_i(pk) * S;
    }
    __syncthreads();
}

// Step 1 with the rhs dots: column r of J^T into column r of Yd; returns
// J qvel and J qacc_smooth of row r.
__device__ void build_col(const Smem& p, int S, int r, int nv,
                          const float* u6, const int* b1, const int* b2,
                          const float* lim_sign, const int* lim_dadr,
                          const uint4* mbits, int B, int b, float* velj,
                          float* aj) {
    float u[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) u[c] = u6[(r * 6 + c) * B + b];
    const uint4 m1 = __ldg(mbits + b1[r * B + b]);
    const uint4 m2 = __ldg(mbits + b2[r * B + b]);
    const unsigned w1[4] = {m1.x, m1.y, m1.z, m1.w};
    const unsigned w2[4] = {m2.x, m2.y, m2.z, m2.w};
    const float ls = lim_sign[r * B + b];
    const int la = lim_dadr[r * B + b];
    float vj = 0.0f, a = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int n = min(32, nv - 32 * q);
        for (int o = 0; o < n; ++o) {
            const int v = 32 * q + o;
            const float2* dv = reinterpret_cast<const float2*>(p.d6 + v * 6);
            const float2 d01 = dv[0], d23 = dv[1], d45 = dv[2];
            float dots = d01.x * u[0];
            dots += d01.y * u[1];
            dots += d23.x * u[2];
            dots += d23.y * u[3];
            dots += d45.x * u[4];
            dots += d45.y * u[5];
            const float md = (float)((w2[q] >> o) & 1u)
                             - (float)((w1[q] >> o) & 1u);
            float x = dots * md;
            if (v == la) x += ls;
            p.Yd[v * S + r] = x;
            vj += x * p.qv[v];
            a += x * p.qs[v];
        }
    }
    *velj = vj;
    *aj = a;
}

// Steps 2-3 on column r of Yd, which holds column r of J^T: Yd's column
// becomes D^{-1/2} L^{-T} J^T; returns its squared norm (Yd^T Yd)[r, r].
// The up-sweep pulls: dof j, from the last to the first (a dof's
// descendants have larger indices), takes its updates from its final
// descendants in the up-sweep's order (cptr; the entries decoded into ldv
// and ioff), so a step's loads wait on no other step.
__device__ float upsolve_col(const Smem& p, const int* cptr, int S, int r,
                             int nv) {
    for (int j = nv - 1; j >= 0; --j) {
        float acc = p.Yd[j * S + r];
        const int q1 = cptr[j + 1];
#pragma unroll 4
        for (int q = cptr[j]; q < q1; ++q)
            acc -= p.ldv[q] * p.Yd[p.ioff[q] + r];
        p.Yd[j * S + r] = acc;
    }
    float dg = 0.0f;
    for (int v = 0; v < nv; ++v) {
        const float y = p.Yd[v * S + r] * p.sqd[v];
        p.Yd[v * S + r] = y;
        dg += y * y;
    }
    return dg;
}

// Row r's inputs to steps 4-6 into the row vectors, and the warp partials
// of sum v0^2 (red[0..7]) and sum active (red[8..15]). Every thread calls
// (row = r < R); a barrier must follow.
__device__ void row_inputs(const Smem& p, bool row, int r, float diag,
                           float bvec, float rr, float act, float v0,
                           float f0) {
    if (row) {
        p.dsh[r] = diag + rr;
        p.bs[r] = bvec;
        p.s2r[r] = rr;
        p.act[r] = act;
        p.vs[r] = v0;
        p.zs[r] = f0;
    }
    part_write(row ? v0 * v0 : 0.0f, p.red);
    part_write(row ? act : 0.0f, p.red + NWARP);
}

// The register tile of Yd from shared memory (zeros past nv and R). A
// barrier must precede.
template <int CPL>
__device__ __forceinline__ void load_tiles(const Smem& p,
                                           float (&yd)[DPW][CPL], int nv,
                                           int R, int S) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < DPW; ++k) {
        const int v = w * DPW + k;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
            const int col = lane + 32 * c;
            yd[k][c] = (v < nv && col < R) ? p.Yd[v * S + col] : 0.0f;
        }
    }
}

// One step of the butterfly reduce-scatter: lanes whose bit 2H is set
// keep slots H .. 2H - 1 (moved to 0 .. H - 1), the others slots
// 0 .. H - 1, each summed with the partner lane's copy.
template <int H>
__device__ __forceinline__ void rs_step(float (&pt)[YW], int lane) {
    const bool hi = lane & (2 * H);
#pragma unroll
    for (int i = 0; i < H; ++i) {
        const float send = hi ? pt[i] : pt[i + H];
        const float keep = hi ? pt[i + H] : pt[i];
        pt[i] = keep + __shfl_xor_sync(FULL, send, 2 * H);
    }
}

// Yd x for this warp's dofs, x(col) for col < R: the sum for dof
// 14 w + k lands in lanes 2k and 2k + 1 (a butterfly reduce-scatter over
// 16 slots: 8 + 4 + 2 + 1 + 1 shuffles).
template <int CPL, class X>
__device__ __forceinline__ float mv_y(const float (&yd)[DPW][CPL], X x,
                                      int R) {
    const int lane = threadIdx.x & 31;
    float xv[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
        const int col = lane + 32 * c;
        xv[c] = col < R ? x(col) : 0.0f;
    }
    float pt[YW];
#pragma unroll
    for (int k = 0; k < DPW; ++k) {
        float a = yd[k][0] * xv[0];
#pragma unroll
        for (int c = 1; c < CPL; ++c) a = fmaf(yd[k][c], xv[c], a);
        pt[k] = a;
    }
#pragma unroll
    for (int k = DPW; k < YW; ++k) pt[k] = 0.0f;
    rs_step<8>(pt, lane);
    rs_step<4>(pt, lane);
    rs_step<2>(pt, lane);
    rs_step<1>(pt, lane);
    return pt[0] + __shfl_xor_sync(FULL, pt[0], 1);
}

// The warp's y (from mv_y) into its slots of ys, then this lane's
// partials of Yd^T y into gpart[w][col].
template <int CPL>
__device__ __forceinline__ void mv_g(const Smem& p,
                                     const float (&yd)[DPW][CPL], float yk) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    float* ysw = p.ys + w * YW;
    if (!(lane & 1) && (lane >> 1) < DPW) ysw[lane >> 1] = yk;
    __syncwarp();
    float y[YW];
    const float4* y4 = reinterpret_cast<const float4*>(ysw);
#pragma unroll
    for (int q = 0; q < YW / 4; ++q) {
        const float4 t = y4[q];
        y[4 * q] = t.x;
        y[4 * q + 1] = t.y;
        y[4 * q + 2] = t.z;
        y[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
        float g = yd[0][c] * y[0];
#pragma unroll
        for (int k = 1; k < DPW; ++k) g = fmaf(yd[k][c], y[k], g);
        p.gpart[w * max_r<CPL>() + lane + 32 * c] = g;
    }
}

// The warp partials of Yd^T Yd x into gpart, then the barrier.
template <int CPL, class X>
__device__ __forceinline__ void apply(const Smem& p,
                                      const float (&yd)[DPW][CPL], X x,
                                      int R) {
    mv_g(p, yd, mv_y(yd, x, R));
    __syncthreads();
}

// (Yd^T Yd x)[r] from the warp partials (after apply's barrier).
template <int CPL>
__device__ __forceinline__ float gsum(const Smem& p, int r) {
    float g = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) g += p.gpart[w * max_r<CPL>() + r];
    return g;
}

// A unit's rows projected onto the nonneg orthant (one limit row, nr 1)
// or an elliptic cone (normal, tangent 1, tangent 2), times active. With
// tangent_only the limit row passes through and the normal is frozen.
__device__ __forceinline__ void project(float (&z)[3], int nr, float m,
                                        const float* act, const int (&rows)[3],
                                        bool tangent_only) {
    if (nr == 1) {
        const float o = tangent_only ? z[0] : fmaxf(z[0], 0.0f);
        z[0] = o * act[rows[0]];
        return;
    }
    const float fn = z[0], t1 = z[1], t2 = z[2];
    const float t = sqrtf(t1 * t1 + t2 * t2) + 1e-20f;
    float fn_new, sc;
    if (tangent_only) {
        const float cap = fmaxf(m * fn, 0.0f);
        sc = fminf(1.0f, cap / t);
        fn_new = fn;
    } else {
        const bool inside = t <= m * fn;
        const bool zero = m * t <= -fn;
        const float fn_m = (fn + m * t) / (1.0f + m * m);
        fn_new = inside ? fn : (zero ? 0.0f : fn_m);
        sc = inside ? 1.0f : (zero ? 0.0f : m * fn_m / t);
    }
    z[0] = fn_new * act[rows[0]];
    z[1] = t1 * sc * act[rows[1]];
    z[2] = t2 * sc * act[rows[2]];
}

// Steps 4-6 with Yd in registers, from the row vectors row_inputs wrote
// (after a barrier); then f and v out and y* = Yd f into p.ystar (ends
// with a barrier).
template <int CPL>
__device__ __forceinline__ void apgd(const Smem& p,
                                     const float (&yd)[DPW][CPL], int nv,
                                     const Rows& rw, const float* mu, int B,
                                     int b, int iterations, int noslip,
                                     int power_iters, float* f_out,
                                     float* v_out) {
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int R = rw.R, kl = rw.kl, kc = rw.kc;
    const bool own = t < kl + kc;
    const int nr = t < kl ? 1 : 3;
    const int rows[3] = {t, kc + t, 2 * kc + t};   // a cone's rows
    const float m = own && nr == 3 ? mu[(t - kl) * B + b] : 0.0f;
    float* vred = p.red + 2 * NWARP;   // partials of sum v^2
    float* rred = p.red + 3 * NWARP;   // partials of the restart test

    // ---- cone-uniform Jacobi scaling ----
    float dcone = 0.0f, s = 0.0f;
    if (own) {
        dcone = p.dsh[t];
        s = 1.0f / sqrtf(fmaxf(dcone, 1e-12f));
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            if (j >= nr) break;
            const int r = rows[j];
            p.ss[r] = s;
            p.bs[r] = s * p.bs[r];
            p.s2r[r] = s * s * p.s2r[r];
        }
    }

    // ---- 4. warm power iteration ----
    const float nrm0 = sqrtf(part_sum(p.red)) + 1e-30f;
    const float asum = part_sum(p.red + NWARP);
    float vpart = 0.0f;
    if (own) {
        float z[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            if (j >= nr) break;
            const int r = rows[j];
            const float a = p.act[r];
            const float v = (p.vs[r] / nrm0 + a / sqrtf(fmaxf(asum, 1.0f)))
                            * a;
            p.vs[r] = v;
            vpart += v * v;
            z[j] = p.zs[r] / fmaxf(s, 1e-30f);
        }
        project(z, nr, m, p.act, rows, false);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            if (j >= nr) break;
            p.zs[rows[j]] = z[j];
            p.dz[rows[j]] = 0.0f;
        }
    }
    part_write(vpart, vred);
    __syncthreads();
    float sv = part_sum(vred);
    for (int it = 0; it < power_iters; ++it) {
        const float nrm = sqrtf(sv) + 1e-30f;
        apply(p, yd, [&](int c) { return p.ss[c] * (p.vs[c] / nrm); }, R);
        vpart = 0.0f;
        if (own) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                if (j >= nr) break;
                const int r = rows[j];
                const float vn = p.vs[r] / nrm;
                const float v = (p.ss[r] * gsum<CPL>(p, r) + p.s2r[r] * vn)
                                * p.act[r];
                p.vs[r] = v;
                vpart += v * v;
            }
        }
        part_write(vpart, vred);
        __syncthreads();
        sv = part_sum(vred);
    }
    const float L = power_iters > 0 ? sqrtf(sv) + 1e-30f : 1.0f;
    const float inv_l = 1.0f / fmaxf(1.5f * L, 1.0f);
    if (own) {
        const float vnorm = sqrtf(sv + 1e-30f);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            if (j >= nr) break;
            v_out[rows[j] * B + b] = p.vs[rows[j]] / vnorm;
        }
    }

    // ---- 5. APGD with restart ----
    float kk = 0.0f;
    for (int it = 0; it < iterations; ++it) {
        const float beta = kk / (kk + 3.0f);
        apply(p, yd,
              [&](int c) { return p.ss[c] * (p.zs[c] + beta * p.dz[c]); },
              R);
        float rpart = 0.0f;
        if (own) {
            float z[3], zo[3], g[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                if (j >= nr) break;
                const int r = rows[j];
                zo[j] = p.zs[r];
                const float y = zo[j] + beta * p.dz[r];
                g[j] = p.ss[r] * gsum<CPL>(p, r) + p.s2r[r] * y - p.bs[r];
                z[j] = y - inv_l * g[j];
            }
            project(z, nr, m, p.act, rows, false);
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                if (j >= nr) break;
                rpart += g[j] * (z[j] - zo[j]);
                p.dz[rows[j]] = z[j] - zo[j];
                p.zs[rows[j]] = z[j];
            }
        }
        part_write(rpart, rred);
        __syncthreads();
        kk = part_sum(rred) > 0.0f ? 0.0f : kk + 1.0f;
    }

    // ---- 6. noslip: tangential rows only, normals frozen ----
    if (noslip > 0 && kc > 0) {
        const float pns = 1.0f / fmaxf(dcone * s * s, 1e-30f);
        for (int it = 0; it < 2 * noslip; ++it) {
            apply(p, yd, [&](int c) { return p.ss[c] * p.zs[c]; }, R);
            if (own) {
                float z[3];
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    if (j >= nr) break;
                    const int r = rows[j];
                    const float g = p.ss[r] * gsum<CPL>(p, r) - p.bs[r];
                    z[j] = r < kl + kc ? p.zs[r]
                                       : p.zs[r] - inv_l * pns * g;
                }
                project(z, nr, m, p.act, rows, true);
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    if (j >= nr) break;
                    p.zs[rows[j]] = z[j];
                }
            }
            __syncthreads();
        }
    }

    // ---- f = s z out, y* = Yd f ----
    const float yk = mv_y(yd, [&](int c) { return p.ss[c] * p.zs[c]; }, R);
    const int v = w * DPW + (lane >> 1);
    if (!(lane & 1) && (lane >> 1) < DPW && v < nv) p.ystar[v] = yk;
    if (own) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            if (j >= nr) break;
            f_out[rows[j] * B + b] = p.ss[rows[j]] * p.zs[rows[j]];
        }
    }
    __syncthreads();
}

// Blocks per SM each instance is built for: two of the narrow one (its
// ~91 kB of shared memory at walk_on_ball allow two), one of the wide one
// (~118 kB at walk_imitation allow one, and its 84 tile floats a thread
// then need no spill).
template <int CPL>
__host__ __device__ constexpr int min_blocks() {
    return CPL == CPL_NARROW ? 2 : 1;
}

template <int CPL>
__global__ void __launch_bounds__(NT, min_blocks<CPL>()) solve_rows_kernel(
    const float* __restrict__ d6, const float* __restrict__ u6,
    const int* __restrict__ b1, const int* __restrict__ b2,
    const float* __restrict__ lim_sign, const int* __restrict__ lim_dadr,
    const uint4* __restrict__ mbits, const float* __restrict__ ld,
    const float* __restrict__ dinv, const float* __restrict__ qacc_smooth,
    const float* __restrict__ qvel, const float* __restrict__ kcoef,
    const float* __restrict__ bcoef, const float* __restrict__ posr,
    const float* __restrict__ rreg, const float* __restrict__ active,
    const float* __restrict__ mu, const float* __restrict__ f0,
    const float* __restrict__ v0,
    float* __restrict__ f_out, float* __restrict__ v_out,
    float* __restrict__ qfrc_out, float* __restrict__ dqacc_out,
    const int* __restrict__ tab, int nv, int R, int B, int nM, int kl,
    int kc, int n_up, int n_down, int nseg, int nlev, int iterations,
    int noslip, int power_iters) {
    extern __shared__ __align__(16) float sm[];
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const Rows rw{R, kl, kc, R | 1};
    const int ntab = nv + 1 + n_up + n_down + nseg + 1 + nlev + 1;
    const Smem p = carve<CPL>(sm, nv, rw.S, nM, ntab, n_up);
    stage_env(p, ld, d6, qvel, qacc_smooth, dinv, tab, ntab, nv, nM, n_up,
              rw.S, B, b);
    const Tab tb = tab_at(p.tab, nv, n_up, n_down, nseg);

    // ---- 1-3. J^T column r, the rhs b[r], the up-solve ----
    const bool row = r < R;
    float diag = 0.0f, bvec = 0.0f;
    if (row) {
        float velj, aj;
        build_col(p, rw.S, r, nv, u6, b1, b2, lim_sign, lim_dadr, mbits, B,
                  b, &velj, &aj);
        bvec = -bcoef[r * B + b] * velj - kcoef[r * B + b] * posr[r * B + b]
               - aj;
        diag = upsolve_col(p, tb.cptr, rw.S, r, nv);
    }
    row_inputs(p, row, r, diag, bvec, row ? rreg[r * B + b] : 0.0f,
               row ? active[r * B + b] : 0.0f, row ? v0[r * B + b] : 0.0f,
               row ? f0[r * B + b] : 0.0f);
    __syncthreads();

    // ---- 4-6. ----
    float yd[DPW][CPL];
    load_tiles(p, yd, nv, R, rw.S);
    apgd(p, yd, nv, rw, mu, B, b, iterations, noslip, power_iters, f_out,
         v_out);

    // ---- 7. qfrc = L^T (y* D^{1/2}), dqacc = L^{-1} (y* D^{-1/2}) ----
    for (int k = r; k < nv; k += NT) {
        p.xq[k] = p.ystar[k] / p.sqm[k];
        p.qs[k] = p.ystar[k] * p.sqd[k];
    }
    __syncthreads();
    const int w = r >> 5, lane = r & 31;
    if (r < nv) {   // warps 0-3: (L^T x)[j] = x[j] + sum_i L[i, j] x[i]
        float acc = p.xq[r];
        for (int q = tb.cptr[r]; q < tb.cptr[r + 1]; ++q) {
            const int pk = tb.cidx[q];
            acc += p.ld[trip_e(pk)] * p.xq[trip_i(pk)];
        }
        qfrc_out[r * B + b] = acc;
    } else if (w == 4) {   // root first: x[i] -= L[i, j] x[j]
        for (int l = 0; l < nlev; ++l) {
            for (int sg = tb.lptr[l] + lane; sg < tb.lptr[l + 1]; sg += 32) {
                const int q0 = tb.sptr[sg], q1 = tb.sptr[sg + 1];
                const int i = trip_i(tb.dn[q0]);
                float acc = p.qs[i];
                for (int q = q0; q < q1; ++q) {
                    const int pk = tb.dn[q];
                    acc -= p.ld[trip_e(pk)] * p.qs[trip_j(pk)];
                }
                p.qs[i] = acc;
            }
            __syncwarp();
        }
        for (int k = lane; k < nv; k += 32) dqacc_out[k * B + b] = p.qs[k];
    }
}

// Steps 1-3 (build = 1) or 2-3 on jt (build = 0); writes yd (nv, R, B) and
// b (R, B).
template <int CPL>
__global__ void __launch_bounds__(NT) upsolve_kernel(
    int build, const float* __restrict__ jt, const float* __restrict__ d6,
    const float* __restrict__ u6, const int* __restrict__ b1,
    const int* __restrict__ b2, const float* __restrict__ lim_sign,
    const int* __restrict__ lim_dadr, const uint4* __restrict__ mbits,
    const float* __restrict__ ld, const float* __restrict__ dinv,
    const float* __restrict__ qacc_smooth, const float* __restrict__ qvel,
    const float* __restrict__ kcoef, const float* __restrict__ bcoef,
    const float* __restrict__ posr, float* __restrict__ yd_out,
    float* __restrict__ b_out, const int* __restrict__ tab, int nv, int R,
    int B, int nM, int n_up) {
    extern __shared__ __align__(16) float sm[];
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const int S = R | 1;
    // the head of the tables: cptr | cidx
    const Smem p = carve<CPL>(sm, nv, S, nM, nv + 1 + n_up, n_up);
    stage_env(p, ld, build ? d6 : nullptr, qvel, qacc_smooth, dinv, tab,
              nv + 1 + n_up, nv, nM, n_up, S, B, b);
    const Tab tb = tab_at(p.tab, nv, n_up, 0, 0);
    if (r >= R) return;
    float velj = 0.0f, aj = 0.0f;
    if (build) {
        build_col(p, S, r, nv, u6, b1, b2, lim_sign, lim_dadr, mbits, B, b,
                  &velj, &aj);
    } else {
        for (int v = 0; v < nv; ++v) {
            const float x = jt[(v * R + r) * B + b];
            p.Yd[v * S + r] = x;
            velj += x * p.qv[v];
            aj += x * p.qs[v];
        }
    }
    b_out[r * B + b] = -bcoef[r * B + b] * velj
                       - kcoef[r * B + b] * posr[r * B + b] - aj;
    upsolve_col(p, tb.cptr, S, r, nv);
    for (int v = 0; v < nv; ++v) yd_out[(v * R + r) * B + b] = p.Yd[v * S + r];
}

// Steps 4-6 on a given Yd (nv, R, B); writes f, v (R, B) and
// ystar = Yd f (nv, B).
template <int CPL>
__global__ void __launch_bounds__(NT, min_blocks<CPL>()) apgd_kernel(
    const float* __restrict__ yd_in, const float* __restrict__ bvec_in,
    const float* __restrict__ rreg, const float* __restrict__ active,
    const float* __restrict__ mu, const float* __restrict__ f0,
    const float* __restrict__ v0, float* __restrict__ f_out,
    float* __restrict__ ystar_out, float* __restrict__ v_out, int nv,
    int R, int B, int kl, int kc, int iterations, int noslip,
    int power_iters) {
    extern __shared__ __align__(16) float sm[];
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const Rows rw{R, kl, kc, R | 1};
    const Smem p = carve<CPL>(sm, nv, rw.S, 0, 0, 0);
    for (int k = r; k < nv * R; k += NT) {   // neighbours read neighbours
        const int v = k / R, c = k - v * R;
        p.Yd[v * rw.S + c] = yd_in[k * B + b];
    }
    __syncthreads();
    const bool row = r < R;
    float diag = 0.0f;
    if (row)
        for (int v = 0; v < nv; ++v) {
            const float y = p.Yd[v * rw.S + r];
            diag += y * y;
        }
    row_inputs(p, row, r, diag, row ? bvec_in[r * B + b] : 0.0f,
               row ? rreg[r * B + b] : 0.0f, row ? active[r * B + b] : 0.0f,
               row ? v0[r * B + b] : 0.0f, row ? f0[r * B + b] : 0.0f);
    __syncthreads();
    float yd[DPW][CPL];
    load_tiles(p, yd, nv, R, rw.S);
    apgd(p, yd, nv, rw, mu, B, b, iterations, noslip, power_iters, f_out,
         v_out);
    for (int k = r; k < nv; k += NT) ystar_out[k * B + b] = p.ystar[k];
}

bool shape_ok(int nv, int R, int B) {
    return nv > 0 && nv <= MAX_NV && R > 0 && R <= max_r<CPL_WIDE>()
           && B > 0;
}

// The narrower instance that takes R rows.
bool narrow(int R) { return R <= max_r<CPL_NARROW>(); }

bool rows_ok(int R, int kl, int kc) {
    return kl >= 0 && kc >= 0 && kl + 3 * kc == R;
}

template <typename K>
cudaError_t set_smem(K kernel, int smem_bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

}  // namespace

extern "C" int solve_rows_launch(
    const float* d6, const float* u6, const int* b1, const int* b2,
    const float* lim_sign, const int* lim_dadr, const void* mbits,
    const float* ld, const float* dinv, const float* qacc_smooth,
    const float* qvel, const float* kcoef, const float* bcoef,
    const float* posr, const float* rreg, const float* active,
    const float* mu, const float* f0, const float* v0, float* f_out,
    float* v_out, float* qfrc_out, float* dqacc_out, const int* tab, int nv,
    int R, int B, int nM, int kl, int kc, int n_up, int n_down, int nseg,
    int nlev, int iterations, int noslip, int power_iters, int smem_bytes,
    void* stream) {
    if (!shape_ok(nv, R, B) || !rows_ok(R, kl, kc))
        return (int)cudaErrorInvalidValue;
    auto kernel = narrow(R) ? solve_rows_kernel<CPL_NARROW>
                            : solve_rows_kernel<CPL_WIDE>;
    cudaError_t e = set_smem(kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<B, NT, smem_bytes, (cudaStream_t)stream>>>(
        d6, u6, b1, b2, lim_sign, lim_dadr, static_cast<const uint4*>(mbits),
        ld, dinv, qacc_smooth, qvel, kcoef, bcoef, posr, rreg, active, mu,
        f0, v0, f_out, v_out, qfrc_out, dqacc_out, tab, nv, R, B, nM, kl, kc,
        n_up, n_down, nseg, nlev, iterations, noslip, power_iters);
    return (int)cudaGetLastError();
}

// upsolve_build_yd (build = 1: jt unused) and upsolve_yd (build = 0: the
// compact-row inputs unused, may be null). tab: the packed tables.
extern "C" int upsolve_launch(
    int build, const float* jt, const float* d6, const float* u6,
    const int* b1, const int* b2, const float* lim_sign, const int* lim_dadr,
    const void* mbits, const float* ld, const float* dinv,
    const float* qacc_smooth, const float* qvel, const float* kcoef,
    const float* bcoef, const float* posr, float* yd_out, float* b_out,
    const int* tab, int nv, int R, int B, int nM, int n_up, int smem_bytes,
    void* stream) {
    if (!shape_ok(nv, R, B)) return (int)cudaErrorInvalidValue;
    auto kernel = narrow(R) ? upsolve_kernel<CPL_NARROW>
                            : upsolve_kernel<CPL_WIDE>;
    cudaError_t e = set_smem(kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<B, NT, smem_bytes, (cudaStream_t)stream>>>(
        build, jt, d6, u6, b1, b2, lim_sign, lim_dadr,
        static_cast<const uint4*>(mbits), ld, dinv, qacc_smooth, qvel, kcoef,
        bcoef, posr, yd_out, b_out, tab, nv, R, B, nM, n_up);
    return (int)cudaGetLastError();
}

extern "C" int apgd_launch(
    const float* yd, const float* b, const float* rreg, const float* active,
    const float* mu, const float* f0, const float* v0, float* f_out,
    float* ystar_out, float* v_out, int nv, int R, int B, int kl, int kc,
    int iterations, int noslip, int power_iters, int smem_bytes,
    void* stream) {
    if (!shape_ok(nv, R, B) || !rows_ok(R, kl, kc))
        return (int)cudaErrorInvalidValue;
    auto kernel = narrow(R) ? apgd_kernel<CPL_NARROW>
                            : apgd_kernel<CPL_WIDE>;
    cudaError_t e = set_smem(kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<B, NT, smem_bytes, (cudaStream_t)stream>>>(
        yd, b, rreg, active, mu, f0, v0, f_out, ystar_out, v_out, nv, R, B,
        kl, kc, iterations, noslip, power_iters);
    return (int)cudaGetLastError();
}

// Registers per thread, static and dynamic shared memory per block,
// resident blocks per SM and local (spill) memory per thread of kernel
// `which` (0 solve_rows, 1 upsolve, 2 apgd; plus 3 for the wide instance)
// at `threads` threads and `smem_bytes` of dynamic shared memory.
extern "C" int fb_kernel_info(int which, int threads, int smem_bytes,
                              int* out) {
    const void* kernels[6] = {
        (const void*)solve_rows_kernel<CPL_NARROW>,
        (const void*)upsolve_kernel<CPL_NARROW>,
        (const void*)apgd_kernel<CPL_NARROW>,
        (const void*)solve_rows_kernel<CPL_WIDE>,
        (const void*)upsolve_kernel<CPL_WIDE>,
        (const void*)apgd_kernel<CPL_WIDE>};
    if (which < 0 || which > 5) return (int)cudaErrorInvalidValue;
    const void* k = kernels[which];
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    cudaFuncAttributes a;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
    int n = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads,
                                                          smem_bytes);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = smem_bytes;
    out[3] = n;
    out[4] = (int)a.localSizeBytes;
    return 0;
}

extern "C" const char* fb_cuda_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
