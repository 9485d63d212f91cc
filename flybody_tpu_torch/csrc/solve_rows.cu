// The fused dual contact solve and its stage kernels.
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
// Design of solve_rows, upsolve_build_yd and apgd_iterate: one thread
// block of 256 threads (8 warps) per env, two blocks per SM (registers and
// shared memory allow two in either instance, below). Inputs arrive
// batch-minor (env axis last), so one env's values sit B apart and are
// read strided, one 32-byte sector per word; the wrappers make no
// env-major copies. Every staged word is copied with cp.async, so a
// thread's copies are all in flight at once, and every row input is
// loaded before the env is staged, so its latency overlaps the staging.
//  - Two instances of every kernel, by the register tile's width: CPL 5
//    (R <= 160: walk_on_ball's 152 rows, flight_imitation's 64) holds
//    column groups 0-4 of Yd in registers (70 floats a thread); CPL 6
//    (R <= 192: walk_imitation's 176) holds groups 0-3 (56 floats) and
//    reads groups 4-5 from the copy of Yd that steps 1-3 leave in shared
//    memory, packed as pairs (one 8-byte load a dof per product). So both
//    fit 128 registers without spilling and run two blocks, 16 warps, per
//    SM: 84 register floats a thread took ~159 registers and left one
//    block of 8 warps per SM, and 16 warps of 42 in one block paid twice
//    the per-warp shared-memory traffic and shuffles in the loop. The
//    launchers pick the narrower instance that takes R.
//  - Steps 1-3, column per thread: thread r builds column r of J^T in
//    shared memory (odd row stride R | 1, conflict-free) with the rhs dots
//    in the same pass, then runs the up-sweep down its column. The body
//    masks arrive as bits (4 words per body, one 16-byte load per row end,
//    no per-element gather); the triplet tables, packed i | j << 7 | e << 14
//    into one word, are staged in shared memory once. The up-sweep pulls:
//    dof j, last to first, sums its descendants' final values, so no step
//    waits on another step's store.
//  - The top chain (pack_tables' `chain`: a free root's 6 dofs, whose
//    pulls are 627 of walk_imitation's 1105 entries) leaves the pull: one
//    pass over the dofs below it feeds 6 register accumulators per Yd load
//    from a dense table of L (zeros where a dof is no descendant), then
//    the 6 x 6 chain resolves. Where 2 R <= 256 (flight_imitation's 64
//    rows), the dofs below split at a subtree boundary (`dsplit`) between
//    thread r and thread 128 + r, which build, pull and scale their halves
//    at once and meet at one barrier (the partial sums pass through the
//    warp-partial buffer, idle until step 4).
//  - Steps 4-6 with Yd in registers: warp w holds dofs 14 w .. 14 w + 13,
//    lane l columns l, l + 32, ..., l + 32 (CPL - 1) (nv <= 112 and
//    R <= 32 CPL; the ragged edges hold zeros). Yd x is 14 CPL FMAs a
//    thread and a 16-shuffle reduce-scatter inside the warp (no block
//    barrier: a warp's dofs see every column); Yd^T y reuses the same
//    registers and sums the 8 warps' partials through shared memory.
//  - The row vectors (z, z - z_prev, s, ...) live in shared memory; thread
//    u < kl + kc owns a unit, one limit row or one cone's three rows, so
//    the projection needs no exchange. The owners also write the next
//    application's x, s z and s (z + beta (z - z_prev)) with the beta of
//    no restart, so each warp gathers one vector, not three. The restart
//    test's and the power iteration's sums are warp partials, summed
//    after the next barrier. Barriers: two per power, APGD and noslip
//    iteration (after the warp partials of Yd^T y; after the new row
//    vectors and sums).
//  - Step 7 in parallel: y* / sqrt(d) and y* sqrt(d) for every dof, then
//    L^T by one thread per dof over its entries (a table grouped by the
//    target dof, in the up-sweep's order) on warps 0-3, and L^{-1} pushed
//    root first on warps 4-7: at step l each dof takes its ancestor of
//    depth l, one FMA and one barrier of the four warps a step (19 steps
//    at walk_imitation, where a pull level by level on one warp waited on
//    190 dependent entries).
// What bounds it (PERF.md): latency more than throughput, with 16 warps
// per SM to hide it: the two barriers and the serial owner step of each of
// the 29 applications, and the up-sweep's chains of dependent dof updates
// per column. The sums are taken in another order than the plain
// version's.
//
// Design of upsolve_yd (its own kernel): it reads J^T and writes Yd, both
// (nv, R, B), so it is bound by bytes (547.7 MB at walk_on_ball's shapes,
// 0.164 ms). A block takes 8 consecutive envs by 16 columns, lane e of a
// group of 8 on env e, so every global load and store of a warp fills
// whole 32-byte sectors; the tree tables and each env's L entries are
// staged once per block (cp.async). Four threads take each (env, column)
// pair, one part of the dofs each (subtrees, pack_tables' ysplit), and
// pull the up-sweep down the pair's column in shared memory (pair-minor,
// conflict-free): the longest part is 165 of walk_on_ball's 481 entries.
// The last env tile and column tile are masked, never padded.

#include <cuda_runtime.h>

namespace {

constexpr int NWARP = 8;
constexpr int NT = 32 * NWARP;        // threads per block
constexpr int DPW = 14;               // dofs per warp in the register tile
constexpr int MAX_NV = NWARP * DPW;   // 112
constexpr int CPL_NARROW = 5;         // columns per lane: R <= 160
constexpr int CPL_WIDE = 6;           // R <= 192
// Column groups an instance holds in registers (the wide one reads its
// last two from shared memory).
template <int CPL>
__host__ __device__ constexpr int creg() { return CPL == 6 ? 4 : 5; }
constexpr int YW = 16;                // y slots per warp (DPW padded)
constexpr int NRED = 4 * NWARP;       // four sets of warp partials
constexpr int CH = 6;                 // top-chain dofs taken out of the pull
constexpr int NX = CH + 3;            // exchange slots: chain sums, rhs, diag
constexpr unsigned FULL = 0xffffffffu;

// Rows an instance takes: one column per lane and column group.
template <int CPL>
__host__ __device__ constexpr int max_r() { return 32 * CPL; }

static_assert(max_r<CPL_WIDE>() <= NT && MAX_NV <= NT,
              "one thread per column or dof");
static_assert(NX * (NT / 2) <= NWARP * max_r<CPL_NARROW>(),
              "the exchange fits the warp partials");
static_assert((MAX_NV - 2) * CH + CH * CH <= NWARP * max_r<CPL_NARROW>(),
              "the chain's entries fit the warp partials");

static_assert(MAX_NV <= 128, "dof indices are packed in 7 bits, masks in "
                             "4 words");

__device__ __forceinline__ int trip_i(int p) { return p & 127; }
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
    const float4* r4 = reinterpret_cast<const float4*>(red);
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < NWARP / 4; ++q) {
        const float4 t = r4[q];
        s += t.x;
        s += t.y;
        s += t.z;
        s += t.w;
    }
    return s;
}

struct Rows {
    int R, kl, kc, S;
};

// The packed tables (ops/solver_kernels.pack_tables), in this order:
// [cptr nv+1 | cidx n_up | push ndepth nv]; the head cptr | cidx is
// staged in shared memory, push is read from global memory.

// The top chain (pack_tables' chain): its m dofs (0 for none), the split
// point d of the dofs below (nv for none) and the n words of entry
// indices, decoded into lch: L[i, k] for i >= m, k < CH at
// lch[(i - m) CH + k], then L[i, j] of the chain at lch[(nv - m) CH +
// i CH + j].
struct Chain {
    const int* idx;
    int m, d, n;
};

// The block's dynamic shared memory, the same carve-up for every kernel
// here, with the instance's sizes (ops/solver_kernels.smem_bytes mirrors
// it).
struct Smem {
    // dq: per dof d6 (6 words), qvel, qacc_smooth; qs: step 7's scratch
    float *ys, *gpart, *red, *dq, *lch, *Yd, *ld, *qs, *sqd, *sqm,
        *ystar, *xq;
    // row vectors: diag + rreg; b, then s b; rreg, then s^2 rreg; active;
    // v0, then v; f0, then z; z - z_prev; s; the next application's x
    // after a restart (s z) and without one (s (z + beta (z - z_prev)));
    // each unit's friction coefficient (at the unit's thread)
    float *dsh, *bs, *s2r, *act, *vs, *zs, *dz, *ss, *xr, *xc, *mus;
    int* tab;
    float* ldv;   // the up-sweep's L entries in table order (cidx)
};

// The fixed-size parts come first, at offsets known when the kernel is
// compiled, so the loop addresses them without registers.
template <int CPL>
__device__ Smem carve(float* sm, int nv, int S, int nM, int ntab,
                      int n_up, int n_chain) {
    constexpr int MR = max_r<CPL>();
    Smem p;
    p.ys = sm;                        // NWARP * YW (16-byte aligned)
    p.gpart = p.ys + NWARP * YW;      // NWARP * MR; steps 1-3: the exchange
    p.red = p.gpart + NWARP * MR;     // NRED
    p.dsh = p.red + NRED;             // MR each
    p.bs = p.dsh + MR;
    p.s2r = p.bs + MR;
    p.act = p.s2r + MR;
    p.vs = p.act + MR;
    p.zs = p.vs + MR;
    p.dz = p.zs + MR;
    p.ss = p.dz + MR;
    p.xr = p.ss + MR;
    p.xc = p.xr + MR;
    p.mus = p.xc + MR;
    p.dq = p.mus + MR;                // 8 nv (16-byte aligned)
    p.lch = p.dq + 8 * nv;            // n_chain (8-byte aligned)
    p.Yd = p.lch + n_chain;           // nv * S
    p.ld = p.Yd + nv * S;             // nM
    p.qs = p.ld + nM;                 // nv each
    p.sqd = p.qs + nv;
    p.sqm = p.sqd + nv;
    p.ystar = p.sqm + nv;
    p.xq = p.ystar + nv;
    p.ldv = p.xq + nv;                // n_up
    p.tab = reinterpret_cast<int*>(p.ldv + n_up);    // ntab: the head
    return p;
}

// One word from global to shared memory without passing a register
// (cp.async), so a thread keeps all its copies in flight at once: the
// staging costs one memory round trip, not one per word a thread copies.
// cp_wait() waits for this thread's copies; a barrier after it, for all.
__device__ __forceinline__ void cp_word(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n words of src (stride B from offset b) into dst.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int B, int b) {
    for (int k = threadIdx.x; k < n; k += NT)
        cp_word(dst + k, src + k * B + b);
}

// Stage env b's factor, dof vectors, d6 (may be null), the ntab words of
// the tables' head cptr | cidx, whose entries' L values are decoded into
// ldv, and the chain's entries decoded into lch (their indices pass
// through the warp-partial buffer, idle until step 4). Ends with a
// barrier.
__device__ void stage_env(const Smem& p, const float* ld, const float* d6,
                          const float* qvel, const float* qacc_smooth,
                          const float* dinv, const int* tab, int ntab,
                          const Chain& ch, int nv, int nM, int n_up, int B,
                          int b) {
    const int t = threadIdx.x;
    int* cix = reinterpret_cast<int*>(p.gpart);
    stage(p.ld, ld, nM, B, b);
    if (d6 != nullptr)
        for (int k = t; k < nv * 6; k += NT)
            cp_word(p.dq + k / 6 * 8 + k % 6, d6 + k * B + b);
    for (int v = t; v < nv; v += NT) {
        cp_word(p.dq + v * 8 + 6, qvel + v * B + b);
        cp_word(p.dq + v * 8 + 7, qacc_smooth + v * B + b);
    }
    stage(p.sqm, dinv, nv, B, b);
    for (int k = t; k < ntab; k += NT) cp_word(p.tab + k, tab + k);
    for (int q = t; q < ch.n; q += NT) cp_word(cix + q, ch.idx + q);
    cp_wait();
    __syncthreads();
    for (int v = t; v < nv; v += NT) {
        const float d = p.sqm[v];
        p.sqd[v] = sqrtf(d);
        p.sqm[v] = sqrtf(fmaxf(d, 1e-30f));
    }
    const int* cidx = p.tab + nv + 1;
    for (int q = t; q < n_up; q += NT) p.ldv[q] = p.ld[trip_e(cidx[q])];
    for (int q = t; q < ch.n; q += NT) {
        const int e = cix[q];
        p.lch[q] = e >= 0 ? p.ld[e] : 0.0f;
    }
    __syncthreads();
}

// A row's compact-row inputs of step 1 and rhs coefficients of step 2,
// loaded before the env is staged so that their latency overlaps it.
struct RowVals {
    float u[6], ls, kcoef, bcoef, posr;
    int b1, b2, la;
};

__device__ __forceinline__ RowVals load_row(
    const float* u6, const int* b1, const int* b2, const float* lim_sign,
    const int* lim_dadr, const float* kcoef, const float* bcoef,
    const float* posr, int r, int B, int b) {
    RowVals v;
#pragma unroll
    for (int c = 0; c < 6; ++c) v.u[c] = u6[(r * 6 + c) * B + b];
    v.b1 = b1[r * B + b];
    v.b2 = b2[r * B + b];
    v.ls = lim_sign[r * B + b];
    v.la = lim_dadr[r * B + b];
    v.kcoef = kcoef[r * B + b];
    v.bcoef = bcoef[r * B + b];
    v.posr = posr[r * B + b];
    return v;
}

// Step 1 with the rhs dots on dofs [v0, v1): those entries of column r of
// J^T into column r of Yd; adds J qvel and J qacc_smooth of row r over
// them to velj and aj.
__device__ void build_col(const Smem& p, int S, int r, int v0, int v1,
                          const RowVals& in, const uint4* mbits,
                          float* velj, float* aj) {
    const float* u = in.u;
    const uint4 m1 = __ldg(mbits + in.b1);
    const uint4 m2 = __ldg(mbits + in.b2);
    const unsigned w1[4] = {m1.x, m1.y, m1.z, m1.w};
    const unsigned w2[4] = {m2.x, m2.y, m2.z, m2.w};
    const float ls = in.ls;
    const int la = in.la;
    float vj = 0.0f, a = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int lo = max(v0, 32 * q), hi = min(v1, 32 * q + 32);
        for (int v = lo; v < hi; ++v) {
            const int o = v - 32 * q;
            const float4* dv = reinterpret_cast<const float4*>(p.dq + v * 8);
            const float4 d03 = dv[0], d4q = dv[1];
            float dots = d03.x * u[0];
            dots += d03.y * u[1];
            dots += d03.z * u[2];
            dots += d03.w * u[3];
            dots += d4q.x * u[4];
            dots += d4q.y * u[5];
            const float md = (float)((w2[q] >> o) & 1u)
                             - (float)((w1[q] >> o) & 1u);
            float x = dots * md;
            if (v == la) x += ls;
            p.Yd[v * S + r] = x;
            vj += x * d4q.z;
            a += x * d4q.w;
        }
    }
    *velj += vj;
    *aj += a;
}

// The up-sweep's pull on column r for dofs j = hi - 1 down to lo: dof j
// takes its updates from its final descendants in the up-sweep's order
// (cptr, cidx; their L values in ldv), so a step's loads wait on no other
// step.
__device__ void pull(const Smem& p, const int* cptr, const int* cidx, int S,
                     int r, int lo, int hi) {
    for (int j = hi - 1; j >= lo; --j) {
        float acc = p.Yd[j * S + r];
        const int q1 = cptr[j + 1];
#pragma unroll 4
        for (int q = cptr[j]; q < q1; ++q)
            acc -= p.ldv[q] * p.Yd[trip_i(cidx[q]) * S + r];
        p.Yd[j * S + r] = acc;
    }
}

// The chain's sums over dofs [lo, hi) (all below the chain, final):
// acc[k] += L[i, k] Yd[i, r], one Yd load for CH FMAs.
__device__ __forceinline__ void chain_sums(const Smem& p, int S, int r,
                                           int m, int lo, int hi,
                                           float (&acc)[CH]) {
    for (int i = lo; i < hi; ++i) {
        const float y = p.Yd[i * S + r];
        const float2* l = reinterpret_cast<const float2*>(
            p.lch + (i - m) * CH);
        const float2 a = l[0], c = l[1], e = l[2];
        acc[0] = fmaf(a.x, y, acc[0]);
        acc[1] = fmaf(a.y, y, acc[1]);
        acc[2] = fmaf(c.x, y, acc[2]);
        acc[3] = fmaf(c.y, y, acc[3]);
        acc[4] = fmaf(e.x, y, acc[4]);
        acc[5] = fmaf(e.y, y, acc[5]);
    }
}

// The chain's own dofs, last to first: Yd[j] -= acc[j] + sum over chain
// dofs i > j of L[i, j] Yd[i].
__device__ __forceinline__ void chain_resolve(const Smem& p, int S, int r,
                                              int m, int nv,
                                              const float (&acc)[CH]) {
    const float* lcc = p.lch + (nv - m) * CH;
#pragma unroll
    for (int j = CH - 1; j >= 0; --j) {
        if (j >= m) continue;
        float x = p.Yd[j * S + r] - acc[j];
#pragma unroll
        for (int i = j + 1; i < CH; ++i)
            if (i < m) x -= lcc[i * CH + j] * p.Yd[i * S + r];
        p.Yd[j * S + r] = x;
    }
}

// D^{-1/2} on dofs [v0, v1) of column r; returns their sum of squares.
__device__ float scale_col(const Smem& p, int S, int r, int v0, int v1) {
    float dg = 0.0f;
    for (int v = v0; v < v1; ++v) {
        const float y = p.Yd[v * S + r] * p.sqd[v];
        p.Yd[v * S + r] = y;
        dg += y * y;
    }
    return dg;
}

// Which column a thread takes in steps 1-3: thread r < R column r; where
// the tables give a split point d and 2 R <= threads, thread NT / 2 + r
// also column r, on dofs [d, nv) (the lower part).
struct ColRole {
    bool split, upper, lower;
    int r;
    __device__ ColRole(int R, int nv, const Chain& ch) {
        constexpr int half = NT / 2;
        const int t = threadIdx.x;
        split = ch.d < nv && R <= half;
        lower = split && t >= half && t - half < R;
        upper = t < R;
        r = upper ? t : t - half;
    }
};

// Steps 1-3: column r of Yd = D^{-1/2} L^{-T} J^T built in thread r < R
// from its row's inputs, with the rhs b[r] and (Yd^T Yd)[r, r] returned
// there. The lower part's thread (ColRole; no dof of [d, nv) has an
// ancestor in [m, d), so its pull stays inside its part) passes its
// partial sums through the exchange. Every thread calls: one barrier.
__device__ void build_upsolve(const Smem& p, const int* cptr, const Rows& rw,
                              const Chain& ch, const ColRole& role,
                              const RowVals& in, const uint4* mbits, int nv,
                              float* diag, float* bvec) {
    constexpr int half = NT / 2;
    const int* cidx = cptr + nv + 1;
    const int S = rw.S, m = ch.m, r = role.r;
    const bool split = role.split, upper = role.upper, lower = role.lower;
    const int v0 = lower ? ch.d : 0;
    const int v1 = upper && split ? ch.d : nv;
    float* xch = p.gpart;             // xch[s * half + r], s < NX
    float velj = 0.0f, aj = 0.0f, acc[CH] = {};
    if (upper || lower) {
        build_col(p, S, r, v0, v1, in, mbits, &velj, &aj);
        pull(p, cptr, cidx, S, r, max(v0, m), v1);
        if (m > 0) chain_sums(p, S, r, m, max(v0, m), v1, acc);
    }
    if (lower) {
#pragma unroll
        for (int k = 0; k < CH; ++k) xch[k * half + r] = acc[k];
        xch[CH * half + r] = velj;
        xch[(CH + 1) * half + r] = aj;
        xch[(CH + 2) * half + r] = scale_col(p, S, r, v0, v1);
    }
    __syncthreads();
    if (!upper) return;
    float dg = 0.0f;
    if (split) {
#pragma unroll
        for (int k = 0; k < CH; ++k) acc[k] += xch[k * half + r];
        velj += xch[CH * half + r];
        aj += xch[(CH + 1) * half + r];
        dg = xch[(CH + 2) * half + r];
    }
    if (m > 0) chain_resolve(p, S, r, m, nv, acc);
    *diag = dg + scale_col(p, S, r, 0, v1);
    *bvec = -in.bcoef * velj - in.kcoef * in.posr - aj;
}

// Row r's inputs to steps 4-6 into the row vectors, and the warp partials
// of sum v0^2 (red[0..8)) and sum active (red[8..16)). Every thread
// calls (row = r < R); a barrier must follow.
__device__ void row_inputs(const Smem& p, bool row, int r, float diag,
                           float bvec, float rr, float act, float v0,
                           float f0, float mu) {
    if (row) {
        p.mus[r] = mu;
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

// The wide instance's column groups 4 and 5, in shared memory only: after
// the tile is loaded, each warp packs its rows' pairs (Yd[v, l + 128],
// Yd[v, l + 160]) at the start of row v, whose first 128 columns the
// registers now hold (+1 word on odd rows, for 8-byte alignment), so a
// lane reads both with one load. Zeros past nv and R.
__device__ __forceinline__ float2* yd_pairs(const Smem& p, int v, int S) {
    return reinterpret_cast<float2*>(p.Yd + v * S + (v & 1));
}

template <int CPL>
__device__ __forceinline__ void pack_pairs(const Smem& p, int nv, int R,
                                           int S) {
    constexpr int CR = creg<CPL>();
    static_assert(CPL == CR + 2 && 2 * 32 + 1 <= 32 * CR,
                  "two groups pack into the row's registered columns");
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < DPW; ++k) {
        const int v = w * DPW + k;
        if (v >= nv) break;
        const int c0 = lane + 32 * CR, c1 = c0 + 32;
        const float2 y2 = make_float2(c0 < R ? p.Yd[v * S + c0] : 0.0f,
                                      c1 < R ? p.Yd[v * S + c1] : 0.0f);
        __syncwarp();
        yd_pairs(p, v, S)[lane] = y2;
    }
    __syncwarp();
}

// This lane's pair of the wide instance's groups 4 and 5 for dof DPW w + k.
__device__ __forceinline__ float2 yd_pair(const Smem& p, int k, int nv,
                                         int S) {
    const int v = (threadIdx.x >> 5) * DPW + k;
    return v < nv ? yd_pairs(p, v, S)[threadIdx.x & 31]
                  : make_float2(0.0f, 0.0f);
}

// The register tile of Yd from shared memory: column groups 0 .. CR - 1
// (zeros past nv and R). A barrier must precede.
template <int CPL>
__device__ __forceinline__ void load_tiles(
    const Smem& p, float (&yd)[DPW][creg<CPL>()], int nv, int R, int S) {
    constexpr int CR = creg<CPL>();
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < DPW; ++k) {
        const int v = w * DPW + k;
#pragma unroll
        for (int c = 0; c < CR; ++c) {
            const int col = lane + 32 * c;
            yd[k][c] = (v < nv && col < R) ? p.Yd[v * S + col] : 0.0f;
        }
    }
    if constexpr (CPL > CR) pack_pairs<CPL>(p, nv, R, S);
}

// One step of the butterfly reduce-scatter: lanes whose bit 2H is set
// keep slots H .. 2H - 1 (moved to 0 .. H - 1), the others slots
// 0 .. H - 1, each summed with the partner lane's copy.
template <int H, int N>
__device__ __forceinline__ void rs_step(float (&pt)[N], int lane) {
    const bool hi = lane & (2 * H);
#pragma unroll
    for (int i = 0; i < H; ++i) {
        const float send = hi ? pt[i] : pt[i + H];
        const float keep = hi ? pt[i + H] : pt[i];
        pt[i] = keep + __shfl_xor_sync(FULL, send, 2 * H);
    }
}


// Yd x for this warp's dofs, x(col) for col < R: the sum for dof
// DPW w + k lands in lanes 2k and 2k + 1 (a butterfly reduce-scatter over
// 16 slots: 8 + 4 + 2 + 1 + 1 shuffles). Column groups past CR come from
// shared memory.
template <int CPL, class X>
__device__ __forceinline__ float mv_y(const Smem& p,
                                      const float (&yd)[DPW][creg<CPL>()], X x,
                                      int nv, int R, int S) {
    constexpr int CR = creg<CPL>();
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
        for (int c = 1; c < CR; ++c) a = fmaf(yd[k][c], xv[c], a);
        if constexpr (CPL > CR) {
            const float2 y2 = yd_pair(p, k, nv, S);
            a = fmaf(y2.x, xv[CR], a);
            a = fmaf(y2.y, xv[CR + 1], a);
        }
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
// partials of Yd^T y into gpart[w][col]. The wide instance runs dof by dof
// (one y slot and CPL sums live, not 14 slots), so its tile and the
// sixth group's loads fit the registers that two blocks per SM leave.
template <int CPL>
__device__ __forceinline__ void mv_g(
    const Smem& p, const float (&yd)[DPW][creg<CPL>()], float yk, int nv,
    int R, int S) {
    constexpr int CR = creg<CPL>();
    constexpr int MR = max_r<CPL>();
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    float* ysw = p.ys + w * YW;
    if (!(lane & 1) && (lane >> 1) < DPW) ysw[lane >> 1] = yk;
    __syncwarp();
    if constexpr (CPL > CR) {
        float g[CPL];
#pragma unroll
        for (int k = 0; k < DPW; ++k) {
            const float y = ysw[k];
#pragma unroll
            for (int c = 0; c < CR; ++c)
                g[c] = k ? fmaf(yd[k][c], y, g[c]) : yd[k][c] * y;
            const float2 y2 = yd_pair(p, k, nv, S);
            g[CR] = k ? fmaf(y2.x, y, g[CR]) : y2.x * y;
            g[CR + 1] = k ? fmaf(y2.y, y, g[CR + 1]) : y2.y * y;
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c) p.gpart[w * MR + lane + 32 * c] = g[c];
        return;
    }
    float y[DPW];
    const float4* y4 = reinterpret_cast<const float4*>(ysw);
#pragma unroll
    for (int q = 0; q < DPW / 4; ++q) {
        const float4 t = y4[q];
        y[4 * q] = t.x;
        y[4 * q + 1] = t.y;
        y[4 * q + 2] = t.z;
        y[4 * q + 3] = t.w;
    }
    const float2 t2 = reinterpret_cast<const float2*>(ysw)[DPW / 2 - 1];
    y[DPW - 2] = t2.x;
    y[DPW - 1] = t2.y;
#pragma unroll
    for (int c = 0; c < CR; ++c) {
        float g = yd[0][c] * y[0];
#pragma unroll
        for (int k = 1; k < DPW; ++k) g = fmaf(yd[k][c], y[k], g);
        p.gpart[w * MR + lane + 32 * c] = g;
    }
}

// The warp partials of Yd^T Yd x into gpart, then the barrier.
template <int CPL, class X>
__device__ __forceinline__ void apply(const Smem& p,
                                      const float (&yd)[DPW][creg<CPL>()], X x,
                                      int nv, int R, int S) {
    mv_g<CPL>(p, yd, mv_y<CPL>(p, yd, x, nv, R, S), nv, R, S);
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
                                     const float (&yd)[DPW][creg<CPL>()],
                                     int nv,
                                     const Rows& rw, int B, int b,
                                     int iterations, int noslip,
                                     int power_iters, float* f_out,
                                     float* v_out) {
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int R = rw.R, kl = rw.kl, kc = rw.kc, S = rw.S;
    const bool own = t < kl + kc;
    const int nr = t < kl ? 1 : 3;
    const int rows[3] = {t, kc + t, 2 * kc + t};   // a cone's rows
    float* vred = p.red + 2 * NWARP;   // partials of sum v^2
    float* rred = p.red + 3 * NWARP;   // partials of the restart test

    // ---- cone-uniform Jacobi scaling ----
    // (the owner's s, diagonal and friction coefficient are read back from
    // shared memory where the loop needs them, not held in registers)
    if (own) {
        const float s = 1.0f / sqrtf(fmaxf(p.dsh[t], 1e-12f));
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
        const float s = p.ss[t];
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
        project(z, nr, p.mus[t], p.act, rows, false);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            if (j >= nr) break;
            p.zs[rows[j]] = z[j];
            p.dz[rows[j]] = 0.0f;
            p.xr[rows[j]] = s * z[j];
        }
    }
    part_write(vpart, vred);
    __syncthreads();
    float sv = part_sum(vred);
    for (int it = 0; it < power_iters; ++it) {
        const float nrm = sqrtf(sv) + 1e-30f;
        apply<CPL>(p, yd, [&](int c) { return p.ss[c] * (p.vs[c] / nrm); },
                   nv, R, S);
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
    // x = s (z + beta (z - z_prev)) is s z after a restart (beta 0), else
    // the owners' xc, written with the next beta of no restart
    float kk = 0.0f;
    for (int it = 0; it < iterations; ++it) {
        const float beta = kk / (kk + 3.0f);
        const float* x = kk == 0.0f ? p.xr : p.xc;
        apply<CPL>(p, yd, [&](int c) { return x[c]; }, nv, R, S);
        float rpart = 0.0f;
        if (own) {
            const float k1 = kk + 1.0f, beta1 = k1 / (k1 + 3.0f);
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
            project(z, nr, p.mus[t], p.act, rows, false);
            const float s = p.ss[t];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                if (j >= nr) break;
                rpart += g[j] * (z[j] - zo[j]);
                const float dz = z[j] - zo[j];
                p.dz[rows[j]] = dz;
                p.zs[rows[j]] = z[j];
                p.xr[rows[j]] = s * z[j];
                p.xc[rows[j]] = s * (z[j] + beta1 * dz);
            }
        }
        part_write(rpart, rred);
        __syncthreads();
        kk = part_sum(rred) > 0.0f ? 0.0f : kk + 1.0f;
    }

    // ---- 6. noslip: tangential rows only, normals frozen ----
    if (noslip > 0 && kc > 0) {
        for (int it = 0; it < 2 * noslip; ++it) {
            apply<CPL>(p, yd, [&](int c) { return p.xr[c]; }, nv, R, S);
            if (own) {
                const float s = p.ss[t];
                const float pns = 1.0f / fmaxf(p.dsh[t] * s * s, 1e-30f);
                float z[3];
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    if (j >= nr) break;
                    const int r = rows[j];
                    const float g = p.ss[r] * gsum<CPL>(p, r) - p.bs[r];
                    z[j] = r < kl + kc ? p.zs[r]
                                       : p.zs[r] - inv_l * pns * g;
                }
                project(z, nr, p.mus[t], p.act, rows, true);
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    if (j >= nr) break;
                    p.zs[rows[j]] = z[j];
                    p.xr[rows[j]] = s * z[j];
                }
            }
            __syncthreads();
        }
    }

    // ---- f = s z out, y* = Yd f ----
    const float yk = mv_y<CPL>(p, yd, [&](int c) { return p.xr[c]; }, nv, R,
                               S);
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

// This thread's row inputs for steps 1-3 (a column's thread, ColRole),
// loaded first so that their latency overlaps the env's staging.
__device__ __forceinline__ RowVals row_vals(
    const ColRole& role, const float* u6, const int* b1, const int* b2,
    const float* lim_sign, const int* lim_dadr, const float* kcoef,
    const float* bcoef, const float* posr, int B, int b) {
    if (!(role.upper || role.lower)) return RowVals{};
    return load_row(u6, b1, b2, lim_sign, lim_dadr, kcoef, bcoef, posr,
                    role.r, B, b);
}

__device__ __forceinline__ void bar_sync_128(int id) {
    asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

template <int CPL>
__global__ void __launch_bounds__(NT, 2)
solve_rows_kernel(
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
    const int* __restrict__ tab, const int* __restrict__ chn, int nv, int R,
    int B, int nM, int kl, int kc, int n_up, int ndepth, int nch, int dsplit,
    int n_chain, int iterations, int noslip, int power_iters) {
    extern __shared__ __align__(16) float sm[];
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const Rows rw{R, kl, kc, R | 1};
    const Chain ch{chn, nch, dsplit, n_chain};
    const ColRole role(R, nv, ch);
    const RowVals rv = row_vals(role, u6, b1, b2, lim_sign, lim_dadr, kcoef,
                                bcoef, posr, B, b);
    const bool row = r < R;
    const float rr = row ? rreg[r * B + b] : 0.0f;
    const float act = row ? active[r * B + b] : 0.0f;
    const float v0r = row ? v0[r * B + b] : 0.0f;
    const float f0r = row ? f0[r * B + b] : 0.0f;
    const float m = r >= kl && r < kl + kc ? mu[(r - kl) * B + b] : 0.0f;
    const int ntab = nv + 1 + n_up;
    const Smem p = carve<CPL>(sm, nv, rw.S, nM, ntab, n_up, n_chain);
    stage_env(p, ld, d6, qvel, qacc_smooth, dinv, tab, ntab, ch, nv, nM,
              n_up, B, b);
    const int* cptr = p.tab;
    const int* cidx = p.tab + nv + 1;

    // ---- 1-3. J^T column r, the rhs b[r], the up-solve ----
    float diag = 0.0f, bvec = 0.0f;
    build_upsolve(p, cptr, rw, ch, role, rv, mbits, nv, &diag, &bvec);
    row_inputs(p, row, r, diag, bvec, rr, act, v0r, f0r, m);
    __syncthreads();

    // ---- 4-6. ----
    float yd[DPW][creg<CPL>()];
    load_tiles<CPL>(p, yd, nv, R, rw.S);
    apgd<CPL>(p, yd, nv, rw, B, b, iterations, noslip, power_iters, f_out,
              v_out);

    // ---- 7. qfrc = L^T (y* D^{1/2}), dqacc = L^{-1} (y* D^{-1/2}) ----
    for (int k = r; k < nv; k += NT) {
        p.xq[k] = p.ystar[k] / p.sqm[k];
        p.qs[k] = p.ystar[k] * p.sqd[k];
    }
    __syncthreads();
    if (r < nv) {   // warps 0-3: (L^T x)[j] = x[j] + sum_i L[i, j] x[i]
        float acc = p.xq[r];
        const int q1 = cptr[r + 1];
#pragma unroll 4
        for (int q = cptr[r]; q < q1; ++q) {
            const int pk = cidx[q];
            acc += p.ld[trip_e(pk)] * p.xq[trip_i(pk)];
        }
        qfrc_out[r * B + b] = acc;
    } else if (r >= 128 && r < 256) {
        // warps 4-7, dof i = r - 128: x[i] -= L[i, a] x[a] for its ancestor
        // a at depth l, root first (push[l nv + i] = a | e << 7, -1 past
        // i's depth); a dof of depth l is final after step l - 1 and no
        // step writes it, so one barrier of the four warps a step
        const int i = r - 128;
        const int* push = tab + ntab;
        int pk = i < nv && ndepth > 0 ? __ldg(push + i) : -1;
        for (int l = 0; l < ndepth; ++l) {
            const int next = i < nv && l + 1 < ndepth
                                 ? __ldg(push + (l + 1) * nv + i) : -1;
            if (pk >= 0) p.qs[i] -= p.ld[pk >> 7] * p.qs[pk & 127];
            bar_sync_128(1);
            pk = next;
        }
        if (i < nv) dqacc_out[i * B + b] = p.qs[i];
    }
}

// Steps 1-3; writes yd (nv, R, B) and b (R, B).
template <int CPL>
__global__ void __launch_bounds__(NT) upsolve_kernel(
    const float* __restrict__ d6, const float* __restrict__ u6,
    const int* __restrict__ b1, const int* __restrict__ b2,
    const float* __restrict__ lim_sign, const int* __restrict__ lim_dadr,
    const uint4* __restrict__ mbits, const float* __restrict__ ld,
    const float* __restrict__ dinv, const float* __restrict__ qacc_smooth,
    const float* __restrict__ qvel, const float* __restrict__ kcoef,
    const float* __restrict__ bcoef, const float* __restrict__ posr,
    float* __restrict__ yd_out, float* __restrict__ b_out,
    const int* __restrict__ tab, const int* __restrict__ chn, int nv, int R,
    int B, int nM, int n_up, int nch, int dsplit, int n_chain) {
    extern __shared__ __align__(16) float sm[];
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const int S = R | 1;
    const Chain ch{chn, nch, dsplit, n_chain};
    const ColRole role(R, nv, ch);
    const RowVals rv = row_vals(role, u6, b1, b2, lim_sign, lim_dadr, kcoef,
                                bcoef, posr, B, b);
    // the head of the tables: cptr | cidx
    const Smem p = carve<CPL>(sm, nv, S, nM, nv + 1 + n_up, n_up, n_chain);
    stage_env(p, ld, d6, qvel, qacc_smooth, dinv, tab, nv + 1 + n_up, ch, nv,
              nM, n_up, B, b);
    float diag, bvec;
    build_upsolve(p, p.tab, Rows{R, 0, 0, S}, ch, role, rv, mbits, nv, &diag,
                  &bvec);
    if (r >= R) return;
    b_out[r * B + b] = bvec;
    for (int v = 0; v < nv; ++v) yd_out[(v * R + r) * B + b] = p.Yd[v * S + r];
}

// Steps 4-6 on a given Yd (nv, R, B); writes f, v (R, B) and
// ystar = Yd f (nv, B).
template <int CPL>
__global__ void __launch_bounds__(NT, 2)
apgd_kernel(
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
    const float m = r >= kl && r < kl + kc ? mu[(r - kl) * B + b] : 0.0f;
    const Smem p = carve<CPL>(sm, nv, rw.S, 0, 0, 0, 0);
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
               row ? v0[r * B + b] : 0.0f, row ? f0[r * B + b] : 0.0f, m);
    __syncthreads();
    float yd[DPW][creg<CPL>()];
    load_tiles<CPL>(p, yd, nv, R, rw.S);
    apgd<CPL>(p, yd, nv, rw, B, b, iterations, noslip, power_iters, f_out,
              v_out);
    for (int k = r; k < nv; k += NT) ystar_out[k * B + b] = p.ystar[k];
}

// upsolve_yd's block: YE envs (one 32-byte sector of a row) by YC
// columns, YP (env, column) pairs; pair p takes env p % YE and column
// p / YE of the tile, and YQ threads take each pair: thread h YP + p the
// dofs [d_h, d_{h+1}) of pack_tables' ysplit (d_0 = 0, d_YQ = nv).
constexpr int YE = 8;
constexpr int YC = 16;
constexpr int YQ = 4;
constexpr int YP = YE * YC;
constexpr int YT = YQ * YP;

// The up-sweep's pull on a pair's column x[v YP] for dofs j = hi - 1 down
// to lo, with this env's L entries ldv[q YE].
__device__ __forceinline__ void pull_pair(float* x, const float* ldv,
                                          const int* cptr, const int* cidx,
                                          int lo, int hi) {
    for (int j = hi - 1; j >= lo; --j) {
        const int q0 = cptr[j], q1 = cptr[j + 1];
        if (q0 == q1) continue;   // a leaf
        float acc = x[j * YP];
#pragma unroll 4
        for (int q = q0; q < q1; ++q)
            acc -= ldv[q * YE] * x[trip_i(cidx[q]) * YP];
        x[j * YP] = acc;
    }
}

// Steps 2-3 on a given J^T (nv, R, B): yd (nv, R, B) and b (R, B). Block
// (x, y) takes envs YE x .. YE x + YE - 1 and columns YC y .. YC y +
// YC - 1, masked past B and R. Shared memory (ops/solver_kernels.
// upsolve_yd_smem mirrors it): the pairs' columns x[v YP + p]; a region
// that holds qvel and qacc_smooth (qv[v YE + e], qa[...]) for the rhs, then
// the up-sweep's L entries ldv[q YE + e]; sqrt(dinv) sd[v YE + e]; then
// cptr | cidx. Two rounds of copies (cp.async): the columns, vectors and
// tables, then the L entries the tables name. The parts of a column pull
// at once (no dof of a part has an ancestor in an earlier part below the
// chain); the top chain's m dofs, whose descendants span them, pull after
// a barrier.
__global__ void __launch_bounds__(YT) upsolve_yd_kernel(
    const float* __restrict__ jt, const float* __restrict__ ld,
    const float* __restrict__ dinv, const float* __restrict__ qacc_smooth,
    const float* __restrict__ qvel, const float* __restrict__ kcoef,
    const float* __restrict__ bcoef, const float* __restrict__ posr,
    float* __restrict__ yd_out, float* __restrict__ b_out,
    const int* __restrict__ tab, int nv, int R, int B, int n_up, int m,
    int d1, int d2, int d3) {
    extern __shared__ __align__(16) float sm[];
    const int t = threadIdx.x, h = t / YP, pr = t % YP;
    const int e = pr % YE, c = pr / YE;
    const int b = blockIdx.x * YE + e, r = blockIdx.y * YC + c;
    const bool env = b < B, pair = env && r < R;
    float* x = sm;
    float* ldv = x + nv * YP;
    float* qv = ldv;
    float* qa = qv + nv * YE;
    float* sd = ldv + max(n_up, 2 * nv + 2 * (YQ - 1) * YC) * YE;
    int* ct = reinterpret_cast<int*>(sd + nv * YE);
    const int* cptr = ct;
    const int* cidx = ct + nv + 1;
    const size_t RB = (size_t)R * B;
    // this thread's dofs
    const int v0 = h == 0 ? 0 : h == 1 ? d1 : h == 2 ? d2 : d3;
    const int v1 = h == 0 ? d1 : h == 1 ? d2 : h == 2 ? d3 : nv;

    for (int k = t; k < nv + 1 + n_up; k += YT) cp_word(ct + k, tab + k);
    if (env && h == 0)
        for (int v = c; v < nv; v += YC) {
            cp_word(qv + v * YE + e, qvel + v * B + b);
            cp_word(qa + v * YE + e, qacc_smooth + v * B + b);
            cp_word(sd + v * YE + e, dinv + v * B + b);
        }
    if (pair) {
        const float* src = jt + (size_t)r * B + b;
        for (int v = v0; v < v1; ++v) cp_word(x + v * YP + pr, src + v * RB);
    }
    cp_wait();
    __syncthreads();
    // the rhs dots, each thread over its dofs; the other parts' sums pass
    // through the L entries' place, two slots a pair and part past qa
    float vj = 0.0f, a = 0.0f;
    if (pair)
        for (int v = v0; v < v1; ++v) {
            const float xv = x[v * YP + pr];
            vj = fmaf(xv, qv[v * YE + e], vj);
            a = fmaf(xv, qa[v * YE + e], a);
        }
    if (env && h == 0)
        for (int v = c; v < nv; v += YC)
            sd[v * YE + e] = sqrtf(sd[v * YE + e]);
    float* part = qa + nv * YE;   // 2 (YQ - 1) YP floats
    if (h > 0) {
        part[(2 * h - 2) * YP + pr] = vj;
        part[(2 * h - 1) * YP + pr] = a;
    }
    __syncthreads();
    if (h == 0)
#pragma unroll
        for (int g = 1; g < YQ; ++g) {
            vj += part[(2 * g - 2) * YP + pr];
            a += part[(2 * g - 1) * YP + pr];
        }
    __syncthreads();   // qv, qa and the sums give way to the L entries
    if (env)
        for (int q = c + YC * h; q < n_up; q += YQ * YC)
            cp_word(ldv + q * YE + e, ld + (size_t)trip_e(cidx[q]) * B + b);
    cp_wait();
    __syncthreads();
    if (pair) {
        if (h == 0)
            b_out[(size_t)r * B + b] = -bcoef[r * B + b] * vj
                                       - kcoef[r * B + b] * posr[r * B + b]
                                       - a;
        pull_pair(x + pr, ldv + e, cptr, cidx, max(v0, m), v1);
    }
    if (m > 0) {
        __syncthreads();
        if (pair && h == 0) pull_pair(x + pr, ldv + e, cptr, cidx, 0, m);
        __syncthreads();
    }
    if (!pair) return;
    float* dst = yd_out + (size_t)r * B + b;
    for (int v = v0; v < v1; ++v)
        dst[v * RB] = x[v * YP + pr] * sd[v * YE + e];
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
    float* v_out, float* qfrc_out, float* dqacc_out, const int* tab,
    const int* chn, int nv, int R, int B, int nM, int kl, int kc, int n_up,
    int ndepth, int nch, int dsplit, int n_chain, int iterations,
    int noslip, int power_iters, int smem_bytes, void* stream) {
    if (!shape_ok(nv, R, B) || !rows_ok(R, kl, kc) || nch > CH)
        return (int)cudaErrorInvalidValue;
    auto kernel = narrow(R) ? solve_rows_kernel<CPL_NARROW>
                            : solve_rows_kernel<CPL_WIDE>;
    cudaError_t e = set_smem(kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<B, NT, smem_bytes, (cudaStream_t)stream>>>(
        d6, u6, b1, b2, lim_sign, lim_dadr, static_cast<const uint4*>(mbits),
        ld, dinv, qacc_smooth, qvel, kcoef, bcoef, posr, rreg, active, mu,
        f0, v0, f_out, v_out, qfrc_out, dqacc_out, tab, chn, nv, R, B, nM,
        kl, kc, n_up, ndepth, nch, dsplit, n_chain, iterations, noslip,
        power_iters);
    return (int)cudaGetLastError();
}

// upsolve_build_yd. tab: the packed tables; chn: the top chain's.
extern "C" int upsolve_launch(
    const float* d6, const float* u6, const int* b1, const int* b2,
    const float* lim_sign, const int* lim_dadr, const void* mbits,
    const float* ld, const float* dinv, const float* qacc_smooth,
    const float* qvel, const float* kcoef, const float* bcoef,
    const float* posr, float* yd_out, float* b_out, const int* tab,
    const int* chn, int nv, int R, int B, int nM, int n_up, int nch,
    int dsplit, int n_chain, int smem_bytes, void* stream) {
    if (!shape_ok(nv, R, B) || nch > CH) return (int)cudaErrorInvalidValue;
    auto kernel = narrow(R) ? upsolve_kernel<CPL_NARROW>
                            : upsolve_kernel<CPL_WIDE>;
    cudaError_t e = set_smem(kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<B, NT, smem_bytes, (cudaStream_t)stream>>>(
        d6, u6, b1, b2, lim_sign, lim_dadr, static_cast<const uint4*>(mbits),
        ld, dinv, qacc_smooth, qvel, kcoef, bcoef, posr, yd_out, b_out, tab,
        chn, nv, R, B, nM, n_up, nch, dsplit, n_chain);
    return (int)cudaGetLastError();
}

// upsolve_yd: a grid of ceil(B / YE) env tiles by ceil(R / YC) column
// tiles. tab: the packed tables (their cptr | cidx head is read).
extern "C" int upsolve_yd_launch(
    const float* jt, const float* ld, const float* dinv,
    const float* qacc_smooth, const float* qvel, const float* kcoef,
    const float* bcoef, const float* posr, float* yd_out, float* b_out,
    const int* tab, int nv, int R, int B, int n_up, int nch, int d1, int d2,
    int d3, int smem_bytes, void* stream) {
    if (!shape_ok(nv, R, B) || !(nch < d1 && d1 <= d2 && d2 <= d3 && d3 <= nv))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem(upsolve_yd_kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((B + YE - 1) / YE, (R + YC - 1) / YC);
    upsolve_yd_kernel<<<grid, YT, smem_bytes, (cudaStream_t)stream>>>(
        jt, ld, dinv, qacc_smooth, qvel, kcoef, bcoef, posr, yd_out, b_out,
        tab, nv, R, B, n_up, nch, d1, d2, d3);
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
// `which` (0 solve_rows, 1 upsolve_build_yd, 2 apgd_iterate in the narrow
// instance, 3-5 the same in the wide one, 6 upsolve_yd) at `threads`
// threads and `smem_bytes` of dynamic shared memory.
extern "C" int fb_kernel_info(int which, int threads, int smem_bytes,
                              int* out) {
    const void* kernels[7] = {
        (const void*)solve_rows_kernel<CPL_NARROW>,
        (const void*)upsolve_kernel<CPL_NARROW>,
        (const void*)apgd_kernel<CPL_NARROW>,
        (const void*)solve_rows_kernel<CPL_WIDE>,
        (const void*)upsolve_kernel<CPL_WIDE>,
        (const void*)apgd_kernel<CPL_WIDE>,
        (const void*)upsolve_yd_kernel};
    if (which < 0 || which > 6) return (int)cudaErrorInvalidValue;
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
