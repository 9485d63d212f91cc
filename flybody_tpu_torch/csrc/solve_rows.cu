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
// Same math, in the same order:
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
// Layout. Inputs arrive batch-minor (env axis last, as the engine keeps
// them), so one env's values sit B apart and are read strided: about
// 4.7k words per env in ~4.7k 32-byte sectors, ~0.6 GB of sector traffic
// at B=4096 (~0.2 ms at 3.35 TB/s) against 77 MB of useful bytes. The
// wrappers make no env-major copies. The stage kernels move Yd (nv, R, B)
// through device memory the same way: 16k strided words per env, one
// sector each (~2 GB of sectors at B=4096, ~0.6 ms at peak bandwidth,
// against 261 MB of useful bytes, 0.08 ms).
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
//
// Design against that bound, first version: Yd (nv x R floats, ~63 kB)
// lives in dynamic shared memory for the whole solve; three blocks fit on
// one SM. Thread r owns column r of Yd, so the J build, the rhs, the
// up-sweep and the Yd^T y half of each matvec are race-free and
// conflict-free; the Yd x half runs one thread per dof over an odd row
// stride (R | 1) so those reads do not collide on shared-memory banks.
// Every Yd element is one shared-memory load per FMA, so the matvecs are
// bound by shared-memory bandwidth (32 words per clock per SM), about 4x
// under the FMA rate: a register-tiled matvec is the next step, in a
// later change.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    return x;
}

// Sum of x over the block; every thread gets the total. `red` holds 33
// floats. The leading barrier keeps a previous call's readers of red[32]
// ahead of this call's writers.
__device__ float block_sum(float x, float* red) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    x = warp_sum(x);
    __syncthreads();
    if (lane == 0) red[w] = x;
    __syncthreads();
    if (w == 0) {
        const int nw = blockDim.x >> 5;
        float s = lane < nw ? red[lane] : 0.0f;
        s = warp_sum(s);
        if (lane == 0) red[32] = s;
    }
    __syncthreads();
    return red[32];
}

struct Rows {
    int R, kl, kc, S;
};

// The block's dynamic shared memory, the same carve-up for every kernel
// here (ops/solver_kernels.smem_bytes mirrors it): Yd with an odd row
// stride, ld, d6 (6 nv), four dof vectors, three row vectors and the
// reduction scratch.
struct Smem {
    float *Yd, *ld, *d6, *qv, *qs, *dv, *y, *xin, *zsh, *dsh, *red;
};

__device__ Smem carve(float* sm, int nv, int S, int nM, int T) {
    Smem p;
    p.Yd = sm;                       // nv * S
    p.ld = p.Yd + nv * S;            // nM
    p.d6 = p.ld + nM;                // nv * 6
    p.qv = p.d6 + nv * 6;            // nv
    p.qs = p.qv + nv;                // nv
    p.dv = p.qs + nv;                // nv
    p.y = p.dv + nv;                 // nv
    p.xin = p.y + nv;                // T
    p.zsh = p.xin + T;               // T
    p.dsh = p.zsh + T;               // T
    p.red = p.dsh + T;               // 64
    return p;
}

// Stage env b's factor and dof vectors into shared memory (d6 may be
// null). Ends with a barrier.
__device__ void stage_env(const Smem& p, const float* ld, const float* d6,
                          const float* qvel, const float* qacc_smooth,
                          const float* dinv, int nv, int nM, int B, int b) {
    const int r = threadIdx.x, T = blockDim.x;
    for (int e = r; e < nM; e += T) p.ld[e] = ld[e * B + b];
    if (d6 != nullptr)
        for (int k = r; k < nv * 6; k += T) p.d6[k] = d6[k * B + b];
    for (int v = r; v < nv; v += T) {
        p.qv[v] = qvel[v * B + b];
        p.qs[v] = qacc_smooth[v * B + b];
        p.dv[v] = dinv[v * B + b];
    }
    __syncthreads();
}

// Step 1: column r of J^T into column r of Yd.
__device__ void build_col(const Smem& p, int S, int r, int nv,
                          const float* u6, const int* b1, const int* b2,
                          const float* lim_sign, const int* lim_dadr,
                          const float* maskd, int B, int b) {
    float u[6];
    for (int c = 0; c < 6; ++c) u[c] = u6[(r * 6 + c) * B + b];
    const float* m1 = maskd + b1[r * B + b] * nv;
    const float* m2 = maskd + b2[r * B + b] * nv;
    const float ls = lim_sign[r * B + b];
    const int la = lim_dadr[r * B + b];
    for (int v = 0; v < nv; ++v) {
        const float* dv = p.d6 + v * 6;
        float dots = 0.0f;
        for (int c = 0; c < 6; ++c) dots += dv[c] * u[c];
        float x = dots * (__ldg(m2 + v) - __ldg(m1 + v));
        if (v == la) x += ls;
        p.Yd[v * S + r] = x;
    }
}

// Steps 2-3 on column r of Yd, which holds column r of J^T: returns the
// rhs b[r]; Yd's column becomes D^{-1/2} L^{-T} J^T and *diag its squared
// norm (Yd^T Yd)[r, r].
__device__ float rhs_upsolve_col(const Smem& p, int S, int r, int nv,
                                 const int* up, int n_up, float kcoef,
                                 float bcoef, float posr, float* diag) {
    float velj = 0.0f, aj = 0.0f;
    for (int v = 0; v < nv; ++v) {
        const float x = p.Yd[v * S + r];
        velj += x * p.qv[v];
        aj += x * p.qs[v];
    }
    const float bvec = -bcoef * velj - kcoef * posr - aj;
    for (int t = 0; t < n_up; ++t) {
        const int i = __ldg(up + 3 * t), e = __ldg(up + 3 * t + 1),
                  j = __ldg(up + 3 * t + 2);
        p.Yd[j * S + r] -= p.ld[e] * p.Yd[i * S + r];
    }
    float dg = 0.0f;
    for (int v = 0; v < nv; ++v) {
        const float y = p.Yd[v * S + r] * sqrtf(p.dv[v]);
        p.Yd[v * S + r] = y;
        dg += y * y;
    }
    *diag = dg;
    return bvec;
}

// y = Yd x (thread per dof); x in shared `xin`, result in shared `y`.
// Callers write xin and barrier first.
__device__ void mv_y(const float* Yd, const float* xin, float* y, int nv,
                     const Rows& rw) {
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
        const float* row = Yd + v * rw.S;
        float acc = 0.0f;
        for (int r = 0; r < rw.R; ++r) acc += row[r] * xin[r];
        y[v] = acc;
    }
    __syncthreads();
}

// (Yd^T y)[r] for this thread's row r (column r of Yd).
__device__ float col_dot(const float* Yd, const float* y, int nv, int S,
                         int r) {
    float acc = 0.0f;
    for (int v = 0; v < nv; ++v) acc += Yd[v * S + r] * y[v];
    return acc;
}

// s * (Yd^T Yd) (s * z) for this thread's row; all threads must call.
__device__ float mv_sas(const float* Yd, float* xin, float* y, int nv,
                        const Rows& rw, int r, float s, float z) {
    if (r < rw.R) xin[r] = s * z;
    __syncthreads();
    mv_y(Yd, xin, y, nv, rw);
    return r < rw.R ? s * col_dot(Yd, y, nv, rw.S, r) : 0.0f;
}

// Projection of the row vector held one value per thread (zc) onto the
// nonneg orthant x elliptic cones, times the active mask. With
// tangent_only the head rows pass through and the normal rows are the
// frozen normals already in zc (noslip). Uses shared `zsh`.
__device__ float project(float zc, float act, const float* mu, int B, int b,
                         float* zsh, const Rows& rw, int r,
                         bool tangent_only) {
    if (r < rw.R) zsh[r] = zc;
    __syncthreads();
    float out = 0.0f;
    if (r < rw.kl) {
        out = tangent_only ? zc : fmaxf(zc, 0.0f);
    } else if (r < rw.R) {
        const int c = (r - rw.kl) % rw.kc;
        const int seg = (r - rw.kl) / rw.kc;
        const float fn = zsh[rw.kl + c];
        const float t1 = zsh[rw.kl + rw.kc + c];
        const float t2 = zsh[rw.kl + 2 * rw.kc + c];
        const float m = mu[c * B + b];
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
        out = seg == 0 ? fn_new : (seg == 1 ? t1 * sc : t2 * sc);
    }
    return out * act;
}

struct Forces {
    float f, v;     // this thread's row of f = s z and of the power vector
};

// Steps 4-6 on Yd in shared memory (_apgd_math). p.dsh[r] holds
// diag(Yd^T Yd)[r] + rreg[r] for every row, written before a barrier.
// bvec, act, rr, v0r, f0r are this thread's row values (0 past R).
__device__ Forces apgd(const Smem& p, int nv, const Rows& rw, int r,
                       float bvec, float act, float rr, float v0r, float f0r,
                       const float* mu, int B, int b, int iterations,
                       int noslip, int power_iters) {
    const bool row = r < rw.R;
    const int kl = rw.kl, kc = rw.kc;
    // ---- cone-uniform Jacobi scaling ----
    float s = 0.0f, bs = 0.0f, s2r = 0.0f, dcone = 0.0f;
    if (row) {
        dcone = r < kl ? p.dsh[r] : p.dsh[kl + (r - kl) % kc];
        s = 1.0f / sqrtf(fmaxf(dcone, 1e-12f));
        bs = s * bvec;
        s2r = s * s * rr;
    }

    // ---- 4. warm power iteration ----
    const float nrm0 = sqrtf(block_sum(v0r * v0r, p.red)) + 1e-30f;
    const float asum = block_sum(act, p.red);
    float v = (v0r / nrm0 + act / sqrtf(fmaxf(asum, 1.0f))) * act;
    float L = 1.0f;
    for (int it = 0; it < power_iters; ++it) {
        const float nrm = sqrtf(block_sum(v * v, p.red)) + 1e-30f;
        const float vn = v / nrm;
        v = (mv_sas(p.Yd, p.xin, p.y, nv, rw, r, s, vn) + s2r * vn) * act;
        L = sqrtf(block_sum(v * v, p.red)) + 1e-30f;
    }
    const float inv_l = 1.0f / fmaxf(1.5f * L, 1.0f);
    const float vout = v / sqrtf(block_sum(v * v, p.red) + 1e-30f);

    // ---- 5. APGD with restart ----
    float z = project(row ? f0r / fmaxf(s, 1e-30f) : 0.0f, act, mu, B, b,
                      p.zsh, rw, r, false);
    float zp = z;
    float kk = 0.0f;
    for (int it = 0; it < iterations; ++it) {
        const float beta = kk / (kk + 3.0f);
        const float y = z + beta * (z - zp);
        const float g = mv_sas(p.Yd, p.xin, p.y, nv, rw, r, s, y) + s2r * y
                        - bs;
        const float zn = project(y - inv_l * g, act, mu, B, b, p.zsh, rw, r,
                                 false);
        const bool restart = block_sum(row ? g * (zn - z) : 0.0f, p.red)
                             > 0.0f;
        kk = restart ? 0.0f : kk + 1.0f;
        zp = z;
        z = zn;
    }

    // ---- 6. noslip: tangential rows only, normals frozen ----
    if (noslip > 0 && kc > 0) {
        const float pns = 1.0f / fmaxf(dcone * s * s, 1e-30f);
        for (int it = 0; it < 2 * noslip; ++it) {
            const float g = mv_sas(p.Yd, p.xin, p.y, nv, rw, r, s, z) - bs;
            const float zc = r < kl + kc ? z : z - inv_l * pns * g;
            z = project(zc, act, mu, B, b, p.zsh, rw, r, true);
        }
    }
    return Forces{s * z, vout};
}

// f, v out and y* = Yd f into shared p.y (ends with a barrier).
__device__ void forces_out(const Smem& p, int nv, const Rows& rw, int r,
                           Forces fv, float* f_out, float* v_out, int B,
                           int b) {
    if (r < rw.R) {
        p.xin[r] = fv.f;
        f_out[r * B + b] = fv.f;
        v_out[r * B + b] = fv.v;
    }
    __syncthreads();
    mv_y(p.Yd, p.xin, p.y, nv, rw);
}

__global__ void solve_rows_kernel(
    const float* __restrict__ d6, const float* __restrict__ u6,
    const int* __restrict__ b1, const int* __restrict__ b2,
    const float* __restrict__ lim_sign, const int* __restrict__ lim_dadr,
    const float* __restrict__ maskd, const float* __restrict__ ld,
    const float* __restrict__ dinv, const float* __restrict__ qacc_smooth,
    const float* __restrict__ qvel, const float* __restrict__ kcoef,
    const float* __restrict__ bcoef, const float* __restrict__ posr,
    const float* __restrict__ rreg, const float* __restrict__ active,
    const float* __restrict__ mu, const float* __restrict__ f0,
    const float* __restrict__ v0,
    float* __restrict__ f_out, float* __restrict__ v_out,
    float* __restrict__ qfrc_out, float* __restrict__ dqacc_out,
    const int* __restrict__ up, const int* __restrict__ down,
    int nv, int R, int B, int nbody, int nM, int kl, int kc, int n_up,
    int n_down, int iterations, int noslip, int power_iters) {
    extern __shared__ float sm[];
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const int T = blockDim.x;
    const Rows rw{R, kl, kc, R | 1};
    const Smem p = carve(sm, nv, rw.S, nM, T);
    stage_env(p, ld, d6, qvel, qacc_smooth, dinv, nv, nM, B, b);

    const bool row = r < R;
    float act = 0.0f, rr = 0.0f, bvec = 0.0f;
    if (row) {
        // ---- 1-3. J^T column r, the rhs b[r], the up-solve ----
        build_col(p, rw.S, r, nv, u6, b1, b2, lim_sign, lim_dadr, maskd, B,
                  b);
        float diag;
        bvec = rhs_upsolve_col(p, rw.S, r, nv, up, n_up, kcoef[r * B + b],
                               bcoef[r * B + b], posr[r * B + b], &diag);
        act = active[r * B + b];
        rr = rreg[r * B + b];
        p.dsh[r] = diag + rr;
    }
    __syncthreads();

    // ---- 4-6. ----
    const Forces fv = apgd(p, nv, rw, r, bvec, act, rr,
                           row ? v0[r * B + b] : 0.0f,
                           row ? f0[r * B + b] : 0.0f, mu, B, b, iterations,
                           noslip, power_iters);

    // ---- 7. outputs ----
    forces_out(p, nv, rw, r, fv, f_out, v_out, B, b);   // y* in p.y
    // qfrc = L^T (y* D^{1/2}) on warp 0, dqacc = L^{-1} (y* D^{-1/2}) on
    // warp 1: both sweeps are sequential over their triplet lists
    if (r == 0) {
        for (int k = 0; k < nv; ++k)
            p.qv[k] = p.y[k] / sqrtf(fmaxf(p.dv[k], 1e-30f));
        for (int t = 0; t < n_up; ++t) {
            const int i = __ldg(up + 3 * t), e = __ldg(up + 3 * t + 1),
                      j = __ldg(up + 3 * t + 2);
            p.qv[j] += p.ld[e] * (p.y[i] / sqrtf(fmaxf(p.dv[i], 1e-30f)));
        }
    }
    if (r == (T > 32 ? 32 : 0)) {
        for (int k = 0; k < nv; ++k) p.qs[k] = p.y[k] * sqrtf(p.dv[k]);
        for (int t = 0; t < n_down; ++t) {
            const int i = __ldg(down + 3 * t), e = __ldg(down + 3 * t + 1),
                      j = __ldg(down + 3 * t + 2);
            p.qs[i] -= p.ld[e] * p.qs[j];
        }
    }
    __syncthreads();
    for (int k = r; k < nv; k += T) {
        qfrc_out[k * B + b] = p.qv[k];
        dqacc_out[k * B + b] = p.qs[k];
    }
}

// Steps 1-3 (build = 1) or 2-3 on jt (build = 0); writes yd (nv, R, B) and
// b (R, B).
__global__ void upsolve_kernel(
    int build, const float* __restrict__ jt, const float* __restrict__ d6,
    const float* __restrict__ u6, const int* __restrict__ b1,
    const int* __restrict__ b2, const float* __restrict__ lim_sign,
    const int* __restrict__ lim_dadr, const float* __restrict__ maskd,
    const float* __restrict__ ld, const float* __restrict__ dinv,
    const float* __restrict__ qacc_smooth, const float* __restrict__ qvel,
    const float* __restrict__ kcoef, const float* __restrict__ bcoef,
    const float* __restrict__ posr, float* __restrict__ yd_out,
    float* __restrict__ b_out, const int* __restrict__ up, int nv, int R,
    int B, int nM, int n_up) {
    extern __shared__ float sm[];
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const int S = R | 1;
    const Smem p = carve(sm, nv, S, nM, blockDim.x);
    stage_env(p, ld, build ? d6 : nullptr, qvel, qacc_smooth, dinv, nv, nM,
              B, b);
    if (r >= R) return;
    if (build) {
        build_col(p, S, r, nv, u6, b1, b2, lim_sign, lim_dadr, maskd, B, b);
    } else {
        for (int v = 0; v < nv; ++v)
            p.Yd[v * S + r] = jt[(v * R + r) * B + b];
    }
    float diag;
    b_out[r * B + b] = rhs_upsolve_col(p, S, r, nv, up, n_up,
                                       kcoef[r * B + b], bcoef[r * B + b],
                                       posr[r * B + b], &diag);
    for (int v = 0; v < nv; ++v) yd_out[(v * R + r) * B + b] = p.Yd[v * S + r];
}

// Steps 4-6 on a given Yd (nv, R, B); writes f, v (R, B) and
// ystar = Yd f (nv, B).
__global__ void apgd_kernel(
    const float* __restrict__ yd, const float* __restrict__ bvec_in,
    const float* __restrict__ rreg, const float* __restrict__ active,
    const float* __restrict__ mu, const float* __restrict__ f0,
    const float* __restrict__ v0, float* __restrict__ f_out,
    float* __restrict__ ystar_out, float* __restrict__ v_out, int nv,
    int R, int B, int kl, int kc, int iterations, int noslip,
    int power_iters) {
    extern __shared__ float sm[];
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const int T = blockDim.x;
    const Rows rw{R, kl, kc, R | 1};
    const Smem p = carve(sm, nv, rw.S, 0, T);
    for (int k = r; k < nv * R; k += T) {   // neighbours read neighbours
        const int v = k / R, c = k - v * R;
        p.Yd[v * rw.S + c] = yd[k * B + b];
    }
    __syncthreads();
    const bool row = r < R;
    float act = 0.0f, rr = 0.0f, bvec = 0.0f;
    if (row) {
        float diag = 0.0f;
        for (int v = 0; v < nv; ++v) {
            const float y = p.Yd[v * rw.S + r];
            diag += y * y;
        }
        act = active[r * B + b];
        rr = rreg[r * B + b];
        bvec = bvec_in[r * B + b];
        p.dsh[r] = diag + rr;
    }
    __syncthreads();
    const Forces fv = apgd(p, nv, rw, r, bvec, act, rr,
                           row ? v0[r * B + b] : 0.0f,
                           row ? f0[r * B + b] : 0.0f, mu, B, b, iterations,
                           noslip, power_iters);
    forces_out(p, nv, rw, r, fv, f_out, v_out, B, b);
    for (int k = r; k < nv; k += T) ystar_out[k * B + b] = p.y[k];
}

int block_threads(int nv, int R) {
    const int big = nv > R ? nv : R;
    return ((big + 31) / 32) * 32;
}

template <typename K>
cudaError_t set_smem(K kernel, int smem_bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

}  // namespace

extern "C" int solve_rows_launch(
    const float* d6, const float* u6, const int* b1, const int* b2,
    const float* lim_sign, const int* lim_dadr, const float* maskd,
    const float* ld, const float* dinv, const float* qacc_smooth,
    const float* qvel, const float* kcoef, const float* bcoef,
    const float* posr, const float* rreg, const float* active,
    const float* mu, const float* f0, const float* v0, float* f_out,
    float* v_out, float* qfrc_out, float* dqacc_out, const int* up,
    const int* down, int nv, int R, int B, int nbody, int nM, int kl, int kc,
    int n_up, int n_down, int iterations, int noslip, int power_iters,
    int smem_bytes, void* stream) {
    const int threads = block_threads(nv, R);
    if (threads > 1024 || kc <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem(solve_rows_kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    solve_rows_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
        d6, u6, b1, b2, lim_sign, lim_dadr, maskd, ld, dinv, qacc_smooth,
        qvel, kcoef, bcoef, posr, rreg, active, mu, f0, v0, f_out, v_out,
        qfrc_out, dqacc_out, up, down, nv, R, B, nbody, nM, kl, kc, n_up,
        n_down, iterations, noslip, power_iters);
    return (int)cudaGetLastError();
}

// upsolve_build_yd (build = 1: jt unused) and upsolve_yd (build = 0: the
// compact-row inputs unused, may be null).
extern "C" int upsolve_launch(
    int build, const float* jt, const float* d6, const float* u6,
    const int* b1, const int* b2, const float* lim_sign, const int* lim_dadr,
    const float* maskd, const float* ld, const float* dinv,
    const float* qacc_smooth, const float* qvel, const float* kcoef,
    const float* bcoef, const float* posr, float* yd_out, float* b_out,
    const int* up, int nv, int R, int B, int nM, int n_up, int smem_bytes,
    void* stream) {
    const int threads = block_threads(nv, R);
    if (threads > 1024 || R <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem(upsolve_kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    upsolve_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
        build, jt, d6, u6, b1, b2, lim_sign, lim_dadr, maskd, ld, dinv,
        qacc_smooth, qvel, kcoef, bcoef, posr, yd_out, b_out, up, nv, R, B,
        nM, n_up);
    return (int)cudaGetLastError();
}

extern "C" int apgd_launch(
    const float* yd, const float* b, const float* rreg, const float* active,
    const float* mu, const float* f0, const float* v0, float* f_out,
    float* ystar_out, float* v_out, int nv, int R, int B, int kl, int kc,
    int iterations, int noslip, int power_iters, int smem_bytes,
    void* stream) {
    const int threads = block_threads(nv, R);
    if (threads > 1024 || kc <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = set_smem(apgd_kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    apgd_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
        yd, b, rreg, active, mu, f0, v0, f_out, ystar_out, v_out, nv, R, B,
        kl, kc, iterations, noslip, power_iters);
    return (int)cudaGetLastError();
}

extern "C" const char* fb_cuda_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
