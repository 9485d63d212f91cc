// The fused dual contact solve, one thread block per env.
//
// Replaces flybody_tpu/ops/solver_kernels.py::solve_rows (the Pallas
// kernel _solve_rows_kernel). Same math, in the same order:
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
// wrapper makes no env-major copies.
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
// 0.023 ms, so the work is bound by float32 arithmetic.
//
// Design against that bound, first version: Yd (nv x R floats, ~63 kB)
// lives in dynamic shared memory for the whole solve and never touches
// device memory; three blocks fit on one SM. Thread r owns column r of
// Yd, so the J build, the rhs, the up-sweep and the Yd^T y half of each
// matvec are race-free and conflict-free; the Yd x half runs one thread
// per dof over an odd row stride (R | 1) so those reads do not collide on
// shared-memory banks. Every Yd element is one shared-memory load per
// FMA, so the matvecs are bound by shared-memory bandwidth (32 words per
// clock per SM), about 4x under the FMA rate: a register-tiled matvec is
// the next step, in a later change.

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
    Rows rw{R, kl, kc, R | 1};
    const int S = rw.S;

    float* Yd = sm;                  // nv * S
    float* ldS = Yd + nv * S;        // nM
    float* d6S = ldS + nM;           // nv * 6
    float* qvS = d6S + nv * 6;       // nv
    float* qsS = qvS + nv;           // nv
    float* dvS = qsS + nv;           // nv
    float* yS = dvS + nv;            // nv
    float* xin = yS + nv;            // T
    float* zsh = xin + T;            // T
    float* dsh = zsh + T;            // T
    float* red = dsh + T;            // 64

    for (int e = r; e < nM; e += T) ldS[e] = ld[e * B + b];
    for (int k = r; k < nv * 6; k += T) d6S[k] = d6[k * B + b];
    for (int v = r; v < nv; v += T) {
        qvS[v] = qvel[v * B + b];
        qsS[v] = qacc_smooth[v * B + b];
        dvS[v] = dinv[v * B + b];
    }
    __syncthreads();

    const bool row = r < R;
    float act = 0.0f, rr = 0.0f, bvec = 0.0f;
    if (row) {
        // ---- 1-2. J^T column r and the rhs b[r] ----
        float u[6];
        for (int c = 0; c < 6; ++c) u[c] = u6[(r * 6 + c) * B + b];
        const float* m1 = maskd + b1[r * B + b] * nv;
        const float* m2 = maskd + b2[r * B + b] * nv;
        const float ls = lim_sign[r * B + b];
        const int la = lim_dadr[r * B + b];
        float velj = 0.0f, aj = 0.0f;
        for (int v = 0; v < nv; ++v) {
            const float* dv = d6S + v * 6;
            float dots = 0.0f;
            for (int c = 0; c < 6; ++c) dots += dv[c] * u[c];
            float x = dots * (__ldg(m2 + v) - __ldg(m1 + v));
            if (v == la) x += ls;
            Yd[v * S + r] = x;
            velj += x * qvS[v];
            aj += x * qsS[v];
        }
        bvec = -bcoef[r * B + b] * velj - kcoef[r * B + b] * posr[r * B + b]
               - aj;
        // ---- 3. up-solve on column r, then the D^{-1/2} scaling ----
        for (int t = 0; t < n_up; ++t) {
            const int i = __ldg(up + 3 * t), e = __ldg(up + 3 * t + 1),
                      j = __ldg(up + 3 * t + 2);
            Yd[j * S + r] -= ldS[e] * Yd[i * S + r];
        }
        float diag = 0.0f;
        for (int v = 0; v < nv; ++v) {
            const float y = Yd[v * S + r] * sqrtf(dvS[v]);
            Yd[v * S + r] = y;
            diag += y * y;
        }
        act = active[r * B + b];
        rr = rreg[r * B + b];
        dsh[r] = diag + rr;
    }
    __syncthreads();

    // ---- cone-uniform Jacobi scaling ----
    float s = 0.0f, bs = 0.0f, s2r = 0.0f, dcone = 0.0f;
    if (row) {
        dcone = r < kl ? dsh[r] : dsh[kl + (r - kl) % kc];
        s = 1.0f / sqrtf(fmaxf(dcone, 1e-12f));
        bs = s * bvec;
        s2r = s * s * rr;
    }

    // ---- 4. warm power iteration ----
    const float v0r = row ? v0[r * B + b] : 0.0f;
    const float nrm0 = sqrtf(block_sum(v0r * v0r, red)) + 1e-30f;
    const float asum = block_sum(act, red);
    float v = (v0r / nrm0 + act / sqrtf(fmaxf(asum, 1.0f))) * act;
    float L = 1.0f;
    for (int p = 0; p < power_iters; ++p) {
        const float nrm = sqrtf(block_sum(v * v, red)) + 1e-30f;
        const float vn = v / nrm;
        v = (mv_sas(Yd, xin, yS, nv, rw, r, s, vn) + s2r * vn) * act;
        L = sqrtf(block_sum(v * v, red)) + 1e-30f;
    }
    const float inv_l = 1.0f / fmaxf(1.5f * L, 1.0f);
    const float vout = v / sqrtf(block_sum(v * v, red) + 1e-30f);

    // ---- 5. APGD with restart ----
    float z = project(row ? f0[r * B + b] / fmaxf(s, 1e-30f) : 0.0f, act, mu,
                      B, b, zsh, rw, r, false);
    float zp = z;
    float kk = 0.0f;
    for (int it = 0; it < iterations; ++it) {
        const float beta = kk / (kk + 3.0f);
        const float y = z + beta * (z - zp);
        const float g = mv_sas(Yd, xin, yS, nv, rw, r, s, y) + s2r * y - bs;
        const float zn = project(y - inv_l * g, act, mu, B, b, zsh, rw, r,
                                 false);
        const bool restart = block_sum(row ? g * (zn - z) : 0.0f, red) > 0.0f;
        kk = restart ? 0.0f : kk + 1.0f;
        zp = z;
        z = zn;
    }

    // ---- 6. noslip: tangential rows only, normals frozen ----
    if (noslip > 0 && kc > 0) {
        const float pns = 1.0f / fmaxf(dcone * s * s, 1e-30f);
        for (int it = 0; it < 2 * noslip; ++it) {
            const float g = mv_sas(Yd, xin, yS, nv, rw, r, s, z) - bs;
            const float zc = r < kl + kc ? z : z - inv_l * pns * g;
            z = project(zc, act, mu, B, b, zsh, rw, r, true);
        }
    }

    // ---- 7. outputs ----
    const float f = s * z;
    if (row) {
        xin[r] = f;
        f_out[r * B + b] = f;
        v_out[r * B + b] = vout;
    }
    __syncthreads();
    mv_y(Yd, xin, yS, nv, rw);          // y* = Yd f, ends with a barrier
    // qfrc = L^T (y* D^{1/2}) on warp 0, dqacc = L^{-1} (y* D^{-1/2}) on
    // warp 1: both sweeps are sequential over their triplet lists
    if (r == 0) {
        for (int k = 0; k < nv; ++k)
            qvS[k] = yS[k] / sqrtf(fmaxf(dvS[k], 1e-30f));
        for (int t = 0; t < n_up; ++t) {
            const int i = __ldg(up + 3 * t), e = __ldg(up + 3 * t + 1),
                      j = __ldg(up + 3 * t + 2);
            qvS[j] += ldS[e] * (yS[i] / sqrtf(fmaxf(dvS[i], 1e-30f)));
        }
    }
    if (r == (T > 32 ? 32 : 0)) {
        for (int k = 0; k < nv; ++k) qsS[k] = yS[k] * sqrtf(dvS[k]);
        for (int t = 0; t < n_down; ++t) {
            const int i = __ldg(down + 3 * t), e = __ldg(down + 3 * t + 1),
                      j = __ldg(down + 3 * t + 2);
            qsS[i] -= ldS[e] * qsS[j];
        }
    }
    __syncthreads();
    for (int k = r; k < nv; k += T) {
        qfrc_out[k * B + b] = qvS[k];
        dqacc_out[k * B + b] = qsS[k];
    }
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
    const int big = nv > R ? nv : R;
    const int threads = ((big + 31) / 32) * 32;
    if (threads > 1024 || kc <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        solve_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
    solve_rows_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
        d6, u6, b1, b2, lim_sign, lim_dadr, maskd, ld, dinv, qacc_smooth,
        qvel, kcoef, bcoef, posr, rreg, active, mu, f0, v0, f_out, v_out,
        qfrc_out, dqacc_out, up, down, nv, R, B, nbody, nM, kl, kc, n_up,
        n_down, iterations, noslip, power_iters);
    return (int)cudaGetLastError();
}

extern "C" const char* fb_cuda_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
