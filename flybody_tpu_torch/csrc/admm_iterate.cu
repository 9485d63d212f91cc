// Over-relaxed ADMM iterations on the dense scaled dual, one thread block
// per env.
//
// Replaces flybody_tpu/ops/admm_kernel.py::admm_iterate (the Pallas kernel
// _kernel). Same math, in the same order, for `iterations` steps:
//   rhs = bf16(b + rho (z - u))          rounded to nearest even
//   f   = W rhs                          bf16 x bf16 products, f32 sums
//                                        in four interleaved accumulators
//   fr  = alpha f + (1 - alpha) z
//   z   = proj(fr + u)                   nonneg rows | cones | the rest
//   u   = u + fr - z
// with z0 projected first and u0 = 0. Every step outside the matvec is
// written with the round-to-nearest intrinsics, so nvcc fuses no
// multiply-add there and each operation rounds once, as the plain
// version's separate PyTorch ops do; the matvec's fmaf adds an exact
// product (bf16 x bf16 fits in float32) to accumulator s % 4 in the order
// s = 0, 1, ..., and f = (a0 + a1) + (a2 + a3), which the plain version
// follows (four chains of 57 FMAs in place of one of 226).
// W = (A_s + rho I)^-1 arrives in float32 as solver_dense.inverse_operator
// lays it out: (rows, rows, B) whose permute(2, 0, 1) is contiguous, so
// env b's W is rows x rows contiguous floats. The kernel rounds it to bf16
// itself (__float2bfloat16_rn, round to nearest even as torch's cast), so
// W crosses device memory once. Cone rows are interleaved per cone,
// [fn, ft1, ft2] x kc (not the segment-major layout of solve_rows); rows
// past kl + 3 kc are not projected but are multiplied by the active mask
// like every row.
//
// Work per env: 2 rows^2 FLOP per iteration, 20 iterations: 2.04 MFLOP at
// rows = 226, 8.4 GFLOP at B=4096, 0.125 ms at 67 TFLOP/s (float32 FMA on
// bf16 operands, no tensor cores). Bytes: the float32 W read once, 204 kB
// per env (837 MB at B=4096, 0.25 ms at 3.35 TB/s). So the kernel is bound
// by bytes.
//
// Design. The env's W is read with 16-byte streaming loads, four in flight
// per thread (two rows are a whole number of float4s when rows is even;
// otherwise 4-byte loads), rounded and stored as bf16 pairs into shared
// memory, where it stays for all iterations: rows x cw 16-byte chunks,
// cw = ceil(rows / 8) made odd, so that the 8 threads of each
// quarter-warp, one per row, hit 8 different chunk columns when they walk
// their rows in step (conflict-free 16-byte loads). 105 kB at rows = 226,
// two blocks per SM. Thread r owns row r and also takes the row's first
// 80 columns into registers, unpacked to float32 once: it forms its rhs
// entry, dots its row of W with the rhs, 8 weights per register chunk or
// 16-byte shared load (unpacked per product) against two 16-byte
// broadcasts of the rhs, in a chunk loop unrolled to the 256-row maximum
// so that the shared loads can be issued early, and projects; a cone's
// three threads meet through shared memory. Two barriers per iteration.
// What bounds it now: the read of W from device memory (~0.30 ms of the
// call at B=4096, near 837 MB at 3.35 TB/s) and, in the iterations, the
// latency of the two barriers and of the projection with only 16 warps
// per SM (shared memory holds two envs' W), more than the FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_ROWS = 256;   // one thread per row, two blocks per SM
constexpr int NREG = 10;   // chunks of a row of W (8 columns each) held in
                           // registers as float32: 80 words, columns 0 .. 79

// Projection of row r's value zc (nonneg | interleaved cones | pass
// through), times the active mask; m is the friction of row r's cone.
// Uses shared `zsh`; ends the caller's use of zsh with a barrier before
// reading.
__device__ float project(float zc, float act, float m, float* zsh, int rows,
                         int kl, int kc, int r) {
    if (r < rows) zsh[r] = zc;
    __syncthreads();
    float out = zc;
    if (r < kl) {
        out = fmaxf(zc, 0.0f);
    } else if (r < kl + 3 * kc) {
        const int c = (r - kl) / 3;
        const int j = (r - kl) - 3 * c;
        const float fn = zsh[kl + 3 * c];
        const float t1 = zsh[kl + 3 * c + 1];
        const float t2 = zsh[kl + 3 * c + 2];
        const float t = __fadd_rn(
            __fsqrt_rn(__fadd_rn(__fmul_rn(t1, t1), __fmul_rn(t2, t2))),
            1e-20f);
        const bool inside = t <= __fmul_rn(m, fn);
        const bool zero = __fmul_rn(m, t) <= -fn;
        const float fn_m = __fdiv_rn(__fadd_rn(fn, __fmul_rn(m, t)),
                                     __fadd_rn(1.0f, __fmul_rn(m, m)));
        const float sc =
            inside ? 1.0f : (zero ? 0.0f : __fdiv_rn(__fmul_rn(m, fn_m), t));
        const float fn_new = inside ? fn : (zero ? 0.0f : fn_m);
        out = j == 0 ? fn_new
                     : (j == 1 ? __fmul_rn(t1, sc) : __fmul_rn(t2, sc));
    }
    return __fmul_rn(out, act);
}

// Two float32 values of row i, columns s and s + 1 (s even), into shared
// memory as one bf16 pair.
__device__ __forceinline__ void put2(__nv_bfloat16* Ws, int cw, int i, int s,
                                     float a, float c) {
    *reinterpret_cast<__nv_bfloat162*>(Ws + i * 8 * cw + s) =
        __floats2bfloat162_rn(a, c);
}

// float4 number q of a pair of rows (hr float4s each pair) into shared
// memory as bf16.
__device__ __forceinline__ void put4(__nv_bfloat16* Ws, int cw, int rows,
                                     int hr, int q, float4 x) {
    const int pr = q / hr;
    int o = 4 * (q - pr * hr);   // offset in the pair of rows
    put2(Ws, cw, 2 * pr + (o >= rows), o >= rows ? o - rows : o, x.x, x.y);
    o += 2;
    put2(Ws, cw, 2 * pr + (o >= rows), o >= rows ? o - rows : o, x.z, x.w);
}

// The low and high bf16 of a 32-bit word, as float32 (exact).
__device__ __forceinline__ float lo(unsigned u) {
    return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi(unsigned u) {
    return __uint_as_float(u & 0xffff0000u);
}

__global__ void __launch_bounds__(MAX_ROWS, 2) admm_kernel(
    const float* __restrict__ W, const float* __restrict__ bvec,
    const float* __restrict__ z0, const float* __restrict__ mu,
    const float* __restrict__ active, float* __restrict__ z_out, int rows,
    int B, int kl, int kc, int iterations, float rho, float alpha,
    float one_minus_alpha, int cw, int vec) {
    extern __shared__ __align__(16) unsigned char smraw[];
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const int T = blockDim.x;
    // rows x cw 16-byte chunks of bf16, then the rhs (8 cw floats, 16-byte
    // aligned) and the projection's row vector
    __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smraw);
    float* rhs = reinterpret_cast<float*>(smraw + (size_t)rows * cw * 16);
    float* zsh = rhs + 8 * cw;

    const float* Wb = W + (size_t)b * rows * rows;
    if (vec) {   // rows even, Wb 16-byte aligned: two rows = rows/2 float4s
        const float4* W4 = reinterpret_cast<const float4*>(Wb);
        const int hr = rows >> 1, nq = rows * hr >> 1;
        int q = r;
        for (; q + 3 * T < nq; q += 4 * T) {
            float4 x[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) x[k] = __ldcs(W4 + q + k * T);
#pragma unroll
            for (int k = 0; k < 4; ++k)
                put4(Ws, cw, rows, hr, q + k * T, x[k]);
        }
        for (; q < nq; q += T) put4(Ws, cw, rows, hr, q, __ldcs(W4 + q));
    } else {
        for (int k = r; k < rows * rows; k += T) {
            const int i = k / rows, s = k - i * rows;
            Ws[i * 8 * cw + s] = __float2bfloat16_rn(__ldcs(Wb + k));
        }
    }
    const bool row = r < rows;
    const bool cone = r >= kl && r < kl + 3 * kc;
    const float act = row ? active[r * B + b] : 0.0f;
    const float br = row ? bvec[r * B + b] : 0.0f;
    const float m = cone ? mu[((r - kl) / 3) * B + b] : 0.0f;
    float z = project(row ? z0[r * B + b] : 0.0f, act, m, zsh, rows, kl, kc,
                      r);
    float u = 0.0f;
    const uint4* wr = reinterpret_cast<const uint4*>(Ws + r * 8 * cw);
    const float4* rh = reinterpret_cast<const float4*>(rhs);
    const int nfull = rows >> 3;
    float wf[NREG][8];   // after project's barrier: W is staged
#pragma unroll
    for (int q = 0; q < NREG; ++q) {
        const uint4 w =
            row && q < nfull ? wr[q] : make_uint4(0u, 0u, 0u, 0u);
        wf[q][0] = lo(w.x);
        wf[q][1] = hi(w.x);
        wf[q][2] = lo(w.y);
        wf[q][3] = hi(w.y);
        wf[q][4] = lo(w.z);
        wf[q][5] = hi(w.z);
        wf[q][6] = lo(w.w);
        wf[q][7] = hi(w.w);
    }
    for (int it = 0; it < iterations; ++it) {
        if (row)
            rhs[r] = __bfloat162float(__float2bfloat16_rn(
                __fadd_rn(br, __fmul_rn(rho, __fsub_rn(z, u)))));
        __syncthreads();
        float f = 0.0f;
        if (row) {
            // product s into accumulator s % 4
            float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
            for (int q = 0; q < NREG; ++q) {
                if (q >= nfull) break;
                const float4 a = rh[2 * q], c = rh[2 * q + 1];
                a0 = fmaf(wf[q][0], a.x, a0);
                a1 = fmaf(wf[q][1], a.y, a1);
                a2 = fmaf(wf[q][2], a.z, a2);
                a3 = fmaf(wf[q][3], a.w, a3);
                a0 = fmaf(wf[q][4], c.x, a0);
                a1 = fmaf(wf[q][5], c.y, a1);
                a2 = fmaf(wf[q][6], c.z, a2);
                a3 = fmaf(wf[q][7], c.w, a3);
            }
#pragma unroll
            for (int q = NREG; q < MAX_ROWS / 8; ++q) {
                if (q >= nfull) break;
                const uint4 w = wr[q];
                const float4 a = rh[2 * q], c = rh[2 * q + 1];
                a0 = fmaf(lo(w.x), a.x, a0);
                a1 = fmaf(hi(w.x), a.y, a1);
                a2 = fmaf(lo(w.y), a.z, a2);
                a3 = fmaf(hi(w.y), a.w, a3);
                a0 = fmaf(lo(w.z), c.x, a0);
                a1 = fmaf(hi(w.z), c.y, a1);
                a2 = fmaf(lo(w.w), c.z, a2);
                a3 = fmaf(hi(w.w), c.w, a3);
            }
            for (int s = 8 * nfull; s < rows; ++s) {   // s % 4 from 0
                const float p = __bfloat162float(Ws[r * 8 * cw + s]);
                const int k = s & 3;
                if (k == 0) a0 = fmaf(p, rhs[s], a0);
                else if (k == 1) a1 = fmaf(p, rhs[s], a1);
                else if (k == 2) a2 = fmaf(p, rhs[s], a2);
                else a3 = fmaf(p, rhs[s], a3);
            }
            f = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
        }
        const float fr =
            __fadd_rn(__fmul_rn(alpha, f), __fmul_rn(one_minus_alpha, z));
        const float zn =
            project(__fadd_rn(fr, u), act, m, zsh, rows, kl, kc, r);
        u = __fsub_rn(__fadd_rn(u, fr), zn);
        z = zn;
    }
    if (row) z_out[r * B + b] = z;
}

}  // namespace

// W float32, env b's rows x rows contiguous at W + b rows^2 (the layout of
// solver_dense.inverse_operator); b, z0, active (rows, B), mu (kc, B)
// float32 batch-minor; z_out (rows, B). cw = 16-byte chunks per row of W
// in shared memory (odd, 8 cw >= rows); vec = 1 takes W with 16-byte loads
// (rows even and W 16-byte aligned).
extern "C" int admm_launch(const float* W, const float* b, const float* z0,
                           const float* mu, const float* active, float* z_out,
                           int rows, int B, int kl, int kc, int iterations,
                           float rho, float alpha, float one_minus_alpha,
                           int cw, int vec, int smem_bytes, void* stream) {
    const int threads = ((rows + 31) / 32) * 32;
    if (rows > MAX_ROWS || rows <= 0 || B <= 0 || 8 * cw < rows ||
        kl + 3 * kc > rows || (vec && (rows & 1)))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
    admm_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
        W, b, z0, mu, active, z_out, rows, B, kl, kc, iterations, rho, alpha,
        one_minus_alpha, cw, vec);
    return (int)cudaGetLastError();
}

// Registers per thread, static and dynamic shared memory per block,
// resident blocks per SM and local (spill) memory per thread of the kernel
// (`which` is 0) at `threads` threads and `smem_bytes` of dynamic shared
// memory.
extern "C" int fb_kernel_info(int which, int threads, int smem_bytes,
                              int* out) {
    if (which != 0) return (int)cudaErrorInvalidValue;
    const void* k = (const void*)admm_kernel;
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
