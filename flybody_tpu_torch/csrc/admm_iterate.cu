// Over-relaxed ADMM iterations on the dense scaled dual, one thread block
// per env.
//
// Replaces flybody_tpu/ops/admm_kernel.py::admm_iterate (the Pallas kernel
// _kernel). Same math, in the same order, for `iterations` steps:
//   rhs = bf16(b + rho (z - u))          rounded to nearest even
//   f   = W rhs                          bf16 x bf16 products, f32 sums
//   fr  = alpha f + (1 - alpha) z
//   z   = proj(fr + u)                   nonneg rows | cones | the rest
//   u   = u + fr - z
// with z0 projected first and u0 = 0. Every step outside the matvec is
// written with the round-to-nearest intrinsics, so nvcc fuses no
// multiply-add there and each operation rounds once, as the plain
// version's separate PyTorch ops do; the matvec's fmaf adds an exact
// product (bf16 x bf16 fits in float32) in the order s = 0, 1, ...,
// which the plain version follows. W = (A_s + rho I)^-1 arrives in
// bf16, env-major (B, rows, rows): the wrapper casts it once, as the JAX
// wrapper does. Cone rows are interleaved per cone, [fn, ft1, ft2] x kc
// (not the segment-major layout of solve_rows); rows past kl + 3 kc are
// not projected but are multiplied by the active mask like every row.
//
// Work per env: 2 rows^2 FLOP per iteration, 20 iterations: 2.04 MFLOP at
// rows = 226, 8.4 GFLOP at B=4096, 0.125 ms at 67 TFLOP/s (float32 FMA on
// bf16 operands, no tensor cores). Bytes: W read once, 102 kB per env in
// bf16 (418 MB at B=4096, 0.125 ms at 3.35 TB/s), 837 MB as the float32
// W the wrapper is given. So the kernel is at the balance point of the
// two bounds and the wrapper, with its cast of W, is bound by bytes.
//
// Design, first version: the env's W lives in shared memory for all
// iterations (rows x ceil(rows/2) words, an odd word stride so that the 32
// threads of a warp, one per row, read 32 different banks when they walk
// their rows in step: 102 kB at rows = 226, two blocks per SM). Thread r
// owns row r: it forms its rhs entry, dots its row of W with the rhs
// (shared, read as a broadcast) and projects; a cone's three threads meet
// through shared memory. Each W element is one shared-memory word per two
// FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Projection of row r's value zc (nonneg | interleaved cones | pass
// through), times the active mask. Uses shared `zsh`; ends the caller's
// use of zsh with a barrier before reading.
__device__ float project(float zc, float act, const float* mu, int B, int b,
                         float* zsh, int rows, int kl, int kc, int r) {
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
        const float m = mu[c * B + b];
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

__global__ void admm_kernel(
    const __nv_bfloat16* __restrict__ W, const float* __restrict__ bvec,
    const float* __restrict__ z0, const float* __restrict__ mu,
    const float* __restrict__ active, float* __restrict__ z_out, int rows,
    int B, int kl, int kc, int iterations, float rho, float alpha,
    float one_minus_alpha, int sw) {
    extern __shared__ float sm[];
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const int T = blockDim.x;
    __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(sm);  // rows x 2 sw
    float* rhs = sm + rows * sw;                                // rows
    float* zsh = rhs + rows;                                    // rows

    const __nv_bfloat16* Wb = W + (size_t)b * rows * rows;
    for (int k = r; k < rows * rows; k += T) {
        const int i = k / rows, s = k - i * rows;
        Ws[i * 2 * sw + s] = Wb[k];
    }
    const bool row = r < rows;
    const float act = row ? active[r * B + b] : 0.0f;
    const float br = row ? bvec[r * B + b] : 0.0f;
    float z = project(row ? z0[r * B + b] : 0.0f, act, mu, B, b, zsh, rows,
                      kl, kc, r);
    float u = 0.0f;
    const __nv_bfloat162* wrow =
        reinterpret_cast<const __nv_bfloat162*>(Ws + r * 2 * sw);
    const int npair = rows >> 1;
    for (int it = 0; it < iterations; ++it) {
        if (row)
            rhs[r] = __bfloat162float(__float2bfloat16_rn(
                __fadd_rn(br, __fmul_rn(rho, __fsub_rn(z, u)))));
        __syncthreads();
        float f = 0.0f;
        if (row) {
            for (int q = 0; q < npair; ++q) {
                const float2 w = __bfloat1622float2(wrow[q]);
                f = fmaf(w.x, rhs[2 * q], f);
                f = fmaf(w.y, rhs[2 * q + 1], f);
            }
            if (rows & 1)
                f = fmaf(__bfloat162float(Ws[r * 2 * sw + rows - 1]),
                         rhs[rows - 1], f);
        }
        const float fr =
            __fadd_rn(__fmul_rn(alpha, f), __fmul_rn(one_minus_alpha, z));
        const float zn =
            project(__fadd_rn(fr, u), act, mu, B, b, zsh, rows, kl, kc, r);
        u = __fsub_rn(__fadd_rn(u, fr), zn);
        z = zn;
    }
    if (row) z_out[r * B + b] = z;
}

}  // namespace

// W (B, rows, rows) bf16 env-major; b, z0, active (rows, B), mu (kc, B)
// float32 batch-minor; z_out (rows, B). sw = the odd word stride of a row
// of W in shared memory.
extern "C" int admm_launch(const void* W, const float* b, const float* z0,
                           const float* mu, const float* active, float* z_out,
                           int rows, int B, int kl, int kc, int iterations,
                           float rho, float alpha, float one_minus_alpha,
                           int sw, int smem_bytes, void* stream) {
    const int threads = ((rows + 31) / 32) * 32;
    if (threads > 1024 || rows <= 0 || B <= 0 || 2 * sw < rows ||
        kl + 3 * kc > rows)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
    admm_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(W), b, z0, mu, active, z_out, rows,
        B, kl, kc, iterations, rho, alpha, one_minus_alpha, sw);
    return (int)cudaGetLastError();
}

extern "C" const char* fb_cuda_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
