// The exact convex narrowphase, one thread per (lane, env).
//
// Replaces no TPU kernel: the JAX package's convex narrowphase
// (flybody_tpu/physics/ccd.py) is plain jnp. On the card the eager
// version (flybody_tpu_torch/physics/ccd.py::narrowphase) dispatches
// about 2,000 elementwise ops and 3x3 einsums over (lanes, B) per call,
// each its own launch, the einsums as cuBLAS gemvs; this kernel runs all
// of one lane's work in registers and writes dist, pos, u and nu once.
// Same algorithm, same order, float32 throughout:
//   minimize_support  the unconstrained PGD run with Barzilai-Borwein
//                     steps, one PGD run per flat axis on its great
//                     circle, the +-axis poles, the +-(a1 x a2) poles
//                     with their degenerate test, the candidates taken
//                     by f < bf in the eager order, two Newton polishes
//                     accepted only if better;
//   _refine_witnesses the 6 alternating projections onto the support
//                     sets;
//   manifold_nu       the manifold multiplicity.
// The constants (1e-12 and 1e-30 guards, the fixed jitter, the 0.05x /
// 20x BB clamps) and the selects are the eager ones; a select tests its
// condition as torch.where does (a comparison with NaN is false), and
// max, min and clamp propagate NaN as torch.maximum, torch.minimum and
// torch.clamp do. Lanes whose u0 has |u0|^2 <= 0.25 (or NaN) reseed from
// the centre line. Built without fast math: IEEE division and square
// root. The flat-axis flags are template parameters (4 instances); the
// PGD iterations are a runtime argument (8 on a fresh substep, 5 on an
// update substep).
//
// Layout: every input is (N, k, B) or (N, 3, 3, B), read through its own
// element strides (a broadcast dimension has stride 0), so the views the
// collision stage hands over need no copy; the outputs are contiguous.
// Thread (blockIdx.x * THREADS + threadIdx.x, blockIdx.y) takes env b and
// lane n: consecutive threads read consecutive envs.
//
// Work per thread (ops/ccd_kernel.py::narrowphase_work counts it): 2,546
// (no flat axis, 5 iterations) to 7,820 (two flat axes, 8 iterations)
// float operations, and 45 words in and out. So a class with a flat axis
// is bound by operations (67 TFLOP/s float32 outside the tensor cores),
// one without by bytes; a fly step's 44 calls take 0.29 ms at the bound.
// What bounds it in practice is one thread's chain of dependent
// operations (IEEE divisions and square roots among them) at 20 warps per
// SM. Its design against the bound: no shared memory, no synchronisation,
// no intermediate in device memory, the candidates folded into the best
// one as they come so that only one is live (88-89 registers, no spill).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int NIN = 11;          // p1 R1 ell1 seg1 r1 p2 R2 ell2 seg2 r2 u0

struct In {
    const float* p;
    int s[4];                    // element strides: lane, i, j, env
};

struct Args {
    In t[NIN];
    float* dist;                 // (N, B)
    float* pos;                  // (N, 3, B)
    float* u;                    // (N, 3, B)
    float* nu;                   // (N, B) or null
    int B, iters, refine;
};

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) {
    return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
    return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
    return {a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
// _n3: sqrt(|v|^2 + eps)
__device__ __forceinline__ float n3(V3 v) { return sqrtf(dot(v, v) + 1e-12f); }
// torch.maximum / torch.minimum / torch.clamp(min=): NaN propagates
__device__ __forceinline__ float tmax(float a, float b) {
    return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float tmin(float a, float b) {
    return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return x < lo ? lo : x;
}
__device__ __forceinline__ float sign(float x) {
    return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// R[3 i + j] = R[..., i, j, b]
struct Geom {
    V3 p;
    float R[9];
    V3 ell;
    float seg, r;
};

__device__ __forceinline__ V3 mT(const float* R, V3 u) {       // R^T u
    return {R[0] * u.x + R[3] * u.y + R[6] * u.z,
            R[1] * u.x + R[4] * u.y + R[7] * u.z,
            R[2] * u.x + R[5] * u.y + R[8] * u.z};
}
__device__ __forceinline__ V3 mv(const float* R, V3 u) {       // R u
    return {R[0] * u.x + R[1] * u.y + R[2] * u.z,
            R[3] * u.x + R[4] * u.y + R[5] * u.z,
            R[6] * u.x + R[7] * u.y + R[8] * u.z};
}
__device__ __forceinline__ V3 zaxis(const float* R) {          // R[:, 2]
    return {R[2], R[5], R[8]};
}

// support_core: the support point of Ellipsoid(ell) + Segment(seg) in the
// geom frame; the segment term is seg sign(u_z) e_z, added to every
// component as the eager broadcast does
__device__ __forceinline__ V3 support_core(V3 ul, V3 ell, float seg) {
    V3 au = ell * ul;
    float n = n3(au);
    V3 s = (ell * au) / n;
    float sg = seg * sign(ul.z);
    return {s.x + sg * 0.f, s.y + sg * 0.f, s.z + sg * 1.f};
}

struct Cand {
    V3 u;
    float f;
    V3 s1, s2;
};

// _Pair.sup and _Pair.f
__device__ __forceinline__ Cand sup(const Geom& g1, const Geom& g2, V3 u) {
    V3 s1l = support_core(mT(g1.R, u), g1.ell, g1.seg);
    V3 s2l = support_core(mT(g2.R, -u), g2.ell, g2.seg);
    Cand c;
    c.u = u;
    c.s1 = g1.p + mv(g1.R, s1l);
    c.s2 = g2.p + mv(g2.R, s2l);
    c.f = dot(u, c.s1 - c.s2);
    return c;
}

__device__ __forceinline__ void take_if_better(Cand& best, const Cand& c) {
    if (c.f < best.f) best = c;
}

template <bool AXIS>
__device__ __forceinline__ V3 project(V3 u, V3 a) {
    if (AXIS) u = u - dot(u, a) * a;
    return u / n3(u);
}

template <bool AXIS>
__device__ __forceinline__ V3 tangrad(V3 u, V3 g, V3 a) {
    V3 r = g - dot(u, g) * u;
    if (AXIS) r = r - dot(r, a) * a;
    return r;
}

// _pgd: projected gradient on S^2 (on the great circle orthogonal to a
// with AXIS), Barzilai-Borwein steps clamped to [0.05, 20] eta0, then
// one half-step polish accepted if better
template <bool AXIS>
__device__ __forceinline__ Cand pgd(const Geom& g1, const Geom& g2,
                                    float eta0, V3 u0, int iters, V3 a) {
    V3 u = project<AXIS>(u0, a);
    Cand c = sup(g1, g2, u);
    V3 r_prev = tangrad<AXIS>(u, c.s1 - c.s2, a);
    V3 u_prev = u;
    u = project<AXIS>(u - eta0 * r_prev, a);
    float eta = eta0;
    for (int it = 0; it < iters; ++it) {
        c = sup(g1, g2, u);
        V3 r = tangrad<AXIS>(u, c.s1 - c.s2, a);
        V3 du = u - u_prev;
        V3 dr = r - r_prev;
        float num = dot(du, du);
        float den = dot(du, dr);
        float eta_bb = num / (fabsf(den) > 1e-30f ? den : 1e-30f);
        eta = (den > 1e-30f && num > 0.f)
                  ? tmin(tmax(eta_bb, 0.05f * eta0), 20.f * eta0)
                  : eta;
        u_prev = u;
        r_prev = r;
        u = project<AXIS>(u - eta * r, a);
    }
    c = sup(g1, g2, u);
    V3 r = tangrad<AXIS>(u, c.s1 - c.s2, a);
    Cand d = sup(g1, g2, project<AXIS>(u - (0.5f * eta0) * r, a));
    take_if_better(c, d);
    return c;
}

struct Quad {
    float a11, a12, a22;
};

// _ell_hess_quad: (t_i^T H t_j) of the ellipsoid part's support Hessian
__device__ __forceinline__ Quad ell_hess_quad(const Geom& g, V3 u, V3 t1,
                                              V3 t2) {
    V3 ul = mT(g.R, u), t1l = mT(g.R, t1), t2l = mT(g.R, t2);
    V3 e2 = g.ell * g.ell;
    float w2 = dot(e2 * ul, ul);
    float w = sqrtf(w2 + 1e-30f);
    V3 eu = e2 * ul;
    float q1 = dot(eu, t1l), q2 = dot(eu, t2l);
    Quad h;
    h.a11 = (dot(e2 * t1l, t1l) - q1 * q1 / w2) / w;
    h.a12 = (dot(e2 * t1l, t2l) - q1 * q2 / w2) / w;
    h.a22 = (dot(e2 * t2l, t2l) - q2 * q2 / w2) / w;
    return h;
}

template <bool AX1, bool AX2>
__device__ __forceinline__ Cand minimize_support(const Geom& g1,
                                                 const Geom& g2, V3 u0,
                                                 int iters) {
    V3 c = g1.p - g2.p;
    float rad1 = tmax(tmax(g1.ell.x, g1.ell.y), g1.ell.z) + g1.seg;
    float rad2 = tmax(tmax(g2.ell.x, g2.ell.y), g2.ell.z) + g2.seg;
    float eta0 = 1.f / clamp_min(rad1 + rad2 + n3(c), 1e-9f);
    const V3 none = {0.f, 0.f, 0.f};

    Cand best = pgd<false>(g1, g2, eta0, u0, iters, none);
    const V3 a1 = zaxis(g1.R), a2 = zaxis(g2.R);
    if (AX1) {
        take_if_better(best, pgd<true>(g1, g2, eta0, u0, iters, a1));
        take_if_better(best, sup(g1, g2, a1));
        take_if_better(best, sup(g1, g2, -a1));
    }
    if (AX2) {
        take_if_better(best, pgd<true>(g1, g2, eta0, u0, iters, a2));
        take_if_better(best, sup(g1, g2, a2));
        take_if_better(best, sup(g1, g2, -a2));
    }
    if (AX1 && AX2) {
        V3 x = cross(a1, a2);
        float xnorm = n3(x);
        V3 xn = x / xnorm;
        bool degenerate = xnorm < 1e-5f;
        for (int k = 0; k < 2; ++k) {
            Cand cx = sup(g1, g2, k ? -xn : xn);
            if (degenerate) cx.f = __int_as_float(0x7f800000);   // +inf
            take_if_better(best, cx);
        }
    }

    // Riemannian Newton polish, two steps, accept-if-better
    const V3 ex = {1.f, 0.f, 0.f}, ey = {0.f, 1.f, 0.f};
    for (int k = 0; k < 2; ++k) {
        V3 bu = best.u;
        V3 t1 = cross(bu, fabsf(bu.x) < 0.5f ? ex : ey);
        t1 = t1 / n3(t1);
        V3 t2 = cross(bu, t1);
        V3 g = best.s1 - best.s2;
        float g1_ = dot(g, t1), g2_ = dot(g, t2);
        Quad qa = ell_hess_quad(g1, bu, t1, t2);
        Quad qb = ell_hess_quad(g2, bu, t1, t2);
        float h11 = qa.a11 + qb.a11 - best.f;
        float h12 = qa.a12 + qb.a12;
        float h22 = qa.a22 + qb.a22 - best.f;
        float det = h11 * h22 - h12 * h12;
        bool ok = fabsf(det) > 1e-20f;
        det = ok ? det : 1.f;
        float x1 = (-g1_ * h22 + g2_ * h12) / det;
        float x2 = (-g2_ * h11 + g1_ * h12) / det;
        float sn = sqrtf(x1 * x1 + x2 * x2) + 1e-30f;
        float sc = (sn > 0.2f ? 0.2f / sn : 1.f) * (ok ? 1.f : 0.f);
        V3 uc = bu + (x1 * sc) * t1 + (x2 * sc) * t2;
        take_if_better(best, sup(g1, g2, uc / n3(uc)));
    }
    return best;
}

// sup_set of _refine_witnesses: the direction, half-width and centre of
// the geom's support set along u_world
__device__ __forceinline__ void sup_set(const Geom& g, V3 uw, V3 s_w,
                                        V3 other, V3& dvec, float& w,
                                        V3& c) {
    const float tol = 1e-5f;
    V3 ul = mT(g.R, uw);
    float un = n3(ul);
    V3 z = zaxis(g.R);
    bool flat_z = fabsf(ul.z) < tol * un;
    float w_seg = flat_z ? g.seg : 0.f;
    bool disk = (g.ell.x > 0.f) && (g.ell.z <= 0.f) &&
                (sqrtf(ul.x * ul.x + ul.y * ul.y) < tol * un);
    float w_disk = disk ? g.ell.x : 0.f;
    V3 rd = other - s_w;
    rd = rd - dot(rd, z) * z;
    rd = rd / n3(rd);
    bool use_disk = w_disk > w_seg;
    dvec = sel(use_disk, rd, z);
    w = tmax(w_disk, w_seg);
    float ax = dot(s_w - g.p, z);
    c = sel(use_disk, g.p + ax * z, s_w - ax * z);
    c = sel(w > 0.f, c, s_w);
}

__device__ __forceinline__ V3 clamp_seg(V3 c0, V3 d, float w, V3 x) {
    float t = tmin(tmax(dot(x - c0, d), -w), w);
    return c0 + t * d;
}

// manifold_nu's per-geom features
struct Feats {
    bool flat, face, side;
    float rflat;
};

__device__ __forceinline__ Feats feats(const Geom& g, V3 a, V3 u) {
    float c = fabsf(dot(a, u));
    bool disk = (g.ell.x > 0.f) && (g.ell.z <= 0.f);
    Feats f;
    f.side = (g.seg > 0.f) && (c < 0.02f);
    f.face = disk && (c > 0.999f);
    bool rim = disk && !f.face && !f.side;
    f.flat = f.side || f.face || rim;
    f.rflat = disk ? g.ell.x : g.r;
    return f;
}

__device__ __forceinline__ float ld(const In& t, int n, int i, int j, int b) {
    return __ldg(t.p + n * t.s[0] + i * t.s[1] + j * t.s[2] + b * t.s[3]);
}

__device__ __forceinline__ V3 ld3(const In& t, int n, int b) {
    return {ld(t, n, 0, 0, b), ld(t, n, 1, 0, b), ld(t, n, 2, 0, b)};
}

__device__ __forceinline__ void load_geom(Geom& g, const In* t, int n,
                                          int b) {
    g.p = ld3(t[0], n, b);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) g.R[3 * i + j] = ld(t[1], n, i, j, b);
    g.ell = ld3(t[2], n, b);
    g.seg = ld(t[3], n, 0, 0, b);
    g.r = ld(t[4], n, 0, 0, b);
}

template <bool AX1, bool AX2>
__global__ void __launch_bounds__(THREADS)
ccd_kernel(const __grid_constant__ Args args) {
    const int b = blockIdx.x * THREADS + threadIdx.x;
    const int n = blockIdx.y;
    if (b >= args.B) return;
    Geom g1, g2;
    load_geom(g1, args.t, n, b);
    load_geom(g2, args.t + 5, n, b);

    // start pointing geom1 -> geom2; the fixed jitter breaks exactly
    // axis-aligned stationary starts; a warm start with |u0|^2 <= 0.25
    // reseeds from there
    V3 c = g1.p - g2.p;
    V3 u0 = {-c.x + 1e-7f, -c.y + 2e-7f, -c.z + 3e-7f};
    if (args.t[10].p != nullptr) {
        V3 uw = ld3(args.t[10], n, b);
        if (dot(uw, uw) > 0.25f) u0 = uw;
    }
    Cand best = minimize_support<AX1, AX2>(g1, g2, u0, args.iters);
    V3 u = best.u, s1 = best.s1, s2 = best.s2;

    if (args.refine) {
        V3 d1, d2, c1, c2;
        float w1, w2;
        sup_set(g1, u, s1, s2, d1, w1, c1);
        sup_set(g2, -u, s2, s1, d2, w2, c2);
        d1 = d1 - dot(d1, u) * u;
        d2 = d2 - dot(d2, u) * u;
        float n1 = n3(d1), n2 = n3(d2);
        w1 = n1 > 1e-9f ? w1 : 0.f;
        w2 = n2 > 1e-9f ? w2 : 0.f;
        d1 = d1 / n1;
        d2 = d2 / n2;
        V3 x1 = c1, x2 = c2;
        for (int k = 0; k < 6; ++k) {
            x1 = clamp_seg(c1, d1, w1, x2);
            x2 = clamp_seg(c2, d2, w2, x1);
        }
        s1 = x1;
        s2 = x2;
    }

    const float dist = -best.f - (g1.r + g2.r);
    V3 pos = 0.5f * ((s1 + g1.r * u) + (s2 - g2.r * u));
    const int o = n * args.B + b;
    const int o3 = 3 * n * args.B + b;
    args.dist[o] = dist;
    args.pos[o3] = pos.x;
    args.pos[o3 + args.B] = pos.y;
    args.pos[o3 + 2 * args.B] = pos.z;
    args.u[o3] = u.x;
    args.u[o3 + args.B] = u.y;
    args.u[o3 + 2 * args.B] = u.z;

    if (args.nu != nullptr) {
        V3 a1 = zaxis(g1.R), a2 = zaxis(g2.R);
        Feats f1 = feats(g1, a1, u), f2 = feats(g2, a2, u);
        bool both = f1.flat && f2.flat;
        bool any_face = f1.face || f2.face;
        float rmax = tmax(f1.flat ? f1.rflat : 0.f, f2.flat ? f2.rflat : 0.f);
        V3 cx = cross(a1, a2);
        bool parallel = dot(cx, cx) < 0.09f;
        bool wide = (f1.side && f2.side && parallel) || any_face;
        bool keep = both && (dist < 0.f) && (wide || (-dist < 0.2f * rmax));
        args.nu[o] = keep ? (any_face ? 4.f : 3.f) : 1.f;
    }
}

// the instance for the flags (ax1, ax2), which = 2 ax1 + ax2
const void* instance(int which) {
    switch (which) {
        case 0: return (const void*)ccd_kernel<false, false>;
        case 1: return (const void*)ccd_kernel<false, true>;
        case 2: return (const void*)ccd_kernel<true, false>;
        case 3: return (const void*)ccd_kernel<true, true>;
    }
    return nullptr;
}

}  // namespace

// ptrs: the NIN inputs (u0 may be null); strides: 4 per input (lane, i,
// j, env, in elements); outs: dist, pos, u, nu (nu may be null). The
// instance is 2 ax1 + ax2.
extern "C" int ccd_launch(const void* const* ptrs, const int* strides,
                          void* const* outs, int N, int B, int iters,
                          int ax1, int ax2, int refine, void* stream) {
    if (N <= 0 || B <= 0 || N > 65535 || iters < 0)
        return (int)cudaErrorInvalidValue;
    Args a;
    for (int k = 0; k < NIN; ++k) {
        a.t[k].p = (const float*)ptrs[k];
        for (int i = 0; i < 4; ++i) a.t[k].s[i] = strides[4 * k + i];
    }
    a.dist = (float*)outs[0];
    a.pos = (float*)outs[1];
    a.u = (float*)outs[2];
    a.nu = (float*)outs[3];
    a.B = B;
    a.iters = iters;
    a.refine = refine;
    void* params[] = {&a};
    cudaError_t e = cudaLaunchKernel(
        instance(2 * (ax1 != 0) + (ax2 != 0)),
        dim3((B + THREADS - 1) / THREADS, N), dim3(THREADS), params, 0,
        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// Registers per thread, static and dynamic shared memory per block,
// resident blocks per SM and local (spill) memory per thread of instance
// `which` (2 ax1 + ax2) at `threads` threads and `smem_bytes` of dynamic
// shared memory.
extern "C" int fb_kernel_info(int which, int threads, int smem_bytes,
                              int* out) {
    const void* k = instance(which);
    if (k == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, k);
    int nb = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k, threads,
                                                          smem_bytes);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = smem_bytes;
    out[3] = nb;
    out[4] = (int)a.localSizeBytes;
    out[5] = 0;
    return 0;
}

extern "C" const char* fb_cuda_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}
