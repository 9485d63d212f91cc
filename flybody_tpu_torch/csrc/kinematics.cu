// Forward kinematics (mj_kinematics), one thread per env.
//
// Replaces no TPU kernel: the JAX package's forward kinematics
// (flybody_tpu/physics/kinematics.py) is plain jnp, run level by level over
// the body tree. On the card the eager version
// (flybody_tpu_torch/physics/kinematics.py::kinematics) dispatches about 30
// small ops per level and joint slot, 3,336 launches a call on the fly and
// 7,962 on the rat (39 levels); this kernel does one call's work in one
// launch. Same arithmetic, in the same order, for each body i = 1 .. nbody-1
// (MuJoCo orders bodies so that every parent comes before its child, which
// the wrapper checks, so walking the bodies in index order needs no level
// loop and no barrier):
//   pos  = xpos[parent] + rotate(body_pos, xquat[parent])
//   quat = mult(xquat[parent], body_quat)
//   each joint of the body in slot order:
//     free   pos, quat = qpos[a .. a+3), qpos[a+3 .. a+7); anchor pos, axis z
//     other  anchor = pos + rotate(jnt_pos, quat), axis = rotate(jnt_axis,
//            quat); slide: pos += axis (q - qpos0); ball and hinge:
//            quat = mult(quat, qloc) (qloc the ball's qpos, or the hinge's
//            axis_angle(jnt_axis, q - qpos0)), pos = anchor - rotate(jnt_pos,
//            quat)
//   quat /= |quat|, once a body
//   xmat = to_mat(quat), xipos = pos + rotate(body_ipos, quat),
//   ximat = xmat body_imat
// then every geom and site: x = xpos[b] + rotate(pos, xquat[b]),
// mat = to_mat(xquat[b]) local_mat. The world body is written as the eager
// version leaves it (pos 0, quat 1). The local rotation matrices
// (body_imat, the geoms' and sites' local_mat) are the eager version's
// to_mat of the model's quaternions, computed once by the wrapper. Built
// without fast math: IEEE division and square root; nvcc may fuse a
// multiply and an add, so a float32 entry can differ from the eager
// version's in its last bits.
//
// Layout: qpos (nq, B) is read through its two element strides (a reset
// may hand over a transposed or sliced batch); every output is (n, k, B)
// or (n, 3, 3, B), contiguous, but for ximat, geom_xmat and site_xmat,
// which keep the layout the plain version's einsum gives them, (n, 3, B,
// 3) in memory, so that every stage after runs the same ops. Thread b
// takes env b, so a warp's stores are consecutive env columns (runs of
// three in the (n, 3, B, 3) outputs). The model's tables
// (ops/kinematics_kernel.py's `tables`) are two small device arrays read
// by every thread alike. A body's parent frame is read back from the
// outputs this thread has just written, or kept in registers when the
// parent is the previous body (a chain); the geoms and sites read their
// body's frame back the same way.
//
// Work per env (ops/kinematics_kernel.py::kinematics_work counts it):
// about 37,000 float operations and 3,735 words written on the fly
// (nbody 68, njnt 103, ngeom 77, nsite 15), so the kernel is bound by the
// bytes it writes: 61 MB at B = 4096 in float32, 18 us at 3.35 TB/s,
// against 2.3 us of operations at 67 TFLOP/s. Its design against the
// bound: every output word is written once and never zeroed first (no
// memset), no intermediate goes to device memory, and the stores of a
// warp are coalesced. What bounds it in practice is one thread's serial
// walk (the bodies, then the geoms and sites, each a chain of table loads,
// arithmetic and stores) with B / 128 blocks of 4 warps: about 0.2 ms a
// call at B = 4096 on an H100, some 10x its bound and still 1-2 % of a
// control step's device time. Templated on float and double.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int FREE = 0, BALL = 1, SLIDE = 2;   // mjtJoint; 3 is a hinge

__device__ __forceinline__ float sq_root(float x) { return sqrtf(x); }
__device__ __forceinline__ double sq_root(double x) { return sqrt(x); }
__device__ __forceinline__ float sine(float x) { return sinf(x); }
__device__ __forceinline__ double sine(double x) { return sin(x); }
__device__ __forceinline__ float cosine(float x) { return cosf(x); }
__device__ __forceinline__ double cosine(double x) { return cos(x); }

template <typename T>
struct V3 {
    T x, y, z;
};

template <typename T>
struct Q4 {
    T w, x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}

template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}

// bquat.rotate: t = 2 q_vec x v; v + w t + q_vec x t
template <typename T>
__device__ __forceinline__ V3<T> rotate(V3<T> v, Q4<T> q) {
    T tx = T(2) * (q.y * v.z - q.z * v.y);
    T ty = T(2) * (q.z * v.x - q.x * v.z);
    T tz = T(2) * (q.x * v.y - q.y * v.x);
    return {v.x + q.w * tx + (q.y * tz - q.z * ty),
            v.y + q.w * ty + (q.z * tx - q.x * tz),
            v.z + q.w * tz + (q.x * ty - q.y * tx)};
}

// bquat.mult: the Hamilton product u v
template <typename T>
__device__ __forceinline__ Q4<T> mult(Q4<T> u, Q4<T> v) {
    return {u.w * v.w - u.x * v.x - u.y * v.y - u.z * v.z,
            u.w * v.x + u.x * v.w + u.y * v.z - u.z * v.y,
            u.w * v.y - u.x * v.z + u.y * v.w + u.z * v.x,
            u.w * v.z + u.x * v.y - u.y * v.x + u.z * v.w};
}

// bquat.to_mat, row-major
template <typename T>
__device__ __forceinline__ void to_mat(Q4<T> q, T* R) {
    R[0] = T(1) - T(2) * (q.y * q.y + q.z * q.z);
    R[1] = T(2) * (q.x * q.y - q.w * q.z);
    R[2] = T(2) * (q.x * q.z + q.w * q.y);
    R[3] = T(2) * (q.x * q.y + q.w * q.z);
    R[4] = T(1) - T(2) * (q.x * q.x + q.z * q.z);
    R[5] = T(2) * (q.y * q.z - q.w * q.x);
    R[6] = T(2) * (q.x * q.z - q.w * q.y);
    R[7] = T(2) * (q.y * q.z + q.w * q.x);
    R[8] = T(1) - T(2) * (q.x * q.x + q.y * q.y);
}

template <typename T>
struct Args {
    const T* qpos;                       // (nq, B), strides qs, bs
    // int tables
    const int* parent;                   // (nbody,)
    const int* jntadr;                   // (nbody,)
    const int* jntnum;                   // (nbody,)
    const int* jnt_type;                 // (njnt,)
    const int* jnt_qposadr;              // (njnt,)
    const int* geom_body;                // (ngeom,)
    const int* site_body;                // (nsite,)
    // float tables
    const T* body_pos;                   // (nbody, 3)
    const T* body_quat;                  // (nbody, 4)
    const T* body_ipos;                  // (nbody, 3)
    const T* body_imat;                  // (nbody, 9)
    const T* jnt_pos;                    // (njnt, 3)
    const T* jnt_axis;                   // (njnt, 3)
    const T* qpos0;                      // (nq,)
    const T* geom_pos;                   // (ngeom, 3)
    const T* geom_mat;                   // (ngeom, 9)
    const T* site_pos;                   // (nsite, 3)
    const T* site_mat;                   // (nsite, 9)
    // outputs
    T* xpos;                             // (nbody, 3, B)
    T* xquat;                            // (nbody, 4, B)
    T* xmat;                             // (nbody, 3, 3, B)
    T* xipos;                            // (nbody, 3, B)
    T* ximat;                            // (nbody, 3, 3, B)
    T* xanchor;                          // (njnt, 3, B)
    T* xaxis;                            // (njnt, 3, B)
    T* geom_xpos;                        // (ngeom, 3, B)
    T* geom_xmat;                        // (ngeom, 3, 3, B)
    T* site_xpos;                        // (nsite, 3, B)
    T* site_xmat;                        // (nsite, 3, 3, B)
    long long qs, bs;                    // qpos's element strides
    int nbody, njnt, ngeom, nsite, B;
};

// table entries, the same for every thread, through the read-only cache
template <typename T>
__device__ __forceinline__ V3<T> tab3(const T* t, int i) {
    return {__ldg(t + 3 * i), __ldg(t + 3 * i + 1), __ldg(t + 3 * i + 2)};
}

// entry i of an (n, 3, B) output, env b
template <typename T>
__device__ __forceinline__ V3<T> load3(const T* a, int i, int b, int B) {
    const T* p = a + (size_t)(3 * i) * B + b;
    return {p[0], p[B], p[2 * B]};
}

template <typename T>
__device__ __forceinline__ Q4<T> load4(const T* a, int i, int b, int B) {
    const T* p = a + (size_t)(4 * i) * B + b;
    return {p[0], p[B], p[2 * B], p[3 * B]};
}

template <typename T>
__device__ __forceinline__ void store3(T* a, int i, int b, int B, V3<T> v) {
    T* p = a + (size_t)(3 * i) * B + b;
    p[0] = v.x;
    p[B] = v.y;
    p[2 * B] = v.z;
}

template <typename T>
__device__ __forceinline__ void store9(T* a, int i, int b, int B,
                                       const T* R) {
    T* p = a + (size_t)(9 * i) * B + b;
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k * B] = R[k];
}

// entry i of an (n, 3, 3, B) output laid out as (n, 3, B, 3) in memory
template <typename T>
__device__ __forceinline__ void store9t(T* a, int i, int b, int B,
                                        const T* R) {
    T* p = a + (size_t)(9 * i) * B + 3 * b;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) p[(size_t)(3 * r) * B + c] = R[3 * r + c];
}

// bquat.matmat for one 3x3 pair, row-major: out = A L
template <typename T>
__device__ __forceinline__ void matmat(const T* A, const T* L, T* out) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            out[3 * i + j] = A[3 * i] * L[j] + A[3 * i + 1] * L[3 + j]
                             + A[3 * i + 2] * L[6 + j];
}

// x = xpos + rotate(lpos, xquat), mat = to_mat(xquat) L, stored at entry i
template <typename T>
__device__ __forceinline__ void place(V3<T> pos, Q4<T> quat, V3<T> lpos,
                                      const T* L, T* x, T* mat, int i, int b,
                                      int B) {
    store3(x, i, b, B, add(pos, rotate(lpos, quat)));
    T R[9], Lr[9], out[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Lr[k] = __ldg(L + k);
    to_mat(quat, R);
    matmat(R, Lr, out);
    store9t(mat, i, b, B, out);
}

// every output of body i from its frame (pos, quat)
template <typename T>
__device__ __forceinline__ void write_body(const Args<T>& a, int i, int b,
                                           V3<T> pos, Q4<T> quat) {
    const int B = a.B;
    store3(a.xpos, i, b, B, pos);
    T* p = a.xquat + (size_t)(4 * i) * B + b;
    p[0] = quat.w;
    p[B] = quat.x;
    p[2 * B] = quat.y;
    p[3 * B] = quat.z;
    T R[9], out[9];
    to_mat(quat, R);
    store9(a.xmat, i, b, B, R);
    store3(a.xipos, i, b, B, add(pos, rotate(tab3(a.body_ipos, i), quat)));
    T L[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) L[k] = __ldg(a.body_imat + 9 * i + k);
    matmat(R, L, out);
    store9t(a.ximat, i, b, B, out);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) kin_kernel(const Args<T> a) {
    const int b = blockIdx.x * THREADS + threadIdx.x;
    const int B = a.B;
    if (b >= B) return;
    const T* qpos = a.qpos + b * a.bs;
    const long long qs = a.qs;

    V3<T> pos = {T(0), T(0), T(0)};
    Q4<T> quat = {T(1), T(0), T(0), T(0)};
    write_body(a, 0, b, pos, quat);

    for (int i = 1; i < a.nbody; ++i) {
        // the parent's frame: body i - 1's is still in (pos, quat)
        const int p = __ldg(a.parent + i);
        if (p != i - 1) {
            pos = load3(a.xpos, p, b, B);
            quat = load4(a.xquat, p, b, B);
        }
        const T* bq = a.body_quat + 4 * i;
        pos = add(pos, rotate(tab3(a.body_pos, i), quat));
        quat = mult(quat, Q4<T>{__ldg(bq), __ldg(bq + 1), __ldg(bq + 2),
                                 __ldg(bq + 3)});

        const int j0 = __ldg(a.jntadr + i), nj = __ldg(a.jntnum + i);
        for (int j = j0; j < j0 + nj; ++j) {
            const int type = __ldg(a.jnt_type + j);
            const int qa = __ldg(a.jnt_qposadr + j);
            V3<T> anchor, axis;
            if (type == FREE) {
                pos = {qpos[qa * qs], qpos[(qa + 1) * qs],
                       qpos[(qa + 2) * qs]};
                quat = {qpos[(qa + 3) * qs],
                        qpos[(qa + 4) * qs],
                        qpos[(qa + 5) * qs],
                        qpos[(qa + 6) * qs]};
                anchor = pos;
                axis = {T(0), T(0), T(1)};
            } else {
                const V3<T> jpos = tab3(a.jnt_pos, j);
                const V3<T> jaxis = tab3(a.jnt_axis, j);
                anchor = add(pos, rotate(jpos, quat));
                axis = rotate(jaxis, quat);
                if (type == SLIDE) {
                    const T delta =
                        qpos[qa * qs] - __ldg(a.qpos0 + qa);
                    pos = add(pos, V3<T>{axis.x * delta, axis.y * delta,
                                         axis.z * delta});
                } else {
                    Q4<T> qloc;
                    if (type == BALL) {
                        qloc = {qpos[qa * qs],
                                qpos[(qa + 1) * qs],
                                qpos[(qa + 2) * qs],
                                qpos[(qa + 3) * qs]};
                    } else {
                        const T half = T(0.5) * (qpos[qa * qs]
                                                 - __ldg(a.qpos0 + qa));
                        const T s = sine(half);
                        qloc = {cosine(half), jaxis.x * s, jaxis.y * s,
                                jaxis.z * s};
                    }
                    quat = mult(quat, qloc);
                    pos = sub(anchor, rotate(jpos, quat));
                }
            }
            store3(a.xanchor, j, b, B, anchor);
            store3(a.xaxis, j, b, B, axis);
        }

        const T n = sq_root(quat.w * quat.w + quat.x * quat.x
                            + quat.y * quat.y + quat.z * quat.z);
        quat = {quat.w / n, quat.x / n, quat.y / n, quat.z / n};
        write_body(a, i, b, pos, quat);
    }

    for (int g = 0; g < a.ngeom; ++g) {
        const int k = __ldg(a.geom_body + g);
        place(load3(a.xpos, k, b, B), load4(a.xquat, k, b, B),
              tab3(a.geom_pos, g), a.geom_mat + 9 * g, a.geom_xpos,
              a.geom_xmat, g, b, B);
    }
    for (int s = 0; s < a.nsite; ++s) {
        const int k = __ldg(a.site_body + s);
        place(load3(a.xpos, k, b, B), load4(a.xquat, k, b, B),
              tab3(a.site_pos, s), a.site_mat + 9 * s, a.site_xpos,
              a.site_xmat, s, b, B);
    }
}

// the instance for `which`: 0 float, 1 double
const void* instance(int which) {
    switch (which) {
        case 0: return (const void*)kin_kernel<float>;
        case 1: return (const void*)kin_kernel<double>;
    }
    return nullptr;
}

template <typename T>
int launch(const void* qpos, long long qs, long long bs, const int* itab,
           const void* ftab, void* const* outs, int nbody, int njnt,
           int ngeom, int nsite, int nq, int B, void* stream) {
    Args<T> a;
    a.qpos = (const T*)qpos;
    a.qs = qs;
    a.bs = bs;
    a.parent = itab;
    a.jntadr = a.parent + nbody;
    a.jntnum = a.jntadr + nbody;
    a.jnt_type = a.jntnum + nbody;
    a.jnt_qposadr = a.jnt_type + njnt;
    a.geom_body = a.jnt_qposadr + njnt;
    a.site_body = a.geom_body + ngeom;
    const T* f = (const T*)ftab;
    a.body_pos = f;
    a.body_quat = a.body_pos + 3 * nbody;
    a.body_ipos = a.body_quat + 4 * nbody;
    a.body_imat = a.body_ipos + 3 * nbody;
    a.jnt_pos = a.body_imat + 9 * nbody;
    a.jnt_axis = a.jnt_pos + 3 * njnt;
    a.qpos0 = a.jnt_axis + 3 * njnt;
    a.geom_pos = a.qpos0 + nq;
    a.geom_mat = a.geom_pos + 3 * ngeom;
    a.site_pos = a.geom_mat + 9 * ngeom;
    a.site_mat = a.site_pos + 3 * nsite;
    T** o[] = {&a.xpos, &a.xquat, &a.xmat, &a.xipos, &a.ximat, &a.xanchor,
               &a.xaxis, &a.geom_xpos, &a.geom_xmat, &a.site_xpos,
               &a.site_xmat};
    for (int k = 0; k < 11; ++k) *o[k] = (T*)outs[k];
    a.nbody = nbody;
    a.njnt = njnt;
    a.ngeom = ngeom;
    a.nsite = nsite;
    a.B = B;
    void* params[] = {&a};
    cudaError_t e = cudaLaunchKernel(
        (const void*)kin_kernel<T>, dim3((B + THREADS - 1) / THREADS),
        dim3(THREADS), params, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// which: 0 float, 1 double. qpos: (nq, B) with element strides qs, bs.
// itab: parent, jntadr, jntnum (nbody each),
// jnt_type, jnt_qposadr (njnt each), geom_body (ngeom), site_body (nsite);
// ftab: body_pos, body_quat, body_ipos, body_imat, jnt_pos, jnt_axis,
// qpos0, geom_pos, geom_mat, site_pos, site_mat (row-major, in that
// order); outs: xpos, xquat, xmat, xipos, ximat, xanchor, xaxis,
// geom_xpos, geom_xmat, site_xpos, site_xmat (ximat, geom_xmat and
// site_xmat laid out (n, 3, B, 3), the others contiguous). All device
// pointers.
extern "C" int kin_launch(int which, const void* qpos, long long qs,
                          long long bs, const int* itab, const void* ftab,
                          void* const* outs, int nbody, int njnt, int ngeom,
                          int nsite, int nq, int B, void* stream) {
    if (nbody <= 0 || njnt < 0 || ngeom < 0 || nsite < 0 || nq < 0 ||
        B <= 0 || qs < 0 || bs < 0)
        return (int)cudaErrorInvalidValue;
    if (which == 0)
        return launch<float>(qpos, qs, bs, itab, ftab, outs, nbody, njnt,
                             ngeom, nsite, nq, B, stream);
    if (which == 1)
        return launch<double>(qpos, qs, bs, itab, ftab, outs, nbody, njnt,
                              ngeom, nsite, nq, B, stream);
    return (int)cudaErrorInvalidValue;
}

// Registers per thread, static and dynamic shared memory per block,
// resident blocks per SM and local (spill) memory per thread of instance
// `which` (0 float, 1 double) at `threads` threads.
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
