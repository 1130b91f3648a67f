// K4 and K5v: fused Chebyshev-Jacobi smoothing on vector fields (the
// velocity mass solves and V-cycles of the incompressible problems), plus
// the final residual r = b - A x.  K4 takes 2-D fields with two components
// per node, K5v 3-D fields with three.
//
// K4 replaces control_tpu/ops/stencil.py:_fused_cheb_vector; K5v replaces
// control_tpu/ops/stencil.py:_fused_cheb_nd3 on vector spaces (C = dim = 3
// of its coupled real form, _coupled_form_3d).  The operator is a node
// stencil with a dim x dim coupling block per offset per node:
//
//   (A x)_r(node) = sum_k sum_c w[k, node, r, c] * x[node + off_k, c]
//
// and, per batch entry i with sigma = theta_i / delta_i, the recurrence is
// that of K2 (cheb_smooth.cu) with a Jacobi diagonal per component:
//
//   step 0:   r = b - A x0;  p = (r * dinv) / theta;  x = x0 + p
//   step s:   r = b - A x;   rho' = 1 / (2 sigma - rho)
//             p = rho' rho p + (2 rho' / delta) (r * dinv);  x = x + p
//   final:    r = b - A x
//
// The TPU kernel splits the weights into four planes (w00, w01, w10, w11)
// and the fields into two component planes, because its blocks are planes.
// Here nothing is split: a field (ny, nx, 2) in row-major storage is one
// pair per node, read as one float2 / double2, and the coupling block of
// one offset at one node is four consecutive reals, read as one float4 (two
// double2).  Neighbouring threads own neighbouring nodes, so both reads
// coalesce.  The weights of offset k start k * ny * nx * 4 reals into a
// batch entry's weights.
//
// As in K2, a plane and its K weight planes do not fit a block's shared
// memory and every step reads the neighbours' previous iterate, so each
// step is one tiled launch: a thread owns one node, reads the old iterate
// from one buffer and writes the new one to the other (ping-pong); p is
// updated in place; rho is recomputed per thread from theta, delta and the
// step index.  One C entry point makes all launches.
//
// Bound on the H100: with every input read once and every output written
// once the bytes are few (the shared Q2 weight set is 6.7 MB in float32),
// so at the mass solve's shape the arithmetic (about 8 K + 16 flops a node
// a step) is the larger of the two bounds.  A call, though, streams the
// weights once per step and per batch entry (out of L2 when they are
// shared), so it runs well above that bound; on the small V-cycle levels
// the launches and the wrapper's host work dominate.  Fusing steps and a
// batch loop that keeps the weights in registers are the next steps for
// speed.
//
// The pair type here is a plain component pair, not a complex number: the
// kernel uses none of the complex helpers of field_ops.cuh.
//
// K5v (the second half of this file) is the same design on 3-D grids:
// (batch, z) on gridDim.z, a node's three components three consecutive
// reals and a 3 x 3 block nine (36 B in float32, 72 B in float64: not
// 16-byte aligned, so every value is a scalar load; neighbouring threads
// still read neighbouring blocks, so the loads coalesce).  Only the dx loop
// of the stencil is unrolled: at degree 2 a step is 125 x 9 multiply-adds a
// node, and a fully unrolled loop buys nothing but registers.  Bound: the
// TPU kernel keeps the K * 9 weight volumes resident and reads them once;
// here every step re-reads them (the 125 x 33^3 x 9 float64 set of the
// Stokes velocity level is 323 MB, above the 50 MB L2), so a call streams
// about steps x batch times the weights.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

template <typename R> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// the 2 x 2 coupling block, row-major: (w00, w01, w10, w11)
template <typename R> struct Block {
    R w00, w01, w10, w11;
};

__device__ __forceinline__ Block<float> load_block(const float* w) {
    const float4 v = *reinterpret_cast<const float4*>(w);
    return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ Block<double> load_block(const double* w) {
    const double2 a = *reinterpret_cast<const double2*>(w);
    const double2 b = *reinterpret_cast<const double2*>(w + 2);
    return {a.x, a.y, b.x, b.y};
}

// (A x)(iy, ix) for one batch entry: w points at its K = (2D+1)^2 weight
// planes of ny * nx blocks, x at its ny * nx pairs; zero outside the grid;
// offsets run (dy, dx) lexicographically over [-D, D]^2, the order of
// stencil_offsets() in ops/stencil.py.
template <int D, typename R>
__device__ __forceinline__ typename Pair<R>::type
vector_stencil_at(const R* __restrict__ w,
                  const typename Pair<R>::type* __restrict__ x, int iy,
                  int ix, int ny, int nx) {
    const size_t plane = (size_t)ny * nx;
    const size_t node = (size_t)iy * nx + ix;
    R a0 = R(0), a1 = R(0);
    int k = 0;
#pragma unroll
    for (int dy = -D; dy <= D; ++dy) {
        const int y = iy + dy;
#pragma unroll
        for (int dx = -D; dx <= D; ++dx, ++k) {
            const int xx = ix + dx;
            if (y >= 0 && y < ny && xx >= 0 && xx < nx) {
                const Block<R> c = load_block(w + (k * plane + node) * 4);
                const typename Pair<R>::type v = x[(size_t)y * nx + xx];
                a0 += c.w00 * v.x + c.w01 * v.y;
                a1 += c.w10 * v.x + c.w11 * v.y;
            }
        }
    }
    typename Pair<R>::type out;
    out.x = a0;
    out.y = a1;
    return out;
}

template <int D, typename R>
__global__ void vector_step_kernel(
    const R* __restrict__ w, long long w_bstride,
    const typename Pair<R>::type* __restrict__ dinv, long long d_bstride,
    const typename Pair<R>::type* __restrict__ b,
    const typename Pair<R>::type* __restrict__ x_old,
    typename Pair<R>::type* __restrict__ x_new,
    typename Pair<R>::type* __restrict__ p, const R* __restrict__ theta,
    const R* __restrict__ delta, int th_stride, int ny, int nx, int step) {
    using V = typename Pair<R>::type;
    const int ix = blockIdx.x * BX + threadIdx.x;
    const int iy = blockIdx.y * BY + threadIdx.y;
    if (ix >= nx || iy >= ny) return;
    const size_t bi = blockIdx.z;
    const size_t plane = (size_t)ny * nx;
    const size_t node = (size_t)iy * nx + ix;
    const size_t at = bi * plane + node;

    const V ax = vector_stencil_at<D, R>(w + bi * (size_t)w_bstride,
                                         x_old + bi * plane, iy, ix, ny, nx);
    const V bv = b[at];
    // d_bstride counts reals; dinv is indexed in pairs
    const V dv = dinv[bi * (size_t)(d_bstride / 2) + node];
    const R z0 = (bv.x - ax.x) * dv.x;
    const R z1 = (bv.y - ax.y) * dv.y;
    const R th = theta[bi * th_stride];
    const R de = delta[bi * th_stride];
    V pn;
    if (step == 0) {
        pn.x = z0 / th;
        pn.y = z1 / th;
    } else {
        const R sigma = th / de;
        R rho = R(1) / sigma;
        for (int k = 1; k < step; ++k) rho = R(1) / (R(2) * sigma - rho);
        const R rho_new = R(1) / (R(2) * sigma - rho);
        const V po = p[at];
        const R c = R(2) * rho_new / de;
        pn.x = rho_new * rho * po.x + c * z0;
        pn.y = rho_new * rho * po.y + c * z1;
    }
    p[at] = pn;
    const V xo = x_old[at];
    V xn;
    xn.x = xo.x + pn.x;
    xn.y = xo.y + pn.y;
    x_new[at] = xn;
}

template <int D, typename R>
__global__ void vector_residual_kernel(
    const R* __restrict__ w, long long w_bstride,
    const typename Pair<R>::type* __restrict__ b,
    const typename Pair<R>::type* __restrict__ x,
    typename Pair<R>::type* __restrict__ r, int ny, int nx) {
    using V = typename Pair<R>::type;
    const int ix = blockIdx.x * BX + threadIdx.x;
    const int iy = blockIdx.y * BY + threadIdx.y;
    if (ix >= nx || iy >= ny) return;
    const size_t bi = blockIdx.z;
    const size_t plane = (size_t)ny * nx;
    const size_t at = bi * plane + (size_t)iy * nx + ix;
    const V ax = vector_stencil_at<D, R>(w + bi * (size_t)w_bstride,
                                         x + bi * plane, iy, ix, ny, nx);
    const V bv = b[at];
    V out;
    out.x = bv.x - ax.x;
    out.y = bv.y - ax.y;
    r[at] = out;
}

template <int D, typename R>
int run(const R* w, long long w_bstride, const typename Pair<R>::type* dinv,
        long long d_bstride, const typename Pair<R>::type* b,
        const typename Pair<R>::type* x0, const R* theta, const R* delta,
        int th_stride, typename Pair<R>::type* x_out,
        typename Pair<R>::type* x_tmp, typename Pair<R>::type* p,
        typename Pair<R>::type* r, int n, int ny, int nx, int steps,
        cudaStream_t stream) {
    using V = typename Pair<R>::type;
    const dim3 block(BX, BY);
    const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, n);
    const int nsteps = steps < 1 ? 1 : steps;
    const V* x_in = x0;
    for (int s = 0; s < nsteps; ++s) {
        // the last step lands in x_out
        V* x_dst = ((nsteps - 1 - s) % 2 == 0) ? x_out : x_tmp;
        vector_step_kernel<D, R><<<grid, block, 0, stream>>>(
            w, w_bstride, dinv, d_bstride, b, x_in, x_dst, p, theta, delta,
            th_stride, ny, nx, s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        x_in = x_dst;
    }
    if (r != nullptr) {
        vector_residual_kernel<D, R><<<grid, block, 0, stream>>>(
            w, w_bstride, b, x_out, r, ny, nx);
    }
    return (int)cudaGetLastError();
}

template <typename R>
int dispatch(const void* w, long long w_bstride, const void* dinv,
             long long d_bstride, const void* b, const void* x0,
             const void* theta, const void* delta, int th_stride, void* x_out,
             void* x_tmp, void* p, void* r, int n, int ny, int nx, int degree,
             int steps, cudaStream_t stream) {
    using V = typename Pair<R>::type;
    // a block and a pair are read with 16- and 8- (double: 16-) byte loads
    if (n < 1 || ny < 1 || nx < 1 || n > 65535 || w_bstride % 4 != 0 ||
        d_bstride % 2 != 0 || (size_t)w % (4 * sizeof(R)) != 0)
        return (int)cudaErrorInvalidValue;
    const R* wv = static_cast<const R*>(w);
    const V* dv = static_cast<const V*>(dinv);
    const V* bv = static_cast<const V*>(b);
    const V* xv = static_cast<const V*>(x0);
    const R* th = static_cast<const R*>(theta);
    const R* de = static_cast<const R*>(delta);
    V* xo = static_cast<V*>(x_out);
    V* xt = static_cast<V*>(x_tmp);
    V* pv = static_cast<V*>(p);
    V* rv = static_cast<V*>(r);
    if (degree == 1)
        return run<1, R>(wv, w_bstride, dv, d_bstride, bv, xv, th, de,
                         th_stride, xo, xt, pv, rv, n, ny, nx, steps, stream);
    if (degree == 2)
        return run<2, R>(wv, w_bstride, dv, d_bstride, bv, xv, th, de,
                         th_stride, xo, xt, pv, rv, n, ny, nx, steps, stream);
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K5v: three components per node on 3-D grids
// ---------------------------------------------------------------------------

// (A x)(iz, iy, ix) for one batch entry into (a0, a1, a2): w points at its
// K = (2D+1)^3 weight volumes of nz * ny * nx row-major 3 x 3 blocks, x at
// its nz * ny * nx component triples; zero outside the grid; offsets run
// (dz, dy, dx) lexicographically over [-D, D]^3, the order of
// stencil_offsets() in ops/stencil.py.
template <int D, typename R>
__device__ __forceinline__ void vector3_stencil_at(
    const R* __restrict__ w, const R* __restrict__ x, int iz, int iy, int ix,
    int nz, int ny, int nx, R& a0, R& a1, R& a2) {
    constexpr int W = 2 * D + 1;
    const size_t vol = (size_t)nz * ny * nx;
    const size_t node = ((size_t)iz * ny + iy) * nx + ix;
    a0 = R(0);
    a1 = R(0);
    a2 = R(0);
#pragma unroll 1
    for (int dz = -D; dz <= D; ++dz) {
        const int z = iz + dz;
        if (z < 0 || z >= nz) continue;
#pragma unroll 1
        for (int dy = -D; dy <= D; ++dy) {
            const int y = iy + dy;
            if (y < 0 || y >= ny) continue;
            const int k0 = ((dz + D) * W + (dy + D)) * W;
            const size_t row = ((size_t)z * ny + y) * nx;
#pragma unroll
            for (int dx = -D; dx <= D; ++dx) {
                const int xx = ix + dx;
                if (xx >= 0 && xx < nx) {
                    const R* c = w + ((size_t)(k0 + dx + D) * vol + node) * 9;
                    const R* v = x + (row + xx) * 3;
                    const R v0 = v[0], v1 = v[1], v2 = v[2];
                    a0 += c[0] * v0 + c[1] * v1 + c[2] * v2;
                    a1 += c[3] * v0 + c[4] * v1 + c[5] * v2;
                    a2 += c[6] * v0 + c[7] * v1 + c[8] * v2;
                }
            }
        }
    }
}

template <int D, typename R>
__global__ void vector3_step_kernel(
    const R* __restrict__ w, long long w_bstride, const R* __restrict__ dinv,
    long long d_bstride, const R* __restrict__ b,
    const R* __restrict__ x_old, R* __restrict__ x_new, R* __restrict__ p,
    const R* __restrict__ theta, const R* __restrict__ delta, int th_stride,
    int nz, int ny, int nx, int step) {
    const int ix = blockIdx.x * BX + threadIdx.x;
    const int iy = blockIdx.y * BY + threadIdx.y;
    if (ix >= nx || iy >= ny) return;
    // (batch, z) on gridDim.z
    const int iz = (int)(blockIdx.z % nz);
    const size_t bi = blockIdx.z / nz;
    const size_t vol = (size_t)nz * ny * nx;
    const size_t node = ((size_t)iz * ny + iy) * nx + ix;
    const size_t at = (bi * vol + node) * 3;

    R a[3];
    vector3_stencil_at<D, R>(w + bi * (size_t)w_bstride, x_old + bi * vol * 3,
                             iz, iy, ix, nz, ny, nx, a[0], a[1], a[2]);
    const R* dv = dinv + bi * (size_t)d_bstride + node * 3;
    const R th = theta[bi * th_stride];
    const R de = delta[bi * th_stride];
    R keep = R(0), gain = R(0);
    if (step > 0) {
        const R sigma = th / de;
        R rho = R(1) / sigma;
        for (int k = 1; k < step; ++k) rho = R(1) / (R(2) * sigma - rho);
        const R rho_new = R(1) / (R(2) * sigma - rho);
        keep = rho_new * rho;
        gain = R(2) * rho_new / de;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const R z = (b[at + c] - a[c]) * dv[c];
        // step 0: z / theta, as the plain version divides
        const R pn = step == 0 ? z / th : keep * p[at + c] + gain * z;
        p[at + c] = pn;
        x_new[at + c] = x_old[at + c] + pn;
    }
}

template <int D, typename R>
__global__ void vector3_residual_kernel(const R* __restrict__ w,
                                        long long w_bstride,
                                        const R* __restrict__ b,
                                        const R* __restrict__ x,
                                        R* __restrict__ r, int nz, int ny,
                                        int nx) {
    const int ix = blockIdx.x * BX + threadIdx.x;
    const int iy = blockIdx.y * BY + threadIdx.y;
    if (ix >= nx || iy >= ny) return;
    const int iz = (int)(blockIdx.z % nz);
    const size_t bi = blockIdx.z / nz;
    const size_t vol = (size_t)nz * ny * nx;
    const size_t at = (bi * vol + ((size_t)iz * ny + iy) * nx + ix) * 3;
    R a0, a1, a2;
    vector3_stencil_at<D, R>(w + bi * (size_t)w_bstride, x + bi * vol * 3,
                             iz, iy, ix, nz, ny, nx, a0, a1, a2);
    r[at] = b[at] - a0;
    r[at + 1] = b[at + 1] - a1;
    r[at + 2] = b[at + 2] - a2;
}

template <int D, typename R>
int run3(const R* w, long long w_bstride, const R* dinv, long long d_bstride,
         const R* b, const R* x0, const R* theta, const R* delta,
         int th_stride, R* x_out, R* x_tmp, R* p, R* r, int n, int nz,
         int ny, int nx, int steps, cudaStream_t stream) {
    const dim3 block(BX, BY);
    const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, n * nz);
    const int nsteps = steps < 1 ? 1 : steps;
    const R* x_in = x0;
    for (int s = 0; s < nsteps; ++s) {
        // the last step lands in x_out
        R* x_dst = ((nsteps - 1 - s) % 2 == 0) ? x_out : x_tmp;
        vector3_step_kernel<D, R><<<grid, block, 0, stream>>>(
            w, w_bstride, dinv, d_bstride, b, x_in, x_dst, p, theta, delta,
            th_stride, nz, ny, nx, s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        x_in = x_dst;
    }
    if (r != nullptr) {
        vector3_residual_kernel<D, R><<<grid, block, 0, stream>>>(
            w, w_bstride, b, x_out, r, nz, ny, nx);
    }
    return (int)cudaGetLastError();
}

template <typename R>
int dispatch3(const void* w, long long w_bstride, const void* dinv,
              long long d_bstride, const void* b, const void* x0,
              const void* theta, const void* delta, int th_stride,
              void* x_out, void* x_tmp, void* p, void* r, int n, int nz,
              int ny, int nx, int degree, int steps, cudaStream_t stream) {
    if (n < 1 || nz < 1 || ny < 1 || nx < 1 || (long long)n * nz > 65535)
        return (int)cudaErrorInvalidValue;
    const R* wv = static_cast<const R*>(w);
    const R* dv = static_cast<const R*>(dinv);
    const R* bv = static_cast<const R*>(b);
    const R* xv = static_cast<const R*>(x0);
    const R* th = static_cast<const R*>(theta);
    const R* de = static_cast<const R*>(delta);
    R* xo = static_cast<R*>(x_out);
    R* xt = static_cast<R*>(x_tmp);
    R* pv = static_cast<R*>(p);
    R* rv = static_cast<R*>(r);
    if (degree == 1)
        return run3<1, R>(wv, w_bstride, dv, d_bstride, bv, xv, th, de,
                          th_stride, xo, xt, pv, rv, n, nz, ny, nx, steps,
                          stream);
    if (degree == 2)
        return run3<2, R>(wv, w_bstride, dv, d_bstride, bv, xv, th, de,
                          th_stride, xo, xt, pv, rv, n, nz, ny, nx, steps,
                          stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 float64.  Fields are (n, ny, nx, 2), weights
// (K, ny, nx, 2, 2) per batch entry; w_bstride and d_bstride count reals
// between batch entries (0: shared).  r may be null (no final residual).
// x_out, x_tmp, p are scratch the caller allocated with the shape of b; x0
// is only read.
extern "C" int cheb_smooth_vector(int dtype, const void* w,
                                  long long w_bstride, const void* dinv,
                                  long long d_bstride, const void* b,
                                  const void* x0, const void* theta,
                                  const void* delta, int th_stride,
                                  void* x_out, void* x_tmp, void* p, void* r,
                                  int n, int ny, int nx, int degree,
                                  int steps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch<float>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                       x_out, x_tmp, p, r, n, ny, nx, degree, steps, s);
        case 1: return dispatch<double>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                        x_out, x_tmp, p, r, n, ny, nx, degree, steps, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K5v.  dtype codes: 0 float32, 1 float64.  Fields are (n, nz, ny, nx, 3),
// weights (K, nz, ny, nx, 3, 3) per batch entry; w_bstride and d_bstride
// count reals between batch entries (0: shared).  r may be null (no final
// residual).  x_out, x_tmp, p are scratch the caller allocated with the
// shape of b; x0 is only read.
extern "C" int cheb_smooth_vector3d(int dtype, const void* w,
                                    long long w_bstride, const void* dinv,
                                    long long d_bstride, const void* b,
                                    const void* x0, const void* theta,
                                    const void* delta, int th_stride,
                                    void* x_out, void* x_tmp, void* p,
                                    void* r, int n, int nz, int ny, int nx,
                                    int degree, int steps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch3<float>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                        x_out, x_tmp, p, r, n, nz, ny, nx, degree, steps, s);
        case 1: return dispatch3<double>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                         x_out, x_tmp, p, r, n, nz, ny, nx, degree, steps, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
