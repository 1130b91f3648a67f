// K2 (real) and K3 (complex): fused Chebyshev-Jacobi smoothing with a
// node-stencil operator, plus the final residual r = b - A x.
//
// Replaces control_tpu/ops/stencil.py:fused_cheb_smooth (the inline real
// TPU kernel, K2) and control_tpu/ops/stencil.py:_fused_cheb_complex (the
// re/im-plane TPU kernel, K3).  Both compute, per batch entry i with
// sigma = theta_i / delta_i:
//
//   step 0:   r = b - A x0;  p = (r * dinv) / theta;  x = x0 + p
//   step s:   r = b - A x;   rho' = 1 / (2 sigma - rho)
//             p = rho' rho p + (2 rho' / delta) (r * dinv);  x = x + p
//   final:    r = b - A x
//
// with rho = 1 / sigma after step 0.  The TPU kernels keep a whole plane
// and all K weight planes resident in VMEM across the steps.  On the H100
// a single 257^2 float32 plane plus its K = 9 weight planes is far above
// the 227 KB of shared memory a block may use, and every step reads the
// neighbours' previous iterate, so the steps need a grid-wide barrier.
// This design therefore runs one tiled launch per step: each thread owns
// one node, reads the OLD iterate from one buffer and writes the new one
// to the other (ping-pong), exactly as the TPU kernel evaluates the whole
// stencil before it writes back.  p is updated in place (each node reads
// only its own p).  rho depends only on theta, delta and the step index,
// so every thread recomputes it; no scalar state crosses launches.  One
// C entry point issues all launches, so Python makes one call per
// smoothing.
//
// Bound on the H100: device-memory bandwidth.  A step streams the K weight
// planes, dinv, b, p (read and write) and the two x planes: about K + 6
// values per node for 2K + 10 flops (real; complex is 4x the flops for 2x
// the bytes).  Fusing steps (temporal blocking in shared memory, thread
// block clusters) is the next step for speed.
//
// Complex fields are read as interleaved float2/double2 straight from the
// storage of torch's complex tensors; theta and delta are real.

#include <cuda_runtime.h>

#include "field_ops.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

template <int D, typename V, typename R>
__global__ void cheb_step_kernel(const V* __restrict__ w, long long w_bstride,
                                 const V* __restrict__ dinv,
                                 long long d_bstride,
                                 const V* __restrict__ b,
                                 const V* __restrict__ x_old,
                                 V* __restrict__ x_new, V* __restrict__ p,
                                 const R* __restrict__ theta,
                                 const R* __restrict__ delta,
                                 int th_stride, int ny, int nx, int step) {
    const int ix = blockIdx.x * BX + threadIdx.x;
    const int iy = blockIdx.y * BY + threadIdx.y;
    if (ix >= nx || iy >= ny) return;
    const size_t plane = (size_t)ny * nx;
    const size_t bi = blockIdx.z;
    const size_t node = (size_t)iy * nx + ix;
    const size_t at = bi * plane + node;

    const V ax = stencil_at<D>(w + bi * (size_t)w_bstride, x_old + bi * plane,
                               iy, ix, ny, nx);
    const V r = f_sub(b[at], ax);
    const V z = f_mul(r, dinv[bi * (size_t)d_bstride + node]);
    const R th = theta[bi * th_stride];
    const R de = delta[bi * th_stride];
    V pn;
    if (step == 0) {
        pn = f_rdiv(z, th);
    } else {
        const R sigma = th / de;
        R rho = R(1) / sigma;
        for (int k = 1; k < step; ++k) rho = R(1) / (R(2) * sigma - rho);
        const R rho_new = R(1) / (R(2) * sigma - rho);
        pn = f_add(f_scal(rho_new * rho, p[at]),
                   f_scal(R(2) * rho_new / de, z));
    }
    p[at] = pn;
    x_new[at] = f_add(x_old[at], pn);
}

template <int D, typename V>
__global__ void residual_kernel(const V* __restrict__ w, long long w_bstride,
                                const V* __restrict__ b,
                                const V* __restrict__ x, V* __restrict__ r,
                                int ny, int nx) {
    const int ix = blockIdx.x * BX + threadIdx.x;
    const int iy = blockIdx.y * BY + threadIdx.y;
    if (ix >= nx || iy >= ny) return;
    const size_t plane = (size_t)ny * nx;
    const size_t bi = blockIdx.z;
    const size_t at = bi * plane + (size_t)iy * nx + ix;
    r[at] = f_sub(b[at], stencil_at<D>(w + bi * (size_t)w_bstride,
                                       x + bi * plane, iy, ix, ny, nx));
}

template <int D, typename V>
int run(const V* w, long long w_bstride, const V* dinv, long long d_bstride,
        const V* b, const V* x0, const typename RealOf<V>::type* theta,
        const typename RealOf<V>::type* delta, int th_stride, V* x_out,
        V* x_tmp, V* p, V* r, int n, int ny, int nx, int steps,
        cudaStream_t stream) {
    const dim3 block(BX, BY);
    const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, n);
    const int nsteps = steps < 1 ? 1 : steps;
    const V* x_in = x0;
    for (int s = 0; s < nsteps; ++s) {
        // the last step lands in x_out
        V* x_dst = ((nsteps - 1 - s) % 2 == 0) ? x_out : x_tmp;
        cheb_step_kernel<D, V><<<grid, block, 0, stream>>>(
            w, w_bstride, dinv, d_bstride, b, x_in, x_dst, p, theta, delta,
            th_stride, ny, nx, s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        x_in = x_dst;
    }
    if (r != nullptr) {
        residual_kernel<D, V><<<grid, block, 0, stream>>>(
            w, w_bstride, b, x_out, r, ny, nx);
    }
    return (int)cudaGetLastError();
}

template <typename V>
int dispatch(const void* w, long long w_bstride, const void* dinv,
             long long d_bstride, const void* b, const void* x0,
             const void* theta, const void* delta, int th_stride, void* x_out,
             void* x_tmp, void* p, void* r, int n, int ny, int nx,
             int degree, int steps, cudaStream_t stream) {
    using R = typename RealOf<V>::type;
    if (n < 1 || n > 65535 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
    const V* wv = static_cast<const V*>(w);
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
        return run<1, V>(wv, w_bstride, dv, d_bstride, bv, xv, th, de,
                         th_stride, xo, xt, pv, rv, n, ny, nx, steps, stream);
    if (degree == 2)
        return run<2, V>(wv, w_bstride, dv, d_bstride, bv, xv, th, de,
                         th_stride, xo, xt, pv, rv, n, ny, nx, steps, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 float64 (K2); 2 complex64, 3 complex128 (K3).
// r may be null (no final residual).  x_out, x_tmp, p are scratch the
// caller allocated with the shape of b; x0 is only read.
extern "C" int cheb_smooth(int dtype, const void* w, long long w_bstride,
                           const void* dinv, long long d_bstride,
                           const void* b, const void* x0, const void* theta,
                           const void* delta, int th_stride, void* x_out,
                           void* x_tmp, void* p, void* r, int n, int ny,
                           int nx, int degree, int steps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch<float>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta,
                                       th_stride, x_out, x_tmp, p, r, n, ny, nx, degree, steps, s);
        case 1: return dispatch<double>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta,
                                        th_stride, x_out, x_tmp, p, r, n, ny, nx, degree, steps, s);
        case 2: return dispatch<float2>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta,
                                        th_stride, x_out, x_tmp, p, r, n, ny, nx, degree, steps, s);
        case 3: return dispatch<double2>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta,
                                         th_stride, x_out, x_tmp, p, r, n, ny, nx, degree, steps, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
