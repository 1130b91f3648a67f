// K2 (2-D real), K3 (2-D complex) and K5 (3-D, real and complex): fused
// Chebyshev-Jacobi smoothing with a node-stencil operator, plus the final
// residual r = b - A x, one thread per (node, batch entry): the kernel of
// the calls whose weights differ per batch entry (the ParaDiag frequency
// blocks of a pc state carried with per-frequency planes, K3 and K5
// complex), of complex fields, of 2-byte planes and of one real field of
// a 2-D degree-1 stencil (K = 9).  Other real fields with weights shared
// by the batch (the mass solves, the real V-cycles) and single real
// fields run the plane-tile kernel of cheb_tile.cuh instead, and a
// ParaDiag hierarchy stored as a stencil pair runs the pair smoother
// there; ops/stencil.py:cheb_design picks by shape.
//
// Replaces control_tpu/ops/stencil.py:fused_cheb_smooth (the inline real
// TPU kernel, K2), control_tpu/ops/stencil.py:_fused_cheb_complex (the
// re/im-plane TPU kernel, K3) and control_tpu/ops/stencil.py:_fused_cheb_nd3
// (the whole-volume 3-D TPU kernel in C x C coupled real form, K5, here for
// C = 1 real and C = 2 complex, degree 1 (K = 27), 2 (K = 125) and 3
// (K = 343); C = dim = 3 is cheb_smooth_vector.cu) on those calls.  All
// compute, per batch entry i with sigma = theta_i / delta_i:
//
//   step 0:   r = b - A x0;  p = (r * dinv) / theta;  x = x0 + p
//   step s:   r = b - A x;   rho' = 1 / (2 sigma - rho)
//             p = rho' rho p + (2 rho' / delta) (r * dinv);  x = x + p
//   final:    r = b - A x
//
// with rho = 1 / sigma after step 0.  The TPU kernels keep a whole plane
// (K5: a whole padded volume) and all K weight planes resident in VMEM
// across the steps.  On the H100 a single 257^2 float32 plane plus its
// K = 9 weight planes, let alone a 65^3 volume (1.1 MB in float32) with
// K = 27 weight volumes, is far above the 227 KB of shared memory a block
// may use, and every step reads the neighbours' previous iterate, so the
// steps need a grid-wide barrier.
// This design therefore runs one tiled launch per step: each thread owns
// one node, reads the OLD iterate from one buffer and writes the new one
// to the other (ping-pong), exactly as the TPU kernel evaluates the whole
// stencil before it writes back.  p is updated in place (each node reads
// only its own p).  rho depends only on theta, delta and the step index,
// so every thread recomputes it; no scalar state crosses launches.  One
// C entry point issues all launches, so Python makes one call per
// smoothing.
//
// Bound on the H100: device-memory bandwidth.  A step streams each
// entry's K weight planes, dinv, b, p (read and write) and the two x
// planes: about K + 6 values per node and entry for 2K + 10 flops (real;
// complex is 4x the flops for 2x the bytes), so a call moves about
// (steps + 1) times the bytes of its inputs, where the TPU kernel reads
// them once.  With per-entry weights nothing is shared between entries;
// where the weights are shared, cheb_tile.cuh reads them once a step for
// the batch (and the pair once for all frequencies), which is the design
// that replaced this one on those calls.
//
// 2-D grids take degrees 1-4 (K = 9, 25, 49, 81: Q1-Q4, and P1/P2
// triangles in their 3 x 3 and 5 x 5 footprints), as the TPU kernels K2
// and K3 take any degree; 3-D grids degrees 1-3 (K = 27, 125, 343: hex
// Q1-Q3).  A thread reads its neighbours straight from device memory (no
// shared tile), so a wider stencil only lengthens the unrolled offset loop
// and the rows of neighbours that adjacent blocks read again from L1/L2.
// Every offset into the weights and fields is a size_t: at degree 3 a
// batch of per-frequency complex weights passes 2^31 values (8 x 343 x
// 73^3 complex weights are 2.1e9 reals).
//
// Complex fields are read as interleaved float2/double2 straight from the
// storage of torch's complex tensors (K5 builds no [[re, -im], [im, re]]
// coupled weight stack: two real volumes per complex weight, not four);
// theta and delta are real.  A 2-D grid is nz = 1 with no z offsets (see
// stencil_at); (batch, z) run on gridDim.z.
//
// Narrow weight planes (the reference's ``weight_dtype``: w and dinv
// stored as bf16, f16 or, under float64 fields, f32; complex ones as
// interleaved (re, im) pairs) are the template parameter Wt: each weight
// and dinv value is widened to the field type on load (f_load), and the
// recurrence runs in the field type exactly as with full-precision
// weights.  A narrow plane cuts the weight bytes of a step (the bulk of
// them: K weight planes against about six field planes) by the ratio of
// the widths; the fields do not shrink.
//
// The kernels are templates here; cheb_smooth.cu instantiates them with
// weights stored in the field type (entry point cheb_smooth) and
// cheb_smooth_narrow.cu with narrower weights (cheb_smooth_narrow), two
// sources that nvcc compiles in parallel.
#pragma once

#include <cuda_runtime.h>

#include "field_ops.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

template <int ND, int D, typename V, typename Wt, typename R>
__global__ void cheb_step_kernel(const Wt* __restrict__ w,
                                 long long w_bstride,
                                 const Wt* __restrict__ dinv,
                                 long long d_bstride,
                                 const V* __restrict__ b,
                                 const V* __restrict__ x_old,
                                 V* __restrict__ x_new, V* __restrict__ p,
                                 const R* __restrict__ theta,
                                 const R* __restrict__ delta,
                                 int th_stride, int nz, int ny, int nx,
                                 int step) {
    const int ix = blockIdx.x * BX + threadIdx.x;
    const int iy = blockIdx.y * BY + threadIdx.y;
    if (ix >= nx || iy >= ny) return;
    // (batch, z) on gridDim.z; a 2-D grid has no z (nz = 1)
    const int iz = ND == 3 ? (int)(blockIdx.z % nz) : 0;
    const size_t bi = ND == 3 ? blockIdx.z / nz : blockIdx.z;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t node = ((size_t)iz * ny + iy) * nx + ix;
    const size_t at = bi * vol + node;

    const V ax = stencil_at<ND, D>(w + bi * (size_t)w_bstride,
                                   x_old + bi * vol, iz, iy, ix, nz, ny, nx);
    const V r = f_sub(b[at], ax);
    const V z = f_mul(r, f_load(V(), dinv[bi * (size_t)d_bstride + node]));
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

template <int ND, int D, typename V, typename Wt>
__global__ void residual_kernel(const Wt* __restrict__ w, long long w_bstride,
                                const V* __restrict__ b,
                                const V* __restrict__ x, V* __restrict__ r,
                                int nz, int ny, int nx) {
    const int ix = blockIdx.x * BX + threadIdx.x;
    const int iy = blockIdx.y * BY + threadIdx.y;
    if (ix >= nx || iy >= ny) return;
    // (batch, z) on gridDim.z; a 2-D grid has no z (nz = 1)
    const int iz = ND == 3 ? (int)(blockIdx.z % nz) : 0;
    const size_t bi = ND == 3 ? blockIdx.z / nz : blockIdx.z;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t at = bi * vol + ((size_t)iz * ny + iy) * nx + ix;
    r[at] = f_sub(b[at], stencil_at<ND, D>(w + bi * (size_t)w_bstride,
                                           x + bi * vol, iz, iy, ix, nz, ny,
                                           nx));
}

template <int ND, int D, typename V, typename Wt>
int run(const Wt* w, long long w_bstride, const Wt* dinv, long long d_bstride,
        const V* b, const V* x0, const typename RealOf<V>::type* theta,
        const typename RealOf<V>::type* delta, int th_stride, V* x_out,
        V* x_tmp, V* p, V* r, int n, int nz, int ny, int nx, int steps,
        cudaStream_t stream) {
    const dim3 block(BX, BY);
    const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, n * nz);
    const int nsteps = steps < 1 ? 1 : steps;
    const V* x_in = x0;
    for (int s = 0; s < nsteps; ++s) {
        // the last step lands in x_out
        V* x_dst = ((nsteps - 1 - s) % 2 == 0) ? x_out : x_tmp;
        cheb_step_kernel<ND, D, V, Wt><<<grid, block, 0, stream>>>(
            w, w_bstride, dinv, d_bstride, b, x_in, x_dst, p, theta, delta,
            th_stride, nz, ny, nx, s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        x_in = x_dst;
    }
    if (r != nullptr) {
        residual_kernel<ND, D, V, Wt><<<grid, block, 0, stream>>>(
            w, w_bstride, b, x_out, r, nz, ny, nx);
    }
    return (int)cudaGetLastError();
}

// w_bstride and d_bstride count elements of Wt (one per real weight, one
// pair per complex one), as do the offsets of stencil_at
template <typename V, typename Wt = V>
int dispatch(const void* w, long long w_bstride, const void* dinv,
             long long d_bstride, const void* b, const void* x0,
             const void* theta, const void* delta, int th_stride, void* x_out,
             void* x_tmp, void* p, void* r, int n, int nz, int ny, int nx,
             int nd, int degree, int steps, cudaStream_t stream) {
    using R = typename RealOf<V>::type;
    if (n < 1 || nz < 1 || ny < 1 || nx < 1 || (long long)n * nz > 65535 ||
        (nd == 2 && nz != 1))
        return (int)cudaErrorInvalidValue;
    const Wt* wv = static_cast<const Wt*>(w);
    const Wt* dv = static_cast<const Wt*>(dinv);
    const V* bv = static_cast<const V*>(b);
    const V* xv = static_cast<const V*>(x0);
    const R* th = static_cast<const R*>(theta);
    const R* de = static_cast<const R*>(delta);
    V* xo = static_cast<V*>(x_out);
    V* xt = static_cast<V*>(x_tmp);
    V* pv = static_cast<V*>(p);
    V* rv = static_cast<V*>(r);
    if (nd == 2 && degree == 1)
        return run<2, 1, V, Wt>(wv, w_bstride, dv, d_bstride, bv, xv,
                                    th, de, th_stride, xo, xt, pv, rv, n, nz,
                                    ny, nx, steps, stream);
    if (nd == 2 && degree == 2)
        return run<2, 2, V, Wt>(wv, w_bstride, dv, d_bstride, bv, xv,
                                    th, de, th_stride, xo, xt, pv, rv, n, nz,
                                    ny, nx, steps, stream);
    if (nd == 2 && degree == 3)
        return run<2, 3, V, Wt>(wv, w_bstride, dv, d_bstride, bv, xv,
                                    th, de, th_stride, xo, xt, pv, rv, n, nz,
                                    ny, nx, steps, stream);
    if (nd == 2 && degree == 4)
        return run<2, 4, V, Wt>(wv, w_bstride, dv, d_bstride, bv, xv,
                                    th, de, th_stride, xo, xt, pv, rv, n, nz,
                                    ny, nx, steps, stream);
    if (nd == 3 && degree == 1)
        return run<3, 1, V, Wt>(wv, w_bstride, dv, d_bstride, bv, xv,
                                    th, de, th_stride, xo, xt, pv, rv, n, nz,
                                    ny, nx, steps, stream);
    if (nd == 3 && degree == 2)
        return run<3, 2, V, Wt>(wv, w_bstride, dv, d_bstride, bv, xv,
                                    th, de, th_stride, xo, xt, pv, rv, n, nz,
                                    ny, nx, steps, stream);
    if (nd == 3 && degree == 3)
        return run<3, 3, V, Wt>(wv, w_bstride, dv, d_bstride, bv, xv,
                                    th, de, th_stride, xo, xt, pv, rv, n, nz,
                                    ny, nx, steps, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace
