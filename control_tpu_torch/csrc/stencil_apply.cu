// K1: node-stencil operator application y[b] = sum_k w[b|0, k] * shift_k(x[b]).
//
// Replaces control_tpu/ops/stencil.py:_pallas_kernel (via apply_stencil),
// the TPU kernel that streams a zero-padded source plane and all K weight
// planes of a batch entry through VMEM in one grid step.
//
// Bound on the H100: device-memory bandwidth.  Each output node reads its K
// weights once (K = 9 planes for Q1, no reuse) plus K neighbouring sources
// and writes one value; the neighbours are shared by adjacent threads and
// come from L1/L2, so the traffic is about (K + 2) values per node at
// 2 flops per weight.  The design follows: one thread per output node,
// neighbouring threads on neighbouring x, zero padding by bounds checks
// (no padded copy of x is made), and the batch on gridDim.z.  A shared
// weight set (w batch stride 0) serves every batch entry.

#include <cuda_runtime.h>

#include "field_ops.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

template <int D, typename V>
__global__ void stencil_apply_kernel(const V* __restrict__ w,
                                     long long w_bstride,
                                     const V* __restrict__ x,
                                     V* __restrict__ y, int ny, int nx) {
    const int ix = blockIdx.x * BX + threadIdx.x;
    const int iy = blockIdx.y * BY + threadIdx.y;
    if (ix >= nx || iy >= ny) return;
    const size_t plane = (size_t)ny * nx;
    const size_t b = blockIdx.z;
    y[b * plane + (size_t)iy * nx + ix] = stencil_at<D>(
        w + b * (size_t)w_bstride, x + b * plane, iy, ix, ny, nx);
}

template <typename V>
int launch_apply(const void* w, long long w_bstride, const void* x, void* y,
                 int n, int ny, int nx, int degree, cudaStream_t stream) {
    if (n < 1 || n > 65535 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
    const dim3 block(BX, BY);
    const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, n);
    const V* wv = static_cast<const V*>(w);
    const V* xv = static_cast<const V*>(x);
    V* yv = static_cast<V*>(y);
    if (degree == 1) {
        stencil_apply_kernel<1, V><<<grid, block, 0, stream>>>(wv, w_bstride, xv, yv, ny, nx);
    } else if (degree == 2) {
        stencil_apply_kernel<2, V><<<grid, block, 0, stream>>>(wv, w_bstride, xv, yv, ny, nx);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 float64, 2 complex64, 3 complex128
extern "C" int stencil_apply(int dtype, const void* w, long long w_bstride,
                             const void* x, void* y, int n, int ny, int nx,
                             int degree, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_apply<float>(w, w_bstride, x, y, n, ny, nx, degree, s);
        case 1: return launch_apply<double>(w, w_bstride, x, y, n, ny, nx, degree, s);
        case 2: return launch_apply<float2>(w, w_bstride, x, y, n, ny, nx, degree, s);
        case 3: return launch_apply<double2>(w, w_bstride, x, y, n, ny, nx, degree, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
