// K1 (2-D) and K6 (3-D): node-stencil operator application
// y[b] = sum_k w[b|0, k] * shift_k(x[b]).
//
// K1 replaces control_tpu/ops/stencil.py:_pallas_kernel (via apply_stencil),
// the TPU kernel that streams a zero-padded source plane and all K weight
// planes of a batch entry through VMEM in one grid step, at any degree
// (K = 9, 25, 49, 81 here: degrees 1-4).  K6
// replaces control_tpu/ops/stencil.py:_pallas_kernel_3d (via
// _apply_3d_pallas), which keeps the padded source volume in VMEM and
// streams the K = 27 (degree 2: 125, degree 3: 343) weight planes of one
// output z-plane per grid step, from weights reshuffled z-major for its
// BlockSpec.  Here the weights are read as (nw, K, nz, ny, nx) directly: no
// reshuffle, no padded copy.
//
// Bound on the H100: device-memory bandwidth.  Each output node reads its K
// weights once (no reuse within a call) plus K neighbouring sources and
// writes one value; the neighbours are shared by adjacent threads and come
// from L1/L2, so the traffic is about (K + 2) values per node at 2 flops
// per weight.  The design follows: one thread per output node, neighbouring
// threads on neighbouring x (coalesced), zero padding by bounds checks, a
// (32, 8) tile of one (y, x) plane per block, and (batch, z) on gridDim.z.
// A shared weight set (w batch stride 0) serves every batch entry, and is
// then streamed once per entry (from HBM where it exceeds the L2); so a
// batch of real fields with shared weights runs stencil_apply_tile.cu,
// which reads each weight once for a chunk of fields, and this kernel
// serves complex fields, per-entry weights and one field
// (ops/stencil.py:apply_design).

#include <cuda_runtime.h>

#include "field_ops.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

template <int ND, int D, typename V>
__global__ void stencil_apply_kernel(const V* __restrict__ w,
                                     long long w_bstride,
                                     const V* __restrict__ x,
                                     V* __restrict__ y, int nz, int ny,
                                     int nx) {
    const int ix = blockIdx.x * BX + threadIdx.x;
    const int iy = blockIdx.y * BY + threadIdx.y;
    if (ix >= nx || iy >= ny) return;
    // (batch, z) on gridDim.z; a 2-D grid has no z (nz = 1)
    const int iz = ND == 3 ? (int)(blockIdx.z % nz) : 0;
    const size_t b = ND == 3 ? blockIdx.z / nz : blockIdx.z;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    y[b * vol + ((size_t)iz * ny + iy) * nx + ix] = stencil_at<ND, D>(
        w + b * (size_t)w_bstride, x + b * vol, iz, iy, ix, nz, ny, nx);
}

template <typename V>
int launch_apply(const void* w, long long w_bstride, const void* x, void* y,
                 int n, int nz, int ny, int nx, int nd, int degree,
                 cudaStream_t stream) {
    if (n < 1 || nz < 1 || ny < 1 || nx < 1 || (long long)n * nz > 65535 ||
        (nd == 2 && nz != 1))
        return (int)cudaErrorInvalidValue;
    const dim3 block(BX, BY);
    const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, n * nz);
    const V* wv = static_cast<const V*>(w);
    const V* xv = static_cast<const V*>(x);
    V* yv = static_cast<V*>(y);
    if (nd == 2 && degree == 1) {
        stencil_apply_kernel<2, 1, V><<<grid, block, 0, stream>>>(wv, w_bstride, xv, yv, nz, ny, nx);
    } else if (nd == 2 && degree == 2) {
        stencil_apply_kernel<2, 2, V><<<grid, block, 0, stream>>>(wv, w_bstride, xv, yv, nz, ny, nx);
    } else if (nd == 2 && degree == 3) {
        stencil_apply_kernel<2, 3, V><<<grid, block, 0, stream>>>(wv, w_bstride, xv, yv, nz, ny, nx);
    } else if (nd == 2 && degree == 4) {
        stencil_apply_kernel<2, 4, V><<<grid, block, 0, stream>>>(wv, w_bstride, xv, yv, nz, ny, nx);
    } else if (nd == 3 && degree == 1) {
        stencil_apply_kernel<3, 1, V><<<grid, block, 0, stream>>>(wv, w_bstride, xv, yv, nz, ny, nx);
    } else if (nd == 3 && degree == 2) {
        stencil_apply_kernel<3, 2, V><<<grid, block, 0, stream>>>(wv, w_bstride, xv, yv, nz, ny, nx);
    } else if (nd == 3 && degree == 3) {
        stencil_apply_kernel<3, 3, V><<<grid, block, 0, stream>>>(wv, w_bstride, xv, yv, nz, ny, nx);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 float64, 2 complex64, 3 complex128.
// Fields are (n, nz, ny, nx), with nz = 1 for nd = 2; weights (nw, K, nz,
// ny, nx) with batch stride w_bstride (0: shared).
extern "C" int stencil_apply(int dtype, const void* w, long long w_bstride,
                             const void* x, void* y, int n, int nz, int ny,
                             int nx, int nd, int degree, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_apply<float>(w, w_bstride, x, y, n, nz, ny, nx, nd, degree, s);
        case 1: return launch_apply<double>(w, w_bstride, x, y, n, nz, ny, nx, nd, degree, s);
        case 2: return launch_apply<float2>(w, w_bstride, x, y, n, nz, ny, nx, nd, degree, s);
        case 3: return launch_apply<double2>(w, w_bstride, x, y, n, nz, ny, nx, nd, degree, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
