// K1 (2-D) and K6 (3-D) on the plane tile: y_j = sum_k w_k * shift_k(x_j)
// for a batch of real fields x_j that share one weight set.
//
// Replaces control_tpu/ops/stencil.py:_pallas_kernel (K1, pallas_call
// :206) and _pallas_kernel_3d (K6, :255) on the paths' hot case: the
// ParaDiag factor's applies (n_t and n_t - 1 fields a call), all on
// n >= 2 real fields with shared weights.  stencil_apply.cu's per-entry
// kernel (one thread per node and field) streams the whole weight set
// once per field: 15 x 343 x 73^3 x 4 B = 8.0 GB at heat3d_q3's
// degree-3 call, where one set is 534 MB.  It stays for complex fields,
// per-entry weights and one field (ops/stencil.py:apply_design).
//
// Design: one pass of cheb_tile.cuh's plane tile (tile_apply, NS = 1), as
// K2 and K5 real run it a step: a block owns a TBX x TBY tile at one z
// for a chunk of NB fields; per input plane it stages the chunk's fields
// with their D-wide halo in shared memory (zero off the grid), and each
// thread loads each of its node's weights once, coalesced along x, with
// the next row's in flight, and applies it to all NB fields.  Chunks run
// fastest on blockIdx.x, so a further chunk of a tile reads its weights
// from L2.  A ragged last chunk stages zeros for the fields past the
// batch and writes none of them.
//
// Bound on the H100: one weight set and two field volumes from HBM (the
// design floor: 0.173 ms at 15 x 73^3 f32, K = 343), then the
// shared-memory neighbour reads, one 4- or 8-byte read per multiply-add
// (8.0 GB at that shape), and the multiply-adds (2 flops a read).  As for
// the smoothers, each weight meets NB values, not a tile of a shared
// operand, so tensor cores do not apply.  The launch bounds are the
// smoothers' (tile_min_blocks): this kernel is their residual pass
// without b, and holds no more registers.
//
// Measured on one H100 (PERF.md, profile_slice.py apply, device time,
// float32, against the per-entry kernel): 15 x 73^3 at degree 3 0.71
// against 2.87-2.92 ms, 15 x 65^3 at degree 2 0.250 against 0.905 and
// at degree 1 0.120 against 0.163, 63 x 257^2 0.024 against 0.032; chunks
// of 8 took 0.79-0.82, 0.283 and (2-D) 0.027 ms, and of 16 at 3-D degree
// 1 0.120, so the smoothers' widths serve both (tile_width).
//
// Instantiated where a path runs it: real float32 (chunks of 16; 8 at
// 3-D degree 1) and float64 (8), 3-D degrees 1-3 and 2-D degree 1.

#include "cheb_tile.cuh"

namespace {

template <int ND, int D, int NB, typename V>
__global__ void __launch_bounds__(TBX * TBY,
                                  tile_min_blocks<ND, D, NB, 1, V, V>())
stencil_tile_apply(const V* __restrict__ w, const V* __restrict__ x,
                   V* __restrict__ y, int n, int chunks, int nz, int ny,
                   int nx) {
    __shared__ PlaneTile<D, NB, V> tile;
    const int chunk = (int)(blockIdx.x % chunks);
    const int ix0 = (int)(blockIdx.x / chunks) * TBX;
    const int iy0 = blockIdx.y * TBY;
    const int ix = ix0 + threadIdx.x;
    const int iy = iy0 + threadIdx.y;
    const bool active = ix < nx && iy < ny;
    const int iz = ND == 3 ? (int)blockIdx.z : 0;
    const int c0 = chunk * NB;
    const int nb = n - c0 < NB ? n - c0 : NB;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t node = ((size_t)iz * ny + iy) * nx + ix;
    V acc[1][NB];
    tile_apply<ND, D, NB, 1, V, V>(w, nullptr, x + (size_t)c0 * vol, nb, iz,
                                   iy0, ix0, active, nz, ny, nx, tile, acc);
    if (!active) return;
#pragma unroll
    for (int j = 0; j < NB; ++j)
        if (j < nb) y[(size_t)(c0 + j) * vol + node] = acc[0][j];
}

template <int ND, int D, int NB, typename V>
int run_apply_tile(const void* w, const void* x, void* y, int n, int nz,
                   int ny, int nx, cudaStream_t stream) {
    const int chunks = (n + NB - 1) / NB;
    const dim3 block(TBX, TBY);
    const dim3 grid((unsigned)(((nx + TBX - 1) / TBX) * chunks),
                    (ny + TBY - 1) / TBY, nz);
    stencil_tile_apply<ND, D, NB, V><<<grid, block, 0, stream>>>(
        static_cast<const V*>(w), static_cast<const V*>(x),
        static_cast<V*>(y), n, chunks, nz, ny, nx);
    return (int)cudaGetLastError();
}

// the chunk width each instantiation takes (ops/stencil.py:apply_design)
template <typename V>
int apply_tile(int nb, const void* w, const void* x, void* y, int n, int nz,
               int ny, int nx, int nd, int degree, cudaStream_t stream) {
    if (n < 1 || nz < 1 || ny < 1 || nx < 1 || (nd == 2 && nz != 1) ||
        nz > 65535 || (ny + TBY - 1) / TBY > 65535 ||
        nb != tile_width<V>(nd, degree))
        return (int)cudaErrorInvalidValue;
#define STENCIL_APPLY_TILE_RUN(ND_, D_)                                     \
    if (nd == ND_ && degree == D_)                                          \
        return run_apply_tile<ND_, D_, tile_width<V>(ND_, D_), V>(          \
            w, x, y, n, nz, ny, nx, stream);
    STENCIL_APPLY_TILE_RUN(2, 1)
    STENCIL_APPLY_TILE_RUN(3, 1)
    STENCIL_APPLY_TILE_RUN(3, 2)
    STENCIL_APPLY_TILE_RUN(3, 3)
#undef STENCIL_APPLY_TILE_RUN
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 float64 (kernels.DTYPE_CODES); nb: the chunk width
// (tile_width: 16 float32 fields, 8 at 3-D degree 1, 8 float64 ones;
// another is refused).  w: (K, nz, ny, nx) shared by all n fields; x, y:
// (n, nz, ny, nx), nz = 1 for nd = 2.
extern "C" int stencil_apply_tile(int dtype, int nb, const void* w,
                                  const void* x, void* y, int n, int nz,
                                  int ny, int nx, int nd, int degree,
                                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return apply_tile<float>(nb, w, x, y, n, nz, ny, nx, nd, degree, s);
        case 1: return apply_tile<double>(nb, w, x, y, n, nz, ny, nx, nd, degree, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
