// The plane-tile Chebyshev-Jacobi smoother: NS real stencils (NS = 1, or
// the ParaDiag pair W_F, W_S with NS = 2) applied to a chunk of NB fields
// that share them.  One template serves
//
//   * cheb_smooth_pair.cu: K3 and K5 complex on a frequency hierarchy
//     stored as one real stencil pair, A_k = W_F + mu_k W_S (NS = 2,
//     complex fields, NB = 8 in complex64, 4 in complex128);
//   * cheb_smooth_tile.cu, cheb_smooth_tile_narrow.cu: K2 and K5 real on
//     a batch of real fields with shared weights (NS = 1, NB = 16 in
//     float32, 8 at 3-D degree 1, and 8 in float64; weights Wt stored as
//     the field type, or float32 under float64) and on a single field of
//     a stencil of RING or more weights (NB = 1, with an asynchronous
//     weight ring, below).  2-byte planes run cheb_smooth.cuh's per-entry
//     kernel, which was as fast or faster at every shape measured;
//   * stencil_apply_tile.cu: K1 and K6, one pass of tile_apply without
//     the recurrence, on a batch of real fields with shared weights.
//
// Replaces control_tpu/ops/stencil.py:fused_cheb_smooth's inline real
// kernel (K2, pallas_call :589), _fused_cheb_complex (K3, :728) and
// _fused_cheb_nd3 (K5, :1090, C = 1 real and C = 2 complex) on those
// paths.  All compute, per field j with sigma = theta_j / delta_j:
//
//   step 0:   r = b - A_j x0;  p = (r * dinv) / theta;  x = x0 + p
//   step s:   r = b - A_j x;   rho' = 1 / (2 sigma - rho)
//             p = rho' rho p + (2 rho' / delta) (r * dinv);  x = x + p
//   final:    r = b - A_j x
//
// with rho = 1 / sigma after step 0, A_j = W (NS = 1) or W_F + mu_j W_S.
// The TPU kernels keep whole planes (K5: volumes) and all K weight planes
// in VMEM across the steps; on the H100 a block has 227 KB of shared
// memory and every step reads the neighbours' previous iterate, so the
// steps need a grid-wide barrier: one launch per step, ping-pong x
// buffers, p updated in place (each node reads only its own p), then the
// residual launch.  rho depends only on theta, delta and the step, so
// every thread recomputes it; no scalar state crosses launches.
//
// Design: a block owns a TBX x TBY tile of nodes at one z for a chunk of
// NB fields, one thread a node.  Per input plane (dz) the block stages the
// chunk's fields on the tile plus its D-wide halo in shared memory (zero
// off the grid, so the offset loop needs no bounds checks), then every
// thread runs that plane's (2D+1)^2 offsets in the order of
// stencil_offsets() (ops/stencil.py): it loads each weight once, in the
// (K, z, y, x) layout, coalesced along x, and applies it to all NB fields
// from shared memory.  With one stencil a thread loads the next row's
// weights into registers before it computes a row, so a row's loads are
// in flight during the previous row's multiply-adds.  The block order runs
// chunks fastest (on blockIdx.x), so the chunks of one tile read its
// weights from L2 one after another.  So a step reads the weights once
// for the whole batch (from HBM once, and from L2 once a further chunk)
// and, from L2, each field value 1.3-2.1 times (D = 1-3: the halo) for
// each of the 2D + 1 planes it lies in, not once per offset.  The
// recurrence's coefficients of shared bounds are computed once a thread,
// not once a field, and a 2-D tile gives the node's old x from shared
// memory.
//
// Bound on the H100.  Weights read once a step for the batch, the
// fields' b, x, p, dinv streamed once a step: the bytes of a call are
// (steps + 1) x (one weight set + about 6 field volumes), where the
// one-thread-per-(node, entry) kernel of cheb_smooth.cuh streamed the
// weight set once per entry (15 x 343 x 73^3 x 4 B = 8.0 GB a step in
// heat3d_q3's mass solve, against 534 MB here).  What is left leads: the
// shared-memory reads of the neighbours, one 4- or 8-byte read per
// multiply-add (88 GB a call at 15 x 73^3, K = 343, 10 steps + r, about
// 3 ms at the card's ~30 TB/s of shared-memory bandwidth), and the
// multiply-adds themselves (2 flops a read).  This is a stencil with
// per-node weights, not a matrix product: each weight meets NB values,
// not a tile of a shared operand, so tensor cores (wgmma, mma.sync) do
// not apply, and the work is CUDA-core FMAs; no cuBLAS, cuDNN or
// torch.compile call computes it.  Measured on one H100 (PERF.md, the
// tool profile_slice.py real): that call 44.6 ms with the per-entry
// kernel; with this design 13.8 at 3 blocks an SM, 11.3 at 4, and with
// the row prefetch 7.9 at 4 (whose registers spill there) and 8.2 at 3,
// the kept one.  Not kept: 5 blocks an SM (spills), chunks of 8 float32
// fields at degree 3 (8.54 against 7.90 ms; they run at degree 1, where
// the 16-field kernel spills), staging the planes with cp.async (q2 and
// the pair's q2 slower), unrolled row and plane loops for one stencil
// (spills).
//
// Batch one (NB = 1, NS = 1; the stationary V-cycles, the 3-D
// backward-Euler edge rows): a weight is used once, so the stream of K
// weights a node and step from device memory is the bound ((steps + 1) x
// the weight set: 21 x 2.50 GB at stationary_hex_q3's 97^3 f64 finest
// level, 15.7 ms at 3.35 TB/s).  Each thread owns one node of the flattened grid (no
// tile: a 97-wide row in 32-wide tiles leaves a quarter of the warps
// nearly idle) and streams its K weights through a ring of RING stages
// in shared memory with cp.async (4- or 8-byte copies: no registers
// held, completion per thread by cp.async.wait_group), reading stage t
// while the next RING - 1 copies are in flight; it loads each row's
// neighbours (through L1) before that row's stages.  No barrier: each
// thread reads only its own slots.  TMA (cp.async.bulk, tensor maps)
// needs 16-byte aligned addresses and global strides; a node row of 97
// float64 values (776 B) or 73 float32 ones (292 B) is not, so the rows
// cannot be described as bulk copies or tensor-map boxes.  A stencil of
// fewer weights than the ring has stages (2-D degree 1, K = 9) runs the
// per-entry kernel: the ring took 1.08-1.19x its device time at 257^2.
// Measured (PERF.md): 97^3 f64 20 + r 21.1-21.9 -> 17.8-18.8 ms (83-88%
// of the floor), 769^2 f64 2.17-2.29 -> 2.00-2.11 ms; the ring
// with the plane tile took 19.9 ms there and 0.42 ms at 65^3 (against
// 0.21 flat), a ring of 8 stages as long as 16, and launch bounds of 4
// or 6 blocks an SM spilled and ran slower (20.6, 31.0 ms).
//
// Chunks and z: gridDim.x = x tiles x chunks, gridDim.y = y tiles,
// gridDim.z = nz; a 2-D grid is nz = 1 with no z offsets.  At K = 343 only
// the dx loop unrolls; every offset is a size_t (a weight set can pass
// 2^31 values).
#pragma once

#include <cuda_runtime.h>

#include "field_ops.cuh"

namespace {

constexpr int TBX = 32;
constexpr int TBY = 8;
// stages of the batch-one weight ring (a power of two)
constexpr int RING = 16;
static_assert((RING & (RING - 1)) == 0, "RING must be a power of two");

// one input plane of the chunk's NB fields for a TBX x TBY tile of nodes,
// with its D-wide halo in y and x (zero outside the grid and for the
// fields past the chunk's end)
template <int D, int NB, typename V>
struct PlaneTile {
    static constexpr int RX = TBX + 2 * D;
    static constexpr int RY = TBY + 2 * D;
    V v[NB][RY][RX];
};

// threads of a batch-one block
constexpr int RING_THREADS = 256;

// each thread's RING weight slots (Wt: 4 or 8 bytes)
template <typename Wt>
struct WeightRing {
    static_assert(sizeof(Wt) == 4 || sizeof(Wt) == 8, "ring weights");
    static constexpr int SLOT = (int)sizeof(Wt);
    alignas(8) unsigned char s[RING][RING_THREADS][SLOT];
};

// the blocks an SM each kernel's launch bounds ask for: the most at which
// ptxas (sm_90a, the card host's toolkit) leaves its registers unspilled,
// found by building every instantiation at 2, 3, 4 and 5 (PERF.md); the
// build is checked for spills (chip_smoke.py fails on one).  The pair: 1
// in complex128, 3 for the 2-D degree-1 kernels, else 2.  One stencil: 4
// (64 registers), but for the float32 16-field 3-D kernels at degree 3
// and for some float64 ones (3); 5 spilled nearly everywhere, and the
// float32 16-field 3-D kernels at degree 1 kept their registers only at
// 2 (so chunks of 8 run there).
template <int ND, int D, int NB, int NS, typename V, typename Wt>
constexpr int tile_min_blocks() {
    if constexpr (NS == 2)
        return sizeof(V) > 8 ? 1 : (ND == 2 && D == 1 ? 3 : 2);
    if constexpr (sizeof(V) == 4) return ND == 3 && D == 3 ? 3 : 4;
    if (ND == 3 && (D == 1 || D == 3)) return 3;
    if (ND == 2 && D == 4) return 3;
    if (ND == 2 && D == 3 && sizeof(Wt) == 8) return 3;
    return 4;
}

// stage plane z of the nb <= NB fields x_j = x + j vol into the tile
// (every thread of the block; between barriers)
template <int D, int NB, typename V>
__device__ __forceinline__ void stage_plane(const V* __restrict__ x, int nb,
                                            size_t vol, int z, int iy0,
                                            int ix0, int ny, int nx,
                                            PlaneTile<D, NB, V>& tile) {
    using Tile = PlaneTile<D, NB, V>;
    constexpr int PLANE = Tile::RY * Tile::RX;
    for (int e = threadIdx.y * TBX + threadIdx.x; e < NB * PLANE;
         e += TBX * TBY) {
        const int j = e / PLANE;
        const int r = e - j * PLANE;
        const int ry = r / Tile::RX;
        const int rx = r - ry * Tile::RX;
        const int gy = iy0 - D + ry;
        const int gx = ix0 - D + rx;
        V v = f_zero(V());
        if (j < nb && gy >= 0 && gy < ny && gx >= 0 && gx < nx)
            v = x[j * vol + ((size_t)z * ny + gy) * nx + gx];
        tile.v[j][ry][rx] = v;
    }
}

// acc[s][j] = (W_s x_j)(iz, iy0 + ty, ix0 + tx) for the NS stencils
// W_0 = w0 (and W_1 = w1) and the nb <= NB fields x_j = x + j vol;
// offsets k run ([dz,] dy, dx) lexicographically over [-D, D]^ND, zero
// outside the grid.  Every thread of the block calls it (it stages the
// tile between barriers); only ``active`` ones (on the grid) compute.
template <int ND, int D, int NB, int NS, typename V, typename Wt>
__device__ __forceinline__ void tile_apply(
    const Wt* __restrict__ w0, const Wt* __restrict__ w1,
    const V* __restrict__ x, int nb, int iz,
    int iy0, int ix0, bool active, int nz, int ny, int nx,
    PlaneTile<D, NB, V>& tile, V (&acc)[NS][NB]) {
    using R = typename RealOf<V>::type;
    constexpr int DZ = ND == 3 ? D : 0;
    constexpr int W = 2 * D + 1;
    // the pair's dy loop unrolls where a plane's terms stay few (the dx
    // loop always does); one stencil's rolls, as does its plane loop (its
    // row prefetch hides the loads, and unrolled rows and planes would
    // spill registers)
    constexpr int UNROLL = NS == 1 || W * W * NB > 200 ? 1 : W;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t node =
        ((size_t)(ND == 3 ? iz : 0) * ny + iy0 + ty) * nx + ix0 + tx;
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[s][j] = f_zero(V());
    // input plane z = iz + dz: stage it, then its (2D+1)^2 offsets
    auto plane = [&](int dz) {
        const int z = (ND == 3 ? iz : 0) + dz;
        if (ND == 3 && (z < 0 || z >= nz)) return;   // the whole block
        __syncthreads();   // the previous plane's reads are done
        stage_plane<D, NB, V>(x, nb, vol, z, iy0, ix0, ny, nx, tile);
        __syncthreads();
        const int kz = (dz + DZ) * W * W;
        if constexpr (NS == 1) {
            // one stencil: each row loads the next row's weights before it
            // computes, so a row's loads are in flight while the previous
            // row's multiply-adds run
            R cur[W];
#pragma unroll
            for (int q = 0; q < W; ++q)
                cur[q] = active ? f_load(R(), w0[(size_t)(kz + q) * vol + node])
                                : R(0);
#pragma unroll UNROLL
            for (int dy = -D; dy <= D; ++dy) {
                const int kn = kz + (dy + D + 1) * W;   // the next row
                R nxt[W];
#pragma unroll
                for (int q = 0; q < W; ++q)
                    nxt[q] = active && dy < D
                                 ? f_load(R(), w0[(size_t)(kn + q) * vol + node])
                                 : R(0);
#pragma unroll
                for (int dx = -D; dx <= D; ++dx) {
#pragma unroll
                    for (int j = 0; j < NB; ++j)
                        acc[0][j] = f_add(
                            acc[0][j],
                            f_scal(cur[dx + D],
                                   tile.v[j][ty + D + dy][tx + D + dx]));
                }
#pragma unroll
                for (int q = 0; q < W; ++q) cur[q] = nxt[q];
            }
        } else {
            if (!active) return;
#pragma unroll UNROLL
            for (int dy = -D; dy <= D; ++dy) {
#pragma unroll
                for (int dx = -D; dx <= D; ++dx) {
                    const size_t k = kz + (dy + D) * W + (dx + D);
                    const R a[NS] = {f_load(R(), w0[k * vol + node]),
                                     f_load(R(), w1[k * vol + node])};
#pragma unroll
                    for (int j = 0; j < NB; ++j) {
                        const V v = tile.v[j][ty + D + dy][tx + D + dx];
#pragma unroll
                        for (int s = 0; s < NS; ++s)
                            acc[s][j] = f_add(acc[s][j], f_scal(a[s], v));
                    }
                }
            }
        }
    };
    if constexpr (NS == 1) {
#pragma unroll 1
        for (int dz = -DZ; dz <= DZ; ++dz) plane(dz);
    } else {
        for (int dz = -DZ; dz <= DZ; ++dz) plane(dz);
    }
}

// A_j x_j from the accumulators: W x (NS = 1) or W_F x + mu_j (W_S x)
template <int NS, typename V>
__device__ __forceinline__ V tile_combine(const V (&acc)[NS], const V* mu,
                                          int j) {
    if constexpr (NS == 1) {
        return acc[0];
    } else {
        return f_add(acc[0], f_mul(mu[j], acc[1]));
    }
}

// the recurrence's coefficients at step > 0: p' = c1 p + c2 (r * dinv)
template <typename R>
__device__ __forceinline__ void cheb_coeffs(R th, R de, int step, R& c1,
                                            R& c2) {
    const R sigma = th / de;
    R rho = R(1) / sigma;
    for (int s = 1; s < step; ++s) rho = R(1) / (R(2) * sigma - rho);
    const R rho_new = R(1) / (R(2) * sigma - rho);
    c1 = rho_new * rho;
    c2 = R(2) * rho_new / de;
}

// the recurrence's update of field f at this thread's node (ax = A_f x,
// xo = x there): p and x_new at ``at``; theta_f and the coefficients come
// shared (th_stride 0: computed once a thread by the caller) or per field
template <typename V, typename Dt>
__device__ __forceinline__ void cheb_update(
    V ax, V xo, const Dt* __restrict__ dinv, size_t d_at,
    const V* __restrict__ b, V* __restrict__ x_new, V* __restrict__ p,
    size_t at, const typename RealOf<V>::type* __restrict__ theta,
    const typename RealOf<V>::type* __restrict__ delta, int th_stride,
    int f, int step, typename RealOf<V>::type th,
    typename RealOf<V>::type c1, typename RealOf<V>::type c2) {
    const V r = f_sub(b[at], ax);
    const V z = f_mul(r, f_load(V(), dinv[d_at]));
    if (th_stride != 0) {
        th = theta[f];
        if (step > 0) cheb_coeffs(th, delta[f], step, c1, c2);
    }
    const V pn = step == 0 ? f_rdiv(z, th)
                           : f_add(f_scal(c1, p[at]), f_scal(c2, z));
    p[at] = pn;
    x_new[at] = f_add(xo, pn);
}

// theta and the step's coefficients of a smoothing with shared bounds
// (th_stride 0), once a thread; per-field bounds take theirs in
// cheb_update
template <typename R>
__device__ __forceinline__ void shared_coeffs(const R* __restrict__ theta,
                                              const R* __restrict__ delta,
                                              int th_stride, int step,
                                              R& th, R& c1, R& c2) {
    th = R(0);
    c1 = R(0);
    c2 = R(0);
    if (th_stride == 0) {
        th = theta[0];
        if (step > 0) cheb_coeffs(th, delta[0], step, c1, c2);
    }
}

template <int ND, int D, int NB, int NS, typename V, typename Wt,
          typename Dt>
__global__ void __launch_bounds__(TBX * TBY,
                                  tile_min_blocks<ND, D, NB, NS, V, Wt>())
cheb_tile_step(const Wt* __restrict__ w0, const Wt* __restrict__ w1,
               const V* __restrict__ mu, const Dt* __restrict__ dinv,
               long long d_bstride, const V* __restrict__ b,
               const V* __restrict__ x_old, V* __restrict__ x_new,
               V* __restrict__ p,
               const typename RealOf<V>::type* __restrict__ theta,
               const typename RealOf<V>::type* __restrict__ delta,
               int th_stride, int n, int chunks, int nz, int ny, int nx,
               int step) {
    using R = typename RealOf<V>::type;
    __shared__ PlaneTile<D, NB, V> tile;
    // chunks fastest: the chunks of one tile run one after another
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
    V acc[NS][NB];
    tile_apply<ND, D, NB, NS, V, Wt>(w0, w1, x_old + (size_t)c0 * vol, nb, iz,
                                     iy0, ix0, active, nz, ny, nx, tile, acc);
    if (!active) return;
    R th, c1, c2;
    shared_coeffs(theta, delta, th_stride, step, th, c1, c2);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        if (j < nb) {
            const int f = c0 + j;
            V aj[NS];
#pragma unroll
            for (int s = 0; s < NS; ++s) aj[s] = acc[s][j];
            const size_t at = (size_t)f * vol + node;
            // a 2-D tile holds the node's own plane: x there from it
            const V xo = ND == 2 ? tile.v[j][threadIdx.y + D][threadIdx.x + D]
                                 : x_old[at];
            cheb_update(tile_combine<NS>(aj, mu, f), xo, dinv,
                        (size_t)f * d_bstride + node, b, x_new, p, at, theta,
                        delta, th_stride, f, step, th, c1, c2);
        }
    }
}

template <int ND, int D, int NB, int NS, typename V, typename Wt>
__global__ void __launch_bounds__(TBX * TBY,
                                  tile_min_blocks<ND, D, NB, NS, V, Wt>())
cheb_tile_residual(const Wt* __restrict__ w0, const Wt* __restrict__ w1,
                   const V* __restrict__ mu, const V* __restrict__ b,
                   const V* __restrict__ x, V* __restrict__ r, int n,
                   int chunks, int nz, int ny, int nx) {
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
    V acc[NS][NB];
    tile_apply<ND, D, NB, NS, V, Wt>(w0, w1, x + (size_t)c0 * vol, nb, iz, iy0,
                                     ix0, active, nz, ny, nx, tile, acc);
    if (!active) return;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        if (j < nb) {
            V aj[NS];
#pragma unroll
            for (int s = 0; s < NS; ++s) aj[s] = acc[s][j];
            const size_t at = (size_t)(c0 + j) * vol + node;
            r[at] = f_sub(b[at], tile_combine<NS>(aj, mu, c0 + j));
        }
    }
}

// ---------------------------------------------------------------------------
// batch one: one thread a node of the flattened grid, the weights through
// the ring, the neighbours through L1
// ---------------------------------------------------------------------------

// cp.async of this thread's weight at g into slot s; no "memory" clobber:
// the ring's asm statements keep their order among themselves, and the
// neighbours' loads may move
template <typename Wt>
__device__ __forceinline__ void ring_copy(unsigned s, const Wt* g) {
    if constexpr (sizeof(Wt) == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                     "l"(g));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                     "l"(g));
}

__device__ __forceinline__ void ring_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void ring_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the weight in slot s (after its group has landed)
template <typename R, typename Wt>
__device__ __forceinline__ R ring_read(unsigned s) {
    if constexpr (sizeof(Wt) == 8) {
        double v;
        asm volatile("ld.shared.f64 %0, [%1];\n" : "=d"(v) : "r"(s));
        return f_load(R(), (Wt)v);
    } else {
        float v;
        asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(s));
        return f_load(R(), (Wt)v);
    }
}

// (W x)(node) at (iz, iy, ix) with W's weights streamed through the ring:
// offsets k run ([dz,] dy, dx) lexicographically over [-D, D]^ND, the
// planes off the grid are not read, the rows and columns off it are
// skipped (their weights stream with their neighbours' anyway)
template <int ND, int D, typename V, typename Wt>
__device__ __forceinline__ V ring_apply(const Wt* __restrict__ w,
                                        const V* __restrict__ x, int iz,
                                        int iy, int ix, bool active, int nz,
                                        int ny, int nx, WeightRing<Wt>& ring) {
    using R = typename RealOf<V>::type;
    constexpr int DZ = ND == 3 ? D : 0;
    constexpr int W = 2 * D + 1;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t node = ((size_t)iz * ny + iy) * nx + ix;
    const int z_lo = ND == 3 ? (iz - DZ < 0 ? -iz : -DZ) : 0;
    const int z_hi = ND == 3 ? (iz + DZ >= nz ? nz - 1 - iz : DZ) : 0;
    const int k0 = (z_lo + DZ) * W * W;
    const int T = active ? (z_hi - z_lo + 1) * W * W : 0;
    // this thread's slot of stage i: base + i * STAGE
    constexpr unsigned STAGE = RING_THREADS * WeightRing<Wt>::SLOT;
    const unsigned base =
        (unsigned)__cvta_generic_to_shared(ring.s[0][threadIdx.x]);
    const Wt* const wn = w + node + (size_t)k0 * vol;
#pragma unroll
    for (int t = 0; t < RING; ++t) {
        if (t < T)
            ring_copy(base + t * STAGE, wn + (size_t)t * vol);
        ring_commit();
    }
    V acc = f_zero(V());
    int t = 0;
    for (int dz = z_lo; dz <= z_hi; ++dz) {
        const int z = ND == 3 ? iz + dz : 0;
#pragma unroll
        for (int dy = -D; dy <= D; ++dy) {
            const int y = iy + dy;
            // the row's neighbours first, all loads in flight together
            // (zero off the grid: their terms add nothing)
            const V* xr = x + ((long long)z * ny + y) * nx + ix;
            V xv[W];
#pragma unroll
            for (int dx = -D; dx <= D; ++dx)
                xv[dx + D] = t < T && y >= 0 && y < ny && ix + dx >= 0 &&
                                     ix + dx < nx
                                 ? xr[dx]
                                 : f_zero(V());
#pragma unroll
            for (int dx = -D; dx <= D; ++dx, ++t) {
                // stage t has landed; its slot takes stage t + RING
                ring_wait<RING - 1>();
                const unsigned s = base + (t & (RING - 1)) * STAGE;
                const Wt* g = wn + (size_t)t * vol;
                if (t < T)
                    acc = f_add(acc, f_scal(ring_read<R, Wt>(s), xv[dx + D]));
                if (t + RING < T)
                    ring_copy(s, g + (size_t)RING * vol);
                ring_commit();
            }
        }
    }
    return acc;
}

template <int ND, int D, typename V, typename Wt>
__global__ void __launch_bounds__(RING_THREADS)
cheb_ring_step(const Wt* __restrict__ w, const Wt* __restrict__ dinv,
               const V* __restrict__ b,
               const V* __restrict__ x_old, V* __restrict__ x_new,
               V* __restrict__ p, const V* __restrict__ theta,
               const V* __restrict__ delta, int th_stride, int nz, int ny,
               int nx, int step) {
    __shared__ WeightRing<Wt> ring;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t node = (size_t)blockIdx.x * RING_THREADS + threadIdx.x;
    const bool active = node < vol;
    const int ix = (int)(node % nx);
    const int iy = (int)((node / nx) % ny);
    const int iz = ND == 3 ? (int)(node / ((size_t)nx * ny)) : 0;
    const V ax = ring_apply<ND, D, V, Wt>(w, x_old, iz, iy, ix, active, nz,
                                          ny, nx, ring);
    if (!active) return;
    V th, c1, c2;
    shared_coeffs(theta, delta, th_stride, step, th, c1, c2);
    cheb_update(ax, x_old[node], dinv, node, b, x_new, p, node, theta,
                delta, th_stride, 0, step, th, c1, c2);
}

template <int ND, int D, typename V, typename Wt>
__global__ void __launch_bounds__(RING_THREADS)
cheb_ring_residual(const Wt* __restrict__ w, const V* __restrict__ b,
                   const V* __restrict__ x, V* __restrict__ r, int nz,
                   int ny, int nx) {
    __shared__ WeightRing<Wt> ring;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t node = (size_t)blockIdx.x * RING_THREADS + threadIdx.x;
    const bool active = node < vol;
    const int ix = (int)(node % nx);
    const int iy = (int)((node / nx) % ny);
    const int iz = ND == 3 ? (int)(node / ((size_t)nx * ny)) : 0;
    const V ax = ring_apply<ND, D, V, Wt>(w, x, iz, iy, ix, active, nz, ny,
                                          nx, ring);
    if (active) r[node] = f_sub(b[node], ax);
}

// all launches of one batch-one smoothing (arguments as run_tile's)
template <int ND, int D, typename V, typename Wt>
int run_ring(const Wt* w, const Wt* dinv, const V* b, const V* x0,
             const V* theta, const V* delta, int th_stride, V* x_out,
             V* x_tmp, V* p, V* r, int nz, int ny, int nx, int steps,
             cudaStream_t stream) {
    if (nz < 1 || ny < 1 || nx < 1 || (ND == 2 && nz != 1))
        return (int)cudaErrorInvalidValue;
    const size_t vol = (size_t)nz * ny * nx;
    const dim3 grid((unsigned)((vol + RING_THREADS - 1) / RING_THREADS));
    const int nsteps = steps < 1 ? 1 : steps;
    const V* x_in = x0;
    for (int s = 0; s < nsteps; ++s) {
        V* x_dst = ((nsteps - 1 - s) % 2 == 0) ? x_out : x_tmp;
        cheb_ring_step<ND, D, V, Wt><<<grid, RING_THREADS, 0, stream>>>(
            w, dinv, b, x_in, x_dst, p, theta, delta, th_stride, nz, ny, nx,
            s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        x_in = x_dst;
    }
    if (r != nullptr) {
        cheb_ring_residual<ND, D, V, Wt><<<grid, RING_THREADS, 0, stream>>>(
            w, b, x_out, r, nz, ny, nx);
    }
    return (int)cudaGetLastError();
}

// all launches of one smoothing: w1 and mu only for NS = 2; dinv shared
// (d_bstride 0) or one volume per field; theta, delta shared (th_stride
// 0) or one per field; r may be null (no final residual); x_out, x_tmp,
// p are scratch of b's shape, x0 is only read
template <int ND, int D, int NB, int NS, typename V, typename Wt,
          typename Dt>
int run_tile(const Wt* w0, const Wt* w1, const V* mu, const Dt* dinv,
             long long d_bstride, const V* b, const V* x0,
             const typename RealOf<V>::type* theta,
             const typename RealOf<V>::type* delta, int th_stride, V* x_out,
             V* x_tmp, V* p, V* r, int n, int nz, int ny, int nx, int steps,
             cudaStream_t stream) {
    if (n < 1 || nz < 1 || ny < 1 || nx < 1 || (ND == 2 && nz != 1) ||
        nz > 65535 || (ny + TBY - 1) / TBY > 65535)
        return (int)cudaErrorInvalidValue;
    const int chunks = (n + NB - 1) / NB;
    const dim3 block(TBX, TBY);
    const dim3 grid((unsigned)(((nx + TBX - 1) / TBX) * chunks),
                    (ny + TBY - 1) / TBY, nz);
    const int nsteps = steps < 1 ? 1 : steps;
    const V* x_in = x0;
    for (int s = 0; s < nsteps; ++s) {
        // the last step lands in x_out
        V* x_dst = ((nsteps - 1 - s) % 2 == 0) ? x_out : x_tmp;
        cheb_tile_step<ND, D, NB, NS, V, Wt, Dt><<<grid, block, 0, stream>>>(
            w0, w1, mu, dinv, d_bstride, b, x_in, x_dst, p, theta, delta,
            th_stride, n, chunks, nz, ny, nx, s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        x_in = x_dst;
    }
    if (r != nullptr) {
        cheb_tile_residual<ND, D, NB, NS, V, Wt><<<grid, block, 0, stream>>>(
            w0, w1, mu, b, x_out, r, n, chunks, nz, ny, nx);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// one real stencil (K2, K5 real): the chunk widths the entry points take
// ---------------------------------------------------------------------------

namespace {

// the chunk width of real fields V on an ND-D grid at degree D for a
// batch with shared weights, as ops/stencil.py:cheb_design picks it: 16
// float32 fields (8 at 3-D degree 1) or 8 float64 ones; a single field
// runs the ring (NB = 1) where the stencil has RING or more weights
template <typename V>
constexpr int tile_width(int nd, int degree) {
    return sizeof(V) == 4 ? (nd == 3 && degree == 1 ? 8 : 16) : 8;
}

constexpr bool ring_runs(int nd, int degree) {
    return (nd == 3 ? (2 * degree + 1) * (2 * degree + 1) * (2 * degree + 1)
                    : (2 * degree + 1) * (2 * degree + 1)) >= RING;
}

template <int NB, typename V, typename Wt>
int run_real_tile(const void* w, const void* dinv, long long d_bstride,
                  const void* b, const void* x0, const void* theta,
                  const void* delta, int th_stride, void* x_out, void* x_tmp,
                  void* p, void* r, int n, int nz, int ny, int nx, int nd,
                  int degree, int steps, cudaStream_t stream) {
    const Wt* wv = static_cast<const Wt*>(w);
    const Wt* dv = static_cast<const Wt*>(dinv);
    const V* bv = static_cast<const V*>(b);
    const V* xv = static_cast<const V*>(x0);
    const V* th = static_cast<const V*>(theta);
    const V* de = static_cast<const V*>(delta);
    V* xo = static_cast<V*>(x_out);
    V* xt = static_cast<V*>(x_tmp);
    V* pv = static_cast<V*>(p);
    V* rv = static_cast<V*>(r);
#define CHEB_REAL_TILE_RUN(ND_, D_)                                         \
    if (nd == ND_ && degree == D_) {                                        \
        if constexpr (NB == 1 && ring_runs(ND_, D_))                       \
            return n != 1 ? (int)cudaErrorInvalidValue                      \
                          : run_ring<ND_, D_, V, Wt>(wv, dv, bv, xv, th, de, \
                                            th_stride, xo, xt, pv, rv, nz,  \
                                            ny, nx, steps, stream);         \
        else if constexpr (NB == tile_width<V>(ND_, D_))                   \
            return run_tile<ND_, D_, NB, 1, V, Wt, Wt>(                    \
                wv, nullptr, nullptr, dv, d_bstride, bv, xv, th, de,        \
                th_stride, xo, xt, pv, rv, n, nz, ny, nx, steps, stream);   \
        else                                                                \
            return (int)cudaErrorInvalidValue;                              \
    }
    CHEB_REAL_TILE_RUN(2, 1)
    CHEB_REAL_TILE_RUN(2, 2)
    CHEB_REAL_TILE_RUN(2, 3)
    CHEB_REAL_TILE_RUN(2, 4)
    CHEB_REAL_TILE_RUN(3, 1)
    CHEB_REAL_TILE_RUN(3, 2)
    CHEB_REAL_TILE_RUN(3, 3)
#undef CHEB_REAL_TILE_RUN
    return (int)cudaErrorInvalidValue;
}

// nb: tile_width<V>(nd, degree), or 1 (ops/stencil.py:cheb_design);
// another width is refused
template <typename V, typename Wt>
int dispatch_real_tile(int nb, const void* w, const void* dinv,
                       long long d_bstride, const void* b, const void* x0,
                       const void* theta, const void* delta, int th_stride,
                       void* x_out, void* x_tmp, void* p, void* r, int n,
                       int nz, int ny, int nx, int nd, int degree, int steps,
                       cudaStream_t stream) {
    if constexpr (sizeof(V) == 4) {
        if (nb == 16)
            return run_real_tile<16, V, Wt>(w, dinv, d_bstride, b, x0, theta,
                                            delta, th_stride, x_out, x_tmp, p,
                                            r, n, nz, ny, nx, nd, degree,
                                            steps, stream);
    }
    if (nb == 8)
        return run_real_tile<8, V, Wt>(w, dinv, d_bstride, b, x0, theta,
                                       delta, th_stride, x_out, x_tmp, p, r,
                                       n, nz, ny, nx, nd, degree, steps,
                                       stream);
    if (nb == 1)
        return run_real_tile<1, V, Wt>(w, dinv, d_bstride, b, x0, theta,
                                       delta, th_stride, x_out, x_tmp, p, r,
                                       n, nz, ny, nx, nd, degree, steps,
                                       stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// the narrow instantiation (cheb_smooth_tile_narrow.cu: float64 fields
// with float32 weights)
#define CHEB_TILE_ARGS                                                      \
    int wdtype, int nb, const void *w, const void *dinv,                    \
        long long d_bstride, const void *b, const void *x0,                 \
        const void *theta, const void *delta, int th_stride, void *x_out,   \
        void *x_tmp, void *p, void *r, int n, int nz, int ny, int nx,       \
        int nd, int degree, int steps, cudaStream_t stream
#define CHEB_TILE_PASS                                                      \
    nb, w, dinv, d_bstride, b, x0, theta, delta, th_stride, x_out, x_tmp,   \
        p, r, n, nz, ny, nx, nd, degree, steps, stream
int cheb_smooth_tile_narrow(CHEB_TILE_ARGS);
