// The ParaDiag frequency smoother on a stencil pair: K3 (2-D) and K5
// complex (3-D) for a frequency hierarchy stored as one real stencil pair.
//
// Replaces control_tpu/ops/stencil.py:_fused_cheb_complex (K3) and
// control_tpu/ops/stencil.py:_fused_cheb_nd3 with C = 2 (K5 complex) on
// the ParaDiag path of the port's own pc builds.  Those TPU kernels, like
// cheb_smooth.cuh's complex instantiations, read one complex weight volume
// per frequency k.  The ParaDiag frequency operators are A_k = F + mu_k S,
// and every stage of the multigrid build is linear in A, so at every level
// W_k = W_F + mu_k W_S with one real pair (W_F, W_S) for all frequencies
// (solvers/multigrid.py, MGConfig.build_pair).  This kernel computes the
// same Chebyshev-Jacobi recurrence as cheb_smooth.cuh, per frequency k
// with sigma = theta_k / delta_k:
//
//   step 0:   r = b - A_k x0;  p = (r * dinv) / theta;  x = x0 + p
//   step s:   r = b - A_k x;   rho' = 1 / (2 sigma - rho)
//             p = rho' rho p + (2 rho' / delta) (r * dinv);  x = x + p
//   final:    r = b - A_k x
//
// with A_k x = W_F x + mu_k (W_S x) and rho = 1 / sigma after step 0.
//
// Bound on the H100: the weight bytes shrink 4x (complex64: 2 real
// weights a node and offset for all frequencies against 2 NB), so the
// neighbour reads lead.  At hex Q3 (73^3, 8 frequencies) a step streams
// the 1.07 GB pair once, where the per-frequency kernels stream 8.54 GB,
// and does 8 flops per node, offset and frequency (the bound of a call is
// in its flops, 78 GFLOP at 8 steps + r); the 2-D flagship's pair is
// 4.8 MB, in L2, and its fields lead (101 MB a step).
//
// Design: a block owns a PBX x PBY tile of nodes at one z for a chunk of
// NB frequencies (NB = 8 in complex64, 4 in complex128: one chunk is all
// of heat3d's 8), one thread a node.  Per input plane (dz) the block
// stages the chunk's fields on the tile plus its D-wide halo in shared
// memory (zero off the grid, so the offset loop needs no bounds checks),
// then every thread runs that plane's (2D+1)^2 offsets: it loads w_F and
// w_S once per offset, in the real type, coalesced along x in the (K, z,
// y, x) layout, and accumulates accF[j] += w_F x_j(shift) and accS[j] +=
// w_S x_j(shift) from shared memory: 4 real multiply-adds a frequency,
// where forming w_F + mu_j w_S first would take 6.  After the last plane
// A x_j = accF[j] + mu_j accS[j].  So a step reads the pair once per
// chunk and, from L2, each field value 1.3-2.1 times (D = 1-3: the halo)
// for each of the 2D + 1 planes it lies in, not once per offset.
// Measured on one H100 (PERF.md): reading the neighbours through L1/L2
// instead took 22.3 ms at hex Q3 against 8.0 with the tile (the
// per-frequency kernel: 29.4), and prefetching the next row of weights
// into registers gained nothing at Q3 and Q2.  The
// launch bounds ask for 2 blocks an SM in complex64 (at most 128
// registers a thread), which took the 3-D degree-2 call from 4.97 to 2.99
// ms, and 3 for the 2-D degree-1 kernels (at most 85; the flagship's call
// 0.31 -> 0.25 ms); 3 spilled in 3-D, and so does complex128 below 128
// registers, so it asks for 1 (no path times it).  One launch per step
// (the steps need a grid-wide barrier: every node reads its neighbours'
// previous iterate), ping-pong x buffers, p in place, then the residual
// launch, as cheb_smooth.cuh's run() does.  The chunks and z run on
// gridDim.z; a 2-D grid is nz = 1 with no z offsets.  At K = 343 only the
// dx loop unrolls (as stencil_at does); every offset is a size_t.
//
// 2-D degrees 1-4 (K = 9 ... 81), 3-D degrees 1-3 (K = 27, 125, 343), in
// complex64 and complex128 (interleaved float2/double2, torch's storage);
// weights, theta and delta real; mu complex.

#include <cuda_runtime.h>

#include "field_ops.cuh"

namespace {

constexpr int PBX = 32;
constexpr int PBY = 8;

// one input plane of the chunk's NB fields for a PBX x PBY tile of nodes,
// with its D-wide halo in y and x (zero outside the grid and for the
// frequencies past the chunk's end)
template <int D, int NB, typename V>
struct PairTile {
    static constexpr int RX = PBX + 2 * D;
    static constexpr int RY = PBY + 2 * D;
    V v[NB][RY][RX];
};

// ax[j] = (W_F + mu[j] W_S) x_j at node (iz, iy0 + ty, ix0 + tx) for the
// nb <= NB fields x_j = x + j vol; offsets k run ([dz,] dy, dx)
// lexicographically over [-D, D]^ND (stencil_offsets() in
// ops/stencil.py), zero outside the grid.  Every thread of the block
// calls it (it stages the tile between barriers); only ``active`` ones
// (on the grid) compute.
// the blocks an SM each kernel's launch bounds ask for (see above): the
// most that leave its registers unspilled
template <int ND, int D, typename V>
constexpr int pair_min_blocks() {
    return sizeof(V) > 8 ? 1 : (ND == 2 && D == 1 ? 3 : 2);
}

template <int ND, int D, int NB, typename V>
__device__ __forceinline__ void pair_apply(
    const typename RealOf<V>::type* __restrict__ wF,
    const typename RealOf<V>::type* __restrict__ wS,
    const V* __restrict__ mu, const V* __restrict__ x, int nb, int iz,
    int iy0, int ix0, bool active, int nz, int ny, int nx,
    PairTile<D, NB, V>& tile, V (&ax)[NB]) {
    using R = typename RealOf<V>::type;
    using Tile = PairTile<D, NB, V>;
    constexpr int DZ = ND == 3 ? D : 0;
    constexpr int W = 2 * D + 1;
    constexpr int PLANE = Tile::RY * Tile::RX;
    // the dy loop unrolls where a plane's terms stay few (the dx loop
    // always does, as stencil_at's)
    constexpr int UNROLL = W * W * NB <= 200 ? W : 1;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t node =
        ((size_t)(ND == 3 ? iz : 0) * ny + iy0 + ty) * nx + ix0 + tx;
    V accF[NB], accS[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        accF[j] = f_zero(V());
        accS[j] = f_zero(V());
    }
    for (int dz = -DZ; dz <= DZ; ++dz) {
        const int z = (ND == 3 ? iz : 0) + dz;
        if (ND == 3 && (z < 0 || z >= nz)) continue;   // the whole block
        __syncthreads();   // the previous plane's reads are done
        for (int e = ty * PBX + tx; e < NB * PLANE; e += PBX * PBY) {
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
        __syncthreads();
        if (!active) continue;
        const int kz = (dz + DZ) * W * W;
#pragma unroll UNROLL
        for (int dy = -D; dy <= D; ++dy) {
#pragma unroll
            for (int dx = -D; dx <= D; ++dx) {
                const size_t k = kz + (dy + D) * W + (dx + D);
                const R a = wF[k * vol + node];
                const R s = wS[k * vol + node];
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    const V v = tile.v[j][ty + D + dy][tx + D + dx];
                    accF[j] = f_add(accF[j], f_scal(a, v));
                    accS[j] = f_add(accS[j], f_scal(s, v));
                }
            }
        }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        if (j < nb) ax[j] = f_add(accF[j], f_mul(mu[j], accS[j]));
    }
}

template <int ND, int D, int NB, typename V>
__global__ void __launch_bounds__(PBX * PBY,
                                  pair_min_blocks<ND, D, V>())
cheb_pair_step(const typename RealOf<V>::type* __restrict__ wF,
               const typename RealOf<V>::type* __restrict__ wS,
               const V* __restrict__ mu, const V* __restrict__ dinv,
               long long d_bstride, const V* __restrict__ b,
               const V* __restrict__ x_old, V* __restrict__ x_new,
               V* __restrict__ p,
               const typename RealOf<V>::type* __restrict__ theta,
               const typename RealOf<V>::type* __restrict__ delta,
               int th_stride, int n, int nz, int ny, int nx, int step) {
    using R = typename RealOf<V>::type;
    __shared__ PairTile<D, NB, V> tile;
    const int ix0 = blockIdx.x * PBX;
    const int iy0 = blockIdx.y * PBY;
    const int ix = ix0 + threadIdx.x;
    const int iy = iy0 + threadIdx.y;
    const bool active = ix < nx && iy < ny;
    // (chunk, z) on gridDim.z; a 2-D grid has no z (nz = 1)
    const int iz = ND == 3 ? (int)(blockIdx.z % nz) : 0;
    const int c0 = (int)(ND == 3 ? blockIdx.z / nz : blockIdx.z) * NB;
    const int nb = n - c0 < NB ? n - c0 : NB;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t node = ((size_t)iz * ny + iy) * nx + ix;
    V ax[NB];
    pair_apply<ND, D, NB, V>(wF, wS, mu + c0, x_old + (size_t)c0 * vol, nb,
                             iz, iy0, ix0, active, nz, ny, nx, tile, ax);
    if (!active) return;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        if (j < nb) {
            const int f = c0 + j;
            const size_t at = (size_t)f * vol + node;
            const V r = f_sub(b[at], ax[j]);
            const V z = f_mul(r, dinv[(size_t)f * d_bstride + node]);
            const R th = theta[f * th_stride];
            const R de = delta[f * th_stride];
            V pn;
            if (step == 0) {
                pn = f_rdiv(z, th);
            } else {
                const R sigma = th / de;
                R rho = R(1) / sigma;
                for (int s = 1; s < step; ++s)
                    rho = R(1) / (R(2) * sigma - rho);
                const R rho_new = R(1) / (R(2) * sigma - rho);
                pn = f_add(f_scal(rho_new * rho, p[at]),
                           f_scal(R(2) * rho_new / de, z));
            }
            p[at] = pn;
            x_new[at] = f_add(x_old[at], pn);
        }
    }
}

template <int ND, int D, int NB, typename V>
__global__ void __launch_bounds__(PBX * PBY,
                                  pair_min_blocks<ND, D, V>())
cheb_pair_residual(const typename RealOf<V>::type* __restrict__ wF,
                   const typename RealOf<V>::type* __restrict__ wS,
                   const V* __restrict__ mu, const V* __restrict__ b,
                   const V* __restrict__ x, V* __restrict__ r, int n,
                   int nz, int ny, int nx) {
    __shared__ PairTile<D, NB, V> tile;
    const int ix0 = blockIdx.x * PBX;
    const int iy0 = blockIdx.y * PBY;
    const int ix = ix0 + threadIdx.x;
    const int iy = iy0 + threadIdx.y;
    const bool active = ix < nx && iy < ny;
    const int iz = ND == 3 ? (int)(blockIdx.z % nz) : 0;
    const int c0 = (int)(ND == 3 ? blockIdx.z / nz : blockIdx.z) * NB;
    const int nb = n - c0 < NB ? n - c0 : NB;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t node = ((size_t)iz * ny + iy) * nx + ix;
    V ax[NB];
    pair_apply<ND, D, NB, V>(wF, wS, mu + c0, x + (size_t)c0 * vol, nb, iz,
                             iy0, ix0, active, nz, ny, nx, tile, ax);
    if (!active) return;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        if (j < nb) {
            const size_t at = (size_t)(c0 + j) * vol + node;
            r[at] = f_sub(b[at], ax[j]);
        }
    }
}

template <int ND, int D, int NB, typename V>
int run_pair(const typename RealOf<V>::type* wF,
             const typename RealOf<V>::type* wS, const V* mu, const V* dinv,
             long long d_bstride, const V* b, const V* x0,
             const typename RealOf<V>::type* theta,
             const typename RealOf<V>::type* delta, int th_stride, V* x_out,
             V* x_tmp, V* p, V* r, int n, int nz, int ny, int nx, int steps,
             cudaStream_t stream) {
    const int chunks = (n + NB - 1) / NB;
    if ((long long)chunks * nz > 65535) return (int)cudaErrorInvalidValue;
    const dim3 block(PBX, PBY);
    const dim3 grid((nx + PBX - 1) / PBX, (ny + PBY - 1) / PBY,
                    chunks * nz);
    const int nsteps = steps < 1 ? 1 : steps;
    const V* x_in = x0;
    for (int s = 0; s < nsteps; ++s) {
        // the last step lands in x_out
        V* x_dst = ((nsteps - 1 - s) % 2 == 0) ? x_out : x_tmp;
        cheb_pair_step<ND, D, NB, V><<<grid, block, 0, stream>>>(
            wF, wS, mu, dinv, d_bstride, b, x_in, x_dst, p, theta, delta,
            th_stride, n, nz, ny, nx, s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        x_in = x_dst;
    }
    if (r != nullptr) {
        cheb_pair_residual<ND, D, NB, V><<<grid, block, 0, stream>>>(
            wF, wS, mu, b, x_out, r, n, nz, ny, nx);
    }
    return (int)cudaGetLastError();
}

template <typename V, int NB>
int dispatch_pair(const void* wF, const void* wS, const void* mu,
                  const void* dinv, long long d_bstride, const void* b,
                  const void* x0, const void* theta, const void* delta,
                  int th_stride, void* x_out, void* x_tmp, void* p, void* r,
                  int n, int nz, int ny, int nx, int nd, int degree,
                  int steps, cudaStream_t stream) {
    using R = typename RealOf<V>::type;
    if (n < 1 || nz < 1 || ny < 1 || nx < 1 || (nd == 2 && nz != 1))
        return (int)cudaErrorInvalidValue;
    const R* f = static_cast<const R*>(wF);
    const R* s = static_cast<const R*>(wS);
    const V* m = static_cast<const V*>(mu);
    const V* dv = static_cast<const V*>(dinv);
    const V* bv = static_cast<const V*>(b);
    const V* xv = static_cast<const V*>(x0);
    const R* th = static_cast<const R*>(theta);
    const R* de = static_cast<const R*>(delta);
    V* xo = static_cast<V*>(x_out);
    V* xt = static_cast<V*>(x_tmp);
    V* pv = static_cast<V*>(p);
    V* rv = static_cast<V*>(r);
#define CHEB_PAIR_RUN(ND_, D_)                                              \
    if (nd == ND_ && degree == D_)                                          \
        return run_pair<ND_, D_, NB, V>(f, s, m, dv, d_bstride, bv, xv, th, \
                                        de, th_stride, xo, xt, pv, rv, n,   \
                                        nz, ny, nx, steps, stream);
    CHEB_PAIR_RUN(2, 1)
    CHEB_PAIR_RUN(2, 2)
    CHEB_PAIR_RUN(2, 3)
    CHEB_PAIR_RUN(2, 4)
    CHEB_PAIR_RUN(3, 1)
    CHEB_PAIR_RUN(3, 2)
    CHEB_PAIR_RUN(3, 3)
#undef CHEB_PAIR_RUN
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 2 complex64, 3 complex128 (kernels.DTYPE_CODES).  wF, wS:
// (K, nz, ny, nx) real weights shared by all n frequencies; mu: (n,)
// complex; dinv: (nz, ny, nx) shared (d_bstride 0) or one plane per
// frequency (d_bstride = nz ny nx, in complex values); b, x0: (n, nz, ny,
// nx), nz = 1 for nd = 2; theta, delta: real, th_stride 0 (shared) or 1
// (per frequency).  r may be null (no final residual).  x_out, x_tmp, p
// are scratch the caller allocated with the shape of b; x0 is only read.
extern "C" int cheb_smooth_pair(int dtype, const void* wF, const void* wS,
                                const void* mu, const void* dinv,
                                long long d_bstride, const void* b,
                                const void* x0, const void* theta,
                                const void* delta, int th_stride,
                                void* x_out, void* x_tmp, void* p, void* r,
                                int n, int nz, int ny, int nx, int nd,
                                int degree, int steps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 2:
            return dispatch_pair<float2, 8>(wF, wS, mu, dinv, d_bstride, b,
                                            x0, theta, delta, th_stride,
                                            x_out, x_tmp, p, r, n, nz, ny,
                                            nx, nd, degree, steps, st);
        case 3:
            return dispatch_pair<double2, 4>(wF, wS, mu, dinv, d_bstride, b,
                                             x0, theta, delta, th_stride,
                                             x_out, x_tmp, p, r, n, nz, ny,
                                             nx, nd, degree, steps, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
