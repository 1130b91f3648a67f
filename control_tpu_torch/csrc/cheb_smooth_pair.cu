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
// Design: the plane-tile template of cheb_tile.cuh with NS = 2 stencils
// (W_F, W_S) and NB = 8 frequencies a chunk in complex64, 4 in
// complex128 (one chunk is all of heat3d's 8): each thread loads w_F and
// w_S once per offset, in the real type, and accumulates accF[j] += w_F
// x_j(shift) and accS[j] += w_S x_j(shift) from the shared-memory plane
// tile: 4 real multiply-adds a frequency, where forming w_F + mu_j w_S
// first would take 6.  After the last plane A x_j = accF[j] + mu_j
// accS[j].  Measured on one H100 (PERF.md): reading the neighbours
// through L1/L2 instead took 22.3 ms at hex Q3 against 8.0 with the tile
// (the per-frequency kernel: 29.4), and prefetching the next row of
// weights into registers gained nothing at Q3 and Q2.  The launch bounds
// ask for 2 blocks an SM in complex64 (at most 128 registers a thread),
// which took the 3-D degree-2 call from 4.97 to 2.99 ms, and 3 for the
// 2-D degree-1 kernels (at most 85; the flagship's call 0.31 -> 0.25
// ms); 3 spilled in 3-D, and so does complex128 below 128 registers, so
// it asks for 1 (no path times it).
//
// 2-D degrees 1-4 (K = 9 ... 81), 3-D degrees 1-3 (K = 27, 125, 343), in
// complex64 and complex128 (interleaved float2/double2, torch's storage);
// weights, theta and delta real; mu complex.

#include "cheb_tile.cuh"

namespace {

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
        return run_tile<ND_, D_, NB, 2, V, R, V>(                          \
            f, s, m, dv, d_bstride, bv, xv, th, de, th_stride, xo, xt, pv,  \
            rv, n, nz, ny, nx, steps, stream);
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
