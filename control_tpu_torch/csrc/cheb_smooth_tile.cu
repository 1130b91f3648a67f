// K2 and K5 real on the plane-tile design (cheb_tile.cuh) with weights
// stored in the field's own dtype: a batch of fields with shared weights
// in chunks of NB, and a single field through the asynchronous weight
// ring.  Float32 planes under float64 fields (``weight_dtype``) are
// instantiated in cheb_smooth_tile_narrow.cu, which nvcc compiles in
// parallel.  Per-entry weights, complex fields, 2-byte planes and one
// field of a 2-D degree-1 stencil run cheb_smooth.cuh's kernels
// (cheb_smooth, cheb_smooth_narrow); ops/stencil.py:cheb_design picks
// the kernel and NB from the shape.

#include "cheb_tile.cuh"

// dtype: 0 float32, 1 float64 (kernels.DTYPE_CODES); wdtype: -1 weights
// and dinv stored as the fields, 2 (kernels.WEIGHT_CODES) float32 under
// float64 fields; nb: the chunk width (16 in float32, 8 at 3-D degree 1,
// 8 in float64; 1 for a single field; another is refused).  w: (K, nz,
// ny, nx) shared by all n fields; dinv: (nz, ny, nx) shared (d_bstride 0)
// or one volume per field (d_bstride = nz ny nx); b, x0: (n, nz, ny, nx),
// nz = 1 for nd = 2; theta, delta: th_stride 0 (shared) or 1 (per field).
// r may be null (no final residual).  x_out, x_tmp, p are scratch the
// caller allocated with the shape of b; x0 is only read.
extern "C" int cheb_smooth_tile(int dtype, CHEB_TILE_ARGS) {
    if (wdtype >= 0)
        return dtype == 1 && wdtype == 2
                   ? cheb_smooth_tile_narrow(wdtype, CHEB_TILE_PASS)
                   : (int)cudaErrorInvalidValue;
    switch (dtype) {
        case 0: return dispatch_real_tile<float, float>(CHEB_TILE_PASS);
        case 1: return dispatch_real_tile<double, double>(CHEB_TILE_PASS);
        default: return (int)cudaErrorInvalidValue;
    }
}
