// K2, K3 and K5 (real and complex) with weights stored in the field's own
// dtype, on calls with per-entry weights, complex fields or one real
// field of a 2-D degree-1 stencil; the kernels and their design are in
// cheb_smooth.cuh (other real fields with shared weights run
// cheb_smooth_tile.cu).

#include "cheb_smooth.cuh"

// dtype codes: 0 float32, 1 float64 (K2, K5 real); 2 complex64,
// 3 complex128 (K3, K5 complex).  Fields are (n, nz, ny, nx), nz = 1 for
// nd = 2.  r may be null (no final residual).  x_out, x_tmp, p are scratch
// the caller allocated with the shape of b; x0 is only read.
extern "C" int cheb_smooth(int dtype, const void* w, long long w_bstride,
                           const void* dinv, long long d_bstride,
                           const void* b, const void* x0, const void* theta,
                           const void* delta, int th_stride, void* x_out,
                           void* x_tmp, void* p, void* r, int n, int nz,
                           int ny, int nx, int nd, int degree, int steps,
                           void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch<float>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                       x_out, x_tmp, p, r, n, nz, ny, nx, nd, degree, steps, s);
        case 1: return dispatch<double>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                        x_out, x_tmp, p, r, n, nz, ny, nx, nd, degree, steps, s);
        case 2: return dispatch<float2>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                        x_out, x_tmp, p, r, n, nz, ny, nx, nd, degree, steps, s);
        case 3: return dispatch<double2>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                         x_out, x_tmp, p, r, n, nz, ny, nx, nd, degree, steps, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
