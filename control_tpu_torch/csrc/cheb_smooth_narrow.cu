// K2, K3 and K5 (real and complex) with narrow weight planes: the
// reference's ``weight_dtype`` storage (control_tpu/ops/stencil.py,
// fused_cheb_smooth :547, _fused_cheb_complex :647 and _fused_cheb_nd3 :980
// keep w and dinv in ``wdt`` and upcast each plane on load).  The same
// kernels as cheb_smooth.cu (cheb_smooth.cuh), instantiated with a weight
// storage type Wt narrower than the field's real type; each weight and
// dinv value is widened on load and the recurrence runs in the field type.
// Bound: device-memory bandwidth, as the full-precision kernels; a bf16 or
// f16 plane under float32 fields halves the weight bytes of each step.

#include "cheb_smooth.cuh"

namespace {

// weight codes: 0 bfloat16, 1 float16, 2 float32 (under float64 fields);
// complex fields take (re, im) pairs of the same type
template <typename V, typename B, typename H, typename F>
int by_weight(int wdtype, const void* w, long long w_bstride,
              const void* dinv, long long d_bstride, const void* b,
              const void* x0, const void* theta, const void* delta,
              int th_stride, void* x_out, void* x_tmp, void* p, void* r,
              int n, int nz, int ny, int nx, int nd, int degree, int steps,
              cudaStream_t s) {
    switch (wdtype) {
        case 0: return dispatch<V, B>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                      x_out, x_tmp, p, r, n, nz, ny, nx, nd, degree, steps, s);
        case 1: return dispatch<V, H>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                      x_out, x_tmp, p, r, n, nz, ny, nx, nd, degree, steps, s);
        case 2:
            // a float32 weight is narrower only under float64 fields
            if constexpr (sizeof(F) < sizeof(V))
                return dispatch<V, F>(w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride,
                                      x_out, x_tmp, p, r, n, nz, ny, nx, nd, degree, steps, s);
            return (int)cudaErrorInvalidValue;
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: the field codes of cheb_smooth (0 float32, 1 float64, 2 complex64,
// 3 complex128); wdtype: the weight storage code above.  w and dinv hold
// Wt values (pairs for complex fields) with strides counted in them; every
// other argument as for cheb_smooth.
extern "C" int cheb_smooth_narrow(int dtype, int wdtype, const void* w,
                                  long long w_bstride, const void* dinv,
                                  long long d_bstride, const void* b,
                                  const void* x0, const void* theta,
                                  const void* delta, int th_stride,
                                  void* x_out, void* x_tmp, void* p, void* r,
                                  int n, int nz, int ny, int nx, int nd,
                                  int degree, int steps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return by_weight<float, __nv_bfloat16, __half, float>(
            wdtype, w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride, x_out, x_tmp, p,
            r, n, nz, ny, nx, nd, degree, steps, s);
        case 1: return by_weight<double, __nv_bfloat16, __half, float>(
            wdtype, w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride, x_out, x_tmp, p,
            r, n, nz, ny, nx, nd, degree, steps, s);
        case 2: return by_weight<float2, __nv_bfloat162, __half2, float2>(
            wdtype, w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride, x_out, x_tmp, p,
            r, n, nz, ny, nx, nd, degree, steps, s);
        case 3: return by_weight<double2, __nv_bfloat162, __half2, float2>(
            wdtype, w, w_bstride, dinv, d_bstride, b, x0, theta, delta, th_stride, x_out, x_tmp, p,
            r, n, nz, ny, nx, nd, degree, steps, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
