// Arithmetic on the field types of the stencil kernels: real (float,
// double) and interleaved complex (float2, double2, the storage layout of
// torch's complex64/complex128).  R is the matching real type.
//
// Weight planes may be stored narrower than the field (the reference's
// ``weight_dtype``): real weights as __nv_bfloat16, __half or float, complex
// ones as interleaved (re, im) pairs __nv_bfloat162, __half2 or float2.
// f_load widens one stored value to the field type V exactly, as the TPU
// kernel upcasts each plane on load; all arithmetic stays in V.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

template <typename V> struct RealOf;
template <> struct RealOf<float> { using type = float; };
template <> struct RealOf<double> { using type = double; };
template <> struct RealOf<float2> { using type = float; };
template <> struct RealOf<double2> { using type = double; };

__device__ __forceinline__ float f_zero(float) { return 0.0f; }
__device__ __forceinline__ double f_zero(double) { return 0.0; }
__device__ __forceinline__ float2 f_zero(float2) { return make_float2(0.0f, 0.0f); }
__device__ __forceinline__ double2 f_zero(double2) { return make_double2(0.0, 0.0); }

__device__ __forceinline__ float f_add(float a, float b) { return a + b; }
__device__ __forceinline__ double f_add(double a, double b) { return a + b; }
__device__ __forceinline__ float2 f_add(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 f_add(double2 a, double2 b) {
    return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float f_sub(float a, float b) { return a - b; }
__device__ __forceinline__ double f_sub(double a, double b) { return a - b; }
__device__ __forceinline__ float2 f_sub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 f_sub(double2 a, double2 b) {
    return make_double2(a.x - b.x, a.y - b.y);
}

// a * b (complex product for the interleaved types)
__device__ __forceinline__ float f_mul(float a, float b) { return a * b; }
__device__ __forceinline__ double f_mul(double a, double b) { return a * b; }
__device__ __forceinline__ float2 f_mul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 f_mul(double2 a, double2 b) {
    return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// s * a for a real scalar s
__device__ __forceinline__ float f_scal(float s, float a) { return s * a; }
__device__ __forceinline__ double f_scal(double s, double a) { return s * a; }
__device__ __forceinline__ float2 f_scal(float s, float2 a) {
    return make_float2(s * a.x, s * a.y);
}
__device__ __forceinline__ double2 f_scal(double s, double2 a) {
    return make_double2(s * a.x, s * a.y);
}

// a / s for a real scalar s
__device__ __forceinline__ float f_rdiv(float a, float s) { return a / s; }
__device__ __forceinline__ double f_rdiv(double a, double s) { return a / s; }
__device__ __forceinline__ float2 f_rdiv(float2 a, float s) {
    return make_float2(a.x / s, a.y / s);
}
__device__ __forceinline__ double2 f_rdiv(double2 a, double s) {
    return make_double2(a.x / s, a.y / s);
}

// a stored weight as a value of the field type V (exact widening; the
// identity when the weight is stored as V)
template <typename V>
__device__ __forceinline__ V f_load(V, V w) { return w; }
__device__ __forceinline__ float f_load(float, __nv_bfloat16 w) {
    return __bfloat162float(w);
}
__device__ __forceinline__ float f_load(float, __half w) {
    return __half2float(w);
}
__device__ __forceinline__ double f_load(double, __nv_bfloat16 w) {
    return (double)__bfloat162float(w);
}
__device__ __forceinline__ double f_load(double, __half w) {
    return (double)__half2float(w);
}
__device__ __forceinline__ double f_load(double, float w) {
    return (double)w;
}
__device__ __forceinline__ float2 f_load(float2, __nv_bfloat162 w) {
    return make_float2(__bfloat162float(w.x), __bfloat162float(w.y));
}
__device__ __forceinline__ float2 f_load(float2, __half2 w) {
    return make_float2(__half2float(w.x), __half2float(w.y));
}
__device__ __forceinline__ double2 f_load(double2, __nv_bfloat162 w) {
    return make_double2((double)__bfloat162float(w.x),
                        (double)__bfloat162float(w.y));
}
__device__ __forceinline__ double2 f_load(double2, __half2 w) {
    return make_double2((double)__half2float(w.x),
                        (double)__half2float(w.y));
}
__device__ __forceinline__ double2 f_load(double2, float2 w) {
    return make_double2((double)w.x, (double)w.y);
}

// y(iz, iy, ix) = sum_k w[k](iz, iy, ix) * x(iz + dz_k, iy + dy_k, ix + dx_k),
// zero outside the grid; offsets k run ([dz,] dy, dx) lexicographically
// over [-D, D]^ND, the order of stencil_offsets() in ops/stencil.py.  A
// 2-D grid is the case ND = 2, nz = 1, iz = 0 (no z offsets).  w points at
// the first of the K = (2D+1)^ND weight volumes of this batch entry, x at
// its field volume.  The weights are stored as Wt (V, or a narrower type
// that f_load widens); offsets into w count elements of Wt.
template <int ND, int D, typename V, typename Wt>
__device__ __forceinline__ V stencil_at(const Wt* __restrict__ w,
                                        const V* __restrict__ x, int iz,
                                        int iy, int ix, int nz, int ny,
                                        int nx) {
    // ND = 2 compiles to the plain 2-D stencil: one plane, no z terms
    constexpr int DZ = ND == 3 ? D : 0;
    // the dz and dy loops unroll fully up to K = 125; at K = 343 (3-D,
    // degree 3) only the dx loop does: 343 unrolled terms in each of the
    // 32 kernels that instantiate it took the build from 45 s to 71 s,
    // and the kernels stream their weights from device memory either way
    constexpr int UNROLL = ND == 3 && D >= 3 ? 1 : 2 * D + 1;
    const size_t vol = (size_t)(ND == 3 ? nz : 1) * ny * nx;
    const size_t node = ((size_t)(ND == 3 ? iz : 0) * ny + iy) * nx + ix;
    V acc = f_zero(V());
    int k = 0;
#pragma unroll UNROLL
    for (int dz = -DZ; dz <= DZ; ++dz) {
        const int z = (ND == 3 ? iz : 0) + dz;
#pragma unroll UNROLL
        for (int dy = -D; dy <= D; ++dy) {
            const int y = iy + dy;
#pragma unroll
            for (int dx = -D; dx <= D; ++dx, ++k) {
                const int xx = ix + dx;
                if ((ND == 2 || (z >= 0 && z < nz)) && y >= 0 && y < ny &&
                    xx >= 0 && xx < nx) {
                    acc = f_add(acc, f_mul(f_load(V(), w[k * vol + node]),
                                           x[((size_t)z * ny + y) * nx + xx]));
                }
            }
        }
    }
    return acc;
}
