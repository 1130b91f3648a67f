// Arithmetic on the field types of the stencil kernels: real (float,
// double) and interleaved complex (float2, double2, the storage layout of
// torch's complex64/complex128).  R is the matching real type.
#pragma once

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

// y(iy, ix) = sum_k w[k](iy, ix) * x(iy + dy_k, ix + dx_k), zero outside
// the grid; offsets k run (dy, dx) lexicographically over [-D, D]^2, the
// order of stencil_offsets() in ops/stencil.py.  w points at the first of
// the K = (2D+1)^2 weight planes of this batch entry, x at its field plane.
template <int D, typename V>
__device__ __forceinline__ V stencil_at(const V* __restrict__ w,
                                        const V* __restrict__ x,
                                        int iy, int ix, int ny, int nx) {
    const size_t plane = (size_t)ny * nx;
    const size_t node = (size_t)iy * nx + ix;
    V acc = f_zero(V());
    int k = 0;
#pragma unroll
    for (int dy = -D; dy <= D; ++dy) {
        const int y = iy + dy;
#pragma unroll
        for (int dx = -D; dx <= D; ++dx, ++k) {
            const int xx = ix + dx;
            if (y >= 0 && y < ny && xx >= 0 && xx < nx) {
                acc = f_add(acc, f_mul(w[k * plane + node],
                                       x[(size_t)y * nx + xx]));
            }
        }
    }
    return acc;
}
