// K4 and K5v: fused Chebyshev-Jacobi smoothing on vector fields (the
// velocity mass solves and V-cycles of the incompressible problems), plus
// the final residual r = b - A x.  K4 takes 2-D fields with two components
// per node, K5v 3-D fields with three.
//
// K4 replaces control_tpu/ops/stencil.py:_fused_cheb_vector; K5v replaces
// control_tpu/ops/stencil.py:_fused_cheb_nd3 on vector spaces (C = dim = 3
// of its coupled real form, _coupled_form_3d).  The operator is a node
// stencil with a dim x dim coupling block per offset per node:
//
//   (A x)_r(node) = sum_k sum_c w[k, node, r, c] * x[node + off_k, c]
//
// and, per batch entry i with sigma = theta_i / delta_i, the recurrence is
// that of K2 (cheb_smooth.cu) with a Jacobi diagonal per component:
//
//   step 0:   r = b - A x0;  p = (r * dinv) / theta;  x = x0 + p
//   step s:   r = b - A x;   rho' = 1 / (2 sigma - rho)
//             p = rho' rho p + (2 rho' / delta) (r * dinv);  x = x + p
//   final:    r = b - A x
//
// Layout.  Nothing is split into planes as on the TPU: a field
// (n, [nz,] ny, nx, dim) is dim consecutive reals per node, and the block
// of offset k at a node is dim * dim consecutive reals of torch's
// (K, [nz,] ny, nx, dim, dim) weights.  K4 reads a block as one float4 (two
// double2) and a node's pair as one float2 (double2); K5v's 36/72-byte
// blocks are not 16-byte aligned and are read as scalars.  Neighbouring
// lanes own neighbouring nodes (32 consecutive nodes of the flattened grid
// a block), so every read coalesces.
//
// What bounds it on the H100, per step: K5v's degree-2 weights, 323 MB in
// float64 at 33^3 nodes, stream from HBM (0.097 ms a pass at 3.35 TB/s);
// K4's, 13.3 MB at 129^2, stay in the 50 MB L2, and there the fields (b,
// dinv, p read and written, x read and written: 41 MB at (31, 129^2) in
// float64) and the neighbour reads of x weigh as much as the weights.  The
// arithmetic is 2 dim^2 flops per block per batch entry, below the card's
// float64 ridge for any batch of eight or fewer, so bytes, not tensor
// cores, are the lever.  Every step reads the neighbours' previous
// iterate, and a node's weights (9 KB at K5v's degree 2) do not fit a
// block's shared memory across steps, so each step is one launch, with x
// ping-ponged between two buffers and p updated in place.
//
// The design has two levers, both template parameters picked by shape in
// the C entry points (never after a failed launch):
//
// * NB, the batch width.  With shared weights (w_bstride == 0: the mass
//   solves, n = n_t - 1 fields) a thread owns one node for NB batch
//   entries: it loads each coupling block once and applies it to NB
//   fields, with NB sets of accumulators in registers.  The batch is
//   walked in chunks of NB, each chunk a block of its own; a ragged last
//   chunk reads the last real entry again for its missing ones and stores
//   nothing for them (nothing is padded in memory).  The chunk is the
//   fastest-varying block index, so the chunks of one tile of nodes run
//   together and share their weight reads through L2.  One HBM pass of
//   the weights per step serves the whole batch, where a thread per node
//   and entry makes one per batch entry (K5v at (7, 33^3): 20 passes
//   instead of 140).
//   Per-batch weights and unbatched fields take NB = 1.
// * S, the split of a node's sum.  The (2D+1)^(nd-1) rows of offsets
//   ((dz, dy) pairs in 3-D, dy in 2-D; the dx loop inside a row is
//   unrolled) are shared out over S warps of a block, all on the same 32
//   nodes: S = W = 2D + 1, one dz plane (3-D) or one dy row (2-D) a warp,
//   or S = 1.  Each warp leaves its partial sums in shared memory and,
//   after one barrier, the block adds the S partials in a fixed order and
//   finishes the update: no atomics, so two identical calls give
//   identical bits.  The split gives the small unbatched V-cycle levels W
//   times the warps in flight (17^3: 770 warps where a thread per node in
//   (32, 8) tiles has about 150), and the loads of a row are independent,
//   so they are issued together.
//
// The entry points run only the variants that pick() below chooses by
// shape, 30 kernels over both dtypes and degrees: K5v NB the smallest of
// 2, 4, 8 that holds the batch (8 beyond), S = W; K4 batches the width of
// 2, 4, 8 (4 in float32) that pads the fewest entries, S = 1; per-batch
// weights and one field NB = 1, S = W.  The choice was made by timing
// forced variants against each other on the card; a split of every
// (dz, dy) row to its own warp (S = W^2), staging a row's neighbours in
// shared memory, and widths of 16 did not pay.  The recurrence's
// coefficients of the later steps are tabulated once per call by one warp
// of the first launch, so no other thread runs the recurrence (step 0
// divides by theta, as the plain version does).
//
// Times on an NVIDIA H100 80GB HBM3 at 700 W, float64, with the earlier
// design (a thread per node and entry, (32, 8) tiles) timed in the same
// call in parentheses (profile_slice.py vector; PERF.md section 6): K5v
// (7, 33^3, 3), 20 steps, 2.67 ms (13.84) against a floor of 1.93; its
// V-cycle levels 33^3 0.96 ms (1.20, floor 0.87) and 17^3 0.12 (0.67); K4
// (31, 129^2, 2), 20 steps, 0.77 ms (1.33), above its 0.18 floor: the
// weights no longer bound it, its five field streams and the neighbour
// reads of x share the rest; K4's levels take half (129^2) to a third
// (65^2) of the earlier device time, and their calls are bound by the
// wrapper's host work (100-160 us a call in either design).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;   // nodes per block, one per lane

// a 2 x 2 coupling block (row-major) in one 16-byte (two 16-byte) loads
__device__ __forceinline__ void load_block(const float* __restrict__ w,
                                           float (&c)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(w);
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
}

__device__ __forceinline__ void load_block(const double* __restrict__ w,
                                           double (&c)[4]) {
    const double2 a = *reinterpret_cast<const double2*>(w);
    const double2 b = *reinterpret_cast<const double2*>(w + 2);
    c[0] = a.x;
    c[1] = a.y;
    c[2] = b.x;
    c[3] = b.y;
}

// a 3 x 3 block: nine scalar loads
template <typename R>
__device__ __forceinline__ void load_block(const R* __restrict__ w,
                                           R (&c)[9]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) c[i] = w[i];
}

// a node's components, one pair load (2-D) or three scalars (3-D), and
// their store
__device__ __forceinline__ void load_node(const float* __restrict__ x,
                                          float (&v)[2]) {
    const float2 a = *reinterpret_cast<const float2*>(x);
    v[0] = a.x;
    v[1] = a.y;
}

__device__ __forceinline__ void load_node(const double* __restrict__ x,
                                          double (&v)[2]) {
    const double2 a = *reinterpret_cast<const double2*>(x);
    v[0] = a.x;
    v[1] = a.y;
}

template <typename R>
__device__ __forceinline__ void load_node(const R* __restrict__ x,
                                          R (&v)[3]) {
    v[0] = x[0];
    v[1] = x[1];
    v[2] = x[2];
}

__device__ __forceinline__ void store_node(float* __restrict__ x,
                                           const float (&v)[2]) {
    *reinterpret_cast<float2*>(x) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ void store_node(double* __restrict__ x,
                                           const double (&v)[2]) {
    *reinterpret_cast<double2*>(x) = make_double2(v[0], v[1]);
}

template <typename R>
__device__ __forceinline__ void store_node(R* __restrict__ x,
                                           const R (&v)[3]) {
    x[0] = v[0];
    x[1] = v[1];
    x[2] = v[2];
}

// The recurrence's coefficients, p' = keep p + gain (r * dinv), of steps
// 1 .. steps - 1 of every entry with bounds of its own (ne = 1 for scalar
// bounds): coef[2 ((s - 1) ne + e) + {0, 1}], one warp's lanes over the
// entries.  rho follows K2's recurrence in the same order of operations;
// tabulating it once keeps the divisions and a loop over the steps out of
// every other thread.
template <typename R>
__device__ __noinline__ void cheb_coeffs(const R* __restrict__ theta,
                                         const R* __restrict__ delta, int ne,
                                         int steps, R* __restrict__ coef,
                                         int lane) {
    for (int e = lane; e < ne; e += LANES) {
        const R th = theta[e], de = delta[e];
        const R sigma = th / de;
        R rho = R(1) / sigma;
        for (int s = 1; s < steps; ++s) {
            const R rho_new = R(1) / (R(2) * sigma - rho);
            coef[2 * ((size_t)(s - 1) * ne + e)] = rho_new * rho;
            coef[2 * ((size_t)(s - 1) * ne + e) + 1] = R(2) * rho_new / de;
            rho = rho_new;
        }
    }
}

// One Chebyshev step (step >= 0: p and x_new from x_old) or the residual
// (step < 0: r = b - A x_old) for 32 nodes and NB batch entries; block
// (LANES, S).  Offsets run ([dz,] dy, dx) lexicographically over
// [-D, D]^ND, the order of stencil_offsets() in ops/stencil.py; a row is
// the W offsets of one ([dz,] dy); warp s owns rows [s RPW, (s+1) RPW).
// Fields are zero outside the grid.  A 2-D grid is ND = 2, nz = 1.
template <int ND, int D, typename R, int NB, int S>
__global__ void __launch_bounds__(LANES * S)
vector_cheb_kernel(const R* __restrict__ w, long long w_bstride,
                   const R* __restrict__ dinv, long long d_bstride,
                   const R* __restrict__ b, const R* __restrict__ x_old,
                   R* __restrict__ x_new, R* __restrict__ p,
                   R* __restrict__ r, const R* __restrict__ theta,
                   const R* __restrict__ delta, int th_stride,
                   R* __restrict__ coef, int steps, int n, int nchunks,
                   int nz, int ny, int nx, int step) {
    constexpr int DIM = ND;
    constexpr int W = 2 * D + 1;
    constexpr int ROWS = ND == 3 ? W * W : W;
    constexpr int RPW = ROWS / S;
    static_assert(ROWS % S == 0, "the split divides the rows of offsets");
    const int lane = threadIdx.x;
    const int s = threadIdx.y;
    // the first launch tabulates the later steps' coefficients (its own
    // step divides by theta); launches in order see the table
    if (step == 0 && blockIdx.x == 0 && s == 0)
        cheb_coeffs(theta, delta, th_stride ? n : 1, steps, coef, lane);
    // the batch chunk varies fastest: the chunks of one tile run together
    const int chunk = (int)(blockIdx.x % (unsigned)nchunks);
    const int tile = (int)(blockIdx.x / (unsigned)nchunks);
    const size_t vol = (size_t)nz * ny * nx;
    const int node = tile * LANES + lane;
    const bool valid = (size_t)node < vol;
    int ix = 0, iy = 0, iz = 0;
    if (valid) {
        const int t = node / nx;
        ix = node - t * nx;
        iy = t % ny;
        iz = t / ny;
    }
    const int b0 = chunk * NB;
    // entries b0 .. b0 + last are real; the rest of a ragged chunk reads
    // entry b0 + last again and stores nothing
    const int last = min(NB, n - b0) - 1;
    // w_bstride is 0 for shared weights; per-batch weights run NB = 1
    const R* __restrict__ wc = w + (size_t)b0 * (size_t)w_bstride;
    size_t xoff[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j)
        xoff[j] = (size_t)(b0 + min(j, last)) * vol * DIM;

    R acc[NB][DIM];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int a = 0; a < DIM; ++a) acc[j][a] = R(0);

    if (valid) {
#pragma unroll 1
        for (int q = 0; q < RPW; ++q) {
            const int row = s * RPW + q;
            const int z = iz + (ND == 3 ? row / W - D : 0);
            const int y = iy + row % W - D;
            if (z < 0 || z >= nz || y < 0 || y >= ny) continue;
            const size_t xrow = ((size_t)z * ny + y) * nx;
            const R* __restrict__ wrow =
                wc + ((size_t)row * W * vol + node) * (DIM * DIM);
            // one field: the row's W blocks first, all their loads in
            // flight together (the unbatched levels are latency-bound;
            // a node has weights for every offset, so the loads need no
            // bounds); a batch keeps its NB accumulator sets and loads a
            // block as it goes (hoisting costs it registers and speed)
            R c[NB == 1 ? W : 1][DIM * DIM];
            if constexpr (NB == 1) {
#pragma unroll
                for (int i = 0; i < W; ++i)
                    load_block(wrow + (size_t)i * vol * (DIM * DIM), c[i]);
            }
#pragma unroll
            for (int i = 0; i < W; ++i) {
                const int xx = ix + i - D;
                if (xx < 0 || xx >= nx) continue;
                const int ci = NB == 1 ? i : 0;
                if constexpr (NB > 1)
                    load_block(wrow + (size_t)i * vol * (DIM * DIM), c[0]);
                const size_t xi = (xrow + xx) * DIM;
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    R v[DIM];
                    load_node(x_old + xoff[j] + xi, v);
#pragma unroll
                    for (int a = 0; a < DIM; ++a)
#pragma unroll
                        for (int e = 0; e < DIM; ++e)
                            acc[j][a] += c[ci][a * DIM + e] * v[e];
                }
            }
        }
    }

    // batch entry b0 + j at this node, all components, given A x
    auto finish = [&](int j, const R (&ax)[DIM]) {
        if (!valid || j > last) return;
        const size_t bi = (size_t)(b0 + j);
        const size_t at = (bi * vol + node) * DIM;
        R res[DIM];
        load_node(b + at, res);
#pragma unroll
        for (int a = 0; a < DIM; ++a) res[a] -= ax[a];
        if (step < 0) {
            store_node(r + at, res);
            return;
        }
        const int e = th_stride ? b0 + j : 0;
        R keep = R(0), gain = R(0);
        if (step > 0) {
            // this step's coefficients, tabulated by the first launch
            const size_t ne = th_stride ? n : 1;
            const R* cf = coef + 2 * ((size_t)(step - 1) * ne + e);
            keep = cf[0];
            gain = cf[1];
        }
        R dv[DIM], pv[DIM], xv[DIM];
        load_node(dinv + bi * (size_t)d_bstride + (size_t)node * DIM, dv);
        load_node(x_old + at, xv);
        if (step > 0) load_node(p + at, pv);
#pragma unroll
        for (int a = 0; a < DIM; ++a) {
            const R zv = res[a] * dv[a];
            // step 0: z / theta, as the plain version divides
            pv[a] = step == 0 ? zv / theta[e] : keep * pv[a] + gain * zv;
            xv[a] += pv[a];
        }
        store_node(p + at, pv);
        store_node(x_new + at, xv);
    };

    if constexpr (S == 1) {
#pragma unroll
        for (int j = 0; j < NB; ++j) finish(j, acc[j]);
    } else {
        // each warp's partial sums; the block adds them in warp order
        __shared__ R part[S][NB * DIM][LANES];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int a = 0; a < DIM; ++a)
                part[s][j * DIM + a][lane] = acc[j][a];
        __syncthreads();
        for (int j = s; j < NB; j += S) {
            R sum[DIM];
#pragma unroll
            for (int a = 0; a < DIM; ++a) {
                sum[a] = part[0][j * DIM + a][lane];
#pragma unroll
                for (int t = 1; t < S; ++t)
                    sum[a] += part[t][j * DIM + a][lane];
            }
            finish(j, sum);
        }
    }
}

// the arguments of one smoothing call (see the C entry points below)
struct Call {
    const void* w;
    long long w_bstride;
    const void* dinv;
    long long d_bstride;
    const void* b;
    const void* x0;
    const void* theta;
    const void* delta;
    int th_stride;
    void* coef;
    void* x_out;
    void* x_tmp;
    void* p;
    void* r;
    int n, nz, ny, nx, steps;
};

// steps launches (the last lands in x_out) and, if r is set, the residual
template <int ND, int D, typename R, int NB, int S>
int run(const Call& c, cudaStream_t stream) {
    const int nchunks = (c.n + NB - 1) / NB;
    const long long vol = (long long)c.nz * c.ny * c.nx;
    const long long blocks = (vol + LANES - 1) / LANES * nchunks;
    if (vol > INT_MAX - LANES || blocks > INT_MAX)
        return (int)cudaErrorInvalidValue;
    const dim3 block(LANES, S);
    const dim3 grid((unsigned)blocks);
    const R* w = static_cast<const R*>(c.w);
    const R* dinv = static_cast<const R*>(c.dinv);
    const R* b = static_cast<const R*>(c.b);
    R* coef = static_cast<R*>(c.coef);
    R* x_out = static_cast<R*>(c.x_out);
    R* x_tmp = static_cast<R*>(c.x_tmp);
    R* p = static_cast<R*>(c.p);
    const R* th = static_cast<const R*>(c.theta);
    const R* de = static_cast<const R*>(c.delta);
    const int nsteps = c.steps < 1 ? 1 : c.steps;
    const R* x_in = static_cast<const R*>(c.x0);
    for (int s = 0; s < nsteps; ++s) {
        R* x_dst = ((nsteps - 1 - s) % 2 == 0) ? x_out : x_tmp;
        vector_cheb_kernel<ND, D, R, NB, S><<<grid, block, 0, stream>>>(
            w, c.w_bstride, dinv, c.d_bstride, b, x_in, x_dst, p, nullptr,
            th, de, c.th_stride, coef, nsteps, c.n, nchunks, c.nz, c.ny,
            c.nx, s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        x_in = x_dst;
    }
    if (c.r != nullptr) {
        vector_cheb_kernel<ND, D, R, NB, S><<<grid, block, 0, stream>>>(
            w, c.w_bstride, dinv, c.d_bstride, b, x_out, nullptr, nullptr,
            static_cast<R*>(c.r), th, de, c.th_stride, coef, nsteps, c.n,
            nchunks, c.nz, c.ny, c.nx, -1);
    }
    return (int)cudaGetLastError();
}

// The variant by shape (from the variants timed against each other on
// the card): one entry a thread (NB = 1) for per-batch weights or one
// field, its node's sum split over W warps.  With shared weights, K5v
// streams its weights from HBM, so the fewest chunks win: the smallest of
// 2, 4, 8 that holds the batch, 8 beyond, split over W warps.  K4's
// weights stay in L2 and a padded entry costs as much as a real one, so
// it takes the width of 2, 4 and 8 (4 in float32) that pads the fewest
// entries, the larger one on a tie, and a thread sums its node alone.
template <int ND, int D, typename R>
int pick(const Call& c, cudaStream_t stream) {
    constexpr int W = 2 * D + 1;
    if (c.w_bstride != 0 || c.n == 1) return run<ND, D, R, 1, W>(c, stream);
    if constexpr (ND == 3) {
        if (c.n <= 2) return run<ND, D, R, 2, W>(c, stream);
        if (c.n <= 4) return run<ND, D, R, 4, W>(c, stream);
        return run<ND, D, R, 8, W>(c, stream);
    } else {
        const int pad2 = (c.n + 1) / 2 * 2, pad4 = (c.n + 3) / 4 * 4;
        if constexpr (sizeof(R) == 8) {
            if ((c.n + 7) / 8 * 8 <= pad2 && (c.n + 7) / 8 * 8 <= pad4)
                return run<ND, D, R, 8, 1>(c, stream);
        }
        if (pad4 <= pad2) return run<ND, D, R, 4, 1>(c, stream);
        return run<ND, D, R, 2, 1>(c, stream);
    }
}

template <int ND, typename R>
int dispatch(const Call& c, int degree, cudaStream_t stream) {
    if (c.n < 1 || c.nz < 1 || c.ny < 1 || c.nx < 1)
        return (int)cudaErrorInvalidValue;
    // K4 reads a block with 16-byte loads and a node's pair with 8-
    // (double: 16-) byte loads
    const size_t pair = 2 * sizeof(R);
    if (ND == 2 &&
        (c.w_bstride % 4 != 0 || c.d_bstride % 2 != 0 ||
         (size_t)c.w % 16 != 0 || (size_t)c.dinv % pair != 0 ||
         (size_t)c.b % pair != 0 || (size_t)c.x0 % pair != 0 ||
         (size_t)c.x_out % pair != 0 || (size_t)c.x_tmp % pair != 0 ||
         (size_t)c.p % pair != 0 || (size_t)c.r % pair != 0))
        return (int)cudaErrorInvalidValue;
    if (degree == 1) return pick<ND, 1, R>(c, stream);
    if (degree == 2) return pick<ND, 2, R>(c, stream);
    return (int)cudaErrorInvalidValue;
}

template <int ND>
int entry(int dtype, const Call& c, int degree, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch<ND, float>(c, degree, s);
        case 1: return dispatch<ND, double>(c, degree, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// K4.  dtype codes: 0 float32, 1 float64.  Fields are (n, ny, nx, 2),
// weights (K, ny, nx, 2, 2) per batch entry; w_bstride and d_bstride count
// reals between batch entries (0: shared); theta and delta are one value
// (th_stride 0) or one per entry (th_stride 1).  r may be null (no final
// residual).  x_out, x_tmp, p are scratch the caller allocated with the
// shape of b, coef scratch of 2 * max(steps - 1, 1) * (th_stride ? n : 1)
// reals; x0 is only read.  The variant follows from the shape (pick).
extern "C" int cheb_smooth_vector(int dtype, const void* w,
                                  long long w_bstride, const void* dinv,
                                  long long d_bstride, const void* b,
                                  const void* x0, const void* theta,
                                  const void* delta, int th_stride,
                                  void* coef, void* x_out, void* x_tmp,
                                  void* p, void* r, int n, int ny, int nx,
                                  int degree, int steps, void* stream) {
    const Call c{w, w_bstride, dinv, d_bstride, b, x0, theta, delta,
                 th_stride, coef, x_out, x_tmp, p, r, n, 1, ny, nx, steps};
    return entry<2>(dtype, c, degree, stream);
}

// K5v.  The same contract on 3-D fields (n, nz, ny, nx, 3) with weights
// (K, nz, ny, nx, 3, 3) per batch entry.
extern "C" int cheb_smooth_vector3d(int dtype, const void* w,
                                    long long w_bstride, const void* dinv,
                                    long long d_bstride, const void* b,
                                    const void* x0, const void* theta,
                                    const void* delta, int th_stride,
                                    void* coef, void* x_out, void* x_tmp,
                                    void* p, void* r, int n, int nz, int ny,
                                    int nx, int degree, int steps,
                                    void* stream) {
    const Call c{w, w_bstride, dinv, d_bstride, b, x0, theta, delta,
                 th_stride, coef, x_out, x_tmp, p, r, n, nz, ny, nx,
                 steps};
    return entry<3>(dtype, c, degree, stream);
}
