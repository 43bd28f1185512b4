// Fused residual + FEM-L2 quadratic forms for Hopper (sm_90a): K4 and K38
// of the port.
//
// K4 (residual_tet_quad) replaces multigrid_dolfinx_tpu/ops/pallas/
// stencil3d_norm.py residual_tet_quad, for the certified uniform P1 mass:
// q_raw = sum over cells [ sum_{6 Kuhn tets} (sum_{4 corners} r)^2
//                          + sum_{8 corners} count * r^2 ]
// with r = f - A v unmasked (f - (wc v + woff S) inside, f - v on the
// boundary).  This is the exact consistent P1 mass form r^T M r up to the
// factor h^3/120, which the final pass applies.  Bound on the H100:
// memory, v and f read once (8 bytes a point in f32) and nothing
// grid-sized written.  Design: a block owns a TY x TX tile of cell
// anchors and marches up a z segment of them (mg3d::z_split sizes the
// segments from the card's occupancy).  Shared memory holds a ring of v
// planes on the tile's corner points grown by 1 on each side (x0-1 ..
// x0+TX+1), a ring of f planes on the corner points, both filled by
// cp.async DEPTH planes ahead, and two planes of r on the (TY+1) x (TX+1)
// corner points.  Step p, after
// one barrier, derives r at plane p (residual_unmasked_at, the plain
// version's association) and forms the cells between planes p-2 and p-1:
// each thread keeps its cells' four lower corners in registers from the
// step before and reads the four upper ones, so r is derived
// (TY+1)(TX+1) / (TY TX) times a point instead of the 8 times of a
// per-cell design.  Per-cell values are formed in T with the association
// order of stencil3d_norm.py _tet_norm_kernel (cell_value; --fmad=false
// keeps them bitwise equal to the plain version); each thread adds its
// cells in a fixed order into an f64 sum.  The reduction is
// deterministic: each block writes one partial, and a one-block second
// pass adds the partials in a fixed order, with no atomics, so the
// per-cycle check cannot move a cycle count from run to run at the rtol
// threshold.  Plane bases are 64-bit, so K4 takes every lm a card can
// hold.
//
// K38 (residual_mass_quad) replaces multigrid_dolfinx_tpu/ops/pallas/
// stencil3d_norm.py residual_mass_quad (with its _norm_kernel and the jnp
// shell delta _shell_delta_quad): q = sum_p r(p) sum_k T[k][cls(p)]
// r(p + off_k) for any radius-1 class-table operator M (an uncertified
// mass), r the same unmasked residual as K4's and 0 outside the box,
// cls(p) = 9 c_z + 3 c_y + c_x with c_a = 0 / 1 / 2 at the low edge /
// between / the high edge.  The wrapper hands in the tables dense, a
// 27 x 27 array indexed [offset][class] with offset (dz+1)*9 + (dy+1)*3 +
// (dx+1), and the bit mask of the offsets present.  Bound on the H100:
// memory, v and f read once (8 bytes a point in f32), nothing grid-sized
// written: the same work as K4.  Design: a block owns an 8 x 8 x 32 tile;
// it derives r on the tile plus a 1-point halo into shared memory (v read
// with its 2-point halo through L1/L2, 0 outside the box) beside the
// table, then each thread forms r(p) * sum_k T[k][cls(p)] r(p + off_k)
// over the present offsets in offset order, in T, and adds it to an f64
// sum.  Each point takes its exact class, so the TPU kernel's split into
// an interior-class pass and a boundary-shell correction has no
// counterpart.  Blocks reduce to one f64 partial each and K4's one-block
// pass adds them in a fixed order: no atomics, the same bits every run.

#include <cuda_runtime.h>

#include <type_traits>

#include "stencil3d.cuh"

namespace {

constexpr int kFinalThreads = 1024;

// r = f - A v unmasked at (z, y, x), v read through `v`: f - v on the
// boundary, f - (wc v + woff S) inside (stencil3d_norm.py's order).
// kInner: the caller knows the point and its six neighbours are interior.
template <typename T, bool kInner = false, typename At>
__device__ __forceinline__ T residual_unmasked_at(const At& v, T f, int z,
                                                  int y, int x, int lm, T wc,
                                                  T woff) {
    if (!kInner && !mg3d::interior(z, y, x, lm)) return f - v(0, 0, 0);
    return f - (wc * v(0, 0, 0) +
                woff * mg3d::nbr_sum_at<T, kInner>(v, z, y, x, lm));
}

// residual_unmasked_at on contiguous lm^3 arrays.
template <typename T>
__device__ __forceinline__ T residual_unmasked(const T* __restrict__ v,
                                               const T* __restrict__ f, int z,
                                               int y, int x, int lm, T wc,
                                               T woff) {
    const long long p = ((long long)z * lm + y) * lm + x;
    const long long sz = (long long)lm * lm, sy = lm;
    return residual_unmasked_at<T>(mg3d::Flat<T, long long>{v, p, sz, sy},
                                   f[p], z, y, x, lm, wc, woff);
}

// Value of one cell: sum_corners count * r^2 + sum_tets (sum_corners r)^2,
// accumulated in this order.  Corner code = dz*4 + dy*2 + dx.  The tables
// are simplex_vertex_offsets(3, 'right') in its order and each corner's
// tet count in first-appearance order; 'left' mirrors the first axis,
// which flips bit 2 of every code (FLIP = 4).  tests/test_torch_kernels.py
// checks the tables against fem/assembly.py.  Every index is a compile-time
// constant after unrolling, so r[] stays in registers.
template <typename T, int FLIP>
__device__ __forceinline__ T cell_value(const T (&r)[8]) {
    constexpr int tets[6][4] = {{0, 4, 6, 7}, {0, 4, 5, 7}, {0, 2, 6, 7},
                                {0, 2, 3, 7}, {0, 1, 5, 7}, {0, 1, 3, 7}};
    constexpr int corner[8] = {0, 4, 6, 7, 5, 2, 3, 1};
    constexpr int count[8] = {6, 2, 2, 6, 2, 2, 2, 2};
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const T c = r[corner[k] ^ FLIP];
        acc = acc + (T(count[k]) * c) * c;
    }
#pragma unroll
    for (int t = 0; t < 6; ++t) {
        const T s = ((r[tets[t][0] ^ FLIP] + r[tets[t][1] ^ FLIP]) +
                     r[tets[t][2] ^ FLIP]) + r[tets[t][3] ^ FLIP];
        acc = acc + s * s;
    }
    return acc;
}

// K4's shared memory: v planes on the tile's points grown by 2 (the
// anchors' points x0 .. x0+TX and one more on each side), f and r planes
// on its (TY+1) x (TX+1) corner points.
template <typename T, typename S>
struct QuadPlan {
    static constexpr int vh = S::ty + 3, vw = S::tx + 3;
    static constexpr int rh = S::ty + 1, rw = S::tx + 1;
    static constexpr int vsize = vh * vw, rsize = rh * rw;
    // step p reads v planes p-1 .. p+1 and f plane p; rings of a power
    // of two
    static constexpr int vslots = 3 + S::depth <= 4 ? 4 : 8;
    static constexpr int fslots = 1 + S::depth <= 2 ? 2 : 4;
    static_assert(S::depth <= 3, "the rings hold the copies ahead");
    static constexpr int bytes =
        (int)sizeof(T) * (vslots * vsize + (fslots + 2) * rsize);
    static constexpr int nr = (rsize + S::threads - 1) / S::threads;
    static constexpr int cells = S::ty * S::tx / S::threads;   // a thread
};

using QuadShape = mg3d::ZShape<16, 32, 256, 1, 2>;

template <typename T, int FLIP, typename S>
__global__ void __launch_bounds__(S::threads, S::min_blocks)
tet_zmarch_kernel(const T* __restrict__ v, const T* __restrict__ f,
                  double* __restrict__ partials, int lm, int seg, T wc,
                  T woff) {
    using P = QuadPlan<T, S>;
    static_assert(S::ty * S::tx % S::threads == 0, "whole cells a thread");
    static_assert(P::bytes >= S::threads * (int)sizeof(double),
                  "the ring holds the block's reduction");
    // element offsets: v slots, then f slots, then the two r slots
    constexpr int kFBase = P::vslots * P::vsize;
    constexpr int kRBase = kFBase + P::fslots * P::rsize;
    extern __shared__ __align__(16) unsigned char smem[];
    T* const sm = reinterpret_cast<T*>(smem);
    const unsigned sa = mg3d::shared_address(smem);
    const int tid = threadIdx.x, nc = lm - 1;    // cell anchors an axis
    const int x0 = blockIdx.x * S::tx, y0 = blockIdx.y * S::ty;
    const int za = blockIdx.z * seg;
    const int zb = za + seg < nc ? za + seg : nc;   // anchors [za, zb)
    // the corner points lie in [2, lm-3]: they and their neighbours are
    // interior on planes 2 .. lm-3
    const bool inner_xy = x0 >= 2 && x0 + S::tx <= lm - 3 && y0 >= 2 &&
                          y0 + S::ty <= lm - 3;

    mg3d::PlaneCopy<T, P::vh, P::vw, S::threads> vcopy;
    mg3d::PlaneCopy<T, P::rh, P::rw, S::threads> fcopy;
    vcopy.init(y0 - 1, x0 - 1, lm, tid);
    fcopy.init(y0, x0, lm, tid);
    // this thread's corner points (r index tid + k THREADS): the v index
    // of the point, and its row and column (y = lm: none)
    int pv[P::nr], py[P::nr], px[P::nr];
#pragma unroll
    for (int k = 0; k < P::nr; ++k) {
        const int i = tid + k * S::threads;
        const int ry = i / P::rw, rx = i % P::rw;
        pv[k] = (ry + 1) * P::vw + rx + 1;
        py[k] = i < P::rsize && y0 + ry < lm && x0 + rx < lm ? y0 + ry : lm;
        px[k] = x0 + rx;
    }
    auto vo = [](int q) { return (q & (P::vslots - 1)) * P::vsize; };
    auto fo = [](int q) { return kFBase + (q & (P::fslots - 1)) * P::rsize; };
    auto ro = [](int q) { return kRBase + (q & 1) * P::rsize; };
    const unsigned bytes = sizeof(T);
    // group g: v plane g+1 and f plane g, both needed by step g
    auto issue = [&](int g) {
        if (g <= zb) {
            vcopy.issue(sa + vo(g + 1) * bytes, v, g + 1, lm, tid);
            fcopy.issue(sa + fo(g) * bytes, f, g, lm, tid);
        }
        mg3d::cp_async_commit();
    };
    vcopy.issue(sa + vo(za - 1) * bytes, v, za - 1, lm, tid);
    vcopy.issue(sa + vo(za) * bytes, v, za, lm, tid);
    for (int d = 0; d < S::depth; ++d) issue(za + d);

    // r at plane p on the corner points (r index i = tid + k THREADS),
    // residual_unmasked_at's arithmetic, with all checks known true on an
    // inner plane
    auto residuals = [&](auto inner, int p) {
        const T* const lo = sm + vo(p - 1);
        const T* const mid = sm + vo(p);
        const T* const hi = sm + vo(p + 1);
        const T* const fp = sm + fo(p);
        T* const r = sm + ro(p);
#pragma unroll
        for (int k = 0; k < P::nr; ++k) {
            // on an inner tile only the last item can be missing
            if ((!decltype(inner)::value || k == P::nr - 1) && py[k] >= lm)
                continue;
            const int i = tid + k * S::threads;
            const mg3d::Planes3<T> at{lo, mid, hi, pv[k], P::vw};
            r[i] = residual_unmasked_at<T, decltype(inner)::value>(
                at, fp[i], p, py[k], px[k], lm, wc, woff);
        }
    };
    // this thread's cells: bit k set where cell k is on the box
    unsigned cell_on = 0;
#pragma unroll
    for (int k = 0; k < P::cells; ++k) {
        const int i = tid + k * S::threads;
        if (y0 + i / S::tx < nc && x0 + i % S::tx < nc)
            cell_on |= 1u << k;
    }
    const std::true_type in{};
    const std::false_type edge{};
    T lo[P::cells][4];     // r at the lower corners of this thread's cells
    double sum = 0.0;
    for (int p = za; p <= zb + 1; ++p) {
        mg3d::cp_async_wait<S::depth - 1>();
        __syncthreads();
        issue(p + S::depth);
        if (p <= zb) {
            if (inner_xy && p >= 2 && p <= lm - 3)
                residuals(in, p);
            else
                residuals(edge, p);
        }
        if (p > za) {
            // the cells between planes p-2 and p-1 (from p = za + 2);
            // at p = za + 1 only the lower corners, plane za
            const T* const up = sm + ro(p - 1);
#pragma unroll
            for (int k = 0; k < P::cells; ++k) {
                const int i = tid + k * S::threads;
                const int ty = i / S::tx, tx = i % S::tx;
                const int c0 = ty * P::rw + tx;
                const T hi[4] = {up[c0], up[c0 + 1], up[c0 + P::rw],
                                 up[c0 + P::rw + 1]};
                if (p > za + 1 && ((cell_on >> k) & 1u)) {
                    // corner code dz*4 + dy*2 + dx
                    const T r8[8] = {lo[k][0], lo[k][1], lo[k][2], lo[k][3],
                                     hi[0], hi[1], hi[2], hi[3]};
                    sum += (double)cell_value<T, FLIP>(r8);
                }
#pragma unroll
                for (int c = 0; c < 4; ++c) lo[k][c] = hi[c];
            }
        }
    }
    mg3d::cp_async_wait<0>();
    __syncthreads();
    double* const red = reinterpret_cast<double*>(smem);
    red[tid] = sum;
    __syncthreads();
    for (int w = S::threads / 2; w > 0; w >>= 1) {
        if (tid < w) red[tid] += red[tid + w];
        __syncthreads();
    }
    if (tid == 0)
        partials[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                 blockIdx.x] = red[0];
}

__global__ void sum_partials_kernel(const double* __restrict__ partials,
                                    int nparts, double scale,
                                    double* __restrict__ out) {
    __shared__ double red[kFinalThreads];
    double s = 0.0;
    for (int i = threadIdx.x; i < nparts; i += kFinalThreads) s += partials[i];
    red[threadIdx.x] = s;
    __syncthreads();
    for (int w = kFinalThreads / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[0] = red[0] * scale;
}

// K4's grid, column tiles of cell anchors x z segments, and the segment
// length.
struct QuadGrid {
    dim3 grid;
    int seg;
    long long blocks() const { return (long long)grid.x * grid.y * grid.z; }
};

// K4's grid on the current device, set up once a device (both
// diagonals' kernels take the same resources); err reports a refusal.
template <typename T>
QuadGrid tet_quad_grid(int lm, cudaError_t* err) {
    using P = QuadPlan<T, QuadShape>;
    static int wave[mg3d::kMaxDevices];
    const int w = mg3d::device_wave(
        wave, tet_zmarch_kernel<T, 0, QuadShape>,
        tet_zmarch_kernel<T, 4, QuadShape>, QuadShape::threads, P::bytes,
        err);
    const int nc = lm - 1;
    const int tx = (nc + QuadShape::tx - 1) / QuadShape::tx;
    const int ty = (nc + QuadShape::ty - 1) / QuadShape::ty;
    const mg3d::ZSplit split = mg3d::z_split(nc, tx * ty, w > 0 ? w : 1, 2);
    return QuadGrid{dim3(tx, ty, split.count), split.len};
}

template <typename T>
int residual_tet_quad(const T* v, const T* f, double* partials, double* out,
                      int lm, T wc, T woff, int diag, double scale,
                      cudaStream_t stream) {
    using P = QuadPlan<T, QuadShape>;
    cudaError_t err = cudaSuccess;
    const QuadGrid g = tet_quad_grid<T>(lm, &err);
    if (err != cudaSuccess) return (int)err;
    auto kernel = diag == 0 ? tet_zmarch_kernel<T, 0, QuadShape>
                            : tet_zmarch_kernel<T, 4, QuadShape>;
    kernel<<<g.grid, QuadShape::threads, P::bytes, stream>>>(
        v, f, partials, lm, g.seg, wc, woff);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials_kernel<<<1, kFinalThreads, 0, stream>>>(
        partials, (int)g.blocks(), scale, out);
    return (int)cudaGetLastError();
}

constexpr int kMqTx = 32, kMqTy = 8, kMqTz = 8;   // tile (x, y, z)
constexpr int kMqHx = kMqTx + 2, kMqHy = kMqTy + 2, kMqHz = kMqTz + 2;
constexpr int kMqHalo = kMqHx * kMqHy * kMqHz;    // r on the tile + 1 halo
constexpr int kMqThreads = kMqTx * kMqTy;
constexpr int kOffsets = 27, kClasses = 27;

__device__ __forceinline__ int axis_class(int i, int lm) {
    return i == 0 ? 0 : (i == lm - 1 ? 2 : 1);
}

template <typename T>
__global__ void __launch_bounds__(kMqThreads)
mass_quad_partial_kernel(const T* __restrict__ v, const T* __restrict__ f,
                         const T* __restrict__ tables, int mask,
                         double* __restrict__ partials, int lm, T wc,
                         T woff) {
    __shared__ T rs[kMqHalo];
    __shared__ T tbl[kOffsets * kClasses];
    __shared__ double red[kMqThreads];
    const int tid = threadIdx.y * kMqTx + threadIdx.x;
    for (int i = tid; i < kOffsets * kClasses; i += kMqThreads)
        tbl[i] = tables[i];
    const int x0 = blockIdx.x * kMqTx, y0 = blockIdx.y * kMqTy,
              z0 = blockIdx.z * kMqTz;
    for (int i = tid; i < kMqHalo; i += kMqThreads) {
        const int x = x0 - 1 + i % kMqHx;
        const int y = y0 - 1 + (i / kMqHx) % kMqHy;
        const int z = z0 - 1 + i / (kMqHx * kMqHy);
        const bool in = x >= 0 && x < lm && y >= 0 && y < lm && z >= 0 &&
                        z < lm;
        rs[i] = in ? residual_unmasked(v, f, z, y, x, lm, wc, woff) : T(0);
    }
    __syncthreads();
    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    double sum = 0.0;
    if (x < lm && y < lm) {
        const int cyx = 3 * axis_class(y, lm) + axis_class(x, lm);
        for (int tz = 0; tz < kMqTz && z0 + tz < lm; ++tz) {
            const int cls = 9 * axis_class(z0 + tz, lm) + cyx;
            const int c = ((tz + 1) * kMqHy + threadIdx.y + 1) * kMqHx +
                          threadIdx.x + 1;
            T acc = T(0);
#pragma unroll
            for (int k = 0; k < kOffsets; ++k) {
                if ((mask >> k) & 1) {
                    const int dz = k / 9 - 1, dy = k / 3 % 3 - 1,
                              dx = k % 3 - 1;
                    const int nb = c + (dz * kMqHy + dy) * kMqHx + dx;
                    acc = acc + tbl[k * kClasses + cls] * rs[nb];
                }
            }
            sum += (double)(rs[c] * acc);
        }
    }
    red[tid] = sum;
    __syncthreads();
    for (int w = kMqThreads / 2; w > 0; w >>= 1) {
        if (tid < w) red[tid] += red[tid + w];
        __syncthreads();
    }
    if (tid == 0)
        partials[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                 blockIdx.x] = red[0];
}

dim3 mass_quad_grid(int lm) {
    return dim3((lm + kMqTx - 1) / kMqTx, (lm + kMqTy - 1) / kMqTy,
                (lm + kMqTz - 1) / kMqTz);
}

template <typename T>
int residual_mass_quad(const T* v, const T* f, const T* tables, int mask,
                       double* partials, double* out, int lm, T wc, T woff,
                       cudaStream_t stream) {
    const dim3 grid = mass_quad_grid(lm);
    mass_quad_partial_kernel<T><<<grid, dim3(kMqTx, kMqTy), 0, stream>>>(
        v, f, tables, mask, partials, lm, wc, woff);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials_kernel<<<1, kFinalThreads, 0, stream>>>(
        partials, (int)(grid.x * grid.y * grid.z), 1.0, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of doubles the caller must allocate for `partials`: one a block
// of the larger of the f32 and f64 grids.
int mg_tet_quad_partials(int lm) {
    cudaError_t e32 = cudaSuccess, e64 = cudaSuccess;
    const long long n32 = tet_quad_grid<float>(lm, &e32).blocks();
    const long long n64 = tet_quad_grid<double>(lm, &e64).blocks();
    if (e32 != cudaSuccess || e64 != cudaSuccess) return -1;
    return (int)(n32 > n64 ? n32 : n64);
}

// diag: 0 = 'right', 1 = 'left'.  out[0] = scale * q_raw.
int mg_residual_tet_quad_f32(const float* v, const float* f, double* partials,
                             double* out, int lm, float wc, float woff,
                             int diag, double scale, void* stream) {
    return residual_tet_quad<float>(v, f, partials, out, lm, wc, woff, diag,
                                    scale, (cudaStream_t)stream);
}

int mg_residual_tet_quad_f64(const double* v, const double* f,
                             double* partials, double* out, int lm,
                             double wc, double woff, int diag, double scale,
                             void* stream) {
    return residual_tet_quad<double>(v, f, partials, out, lm, wc, woff, diag,
                                     scale, (cudaStream_t)stream);
}

// Number of doubles the caller must allocate for K38's `partials`.
int mg_mass_quad_partials(int lm) {
    const dim3 g = mass_quad_grid(lm);
    return (int)(g.x * g.y * g.z);
}

// tables: 27 x 27 dense [offset][class] in T; mask: bit k set where offset
// k is present.  out[0] = q.
int mg_residual_mass_quad_f32(const float* v, const float* f,
                              const float* tables, int mask, double* partials,
                              double* out, int lm, float wc, float woff,
                              void* stream) {
    return residual_mass_quad<float>(v, f, tables, mask, partials, out, lm, wc,
                                     woff, (cudaStream_t)stream);
}

int mg_residual_mass_quad_f64(const double* v, const double* f,
                              const double* tables, int mask,
                              double* partials, double* out, int lm,
                              double wc, double woff, void* stream) {
    return residual_mass_quad<double>(v, f, tables, mask, partials, out, lm,
                                      wc, woff, (cudaStream_t)stream);
}

}  // extern "C"
