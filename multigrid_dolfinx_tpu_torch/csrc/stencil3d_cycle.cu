// Cycle-step fusion kernels for Hopper (sm_90a): K35-K37 of the port.
//
//   K35 rb_sweep2 replaces multigrid_dolfinx_tpu/ops/pallas/stencil3d.py
//       rb_sweep2_fused: two red-black Gauss-Seidel sweeps in one launch,
//       bitwise K1 after K1.
//   K36 rb_residual_restrict replaces stencil3d_cycle.py
//       rb_residual_restrict_fused: one red-black sweep, the masked
//       residual and the variational P^T restriction in one launch,
//       bitwise K2 after K1 (and K1's v).
//   K37 prolong_correct_rb replaces stencil3d_cycle.py
//       prolong_correct_rb_fused: v + P(c) and one red-black sweep in one
//       launch, bitwise K1 after K3.
//
// Storage is the logical lm^3 node box, C-order (z, y, x), contiguous and
// unpadded; the coarse box is lmc^3 with lm = 2 lmc - 1.
//
// Bound: memory.  Each kernel must read v and f once and write v once
// (K36 also writes the coarse right-hand side, K37 also reads the coarse
// correction); the chain it replaces moves v and f once per launch.
//
// Design: one thread block per output tile of fine points (the Shape
// below, per kernel).  The block copies v over the tile grown by a halo
// of h points on
// every side into shared memory (0 outside the box) and runs the
// red-black colours in place there, each on a region one point smaller
// than the one before (the dependency pyramid of the JAX kernels): a
// point of one colour needs the other colour only at +-1.
//   K35: h = 4; red over the tile + 3, black + 2, red + 1, black + 0.
//   K36: h = 4; red + 3, black + 2; then K2's restriction of the masked
//        residual at fine 2I +- 1, which reads the swept v at 2I +- 2.
//        The block owns the coarse tile whose fine points 2I, 2I + 1 make
//        up its fine tile, so every coarse point is computed in exactly
//        one block.
//   K37: h = 2; v + P(c) over the tile + 2 from the coarse footprint
//        copied to shared memory, red + 1, black + 0.
// f is read from global memory at the point being updated (each point at
// most twice a launch, through L1/L2).  Each point goes through the
// helpers of K1-K3 (stencil3d.cuh: rb_candidate, masked_residual_at,
// restrict_combine, prolong_point_at) reading the windows, and the library
// is built with --fmad=false, so the results are bitwise the unfused
// chain's: red-black Gauss-Seidel does not depend on the order of the
// points within a colour.  Point indices are 32-bit (lm <= 1290, checked
// by the Python wrappers).
//
// Each entry point is a plain C function: it launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include "stencil3d.cuh"

namespace {

using mg3d::Flat;

// A kernel's output tile, TZ x TY x TX fine points, and its block size,
// each the fastest of the shapes scripts/fusion_tiles.py times at 513^3
// f32: larger tiles cut the pyramid's redundant work, more threads a
// block keep the stages busy; K36's restriction tail runs best on the
// smaller tile.  At these sizes every f64 window fits the 227 KB a block
// can have.
template <int TZ, int TY, int TX, int THREADS>
struct Shape {
    static constexpr int tz = TZ, ty = TY, tx = TX, threads = THREADS;
};
using Sweep2Shape = Shape<16, 16, 32, 1024>;     // K35
using RestrictShape = Shape<8, 16, 32, 512>;     // K36
using ProlongShape = Shape<16, 16, 32, 1024>;    // K37

// A box of the fine (or coarse) grid held in shared memory: global points
// [z0, z0 + nz) x [y0, y0 + ny) x [x0, x0 + nx), C-order.
template <typename T>
struct Tile {
    T* s;
    int z0, y0, x0, nz, ny, nx;
    __device__ __forceinline__ int at(int z, int y, int x) const {
        return ((z - z0) * ny + (y - y0)) * nx + (x - x0);
    }
    __device__ __forceinline__ int size() const { return nz * ny * nx; }
    // the value at (z, y, x): the coarse accessor of prolong_point_at
    __device__ __forceinline__ T operator()(int z, int y, int x) const {
        return s[at(z, y, x)];
    }
    // the window around (z, y, x), for nbr_sum_at
    __device__ __forceinline__ Flat<T, int> around(int z, int y, int x) const {
        return Flat<T, int>{s, at(z, y, x), ny * nx, nx};
    }
};

__device__ __forceinline__ bool in_box(int z, int y, int x, int lm) {
    return z >= 0 && z < lm && y >= 0 && y < lm && x >= 0 && x < lm;
}

__device__ __forceinline__ int point(int z, int y, int x, int lm) {
    return (z * lm + y) * lm + x;
}

// Elements of the window of halo H around an S tile.
template <typename S, int H>
__host__ __device__ constexpr int window_size() {
    return (S::tz + 2 * H) * (S::ty + 2 * H) * (S::tx + 2 * H);
}

// The window of halo H around the S tile at (az, ay, ax); its extents are
// compile-time constants, so the index arithmetic below divides by
// constants only.
template <typename S, int H, typename T>
__device__ __forceinline__ Tile<T> fine_window(T* s, int az, int ay,
                                               int ax) {
    return Tile<T>{s, az - H, ay - H, ax - H,
                   S::tz + 2 * H, S::ty + 2 * H, S::tx + 2 * H};
}

// Copy v into the window of halo H, 0 outside the box.
template <typename S, int H, typename T>
__device__ void load_window(const Tile<T>& w, const T* __restrict__ v,
                            int lm) {
    constexpr int ny = S::ty + 2 * H, nx = S::tx + 2 * H;
    for (int i = threadIdx.x; i < window_size<S, H>(); i += S::threads) {
        const int x = w.x0 + i % nx;
        const int y = w.y0 + (i / nx) % ny;
        const int z = w.z0 + i / (nx * ny);
        w.s[i] = in_box(z, y, x, lm) ? v[point(z, y, x, lm)] : T(0);
    }
}

// One colour of a red-black sweep, in place in the window, over the S
// tile grown by E (its points in the box): a thread takes every other x
// of a row, the points of `color` ((x+y+z) % 2 == color) only.  Ends
// with a block barrier.
template <typename S, int E, typename T>
__device__ void rb_stage(const Tile<T>& w, const T* __restrict__ f, int az,
                         int ay, int ax, int lm, T inv_wc, T neg_woff,
                         int color) {
    constexpr int ny = S::ty + 2 * E, hx = (S::tx + 2 * E) / 2;
    constexpr int n = (S::tz + 2 * E) * ny * hx;
    const int z0 = az - E, y0 = ay - E, x0 = ax - E;
    for (int i = threadIdx.x; i < n; i += S::threads) {
        const int row = i / hx;
        const int y = y0 + row % ny;
        const int z = z0 + row / ny;
        const int x = x0 + ((color + z + y + x0) & 1) + 2 * (i - row * hx);
        if (!in_box(z, y, x, lm)) continue;
        w.s[w.at(z, y, x)] = mg3d::rb_candidate<T>(
            w.around(z, y, x), f, point(z, y, x, lm), z, y, x, lm, inv_wc,
            neg_woff);
    }
    __syncthreads();
}

// Write the window's points of the S tile (those in the box) to out.
template <typename S, typename T>
__device__ void store_tile(const Tile<T>& w, T* __restrict__ out, int az,
                           int ay, int ax, int lm) {
    constexpr int n = S::tz * S::ty * S::tx;
    for (int i = threadIdx.x; i < n; i += S::threads) {
        const int x = ax + i % S::tx;
        const int y = ay + (i / S::tx) % S::ty;
        const int z = az + i / (S::tx * S::ty);
        if (in_box(z, y, x, lm)) out[point(z, y, x, lm)] = w(z, y, x);
    }
}

template <typename T>
__device__ __forceinline__ T* shared_base() {
    extern __shared__ __align__(16) unsigned char smem[];
    return reinterpret_cast<T*>(smem);
}

// K35: two full red-black sweeps (R B R B) of the tile.
template <typename T>
__global__ void __launch_bounds__(Sweep2Shape::threads)
    rb_sweep2_kernel(const T* __restrict__ v, const T* __restrict__ f,
                     T* __restrict__ out, int lm, T inv_wc, T neg_woff) {
    using S = Sweep2Shape;
    const int az = blockIdx.z * S::tz, ay = blockIdx.y * S::ty,
              ax = blockIdx.x * S::tx;
    const Tile<T> w = fine_window<S, 4>(shared_base<T>(), az, ay, ax);
    load_window<S, 4>(w, v, lm);
    __syncthreads();
    rb_stage<S, 3>(w, f, az, ay, ax, lm, inv_wc, neg_woff, 0);
    rb_stage<S, 2>(w, f, az, ay, ax, lm, inv_wc, neg_woff, 1);
    rb_stage<S, 1>(w, f, az, ay, ax, lm, inv_wc, neg_woff, 0);
    rb_stage<S, 0>(w, f, az, ay, ax, lm, inv_wc, neg_woff, 1);
    store_tile<S>(w, out, az, ay, ax, lm);
}

// The masked residual of the swept window as a restriction sample (K2's
// ResidualSample reading shared memory).
template <typename T>
struct TileResidual {
    Tile<T> w;
    const T* f;
    int lm;
    T wc, woff;
    __device__ __forceinline__ T operator()(int z, int y, int x) const {
        return mg3d::masked_residual_at<T>(w.around(z, y, x), f,
                                           point(z, y, x, lm), z, y, x, lm,
                                           wc, woff);
    }
};

// K36: one red-black sweep of the fine tile, then the coarse points of
// the block's coarse tile, P^T (f - A v) through K2's restrict_combine.
template <typename T>
__global__ void __launch_bounds__(RestrictShape::threads)
    rb_residual_restrict_kernel(const T* __restrict__ v,
                                const T* __restrict__ f, T* __restrict__ out,
                                T* __restrict__ fc, int lm, int lmc, T wc,
                                T woff, T inv_wc, T neg_woff) {
    using S = RestrictShape;
    constexpr int cz = S::tz / 2, cy = S::ty / 2, cx = S::tx / 2;
    const int zc0 = blockIdx.z * cz, yc0 = blockIdx.y * cy,
              xc0 = blockIdx.x * cx;
    const int az = 2 * zc0, ay = 2 * yc0, ax = 2 * xc0;
    const Tile<T> w = fine_window<S, 4>(shared_base<T>(), az, ay, ax);
    load_window<S, 4>(w, v, lm);
    __syncthreads();
    rb_stage<S, 3>(w, f, az, ay, ax, lm, inv_wc, neg_woff, 0);
    rb_stage<S, 2>(w, f, az, ay, ax, lm, inv_wc, neg_woff, 1);
    store_tile<S>(w, out, az, ay, ax, lm);
    const TileResidual<T> sample{w, f, lm, wc, woff};
    const int mz = min(cz, lmc - zc0), my = min(cy, lmc - yc0),
              mx = min(cx, lmc - xc0);
    for (int i = threadIdx.x; i < mz * my * mx; i += S::threads) {
        const int xc = xc0 + i % mx;
        const int yc = yc0 + (i / mx) % my;
        const int zc = zc0 + i / (mx * my);
        fc[point(zc, yc, xc, lmc)] =
            mg3d::restrict_combine<T>(sample, zc, yc, xc, lmc);
    }
}

// Elements of K37's coarse footprint: tile/2 + 4 points an axis at most.
template <typename S>
__host__ __device__ constexpr int footprint_size() {
    return (S::tz / 2 + 4) * (S::ty / 2 + 4) * (S::tx / 2 + 4);
}

// K37: v + P(c) over the tile + 2, then red over the tile + 1 and black
// over the tile.
template <typename T>
__global__ void __launch_bounds__(ProlongShape::threads)
    prolong_correct_rb_kernel(const T* __restrict__ c,
                              const T* __restrict__ v,
                              const T* __restrict__ f, T* __restrict__ out,
                              int lmc, int lm, T inv_wc, T neg_woff) {
    using S = ProlongShape;
    const int az = blockIdx.z * S::tz, ay = blockIdx.y * S::ty,
              ax = blockIdx.x * S::tx;
    T* s = shared_base<T>();
    const Tile<T> w = fine_window<S, 2>(s, az, ay, ax);
    // the coarse points that P reads over the window's points in the box,
    // fine [lo, hi): k from lo/2 to (hi-1)/2 + 1
    const int zlo = max(az - 2, 0), ylo = max(ay - 2, 0), xlo = max(ax - 2, 0);
    const int zhi = min(az + S::tz + 2, lm), yhi = min(ay + S::ty + 2, lm),
              xhi = min(ax + S::tx + 2, lm);
    const int kz0 = zlo >> 1, ky0 = ylo >> 1, kx0 = xlo >> 1;
    const Tile<T> ct{s + window_size<S, 2>(), kz0, ky0, kx0,
                     min(((zhi - 1) >> 1) + 2, lmc) - kz0,
                     min(((yhi - 1) >> 1) + 2, lmc) - ky0,
                     min(((xhi - 1) >> 1) + 2, lmc) - kx0};
    for (int i = threadIdx.x; i < ct.size(); i += S::threads) {
        const int x = kx0 + i % ct.nx;
        const int y = ky0 + (i / ct.nx) % ct.ny;
        const int z = kz0 + i / (ct.nx * ct.ny);
        ct.s[i] = c[point(z, y, x, lmc)];
    }
    __syncthreads();
    constexpr int ny = S::ty + 4, nx = S::tx + 4;
    for (int i = threadIdx.x; i < window_size<S, 2>(); i += S::threads) {
        const int x = w.x0 + i % nx;
        const int y = w.y0 + (i / nx) % ny;
        const int z = w.z0 + i / (nx * ny);
        w.s[i] = in_box(z, y, x, lm) ? v[point(z, y, x, lm)] +
                                           mg3d::prolong_point_at<T>(ct, z,
                                                                     y, x)
                                     : T(0);
    }
    __syncthreads();
    rb_stage<S, 1>(w, f, az, ay, ax, lm, inv_wc, neg_woff, 0);
    rb_stage<S, 0>(w, f, az, ay, ax, lm, inv_wc, neg_woff, 1);
    store_tile<S>(w, out, az, ay, ax, lm);
}

// Grid of one block per S tile over an n^3 box (the fine box, or K36's
// coarse box in coarse tiles of half the extent).
template <typename S>
dim3 tile_grid(int n, int halve) {
    const int tz = S::tz >> halve, ty = S::ty >> halve, tx = S::tx >> halve;
    return dim3((unsigned int)((n + tx - 1) / tx),
                (unsigned int)((n + ty - 1) / ty),
                (unsigned int)((n + tz - 1) / tz));
}

// Launch `kernel` with S's block and `elements` of T in shared memory,
// after raising its dynamic shared-memory limit (above the default 48 KB).
template <typename S, typename T, typename K, typename... Args>
int launch(K kernel, dim3 grid, int elements, cudaStream_t stream,
           Args... args) {
    const int bytes = elements * (int)sizeof(T);
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, S::threads, bytes, stream>>>(args...);
    return (int)cudaGetLastError();
}

template <typename T>
int rb_sweep2(const T* v, const T* f, T* out, int lm, T inv_wc, T neg_woff,
              cudaStream_t stream) {
    using S = Sweep2Shape;
    return launch<S, T>(rb_sweep2_kernel<T>, tile_grid<S>(lm, 0),
                        window_size<S, 4>(), stream, v, f, out, lm, inv_wc,
                        neg_woff);
}

template <typename T>
int rb_residual_restrict(const T* v, const T* f, T* out, T* fc, int lm,
                         int lmc, T wc, T woff, T inv_wc, T neg_woff,
                         cudaStream_t stream) {
    using S = RestrictShape;
    return launch<S, T>(rb_residual_restrict_kernel<T>, tile_grid<S>(lmc, 1),
                        window_size<S, 4>(), stream, v, f, out, fc, lm, lmc,
                        wc, woff, inv_wc, neg_woff);
}

template <typename T>
int prolong_correct_rb(const T* c, const T* v, const T* f, T* out, int lmc,
                       int lm, T inv_wc, T neg_woff, cudaStream_t stream) {
    using S = ProlongShape;
    return launch<S, T>(prolong_correct_rb_kernel<T>, tile_grid<S>(lm, 0),
                        window_size<S, 2>() + footprint_size<S>(), stream, c,
                        v, f, out, lmc, lm, inv_wc, neg_woff);
}

}  // namespace

extern "C" {

// out must not alias v or f.
int mg_rb_sweep2_f32(const float* v, const float* f, float* out, int lm,
                     float inv_wc, float neg_woff, void* stream) {
    return rb_sweep2<float>(v, f, out, lm, inv_wc, neg_woff,
                            (cudaStream_t)stream);
}

int mg_rb_sweep2_f64(const double* v, const double* f, double* out, int lm,
                     double inv_wc, double neg_woff, void* stream) {
    return rb_sweep2<double>(v, f, out, lm, inv_wc, neg_woff,
                             (cudaStream_t)stream);
}

// out (lm^3) and fc (lmc^3) must not alias v or f.
int mg_rb_residual_restrict_f32(const float* v, const float* f, float* out,
                                float* fc, int lm, int lmc, float wc,
                                float woff, float inv_wc, float neg_woff,
                                void* stream) {
    return rb_residual_restrict<float>(v, f, out, fc, lm, lmc, wc, woff,
                                       inv_wc, neg_woff,
                                       (cudaStream_t)stream);
}

int mg_rb_residual_restrict_f64(const double* v, const double* f,
                                double* out, double* fc, int lm, int lmc,
                                double wc, double woff, double inv_wc,
                                double neg_woff, void* stream) {
    return rb_residual_restrict<double>(v, f, out, fc, lm, lmc, wc, woff,
                                        inv_wc, neg_woff,
                                        (cudaStream_t)stream);
}

// out must not alias c, v or f.
int mg_prolong_correct_rb_f32(const float* c, const float* v, const float* f,
                              float* out, int lmc, int lm, float inv_wc,
                              float neg_woff, void* stream) {
    return prolong_correct_rb<float>(c, v, f, out, lmc, lm, inv_wc, neg_woff,
                                     (cudaStream_t)stream);
}

int mg_prolong_correct_rb_f64(const double* c, const double* v,
                              const double* f, double* out, int lmc, int lm,
                              double inv_wc, double neg_woff, void* stream) {
    return prolong_correct_rb<double>(c, v, f, out, lmc, lm, inv_wc,
                                      neg_woff, (cudaStream_t)stream);
}

}  // extern "C"
