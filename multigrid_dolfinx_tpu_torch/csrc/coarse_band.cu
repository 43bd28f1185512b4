// Coarsest-level Cholesky solve over the factor's band for Hopper
// (sm_90a): K39 coarse_band_solve of the port.
//
// Replaces no TPU kernel: the JAX package leaves the coarse solve to XLA
// (jax.scipy cho_solve on the dense factor).  The port's library solve,
// torch.cholesky_solve, copied the dense f64 factor on every call (1.95 GB
// at the 25^3 Galerkin coarsest level) before two cuBLAS trsv.
//
// L is lower triangular with half-bandwidth w, so cut into blocks of
// bs >= w rows it is block lower bidiagonal: diagonal blocks D_k, blocks
// C_k below them.  The host stores, per block, D_k^-1 and D_k^-T packed
// into one symmetric bs x bs array (tril = D_k^-1, triu = D_k^-T), and C_k
// and C_k^T the same way (triu = C_k, tril = C_k^T; C_k's nonzeros lie at
// columns >= row + shift, shift = bs - w).  One launch solves L L^T u = f:
//   forward  y_0 = D_0^-1 f_0,  y_k = D_k^-1 (f_k - C_k y_{k-1});
//   back     x_last = D_last^-T y_last,
//            x_k = D_k^-T (y_k - C_{k+1}^T x_{k+1}),
// each product one step over the block's rows, with a barrier between
// steps: 4 nb - 2 steps.  Bound on the H100: the chain of dependent
// steps (a grid barrier each) plus the bytes, the packed arrays read once
// a solve (about 8 n (bs + w^2 / bs) bytes); nb is as small as the
// kernel's 1024 columns a row allow (ops/cuda/coarse_band.py
// block_layout), so the chain is short.
//
// Design: a cooperative launch of as many 256-thread blocks as a step
// has rows for (one warp a row, every block resident, so the launch
// refuses rather than hangs), meeting at grid.sync() between steps; a
// single block meets at __syncthreads().  A warp loads its next row of
// the packed block before the barrier; a thread block copies the step's
// vector to shared memory after it.  Lane l of a row's warp holds
// the products of columns l, l+32, ... in registers (the masked triangle
// as +0.0, never loaded) and the row's sum is a fixed halving tree over
// the columns (element j + h onto j while j + h is inside the row: in
// registers, then by shuffles), so every sum has one order: two runs give
// the same bits, and the plain version (ops/cuda/coarse_band.py), which
// runs the same tree with elementwise tensor ops, gives them too.  f is
// read in the hierarchy's dtype and u written in it; all else is f64.
// Vectors written inside the launch are read through L2 (__ldcg).
// Measured on an H100 (PERF.md): 0.26 ms a solve at 25^3 (62 steps,
// ~4 us each) against 0.05 ms of bytes: the chain, not the bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 1024;   // the wrapper's MAX_BLOCK
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Band {
    const T* f;         // right-hand side, n values
    T* u;               // solution, n values
    const double* d;    // nb packed D_k^-1 | D_k^-T, bs x bs each
    const double* c;    // nb - 1 packed C_k | C_k^T (k = 1 .. nb-1)
    double* y;          // forward result, nb * bs
    double* x;          // back result, nb * bs
    double* t;          // one step's right-hand side, bs
    int n, nb, bs, shift;
};

// A vector written earlier in this launch: read through L2.
struct Vec64 {
    const double* p;
    __device__ __forceinline__ double operator()(int j) const {
        return __ldcg(p + j);
    }
};

// Block 0 of the right-hand side, in the hierarchy's dtype.
template <typename T>
struct VecIn {
    const T* f;
    int n;
    __device__ __forceinline__ double operator()(int j) const {
        return j < n ? (double)f[j] : 0.0;
    }
};

// One register level of the halving tree: column j + 32 HM onto j (lane
// l holds columns l + 32 i at p[i]) while it is inside the row's w
// columns, then the next level; unrolled at compile time, so p stays in
// registers.
template <int HM, int MPL>
struct Halve {
    __device__ __forceinline__ static void run(double (&p)[MPL], int lane,
                                               int& w) {
#pragma unroll
        for (int i = 0; i < HM; ++i)
            if (32 * (i + HM) + lane < w) p[i] += p[i + HM];
        w = min(w, 32 * HM);
        Halve<HM / 2, MPL>::run(p, lane, w);
    }
};

template <int MPL>
struct Halve<0, MPL> {
    __device__ __forceinline__ static void run(double (&)[MPL], int, int&) {}
};

// Row r's values at the columns j in [lo, hi] (lane l: columns l + 32 i
// at p[i]), 0 elsewhere; no load outside [lo, hi].
template <int MPL>
__device__ __forceinline__ void load_row(const double* __restrict__ m,
                                         int lo, int hi, int lane,
                                         double (&p)[MPL]) {
#pragma unroll
    for (int i = 0; i < MPL; ++i) {
        const int j = 32 * i + lane;
        p[i] = (j >= lo && j <= hi) ? __ldg(m + j) : 0.0;
    }
}

// sum_j p[j] v[j] over the columns j in [lo, hi] of a row of bs columns
// (+0.0 products elsewhere), in the fixed halving tree; lane 0 holds it.
// MPL: columns a lane holds, 32 MPL >= bs.
template <int MPL>
__device__ __forceinline__ double row_sum(double (&p)[MPL], const double* v,
                                          int bs, int lo, int hi, int lane) {
#pragma unroll
    for (int i = 0; i < MPL; ++i) {
        const int j = 32 * i + lane;
        p[i] = (j >= lo && j <= hi) ? p[i] * v[j] : 0.0;
    }
    int w = bs;
    Halve<MPL / 2, MPL>::run(p, lane, w);
    double s = p[0];
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
        const double o = __shfl_down_sync(kFull, s, h);
        if (lane + h < w) s += o;
        w = min(w, h);
    }
    return s;
}

__device__ __forceinline__ void step_barrier(cg::grid_group& grid) {
    if (gridDim.x > 1)
        grid.sync();
    else
        __syncthreads();
}

// One step: out(r, row r of the bs x bs block m, masked to mask(r), times
// v) for each of the block's rows, one warp a row.  A warp loads its first
// row before the barrier that opens the step, so the load's latency hides
// behind the wait for the step before; after it, each thread block copies
// v to shared memory once for its warps.
template <int MPL, typename Mask, typename Load, typename Out>
__device__ __forceinline__ void step(cg::grid_group& grid, double* vs,
                                     bool barrier, const double* m, int bs,
                                     Mask mask, Load v, Out out) {
    const int lane = threadIdx.x & 31;
    const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    const int warps = (int)((gridDim.x * blockDim.x) >> 5);
    double p[MPL];
    int lo, hi;
    if (warp < bs) {
        mask(warp, lo, hi);
        load_row<MPL>(m + (size_t)warp * bs, lo, hi, lane, p);
    }
    if (barrier) step_barrier(grid);
    for (int j = threadIdx.x; j < bs; j += blockDim.x) vs[j] = v(j);
    __syncthreads();
    for (int r = warp; r < bs; r += warps) {
        mask(r, lo, hi);
        if (r != warp) load_row<MPL>(m + (size_t)r * bs, lo, hi, lane, p);
        const double s = row_sum<MPL>(p, vs, bs, lo, hi, lane);
        if (lane == 0) out(r, s);
    }
}

template <typename T, int MPL>
__global__ void __launch_bounds__(kThreads)
band_solve_kernel(Band<T> a) {
    __shared__ double vs[kMaxCols];   // the step's vector
    cg::grid_group grid = cg::this_grid();
    const int bs = a.bs, shift = a.shift;
    const size_t bb = (size_t)bs * bs;
    // the packed blocks' halves: D^-1, D^-T, C (columns >= row + shift)
    // and C^T (columns <= row - shift)
    auto d_fwd = [](int r, int& lo, int& hi) { lo = 0; hi = r; };
    auto d_back = [bs](int r, int& lo, int& hi) { lo = r; hi = bs - 1; };
    auto c_fwd = [bs, shift](int r, int& lo, int& hi) {
        lo = r + shift;
        hi = bs - 1;
    };
    auto c_back = [shift](int r, int& lo, int& hi) { lo = 0; hi = r - shift; };

    // forward: y_0 = D_0^-1 f_0, y_k = D_k^-1 (f_k - C_k y_{k-1})
    step<MPL>(grid, vs, false, a.d, bs, d_fwd, VecIn<T>{a.f, a.n},
              [&](int r, double s) { a.y[r] = s; });
    for (int k = 1; k < a.nb; ++k) {
        const size_t base = (size_t)k * bs;
        step<MPL>(grid, vs, true, a.c + (k - 1) * bb, bs, c_fwd,
                  Vec64{a.y + base - bs}, [&](int r, double s) {
                      const size_t i = base + r;
                      const double fi = i < (size_t)a.n ? (double)a.f[i] : 0.0;
                      a.t[r] = fi - s;
                  });
        step<MPL>(grid, vs, true, a.d + k * bb, bs, d_fwd, Vec64{a.t},
                  [&](int r, double s) { a.y[base + r] = s; });
    }
    // back, last block first: x_k = D_k^-T (y_k - C_{k+1}^T x_{k+1}), and
    // u where the row is one of the n
    for (int k = a.nb - 1; k >= 0; --k) {
        const size_t base = (size_t)k * bs;
        const double* v = a.y + base;
        if (k < a.nb - 1) {
            step<MPL>(grid, vs, true, a.c + k * bb, bs, c_back,
                      Vec64{a.x + base + bs}, [&](int r, double s) {
                          a.t[r] = __ldcg(a.y + base + r) - s;
                      });
            v = a.t;
        }
        step<MPL>(grid, vs, true, a.d + k * bb, bs, d_back, Vec64{v},
                  [&](int r, double s) {
                      a.x[base + r] = s;
                      if (base + r < (size_t)a.n) a.u[base + r] = (T)s;
                  });
    }
}

// One cooperative launch, one warp a row of a block: as many blocks as
// the rows need, at most as many as are resident at once on the card.
template <typename T, int MPL>
int launch(Band<T>& a, cudaStream_t stream) {
    void (*kernel)(Band<T>) = band_solve_kernel<T, MPL>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    long long blocks = (a.bs + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
    if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)kernel,
                                      dim3((unsigned)blocks), dim3(kThreads),
                                      args, 0, stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int band_solve(const T* f, T* u, const double* d, const double* c,
               double* work, int n, int nb, int bs, int shift,
               cudaStream_t stream) {
    if (n < 1 || nb < 1 || bs < 1 || bs > kMaxCols || shift < 0 ||
        shift >= bs || (long long)nb * bs < n)
        return (int)cudaErrorInvalidValue;
    const size_t nn = (size_t)nb * bs;
    Band<T> a = {f, u, d, c, work, work + nn, work + 2 * nn, n, nb, bs, shift};
    const int cols = bs <= 32 ? 32 : 1 << (32 - __builtin_clz(bs - 1));
    switch (cols / 32) {
        case 1: return launch<T, 1>(a, stream);
        case 2: return launch<T, 2>(a, stream);
        case 4: return launch<T, 4>(a, stream);
        case 8: return launch<T, 8>(a, stream);
        case 16: return launch<T, 16>(a, stream);
        case 32: return launch<T, 32>(a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// f, u: n values of the hierarchy's dtype; d: nb packed diagonal blocks,
// c: nb - 1 packed blocks below them (bs x bs f64 each, row-major);
// work: 2 nb bs + bs f64 of scratch.  Launches on the given stream, does
// not synchronise, returns a cudaError_t.
int mg_coarse_band_solve_f32(const float* f, float* u, const double* d,
                             const double* c, double* work, int n, int nb,
                             int bs, int shift, void* stream) {
    return band_solve<float>(f, u, d, c, work, n, nb, bs, shift,
                             (cudaStream_t)stream);
}

int mg_coarse_band_solve_f64(const double* f, double* u, const double* d,
                             const double* c, double* work, int n, int nb,
                             int bs, int shift, void* stream) {
    return band_solve<double>(f, u, d, c, work, n, nb, bs, shift,
                              (cudaStream_t)stream);
}

}  // extern "C"
