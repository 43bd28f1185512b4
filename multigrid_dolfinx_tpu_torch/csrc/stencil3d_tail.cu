// Fused coarse tail of the 3D red-black V-cycle for Hopper (sm_90a):
// K13 tail_down and K14 tail_up of the port.
//
// Below a size threshold (the JAX package's 65^3) every level of a
// V-cycle moves little data, so per-level launches cost more than the
// work.  The tail runs the levels 1..t under it (t+1 levels, level 0 the
// coarsest) as two kernels, each one cooperative launch whose blocks all
// stay resident and meet at a grid-wide barrier between steps:
//   tail_down: per level, top to 1: v = 0, nu red-black sweeps on f,
//              then f_{l-1} = P^T (f - A v) (restrict_point);
//   (the coarse Cholesky solve of f_0 runs between them, in PyTorch);
//   tail_up:   per level, 1 to top: v = v_down + P(c) (prolong_point),
//              nu red-black sweeps on f, c = v.
// Each step keeps the arithmetic of K1 (a colour: candidate
// (f + (-woff) S) * inv_wc inside, f on the boundary), K2 and K3, and the
// library is built with --fmad=false, so the tail agrees bitwise with the
// per-level path, its plain version (ops/cuda/stencil3d_tail.py).  A
// colour runs in place: a point of one colour reads only neighbours of
// the other, which no thread writes during that step.
//
// Storage is the logical lm^3 box of each level, C-order, unpadded.  The
// entry points take the level sizes, the weights (wc, woff, 1/wc, -woff
// per level, as doubles rounded here to T, as the K1/K2 wrappers round
// theirs) and the level arrays as host arrays of device pointers; they
// launch on the given stream, do not synchronise and return a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stencil3d.cuh"

namespace cg = cooperative_groups;

namespace {

using mg3d::interior;
using mg3d::nbr_sum;
using mg3d::prolong_point;
using mg3d::restrict_point;

// Levels of one tail, coarsest included (the wrapper refuses more).
constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

template <typename T>
struct Tail {
    int t;                      // levels above the coarsest
    int nu;                     // red-black sweeps per level
    int lm[kMaxLevels];         // index 0 = coarsest ... t = top
    T wc[kMaxLevels], woff[kMaxLevels], inv_wc[kMaxLevels],
        neg_woff[kMaxLevels];
    T* v[kMaxLevels];           // down: pre-smoothed v; up: result (1..t)
    T* f[kMaxLevels];           // right-hand sides; down writes 0..t-1
    const T* vd[kMaxLevels];    // up: the down leg's v (1..t)
    const T* c0;                // up: the coarse solution
};

__device__ __forceinline__ void decode(int p, int lm, int& z, int& y,
                                       int& x) {
    x = p % lm;
    y = (p / lm) % lm;
    z = p / (lm * lm);
}

// One colour of a red-black sweep on level `l`, in place, grid-strided.
template <typename T>
__device__ void rb_colour(const Tail<T>& a, int l, int color, int tid,
                          int nth) {
    const int lm = a.lm[l];
    const int n = lm * lm * lm;
    T* v = a.v[l];
    const T* f = a.f[l];
    for (int p = tid; p < n; p += nth) {
        int z, y, x;
        decode(p, lm, z, y, x);
        if (((x + y + z) & 1) != color) continue;
        if (!interior(z, y, x, lm)) {
            v[p] = f[p];
        } else {
            const T s = nbr_sum(v, p, z, y, x, lm);
            v[p] = (f[p] + a.neg_woff[l] * s) * a.inv_wc[l];
        }
    }
}

template <typename T>
__device__ void sweeps(const Tail<T>& a, int l, cg::grid_group& grid,
                       int tid, int nth) {
    for (int s = 0; s < a.nu; ++s) {
        for (int color = 0; color < 2; ++color) {
            rb_colour(a, l, color, tid, nth);
            grid.sync();
        }
    }
}

// K13: the down leg (stencil3d_tail.py _tail_down_kernel).
template <typename T>
__global__ void __launch_bounds__(kThreads) tail_down_kernel(Tail<T> a) {
    cg::grid_group grid = cg::this_grid();
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int nth = gridDim.x * blockDim.x;
    for (int l = 1; l <= a.t; ++l) {
        const int n = a.lm[l] * a.lm[l] * a.lm[l];
        for (int p = tid; p < n; p += nth) a.v[l][p] = T(0);
    }
    grid.sync();
    for (int l = a.t; l >= 1; --l) {
        sweeps(a, l, grid, tid, nth);
        const int lmf = a.lm[l], lmc = a.lm[l - 1];
        const int nc = lmc * lmc * lmc;
        for (int q = tid; q < nc; q += nth) {
            int zc, yc, xc;
            decode(q, lmc, zc, yc, xc);
            a.f[l - 1][q] = restrict_point<T>(a.v[l], a.f[l], zc, yc, xc, lmf,
                                              lmc, a.wc[l], a.woff[l]);
        }
        if (l > 1) grid.sync();
    }
}

// K14: the up leg (stencil3d_tail.py _tail_up_kernel).
template <typename T>
__global__ void __launch_bounds__(kThreads) tail_up_kernel(Tail<T> a) {
    cg::grid_group grid = cg::this_grid();
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int nth = gridDim.x * blockDim.x;
    const T* c = a.c0;
    for (int l = 1; l <= a.t; ++l) {
        const int lm = a.lm[l], lmc = a.lm[l - 1];
        const int n = lm * lm * lm;
        for (int p = tid; p < n; p += nth) {
            int z, y, x;
            decode(p, lm, z, y, x);
            a.v[l][p] = a.vd[l][p] + prolong_point(c, z, y, x, lmc);
        }
        grid.sync();
        sweeps(a, l, grid, tid, nth);
        c = a.v[l];
    }
}

template <typename T>
int fill(Tail<T>& a, const int* lm, const double* w, int t, int nu) {
    if (t < 1 || t >= kMaxLevels || nu < 0) return (int)cudaErrorInvalidValue;
    a.t = t;
    a.nu = nu;
    for (int l = 0; l <= t; ++l) {
        a.lm[l] = lm[l];
        a.wc[l] = (T)w[4 * l];
        a.woff[l] = (T)w[4 * l + 1];
        a.inv_wc[l] = (T)w[4 * l + 2];
        a.neg_woff[l] = (T)w[4 * l + 3];
    }
    return 0;
}

// One cooperative launch: as many blocks as are resident at once on the
// card (at most one thread per point of the top level); every block
// reaches every barrier, so the launch refuses rather than hangs.
template <typename T>
int launch(void (*kernel)(Tail<T>), Tail<T>& a, cudaStream_t stream) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    const long long top = (long long)a.lm[a.t] * a.lm[a.t] * a.lm[a.t];
    long long blocks = (top + kThreads - 1) / kThreads;
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
    if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)blocks),
                                      dim3(kThreads), args, 0, stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int tail_down(const T* f_top, void* const* v, void* const* f, const int* lm,
              const double* w, int t, int nu, cudaStream_t stream) {
    Tail<T> a = {};
    int err = fill(a, lm, w, t, nu);
    if (err) return err;
    for (int l = 1; l <= t; ++l) a.v[l] = (T*)v[l];
    for (int l = 0; l < t; ++l) a.f[l] = (T*)f[l];
    a.f[t] = const_cast<T*>(f_top);    // only read
    return launch(tail_down_kernel<T>, a, stream);
}

template <typename T>
int tail_up(const T* c0, void* const* vd, void* const* f, void* const* v,
            const int* lm, const double* w, int t, int nu,
            cudaStream_t stream) {
    Tail<T> a = {};
    int err = fill(a, lm, w, t, nu);
    if (err) return err;
    a.c0 = c0;
    for (int l = 1; l <= t; ++l) {
        a.vd[l] = (const T*)vd[l];
        a.f[l] = (T*)f[l];              // only read
        a.v[l] = (T*)v[l];
    }
    return launch(tail_up_kernel<T>, a, stream);
}

}  // namespace

extern "C" {

// v[1..t]: the pre-smoothed v of each level (written); f[0..t-1]: the
// restricted right-hand sides (written); index 0 of v is unused.
int mg_tail_down_f32(const float* f_top, void* const* v, void* const* f,
                     const int* lm, const double* w, int t, int nu,
                     void* stream) {
    return tail_down<float>(f_top, v, f, lm, w, t, nu, (cudaStream_t)stream);
}

int mg_tail_down_f64(const double* f_top, void* const* v, void* const* f,
                     const int* lm, const double* w, int t, int nu,
                     void* stream) {
    return tail_down<double>(f_top, v, f, lm, w, t, nu, (cudaStream_t)stream);
}

// vd[1..t]: tail_down's v; f[1..t]: each level's right-hand side (f[t]
// the top's); v[1..t]: the corrected, post-smoothed v of each level
// (written; v[t] is the result).  Index 0 of the arrays is unused.
int mg_tail_up_f32(const float* c0, void* const* vd, void* const* f,
                   void* const* v, const int* lm, const double* w, int t,
                   int nu, void* stream) {
    return tail_up<float>(c0, vd, f, v, lm, w, t, nu, (cudaStream_t)stream);
}

int mg_tail_up_f64(const double* c0, void* const* vd, void* const* f,
                   void* const* v, const int* lm, const double* w, int t,
                   int nu, void* stream) {
    return tail_up<double>(c0, vd, f, v, lm, w, t, nu, (cudaStream_t)stream);
}

}  // extern "C"
