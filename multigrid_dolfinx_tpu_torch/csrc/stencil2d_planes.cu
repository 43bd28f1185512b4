// Stored-planes (variable-coefficient, Galerkin) 2D kernels for Hopper
// (sm_90a): K22 residual, K23 weighted Jacobi, K24 multicolour
// Gauss-Seidel.  They replace multigrid_dolfinx_tpu/ops/pallas/stencil2d.py
// planes_residual, planes_jacobi_sweep and planes_gs_sweep.
//
// The operator is K coefficient planes of the logical lm^2 node box,
// (K, lm, lm) C-order (row y, column x), contiguous and unpadded: row p
// is sum_k planes[k][p] * v[p + off_k].  One thread per point, 32-bit
// point indices (the wrappers refuse lm > 46340); plane k starts k * lm^2
// points further, a 64-bit step.  Each thread sums its terms in the order
// of the offsets from a zero accumulator (the Pallas _planes_apply
// association) and the library is built with --fmad=false, so each kernel
// is bitwise equal to its plain PyTorch version
// (ops/cuda/stencil2d_planes.py).  Out-of-box neighbours are skipped,
// never read: the TPU kernel lets its rolls wrap onto zero-plane padding
// instead.  The radius (1 or 2) is a template parameter: points at least
// R from every edge skip the per-offset box test.
//
// Bound on the H100: memory.  Per point a sweep reads K plane values, v
// and f and writes one value: (K + 3) arrays, 10 for the 7-offset P1
// operator of the finest level, 2.68 GB at 8193^2 f32, 0.80 ms at 3.35
// TB/s.  The neighbours of v come from L1/L2.  What the design does about
// it:
//  - The offset count is a template parameter for the counts the path
//    has (7 on the finest level, 9 on the Galerkin levels), so a thread's
//    loop over the offsets unrolls and its 2K loads are in flight
//    together; with the count read at run time a thread kept about one
//    load in flight and the kernels ran at ~45 % of the bound.
//  - K24 runs in place on v.  With the 'quad' (4 colours, per-axis
//    parity; radius 1) and 'mod' (9 colours, per-axis residue mod 3;
//    radius 2) schedules it makes one launch per row residue, m = R + 1
//    launches a sweep: a block owns one row of the class and sweeps it as
//    a wavefront, a tile of m x 256 points at a time, in which column
//    residue c updates its points in [base - c R, base - c R + tile), a
//    barrier between residues.  That is the colour-by-colour order: a
//    point's neighbours in other rows belong to other row residues, which
//    no block of the launch writes; in its own row, those of an earlier
//    residue (at most R away) lie in windows already swept, and those of
//    a later one lie at or beyond that residue's window, not yet swept.
//    So each tile's plane rows come from device memory once and the
//    later residues read them from L1; sweeping the row once per residue
//    instead fetched them again (a launch's rows in flight overrun L2).
//  - The 'sum' schedule (2 colours by coordinate parity, axis-only
//    radius-1 stencils) couples rows, so it runs one masked launch per
//    colour.
//
// Each entry point is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kBx = 32;
constexpr int kBy = 8;
// Every offset of radius <= 2 in 2D: the 5 x 5 box.
constexpr int kMaxOffsets = 25;
constexpr int kRowThreads = 256;

// The stencil, passed by value: K offsets (dy, dx) and the centre's index.
struct Stencil {
    int k;
    int center;
    signed char d[2 * kMaxOffsets];
};

__device__ __forceinline__ bool in_box(int i, int lm) {
    return (unsigned)i < (unsigned)lm;
}

// sum_k planes[k][p] v[p + off_k] over k != skip, in offset order, from 0.
// KC is the offset count when it is a compile-time constant, else 0.
template <typename T, int R, int KC>
__device__ __forceinline__ T planes_acc(const T* __restrict__ planes,
                                        const T* v, int p, long long n,
                                        int y, int x, int lm,
                                        const Stencil& s, int skip) {
    const int K = KC > 0 ? KC : s.k;
    T acc = T(0);
    if (y >= R && y < lm - R && x >= R && x < lm - R) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (k == skip) continue;
            const int dy = s.d[2 * k], dx = s.d[2 * k + 1];
            acc = acc + planes[k * n + p] * v[p + dy * lm + dx];
        }
        return acc;
    }
    for (int k = 0; k < K; ++k) {
        if (k == skip) continue;
        const int dy = s.d[2 * k], dx = s.d[2 * k + 1];
        if (!(in_box(y + dy, lm) && in_box(x + dx, lm))) continue;
        acc = acc + planes[k * n + p] * v[p + dy * lm + dx];
    }
    return acc;
}

template <typename T>
__device__ __forceinline__ T planes_dinv(const T* __restrict__ planes, int p,
                                         long long n, int center) {
    const T pc = planes[center * n + p];
    return T(1) / (pc == T(0) ? T(1) : pc);
}

// K22: r = f - A v.
template <typename T, int R, int KC>
__global__ void residual_kernel(const T* __restrict__ v,
                                const T* __restrict__ f,
                                const T* __restrict__ planes,
                                T* __restrict__ out, int lm, Stencil s) {
    const int x = blockIdx.x * kBx + threadIdx.x;
    const int y = blockIdx.y * kBy + threadIdx.y;
    if (x >= lm || y >= lm) return;
    const int p = y * lm + x;
    const long long n = (long long)lm * lm;
    out[p] = f[p] - planes_acc<T, R, KC>(planes, v, p, n, y, x, lm, s, -1);
}

// K23: out = keep v + w (d f - d acc), acc without the centre term,
// d = 1 / P_c (1 where P_c = 0): the Pallas _planes_jacobi_kernel
// association (the reference's jacobiRelaxation).  keep = 1 - w and w
// arrive rounded to T by the wrapper.  Out of place: the smoother
// ping-pongs two buffers.
template <typename T, int R, int KC>
__global__ void jacobi_kernel(const T* __restrict__ v,
                              const T* __restrict__ f,
                              const T* __restrict__ planes,
                              T* __restrict__ out, int lm, Stencil s, T keep,
                              T w) {
    const int x = blockIdx.x * kBx + threadIdx.x;
    const int y = blockIdx.y * kBy + threadIdx.y;
    if (x >= lm || y >= lm) return;
    const int p = y * lm + x;
    const long long n = (long long)lm * lm;
    const T acc = planes_acc<T, R, KC>(planes, v, p, n, y, x, lm, s,
                                       s.center);
    const T d = planes_dinv(planes, p, n, s.center);
    out[p] = keep * v[p] + w * (d * f[p] - d * acc);
}

// One Gauss-Seidel point update in place: v + d (f - A v) (the Pallas
// _planes_gs_kernel).
template <typename T, int R, int KC>
__device__ __forceinline__ void gs_point(T* v, const T* __restrict__ f,
                                         const T* __restrict__ planes,
                                         int lm, const Stencil& s, int y,
                                         int x) {
    const int p = y * lm + x;
    const long long n = (long long)lm * lm;
    const T acc = planes_acc<T, R, KC>(planes, v, p, n, y, x, lm, s, -1);
    const T d = planes_dinv(planes, p, n, s.center);
    v[p] = v[p] + d * (f[p] - acc);
}

// K24, 'sum' schedule, one colour: the points with (x + y) % 2 == parity.
template <typename T>
__global__ void gs_parity_kernel(T* v, const T* __restrict__ f,
                                 const T* __restrict__ planes, int lm,
                                 Stencil s, int parity) {
    const int x = blockIdx.x * kBx + threadIdx.x;
    const int y = blockIdx.y * kBy + threadIdx.y;
    if (x >= lm || y >= lm || ((x + y) & 1) != parity) return;
    gs_point<T, 1, 0>(v, f, planes, lm, s, y, x);
}

// K24, 'quad' (R = 1) / 'mod' (R = 2) schedule, the m = R + 1 colours
// (py, 0..m-1) of one row residue: block b owns row y = py + m b and
// sweeps it as the wavefront described above.
template <typename T, int R, int KC>
__global__ void gs_rows_kernel(T* v, const T* __restrict__ f,
                               const T* __restrict__ planes, int lm,
                               Stencil s, int py) {
    constexpr int m = R + 1;
    const int y = py + m * (int)blockIdx.x;
    const int tile = m * (int)blockDim.x;
    for (int base = 0; base - (m - 1) * R < lm; base += tile) {
#pragma unroll
        for (int c = 0; c < m; ++c) {
            const int lo = base - c * R;
            const int x = lo + ((c - lo) % m + m) % m + m * (int)threadIdx.x;
            if (x >= 0 && x < lm) gs_point<T, R, KC>(v, f, planes, lm, s, y, x);
            __syncthreads();
        }
    }
}

bool make_stencil(const int* offsets, int k, int center, int radius,
                  Stencil* s) {
    if (k < 1 || k > kMaxOffsets || center < 0 || center >= k ||
        (radius != 1 && radius != 2))
        return false;
    s->k = k;
    s->center = center;
    for (int i = 0; i < 2 * k; ++i) {
        if (offsets[i] < -radius || offsets[i] > radius) return false;
        s->d[i] = (signed char)offsets[i];
    }
    return true;
}

dim3 grid_for(int lm) {
    return dim3((unsigned)((lm + kBx - 1) / kBx),
                (unsigned)((lm + kBy - 1) / kBy));
}

template <typename T, int R, int KC>
struct Residual {
    static void launch(const T* v, const T* f, const T* planes, T* out,
                       int lm, const Stencil& s, cudaStream_t stream) {
        residual_kernel<T, R, KC><<<grid_for(lm), dim3(kBx, kBy), 0,
                                    stream>>>(v, f, planes, out, lm, s);
    }
};

template <typename T, int R, int KC>
struct Jacobi {
    static void launch(const T* v, const T* f, const T* planes, T* out,
                       int lm, const Stencil& s, T keep, T w,
                       cudaStream_t stream) {
        jacobi_kernel<T, R, KC><<<grid_for(lm), dim3(kBx, kBy), 0,
                                  stream>>>(v, f, planes, out, lm, s, keep,
                                            w);
    }
};

// One sweep's m row-residue launches ('quad' / 'mod').
template <typename T, int R, int KC>
struct GsRows {
    static void launch(T* v, const T* f, const T* planes, int lm,
                       const Stencil& s, cudaStream_t stream) {
        constexpr int m = R + 1;
        for (int py = 0; py < m; ++py) {
            const int ny = (lm - py + m - 1) / m;
            gs_rows_kernel<T, R, KC><<<(unsigned)ny, kRowThreads, 0,
                                       stream>>>(v, f, planes, lm, s, py);
            if (cudaPeekAtLastError() != cudaSuccess) return;
        }
    }
};

// Op<T, R, KC>::launch(args...) with KC the offset count where the path
// has it (7 and 9 at radius 1), else 0; returns cudaGetLastError().
template <template <typename, int, int> class Op, typename T,
          typename... A>
int dispatch(const Stencil& s, int radius, A... args) {
    if (radius == 2)
        Op<T, 2, 0>::launch(args...);
    else if (s.k == 7)
        Op<T, 1, 7>::launch(args...);
    else if (s.k == 9)
        Op<T, 1, 9>::launch(args...);
    else
        Op<T, 1, 0>::launch(args...);
    return (int)cudaGetLastError();
}

template <typename T>
int residual(const T* v, const T* f, const T* planes, T* out, int lm,
             const int* offsets, int k, int center, int radius,
             cudaStream_t stream) {
    Stencil s;
    if (!make_stencil(offsets, k, center, radius, &s))
        return (int)cudaErrorInvalidValue;
    return dispatch<Residual, T>(s, radius, v, f, planes, out, lm, s,
                                 stream);
}

template <typename T>
int jacobi(const T* v, const T* f, const T* planes, T* out, int lm,
           const int* offsets, int k, int center, int radius, T keep, T w,
           cudaStream_t stream) {
    Stencil s;
    if (!make_stencil(offsets, k, center, radius, &s))
        return (int)cudaErrorInvalidValue;
    return dispatch<Jacobi, T>(s, radius, v, f, planes, out, lm, s, keep, w,
                               stream);
}

// One full sweep in place on v: kind 0 'sum' (2 colours, coordinate-sum
// parity; axis-only radius-1 stencils), 1 'quad' (4 colours, per-axis
// parity; radius 1), 2 'mod' (9 colours, per-axis residue mod 3; radius
// 2), in itertools.product order (row residue slowest), as stencil2d.py
// planes_gs_sweep chooses them.  A schedule whose colours are not
// independent sets of the stencil is refused.
template <typename T>
int gs_sweep(T* v, const T* f, const T* planes, int lm, const int* offsets,
             int k, int center, int radius, int kind, cudaStream_t stream) {
    Stencil s;
    if (!make_stencil(offsets, k, center, radius, &s) || kind < 0 ||
        kind > 2 || (kind < 2 && radius != 1) || (kind == 2 && radius != 2))
        return (int)cudaErrorInvalidValue;
    if (kind > 0)
        return dispatch<GsRows, T>(s, radius, v, f, planes, lm, s, stream);
    for (int i = 0; i < k; ++i)
        if (s.d[2 * i] != 0 && s.d[2 * i + 1] != 0)
            return (int)cudaErrorInvalidValue;
    for (int parity = 0; parity < 2; ++parity) {
        gs_parity_kernel<T><<<grid_for(lm), dim3(kBx, kBy), 0, stream>>>(
            v, f, planes, lm, s, parity);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

}  // namespace

extern "C" {

int mg_planes2_residual_f32(const float* v, const float* f,
                            const float* planes, float* out, int lm,
                            const int* offsets, int k, int center,
                            int radius, void* stream) {
    return residual<float>(v, f, planes, out, lm, offsets, k, center, radius,
                           (cudaStream_t)stream);
}

int mg_planes2_residual_f64(const double* v, const double* f,
                            const double* planes, double* out, int lm,
                            const int* offsets, int k, int center,
                            int radius, void* stream) {
    return residual<double>(v, f, planes, out, lm, offsets, k, center,
                            radius, (cudaStream_t)stream);
}

int mg_planes2_jacobi_f32(const float* v, const float* f,
                          const float* planes, float* out, int lm,
                          const int* offsets, int k, int center, int radius,
                          float keep, float w, void* stream) {
    return jacobi<float>(v, f, planes, out, lm, offsets, k, center, radius,
                         keep, w, (cudaStream_t)stream);
}

int mg_planes2_jacobi_f64(const double* v, const double* f,
                          const double* planes, double* out, int lm,
                          const int* offsets, int k, int center, int radius,
                          double keep, double w, void* stream) {
    return jacobi<double>(v, f, planes, out, lm, offsets, k, center, radius,
                          keep, w, (cudaStream_t)stream);
}

// v is updated in place.
int mg_planes2_gs_sweep_f32(float* v, const float* f, const float* planes,
                            int lm, const int* offsets, int k, int center,
                            int radius, int kind, void* stream) {
    return gs_sweep<float>(v, f, planes, lm, offsets, k, center, radius, kind,
                           (cudaStream_t)stream);
}

int mg_planes2_gs_sweep_f64(double* v, const double* f,
                            const double* planes, int lm, const int* offsets,
                            int k, int center, int radius, int kind,
                            void* stream) {
    return gs_sweep<double>(v, f, planes, lm, offsets, k, center, radius,
                            kind, (cudaStream_t)stream);
}

}  // extern "C"
