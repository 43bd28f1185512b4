// Stored-planes (variable-coefficient, Galerkin) 3D kernels for Hopper
// (sm_90a): K15 residual, K16 weighted Jacobi, K17 multicolour
// Gauss-Seidel.  They replace multigrid_dolfinx_tpu/ops/pallas/stencil3d.py
// planes3_residual, planes3_jacobi_sweep and planes3_gs_sweep (all through
// _call_planes3).
//
// The operator is K coefficient planes of the logical lm^3 node box,
// (K, lm, lm, lm) C-order, contiguous and unpadded: row p is
// sum_k planes[k][p] * v[p + off_k].  One thread per point in 32 x 8
// blocks on x-contiguous rows, one z plane per grid slice, 32-bit point
// indices (the wrappers refuse lm > 1290); plane k starts k * lm^3 points
// further, a 64-bit step.  Each thread sums its terms in the order of the
// offsets from a zero accumulator (the Pallas _p3_apply_row association)
// and the library is built with --fmad=false, so each kernel is bitwise
// equal to its plain PyTorch version (ops/cuda/stencil3d_planes.py).
// Out-of-box neighbours are skipped, never read: the TPU kernel lets its
// window index wrap onto zero-plane padding instead.  The radius (1 or 2)
// is a template parameter: points at least R from every face skip the
// per-offset box test.
//
// Bound on the H100: memory.  Per point a sweep reads K plane values, v
// and f and writes one value: (K + 3) arrays, 18 for the 15-offset Kuhn
// operator, 4.1 GB at 385^3 f32, 1.23 ms at 3.35 TB/s.  The neighbours of
// v come from L1/L2.  K17 runs in place on v.  With the 'coord'
// (8 colours) and 'coord3' (27) schedules it makes one launch per (z, y)
// row class, m^2 launches a sweep: a block owns one row of the class and
// runs its m x-residue colours over the whole row in turn, a barrier
// between them.  That is the colour-by-colour order: a point's
// neighbours in other rows belong to other row classes, which no block of
// the launch writes, and those in its own row to other x-residues, which
// the barriers order.  Each plane sector is then fetched once a sweep,
// v about once a launch.  The 'sum' schedule (2 colours by coordinate
// parity) couples rows, so it runs one masked launch per colour.
//
// Each entry point is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>

#include "stencil3d.cuh"

namespace {

constexpr int kMaxOffsets = 64;

// The stencil, passed by value: K offsets (dz, dy, dx) and the centre's
// index.
struct Stencil {
    int k;
    int center;
    signed char d[3 * kMaxOffsets];
};

__device__ __forceinline__ bool in_box(int i, int lm) {
    return (unsigned)i < (unsigned)lm;
}

// sum_k planes[k][p] v[p + off_k] over k != skip, in offset order, from 0.
template <typename T, int R>
__device__ __forceinline__ T planes_acc(const T* __restrict__ planes,
                                        const T* v, int p, long long n,
                                        int z, int y, int x, int lm,
                                        const Stencil& s, int skip) {
    const bool deep = z >= R && z < lm - R && y >= R && y < lm - R &&
                      x >= R && x < lm - R;
    T acc = T(0);
    const T* pk = planes + p;
    for (int k = 0; k < s.k; ++k, pk += n) {
        if (k == skip) continue;
        const int dz = s.d[3 * k], dy = s.d[3 * k + 1], dx = s.d[3 * k + 2];
        if (!deep && !(in_box(z + dz, lm) && in_box(y + dy, lm) &&
                       in_box(x + dx, lm)))
            continue;
        acc = acc + *pk * v[p + (dz * lm + dy) * lm + dx];
    }
    return acc;
}

template <typename T>
__device__ __forceinline__ T planes_dinv(const T* __restrict__ planes, int p,
                                         long long n, int center) {
    const T pc = planes[(long long)center * n + p];
    return T(1) / (pc == T(0) ? T(1) : pc);
}

// K15: r = f - A v.
template <typename T, int R>
__global__ void residual_kernel(const T* __restrict__ v,
                                const T* __restrict__ f,
                                const T* __restrict__ planes,
                                T* __restrict__ out, int lm, Stencil s) {
    const int x = blockIdx.x * mg3d::kBx + threadIdx.x;
    const int y = blockIdx.y * mg3d::kBy + threadIdx.y;
    const int z = blockIdx.z;
    if (x >= lm || y >= lm) return;
    const int p = (z * lm + y) * lm + x;
    const long long n = (long long)lm * lm * lm;
    out[p] = f[p] - planes_acc<T, R>(planes, v, p, n, z, y, x, lm, s, -1);
}

// K16: out = keep v + w (d f - d acc), acc without the centre term,
// d = 1 / P_c (1 where P_c = 0): the Pallas _p3_jacobi_body association
// (the reference's jacobiRelaxation).  keep = 1 - w and w arrive rounded
// to T by the wrapper.  Out of place: the smoother ping-pongs two buffers.
template <typename T, int R>
__global__ void jacobi_kernel(const T* __restrict__ v,
                              const T* __restrict__ f,
                              const T* __restrict__ planes,
                              T* __restrict__ out, int lm, Stencil s, T keep,
                              T w) {
    const int x = blockIdx.x * mg3d::kBx + threadIdx.x;
    const int y = blockIdx.y * mg3d::kBy + threadIdx.y;
    const int z = blockIdx.z;
    if (x >= lm || y >= lm) return;
    const int p = (z * lm + y) * lm + x;
    const long long n = (long long)lm * lm * lm;
    const T acc = planes_acc<T, R>(planes, v, p, n, z, y, x, lm, s, s.center);
    const T d = planes_dinv(planes, p, n, s.center);
    out[p] = keep * v[p] + w * (d * f[p] - d * acc);
}

// K17, 'sum' schedule, one colour: the points with (x + y + z) % 2 ==
// parity take v + d (f - A v) (the Pallas _p3_gs_body), in place.
template <typename T, int R>
__global__ void gs_parity_kernel(T* v, const T* __restrict__ f,
                                 const T* __restrict__ planes, int lm,
                                 Stencil s, int parity) {
    const int x = blockIdx.x * mg3d::kBx + threadIdx.x;
    const int y = blockIdx.y * mg3d::kBy + threadIdx.y;
    const int z = blockIdx.z;
    if (x >= lm || y >= lm || ((x + y + z) & 1) != parity) return;
    const int p = (z * lm + y) * lm + x;
    const long long n = (long long)lm * lm * lm;
    const T acc = planes_acc<T, R>(planes, v, p, n, z, y, x, lm, s, -1);
    const T d = planes_dinv(planes, p, n, s.center);
    v[p] = v[p] + d * (f[p] - acc);
}

// K17, 'coord' / 'coord3' schedule, the m colours (pz, py, 0..m-1) of one
// row class, in place: block b owns row (z, y) = (pz + m (b / ny),
// py + m (b % ny)) and updates its x-residues px = 0 .. m-1 in turn.
template <typename T, int R>
__global__ void gs_rows_kernel(T* v, const T* __restrict__ f,
                               const T* __restrict__ planes, int lm,
                               Stencil s, int m, int pz, int py) {
    const int ny = (lm - py + m - 1) / m;
    const int z = pz + m * (int)(blockIdx.x / ny);
    const int y = py + m * (int)(blockIdx.x % ny);
    const long long n = (long long)lm * lm * lm;
    const int row = (z * lm + y) * lm;
    for (int px = 0; px < m; ++px) {
        for (int x = px + m * (int)threadIdx.x; x < lm;
             x += m * (int)blockDim.x) {
            const int p = row + x;
            const T acc = planes_acc<T, R>(planes, v, p, n, z, y, x, lm, s,
                                           -1);
            const T d = planes_dinv(planes, p, n, s.center);
            v[p] = v[p] + d * (f[p] - acc);
        }
        __syncthreads();
    }
}

bool make_stencil(const int* offsets, int k, int center, int radius,
                  Stencil* s) {
    if (k < 1 || k > kMaxOffsets || center < 0 || center >= k ||
        (radius != 1 && radius != 2))
        return false;
    s->k = k;
    s->center = center;
    for (int i = 0; i < 3 * k; ++i) {
        if (offsets[i] < -radius || offsets[i] > radius) return false;
        s->d[i] = (signed char)offsets[i];
    }
    return true;
}

template <typename T>
int residual(const T* v, const T* f, const T* planes, T* out, int lm,
             const int* offsets, int k, int center, int radius,
             cudaStream_t stream) {
    Stencil s;
    if (!make_stencil(offsets, k, center, radius, &s))
        return (int)cudaErrorInvalidValue;
    const dim3 block(mg3d::kBx, mg3d::kBy);
    if (radius == 1)
        residual_kernel<T, 1><<<mg3d::grid_for(lm), block, 0, stream>>>(
            v, f, planes, out, lm, s);
    else
        residual_kernel<T, 2><<<mg3d::grid_for(lm), block, 0, stream>>>(
            v, f, planes, out, lm, s);
    return (int)cudaGetLastError();
}

template <typename T>
int jacobi(const T* v, const T* f, const T* planes, T* out, int lm,
           const int* offsets, int k, int center, int radius, T keep, T w,
           cudaStream_t stream) {
    Stencil s;
    if (!make_stencil(offsets, k, center, radius, &s))
        return (int)cudaErrorInvalidValue;
    const dim3 block(mg3d::kBx, mg3d::kBy);
    if (radius == 1)
        jacobi_kernel<T, 1><<<mg3d::grid_for(lm), block, 0, stream>>>(
            v, f, planes, out, lm, s, keep, w);
    else
        jacobi_kernel<T, 2><<<mg3d::grid_for(lm), block, 0, stream>>>(
            v, f, planes, out, lm, s, keep, w);
    return (int)cudaGetLastError();
}

constexpr int kRowThreads = 128;

template <typename T, int R>
int gs_sweep_r(T* v, const T* f, const T* planes, int lm, const Stencil& s,
               int kind, cudaStream_t stream) {
    if (kind == 0) {
        const dim3 block(mg3d::kBx, mg3d::kBy);
        for (int parity = 0; parity < 2; ++parity) {
            gs_parity_kernel<T, R><<<mg3d::grid_for(lm), block, 0, stream>>>(
                v, f, planes, lm, s, parity);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        return (int)cudaSuccess;
    }
    const int m = kind + 1;
    for (int pz = 0; pz < m; ++pz) {
        for (int py = 0; py < m; ++py) {
            const int nz = (lm - pz + m - 1) / m, ny = (lm - py + m - 1) / m;
            gs_rows_kernel<T, R><<<(unsigned int)(nz * ny), kRowThreads, 0,
                                   stream>>>(v, f, planes, lm, s, m, pz, py);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
    }
    return (int)cudaSuccess;
}

// One full sweep in place on v: kind 0 'sum' (2 colours, coordinate-sum
// parity), 1 'coord' (8 colours, per-axis parity), 2 'coord3' (27
// colours, per-axis residue mod 3), in itertools.product order (z
// slowest, x fastest), as stencil3d.py planes3_colors.
template <typename T>
int gs_sweep(T* v, const T* f, const T* planes, int lm, const int* offsets,
             int k, int center, int radius, int kind, cudaStream_t stream) {
    Stencil s;
    if (!make_stencil(offsets, k, center, radius, &s) || kind < 0 ||
        kind > 2)
        return (int)cudaErrorInvalidValue;
    if (radius == 1)
        return gs_sweep_r<T, 1>(v, f, planes, lm, s, kind, stream);
    return gs_sweep_r<T, 2>(v, f, planes, lm, s, kind, stream);
}

}  // namespace

extern "C" {

int mg_planes_residual_f32(const float* v, const float* f,
                           const float* planes, float* out, int lm,
                           const int* offsets, int k, int center, int radius,
                           void* stream) {
    return residual<float>(v, f, planes, out, lm, offsets, k, center, radius,
                           (cudaStream_t)stream);
}

int mg_planes_residual_f64(const double* v, const double* f,
                           const double* planes, double* out, int lm,
                           const int* offsets, int k, int center, int radius,
                           void* stream) {
    return residual<double>(v, f, planes, out, lm, offsets, k, center,
                            radius, (cudaStream_t)stream);
}

int mg_planes_jacobi_f32(const float* v, const float* f, const float* planes,
                         float* out, int lm, const int* offsets, int k,
                         int center, int radius, float keep, float w,
                         void* stream) {
    return jacobi<float>(v, f, planes, out, lm, offsets, k, center, radius,
                         keep, w, (cudaStream_t)stream);
}

int mg_planes_jacobi_f64(const double* v, const double* f,
                         const double* planes, double* out, int lm,
                         const int* offsets, int k, int center, int radius,
                         double keep, double w, void* stream) {
    return jacobi<double>(v, f, planes, out, lm, offsets, k, center, radius,
                          keep, w, (cudaStream_t)stream);
}

// v is updated in place.
int mg_planes_gs_sweep_f32(float* v, const float* f, const float* planes,
                           int lm, const int* offsets, int k, int center,
                           int radius, int kind, void* stream) {
    return gs_sweep<float>(v, f, planes, lm, offsets, k, center, radius, kind,
                           (cudaStream_t)stream);
}

int mg_planes_gs_sweep_f64(double* v, const double* f, const double* planes,
                           int lm, const int* offsets, int k, int center,
                           int radius, int kind, void* stream) {
    return gs_sweep<double>(v, f, planes, lm, offsets, k, center, radius,
                            kind, (cudaStream_t)stream);
}

}  // extern "C"
