// Const-7-point multigrid kernels for Hopper (sm_90a): K1-K3 of the port.
//
// Storage is the logical lm^3 node box, C-order (z, y, x), contiguous and
// unpadded.  Interior means 1 <= index <= lm-2 on every axis.  Every sum
// keeps the association order of the Pallas TPU kernels it replaces, and
// the library is built with --fmad=false, so each kernel agrees bitwise
// with its plain PyTorch version (ops/cuda/stencil3d.py, *_ref).
//
// Each entry point is a plain C function: it launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool inside(int i, int lm) {
    return i >= 1 && i <= lm - 2;
}

// 6-neighbour sum of the interior-masked field around interior point
// (z, y, x), in the order (z-1)+(z+1)+(y-1)+(y+1)+(x-1)+(x+1)
// (stencil3d.py _nbr_sum).  Neighbours outside the interior read as 0.
template <typename T>
__device__ __forceinline__ T nbr_sum(const T* v, long long p, int z, int y,
                                     int x, int lm) {
    const long long sz = (long long)lm * lm, sy = lm;
    T zm = inside(z - 1, lm) ? v[p - sz] : T(0);
    T zp = inside(z + 1, lm) ? v[p + sz] : T(0);
    T ym = inside(y - 1, lm) ? v[p - sy] : T(0);
    T yp = inside(y + 1, lm) ? v[p + sy] : T(0);
    T xm = inside(x - 1, lm) ? v[p - 1] : T(0);
    T xp = inside(x + 1, lm) ? v[p + 1] : T(0);
    return ((((zm + zp) + ym) + yp) + xm) + xp;
}

// K1: one colour of the red-black Gauss-Seidel sweep, one thread per
// point.  Points of `color` ((x+y+z) % 2 == color) take the candidate
// (f + (-woff) S) * (1/wc) inside and f on the boundary; the others copy
// src.  The red launch reads v and writes out; the black launch runs in
// place on out (src == out): a black point reads only red neighbours and
// writes only itself, so the in-place update has no race.
template <typename T>
__global__ void rb_color_kernel(const T* src, const T* __restrict__ f, T* out,
                                int lm, T inv_wc, T neg_woff, int color) {
    const long long n = (long long)lm * lm * lm;
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const int x = (int)(p % lm);
    const int y = (int)((p / lm) % lm);
    const int z = (int)(p / ((long long)lm * lm));
    if (((x + y + z) & 1) != color) {
        if (src != out) out[p] = src[p];
        return;
    }
    if (!(inside(z, lm) && inside(y, lm) && inside(x, lm))) {
        out[p] = f[p];
        return;
    }
    const T s = nbr_sum(src, p, z, y, x, lm);
    out[p] = (f[p] + neg_woff * s) * inv_wc;
}

// Residual r = f - (wc v + woff S) at a fine point, 0 off the interior
// (the 'pt' correction-equation masking).
template <typename T>
__device__ __forceinline__ T masked_residual(const T* __restrict__ v,
                                             const T* __restrict__ f, int z,
                                             int y, int x, int lm, T wc,
                                             T woff) {
    if (!(inside(z, lm) && inside(y, lm) && inside(x, lm))) return T(0);
    const long long p = ((long long)z * lm + y) * lm + x;
    const T av = wc * v[p] + woff * nbr_sum(v, p, z, y, x, lm);
    return f[p] - av;
}

// K2: fused residual + variational P^T restriction, one thread per coarse
// point I.  The coarse value is 0.125 * [1 2 1]^3 applied to the masked
// fine residual around 2I, combined z first, then y, then x (the order of
// stencil3d.py _restrict_residual_kernel and _plane_restrict); 0 outside
// the coarse interior.  The 27 residuals are recomputed from v and f,
// which L1/L2 hold for the neighbouring threads.
template <typename T>
__global__ void restrict_residual_pt_kernel(const T* __restrict__ v,
                                            const T* __restrict__ f,
                                            T* __restrict__ out, int lmf,
                                            int lmc, T wc, T woff) {
    const long long n = (long long)lmc * lmc * lmc;
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    const int xc = (int)(q % lmc);
    const int yc = (int)((q / lmc) % lmc);
    const int zc = (int)(q / ((long long)lmc * lmc));
    if (!(inside(zc, lmc) && inside(yc, lmc) && inside(xc, lmc))) {
        out[q] = T(0);
        return;
    }
    const int zf = 2 * zc, yf = 2 * yc, xf = 2 * xc;
    T gy[3];
    for (int dx = -1; dx <= 1; ++dx) {
        T gz[3];
        for (int dy = -1; dy <= 1; ++dy) {
            const T lo = masked_residual(v, f, zf - 1, yf + dy, xf + dx, lmf, wc, woff);
            const T mid = masked_residual(v, f, zf, yf + dy, xf + dx, lmf, wc, woff);
            const T hi = masked_residual(v, f, zf + 1, yf + dy, xf + dx, lmf, wc, woff);
            gz[dy + 1] = (lo + T(2) * mid) + hi;
        }
        gy[dx + 1] = (gz[0] + T(2) * gz[1]) + gz[2];
    }
    out[q] = ((gy[0] + T(2) * gy[1]) + gy[2]) * T(0.125);
}

// K3: trilinear prolongation, one thread per fine point, with the
// optional fused correction out = v + P(c).  Interpolates in x, then y,
// then z, as stencil3d.py _plane_prolong / _prolong_kernel do.
template <typename T>
__device__ __forceinline__ T interp_x(const T* __restrict__ c, int kz, int jy,
                                      int xf, int lmc) {
    const T* row = c + ((long long)kz * lmc + jy) * lmc;
    if ((xf & 1) == 0) return row[xf >> 1];
    return T(0.5) * (row[xf >> 1] + row[(xf >> 1) + 1]);
}

template <typename T>
__device__ __forceinline__ T interp_xy(const T* __restrict__ c, int kz, int yf,
                                       int xf, int lmc) {
    if ((yf & 1) == 0) return interp_x(c, kz, yf >> 1, xf, lmc);
    return T(0.5) * (interp_x(c, kz, yf >> 1, xf, lmc) +
                     interp_x(c, kz, (yf >> 1) + 1, xf, lmc));
}

template <typename T>
__global__ void prolong_linear_kernel(const T* __restrict__ c,
                                      const T* __restrict__ v,
                                      T* __restrict__ out, int lmc, int lmf) {
    const long long n = (long long)lmf * lmf * lmf;
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const int xf = (int)(p % lmf);
    const int yf = (int)((p / lmf) % lmf);
    const int zf = (int)(p / ((long long)lmf * lmf));
    T e;
    if ((zf & 1) == 0) {
        e = interp_xy(c, zf >> 1, yf, xf, lmc);
    } else {
        e = T(0.5) * (interp_xy(c, zf >> 1, yf, xf, lmc) +
                      interp_xy(c, (zf >> 1) + 1, yf, xf, lmc));
    }
    out[p] = v ? v[p] + e : e;
}

unsigned int blocks_for(long long n) {
    return (unsigned int)((n + kThreads - 1) / kThreads);
}

template <typename T>
int rb_sweep(const T* v, const T* f, T* out, int lm, T inv_wc, T neg_woff,
             cudaStream_t stream) {
    const unsigned int nb = blocks_for((long long)lm * lm * lm);
    rb_color_kernel<T><<<nb, kThreads, 0, stream>>>(v, f, out, lm, inv_wc,
                                                    neg_woff, 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rb_color_kernel<T><<<nb, kThreads, 0, stream>>>(out, f, out, lm, inv_wc,
                                                    neg_woff, 1);
    return (int)cudaGetLastError();
}

template <typename T>
int restrict_residual_pt(const T* v, const T* f, T* out, int lmf, int lmc,
                         T wc, T woff, cudaStream_t stream) {
    const unsigned int nb = blocks_for((long long)lmc * lmc * lmc);
    restrict_residual_pt_kernel<T><<<nb, kThreads, 0, stream>>>(
        v, f, out, lmf, lmc, wc, woff);
    return (int)cudaGetLastError();
}

template <typename T>
int prolong_linear(const T* c, const T* v, T* out, int lmc, int lmf,
                   cudaStream_t stream) {
    const unsigned int nb = blocks_for((long long)lmf * lmf * lmf);
    prolong_linear_kernel<T><<<nb, kThreads, 0, stream>>>(c, v, out, lmc, lmf);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_rb_sweep_f32(const float* v, const float* f, float* out, int lm,
                    float inv_wc, float neg_woff, void* stream) {
    return rb_sweep<float>(v, f, out, lm, inv_wc, neg_woff,
                           (cudaStream_t)stream);
}

int mg_rb_sweep_f64(const double* v, const double* f, double* out, int lm,
                    double inv_wc, double neg_woff, void* stream) {
    return rb_sweep<double>(v, f, out, lm, inv_wc, neg_woff,
                            (cudaStream_t)stream);
}

int mg_restrict_residual_pt_f32(const float* v, const float* f, float* out,
                                int lmf, int lmc, float wc, float woff,
                                void* stream) {
    return restrict_residual_pt<float>(v, f, out, lmf, lmc, wc, woff,
                                       (cudaStream_t)stream);
}

int mg_restrict_residual_pt_f64(const double* v, const double* f,
                                double* out, int lmf, int lmc, double wc,
                                double woff, void* stream) {
    return restrict_residual_pt<double>(v, f, out, lmf, lmc, wc, woff,
                                        (cudaStream_t)stream);
}

// v may be NULL: then out = P(c).
int mg_prolong_linear_f32(const float* c, const float* v, float* out,
                          int lmc, int lmf, void* stream) {
    return prolong_linear<float>(c, v, out, lmc, lmf, (cudaStream_t)stream);
}

int mg_prolong_linear_f64(const double* c, const double* v, double* out,
                          int lmc, int lmf, void* stream) {
    return prolong_linear<double>(c, v, out, lmc, lmf, (cudaStream_t)stream);
}

}  // extern "C"
