// Const-7-point multigrid kernels for Hopper (sm_90a): K1-K3, K10 and
// K11 of the port, K18, the P^T restriction of a given residual, and the
// red-black half sweep that K1 launches twice.
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

#include "stencil3d.cuh"

namespace {

using mg3d::inside;
using mg3d::interior;
using mg3d::nbr_sum;
using mg3d::prolong_point;
using mg3d::restrict_point;

constexpr int kThreads = 256;

// K1 is two launches of the half sweep (stencil3d.py rb_half_sweep): one
// colour of the red-black Gauss-Seidel sweep, one thread per point.
// Points of `color` ((x+y+z) % 2 == color) take the candidate (f +
// (-woff) S) * (1/wc) inside and f on the boundary (mg3d::rb_candidate);
// the others copy src.  K1's red launch reads v and writes out; its black
// launch runs in place on out (src == out): a point of one colour reads
// only the other colour and writes only itself, so the in-place update
// has no race.
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
    const long long sz = (long long)lm * lm, sy = lm;
    out[p] = mg3d::rb_candidate<T>(mg3d::Flat<T, long long>{src, p, sz, sy},
                                   f, p, z, y, x, lm, inv_wc, neg_woff);
}

// K2: fused residual + variational P^T restriction, one thread per coarse
// point (restrict_point in stencil3d.cuh).  The 27 residuals around 2I
// are recomputed from v and f, which L1/L2 hold for the neighbouring
// threads.
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
    out[q] = restrict_point(v, f, zc, yc, xc, lmf, lmc, wc, woff);
}

// K3: trilinear prolongation, one thread per fine point (prolong_point in
// stencil3d.cuh), with the optional fused correction out = v + P(c).
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
    const T e = prolong_point(c, zf, yf, xf, lmc);
    out[p] = v ? v[p] + e : e;
}

// K10: r = f - A v, replacing stencil3d.py residual (_residual_emit):
// A v = wc v + woff S(v~) on the interior, v on the boundary (identity
// rows), so boundary rows give f - v.  One thread per point in 32 x 8
// blocks, one z plane per grid slice, 32-bit indices.  v and f may be the
// same array (the JAX package forms A p as p - r(p, p)): both are only
// read, so neither pointer is __restrict__; out never aliases them.
template <typename T>
__global__ void residual_kernel(const T* v, const T* f, T* __restrict__ out,
                                int lm, T wc, T woff) {
    const int x = blockIdx.x * mg3d::kBx + threadIdx.x;
    const int y = blockIdx.y * mg3d::kBy + threadIdx.y;
    const int z = blockIdx.z;
    if (x >= lm || y >= lm) return;
    const int p = (z * lm + y) * lm + x;
    const T av = interior(z, y, x, lm)
                     ? wc * v[p] + woff * nbr_sum(v, p, z, y, x, lm)
                     : v[p];
    out[p] = f[p] - av;
}

// K11: one weighted-Jacobi sweep, replacing stencil3d.py jacobi_sweep
// (_jacobi_emit): out = keep v + w cand, with cand = (f + (-woff) S(v~))
// * inv_wc on the interior and f on the boundary (_gs_candidate), so
// boundary rows mix to (1-w) v + w f as the reference's Jacobi does.
// keep = 1-w, w, inv_wc = 1/wc and neg_woff arrive rounded to T by the
// wrapper.  Out of place: the smoother ping-pongs two buffers.
template <typename T>
__global__ void jacobi_kernel(const T* __restrict__ v,
                              const T* __restrict__ f, T* __restrict__ out,
                              int lm, T inv_wc, T neg_woff, T keep, T w) {
    const int x = blockIdx.x * mg3d::kBx + threadIdx.x;
    const int y = blockIdx.y * mg3d::kBy + threadIdx.y;
    const int z = blockIdx.z;
    if (x >= lm || y >= lm) return;
    const int p = (z * lm + y) * lm + x;
    const T cand = interior(z, y, x, lm)
                       ? (f[p] + neg_woff * nbr_sum(v, p, z, y, x, lm)) *
                             inv_wc
                       : f[p];
    out[p] = keep * v[p] + w * cand;
}

// K18: the two-step variational P^T restriction of a given fine r,
// replacing stencil3d.py restrict_pt (_restrict_kernel): r masked to the
// fine interior, [1 2 1]^3 / 8 combined z, then y, then x, the coarse
// boundary zeroed.  One thread per coarse point; the 27 fine values come
// through L1/L2.  Bound: memory, r read once and the coarse array written
// once.
template <typename T>
__global__ void restrict_pt_kernel(const T* __restrict__ r,
                                   T* __restrict__ out, int lmf, int lmc) {
    const long long n = (long long)lmc * lmc * lmc;
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    const int xc = (int)(q % lmc);
    const int yc = (int)((q / lmc) % lmc);
    const int zc = (int)(q / ((long long)lmc * lmc));
    const mg3d::MaskedSample<T> sample{r, lmf};
    out[q] = mg3d::restrict_combine<T>(sample, zc, yc, xc, lmc);
}

unsigned int blocks_for(long long n) {
    return (unsigned int)((n + kThreads - 1) / kThreads);
}

template <typename T>
int rb_half_sweep(const T* src, const T* f, T* out, int lm, T inv_wc,
                  T neg_woff, int color, cudaStream_t stream) {
    const unsigned int nb = blocks_for((long long)lm * lm * lm);
    rb_color_kernel<T><<<nb, kThreads, 0, stream>>>(src, f, out, lm, inv_wc,
                                                    neg_woff, color);
    return (int)cudaGetLastError();
}

// K1: red from v into out, then black in place on out.
template <typename T>
int rb_sweep(const T* v, const T* f, T* out, int lm, T inv_wc, T neg_woff,
             cudaStream_t stream) {
    const int err = rb_half_sweep<T>(v, f, out, lm, inv_wc, neg_woff, 0,
                                     stream);
    if (err != 0) return err;
    return rb_half_sweep<T>(out, f, out, lm, inv_wc, neg_woff, 1, stream);
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
int restrict_pt(const T* r, T* out, int lmf, int lmc, cudaStream_t stream) {
    const unsigned int nb = blocks_for((long long)lmc * lmc * lmc);
    restrict_pt_kernel<T><<<nb, kThreads, 0, stream>>>(r, out, lmf, lmc);
    return (int)cudaGetLastError();
}

template <typename T>
int prolong_linear(const T* c, const T* v, T* out, int lmc, int lmf,
                   cudaStream_t stream) {
    const unsigned int nb = blocks_for((long long)lmf * lmf * lmf);
    prolong_linear_kernel<T><<<nb, kThreads, 0, stream>>>(c, v, out, lmc, lmf);
    return (int)cudaGetLastError();
}

template <typename T>
int residual(const T* v, const T* f, T* out, int lm, T wc, T woff,
             cudaStream_t stream) {
    const dim3 block(mg3d::kBx, mg3d::kBy);
    residual_kernel<T><<<mg3d::grid_for(lm), block, 0, stream>>>(v, f, out,
                                                                 lm, wc, woff);
    return (int)cudaGetLastError();
}

template <typename T>
int jacobi_sweep(const T* v, const T* f, T* out, int lm, T inv_wc,
                 T neg_woff, T keep, T w, cudaStream_t stream) {
    const dim3 block(mg3d::kBx, mg3d::kBy);
    jacobi_kernel<T><<<mg3d::grid_for(lm), block, 0, stream>>>(
        v, f, out, lm, inv_wc, neg_woff, keep, w);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_residual_f32(const float* v, const float* f, float* out, int lm,
                    float wc, float woff, void* stream) {
    return residual<float>(v, f, out, lm, wc, woff, (cudaStream_t)stream);
}

int mg_residual_f64(const double* v, const double* f, double* out, int lm,
                    double wc, double woff, void* stream) {
    return residual<double>(v, f, out, lm, wc, woff, (cudaStream_t)stream);
}

int mg_jacobi_sweep_f32(const float* v, const float* f, float* out, int lm,
                        float inv_wc, float neg_woff, float keep, float w,
                        void* stream) {
    return jacobi_sweep<float>(v, f, out, lm, inv_wc, neg_woff, keep, w,
                               (cudaStream_t)stream);
}

int mg_jacobi_sweep_f64(const double* v, const double* f, double* out,
                        int lm, double inv_wc, double neg_woff, double keep,
                        double w, void* stream) {
    return jacobi_sweep<double>(v, f, out, lm, inv_wc, neg_woff, keep, w,
                                (cudaStream_t)stream);
}

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

// One colour; out may be src (in place).
int mg_rb_half_sweep_f32(const float* src, const float* f, float* out,
                         int lm, float inv_wc, float neg_woff, int color,
                         void* stream) {
    return rb_half_sweep<float>(src, f, out, lm, inv_wc, neg_woff, color,
                                (cudaStream_t)stream);
}

int mg_rb_half_sweep_f64(const double* src, const double* f, double* out,
                         int lm, double inv_wc, double neg_woff, int color,
                         void* stream) {
    return rb_half_sweep<double>(src, f, out, lm, inv_wc, neg_woff, color,
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

int mg_restrict_pt_f32(const float* r, float* out, int lmf, int lmc,
                       void* stream) {
    return restrict_pt<float>(r, out, lmf, lmc, (cudaStream_t)stream);
}

int mg_restrict_pt_f64(const double* r, double* out, int lmf, int lmc,
                       void* stream) {
    return restrict_pt<double>(r, out, lmf, lmc, (cudaStream_t)stream);
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
