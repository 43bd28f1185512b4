// Const-5-point multigrid kernels for Hopper (sm_90a): K5-K9 of the port.
//
// The operator is the 2D P1 stiffness (-1, -1, 4, -1, -1) with Dirichlet
// identity rows.  Storage is the logical lm^2 node box, C-order (row i,
// column j), contiguous and unpadded; interior means 1 <= index <= lm-2
// on both axes.  Every sum keeps the association order of the Pallas TPU
// kernels of multigrid_dolfinx_tpu/ops/pallas/stencil2d.py, and the
// library is built with --fmad=false, so each kernel agrees bitwise with
// its plain PyTorch version (ops/cuda/stencil2d.py, *_ref).  The Pallas
// kernels let rolls wrap onto zero tile padding; here every out-of-box or
// boundary neighbour is masked explicitly.
//
// One thread per output point, 32 x 8 thread blocks (32 consecutive
// columns per warp, so every load and store is coalesced).  Each kernel
// is bound by memory: it reads its operands once from device memory and
// takes the four neighbours from L1/L2.  Indices are 32-bit: the wrapper
// refuses lm > 46340, so lm^2 fits.
//
// Each entry point is a plain C function: it launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBx = 32;
constexpr int kBy = 8;

__device__ __forceinline__ bool inside(int i, int lm) {
    return i >= 1 && i <= lm - 2;
}

// S(v~) = v~[i-1,j] + v~[i+1,j] + v~[i,j-1] + v~[i,j+1] at interior point
// (i, j), in that order (stencil2d.py _neighbor_sum); v~ is v masked to
// the interior, so boundary neighbours read as 0.
template <typename T>
__device__ __forceinline__ T nbr_sum(const T* v, int p, int i, int j,
                                     int lm) {
    const T im = inside(i - 1, lm) ? v[p - lm] : T(0);
    const T ip = inside(i + 1, lm) ? v[p + lm] : T(0);
    const T jm = inside(j - 1, lm) ? v[p - 1] : T(0);
    const T jp = inside(j + 1, lm) ? v[p + 1] : T(0);
    return ((im + ip) + jm) + jp;
}

// K5: one weighted-Jacobi sweep, replacing stencil2d.py jacobi_sweep.
// out = (keep v + nbr s) + wdf df with keep = 1-w, nbr = w/4, wdf = w
// rounded once to T by the wrapper, s = S(v~) inside and 0 on the
// boundary, so boundary rows mix: (1-w) v + w df (the reference's
// jacobiRelaxation with identity rows).  df = dinv * f is hoisted by the
// caller, once per smoothing call.
template <typename T>
__global__ void jacobi_kernel(const T* __restrict__ v,
                              const T* __restrict__ df, T* __restrict__ out,
                              int lm, T keep, T nbr, T wdf) {
    const int j = blockIdx.x * kBx + threadIdx.x;
    const int i = blockIdx.y * kBy + threadIdx.y;
    if (i >= lm || j >= lm) return;
    const int p = i * lm + j;
    const T s = (inside(i, lm) && inside(j, lm)) ? nbr_sum(v, p, i, j, lm)
                                                 : T(0);
    out[p] = (keep * v[p] + nbr * s) + wdf * df[p];
}

// K6: one colour of the red-black Gauss-Seidel sweep, replacing the two
// stages of stencil2d.py rb_sweep.  Points of `color` ((i+j) % 2 ==
// color) take (f + S(v~)) * 0.25 inside and f on the boundary; the others
// copy src.  The red launch reads v and writes out; the black launch runs
// in place on out (src == out): a black point reads only red neighbours
// and writes only itself, so the in-place update has no race.
template <typename T>
__global__ void rb_color_kernel(const T* src, const T* __restrict__ f, T* out,
                                int lm, int color) {
    const int j = blockIdx.x * kBx + threadIdx.x;
    const int i = blockIdx.y * kBy + threadIdx.y;
    if (i >= lm || j >= lm) return;
    const int p = i * lm + j;
    if (((i + j) & 1) != color) {
        if (src != out) out[p] = src[p];
        return;
    }
    if (!(inside(i, lm) && inside(j, lm))) {
        out[p] = f[p];
        return;
    }
    out[p] = (f[p] + nbr_sum(src, p, i, j, lm)) * T(0.25);
}

// K7: r = f - A v, replacing stencil2d.py residual: A v = 4 v~ - S(v~)
// inside, v on the boundary (identity rows).
template <typename T>
__global__ void residual_kernel(const T* __restrict__ v,
                                const T* __restrict__ f, T* __restrict__ out,
                                int lm) {
    const int j = blockIdx.x * kBx + threadIdx.x;
    const int i = blockIdx.y * kBy + threadIdx.y;
    if (i >= lm || j >= lm) return;
    const int p = i * lm + j;
    const T av = (inside(i, lm) && inside(j, lm))
                     ? T(4) * v[p] - nbr_sum(v, p, i, j, lm)
                     : v[p];
    out[p] = f[p] - av;
}

// The fine residual masked to the fine interior (the 'pt' correction
// equation drops the boundary residual).
template <typename T>
__device__ __forceinline__ T masked(const T* __restrict__ r, int i, int j,
                                    int lmf) {
    return (inside(i, lmf) && inside(j, lmf)) ? r[i * lmf + j] : T(0);
}

// K8: variational P^T restriction, replacing stencil2d.py restrict_pt.
// One thread per coarse point (I, J): [1 2 1] along rows, then along
// columns, of the masked fine residual around (2I, 2J), times 0.25
// (P^T = 4 x full weighting / 16); 0 outside the coarse interior.
template <typename T>
__global__ void restrict_pt_kernel(const T* __restrict__ r,
                                   T* __restrict__ out, int lmf, int lmc) {
    const int jc = blockIdx.x * kBx + threadIdx.x;
    const int ic = blockIdx.y * kBy + threadIdx.y;
    if (ic >= lmc || jc >= lmc) return;
    const int q = ic * lmc + jc;
    if (!(inside(ic, lmc) && inside(jc, lmc))) {
        out[q] = T(0);
        return;
    }
    const int i = 2 * ic, j = 2 * jc;
    T rows[3];
    for (int dj = -1; dj <= 1; ++dj) {
        rows[dj + 1] = (masked(r, i - 1, j + dj, lmf) +
                        T(2) * masked(r, i, j + dj, lmf)) +
                       masked(r, i + 1, j + dj, lmf);
    }
    out[q] = ((rows[0] + T(2) * rows[1]) + rows[2]) * T(0.25);
}

// K9: bilinear prolongation, replacing stencil2d.py prolong_linear.  One
// thread per fine point; columns are interpolated first, then rows, each
// midpoint as 0.5 * (a + b).
template <typename T>
__device__ __forceinline__ T interp_col(const T* __restrict__ c, int ic,
                                        int jf, int lmc) {
    const T* row = c + ic * lmc;
    if ((jf & 1) == 0) return row[jf >> 1];
    return T(0.5) * (row[jf >> 1] + row[(jf >> 1) + 1]);
}

template <typename T>
__global__ void prolong_linear_kernel(const T* __restrict__ c,
                                      T* __restrict__ out, int lmc, int lmf) {
    const int j = blockIdx.x * kBx + threadIdx.x;
    const int i = blockIdx.y * kBy + threadIdx.y;
    if (i >= lmf || j >= lmf) return;
    T e;
    if ((i & 1) == 0) {
        e = interp_col(c, i >> 1, j, lmc);
    } else {
        e = T(0.5) * (interp_col(c, i >> 1, j, lmc) +
                      interp_col(c, (i >> 1) + 1, j, lmc));
    }
    out[i * lmf + j] = e;
}

dim3 grid_for(int lm) {
    return dim3((unsigned int)((lm + kBx - 1) / kBx),
                (unsigned int)((lm + kBy - 1) / kBy));
}

const dim3 kBlock(kBx, kBy);

template <typename T>
int jacobi_sweep(const T* v, const T* df, T* out, int lm, T keep, T nbr,
                 T wdf, cudaStream_t stream) {
    jacobi_kernel<T><<<grid_for(lm), kBlock, 0, stream>>>(v, df, out, lm,
                                                          keep, nbr, wdf);
    return (int)cudaGetLastError();
}

template <typename T>
int rb_sweep(const T* v, const T* f, T* out, int lm, cudaStream_t stream) {
    rb_color_kernel<T><<<grid_for(lm), kBlock, 0, stream>>>(v, f, out, lm, 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rb_color_kernel<T><<<grid_for(lm), kBlock, 0, stream>>>(out, f, out, lm,
                                                            1);
    return (int)cudaGetLastError();
}

template <typename T>
int residual(const T* v, const T* f, T* out, int lm, cudaStream_t stream) {
    residual_kernel<T><<<grid_for(lm), kBlock, 0, stream>>>(v, f, out, lm);
    return (int)cudaGetLastError();
}

template <typename T>
int restrict_pt(const T* r, T* out, int lmf, int lmc, cudaStream_t stream) {
    restrict_pt_kernel<T><<<grid_for(lmc), kBlock, 0, stream>>>(r, out, lmf,
                                                                lmc);
    return (int)cudaGetLastError();
}

template <typename T>
int prolong_linear(const T* c, T* out, int lmc, int lmf,
                   cudaStream_t stream) {
    prolong_linear_kernel<T><<<grid_for(lmf), kBlock, 0, stream>>>(c, out,
                                                                   lmc, lmf);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_jacobi_sweep_2d_f32(const float* v, const float* df, float* out,
                           int lm, float keep, float nbr, float wdf,
                           void* stream) {
    return jacobi_sweep<float>(v, df, out, lm, keep, nbr, wdf,
                               (cudaStream_t)stream);
}

int mg_jacobi_sweep_2d_f64(const double* v, const double* df, double* out,
                           int lm, double keep, double nbr, double wdf,
                           void* stream) {
    return jacobi_sweep<double>(v, df, out, lm, keep, nbr, wdf,
                                (cudaStream_t)stream);
}

int mg_rb_sweep_2d_f32(const float* v, const float* f, float* out, int lm,
                       void* stream) {
    return rb_sweep<float>(v, f, out, lm, (cudaStream_t)stream);
}

int mg_rb_sweep_2d_f64(const double* v, const double* f, double* out, int lm,
                       void* stream) {
    return rb_sweep<double>(v, f, out, lm, (cudaStream_t)stream);
}

int mg_residual_2d_f32(const float* v, const float* f, float* out, int lm,
                       void* stream) {
    return residual<float>(v, f, out, lm, (cudaStream_t)stream);
}

int mg_residual_2d_f64(const double* v, const double* f, double* out, int lm,
                       void* stream) {
    return residual<double>(v, f, out, lm, (cudaStream_t)stream);
}

int mg_restrict_pt_2d_f32(const float* r, float* out, int lmf, int lmc,
                          void* stream) {
    return restrict_pt<float>(r, out, lmf, lmc, (cudaStream_t)stream);
}

int mg_restrict_pt_2d_f64(const double* r, double* out, int lmf, int lmc,
                          void* stream) {
    return restrict_pt<double>(r, out, lmf, lmc, (cudaStream_t)stream);
}

int mg_prolong_linear_2d_f32(const float* c, float* out, int lmc, int lmf,
                             void* stream) {
    return prolong_linear<float>(c, out, lmc, lmf, (cudaStream_t)stream);
}

int mg_prolong_linear_2d_f64(const double* c, double* out, int lmc, int lmf,
                             void* stream) {
    return prolong_linear<double>(c, out, lmc, lmf, (cudaStream_t)stream);
}

}  // extern "C"
