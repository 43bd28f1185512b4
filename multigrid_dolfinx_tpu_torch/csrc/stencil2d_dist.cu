// Const-5-point kernels on a row strip of a distributed 2D level for
// Hopper (sm_90a): K30-K34 of the port, the row-decomposed forms of K6,
// K5, K7, K8 and K9.
//
// A rank holds `m` consecutive rows of an lm-wide level, contiguous and
// unpadded in columns.  Global row of local row 0 is row_base; rows at
// global index >= lm are plan padding and are written as 0.  The
// neighbours' rows arrive as separate small arrays, never concatenated
// onto the strip: `lo` holds the -row neighbour's last h rows (lo[h-1] is
// local row -1), `hi` the +row neighbour's first h rows (hi[0] is local
// row m), zeros at the domain edge.  Rows::row maps a local row in
// [-h, m + h) to its row in lo, the strip or hi, so the strip crosses
// memory once per kernel.  Interior masks and red-black parity use the
// global row.  Each point keeps the association order of stencil2d.cu
// (nbr_sum's ((i-1) + (i+1)) + (j-1)) + (j+1), K5's (keep v + nbr s) +
// wdf df, K8's rows-then-columns [1 2 1], K9's columns-then-rows
// midpoints), so a sweep stitched over the ranks is bitwise the
// single-device kernel's.
//
// One thread per output point in 32 x 8 blocks (32 consecutive columns a
// warp), as K5-K9: each kernel reads its operands once from device memory
// and takes the neighbours from L1/L2, and is bound by memory.  Row
// offsets are 64-bit.
//
// Each entry point is a plain C function: it launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBx = 32;
constexpr int kBy = 8;

__device__ __forceinline__ bool inside(int i, int lm) {
    return i >= 1 && i <= lm - 2;
}

// The local row window of one array: strip rows [0, m), halo rows [-h, 0)
// from lo and [m, m + h) from hi.
template <typename T>
struct Rows {
    const T* lo;
    const T* mid;
    const T* hi;
    int m, h, lm;

    __device__ __forceinline__ const T* row(int li) const {
        if (li < 0) return lo + (long long)(li + h) * lm;
        if (li >= m) return hi + (long long)(li - m) * lm;
        return mid + (long long)li * lm;
    }
};

// stencil2d.cu's nbr_sum through a window: the row neighbours come from
// local rows li -+ 1, the column ones from the point's own row.  gi is
// the point's global row.
template <typename T>
__device__ __forceinline__ T nbr_sum_win(const Rows<T>& w, int li, int gi,
                                         int j, int lm) {
    const T* c = w.row(li);
    const T im = inside(gi - 1, lm) ? w.row(li - 1)[j] : T(0);
    const T ip = inside(gi + 1, lm) ? w.row(li + 1)[j] : T(0);
    const T jm = inside(j - 1, lm) ? c[j - 1] : T(0);
    const T jp = inside(j + 1, lm) ? c[j + 1] : T(0);
    return ((im + ip) + jm) + jp;
}

// K6's red-black candidate at local row li: (f + S(v~)) * 0.25 inside, f
// on the boundary, 0 in the plan padding.
template <typename T>
__device__ __forceinline__ T gs_candidate(const Rows<T>& v, const Rows<T>& f,
                                          int li, int gi, int j, int lm) {
    if (gi >= lm) return T(0);
    const T fq = f.row(li)[j];
    if (!(inside(gi, lm) && inside(j, lm))) return fq;
    return (fq + nbr_sum_win(v, li, gi, j, lm)) * T(0.25);
}

// K30 red stage: red points ((gi + j) even) over local rows [-1, m] take
// the candidate from v; black points of the strip copy v.  The two halo
// rows' red values go to scratch (row 0: local row -1, row 1: local row
// m), where the black stage reads them.
template <typename T>
__global__ void rb_red_dist2_kernel(Rows<T> v, Rows<T> f, T* out, T* scratch,
                                    int lm, int row_base) {
    const int j = blockIdx.x * kBx + threadIdx.x;
    const int li = (int)(blockIdx.y * kBy + threadIdx.y) - 1;
    if (j >= lm || li > v.m) return;
    const int gi = row_base + li;
    const bool halo = li < 0 || li >= v.m;
    T* dst = halo ? scratch + (li < 0 ? 0 : lm) : out + (long long)li * lm;
    if (((gi + j) & 1) != 0) {
        if (!halo) dst[j] = gi >= lm ? T(0) : v.row(li)[j];
        return;
    }
    dst[j] = gs_candidate(v, f, li, gi, j, lm);
}

// K30 black stage, in place on out: black points of the strip take the
// candidate from the red values (out, and scratch for the halo rows).  A
// black point reads only red neighbours and writes only itself.
template <typename T>
__global__ void rb_black_dist2_kernel(Rows<T> red, Rows<T> f, T* out, int lm,
                                      int row_base) {
    const int j = blockIdx.x * kBx + threadIdx.x;
    const int li = blockIdx.y * kBy + threadIdx.y;
    if (j >= lm || li >= red.m) return;
    const int gi = row_base + li;
    if (((gi + j) & 1) != 1) return;
    out[(long long)li * lm + j] = gs_candidate(red, f, li, gi, j, lm);
}

// K31: one weighted-Jacobi sweep, K5's (keep v + nbr s) + wdf df with
// df = dinv f hoisted by the caller, out of place.
template <typename T>
__global__ void jacobi_dist2_kernel(Rows<T> v, const T* __restrict__ df,
                                    T* __restrict__ out, int lm, int row_base,
                                    T keep, T nbr, T wdf) {
    const int j = blockIdx.x * kBx + threadIdx.x;
    const int li = blockIdx.y * kBy + threadIdx.y;
    if (j >= lm || li >= v.m) return;
    const int gi = row_base + li;
    const long long p = (long long)li * lm + j;
    if (gi >= lm) {
        out[p] = T(0);
        return;
    }
    const T s = (inside(gi, lm) && inside(j, lm))
                    ? nbr_sum_win(v, li, gi, j, lm)
                    : T(0);
    out[p] = (keep * v.mid[p] + nbr * s) + wdf * df[p];
}

// K32: r = f - A v (K7's arithmetic; boundary rows f - v).
template <typename T>
__global__ void residual_dist2_kernel(Rows<T> v, const T* __restrict__ f,
                                      T* __restrict__ out, int lm,
                                      int row_base) {
    const int j = blockIdx.x * kBx + threadIdx.x;
    const int li = blockIdx.y * kBy + threadIdx.y;
    if (j >= lm || li >= v.m) return;
    const int gi = row_base + li;
    const long long p = (long long)li * lm + j;
    if (gi >= lm) {
        out[p] = T(0);
        return;
    }
    const T vq = v.mid[p];
    const T av = (inside(gi, lm) && inside(j, lm))
                     ? T(4) * vq - nbr_sum_win(v, li, gi, j, lm)
                     : vq;
    out[p] = f[p] - av;
}

// The fine residual masked to the fine interior (global row gi).
template <typename T>
__device__ __forceinline__ T masked(const Rows<T>& r, int li, int gi, int j,
                                    int lmf) {
    return (inside(gi, lmf) && inside(j, lmf)) ? r.row(li)[j] : T(0);
}

// K33: K8's P^T restriction, one thread per coarse point of the local
// coarse rows (global coarse row row_base / 2 + ic): [1 2 1] along rows,
// then along columns, of the masked fine residual around local fine row
// 2 ic, times 0.25; 0 off the coarse interior.  Coarse row ic reads fine
// rows 2 ic - 1 .. 2 ic + 1 <= m - 1, so only the -row halo is read.
template <typename T>
__global__ void restrict_pt_dist2_kernel(Rows<T> r, T* __restrict__ out,
                                         int mc, int lmf, int lmc,
                                         int row_base) {
    const int jc = blockIdx.x * kBx + threadIdx.x;
    const int ic = blockIdx.y * kBy + threadIdx.y;
    if (jc >= lmc || ic >= mc) return;
    const long long q = (long long)ic * lmc + jc;
    if (!(inside(row_base / 2 + ic, lmc) && inside(jc, lmc))) {
        out[q] = T(0);
        return;
    }
    const int li = 2 * ic, gi = row_base + li, j = 2 * jc;
    T rows[3];
    for (int dj = -1; dj <= 1; ++dj) {
        rows[dj + 1] = (masked(r, li - 1, gi - 1, j + dj, lmf) +
                        T(2) * masked(r, li, gi, j + dj, lmf)) +
                       masked(r, li + 1, gi + 1, j + dj, lmf);
    }
    out[q] = ((rows[0] + T(2) * rows[1]) + rows[2]) * T(0.25);
}

// K9's column interpolation of one coarse row at fine column jf.
template <typename T>
__device__ __forceinline__ T interp_col(const T* __restrict__ row, int jf) {
    if ((jf & 1) == 0) return row[jf >> 1];
    return T(0.5) * (row[jf >> 1] + row[(jf >> 1) + 1]);
}

// K34: K9's bilinear prolongation of the local coarse strip (columns,
// then rows) with the optional correction out = v + P(c).  The last odd
// fine row interpolates towards chi, the +row neighbour's first coarse
// row.  Fine rows at global index >= lmf get P(c) = 0.
template <typename T>
__global__ void prolong_add_dist2_kernel(const T* __restrict__ c,
                                         const T* __restrict__ chi,
                                         const T* __restrict__ v,
                                         T* __restrict__ out, int mc, int lmc,
                                         int lmf, int row_base) {
    const int j = blockIdx.x * kBx + threadIdx.x;
    const int li = blockIdx.y * kBy + threadIdx.y;
    if (j >= lmf || li >= 2 * mc) return;
    const long long p = (long long)li * lmf + j;
    T e = T(0);
    if (row_base + li <= lmf - 1) {
        const int k = li >> 1;
        const T* c0 = c + (long long)k * lmc;
        if ((li & 1) == 0) {
            e = interp_col(c0, j);
        } else {
            const T* c1 = k + 1 < mc ? c0 + lmc : chi;
            e = T(0.5) * (interp_col(c0, j) + interp_col(c1, j));
        }
    }
    out[p] = v ? v[p] + e : e;
}

dim3 grid_for(int cols, int rows) {
    return dim3((unsigned int)((cols + kBx - 1) / kBx),
                (unsigned int)((rows + kBy - 1) / kBy));
}

const dim3 kBlock(kBx, kBy);

template <typename T>
Rows<T> window(const T* lo, const T* mid, const T* hi, int m, int h, int lm) {
    return Rows<T>{lo, mid, hi, m, h, lm};
}

template <typename T>
int rb_sweep_dist2(const T* v, const T* f, const T* vlo, const T* vhi,
                   const T* flo, const T* fhi, T* out, T* scratch, int m,
                   int lm, int row_base, cudaStream_t stream) {
    const Rows<T> fw = window(flo, f, fhi, m, 2, lm);
    rb_red_dist2_kernel<T><<<grid_for(lm, m + 2), kBlock, 0, stream>>>(
        window(vlo, v, vhi, m, 2, lm), fw, out, scratch, lm, row_base);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // the red window: the strip from out, local rows -1 and m from scratch
    const Rows<T> rw = window<T>(scratch, out, scratch + lm, m, 1, lm);
    rb_black_dist2_kernel<T><<<grid_for(lm, m), kBlock, 0, stream>>>(
        rw, fw, out, lm, row_base);
    return (int)cudaGetLastError();
}

template <typename T>
int jacobi_sweep_dist2(const T* v, const T* df, const T* vlo, const T* vhi,
                       T* out, int m, int lm, int row_base, T keep, T nbr,
                       T wdf, cudaStream_t stream) {
    jacobi_dist2_kernel<T><<<grid_for(lm, m), kBlock, 0, stream>>>(
        window(vlo, v, vhi, m, 1, lm), df, out, lm, row_base, keep, nbr, wdf);
    return (int)cudaGetLastError();
}

template <typename T>
int residual_dist2(const T* v, const T* f, const T* vlo, const T* vhi, T* out,
                   int m, int lm, int row_base, cudaStream_t stream) {
    residual_dist2_kernel<T><<<grid_for(lm, m), kBlock, 0, stream>>>(
        window(vlo, v, vhi, m, 1, lm), f, out, lm, row_base);
    return (int)cudaGetLastError();
}

template <typename T>
int restrict_pt_dist2(const T* r, const T* rlo, T* out, int m, int lmf,
                      int lmc, int row_base, cudaStream_t stream) {
    const int mc = m / 2;
    restrict_pt_dist2_kernel<T><<<grid_for(lmc, mc), kBlock, 0, stream>>>(
        window<T>(rlo, r, nullptr, m, 1, lmf), out, mc, lmf, lmc, row_base);
    return (int)cudaGetLastError();
}

template <typename T>
int prolong_add_dist2(const T* c, const T* chi, const T* v, T* out, int mc,
                      int lmc, int lmf, int row_base, cudaStream_t stream) {
    prolong_add_dist2_kernel<T><<<grid_for(lmf, 2 * mc), kBlock, 0, stream>>>(
        c, chi, v, out, mc, lmc, lmf, row_base);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_rb_sweep_dist_2d_f32(const float* v, const float* f, const float* vlo,
                          const float* vhi, const float* flo,
                          const float* fhi, float* out, float* scratch, int m,
                          int lm, int row_base, void* stream) {
    return rb_sweep_dist2<float>(v, f, vlo, vhi, flo, fhi, out, scratch, m,
                                 lm, row_base, (cudaStream_t)stream);
}

int mg_rb_sweep_dist_2d_f64(const double* v, const double* f, const double* vlo,
                          const double* vhi, const double* flo,
                          const double* fhi, double* out, double* scratch,
                          int m, int lm, int row_base, void* stream) {
    return rb_sweep_dist2<double>(v, f, vlo, vhi, flo, fhi, out, scratch, m,
                                  lm, row_base, (cudaStream_t)stream);
}

int mg_jacobi_sweep_dist_2d_f32(const float* v, const float* df,
                              const float* vlo, const float* vhi, float* out,
                              int m, int lm, int row_base, float keep,
                              float nbr, float wdf, void* stream) {
    return jacobi_sweep_dist2<float>(v, df, vlo, vhi, out, m, lm, row_base,
                                     keep, nbr, wdf, (cudaStream_t)stream);
}

int mg_jacobi_sweep_dist_2d_f64(const double* v, const double* df,
                              const double* vlo, const double* vhi,
                              double* out, int m, int lm, int row_base,
                              double keep, double nbr, double wdf,
                              void* stream) {
    return jacobi_sweep_dist2<double>(v, df, vlo, vhi, out, m, lm, row_base,
                                      keep, nbr, wdf, (cudaStream_t)stream);
}

int mg_residual_dist_2d_f32(const float* v, const float* f, const float* vlo,
                          const float* vhi, float* out, int m, int lm,
                          int row_base, void* stream) {
    return residual_dist2<float>(v, f, vlo, vhi, out, m, lm, row_base,
                                 (cudaStream_t)stream);
}

int mg_residual_dist_2d_f64(const double* v, const double* f, const double* vlo,
                          const double* vhi, double* out, int m, int lm,
                          int row_base, void* stream) {
    return residual_dist2<double>(v, f, vlo, vhi, out, m, lm, row_base,
                                  (cudaStream_t)stream);
}

int mg_restrict_pt_dist_2d_f32(const float* r, const float* rlo, float* out,
                             int m, int lmf, int lmc, int row_base,
                             void* stream) {
    return restrict_pt_dist2<float>(r, rlo, out, m, lmf, lmc, row_base,
                                    (cudaStream_t)stream);
}

int mg_restrict_pt_dist_2d_f64(const double* r, const double* rlo, double* out,
                             int m, int lmf, int lmc, int row_base,
                             void* stream) {
    return restrict_pt_dist2<double>(r, rlo, out, m, lmf, lmc, row_base,
                                     (cudaStream_t)stream);
}

// v may be NULL: then out = P(c).
int mg_prolong_add_dist_2d_f32(const float* c, const float* chi, const float* v,
                             float* out, int mc, int lmc, int lmf,
                             int row_base, void* stream) {
    return prolong_add_dist2<float>(c, chi, v, out, mc, lmc, lmf, row_base,
                                    (cudaStream_t)stream);
}

int mg_prolong_add_dist_2d_f64(const double* c, const double* chi,
                             const double* v, double* out, int mc, int lmc,
                             int lmf, int row_base, void* stream) {
    return prolong_add_dist2<double>(c, chi, v, out, mc, lmc, lmf, row_base,
                                     (cudaStream_t)stream);
}

}  // extern "C"
