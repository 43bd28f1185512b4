// Const-7-point kernels on a z-slab of a distributed level for Hopper
// (sm_90a): K25-K29 of the port, the z-decomposed forms of K1, K11, K10,
// K2 and K3.
//
// A rank holds the local block of `mz` z-slabs of an lm x lm plane each,
// contiguous and unpadded in y and x.  Global z of local slab 0 is z_base;
// rows at global z >= lm are plan padding and are written as 0.  The
// z-neighbours' slabs arrive as separate small arrays, never concatenated
// onto the block: `lo` holds the -z neighbour's top h slabs (lo[h-1] is
// local z = -1), `hi` the +z neighbour's bottom h slabs (hi[0] is local
// z = mz), zeros at the domain edge.  Window::plane maps a local z in
// [-h, mz + h) to its plane in lo, the block or hi, so the block crosses
// memory once per kernel.  Interior masks and red-black parity use the
// global z.  Each point keeps the association order of stencil3d.cu
// (nbr_sum's (z-1)+(z+1)+(y-1)+(y+1)+(x-1)+(x+1), restrict_combine,
// interp_xy), so a sweep stitched over the ranks is bitwise the
// single-device kernel's.
//
// Each entry point is a plain C function: it launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "stencil3d.cuh"

namespace {

using mg3d::inside;
using mg3d::interior;
using mg3d::kBx;
using mg3d::kBy;

// The local z-window of one array: block planes [0, mz), halo planes
// [-h, 0) from lo and [mz, mz + h) from hi.
template <typename T>
struct Window {
    const T* lo;
    const T* mid;
    const T* hi;
    int mz, h;
    long long plane_size;

    __device__ __forceinline__ const T* plane(int lz) const {
        if (lz < 0) return lo + (long long)(lz + h) * plane_size;
        if (lz >= mz) return hi + (long long)(lz - mz) * plane_size;
        return mid + (long long)lz * plane_size;
    }
};

// nbr_sum of stencil3d.cuh through a window: the z-neighbours come from
// the planes at local z -+ 1, the in-plane ones from the point's own
// plane `c` at in-plane offset q.  gz is the point's global z.
template <typename T>
__device__ __forceinline__ T nbr_sum_win(const Window<T>& w, int lz, int gz,
                                         int y, int x, long long q, int lm) {
    const T* c = w.plane(lz);
    T zm = inside(gz - 1, lm) ? w.plane(lz - 1)[q] : T(0);
    T zp = inside(gz + 1, lm) ? w.plane(lz + 1)[q] : T(0);
    T ym = inside(y - 1, lm) ? c[q - lm] : T(0);
    T yp = inside(y + 1, lm) ? c[q + lm] : T(0);
    T xm = inside(x - 1, lm) ? c[q - 1] : T(0);
    T xp = inside(x + 1, lm) ? c[q + 1] : T(0);
    return ((((zm + zp) + ym) + yp) + xm) + xp;
}

// The red-black candidate of K1 at local z lz: (f + (-woff) S) (1/wc)
// inside, f on the boundary, 0 in the plan padding.
template <typename T>
__device__ __forceinline__ T gs_candidate(const Window<T>& v,
                                          const Window<T>& f, int lz, int gz,
                                          int y, int x, long long q, int lm,
                                          T inv_wc, T neg_woff) {
    if (gz >= lm) return T(0);
    const T fq = f.plane(lz)[q];
    if (!interior(gz, y, x, lm)) return fq;
    return (fq + neg_woff * nbr_sum_win(v, lz, gz, y, x, q, lm)) * inv_wc;
}

// K25 red stage: red points ((x+y+gz) even) over local z in [-1, mz]
// take the candidate from v; black points of the block copy v.  The two
// halo planes' red values go to scratch (plane 0: local z -1, plane 1:
// local z mz), where the black stage reads them.
template <typename T>
__global__ void rb_red_dist_kernel(Window<T> v, Window<T> f, T* out,
                                   T* scratch, int lm, int z_base, T inv_wc,
                                   T neg_woff) {
    const int x = blockIdx.x * kBx + threadIdx.x;
    const int y = blockIdx.y * kBy + threadIdx.y;
    const int lz = (int)blockIdx.z - 1;
    if (x >= lm || y >= lm) return;
    const int gz = z_base + lz;
    const long long q = (long long)y * lm + x;
    const bool halo = lz < 0 || lz >= v.mz;
    T* dst = halo ? scratch + (lz < 0 ? 0 : v.plane_size)
                  : out + (long long)lz * v.plane_size;
    if (((x + y + gz) & 1) != 0) {
        if (!halo) dst[q] = gz >= lm ? T(0) : v.plane(lz)[q];
        return;
    }
    dst[q] = gs_candidate(v, f, lz, gz, y, x, q, lm, inv_wc, neg_woff);
}

// K25 black stage, in place on out: black points of the block take the
// candidate from the red values (out, and scratch for the halo planes).
// A black point reads only red neighbours and writes only itself.
template <typename T>
__global__ void rb_black_dist_kernel(Window<T> red, Window<T> f, T* out,
                                     int lm, int z_base, T inv_wc,
                                     T neg_woff) {
    const int x = blockIdx.x * kBx + threadIdx.x;
    const int y = blockIdx.y * kBy + threadIdx.y;
    const int lz = blockIdx.z;
    if (x >= lm || y >= lm) return;
    const int gz = z_base + lz;
    if (((x + y + gz) & 1) != 1) return;
    const long long q = (long long)y * lm + x;
    out[(long long)lz * red.plane_size + q] =
        gs_candidate(red, f, lz, gz, y, x, q, lm, inv_wc, neg_woff);
}

// K26: one weighted-Jacobi sweep (K11's keep v + w cand), out of place.
template <typename T>
__global__ void jacobi_dist_kernel(Window<T> v, Window<T> f,
                                   T* __restrict__ out, int lm, int z_base,
                                   T inv_wc, T neg_woff, T keep, T w) {
    const int x = blockIdx.x * kBx + threadIdx.x;
    const int y = blockIdx.y * kBy + threadIdx.y;
    const int lz = blockIdx.z;
    if (x >= lm || y >= lm) return;
    const int gz = z_base + lz;
    const long long q = (long long)y * lm + x;
    T* dst = out + (long long)lz * v.plane_size + q;
    if (gz >= lm) {
        *dst = T(0);
        return;
    }
    const T cand = gs_candidate(v, f, lz, gz, y, x, q, lm, inv_wc, neg_woff);
    *dst = keep * v.plane(lz)[q] + w * cand;
}

// K27: r = f - A v (K10's arithmetic; boundary rows f - v).
template <typename T>
__global__ void residual_dist_kernel(Window<T> v, Window<T> f,
                                     T* __restrict__ out, int lm, int z_base,
                                     T wc, T woff) {
    const int x = blockIdx.x * kBx + threadIdx.x;
    const int y = blockIdx.y * kBy + threadIdx.y;
    const int lz = blockIdx.z;
    if (x >= lm || y >= lm) return;
    const int gz = z_base + lz;
    const long long q = (long long)y * lm + x;
    T* dst = out + (long long)lz * v.plane_size + q;
    if (gz >= lm) {
        *dst = T(0);
        return;
    }
    const T vq = v.plane(lz)[q];
    const T av = interior(gz, y, x, lm)
                     ? wc * vq + woff * nbr_sum_win(v, lz, gz, y, x, q, lm)
                     : vq;
    *dst = f.plane(lz)[q] - av;
}

// mg3d::masked_residual through windows, as a restriction sample taking
// global fine coordinates: K28's rows at the block's ends.
template <typename T>
struct WindowResidualSample {
    Window<T> v, f;
    int lm, z_base;
    T wc, woff;
    __device__ __forceinline__ T operator()(int gz, int y, int x) const {
        if (!interior(gz, y, x, lm)) return T(0);
        const int lz = gz - z_base;
        const long long q = (long long)y * lm + x;
        const T av = wc * v.plane(lz)[q] +
                     woff * nbr_sum_win(v, lz, gz, y, x, q, lm);
        return f.plane(lz)[q] - av;
    }
};

// mg3d::masked_residual on the block itself (mg3d::nbr_sum addressed by
// the local index, masked by the global z): K28's inner rows, whose
// samples and their neighbours all lie in the block.
template <typename T>
struct BlockResidualSample {
    const T* v;
    const T* f;
    int lm, z_base;
    T wc, woff;
    __device__ __forceinline__ T operator()(int gz, int y, int x) const {
        if (!interior(gz, y, x, lm)) return T(0);
        const long long p = ((long long)(gz - z_base) * lm + y) * lm + x;
        const T av = wc * v[p] + woff * mg3d::nbr_sum(v, p, gz, y, x, lm);
        return f[p] - av;
    }
};

// K28: fused residual + P^T restriction (K2's restrict_combine), one
// thread per coarse point of the local coarse rows row0 + k row_step,
// k < nrows, in K2's 1D blocks of kThreads; the coarse block's global z
// starts at z_base / 2 (z_base is even).  One instantiation per sample:
// the windowed one for the two end rows, the block one for the rest.
template <typename T, typename Sample>
__global__ void restrict_residual_pt_dist_kernel(Sample sample,
                                                 T* __restrict__ out,
                                                 int lmc, int row0,
                                                 int row_step, int nrows) {
    const long long plane = (long long)lmc * lmc;
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= nrows * plane) return;
    const int xc = (int)(q % lmc);
    const int yc = (int)((q / lmc) % lmc);
    const int lzc = row0 + (int)(q / plane) * row_step;
    out[lzc * plane + (long long)yc * lmc + xc] = mg3d::restrict_combine<T>(
        sample, sample.z_base / 2 + lzc, yc, xc, lmc);
}

// K29: trilinear prolongation of the local coarse block (K3's interp_xy
// order: x, then y, then z) with the optional correction out = v + P(c).
// The top fine pair interpolates towards chi, the +z neighbour's first
// coarse plane.  Fine rows at global z >= lmf get P(c) = 0.
template <typename T>
__global__ void prolong_linear_dist_kernel(const T* __restrict__ c,
                                           const T* __restrict__ chi,
                                           const T* __restrict__ v,
                                           T* __restrict__ out, int mzc,
                                           int lmc, int lmf, int z_base) {
    const int xf = blockIdx.x * kBx + threadIdx.x;
    const int yf = blockIdx.y * kBy + threadIdx.y;
    const int lzf = blockIdx.z;
    if (xf >= lmf || yf >= lmf) return;
    const long long cplane = (long long)lmc * lmc;
    const long long p = ((long long)lzf * lmf + yf) * lmf + xf;
    T e = T(0);
    if (z_base + lzf <= lmf - 1) {
        const int kz = lzf >> 1;
        const T* c0 = c + kz * cplane;
        if ((lzf & 1) == 0) {
            e = mg3d::interp_xy(c0, 0, yf, xf, lmc);
        } else {
            const T* c1 = kz + 1 < mzc ? c0 + cplane : chi;
            e = T(0.5) * (mg3d::interp_xy(c0, 0, yf, xf, lmc) +
                          mg3d::interp_xy(c1, 0, yf, xf, lmc));
        }
    }
    out[p] = v ? v[p] + e : e;
}

constexpr int kThreads = 256;

unsigned int blocks_for(long long n) {
    return (unsigned int)((n + kThreads - 1) / kThreads);
}

dim3 grid_for(int lm, int nz) {
    return dim3((unsigned int)((lm + kBx - 1) / kBx),
                (unsigned int)((lm + kBy - 1) / kBy), (unsigned int)nz);
}

template <typename T>
Window<T> window(const T* lo, const T* mid, const T* hi, int mz, int h,
                 int lm) {
    return Window<T>{lo, mid, hi, mz, h, (long long)lm * lm};
}

template <typename T>
int rb_sweep_dist(const T* v, const T* f, const T* vlo, const T* vhi,
                  const T* flo, const T* fhi, T* out, T* scratch, int mz,
                  int lm, int z_base, T inv_wc, T neg_woff,
                  cudaStream_t stream) {
    const dim3 block(kBx, kBy);
    const Window<T> fw = window(flo, f, fhi, mz, 2, lm);
    rb_red_dist_kernel<T><<<grid_for(lm, mz + 2), block, 0, stream>>>(
        window(vlo, v, vhi, mz, 2, lm), fw, out, scratch, lm, z_base, inv_wc,
        neg_woff);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // the red window: the block from out, local z -1 and mz from scratch
    const T* red = out;
    const Window<T> rw{scratch, red, scratch + (long long)lm * lm, mz, 1,
                       (long long)lm * lm};
    rb_black_dist_kernel<T><<<grid_for(lm, mz), block, 0, stream>>>(
        rw, fw, out, lm, z_base, inv_wc, neg_woff);
    return (int)cudaGetLastError();
}

template <typename T>
int jacobi_sweep_dist(const T* v, const T* f, const T* vlo, const T* vhi,
                      const T* flo, const T* fhi, T* out, int mz, int lm,
                      int z_base, T inv_wc, T neg_woff, T keep, T w,
                      cudaStream_t stream) {
    jacobi_dist_kernel<T><<<grid_for(lm, mz), dim3(kBx, kBy), 0, stream>>>(
        window(vlo, v, vhi, mz, 1, lm), window(flo, f, fhi, mz, 1, lm), out,
        lm, z_base, inv_wc, neg_woff, keep, w);
    return (int)cudaGetLastError();
}

template <typename T>
int residual_dist(const T* v, const T* f, const T* vlo, const T* vhi,
                  const T* flo, const T* fhi, T* out, int mz, int lm,
                  int z_base, T wc, T woff, cudaStream_t stream) {
    residual_dist_kernel<T><<<grid_for(lm, mz), dim3(kBx, kBy), 0, stream>>>(
        window(vlo, v, vhi, mz, 1, lm), window(flo, f, fhi, mz, 1, lm), out,
        lm, z_base, wc, woff);
    return (int)cudaGetLastError();
}

template <typename T>
int restrict_residual_pt_dist(const T* v, const T* f, const T* vlo,
                              const T* vhi, const T* flo, const T* fhi,
                              T* out, int mz, int lmf, int lmc, int z_base,
                              T wc, T woff, cudaStream_t stream) {
    const int mzc = mz / 2;
    const long long plane = (long long)lmc * lmc;
    const WindowResidualSample<T> ends{window(vlo, v, vhi, mz, 2, lmf),
                                       window(flo, f, fhi, mz, 2, lmf), lmf,
                                       z_base, wc, woff};
    // rows 0 and mzc - 1 (one row when mzc == 1)
    const int nends = mzc > 1 ? 2 : 1;
    restrict_residual_pt_dist_kernel<T>
        <<<blocks_for(nends * plane), kThreads, 0, stream>>>(
            ends, out, lmc, 0, mzc - 1, nends);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || mzc < 3) return (int)err;
    const BlockResidualSample<T> inner{v, f, lmf, z_base, wc, woff};
    restrict_residual_pt_dist_kernel<T>
        <<<blocks_for((mzc - 2) * plane), kThreads, 0, stream>>>(
            inner, out, lmc, 1, 1, mzc - 2);
    return (int)cudaGetLastError();
}

template <typename T>
int prolong_linear_dist(const T* c, const T* chi, const T* v, T* out,
                        int mzc, int lmc, int lmf, int z_base,
                        cudaStream_t stream) {
    prolong_linear_dist_kernel<T>
        <<<grid_for(lmf, 2 * mzc), dim3(kBx, kBy), 0, stream>>>(
            c, chi, v, out, mzc, lmc, lmf, z_base);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_rb_sweep_dist_f32(const float* v, const float* f, const float* vlo,
                         const float* vhi, const float* flo, const float* fhi,
                         float* out, float* scratch, int mz, int lm,
                         int z_base, float inv_wc, float neg_woff,
                         void* stream) {
    return rb_sweep_dist<float>(v, f, vlo, vhi, flo, fhi, out, scratch, mz,
                                lm, z_base, inv_wc, neg_woff,
                                (cudaStream_t)stream);
}

int mg_rb_sweep_dist_f64(const double* v, const double* f, const double* vlo,
                         const double* vhi, const double* flo,
                         const double* fhi, double* out, double* scratch,
                         int mz, int lm, int z_base, double inv_wc,
                         double neg_woff, void* stream) {
    return rb_sweep_dist<double>(v, f, vlo, vhi, flo, fhi, out, scratch, mz,
                                 lm, z_base, inv_wc, neg_woff,
                                 (cudaStream_t)stream);
}

int mg_jacobi_sweep_dist_f32(const float* v, const float* f, const float* vlo,
                             const float* vhi, const float* flo,
                             const float* fhi, float* out, int mz, int lm,
                             int z_base, float inv_wc, float neg_woff,
                             float keep, float w, void* stream) {
    return jacobi_sweep_dist<float>(v, f, vlo, vhi, flo, fhi, out, mz, lm,
                                    z_base, inv_wc, neg_woff, keep, w,
                                    (cudaStream_t)stream);
}

int mg_jacobi_sweep_dist_f64(const double* v, const double* f,
                             const double* vlo, const double* vhi,
                             const double* flo, const double* fhi,
                             double* out, int mz, int lm, int z_base,
                             double inv_wc, double neg_woff, double keep,
                             double w, void* stream) {
    return jacobi_sweep_dist<double>(v, f, vlo, vhi, flo, fhi, out, mz, lm,
                                     z_base, inv_wc, neg_woff, keep, w,
                                     (cudaStream_t)stream);
}

int mg_residual_dist_f32(const float* v, const float* f, const float* vlo,
                         const float* vhi, const float* flo, const float* fhi,
                         float* out, int mz, int lm, int z_base, float wc,
                         float woff, void* stream) {
    return residual_dist<float>(v, f, vlo, vhi, flo, fhi, out, mz, lm, z_base,
                                wc, woff, (cudaStream_t)stream);
}

int mg_residual_dist_f64(const double* v, const double* f, const double* vlo,
                         const double* vhi, const double* flo,
                         const double* fhi, double* out, int mz, int lm,
                         int z_base, double wc, double woff, void* stream) {
    return residual_dist<double>(v, f, vlo, vhi, flo, fhi, out, mz, lm,
                                 z_base, wc, woff, (cudaStream_t)stream);
}

int mg_restrict_residual_pt_dist_f32(const float* v, const float* f,
                                     const float* vlo, const float* vhi,
                                     const float* flo, const float* fhi,
                                     float* out, int mz, int lmf, int lmc,
                                     int z_base, float wc, float woff,
                                     void* stream) {
    return restrict_residual_pt_dist<float>(v, f, vlo, vhi, flo, fhi, out, mz,
                                            lmf, lmc, z_base, wc, woff,
                                            (cudaStream_t)stream);
}

int mg_restrict_residual_pt_dist_f64(const double* v, const double* f,
                                     const double* vlo, const double* vhi,
                                     const double* flo, const double* fhi,
                                     double* out, int mz, int lmf, int lmc,
                                     int z_base, double wc, double woff,
                                     void* stream) {
    return restrict_residual_pt_dist<double>(v, f, vlo, vhi, flo, fhi, out,
                                             mz, lmf, lmc, z_base, wc, woff,
                                             (cudaStream_t)stream);
}

// v may be NULL: then out = P(c).
int mg_prolong_linear_dist_f32(const float* c, const float* chi,
                               const float* v, float* out, int mzc, int lmc,
                               int lmf, int z_base, void* stream) {
    return prolong_linear_dist<float>(c, chi, v, out, mzc, lmc, lmf, z_base,
                                      (cudaStream_t)stream);
}

int mg_prolong_linear_dist_f64(const double* c, const double* chi,
                               const double* v, double* out, int mzc, int lmc,
                               int lmf, int z_base, void* stream) {
    return prolong_linear_dist<double>(c, chi, v, out, mzc, lmc, lmf, z_base,
                                       (cudaStream_t)stream);
}

}  // extern "C"
