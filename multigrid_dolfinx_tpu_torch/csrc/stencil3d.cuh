// Device helpers shared by the kernels of stencil3d.cu,
// stencil3d_cheby.cu, stencil3d_tail.cu, stencil3d_planes.cu,
// stencil3d_dist.cu and stencil3d_cycle.cu.
//
// Storage is the logical lm^3 node box, C-order (z, y, x), contiguous and
// unpadded.  Interior means 1 <= index <= lm-2 on every axis.

#pragma once

#include <cuda_runtime.h>

namespace mg3d {

// Thread block of the one-point-per-thread kernels K10-K12: 32 consecutive
// x per warp (coalesced rows), 8 rows of y, one z plane per grid slice.
constexpr int kBx = 32;
constexpr int kBy = 8;

// Largest lm whose lm^3 point index fits a 32-bit int (1290^3 < 2^31);
// the Python wrappers refuse larger boxes for K10-K12.
constexpr int kMaxLm32 = 1290;

__device__ __forceinline__ bool inside(int i, int lm) {
    return i >= 1 && i <= lm - 2;
}

__device__ __forceinline__ bool interior(int z, int y, int x, int lm) {
    return inside(z, lm) && inside(y, lm) && inside(x, lm);
}

// A field around one point, read at neighbour offsets: at(dz, dy, dx) is
// v[p + dz sz + dy sy + dx].  With v a contiguous lm^3 array in global
// memory (sz = lm^2, sy = lm) it reads the box; with v a window in shared
// memory (its own strides) it reads the window, so the cycle kernels of
// stencil3d_cycle.cu run each point through the same arithmetic as K1-K3.
// I is the index type: long long for K1-K3, int for K10-K12 and the
// shared-memory windows.
template <typename T, typename I>
struct Flat {
    const T* v;
    I p, sz, sy;
    __device__ __forceinline__ T operator()(int dz, int dy, int dx) const {
        return v[p + dz * sz + dy * sy + dx];
    }
};

// 6-neighbour sum of the interior-masked field around interior point
// (z, y, x), in the order (z-1)+(z+1)+(y-1)+(y+1)+(x-1)+(x+1)
// (stencil3d.py _nbr_sum).  Neighbours outside the interior read as 0.
template <typename T, typename At>
__device__ __forceinline__ T nbr_sum_at(const At& at, int z, int y, int x,
                                        int lm) {
    T zm = inside(z - 1, lm) ? at(-1, 0, 0) : T(0);
    T zp = inside(z + 1, lm) ? at(1, 0, 0) : T(0);
    T ym = inside(y - 1, lm) ? at(0, -1, 0) : T(0);
    T yp = inside(y + 1, lm) ? at(0, 1, 0) : T(0);
    T xm = inside(x - 1, lm) ? at(0, 0, -1) : T(0);
    T xp = inside(x + 1, lm) ? at(0, 0, 1) : T(0);
    return ((((zm + zp) + ym) + yp) + xm) + xp;
}

// nbr_sum_at on a contiguous lm^3 array around point index p.
template <typename T, typename I>
__device__ __forceinline__ T nbr_sum(const T* v, I p, int z, int y, int x,
                                     int lm) {
    const I sz = (I)lm * lm, sy = lm;
    return nbr_sum_at<T>(Flat<T, I>{v, p, sz, sy}, z, y, x, lm);
}

// The red-black candidate of K1 at point (z, y, x), global index p of f:
// (f + (-woff) S) (1/wc) inside, f on the boundary (stencil3d.py
// _gs_candidate).  inv_wc and neg_woff arrive rounded to T.
template <typename T, typename At, typename I>
__device__ __forceinline__ T rb_candidate(const At& v,
                                          const T* __restrict__ f, I p,
                                          int z, int y, int x, int lm,
                                          T inv_wc, T neg_woff) {
    if (!interior(z, y, x, lm)) return f[p];
    return (f[p] + neg_woff * nbr_sum_at<T>(v, z, y, x, lm)) * inv_wc;
}

// Residual r = f - (wc v + woff S) at a fine point, 0 off the interior
// (the 'pt' correction-equation masking); v read through `v`, f at its
// global index p.
template <typename T, typename At, typename I>
__device__ __forceinline__ T masked_residual_at(const At& v,
                                                const T* __restrict__ f,
                                                I p, int z, int y, int x,
                                                int lm, T wc, T woff) {
    if (!interior(z, y, x, lm)) return T(0);
    const T av = wc * v(0, 0, 0) + woff * nbr_sum_at<T>(v, z, y, x, lm);
    return f[p] - av;
}

// masked_residual_at on contiguous lm^3 arrays.
template <typename T>
__device__ __forceinline__ T masked_residual(const T* __restrict__ v,
                                             const T* __restrict__ f, int z,
                                             int y, int x, int lm, T wc,
                                             T woff) {
    const long long p = ((long long)z * lm + y) * lm + x;
    const long long sz = (long long)lm * lm, sy = lm;
    return masked_residual_at<T>(Flat<T, long long>{v, p, sz, sy}, f, p, z,
                                 y, x, lm, wc, woff);
}

// Variational P^T restriction at coarse point (zc, yc, xc) of the fine
// values sample(z, y, x) (0 off the fine interior): 0.125 * [1 2 1]^3
// around 2I, combined z first, then y, then x (the order of stencil3d.py
// _restrict_residual_kernel, _restrict_kernel and _plane_restrict); 0
// outside the coarse interior.
template <typename T, typename Sample>
__device__ __forceinline__ T restrict_combine(const Sample& sample, int zc,
                                              int yc, int xc, int lmc) {
    if (!interior(zc, yc, xc, lmc)) return T(0);
    const int zf = 2 * zc, yf = 2 * yc, xf = 2 * xc;
    T gy[3];
    for (int dx = -1; dx <= 1; ++dx) {
        T gz[3];
        for (int dy = -1; dy <= 1; ++dy) {
            const T lo = sample(zf - 1, yf + dy, xf + dx);
            const T mid = sample(zf, yf + dy, xf + dx);
            const T hi = sample(zf + 1, yf + dy, xf + dx);
            gz[dy + 1] = (lo + T(2) * mid) + hi;
        }
        gy[dx + 1] = (gz[0] + T(2) * gz[1]) + gz[2];
    }
    return ((gy[0] + T(2) * gy[1]) + gy[2]) * T(0.125);
}

// The masked residual of the const-7 operator as a restriction sample.
template <typename T>
struct ResidualSample {
    const T* v;
    const T* f;
    int lm;
    T wc, woff;
    __device__ __forceinline__ T operator()(int z, int y, int x) const {
        return masked_residual(v, f, z, y, x, lm, wc, woff);
    }
};

// A given fine array r, interior-masked, as a restriction sample.
template <typename T>
struct MaskedSample {
    const T* r;
    int lm;
    __device__ __forceinline__ T operator()(int z, int y, int x) const {
        if (!interior(z, y, x, lm)) return T(0);
        return r[((long long)z * lm + y) * lm + x];
    }
};

// Fused residual + P^T restriction at a coarse point: the 27 residuals
// around 2I are recomputed from v and f.
template <typename T>
__device__ __forceinline__ T restrict_point(const T* __restrict__ v,
                                            const T* __restrict__ f, int zc,
                                            int yc, int xc, int lmf, int lmc,
                                            T wc, T woff) {
    const ResidualSample<T> sample{v, f, lmf, wc, woff};
    return restrict_combine<T>(sample, zc, yc, xc, lmc);
}

// Trilinear prolongation at fine point (zf, yf, xf) of the coarse values
// c(kz, jy, ix): interpolated in x, then y, then z, as stencil3d.py
// _plane_prolong / _prolong_kernel do.  `c` reads a coarse array in
// global memory (Box) or a coarse footprint in shared memory.
template <typename T, typename C>
__device__ __forceinline__ T interp_x_at(const C& c, int kz, int jy, int xf) {
    if ((xf & 1) == 0) return c(kz, jy, xf >> 1);
    return T(0.5) * (c(kz, jy, xf >> 1) + c(kz, jy, (xf >> 1) + 1));
}

template <typename T, typename C>
__device__ __forceinline__ T interp_xy_at(const C& c, int kz, int yf,
                                          int xf) {
    if ((yf & 1) == 0) return interp_x_at<T>(c, kz, yf >> 1, xf);
    return T(0.5) * (interp_x_at<T>(c, kz, yf >> 1, xf) +
                     interp_x_at<T>(c, kz, (yf >> 1) + 1, xf));
}

template <typename T, typename C>
__device__ __forceinline__ T prolong_point_at(const C& c, int zf, int yf,
                                              int xf) {
    if ((zf & 1) == 0) return interp_xy_at<T>(c, zf >> 1, yf, xf);
    return T(0.5) * (interp_xy_at<T>(c, zf >> 1, yf, xf) +
                     interp_xy_at<T>(c, (zf >> 1) + 1, yf, xf));
}

// A contiguous lm^3 array in global memory, read at (z, y, x).
template <typename T>
struct Box {
    const T* a;
    int lm;
    __device__ __forceinline__ T operator()(int z, int y, int x) const {
        return a[((long long)z * lm + y) * lm + x];
    }
};

// The prolongation helpers on the lmc^3 coarse array c in global memory.
template <typename T>
__device__ __forceinline__ T interp_x(const T* __restrict__ c, int kz, int jy,
                                      int xf, int lmc) {
    return interp_x_at<T>(Box<T>{c, lmc}, kz, jy, xf);
}

template <typename T>
__device__ __forceinline__ T interp_xy(const T* __restrict__ c, int kz, int yf,
                                       int xf, int lmc) {
    return interp_xy_at<T>(Box<T>{c, lmc}, kz, yf, xf);
}

template <typename T>
__device__ __forceinline__ T prolong_point(const T* __restrict__ c, int zf,
                                           int yf, int xf, int lmc) {
    return prolong_point_at<T>(Box<T>{c, lmc}, zf, yf, xf);
}

// Grid of the 32 x 8 kernels over an lm^3 box.
inline dim3 grid_for(int lm) {
    return dim3((unsigned int)((lm + kBx - 1) / kBx),
                (unsigned int)((lm + kBy - 1) / kBy), (unsigned int)lm);
}

}  // namespace mg3d
