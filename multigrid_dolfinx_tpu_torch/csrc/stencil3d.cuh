// Device helpers shared by the kernels of stencil3d.cu,
// stencil3d_cheby.cu, stencil3d_tail.cu, stencil3d_planes.cu,
// stencil3d_dist.cu, stencil3d_cycle.cu and stencil3d_norm.cu.
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
// I is the index type: long long on a box in global memory, int for
// K10-K12 and the shared-memory windows and rings.
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
// kAllInside: the caller knows all six neighbours lie inside (the point's
// coordinates in [2, lm-3]), so the sum reads them with no checks, in the
// same order.
template <typename T, bool kAllInside = false, typename At>
__device__ __forceinline__ T nbr_sum_at(const At& at, int z, int y, int x,
                                        int lm) {
    if (kAllInside)
        return ((((at(-1, 0, 0) + at(1, 0, 0)) + at(0, -1, 0)) +
                 at(0, 1, 0)) + at(0, 0, -1)) + at(0, 0, 1);
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
// _gs_candidate).  inv_wc and neg_woff arrive rounded to T.  kInner: the
// caller knows the point and its six neighbours are interior.
template <typename T, bool kInner = false, typename At, typename I>
__device__ __forceinline__ T rb_candidate(const At& v,
                                          const T* __restrict__ f, I p,
                                          int z, int y, int x, int lm,
                                          T inv_wc, T neg_woff) {
    if (!kInner && !interior(z, y, x, lm)) return f[p];
    return (f[p] + neg_woff * nbr_sum_at<T, kInner>(v, z, y, x, lm)) *
           inv_wc;
}

// Residual r = f - (wc v + woff S) at a fine point, 0 off the interior
// (the 'pt' correction-equation masking); v read through `v`, f at index
// p of `f`.  kInner: the caller knows the point and its six neighbours are
// interior.
template <typename T, bool kInner = false, typename At, typename I>
__device__ __forceinline__ T masked_residual_at(const At& v,
                                                const T* __restrict__ f,
                                                I p, int z, int y, int x,
                                                int lm, T wc, T woff) {
    if (!kInner && !interior(z, y, x, lm)) return T(0);
    const T av =
        wc * v(0, 0, 0) + woff * nbr_sum_at<T, kInner>(v, z, y, x, lm);
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

// ---------------------------------------------------------------------
// The z-marching kernels K1-K4: a block owns a column tile of (y, x)
// points and marches up the box in z, holding a ring of planes in shared
// memory that asynchronous copies fill ahead of the step that reads them.
// Rows of the unpadded box are lm elements long, so they are not 16-byte
// aligned for odd lm and TMA's tiled copies (16-byte global strides) do
// not apply: each element is one cp.async of its own size.
// ---------------------------------------------------------------------

// A march's tile and pipeline: TY x TX columns a block, THREADS threads,
// DEPTH planes of copies in flight ahead of the step that reads them, and
// at least MINB blocks an SM (__launch_bounds__: a register cap).
template <int TY, int TX, int THREADS, int DEPTH, int MINB = 1>
struct ZShape {
    static constexpr int ty = TY, tx = TX, threads = THREADS, depth = DEPTH,
                         min_blocks = MINB;
};

// One element copied global -> shared (dst a shared-space address)
// without passing through registers; with valid false the destination is
// zero-filled and nothing is read.
template <typename T>
__device__ __forceinline__ void cp_async(unsigned dst, const T* src,
                                         bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0)
                 : "memory");
}

// The shared-space address of p, for cp_async.
__device__ __forceinline__ unsigned shared_address(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The smallest power of two >= n: a ring's slot count, so that a plane's
// slot is its index masked (planes below 0 included).
constexpr int pow2_ceil(int n) {
    return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}

// A thread's share of copying an H x W region of every plane: rows y0 ..
// y0+H-1, columns x0 .. x0+W-1 (global coordinates, possibly off the
// box), element i = tid + k THREADS to slot element i.  The in-plane byte
// offsets (0 off the box) and a mask of the elements on the box are
// worked out once, so a plane costs little more than a cp.async an
// element.  In-plane byte offsets are 32-bit (lm^2 sizeof(T) < 2^32: lm
// <= 23170, beyond any box a card holds); plane bases are 64-bit.
template <typename T, int H, int W, int THREADS>
struct PlaneCopy {
    static constexpr int n = (H * W + THREADS - 1) / THREADS;
    static_assert(n <= 32, "one mask bit an element");
    unsigned off[n];
    unsigned on;           // bit k: element k lies on the box
    __device__ __forceinline__ void init(int y0, int x0, int lm, int tid) {
        on = 0;
#pragma unroll
        for (int k = 0; k < n; ++k) {
            const int i = tid + k * THREADS;
            const int y = y0 + i / W, x = x0 + i % W;
            const bool in = i < H * W && y >= 0 && y < lm && x >= 0 && x < lm;
            off[k] = in ? (unsigned)(y * lm + x) * (unsigned)sizeof(T) : 0u;
            on |= in ? 1u << k : 0u;
        }
    }
    // Start copying plane z of the lm^3 box g to the slot at shared
    // address s; points off the box arrive as 0.  A plane off the box is
    // not copied (no reader touches it).
    __device__ __forceinline__ void issue(unsigned s, const T* g, int z,
                                          int lm, int tid) const {
        if (z < 0 || z >= lm) return;
        const char* plane =
            reinterpret_cast<const char*>(g + (long long)z * lm * lm);
        const unsigned d = s + tid * (unsigned)sizeof(T);
#pragma unroll
        for (int k = 0; k < n; ++k)
            if (k < n - 1 || tid < H * W - (n - 1) * THREADS)
                cp_async(d + k * THREADS * (unsigned)sizeof(T),
                         reinterpret_cast<const T*>(plane + off[k]),
                         (on >> k) & 1u);
    }
};

// The parity-split layout of a plane slot: the points of an H x W region
// whose first column is even, each parity of x + y in its own row-major
// H x W/2 array of compact columns j = c / 2, the odd array `half`
// elements after the even one.  The six neighbours of a point lie in the
// other parity's array of its plane and in its own parity's arrays of
// the planes above and below, so the red points of plane z, (x + y) % 2
// = z % 2, are all reached through per-plane array offsets, and a warp
// on consecutive points of one colour reads consecutive words.  half = 16
// (mod 32), so a warp reading 32 consecutive points of a row, alternating
// parities, hits 32 banks.
template <int H, int W>
struct Split {
    static_assert(W % 2 == 0, "whole column pairs");
    static constexpr int hw = W / 2;
    static constexpr int half = H * hw + ((16 - H * hw % 32) + 32) % 32;
    static constexpr int size = 2 * half;
};

// A thread's share of copying an H x W region (rows y0 .., columns x0 ..,
// x0 even) of every plane into the parity-split layout, as PlaneCopy: the
// destination byte offsets are worked out once too.
template <typename T, int H, int W, int THREADS>
struct SplitCopy {
    static constexpr int n = (H * W + THREADS - 1) / THREADS;
    static_assert(n <= 32, "one mask bit an element");
    unsigned off[n], dst[n];
    unsigned on;
    __device__ __forceinline__ void init(int y0, int x0, int lm, int tid) {
        on = 0;
#pragma unroll
        for (int k = 0; k < n; ++k) {
            const int i = tid + k * THREADS;
            const int r = i / W, c = i % W;
            const int y = y0 + r, x = x0 + c;
            const bool in = i < H * W && y >= 0 && y < lm && x >= 0 && x < lm;
            off[k] = in ? (unsigned)(y * lm + x) * (unsigned)sizeof(T) : 0u;
            on |= in ? 1u << k : 0u;
            dst[k] = (unsigned)(((x + y) & 1 ? Split<H, W>::half : 0) +
                                r * Split<H, W>::hw + (c >> 1)) *
                     (unsigned)sizeof(T);
        }
    }
    __device__ __forceinline__ void issue(unsigned s, const T* g, int z,
                                          int lm, int tid) const {
        if (z < 0 || z >= lm) return;
        const char* plane =
            reinterpret_cast<const char*>(g + (long long)z * lm * lm);
#pragma unroll
        for (int k = 0; k < n; ++k)
            if (k < n - 1 || tid < H * W - (n - 1) * THREADS)
                cp_async(s + dst[k], reinterpret_cast<const T*>(plane + off[k]),
                         (on >> k) & 1u);
    }
};

// The six neighbours of a point at compact index p of the parity-split
// layout: in-plane from the other parity's array `mid`, above and below
// from the point's own parity's arrays `lo` and `hi` of planes z-1 and
// z+1 (row stride hw).  The point's column is 2j + s, so x-1 sits at
// j + s - 1 and x+1 at j + s of `mid`.
template <typename T>
struct SplitAt {
    const T* lo;
    const T* mid;
    const T* hi;
    int p, hw, s;
    __device__ __forceinline__ T operator()(int dz, int dy, int dx) const {
        const T* b = dz < 0 ? lo : (dz > 0 ? hi : mid);
        return b[p + dy * hw + (dx < 0 ? s - 1 : (dx > 0 ? s : 0))];
    }
};

// Point p of plane z, read from three shared-memory planes z-1, z, z+1 of
// row stride sy (a march's ring holds them in no fixed order).
template <typename T>
struct Planes3 {
    const T* lo;
    const T* mid;
    const T* hi;
    int p, sy;
    __device__ __forceinline__ T operator()(int dz, int dy, int dx) const {
        const T* s = dz < 0 ? lo : (dz > 0 ? hi : mid);
        return s[p + dy * sy + dx];
    }
};

// Devices a launch set-up is cached for.
constexpr int kMaxDevices = 64;

// Blocks of `kernel` (`threads` a block, `bytes` of dynamic shared
// memory) that fill every SM of the current device once, set up once a
// device: the shared memory is allowed for `kernel` and `twin` (a second
// kernel of the same resources, or `kernel` again), then the occupancy is
// read and kept in cache[device].  Returns 0 with err set if the device
// refuses.
template <typename K>
inline int device_wave(int (&cache)[kMaxDevices], K kernel, K twin,
                       int threads, int bytes, cudaError_t* err) {
    int dev = 0;
    *err = cudaGetDevice(&dev);
    if (*err != cudaSuccess) return 0;
    if (dev < 0 || dev >= kMaxDevices) {
        *err = cudaErrorInvalidDevice;
        return 0;
    }
    if (cache[dev] > 0) return cache[dev];
    const K both[2] = {kernel, twin};
    for (int i = 0; i < 2; ++i) {
        *err = cudaFuncSetAttribute(
            both[i], cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (*err != cudaSuccess) return 0;
    }
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  bytes);
    cache[dev] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    return cache[dev];
}

// Fewest planes a z segment holds.
constexpr int kMinSegment = 8;

// How a march cuts `planes` z planes into segments, one block per column
// tile and segment: len planes a segment, count segments.
struct ZSplit {
    int len, count;
};

// The split with the fewest (waves of `wave` blocks) x (segment length +
// the `halo` planes a segment re-reads): more segments fill the card,
// each pays its halo.
inline ZSplit z_split(int planes, int tiles, int wave, int halo) {
    const int most = planes / kMinSegment > 1 ? planes / kMinSegment : 1;
    ZSplit best{planes, 1};
    long long best_cost = -1;
    for (int n = 1; n <= most; ++n) {
        const int len = (planes + n - 1) / n;
        const int count = (planes + len - 1) / len;
        const long long waves = ((long long)tiles * count + wave - 1) / wave;
        const long long cost = waves * (len + halo);
        if (best_cost < 0 || cost < best_cost) {
            best_cost = cost;
            best = ZSplit{len, count};
        }
    }
    return best;
}

}  // namespace mg3d
