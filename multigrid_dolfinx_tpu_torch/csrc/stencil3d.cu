// Const-7-point multigrid kernels for Hopper (sm_90a): K1-K3, K10 and
// K11 of the port, K18, the P^T restriction of a given residual, and the
// red-black half sweep (one colour of K1 as its own entry).
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

#include <type_traits>

#include "stencil3d.cuh"

namespace {

using mg3d::inside;
using mg3d::interior;
using mg3d::nbr_sum;
using mg3d::prolong_point;
using mg3d::restrict_point;

constexpr int kThreads = 256;

// The red-black half sweep (stencil3d.py rb_half_sweep): one colour of
// the red-black Gauss-Seidel sweep, one thread per point.  Points of
// `color` ((x+y+z) % 2 == color) take the candidate (f + (-woff) S) *
// (1/wc) inside and f on the boundary (mg3d::rb_candidate); the others
// copy src.  Out of place, or in place (src == out): a point of one
// colour reads only the other colour and writes only itself.
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

// K1 rb_sweep replaces stencil3d.py rb_sweep_fused: both colours of one
// red-black Gauss-Seidel sweep in one pass over the box.  Bound on the
// H100: memory, v and f read once and out written once (12 bytes a point
// in f32); the two half sweeps it replaces move each array twice.
//
// Design: a block owns a TY x TX column tile of output points and marches
// up a z segment of them.  Shared memory holds a ring of v planes on the
// tile grown by 2 (0 off the box) and a ring of f planes on the tile
// grown by 1 in y (by 2 in x), filled by cp.async DEPTH planes ahead,
// each plane split by the parity of x + y (mg3d::Split): the points of
// one colour on a plane are one parity, their neighbours the other parity
// of that plane and their own parity of the planes beside it, so a warp
// on consecutive points of one colour reads consecutive words and the
// colours never diverge within a warp.  Step z, after one barrier:
//   1. red at plane z on the tile grown by 1, in place in the ring: red
//      reads only black, still old;
//   2. black at plane z-2 on the tile, in place: it reads red at planes
//      z-3 .. z-1, all updated in earlier steps, and its old value has
//      no reader left (red at z-3 and z-1 ran in earlier steps);
//   3. plane z-3 of the tile, both colours, to out in coalesced rows.
// The lags let one barrier a step order all three.  Every thread works
// out its copy, update and store addresses once, before the march.  A
// segment [za, zb) updates red at za-1 .. zb from the old v it reads (v
// planes za-2 .. zb+1), so segments overlap by those planes and run in
// any order; mg3d::z_split picks their length from the card's occupancy.
// Each point goes through mg3d::rb_candidate reading the ring
// (mg3d::SplitAt), and the library is built with --fmad=false, so out is
// bitwise the two half sweeps: red-black Gauss-Seidel does not depend on
// the order of the points within a colour.  Out of place: a block cannot
// overwrite v that its neighbours still read.  Plane bases are 64-bit,
// so K1 takes every lm a card can hold.
template <typename T, typename S>
struct RbPlan {
    static_assert(S::tx % 2 == 0, "tiles start at even columns");
    using V = mg3d::Split<S::ty + 4, S::tx + 4>;   // rows y0-2 .., x0-2 ..
    using F = mg3d::Split<S::ty + 2, S::tx + 4>;   // rows y0-1 .., x0-2 ..
    // step z reads v planes z-3 .. z+1 and f planes z-2 .. z
    static constexpr int vslots = 8, fslots = S::depth + 3 <= 4 ? 4 : 8;
    static_assert(S::depth + 5 <= vslots, "the ring holds the copies ahead");
    static constexpr int bytes =
        (int)sizeof(T) * (vslots * V::size + fslots * F::size);
    static constexpr int red_row = S::tx / 2 + 1;   // red points a row
    static constexpr int red_items = (S::ty + 2) * red_row;
    static constexpr int black_items = S::ty * (S::tx / 2);
    static constexpr int points = S::ty * S::tx;
    static constexpr int nred = (red_items + S::threads - 1) / S::threads;
    static constexpr int nblack = (black_items + S::threads - 1) / S::threads;
    static constexpr int nstore = (points + S::threads - 1) / S::threads;
};

using SweepShape = mg3d::ZShape<16, 32, 256, 1, 2>;

template <typename T, typename S>
__global__ void __launch_bounds__(S::threads, S::min_blocks)
rb_zmarch_kernel(const T* __restrict__ v, const T* __restrict__ f,
                 T* __restrict__ out, int lm, int seg, T inv_wc, T neg_woff) {
    using P = RbPlan<T, S>;
    using V = typename P::V;
    using F = typename P::F;
    constexpr int hw = V::hw;                       // = F::hw
    constexpr int kFBase = P::vslots * V::size;    // f slots follow v's
    extern __shared__ __align__(16) unsigned char smem[];
    T* const sm = reinterpret_cast<T*>(smem);
    const unsigned sa = mg3d::shared_address(smem);
    const int tid = threadIdx.x;
    const int x0 = blockIdx.x * S::tx, y0 = blockIdx.y * S::ty;
    const int za = blockIdx.z * seg;
    const int zb = za + seg < lm ? za + seg : lm;
    // tile + 1 lies in [2, lm-3]: its points and their neighbours are
    // interior on planes 2 .. lm-3
    const bool inner_xy = x0 >= 3 && x0 + S::tx <= lm - 3 && y0 >= 3 &&
                          y0 + S::ty <= lm - 3;

    mg3d::SplitCopy<T, S::ty + 4, S::tx + 4, S::threads> vcopy;
    mg3d::SplitCopy<T, S::ty + 2, S::tx + 4, S::threads> fcopy;
    vcopy.init(y0 - 2, x0 - 2, lm, tid);
    fcopy.init(y0 - 1, x0 - 2, lm, tid);
    // this thread's points, fixed for the march (y = lm: none): red at
    // compact index rp - (column parity) of row ry (x = rx - parity);
    // black at bp of row by (x = bx + parity); stores of element sp to
    // in-plane offset so
    int rp[P::nred], ry[P::nred], rx[P::nred];
    int bp[P::nblack], by[P::nblack], bx[P::nblack];
    int sp[P::nstore], so[P::nstore];
#pragma unroll
    for (int k = 0; k < P::nred; ++k) {
        const int i = tid + k * S::threads;
        const int r = i / P::red_row, jj = i % P::red_row;
        const int y = y0 - 1 + r;
        rp[k] = (r + 1) * hw + jj + 1;
        ry[k] = i < P::red_items && y >= 0 && y < lm ? y : lm;
        rx[k] = x0 + 2 * jj;
    }
#pragma unroll
    for (int k = 0; k < P::nblack; ++k) {
        const int i = tid + k * S::threads;
        const int r = i / (S::tx / 2), jj = i % (S::tx / 2);
        bp[k] = (r + 2) * hw + jj + 1;
        by[k] = i < P::black_items && y0 + r < lm ? y0 + r : lm;
        bx[k] = x0 + 2 * jj;
    }
#pragma unroll
    for (int k = 0; k < P::nstore; ++k) {
        const int i = tid + k * S::threads;
        const int r = i / S::tx, cx = i % S::tx;
        const int y = y0 + r, x = x0 + cx;
        sp[k] = ((x + y) & 1 ? V::half : 0) + (r + 2) * hw + ((cx + 2) >> 1);
        so[k] = i < P::points && y < lm && x < lm ? y * lm + x : -1;
    }
    // element offsets of the slots of v plane q and f plane q
    auto vo = [](int q) { return (q & (P::vslots - 1)) * V::size; };
    auto fo = [](int q) { return kFBase + (q & (P::fslots - 1)) * F::size; };
    const unsigned bytes = sizeof(T);
    // group g: v plane g+1 and f plane g, both needed by step g
    auto issue = [&](int g) {
        if (g <= zb) {
            vcopy.issue(sa + vo(g + 1) * bytes, v, g + 1, lm, tid);
            fcopy.issue(sa + fo(g) * bytes, f, g, lm, tid);
        }
        mg3d::cp_async_commit();
    };
    const int zs = za - 1;                   // the first step
    vcopy.issue(sa + vo(zs - 1) * bytes, v, zs - 1, lm, tid);
    vcopy.issue(sa + vo(zs) * bytes, v, zs, lm, tid);
    for (int d = 0; d < S::depth; ++d) issue(zs + d);

    // 1. red at plane z, rows y0-1 .. y0+TY and columns x0-1 .. x0+TX, in
    //    place: parity z%2 of plane z, reading the other parity of plane
    //    z and parity z%2 of planes z-1 and z+1
    auto red = [&](auto inner, int z) {
        const int own = z & 1 ? V::half : 0, other = V::half - own;
        const T* const lo = sm + vo(z - 1) + own;
        const T* const mid = sm + vo(z) + other;
        const T* const hi = sm + vo(z + 1) + own;
        T* const put = sm + vo(z) + own;
        const T* const fp = sm + fo(z) + (z & 1 ? F::half : 0) - hw;
#pragma unroll
        for (int k = 0; k < P::nred; ++k) {
            const int y = ry[k];
            // on an inner tile only the last item can be missing
            if ((!decltype(inner)::value || k == P::nred - 1) && y >= lm)
                continue;
            const int sft = (y + z) & 1;      // red columns' parity
            const int x = rx[k] - sft;
            if (!decltype(inner)::value && (x < 0 || x >= lm)) continue;
            const int p = rp[k] - sft;
            const mg3d::SplitAt<T> at{lo, mid, hi, p, hw, sft};
            put[p] = mg3d::rb_candidate<T, decltype(inner)::value>(
                at, fp, p, z, y, x, lm, inv_wc, neg_woff);
        }
    };
    // 2. black at plane zo on the tile, in place: parity (zo+1)%2 of
    //    plane zo, reading the other parity of plane zo and its own of
    //    planes zo-1 and zo+1
    auto black = [&](auto inner, int zo) {
        const int own = zo & 1 ? 0 : V::half, other = V::half - own;
        const T* const lo = sm + vo(zo - 1) + own;
        const T* const mid = sm + vo(zo) + other;
        const T* const hi = sm + vo(zo + 1) + own;
        T* const put = sm + vo(zo) + own;
        const T* const fp = sm + fo(zo) + (zo & 1 ? 0 : F::half) - hw;
#pragma unroll
        for (int k = 0; k < P::nblack; ++k) {
            const int y = by[k];
            if ((!decltype(inner)::value || k == P::nblack - 1) && y >= lm)
                continue;
            const int sft = (y + zo + 1) & 1;  // black columns' parity
            const int x = bx[k] + sft;
            if (!decltype(inner)::value && x >= lm) continue;
            const int p = bp[k];
            const mg3d::SplitAt<T> at{lo, mid, hi, p, hw, sft};
            put[p] = mg3d::rb_candidate<T, decltype(inner)::value>(
                at, fp, p, zo, y, x, lm, inv_wc, neg_woff);
        }
    };
    // 3. plane zt of the tile to out
    auto store = [&](auto inner, int zt) {
        const T* const get = sm + vo(zt);
        T* const plane = out + (long long)zt * lm * lm;
#pragma unroll
        for (int k = 0; k < P::nstore; ++k)
            if ((decltype(inner)::value && k < P::nstore - 1) || so[k] >= 0)
                plane[so[k]] = get[sp[k]];
    };
    const std::true_type in{};
    const std::false_type edge{};
    for (int z = zs; z <= zb + 2; ++z) {
        mg3d::cp_async_wait<S::depth - 1>();
        __syncthreads();
        issue(z + S::depth);
        if (z >= 0 && z < lm && z <= zb) {
            if (inner_xy && z >= 2 && z <= lm - 3)
                red(in, z);
            else
                red(edge, z);
        }
        const int zo = z - 2;
        if (zo >= za && zo < zb) {
            if (inner_xy && zo >= 2 && zo <= lm - 3)
                black(in, zo);
            else
                black(edge, zo);
        }
        if (z - 3 >= za && z - 3 < zb) {
            if (inner_xy)
                store(in, z - 3);
            else
                store(edge, z - 3);
        }
    }
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

template <typename T>
int rb_sweep(const T* v, const T* f, T* out, int lm, T inv_wc, T neg_woff,
             cudaStream_t stream) {
    using P = RbPlan<T, SweepShape>;
    auto kernel = rb_zmarch_kernel<T, SweepShape>;
    static int wave[mg3d::kMaxDevices];
    cudaError_t err = cudaSuccess;
    const int w = mg3d::device_wave(wave, kernel, kernel,
                                    SweepShape::threads, P::bytes, &err);
    if (err != cudaSuccess) return (int)err;
    const int tx = (lm + SweepShape::tx - 1) / SweepShape::tx;
    const int ty = (lm + SweepShape::ty - 1) / SweepShape::ty;
    const mg3d::ZSplit split = mg3d::z_split(lm, tx * ty, w, 3);
    kernel<<<dim3(tx, ty, split.count), SweepShape::threads, P::bytes,
             stream>>>(v, f, out, lm, split.len, inv_wc, neg_woff);
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
