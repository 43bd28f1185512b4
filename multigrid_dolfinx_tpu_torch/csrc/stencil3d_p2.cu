// Plane-free constant-coefficient P2 kernels for Hopper (sm_90a): K19
// residual, K20 weighted Jacobi with Dirichlet snap, K21 the raw P2 mass
// quadratic form.  They replace multigrid_dolfinx_tpu/ops/pallas/
// stencil3d_p2.py p2_residual (:240), p2_jacobi_sweep (:247), both through
// _call_p2 (:199), and p2_mass_quad (:429).
//
// The operator lives on the half-step lattice of lm = 2n + 1 points per
// axis, stored as the logical lm^3 box, C-order (z, y, x), contiguous and
// unpadded, 32-bit point indices (the wrappers refuse lm > 1290).  It is
// K radius-2 offsets and a (K, 64) table in the working type: the weight
// of offset k at node p is tables[k * 64 + class(p)], the flat 4^3 class
// with per-axis classes {0: index 0, 1: even interior, 2: odd interior,
// 3: index lm-1}.  No operator bytes are stored per node.
//
// K19 and K20 run the Dirichlet-eliminated stiffness (51 offsets): on an
// interior node the class is its (z%2, y%2, x%2) parity, so each block
// stages the 8 interior classes' weights (K x 8) in shared memory; reads
// are interior-masked (non-interior neighbours skipped); boundary rows
// give f - v (K19) or snap to f (K20).  K21 runs the raw mass (65
// offsets) over every node of the box with the true 4^3 class, face rows
// included, reads inside the box; its block stages the whole (K, 64)
// table.  So one kernel gives both the post-sweep check (r = 0 on faces)
// and ||b||_M of the zero iterate (r = b, faces = uD).
//
// Bitwise equal to the plain versions (ops/cuda/stencil3d_p2.py): each
// node sums its terms in the template's offset order from a zero
// accumulator, both skip zero weights (odd-z rows have exactly zero
// |dz| = 2 weights), out-of-box or masked neighbours are skipped here and
// read as zero there (the same sum: the accumulator is never -0), the
// library is built with --fmad=false, and K21's f64 partials have a fixed
// block size and are summed in a fixed order, with no atomics.
//
// Bound on the H100: memory.  K19 and K20: v and f read and one array
// written, 3 x 0.54 GB at 513^3 f32, 0.48 ms at 3.35 TB/s; the ~23
// nonzero neighbours a node reads come from L1/L2.  K21: one read of r,
// 0.16 ms; its ~59 operations a node (nonzero weights only) take 0.12 ms
// at 67 TFLOP/s.  Design: one thread per node in 32 x 8 blocks for
// K19/K20 (the shape of K15); a grid-stride loop in a fixed number of
// blocks for K21, each thread summing r * (M r) in f64, then K4's
// fixed-order two-pass reduction.  The loop over offsets is what costs:
// a node away from the faces (the "deep" nodes, all but ~3.5 % at
// 513^3) walks a list of its parity class's nonzero weights and their
// linear index steps, compacted in shared memory per block (one warp a
// class, by ballot), in the template's order, each weight read with its
// step in one shared load; the other nodes walk all offsets with the box
// tests.  A warp's 32 consecutive x hold two parity classes, so its list
// loop is as long as the longer one (27.5 terms on average for the
// stiffness); warps of one class (x of one parity) read v at stride 2
// and measured slower.  The TPU kernels' even-tz rolling window,
// static parity, clamp reads, VMEM budgets and the shell delta are not
// carried over.
//
// Each entry point is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>

#include "stencil3d.cuh"

namespace {

constexpr int kMaxOffsets = 72;
constexpr int kClasses = 64;
constexpr int kQuadThreads = 256;
constexpr int kQuadMaxBlocks = 2048;
constexpr int kFinalThreads = 1024;

// The stencil, passed by value: K radius-2 offsets (dz, dy, dx) and the
// centre's index (-1 where the kernel does not need it).
struct P2Stencil {
    int k;
    int center;
    signed char d[3 * kMaxOffsets];
};

// Flat 4^3 class of the interior parity class c = zp * 4 + yp * 2 + xp.
__device__ __forceinline__ int interior_flat(int c) {
    return ((1 + (c >> 2)) * 4 + (1 + ((c >> 1) & 1))) * 4 + (1 + (c & 1));
}

// Per-axis true class of index i.
__device__ __forceinline__ int axis_class(int i, int lm) {
    return i == 0 ? 0 : (i == lm - 1 ? 3 : ((i & 1) ? 2 : 1));
}

// w8[k * 8 + c] = tables[k * 64 + interior_flat(c)], by the whole block.
template <typename T>
__device__ __forceinline__ void stage_interior(const T* __restrict__ tables,
                                               T* w8, int k) {
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nt = blockDim.x * blockDim.y;
    for (int i = tid; i < k * 8; i += nt)
        w8[i] = tables[(i >> 3) * kClasses + interior_flat(i & 7)];
}

// A nonzero weight and its offset's linear index step, read together.
template <typename T>
struct Term {
    T w;
    int delta;
};

// The nonzero weights of the 8 interior parity classes, each compacted in
// the template's order: class c's list is t[c * kMaxOffsets + i],
// i < count[c].
template <typename T>
struct ClassLists {
    Term<T> t[8 * kMaxOffsets];
    int count[8];
};

// Warp `c` (lanes 0..31) compacts class c's list from wk(k), the weight
// of offset k in class c, leaving out offset `skip`; deltas[k] is offset
// k's linear step on the lm^3 box.
template <typename T, typename Weight>
__device__ __forceinline__ void compact_class(const Weight& wk, int k,
                                              int skip,
                                              const int* __restrict__ deltas,
                                              int c, int lane,
                                              ClassLists<T>* lists) {
    int n = 0;
    for (int k0 = 0; k0 < k; k0 += 32) {
        const int kk = k0 + lane;
        const T w = kk < k ? wk(kk) : T(0);
        const bool keep = kk < k && kk != skip && w != T(0);
        const unsigned mask = __ballot_sync(0xffffffffu, keep);
        if (keep) {
            const int at = c * kMaxOffsets + n +
                           __popc(mask & ((1u << lane) - 1u));
            lists->t[at] = Term<T>{w, deltas[kk]};
        }
        n += __popc(mask);
    }
    if (lane == 0) lists->count[c] = n;
}

// sum of class c's list at node p: w_i v[p + delta_i] in order from 0.
template <typename T>
__device__ __forceinline__ T list_acc(const T* v, const ClassLists<T>& lists,
                                      int c, int p) {
    const Term<T>* t = lists.t + c * kMaxOffsets;
    const int n = lists.count[c];
    T acc = T(0);
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
        const Term<T> term = t[i];
        acc = acc + term.w * v[p + term.delta];
    }
    return acc;
}

// sum_k w8[k][parity(p)] v[p + off_k] over interior neighbours, k != skip,
// in offset order from 0, zero weights skipped.  Nodes at least 3 from
// every face have only interior neighbours and take their class's list;
// the same terms in the same order.
template <typename T>
__device__ __forceinline__ T interior_acc(const T* v, const T* w8,
                                          const ClassLists<T>& lists, int p,
                                          int z, int y, int x, int lm,
                                          const P2Stencil& s, int skip) {
    const int c = ((z & 1) << 2) | ((y & 1) << 1) | (x & 1);
    if (z >= 3 && z <= lm - 4 && y >= 3 && y <= lm - 4 && x >= 3 &&
        x <= lm - 4)
        return list_acc(v, lists, c, p);
    T acc = T(0);
    for (int k = 0; k < s.k; ++k) {
        if (k == skip) continue;
        const T w = w8[k * 8 + c];
        if (w == T(0)) continue;
        const int dz = s.d[3 * k], dy = s.d[3 * k + 1], dx = s.d[3 * k + 2];
        if (!(mg3d::inside(z + dz, lm) && mg3d::inside(y + dy, lm) &&
              mg3d::inside(x + dx, lm)))
            continue;
        acc = acc + w * v[p + (dz * lm + dy) * lm + dx];
    }
    return acc;
}

// Shared-memory staging of K19/K20 (32 x 8 threads, warp = threadIdx.y):
// the dense K x 8 interior table, then each warp compacts its class.
template <typename T>
struct InteriorWeights {
    T w8[kMaxOffsets * 8];
    ClassLists<T> lists;
};

template <typename T>
struct W8Weight {
    const T* w8;
    int c;
    __device__ __forceinline__ T operator()(int k) const {
        return w8[k * 8 + c];
    }
};

template <typename T>
__device__ __forceinline__ void stage_p2(const T* __restrict__ tables,
                                         const int* __restrict__ deltas,
                                         const P2Stencil& s, int skip,
                                         InteriorWeights<T>* sh) {
    stage_interior(tables, sh->w8, s.k);
    __syncthreads();
    compact_class<T>(W8Weight<T>{sh->w8, (int)threadIdx.y}, s.k, skip,
                     deltas, threadIdx.y, threadIdx.x, &sh->lists);
    __syncthreads();
}

// K19: r = f - A v; boundary rows f - v.
template <typename T>
__global__ void p2_residual_kernel(const T* __restrict__ v,
                                   const T* __restrict__ f,
                                   const T* __restrict__ tables,
                                   const int* __restrict__ deltas,
                                   T* __restrict__ out, int lm, P2Stencil s) {
    __shared__ InteriorWeights<T> sh;
    stage_p2(tables, deltas, s, -1, &sh);
    const int x = blockIdx.x * mg3d::kBx + threadIdx.x;
    const int y = blockIdx.y * mg3d::kBy + threadIdx.y;
    const int z = blockIdx.z;
    if (x >= lm || y >= lm) return;
    const int p = (z * lm + y) * lm + x;
    if (!mg3d::interior(z, y, x, lm)) {
        out[p] = f[p] - v[p];
        return;
    }
    out[p] = f[p] - interior_acc(v, sh.w8, sh.lists, p, z, y, x, lm, s, -1);
}

// K20: keep v + (w d) (f - acc), acc without the centre term, d = 1 / w_c
// of the node's parity class (1 where w_c = 0); boundary rows snap to f
// (the Pallas _p2_jacobi_emit).  keep = 1 - w and w arrive rounded to T.
// Out of place: the smoother ping-pongs two buffers.
template <typename T>
__global__ void p2_jacobi_kernel(const T* __restrict__ v,
                                 const T* __restrict__ f,
                                 const T* __restrict__ tables,
                                 const int* __restrict__ deltas,
                                 T* __restrict__ out, int lm, P2Stencil s,
                                 T keep, T w) {
    __shared__ InteriorWeights<T> sh;
    __shared__ T wd[8];
    stage_p2(tables, deltas, s, s.center, &sh);
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    if (tid < 8) {
        const T wc = sh.w8[s.center * 8 + tid];
        wd[tid] = w * (T(1) / (wc == T(0) ? T(1) : wc));
    }
    __syncthreads();
    const int x = blockIdx.x * mg3d::kBx + threadIdx.x;
    const int y = blockIdx.y * mg3d::kBy + threadIdx.y;
    const int z = blockIdx.z;
    if (x >= lm || y >= lm) return;
    const int p = (z * lm + y) * lm + x;
    if (!mg3d::interior(z, y, x, lm)) {
        out[p] = f[p];
        return;
    }
    const int c = ((z & 1) << 2) | ((y & 1) << 1) | (x & 1);
    const T acc = interior_acc(v, sh.w8, sh.lists, p, z, y, x, lm, s,
                               s.center);
    out[p] = keep * v[p] + wd[c] * (f[p] - acc);
}

// K21, first pass: block b's partial of sum_p r[p] (M r)[p] over the
// nodes p = b * kQuadThreads + t + j * stride (stride = blocks x threads),
// each thread adding r (M r) (formed in T) to an f64 sum in increasing j,
// then a shared-memory tree over the block's threads.  Nodes at least 2
// from every face (reads inside the box, an interior class) walk their
// class's list; the others all offsets with their true class and the box
// tests.
template <typename T>
struct MassWeights {
    T w64[kMaxOffsets * kClasses];
    ClassLists<T> lists;
    double red[kQuadThreads];
};

template <typename T>
struct W64Weight {
    const T* w64;
    int flat;
    __device__ __forceinline__ T operator()(int k) const {
        return w64[k * kClasses + flat];
    }
};

template <typename T>
__global__ void __launch_bounds__(kQuadThreads)
p2_quad_partial_kernel(const T* __restrict__ r, const T* __restrict__ tables,
                       const int* __restrict__ deltas,
                       double* __restrict__ partials, int lm, P2Stencil s) {
    __shared__ MassWeights<T> sh;
    for (int i = threadIdx.x; i < s.k * kClasses; i += kQuadThreads)
        sh.w64[i] = tables[i];
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    compact_class<T>(W64Weight<T>{sh.w64, interior_flat(warp)}, s.k, -1,
                     deltas, warp, lane, &sh.lists);
    __syncthreads();
    const long long n = (long long)lm * lm * lm;
    const int stride = gridDim.x * kQuadThreads;   // < lm^3 + kQuadThreads
    const int sx = stride % lm, sy = (stride / lm) % lm,
              sz = stride / (lm * lm);
    const int q0 = blockIdx.x * kQuadThreads + threadIdx.x;
    int x = q0 % lm, y = (q0 / lm) % lm, z = q0 / (lm * lm);
    double sum = 0.0;
    for (long long q = q0; q < n; q += stride) {
        const int p = (int)q;
        T acc = T(0);
        if (z >= 2 && z <= lm - 3 && y >= 2 && y <= lm - 3 && x >= 2 &&
            x <= lm - 3) {
            acc = list_acc(r, sh.lists,
                           ((z & 1) << 2) | ((y & 1) << 1) | (x & 1), p);
        } else {
            const int cls = (axis_class(z, lm) * 4 + axis_class(y, lm)) * 4 +
                            axis_class(x, lm);
            for (int k = 0; k < s.k; ++k) {
                const T w = sh.w64[k * kClasses + cls];
                if (w == T(0)) continue;
                const int dz = s.d[3 * k], dy = s.d[3 * k + 1],
                          dx = s.d[3 * k + 2];
                if (!((unsigned)(z + dz) < (unsigned)lm &&
                      (unsigned)(y + dy) < (unsigned)lm &&
                      (unsigned)(x + dx) < (unsigned)lm))
                    continue;
                acc = acc + w * r[p + (dz * lm + dy) * lm + dx];
            }
        }
        sum += (double)(r[p] * acc);
        x += sx;
        y += sy;
        z += sz;
        if (x >= lm) {
            x -= lm;
            ++y;
        }
        if (y >= lm) {
            y -= lm;
            ++z;
        }
    }
    sh.red[threadIdx.x] = sum;
    __syncthreads();
    for (int h = kQuadThreads / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) sh.red[threadIdx.x] += sh.red[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) partials[blockIdx.x] = sh.red[0];
}

// K21, second pass (one block): thread t sums partials t, t + 1024, ... in
// order, then a tree over the threads.
__global__ void p2_sum_partials_kernel(const double* __restrict__ partials,
                                       int nparts, double* __restrict__ out) {
    __shared__ double red[kFinalThreads];
    double s = 0.0;
    for (int i = threadIdx.x; i < nparts; i += kFinalThreads) s += partials[i];
    red[threadIdx.x] = s;
    __syncthreads();
    for (int h = kFinalThreads / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[0] = red[0];
}

bool make_stencil(const int* offsets, int k, int center, P2Stencil* s) {
    if (k < 1 || k > kMaxOffsets || center < -1 || center >= k) return false;
    s->k = k;
    s->center = center;
    for (int i = 0; i < 3 * k; ++i) {
        if (offsets[i] < -2 || offsets[i] > 2) return false;
        s->d[i] = (signed char)offsets[i];
    }
    return true;
}

bool lm_ok(int lm) { return lm >= 3 && lm <= mg3d::kMaxLm32; }

template <typename T>
int residual(const T* v, const T* f, const T* tables, const int* deltas,
             T* out, int lm, const int* offsets, int k, cudaStream_t stream) {
    P2Stencil s;
    if (!lm_ok(lm) || !make_stencil(offsets, k, -1, &s))
        return (int)cudaErrorInvalidValue;
    p2_residual_kernel<T><<<mg3d::grid_for(lm), dim3(mg3d::kBx, mg3d::kBy), 0,
                            stream>>>(v, f, tables, deltas, out, lm, s);
    return (int)cudaGetLastError();
}

template <typename T>
int jacobi(const T* v, const T* f, const T* tables, const int* deltas, T* out,
           int lm, const int* offsets, int k, int center, T keep, T w,
           cudaStream_t stream) {
    P2Stencil s;
    if (!lm_ok(lm) || center < 0 || !make_stencil(offsets, k, center, &s))
        return (int)cudaErrorInvalidValue;
    p2_jacobi_kernel<T><<<mg3d::grid_for(lm), dim3(mg3d::kBx, mg3d::kBy), 0,
                          stream>>>(v, f, tables, deltas, out, lm, s, keep,
                                    w);
    return (int)cudaGetLastError();
}

template <typename T>
int mass_quad(const T* r, const T* tables, const int* deltas,
              double* partials, double* out, int lm, const int* offsets,
              int k, int nblocks, cudaStream_t stream) {
    P2Stencil s;
    if (!lm_ok(lm) || nblocks < 1 || nblocks > kQuadMaxBlocks ||
        !make_stencil(offsets, k, -1, &s))
        return (int)cudaErrorInvalidValue;
    p2_quad_partial_kernel<T><<<nblocks, kQuadThreads, 0, stream>>>(
        r, tables, deltas, partials, lm, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    p2_sum_partials_kernel<<<1, kFinalThreads, 0, stream>>>(partials, nblocks,
                                                            out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// deltas[k] = (dz * lm + dy) * lm + dx of offset k, on the device.
int mg_p2_residual_f32(const float* v, const float* f, const float* tables,
                       const int* deltas, float* out, int lm,
                       const int* offsets, int k, void* stream) {
    return residual<float>(v, f, tables, deltas, out, lm, offsets, k,
                           (cudaStream_t)stream);
}

int mg_p2_residual_f64(const double* v, const double* f,
                       const double* tables, const int* deltas, double* out,
                       int lm, const int* offsets, int k, void* stream) {
    return residual<double>(v, f, tables, deltas, out, lm, offsets, k,
                            (cudaStream_t)stream);
}

int mg_p2_jacobi_f32(const float* v, const float* f, const float* tables,
                     const int* deltas, float* out, int lm,
                     const int* offsets, int k, int center, float keep,
                     float w, void* stream) {
    return jacobi<float>(v, f, tables, deltas, out, lm, offsets, k, center,
                         keep, w, (cudaStream_t)stream);
}

int mg_p2_jacobi_f64(const double* v, const double* f, const double* tables,
                     const int* deltas, double* out, int lm,
                     const int* offsets, int k, int center, double keep,
                     double w, void* stream) {
    return jacobi<double>(v, f, tables, deltas, out, lm, offsets, k, center,
                          keep, w, (cudaStream_t)stream);
}

// partials holds nblocks doubles (1 <= nblocks <= 2048); out[0] = q.
int mg_p2_mass_quad_f32(const float* r, const float* tables,
                        const int* deltas, double* partials, double* out,
                        int lm, const int* offsets, int k, int nblocks,
                        void* stream) {
    return mass_quad<float>(r, tables, deltas, partials, out, lm, offsets, k,
                            nblocks, (cudaStream_t)stream);
}

int mg_p2_mass_quad_f64(const double* r, const double* tables,
                        const int* deltas, double* partials, double* out,
                        int lm, const int* offsets, int k, int nblocks,
                        void* stream) {
    return mass_quad<double>(r, tables, deltas, partials, out, lm, offsets,
                             k, nblocks, (cudaStream_t)stream);
}

}  // extern "C"
