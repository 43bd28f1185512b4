// Fused residual + FEM-L2 quadratic forms for Hopper (sm_90a): K4 and K38
// of the port.
//
// K4 (residual_tet_quad), for the certified uniform P1 mass:
// q_raw = sum over cells [ sum_{6 Kuhn tets} (sum_{4 corners} r)^2
//                          + sum_{8 corners} count * r^2 ]
// with r = f - A v unmasked (f - (wc v + woff S) inside, f - v on the
// boundary) derived at the 8 cell corners from v and f.  This is the exact
// consistent P1 mass form r^T M r up to the factor h^3/120, which the final
// pass applies.  Per-cell values are formed in T with the association
// order of stencil3d_norm.py _tet_norm_kernel (--fmad=false keeps them
// bitwise equal to the plain version); the sum over cells is taken in
// double.  The reduction is deterministic: each block writes one partial,
// and a one-block second pass adds the partials in a fixed order, with no
// atomics, so the per-cycle check cannot move a cycle count from run to
// run at the rtol threshold.
//
// K38 (residual_mass_quad) replaces multigrid_dolfinx_tpu/ops/pallas/
// stencil3d_norm.py residual_mass_quad (with its _norm_kernel and the jnp
// shell delta _shell_delta_quad): q = sum_p r(p) sum_k T[k][cls(p)]
// r(p + off_k) for any radius-1 class-table operator M (an uncertified
// mass), r the same unmasked residual as K4's and 0 outside the box,
// cls(p) = 9 c_z + 3 c_y + c_x with c_a = 0 / 1 / 2 at the low edge /
// between / the high edge.  The wrapper hands in the tables dense, a
// 27 x 27 array indexed [offset][class] with offset (dz+1)*9 + (dy+1)*3 +
// (dx+1), and the bit mask of the offsets present.  Bound on the H100:
// memory, v and f read once (8 bytes a point in f32), nothing grid-sized
// written: the same work as K4.  Design: a block owns an 8 x 8 x 32 tile;
// it derives r on the tile plus a 1-point halo into shared memory (v read
// with its 2-point halo through L1/L2, 0 outside the box) beside the
// table, then each thread forms r(p) * sum_k T[k][cls(p)] r(p + off_k)
// over the present offsets in offset order, in T, and adds it to an f64
// sum.  Each point takes its exact class, so the TPU kernel's split into
// an interior-class pass and a boundary-shell correction has no
// counterpart.  Blocks reduce to one f64 partial each and K4's one-block
// pass adds them in a fixed order: no atomics, the same bits every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;
constexpr int kFinalThreads = 1024;

__device__ __forceinline__ bool inside(int i, int lm) {
    return i >= 1 && i <= lm - 2;
}

template <typename T>
__device__ __forceinline__ T residual_unmasked(const T* __restrict__ v,
                                               const T* __restrict__ f, int z,
                                               int y, int x, int lm, T wc,
                                               T woff) {
    const long long p = ((long long)z * lm + y) * lm + x;
    if (!(inside(z, lm) && inside(y, lm) && inside(x, lm))) return f[p] - v[p];
    const long long sz = (long long)lm * lm, sy = lm;
    T zm = inside(z - 1, lm) ? v[p - sz] : T(0);
    T zp = inside(z + 1, lm) ? v[p + sz] : T(0);
    T ym = inside(y - 1, lm) ? v[p - sy] : T(0);
    T yp = inside(y + 1, lm) ? v[p + sy] : T(0);
    T xm = inside(x - 1, lm) ? v[p - 1] : T(0);
    T xp = inside(x + 1, lm) ? v[p + 1] : T(0);
    const T s = ((((zm + zp) + ym) + yp) + xm) + xp;
    return f[p] - (wc * v[p] + woff * s);
}

// Value of one cell: sum_corners count * r^2 + sum_tets (sum_corners r)^2,
// accumulated in this order.  Corner code = dz*4 + dy*2 + dx.  The tables
// are simplex_vertex_offsets(3, 'right') in its order and each corner's
// tet count in first-appearance order; 'left' mirrors the first axis,
// which flips bit 2 of every code (FLIP = 4).  tests/test_torch_kernels.py
// checks the tables against fem/assembly.py.  Every index is a compile-time
// constant after unrolling, so r[] stays in registers.
template <typename T, int FLIP>
__device__ __forceinline__ T cell_value(const T (&r)[8]) {
    constexpr int tets[6][4] = {{0, 4, 6, 7}, {0, 4, 5, 7}, {0, 2, 6, 7},
                                {0, 2, 3, 7}, {0, 1, 5, 7}, {0, 1, 3, 7}};
    constexpr int corner[8] = {0, 4, 6, 7, 5, 2, 3, 1};
    constexpr int count[8] = {6, 2, 2, 6, 2, 2, 2, 2};
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const T c = r[corner[k] ^ FLIP];
        acc = acc + (T(count[k]) * c) * c;
    }
#pragma unroll
    for (int t = 0; t < 6; ++t) {
        const T s = ((r[tets[t][0] ^ FLIP] + r[tets[t][1] ^ FLIP]) +
                     r[tets[t][2] ^ FLIP]) + r[tets[t][3] ^ FLIP];
        acc = acc + s * s;
    }
    return acc;
}

template <typename T, int FLIP>
__global__ void tet_quad_partial_kernel(const T* __restrict__ v,
                                        const T* __restrict__ f,
                                        double* __restrict__ partials, int lm,
                                        T wc, T woff) {
    __shared__ double red[kThreads];
    const int nc = lm - 1;                       // cell anchors per axis
    const long long ncells = (long long)nc * nc * nc;
    double sum = 0.0;
    for (long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         cell < ncells; cell += (long long)gridDim.x * blockDim.x) {
        const int x = (int)(cell % nc);
        const int y = (int)((cell / nc) % nc);
        const int z = (int)(cell / ((long long)nc * nc));
        T r[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            r[k] = residual_unmasked(v, f, z + (k >> 2), y + ((k >> 1) & 1),
                                     x + (k & 1), lm, wc, woff);
        sum += (double)cell_value<T, FLIP>(r);
    }
    red[threadIdx.x] = sum;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
}

__global__ void sum_partials_kernel(const double* __restrict__ partials,
                                    int nparts, double scale,
                                    double* __restrict__ out) {
    __shared__ double red[kFinalThreads];
    double s = 0.0;
    for (int i = threadIdx.x; i < nparts; i += kFinalThreads) s += partials[i];
    red[threadIdx.x] = s;
    __syncthreads();
    for (int w = kFinalThreads / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[0] = red[0] * scale;
}

int quad_blocks(int lm) {
    const long long nc = lm - 1;
    const long long blocks = (nc * nc * nc + kThreads - 1) / kThreads;
    return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
int residual_tet_quad(const T* v, const T* f, double* partials, double* out,
                      int lm, T wc, T woff, int diag, double scale,
                      cudaStream_t stream) {
    const int nb = quad_blocks(lm);
    if (diag == 0)
        tet_quad_partial_kernel<T, 0><<<nb, kThreads, 0, stream>>>(
            v, f, partials, lm, wc, woff);
    else
        tet_quad_partial_kernel<T, 4><<<nb, kThreads, 0, stream>>>(
            v, f, partials, lm, wc, woff);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials_kernel<<<1, kFinalThreads, 0, stream>>>(partials, nb, scale,
                                                          out);
    return (int)cudaGetLastError();
}

constexpr int kMqTx = 32, kMqTy = 8, kMqTz = 8;   // tile (x, y, z)
constexpr int kMqHx = kMqTx + 2, kMqHy = kMqTy + 2, kMqHz = kMqTz + 2;
constexpr int kMqHalo = kMqHx * kMqHy * kMqHz;    // r on the tile + 1 halo
constexpr int kMqThreads = kMqTx * kMqTy;
constexpr int kOffsets = 27, kClasses = 27;

__device__ __forceinline__ int axis_class(int i, int lm) {
    return i == 0 ? 0 : (i == lm - 1 ? 2 : 1);
}

template <typename T>
__global__ void __launch_bounds__(kMqThreads)
mass_quad_partial_kernel(const T* __restrict__ v, const T* __restrict__ f,
                         const T* __restrict__ tables, int mask,
                         double* __restrict__ partials, int lm, T wc,
                         T woff) {
    __shared__ T rs[kMqHalo];
    __shared__ T tbl[kOffsets * kClasses];
    __shared__ double red[kMqThreads];
    const int tid = threadIdx.y * kMqTx + threadIdx.x;
    for (int i = tid; i < kOffsets * kClasses; i += kMqThreads)
        tbl[i] = tables[i];
    const int x0 = blockIdx.x * kMqTx, y0 = blockIdx.y * kMqTy,
              z0 = blockIdx.z * kMqTz;
    for (int i = tid; i < kMqHalo; i += kMqThreads) {
        const int x = x0 - 1 + i % kMqHx;
        const int y = y0 - 1 + (i / kMqHx) % kMqHy;
        const int z = z0 - 1 + i / (kMqHx * kMqHy);
        const bool in = x >= 0 && x < lm && y >= 0 && y < lm && z >= 0 &&
                        z < lm;
        rs[i] = in ? residual_unmasked(v, f, z, y, x, lm, wc, woff) : T(0);
    }
    __syncthreads();
    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    double sum = 0.0;
    if (x < lm && y < lm) {
        const int cyx = 3 * axis_class(y, lm) + axis_class(x, lm);
        for (int tz = 0; tz < kMqTz && z0 + tz < lm; ++tz) {
            const int cls = 9 * axis_class(z0 + tz, lm) + cyx;
            const int c = ((tz + 1) * kMqHy + threadIdx.y + 1) * kMqHx +
                          threadIdx.x + 1;
            T acc = T(0);
#pragma unroll
            for (int k = 0; k < kOffsets; ++k) {
                if ((mask >> k) & 1) {
                    const int dz = k / 9 - 1, dy = k / 3 % 3 - 1,
                              dx = k % 3 - 1;
                    const int nb = c + (dz * kMqHy + dy) * kMqHx + dx;
                    acc = acc + tbl[k * kClasses + cls] * rs[nb];
                }
            }
            sum += (double)(rs[c] * acc);
        }
    }
    red[tid] = sum;
    __syncthreads();
    for (int w = kMqThreads / 2; w > 0; w >>= 1) {
        if (tid < w) red[tid] += red[tid + w];
        __syncthreads();
    }
    if (tid == 0)
        partials[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                 blockIdx.x] = red[0];
}

dim3 mass_quad_grid(int lm) {
    return dim3((lm + kMqTx - 1) / kMqTx, (lm + kMqTy - 1) / kMqTy,
                (lm + kMqTz - 1) / kMqTz);
}

template <typename T>
int residual_mass_quad(const T* v, const T* f, const T* tables, int mask,
                       double* partials, double* out, int lm, T wc, T woff,
                       cudaStream_t stream) {
    const dim3 grid = mass_quad_grid(lm);
    mass_quad_partial_kernel<T><<<grid, dim3(kMqTx, kMqTy), 0, stream>>>(
        v, f, tables, mask, partials, lm, wc, woff);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials_kernel<<<1, kFinalThreads, 0, stream>>>(
        partials, (int)(grid.x * grid.y * grid.z), 1.0, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of doubles the caller must allocate for `partials`.
int mg_tet_quad_partials(int lm) { return quad_blocks(lm); }

// diag: 0 = 'right', 1 = 'left'.  out[0] = scale * q_raw.
int mg_residual_tet_quad_f32(const float* v, const float* f, double* partials,
                             double* out, int lm, float wc, float woff,
                             int diag, double scale, void* stream) {
    return residual_tet_quad<float>(v, f, partials, out, lm, wc, woff, diag,
                                    scale, (cudaStream_t)stream);
}

int mg_residual_tet_quad_f64(const double* v, const double* f,
                             double* partials, double* out, int lm,
                             double wc, double woff, int diag, double scale,
                             void* stream) {
    return residual_tet_quad<double>(v, f, partials, out, lm, wc, woff, diag,
                                     scale, (cudaStream_t)stream);
}

// Number of doubles the caller must allocate for K38's `partials`.
int mg_mass_quad_partials(int lm) {
    const dim3 g = mass_quad_grid(lm);
    return (int)(g.x * g.y * g.z);
}

// tables: 27 x 27 dense [offset][class] in T; mask: bit k set where offset
// k is present.  out[0] = q.
int mg_residual_mass_quad_f32(const float* v, const float* f,
                              const float* tables, int mask, double* partials,
                              double* out, int lm, float wc, float woff,
                              void* stream) {
    return residual_mass_quad<float>(v, f, tables, mask, partials, out, lm, wc,
                                     woff, (cudaStream_t)stream);
}

int mg_residual_mass_quad_f64(const double* v, const double* f,
                              const double* tables, int mask,
                              double* partials, double* out, int lm,
                              double wc, double woff, void* stream) {
    return residual_mass_quad<double>(v, f, tables, mask, partials, out, lm,
                                      wc, woff, (cudaStream_t)stream);
}

}  // extern "C"
