// Fused Chebyshev smoothing step for Hopper (sm_90a): K12 of the port.
//
// Replaces multigrid_dolfinx_tpu/ops/pallas/stencil3d_cheby.py cheby_step
// (_cheby_kernel): one step of the momentum (three-term) form
//
//     out = v + a (v - vp) + b z,   z = D^-1 (f - A v),
//
// with r = f - (wc v + woff S(v~)) and z = r * inv_wc on the interior,
// r = f - v and z = r on the boundary (identity rows, dinv = 1).  The
// association is the Pallas body's: wc v + woff S, then f - av, then
// (v + a (v - vp)) + b z; the library is built with --fmad=false, so the
// kernel agrees bitwise with its plain version (ops/cuda/stencil3d_cheby.py
// cheby_step_ref).  a and b are arguments in the solve's type, formed on
// the host once per phase (ops/smoothers.py chebyshev_phase).
//
// Bound on the H100: memory.  It reads v, vp and f and writes one array,
// 16 bytes per point in f32; the six neighbours of v come from L1/L2.
// One thread per point in 32 x 8 blocks (a warp on 32 consecutive x),
// one z plane per grid slice, 32-bit indices (the wrapper refuses
// lm > 1290).  The first step of a phase passes vp == v (a = 0): both are
// only read, so neither pointer is __restrict__.
//
// The entry point is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "stencil3d.cuh"

namespace {

template <typename T>
__global__ void cheby_step_kernel(const T* v, const T* vp,
                                  const T* __restrict__ f,
                                  T* __restrict__ out, int lm, T wc, T woff,
                                  T inv_wc, T a, T b) {
    const int x = blockIdx.x * mg3d::kBx + threadIdx.x;
    const int y = blockIdx.y * mg3d::kBy + threadIdx.y;
    const int z = blockIdx.z;
    if (x >= lm || y >= lm) return;
    const int p = (z * lm + y) * lm + x;
    const T vc = v[p];
    T zz;
    if (mg3d::interior(z, y, x, lm)) {
        const T av = wc * vc + woff * mg3d::nbr_sum(v, p, z, y, x, lm);
        zz = (f[p] - av) * inv_wc;
    } else {
        zz = f[p] - vc;
    }
    out[p] = (vc + a * (vc - vp[p])) + b * zz;
}

template <typename T>
int cheby_step(const T* v, const T* vp, const T* f, T* out, int lm, T wc,
               T woff, T inv_wc, T a, T b, cudaStream_t stream) {
    const dim3 block(mg3d::kBx, mg3d::kBy);
    cheby_step_kernel<T><<<mg3d::grid_for(lm), block, 0, stream>>>(
        v, vp, f, out, lm, wc, woff, inv_wc, a, b);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_cheby_step_f32(const float* v, const float* vp, const float* f,
                      float* out, int lm, float wc, float woff, float inv_wc,
                      float a, float b, void* stream) {
    return cheby_step<float>(v, vp, f, out, lm, wc, woff, inv_wc, a, b,
                             (cudaStream_t)stream);
}

int mg_cheby_step_f64(const double* v, const double* vp, const double* f,
                      double* out, int lm, double wc, double woff,
                      double inv_wc, double a, double b, void* stream) {
    return cheby_step<double>(v, vp, f, out, lm, wc, woff, inv_wc, a, b,
                              (cudaStream_t)stream);
}

}  // extern "C"
