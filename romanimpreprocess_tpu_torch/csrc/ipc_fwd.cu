// One forward application of the spatially-varying 3x3 IPC kernel to a
// cube: the sim's IL forward model (electrons collected -> electrons
// seen by the readout).
//
// Replaces the TPU kernel romanimpreprocess_tpu/ops/ipc_pallas.py
// ipc_fwd_cube_blocked (_ipc_fwd_kernel_blocked).  For every group g of
// the (G, n, n) cube:
//
//     y   = d * gain               (y = d when no gain is given)
//     out = (K y) / gain           (out = K y when no gain is given)
//     (K y)[r, c] = sum_t y[r-dy, c-dx] * K_t[r-dy, c-dx]
//
// The weights are indexed at the SOURCE pixel: K_t[y, x] is the
// fraction of pixel (y, x)'s charge that lands at (y+dy, x+dx), with
// t = 3 (1 + dy) + (1 + dx).  Sources outside the array contribute
// zero (zero fill).  The TPU kernel needs the cube and the planes in a
// padded slab layout for its block windows; here the raw (9, n, n)
// planes are read as they are and the edge is a bounds check.
//
// What bounds it: bytes.  The cube is read and written once and the
// nine planes read once: 1.40 GB at 6 groups of 4088^2.  Design: one
// CTA per 32x32 output tile loads the nine planes (and the gain) of
// its tile plus a 1-pixel halo into shared memory ONCE and keeps them
// while it loops over the groups; the next group's cube tile is loaded
// into registers while the current one is computed.
//
// Every rounding step is an explicit _rn intrinsic in the order of the
// plain PyTorch twin (ipc.ipc_fwd: centre tap first, then the eight
// shifts in row-major order; an out-of-range tap adds +0), so the
// kernel agrees with the twin bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int TH = 32;            // output tile rows
constexpr int TW = 32;            // output tile cols
constexpr int HY = TH + 2;        // tile + 1-pixel halo
constexpr int HX = TW + 2;
constexpr int HN = HY * HX;
constexpr int NTHREADS = 256;
constexpr int YPT = (HN + NTHREADS - 1) / NTHREADS;  // tile values per thread
constexpr size_t SMEM_BYTES = sizeof(float) * (9 * HN + 2 * HN);

// the centre (t = 4) is summed first, then j = 1..8 -> t = 0,1,2,3,5,6,7,8
__device__ __forceinline__ constexpr int off_centre_tap(int j)
{
    return j <= 4 ? j - 1 : j;
}

template <bool HAS_GAIN>
__global__ void __launch_bounds__(NTHREADS)
ipc_fwd_kernel(const float* __restrict__ data,
               const float* __restrict__ planes,
               const float* __restrict__ gain,
               float* __restrict__ out, int ngrp, int n)
{
    extern __shared__ float smem[];
    float* k_s = smem;             // 9 x HY x HX
    float* g_s = k_s + 9 * HN;     // HY x HX (unused without gain)
    float* y_s = g_s + HN;         // HY x HX

    const int r0 = blockIdx.y * TH;
    const int c0 = blockIdx.x * TW;
    const size_t plane = (size_t)n * n;
    const int tid = threadIdx.x;

    for (int i = tid; i < HN; i += NTHREADS) {
        const int r = r0 - 1 + i / HX;
        const int c = c0 - 1 + i % HX;
        const bool in = r >= 0 && r < n && c >= 0 && c < n;
        const size_t off = in ? (size_t)r * n + c : 0;
#pragma unroll
        for (int t = 0; t < 9; ++t)
            k_s[t * HN + i] = in ? planes[t * plane + off] : 0.f;
        if (HAS_GAIN) g_s[i] = in ? gain[off] : 0.f;
    }

    float dr[YPT];
    auto load_tile = [&](int g) {
        const float* d = data + g * plane;
#pragma unroll
        for (int u = 0; u < YPT; ++u) {
            const int i = tid + u * NTHREADS;
            const int r = r0 - 1 + i / HX;
            const int c = c0 - 1 + i % HX;
            const bool in = i < HN && r >= 0 && r < n && c >= 0 && c < n;
            dr[u] = in ? d[(size_t)r * n + c] : 0.f;
        }
    };
    load_tile(0);

    for (int g = 0; g < ngrp; ++g) {
        float* o = out + g * plane;
        __syncthreads();  // planes loaded / previous group done with y_s
#pragma unroll
        for (int u = 0; u < YPT; ++u) {
            const int i = tid + u * NTHREADS;
            if (i < HN) y_s[i] = HAS_GAIN ? __fmul_rn(dr[u], g_s[i]) : dr[u];
        }
        __syncthreads();
        if (g + 1 < ngrp) load_tile(g + 1);
        for (int i = tid; i < TH * TW; i += NTHREADS) {
            const int tr = i / TW;
            const int tc = i % TW;
            const int r = r0 + tr;
            const int c = c0 + tc;
            if (r >= n || c >= n) continue;
            const int h = (tr + 1) * HX + (tc + 1);
            float acc = __fmul_rn(y_s[h], k_s[4 * HN + h]);
#pragma unroll
            for (int j = 1; j < 9; ++j) {
                const int t = off_centre_tap(j);
                const int src = (tr + 1 - (t / 3 - 1)) * HX + (tc + 1 - (t % 3 - 1));
                acc = __fadd_rn(acc, __fmul_rn(y_s[src], k_s[t * HN + src]));
            }
            o[(size_t)r * n + c] = HAS_GAIN ? __fdiv_rn(acc, g_s[h]) : acc;
        }
    }
}

template <bool HAS_GAIN>
cudaError_t launch(const float* data, const float* planes, const float* gain,
                   float* out, int ngrp, int n, cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        ipc_fwd_kernel<HAS_GAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid((n + TW - 1) / TW, (n + TH - 1) / TH);
    ipc_fwd_kernel<HAS_GAIN><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
        data, planes, gain, out, ngrp, n);
    return cudaGetLastError();
}

}  // namespace

// data, out (ngrp, n, n); planes (9, n, n); gain (n, n) or null; all
// float32 and contiguous.
extern "C" int ipc_fwd_cube_launch(const float* data, const float* planes,
                                   const float* gain, float* out,
                                   int ngrp, int n, void* stream)
{
    if (ngrp < 1 || n < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(gain ? launch<true>(data, planes, gain, out, ngrp, n, s)
                      : launch<false>(data, planes, gain, out, ngrp, n, s));
}
