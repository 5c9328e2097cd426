// Order-2 IPC inverse on the raw full frame, border passthrough.
//
// Replaces the TPU kernel romanimpreprocess_tpu/ops/ipc_pallas.py
// ipc_rev2_frame_stream (_ipc_kernel_frame).  For every group g of the
// (G, n, n) cube, the order-2 Neumann inverse 3y - 3Ky + K(Ky):
//
//     y   = d * gain
//     o1  = (y + y) - K y,  (K y)[r, c] = sum_t y[r-dy, c-dx] * K_t[r-dy, c-dx]
//     out = ((o1 + y) - K o1) / gain     on the active region,
//     out = d                            on the nborder-wide border.
//
// The weights are indexed at the SOURCE pixel: K_t[y, x] is the
// fraction of pixel (y, x)'s charge that lands at (y+dy, x+dx).  The
// nine planes come border-zeroed (kernel_planes_frame), and this kernel
// reads zeros outside the frame, which together give the zero-fill edge
// of the reference stencil.
//
// What bounds it: bytes.  Per call the cube is read and written once,
// the nine planes and the gain read once: about 1.48 GB at
// 4096^2 x 6 groups.  Design: one CTA per 32x32 output tile loads the
// nine planes and the gain of its tile plus a 2-pixel halo into shared
// memory ONCE and keeps them there while it loops over all groups, so
// the planes are not re-read per group.  Per group, y (2-pixel halo)
// and o1 (1-pixel halo) live in shared memory only; the halo makes the
// cube read (36/32)^2 = 1.27 times.  The next group's cube tile is
// loaded into registers while the current group is computed (the
// kernel is latency-bound, not bandwidth-bound, without it).
//
// Every rounding step is an explicit _rn intrinsic, in the order of the
// plain PyTorch twin (ipc_rev2_frame_plain, which follows the JAX
// package's Neumann recursion: centre tap first, then the eight shifts
// in row-major order): no FMA contraction, so the kernel agrees with
// the twin bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int TH = 32;            // output tile rows
constexpr int TW = 32;            // output tile cols
constexpr int HY = TH + 4;        // y / K / gain tile (2-pixel halo)
constexpr int HX = TW + 4;
constexpr int AY = TH + 2;        // o1 tile (1-pixel halo)
constexpr int AX = TW + 2;
constexpr int NTHREADS = 256;
constexpr int HN = HY * HX;
constexpr int YPT = (HN + NTHREADS - 1) / NTHREADS;  // tile values per thread
// tap t holds (dy, dx) = (t / 3 - 1, t % 3 - 1); the centre (t = 4)
// is summed first, as the reference's K application does, then the
// other taps in order: j = 1..8 -> t = 0, 1, 2, 3, 5, 6, 7, 8
__device__ __forceinline__ constexpr int off_centre_tap(int j)
{
    return j <= 4 ? j - 1 : j;
}
constexpr size_t SMEM_BYTES = sizeof(float) * (9 * HN + 2 * HN + AY * AX);

__global__ void __launch_bounds__(NTHREADS)
ipc_rev2_frame_kernel(const float* __restrict__ data,
                      const float* __restrict__ planes,
                      const float* __restrict__ gain,
                      float* __restrict__ out,
                      int ngrp, int nside, int nb)
{
    extern __shared__ float smem[];
    float* k_s = smem;             // 9 x HY x HX
    float* g_s = k_s + 9 * HN;     // HY x HX
    float* y_s = g_s + HN;         // HY x HX
    float* a_s = y_s + HN;         // AY x AX: o1

    const int r0 = blockIdx.y * TH;
    const int c0 = blockIdx.x * TW;
    const size_t plane = (size_t)nside * nside;
    const int tid = threadIdx.x;

    // nine planes + gain on the halo tile, zero outside the frame
    for (int i = tid; i < HN; i += NTHREADS) {
        const int r = r0 - 2 + i / HX;
        const int c = c0 - 2 + i % HX;
        const bool in = r >= 0 && r < nside && c >= 0 && c < nside;
        const size_t off = in ? (size_t)r * nside + c : 0;
#pragma unroll
        for (int t = 0; t < 9; ++t)
            k_s[t * HN + i] = in ? planes[t * plane + off] : 0.f;
        g_s[i] = in ? gain[off] : 0.f;
    }

    // the cube tile (2-pixel halo) of one group into registers, zero
    // outside the frame; group g+1's loads are in flight while group g
    // is computed
    float dr[YPT];
    auto load_tile = [&](int g) {
        const float* d = data + g * plane;
#pragma unroll
        for (int u = 0; u < YPT; ++u) {
            const int i = tid + u * NTHREADS;
            const int r = r0 - 2 + i / HX;
            const int c = c0 - 2 + i % HX;
            const bool in = i < HN && r >= 0 && r < nside && c >= 0 && c < nside;
            dr[u] = in ? d[(size_t)r * nside + c] : 0.f;
        }
    };
    load_tile(0);

    for (int g = 0; g < ngrp; ++g) {
        const float* d = data + g * plane;
        float* o = out + g * plane;
        __syncthreads();  // planes loaded / previous group done with y_s, a_s
#pragma unroll
        for (int u = 0; u < YPT; ++u) {
            const int i = tid + u * NTHREADS;
            if (i < HN) y_s[i] = __fmul_rn(dr[u], g_s[i]);  // 0 * 0 outside
        }
        __syncthreads();
        if (g + 1 < ngrp) load_tile(g + 1);
        // o1 = 2y - K y on the tile + 1-pixel halo; o1-tile (ar, ac) is
        // halo tile (ar + 1, ac + 1)
        for (int i = tid; i < AY * AX; i += NTHREADS) {
            const int hr = i / AX + 1;
            const int hc = i % AX + 1;
            float acc = __fmul_rn(y_s[hr * HX + hc], k_s[4 * HN + hr * HX + hc]);
#pragma unroll
            for (int j = 1; j < 9; ++j) {
                const int t = off_centre_tap(j);
                const int src = (hr - (t / 3 - 1)) * HX + (hc - (t % 3 - 1));
                acc = __fadd_rn(acc, __fmul_rn(y_s[src], k_s[t * HN + src]));
            }
            const float y = y_s[hr * HX + hc];
            a_s[i] = __fsub_rn(__fadd_rn(y, y), acc);
        }
        __syncthreads();
        for (int i = tid; i < TH * TW; i += NTHREADS) {
            const int tr = i / TW;
            const int tc = i % TW;
            const int r = r0 + tr;
            const int c = c0 + tc;
            if (r >= nside || c >= nside) continue;
            const size_t off = (size_t)r * nside + c;
            if (r < nb || r >= nside - nb || c < nb || c >= nside - nb) {
                o[off] = d[off];
                continue;
            }
            const int ar = tr + 1;
            const int ac = tc + 1;
            const int h = (tr + 2) * HX + (tc + 2);
            float b = __fmul_rn(a_s[ar * AX + ac], k_s[4 * HN + h]);
#pragma unroll
            for (int j = 1; j < 9; ++j) {
                const int t = off_centre_tap(j);
                const int sr = ar - (t / 3 - 1);
                const int sc = ac - (t % 3 - 1);
                b = __fadd_rn(b, __fmul_rn(a_s[sr * AX + sc],
                                           k_s[t * HN + (sr + 1) * HX + (sc + 1)]));
            }
            const float o2 = __fsub_rn(__fadd_rn(a_s[ar * AX + ac], y_s[h]), b);
            o[off] = __fdiv_rn(o2, g_s[h]);
        }
    }
}

}  // namespace

extern "C" int ipc_rev2_frame_launch(const float* data, const float* planes,
                                     const float* gain, float* out,
                                     int ngrp, int nside, int nborder,
                                     void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        ipc_rev2_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((nside + TW - 1) / TW, (nside + TH - 1) / TH);
    ipc_rev2_frame_kernel<<<grid, NTHREADS, SMEM_BYTES,
                            (cudaStream_t)stream>>>(
        data, planes, gain, out, ngrp, nside, nborder);
    return (int)cudaGetLastError();
}
