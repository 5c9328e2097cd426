// Order-2 IPC inverse on an active-region cube: the blocked kernel, the
// streaming kernel, and the fused full-frame launch of the blocked one.
//
// Replaces the TPU kernels of romanimpreprocess_tpu/ops/ipc_pallas.py:
// ipc_rev2_cube_blocked (_ipc_kernel_blocked), ipc_rev2_cube_stream
// (_ipc_kernel_stream) and the wrapper correct_cube_fused.  For every
// group of the (G, na, na) cube
//
//     y   = d * gain                      (y = d without a gain)
//     a   = K y,   b = K a
//     out = ((3 y - 3 a) + b) / gain
//     (K x)[r, c] = sum_{t=0..8} x[r-dy, c-dx] * K_t[r-dy, c-dx],
//                   (dy, dx) = (t / 3 - 1, t % 3 - 1)
//
// with the weights indexed at the SOURCE pixel, the taps summed in the
// order t = 0..8 (the first product starts the sum), and sources outside
// the active region reading as +0: that is what the zero pad rows and
// columns of the TPU kernels' slab layout give.  `a` is not zero one
// pixel outside the active region (in-range sources spill there); it is
// formed on that ring like anywhere else and killed by the ring's zero
// weights when `b` is summed.
//
// Every array comes with a row pitch (and the cube and the planes with a
// group / plane stride), so one kernel reads
//   - a contiguous active-region cube or the active view of a full frame,
//   - the raw (3, 3, na, na) IPC kernel (pitch na) or the pre-padded
//     (9, rows_in, width) slab buffer in place (offset th * width + 2,
//     pitch width): no repack, no slice copy.
//
// What bounds them: bytes.  Cube in and out, nine planes and the gain:
// 4 * na^2 * (2 G + 9 + 1) = 1.47 GB at 6 groups of 4088^2.
//
// Blocked kernel: one CTA per 32x32 output tile loads the nine planes
// and the gain of its tile plus a 2-pixel halo into shared memory once
// and loops over the groups; y (2-pixel halo) and a (1-pixel halo) live
// in shared memory only.  The halo is read again by the neighbouring
// CTAs ((36/32)^2 = 1.27 times the tile), as the TPU kernel's three
// shifted windows read the cube three times.  The next group's cube tile
// is loaded into registers while the current group is computed.
//
// Streaming kernel: a CTA owns a strip of 128 columns (plus 2 halo
// columns each side) and a segment of 64 rows, and marches down the rows
// with a ring in shared memory: five rows of the nine planes, of the
// gain and of y per group, three rows of a per group.  Each step loads
// ONE row (planes, gain, all groups), forms the a-row above it and the
// output row above that.  Every input row of a strip segment is read
// from global memory once; a segment re-reads 4 warm-up rows (4/64) and
// a strip 4 halo columns (4/128).
//
// Fused launch: the blocked kernel on the active view of the full frame
// (base offset nb * nside + nb, pitch nside), writing the active region
// of the output frame; extra CTAs of the SAME launch copy the nb-wide
// border through.
//
// Every rounding step is an explicit _rn intrinsic in the order of the
// plain PyTorch twin (ops/ipc_slab.py ipc_rev2_plain): no FMA
// contraction, so both kernels agree with the twin, and with each other,
// bit for bit.
#include <cuda_runtime.h>

namespace {

struct Slab {
    const float* in;    // group 0, active row 0, active col 0
    long long in_gs;    // elements between groups
    int in_pitch;       // elements between rows
    float* out;
    long long out_gs;
    int out_pitch;
    const float* k;     // plane 0, active row 0, active col 0
    long long k_ps;     // elements between planes
    int k_pitch;
    const float* gain;  // active row 0, col 0; null: no gain
    int g_pitch;
    int ngrp;
    int na;
};

struct Border {
    const float* in;    // (G, nside, nside) contiguous frames; null: none
    float* out;
    int nside;
    int nb;
};

// ------------------------------------------------------------------ blocked

constexpr int TH = 32;            // output tile rows
constexpr int TW = 32;            // output tile cols
constexpr int HY = TH + 4;        // y / K / gain tile (2-pixel halo)
constexpr int HX = TW + 4;
constexpr int AY = TH + 2;        // a tile (1-pixel halo)
constexpr int AX = TW + 2;
constexpr int NTHREADS = 256;
constexpr int HN = HY * HX;
constexpr int YPT = (HN + NTHREADS - 1) / NTHREADS;  // tile values per thread
constexpr size_t BLOCKED_SMEM = sizeof(float) * (9 * HN + 2 * HN + AY * AX);

__device__ void copy_border(const Border& q, int ngrp, int block, int nblocks)
{
    // border pixels of one frame: nb full rows at the top and at the
    // bottom, nb columns left and right of the na rows between
    const long long nside = q.nside;
    const int nb = q.nb;
    const long long na = nside - 2 * nb;
    const long long rows = (long long)nb * nside;
    const long long per = 2 * rows + 2 * nb * na;
    const long long total = per * ngrp;
    for (long long i = (long long)block * NTHREADS + threadIdx.x; i < total;
         i += (long long)nblocks * NTHREADS) {
        const long long g = i / per;
        long long j = i % per;
        long long r, c;
        if (j < rows) {
            r = j / nside;
            c = j % nside;
        } else if (j < 2 * rows) {
            j -= rows;
            r = nside - nb + j / nside;
            c = j % nside;
        } else {
            j -= 2 * rows;
            r = nb + j / (2 * nb);
            const long long kk = j % (2 * nb);
            c = kk < nb ? kk : nside - 2 * nb + kk;
        }
        const long long off = (g * nside + r) * nside + c;
        q.out[off] = q.in[off];
    }
}

__global__ void __launch_bounds__(NTHREADS)
ipc_slab_blocked_kernel(Slab p, Border q, int tiles_y)
{
    if ((int)blockIdx.y >= tiles_y) {
        copy_border(q, p.ngrp, (blockIdx.y - tiles_y) * gridDim.x + blockIdx.x,
                    (gridDim.y - tiles_y) * gridDim.x);
        return;
    }
    extern __shared__ float smem[];
    float* k_s = smem;             // 9 x HY x HX
    float* g_s = k_s + 9 * HN;     // HY x HX
    float* y_s = g_s + HN;         // HY x HX
    float* a_s = y_s + HN;         // AY x AX

    const int r0 = blockIdx.y * TH;
    const int c0 = blockIdx.x * TW;
    const int na = p.na;
    const int tid = threadIdx.x;

    // nine planes + gain on the halo tile; zero weights outside the
    // active region, gain 1 where there is none (x * 1 and x / 1 are x)
    for (int i = tid; i < HN; i += NTHREADS) {
        const int r = r0 - 2 + i / HX;
        const int c = c0 - 2 + i % HX;
        const bool in = r >= 0 && r < na && c >= 0 && c < na;
        const size_t koff = in ? (size_t)r * p.k_pitch + c : 0;
#pragma unroll
        for (int t = 0; t < 9; ++t)
            k_s[t * HN + i] = in ? p.k[(size_t)t * p.k_ps + koff] : 0.f;
        g_s[i] = (in && p.gain) ? p.gain[(size_t)r * p.g_pitch + c] : 1.f;
    }

    // the cube tile (2-pixel halo) of one group into registers, +0
    // outside the active region; group g+1's loads are in flight while
    // group g is computed
    float dr[YPT];
    auto load_tile = [&](int g) {
        const float* d = p.in + (size_t)g * p.in_gs;
#pragma unroll
        for (int u = 0; u < YPT; ++u) {
            const int i = tid + u * NTHREADS;
            const int r = r0 - 2 + i / HX;
            const int c = c0 - 2 + i % HX;
            const bool in = i < HN && r >= 0 && r < na && c >= 0 && c < na;
            dr[u] = in ? d[(size_t)r * p.in_pitch + c] : 0.f;
        }
    };
    load_tile(0);

    for (int g = 0; g < p.ngrp; ++g) {
        float* o = p.out + (size_t)g * p.out_gs;
        __syncthreads();  // planes loaded / previous group done with y_s, a_s
#pragma unroll
        for (int u = 0; u < YPT; ++u) {
            const int i = tid + u * NTHREADS;
            if (i < HN) y_s[i] = __fmul_rn(dr[u], g_s[i]);
        }
        __syncthreads();
        if (g + 1 < p.ngrp) load_tile(g + 1);
        // a = K y on the tile + 1-pixel ring; a-tile (ar, ac) is halo
        // tile (ar + 1, ac + 1)
        for (int i = tid; i < AY * AX; i += NTHREADS) {
            const int hr = i / AX + 1;
            const int hc = i % AX + 1;
            float acc = 0.f;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
                const int src = (hr - (t / 3 - 1)) * HX + (hc - (t % 3 - 1));
                const float prod = __fmul_rn(y_s[src], k_s[t * HN + src]);
                acc = t == 0 ? prod : __fadd_rn(acc, prod);
            }
            a_s[i] = acc;
        }
        __syncthreads();
        for (int i = tid; i < TH * TW; i += NTHREADS) {
            const int tr = i / TW;
            const int tc = i % TW;
            const int r = r0 + tr;
            const int c = c0 + tc;
            if (r >= na || c >= na) continue;
            const int ar = tr + 1;
            const int ac = tc + 1;
            float b = 0.f;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
                const int sr = ar - (t / 3 - 1);
                const int sc = ac - (t % 3 - 1);
                const float prod = __fmul_rn(
                    a_s[sr * AX + sc], k_s[t * HN + (sr + 1) * HX + (sc + 1)]);
                b = t == 0 ? prod : __fadd_rn(b, prod);
            }
            const int h = (tr + 2) * HX + (tc + 2);
            const float res = __fadd_rn(
                __fsub_rn(__fmul_rn(3.f, y_s[h]),
                          __fmul_rn(3.f, a_s[ar * AX + ac])), b);
            o[(size_t)r * p.out_pitch + c] = __fdiv_rn(res, g_s[h]);
        }
    }
}

// ---------------------------------------------------------------- streaming

constexpr int SW = 128;           // strip columns
constexpr int SWH = SW + 4;       // y / K / gain row (2-pixel halo)
constexpr int SWA = SW + 2;       // a row (1-pixel halo)
constexpr int SEG = 64;           // rows per segment
constexpr int SNT = 288;          // threads: >= 2 * SWH for the row load
constexpr int YR = 5;             // ring rows of y, K, gain
constexpr int AR = 3;             // ring rows of a

__host__ __device__ inline size_t stream_smem(int ngrp)
{
    return sizeof(float) * ((size_t)(9 + 1 + ngrp) * YR * SWH
                            + (size_t)ngrp * AR * SWA);
}

__global__ void __launch_bounds__(SNT)
ipc_slab_stream_kernel(Slab p)
{
    extern __shared__ float smem[];
    const int G = p.ngrp;
    float* k_s = smem;                   // 9 x YR x SWH
    float* g_s = k_s + 9 * YR * SWH;     // YR x SWH
    float* y_s = g_s + YR * SWH;         // G x YR x SWH
    float* a_s = y_s + G * YR * SWH;     // G x AR x SWA

    const int na = p.na;
    const int c0 = blockIdx.x * SW;
    const int rs = blockIdx.y * SEG;
    const int re = min(rs + SEG, na);
    const int tid = threadIdx.x;

    // step L: load row L; then a-row L-1 (y rows L-2..L are in the
    // ring); then output row L-2 (a rows L-3..L-1).  Rows rs-2, rs-1,
    // re, re+1 are the segment's warm-up and tail.
    for (int L = rs - 2; L <= re + 1; ++L) {
        const int sl = (L + 2 * YR) % YR;
        const bool rin = L >= 0 && L < na;
        // one thread per (column, half): half 0 the nine planes, half 1
        // the gain and every group's y = d * gain
        if (tid < 2 * SWH) {
            const int x = tid % SWH;
            const int c = c0 - 2 + x;
            const bool in = rin && c >= 0 && c < na;
            if (tid < SWH) {
                const size_t koff = in ? (size_t)L * p.k_pitch + c : 0;
#pragma unroll
                for (int t = 0; t < 9; ++t)
                    k_s[(t * YR + sl) * SWH + x] =
                        in ? p.k[(size_t)t * p.k_ps + koff] : 0.f;
            } else {
                const float gv = (in && p.gain)
                    ? p.gain[(size_t)L * p.g_pitch + c] : 1.f;
                g_s[sl * SWH + x] = gv;
                const size_t doff = in ? (size_t)L * p.in_pitch + c : 0;
                for (int g = 0; g < G; ++g) {
                    const float d = in ? p.in[(size_t)g * p.in_gs + doff] : 0.f;
                    y_s[(g * YR + sl) * SWH + x] = __fmul_rn(d, gv);
                }
            }
        }
        __syncthreads();
        // a-row R = L - 1 on the strip + 1-pixel ring: a column ax is
        // row column ax + 1
        const int R = L - 1;
        if (R >= rs - 1) {
            const int as = (R + 2 * AR) % AR;
            for (int i = tid; i < G * SWA; i += SNT) {
                const int g = i / SWA;
                const int hc = i % SWA + 1;
                float acc = 0.f;
#pragma unroll
                for (int t = 0; t < 9; ++t) {
                    const int s = (R - (t / 3 - 1) + 2 * YR) % YR;
                    const int sx = hc - (t % 3 - 1);
                    const float prod = __fmul_rn(y_s[(g * YR + s) * SWH + sx],
                                                 k_s[(t * YR + s) * SWH + sx]);
                    acc = t == 0 ? prod : __fadd_rn(acc, prod);
                }
                a_s[(g * AR + as) * SWA + (hc - 1)] = acc;
            }
        }
        __syncthreads();
        // output row O = L - 2
        const int O = L - 2;
        if (O >= rs) {
            const int ys = (O + 2 * YR) % YR;
            for (int i = tid; i < G * SW; i += SNT) {
                const int g = i / SW;
                const int tc = i % SW;
                const int c = c0 + tc;
                if (c >= na) continue;
                const int ac = tc + 1;
                float b = 0.f;
#pragma unroll
                for (int t = 0; t < 9; ++t) {
                    const int sr = O - (t / 3 - 1);
                    const int sc = ac - (t % 3 - 1);
                    const float prod = __fmul_rn(
                        a_s[(g * AR + (sr + 2 * AR) % AR) * SWA + sc],
                        k_s[(t * YR + (sr + 2 * YR) % YR) * SWH + sc + 1]);
                    b = t == 0 ? prod : __fadd_rn(b, prod);
                }
                const float y = y_s[(g * YR + ys) * SWH + tc + 2];
                const float a = a_s[(g * AR + (O + 2 * AR) % AR) * SWA + ac];
                const float res = __fadd_rn(
                    __fsub_rn(__fmul_rn(3.f, y), __fmul_rn(3.f, a)), b);
                p.out[(size_t)g * p.out_gs + (size_t)O * p.out_pitch + c] =
                    __fdiv_rn(res, g_s[ys * SWH + tc + 2]);
            }
        }
        // the next step's load overwrites the ring row of L - 4 and its
        // a-row that of L - 3: neither is read after this point, and the
        // sync after the load orders the a-row write behind these reads
    }
}

Slab make_slab(const float* in, long long in_gs, int in_pitch,
               float* out, long long out_gs, int out_pitch,
               const float* k, long long k_ps, int k_pitch,
               const float* gain, int g_pitch, int ngrp, int na)
{
    Slab p;
    p.in = in; p.in_gs = in_gs; p.in_pitch = in_pitch;
    p.out = out; p.out_gs = out_gs; p.out_pitch = out_pitch;
    p.k = k; p.k_ps = k_ps; p.k_pitch = k_pitch;
    p.gain = gain; p.g_pitch = g_pitch;
    p.ngrp = ngrp; p.na = na;
    return p;
}

}  // namespace

// The blocked kernel.  With frame_in / frame_out given (the fused
// launch), `in` and `out` point at the active region inside those
// (ngrp, nside, nside) frames and extra CTAs of the launch copy the
// nborder-wide border from frame_in to frame_out.
extern "C" int ipc_slab_blocked_launch(
    const float* in, long long in_gs, int in_pitch,
    float* out, long long out_gs, int out_pitch,
    const float* k, long long k_ps, int k_pitch,
    const float* gain, int g_pitch, int ngrp, int na,
    const float* frame_in, float* frame_out, int nside, int nborder,
    void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        ipc_slab_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)BLOCKED_SMEM);
    if (err != cudaSuccess) return (int)err;
    const Slab p = make_slab(in, in_gs, in_pitch, out, out_gs, out_pitch,
                             k, k_ps, k_pitch, gain, g_pitch, ngrp, na);
    Border q;
    q.in = frame_in; q.out = frame_out; q.nside = nside; q.nb = nborder;
    const int tiles_x = (na + TW - 1) / TW;
    const int tiles_y = (na + TH - 1) / TH;
    int extra_y = 0;
    if (frame_in && nborder > 0) {
        // about 8 border pixels per thread
        const long long per = 4LL * nborder * (nside - nborder);
        const long long blocks = (per * ngrp + 8 * NTHREADS - 1) / (8 * NTHREADS);
        extra_y = (int)((blocks + tiles_x - 1) / tiles_x);
    }
    dim3 grid(tiles_x, tiles_y + extra_y);
    ipc_slab_blocked_kernel<<<grid, NTHREADS, BLOCKED_SMEM,
                              (cudaStream_t)stream>>>(p, q, tiles_y);
    return (int)cudaGetLastError();
}

extern "C" int ipc_slab_stream_launch(
    const float* in, long long in_gs, int in_pitch,
    float* out, long long out_gs, int out_pitch,
    const float* k, long long k_ps, int k_pitch,
    const float* gain, int g_pitch, int ngrp, int na, void* stream)
{
    const size_t smem = stream_smem(ngrp);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        ipc_slab_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const Slab p = make_slab(in, in_gs, in_pitch, out, out_gs, out_pitch,
                             k, k_ps, k_pitch, gain, g_pitch, ngrp, na);
    dim3 grid((na + SW - 1) / SW, (na + SEG - 1) / SEG);
    ipc_slab_stream_kernel<<<grid, SNT, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
