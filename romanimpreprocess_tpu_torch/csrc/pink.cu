// Batched 1/f ("pink") noise frames: a shaped white spectrum through a
// two-stage Cooley-Tukey DFT whose stages are tensor-core products.
//
// Replaces the TPU kernel romanimpreprocess_tpu/ops/pink_pallas.py
// pink_frames_fused (_pink_kernel).  For each of ntr transforms of
// length N = n1 * n2 (k = k1 n2 + k2, n = m1 + n1 m2; m2 < n2 / 2, the
// first half of the output):
//
//     c[k1, k2]  = bf16(white[k1, k2] * amp[k1, k2])            Re and Im
//     a[k2, m1]  = sum_k1 c[k1, k2] e^(-2 pi i k1 m1 / n1)      bf16 in, f32 sum
//     b[k2, m1]  = bf16(a[k2, m1] e^(-2 pi i k2 m1 / N))        f32 twiddle
//     x[m2, m1]  = sum_k2 e^(-2 pi i k2 m2 / n2) b[k2, m1]      bf16 in, f32 sum
//     out        = Re x - mean(Re x),  Im x - mean(Im x)        two frames
//
// The cast points (bf16 spectrum, bf16 DFT matrices, f32 twiddle, bf16
// b, f32 sums) are those of the TPU kernel and of the plain PyTorch
// twin (pink.fft_ct), so the three agree to the order of the sums.
//
// What bounds it: operations, 12.9 GFLOP per transform at N = 2^20 on
// the bf16 tensor cores, against 8.4 MB of traffic.  The TPU kernel
// keeps one whole transform (two 4 MB f32 intermediates) in its fast
// memory; an SM has 227 KB, so the work is cut into passes over device
// memory / L2, and the constant operand, shared by all transforms,
// makes each stage one large product.
//
// The wgmma path (n1 a multiple of 256, n2 of 128: lengths from 2^16):
//
//   1. pink_stage1: (ntr n2) x (2 n1) x (2 n1).  A is the spectrum with
//      k2 running along memory.  Each consumer warp reads its rows of
//      the MN-major box transposed (ldmatrix.trans: no transpose pass)
//      and the amplitude's box with the same addresses, shapes in
//      registers (one packed bf16 multiply: the product of two bf16
//      values is exact in f32, so its single rounding gives the bits of
//      bf16(float(white) * float(amp))), and feeds wgmma its A operand
//      from registers: no shaped copy is ever written, to device or to
//      shared memory.  B is the constant [cos; sin | -sin; cos], stored
//      K-major, its depth in blocks of 32 Re rows k1 and the same 32 Im
//      rows so that one box of the amplitude serves both.  128 x 128
//      tiles of (k2, m1), Re and Im sums for the same elements in one
//      thread, so the f32 twiddle is applied on the accumulator
//      registers and b leaves as bf16, 16 bytes a thread after an
//      exchange inside each quad (4 MB per transform, to device memory:
//      stage 2 starts when all of stage 1 is done).  The frames' sums
//      are linear in b, so this epilogue also writes each tile's share
//      of them (one slot per tile and warpgroup: no float atomics, the
//      same input gives the same bits on every run).
//   2. pink_stage2: (n2 / 2) x (ntr n1) x (2 n2), the constant
//      [cos^T | sin^T ; -sin^T | cos^T] on the left (K-major), b as the
//      MN-major B, both behind shared-memory descriptors.  64 x 256
//      tiles of (m2, m1); each tile adds its frame's partial sums in a
//      fixed order, subtracts the mean from the accumulators and writes
//      the f32 frame once, in time order: no pass reads the frames
//      again.
//
//   Both products run on persistent CTAs (one per SM) that walk the
//   tiles in an order that keeps a transform's operand and the
//   constants in L2.  One producer thread fills a ring of four stages
//   (56 KB in stage 1, 48 KB in stage 2) in shared memory with TMA boxes
//   (128-byte swizzle), each stage reported to an mbarrier; two consumer
//   warpgroups issue wgmma (m64n256k16 in stage 1, two m64n128k16 that
//   share A in stage 2) from the ring with f32 accumulators in registers
//   (128 a thread), one group in flight, and release a stage through a
//   second mbarrier.  The producer runs ahead
//   into the next tile while the consumers are in their epilogue.
//
//   What bounds these kernels (measured on an H100 at 700 W): stage 2
//   runs at 680 TFLOP/s and loses 8% with three ring stages instead of
//   four, so it is near what this ring can feed the tensor cores.  Stage
//   1 runs at 530: with its ldmatrix and multiply compiled out, with
//   three stages, or with the boxes issued by eight lanes it runs the
//   same, so it is wgmma with A from registers that is slower here than
//   with both operands in shared memory (which reaches 650 on a spectrum
//   shaped beforehand).  The shaping costs about 0.3 ms
//   whichever way it is done: a pre-pass over device memory (and 428 MB
//   of scratch), in place in shared memory (a proxy fence a stage), or
//   through registers as here, which moves the fewest bytes.  Pairing
//   CTAs in clusters to multicast B ran correctly and 1.5 times slower
//   (the pair moves in lock step); it is not used.
//
// The mma.sync path (n1 = 128: lengths 2^14 and 2^15, which the wgmma
// tiles do not divide): pink_pass1 / pink_pass2, wmma m16n16k16 from
// padded, single-buffered shared tiles, the spectrum shaped on load, one
// partial sum per tile, and pink_pass3, which adds them in a fixed order
// and subtracts the mean from the frames in a pass of its own.
#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int NT = 256;   // 8 warps
constexpr int BK = 32;    // depth of one shared-memory tile
constexpr int PAD = 8;    // bf16 elements (16 bytes) against bank conflicts
constexpr int S1_BM = 128;  // pass 1 tile: k2 rows
constexpr int S1_BN = 64;   //              m1 columns
constexpr int S2_BM = 64;   // pass 2 tile: m2 rows
constexpr int S2_BN = 128;  //              m1 columns

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// eight bf16 products, each rounded to bf16 (the bf16 multiply of the
// reference: exact in f32, then round to nearest even)
__device__ __forceinline__ uint4 shape8(uint4 w, uint4 a)
{
    const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&w);
    const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
    uint4 r;
    __nv_bfloat162* rp = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 wf = __bfloat1622float2(wp[i]);
        const float2 af = __bfloat1622float2(ap[i]);
        rp[i] = __floats2bfloat162_rn(__fmul_rn(wf.x, af.x), __fmul_rn(wf.y, af.y));
    }
    return r;
}

// Pass 1.  white (ntr, 2 n1, n2) bf16: rows 0..n1-1 Re, n1..2n1-1 Im.
// amp (n1, n2) bf16.  b1r, b1i (2 n1, n1) bf16.  wc, ws (n2, n1) f32.
// scratch (ntr, 2 n2, n1) bf16: rows 0..n2-1 Re b, n2..2n2-1 Im b.
__global__ void __launch_bounds__(NT)
pink_pass1(const bf16* __restrict__ white, const bf16* __restrict__ amp,
           const bf16* __restrict__ b1r, const bf16* __restrict__ b1i,
           const float* __restrict__ wc, const float* __restrict__ ws,
           bf16* __restrict__ scratch, int n1, int n2)
{
    // A = spectrum^T: element (k2, kk) at a_s[kk][k2], i.e. column-major
    __shared__ __align__(32) bf16 a_s[BK][S1_BM + PAD];
    __shared__ __align__(32) bf16 br_s[BK][S1_BN + PAD];
    __shared__ __align__(32) bf16 bi_s[BK][S1_BN + PAD];
    __shared__ __align__(32) float stage[NT / 32][16 * 16];

    const int tr = blockIdx.z;
    const int k2_0 = blockIdx.y * S1_BM;
    const int m1_0 = blockIdx.x * S1_BN;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int wm = warp >> 1;  // 0..3: 32 rows (k2) each
    const int wn = warp & 1;   // 0..1: 32 columns (m1) each
    const int K = 2 * n1;
    const bf16* w = white + (size_t)tr * K * n2;

    AccFrag ar[2][2], ai[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::fill_fragment(ar[i][j], 0.f);
            wmma::fill_fragment(ai[i][j], 0.f);
        }

    for (int kk0 = 0; kk0 < K; kk0 += BK) {
        for (int c = tid; c < BK * (S1_BM / 8); c += NT) {
            const int row = c / (S1_BM / 8);
            const int col = (c % (S1_BM / 8)) * 8;
            const int kk = kk0 + row;
            const uint4 wv = *reinterpret_cast<const uint4*>(
                w + (size_t)kk * n2 + k2_0 + col);
            const uint4 av = *reinterpret_cast<const uint4*>(
                amp + (size_t)(kk & (n1 - 1)) * n2 + k2_0 + col);
            *reinterpret_cast<uint4*>(&a_s[row][col]) = shape8(wv, av);
        }
        for (int c = tid; c < BK * (S1_BN / 8); c += NT) {
            const int row = c / (S1_BN / 8);
            const int col = (c % (S1_BN / 8)) * 8;
            const size_t off = (size_t)(kk0 + row) * n1 + m1_0 + col;
            *reinterpret_cast<uint4*>(&br_s[row][col]) =
                *reinterpret_cast<const uint4*>(b1r + off);
            *reinterpret_cast<uint4*>(&bi_s[row][col]) =
                *reinterpret_cast<const uint4*>(b1i + off);
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < BK; ks += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fr[2], fi[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(af[i], &a_s[ks][wm * 32 + i * 16], S1_BM + PAD);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::load_matrix_sync(fr[j], &br_s[ks][wn * 32 + j * 16], S1_BN + PAD);
                wmma::load_matrix_sync(fi[j], &bi_s[ks][wn * 32 + j * 16], S1_BN + PAD);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    wmma::mma_sync(ar[i][j], af[i], fr[j], ar[i][j]);
                    wmma::mma_sync(ai[i][j], af[i], fi[j], ai[i][j]);
                }
        }
        __syncthreads();
    }

    // twiddle on the accumulators (wc, ws load with the accumulators'
    // own layout), then to bf16 through a per-warp staging tile
    bf16* sr = scratch + (size_t)tr * 2 * n2 * n1;
    bf16* si = sr + (size_t)n2 * n1;
    float* st = stage[warp];
    const int srow = lane >> 1;
    const int scol = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int row0 = k2_0 + wm * 32 + i * 16;
            const int col0 = m1_0 + wn * 32 + j * 16;
            const size_t off0 = (size_t)row0 * n1 + col0;
            AccFrag c, s, br, bi;
            wmma::load_matrix_sync(c, wc + off0, n1, wmma::mem_row_major);
            wmma::load_matrix_sync(s, ws + off0, n1, wmma::mem_row_major);
#pragma unroll
            for (int e = 0; e < c.num_elements; ++e) {
                const float a_r = ar[i][j].x[e];
                const float a_i = ai[i][j].x[e];
                br.x[e] = __fadd_rn(__fmul_rn(a_r, c.x[e]), __fmul_rn(a_i, s.x[e]));
                bi.x[e] = __fsub_rn(__fmul_rn(a_i, c.x[e]), __fmul_rn(a_r, s.x[e]));
            }
#pragma unroll
            for (int part = 0; part < 2; ++part) {
                wmma::store_matrix_sync(st, part == 0 ? br : bi, 16, wmma::mem_row_major);
                __syncwarp();
                uint4 v;
                __nv_bfloat162* vp = reinterpret_cast<__nv_bfloat162*>(&v);
                const float* p = st + srow * 16 + scol;
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    vp[q] = __floats2bfloat162_rn(p[2 * q], p[2 * q + 1]);
                bf16* dst = (part == 0 ? sr : si) + off0 + (size_t)srow * n1 + scol;
                *reinterpret_cast<uint4*>(dst) = v;
                __syncwarp();
            }
        }
}

// Pass 2.  a2r, a2i (m2, 2 n2) bf16, m2 = n2 / 2.  scratch as pass 1
// wrote it.  out (2, ntr, m2, n1) f32: Re frames, then Im frames.
// partial (2 ntr, ntiles) f32, ntiles = gridDim.x * gridDim.y.
__global__ void __launch_bounds__(NT)
pink_pass2(const bf16* __restrict__ a2r, const bf16* __restrict__ a2i,
           const bf16* __restrict__ scratch, float* __restrict__ out,
           float* __restrict__ partial, int ntr, int n1, int n2)
{
    __shared__ __align__(32) bf16 ar_s[S2_BM][BK + PAD];
    __shared__ __align__(32) bf16 ai_s[S2_BM][BK + PAD];
    __shared__ __align__(32) bf16 b_s[BK][S2_BN + PAD];
    __shared__ float red[NT / 32][2];

    const int tr = blockIdx.z;
    const int m2_0 = blockIdx.y * S2_BM;
    const int m1_0 = blockIdx.x * S2_BN;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int wm = warp >> 2;  // 0..1: 32 rows (m2) each
    const int wn = warp & 3;   // 0..3: 32 columns (m1) each
    const int m2 = n2 / 2;
    const int K = 2 * n2;
    const bf16* b = scratch + (size_t)tr * K * n1;

    AccFrag xr[2][2], xi[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::fill_fragment(xr[i][j], 0.f);
            wmma::fill_fragment(xi[i][j], 0.f);
        }

    for (int kk0 = 0; kk0 < K; kk0 += BK) {
        {
            const int row = tid / (BK / 8);
            const int col = (tid % (BK / 8)) * 8;
            const size_t off = (size_t)(m2_0 + row) * K + kk0 + col;
            *reinterpret_cast<uint4*>(&ar_s[row][col]) =
                *reinterpret_cast<const uint4*>(a2r + off);
            *reinterpret_cast<uint4*>(&ai_s[row][col]) =
                *reinterpret_cast<const uint4*>(a2i + off);
        }
        for (int c = tid; c < BK * (S2_BN / 8); c += NT) {
            const int row = c / (S2_BN / 8);
            const int col = (c % (S2_BN / 8)) * 8;
            *reinterpret_cast<uint4*>(&b_s[row][col]) =
                *reinterpret_cast<const uint4*>(
                    b + (size_t)(kk0 + row) * n1 + m1_0 + col);
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < BK; ks += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fr[2], fi[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                wmma::load_matrix_sync(fr[i], &ar_s[wm * 32 + i * 16][ks], BK + PAD);
                wmma::load_matrix_sync(fi[i], &ai_s[wm * 32 + i * 16][ks], BK + PAD);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], &b_s[ks][wn * 32 + j * 16], S2_BN + PAD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    wmma::mma_sync(xr[i][j], fr[i], fb[j], xr[i][j]);
                    wmma::mma_sync(xi[i][j], fi[i], fb[j], xi[i][j]);
                }
        }
        __syncthreads();
    }

    const size_t frame = (size_t)m2 * n1;
    float* out_r = out + (size_t)tr * frame;
    float* out_i = out + ((size_t)ntr + tr) * frame;
    float sum_r = 0.f, sum_i = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const size_t off = (size_t)(m2_0 + wm * 32 + i * 16) * n1
                               + m1_0 + wn * 32 + j * 16;
            wmma::store_matrix_sync(out_r + off, xr[i][j], n1, wmma::mem_row_major);
            wmma::store_matrix_sync(out_i + off, xi[i][j], n1, wmma::mem_row_major);
#pragma unroll
            for (int e = 0; e < xr[i][j].num_elements; ++e) {
                sum_r += xr[i][j].x[e];
                sum_i += xi[i][j].x[e];
            }
        }
    // the tile's two sums, reduced in a fixed tree
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        sum_r += __shfl_down_sync(0xffffffffu, sum_r, d);
        sum_i += __shfl_down_sync(0xffffffffu, sum_i, d);
    }
    if (lane == 0) {
        red[warp][0] = sum_r;
        red[warp][1] = sum_i;
    }
    __syncthreads();
    if (tid == 0) {
        float tr_sum = 0.f, ti_sum = 0.f;
        for (int wi = 0; wi < NT / 32; ++wi) {
            tr_sum += red[wi][0];
            ti_sum += red[wi][1];
        }
        const int ntiles = gridDim.x * gridDim.y;
        const int tile = blockIdx.y * gridDim.x + blockIdx.x;
        partial[(size_t)tr * ntiles + tile] = tr_sum;
        partial[((size_t)ntr + tr) * ntiles + tile] = ti_sum;
    }
}

// Pass 3.  Frame f = blockIdx.y: subtract the mean of its frame_len
// values, the partial sums added in tile order.
__global__ void __launch_bounds__(NT)
pink_pass3(float* __restrict__ out, const float* __restrict__ partial,
           int ntiles, long long frame_len)
{
    __shared__ float mean_s;
    const int f = blockIdx.y;
    if (threadIdx.x == 0) {
        float s = 0.f;
        for (int t = 0; t < ntiles; ++t) s += partial[(size_t)f * ntiles + t];
        mean_s = s / (float)frame_len;
    }
    __syncthreads();
    const float mean = mean_s;
    float4* o = reinterpret_cast<float4*>(out + (size_t)f * frame_len);
    const long long n4 = frame_len / 4;
    for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n4;
         i += (long long)gridDim.x * NT) {
        float4 v = o[i];
        v.x = __fsub_rn(v.x, mean);
        v.y = __fsub_rn(v.y, mean);
        v.z = __fsub_rn(v.z, mean);
        v.w = __fsub_rn(v.w, mean);
        o[i] = v;
    }
}

// ------------------------------------------------------------------
// The wgmma path
// ------------------------------------------------------------------

constexpr int GT = 384;            // two consumer warpgroups and the producer's
constexpr int BKW = 64;            // depth of one ring stage (128 bytes of bf16)
constexpr int STAGES = 4;
constexpr int BOX_BYTES = 64 * 64 * 2;          // one 64 x 64 bf16 box: 8 KB
constexpr int A_BYTES = 2 * BOX_BYTES;          // 16 KB
constexpr int B_BYTES = 4 * BOX_BYTES;          // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 48 KB: stage 2
constexpr int AMP_BYTES = BOX_BYTES;            // 32 rows x 128 k2 of the amplitude
constexpr int STAGE1_BYTES = STAGE_BYTES + AMP_BYTES;  // 56 KB: stage 1
// ring + 1 KB to align it (the 128-byte swizzle repeats every 1 KB) +
// barriers and the epilogue's sums
constexpr int TAIL_BYTES = 256;
constexpr int GEMM1_SMEM = STAGES * STAGE1_BYTES + 1024 + TAIL_BYTES;
constexpr int GEMM2_SMEM = STAGES * STAGE_BYTES + 1024 + TAIL_BYTES;
// MN-major operand, 128-byte swizzle: 64 elements of M or N by 8 of K
// make one 1 KB atom; atoms follow each other along K every SBO bytes
// and along M / N every LBO bytes (one 64 x 64 box)
constexpr uint32_t MN_LBO = BOX_BYTES;
constexpr uint32_t MN_SBO = 1024;
// K-major operand, 128-byte swizzle: rows of 64 K-elements (128 bytes),
// groups of 8 rows every SBO bytes; LBO is not used
constexpr uint32_t K_LBO = 16;
constexpr uint32_t K_SBO = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// spins until the barrier's phase differs from `parity`.  A wait that
// outlasts any honest one (seconds) traps: a fault in the ring's
// protocol then fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    uint32_t done, spins = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (!done && ++spins > (1u << 26)) __trap();
    } while (!done);
}

// one box of a 2-D tensor map into shared memory; c0 is the coordinate
// along memory, c1 the row
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];"
        ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo)
{
    return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16)
           | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// D (64 x 128, f32, 64 registers a thread) (+)= A (64 x 16) B (16 x 128),
// both operands bf16 in shared memory behind their descriptors, A with K
// running along memory ("K-major").  TB is 1 for a B whose N index runs
// along memory ("MN-major"), 0 where K does.  scale_d = 0 starts a new
// sum.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D (64 x 256, f32, 128 registers a thread) (+)= A (64 x 16) B (16 x 256)
// with A taken from registers: four 32-bit registers a thread in the mma
// fragment layout (rows lane / 4 and + 8 of the warp's 16, K pairs
// 2 (lane % 4) and + 8), sent once for all 256 columns.  B is bf16 in
// shared memory behind its descriptor, K-major.  The registers must not
// change until the product has completed.  scale_d = 0 starts a new sum.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// four 8 x 8 b16 matrices from shared memory, transposed on the way: lane
// l gives the address of row l & 7 of matrix l >> 3
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// two bf16 products, each rounded once to bf16: the product of two bf16
// values is exact in f32, so the packed bf16 multiply gives the bits of
// bf16(float(w) * float(a))
__device__ __forceinline__ uint32_t shape2(uint32_t w, uint32_t a)
{
    const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                                     *reinterpret_cast<const __nv_bfloat162*>(&a));
    return *reinterpret_cast<const uint32_t*>(&r);
}

// The four lanes of a quad (c = lane & 3) each hold four 32-bit pieces,
// v[i] meant for lane i; afterwards lane c holds the pieces of lanes
// 0..3 meant for it, in lane order.  Two exchange steps, four shuffles.
__device__ __forceinline__ uint4 quad_transpose(uint32_t v0, uint32_t v1,
                                                uint32_t v2, uint32_t v3, int c)
{
    const bool hi = c & 2, lo = c & 1;
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? v0 : v2, 2);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? v1 : v3, 2);
    const uint32_t x0 = hi ? r0 : v0, x1 = hi ? r1 : v1;
    const uint32_t y0 = hi ? v2 : r0, y1 = hi ? v3 : r1;
    const uint32_t rx = __shfl_xor_sync(0xffffffffu, lo ? x0 : x1, 1);
    const uint32_t ry = __shfl_xor_sync(0xffffffffu, lo ? y0 : y1, 1);
    return lo ? make_uint4(rx, x1, ry, y1) : make_uint4(x0, rx, y0, ry);
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v)
{
    return *reinterpret_cast<uint32_t*>(&v);
}

// the ring's barriers and where a CTA stands in it
struct Ring {
    uint32_t base;    // shared address of stage 0 (1 KB aligned)
    uint32_t stride;  // bytes of a stage
    uint32_t full;    // STAGES barriers: a stage is ready for wgmma
    uint32_t empty;   // STAGES barriers: both consumer warpgroups are done with it
    int stage;
    uint32_t phase;

    __device__ __forceinline__ void advance()
    {
        if (++stage == STAGES) { stage = 0; phase ^= 1u; }
    }
};

// Sets up the ring in dynamic shared memory: barriers initialised by
// one thread, visible to all and to the async proxy after the barrier.
__device__ __forceinline__ Ring ring_setup(unsigned char* smem_raw, uint32_t stride,
                                           float** red)
{
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* tail = smem_raw + (base - raw) + STAGES * stride;
    Ring r;
    r.base = base;
    r.stride = stride;
    r.full = smem_u32(tail);
    r.empty = r.full + 8 * STAGES;
    r.stage = 0;
    r.phase = 0;
    *red = reinterpret_cast<float*>(tail + 16 * STAGES);
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(r.full + 8 * s, 1);
            mbar_init(r.empty + 8 * s, 2);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    return r;
}

// Stage 2's main loop for one consumer warpgroup and one output tile:
// `ksteps` ring stages, four k16 steps each, two products per step (c0
// and c1 share A).  A is K-major, B MN-major, both behind descriptors.
// a_off / b_off: byte offsets of this warpgroup's A box and of the two B
// halves inside a stage.  One wgmma group stays in flight: stage s is
// released when the group of stage s + 1 has been committed and the one
// of stage s has completed.
__device__ __forceinline__ void consume_tile_stage2(float (&c0)[64], float (&c1)[64],
                                                    Ring& ring, int ksteps,
                                                    uint32_t a_off, uint32_t b0_off,
                                                    uint32_t b1_off)
{
    constexpr uint32_t A_STEP = 32;        // 16 of K: bytes along a row
    constexpr uint32_t B_STEP = 16 * 128;  // 16 of K: rows of 128 bytes
    const bool elected = (threadIdx.x & 127) == 0;
    int prev = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(ring.full + 8 * ring.stage, ring.phase);
        const uint32_t st = ring.base + ring.stage * ring.stride;
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < BKW / 16; ++q) {
            const uint64_t da = smem_desc(st + a_off + q * A_STEP, K_LBO, K_SBO);
            const uint64_t db0 = smem_desc(st + b0_off + q * B_STEP, MN_LBO, MN_SBO);
            const uint64_t db1 = smem_desc(st + b1_off + q * B_STEP, MN_LBO, MN_SBO);
            const int acc = (ks | q) != 0;
            wgmma_m64n128k16<1>(c0, da, db0, acc);
            wgmma_m64n128k16<1>(c1, da, db1, acc);
        }
        wgmma_commit();
        if (ks > 0) {
            wgmma_wait<1>();
            if (elected) mbar_arrive(ring.empty + 8 * prev);
        }
        prev = ring.stage;
        ring.advance();
    }
    wgmma_wait<0>();
    if (elected) mbar_arrive(ring.empty + 8 * prev);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        asm volatile("" : "+f"(c0[i])::"memory");
        asm volatile("" : "+f"(c1[i])::"memory");
    }
}

// Stage 1's main loop for one consumer warpgroup.  A comes from
// registers: each warp reads its 16 rows (k2) of the stage's 64 K rows
// from the MN-major box with ldmatrix.trans, and the amplitude for the
// same (k1, k2) from its box with the same addresses (K rows 0..31 are
// Re k1, 32..63 the same Im k1; the boxes share their swizzle), and
// shapes in registers: a = bf16(white * amp), the product exact in f32.
// Nothing is written back to shared memory.  B is K-major behind its
// descriptor, 256 rows at b_off: the Re outputs m1, then the Im outputs,
// so one m64n256k16 product a k16 step fills c (columns 0..127 Re,
// 128..255 Im).  The fragments of a stage must outlive its products, so
// two stages alternate between two register sets (ksteps is even).
struct Stage1Frag { uint32_t a[4][4]; };

__device__ __forceinline__ void stage1_step(float (&c)[128], Stage1Frag& f,
                                            Ring& ring, bool first,
                                            uint32_t a_off, uint32_t amp_off,
                                            uint32_t b_off, int& prev,
                                            bool release_prev)
{
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    const uint32_t st = ring.base + ring.stage * ring.stride;
    // lane l: matrix l >> 3 = (M block, K block) = (bit 0, bit 1), row l & 7
    const uint32_t krow = ((lane >> 4) << 3) + (lane & 7);
    const uint32_t chunk = (uint32_t)(warp * 2 + ((lane >> 3) & 1));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint32_t kr = q * 16 + krow;
        const uint32_t sw = ((chunk ^ (kr & 7u)) << 4);
        uint32_t w[4], m[4];
        ldmatrix_x4_trans(w, st + a_off + kr * 128 + sw);
        ldmatrix_x4_trans(m, st + amp_off + (kr & 31u) * 128 + sw);
#pragma unroll
        for (int i = 0; i < 4; ++i) f.a[q][i] = shape2(w[i], m[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint64_t db = smem_desc(st + b_off + q * 32, K_LBO, K_SBO);
        wgmma_m64n256k16_rs(c, f.a[q], db, !(first && q == 0));
    }
    wgmma_commit();
    if (release_prev) {
        wgmma_wait<1>();
        if ((threadIdx.x & 127) == 0) mbar_arrive(ring.empty + 8 * prev);
    }
    prev = ring.stage;
    ring.advance();
}

__device__ __forceinline__ void consume_tile_stage1(float (&c)[128], Ring& ring,
                                                    int ksteps, uint32_t a_off,
                                                    uint32_t amp_off, uint32_t b_off)
{
    Stage1Frag f0, f1;
    int prev = 0;
    for (int ks = 0; ks < ksteps; ks += 2) {
        stage1_step(c, f0, ring, ks == 0, a_off, amp_off, b_off, prev, ks > 0);
        stage1_step(c, f1, ring, false, a_off, amp_off, b_off, prev, true);
    }
    wgmma_wait<0>();
    if ((threadIdx.x & 127) == 0) mbar_arrive(ring.empty + 8 * prev);
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(c[i])::"memory");
}

// Stage 1.  Tile: 128 k2 x 128 m1, Re and Im; depth 2 n1, taken 64 at a
// time as 32 Re rows k1 and the same 32 Im rows, so that one 32-row box
// of the amplitude serves both.
//   map_w:   the white spectrum as (ntr * 2 n1 rows, n2) bf16, boxes of
//            32 rows (K) x 64 k2: A, MN-major.
//   map_amp: the amplitude (n1 rows, n2) bf16, boxes of 32 rows x 64 k2.
//   map_b:   b1t (2 n1 rows [Re m1; Im m1], 2 n1 K in the same blocked
//            order) bf16, boxes of 128 rows x 64 K: B, K-major.
// Consumer warpgroup w owns rows 64 w .. 64 w + 63 of the tile and both
// sums for them.  It takes its half of A through registers, shaping it
// there (consume_tile_stage1), applies the twiddle to its accumulator
// registers (wc, ws read by each thread for its own elements) and stores
// b as bf16.
// It also writes its share of the two frames' sums: the sum of a frame
// over (m2, m1) is sum_k2 C[k2] sum_m1 Re b + S[k2] sum_m1 Im b (Re
// frame; C sum_m1 Im b - S sum_m1 Re b for the Im frame) with C, S =
// msum, the stage-2 matrices summed over m2.  mpart (2, ntr, np), np =
// 2 tiles per transform: one slot per tile and warpgroup, no atomics.
__global__ void __launch_bounds__(GT, 1)
pink_stage1(const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_amp,
            const __grid_constant__ CUtensorMap map_b,
            const float* __restrict__ wc, const float* __restrict__ ws,
            const float* __restrict__ msum, bf16* __restrict__ scratch,
            float* __restrict__ mpart, int ntr, int n1, int n2)
{
    extern __shared__ unsigned char smem_raw[];
    float* red;
    Ring ring = ring_setup(smem_raw, STAGE1_BYTES, &red);
    const int wg = threadIdx.x >> 7;
    const int tn = n1 / 128, tm = n2 / 128;
    const int ntiles = ntr * tm * tn;
    const int ksteps = 2 * n1 / BKW;

    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (threadIdx.x == 256) {
            ring.phase = 1;  // the ring starts empty
            for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
                const int m1_0 = (t % tn) * 128;
                const int k2_0 = (t / tn % tm) * 128;
                const int tr = t / (tn * tm);
                for (int ks = 0; ks < ksteps; ++ks) {
                    mbar_wait(ring.empty + 8 * ring.stage, ring.phase);
                    const uint32_t st = ring.base + ring.stage * STAGE1_BYTES;
                    const uint32_t bar = ring.full + 8 * ring.stage;
                    mbar_expect_tx(bar, STAGE1_BYTES);
                    const int k1_0 = ks * 32;
                    const int row_re = tr * 2 * n1 + k1_0;
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const uint32_t a = st + half * BOX_BYTES;
                        tma_load_2d(a, &map_w, bar, k2_0 + 64 * half, row_re);
                        tma_load_2d(a + BOX_BYTES / 2, &map_w, bar,
                                    k2_0 + 64 * half, row_re + n1);
                        tma_load_2d(st + STAGE_BYTES + half * (AMP_BYTES / 2),
                                    &map_amp, bar, k2_0 + 64 * half, k1_0);
                    }
                    tma_load_2d(st + A_BYTES, &map_b, bar, ks * BKW, m1_0);
                    tma_load_2d(st + A_BYTES + 2 * BOX_BYTES, &map_b, bar,
                                ks * BKW, n1 + m1_0);
                    ring.advance();
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
        float acc[128];  // columns 0..127: Re a, 128..255: Im a
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
        const int lane = threadIdx.x & 31;
        const int warp = (threadIdx.x >> 5) & 3;
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
            const int m1_0 = (t % tn) * 128;
            const int k2_0 = (t / tn % tm) * 128;
            const int tr = t / (tn * tm);
            const int row0 = k2_0 + wg * 64 + warp * 16 + (lane >> 2);
            const int col0 = m1_0 + (lane & 3) * 2;
            consume_tile_stage1(acc, ring, ksteps, wg * BOX_BYTES,
                                STAGE_BYTES + wg * (AMP_BYTES / 2), A_BYTES);
            bf16* sr = scratch + (size_t)tr * 2 * n2 * n1;
            bf16* si = sr + (size_t)n2 * n1;
            float t_re = 0.f, t_im = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = row0 + 8 * h;
                float sum_r = 0.f, sum_i = 0.f;  // of the rounded b, this row
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    uint32_t pr[4], pi[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int j = 4 * q + i;
                        const size_t off = (size_t)row * n1 + col0 + 8 * j;
                        const float2 c = *reinterpret_cast<const float2*>(wc + off);
                        const float2 s = *reinterpret_cast<const float2*>(ws + off);
                        const float r0 = acc[4 * j + 2 * h], r1 = acc[4 * j + 2 * h + 1];
                        const float i0 = acc[64 + 4 * j + 2 * h], i1 = acc[64 + 4 * j + 2 * h + 1];
                        const __nv_bfloat162 br = __floats2bfloat162_rn(
                            __fadd_rn(__fmul_rn(r0, c.x), __fmul_rn(i0, s.x)),
                            __fadd_rn(__fmul_rn(r1, c.y), __fmul_rn(i1, s.y)));
                        const __nv_bfloat162 bi = __floats2bfloat162_rn(
                            __fsub_rn(__fmul_rn(i0, c.x), __fmul_rn(r0, s.x)),
                            __fsub_rn(__fmul_rn(i1, c.y), __fmul_rn(r1, s.y)));
                        pr[i] = bf162_bits(br);
                        pi[i] = bf162_bits(bi);
                        const float2 fr = __bfloat1622float2(br);
                        const float2 fi = __bfloat1622float2(bi);
                        sum_r += fr.x + fr.y;
                        sum_i += fi.x + fi.y;
                    }
                    // a thread holds 2 of the 8 columns of four 8-column
                    // groups; after the exchange it holds one whole group
                    // and stores 16 bytes (whole 32-byte sectors per row)
                    const int qc = lane & 3;
                    const size_t dst = (size_t)row * n1 + m1_0 + 8 * (4 * q + qc);
                    *reinterpret_cast<uint4*>(sr + dst) =
                        quad_transpose(pr[0], pr[1], pr[2], pr[3], qc);
                    *reinterpret_cast<uint4*>(si + dst) =
                        quad_transpose(pi[0], pi[1], pi[2], pi[3], qc);
                }
                // the four lanes of a quad hold one row of the tile
                sum_r += __shfl_xor_sync(0xffffffffu, sum_r, 1);
                sum_i += __shfl_xor_sync(0xffffffffu, sum_i, 1);
                sum_r += __shfl_xor_sync(0xffffffffu, sum_r, 2);
                sum_i += __shfl_xor_sync(0xffffffffu, sum_i, 2);
                if ((lane & 3) == 0) {
                    const float C = msum[row], S = msum[n2 + row];
                    t_re += C * sum_r + S * sum_i;
                    t_im += C * sum_i - S * sum_r;
                }
            }
            // this warpgroup's share of the two frame sums, in a fixed tree
#pragma unroll
            for (int d = 16; d > 0; d >>= 1) {
                t_re += __shfl_down_sync(0xffffffffu, t_re, d);
                t_im += __shfl_down_sync(0xffffffffu, t_im, d);
            }
            if (lane == 0) {
                red[wg * 8 + warp * 2] = t_re;
                red[wg * 8 + warp * 2 + 1] = t_im;
            }
            asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
            if ((threadIdx.x & 127) == 0) {
                const int np = 2 * tn * tm;
                const int slot = 2 * (t % (tn * tm)) + wg;
                const float* q = red + wg * 8;
                mpart[(size_t)tr * np + slot] = (q[0] + q[2]) + (q[4] + q[6]);
                mpart[((size_t)ntr + tr) * np + slot] = (q[1] + q[3]) + (q[5] + q[7]);
            }
            asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
        }
    }
}

// Stage 2.  Tile: 64 m2 x 256 m1, Re and Im; depth 2 n2.
//   map_a: a2 (2 m2 rows [Re; Im], 2 n2 K) bf16, boxes of 64 rows x 64
//          K: A, K-major.
//   map_s: the scratch b as (ntr * 2 n2 rows, n1) bf16, boxes of 64 rows
//          (K) x 64 m1: B, MN-major.
// Consumer warpgroup 0 computes the Re frame's tile, warpgroup 1 the Im
// frame's.  Each adds stage 1's partial sums of its frame in a fixed
// order (before the main loop, so the loads cost nothing), subtracts the
// mean from its accumulators and stores the f32 tile in time order.
__global__ void __launch_bounds__(GT, 1)
pink_stage2(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_s,
            float* __restrict__ out, const float* __restrict__ mpart,
            int ntr, int n1, int n2)
{
    extern __shared__ unsigned char smem_raw[];
    float* red;
    Ring ring = ring_setup(smem_raw, STAGE_BYTES, &red);
    const int wg = threadIdx.x >> 7;
    const int m2 = n2 / 2;
    const int tn = n1 / 256, tm = m2 / 64;
    const int ntiles = ntr * tm * tn;
    const int ksteps = 2 * n2 / BKW;

    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (threadIdx.x == 256) {
            ring.phase = 1;
            for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
                const int m1_0 = (t % tn) * 256;
                const int m2_0 = (t / tn % tm) * 64;
                const int tr = t / (tn * tm);
                for (int ks = 0; ks < ksteps; ++ks) {
                    mbar_wait(ring.empty + 8 * ring.stage, ring.phase);
                    const uint32_t st = ring.base + ring.stage * STAGE_BYTES;
                    const uint32_t bar = ring.full + 8 * ring.stage;
                    mbar_expect_tx(bar, STAGE_BYTES);
                    const int kk0 = ks * BKW;
                    tma_load_2d(st, &map_a, bar, kk0, m2_0);
                    tma_load_2d(st + BOX_BYTES, &map_a, bar, kk0, m2 + m2_0);
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        tma_load_2d(st + A_BYTES + j * BOX_BYTES, &map_s, bar,
                                    m1_0 + 64 * j, tr * 2 * n2 + kk0);
                    ring.advance();
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
        float x0[64], x1[64];  // columns 0..127 and 128..255 of the tile
#pragma unroll
        for (int i = 0; i < 64; ++i) x0[i] = x1[i] = 0.f;
        const int lane = threadIdx.x & 31;
        const int warp = (threadIdx.x >> 5) & 3;
        const size_t frame = (size_t)m2 * n1;
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
            const int m1_0 = (t % tn) * 256;
            const int m2_0 = (t / tn % tm) * 64;
            const int tr = t / (tn * tm);
            // this frame's mean from stage 1's partial sums, in a fixed order
            const int np = 2 * (n1 / 128) * (n2 / 128);
            const float* mp = mpart + ((size_t)wg * ntr + tr) * np;
            float mean = 0.f;
            for (int i = threadIdx.x & 127; i < np; i += 128) mean += mp[i];
#pragma unroll
            for (int d = 16; d > 0; d >>= 1)
                mean += __shfl_down_sync(0xffffffffu, mean, d);
            if (lane == 0) red[wg * 4 + warp] = mean;
            asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
            mean = ((red[wg * 4] + red[wg * 4 + 1]) + (red[wg * 4 + 2] + red[wg * 4 + 3]))
                   / (float)frame;
            asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");

            consume_tile_stage2(x0, x1, ring, ksteps, wg * BOX_BYTES, A_BYTES,
                                A_BYTES + 2 * BOX_BYTES);
            float* o = out + ((size_t)wg * ntr + tr) * frame;
            const int row0 = m2_0 + warp * 16 + (lane >> 2);
            const int col0 = m1_0 + (lane & 3) * 2;
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const size_t off = (size_t)(row0 + 8 * h) * n1 + col0 + 8 * j;
                    *reinterpret_cast<float2*>(o + off) = make_float2(
                        __fsub_rn(x0[4 * j + 2 * h], mean),
                        __fsub_rn(x0[4 * j + 2 * h + 1], mean));
                    *reinterpret_cast<float2*>(o + off + 128) = make_float2(
                        __fsub_rn(x1[4 * j + 2 * h], mean),
                        __fsub_rn(x1[4 * j + 2 * h + 1], mean));
                }
        }
    }
}

// cuTensorMapEncodeTiled, resolved at run time through the CUDA runtime
// (the library links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled()
{
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                    &q) != cudaSuccess
            || q != cudaDriverEntryPointSuccess)
            return nullptr;
        fn = (EncodeTiled)p;
    }
    return fn;
}

// a (rows, cols) bf16 matrix, cols along memory, cut into boxes of
// box_rows x 64 columns with the 128-byte swizzle
bool bf16_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
              uint32_t box_rows)
{
    EncodeTiled enc = encode_tiled();
    if (!enc) return false;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * sizeof(bf16)};
    const cuuint32_t box[2] = {64, box_rows};
    const cuuint32_t estr[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
               dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_pass3(float* out, const float* partial, int ntr, int ntiles,
                 long long frame_len, cudaStream_t s)
{
    const int chunks = (int)((frame_len / 4 + 4 * NT - 1) / (4 * NT));
    dim3 g3(chunks > 0 ? chunks : 1, 2 * ntr);
    pink_pass3<<<g3, NT, 0, s>>>(out, partial, ntiles, frame_len);
    return (int)cudaGetLastError();
}

}  // namespace

// The mma.sync path.  white (ntr, 2 n1, n2), amp (n1, n2), b1r / b1i
// (2 n1, n1), a2r / a2i (n2 / 2, 2 n2) bf16; wc, ws (n2, n1) f32; scratch
// (ntr, 2 n2, n1) bf16; partial (2 ntr, (n1 / 128) (n2 / 128)) f32; out
// (2, ntr, n2 / 2, n1) f32.  n1 and n2 are powers of two and multiples
// of 128.  The passes are queued on the stream; the first failing
// launch's error is returned.
extern "C" int pink_frames_launch(const void* white, const void* amp,
                                  const void* b1r, const void* b1i,
                                  const float* wc, const float* ws,
                                  const void* a2r, const void* a2i,
                                  void* scratch, float* partial, float* out,
                                  int ntr, int n1, int n2, void* stream)
{
    if (ntr < 1 || n1 < S2_BN || n2 < S1_BM || (n1 & (n1 - 1)) || (n2 & (n2 - 1)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int m2 = n2 / 2;
    dim3 g1(n1 / S1_BN, n2 / S1_BM, ntr);
    pink_pass1<<<g1, NT, 0, s>>>((const bf16*)white, (const bf16*)amp,
                                 (const bf16*)b1r, (const bf16*)b1i, wc, ws,
                                 (bf16*)scratch, n1, n2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 g2(n1 / S2_BN, m2 / S2_BM, ntr);
    pink_pass2<<<g2, NT, 0, s>>>((const bf16*)a2r, (const bf16*)a2i,
                                 (const bf16*)scratch, out, partial, ntr, n1, n2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_pass3(out, partial, ntr, (int)(g2.x * g2.y), (long long)m2 * n1, s);
}

// The wgmma path.  white, amp, wc, ws, scratch, out as above; b1t
// (2 n1 [Re m1; Im m1], 2 n1) and a2 (n2 [Re m2; Im m2], 2 n2) bf16, the
// constants K-major, b1t's K in blocks of 32 Re then 32 Im rows k1; msum
// (2, n2) f32, the cos and sin matrices of stage 2 summed over m2; mpart
// (2 ntr, 2 (n1 / 128) (n2 / 128)) f32.  n1 a multiple of 256, n2 of 128.
extern "C" int pink_frames_wgmma_launch(const void* white, const void* amp,
                                        const void* b1t, const float* wc,
                                        const float* ws, const float* msum,
                                        const void* a2, void* scratch,
                                        float* mpart, float* out, int ntr,
                                        int n1, int n2, void* stream)
{
    if (ntr < 1 || n1 % 256 || n2 % 128 || (n1 & (n1 - 1)) || (n2 & (n2 - 1)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int m2 = n2 / 2;
    CUtensorMap map_w, map_amp, map_b, map_a, map_s;
    if (!bf16_map(&map_w, white, (uint64_t)ntr * 2 * n1, n2, 32)
        || !bf16_map(&map_amp, amp, n1, n2, 32)
        || !bf16_map(&map_b, b1t, 2 * (uint64_t)n1, 2 * (uint64_t)n1, 128)
        || !bf16_map(&map_a, a2, n2, 2 * (uint64_t)n2, 64)
        || !bf16_map(&map_s, scratch, (uint64_t)ntr * 2 * n2, n1, 64))
        return (int)cudaErrorInvalidValue;
    // per device, once: the SM count and the kernels' shared-memory opt-in
    static int sms_of[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (sms_of[dev] == 0) {
        int n = 0;
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(pink_stage1,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM1_SMEM);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(pink_stage2,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM2_SMEM);
        if (err != cudaSuccess) return (int)err;
        sms_of[dev] = n;
    }
    const int sms = sms_of[dev];

    const int t1 = ntr * (n2 / 128) * (n1 / 128);
    pink_stage1<<<t1 < sms ? t1 : sms, GT, GEMM1_SMEM, s>>>(
        map_w, map_amp, map_b, wc, ws, msum, (bf16*)scratch, mpart, ntr, n1, n2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int t2 = ntr * (m2 / 64) * (n1 / 256);
    pink_stage2<<<t2 < sms ? t2 : sms, GT, GEMM2_SMEM, s>>>(
        map_a, map_s, out, mpart, ntr, n1, n2);
    return (int)cudaGetLastError();
}
