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
// memory; an SM has 227 KB, so here the work is cut into three passes:
//
//   1. a tiled product over (k2, m1), K = 2 n1 (Re and Im of the
//      spectrum stacked along K against [cos; sin] and [-sin; cos]):
//      the spectrum is shaped as it is loaded, the twiddle is applied
//      to the accumulators, and b goes out as bf16 to a scratch tensor
//      (4 MB per transform, so a transform's b is still in the 50 MB L2
//      when pass 2 reads it);
//   2. a tiled product over (m2, m1), K = 2 n2 ([cos^T | sin^T] and
//      [-sin^T | cos^T] against the stacked b): the f32 frames go out
//      in time order, with one partial sum per tile and frame;
//   3. a pass that adds each frame's partial sums in a fixed order and
//      subtracts the mean (no float atomics: the same input gives the
//      same bits on every run).
//
// The products are wmma (mma.sync) m16n16k16 on bf16 with f32
// accumulators from padded shared-memory tiles, single-buffered: the
// simple route.  wgmma and TMA are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

}  // namespace

// Shapes as documented at the passes; n1 and n2 are powers of two and
// multiples of 128.  The three passes are queued on the stream; the
// first failing launch's error is returned.
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
    const long long frame_len = (long long)m2 * n1;
    const int chunks = (int)((frame_len / 4 + 4 * NT - 1) / (4 * NT));
    dim3 g3(chunks > 0 ? chunks : 1, 2 * ntr);
    pink_pass3<<<g3, NT, 0, s>>>(out, partial, (int)(g2.x * g2.y), frame_len);
    return (int)cudaGetLastError();
}
