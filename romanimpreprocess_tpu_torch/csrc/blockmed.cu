// Exact nanmedian of each of the N x N blocks of a frame.
//
// Replaces the TPU kernel romanimpreprocess_tpu/ops/median_pallas.py
// block_nanmedian_fused (_blockmed_kernel).  Block (by, bx) covers rows
// py + by*ky .. +ky and columns px + bx*kx .. +kx, with ky = ny / N,
// kx = nx / N and the remainder split as py = (ny % N) / 2,
// px = (nx % N) / 2.  Each float maps to a uint32 key that preserves the
// IEEE total order (NaN -> 0xFFFFFFFF, never counted).  The two middle
// order statistics k_lo = max((cnt-1)/2, 0) and k_hi = cnt/2 are found
// by 32 rounds of bit bisection (largest m with #(key < m) <= k), and
// the median is 0.5 * (lo + hi); a block with no valid value gives NaN.
// The result equals np.nanmedian bit for bit.
//
// What bounds it: bytes, once: the frame is read once (66.8 MB at
// 4088^2).  This first version reads the block again in each of the
// 33 passes (one count of valid values, 32 bisection rounds that count
// both targets together), so it moves 33x the bound, mostly from L2.
// Design: one CTA of 1024 threads per block; warps walk rows, lanes
// walk columns (coalesced), each lane loading U values before it counts
// them so that U loads are in flight (the passes are latency-bound,
// not bandwidth-bound); counts reduce by warp shuffles and shared
// memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 1024;
constexpr int NWARPS = NTHREADS / 32;
constexpr int U = 8;  // loads in flight per lane

__device__ __forceinline__ unsigned order_key(float x)
{
    const unsigned b = __float_as_uint(x);
    if (isnan(x)) return 0xFFFFFFFFu;
    return (b & 0x80000000u) ? ~b : b + 0x80000000u;
}

__device__ __forceinline__ float key_value(unsigned k)
{
    return __uint_as_float(k >= 0x80000000u ? k - 0x80000000u : ~k);
}

// sums two counters over the CTA; every thread gets the totals
__device__ __forceinline__ void block_sum2(unsigned& a, unsigned& b,
                                           unsigned (*red)[NWARPS])
{
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_down_sync(0xFFFFFFFFu, a, o);
        b += __shfl_down_sync(0xFFFFFFFFu, b, o);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) { red[0][warp] = a; red[1][warp] = b; }
    __syncthreads();
    a = lane < NWARPS ? red[0][lane] : 0u;
    b = lane < NWARPS ? red[1][lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xFFFFFFFFu, a, o);
        b += __shfl_xor_sync(0xFFFFFFFFu, b, o);
    }
    __syncthreads();  // red is reused by the next call
}

// calls f(x) for every value of the ky x kx block at base (row stride
// ld) that this thread owns; U loads are issued before any is used
template <class F>
__device__ __forceinline__ void for_each_value(const float* __restrict__ base,
                                               long long ld, int ky, int kx,
                                               F f)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int r = warp; r < ky; r += NWARPS) {
        const float* row = base + r * ld;
        for (int c0 = lane; c0 < kx; c0 += 32 * U) {
            float v[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int c = c0 + 32 * u;
                v[u] = c < kx ? row[c] : __int_as_float(0x7FC00000);  // NaN: skipped
            }
#pragma unroll
            for (int u = 0; u < U; ++u) f(v[u]);
        }
    }
}

__global__ void __launch_bounds__(NTHREADS)
block_nanmedian_kernel(const float* __restrict__ arr, float* __restrict__ out,
                       long long ld, int N, int ky, int kx, int py, int px)
{
    __shared__ unsigned red[2][NWARPS];
    const int by = blockIdx.x / N;
    const int bx = blockIdx.x % N;
    const float* base = arr + (py + by * ky) * ld + (px + bx * kx);

    unsigned valid = 0, unused = 0;
    for_each_value(base, ld, ky, kx,
                   [&](float x) { valid += isnan(x) ? 0u : 1u; });
    block_sum2(valid, unused, red);
    const unsigned cnt = valid;
    const unsigned k_lo = cnt > 0 ? (cnt - 1) / 2 : 0;
    const unsigned k_hi = cnt / 2;

    unsigned m_lo = 0, m_hi = 0;
    for (int bit = 31; bit >= 0; --bit) {
        const unsigned c_lo = m_lo | (1u << bit);
        const unsigned c_hi = m_hi | (1u << bit);
        unsigned n_lo = 0, n_hi = 0;
        for_each_value(base, ld, ky, kx, [&](float x) {
            const unsigned k = order_key(x);
            n_lo += k < c_lo ? 1u : 0u;
            n_hi += k < c_hi ? 1u : 0u;
        });
        block_sum2(n_lo, n_hi, red);
        if (n_lo <= k_lo) m_lo = c_lo;
        if (n_hi <= k_hi) m_hi = c_hi;
    }
    if (threadIdx.x == 0)
        out[blockIdx.x] = cnt > 0
            ? __fmul_rn(0.5f, __fadd_rn(key_value(m_lo), key_value(m_hi)))
            : __int_as_float(0x7FC00000);
}

}  // namespace

// ld: row stride of arr in elements (>= nx; the active region of a
// frame is passed as a view of the frame)
extern "C" int block_nanmedian_launch(const float* arr, float* out, int ny,
                                      int nx, long long ld, int N,
                                      void* stream)
{
    const int ky = ny / N;
    const int kx = nx / N;
    const int py = (ny % N) / 2;
    const int px = (nx % N) / 2;
    block_nanmedian_kernel<<<N * N, NTHREADS, 0, (cudaStream_t)stream>>>(
        arr, out, ld, N, ky, kx, py, px);
    return (int)cudaGetLastError();
}
