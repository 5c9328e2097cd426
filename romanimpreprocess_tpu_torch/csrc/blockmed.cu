// Exact nanmedian of each of the N x N blocks of a frame.
//
// Replaces the TPU kernel romanimpreprocess_tpu/ops/median_pallas.py
// block_nanmedian_fused (_blockmed_kernel).  Block (by, bx) covers rows
// py + by*ky .. +ky and columns px + bx*kx .. +kx, with ky = ny / N,
// kx = nx / N and the remainder split as py = (ny % N) / 2,
// px = (nx % N) / 2.  Each float maps to a uint32 key that preserves the
// IEEE total order (NaN -> 0xFFFFFFFF, above every value, never
// selected).  The median is 0.5 * (lo + hi) of the two middle order
// statistics k_lo = (cnt-1)/2 and k_hi = cnt/2 of the cnt valid values;
// a block with no valid value gives NaN.  The result equals
// np.nanmedian bit for bit: every count is an integer, so it is also
// the same on every run.
//
// What bounds it: bytes, once: the frame is read once (66.8 MB at
// 4088^2, 0.020 ms).  What the cluster kernel takes its time for is not
// that read but the selection: a block's keys fill the shared memory of
// 8 SMs, so 16 of the 64 blocks are on the card at a time (four waves),
// and in each the scans of the on-chip keys (some 25 instructions per 32
// keys) and the 9 cluster barriers follow one another.
//
// Two kernels, chosen by the block's size (the wrapper decides, see
// ops/median_cuda.py plan()):
//
// 1. block_nanmedian_cluster_kernel: a thread-block cluster of 1, 2, 4
//    or 8 CTAs per block.  Each CTA reads its share of the block's rows
//    from device memory ONCE, converts to keys and keeps them in its
//    shared memory (up to 200 KB: a 511^2 block is 8 x 130.6 KB).  The
//    lower middle value is then selected by digits: eight rounds of four
//    bits, each a scan of the on-chip keys that counts the 16 digit
//    values among the keys matching the prefix found so far.  A thread
//    compacts its own keys as it goes, so a round scans only what the
//    last one left: noise thins out 16-fold a round; a nearly constant
//    sky frame, whose keys share their leading digits, keeps every key
//    for the first rounds and costs about half as much again.  Counting
//    is per thread in two 64-bit words of eight 8-bit fields (no
//    shared-memory atomics, which such a frame would serialise on one
//    bin), summed by warp reductions, then per CTA, then across the
//    cluster through distributed shared memory with one cluster.sync()
//    per round (double-buffered; each CTA pushes its counts to the
//    others, so nothing is read remotely after the barrier).  The first
//    round's digits and the count of valid values are taken while the
//    block is loaded.  The upper middle value needs no second
//    selection: it equals the lower one when another equal key follows
//    it, else it is the next key in order, which the last round's counts
//    and the smallest key dropped above the prefix give.  At N = 8 on
//    4088^2 that is 64 clusters x 8 = 512 CTAs on 132 SMs and 9 barriers
//    a block.
//
// 2. block_nanmedian_stream_kernel: a block too large for a cluster's
//    shared memory (more than 8 x 51,200 values, for example N = 1 on a
//    full frame).  One CTA per block, 32 rounds of bit bisection that
//    read the block again from device memory / L2 in each round.  Slow,
//    and off every main path.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

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

__device__ __forceinline__ float median_of(unsigned cnt, unsigned lo, unsigned hi)
{
    return cnt > 0 ? __fmul_rn(0.5f, __fadd_rn(key_value(lo), key_value(hi)))
                   : __int_as_float(0x7FC00000);
}

// ------------------------------------------------------------------
// 1. the cluster kernel
// ------------------------------------------------------------------

constexpr int CT = 512;          // threads per CTA
constexpr int CW = CT / 32;      // warps per CTA
constexpr int CU = 8;            // loads in flight per thread
constexpr int MAX_CLUSTER = 8;    // the portable maximum
constexpr int MAX_KEYS_BYTES = 200 * 1024;  // a CTA's keys in dynamic shared memory
// what a round exchanges: 16 digit counts, the count of valid values
// (first round), the smallest key dropped above the prefix (last round)
constexpr int NV = 18;
constexpr int V_VALID = 16;
constexpr int V_MIN = 17;

struct ClusterShared {
    unsigned warp_part[CW][NV];
    unsigned inbox[2][MAX_CLUSTER][NV];  // row r is written by rank r of the cluster
    unsigned total[NV];
};

__device__ __forceinline__ unsigned combine(int i, unsigned a, unsigned b)
{
    return i == V_MIN ? min(a, b) : a + b;
}

// Combines per-thread values over all threads of the cluster (sums, and
// a minimum in slot V_MIN); every thread of every CTA gets the results
// in sh.total.  Each CTA pushes its own results into every CTA's inbox
// through distributed shared memory, so that after the one
// cluster.sync() of the call all reads are local.  `round` alternates
// the inbox so that a CTA ahead by one round does not overwrite what a
// slower one still reads.
__device__ __forceinline__ void cluster_combine(unsigned (&c)[NV],
                                                ClusterShared& sh, int round,
                                                cg::cluster_group& cluster)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < NV; ++i)
        c[i] = i == V_MIN ? __reduce_min_sync(0xFFFFFFFFu, c[i])
                          : __reduce_add_sync(0xFFFFFFFFu, c[i]);
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < NV; ++i) sh.warp_part[warp][i] = c[i];
    }
    __syncthreads();
    const int buf = round & 1;
    const int nranks = (int)cluster.num_blocks();
    if (threadIdx.x < NV * nranks) {
        const int i = threadIdx.x % NV;
        const int dst = threadIdx.x / NV;
        unsigned v = sh.warp_part[0][i];
#pragma unroll
        for (int w = 1; w < CW; ++w) v = combine(i, v, sh.warp_part[w][i]);
        *cluster.map_shared_rank(&sh.inbox[buf][cluster.block_rank()][i], dst) = v;
    }
    cluster.sync();
    if (threadIdx.x < NV) {
        unsigned v = sh.inbox[buf][0][threadIdx.x];
        for (int r = 1; r < nranks; ++r)
            v = combine(threadIdx.x, v, sh.inbox[buf][r][threadIdx.x]);
        sh.total[threadIdx.x] = v;
    }
    __syncthreads();
}

// one key into the two words of eight 8-bit digit counts
__device__ __forceinline__ void count_digit(unsigned long long& lo,
                                            unsigned long long& hi, unsigned d,
                                            bool take)
{
    const unsigned long long inc = take ? 1ull << (8 * (d & 7u)) : 0ull;
    if (d & 8u) hi += inc; else lo += inc;
}

__device__ __forceinline__ void unpack(unsigned (&c)[NV], unsigned long long lo,
                                       unsigned long long hi)
{
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c[i] = (unsigned)(lo >> (8 * i)) & 0xFFu;
        c[8 + i] = (unsigned)(hi >> (8 * i)) & 0xFFu;
    }
}

// keys: this CTA's share of the block in dynamic shared memory.  A
// thread counts at most 200 KB / 4 / 512 = 100 keys a round, so no
// 8-bit field overflows.
__global__ void __launch_bounds__(CT)
block_nanmedian_cluster_kernel(const float* __restrict__ arr,
                               float* __restrict__ out, long long ld, int N,
                               int ky, int kx, int py, int px, int rows_per)
{
    extern __shared__ unsigned keys[];
    __shared__ ClusterShared sh;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int blk = blockIdx.x / (int)cluster.num_blocks();
    const int by = blk / N;
    const int bx = blk % N;

    // ---- the one read from device memory: rows r0 .. r1 of the block,
    // ---- as keys into shared memory, the first digit counted on the way
    const int r0 = min(rank * rows_per, ky);
    const int r1 = min(r0 + rows_per, ky);
    const int nkeys = (r1 - r0) * kx;
    const float* base = arr + (py + by * ky + r0) * ld + (px + bx * kx);
    unsigned c[NV];
    unsigned long long acc_lo = 0, acc_hi = 0;
    unsigned nvalid = 0;
    int mine = 0;  // keys of this thread, at keys[threadIdx.x + CT * j]
    {
        // flat index i = row * kx + col, advanced by CT a step
        int row = threadIdx.x / kx, col = threadIdx.x % kx;
        const int drow = CT / kx, dcol = CT % kx;
        for (int i0 = threadIdx.x; i0 < nkeys; i0 += CT * CU) {
            float v[CU];
            int rr = row, cc = col;
#pragma unroll
            for (int u = 0; u < CU; ++u) {
                v[u] = i0 + u * CT < nkeys ? base[rr * ld + cc]
                                           : __int_as_float(0x7FC00000);
                rr += drow; cc += dcol;
                if (cc >= kx) { cc -= kx; ++rr; }
            }
            row = rr; col = cc;
#pragma unroll
            for (int u = 0; u < CU; ++u)
                if (i0 + u * CT < nkeys) {
                    const unsigned key = order_key(v[u]);
                    keys[i0 + u * CT] = key;
                    ++mine;
                    nvalid += key != 0xFFFFFFFFu ? 1u : 0u;
                    count_digit(acc_lo, acc_hi, key >> 28, true);
                }
        }
    }

    // ---- the lower middle value, four bits a round ----
    // Each thread keeps the keys that still match the prefix at the front
    // of its own slots, so a round scans only what the last one left; of
    // the keys it drops, it remembers the smallest one above the prefix.
    unsigned cnt = 0, k = 0, prefix = 0, n_equal = 0, d = 0;
    unsigned above = 0xFFFFFFFFu;
    for (int round = 0; round < 8; ++round) {
        const int shift = 28 - 4 * round;
        if (round > 0) {
            const unsigned mask = 0xFFFFFFFFu << (shift + 4);
            acc_lo = acc_hi = 0;
            int kept = 0;
            for (int j = 0; j < mine; ++j) {
                const unsigned key = keys[threadIdx.x + CT * j];
                if (((key ^ prefix) & mask) == 0) {
                    count_digit(acc_lo, acc_hi, (key >> shift) & 15u, true);
                    keys[threadIdx.x + CT * kept++] = key;
                } else if (key > prefix) {
                    above = min(above, key);
                }
            }
            mine = kept;
        }
        unpack(c, acc_lo, acc_hi);
        c[V_VALID] = round == 0 ? nvalid : 0u;
        c[V_MIN] = above;
        cluster_combine(c, sh, round, cluster);
        if (round == 0) {
            cnt = sh.total[V_VALID];
            if (cnt == 0) break;  // the same in every CTA of the cluster
            k = (cnt - 1) / 2;    // rank still to find among the matching keys
        }
        unsigned below = 0;
        d = 0;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const unsigned n = sh.total[i];
            if (below + n <= k) { below += n; d = i + 1; }
            else break;
        }
        // k < (matching valid keys) <= sum of the counts, so d <= 15
        k -= below;
        n_equal = sh.total[d];
        prefix |= d << shift;
        // (the next round rewrites sh.total only after its own barriers)
    }

    if (rank == 0 && threadIdx.x == 0) {
        // ---- the upper middle value: the same key if another equal one
        // follows, else the next key in order: in the last digit's counts,
        // or the smallest key above them (it exists: k_hi < cnt, and NaN
        // keys lie above every valid key)
        const unsigned v_lo = prefix;
        unsigned v_hi = v_lo;
        if (cnt > 0 && (cnt & 1u) == 0 && k + 1 >= n_equal) {
            v_hi = sh.total[V_MIN];  // dropped in some round, above the prefix
            for (int i = 15; i > (int)d; --i)
                if (sh.total[i] > 0) v_hi = (prefix & ~15u) | (unsigned)i;
        }
        out[blk] = median_of(cnt, v_lo, v_hi);
    }
    cluster.sync();  // no CTA leaves while another may write to its inbox
}

// ------------------------------------------------------------------
// 2. the streaming kernel, for blocks too large for a cluster
// ------------------------------------------------------------------

constexpr int NTHREADS = 1024;
constexpr int NWARPS = NTHREADS / 32;
constexpr int U = 8;  // loads in flight per lane

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
block_nanmedian_stream_kernel(const float* __restrict__ arr,
                              float* __restrict__ out, long long ld, int N,
                              int ky, int kx, int py, int px)
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

    // largest m with #(key < m) <= k, for both targets in one pass
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
    if (threadIdx.x == 0) out[blockIdx.x] = median_of(cnt, m_lo, m_hi);
}

}  // namespace

// ld: row stride of arr in elements (>= nx; the active region of a
// frame is passed as a view of the frame).  cluster: 1, 2, 4 or 8 CTAs
// per block with rows_per rows of the block each (rows_per * kx keys in
// shared memory), or 0 for the streaming kernel.  A cluster that cannot
// be scheduled (shared memory, cluster size) is an error, never a
// silent step down.
extern "C" int block_nanmedian_launch(const float* arr, float* out, int ny,
                                      int nx, long long ld, int N, int cluster,
                                      int rows_per, void* stream)
{
    const int ky = ny / N;
    const int kx = nx / N;
    const int py = (ny % N) / 2;
    const int px = (nx % N) / 2;
    cudaStream_t s = (cudaStream_t)stream;
    if (cluster == 0) {
        block_nanmedian_stream_kernel<<<N * N, NTHREADS, 0, s>>>(
            arr, out, ld, N, ky, kx, py, px);
        return (int)cudaGetLastError();
    }
    if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1))
        || rows_per < 1 || (long long)rows_per * cluster < ky)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)rows_per * kx * sizeof(unsigned);
    if (smem > MAX_KEYS_BYTES) return (int)cudaErrorInvalidValue;
    // per device, once: the opt-in to more than 48 KB of dynamic shared memory
    static bool opted_in[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
        err = cudaFuncSetAttribute(block_nanmedian_cluster_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   MAX_KEYS_BYTES);
        if (err != cudaSuccess) return (int)err;
        opted_in[dev] = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(N * N * cluster));
    cfg.blockDim = dim3(CT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // checked once per cluster size and shared-memory need
    static size_t fits[MAX_CLUSTER + 1] = {};
    if (smem + 1 > fits[cluster]) {
        int nclusters = 0;
        err = cudaOccupancyMaxActiveClusters(
            &nclusters, block_nanmedian_cluster_kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (nclusters < 1) return (int)cudaErrorLaunchOutOfResources;
        fits[cluster] = smem + 1;
    }
    err = cudaLaunchKernelEx(&cfg, block_nanmedian_cluster_kernel, arr, out, ld,
                             N, ky, kx, py, px, rows_per);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
