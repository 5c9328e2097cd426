// Order-2 IPC inverse on an active-region cube: one row-streaming kernel
// whose data path lives in registers, launched by every entry point (the
// blocked and the streaming slab forms, on the cube or on the full frame,
// and the frame inverse of the auto route).
//
// Replaces the TPU kernels of romanimpreprocess_tpu/ops/ipc_pallas.py:
// ipc_rev2_cube_blocked (_ipc_kernel_blocked), ipc_rev2_cube_stream
// (_ipc_kernel_stream), the wrapper correct_cube_fused, and
// ipc_rev2_frame_stream (_ipc_kernel_frame).  The TPU's traversals exist
// for its VMEM windows; here one __global__ computes them, compiled for
// two orders of summation (its Order parameter):
//
// SlabOrder (the slab entry points; twin ops/ipc_slab.py ipc_rev2_plain):
//     y   = d * gain                      (y = d without a gain)
//     a   = K y,   b = K a
//     out = ((3 y - 3 a) + b) / gain
//     (K x)[r, c] = sum_{t=0..8} x[r-dy, c-dx] * K_t[r-dy, c-dx],
//                   (dy, dx) = (t / 3 - 1, t % 3 - 1)
//   with the taps summed in the order t = 0..8 (the first product starts
//   the sum) and sources outside the active region reading +0 (the zero
//   pad of the TPU kernels' slab layout).
//
// NeumannOrder (the frame inverse; twin ops/ipc_cuda.py
// ipc_rev2_frame_plain, the reference's Neumann recursion):
//     o1  = (y + y) - K y
//     out = ((o1 + y) - K o1) / gain      on the active region
//   with K's sum started by the centre tap (t = 4), then t = 0, 1, 2, 3,
//   5, 6, 7, 8, and sources read from the frame: the walk reads EXT = 2
//   rows and columns of the border around the active region (their
//   weights are the zeros of kernel_planes_frame, but a NaN or inf there
//   reaches the output as it does in the twin), +0 outside the frame.
//   o1 outside the frame is +0, the twin's zero fill of its shifts.
//
// In both, the weights are indexed at the SOURCE pixel and every step is
// an explicit _rn intrinsic in the order of the twin: no FMA
// contraction, so the kernel agrees with its twin bit for bit.
//
// Every array comes with a row pitch (and the cube and the planes with a
// group / plane stride), so the kernel reads
//   - a contiguous active-region cube or the active view of a full frame,
//   - the raw (3, 3, na, na) IPC kernel (pitch na), the pre-padded
//     (9, rows_in, width) slab buffer in place (offset th * width + 2,
//     pitch width), or the active view of the (9, nside, nside) frame
//     planes: no repack, no slice copy.
//
// What bounds it: bytes.  Cube in and out, nine planes and the gain:
// 4 * na^2 * (2 G + 9 + 1) = 1.47 GB at 6 groups of 4088^2, 0.44 ms at
// 3.35 TB/s.  Next to it, issue: some 70 instructions a pixel and group
// (21 multiplies, 18 adds, the division, shuffles, copies).  What the
// design does about them:
//
// - A warp owns a strip of 64 columns, two adjacent ones a lane, and
//   walks a segment of rows UPWARD (descending row index).  (K x)[R]
//   takes its taps t = 0..2 from row R + 1, t = 3..5 from row R, t =
//   6..8 from row R - 1, so row s's nine products y[s] * K_t[s] continue
//   or finish the sums of rows s - 1, s and s + 1, and a partial sum per
//   group and column carries the window:
//     SlabOrder: row s starts a[s - 1] (taps 0..2), continues a[s] (3..5)
//       and finishes a[s + 1] (6..8): two partial sums.
//     NeumannOrder: a[s] starts with its centre, which arrives with row
//       s, AFTER row s + 1; so when row s arrives, a[s] takes its centre,
//       then row s + 1's taps 0..2 formed again from y[s + 1] and K[s + 1]
//       (kept for that; a product is one rounded multiply, so it has the
//       same bits), then taps 3 and 5; row s's taps 6..8 finish a[s + 1].
//       One partial sum, and 9 multiplies a row as in the slab order.
//   b runs one row behind on the finished a-row (o1-row), with the
//   weights of that row kept from the previous step (and, in the Neumann
//   order, those of the row before, for taps 0..2).  The output of row
//   s + 2 is written at step s.  No ring index is computed per tap.
// - Horizontal taps: the product is formed at its source column (rounded
//   there, as the twin rounds it); a lane's two columns are each other's
//   neighbours, and the columns of the lanes beside it come by
//   __shfl_sync: 6 shuffles a pass for two columns, no barrier.  Columns
//   0, 1, 62, 63 are halo: a warp writes 60 columns.
// - Loads: each warp keeps DEPTH rows in flight beyond the one it
//   computes in its own ring of shared memory, filled by cp.async (8
//   bytes, a lane's column pair, zero-filled outside what it reads) and
//   read back by the lane that copied them, so no barrier either.
// - Groups: the kernel is compiled for chunks of 1..8 groups held in
//   registers; more groups take more chunks (a grid axis), each reading
//   the planes again.
// - Segments: the plan (ops/ipc_slab.py plan) sizes them so the grid is
//   one wave of resident CTAs; each pays 4 warm-up rows.
//
// Frame forms: the same kernel on the active view of the full frame
// (base offset nb * nside + nb, pitch nside), writing the active region
// of the output frame; a few extra CTAs at the head of the SAME launch
// copy the nb-wide border through (1.5 MB at 6 x 4096^2), with 16 loads
// a thread in flight, beside the one wave of segments.
//
// Row slabs (the row-sharded calibration), in either order: the frame
// forms take a slab of the frame's rows.  The row count (Slab::nr) is a
// parameter of its own beside the column count (Slab::na), and the rows
// read above and below the rows written (ext_lo, ext_hi) are too: the
// slab's halo rows, read through `in` with their real weights, or
// (Neumann order) the frame's border rows where the slab holds the
// frame's top or bottom edge.  The border copy covers the slab's own
// rows: whole rows for the frame border rows the slab holds (top, bot),
// nb columns on each side of the rest.  The whole frame is the slab
// with nr = na, ext_lo = ext_hi = ext and top = bot = nb.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// the orders of summation (tag types, so that a profile names the
// instantiation)
struct SlabOrder {};
struct NeumannOrder {};

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
    int na;             // columns (and, in the square forms, rows)
    int nr;             // rows written
    int ext;            // columns read around the active region
    int ext_lo;         // rows read above the first row written
    int ext_hi;         // rows read below the last row written
};

struct Border {
    const float* in;    // (G, rows, nside) frames of row pitch nside; null: none
    float* out;
    long long in_gs;    // elements between groups
    long long out_gs;
    int rows;           // rows of each frame
    int nside;          // columns of each frame
    int nb;             // border columns on each side
    int top;            // leading rows that are border rows (nb in a square frame)
    int bot;            // trailing rows that are border rows
};

constexpr int LANES = 32;
constexpr int COLS = 2;                    // adjacent columns a lane owns
constexpr int WIDTH = COLS * LANES;        // columns a warp reads
constexpr int HALO = 2;                    // halo columns on each side
constexpr int STRIP = WIDTH - 2 * HALO;    // output columns of a warp
constexpr int WARPS = 4;                   // warps (strips) of a CTA
constexpr int NT = WARPS * LANES;
constexpr int MAX_CHUNK = 8;               // groups a pass holds
constexpr int BATCH = 16;                  // border pixels a thread loads at once
constexpr unsigned FULL = 0xffffffffu;
constexpr int DEPTH = 3;                   // rows in flight beyond the one computed
constexpr int RING = DEPTH + 1;            // rows of a warp's ring
constexpr int EXT = 2;                     // border rows / columns the Neumann order reads

// shared memory of a CTA: each warp's ring of RING rows of (10 + GC)
// arrays of WIDTH floats
constexpr size_t ring_bytes(int gc)
{
    return sizeof(float) * WARPS * RING * (10 + gc) * WIDTH;
}

// copy `bytes` (0, 4 or 8) of src to dst, zero-filling the rest of 8
__device__ __forceinline__ void cp_async8(float* dst, const float* src, int bytes)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// border pixels of one frame: the top full rows, the bottom full rows,
// then nb columns left and right of each row between
__device__ __forceinline__ long long border_per_frame(const Border& q)
{
    return (long long)(q.top + q.bot) * q.nside
        + 2LL * q.nb * (q.rows - q.top - q.bot);
}

// group, row and column of border pixel i (in the order of
// border_per_frame), as the offsets of that pixel in the input and the
// output frames
__device__ __forceinline__ void border_offset(const Border& q, long long per,
                                              long long i, long long* oi, long long* oo)
{
    const int nside = q.nside, nb = q.nb;
    const int top = q.top * nside, bot = q.bot * nside;
    const long long g = i / per;
    int j = (int)(i - g * per), r, c;
    if (j < top) {
        r = j / nside;
        c = j - r * nside;
    } else if (j < top + bot) {
        j -= top;
        r = q.rows - q.bot + j / nside;
        c = j % nside;
    } else {
        j -= top + bot;
        r = q.top + j / (2 * nb);
        const int k = j % (2 * nb);
        c = k < nb ? k : nside - 2 * nb + k;
    }
    const long long rc = (long long)r * nside + c;
    *oi = g * q.in_gs + rc;
    *oo = g * q.out_gs + rc;
}

// copies the border of every frame: BATCH independent loads a thread in
// flight, then their stores
__device__ void copy_border(const Border& q, int ngrp, int block, int nblocks)
{
    const long long per = border_per_frame(q);
    const long long total = per * ngrp;
    const long long stride = (long long)nblocks * NT;
    for (long long i0 = (long long)block * NT + threadIdx.x; i0 < total;
         i0 += BATCH * stride) {
        long long oi[BATCH], oo[BATCH];
        float v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const long long i = i0 + u * stride;
            if (i < total) {
                border_offset(q, per, i, &oi[u], &oo[u]);
            } else {
                oi[u] = oo[u] = -1;
            }
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
            v[u] = oi[u] >= 0 ? __ldg(q.in + oi[u]) : 0.f;
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
            if (oo[u] >= 0) q.out[oo[u]] = v[u];
    }
}

// acc + the taps t0, t0 + 1, t0 + 2 of v, in that order
__device__ __forceinline__ float taps3(float acc, const float* v, int t0)
{
    return __fadd_rn(__fadd_rn(__fadd_rn(acc, v[t0]), v[t0 + 1]), v[t0 + 2]);
}

// the Neumann order's sum through tap 5: the centre, then taps 0, 1, 2,
// 3, 5
__device__ __forceinline__ float centre_to5(const float* v)
{
    return __fadd_rn(__fadd_rn(taps3(v[4], v, 0), v[3]), v[5]);
}

// The nine products of a lane's two columns (pe: column c, po: c + 1),
// each formed at its source, as the terms of the two outputs: tap t
// takes its source from column + 1 (t % 3 == 0), the column itself, or
// column - 1 (t % 3 == 2).  Column c's right neighbour is the lane's
// own c + 1 and its left one the previous lane's c + 1; column c + 1's
// right neighbour is the next lane's c.  Six shuffles for two columns.
__device__ __forceinline__ void to_terms(const float* pe, const float* po,
                                         float* ve, float* vo)
{
#pragma unroll
    for (int t = 0; t < 9; t += 3) {
        ve[t] = po[t];
        vo[t] = __shfl_down_sync(FULL, pe[t], 1);      // from lane + 1
        ve[t + 1] = pe[t + 1];
        vo[t + 1] = po[t + 1];
        ve[t + 2] = __shfl_up_sync(FULL, po[t + 2], 1); // from lane - 1
        vo[t + 2] = pe[t + 2];
    }
}

template <int GC, class Order>
__global__ void __launch_bounds__(NT, 3)
ipc_slab_kernel(Slab p, Border q, int ctas_x, int nseg, int seg,
                int border_ctas, int vec)
{
    constexpr bool NEUMANN = std::is_same<Order, NeumannOrder>::value;
    int blk = blockIdx.x;
    if (blk < border_ctas) {
        copy_border(q, p.ngrp, blk, border_ctas);
        return;
    }
    blk -= border_ctas;
    const int cx = blk % ctas_x;
    blk /= ctas_x;
    const int sg = blk % nseg;
    const int ch = blk / nseg;

    const int na = p.na, ext = p.ext;
    const int lane = threadIdx.x % LANES;
    const int strip = cx * WARPS + threadIdx.x / LANES;
    if (strip * STRIP >= na) return;  // the whole warp
    // the lane's columns c and c + 1 (c even within the strip); lanes 1
    // to 30 write theirs, lanes 0 and 31 are halo.  in0 / in1: the
    // column lies in the span the kernel reads, [-ext, na + ext)
    const int c = strip * STRIP - HALO + COLS * lane;
    const bool in0 = c >= -ext && c < na + ext;
    const bool in1 = c + 1 >= -ext && c + 1 < na + ext;
    const bool live = lane >= 1 && lane < LANES - 1;
    const bool emit0 = live && c < na;
    const bool emit1 = live && c + 1 < na;
    const int g0 = ch * GC;
    const int ng = min(GC, p.ngrp - g0);
    const int rs = sg * seg;
    const int re = min(rs + seg, p.nr);

    // column offsets of the lane's two copies (0 where nothing is read),
    // and the bytes of its 8-byte copy (with vec, in1 implies in0)
    const int off0 = in0 ? c : 0, off1 = in1 ? c + 1 : 0;
    const int nbytes = in1 ? 8 : in0 ? 4 : 0;
    const float* gbase = p.gain ? p.gain : p.k;
    const float* dbase = p.in + (long long)g0 * p.in_gs;
    // row s + 2 of the chunk's first group once moved up at step s
    float* orow = p.out + (long long)g0 * p.out_gs + c + (long long)(re + 4) * p.out_pitch;

    // the warp's ring of RING rows in shared memory: slot i holds the
    // row's arrays (nine planes, the gain, the chunk's groups) of WIDTH
    // floats; each lane copies and reads its own two columns only
    extern __shared__ float ring_s[];
    float* ring = ring_s + (threadIdx.x / LANES) * (RING * (10 + GC) * WIDTH) + COLS * lane;
    // one column pair of one array row: one 8-byte copy where every
    // array is 8-byte aligned at even columns (vec), else two 4-byte
    // copies; +0 where `on` is false
    auto copy2 = [&](float* dst, const float* row, bool on) {
        if (vec) {
            cp_async8(dst, row + off0, on ? nbytes : 0);
        } else {
            cp_async4(dst, row + off0, on && in0 ? 4 : 0);
            cp_async4(dst + 1, row + off1, on && in1 ? 4 : 0);
        }
    };
    // issue the copies of row r into slot i: +0 outside the rows read,
    // [-ext_lo, nr + ext_hi), and outside the walk's rows [rs - 2, re + 1]
    auto issue = [&](int r, int i) {
        const bool in = r >= -p.ext_lo && r < p.nr + p.ext_hi && r >= rs - 2;
        const long long rr = in ? r : 0;
        float* dst = ring + i * ((10 + GC) * WIDTH);
#pragma unroll
        for (int t = 0; t < 9; ++t)
            copy2(dst + t * WIDTH, p.k + t * p.k_ps + rr * p.k_pitch, in);
        copy2(dst + 9 * WIDTH, gbase + rr * p.g_pitch, in && p.gain);
#pragma unroll
        for (int j = 0; j < GC; ++j)
            copy2(dst + (10 + j) * WIDTH,
                  dbase + (j < ng ? j : 0) * p.in_gs + rr * p.in_pitch, in && j < ng);
        cp_async_commit();
    };

    // before step s, per group and column, in both orders: am = a[s + 1]
    // (SlabOrder: taps 0..5; NeumannOrder: through tap 5), y1 = y[s + 1];
    // kp = K[s + 1], g1 / g2 the gain of rows s + 1 / s + 2.
    // SlabOrder: an = a[s] (taps 0..2), bn = b[s + 1] (0..2), bm = b[s +
    // 2] (0..5), u = 3 y[s + 2] - 3 a[s + 2].
    // NeumannOrder: bm = b[s + 2] through tap 5, y2 = y[s + 2], o1p =
    // o1[s + 2]; kq = taps 0..2 of K[s + 2].
    // Warm-up rows leave them defined, never stored.
    float am[GC][COLS], bm[GC][COLS], y1[GC][COLS];
    float an[GC][COLS], bn[GC][COLS], u[GC][COLS];     // SlabOrder
    float y2[GC][COLS], o1p[GC][COLS], kq[3][COLS];    // NeumannOrder
    float kp[9][COLS];
#pragma unroll
    for (int j = 0; j < GC; ++j)
#pragma unroll
        for (int h = 0; h < COLS; ++h)
            an[j][h] = am[j][h] = bn[j][h] = bm[j][h] = y1[j][h] = u[j][h]
                = y2[j][h] = o1p[j][h] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) kp[t][0] = kp[t][1] = 0.f;
#pragma unroll
    for (int t = 0; t < 3; ++t) kq[t][0] = kq[t][1] = 0.f;
    float g1[COLS] = {1.f, 1.f}, g2[COLS] = {1.f, 1.f};

#pragma unroll
    for (int i = 0; i < DEPTH; ++i) issue(re + 1 - i, i);
    int slot = 0;  // ring slot of row s
    for (int s = re + 1; s >= rs - 2; --s) {
        // DEPTH rows in flight beyond this one; wait for row s
        issue(s - DEPTH, (slot + DEPTH) % RING);
        cp_async_wait<DEPTH>();
        const float* cur = ring + slot * ((10 + GC) * WIDTH);
        slot = (slot + 1) % RING;
        float kc[9][COLS], y[GC][COLS], gs[COLS];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            const float2 k2 = *reinterpret_cast<const float2*>(cur + t * WIDTH);
            kc[t][0] = k2.x;
            kc[t][1] = k2.y;
        }
        if (p.gain) {
            const float2 g = *reinterpret_cast<const float2*>(cur + 9 * WIDTH);
            gs[0] = g.x;
            gs[1] = g.y;
        } else {
            gs[0] = gs[1] = 1.f;
        }
#pragma unroll
        for (int j = 0; j < GC; ++j) {
            const float2 d = *reinterpret_cast<const float2*>(cur + (10 + j) * WIDTH);
            y[j][0] = __fmul_rn(d.x, gs[0]);
            y[j][1] = __fmul_rn(d.y, gs[1]);
        }

        // the finished a-row s + 1 is +0 outside the rows and columns read
        const bool arow = s + 1 >= -p.ext_lo && s + 1 < p.nr + p.ext_hi;
        const bool a0 = arow && in0, a1 = arow && in1;
        const bool store = s + 2 < re;
        orow -= p.out_pitch;
#pragma unroll
        for (int j = 0; j < GC; ++j) {
            float pe[9], po[9], ve[9], vo[9], af[COLS], bf[COLS], res[COLS];
            if constexpr (NEUMANN) {
                // row s + 1's taps 0..2 formed again, row s's taps 3..8
#pragma unroll
                for (int t = 0; t < 9; ++t) {
                    pe[t] = __fmul_rn(t < 3 ? y1[j][0] : y[j][0], t < 3 ? kp[t][0] : kc[t][0]);
                    po[t] = __fmul_rn(t < 3 ? y1[j][1] : y[j][1], t < 3 ? kp[t][1] : kc[t][1]);
                }
                to_terms(pe, po, ve, vo);
                af[0] = taps3(am[j][0], ve, 6);           // a[s + 1] complete
                af[1] = taps3(am[j][1], vo, 6);
                am[j][0] = centre_to5(ve);                 // a[s] through tap 5
                am[j][1] = centre_to5(vo);
                // o1[s + 1] = (y + y) - a, +0 outside
                af[0] = a0 ? __fsub_rn(__fadd_rn(y1[j][0], y1[j][0]), af[0]) : 0.f;
                af[1] = a1 ? __fsub_rn(__fadd_rn(y1[j][1], y1[j][1]), af[1]) : 0.f;
                // o1-row s + 2's taps 0..2 formed again, o1-row s + 1's 3..8
#pragma unroll
                for (int t = 0; t < 9; ++t) {
                    pe[t] = __fmul_rn(t < 3 ? o1p[j][0] : af[0], t < 3 ? kq[t % 3][0] : kp[t][0]);
                    po[t] = __fmul_rn(t < 3 ? o1p[j][1] : af[1], t < 3 ? kq[t % 3][1] : kp[t][1]);
                }
                to_terms(pe, po, ve, vo);
                bf[0] = taps3(bm[j][0], ve, 6);           // b[s + 2] complete
                bf[1] = taps3(bm[j][1], vo, 6);
                bm[j][0] = centre_to5(ve);                 // b[s + 1] through tap 5
                bm[j][1] = centre_to5(vo);
#pragma unroll
                for (int h = 0; h < COLS; ++h) {
                    res[h] = __fsub_rn(__fadd_rn(o1p[j][h], y2[j][h]), bf[h]);
                    o1p[j][h] = af[h];
                    y2[j][h] = y1[j][h];
                    y1[j][h] = y[j][h];
                }
            } else {
#pragma unroll
                for (int t = 0; t < 9; ++t) {
                    pe[t] = __fmul_rn(y[j][0], kc[t][0]);
                    po[t] = __fmul_rn(y[j][1], kc[t][1]);
                }
                to_terms(pe, po, ve, vo);
                af[0] = taps3(am[j][0], ve, 6);           // a[s + 1] complete
                af[1] = taps3(am[j][1], vo, 6);
                am[j][0] = taps3(an[j][0], ve, 3);
                am[j][1] = taps3(an[j][1], vo, 3);
                an[j][0] = __fadd_rn(__fadd_rn(ve[0], ve[1]), ve[2]);
                an[j][1] = __fadd_rn(__fadd_rn(vo[0], vo[1]), vo[2]);
                af[0] = a0 ? af[0] : 0.f;                  // +0 outside
                af[1] = a1 ? af[1] : 0.f;
#pragma unroll
                for (int t = 0; t < 9; ++t) {
                    pe[t] = __fmul_rn(af[0], kp[t][0]);
                    po[t] = __fmul_rn(af[1], kp[t][1]);
                }
                to_terms(pe, po, ve, vo);
                bf[0] = taps3(bm[j][0], ve, 6);           // b[s + 2] complete
                bf[1] = taps3(bm[j][1], vo, 6);
                bm[j][0] = taps3(bn[j][0], ve, 3);
                bm[j][1] = taps3(bn[j][1], vo, 3);
                bn[j][0] = __fadd_rn(__fadd_rn(ve[0], ve[1]), ve[2]);
                bn[j][1] = __fadd_rn(__fadd_rn(vo[0], vo[1]), vo[2]);
#pragma unroll
                for (int h = 0; h < COLS; ++h) {
                    res[h] = __fadd_rn(u[j][h], bf[h]);
                    u[j][h] = __fsub_rn(__fmul_rn(3.f, y1[j][h]), __fmul_rn(3.f, af[h]));
                    y1[j][h] = y[j][h];
                }
            }
            if (store && j < ng && emit0) {
                float* o = orow + j * p.out_gs;
                const float r0 = __fdiv_rn(res[0], g2[0]);
                const float r1 = __fdiv_rn(res[1], g2[1]);
                if (vec && emit1) {
                    *reinterpret_cast<float2*>(o) = make_float2(r0, r1);
                } else {
                    o[0] = r0;
                    if (emit1) o[1] = r1;
                }
            }
        }
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            if (NEUMANN && t < 3) {
                kq[t % 3][0] = kp[t][0];
                kq[t % 3][1] = kp[t][1];
            }
            kp[t][0] = kc[t][0];
            kp[t][1] = kc[t][1];
        }
#pragma unroll
        for (int h = 0; h < COLS; ++h) {
            g2[h] = g1[h];
            g1[h] = gs[h];
        }
    }
}

template <int GC, class O>
cudaError_t launch(const Slab& p, const Border& q, int ctas_x, int nseg,
                   int seg, int nch, int border_ctas, int vec, cudaStream_t stream)
{
    const long long grid = (long long)ctas_x * nseg * nch + border_ctas;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        ipc_slab_kernel<GC, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ring_bytes(GC));
    if (err != cudaSuccess) return err;
    ipc_slab_kernel<GC, O><<<(unsigned)grid, NT, ring_bytes(GC), stream>>>(
        p, q, ctas_x, nseg, seg, border_ctas, vec);
    return cudaGetLastError();
}

template <int GC, class O>
cudaError_t resident(int* ctas)
{
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t err = cudaFuncSetAttribute(
        ipc_slab_kernel<GC, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ring_bytes(GC));
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ipc_slab_kernel<GC, O>, NT, ring_bytes(GC));
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *ctas = per_sm * sms;
    return err;
}

// f(std::integral_constant<int, chunk>, order tag) for chunk 1..8 and
// order 0 (SlabOrder) or 1 (NeumannOrder)
template <class F>
cudaError_t instantiation(int chunk, int order, F f)
{
    auto by_chunk = [&](auto o) -> cudaError_t {
        switch (chunk) {
        case 1: return f(std::integral_constant<int, 1>(), o);
        case 2: return f(std::integral_constant<int, 2>(), o);
        case 3: return f(std::integral_constant<int, 3>(), o);
        case 4: return f(std::integral_constant<int, 4>(), o);
        case 5: return f(std::integral_constant<int, 5>(), o);
        case 6: return f(std::integral_constant<int, 6>(), o);
        case 7: return f(std::integral_constant<int, 7>(), o);
        case 8: return f(std::integral_constant<int, 8>(), o);
        default: return cudaErrorInvalidValue;
        }
    };
    if (order == 0) return by_chunk(SlabOrder());
    if (order == 1) return by_chunk(NeumannOrder());
    return cudaErrorInvalidValue;
}

}  // namespace

// CTAs of the kernel compiled for `chunk` groups and `order` (0: slab,
// 1: Neumann) that the current device holds at once.
extern "C" int ipc_slab_resident(int chunk, int order, int* ctas)
{
    return (int)instantiation(chunk, order, [&](auto gc, auto o) {
        return resident<decltype(gc)::value, decltype(o)>(ctas);
    });
}

// One launch: segments of `seg` rows, chunks of `chunk` groups (the plan
// of ops/ipc_slab.py), sums in `order` (0: slab, 1: Neumann).  `in` /
// `out` are the (ngrp, nrows, na) active views of the rows written.
// Without frame_in / frame_out (a cube) nothing else is read or written.
// With them (a frame, or a row slab of one), `in` and `out` lie inside
// those (ngrp, frame_rows, nside) rows (group strides frame_in_gs /
// frame_out_gs, row pitch nside): the walk reads ext_lo rows above and
// ext_hi rows below the rows written through `in`, the planes and the
// gain (a slab's halo rows, or in the Neumann order the frame's border
// rows), and, in the Neumann order, min(nborder, EXT) border columns on
// each side; `border_ctas` extra CTAs at the head of the grid copy the
// border from frame_in to frame_out while the others walk their
// segments: the first `top` and last `bot` rows whole (the frame's
// border rows held) and nborder columns on each side of the rows
// between.  A whole frame is nrows = na, ext_lo = ext_hi = min(nborder,
// EXT) in the Neumann order (0 in the slab order), top = bot = nborder.
extern "C" int ipc_slab_launch(
    const float* in, long long in_gs, int in_pitch,
    float* out, long long out_gs, int out_pitch,
    const float* k, long long k_ps, int k_pitch,
    const float* gain, int g_pitch, int ngrp, int na, int nrows,
    int ext_lo, int ext_hi,
    const float* frame_in, long long frame_in_gs, float* frame_out,
    long long frame_out_gs, int frame_rows, int nside, int nborder, int top, int bot,
    int border_ctas, int seg, int chunk, int order, void* stream)
{
    if (ngrp < 1 || na < 1 || nrows < 1 || seg < 1 || chunk < 1 || chunk > MAX_CHUNK ||
        border_ctas < 0 || nborder < 0 || ext_lo < 0 || ext_lo > EXT || ext_hi < 0 ||
        ext_hi > EXT || !frame_in != !frame_out ||
        (frame_in && (top < 0 || bot < 0 || top + bot + nrows != frame_rows)) ||
        (!frame_in && (ext_lo || ext_hi || nborder)))
        return (int)cudaErrorInvalidValue;
    Slab p;
    p.in = in; p.in_gs = in_gs; p.in_pitch = in_pitch;
    p.out = out; p.out_gs = out_gs; p.out_pitch = out_pitch;
    p.k = k; p.k_ps = k_ps; p.k_pitch = k_pitch;
    p.gain = gain; p.g_pitch = g_pitch;
    p.ngrp = ngrp; p.na = na; p.nr = nrows;
    p.ext = order == 1 ? (nborder < EXT ? nborder : EXT) : 0;
    p.ext_lo = ext_lo; p.ext_hi = ext_hi;
    Border q;
    q.in = frame_in; q.out = frame_out;
    q.in_gs = frame_in_gs; q.out_gs = frame_out_gs;
    q.rows = frame_rows; q.nside = nside; q.nb = nborder;
    q.top = top; q.bot = bot;
    const int strips = (na + STRIP - 1) / STRIP;
    const int ctas_x = (strips + WARPS - 1) / WARPS;
    const int nseg = (nrows + seg - 1) / seg;
    const int nch = (ngrp + chunk - 1) / chunk;
    if (!frame_in || nborder <= 0) border_ctas = 0;
    // 8-byte copies and stores of column pairs: every array 8-byte
    // aligned at even columns of every row, group and plane, and the
    // span read starting at an even column
    auto even = [](const void* ptr, long long a, long long b) {
        return ((unsigned long long)ptr % 8 == 0) && a % 2 == 0 && b % 2 == 0;
    };
    const int vec = even(in, in_gs, in_pitch) && even(out, out_gs, out_pitch)
        && even(k, k_ps, k_pitch) && (!gain || even(gain, 0, g_pitch))
        && p.ext % 2 == 0;
    const cudaStream_t s = (cudaStream_t)stream;
    return (int)instantiation(chunk, order, [&](auto gc, auto o) {
        return launch<decltype(gc)::value, decltype(o)>(
            p, q, ctas_x, nseg, seg, nch, border_ctas, vec, s);
    });
}
