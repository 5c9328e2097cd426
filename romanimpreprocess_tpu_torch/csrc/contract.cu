// Read-axis contraction of a per-read cube: out[j] = sum_r T[j, r] * x[r].
//
// Replaces the TPU kernel romanimpreprocess_tpu/ops/contract_pallas.py
// contract_reads (_contract_kernel): the cumulative-membership
// contraction that turns per-read Poisson increments into MultiAccum
// resultants (the sim accumulator; later the 'P' noise layer).
//
// What bounds it: bytes.  x (nreads planes) is read once and out (ngrp
// planes) written once: 1.34 GB at 14 reads -> 6 groups of 4088^2.
// Design: a streaming pass.  Each thread owns four neighbouring pixels
// (one 16-byte load per read plane; one pixel each when the plane size
// or a pointer does not allow 16-byte accesses), keeps its ngrp sums in
// registers and walks the read planes once; T sits in shared memory.
// There is no row padding: the pixel index is bounds-checked.
//
// The sums run r = 0 .. nreads-1 in order with explicit _rn products
// and adds (no FMA contraction), exactly as the plain PyTorch twin's
// ordered loop does, so the kernel agrees with it bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

__device__ __forceinline__ float mul_rn(float t, float v) { return __fmul_rn(t, v); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 mul_rn(float t, float4 v)
{
    return make_float4(__fmul_rn(t, v.x), __fmul_rn(t, v.y),
                       __fmul_rn(t, v.z), __fmul_rn(t, v.w));
}
__device__ __forceinline__ float4 add_rn(float4 a, float4 b)
{
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// V is float or float4; n counts V elements per plane.  MAXG bounds
// ngrp at compile time so that the sums index registers statically.
template <int MAXG, typename V>
__global__ void __launch_bounds__(NTHREADS)
contract_kernel(const float* __restrict__ T, const V* __restrict__ x,
                V* __restrict__ out, int ngrp, int nreads, long long n)
{
    extern __shared__ float t_s[];  // ngrp x nreads
    for (int i = threadIdx.x; i < ngrp * nreads; i += NTHREADS) t_s[i] = T[i];
    __syncthreads();
    const long long p = (long long)blockIdx.x * NTHREADS + threadIdx.x;
    if (p >= n) return;

    V acc[MAXG];
    {
        const V v = x[p];
#pragma unroll
        for (int j = 0; j < MAXG; ++j)
            if (j < ngrp) acc[j] = mul_rn(t_s[j * nreads], v);
    }
#pragma unroll 4
    for (int r = 1; r < nreads; ++r) {
        const V v = x[(long long)r * n + p];
#pragma unroll
        for (int j = 0; j < MAXG; ++j)
            if (j < ngrp) acc[j] = add_rn(acc[j], mul_rn(t_s[j * nreads + r], v));
    }
#pragma unroll
    for (int j = 0; j < MAXG; ++j)
        if (j < ngrp) out[(long long)j * n + p] = acc[j];
}

template <int MAXG, typename V>
cudaError_t launch(const float* T, const float* x, float* out, int ngrp,
                   int nreads, long long n, cudaStream_t stream)
{
    const long long blocks = (n + NTHREADS - 1) / NTHREADS;
    contract_kernel<MAXG, V><<<(unsigned)blocks, NTHREADS,
                               sizeof(float) * ngrp * nreads, stream>>>(
        T, reinterpret_cast<const V*>(x), reinterpret_cast<V*>(out),
        ngrp, nreads, n);
    return cudaGetLastError();
}

}  // namespace

// T (ngrp, nreads), x (nreads, npix), out (ngrp, npix), all float32 and
// contiguous.  vec4 != 0 asks for the 16-byte path: the caller has
// checked that npix is a multiple of 4 and both pointers are 16-byte
// aligned.  ngrp <= 32 and ngrp * nreads * 4 bytes <= 48 KB.
extern "C" int contract_reads_launch(const float* T, const float* x, float* out,
                                     int ngrp, int nreads, long long npix,
                                     int vec4, void* stream)
{
    if (ngrp < 1 || ngrp > 32 || nreads < 1 ||
        (long long)ngrp * nreads * 4 > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    if (npix == 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (vec4) {
        err = ngrp <= 8 ? launch<8, float4>(T, x, out, ngrp, nreads, npix / 4, s)
                        : launch<32, float4>(T, x, out, ngrp, nreads, npix / 4, s);
    } else {
        err = ngrp <= 8 ? launch<8, float>(T, x, out, ngrp, nreads, npix, s)
                        : launch<32, float>(T, x, out, ngrp, nreads, npix, s);
    }
    return (int)err;
}
