// Legendre linearity correction of a resultant cube.
//
// Replaces the TPU kernel romanimpreprocess_tpu/ops/linearity_pallas.py
// apply_linearity_cube_fused (_lin_kernel).  Per pixel and group g:
//
//     z   = -1 + 2 (S - smin) / (smax - smin)   (clipped to [-1, 1] in
//                                              group 0 if do_not_flag_first)
//     phi = sum_L coefs[L] P_L(z), each P_L continued linearly for |z| > 1
//     new flag (NO_LIN_CORR) where |z| > 1 and attempt, never in group 0
//     when do_not_flag_first
//     out = phi, or S - sref where the dq seen by group g (calibration dq
//           OR NO_LIN_CORR if an EARLIER group raised a flag) holds
//           NO_LIN_CORR | REFERENCE_PIXEL
//
// and the accumulated dq plane.  DQ travels as int32 bit patterns.
//
// What bounds it: bytes (about 90 B per pixel at 6 groups and 4
// coefficients, 1.51 GB at 4096^2).  Design: one thread per pixel loops
// over the groups, so the coefficients, smin, smax, sref and dq are
// read once per pixel and the sequential flag feedback is a register.
// Every rounding step is an explicit _rn intrinsic: no FMA contraction,
// so z, the |z| > 1 test and hence the DQ plane match the plain PyTorch
// version (separate elementwise ops) bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NLC = 1 << 20;                          // NO_LIN_CORR
constexpr int FALLBACK = (int)((1u << 20) | (1u << 31));  // | REFERENCE_PIXEL
constexpr int NTHREADS = 256;

template <int NC>
__global__ void __launch_bounds__(NTHREADS)
linearity_kernel(const float* __restrict__ S, const float* __restrict__ coefs,
                 const float* __restrict__ smin, const float* __restrict__ smax,
                 const float* __restrict__ sref, const int* __restrict__ dq,
                 const uint8_t* __restrict__ attempt,
                 float* __restrict__ phi_out, int* __restrict__ dq_out,
                 int ngrp, long long npix, int do_not_flag_first)
{
    const long long p = (long long)blockIdx.x * NTHREADS + threadIdx.x;
    if (p >= npix) return;
    float c[NC];
#pragma unroll
    for (int L = 0; L < NC; ++L) c[L] = coefs[L * npix + p];
    const float lo = smin[p];
    const float span = __fsub_rn(smax[p], lo);
    const float ref = sref[p];
    const int dq0 = dq[p];
    bool acc = false;

    for (int g = 0; g < ngrp; ++g) {
        const long long gp = g * npix + p;
        const float s = S[gp];
        float z = __fadd_rn(-1.f, __fdiv_rn(__fmul_rn(2.f, __fsub_rn(s, lo)), span));
        const bool first = do_not_flag_first && g == 0;
        if (first && !isnan(z)) z = fminf(fmaxf(z, -1.f), 1.f);  // clamp keeps NaN
        const bool ex = fabsf(z) > 1.f;

        const float signz = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
        const float excess = __fsub_rn(fabsf(z), 1.f);
        float sign_pow = signz;
        float phi = c[0];
        float poly_prev = 1.f;
        float poly = z;
#pragma unroll
        for (int L = 1; L < NC; ++L) {
            const float w = (float)(L * (L + 1)) / 2.f;
            const float term = ex ? __fmul_rn(sign_pow, __fadd_rn(1.f, __fmul_rn(w, excess)))
                                  : poly;
            sign_pow = __fmul_rn(sign_pow, signz);
            phi = __fadd_rn(phi, __fmul_rn(c[L], term));
            const float a = (float)((2.0 * L + 1.0) / (L + 1.0));
            const float b = (float)((double)L / (L + 1.0));
            const float next = __fsub_rn(__fmul_rn(__fmul_rn(a, z), poly),
                                         __fmul_rn(b, poly_prev));
            poly_prev = poly;
            poly = next;
        }

        const int dq_g = dq0 | (acc ? NLC : 0);
        phi_out[gp] = (dq_g & FALLBACK) == 0 ? phi : __fsub_rn(s, ref);
        acc = acc || (ex && attempt[gp] != 0 && !first);
    }
    dq_out[p] = dq0 | (acc ? NLC : 0);
}

template <int NC>
int launch(const float* S, const float* coefs, const float* smin,
           const float* smax, const float* sref, const int* dq,
           const uint8_t* attempt, float* phi, int* dqo, int ngrp,
           long long npix, int dnff, cudaStream_t stream)
{
    const unsigned blocks = (unsigned)((npix + NTHREADS - 1) / NTHREADS);
    linearity_kernel<NC><<<blocks, NTHREADS, 0, stream>>>(
        S, coefs, smin, smax, sref, dq, attempt, phi, dqo, ngrp, npix, dnff);
    return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue for an unsupported
// coefficient count (the wrapper checks 1 <= nc <= 8 first).
extern "C" int linearity_cube_launch(const float* S, const float* coefs,
                                     const float* smin, const float* smax,
                                     const float* sref, const int* dq,
                                     const uint8_t* attempt, float* phi,
                                     int* dqo, int ngrp, int nc,
                                     long long npix, int do_not_flag_first,
                                     void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    switch (nc) {
#define CASE(n) case n: return launch<n>(S, coefs, smin, smax, sref, dq, attempt, \
                                         phi, dqo, ngrp, npix, do_not_flag_first, st);
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
        default: return (int)cudaErrorInvalidValue;
    }
}
