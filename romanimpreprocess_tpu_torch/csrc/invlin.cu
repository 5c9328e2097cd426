// Inverse of the Legendre linearity model by bisection: the sim's IL
// forward model (linearized electrons -> raw DN), kernel D.
//
// No TPU kernel corresponds to it: the JAX package writes the bisection
// (romanimpreprocess_tpu/ops/linearity.py invert_linearity) as an
// unrolled loop of elementwise operations, which XLA fuses into one
// pass.  PyTorch runs the same loop as about 40 launches a step over
// the whole cube, so here the fusion is written by hand.  Per active
// pixel and group g:
//
//     s   = x[g] / gain
//     z   = 0;  for j = 1..niter:
//               phi = sum_L coefs[L] P_L(z)       (no extrapolation)
//               z  += phi < s ? 2^-j : -2^-j
//     S   = smin + 0.5 (smax - smin) (1 + z)
//     ex  = |z| > 1 at the last evaluation
//
// x, S and ex are (ngrp, na, na); gain, smin, smax (ny, nx) and coefs
// (nc, ny, nx) are full frames whose centred na x na window is the
// active region (offset nb), read in place.
//
// What bounds it: operations.  Each step is about 34 unfused float32
// operations at 7 coefficients (no FMA), so 8 x 4088^2 pixels x 24
// steps is about 110 G operations, 3.3 ms at the card's 33.5 T float32
// instructions a second, against 1.87 GB of bytes (0.56 ms).  Design:
// one thread per active pixel keeps the coefficients, smin, smax and
// the gain in registers and loops over the groups, so the cal planes
// are read once and the cube once in and once out.
//
// Every rounding step is an explicit _rn intrinsic in the order of the
// plain PyTorch version (ops/linearity.py invert_linearity with
// ops/legendre.py legendre_eval, linextrap=False): no FMA contraction,
// the recursion constants rounded to float32 as torch rounds a Python
// scalar, so every comparison, and hence S, agrees bit for bit.  The
// last recursion step, whose polynomial nothing reads, is skipped.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

template <int NC>
__global__ void __launch_bounds__(NTHREADS)
invlin_kernel(const float* __restrict__ x, const float* __restrict__ gain,
              const float* __restrict__ coefs, const float* __restrict__ smin,
              const float* __restrict__ smax, float* __restrict__ S_out,
              uint8_t* __restrict__ ex_out, int ngrp, int na, int nx,
              long long plane, int nb, int niter)
{
    const long long p = (long long)blockIdx.x * NTHREADS + threadIdx.x;
    const long long npix = (long long)na * na;
    if (p >= npix) return;
    const int r = (int)(p / na);
    const int c = (int)(p - (long long)r * na);
    const long long q = (long long)(r + nb) * nx + (c + nb);  // full-frame index

    float cf[NC];
#pragma unroll
    for (int L = 0; L < NC; ++L) cf[L] = coefs[L * plane + q];
    const float lo = smin[q];
    const float half_span = __fmul_rn(0.5f, __fsub_rn(smax[q], lo));
    const float g = gain[q];

    for (int grp = 0; grp < ngrp; ++grp) {
        const long long gp = grp * npix + p;
        const float s = __fdiv_rn(x[gp], g);
        float z = 0.f;
        float zlast = 0.f;
        float step = 0.5f;
        for (int j = 0; j < niter; ++j) {
            float phi = cf[0];
            float poly_prev = 1.f;
            float poly = z;
#pragma unroll
            for (int L = 1; L < NC; ++L) {
                phi = __fadd_rn(phi, __fmul_rn(cf[L], poly));
                if (L + 1 < NC) {
                    const float a = (float)((2.0 * L + 1.0) / (L + 1.0));
                    const float b = (float)((double)L / (L + 1.0));
                    const float next = __fsub_rn(__fmul_rn(__fmul_rn(a, z), poly),
                                                 __fmul_rn(b, poly_prev));
                    poly_prev = poly;
                    poly = next;
                }
            }
            zlast = z;
            z = __fadd_rn(z, phi < s ? step : -step);
            step = __fmul_rn(step, 0.5f);
        }
        S_out[gp] = __fadd_rn(lo, __fmul_rn(half_span, __fadd_rn(1.f, z)));
        ex_out[gp] = fabsf(zlast) > 1.f;
    }
}

template <int NC>
int launch(const float* x, const float* gain, const float* coefs,
           const float* smin, const float* smax, float* S, uint8_t* ex,
           int ngrp, int na, int nx, long long plane, int nb, int niter,
           cudaStream_t stream)
{
    const long long npix = (long long)na * na;
    const unsigned blocks = (unsigned)((npix + NTHREADS - 1) / NTHREADS);
    invlin_kernel<NC><<<blocks, NTHREADS, 0, stream>>>(
        x, gain, coefs, smin, smax, S, ex, ngrp, na, nx, plane, nb, niter);
    return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue for an unsupported
// coefficient count (the wrapper checks 1 <= nc <= 8 first).  plane is
// ny * nx, the stride between coefficient planes.
extern "C" int invert_linearity_launch(const float* x, const float* gain,
                                       const float* coefs, const float* smin,
                                       const float* smax, float* S, uint8_t* ex,
                                       int ngrp, int nc, int na, int nx,
                                       long long plane, int nb, int niter,
                                       void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    switch (nc) {
#define CASE(n) case n: return launch<n>(x, gain, coefs, smin, smax, S, ex, ngrp, \
                                         na, nx, plane, nb, niter, st);
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
        default: return (int)cudaErrorInvalidValue;
    }
}
