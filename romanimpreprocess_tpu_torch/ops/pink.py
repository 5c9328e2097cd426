"""1/f ("pink") banding-noise synthesis.

Re-implements the reference's ``noise_1f_frame``
(``from_sim/sim_to_isim.py:265-303``): a (nside, channelwidth) block of
noise with S(f) = 1/f normalized to unit variance per logarithmic
frequency range, generated by shaping a complex white spectrum and
transforming to the time domain.

For full-frame sizes the batched transform is a two-stage Cooley-Tukey
factorization (N = n1 * n2) whose stages are matrix products with
bfloat16 inputs and float32 sums; each complex transform yields two
independent frames (Re and Im).  :func:`pink_from_white_plain` is that
transform in plain PyTorch, from a given white spectrum, and the twin
of the CUDA kernel in :mod:`.pink_cuda`.  Small frames (tests) use the
exact Hermitian half-spectrum ``irfft``.
"""

import math

import torch

#: use the Cooley-Tukey path at or above this transform length
MXU_MIN_LENGTH = 1 << 16

BF16 = torch.bfloat16


def split_length(length):
    """(n1, n2) of the two-stage factorization of a power-of-two length."""
    n1 = 1 << ((length.bit_length() - 1) // 2)
    return n1, length // n1


def amplitude(length, device=None):
    """The (length,) bfloat16 spectral amplitude ``k_fold^-1/2 / sqrt 2``
    with ``k_fold = min(k, length - k)`` and a zero DC term: symmetric,
    so Re and Im of the transform are independent frames."""
    k = torch.arange(length, dtype=torch.float32, device=device)
    k_fold = torch.minimum(k, length - k)
    amp = k_fold.pow(-0.5) / math.sqrt(2.0)
    amp[0] = 0.0
    return amp.to(BF16)


def dft_matrices(n1, n2, m2max, device=None):
    """The constant matrices of the two stages: ``e1c, e1s`` (n1, n1)
    and ``e2c, e2s`` (n2, m2max) bfloat16 cos/sin, and the float32
    twiddle ``wc, ws`` (n2, n1).  Angles are formed in float32, as the
    reference forms them."""
    a1 = torch.arange(n1, dtype=torch.float32, device=device)
    a2 = torch.arange(n2, dtype=torch.float32, device=device)
    th1 = torch.outer(a1, a1) * (2.0 * math.pi / n1)
    th2 = torch.outer(a2, a2[:m2max]) * (2.0 * math.pi / n2)
    thw = torch.outer(a2, a1) * (2.0 * math.pi / (n1 * n2))
    return (torch.cos(th1).to(BF16), torch.sin(th1).to(BF16),
            torch.cos(th2).to(BF16), torch.sin(th2).to(BF16),
            torch.cos(thw), torch.sin(thw))


def _fft_ct(spec_r, spec_i, n1, n2, both=False, half=False):
    """FFT_N(spec) for a batch of complex spectra, N = n1*n2, via two
    matrix-product stages (Cooley-Tukey), bf16 inputs / f32 sums.
    Returns Re only (``both=False``) or (Re, Im).  ``half=True`` returns
    only the first N/2 output samples: with n = m1 + n1*m2 that is
    m2 < n2/2, so stage 2 contracts against n2/2 columns.

    Index math (k = k1*n2 + k2, n = m1 + n1*m2):
      A[k2, m1] = sum_k1 C[k1, k2] e^(-2pi i k1 m1 / n1)
      B = A * e^(-2pi i k2 m1 / N)
      x[m1 + n1 m2] = sum_k2 B[k2, m1] e^(-2pi i k2 m2 / n2)

    The bf16 values are widened to float32 before each product, so the
    products are exact and the sums run in float32 (TF32 off).
    """
    from .sky import full_fp32

    f = spec_r.shape[0]
    m2max = n2 // 2 if half else n2
    e1c, e1s, e2c, e2s, wc, ws = dft_matrices(n1, n2, m2max, spec_r.device)
    e1c, e1s, e2c, e2s = (e.float() for e in (e1c, e1s, e2c, e2s))

    # (f, k1, k2) -> (f, k2, k1): stage 1 contracts k1
    cr = spec_r.reshape(f, n1, n2).to(BF16).float().transpose(1, 2)
    ci = spec_i.reshape(f, n1, n2).to(BF16).float().transpose(1, 2)
    with full_fp32():
        # stage 1, e^{-i}: (cr + i ci)(c - i s) -> (f, k2, m1)
        ar = cr @ e1c + ci @ e1s
        ai = ci @ e1c - cr @ e1s
        # twiddle (f32 elementwise), wc/ws: (k2, m1)
        br = (ar * wc + ai * ws).to(BF16).float()
        bi = (ai * wc - ar * ws).to(BF16).float()
        # stage 2 with the small matrix on the left: (m2, k2) @ (f, k2, m1)
        # -> (f, m2, m1), already in time order n = m1 + n1 m2
        xr = (e2c.T @ br + e2s.T @ bi).reshape(f, n1 * m2max)
        if not both:
            return xr
        xi = (e2c.T @ bi - e2s.T @ br).reshape(f, n1 * m2max)
    return xr, xi


def pink_from_white_plain(white):
    """Plain PyTorch version of the CUDA kernel: ``white`` is the
    (ntr, 2, length) bfloat16 white spectrum (Re, Im), length a power of
    two.  Returns (2 * ntr, length / 2) float32: the Re frames, then
    the Im frames, each with its mean removed."""
    length = white.shape[-1]
    n1, n2 = split_length(length)
    amp = amplitude(length, white.device)
    xr, xi = _fft_ct(white[:, 0] * amp, white[:, 1] * amp, n1, n2,
                     both=True, half=True)
    block = torch.cat([xr, xi], dim=0)
    return block - block.mean(dim=-1, keepdim=True)


def pink_frames(gen, nframes, nside, channelwidth, backend="xla"):
    """Generate ``nframes`` independent 1/f blocks, shape
    (nframes, nside, channelwidth), float32, on ``gen``'s device.

    Power-of-two lengths ``2 * nside * channelwidth`` at or above
    :data:`MXU_MIN_LENGTH` take the Cooley-Tukey path: one bfloat16
    draw of (ntr, 2, length) from ``gen``, then the CUDA kernel
    (``backend='cuda'``) or its plain version (``'xla'``).  Smaller
    sizes use the exact Hermitian half-spectrum ``irfft`` whatever the
    backend: distributionally identical to the reference's
    complex-FFT-and-take-real-part construction (each |frequency| k
    carries an independent complex Gaussian with variance 1/k).
    """
    dev = gen.device
    length = 2 * nside * channelwidth
    if length >= MXU_MIN_LENGTH and (length & (length - 1)) == 0:
        ntr = (nframes + 1) // 2
        white = torch.randn((ntr, 2, length), generator=gen, device=dev,
                            dtype=BF16)
        if backend == "cuda":
            from . import pink_cuda

            block = pink_cuda.pink_from_white(white)
        else:
            block = pink_from_white_plain(white)
        return block[:nframes].reshape(nframes, nside, channelwidth)
    half = length // 2
    white = torch.randn((nframes, 2, half + 1), generator=gen, device=dev,
                        dtype=torch.float32)
    k_idx = torch.arange(half + 1, dtype=torch.float32, device=dev)
    # per-|k| variance of the reference construction after its /sqrt(2):
    # amp_k^2 = 1/k; irfft carries bin k with weight 2/N, so the
    # coefficient scale is (N/2) * amp_k
    amp = (length / 2.0) * k_idx.pow(-0.5)
    amp[0] = 0.0
    # the Nyquist bin enters the irfft once (not as a +/-k pair)
    amp[-1] *= math.sqrt(2.0)
    spec = torch.complex(white[:, 0], white[:, 1]) * amp
    block = torch.fft.irfft(spec, n=length, dim=-1)[:, :half]
    block = block - block.mean(dim=-1, keepdim=True)
    return block.reshape(nframes, nside, channelwidth)
