"""Device-side numeric code: plain PyTorch functions on tensors, and
the wrappers of the hand-written CUDA kernels (``*_cuda`` modules).

- legendre:   Legendre-basis evaluation with linear extrapolation
- linearity:  Legendre linearity correction of a resultant cube
- ipc:        spatially-varying 3x3 IPC convolution and Neumann inverse
- ramp:       Casertano weights, jump detection, ramp fitting
- saturation: per-group saturation flagging with backup + spatial grow
- refsub:     row/channel reference-pixel subtraction
- sky:        binning, smoothed histogram mode, 2D Legendre sky fit
- mask:       DQ bit-plane growing (boolean dilation)
- ipc_cuda, linearity_cuda, median_cuda: kernel wrappers + plain twins
"""
