"""romanimpreprocess_tpu_torch — Roman WFI image preprocessing in PyTorch.

The PyTorch/CUDA port of the JAX package ``romanimpreprocess_tpu``,
which stays beside it as the reference.  Ported so far, each for one
SCA: L1 -> L2 calibration (:mod:`.pipeline.l1_to_l2`) and sim -> L1
(:mod:`.pipeline.sim_to_l1`); the kernels that the JAX package wrote in
Pallas for the TPU are hand-written CUDA C++ for Hopper (``csrc/``),
built at first use by :mod:`.ops.cuda_build`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
