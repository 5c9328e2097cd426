"""romanimpreprocess_tpu_torch — Roman WFI image preprocessing in PyTorch.

The PyTorch/CUDA port of the JAX package ``romanimpreprocess_tpu``,
which stays beside it as the reference.  This slice covers L1 -> L2
calibration of one SCA (:mod:`.pipeline.l1_to_l2`); the kernels that
the JAX package wrote in Pallas for the TPU are hand-written CUDA C++
for Hopper (``csrc/``), built at first use by :mod:`.ops.cuda_build`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
