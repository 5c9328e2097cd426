"""The benchmark's plain reference of one SCA's L1 -> L2 calibration.

Frozen copies of the port's plain PyTorch modules at commit 30ea5db,
which import nothing of the program: ``dqflags`` and ``ops/{legendre,
saturation, refsub, linearity, ipc, ramp, likely, sky, mask}``, with their imports made
local; ``sky`` without the CUDA block median, and with the comparison's
control (:func:`.sky.lowered_precision`: float32 matrix operands rounded
to TF32, the cube that enters the ramp fit rounded to bfloat16);
``mask`` without its file conversion.  :mod:`.l2` is the plain path of
``pipeline/l1_to_l2.py`` from the staged inputs to the L2 arrays.
"""
