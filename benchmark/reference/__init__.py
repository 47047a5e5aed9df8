"""The benchmark's plain reference of BoxeR-2D instance segmentation, the
inference forward that the segm cell serves.

Plain PyTorch: the sampling ops are bilinear gathers and weighted sums,
the dense attention its plain math. It imports nothing of the port, of JAX
or of the JAX package, so a later change to the port cannot move it.
Parameter names are the port's, so the benchmark hands both sides one
state dict. `control.py` is the same reference computed in fp8, the
precision below the configuration's bf16; `follow.py` how it follows the
program's discrete choices.
"""
