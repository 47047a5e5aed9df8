"""PyTorch + CUDA port of boxer_tpu for NVIDIA Hopper (BoxeR-2D and
BoxeR-3D inference, training step, trainer and CLI).

The JAX package `boxer_tpu` is the reference this port is held against; this
package imports neither it nor jax. Layout mirrors it: `ops/` (sampling ops
and the CUDA kernels' wrappers, sources in `csrc/`), `nn/` (incl. the
matcher), `models/`, `criterion/`, `optim/`, `parallel/` (the train step),
`dataset/` (the COCO and Waymo tasks, the loader), `evaluate/`,
`trainer/`, `tools/`, `utils/`.
"""
