"""PyTorch + CUDA port of boxer_tpu for NVIDIA Hopper (BoxeR-2D inference
and training step).

The JAX package `boxer_tpu` is the reference this port is held against; this
package imports neither it nor jax. Layout mirrors it: `ops/` (sampling ops
and the CUDA kernels' wrappers, sources in `csrc/`), `nn/` (incl. the
matcher), `models/`, `criterion/`, `optim/`, `parallel/` (the train step),
`dataset/` (synthetic batches), `evaluate/`, `utils/`.
"""
