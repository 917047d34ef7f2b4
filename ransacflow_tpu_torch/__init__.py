"""PyTorch + CUDA port of the RANSAC-Flow serving path.

The JAX package `ransacflow_tpu` is the reference; this package imports
neither it nor JAX. Layout mirrors it (`ops/`, `models/`, `pipeline/`,
`utils/`), with the hand-written CUDA kernels in `kernels/` and `csrc/`.
"""
