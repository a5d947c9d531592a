"""PyTorch + CUDA port of the serving system, beside the JAX package.

It imports torch and numpy, never jax and nothing of `repro`.  The layout
mirrors `repro`: `configs/`, `models/`, `kernels/`, `serving/`, plus
`params.py`.  Entry points run on the CUDA device unless the caller
passes `device="cpu"`; the hand-written Hopper kernels live in
`kernels/csrc/` and are built by `kernels.ops` at first use.
"""
