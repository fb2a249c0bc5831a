"""PyTorch/CUDA port of flux_generator_tpu for one NVIDIA Hopper card.

The JAX package `flux_generator_tpu` stays the numerical reference; this
package mirrors its layout (ops/, ops/kernels/, csrc/, models/, pipelines/,
io/, runtime/) and keeps its parameter-tree layout, so every module here has
a counterpart there. Nothing in this package imports jax.
"""
