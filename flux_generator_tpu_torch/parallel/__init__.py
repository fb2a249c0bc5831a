"""Multi-process parallelism: process groups, meshes, tensor-parallel
sharding, GPipe pipeline parallelism and ring attention (counterpart of
flux_generator_tpu/parallel/)."""
