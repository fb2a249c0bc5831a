"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and a launch counter (see flash_attention.py, int4_matmul.py)."""
