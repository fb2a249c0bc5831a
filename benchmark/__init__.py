"""The benchmark of the PyTorch and CUDA port (`flux_generator_tpu_torch`):
`python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1`
from the root of a checkout, on a machine with the card the cell asks for."""
