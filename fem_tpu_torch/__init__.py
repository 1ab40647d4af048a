"""fem_tpu_torch — the all-mapping short-read engine on PyTorch and CUDA.

The port of `fem_tpu` to one NVIDIA Hopper GPU. It shares the
framework-free modules of `fem_tpu` (config, core, io, index, golden,
native, sim) and never imports JAX. Layout:

  ops/         the device stages as plain functions on tensors
  csrc/        the hand-written CUDA kernels (banded Myers, filter tail)
  kernels.py   builds csrc/*.cu with nvcc on first use and loads them
  pipeline/    MappingEngine: batches, device step, host emission
"""

__version__ = "0.1.0"
