"""fem_tpu_torch — the all-mapping short-read engine on PyTorch and CUDA.

The port of `fem_tpu` to one NVIDIA Hopper GPU. It stands on its own
files: it imports neither JAX nor `fem_tpu`, and keeps its own copy of
every framework-free module it uses, under the same names. Layout:

  config.py    FemArgs
  core/ io/ index/ sim.py stats.py
               encoding, FASTA/FASTQ/SAM, the hash index, the read
               simulator, the five mapping counters
  native/      C++ SAM emitter, exact CPU mapper, FASTQ reader and the
               fem_baseline oracle (native/src/), built with g++ on first use
  ops/         the device stages as plain functions on tensors, and the
               device step over them (ops/step.py)
  csrc/        the hand-written CUDA kernels (occurrence slab, filter tail,
               banded Myers)
  kernels.py   builds csrc/*.cu with nvcc on first use and loads them
  parallel/    device grids: the step over a grid's cells, the sharded
               index, processes
  pipeline/    MappingEngine: batches, step programs, host emission

Imports run one way: pipeline/ -> parallel/ -> ops/ -> kernels.py.

Everything built goes to build/fem_tpu_torch/ at the repository root.
"""

__version__ = "0.1.0"
