"""ngsbits_tpu_torch — the PyTorch/CUDA port of ngsbits_tpu.

The device layer of the JAX package, rewritten for torch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a), and its own copy of the host code
that the ported tools need (FASTQ decode and encode, qcML writer, CLI
framework), trimmed to what those tools use. This package imports neither jax
nor ngsbits_tpu.

Layout:
  csrc/      CUDA C++ kernels, built with nvcc at first use (ops/_build.py)
  native/    C++ host library (FASTQ decode/encode), built with g++ at first
             use (io/native.py)
  core/      report substrate: histogram, plots, qcML writer, basic statistics
  io/        FASTQ, BAM, VCF, GSvar, FASTA, BGZF and tabix readers and writers
  ops/       kernel wrappers with their plain torch versions, stream step
  parallel/  the mesh: a torch.distributed process group, sharded steps
  qc/        device-backed accumulators and engines
  tools/     CLI tools whose device route is ported
  utils/     device choice, prefetch, progress lines, synthetic input
  entry.py   entry() and dryrun_multichip(n)
"""

# the qcML writer prints both; they match the JAX package's, so reports are
# byte-identical
__version__ = "0.1.0"
APP_NAME = "ngsbits-tpu"
