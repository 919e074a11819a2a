"""PyTorch/CUDA port of the AD-Census stereo engine (``adcensus_tpu``).

Plain stages are PyTorch tensor code; the stages that the JAX package
writes as Pallas kernels, and its two in-place refinement scans (the
raster-order median and discontinuity adjustment), run as hand-written
CUDA kernels on an NVIDIA Hopper card (``adcensus_torch/csrc``), with a
plain PyTorch version of each beside it for CPU tensors. ``cli.py`` is
the command-line entry point.
"""
