"""PyTorch/CUDA port of the AD-Census stereo engine (``adcensus_tpu``).

Plain stages are PyTorch tensor code; the four stages that the JAX
package writes as Pallas kernels run as hand-written CUDA kernels on an
NVIDIA Hopper card (``adcensus_torch/csrc``), with a plain PyTorch version
of each beside it for CPU tensors.
"""
