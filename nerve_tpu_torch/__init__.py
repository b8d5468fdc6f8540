"""nerve_tpu_torch: the PyTorch / CUDA port of nerve_tpu for NVIDIA Hopper.

It mirrors the module layout of the JAX package ``nerve_tpu`` (the
reference it is held against) and keeps its NHWC layout at every public
function. It imports neither JAX nor ``nerve_tpu``. The Pallas kernels of the
JAX package are hand-written CUDA kernels here (``csrc/``), built with
``nvcc`` at their first launch.
"""
