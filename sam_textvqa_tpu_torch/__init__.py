"""SA-M4C TextVQA in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package ``sam_textvqa_tpu`` (which stays the reference).
Module names mirror the JAX package; the three Pallas kernels of the
serving path are CUDA C++ under ``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use and bound through ctypes (``ops/cuda_build.py``).
"""
