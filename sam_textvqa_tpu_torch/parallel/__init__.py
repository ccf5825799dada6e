"""Data-parallel training across processes (JAX package ``parallel/``):
one process per GPU under ``torchrun``, gradients all-reduced by
``DistributedDataParallel``."""
