"""The training step: masked BCE loss, Adam with the LambdaLR schedule and
per-module LR scales, global-norm clip, gradient accumulation and dropout
(counterpart of the JAX package's ``training/``)."""
