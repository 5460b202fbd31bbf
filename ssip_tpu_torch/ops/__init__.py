"""Tensor ops: the PIL-exact extraction preprocess and its CUDA kernel."""
