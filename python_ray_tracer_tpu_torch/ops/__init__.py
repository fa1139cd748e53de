"""Tensor ops and the CUDA bounce kernels' wrappers."""
