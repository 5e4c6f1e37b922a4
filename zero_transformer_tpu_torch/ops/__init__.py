"""Attention ops and the CUDA kernel wrappers."""
