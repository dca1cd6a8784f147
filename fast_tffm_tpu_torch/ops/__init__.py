"""FM interaction ops: the plain PyTorch version and the CUDA kernel wrapper."""
