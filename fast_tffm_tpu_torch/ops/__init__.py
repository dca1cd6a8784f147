"""FM interaction ops: plain PyTorch versions and CUDA kernel wrappers."""
