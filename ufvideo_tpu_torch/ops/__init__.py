"""Kernels and plain tensor ops. Each kernel wrapper runs its hand-written
CUDA kernel on CUDA tensors and its plain PyTorch version on CPU tensors."""
