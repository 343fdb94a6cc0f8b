"""PyTorch/CUDA port of anatomask_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's structure (models/, ssl/, ops/). Every stride-1
3x3x3 convolution runs through the hand-written CUDA kernel in
csrc/conv3x3.cu; entry points run on CUDA unless the caller passes
device="cpu", where each kernel's plain PyTorch version runs instead.
"""
