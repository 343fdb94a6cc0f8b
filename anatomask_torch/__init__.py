"""PyTorch/CUDA port of anatomask_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's structure (models/, ssl/, inference/, plans/,
training/, ops/). Every stride-1 3x3x3 convolution runs through the
hand-written CUDA kernel in csrc/conv3x3.cu and the statistics of every
instance norm through csrc/moments.cu; entry points run on CUDA unless the
caller passes device="cpu", where each kernel's plain PyTorch version runs
instead.
"""
