"""PyTorch/CUDA port of anatomask_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's structure (models/, ssl/, inference/, plans/,
training/, ops/, planning/, postprocessing/, ensembling/, evaluation/,
cli.py). Every stride-1 3x3x3 convolution runs through the hand-written
CUDA kernels in csrc/conv3x3.cu and csrc/zslab_conv.cu and the statistics
of every instance norm through csrc/moments.cu; entry points run on CUDA
unless the caller passes device="cpu" (-device cpu on the command line),
where each kernel's plain PyTorch version runs instead.
"""
