"""Image readers and writers (counterpart of anatomask_tpu/imageio/): pure
numpy, with nnU-Net's backend names as aliases."""
