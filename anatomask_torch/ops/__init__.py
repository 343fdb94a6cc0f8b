"""Hand-written kernels, their plain versions and the build helper."""
