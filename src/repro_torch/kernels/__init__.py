"""Hand-written CUDA kernels of the port, one package per JAX kernel package."""
