"""AMR-MUL matmul: hand-written CUDA kernels (``kernel``), their plain
versions (``ref``) and the float op (``ops``: quantize -> kernel -> rescale)."""
