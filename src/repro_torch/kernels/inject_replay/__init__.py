"""Circuit-replay AMR matmul: the hand-written CUDA kernel (``kernel``),
its plain version (``ref``) and the index-level ops (``ops``)."""
