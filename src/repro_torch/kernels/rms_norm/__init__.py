"""The row mean square of RMSNorm: a hand-written CUDA kernel (``kernel``)
and its plain version (``ref``)."""
