"""Mamba2 SSD chunked scan: the hand-written CUDA kernel (``kernel``), its
plain version (``ref``) and the split form's decay-weighted C (``ops``)."""
