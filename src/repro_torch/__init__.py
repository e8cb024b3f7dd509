"""AMR-MUL on PyTorch and CUDA: the port of the JAX package ``repro``.

Mirrors the JAX package's module names (``core``, ``numerics``,
``kernels``, ``configs``, ``models``, ``train``, ``serve``, ``launch``) and
imports nothing of it.  Entry points take ``device="cuda"`` by default and
raise when CUDA is absent unless the caller passes ``device="cpu"``.
"""
