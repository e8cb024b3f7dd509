"""The paper's arithmetic for int8 operands, numpy only.

``mrsd``, ``cells``, ``ppgen`` and ``reduction`` are copies of the JAX
package's modules of the same names, and ``dse.column`` holds the part of
its column search that ``reduction.build_schedule`` calls.  The port keeps
its own copies so that it never imports the JAX package; the parity tests
hold the tables built here bit for bit against the JAX package's.
``lut`` builds the 256x256 product tables and the low-rank error factors
from them and keeps the per-device tensors the kernels read.
"""
