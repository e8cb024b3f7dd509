"""The decay-weighted C panel of the SSD scan's split form.

``decay_weighted_c`` is the A operand of the ``ssm.scan`` readout in split
mode, computed by the same torch code whichever route the scan took
(``kernel.ssd_scan``), so the kernel and the plain version feed the
numerics seam the same panel.  The JAX package's ``ssd_mixer`` (group to
head expansion before its kernel) has no counterpart: the port's kernel
reads each head's B/C group itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ref import chunk_cumsum


def decay_weighted_c(dt: torch.Tensor, a_log: torch.Tensor, c: torch.Tensor, chunk: int,
                     n_heads: int) -> torch.Tensor:
    """``C_h * exp(cum)`` per (batch, chunk, head): (B, nc, H, Q, N) float32,
    the rows that read out the state before each chunk; rows past S are zero."""
    B, S, G, N = c.shape
    cum = chunk_cumsum(dt, a_log, chunk)                        # (B, nc, Q, H)
    nc = cum.shape[1]
    cp = F.pad(c.float(), (0, 0, 0, 0, 0, -S % chunk))
    ch = cp.reshape(B, nc, chunk, G, N).repeat_interleave(n_heads // G, dim=3)
    return (ch * torch.exp(cum)[..., None]).permute(0, 1, 3, 2, 4)
