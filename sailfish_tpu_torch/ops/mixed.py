"""Mixed-precision storage: int16 fixed-point distributions, fp32 math.

Port of ``sailfish_tpu/ops/mixed.py`` (``--precision=mixed``). Each
distribution is stored as a 16-bit code of its normalized deviation from
rest,

    q_i = round((f_i / w_i - 1) / s),   s = mixed_range / 32767,

and every arithmetic operation runs in fp32 on the dequantized values
f_i = w_i + (w_i s) q_i. A D3Q19 step then moves 2·19·2 + 1 = 77 B per node
instead of 153 B (D2Q9: 37 B instead of 73 B); the grid's absolute error is
a uniform w_i s / 2.

Exactness: ``quant(dequant(q)) == q`` for every int16 code and every
direction (|fl(w + ws q) - w - ws q| <= w 2^-24, under 1e-3 of a code
step), so a state round-trips through the public fp32 layout (chunk
boundaries, checkpoints, output) without drift. The constants are the JAX
module's to the bit: ``w``, ``ws = fp32(w s)`` and ``inv_ws = 1 / ws`` are
computed in numpy float32 as it computes them, ``w + ws q`` and
``(f - w) inv_ws`` are separate operations (no fused multiply-add), and
rounding is to nearest even (``torch.round``, as ``jnp.round``) followed by
a clamp to [-32768, 32767]. The CUDA kernel's in-register conversions
(``csrc/lbm_common.cuh``) use the same constants and roundings.
"""

from __future__ import annotations

import numpy as np
import torch

#: int16 code range; +-32767 (-32768 is produced only by clipping, keeping
#: the grid symmetric)
QMAX = 32767.0

#: default normalized-deviation range (``--mixed_range``)
DEFAULT_RANGE = 0.5


class MixedScales:
    """Per-distribution quantization constants of ``grid``, all fp32.

    ``w``: lattice weights; ``ws`` = w * s (one code step in f units);
    ``inv_ws`` = 1 / ws; lists of python floats, one per direction, each
    exactly representable in fp32."""

    def __init__(self, grid, range_=DEFAULT_RANGE):
        self.range = float(range_)
        s = np.float32(self.range / QMAX)
        w = np.asarray(grid.weights, np.float32)
        self.w = [float(v) for v in w]
        self.ws = [float(np.float32(v * s)) for v in w]
        self.inv_ws = [float(np.float32(1.0) / np.float32(v * s))
                       for v in w]

    def _cols(self, values, ndim, device):
        return torch.tensor(values, dtype=torch.float32,
                            device=device).reshape((-1,) + (1,) * (ndim - 1))

    # -- per direction ---------------------------------------------------

    def dequant_i(self, i, q):
        """int16 codes of direction ``i`` -> fp32 values."""
        w = torch.tensor(self.w[i], dtype=torch.float32, device=q.device)
        ws = torch.tensor(self.ws[i], dtype=torch.float32, device=q.device)
        return w + ws * q.to(torch.float32)

    def quant_i(self, i, f):
        """fp32 values of direction ``i`` -> int16 codes."""
        w = torch.tensor(self.w[i], dtype=torch.float32, device=f.device)
        inv = torch.tensor(self.inv_ws[i], dtype=torch.float32,
                           device=f.device)
        return _codes((f - w) * inv)

    # -- whole state, Q on axis 0 ----------------------------------------

    def dequant(self, q):
        """(Q, ...) int16 -> fp32."""
        w = self._cols(self.w, q.dim(), q.device)
        ws = self._cols(self.ws, q.dim(), q.device)
        return w + ws * q.to(torch.float32)

    def quant(self, f):
        """(Q, ...) fp32 -> int16 codes."""
        w = self._cols(self.w, f.dim(), f.device)
        inv = self._cols(self.inv_ws, f.dim(), f.device)
        return _codes((f - w) * inv)

    def snap(self, f):
        """``dequant(quant(f))``: ``f`` on the int16 grid, fp32."""
        return self.dequant(self.quant(f))


def _codes(d):
    """Round to nearest even, clamp to the int16 range, convert."""
    return torch.clamp(torch.round(d), -32768.0, QMAX).to(torch.int16)
