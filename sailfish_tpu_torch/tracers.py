"""Passive tracer particles advected by the flow.

Port of ``sailfish_tpu/tracers.py`` (the reference's
``templates/tracers.mako``): Euler advection by the fluid velocity at the
node below each tracer, with periodic wrapping. The velocity is read
through the runner's ``macro_fields`` (the path of the output fields), so
the tracers move the same on the torch engine, on the kernel engine
(whose state lives in the kernel's buffers), under int16 storage and on a
mesh (the sharded step's gathered fields).
"""

from __future__ import annotations

import numpy as np
import torch


class TracerParticles:
    """Tracks N passive tracers on the device.

    positions: (dim, N) array in (x, y[, z]) order, lattice units, kept
    as an fp32 (dim, N) tensor, on the velocity field's device from the
    first ``update`` on; ``domain_shape`` is (.., z, y, x).
    """

    def __init__(self, positions, domain_shape):
        pos = np.asarray(positions, dtype=np.float64)
        if pos.ndim != 2:
            raise ValueError(f'positions must be (dim, N); got {pos.shape}')
        self.dim = pos.shape[0]
        # sizes per (x, y, z) component
        self.sizes = tuple(reversed(domain_shape))
        self.positions = torch.as_tensor(pos, dtype=torch.float32)

    def advect(self, u):
        """One Euler step of the positions by the velocity field ``u``
        (dim, [z,] y, x): x += u(trunc(x)), the node index clamped to the
        domain, then wrapped periodically (``sailfish_tpu/tracers.py
        :28-43``). Returns the new positions."""
        pos = self.positions.to(u.device)
        # u is (dim, [z,] y, x): index with the components reversed
        idx = tuple(reversed([torch.clamp(pos[a].to(torch.int64), 0, n - 1)
                              for a, n in enumerate(self.sizes)]))
        vel = torch.stack([u[a][idx] for a in range(self.dim)])
        new = pos + vel
        rows = []
        for a, n in enumerate(self.sizes):
            n = float(n)
            rows.append(torch.where(new[a] >= n, new[a] - n,
                                    torch.where(new[a] < 0.0, new[a] + n,
                                                new[a])))
        self.positions = torch.stack(rows)
        return self.positions

    def update(self, runner):
        """Advance the tracers by one (output-interval) step using the
        current velocity field; of a mixture, the last component's
        (``sailfish_tpu/tracers.py:45-53``)."""
        _rho, u = runner.macro_fields()
        if isinstance(u, (tuple, list)):
            u = u[-1]
        with torch.no_grad():
            return self.advect(u)

    def to_numpy(self):
        return self.positions.detach().cpu().numpy()

    # checkpoint protocol (sim.register_checkpoint_object)
    def checkpoint_state(self):
        return {'positions': self.to_numpy()}

    def restore_checkpoint_state(self, state):
        self.positions = torch.as_tensor(
            np.asarray(state['positions']), dtype=torch.float32,
            device=self.positions.device)
