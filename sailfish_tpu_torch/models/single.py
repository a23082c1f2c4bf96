"""Single-fluid models of the port (``LBFluidSim``).

The JAX package's ``LBFluidSim`` (``sailfish_tpu/models/single.py:17-153``)
is numpy-only at import time: its options, fields and host-side field
plumbing are reused by subclassing. The port replaces the three methods
that touch device arrays: the initial state, the device -> host field copy
and the step builder. The other sim classes (entropic, free surface, IBM,
Shan-Chen) are still to be ported.
"""

from __future__ import annotations

import numpy as np
import torch

from sailfish_tpu.models import single as _single
from sailfish_tpu.models.base import LBForcedSim


class LBFluidSim(_single.LBFluidSim):
    """Single-phase fluid on torch tensors."""

    def make_initial_state(self, builder, dtype):
        """Equilibrium at the user-set (rho, u), on the builder's device."""
        rho = torch.as_tensor(self.rho, dtype=dtype, device=builder.device)
        u = torch.as_tensor(np.stack(self.velocity_components()),
                            dtype=dtype, device=builder.device)
        return builder.feq(rho, u)

    def update_host_fields(self, macro):
        """Copy device macro fields into the host-side float64 arrays."""
        rho, u = macro
        self.rho[...] = rho.detach().cpu().numpy().astype(np.float64)
        comps = self.velocity_components()
        for a in range(self.dim):
            comps[a][...] = u[a].detach().cpu().numpy().astype(np.float64)

    def make_step_builder(self, maps, dtype, device):
        from sailfish_tpu_torch.ops.step import StepBuilder
        cfg = self.config
        body_force = None
        force_model = 'guo'
        if isinstance(self, LBForcedSim):
            body_force = self.body_force(0)
            force_model = getattr(cfg, 'force_implementation', 'guo')
        smag = (cfg.smagorinsky_const
                if cfg.subgrid == 'les-smagorinsky' else 0.0)
        kwargs = self.step_builder_kwargs()
        if cfg.precision == 'mixed':
            kwargs.setdefault('storage', 'int16')
        if getattr(cfg, 'entropic_equilibrium', False):
            kwargs.setdefault('equilibrium', 'elbm')
        return StepBuilder(
            self.grid, maps,
            model=cfg.model,
            visc=cfg.visc,
            incompressible=cfg.incompressible,
            smagorinsky=smag,
            body_force=body_force,
            force_model=force_model,
            dtype=dtype,
            device=device,
            **kwargs)
