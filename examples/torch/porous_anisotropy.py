#!/usr/bin/env python
"""Flow anisotropy in stochastically generated porous media, on the
PyTorch/CUDA port (twin of examples/porous_anisotropy.py; on a CUDA device
the full bounce-back matrix and the constant Guo force run in the
single-fluid kernel's forcing mode).

Run from the repository root:
    PYTHONPATH=. python examples/torch/porous_anisotropy.py --max_iters=2000

Counterpart of the reference's showcases/porous_anisotropy (code for
Matyka & Koza-style studies, arXiv:1305.3426): a periodic body-force
flow is driven through a random solid matrix and the Darcy
permeability is measured from the superficial velocity,

    k = <u_a> * nu / g        (lattice units, rho ~ 1),

where <u_a> is the flow-direction velocity averaged over the WHOLE
domain (fluid + solid, the superficial/Darcy velocity) and g is the
body acceleration. Anisotropic media are produced by smoothing white
noise with a direction-dependent Gaussian kernel and thresholding to
the target porosity: grains elongated along z make k_z > k_x.

Run with --flow_axis=x and --flow_axis=z on the same --seed to
quantify the anisotropy ratio. --geometry=channel replaces the random
matrix with parallel plates (gap H), whose exact permeability
k = H^2 / 12 validates the measurement end to end
(tests/test_physics.py::test_porous_channel_permeability).
"""

import numpy as np

from sailfish_tpu_torch.controller import LBSimulationController
from sailfish_tpu_torch.geo import LBGeometry3D
from sailfish_tpu_torch.models.base import LBForcedSim
from sailfish_tpu_torch.models.single import LBFluidSim
from sailfish_tpu_torch.node_type import NTFullBBWall
from sailfish_tpu_torch.subdomain import Subdomain3D

AXES = {'x': 0, 'y': 1, 'z': 2}


def anisotropic_medium(shape_zyx, porosity, stretch, seed):
    """Boolean solid mask: anisotropically smoothed white noise
    thresholded so that the FLUID fraction equals ``porosity``.
    ``stretch`` > 1 elongates grains along z."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    field = rng.standard_normal(shape_zyx)
    base = 2.0
    field = gaussian_filter(field, (base * stretch, base, base),
                            mode='wrap')
    cut = np.quantile(field, 1.0 - porosity)
    return field >= cut   # top `porosity` fraction stays fluid


class PorousDomain(Subdomain3D):
    def _solid_mask(self, hx):
        cfg = self.config
        shape = hx.shape  # (z, y, x)
        if cfg.geometry == 'channel':
            # parallel plates normal to y: walls at the y edges, a
            # fluid gap of H = gy - 2 in between (exact k = H^2 / 12)
            solid = np.zeros(shape, dtype=bool)
            solid[:, 0, :] = True
            solid[:, -1, :] = True
            return solid
        return ~anisotropic_medium(shape, cfg.porosity, cfg.stretch,
                                   cfg.seed or 1)

    def boundary_conditions(self, hx, hy, hz):
        self.set_node(self._solid_mask(hx), NTFullBBWall)

    def initial_conditions(self, sim, hx, hy, hz):
        sim.rho[:] = 1.0


class PorousSim(LBFluidSim, LBForcedSim):
    subdomain = PorousDomain

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--porosity', type=float, default=0.7,
                           help='fluid volume fraction of the medium')
        group.add_argument('--stretch', type=float, default=3.0,
                           help='grain elongation along z (1 = '
                                'isotropic)')
        group.add_argument('--flow_axis', type=str, default='z',
                           choices=sorted(AXES),
                           help='body-force direction')
        group.add_argument('--accel', type=float, default=1e-5,
                           help='body acceleration g')
        group.add_argument('--geometry', type=str, default='random',
                           choices=['random', 'channel'],
                           help='channel = parallel plates '
                                '(k = H^2/12 validation case)')

    @classmethod
    def update_defaults(cls, defaults):
        defaults.update({
            'grid': 'D3Q19',
            'lat_nx': 64, 'lat_ny': 64, 'lat_nz': 64,
            'periodic_x': True, 'periodic_y': True, 'periodic_z': True,
            'visc': 1.0 / 6.0,
            'max_iters': 20000,
            'every': 2000,
            'seed': 12345,
        })

    def __init__(self, config):
        super().__init__(config)
        force = [0.0, 0.0, 0.0]
        force[AXES[config.flow_axis]] = config.accel
        self.add_body_force(tuple(force))

    def permeability(self, runner):
        """Darcy permeability from the current state (lattice units)."""
        cfg = self.config
        runner._fields_to_host()
        u = [np.asarray(self.vx), np.asarray(self.vy),
             np.asarray(self.vz)][AXES[cfg.flow_axis]]
        # superficial (Darcy) velocity: average over the WHOLE volume
        u_sup = float(np.mean(u))
        return u_sup * cfg.visc / cfg.accel

    def after_step(self, runner):
        cfg = self.config
        if not cfg.quiet and self.iteration % cfg.every == 0:
            k = self.permeability(runner)
            print(f'it={self.iteration}  k_{cfg.flow_axis} = {k:.4f} '
                  f'(lattice units)')


if __name__ == '__main__':
    LBSimulationController(PorousSim, LBGeometry3D).run()
