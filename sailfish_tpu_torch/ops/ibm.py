"""Immersed-boundary method: Lagrangian particles coupled to the fluid.

Port of ``sailfish_tpu/ops/ibm.py``: particles tethered to reference
positions by Hookean springs spread their forces onto the grid with the
phi_2 kernel (support 2, w = prod_a (1 - |x_a - X_a|)), the step runs with
that force field, and the particles advance by the interpolated fluid
velocity (Euler). Like the JAX package's, this is plain tensor code on
the state's device (the JAX package runs it on XLA: it has no TPU kernel,
so the port has no CUDA kernel for it, and the runner keeps it on the
torch engine).

The spreading gives the same bits run after run on every device: each
node sums its contributions sequentially in the JAX scatter's order
(corner by corner, particles in order within a corner), one rank of
contributions at a time, never through atomics.
"""

from __future__ import annotations

import itertools

import torch

from sailfish_tpu_torch.ops import collide as co
from sailfish_tpu_torch.ops import step as st


def _corner_weights(pos, dim):
    """For positions (dim, Np) the 2^dim corners around each particle as
    (index tuple, weight): the indices in array-axis order ([z,] y, x),
    positions being (x, y[, z]); the weights the phi_2 tensor product
    (``sailfish_tpu/ops/ibm.py:29-47``)."""
    base = [torch.floor(pos[a]).to(torch.int64) for a in range(dim)]
    frac = [pos[a] - base[a].to(pos.dtype) for a in range(dim)]
    out = []
    for corner in itertools.product((0, 1), repeat=dim):
        w = None
        idx = []
        for a, c in enumerate(corner):
            wa = frac[a] if c else (1.0 - frac[a])
            w = wa if w is None else w * wa
            idx.append(base[a] + c)
        out.append((tuple(reversed(idx)), w))
    return out


def _clipped(idx, shape):
    """Corner indices clamped to the domain (particles should stay
    inside)."""
    return tuple(torch.clamp(i, 0, n - 1) for i, n in zip(idx, shape))


def _flat(idx, shape):
    """Array-order index tuple -> flat node index."""
    flat = idx[0]
    for i, n in zip(idx[1:], shape[1:]):
        flat = flat * n + i
    return flat


def spread_forces(pos, ref_pos, stiffness, shape, dtype):
    """Hookean spring forces spread onto the grid -> (dim, *shape)
    (``sailfish_tpu/ops/ibm.py:50-61``). Each node's contributions are
    added in the JAX scatter's order, sequentially from 0: the
    (corner, particle) entries are sorted stably by node and summed one
    rank of each node's segment at a time (a rank writes every node at
    most once), so two runs on any device give the same bits."""
    dim = pos.shape[0]
    nodes = 1
    for n in shape:
        nodes *= n
    spring = -stiffness[None] * (pos - ref_pos)     # (dim, Np)
    corners = _corner_weights(pos, dim)
    # entries in the scatter's order: corner-major, particles within
    node = torch.cat([_flat(_clipped(idx, shape), shape)
                      for idx, _w in corners])
    vals = torch.cat([torch.stack([w * spring[a] for a in range(dim)])
                      for _idx, w in corners], dim=1)
    node, order = torch.sort(node, stable=True)
    vals = vals[:, order]
    k = node.shape[0]
    pos_k = torch.arange(k, device=node.device)
    start = torch.ones(k, dtype=torch.bool, device=node.device)
    start[1:] = node[1:] != node[:-1]
    first = torch.cummax(torch.where(start, pos_k, 0), dim=0).values
    rank = pos_k - first
    acc = torch.zeros((dim, nodes + 1), dtype=dtype, device=pos.device)
    spare = torch.full_like(node, nodes)
    for r in range(int(rank.max()) + 1 if k else 0):
        # the entries of rank r, the others sent to the spare column
        sel = rank == r
        dst = torch.where(sel, node, spare)
        acc.index_copy_(1, dst, acc.index_select(1, dst)
                        + torch.where(sel[None], vals, 0.0))
    return acc[:, :nodes].reshape((dim,) + tuple(shape))


def interpolate_velocity(u, pos):
    """Fluid velocity at the particle positions -> (dim, Np)
    (``sailfish_tpu/ops/ibm.py:64-74``): the corners' weighted samples
    summed in corner order."""
    dim = pos.shape[0]
    shape = u.shape[1:]
    vel = None
    for idx, w in _corner_weights(pos, dim):
        idx = _clipped(idx, shape)
        sample = torch.stack([u[(a,) + idx] for a in range(dim)])
        contrib = w[None] * sample
        vel = contrib if vel is None else vel + contrib
    return vel


class IBMStepBuilder(st.StepBuilder):
    """Fluid step + particle update on the torch engine. State = (f,
    positions), positions (dim, Np) in (x, y[, z]) order
    (``sailfish_tpu/ops/ibm.py:79-126``)."""

    def __init__(self, grid, maps, *, ref_positions, stiffness, **kwargs):
        super().__init__(grid, maps, **kwargs)
        self.ref_pos = torch.as_tensor(ref_positions, dtype=self.dtype,
                                       device=self.device)
        self.stiffness = torch.as_tensor(stiffness, dtype=self.dtype,
                                         device=self.device)

    def build(self):
        """step((f, pos), it) in the JAX step's sequence
        (``sailfish_tpu/ops/ibm.py:93-121``): spread the spring forces;
        stream, fix missing, macro and BC solves; accel = F / rho plus the
        body force (at iteration ``it``); BGK towards feq(rho, u + a/2)
        plus the Guo term; dry nodes, dry walls, the TMS shift and the Guo
        density overlay; the particles moved by u + a/2 interpolated at
        their positions."""
        shape = self.maps.type_map.shape
        grid = self.grid

        def step(state, it=0):
            f, pos = state
            force = spread_forces(pos, self.ref_pos, self.stiffness, shape,
                                  self.dtype)
            instances = self.instances_at(it)
            fs, target, rho, u = self.stream_phase(f, it,
                                                   instances=instances)
            fs2 = self._pre_collision_bc(fs, rho, u)
            # the spring forces are force densities: accel = F / rho
            accel = force / rho[None]
            body = self.force_at(it)
            if body is not None:
                accel = accel + body
            u_eq = u + 0.5 * accel
            feq = self.feq(rho, u_eq)
            fpost = fs2 + self.tau_inv * (feq - fs2)
            fpost = fpost + co.guo_force_terms(grid, u_eq, accel,
                                               self.tau_inv, rho)
            if self.has_dry:
                fpost = torch.where(self.wet[None], fpost, fs2)
            fpost = self._post_collision(fs2, fpost)
            fpost = st.apply_tms(grid, fpost, rho, u, self.tms, target,
                                 self._feq)
            fpost = st.guo_density_overlay(grid, fs, fpost, instances,
                                           self.tau_inv, self._feq)
            vel = interpolate_velocity(u + 0.5 * accel, pos)
            return (fpost, pos + vel)

        return step

    def macro_fields(self, state, it=0):
        f, _pos = state
        return super().macro_fields(f, it)
