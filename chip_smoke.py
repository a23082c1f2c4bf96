#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``sailfish_tpu_torch/ops/csrc`` (one
``nvcc`` per source, in parallel) and holds each against its plain PyTorch
version on the card from seeded random states:

* the single-fluid stream-and-collide kernel (``ops/lbm_step``) against
  ``step_reference`` on lid-driven cavities and on ducts with x-normal
  velocity/density faces of each native BC pair;
* the same kernel with varying BC rows (native BCs that read each node's
  own rho and u from the parameter array of ``ops/bc_patch``; launches
  counted as ``lbm_step_vary_<grid>``) against
  ``step_reference`` on channels whose velocity inlet carries a parabolic
  profile, for each native BC pair and inlet normal to z, y and x (D3Q19
  128x64x64) and to y and x (D2Q9 1024^2), the inlet face thinned so it
  has holes, 200 steps: with the outlet at the other end, every face the
  kernel's BC dispatch has a case for;
* the same kernel's forcing mode (a constant body force by the Guo,
  exact-difference or velocity-shift model; launches counted as
  ``lbm_step_force_<grid>``) against ``step_reference`` with the same
  force, 200 steps: the force-driven flows past a sphere (D3Q19
  128x64x64) and a cylinder (D2Q9 1024x512) for each model, the
  force-driven pipe (poiseuille_3d 64^3), and channels under a force with
  regularized and Zou-He faces normal to x, y and z, whose BC nodes take
  the force;
* the same kernel's wall rows (launches counted as ``lbm_step_wall_<grid>``)
  against ``step_reference``, 200 steps at 64^3 / 1024^2: half-way boxes
  closed on every axis (edges, corners, a block of excluded nodes) without
  a force and under each force model, TMS channels (the scene of
  tests/test_bc_catalog.py:147), slip faces normal to each axis, half-way
  walls beside a varying native inlet; each asserting the walls moved the
  state away from full bounce-back;
* its time-dependent rows (``lbm_step_dyn_<grid>``: values written before
  each launch) from a nonzero iteration: time-only density rows
  (womersley), a time series, a time-only force
  (poiseuille_pulsatile --drive=force) and a space- and time-dependent
  inlet rewritten into the parameter array (poiseuille_sa), each asserting
  the state moved against the same steps at t = 0;
* its collision-model mode (MRT/TRT, BGK at the Smagorinsky LES rate, the
  incompressible equilibrium; launches counted as ``lbm_step_mrt_<grid>``,
  ``lbm_step_les_<grid>``, ``lbm_step_incomp_<grid>`` unless wall rows or
  per-step values rank first) against ``step_reference`` with the same
  model, 200 steps, every instantiation at least once: each model
  unforced and under each force model on the forced sphere (128x64x64) and
  cylinder (1024x512), on half-way and TMS boxes and slip faces, on
  native-BC channels with faces normal to x, y and z, and with the
  time-only rows of womersley 64^3; each asserting the model moved the
  state away from BGK;
* the Shan-Chen density pre-pass and K-component step (``ops/sc_multi``)
  against ``rho_reference`` and ``sc_multi_reference`` on the binary
  separation scenes (periodic 2D and 3D, and the walled 3D box), and in
  every mode of the step (launches counted as ``sc_multi_force_<grid>``,
  ``sc_multi_k3_<grid>``, ``sc_multi_k3_force_<grid>``): Rayleigh-Taylor
  (a Guo force on one component), the walled 3D box with a Guo force on
  each component, the ternary drops (K = 3, classic potential,
  self-couplings), the ternary 3D separation under both potentials, and a
  forced ternary mixture in 2D and in 3D; every instantiation of the
  D3Q19 step's tile (``sc3_kernel``) also on shapes that are no multiple
  of its tile and with fewer z-planes than a block marches over
  (``SC3_RAGGED``); and the mixtures the kernels
  cannot run (half-way walls, K = 4, a per-node or DynamicValue force)
  raise on the default engine, naming the reason;
* the free-energy step (``ops/fe_step``, after the same pre-pass on the
  order parameter) against ``fe_step_reference`` on the five free-energy
  scenes (periodic separations with BGK and FE-MRT, walled channels with
  wetting, body forces and equilibrium-velocity overrides);
* the stream-and-collide kernel's single-component Shan-Chen mode
  (``lbm_step_sc_<grid>``, after the pre-pass at nk = 1 counted as
  ``rho_poststream_nk1_<grid>``) and its shallow-water equilibrium
  (``lbm_step_sw_d2q9``) against ``step_reference`` from each scene's own
  seeded start, 20 steps (``SINGLE_MODE_CASES``; the shallow-water mode
  also against the fp64 plain version, ``FP64_FACTOR``): the spinodal
  scenes at
  1024^2 / 128^3 under the classic potential, the linear potential, Guo
  forces and full bounce-back boxes with excluded nodes on 1000 x 600 /
  100 x 60 x 40 (no multiple of the block), the Gaussian hump unforced,
  under Guo and the velocity shift, and channels of each native BC pair
  along y and x; each asserting the mode moved the state; and the scenes
  the kernel refuses (Shan-Chen under MRT or LES, with an EDM,
  velocity-shift or DynamicValue force, with native BCs, half-way or
  slip walls, with the shallow-water equilibrium; shallow water under
  MRT, LES or EDM) raise on the default engine, naming the reason;
* the same kernel on int16 state buffers (``--precision=mixed``, launches
  counted as ``lbm_step_mixed_<grid>``, built from ``lbm_step_mixed*.cu``)
  against ``step_reference`` in codes (``MIXED_CASES``: the cavities, each
  force model, MRT at tau != 1, LES, the incompressible equilibrium,
  half-way, TMS and slip walls, varying inlets along z and x, time-only and
  space-and-time rows, shapes that are no multiple of the block; 100
  steps, the criterion of ``torch_scenes.mixed_errors``), every one of the
  65,536 codes of every direction through the kernel's own conversions,
  the shear-wave viscosity on it, and the scenes the mode refuses;
* the same kernel's ELBM mode (``--model=elbm``: launches counted as
  ``lbm_step_elbm_<grid>``, on int16 state as ``lbm_step_mixed_<grid>``)
  against ``step_reference`` with the entropic collision
  (``ELBM_CASES``, ``ELBM_MIXED_CASES``): launches with the alpha
  solve's diagnostics, the branch counts (tiny / series / Newton) of
  kernel and plain version and the same Newton nodes in both; smooth
  states (alpha 2 - 1e-3) 200 steps within ``TOL``; a state pushed into
  the Newton branch one launch, also under each force model and with
  each kind of wall row, within ``TOL`` or ``FP64_FACTOR`` times the fp32
  plain version's distance to the fp64 plain version; the cavities' own
  start 50 steps by the same rule; each force model and the wall rows 50
  steps from the smooth state, the mean distance to the fp64 plain
  version within ``ELBM_MEAN_FACTOR`` times the fp32 plain version's;
  int16 in codes;
* the same kernel on the D3Q15 and D3Q27 lattices (``csrc/
  lbm_step_lattices.cu``: BGK with either equilibrium, each force model,
  wall rows or not; ``lattice_compare``) against ``step_reference`` on the
  same lattice, every instantiation class at 64^3 for 100 steps on the lid
  cavity and on a half-way or TMS box; and the runner's device hooks: an
  int16 cavity whose final state a strided hook leaves bitwise unchanged
  (``mixed_hook_bitwise``), a checkpoint with the Reynolds hook's state
  continued to the unbroken run's bits (``checkpoint_continues``);
* the same kernel's outflow rows (the patch-plane / patch-block mode of
  the JAX kernels: ``csrc/lbm_step_outflow.cu``, launches counted as
  ``lbm_step_outflow_<grid>``; a laminarize row after the plane-mean
  pre-pass ``laminarize_mean_<grid>``) against ``step_reference``
  (``outflow_compare``): each kernel-borne type of the family on the
  inflow/outflow channel of ``torch_scenes.outflow_channel`` at D3Q19 64^3
  and D2Q9 1024x512, the outlet normal to x or to z / y and the force
  models in turns, one launch and 200 steps (the pre-pass against its
  plain version); and the outflow scenes the kernels refuse
  (``outflow_refusals``) raise on the default engine, naming the reason;
* on a one-axis mesh with its shards on the card (``parallel/halo.py``,
  ``parallel/halo_multi.py``): the ghost-plane mode and the
  ``halo_exchange`` kernel against their plain versions, one scene per
  mode class over 2 shards the unsharded run's bits (``mesh_bitwise``),
  and the Shan-Chen and free-energy ghost modes (``MESH_MULTI_CASES``:
  K = 3 forced with walls, walls, Rayleigh-Taylor, FE-MRT, wetting in 3D
  and 2D, single-component Shan-Chen; 2 shards, 20 steps): both exchange
  kernels against their plain versions on random buffers, the ghost-mode
  pre-pass and step against theirs, the unsharded kernel's bits;
* on meshes of two axes (('z', 'y'), ('y', 'x')): the edge mode of both
  exchanges (``halo_edge_exchange_<grid>``, ``halo_rho_edge_exchange_
  <grid>``) against ``ghost_copy`` on random buffers, bit for bit
  (``EDGE_CASES``: K = 1 in fp32 and int16, 2 and 3, one and two ghost
  layers, on 2x2 and 1x4 in 3D, 2x2 and 1x2 in 2D), and every mode class
  of ``MESH_BITWISE`` and ``MESH_MULTI_CASES`` over 2x2 shards on the card,
  the unsharded run's bits.

Then it runs each model's main path through the controller with the
default engine and the launch counts zeroed just before: the lid-driven
cavities (D3Q19 256^3, D2Q9 4096^2), the parabolic-inlet channels
(``parabolic_inlet_3d`` / ``parabolic_inlet_x_3d`` 256^3 and
``parabolic_inlet_2d`` / ``parabolic_inlet_x_2d`` 4096^2, one launch per
step, each timed against the same channel with a uniform inlet, and the
step of the channel flowing along x over that of the z- / y-normal one),
the force-driven flows past a sphere (``sphere_3d`` 256^3) and a cylinder
(``cylinder`` 4096^2) with Guo forcing (one ``lbm_step_force`` launch per
step; each force model then timed in turns against the same geometry
without a force), the collision-model paths (``ldc_3d`` 256^3 under MRT,
``sphere_3d`` 256^3 under the Smagorinsky model with Guo, ``cylinder``
4096^2 under MRT with Guo; one launch per step under the model's key;
MRT, LES and the incompressible equilibrium also timed in turns against
BGK on the cavities' geometry and buffers), the half-way duct
(``duct_flow`` 256^3, Guo), the Womersley pipe with time-dependent
densities at its ends (``womersley`` 256^3) and the ramped SpatialArray
inlet (``poiseuille_sa`` 4096^2), one launch per step each, with the share
of a step that the per-step values cost, the two cavities under
``--precision=mixed`` (``ldc_3d_mixed`` 256^3, ``ldc_2d_mixed`` 4096^2:
one ``lbm_step_mixed`` launch per step on int16 buffers, the mean density
against the fp32 path's, timed in turns against the fp32 kernel, and the
cost of the chunk's whole-state conversions), the four ELBM paths
(``ELBM_MAIN``: the entropic cavity ``ldc_2d_entropic`` 4096^2 and
``bench.py``'s cavity under ``--model=elbm`` 256^3, each in fp32 and
int16; one launch per step, the Newton share of one launch from the last state, timed in
turns against the BGK kernel of the same storage), the binary Shan-Chen
separations
and the free-energy separations (each D3Q19 256^3, D2Q9 4096^2), the
forced Rayleigh-Taylor mixture (``sc_rayleigh_taylor_2d`` 4096^2), the
ternary drops (``ternary_sc_drop_2d`` 4096^2) and the ternary separation
(``ternary_separation_3d`` 256^3), each with one pre-pass and one step
launch per step under the mode's name, then the three forced modes
without a main path of their own for 500 steps each at the same sizes
(each forced kernel also timed in turns against the unforced one on the
same buffers), the single-component twins at full size with their own
physics (``sc_phase_separation_3d`` 256^3 and ``sc_phase_separation``
4096^2: G = -5, classic psi, rho = 0.693 + U(0, 0.01), one pre-pass and
one ``lbm_step_sc`` launch per step, the phases separating, mass within
``MASS_TOL``; ``fs_gaussian`` 4096^2: one ``lbm_step_sw`` launch per step,
the hump's top falling, the mass drift the shallow-water equilibrium's
own bounded), the paths of the other lattices and of the device hooks
for 1,000 steps (``kida_vortex_256``: the Kida vortex on D3Q15 256^3 at
the scene's defaults with its KE / enstrophy hook every 20 steps;
``ldc_3d_d3q27``: ``bench.py``'s cavity on D3Q27; ``channel_flow``: the
turbulent channel at its published settings, 240 x 82 x 80, with its
Reynolds statistics hook every 20 steps from 0; one launch per step each,
the hooks' samples checked and their share of a chunk timed in turns),
the outflow family's paths (``OPEN_MAIN``: ``open_sphere_3d``, a
regularized inlet and a Yu outlet past a sphere, D3Q19 512x256x256, and
``open_cylinder_2d``, a Zou-He inlet and a copy outlet past a cylinder,
D2Q9 8192x2048, each with a force object whose drag is sampled after every
250-step chunk, its mean along +x positive, one ``lbm_step_outflow``
launch per step, the idle share of one more chunk traced with
``torch.profiler`` and the cost of a drag sample; and
``laminarize_channel_2d`` 8192x2048, one pre-pass and one step launch per
step), the mesh main paths with ``--mesh=1`` (``ldc_3d_zmesh1`` 256^3,
``ldc_2d_ymesh1`` 4096^2, ``channel_flow_zmesh1``; ``MESH_MULTI_MAIN``:
``sc_separation_3d_zmesh1``, ``fe_separation_3d_zmesh1`` and
``sc_phase_separation_3d_zmesh1`` 256^3, ``sc_separation_2d_ymesh1``,
``fe_separation_2d_ymesh1`` and ``sc_phase_separation_ymesh1`` 4096^2:
one ghost-mode launch per step, after one ghost-mode pre-pass and one
density exchange for the couplings, and one exchange; MLUPS in turns
against the unsharded kernel with the same bits after each turn, ms per
launch of the ghost-mode kernels and of each exchange; the 3D paths also
over 2 and 4 shards on the card, 100 steps, the unsharded bits), the
two-axis main paths with ``--mesh=1x1`` (``MESH2_MAIN``: ``ldc_3d_zymesh1``
and ``sc_separation_3d_zymesh1`` 256^3, ``taylor_green_2d_yxmesh1`` and
``fe_separation_2d_yxmesh1`` 4096^2: the ghost-mode launches and one edge
exchange per step, the density edge exchange for the couplings; MLUPS of
``--mesh=1x1``, ``--mesh=1`` and the unsharded kernel in turns with the
same bits after each turn, the edge exchanges' ms from C against the
one-axis ones, 2x2 shards on the card 100 steps with the unsharded bits),
the immersed-boundary paths on the torch engine, which the kernels refuse
by name (``ibm_cylinder`` at 48x24, 200 steps, against the CPU's torch
engine and twice on the card for the same bits; at 4096x2048 with 1,600
markers 1.005 nodes apart, ``IBM_MAIN``: ms per step, the spreading and
interpolation alone, PyTorch kernels per step, the markers' displacement),
the tracers and the visualization on the kernel's main path (``ldc_3d``
256^3: 100,000 tracers updated every 100 of 1,000 steps, the card's
advection against the CPU's bit for bit; ``--mode=visualization`` with
two frames; a slice server with a subscriber on 127.0.0.1, the slice
received against the host field's bit for bit; a phase whose host
package, matplotlib or pyzmq, is not installed says so and does not run),
checks the results, times
the 3D free-energy kernel's FE-MRT instantiation at 256^3 beside the main
path's BGK one (with its tile and ptxas registers), runs a free-energy
demixing to its end, times every kernel against its plain version and its
bound and an empty kernel launch, and prints the measurements. Every phase raises on
failure, so the exit code is 0 only when all of them passed; without a
CUDA device it exits non-zero before printing a result. The last line is
``{"ok": true, "device": {...}}``.
"""

import copy
import ctypes
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sailfish_tpu_torch import equilibrium as eq
from sailfish_tpu_torch import node_type as nt
from sailfish_tpu_torch import state as st
from sailfish_tpu_torch import util
from sailfish_tpu_torch.ops import build
from sailfish_tpu_torch.ops import fe_step as fe
from sailfish_tpu_torch.ops import lbm_step as ls
from sailfish_tpu_torch.ops import sc_multi as sm
from sailfish_tpu_torch.ops.step import FORCE_MODELS
from sailfish_tpu_torch.parallel import halo
from sailfish_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, 'tests'))
sys.path.insert(0, os.path.join(REPO, 'tools'))
from trace_main_path import trace_runner_chunk  # noqa: E402
from torch_scenes import (ACCEL, BC_PAIRS, FE_GOLDEN_FLAGS,  # noqa: E402
                          FORCED_SCENES, MIX_ACCELS, SC_HALFWAY_SCENES,
                          SC_MORE_GOLDEN_FLAGS, SC_MORE_SCENES,
                          SC_SINGLE_SCENES, SHALLOW_WATER_SCENES,
                          SINGLE_GOLDEN_FLAGS, TERNARY_GOLDEN_FLAGS,
                          TURBULENCE_GOLDEN_FLAGS, FE_HALFWAY_GOLDEN_FLAGS,
                          WALL_DYNAMIC_SCENES, WALLS, binary_twin, box_cfg,
                          box_sim, channel_sim, channel_sim_2d, forced,
                          forced_channel_sim, forced_mixture,
                          halfbb_beside_parabolic_inlet, parabolic_profile,
                          random_binary_state, random_fe_state, random_feq,
                          run, shallow_water, slip_sim, ternary_separation,
                          ternary_twin, time_series_density_sim,
                          tms_channel_sim, turbulence_twin, twin, unforced,
                          walled,
                          walls_moved, wet_map, with_keep_block,
                          with_patch_row_mix, MIXED_CODE_FLOOR,
                          FP64_FACTOR, MIXED_ONE_STEP, all_codes,
                          code_distance, mixed_errors, periodic_box,
                          shear_wave_viscosity, ELBM_DEV_BAND,
                          ELBM_MEAN_FACTOR, elbm_branches, elbm_errors, fp64_distances,
                          newton_state, smooth_feq, KERNEL_OUTFLOW_KINDS,
                          guo_beside_halfbb, open_channel, outflow_channel,
                          with_slice_subscriber, with_tracers)

LDC_3D = twin('ldc_3d')
LDC_2D = twin('ldc_2d')
SEP_2D = binary_twin('sc_separation_2d')
SEP_3D = binary_twin('sc_separation_3d')
SEP_3D_WALLS = binary_twin('sc_separation_3d_walls')
FE_SCENES = ('fe_separation_2d', 'fe_separation_3d', 'fe_poiseuille_2d',
             'fe_viscous_fingering', 'binary_microchannel')
FE = {scene: binary_twin(scene) for scene in FE_SCENES}
RT_2D = binary_twin('sc_rayleigh_taylor_2d')
DROP_3 = ternary_twin('sc_drop_2d')
TERNARY_3D = ternary_separation(3)
#: the accelerations of the forced mixture paths: ``MIX_ACCELS`` / 1000, so
#: 2000 steps from rest stay below |u| = 0.01
MAIN_ACCELS = tuple(tuple(1e-3 * c for c in a) for a in MIX_ACCELS)
#: the Shan-Chen main paths: name -> (sim class, size, step launch name,
#: demixing check: None, or the number of components, first to last, whose
#: density contrast must pass 0.5). The binary separations demix (rho's
#: contrast, and rho and phi anticorrelate); Rayleigh-Taylor starts
#: separated under gravity; the ternary drops stay drops; the ternary
#: separation demixes in all three (contrast 3.3-3.7 after 2000 steps of
#: the torch engine at 32^3 on the CPU)
SC_MAIN = {
    'sc_separation_3d': (SEP_3D, (256, 256, 256), 'sc_multi_d3q19', 1),
    'sc_separation_2d': (SEP_2D, (4096, 4096), 'sc_multi_d2q9', 1),
    'sc_rayleigh_taylor_2d': (RT_2D, (4096, 4096), 'sc_multi_force_d2q9',
                              None),
    'ternary_sc_drop_2d': (DROP_3, (4096, 4096), 'sc_multi_k3_d2q9', None),
    'ternary_separation_3d': (TERNARY_3D, (256, 256, 256),
                              'sc_multi_k3_d3q19', 3),
}
#: the forced modes that no main path runs, driven through the controller
#: at the main paths' sizes for 2 chunks of 250 steps: the binary
#: separation, the ternary drops and the ternary separation with
#: ``MAIN_ACCELS`` on every component
SC_MODE_MAIN = {
    'sc_separation_3d_forced': (forced_mixture(SEP_3D, MAIN_ACCELS),
                                (256, 256, 256), 'sc_multi_force_d3q19'),
    'ternary_sc_drop_2d_forced': (forced_mixture(DROP_3, MAIN_ACCELS),
                                  (4096, 4096), 'sc_multi_k3_force_d2q9'),
    'ternary_separation_3d_forced': (forced_mixture(TERNARY_3D, MAIN_ACCELS),
                                     (256, 256, 256),
                                     'sc_multi_k3_force_d3q19'),
}
#: the D3Q19 Shan-Chen step's tile on ragged shapes, every instantiation:
#: (name, sim class, flags, tile or None for the default). 37 x 23 x 11 on
#: a 32 x 8 x 16 tile is ragged in x, y and z and holds fewer z-planes
#: than a block marches over; 37 x 23 x 5 on the default tile (256 x 1 x
#: 8) is ragged in x and z, with fewer z-planes than a block's; the walled
#: boxes hold mask codes 0, 1 and 2 (with the block of excluded nodes
#: ``sc_compare`` adds), both potentials
RAGGED_11 = dict(lat_nx=37, lat_ny=23, lat_nz=11)
RAGGED_5 = dict(lat_nx=37, lat_ny=23, lat_nz=5)
TILE_32x8 = (32, 8, 16)
SC3_RAGGED = [
    ('sc3_k2_walls_37x23x11', SEP_3D_WALLS, RAGGED_11, TILE_32x8),
    ('sc3_k2_classic_37x23x5', SEP_3D,
     dict(RAGGED_5, sc_potential='classic', G11=-0.3, G22=0.2), None),
    ('sc3_k2_forced_walls_classic_37x23x11', forced_mixture(SEP_3D_WALLS),
     dict(RAGGED_11, sc_potential='classic', G22=0.2), TILE_32x8),
    ('sc3_k2_forced_37x23x5', forced_mixture(SEP_3D),
     dict(RAGGED_5, G11=-0.3), None),
    ('sc3_k3_walls_37x23x11', ternary_separation(3, walls=True),
     dict(RAGGED_11, G11=-0.3, G33=0.2), TILE_32x8),
    ('sc3_k3_classic_37x23x5', TERNARY_3D,
     dict(RAGGED_5, sc_potential='classic', G22=-0.3), None),
    ('sc3_k3_forced_walls_classic_37x23x11',
     forced_mixture(ternary_separation(3, walls=True)),
     dict(RAGGED_11, sc_potential='classic', G22=-0.3), TILE_32x8),
    ('sc3_k3_forced_37x23x5', forced_mixture(TERNARY_3D),
     dict(RAGGED_5, G11=-0.3, G33=0.2), None),
]
#: the single-component Shan-Chen and shallow-water main paths, each
#: twin's own physics at full size: scene -> (size, step launch name)
SINGLE_MODE_MAIN = {
    'sc_phase_separation_3d': ((256, 256, 256), 'lbm_step_sc_d3q19'),
    'sc_phase_separation': ((4096, 4096), 'lbm_step_sc_d2q9'),
    'fs_gaussian': ((4096, 4096), 'lbm_step_sw_d2q9'),
}
SC_2D = twin('sc_phase_separation')
SC_3D = twin('sc_phase_separation_3d')
FS = twin('fs_gaussian')
#: Shan-Chen with the linear potential: G = -1.6, just inside the spinodal
#: at the scenes' rho ~ 0.693 (G = -5 blows up within 20 steps there)
SC_LINEAR = dict(sc_potential='linear', G=-1.6)
#: the accelerations of the forced comparisons: every component, both
#: signs, strong enough that a wrong order of the two velocity shifts
#: shows after 20 steps
SC_ACCEL = (1e-3, -5e-4, 2.5e-4)
SW_ACCEL = (2e-4, -1e-4)
#: shallow-water channels with native BCs: g = 0.01 keeps the 0.03 inlet
#: subcritical (Froude 0.3); the regularized pair is unstable there under
#: the shallow-water equilibrium on both engines (and in JAX) unless
#: tau = 1
SW_CHANNEL = dict(visc=0.05, gravity=0.01)
SW_CHANNEL_REG = dict(visc=1.0 / 6.0, gravity=0.01)
#: the kernel-vs-plain cases of the two modes: (name, sim class, flags);
#: 1000 x 600 and 100 x 60 x 40 are no multiple of the 128-node block
RAGGED_2D = dict(lat_nx=1000, lat_ny=600)
RAGGED_3D = dict(lat_nx=100, lat_ny=60, lat_nz=40)
SINGLE_MODE_CASES = [
    ('sc_phase_separation_2d', SC_2D, dict(lat_nx=1024, lat_ny=1024)),
    ('sc_2d_linear_ragged', SC_2D, dict(RAGGED_2D, **SC_LINEAR)),
    ('sc_2d_guo_box_ragged', with_keep_block(walled(forced(
        SC_2D, SC_ACCEL[:2]))), RAGGED_2D),
    ('sc_phase_separation_3d', SC_3D,
     dict(lat_nx=128, lat_ny=128, lat_nz=128)),
    ('sc_3d_linear_box_ragged', with_keep_block(walled(SC_3D)),
     dict(RAGGED_3D, **SC_LINEAR)),
    ('sc_3d_guo_ragged', forced(SC_3D, SC_ACCEL), RAGGED_3D),
    ('sc_3d_linear_guo_box_ragged', walled(forced(SC_3D, SC_ACCEL)),
     dict(RAGGED_3D, **SC_LINEAR)),
    ('sw_hump', with_keep_block(FS), dict(lat_nx=1024, lat_ny=1024)),
    ('sw_hump_guo_ragged', forced(FS, SW_ACCEL), RAGGED_2D),
    ('sw_hump_velocity_shift_ragged', forced(FS, SW_ACCEL),
     dict(RAGGED_2D, force_implementation='velocity_shift')),
    ('sw_channel_equilibrium', with_keep_block(shallow_water(
        channel_sim_2d('equilibrium'))), dict(RAGGED_2D, **SW_CHANNEL)),
    ('sw_channel_zouhe_x', with_keep_block(shallow_water(
        channel_sim_2d('zouhe', axis='x'))), dict(RAGGED_2D, **SW_CHANNEL)),
    ('sw_channel_regularized', shallow_water(channel_sim_2d('regularized')),
     dict(RAGGED_2D, **SW_CHANNEL_REG)),
]
#: the force-driven main paths (Guo forcing): scene -> size
FORCED_MAIN = {'sphere_3d': (256, 256, 256), 'cylinder': (4096, 4096)}
#: their constant acceleration (examples/torch/sphere_3d.py, cylinder.py)
FORCED_ACCEL = 1e-5
#: the collision models of the kernel's collision-model mode, as flags
#: (the Smagorinsky constant of the comparisons raised to 0.2, so the
#: subgrid rate moves one step from a random state by ~1e-3)
COLLISION = {
    'mrt': dict(model='mrt'),
    'trt': dict(model='trt'),
    'les': dict(subgrid='les-smagorinsky', smagorinsky_const=0.2),
    'mrt_les': dict(model='mrt', subgrid='les-smagorinsky',
                    smagorinsky_const=0.2),
    'incompressible': dict(incompressible=True),
    'incompressible_mrt': dict(incompressible=True, model='mrt'),
    'incompressible_les': dict(incompressible=True,
                               subgrid='les-smagorinsky',
                               smagorinsky_const=0.2),
}
#: the collision-model main paths: name -> (scene, size, flags, constant
#: acceleration along x or None, launch key): the MRT cavity of bench.py's
#: scene, the example's LES configuration of the sphere (its own
#: Smagorinsky constant, 0.03) and the cylinder under MRT and the Guo
#: force (the conserved-moment correction)
COLLISION_MAIN = {
    'ldc_3d_mrt': ('ldc_3d', (256, 256, 256), dict(model='mrt'), None,
                   'mrt_'),
    'sphere_3d_les': ('sphere_3d', (256, 256, 256),
                      dict(subgrid='les-smagorinsky'), FORCED_ACCEL, 'les_'),
    'cylinder_mrt': ('cylinder', (4096, 4096), dict(model='mrt'),
                     FORCED_ACCEL, 'mrt_'),
}
#: the models timed in turns against BGK on the cavities' geometry and
#: buffers (the main paths' flags)
COLLISION_TIMED = {'mrt': dict(model='mrt'),
                   'les': dict(subgrid='les-smagorinsky'),
                   'incompressible': dict(incompressible=True)}

#: --precision=mixed (int16 A/B buffers): the two main paths, bench.py's
#: cavities with the default --mixed_range: path -> (scene, size)
MIXED_MAIN = {'ldc_3d_mixed': ('ldc_3d', (256, 256, 256)),
              'ldc_2d_mixed': ('ldc_2d', (4096, 4096))}
MIXED_RANGE = 0.5
#: the mixed mode's kernel-vs-plain cases, 100 steps each (200 until the
#: smoke's time was cut for the Shan-Chen and free-energy mesh paths;
#: criterion: ``torch_scenes.mixed_errors``): (name, sim class, flags,
#: first iteration); 100 x 60 x 40 and 1000 x 600 are no multiple of the
#: block
MIXED_STEPS = 100
MIXED_CUBE = dict(lat_nx=64, lat_ny=64, lat_nz=64)
MIXED_SQ = dict(lat_nx=1024, lat_ny=512)
MIXED_CASES = [
    ('ldc_3d', with_keep_block(LDC_3D), MIXED_CUBE, 0),
    ('ldc_2d', with_keep_block(LDC_2D), MIXED_SQ, 0),
    ('ldc_3d_ragged', with_keep_block(LDC_3D), RAGGED_3D, 0),
    ('ldc_2d_ragged', with_keep_block(LDC_2D), RAGGED_2D, 0),
    ('sphere_3d_guo', with_keep_block(twin('sphere_3d')), MIXED_CUBE, 0),
    ('sphere_3d_edm', twin('sphere_3d'),
     dict(MIXED_CUBE, force_implementation='edm'), 0),
    ('cylinder_velocity_shift', twin('cylinder'),
     dict(MIXED_SQ, force_implementation='velocity_shift'), 0),
    ('ldc_3d_mrt', LDC_3D, dict(MIXED_CUBE, model='mrt', visc=0.05), 0),
    ('cylinder_mrt_guo', twin('cylinder'), dict(MIXED_SQ, model='mrt'), 0),
    ('sphere_3d_les', twin('sphere_3d'), dict(
        MIXED_CUBE, subgrid='les-smagorinsky', smagorinsky_const=0.2), 0),
    ('ldc_2d_incompressible', LDC_2D, dict(MIXED_SQ, incompressible=True),
     0),
    ('halfbb_box_3d_guo', box_sim(WALLS['halfbb'], 3, (0, 1, 2), ACCEL),
     dict(box_cfg(3, (0, 1, 2)), **MIXED_CUBE), 0),
    ('tms_channel_3d', tms_channel_sim(3),
     dict(MIXED_CUBE, periodic_x=True, periodic_z=True), 0),
    ('tms_box_2d_mrt', box_sim(WALLS['tms'], 2, (0, 1)),
     dict(box_cfg(2, (0, 1)), model='mrt', visc=0.05,
          lat_nx=1024, lat_ny=1024), 0),
    ('slip_3d_y', slip_sim(3, 1),
     dict(MIXED_CUBE, periodic_x=True, periodic_z=True), 0),
    ('parabolic_inlet_z', with_patch_row_mix(with_keep_block(channel_sim(
        'regularized', 'z', profile='parabolic')), 'z'),
     dict(MIXED_CUBE, periodic_x=True), 0),
    ('parabolic_inlet_x_zouhe', channel_sim('zouhe', 'x',
                                            profile='parabolic'),
     dict(MIXED_CUBE, periodic_z=True), 0),
    ('parabolic_inlet_2d_x', channel_sim_2d('equilibrium', axis='x'),
     MIXED_SQ, 0),
    ('womersley_64', twin('womersley'), MIXED_CUBE, 3000),
    ('poiseuille_sa_1024', twin('poiseuille_sa'),
     dict(lat_nx=1024, lat_ny=1024, velocity='spatial_array'), 2500),
]

#: the ELBM mode (``--model=elbm``): the main paths, name -> (sim class,
#: size, flags, the JSON row): the example's cavity (lid 0.01, nu = 1e-4;
#: model_zoo d2q9_elbm_ldc_1024, at the port's 2D extent), the same under
#: --precision=mixed (model_zoo d2q9_elbm_ldc_1024_mixed16) and bench.py's
#: 3D cavity under --model=elbm, in fp32 and int16
ELBM_2D = twin('ldc_2d_entropic')
ELBM_MAIN = {
    'ldc_2d_entropic': (ELBM_2D, (4096, 4096), {}, 'lbm_step_elbm_d2q9'),
    'ldc_2d_entropic_mixed': (ELBM_2D, (4096, 4096), dict(
        precision='mixed', mixed_range=MIXED_RANGE),
        'lbm_step_mixed_elbm_d2q9'),
    'ldc_3d_elbm': (LDC_3D, (256, 256, 256), dict(model='elbm'),
                    'lbm_step_elbm_d3q19'),
    'ldc_3d_elbm_mixed': (LDC_3D, (256, 256, 256), dict(
        model='elbm', precision='mixed', mixed_range=MIXED_RANGE),
        'lbm_step_mixed_elbm_d3q19'),
}
#: the ELBM mode's kernel-vs-plain cases: name -> (sim class, flags,
#: state: 'smooth' (``smooth_feq`` at ``ELBM_AMP``: every node on the
#: series branch, alpha 2 - 1e-3; 200 steps within TOL), 'newton'
#: (``newton_state``: one launch, the same branch at every node), 'own'
#: (the scene's start; 50 steps within ELBM_CAVITY_TOL or ``FP64_FACTOR``
#: times the fp32 plain version's distance to the fp64 plain version) or
#: 'forced' (under a force or with wall rows: one launch from
#: ``smooth_feq`` at ``ELBM_AMP`` and one from ``newton_state``, each
#: within TOL or by ``FP64_FACTOR``; then 50 steps from the first, in
#: which the walls push nodes into the Newton branch: the mean distance to
#: the fp64 plain version within ``ELBM_MEAN_FACTOR`` times the fp32 plain
#: version's))
ELBM_BOX_2D = dict(lat_nx=1024, lat_ny=1024, periodic_x=True,
                   periodic_y=True)
ELBM_BOX_3D = dict(lat_nx=128, lat_ny=128, lat_nz=64, periodic_x=True,
                   periodic_y=True, periodic_z=True)
ELBM_CASES = [
    ('box_2d_smooth', periodic_box(2), ELBM_BOX_2D, 'smooth'),
    ('box_3d_smooth', periodic_box(3), ELBM_BOX_3D, 'smooth'),
    ('ldc_2d_newton', LDC_2D, dict(lat_nx=1024, lat_ny=1024), 'newton'),
    ('ldc_3d_newton', LDC_3D, dict(lat_nx=128, lat_ny=128, lat_nz=128),
     'newton'),
    ('ldc_2d_entropic_1024', ELBM_2D, dict(lat_nx=1024, lat_ny=1024),
     'own'),
    ('ldc_3d_128', LDC_3D, dict(lat_nx=128, lat_ny=128, lat_nz=128), 'own'),
] + [(f'{scene}_{model}', twin(scene), dict(
    size, force_implementation=model), 'forced')
    for scene, size in (('sphere_3d', dict(lat_nx=128, lat_ny=64,
                                           lat_nz=64)),
                        ('cylinder', dict(lat_nx=1024, lat_ny=512)))
    for model in FORCE_MODELS] + [
    ('halfbb_box_3d_guo', box_sim(WALLS['halfbb'], 3, (0, 1, 2), ACCEL),
     dict(box_cfg(3, (0, 1, 2)), lat_nx=64, lat_ny=64, lat_nz=64),
     'forced'),
    ('tms_channel_2d_guo', tms_channel_sim(2), dict(
        lat_nx=1024, lat_ny=1024, periodic_x=True), 'forced'),
    ('slip_3d_y_guo', slip_sim(3, 1), dict(
        lat_nx=64, lat_ny=64, lat_nz=64, periodic_x=True, periodic_z=True),
     'forced'),
    ('channel_x_zouhe', channel_sim('zouhe', 'x'), dict(
        lat_nx=128, lat_ny=64, lat_nz=64, periodic_z=True), 'forced'),
]
#: the ELBM mode on int16 state: (name, sim class, flags), 200 steps in
#: codes from ``smooth_feq`` (``mixed_errors``; the one launch by
#: ``elbm_branches``)
ELBM_MIXED_CASES = [
    ('ldc_2d_entropic', ELBM_2D, dict(lat_nx=1024, lat_ny=512)),
    ('ldc_3d', LDC_3D, MIXED_CUBE),
    ('sphere_3d_edm', twin('sphere_3d'),
     dict(MIXED_CUBE, force_implementation='edm')),
    ('tms_box_2d', box_sim(WALLS['tms'], 2, (0, 1)),
     dict(box_cfg(2, (0, 1)), lat_nx=1024, lat_ny=1024, visc=0.05)),
    ('halfbb_box_3d_guo', box_sim(WALLS['halfbb'], 3, (0, 1, 2), ACCEL),
     dict(box_cfg(3, (0, 1, 2)), **MIXED_CUBE)),
]
#: the cavity's own start under ELBM, 50 steps: the bound of the JAX
#: package's ELBM engines (regtest/engine_equivalence.py:100-104)
ELBM_CAVITY_TOL = 2e-5
#: the amplitude of the ELBM cases' smooth states: alpha departs from 2 by
#: up to 1e-3 (at 1e-3 by 1e-5, where the entropic collision is BGK's
#: within rounding)
ELBM_AMP = 1e-2

#: kernel-vs-plain tolerance: wet-node max |df| after 200 steps (fp32,
#: FMA contraction and summation order differ between the two)
TOL = 1e-5
#: the shallow-water mode is held to the fp64 plain version instead
#: (``sw_fp64_check``): the examples' tau = 0.515 (relaxation rate 1.94)
#: damps each step's fp32 rounding by only 6 % a step, so two correct fp32
#: steps drift apart (the torch and the JAX XLA engines on the CPU: 4.6e-6
#: / 7.8e-6 from the fp64 torch engine after 20 steps of fs_gaussian at
#: 256^2 / 1024^2, 2.9e-6 from each other at 1024^2)
#: density pre-pass vs rho_reference, max |d rho| (fp32 summation order)
RHO_TOL = 1e-6
#: relative drift of a component's total mass over a binary main path.
#: fp32 BGK does not conserve mass exactly: the fp32 lattice weights sum
#: to 1 + 7.5e-9 (D2Q9) / 1 + 1.5e-8 (D3Q19), and each step at tau = 1
#: adds about that much plus rounding (1.8e-5 after 1600 steps of the
#: plain torch engine at 96^2 on the CPU), so 2000 steps drift by a few
#: 1e-5; a lost or doubled population would drift by far more
MASS_TOL = 1e-4
#: free-energy main path: relative drift of the total of rho, and drift of
#: the total of phi per node, over 2000 steps. Both equilibria put the
#: rest population at rho - sum_{i>0} feq_i, so only rounding moves the
#: totals: the plain torch engine on the CPU drifts 6.0e-8 / 3.9e-11
#: (fe_separation_2d 96^2) and 8.9e-8 / 3.4e-12 (fe_separation_3d 32^3)
#: over 2000 steps
FE_RHO_TOL = 1e-6
FE_PHI_TOL = 1e-9
#: bytes moved per node per step: Q floats read + Q written + 1 mask byte
BYTES = {'D3Q19': 2 * 19 * 4 + 1, 'D2Q9': 2 * 9 * 4 + 1,
         'D3Q15': 2 * 15 * 4 + 1, 'D3Q27': 2 * 27 * 4 + 1}
#: bytes moved per node by one K-component Shan-Chen pre-pass (K*Q floats
#: read, K written) and by one step (K*Q floats read and written, K
#: densities and the mask byte read); Q by lattice
SC_Q = {'D3Q19': 19, 'D2Q9': 9}


def sc_prepass_bytes(grid_name, K):
    return K * (SC_Q[grid_name] * 4 + 4)


def sc_step_bytes(grid_name, K):
    return 2 * K * SC_Q[grid_name] * 4 + K * 4 + 1


def sc_bytes(grid_name, K):
    """Bytes per node and step of a Shan-Chen path: pre-pass + step (473 /
    233 B for K = 2, 709 / 349 B for K = 3, D3Q19 / D2Q9)."""
    return sc_prepass_bytes(grid_name, K) + sc_step_bytes(grid_name, K)

#: bytes moved per node per step by the free-energy path: the pre-pass
#: reads Q floats and writes phi; the step reads 2*Q floats, writes 2*Q,
#: reads phi and the mask byte (plus 1 orientation byte with walls)
FE_BYTES = {'D3Q19': (19 * 4 + 4) + (2 * 2 * 19 * 4 + 4 + 1),
            'D2Q9': (9 * 4 + 4) + (2 * 2 * 9 * 4 + 4 + 1)}
#: bytes moved per node per step on int16 state: Q codes read + Q written
#: + 1 mask byte
MIXED_BYTES = {'D3Q19': 2 * 19 * 2 + 1, 'D2Q9': 2 * 9 * 2 + 1}
#: bytes each kernel must move per node of its main-path call, each input
#: read once and each output written once (``lbm_step_vary``: the step's
#: bytes; the 4 (1 + dim) parameter bytes of each node of a varying BC
#: are added per run; the pre-pass at the Shan-Chen path's K = 2, whose
#: time the JSON line carries)
NODE_BYTES = {
    'lbm_step_d3q19': BYTES['D3Q19'], 'lbm_step_d2q9': BYTES['D2Q9'],
    'lbm_step_vary_d3q19': BYTES['D3Q19'],
    'lbm_step_vary_d2q9': BYTES['D2Q9'],
    'lbm_step_force_d3q19': BYTES['D3Q19'],
    'lbm_step_force_d2q9': BYTES['D2Q9'],
    # the wall rows: the step's bytes, and per wall node 4 B of tags and
    # 4 B per bounced link, added per run
    'lbm_step_wall_d3q19': BYTES['D3Q19'],
    # per-step values: the step's bytes (the rewritten block of the
    # parameter array is read as a varying row's, added per run)
    'lbm_step_dyn_d3q19': BYTES['D3Q19'],
    'lbm_step_dyn_d2q9': BYTES['D2Q9'],
    # the collision models: the step's bytes (rates and tau are in the
    # parameter block)
    'lbm_step_mrt_d3q19': BYTES['D3Q19'],
    'lbm_step_les_d3q19': BYTES['D3Q19'],
    'lbm_step_mrt_d2q9': BYTES['D2Q9'],
    'rho_poststream_d3q19': sc_prepass_bytes('D3Q19', 2),
    'rho_poststream_d2q9': sc_prepass_bytes('D2Q9', 2),
    'sc_multi_d3q19': sc_step_bytes('D3Q19', 2),
    'sc_multi_d2q9': sc_step_bytes('D2Q9', 2),
    # the Shan-Chen modes: the accelerations are in the parameter block;
    # K = 3 reads and writes a third component (the pre-pass's K = 3 row
    # times the launches of the ternary paths)
    'sc_multi_force_d3q19': sc_step_bytes('D3Q19', 2),
    'sc_multi_force_d2q9': sc_step_bytes('D2Q9', 2),
    'sc_multi_k3_d3q19': sc_step_bytes('D3Q19', 3),
    'sc_multi_k3_d2q9': sc_step_bytes('D2Q9', 3),
    'sc_multi_k3_force_d3q19': sc_step_bytes('D3Q19', 3),
    'sc_multi_k3_force_d2q9': sc_step_bytes('D2Q9', 3),
    'rho_poststream_k3_d3q19': sc_prepass_bytes('D3Q19', 3),
    'rho_poststream_k3_d2q9': sc_prepass_bytes('D2Q9', 3),
    'fe_step_d3q19': 2 * 2 * 19 * 4 + 4 + 1,
    'fe_step_d2q9': 2 * 2 * 9 * 4 + 4 + 1,
    # the single-component modes: the Shan-Chen step reads its own density
    # once more (the neighbours' from cache), its pre-pass reads the state
    # and writes one density; shallow water moves the step's bytes
    'lbm_step_sc_d3q19': BYTES['D3Q19'] + 4,
    'lbm_step_sc_d2q9': BYTES['D2Q9'] + 4,
    'lbm_step_sw_d2q9': BYTES['D2Q9'],
    'rho_poststream_nk1_d3q19': sc_prepass_bytes('D3Q19', 1),
    'rho_poststream_nk1_d2q9': sc_prepass_bytes('D2Q9', 1),
    # --precision=mixed: int16 codes in and out
    'lbm_step_mixed_d3q19': MIXED_BYTES['D3Q19'],
    'lbm_step_mixed_d2q9': MIXED_BYTES['D2Q9'],
    # the ELBM mode: the step's bytes (beta and the stops are in the block)
    'lbm_step_elbm_d3q19': BYTES['D3Q19'],
    'lbm_step_elbm_d2q9': BYTES['D2Q9'],
    'lbm_step_mixed_elbm_d3q19': MIXED_BYTES['D3Q19'],
    'lbm_step_mixed_elbm_d2q9': MIXED_BYTES['D2Q9'],
    # the other lattices: Q floats in and out and the mask byte (121 B for
    # D3Q15, 217 B for D3Q27)
    'lbm_step_d3q15': BYTES['D3Q15'],
    'lbm_step_d3q27': BYTES['D3Q27'],
    # the outflow rows: the step's bytes (a face node's extra loads along
    # the normal read the same state, which counts once)
    'lbm_step_outflow_d3q19': BYTES['D3Q19'],
    'lbm_step_outflow_d2q9': BYTES['D2Q9'],
    # the laminarize pre-pass, per laminarize node: its Q pulled values and
    # its 8-byte index (the entries' means and offsets added per run)
    'laminarize_mean_d2q9': 9 * 4 + 8,
    # on a mesh: the same per node (its code in place of its index; the
    # means written to every shard that reads the plane, the destinations'
    # addresses and offsets added per run)
    'laminarize_mean_ghost_d2q9': 9 * 4 + 8,
    # the outflow rows on a shard's slab: the step's bytes per node of the
    # domain, as the ghost-plane mode's
    'lbm_step_ghost_outflow_d3q19': BYTES['D3Q19'],
    'lbm_step_ghost_outflow_d2q9': BYTES['D2Q9'],
    # the ghost-plane mode: the step's bytes per node of the domain (the
    # ghost planes' own work is the mode's overhead, not its bound)
    'lbm_step_ghost_d3q19': BYTES['D3Q19'],
    'lbm_step_ghost_d2q9': BYTES['D2Q9'],
    'lbm_step_ghost_wall_d3q19': BYTES['D3Q19'],
    # the exchange, per node of a plane normal to the sharded axis: the
    # crossing directions (5 / 3) of both ghost planes, read and written
    'halo_exchange_d3q19': 2 * 5 * 2 * 4,
    'halo_exchange_d2q9': 2 * 3 * 2 * 4,
    # the ghost modes of the Shan-Chen and free-energy paths: the
    # unsharded kernels' bytes per node of the domain (K = 2 for the
    # pre-pass, whose time the mixtures' path gives)
    'rho_poststream_ghost_d3q19': sc_prepass_bytes('D3Q19', 2),
    'rho_poststream_ghost_d2q9': sc_prepass_bytes('D2Q9', 2),
    'sc_multi_ghost_d3q19': sc_step_bytes('D3Q19', 2),
    'sc_multi_ghost_d2q9': sc_step_bytes('D2Q9', 2),
    'fe_step_ghost_d3q19': 2 * 2 * 19 * 4 + 4 + 1,
    'fe_step_ghost_d2q9': 2 * 2 * 9 * 4 + 4 + 1,
    'lbm_step_ghost_sc_d3q19': BYTES['D3Q19'] + 4,
    'lbm_step_ghost_sc_d2q9': BYTES['D2Q9'] + 4,
    'rho_poststream_nk1_ghost_d3q19': sc_prepass_bytes('D3Q19', 1),
    'rho_poststream_nk1_ghost_d2q9': sc_prepass_bytes('D2Q9', 1),
    # the density exchange, per node of a plane: the K = 2 densities of
    # both ghost planes, read and written
    'halo_rho_exchange_d3q19': 2 * 2 * 2 * 4,
    'halo_rho_exchange_d2q9': 2 * 2 * 2 * 4,
    # the edge mode on --mesh=1x1, per node of a plane (3D) or a row (2D)
    # normal to the outer axis: the crossing directions (5 / 3) of both
    # ghost planes and both ghost rows, read and written; the edges' or
    # corners' values come as ``edge_bytes``
    'halo_edge_exchange_d3q19': 2 * 2 * 5 * 2 * 4,
    'halo_edge_exchange_d2q9': 2 * 2 * 3 * 2 * 4,
    # the density edge mode: both ghost planes and rows of the K = 2
    # densities (3D) and of phi (2D)
    'halo_rho_edge_exchange_d3q19': 2 * 2 * 2 * 2 * 4,
    'halo_rho_edge_exchange_d2q9': 2 * 2 * 1 * 2 * 4,
}
#: fp32 operations per direction of an ELBM node on the series branch
#: (``NODE_OPS``)
ELBM_OPS = 2 + 2 + 6 + 1 + 3 + 2 + 8 + 2
#: fp32 operations per node, an upper estimate read off each kernel's
#: source (BGK: ~23 per direction for the moments, feq and relaxation,
#: ~10 more for the Guo term of the forcing mode; MRT ~3 more per direction
#: for the parity split and ~16 for the conserved-moment pass and
#: correction, which runs with or without a force; LES a second Q-term pass for the
#: stress, ~14 per direction, and ~20 per node for the rate; the
#: native-BC chain ~60 per direction, on BC nodes only; the pre-pass one add per direction
#: and component; Shan-Chen K BGK components plus the force stencil, ~6
#: per direction and component, ~10 more per direction and component for
#: the Guo term, ~4 more for the classic potential's exp; the
#: free-energy step ~40 per direction and component). Against 67 TFLOP/s
#: each stays below 0.4 of its kernel's byte time: the bytes bound every
#: kernel.
NODE_OPS = {
    'lbm_step_d3q19': 23 * 19, 'lbm_step_d2q9': 23 * 9,
    'lbm_step_vary_d3q19': 23 * 19, 'lbm_step_vary_d2q9': 23 * 9,
    'lbm_step_force_d3q19': 33 * 19, 'lbm_step_force_d2q9': 33 * 9,
    'lbm_step_wall_d3q19': 33 * 19,
    'lbm_step_dyn_d3q19': 23 * 19, 'lbm_step_dyn_d2q9': 23 * 9,
    # ldc_3d under MRT (no force); the sphere under LES and Guo; the
    # cylinder under MRT and Guo
    'lbm_step_mrt_d3q19': (26 + 16) * 19,
    'lbm_step_les_d3q19': (23 + 14 + 10) * 19 + 20,
    'lbm_step_mrt_d2q9': (26 + 16 + 10) * 9,
    'rho_poststream_d3q19': 2 * 19, 'rho_poststream_d2q9': 2 * 9,
    'sc_multi_d3q19': 2 * (23 * 19 + 6 * 19),
    'sc_multi_d2q9': 2 * (23 * 9 + 4 * 9),
    # the main paths: Rayleigh-Taylor and the forced separation (Guo), the
    # ternary drops (classic), the ternary separation (linear), the forced
    # ternary mixtures (classic drops, linear separation)
    'sc_multi_force_d3q19': 2 * (33 * 19 + 6 * 19),
    'sc_multi_force_d2q9': 2 * (33 * 9 + 4 * 9),
    'sc_multi_k3_d3q19': 3 * (23 * 19 + 6 * 19),
    'sc_multi_k3_d2q9': 3 * (23 * 9 + 8 * 9),
    'sc_multi_k3_force_d3q19': 3 * (33 * 19 + 6 * 19),
    'sc_multi_k3_force_d2q9': 3 * (33 * 9 + 8 * 9),
    'rho_poststream_k3_d3q19': 3 * 19, 'rho_poststream_k3_d2q9': 3 * 9,
    'fe_step_d3q19': 2 * 40 * 19, 'fe_step_d2q9': 2 * 40 * 9,
    # BGK plus the force stencil under the classic potential (~14 per
    # neighbour: its exp and the sums); shallow water ~2 more per direction
    'lbm_step_sc_d3q19': (23 + 14) * 19, 'lbm_step_sc_d2q9': (23 + 14) * 9,
    'lbm_step_sw_d2q9': 25 * 9,
    'rho_poststream_nk1_d3q19': 19, 'rho_poststream_nk1_d2q9': 9,
    # BGK plus, per direction, the dequantize (int-to-float conversion,
    # multiply, add) and the quantize (subtract, multiply, saturating
    # float-to-int conversion), each conversion counted as one operation
    'lbm_step_mixed_d3q19': (23 + 6) * 19,
    'lbm_step_mixed_d2q9': (23 + 6) * 9,
    # ELBM on the series branch: BGK's moments (~2 per direction), then per
    # direction the range proof of the reciprocal (a min and a max), the
    # product-form feq rebuilt twice (~3 multiplies each) and fneq (a
    # subtract), one reciprocal (~3: the approximation and its Newton
    # step), t and |t| into dev (~2), the four power sums (~8) and the
    # relaxation (~2); per node the per-axis prefactor, B and 1/B (~10 per
    # axis with a sqrt and two divisions) and the alpha formula (~25); on
    # int16 state the conversions of BGK's (~6 per direction)
    'lbm_step_elbm_d3q19': ELBM_OPS * 19 + 3 * 10 + 25,
    'lbm_step_elbm_d2q9': ELBM_OPS * 9 + 2 * 10 + 25,
    'lbm_step_mixed_elbm_d3q19': (ELBM_OPS + 6) * 19 + 3 * 10 + 25,
    'lbm_step_mixed_elbm_d2q9': (ELBM_OPS + 6) * 9 + 2 * 10 + 25,
    # BGK on the other lattices: ~23 per direction
    'lbm_step_d3q15': 23 * 15, 'lbm_step_d3q27': 23 * 27,
    # the open channels: BGK (the face nodes' few sums are a small share);
    # the laminarize pre-pass: one add per direction and node
    'lbm_step_outflow_d3q19': 23 * 19, 'lbm_step_outflow_d2q9': 23 * 9,
    'laminarize_mean_d2q9': 9, 'laminarize_mean_ghost_d2q9': 9,
    'lbm_step_ghost_outflow_d3q19': 23 * 19,
    'lbm_step_ghost_outflow_d2q9': 23 * 9,
    # the ghost-plane mode: BGK; the exchange does no arithmetic (one
    # counted per moved value, so that the table stays positive)
    'lbm_step_ghost_d3q19': 23 * 19, 'lbm_step_ghost_d2q9': 23 * 9,
    'lbm_step_ghost_wall_d3q19': 33 * 19,
    'halo_exchange_d3q19': 2 * 5, 'halo_exchange_d2q9': 2 * 3,
    'rho_poststream_ghost_d3q19': 2 * 19, 'rho_poststream_ghost_d2q9': 2 * 9,
    'sc_multi_ghost_d3q19': 2 * (23 * 19 + 6 * 19),
    'sc_multi_ghost_d2q9': 2 * (23 * 9 + 4 * 9),
    'fe_step_ghost_d3q19': 2 * 40 * 19, 'fe_step_ghost_d2q9': 2 * 40 * 9,
    'lbm_step_ghost_sc_d3q19': (23 + 14) * 19,
    'lbm_step_ghost_sc_d2q9': (23 + 14) * 9,
    'rho_poststream_nk1_ghost_d3q19': 19,
    'rho_poststream_nk1_ghost_d2q9': 9,
    'halo_rho_exchange_d3q19': 2 * 2, 'halo_rho_exchange_d2q9': 2 * 2,
    'halo_edge_exchange_d3q19': 2 * 2 * 5,
    'halo_edge_exchange_d2q9': 2 * 2 * 3,
    'halo_rho_edge_exchange_d3q19': 2 * 2 * 2,
    'halo_rho_edge_exchange_d2q9': 2 * 2,
}
#: H100 SXM data-sheet peaks: HBM bytes/s and fp32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
#: kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    'lbm_step_d3q19': ('lbm_step.cu', 'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_d2q9': ('lbm_step.cu', 'sailfish_tpu/ops/pallas_step2d.py:36'),
    'rho_poststream_d3q19': ('sc_multi.cu',
                             'sailfish_tpu/ops/pallas_step.py:2409'),
    'rho_poststream_d2q9': ('sc_multi.cu',
                            'sailfish_tpu/ops/pallas_step2d.py:1069'),
    'sc_multi_d3q19': ('sc_multi.cu', 'sailfish_tpu/ops/pallas_multi3d.py:57'),
    'sc_multi_d2q9': ('sc_multi.cu', 'sailfish_tpu/ops/pallas_multi2d.py:91'),
    # the K = 3 and forced modes of make_kernel_3d_sc_multi /
    # make_kernel_2d_sc_multi, and the K = 3 pre-pass
    'sc_multi_force_d3q19': ('sc_multi.cu',
                             'sailfish_tpu/ops/pallas_multi3d.py:57'),
    'sc_multi_force_d2q9': ('sc_multi.cu',
                            'sailfish_tpu/ops/pallas_multi2d.py:91'),
    'sc_multi_k3_d3q19': ('sc_multi.cu',
                          'sailfish_tpu/ops/pallas_multi3d.py:57'),
    'sc_multi_k3_d2q9': ('sc_multi.cu',
                         'sailfish_tpu/ops/pallas_multi2d.py:91'),
    'sc_multi_k3_force_d3q19': ('sc_multi.cu',
                                'sailfish_tpu/ops/pallas_multi3d.py:57'),
    'sc_multi_k3_force_d2q9': ('sc_multi.cu',
                               'sailfish_tpu/ops/pallas_multi2d.py:91'),
    'rho_poststream_k3_d3q19': ('sc_multi.cu',
                                'sailfish_tpu/ops/pallas_step.py:2409'),
    'rho_poststream_k3_d2q9': ('sc_multi.cu',
                               'sailfish_tpu/ops/pallas_step2d.py:1069'),
    'fe_step_d3q19': ('fe_step.cu', 'sailfish_tpu/ops/pallas_multi3d.py:820'),
    'fe_step_d2q9': ('fe_step.cu', 'sailfish_tpu/ops/pallas_multi2d.py:756'),
    'lbm_step_vary_d3q19': ('lbm_step.cu',
                            'sailfish_tpu/ops/pallas_step.py:2197'),
    'lbm_step_vary_d2q9': ('lbm_step.cu',
                           'sailfish_tpu/ops/pallas_step2d.py:900'),
    # the forcing mode of make_kernel_3d / make_kernel_2d
    'lbm_step_force_d3q19': ('lbm_step.cu',
                             'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_force_d2q9': ('lbm_step.cu',
                            'sailfish_tpu/ops/pallas_step2d.py:36'),
    # the link-tagged, TMS, slip and dynamic families of the patch kernels
    'lbm_step_wall_d3q19': ('lbm_step.cu',
                            'sailfish_tpu/ops/pallas_step.py:2197'),
    'lbm_step_dyn_d3q19': ('lbm_step.cu',
                           'sailfish_tpu/ops/pallas_step.py:2197'),
    'lbm_step_dyn_d2q9': ('lbm_step.cu',
                          'sailfish_tpu/ops/pallas_step2d.py:900'),
    # the collision-model mode of make_kernel_3d / make_kernel_2d
    'lbm_step_mrt_d3q19': ('lbm_step_mrt.cu',
                           'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_les_d3q19': ('lbm_step_les.cu',
                           'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_mrt_d2q9': ('lbm_step_mrt.cu',
                          'sailfish_tpu/ops/pallas_step2d.py:36'),
    # the sc and shallow-water modes of make_kernel_3d / make_kernel_2d,
    # and their pre-pass at nk = 1
    'lbm_step_sc_d3q19': ('lbm_step.cu',
                          'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_sc_d2q9': ('lbm_step.cu',
                         'sailfish_tpu/ops/pallas_step2d.py:36'),
    'lbm_step_sw_d2q9': ('lbm_step.cu',
                         'sailfish_tpu/ops/pallas_step2d.py:36'),
    'rho_poststream_nk1_d3q19': ('sc_multi.cu',
                                 'sailfish_tpu/ops/pallas_step.py:2409'),
    'rho_poststream_nk1_d2q9': ('sc_multi.cu',
                                'sailfish_tpu/ops/pallas_step2d.py:1069'),
    # the mixed (int16 storage) mode of make_kernel_3d / make_kernel_2d
    'lbm_step_mixed_d3q19': ('lbm_step_mixed.cu',
                             'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_mixed_d2q9': ('lbm_step_mixed.cu',
                            'sailfish_tpu/ops/pallas_step2d.py:36'),
    # the ELBM mode of make_kernel_3d / make_kernel_2d (fp32 and int16)
    'lbm_step_elbm_d3q19': ('lbm_step_elbm.cu',
                            'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_elbm_d2q9': ('lbm_step_elbm.cu',
                           'sailfish_tpu/ops/pallas_step2d.py:36'),
    'lbm_step_mixed_elbm_d3q19': ('lbm_step_mixed_elbm.cu',
                                  'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_mixed_elbm_d2q9': ('lbm_step_mixed_elbm.cu',
                                 'sailfish_tpu/ops/pallas_step2d.py:36'),
    # make_kernel_3d on the D3Q15 and D3Q27 lattices (builder.grid)
    'lbm_step_d3q15': ('lbm_step_lattices.cu',
                       'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_d3q27': ('lbm_step_lattices.cu',
                       'sailfish_tpu/ops/pallas_step.py:812'),
    # the patch-plane / patch-block mode of make_kernel_3d / make_kernel_2d
    # (the outflow family), and the laminarize plane means of the XLA
    # prologue that feeds it
    'lbm_step_outflow_d3q19': ('lbm_step_outflow.cu',
                               'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_outflow_d2q9': ('lbm_step_outflow.cu',
                              'sailfish_tpu/ops/pallas_step2d.py:36'),
    'laminarize_mean_d2q9': ('lbm_step_outflow.cu',
                             'sailfish_tpu/ops/pallas_step2d.py:36'),
    # the sharded patch-plane / patch-block mode (dyn_patches on a shard)
    # and the laminarize plane means over the mesh
    'lbm_step_ghost_outflow_d3q19': ('lbm_step_outflow.cu',
                                     'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_ghost_outflow_d2q9': ('lbm_step_outflow.cu',
                                    'sailfish_tpu/ops/pallas_step2d.py:36'),
    'laminarize_mean_ghost_d2q9': ('lbm_step_outflow.cu',
                                   'sailfish_tpu/ops/pallas_step2d.py:36'),
    # the sharded mode of make_kernel_3d / make_kernel_2d: the step on a
    # shard's padded slab, and the exchange that fills its ghost inputs
    'lbm_step_ghost_d3q19': ('lbm_step.cu',
                             'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_ghost_d2q9': ('lbm_step.cu',
                            'sailfish_tpu/ops/pallas_step2d.py:36'),
    'lbm_step_ghost_wall_d3q19': ('lbm_step.cu',
                                  'sailfish_tpu/ops/pallas_step.py:812'),
    'halo_exchange_d3q19': ('halo.cu', 'sailfish_tpu/ops/pallas_step.py:812'),
    'halo_exchange_d2q9': ('halo.cu',
                           'sailfish_tpu/ops/pallas_step2d.py:36'),
    # the sharded (edge_io / emit_rho) modes of the pre-pass and the
    # mixture and free-energy steps, the sc mode on a slab, and the
    # density exchange that feeds their ghost planes
    'rho_poststream_ghost_d3q19': ('sc_multi.cu',
                                   'sailfish_tpu/ops/pallas_step.py:2409'),
    'rho_poststream_ghost_d2q9': ('sc_multi.cu',
                                  'sailfish_tpu/ops/pallas_step2d.py:1069'),
    'sc_multi_ghost_d3q19': ('sc_multi.cu',
                             'sailfish_tpu/ops/pallas_multi3d.py:57'),
    'sc_multi_ghost_d2q9': ('sc_multi.cu',
                            'sailfish_tpu/ops/pallas_multi2d.py:91'),
    'fe_step_ghost_d3q19': ('fe_step.cu',
                            'sailfish_tpu/ops/pallas_multi3d.py:820'),
    'fe_step_ghost_d2q9': ('fe_step.cu',
                           'sailfish_tpu/ops/pallas_multi2d.py:756'),
    'lbm_step_ghost_sc_d3q19': ('lbm_step.cu',
                                'sailfish_tpu/ops/pallas_step.py:812'),
    'lbm_step_ghost_sc_d2q9': ('lbm_step.cu',
                               'sailfish_tpu/ops/pallas_step2d.py:36'),
    'rho_poststream_nk1_ghost_d3q19': (
        'sc_multi.cu', 'sailfish_tpu/ops/pallas_step.py:2409'),
    'rho_poststream_nk1_ghost_d2q9': (
        'sc_multi.cu', 'sailfish_tpu/ops/pallas_step2d.py:1069'),
    'halo_rho_exchange_d3q19': ('halo.cu',
                                'sailfish_tpu/ops/pallas_multi3d.py:57'),
    'halo_rho_exchange_d2q9': ('halo.cu',
                               'sailfish_tpu/ops/pallas_multi2d.py:91'),
    # the edge mode of both exchanges on two-axis meshes
    'halo_edge_exchange_d3q19': ('halo.cu',
                                 'sailfish_tpu/ops/pallas_step.py:812'),
    'halo_edge_exchange_d2q9': ('halo.cu',
                                'sailfish_tpu/ops/pallas_step2d.py:36'),
    'halo_rho_edge_exchange_d3q19': ('halo.cu',
                                     'sailfish_tpu/ops/pallas_multi3d.py:57'),
    'halo_rho_edge_exchange_d2q9': ('halo.cu',
                                    'sailfish_tpu/ops/pallas_multi2d.py:756'),
}
#: what of the TPU kernel a row stands for, where one TPU kernel has two
MODES = {
    'lbm_step_force_d3q19': 'make_kernel_3d, forcing mode (_moments, '
                            '_force_term, _edm_prep, _edm_term)',
    'lbm_step_force_d2q9': 'make_kernel_2d, forcing mode',
    'lbm_step_wall_d3q19': 'make_bc_patch_kernel_3d, link-tagged walls '
                           '(half-way bounce-back under the Guo force)',
    'lbm_step_dyn_d3q19': 'make_bc_patch_kernel_3d, dynamic families '
                          '(time-only density rows)',
    'lbm_step_dyn_d2q9': 'make_bc_patch_kernel_2d, dynamic families (a '
                         'space- and time-dependent inlet)',
    'lbm_step_mrt_d3q19': 'make_kernel_3d, collision-model mode: MRT/TRT '
                          '(mrt_pair_rates, _collide_pair)',
    'lbm_step_les_d3q19': 'make_kernel_3d, collision-model mode: the LES '
                          'tau field (_collide_prepass) under Guo',
    'lbm_step_mrt_d2q9': 'make_kernel_2d, collision-model mode: MRT with the '
                         'conserved-moment correction (_mrt_corr) under Guo',
    'sc_multi_force_d3q19': 'make_kernel_3d_sc_multi, K = 2 with Guo forces '
                            '(pallas_multi3d.py:548-575)',
    'sc_multi_force_d2q9': 'make_kernel_2d_sc_multi, K = 2 with Guo forces '
                           '(pallas_multi2d.py:521-545)',
    'sc_multi_k3_d3q19': 'make_kernel_3d_sc_multi, K = 3',
    'sc_multi_k3_d2q9': 'make_kernel_2d_sc_multi, K = 3',
    'sc_multi_k3_force_d3q19': 'make_kernel_3d_sc_multi, K = 3 with Guo '
                               'forces',
    'sc_multi_k3_force_d2q9': 'make_kernel_2d_sc_multi, K = 3 with Guo '
                              'forces',
    'rho_poststream_k3_d3q19': 'make_rho_kernel_3d, K = 3',
    'rho_poststream_k3_d2q9': 'make_rho_kernel_2d, K = 3',
    'lbm_step_sc_d3q19': 'make_kernel_3d, sc mode: the psi velocity shift '
                         'u + tau F / rho (_sc_shift_moments, '
                         'pallas_step.py:714-785) from the pre-pass '
                         'density, classic potential',
    'lbm_step_sc_d2q9': 'make_kernel_2d, sc mode (_sc_shift_moments; the '
                        'sc argument, pallas_step2d.py:38, :491-536)',
    'lbm_step_sw_d2q9': 'make_kernel_2d, the shallow-water equilibrium '
                        '(the _feq_i branch, pallas_step.py:289-294) with '
                        'gravity',
    'rho_poststream_nk1_d3q19': 'make_rho_kernel_3d, nk = 1 (the '
                                'single-component Shan-Chen pre-pass)',
    'rho_poststream_nk1_d2q9': 'make_rho_kernel_2d, nk = 1 (the '
                               'single-component Shan-Chen pre-pass)',
    'lbm_step_mixed_d3q19': 'make_kernel_3d, mixed mode: int16 codes '
                            'dequantized and requantized in registers '
                            '(pallas_step.py:961-978, dequant_i / quant_i '
                            ':1574-1768), with the lid rows of '
                            'make_bc_patch_kernel_3d (:2220-2271)',
    'lbm_step_mixed_d2q9': 'make_kernel_2d, mixed mode (pallas_step2d.py'
                           ':128-132, :455-622), with the lid rows of '
                           'make_bc_patch_kernel_2d (:921-979)',
    'lbm_step_elbm_d3q19': 'make_kernel_3d, ELBM mode (_collide_elbm '
                           ':529-555, called at :691-693 and :1668-1687), '
                           'with the lid rows of make_bc_patch_kernel_3d '
                           '(_bc_patch_compute :2172-2174)',
    'lbm_step_elbm_d2q9': 'make_kernel_2d, ELBM mode (pallas_step2d.py'
                          ':543-565), with the lid rows of '
                          'make_bc_patch_kernel_2d',
    'lbm_step_mixed_elbm_d3q19': 'make_kernel_3d, ELBM mode on int16 state '
                                 '(quant_i after _collide_elbm, '
                                 'pallas_step.py:1694); launches counted '
                                 'as lbm_step_mixed_d3q19',
    'lbm_step_mixed_elbm_d2q9': 'make_kernel_2d, ELBM mode on int16 state '
                                '(quant_i after _collide_elbm, '
                                'pallas_step2d.py:563); launches counted '
                                'as lbm_step_mixed_d2q9',
    'lbm_step_d3q15': 'make_kernel_3d on the D3Q15 lattice (builder.grid; '
                      'cz_groups :147, pick_slab_k), the Kida vortex with '
                      'its KE/enstrophy hook',
    'lbm_step_d3q27': 'make_kernel_3d on the D3Q27 lattice, with the lid '
                      'rows of make_bc_patch_kernel_3d',
    'lbm_step_outflow_d3q19': 'make_kernel_3d, patch-plane mode (patch_rows '
                              ':834-843, prologue compute_patch_plane '
                              ':2306): a regularized inlet and a Yu outlet '
                              'past a sphere',
    'lbm_step_outflow_d2q9': 'make_kernel_2d, patch-block mode '
                             '(patch_blocks, pallas_step2d.py:57, :138): a '
                             'Zou-He inlet and a copy outlet past a cylinder',
    'laminarize_mean_d2q9': 'make_kernel_2d, patch-block mode: the '
                            'NTLaminarize plane means its XLA prologue '
                            'computes (sailfish_tpu/ops/step.py:543-561), '
                            'a pre-pass of its own',
    'lbm_step_ghost_outflow_d3q19': 'make_kernel_3d, sharded patch-plane '
                                    'mode (dyn_patches / max_patches, '
                                    ':812-838; planes recomputed globally '
                                    'by _compute_patches_padded, '
                                    'parallel/halo.py:653): open_sphere_3d '
                                    'on --mesh=1 and --mesh=1x1',
    'lbm_step_ghost_outflow_d2q9': 'make_kernel_2d, sharded patch-block '
                                   'mode (parallel/halo.py:823-887): '
                                   'open_cylinder_2d on --mesh=1 and 1x1, '
                                   'the laminarize channel on 1x1',
    'laminarize_mean_ghost_d2q9': 'the NTLaminarize plane means of the '
                                  'sharded patch blocks, over the whole '
                                  'mesh in the unsharded order (one launch '
                                  'per step, peer reads across GPUs)',
    'lbm_step_ghost_d3q19': 'make_kernel_3d, sharded mode: z ghost planes '
                            '(fused(f, ghost_lo, ghost_hi, ...), '
                            'pallas_step.py:828-834; ShardedPallasStep3D, '
                            'sailfish_tpu/parallel/halo.py:170), the step '
                            'launched over the shard and its two ghost '
                            'planes (BGK, uniform BC rows); ldc_3d on '
                            '--mesh=1',
    'lbm_step_ghost_wall_d3q19': 'make_kernel_3d, sharded mode with the '
                                 'link-tagged wall rows of '
                                 'make_bc_patch_kernel_3d (TMS walls, Guo '
                                 'force; ShardedPallasStep3D, '
                                 'sailfish_tpu/parallel/halo.py:170); '
                                 'channel_flow on --mesh=1',
    'lbm_step_ghost_d2q9': 'make_kernel_2d, sharded mode: y ghost rows '
                           '(ShardedPallasStep2D, '
                           'sailfish_tpu/parallel/halo.py:760); ldc_2d on '
                           '--mesh=1',
    'halo_exchange_d3q19': 'make_kernel_3d, sharded mode: the ghost planes '
                           'its ghost inputs take, moved by the two '
                           'jax.lax.ppermute of sailfish_tpu/parallel/'
                           'halo.py:361-362 (no Pallas kernel of its own)',
    'halo_exchange_d2q9': 'make_kernel_2d, sharded mode: its ghost rows, '
                          'moved by ppermute (ShardedPallasStep2D)',
    'rho_poststream_ghost_d3q19': 'make_rho_kernel_3d on a z shard '
                                  '(ShardedPallasSCMulti3D / ShardedPallasFE3D'
                                  ', sailfish_tpu/parallel/halo_multi.py:58, '
                                  ':339), K = 2 (nk = 1 for free energy)',
    'rho_poststream_ghost_d2q9': 'make_rho_kernel_2d on a y shard '
                                 '(ShardedPallasSCMulti2D / ShardedPallasFE2D'
                                 ', halo_multi.py:816, :1230)',
    'sc_multi_ghost_d3q19': 'make_kernel_3d_sc_multi, edge_io / emit_rho '
                            'mode (pallas_multi3d.py:57-60): the step over '
                            'a z shard and its ghost planes; '
                            'sc_separation_3d on --mesh=1',
    'sc_multi_ghost_d2q9': 'make_kernel_2d_sc_multi, edge_io mode '
                           '(pallas_multi2d.py:91-94); sc_separation_2d '
                           'on --mesh=1',
    'fe_step_ghost_d3q19': 'make_kernel_3d_fe, edge_io / emit_phi mode '
                           '(pallas_multi3d.py:820-829; two phi ghost planes '
                           'under wetting); fe_separation_3d on --mesh=1',
    'fe_step_ghost_d2q9': 'make_kernel_2d_fe, edge_io / emit_phi mode '
                          '(pallas_multi2d.py:756-758); fe_separation_2d '
                          'on --mesh=1',
    'lbm_step_ghost_sc_d3q19': 'make_kernel_3d, sc mode on a z shard '
                               '(edge_io, sailfish_tpu/parallel/halo.py'
                               ':296-339); sc_phase_separation_3d on '
                               '--mesh=1',
    'lbm_step_ghost_sc_d2q9': 'make_kernel_2d, sc mode on a y shard '
                              '(edge_io, halo.py:893-921); '
                              'sc_phase_separation on --mesh=1',
    'rho_poststream_nk1_ghost_d3q19': 'make_rho_kernel_3d, nk = 1 on a z '
                                      'shard',
    'rho_poststream_nk1_ghost_d2q9': 'make_rho_kernel_2d, nk = 1 on a y '
                                     'shard',
    'halo_rho_exchange_d3q19': 'the post-stream density edges of a z shard '
                               '(stream_rho_edges, sailfish_tpu/parallel/'
                               'halo.py:51-107, and the rglo / rghi '
                               'ppermutes :476-477; no Pallas kernel of its '
                               'own), K = 2',
    'halo_rho_exchange_d2q9': 'the post-stream density edge rows of a y '
                              'shard (ShardedPallasSCMulti2D), K = 2',
    'halo_edge_exchange_d3q19': 'make_kernel_3d, y_ghosts mode (pallas_step'
                                '.py:879-895): the y ghost rows and the z-y '
                                'edges of a (z, y) shard, moved by ppermute '
                                'in two hops (sailfish_tpu/parallel/halo.py'
                                ':364-377), here one launch reading the '
                                'diagonal shard; ldc_3d and sc_separation_3d '
                                'on --mesh=1x1',
    'halo_edge_exchange_d2q9': 'make_kernel_2d, x_ghosts mode (pallas_step2d'
                               '.py:44-53): the x ghost columns and corners '
                               'of a (y, x) shard (halo.py:763-771); '
                               'taylor_green_2d and fe_separation_2d on '
                               '--mesh=1x1',
    'halo_rho_edge_exchange_d3q19': 'make_kernel_3d_sc_multi, y_ghosts '
                                    '(pallas_multi3d.py:57-60): the K = 2 '
                                    'densities\' y ghost rows and edges; '
                                    'sc_separation_3d on --mesh=1x1',
    'halo_rho_edge_exchange_d2q9': 'make_kernel_2d_fe, x_ghosts '
                                   '(pallas_multi2d.py:756-758): phi\'s x '
                                   'ghost columns and corners; '
                                   'fe_separation_2d on --mesh=1x1',
}
#: the parabolic-inlet channels (regularized velocity inlet, density
#: outlet), the main paths of the varying BC rows: scene -> (inlet
#: axis, size, extra flags)
CHANNELS = {
    'parabolic_inlet_3d': ('z', (256, 256, 256), dict(periodic_x=True)),
    'parabolic_inlet_x_3d': ('x', (256, 256, 256), dict(periodic_z=True)),
    'parabolic_inlet_2d': ('y', (4096, 4096), {}),
    'parabolic_inlet_x_2d': ('x', (4096, 4096), {}),
}
#: inlet macro velocity vs the prescribed profile (the BC sets it; fp32
#: rounding of the profile is ~2e-9)
INLET_TOL = 1e-6
CSRC = 'sailfish_tpu_torch/ops/csrc/'
DEVICE = 'cuda'


T0 = time.perf_counter()


def say(*parts):
    """Print a line of the log, after the seconds since the script
    started."""
    print(f'[{time.perf_counter() - T0:.1f} s]', *parts, flush=True)


def phase_done(what):
    """Print the seconds since the script started, after ``what``."""
    say(f'{what} done')


def compare(name, sim_cls, steps=200, force_model=None, bc=True, **cfg):
    """Kernel vs step_reference on the card from one random state. With
    ``force_model`` the scene has a body force and runs the kernel's
    instantiation of that model; ``bc``: whether it has native-BC nodes
    (mask codes 3+), which then take the force too."""
    if force_model:
        cfg['force_implementation'] = force_model
    r = run(with_keep_block(sim_cls), platform=DEVICE, engine='kernel',
            max_iters=0, **cfg)
    ks = r.kernel
    grid = r.sim.grid.name
    codes = sorted(torch.unique(ks.mask).tolist())
    assert codes[:3] == [0, 1, 2] and (codes[-1] >= 3) == bc, codes
    kind = 'force_' if force_model else ''
    assert ks.name == f'lbm_step_{kind}{grid.lower()}', ks.name
    assert ks.params.force.model == ls.FORCE_CODES.get(force_model, 0)
    f0 = random_feq(r.sim.grid, ks.shape, seed=1234, device=DEVICE)
    fk = ks.run(f0, steps)
    fr = f0
    for _ in range(steps):
        fr = ks.reference(fr)
    util.synchronize(DEVICE)
    assert ks.launches == steps and not ks.vary
    err = float((fk - fr)[:, wet_mask(ks)].abs().max())
    forced_by = ''
    if force_model:
        # what the force moved: against the unforced plain version
        fu = f0
        for _ in range(steps):
            fu = ls.step_reference(fu, ks.mask, ks.table, ks.grid,
                                   ks.tau_inv)
        moved = float((fk - fu)[:, wet_mask(ks)].abs().max())
        assert moved > 10 * TOL, moved
        forced_by = (f', force {ks.force} by {force_model} (moved the '
                     f'state by {moved:.3e})')
    say(f'compare {name}: {grid} {ks.shape} {steps} steps of {ks.name}, '
        f'mask codes {codes}{forced_by}, wet max|df| = {err:.3e} (tol '
        f'{TOL:g})')
    assert np.isfinite(err) and err <= TOL, err
    del r, ks, f0, fk, fr
    torch.cuda.empty_cache()
    return grid, err


def channel(dim, axis, pair='regularized', profile='parabolic'):
    """The channel of ``dim`` dimensions flowing along ``axis``."""
    if dim == 3:
        return channel_sim(pair, axis, profile=profile)
    return channel_sim_2d(pair, profile=profile, axis=axis)


def wet_mask(ks):
    return (ks.mask == 0) | (ks.mask >= 3)


def vary_errors(ks, f0, steps):
    """Wet-node max |df| of the kernel with varying BC rows against
    ``step_reference`` after ``steps`` steps from ``f0``."""
    fk = ks.run(f0, steps)
    fr = f0
    for _ in range(steps):
        fr = ks.reference(fr)
    util.synchronize(DEVICE)
    err = float((fk - fr)[:, wet_mask(ks)].abs().max())
    assert np.isfinite(err) and err <= TOL, err
    return err


def vary_compare(name, dim, axis, pair, steps=200, **cfg):
    """The kernel with varying BC rows vs ``step_reference`` on the card from
    one random state, on a parabolic-inlet channel with a block of
    excluded nodes and a thinned inlet face (every mask code, a face with
    holes, several varying instances)."""
    sim_cls = with_patch_row_mix(
        with_keep_block(channel(dim, axis, pair)), axis)
    r = run(sim_cls, platform=DEVICE, engine='kernel', max_iters=0, **cfg)
    ks = r.kernel
    codes = sorted(torch.unique(ks.mask).tolist())
    varying = [j for j, row in enumerate(ks.table) if row.box is not None]
    assert ks.vary and varying and codes[:4] == [0, 1, 2, 3], codes
    f0 = random_feq(ks.grid, ks.shape, seed=1234, device=DEVICE)
    err = vary_errors(ks, f0, steps)
    assert ks.launches == steps
    grid = ks.grid.name
    say(f'compare {name}: {grid} {ks.shape}, inlet normal to {axis}, mask '
        f'codes {codes}, varying instances {varying} ({ks.bcp.numel()} '
        f'parameter floats), {steps} steps of {ks.name}, wet max|df| = '
        f'{err:.3e} (tol {TOL:g})')
    del r, ks, f0
    torch.cuda.empty_cache()
    return grid, err


def slice_compare(name, sim_cls, it0=0, steps=200, force_model=None, **cfg):
    """The kernel with wall rows or per-step values vs ``step_reference`` on
    the card from one random state, the reference given the values the
    kernel was given before each launch (``set_iteration``), from iteration
    ``it0``. Asserts what the new rows moved: for wall rows the wall nodes
    after one step against full bounce-back walls, for per-step values the
    state after ``steps`` against the same steps from iteration 0."""
    if force_model:
        cfg['force_implementation'] = force_model
    r = run(sim_cls, platform=DEVICE, engine='kernel', max_iters=0, **cfg)
    ks = r.kernel
    dyn = bool(ks.dynamic) or ks.force_expr is not None
    kind = 'dyn_' if dyn else 'wall_'
    assert ks.name == f'lbm_step_{kind}{ks.grid.name.lower()}', ks.name
    assert ks.params.force.model == ls.FORCE_CODES.get(
        ks.force_model if ks.force else None, 0)
    codes = sorted(torch.unique(ks.mask).tolist())
    f0 = random_feq(ks.grid, ks.shape, seed=1234, device=DEVICE)
    fk = ks.run(f0, steps, it0=it0).clone()
    fr = f0
    for i in range(steps):
        ks.set_iteration(it0 + i)
        fr = ks.reference(fr)
    util.synchronize(DEVICE)
    assert ks.launches == steps
    wet = wet_mask(ks)
    err = float((fk - fr)[:, wet].abs().max())
    if dyn:
        # a density swing of 1.5 dp = 1.6e-4 (womersley at 64^3) moves the
        # distributions by ~5e-5 in 200 steps: well above the tolerance
        moved = float((fk - ks.run(f0, steps))[:, wet].abs().max())
        what = f'per-step values from iteration {it0}'
        assert moved > TOL, moved
    else:
        moved = walls_moved(ks, f0)
        what = 'wall rows against full bounce-back'
        assert moved > 1e-4, moved
    rows = ', '.join(f'{nt.get_node_type(row.type_id).__name__}'
                     f'{"[box]" if row.box else ""}' for row in ks.table)
    say(f'compare {name}: {ks.grid.name} {ks.shape} {steps} steps of '
        f'{ks.name}, rows [{rows}], mask codes {codes}, force '
        f'{ks.force_model if ks.force else None}; {what} moved the state by '
        f'{moved:.3e}; wet max|df| = {err:.3e} (tol {TOL:g})')
    assert np.isfinite(err) and err <= TOL, err
    grid = ks.grid.name
    del r, ks, f0, fk, fr
    torch.cuda.empty_cache()
    return f'lbm_step_{kind}{grid.lower()}', err


def model_compare(name, sim_cls, coll, force_model=None, it0=0, steps=200,
                  **cfg):
    """A collision model's instantiation (``COLLISION[coll]``) vs
    ``step_reference`` on the card from one random state, from iteration
    ``it0``, under ``force_model``: one launch (wet max |df| <= 1e-6) and
    ``steps`` steps (<= ``TOL``). Asserts that the model moved one step
    from that state away from BGK with the compressible equilibrium (the
    same plain version without the model) by more than 10 ``TOL``: after
    200 steps a closed box has nearly come to rest under either, so the
    long comparison alone could miss a kernel that ignored the model."""
    if force_model:
        cfg['force_implementation'] = force_model
    flags = COLLISION[coll]
    r = run(sim_cls, platform=DEVICE, engine='kernel', max_iters=0,
            **flags, **cfg)
    ks = r.kernel
    c = ks.params.coll
    want = ls.MODEL_CODES[flags.get('model', 'les' if 'subgrid' in flags
                                    else 'bgk')]
    assert (c.model, c.equilibrium == ls.EQ_CODES['incompressible']) == (
        want, flags.get('incompressible', False)), (c.model, want)
    assert ks.params.force.model == ls.FORCE_CODES.get(force_model, 0)
    codes = sorted(torch.unique(ks.mask).tolist())
    f0 = random_feq(ks.grid, ks.shape, seed=1234, device=DEVICE)
    wet = wet_mask(ks)
    one = torch.empty_like(f0)
    ks.step_into(f0, one, it0)
    ref = ks.reference(f0)
    bgk = ls.step_reference(f0, ks.mask, ks.table, ks.grid, ks.tau_inv,
                            ks.bcp, ks.force, ks.force_model, ks.tags)
    util.synchronize(DEVICE)
    err1 = float((one - ref)[:, wet].abs().max())
    moved = float((ref - bgk)[:, wet].abs().max())
    del one, ref, bgk
    fk = ks.run(f0, steps, it0=it0).clone()
    fr = f0
    for i in range(steps):
        ks.set_iteration(it0 + i)
        fr = ks.reference(fr)
    util.synchronize(DEVICE)
    assert ks.launches == steps + 1
    err = float((fk - fr)[:, wet].abs().max())
    say(f'compare {name}: {ks.grid.name} {ks.shape} {steps} steps of '
        f'{ks.name} (model code {c.model}, equilibrium code '
        f'{c.equilibrium}, force {force_model}), mask codes {codes}; one '
        f'step: the model moved the state from BGK by {moved:.3e}, wet '
        f'max|df| = {err1:.3e} (tol 1e-06); {steps} steps: wet max|df| = '
        f'{err:.3e} (tol {TOL:g})')
    assert np.isfinite(err1) and err1 <= 1e-6, err1
    assert np.isfinite(err) and err <= TOL, err
    assert moved > 10 * TOL, moved
    key = ks.name
    del r, ks, f0, fk, fr
    torch.cuda.empty_cache()
    return key, err


def golden(scene, sim_cls, golden_name=None, engine='kernel', atol=None,
           **cfg):
    """The default engine on the card (the kernel engine; ``engine='torch'``
    for a scene the kernels refuse by name) on the golden harness's small
    scene (20 steps, seed 1234) against tests/goldens at the harness
    tolerance; ``atol`` maps a field to another absolute tolerance (as
    ``torch_scenes.golden_run``)."""
    golden_name = golden_name or scene
    if engine != 'kernel':
        cfg['engine'] = engine
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, scene)
        r = run(sim_cls, platform=DEVICE, max_iters=20, every=20,
                seed=1234, output=out, **cfg)
        assert r.engine == engine and r.device.type == DEVICE, r.engine
        if engine == 'kernel':
            launches = r.kernel.launches
            assert set(launches.values() if isinstance(launches, dict)
                       else [launches]) == {20}, launches
        data = np.load(f'{out}.0.0000020.npz')
        ref = np.load(os.path.join(REPO, 'tests', 'goldens',
                                   f'{golden_name}.npz'))
        worst = 0.0
        for k in ref.files:
            np.testing.assert_allclose(data[k], ref[k], rtol=1e-5,
                                       atol=(atol or {}).get(k, 5e-7),
                                       err_msg=f'{scene}:{k}')
            worst = max(worst, float(np.max(np.abs(data[k] - ref[k]))))
    say(f'golden {golden_name}: {engine} engine matches tests/goldens '
        f'(max |d| = {worst:.3e}; rtol 1e-5, atol {atol or 5e-7})')


def sc_reference_step(ks, grid, fs):
    """One step of the plain versions: the pre-pass, then the coupled
    step."""
    return ks.reference(fs, [sm.rho_reference(f, grid) for f in fs])


def sc_errors(ks, grid, f0, steps):
    """(pre-pass max |d rho|, wet-node max |d f| after ``steps`` steps)
    of the Shan-Chen kernels against their plain versions from the
    K-tuple ``f0``."""
    rho = torch.empty_like(ks.rho)
    ks.density_into(torch.stack(f0), rho)
    rho_ref = torch.stack([sm.rho_reference(f, grid) for f in f0])
    rho_err = float((rho - rho_ref).abs().max())
    del rho, rho_ref
    fk = ks.run(f0, steps)
    fr = f0
    for _ in range(steps):
        fr = sc_reference_step(ks, grid, fr)
    util.synchronize(DEVICE)
    wet = ks.mask == 0
    err = max(float((a - b)[:, wet].abs().max()) for a, b in zip(fk, fr))
    assert np.isfinite(rho_err) and rho_err <= RHO_TOL, rho_err
    assert np.isfinite(err) and err <= TOL, err
    return rho_err, err


def sc_compare(name, sim_cls, steps=20, tile=None, **cfg):
    """The Shan-Chen kernels vs their plain versions on the card from one
    seeded near-uniform K-component state (each density 1 + U(0, 1e-3), as
    the separation scenes start), with a block of excluded nodes; a D3Q19
    step on ``tile`` if given. Returns (step launch name, pre-pass row
    name, pre-pass error, step error)."""
    r = run(with_keep_block(sim_cls), platform=DEVICE, engine='kernel',
            max_iters=0, **cfg)
    ks = r.kernel
    if tile:
        ks.set_tile(tile)
    grid = r.sim.grid
    codes = sorted(torch.unique(ks.mask).tolist())
    f0 = tuple(random_binary_state(grid, ks.shape, seed=1234,
                                   device=DEVICE, K=ks.K))
    rho_err, err = sc_errors(ks, grid, f0, steps)
    assert ks.launches == {ks.rho_name: steps + 1, ks.name: steps}
    couplings = ', '.join(f'G{j + 1}{k + 1} {g:g}'
                          for (j, k), g in ks.couplings.items() if g)
    forces = ', '.join(f'a{k + 1} {tuple(float(x) for x in a)}'
                       for k, a in enumerate(ks.accels) if a is not None)
    tiled = '' if ks.tile is None else \
        f' tile {ks.tile.tx}x{ks.tile.ty}x{ks.tile.kz} grid {ks.tile.grid},'
    say(f'compare {name}: {ks.name}, {grid.name} K={ks.K} {ks.shape}{tiled} '
        f'{ks.potential}, {couplings}{", " + forces if forces else ""}, mask '
        f'codes {codes}: pre-pass max|drho| = {rho_err:.3e} (tol '
        f'{RHO_TOL:g}); {steps} steps wet max|df| = {err:.3e} (tol {TOL:g})')
    names = ks.name, prepass_row(ks)
    del r, ks, f0
    torch.cuda.empty_cache()
    return names + (rho_err, err)


def prepass_row(ks):
    """The JSON row of ``ks``'s pre-pass: ``rho_poststream_<grid>`` at K =
    2 (and nk = 1 for free energy), ``rho_poststream_k3_<grid>`` at K =
    3."""
    g = ks.grid.name.lower()
    return f'rho_poststream_k3_{g}' if ks.K == 3 else ks.rho_name


def sc_refusals():
    """On the card, the default engine refuses by name the mixtures the
    kernels cannot run, and changes no engine: half-way walls, a per-node
    force, a DynamicValue force, K = 4."""
    from sailfish_tpu_torch.ops.multigrid import ShanChenMultiStepBuilder
    cases = []
    flags = SC_MORE_GOLDEN_FLAGS['sc_poiseuille_2d']
    cases.append(('half-way walls', lambda: run(
        binary_twin('sc_poiseuille_2d'), max_iters=0, **flags),
        'NTHalfBBWall'))

    class PerNode(SEP_2D):
        def __init__(self, config):
            super().__init__(config)
            self.add_body_force(np.full((2, 64, 64), 1e-6), grid=1)

    class Ramped(SEP_2D):
        def __init__(self, config):
            super().__init__(config)
            self.add_body_force((0.0, lambda t: -1e-9 * t), grid=1)

    small = dict(lat_nx=64, lat_ny=64)
    cases.append(('a per-node force', lambda: run(PerNode, max_iters=0,
                                                   **small),
                  'space-varying body force on component 1'))
    cases.append(('a DynamicValue force', lambda: run(Ramped, max_iters=0,
                                                       **small),
                  'DynamicValue body forces'))
    r = run(SEP_2D, engine='torch', max_iters=0, **small)

    def four():
        b = ShanChenMultiStepBuilder(r.sim.grid, r.maps, [1.0] * 4,
                                     {(0, 1): 1.0}, device=DEVICE)
        return sm.SCMultiStep(b)

    cases.append(('K = 4', four, '4 components'))
    for what, make, reason in cases:
        try:
            make()
        except NotImplementedError as exc:
            assert reason in str(exc), (what, str(exc))
            say(f'refused on the default engine: a mixture with {what} '
                f'({reason!r} in: {str(exc)[:160]})')
            continue
        raise AssertionError(f'a mixture with {what} was not refused')


def sw_fp64_check(ks, f0, fk, fr, steps, it0=0):
    """The shallow-water mode's criterion: the kernel's ``fk`` within TOL
    or within ``FP64_FACTOR`` times the fp32 plain version's ``fr``
    distance to the fp64 plain version after ``steps`` from ``f0``
    (``torch_scenes.fp64_distances``). Returns (k64, p64) and the text."""
    d = fp64_distances(ks, f0, fk, fr, steps, it0)
    k64, p64 = d['k64'], d['p64']
    assert np.isfinite(k64) and k64 <= max(TOL, FP64_FACTOR * p64), d
    return (f'; against the fp64 plain version kernel {k64:.3e}, fp32 '
            f'plain {p64:.3e} (tol {FP64_FACTOR:g}x that, or {TOL:g})')


def single_mode_compare(name, sim_cls, steps=20, **cfg):
    """The kernel's Shan-Chen or shallow-water mode against
    ``step_reference`` (in the Shan-Chen mode after ``rho_reference``) on
    the card from the scene's own seeded start, ``steps`` steps; the
    Shan-Chen pre-pass against ``rho_reference`` after one launch. Asserts
    that the mode moved the state: against the same steps of the plain
    version without it (no coupling; the second-order equilibrium).
    Returns (step row, pre-pass row or None, step error, pre-pass
    error)."""
    r = run(sim_cls, platform=DEVICE, engine='kernel', max_iters=0,
            seed=1234, **cfg)
    ks = r.kernel
    g = ks.grid.name.lower()
    assert ks.name == f'lbm_step_{"sc" if ks.sc else "sw"}_{g}', ks.name
    codes = sorted(torch.unique(ks.mask).tolist())
    f0 = r.f.clone()
    rho_err = None
    if ks.sc:
        rho = torch.empty_like(ks.rho)
        ks.density_into(f0, rho)
        rho_err = float((rho - sm.rho_reference(f0, ks.grid)).abs().max())
        del rho
        assert np.isfinite(rho_err) and rho_err <= RHO_TOL, rho_err
    fk = ks.run(f0, steps)
    fr = fb = f0
    for it in range(steps):
        ks.set_iteration(it)
        fr = ks.reference(fr)
        fb = ls.step_reference(fb, ks.mask, ks.table, ks.grid, ks.tau_inv,
                               ks.bcp, ks.force, ks.force_model, ks.tags)
    util.synchronize(DEVICE)
    assert ks.launches == steps
    assert ks.prepass_launches == (steps + 1 if ks.sc else 0)
    wet = wet_mask(ks)
    err = float((fk - fr)[:, wet].abs().max())
    moved = float((fr - fb)[:, wet].abs().max())
    mode = (f'G {ks.sc_coupling:g}, {ks.sc_potential} psi' if ks.sc else
            f'gravity {ks.gravity:g}')
    pre = '' if rho_err is None else \
        f'pre-pass max|drho| = {rho_err:.3e} (tol {RHO_TOL:g}); '
    if ks.sc:
        held = f' (tol {TOL:g})'
        assert np.isfinite(err) and err <= TOL, err
    else:
        held = sw_fp64_check(ks, f0, fk, fr, steps)
    say(f'compare {name}: {ks.grid.name} {ks.shape} {steps} steps of '
        f'{ks.name} ({mode}, force {ks.force_model if ks.force else None}, '
        f'tau {1.0 / ks.tau_inv:g}), mask codes {codes}: {pre}wet max|df| '
        f'= {err:.3e}{held}; the mode moved the state by {moved:.3e}')
    assert moved > 10 * TOL, moved
    names = ks.name, ks.rho_name if ks.sc else None
    del r, ks, f0, fk, fr, fb
    torch.cuda.empty_cache()
    return names + (err, rho_err)


def single_mode_refusals():
    """On the card, the default engine refuses by name the single-fluid
    Shan-Chen and shallow-water scenes the kernel cannot run (what the
    JAX router keeps off its kernels, ``sailfish_tpu/runner.py:355-385``)
    and changes no engine."""
    from sailfish_tpu_torch.models.base import LBForcedSim
    from sailfish_tpu_torch.ops.step import StepBuilder
    small = dict(lat_nx=64, lat_ny=64)

    class Ramped(SC_2D, LBForcedSim):
        def __init__(self, config):
            super().__init__(config)
            self.add_body_force((lambda t: 1e-6 * t, 0.0))

    def with_rows(node_type):
        class Scene(SC_2D.subdomain):
            def boundary_conditions(self, hx, hy):
                self.set_node((hy == 0) | (hy == self.gy - 1), node_type)

        class Sim(SC_2D):
            subdomain = Scene

        return Sim

    def builder(**kwargs):
        r = run(FS, engine='torch', max_iters=0, **small)
        return lambda: ls.KernelStep(StepBuilder(
            r.sim.grid, r.maps, visc=0.1, device=DEVICE, **kwargs))

    cases = [
        ('Shan-Chen under MRT', lambda: run(SC_2D, max_iters=0, model='mrt',
                                            **small),
         'Shan-Chen with model=mrt'),
        ('Shan-Chen under LES', lambda: run(
            SC_2D, max_iters=0, subgrid='les-smagorinsky', **small),
         'Shan-Chen with the Smagorinsky LES model'),
        ('Shan-Chen with an EDM force', lambda: run(
            forced(SC_2D, SW_ACCEL), max_iters=0,
            force_implementation='edm', **small),
         'Shan-Chen with the edm body force'),
        ('Shan-Chen with a velocity-shift force', lambda: run(
            forced(SC_2D, SW_ACCEL), max_iters=0,
            force_implementation='velocity_shift', **small),
         'Shan-Chen with the velocity_shift body force'),
        ('Shan-Chen with a DynamicValue force', lambda: run(
            Ramped, max_iters=0, **small),
         'Shan-Chen with a DynamicValue body force'),
        ('Shan-Chen with native BC rows', lambda: run(
            with_rows(nt.NTZouHeDensity(1.0)), max_iters=0,
            periodic_y=False, **small), 'Shan-Chen with BC rows'),
        ('Shan-Chen with half-way walls', lambda: run(
            with_rows(nt.NTHalfBBWall), max_iters=0, periodic_y=False,
            **small), 'NTHalfBBWall'),
        ('Shan-Chen with slip walls', lambda: run(
            with_rows(nt.NTSlip), max_iters=0, periodic_y=False, **small),
         'NTSlip'),
        ('Shan-Chen with the shallow-water equilibrium', builder(
            sc_coupling=-5.0, equilibrium='shallow_water', gravity=1e-3),
         'Shan-Chen with the shallow-water equilibrium'),
        ('shallow water under MRT', builder(
            model='mrt', equilibrium='shallow_water', gravity=1e-3),
         'shallow water with model=mrt'),
        ('shallow water under LES', builder(
            smagorinsky=0.1, equilibrium='shallow_water', gravity=1e-3),
         'shallow water with the Smagorinsky LES model'),
        ('shallow water with EDM', builder(
            body_force=SW_ACCEL, force_model='edm',
            equilibrium='shallow_water', gravity=1e-3),
         'shallow water with the edm body force'),
    ]
    for what, make, reason in cases:
        try:
            make()
        except NotImplementedError as exc:
            assert reason in str(exc), (what, str(exc))
            say(f'refused on the default engine: {what} ({reason!r} in: '
                f'{str(exc)[:160]})')
            continue
        raise AssertionError(f'{what} was not refused')


def fe_errors(ks, f0, steps):
    """(pre-pass max |d phi|, wet-node max |d f| after ``steps`` steps) of
    the free-energy kernels against their plain versions from the 2-tuple
    ``f0``."""
    grid = ks.grid
    phi = torch.empty_like(ks.phi)
    ks.phi_into(torch.stack(f0), phi)
    phi_err = float((phi - sm.rho_reference(f0[1], grid)).abs().max())
    del phi
    fk = ks.run(f0, steps)
    fr = f0
    for _ in range(steps):
        fr = fe.fe_step_reference(fr, sm.rho_reference(fr[1], grid),
                                  ks.mask, ks.orient, ks.builder)
    util.synchronize(DEVICE)
    wet = ks.mask == 0
    err = max(float((a - b)[:, wet].abs().max()) for a, b in zip(fk, fr))
    assert np.isfinite(phi_err) and phi_err <= RHO_TOL, phi_err
    assert np.isfinite(err) and err <= TOL, err
    return phi_err, err


def fe_compare(name, sim_cls, steps=20, **cfg):
    """The free-energy kernels vs their plain versions on the card from one
    seeded state with sharp interfaces (``random_fe_state``), with a block
    of excluded nodes."""
    r = run(with_keep_block(sim_cls), platform=DEVICE, engine='kernel',
            max_iters=0, **cfg)
    ks = r.kernel
    assert isinstance(ks, fe.FEStep)
    codes = sorted(torch.unique(ks.mask).tolist())
    f0 = tuple(random_fe_state(ks.grid, ks.shape, seed=1234, device=DEVICE))
    phi_err, err = fe_errors(ks, f0, steps)
    assert ks.launches == {ks.rho_name: steps + 1, ks.name: steps}
    b = ks.builder
    say(f'compare {name}: {ks.grid.name} {ks.shape} {b.fe_model}, mask '
        f'codes {codes}, wetting {ks.orient is not None} (wall_grad '
        f'{b.wall_grad_phase:g}), body force {b.body_force is not None}, '
        f'eq_force_map {b.eq_force_map}: pre-pass max|dphi| = '
        f'{phi_err:.3e} (tol {RHO_TOL:g}); {steps} steps wet max|df| = '
        f'{err:.3e} (tol {TOL:g})')
    del r, ks, f0
    torch.cuda.empty_cache()
    return b.grid.name, phi_err, err


def mixed_compare(name, sim_cls, it0=0, steps=MIXED_STEPS, **cfg):
    """The int16 kernel (``lbm_step_mixed_<grid>``) vs ``step_reference``
    on the card in codes from one random state quantized, from iteration
    ``it0`` (``torch_scenes.mixed_errors``: one launch within
    ``MIXED_ONE_STEP`` code of the plain version; after ``steps`` steps
    the kernel within ``FP64_FACTOR`` times the fp32 plain version's
    distance to the fp64 plain version, or within ``MIXED_CODE_FLOOR``
    codes of it). Returns (launch key, wet max |df| of the kernel to the
    fp32 plain version after ``steps``)."""
    r = run(sim_cls, platform=DEVICE, engine='kernel', max_iters=0,
            precision='mixed', mixed_range=MIXED_RANGE, **cfg)
    ks = r.kernel
    g = ks.grid.name.lower()
    assert ks.name == ks.entry == f'lbm_step_mixed_{g}', ks.name
    assert ks.a.dtype == ks.b.dtype == torch.int16
    assert ks.library == ls.MIXED_LIBRARIES[ks.params.coll.model]
    codes = sorted(torch.unique(ks.mask).tolist())
    q0 = ks.mixed.quant(random_feq(ks.grid, ks.shape, seed=1234,
                                   device=DEVICE))
    e = mixed_errors(ks, q0, steps, it0)
    util.synchronize(DEVICE)
    assert ks.launches == steps + 1
    rows = ', '.join(sorted({nt.get_node_type(row.type_id).__name__
                             for row in ks.table}))
    say(f'compare mixed {name}: {ks.grid.name} {ks.shape} {ks.name} '
        f'({ks.library}, force {ks.force_model if ks.force else None}, '
        f'model code {ks.params.coll.model}, equilibrium code '
        f'{ks.params.coll.equilibrium}), rows [{rows}], mask codes {codes}; '
        f'one launch max|dq| = {e["one"]} (tol {MIXED_ONE_STEP}); after '
        f'{steps} steps from iteration {it0}: kernel to fp32 plain '
        f'max|dq| {e["p32"][0]} ({e["p32"][1]:.4f} of codes differ, '
        f'max|df| {e["df"]:.3e}), kernel to fp64 plain {e["k64"][0]} '
        f'({e["k64"][1]:.4f}), fp32 plain to fp64 plain {e["p64"][0]} '
        f'({e["p64"][1]:.4f}) (tol max({MIXED_CODE_FLOOR}, '
        f'{FP64_FACTOR:g} x {e["p64"][0]}))')
    key = ks.name
    del r, ks, q0
    torch.cuda.empty_cache()
    return key, e['df']


def mixed_round_trip():
    """Every one of the 65,536 int16 codes of every direction through the
    kernel's own conversions: a periodic fluid box at 1/tau = 0 stores
    f + 0 (feq - f) = f, so each code must come back, streamed, in both
    lattices."""
    from sailfish_tpu_torch.ops.step import pull
    for dim, size in ((2, dict(lat_nx=256, lat_ny=256)),
                      (3, dict(lat_nx=64, lat_ny=32, lat_nz=32))):
        r = run(periodic_box(dim), platform=DEVICE, engine='kernel',
                max_iters=0, precision='mixed', periodic_x=True,
                periodic_y=True, periodic_z=True, **size)
        ks = r.kernel
        assert ks.table == [] and int(ks.mask.max()) == 0
        ks.tau_inv = ks.params.tau_inv = 0.0
        q = all_codes(ks.grid, ks.shape, DEVICE)
        out = torch.empty_like(q)
        ks.step_into(q, out)
        want = torch.stack([pull(q[i], ks.grid.basis[i])
                            for i in range(ks.grid.Q)])
        util.synchronize(DEVICE)
        same = int((out == want).sum())
        say(f'mixed round trip {ks.grid.name} {ks.shape}: {same} of '
            f'{want.numel()} codes ({ks.grid.Q} directions x 65,536 codes) '
            f'came back unchanged through {ks.name}')
        assert torch.equal(out, want)


def mixed_shear_wave(n=64, visc=0.02, steps=400):
    """Shear-wave decay on the int16 kernel (tests/test_mixed.py:141-176):
    the viscosity measured from the first Fourier mode within 1.5 % of
    the configured one."""
    r = run(periodic_box(3), platform=DEVICE, engine='kernel', max_iters=0,
            precision='mixed', periodic_x=True, periodic_y=True,
            periodic_z=True, lat_nx=n, lat_ny=8, lat_nz=8, visc=visc)
    ks = r.kernel
    assert ks.a.dtype == torch.int16
    nu = shear_wave_viscosity(ks, r.builder, n, visc, steps=steps)
    assert ks.launches == 2 * steps
    err = abs(nu - visc) / visc
    say(f'mixed shear wave {n}x8x8 on {ks.name}: viscosity {nu:.6f} '
        f'against {visc} ({err:.4%}; tol 1.5 %)')
    assert err < 0.015, nu


def mixed_refusals():
    """Under --precision=mixed the default engine refuses by name what
    the int16 storage cannot hold: fp64 compute, Shan-Chen (single
    component and mixtures), the shallow-water equilibrium."""
    from sailfish_tpu_torch.ops.step import StepBuilder
    small = dict(lat_nx=64, lat_ny=64)
    r = run(LDC_2D, engine='torch', max_iters=0, **small)
    cases = [
        ('fp64 compute', lambda: StepBuilder(
            r.sim.grid, r.maps, visc=0.1, dtype=torch.float64,
            storage='int16', device=DEVICE), 'requires fp32 compute'),
        ('single-component Shan-Chen', lambda: run(
            SC_2D, max_iters=0, precision='mixed', **small),
         'does not cover Shan-Chen'),
        ('shallow water', lambda: run(FS, max_iters=0, precision='mixed',
                                      **small),
         'standard equilibrium only'),
        ('a Shan-Chen mixture', lambda: run(
            SEP_2D, max_iters=0, precision='mixed', **small),
         'covers single-fluid scenes only'),
    ]
    for what, make, reason in cases:
        try:
            make()
        except NotImplementedError as exc:
            assert reason in str(exc), (what, str(exc))
            say(f'refused under --precision=mixed: {what} ({reason!r} in: '
                f'{str(exc)[:120]})')
            continue
        raise AssertionError(f'{what} was not refused under mixed')


def mixed_main_path(path, scene, size, copy_bw, fp32, chunk=250, chunks=4):
    """bench.py's cavity ``scene`` through the controller with the default
    engine under --precision=mixed: the int16 kernel, one launch per step
    under ``lbm_step_mixed_<grid>``, on int16 A/B buffers. The launch
    counts are zeroed just before the controller runs and read just
    after; MLUPS = median of the chunks after the first. Checks the
    fields, the mean wet density against that of the fp32 main path
    ``fp32`` (within ``MASS_TOL``) and one launch from the final state
    against the plain version (within ``MIXED_ONE_STEP`` code); times the
    kernel, its plain version, the chunk's two conversions of the whole
    state (quantize into A, dequantize the result) and, in turns on the
    same geometry, the fp32 kernel."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    steps = chunk * chunks
    ls.reset_launch_counts()
    r = run(twin(scene), max_iters=steps, every=chunk, precision='mixed',
            mixed_range=MIXED_RANGE, **cfg)
    counts = dict(ls.LAUNCHES)
    ks = r.kernel
    grid = r.sim.grid.name
    key = f'lbm_step_mixed_{grid.lower()}'
    assert r.engine == 'kernel' and ks.name == key, ks.name
    assert counts[key] == steps == r.sim.iteration == ks.launches, counts
    assert sum(counts.values()) == steps, counts
    nodes = int(np.prod(size))
    state_bytes = ks.a.element_size() * ks.a.numel()
    assert ks.a.dtype == ks.b.dtype == torch.int16
    assert state_bytes == 2 * ks.grid.Q * nodes, state_bytes
    assert torch.equal(ks.mixed.snap(r.f), r.f)
    r._fields_to_host()
    shape = tuple(reversed(size))
    for name, arr in (('rho', r.sim.rho), ('vx', r.sim.vx)):
        assert arr.shape == shape and np.all(np.isfinite(arr)), name
    mask = ks.mask.cpu().numpy()
    wet = (mask == 0) | (mask >= 3)
    mean_rho = float(np.mean(r.sim.rho[wet], dtype=np.float64))
    drift = mean_rho - fp32['mean_rho']
    vmax = float(np.abs(r.sim.vx[wet]).max())
    assert vmax <= 1.01 * twin(scene).subdomain.max_v, vmax
    assert abs(mean_rho - 1.0) < 0.01 and abs(drift) <= MASS_TOL, \
        (mean_rho, fp32['mean_rho'])
    mlups = statistics.median(r.mlups_history[1:])
    eff = mlups * 1e6 * MIXED_BYTES[grid]
    say(f'main path {path} {"x".join(map(str, size))} ({grid}, engine '
        f'{r.engine}, --precision=mixed --mixed_range={MIXED_RANGE}): '
        f'{counts[key]} {key} launches; state buffers {ks.a.dtype} '
        f'{state_bytes} B each ({state_bytes / nodes:.0f} B per node); '
        f'MLUPS per {chunk}-step chunk '
        f'{[round(m, 1) for m in r.mlups_history]}; median {mlups:.1f} '
        f'MLUPS; {eff / 1e9:.1f} GB/s effective ({MIXED_BYTES[grid]} '
        f'B/node), {eff / copy_bw:.3f} of the copy bandwidth; mean wet '
        f'rho {mean_rho:.8f} against {fp32["mean_rho"]:.8f} on the fp32 '
        f'path ({drift:+.2e}; tol {MASS_TOL:g}), max |vx| {vmax:.5f}')
    a, b = ks.a, ks.b
    a.copy_(ks.mixed.quant(r.f))
    one = torch.empty_like(a)
    ks.step_into(a, one, steps)
    wet_t = torch.as_tensor(wet, device=DEVICE)
    d1, share = code_distance(one, ks.reference(a), wet_t)
    say(f'compare main path {path}: one launch from the state after '
        f'{steps} steps, wet max|dq| = {d1} ({share:.2e} of codes differ; '
        f'tol {MIXED_ONE_STEP})')
    assert d1 <= MIXED_ONE_STEP, d1
    del one, wet_t
    ms = util.cuda_time_ms(lambda: ks.step_into(a, b), 50, warmup=5)
    plain_ms = util.cuda_time_ms(lambda: ks.reference(a), 5)
    convert_ms = util.cuda_time_ms(lambda: ks.run(r.f, 0), 5, warmup=1)
    # the fp32 kernel on the same maps, in turns
    from sailfish_tpu_torch.ops.step import StepBuilder
    k32 = ls.KernelStep(StepBuilder(r.sim.grid, r.maps, tau=r.builder.tau,
                                    device=DEVICE))
    assert k32.name == f'lbm_step_{grid.lower()}' and torch.equal(
        k32.mask, ks.mask)
    k32.a.copy_(r.f)
    turns = {'mixed': [], 'fp32': []}
    for which in ('mixed', 'fp32', 'fp32', 'mixed'):
        if which == 'mixed':
            turns[which].append(util.cuda_time_ms(
                lambda: ks.step_into(a, b), 100, warmup=20))
        else:
            turns[which].append(util.cuda_time_ms(
                lambda: k32.step_into(k32.a, k32.b), 100, warmup=20))
    t = {k: statistics.mean(v) for k, v in turns.items()}
    chunk_ms = chunk * ms
    say(f'kernel {key} at {"x".join(map(str, size))}: {ms:.4f} ms per '
        f'launch; step_reference {plain_ms:.3f} ms; in turns mixed '
        f'{t["mixed"]:.4f} {turns["mixed"]} / fp32 {t["fp32"]:.4f} '
        f'{turns["fp32"]} ms: fp32 over mixed {t["fp32"] / t["mixed"]:.4f}; '
        f'the chunk\'s conversions of the whole state {convert_ms:.3f} ms, '
        f'{convert_ms / (chunk_ms + convert_ms):.4f} of a {chunk}-step '
        f'chunk')
    result = dict(launches=counts[key], mlups=mlups, ms=ms,
                  plain_ms=plain_ms, err=0.0, fp32_ms=t['fp32'],
                  mixed_over_fp32=t['mixed'] / t['fp32'],
                  convert_ms=convert_ms)
    del r, ks, a, b, k32
    torch.cuda.empty_cache()
    return key, result


def branch_line(b):
    """The branch counts of ``elbm_branches``' result ``b`` as text."""
    return (f'branches tiny / series / Newton: kernel {b["kernel"]}, plain '
            f'{b["plain"]} (nodes on another branch: {b["flips"]}; the same '
            f'Newton nodes: {b["newton_same"]}, else {b["newton_flips"]} '
            f'with the plain dev within {ELBM_DEV_BAND:g} of 0.01: '
            f'{b["newton_at_threshold"]}), at most {b["iters"]} '
            f'Newton steps at a node')


def elbm_launch(ks, f0, tol=TOL):
    """One launch of the ELBM kernel with the alpha solve's diagnostics
    against its plain version from ``f0`` (``elbm_branches``): the same
    Newton nodes in both, f within ``tol`` or within ``FP64_FACTOR`` times
    the fp32 plain version's distance to the fp64 plain version. Returns
    (the ``elbm_branches`` dict, its text)."""
    b = elbm_branches(ks, f0, tol=tol)
    assert b['newton_same'], b
    text = f'{branch_line(b)}; one launch wet max|df| = {b["err"]:.3e}'
    if b['k64'] is not None:
        text += (f' (to the fp64 plain version kernel {b["k64"]:.3e}, fp32 '
                 f'plain {b["p64"]:.3e}, factor {FP64_FACTOR:g})')
        assert b['k64'] <= FP64_FACTOR * b['p64'], b
    return b, text


def elbm_compare(name, sim_cls, cfg, state):
    """The ELBM mode (``lbm_step_elbm_<grid>``, or the wall rows' key) vs
    ``step_reference`` on the card from ``state`` (see ``ELBM_CASES``):
    launches with the alpha solve's diagnostics (``elbm_launch``), then
    the case's steps (``torch_scenes.elbm_errors``). Returns (JSON row, the
    largest wet max |df|)."""
    r = run(with_keep_block(sim_cls), platform=DEVICE, engine='kernel',
            max_iters=0, model='elbm', seed=1234, **cfg)
    ks = r.kernel
    g = ks.grid.name.lower()
    assert ks.params.coll.model == ls.MODEL_CODES['elbm'], ks.params
    assert ks.library == 'lbm_step_elbm'
    assert ks.name in (f'lbm_step_elbm_{g}', f'lbm_step_wall_{g}'), ks.name
    codes = sorted(torch.unique(ks.mask).tolist())
    if state == 'own':
        f0 = r.f.clone()
    elif state == 'newton':
        f0 = newton_state(ks.grid, ks.shape, 1234, DEVICE)
    else:
        f0 = smooth_feq(ks.grid, ks.shape, 1234, DEVICE, amp=ELBM_AMP)
    b, text = elbm_launch(ks, f0)
    errs = [b['err']]
    if state == 'smooth':
        assert b['kernel'][2] == b['plain'][2] == 0 < b['kernel'][1], b
    if state in ('newton', 'forced'):
        bn, more = elbm_launch(ks, newton_state(ks.grid, ks.shape, 1234,
                                                DEVICE)) \
            if state == 'forced' else (b, '')
        # from the Newton state the same branch at every node (elsewhere a
        # node within rounding of dev = 1e-6 may take the tiny branch in
        # one and the series in the other)
        assert bn['same'] and bn['kernel'][2] > 0.9 * sum(bn['kernel']), bn
        errs.append(bn['err'])
        if more:
            text += f'; from the Newton state: {more}'
    if state != 'newton':
        steps, tol = {'smooth': (200, TOL), 'own': (50, ELBM_CAVITY_TOL),
                      'forced': (50, TOL)}[state]
        e = elbm_errors(ks, f0, steps, tol, newton=state == 'forced')
        errs.append(e['err'])
        held = (f'mean {e["k64_mean"]:.3e} / {e["p64_mean"]:.3e}, factor '
                f'{ELBM_MEAN_FACTOR:g}' if state == 'forced' else
                f'factor {FP64_FACTOR:g}')
        text += (f'; {steps} steps wet max|df| = {e["err"]:.3e} (tol {tol:g};'
                 f' to the fp64 plain version kernel {e["k64"]:.3e}, fp32 '
                 f'plain {e["p64"]:.3e}; {held})')
        if state == 'smooth':
            assert e['err'] <= TOL, e
    force = ks.force_model if ks.force else None
    say(f'compare elbm {name}: {ks.grid.name} {ks.shape} {ks.name}, force '
        f'{force}, tau {1.0 / ks.tau_inv:g}, mask codes {codes}, state '
        f'{state}: {text}')
    key = f'lbm_step_elbm_{g}'
    del r, ks, f0
    torch.cuda.empty_cache()
    return key, max(errs)


def elbm_mixed_compare(name, sim_cls, cfg, steps=MIXED_STEPS):
    """The ELBM mode on int16 state (``lbm_step_mixed_<grid>`` of the
    ``lbm_step_mixed_elbm`` library) vs ``step_reference`` in codes from
    states quantized: one launch each from ``smooth_feq`` at ``ELBM_AMP``
    and from ``newton_state`` with the diagnostics (``elbm_launch``: the
    same Newton nodes; within one code of the heaviest direction, or the
    fp64 criterion), then ``mixed_errors`` over ``steps`` steps from
    ``smooth_feq``. Returns (JSON row, wet max |df| to the fp32 plain
    version)."""
    r = run(sim_cls, platform=DEVICE, engine='kernel', max_iters=0,
            model='elbm', precision='mixed', mixed_range=MIXED_RANGE, **cfg)
    ks = r.kernel
    g = ks.grid.name.lower()
    assert ks.name == ks.entry == f'lbm_step_mixed_{g}', ks.name
    assert ks.library == 'lbm_step_mixed_elbm'
    text = '; '.join(
        f'from the {label} state: ' + elbm_launch(
            ks, ks.mixed.quant(f0), tol=float(max(ks.mixed.ws)))[1]
        for label, f0 in (
            ('smooth', smooth_feq(ks.grid, ks.shape, 1234, DEVICE,
                                  amp=ELBM_AMP)),
            ('Newton', newton_state(ks.grid, ks.shape, 1234, DEVICE))))
    q0 = ks.mixed.quant(smooth_feq(ks.grid, ks.shape, 1234, DEVICE))
    e = mixed_errors(ks, q0, steps, one_launch=False)
    say(f'compare mixed elbm {name}: {ks.grid.name} {ks.shape} {ks.name} '
        f'({ks.library}, force {ks.force_model if ks.force else None}): '
        f'{text}; after {steps} steps: kernel to '
        f'fp32 plain max|dq| {e["p32"][0]}, kernel to fp64 plain '
        f'{e["k64"][0]}, fp32 plain to fp64 plain {e["p64"][0]} (tol '
        f'max({MIXED_CODE_FLOOR}, {FP64_FACTOR:g} x {e["p64"][0]}))')
    del r, ks, q0
    torch.cuda.empty_cache()
    return f'lbm_step_mixed_elbm_{g}', e['df']


def elbm_main_path(path, copy_bw, chunk=250, chunks=4):
    """An ELBM main path (``ELBM_MAIN``) through the controller with the
    default engine, the launch counts zeroed just before and read just
    after: one launch per step under ``lbm_step_elbm_<grid>`` (int16:
    ``lbm_step_mixed_<grid>``), MLUPS the median of the chunks after the
    first. Checks the fields (finite, no node faster than the lid, the
    mean wet density near 1), one launch from the final state with the
    diagnostics (the same Newton nodes as the plain version, but for nodes
    whose plain dev lies within ``ELBM_DEV_BAND`` of the threshold 0.01,
    where two fp32 versions may each take either branch; its Newton
    share), and times the kernel, its plain version and, in turns
    on the same maps and buffers, the BGK kernel of the same storage: from
    the final state and from one state per branch (``elbm_turns``)."""
    sim_cls, size, flags, row = ELBM_MAIN[path]
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    steps = chunk * chunks
    ls.reset_launch_counts()
    r = run(sim_cls, max_iters=steps, every=chunk, **cfg, **flags)
    counts = dict(ls.LAUNCHES)
    ks = r.kernel
    grid = r.sim.grid.name
    mixed = ks.mixed is not None
    key = f'lbm_step_{"mixed" if mixed else "elbm"}_{grid.lower()}'
    assert r.engine == 'kernel' and ks.name == key, ks.name
    assert r.config.model == 'elbm' and ks.elbm is not None
    assert counts[key] == steps == r.sim.iteration == ks.launches, counts
    assert sum(counts.values()) == steps, counts
    r._fields_to_host()
    shape = tuple(reversed(size))
    for name in ('rho', 'vx') + (('alpha',) if hasattr(r.sim, 'alpha')
                                 else ()):
        arr = getattr(r.sim, name)
        assert arr.shape == shape and np.all(np.isfinite(arr)), name
    mask = ks.mask.cpu().numpy()
    wet = (mask == 0) | (mask >= 3)
    mean_rho = float(np.mean(r.sim.rho[wet], dtype=np.float64))
    vmax = float(np.abs(r.sim.vx[wet]).max())
    lid = sim_cls.subdomain.max_v
    assert vmax <= 1.01 * lid and abs(mean_rho - 1.0) < 0.01, \
        (vmax, mean_rho)
    alpha = ''
    if hasattr(r.sim, 'alpha'):
        a = r.sim.alpha[wet]
        alpha = (f', alpha field (the diagnostic of the state) {a.min():.6f}'
                 f'-{a.max():.6f}, mean {a.mean():.6f}')
    mlups = statistics.median(r.mlups_history[1:])
    nbytes = MIXED_BYTES[grid] if mixed else BYTES[grid]
    eff = mlups * 1e6 * nbytes
    say(f'main path {path} {"x".join(map(str, size))} ({grid}, engine '
        f'{r.engine}, --model=elbm{", --precision=mixed" if mixed else ""}, '
        f'lid {lid}, visc {r.config.visc:g}): {counts[key]} {key} launches; '
        f'MLUPS per {chunk}-step chunk '
        f'{[round(m, 1) for m in r.mlups_history]}; median {mlups:.1f} '
        f'MLUPS; {eff / 1e9:.1f} GB/s effective ({nbytes} B/node), '
        f'{eff / copy_bw:.3f} of the copy bandwidth; mean wet rho '
        f'{mean_rho:.8f}, max |vx| {vmax:.5f}{alpha}')
    a, b = ks.a, ks.b
    state = a.copy_(ks.mixed.quant(r.f)) if mixed else r.f.clone()
    tol = float(max(ks.mixed.ws)) if mixed else TOL
    d = elbm_branches(ks, state, steps, tol=tol)
    newton = d['kernel'][2] / max(1, sum(d['kernel']))
    fp64 = '' if d['k64'] is None else \
        (f' (to the fp64 plain version kernel {d["k64"]:.3e}, fp32 plain '
         f'{d["p64"]:.3e})')
    say(f'compare main path {path}: one launch from the state after '
        f'{steps} steps: {branch_line(d)}; Newton share of the colliding '
        f'nodes {newton:.6f}; wet max|df| = {d["err"]:.3e} (tol {tol:.3g})'
        f'{fp64}')
    assert d['newton_same'] or d['newton_at_threshold'], d
    assert d['k64'] is None or d['k64'] <= FP64_FACTOR * d['p64'], d
    if not mixed:
        a.copy_(state)
    del state
    ms = util.cuda_time_ms(lambda: ks.step_into(a, b), 50, warmup=5)
    plain_ms = util.cuda_time_ms(lambda: ks.reference(a), 3)
    # the BGK kernel of the same storage on the same maps, in turns
    from sailfish_tpu_torch.ops.step import StepBuilder
    bgk = ls.KernelStep(StepBuilder(
        r.sim.grid, r.maps, tau=r.builder.tau, device=DEVICE,
        storage='int16' if mixed else 'fp'))
    assert bgk.name == f'lbm_step_{"mixed_" if mixed else ""}' \
        f'{grid.lower()}' and torch.equal(bgk.mask, ks.mask)
    t, turns = elbm_turns(ks, bgk, a)
    say(f'kernel {row} ({key}) at {"x".join(map(str, size))}: {ms:.4f} ms '
        f'per launch; step_reference {plain_ms:.3f} ms; in turns ELBM '
        f'{t["elbm"]:.4f} {turns["elbm"]} / BGK {t["bgk"]:.4f} '
        f'{turns["bgk"]} ms: ELBM over BGK {t["elbm"] / t["bgk"]:.4f}')
    grid_obj = ks.grid
    rest = eq.bgk_equilibrium(
        grid_obj, torch.ones(ks.shape, device=DEVICE),
        torch.zeros((grid_obj.dim,) + ks.shape, device=DEVICE))
    per_branch = {}
    for label, f0 in (
            ('rest', rest),
            ('smooth', smooth_feq(grid_obj, ks.shape, 5, DEVICE,
                                  amp=ELBM_AMP)),
            ('newton', newton_state(grid_obj, ks.shape, 5, DEVICE))):
        a.copy_(ks.mixed.quant(f0) if mixed else f0)
        del f0
        diag = torch.full((2,) + ks.shape, -1.0, device=DEVICE)
        ks.diagnostics_into(a, b, diag)
        coll = diag[1] >= 0
        counts_b = [int((diag[1].clamp(max=2)[coll] == v).sum())
                    for v in (0, 1, 2)]
        iters = int(diag[1].max()) - 2 if counts_b[2] else 0
        del diag, coll
        tb, _ = elbm_turns(ks, bgk, a)
        per_branch[label] = dict(branches=counts_b, newton_iters=iters,
                                 elbm_ms=tb['elbm'], bgk_ms=tb['bgk'],
                                 ratio=tb['elbm'] / tb['bgk'])
        say(f'kernel {row} at {"x".join(map(str, size))} from the {label} '
            f'state: branches tiny / series / Newton {counts_b} (at most '
            f'{iters} Newton steps at a node); in turns ELBM '
            f'{tb["elbm"]:.4f} / BGK {tb["bgk"]:.4f} ms: ELBM over BGK '
            f'{tb["elbm"] / tb["bgk"]:.4f}')
    del rest
    result = dict(launches=counts[key], mlups=mlups, ms=ms,
                  plain_ms=plain_ms, err=d['err'], bgk_ms=t['bgk'],
                  elbm_over_bgk=t['elbm'] / t['bgk'], newton_share=newton,
                  per_branch=per_branch)
    del r, ks, a, b, bgk
    torch.cuda.empty_cache()
    return row, result


def elbm_turns(ks, bgk, state, launches=100):
    """The ELBM ``KernelStep`` ``ks`` and the BGK one ``bgk`` of the same
    maps and storage, each stepping from ``state`` (copied into its A
    buffer) into its B buffer, timed with CUDA events in turns (ELBM, BGK,
    BGK, ELBM). Returns ({'elbm' / 'bgk': mean ms}, the turns)."""
    turns = {'elbm': [], 'bgk': []}
    for k in (ks, bgk):
        if k.a is not state:
            k.a.copy_(state)
    for which in ('elbm', 'bgk', 'bgk', 'elbm'):
        k = ks if which == 'elbm' else bgk
        turns[which].append(util.cuda_time_ms(
            lambda: k.step_into(k.a, k.b), launches, warmup=20))
    return {k: statistics.mean(v) for k, v in turns.items()}, turns


def copy_bandwidth():
    """Device-to-device copy bandwidth on a 1 GiB tensor, bytes/s
    (read + write)."""
    n = 2 ** 28
    src = torch.ones(n, dtype=torch.float32, device=DEVICE)
    dst = torch.empty_like(src)
    ms = util.cuda_time_ms(lambda: dst.copy_(src), 20, warmup=3)
    return 2 * n * 4 / (ms / 1e3)


def main_path(scene, sim_cls, size, copy_bw, chunk=250, chunks=4,
              accel=None, flags=None, kind=None, timed=None):
    """The scene through the controller with the default engine: the
    main path. The kernels' launch counts are zeroed just before the
    controller runs and read just after. MLUPS = median of the chunks
    after the first. ``accel``: the scene is driven from rest by this
    constant acceleration along x (the forcing mode's main paths) and is
    checked as such. ``flags``: more controller flags (a collision model),
    whose launches count under the key of ``kind`` (default 'force_' with
    ``accel``, else none). ``timed``: 'force' times each force model, and
    'collision' each collision model of ``COLLISION_TIMED``, in turns
    against the main path's own kernel on its geometry and buffers."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    flags = flags or {}
    steps = chunk * chunks
    ls.reset_launch_counts()
    r = run(sim_cls, max_iters=steps, every=chunk, **cfg, **flags)
    counts = dict(ls.LAUNCHES)
    assert r.engine == 'kernel', r.engine
    if kind is None:
        kind = 'force_' if accel else ''
    assert r.kernel.name == f'lbm_step_{kind}{r.sim.grid.name.lower()}'
    launches = counts[r.kernel.name]
    assert launches == steps == r.sim.iteration == r.kernel.launches, \
        (counts, steps)
    assert sum(counts.values()) == launches, counts
    r._fields_to_host()
    shape = tuple(reversed(size))
    for name, arr in (('rho', r.sim.rho), ('vx', r.sim.vx)):
        assert arr.shape == shape and np.all(np.isfinite(arr)), name
    mask = r.kernel.mask.cpu().numpy()
    wet = (mask == 0) | (mask >= 3)
    mean_rho = float(np.mean(r.sim.rho[wet], dtype=np.float64))
    checks = ''
    if accel:
        # from rest under the acceleration a: free fall is a (steps + 1/2);
        # the flow round the body and through the gap it leaves gains a
        # factor (2 at a cylinder's equator in potential flow, times the
        # blockage), so no node passes 4x; the mean follows the force at
        # more than a quarter of free fall (drag takes the rest); the mass
        # per wet node stays within MASS_TOL of its start (rho = 1)
        free = accel * (steps + 0.5)
        vmax = float(np.abs(r.sim.vx[wet]).max())
        vmean = float(np.mean(r.sim.vx[wet], dtype=np.float64))
        assert vmax <= 4.0 * free, (vmax, free)
        assert 0.25 * free <= vmean <= 1.01 * free, (vmean, free)
        assert abs(mean_rho - 1.0) <= MASS_TOL, mean_rho
        checks = (f'; mean wet vx {vmean:.6f}, max {vmax:.6f} (free '
                  f'acceleration {free:.6f}), mean wet rho - 1 = '
                  f'{mean_rho - 1.0:+.2e} (tol {MASS_TOL:g})')
    else:
        # wet nodes: no faster than the lid, mass near its initial density
        assert np.abs(r.sim.vx[wet]).max() \
            <= 1.01 * sim_cls.subdomain.max_v
        assert abs(mean_rho - 1.0) < 0.01
    grid = r.sim.grid.name
    mlups = statistics.median(r.mlups_history[1:])
    eff = mlups * 1e6 * BYTES[grid]
    model = ', '.join(f'--{k}={v}' for k, v in flags.items())
    say(f'main path {scene} {"x".join(map(str, size))} ({grid}, engine '
        f'{r.engine}{", " + model if model else ""}): {launches} '
        f'{r.kernel.name} '
        f'launches; MLUPS per {chunk}-step chunk '
        f'{[round(m, 1) for m in r.mlups_history]}; median {mlups:.1f} '
        f'MLUPS; {eff / 1e9:.1f} GB/s effective ({BYTES[grid]} B/node), '
        f'{eff / copy_bw:.3f} of the copy bandwidth{checks}')
    # the kernel against its plain version on the main path's own state
    # and shapes (10 steps), then each timed alone on the same tensors
    ks = r.kernel
    f0 = r.f.clone()
    fk = ks.run(f0, 10)
    fr = f0
    for _ in range(10):
        fr = ks.reference(fr)
    wet_t = torch.as_tensor(wet, device=DEVICE)
    err = float((fk - fr)[:, wet_t].abs().max())
    say(f'compare main path {scene}: 10 steps from the state after '
        f'{steps}, wet max|df| = {err:.3e} (tol {TOL:g})')
    assert np.isfinite(err) and err <= TOL, err
    del f0, fk, fr, wet_t
    a, b = ks.a, ks.b
    ms = util.cuda_time_ms(lambda: ks.step_into(a, b), 50, warmup=5)
    plain_ms = util.cuda_time_ms(lambda: ks.reference(a), 5)
    say(f'kernel {ks.name} at {"x".join(map(str, size))}: {ms:.4f} ms per '
        f'launch; step_reference {plain_ms:.3f} ms')
    result = dict(launches=launches, mlups=mlups, ms=ms,
                  plain_ms=plain_ms, err=err, mean_rho=mean_rho)
    if timed == 'force':
        result['models_ms'] = force_models_ms(sim_cls, r, ks)
    elif timed == 'collision':
        result['collision_ms'] = collision_models_ms(sim_cls, r, ks)
    del r, ks, a, b
    torch.cuda.empty_cache()
    return grid, result


def variant_kernel(r, ks, maps=None, unforced=False, **flags):
    """A ``KernelStep`` of the scene of the controller's runner ``r``,
    built as the controller builds it (the scene's ``make_step_builder``)
    with the command-line flags ``flags`` changed, on the runner's maps or
    ``maps``, without the body force when ``unforced``; on the mask of the
    main path's kernel ``ks`` and without buffers of its own: for timings
    in turns on the main path's own geometry and buffers, without setting
    the scene up again through the controller."""
    sim = copy.copy(r.sim)
    sim.config = copy.copy(r.config)
    vars(sim.config).update(flags)
    if unforced:
        sim._forces = {}
    k = ls.KernelStep(sim.make_step_builder(
        r.maps if maps is None else maps, r.config.dtype, r.device))
    assert torch.equal(k.mask, ks.mask)
    k.a = k.b = None
    k.mask = ks.mask
    torch.cuda.empty_cache()
    return k


def force_models_ms(sim_cls, r, ks):
    """ms per launch of each force model's instantiation and of the
    unforced kernel on the geometry, mask and state buffers of the forced
    main path's ``ks`` (of the runner ``r``), in turns (there and back):
    what the force costs a step."""
    steppers = {}
    for model in FORCE_MODELS + (None,):
        if model == ks.force_model:
            steppers[model] = ks
            continue
        k = variant_kernel(r, ks, force_implementation=model) if model \
            else variant_kernel(r, ks, unforced=True)
        assert k.params.force.model == ls.FORCE_CODES.get(model, 0)
        steppers[model] = k
    a, b = ks.a, ks.b
    order = list(steppers)
    turns = {model: [] for model in order}
    for model in order + order[::-1]:
        k = steppers[model]
        turns[model].append(util.cuda_time_ms(
            lambda: k.step_into(a, b), 100, warmup=50))
    ms = {str(model): statistics.mean(t) for model, t in turns.items()}
    say(f'kernel lbm_step_{ks.grid.name.lower()} on the geometry of '
        f'{sim_cls.__name__} {ks.shape}, ms per launch by force model, in '
        f'turns: ' + ', '.join(
            f'{model} {ms[str(model)]:.4f} {turns[model]}'
            for model in order) + '; over the unforced kernel: '
        + ', '.join(f'{model} {ms[model] / ms["None"]:.4f}'
                    for model in FORCE_MODELS))
    return ms


def collision_models_ms(sim_cls, r, ks):
    """ms per launch of the BGK kernel ``ks`` (the BGK main path's of the
    runner ``r``) and of each collision model of ``COLLISION_TIMED`` (the
    scene built with its flags) on the same geometry, mask and state
    buffers, in turns (there and back): what a model costs a step."""
    steppers = {'bgk': ks}
    for model, flags in COLLISION_TIMED.items():
        k = variant_kernel(r, ks, **flags)
        assert k.name != ks.name, k.name
        steppers[model] = k
    a, b = ks.a, ks.b
    order = list(steppers)
    turns = {model: [] for model in order}
    for model in order + order[::-1]:
        k = steppers[model]
        turns[model].append(util.cuda_time_ms(
            lambda: k.step_into(a, b), 100, warmup=50))
    ms = {model: statistics.mean(t) for model, t in turns.items()}
    say(f'kernel {ks.name} on the geometry of {sim_cls.__name__} '
        f'{ks.shape}, ms per launch by collision model, in turns: '
        + ', '.join(f'{model} ({steppers[model].name}) {ms[model]:.4f} '
                    f'{turns[model]}' for model in order)
        + '; model over BGK: ' + ', '.join(
            f'{model} {ms[model] / ms["bgk"]:.4f}'
            for model in COLLISION_TIMED))
    return ms


def channel_main_path(scene, copy_bw, chunk=250, chunks=4):
    """A parabolic-inlet channel of ``CHANNELS`` through the controller
    with the default engine: a main path of the varying BC rows,
    ONE launch per step. The launch counts are zeroed just before the
    controller runs and read just after. Checks: finite fields, the inlet
    macro velocity equal to the prescribed profile, the mean wet density
    within 1 % of 1 and no wet speed above 0.1, and 10 steps from the
    final state against ``step_reference``; then the kernel is timed
    against its plain version, and against the same channel with a
    uniform inlet (every BC row on its scalars) in turns, on the same state
    buffers and mask (two allocations of one size differ by ~0.5 % by
    themselves): what the per-node parameters cost a step."""
    axis, size, extra = CHANNELS[scene]
    dim = len(size)
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size), **extra)
    steps = chunk * chunks
    ls.reset_launch_counts()
    r = run(channel(dim, axis), max_iters=steps, every=chunk, **cfg)
    counts = dict(ls.LAUNCHES)
    assert r.engine == 'kernel', r.engine
    ks = r.kernel
    assert ks.vary and ks.name == f'lbm_step_vary_{ks.grid.name.lower()}'
    assert counts[ks.name] == steps == r.sim.iteration == ks.launches, \
        (counts, steps)
    assert sum(counts.values()) == steps, counts       # one launch per step
    r._fields_to_host()
    shape = tuple(reversed(size))
    comps = r.sim.velocity_components()
    for name, arr in [('rho', r.sim.rho)] + list(zip('xyz', comps)):
        assert arr.shape == shape and np.all(np.isfinite(arr)), name
    # the inlet: the low face of the flow axis; the profile runs across
    # the walls' axis (y, or x in the 2D channel flowing along y)
    inlet_row, = (row for row in ks.table if row.box is not None)
    inlet = r.maps.type_map == inlet_row.type_id
    flow = 'xyz'.index(axis)
    across = -2 if dim == 3 or axis == 'x' else -1
    prof = parabolic_profile(np.indices(shape)[across], shape[across])
    inlet_err = max(float(np.abs(comps[flow][inlet] - prof[inlet]).max()),
                    max(float(np.abs(c[inlet]).max())
                        for a, c in enumerate(comps) if a != flow))
    assert inlet_err <= INLET_TOL, inlet_err
    wet = wet_map(r.maps)
    mean_rho = float(np.mean(r.sim.rho[wet]))
    speed = float(np.sqrt(sum(c[wet] ** 2 for c in comps)).max())
    assert abs(mean_rho - 1.0) < 0.01, mean_rho
    assert speed <= 0.1, speed
    grid = ks.grid.name
    nodes = int(inlet.sum())
    mlups = statistics.median(r.mlups_history[1:])
    eff = mlups * 1e6 * BYTES[grid]
    say(f'main path {scene} {"x".join(map(str, size))} ({grid}, engine '
        f'{r.engine}, inlet normal to {axis}): {counts[ks.name]} {ks.name} '
        f'launches and no other, {nodes} nodes with their own parameters '
        f'(box {inlet_row.box.ext}, {ks.bcp.numel()} floats); MLUPS per '
        f'{chunk}-step chunk {[round(m, 1) for m in r.mlups_history]}; '
        f'median {mlups:.1f} MLUPS; {eff / 1e9:.1f} GB/s effective '
        f'({BYTES[grid]} B/node), {eff / copy_bw:.3f} of the copy '
        f'bandwidth; inlet max|u - profile| = {inlet_err:.2e} (tol '
        f'{INLET_TOL:g}), mean wet rho {mean_rho:.6f}, max wet |u| '
        f'{speed:.4f}')
    err = vary_errors(ks, r.f.clone(), 10)
    say(f'compare main path {scene}: 10 steps from the state after '
        f'{steps}, wet max|df| = {err:.3e} (tol {TOL:g})')
    a, b = ks.a, ks.b
    plain_ms = util.cuda_time_ms(lambda: ks.reference(a), 5)
    # the same maps with the inlet's velocity made uniform (its first
    # node's): every BC row on its scalars
    maps = copy.copy(r.maps)
    maps.param_vel = r.maps.param_vel.copy()
    maps.param_vel[:, inlet] = maps.param_vel[:, inlet][:, :1]
    ku = variant_kernel(r, ks, maps=maps)
    assert not ku.vary
    turns = {'varying': [], 'uniform': []}
    for which in ('varying', 'uniform', 'uniform', 'varying'):
        k = ks if which == 'varying' else ku
        turns[which].append(util.cuda_time_ms(
            lambda: k.step_into(a, b), 100, warmup=50))
    ms, uniform_ms = (statistics.mean(turns[w])
                      for w in ('varying', 'uniform'))
    share = (ms - uniform_ms) / ms
    say(f'kernel {ks.name} at {"x".join(map(str, size))}, inlet normal to '
        f'{axis}: {ms:.4f} ms per launch {turns["varying"]}; step_reference '
        f'{plain_ms:.3f} ms; the same channel with a uniform inlet '
        f'({ku.name}) {uniform_ms:.4f} ms {turns["uniform"]}: (varying - '
        f'uniform) / varying = {share:+.4f} of a step')
    result = dict(launches=counts[ks.name], ms=ms, plain_ms=plain_ms,
                  err=err, extra_bytes=4 * (1 + dim) * nodes, mlups=mlups,
                  uniform_ms=uniform_ms, share=share)
    del r, ks, ku, a, b
    torch.cuda.empty_cache()
    return grid, result


#: the main paths of the wall rows and per-step values: scene -> (size,
#: extra flags)
SLICE_MAIN = {
    'duct_flow': ((256, 256, 256), {}),
    'womersley': ((256, 256, 256), {}),
    'poiseuille_sa': ((4096, 4096), dict(velocity='spatial_array')),
}
#: duct_flow: largest |vz - analytic| over the peak velocity after 1000
#: steps from the analytic start (the half-way walls hold the series
#: solution; its discrete steady state differs by the BGK wall slip)
DUCT_TOL = 0.05


def slice_checks(scene, r, ks, steps):
    """The scene's own checks after its main path (raises on failure) and
    the line that states them."""
    r._fields_to_host()
    shape = r.maps.type_map.shape
    comps = r.sim.velocity_components()
    for name, arr in [('rho', r.sim.rho)] + list(zip('xyz', comps)):
        assert arr.shape == shape and np.all(np.isfinite(arr)), name
    wet = wet_map(r.maps)
    mean_rho = float(np.mean(r.sim.rho[wet], dtype=np.float64))
    speed = float(np.sqrt(sum(c[wet] ** 2 for c in comps)).max())
    assert speed <= 0.1, speed
    rho_tol = 1e-4 if scene == 'duct_flow' else 0.01
    assert abs(mean_rho - 1.0) <= rho_tol, mean_rho
    line = (f'mean wet rho - 1 = {mean_rho - 1.0:+.3e} (tol {rho_tol:g}), '
            f'max wet |u| {speed:.5f} (tol 0.1)')
    h = np.indices(shape)[::-1]
    if scene == 'duct_flow':
        sub = r._subdomain
        # the profile depends on (x, y) only: one z-plane, broadcast
        ana = sub.analytical(h[0][0], h[1][0])[None]
        err = float(np.abs(comps[2] - ana)[wet].max()) / sub.max_v
        assert err <= DUCT_TOL, err
        line += (f'; max |vz - analytic| / max_v = {err:.4e} (tol '
                 f'{DUCT_TOL:g})')
    elif scene == 'womersley':
        # the ends' density at iteration `steps`, the value the BC set
        dp = r._subdomain.pressure_delta
        want = 1.5 * dp * np.sin(0.0005 * steps)
        for row, sign in zip(ks.table, (1.0, -1.0)):
            at = r.maps.type_map == row.type_id
            at &= r.maps.orientation == row.orientation
            got = r.sim.rho[at]
            err = float(np.abs(got - (1.0 + sign * want)).max())
            assert err <= INLET_TOL, (err, row)
            line += (f'; end rho {float(got.mean()):.8f} against 1 '
                     f'{"+" if sign > 0 else "-"} 1.5 dp sin(w t) = '
                     f'{1.0 + sign * want:.8f} (max |d| {err:.1e})')
    else:
        inlet = (r.maps.type_map == nt.NTEquilibriumVelocity.id)
        ny = shape[0]
        radius = (ny - 2.0) / 2.0
        ramp = min(steps / 5000.0, 1.0)
        prof = 0.02 * (1.0 - (h[1] + 0.5 - radius) ** 2 / radius ** 2) \
            * ramp
        err = max(float(np.abs(comps[0] - prof)[inlet].max()),
                  float(np.abs(comps[1][inlet]).max()))
        assert err <= INLET_TOL, err
        line += (f'; inlet max |u - ramped parabola| = {err:.2e} (ramp '
                 f'{ramp:g}, tol {INLET_TOL:g})')
    return line


def slice_main_path(scene, copy_bw, chunk=250, chunks=4):
    """A scene of the wall rows or the per-step values through the
    controller with the default engine: ONE launch per step (plus, for a
    space- and time-dependent row, a counted rewrite of its block of the
    parameter array). The counts are zeroed just before the controller
    runs and read just after. Then the scene's checks (``slice_checks``),
    10 steps from the final state against ``step_reference`` with the
    values of iterations 2000.., the kernel alone against its plain
    version, and the dynamic share: a step with the per-step writes against
    the launch alone on the same object and buffers, in turns."""
    size, extra = SLICE_MAIN[scene]
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size), **extra)
    steps = chunk * chunks
    ls.reset_launch_counts()
    r = run(twin(scene), max_iters=steps, every=chunk, **cfg)
    counts, rewrites = dict(ls.LAUNCHES), dict(ls.BCP_REWRITES)
    assert r.engine == 'kernel', r.engine
    ks = r.kernel
    assert counts[ks.name] == steps == r.sim.iteration == ks.launches, \
        (counts, steps)
    assert sum(counts.values()) == steps, counts     # one launch per step
    blocks = [d for d in ks.dynamic if d.static is not None]
    assert sum(rewrites.values()) == len(blocks) * steps, rewrites
    checks = slice_checks(scene, r, ks, steps)
    grid = ks.grid.name
    mlups = statistics.median(r.mlups_history[1:])
    eff = mlups * 1e6 * BYTES[grid]
    say(f'main path {scene} {"x".join(map(str, size))} ({grid}, engine '
        f'{r.engine}): {counts[ks.name]} {ks.name} launches and no other, '
        f'{sum(rewrites.values())} parameter-block rewrites; MLUPS per '
        f'{chunk}-step chunk {[round(m, 1) for m in r.mlups_history]}; '
        f'median {mlups:.1f} MLUPS; {eff / 1e9:.1f} GB/s effective '
        f'({BYTES[grid]} B/node), {eff / copy_bw:.3f} of the copy '
        f'bandwidth; {checks}')
    f0 = r.f.clone()
    fk = ks.run(f0, 10, it0=steps)
    fr = f0
    for i in range(10):
        ks.set_iteration(steps + i)
        fr = ks.reference(fr)
    wet = wet_mask(ks)
    err = float((fk - fr)[:, wet].abs().max())
    say(f'compare main path {scene}: 10 steps from the state after '
        f'{steps}, wet max|df| = {err:.3e} (tol {TOL:g})')
    assert np.isfinite(err) and err <= TOL, err
    del f0, fk, fr
    a, b = ks.a, ks.b
    ms = util.cuda_time_ms(lambda: ks._launch(a, b), 50, warmup=5)
    plain_ms = util.cuda_time_ms(lambda: ks.reference(a), 5)
    result = dict(launches=counts[ks.name], ms=ms, plain_ms=plain_ms,
                  err=err, mlups=mlups)
    timing = ''
    if ks.dynamic or ks.force_expr is not None:
        it = [steps]

        def stepped():
            ks.step_into(a, b, it[0])
            it[0] += 1

        turns = {'per-step values': [], 'launch alone': []}
        for which in ('per-step values', 'launch alone', 'launch alone',
                      'per-step values'):
            fn = stepped if which == 'per-step values' else \
                (lambda: ks._launch(a, b))
            turns[which].append(util.cuda_time_ms(fn, 100, warmup=20))
        dyn_ms, alone_ms = (statistics.mean(turns[w]) for w in turns)
        share = (dyn_ms - alone_ms) / dyn_ms
        result.update(step_ms=dyn_ms, dynamic_share=share)
        timing = (f'; a step with its per-step writes {dyn_ms:.4f} ms '
                  f'{turns["per-step values"]} against the launch alone '
                  f'{alone_ms:.4f} ms {turns["launch alone"]}: dynamic share '
                  f'(dynamic - static) / dynamic = {share:+.4f}')
    extra_bytes = 0
    if ks.walls:
        # 4 B of tags per wall node, 4 B per bounced link
        tagged = ks.tags[ks.mask >= 3].cpu().numpy()
        words, n = np.unique(tagged, return_counts=True)
        links = int(sum(bin(int(w)).count('1') * int(c)
                        for w, c in zip(words, n)))
        extra_bytes = 4 * tagged.size + 4 * links
    for d in blocks:
        extra_bytes += 4 * int(d.static.numel())
    result['extra_bytes'] = extra_bytes
    say(f'kernel {ks.name} at {"x".join(map(str, size))}: {ms:.4f} ms per '
        f'launch; step_reference {plain_ms:.3f} ms; {extra_bytes} bytes a '
        f'step beyond {BYTES[grid]} B per node{timing}')
    del r, ks, a, b
    torch.cuda.empty_cache()
    return result


def empty_launch_ms(iters=2000):
    """Device milliseconds per launch of an empty one-block kernel
    (``lbm_empty_launch`` of ``csrc/lbm_step.cu``), CUDA events around
    ``iters`` back-to-back launches: the floor under any kernel's time in
    a stream of launches, to read a bound smaller than it against."""
    fn = build.load('lbm_step').lib.lbm_empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = fn(stream)
        if rc != 0:
            raise RuntimeError(f'empty launch failed: CUDA error {rc}')

    return util.cuda_time_ms(launch, iters, warmup=10)


def bound_ms(name, nodes, extra_bytes=0):
    """(least milliseconds the card could take for the kernel's work on
    ``nodes`` nodes, 'bytes' or 'operations'): the larger of the bytes
    over the HBM rate and the fp32 operations over the fp32 peak."""
    t_bytes = (nodes * NODE_BYTES[name] + extra_bytes) / PEAK_BYTES
    t_ops = nodes * NODE_OPS[name] / PEAK_FP32
    return (1e3 * max(t_bytes, t_ops),
            'bytes' if t_bytes >= t_ops else 'operations')


def sc_main_path(scene, sim_cls, size, copy_bw, name, demix=None,
                 chunk=500, chunks=2):
    """A Shan-Chen scene through the controller with the default engine:
    a main path of the mixtures, whose step launches count under ``name``.
    The launch counts are zeroed just before the controller runs and read
    just after: one pre-pass and one step launch per step, no other kernel.
    Checks: finite fields, each component's mass (float64 sums) within
    ``MASS_TOL`` (Guo forcing conserves it too), with ``demix`` = n the
    demixing of tests/test_binary.py:41-43 (a density contrast above 0.5 in
    each of the first n components; for K = 2 rho and phi anticorrelated
    below -0.9), and 10 steps from the final state against the plain
    versions; then each kernel is timed alone against its plain version,
    and a forced kernel in turns against the same scene's unforced one.
    Returns {JSON row: measurements}."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    steps = chunk * chunks

    class Sim(sim_cls):
        def make_initial_state(self, builder, dtype):
            state = super().make_initial_state(builder, dtype)
            self.mass0 = [float(torch.sum(f, dtype=torch.float64))
                          for f in state]
            return state

    sm.reset_launch_counts()
    r = run(Sim, max_iters=steps, every=chunk, seed=1, **cfg)
    counts = dict(sm.LAUNCHES)
    assert r.engine == 'kernel', r.engine
    ks = r.kernel
    assert ks.name == name, (ks.name, name)
    assert counts[ks.name] == counts[ks.rho_name] == steps \
        == r.sim.iteration, (counts, steps)
    assert sum(counts.values()) == 2 * steps, counts
    assert ks.launches == {ks.rho_name: steps, ks.name: steps}
    assert st.is_finite(r.f)
    mass = [float(torch.sum(f, dtype=torch.float64)) for f in r.f]
    drift = max(abs(m - m0) / m0 for m, m0 in zip(mass, r.sim.mass0))
    assert drift <= MASS_TOL, (mass, r.sim.mass0)
    r._fields_to_host()
    fields = ['rho', 'phi', 'theta'][:ks.K]
    shape = tuple(reversed(size))
    for fname in fields + ['vx']:
        arr = getattr(r.sim, fname)
        assert arr.shape == shape and np.all(np.isfinite(arr)), fname
    contrast = [float(np.ptp(getattr(r.sim, fname))) for fname in fields]
    checks = ''
    if demix:
        assert min(contrast[:demix]) > 0.5, contrast
        checks = f'; density contrast {[round(c, 3) for c in contrast]}'
        if ks.K == 2:
            corr = float(np.corrcoef(r.sim.rho.ravel(),
                                     r.sim.phi.ravel())[0, 1])
            assert corr < -0.9, corr
            checks += f', corr(rho, phi) {corr:.4f}'
    vmax = float(max(np.abs(getattr(r.sim, f'v{a}')).max()
                     for a in 'xyz'[:len(size)]))
    grid = r.sim.grid
    mlups = statistics.median(r.mlups_history[1:])
    node_bytes = sc_bytes(grid.name, ks.K)
    eff = mlups * 1e6 * node_bytes
    forces = ', '.join(f'a{k + 1} {tuple(float(x) for x in a)}'
                       for k, a in enumerate(ks.accels) if a is not None)
    say(f'main path {scene} {"x".join(map(str, size))} ({grid.name}, K='
        f'{ks.K}, {ks.potential}{", " + forces if forces else ""}, engine '
        f'{r.engine}): {counts[ks.rho_name]} {ks.rho_name} + '
        f'{counts[ks.name]} {ks.name} launches; MLUPS per {chunk}-step '
        f'chunk {[round(m, 1) for m in r.mlups_history]}; median '
        f'{mlups:.1f} MLUPS; {eff / 1e9:.1f} GB/s effective ({node_bytes} '
        f'B/node), {eff / copy_bw:.3f} of the copy bandwidth; mass drift '
        f'{drift:.2e} (tol {MASS_TOL:g}); max |u| {vmax:.3e}{checks}')
    # the kernels against their plain versions on the main path's own
    # state and shapes (10 steps), then each timed alone
    rho_err, err = sc_errors(ks, grid, tuple(f.clone() for f in r.f), 10)
    say(f'compare main path {scene}: pre-pass max|drho| = {rho_err:.3e}; '
        f'10 steps from the state after {steps}, wet max|df| = {err:.3e} '
        f'(tol {TOL:g})')
    a, b, rb = ks.a, ks.b, ks.rho
    rho_ms = util.cuda_time_ms(lambda: ks.density_into(a, rb), 50, warmup=5)
    ms = util.cuda_time_ms(lambda: ks.collide_into(a, rb, b), 50, warmup=5)
    plain_rho_ms = util.cuda_time_ms(
        lambda: [sm.rho_reference(f, grid) for f in a], 5)
    plain_ms = util.cuda_time_ms(
        lambda: ks.reference(a.unbind(0), rb.unbind(0)), 5)
    say(f'kernel {ks.rho_name} at {"x".join(map(str, size))}: {rho_ms:.4f} '
        f'ms per launch (K={ks.K}); rho_reference {plain_rho_ms:.3f} ms')
    say(f'kernel {ks.name} at {"x".join(map(str, size))}: {ms:.4f} ms per '
        f'launch; sc_multi_reference {plain_ms:.3f} ms; the pre-pass is '
        f'{rho_ms / (rho_ms + ms):.3f} of a step')
    step = dict(launches=counts[ks.name], ms=ms, plain_ms=plain_ms, err=err,
                mlups=mlups)
    if ks.forced:
        step['unforced_ms'] = sc_unforced_ms(scene, sim_cls, cfg, ks)
    results = {
        prepass_row(ks): dict(launches=counts[ks.rho_name], ms=rho_ms,
                              plain_ms=plain_rho_ms, err=rho_err),
        ks.name: step,
    }
    del r, ks, a, b, rb
    torch.cuda.empty_cache()
    return results


def single_mode_main_path(scene, size, name, copy_bw, chunk=500,
                          chunks=4):
    """A single-component Shan-Chen or shallow-water twin through the
    controller with the default engine at ``size``, its own physics: a
    main path, whose step launches count under ``name``. The launch
    counts of every kernel engine are zeroed just before the controller
    runs and read just after: per step one ``lbm_step_sc`` launch after one
    pre-pass (``rho_poststream_nk1``), or one ``lbm_step_sw`` launch, and
    no other kernel. Checks: finite fields; Shan-Chen: the total mass
    within ``MASS_TOL`` and the density spread grown from the start's 0.01
    past 0.1 (the phases separate); shallow water: the hump's top falls
    and stays finite, and the mass drift lies between -``MASS_TOL`` and
    ``steps`` times the last step's gain plus ``MASS_TOL`` (the JAX
    shallow-water equilibrium's zeroth moment is h (1 + 2 u.u), so BGK
    adds 2 h u.u / tau per node and step, and |u| grows along the path);
    then 20 steps from the final state against the plain versions, and
    each kernel timed alone against its plain version. Returns {JSON row:
    measurements}."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    steps = chunk * chunks

    class Sim(twin(scene)):
        def make_initial_state(self, builder, dtype):
            f = super().make_initial_state(builder, dtype)
            self.mass0 = float(torch.sum(f, dtype=torch.float64))
            self.top0 = float(builder.macro_fields(f)[0].max())
            return f

    for engine in (ls, sm, fe):
        engine.reset_launch_counts()
    r = run(Sim, max_iters=steps, every=chunk, seed=1, **cfg)
    counts = dict(ls.LAUNCHES)
    others = sum(sm.LAUNCHES.values()) + sum(fe.LAUNCHES.values())
    assert r.engine == 'kernel', r.engine
    ks = r.kernel
    assert ks.name == name, (ks.name, name)
    assert counts[name] == steps == r.sim.iteration == ks.launches, counts
    per_step = 2 if ks.sc else 1
    if ks.sc:
        assert counts[ks.rho_name] == steps == ks.prepass_launches, counts
    assert sum(counts.values()) == per_step * steps and others == 0, \
        (counts, others)
    assert st.is_finite(r.f)
    mass = float(torch.sum(r.f, dtype=torch.float64))
    drift = (mass - r.sim.mass0) / r.sim.mass0
    r._fields_to_host()
    shape = tuple(reversed(size))
    for fname in ('rho', 'vx', 'vy'):
        arr = getattr(r.sim, fname)
        assert arr.shape == shape and np.all(np.isfinite(arr)), fname
    grid = ks.grid
    spread = float(np.ptp(r.sim.rho))
    top = float(r.sim.rho.max())
    if ks.sc:
        assert abs(drift) <= MASS_TOL, drift
        assert spread > 0.1, spread
        checks = (f'mass drift {drift:.2e} (tol {MASS_TOL:g}); rho spread '
                  f'{spread:.4f} (start 0.01), min {r.sim.rho.min():.4f}, '
                  f'max {top:.4f}')
    else:
        fs = r.builder.streamed(r.f)
        h, u = eq.macroscopic(grid, fs)
        gain = 2.0 * ks.tau_inv * float(torch.sum(
            h.double() * (u.double() ** 2).sum(0))) / mass
        del fs, h, u
        assert -MASS_TOL <= drift <= steps * gain + MASS_TOL, (drift, gain)
        assert top < r.sim.top0 - 0.01, (top, r.sim.top0)
        checks = (f'mass drift {drift:.3e} (bound: -{MASS_TOL:g} to {steps} '
                  f'x the last step\'s gain {gain:.3e} + {MASS_TOL:g}); '
                  f'max h {r.sim.top0:.4f} -> {top:.4f}, min h '
                  f'{r.sim.rho.min():.4f}')
    vmax = float(max(np.abs(getattr(r.sim, f'v{a}')).max()
                     for a in 'xyz'[:len(size)]))
    mlups = statistics.median(r.mlups_history[1:])
    node_bytes = NODE_BYTES[name] + (
        NODE_BYTES[ks.rho_name] if ks.sc else 0)
    eff = mlups * 1e6 * node_bytes
    say(f'main path {scene} {"x".join(map(str, size))} ({grid.name}, '
        f'{"G %g, %s psi" % (ks.sc_coupling, ks.sc_potential) if ks.sc else "gravity %g" % ks.gravity}, '
        f'tau {1.0 / ks.tau_inv:g}, engine {r.engine}): '
        + (f'{counts[ks.rho_name]} {ks.rho_name} + ' if ks.sc else '')
        + f'{counts[name]} {name} launches; MLUPS per {chunk}-step chunk '
        f'{[round(m, 1) for m in r.mlups_history]}; median {mlups:.1f} '
        f'MLUPS; {eff / 1e9:.1f} GB/s effective ({node_bytes} B/node), '
        f'{eff / copy_bw:.3f} of the copy bandwidth; {checks}; max |u| '
        f'{vmax:.3e}')
    # the kernels against their plain versions from the main path's own
    # state (20 steps; the pre-pass after one launch), then each timed alone
    f0 = r.f.clone()
    rho_err = None
    if ks.sc:
        rho = torch.empty_like(ks.rho)
        ks.density_into(f0, rho)
        rho_err = float((rho - sm.rho_reference(f0, grid)).abs().max())
        del rho
        assert np.isfinite(rho_err) and rho_err <= RHO_TOL, rho_err
    fk = ks.run(f0, 20, it0=steps)
    fr = f0
    for _ in range(20):
        fr = ks.reference(fr)
    wet = wet_mask(ks)
    err = float((fk - fr)[:, wet].abs().max())
    if ks.sc:
        held = f' (tol {TOL:g})'
        assert np.isfinite(err) and err <= TOL, err
    else:
        held = sw_fp64_check(ks, f0, fk, fr, 20, it0=steps)
    del f0, fk, fr
    say(f'compare main path {scene}: '
        + ('' if rho_err is None else
           f'pre-pass max|drho| = {rho_err:.3e} (tol {RHO_TOL:g}); ')
        + f'20 steps from the state after {steps}, wet max|df| = {err:.3e}'
        f'{held}')
    a, b = ks.a, ks.b
    if ks.sc:
        ks.density_into(a, ks.rho)
    ms = util.cuda_time_ms(lambda: ks._launch(a, b), 50, warmup=5)
    plain_ms = util.cuda_time_ms(lambda: ks.reference(a, ks.rho), 5)
    say(f'kernel {name} at {"x".join(map(str, size))}: {ms:.4f} ms per '
        f'launch; step_reference {plain_ms:.3f} ms')
    results = {name: dict(launches=counts[name], ms=ms, plain_ms=plain_ms,
                          err=err, mlups=mlups)}
    if ks.sc:
        rb = ks.rho
        rho_ms = util.cuda_time_ms(lambda: ks.density_into(a, rb), 50,
                                   warmup=5)
        plain_rho_ms = util.cuda_time_ms(
            lambda: sm.rho_reference(a, grid), 5)
        say(f'kernel {ks.rho_name} at {"x".join(map(str, size))}: '
            f'{rho_ms:.4f} ms per launch; rho_reference {plain_rho_ms:.3f} '
            f'ms; the pre-pass is {rho_ms / (rho_ms + ms):.3f} of a step')
        results[ks.rho_name] = dict(launches=counts[ks.rho_name],
                                    ms=rho_ms, plain_ms=plain_rho_ms,
                                    err=rho_err, step_launch_ms=ms)
    del r, ks, a, b
    torch.cuda.empty_cache()
    return results


def sc_unforced_ms(scene, sim_cls, cfg, ks):
    """ms per launch of the forced step kernel ``ks`` and of the unforced
    instantiation of the same K on the same scene without its forces, on
    ``ks``'s mask, densities and state buffers, in turns (there and back):
    what the Guo forces cost a step. Returns the unforced ms."""
    k = run(unforced(sim_cls), max_iters=0, **cfg).kernel
    assert not k.forced and k.K == ks.K and torch.equal(k.mask, ks.mask)
    k.a, k.b, k.rho, k.mask = ks.a, ks.b, ks.rho, ks.mask
    torch.cuda.empty_cache()
    a, b, rb = ks.a, ks.b, ks.rho
    turns = {ks.name: [], k.name: []}
    for stepper in (ks, k, k, ks):
        turns[stepper.name].append(util.cuda_time_ms(
            lambda: stepper.collide_into(a, rb, b), 100, warmup=50))
    ms = {name: statistics.mean(t) for name, t in turns.items()}
    say(f'kernel {ks.name} on the buffers of {scene}, in turns: '
        f'{ks.name} {ms[ks.name]:.4f} {turns[ks.name]}, {k.name} '
        f'{ms[k.name]:.4f} {turns[k.name]}; forced over unforced '
        f'{ms[ks.name] / ms[k.name]:.4f}')
    return ms[k.name]


def merge_rows(results, rows):
    """Add ``rows`` ({JSON row: measurements}) to ``results``: a row there
    already (the pre-pass of several paths) adds its launches and keeps
    the larger error; its times stay the first path's."""
    for name, res in rows.items():
        if name in results:
            res = dict(results[name],
                       launches=results[name]['launches'] + res['launches'],
                       err=max(results[name]['err'], res['err']))
        results[name] = res


def fe_main_path(scene, sim_cls, size, copy_bw, chunk=500, chunks=2):
    """A free-energy scene through the controller with the default engine:
    the main path of the model. The launch counts are zeroed just before
    the controller runs and read just after. Checks: finite fields, the
    total of rho (float64 sums) within ``FE_RHO_TOL`` relative and the
    total of phi within ``FE_PHI_TOL`` per node, and 10 steps from the
    final state against the plain versions; then each kernel is timed
    alone against its plain version."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    steps = chunk * chunks

    class Sim(sim_cls):
        def make_initial_state(self, builder, dtype):
            state = super().make_initial_state(builder, dtype)
            self.mass0 = [float(torch.sum(f, dtype=torch.float64))
                          for f in state]
            return state

    sm.reset_launch_counts()
    fe.reset_launch_counts()
    r = run(Sim, max_iters=steps, every=chunk, seed=1, **cfg)
    counts = {**sm.LAUNCHES, **fe.LAUNCHES}
    assert r.engine == 'kernel', r.engine
    ks = r.kernel
    assert isinstance(ks, fe.FEStep)
    assert counts[ks.name] == counts[ks.rho_name] == steps \
        == r.sim.iteration, (counts, steps)
    assert sum(counts.values()) == 2 * steps, counts
    assert ks.launches == {ks.rho_name: steps, ks.name: steps}
    assert st.is_finite(r.f)
    nodes = int(np.prod(size))
    mass = [float(torch.sum(f, dtype=torch.float64)) for f in r.f]
    rho_drift = abs(mass[0] - r.sim.mass0[0]) / r.sim.mass0[0]
    phi_drift = abs(mass[1] - r.sim.mass0[1]) / nodes
    assert rho_drift <= FE_RHO_TOL, (mass, r.sim.mass0)
    assert phi_drift <= FE_PHI_TOL, (mass, r.sim.mass0)
    r._fields_to_host()
    shape = tuple(reversed(size))
    for name, arr in (('rho', r.sim.rho), ('phi', r.sim.phi),
                      ('vx', r.sim.vx)):
        assert arr.shape == shape and np.all(np.isfinite(arr)), name
    phi_range = (float(r.sim.phi.min()), float(r.sim.phi.max()))
    grid = ks.grid
    mlups = statistics.median(r.mlups_history[1:])
    eff = mlups * 1e6 * FE_BYTES[grid.name]
    say(f'main path {scene} {"x".join(map(str, size))} ({grid.name}, '
        f'{ks.builder.fe_model}, engine {r.engine}): {counts[ks.rho_name]} '
        f'{ks.rho_name} + {counts[ks.name]} {ks.name} launches; MLUPS per '
        f'{chunk}-step chunk {[round(m, 1) for m in r.mlups_history]}; '
        f'median {mlups:.1f} MLUPS; {eff / 1e9:.1f} GB/s effective '
        f'({FE_BYTES[grid.name]} B/node), {eff / copy_bw:.3f} of the copy '
        f'bandwidth; rho drift {rho_drift:.2e} relative (tol '
        f'{FE_RHO_TOL:g}), phi drift {phi_drift:.2e} per node (tol '
        f'{FE_PHI_TOL:g}); phi range {phi_range[0]:.4f} .. '
        f'{phi_range[1]:.4f}')
    # the kernels against their plain versions on the main path's own
    # state and shapes (10 steps), then each timed alone
    phi_err, err = fe_errors(ks, tuple(f.clone() for f in r.f), 10)
    say(f'compare main path {scene}: pre-pass max|dphi| = {phi_err:.3e}; '
        f'10 steps from the state after {steps}, wet max|df| = {err:.3e} '
        f'(tol {TOL:g})')
    a, b, pb = ks.a, ks.b, ks.phi
    rho_ms = util.cuda_time_ms(lambda: ks.phi_into(a, pb), 50, warmup=5)
    ms = util.cuda_time_ms(lambda: ks.collide_into(a, pb, b), 50, warmup=5)
    plain_rho_ms = util.cuda_time_ms(
        lambda: sm.rho_reference(a[1], grid), 5)
    plain_ms = util.cuda_time_ms(
        lambda: fe.fe_step_reference(a.unbind(0), pb, ks.mask, ks.orient,
                                     ks.builder), 5)
    say(f'kernel {ks.rho_name} at {"x".join(map(str, size))}: {rho_ms:.4f} '
        f'ms per launch (order parameter alone); rho_reference '
        f'{plain_rho_ms:.3f} ms')
    tile = '' if ks.tile is None else (
        f' (tile {ks.tile.tx}x{ks.tile.ty} threads, {ks.tile.kz} z-planes '
        f'per block, grid {ks.tile.grid}, {ks.tile.smem_bytes} B shared)')
    say(f'kernel {ks.name} at {"x".join(map(str, size))}{tile}: {ms:.4f} ms '
        f'per launch ({ks.builder.fe_model}); fe_step_reference '
        f'{plain_ms:.3f} ms; the pre-pass is {rho_ms / (rho_ms + ms):.3f} of '
        f'a step')
    results = {
        ks.rho_name: dict(launches=counts[ks.rho_name], ms=rho_ms,
                          plain_ms=plain_rho_ms, err=phi_err),
        ks.name: dict(launches=counts[ks.name], ms=ms, plain_ms=plain_ms,
                      err=err, mlups=mlups),
    }
    del r, ks, a, b, pb
    torch.cuda.empty_cache()
    return results


def fe_mrt_time(size=256, steps=20):
    """The FE-MRT instantiation of the 3D free-energy kernel timed at
    size^3 beside the main path's BGK one: ``fe_separation_3d`` with
    ``--model=mrt`` on the kernel engine, 20 steps from its initial state,
    then ``fe_step`` alone; the result must stay finite."""
    r = run(FE['fe_separation_3d'], max_iters=0, lat_nx=size, lat_ny=size,
            lat_nz=size, model='mrt', tau_a=3.0, tau_b=0.8)
    ks = r.kernel
    assert isinstance(ks, fe.FEStep) and ks.mrt
    out = ks.run(r.f, steps)
    assert all(bool(torch.isfinite(f).all()) for f in out)
    a, b, pb = ks.b, ks.a, ks.phi
    ks.phi_into(a, pb)
    ms = util.cuda_time_ms(lambda: ks.collide_into(a, pb, b), 50, warmup=5)
    say(f'kernel {ks.name} at {size}^3 (mrt, tile {ks.tile.tx}x{ks.tile.ty}'
        f'x{ks.tile.kz}): {ms:.4f} ms per launch after {steps} steps')
    del r, ks, out, a, b, pb
    torch.cuda.empty_cache()
    return ms


def fe_demix(size=512, steps=2500):
    """Free-energy demixing on the kernel engine with the parameters of
    tests/test_binary.py:63-66 (kappa = A = 0.04, Gamma = 1, tau_a = 1,
    tau_b = 0.8, phi = 0.1 (U(0, 1) - 0.5) from RandomState(11)): the
    order parameter must reach past +-0.5 and the mean density stay 1."""
    base = FE['fe_separation_2d']

    class Noise(base.subdomain):
        def initial_conditions(self, sim, hx, hy):
            rng = np.random.RandomState(11)
            sim.rho[:] = 1.0
            sim.phi[:] = 0.1 * (rng.rand(*sim.phi.shape) - 0.5)

    class Sim(base):
        subdomain = Noise

    r = run(Sim, max_iters=steps, every=steps, lat_nx=size, lat_ny=size,
            kappa=0.04, Gamma=1.0, A=0.04, tau_a=1.0, tau_b=0.8,
            tau_phi=1.0)
    assert r.engine == 'kernel' and isinstance(r.kernel, fe.FEStep)
    assert r.kernel.launches[r.kernel.name] == steps
    r._fields_to_host()
    phi, rho = r.sim.phi, r.sim.rho
    assert np.all(np.isfinite(phi)) and np.all(np.isfinite(rho))
    ok = phi.max() > 0.5 and phi.min() < -0.5
    say(f'demixing fe_separation_2d {size}x{size}, {steps} steps (kernel '
        f'engine): phi range {phi.min():.4f} .. {phi.max():.4f} (pass: '
        f'beyond -0.5 and 0.5), mean rho {rho.mean():.6f}')
    assert ok, (phi.min(), phi.max())
    assert abs(rho.mean() - 1.0) < 1e-3, rho.mean()
    del r
    torch.cuda.empty_cache()


def plain_path(scene, sim_cls, size, chunk, chunks=2):
    """The same scene on the plain torch engine on the card."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    r = run(sim_cls, engine='torch', max_iters=chunk * chunks,
            every=chunk, **cfg)
    assert r.engine == 'torch' and r.device.type == DEVICE
    assert st.is_finite(r.f)
    mlups = statistics.median(r.mlups_history[1:])
    say(f'plain torch engine {scene} {"x".join(map(str, size))}: MLUPS '
        f'per {chunk}-step chunk {[round(m, 2) for m in r.mlups_history]};'
        f' median {mlups:.2f} MLUPS')
    del r
    torch.cuda.empty_cache()
    return mlups


#: the lattices of the D3Q15 / D3Q27 library and their comparison scenes
#: at 64^3, 100 steps (200 until the smoke's time was cut for the
#: Shan-Chen and free-energy mesh paths): the lid cavity carries every
#: class without wall rows (each force model, the compressible and the
#: incompressible equilibrium), a half-way box closed on every axis (a TMS
#: box for the incompressible equilibrium) every class with them
LATTICE_STEPS = 100
LATTICE_CUBE = dict(lat_nx=64, lat_ny=64, lat_nz=64)
#: the turbulence main paths: Kida's vortex at the scene's defaults on
#: D3Q15 256^3 with its KE/enstrophy hook every 20 steps, and the channel
#: at its published settings (H = 40, Re_tau = 180, full bounce-back walls:
#: 240 x 82 x 80, D3Q19, Guo) with the Reynolds statistics hook every 20
#: steps from iteration 0
KIDA = turbulence_twin('kida_vortex')
CHANNEL_FLOW = turbulence_twin('channel_flow')
STATS_EVERY = 20


def lattice_compare(grid_name, wall, force_model, incompressible):
    """One instantiation class of the D3Q15 / D3Q27 library against
    ``step_reference`` on the same lattice: ``wall`` None for the lid
    cavity, else a box of that wall (half-way or TMS) closed on every
    axis, both with a block of excluded nodes; under ``force_model`` (or
    none) and the compressible or the incompressible equilibrium."""
    accel = ACCEL if force_model else None
    if wall is None:
        sim = LDC_3D if accel is None else forced(LDC_3D, accel)
        cfg = dict(LATTICE_CUBE)
    else:
        sim = box_sim(WALLS[wall], 3, (0, 1, 2), accel)
        cfg = dict(box_cfg(3, (0, 1, 2)), **LATTICE_CUBE)
    if force_model:
        cfg['force_implementation'] = force_model
    r = run(with_keep_block(sim), platform=DEVICE, engine='kernel',
            max_iters=0, grid=grid_name, incompressible=incompressible,
            visc=0.05, **cfg)
    ks = r.kernel
    g = grid_name.lower()
    assert ks.library == ls.LATTICES_LIBRARY and ks.walls == bool(wall)
    assert ks.params.force.model == ls.FORCE_CODES.get(force_model, 0)
    steps = LATTICE_STEPS
    f0 = random_feq(r.sim.grid, ks.shape, seed=1234, device=DEVICE)
    fk = ks.run(f0, steps)
    fr = f0
    for _ in range(steps):
        fr = ks.reference(fr)
    util.synchronize(DEVICE)
    assert ks.launches == steps
    err = float((fk - fr)[:, wet_mask(ks)].abs().max())
    moved = float((fk - f0).abs().max())
    say(f'compare lattice {g} {wall or "cavity"} force {force_model} '
        f'{"incompressible" if incompressible else "compressible"}: '
        f'{steps} steps of {ks.name}, wet max|df| = {err:.3e} (tol '
        f'{TOL:g}); the state moved by {moved:.3e}')
    assert np.isfinite(err) and err <= TOL, err
    assert moved > 100 * TOL, moved
    del r, ks, f0, fk, fr
    torch.cuda.empty_cache()
    return f'lbm_step_{g}', err


def chunk_ms(r, run_steps, chunk, it):
    """Host milliseconds of one ``chunk``-step call of ``run_steps`` on the
    runner's state from iteration ``it``, between device synchronizations
    (as the runner times a chunk)."""
    util.synchronize(DEVICE)
    t0 = time.perf_counter()
    r.f = run_steps(r.f, chunk, it)
    util.synchronize(DEVICE)
    return 1e3 * (time.perf_counter() - t0)


def hook_share(r, chunk):
    """The hooks' share of a chunk: two chunks with the runner's hooks and
    two of the engine alone (``KernelStep.run``), in turns, continuing the
    run; returns (median hooked ms, median plain ms, share)."""
    it = r.sim.iteration
    hooked, plain = [], []
    for _ in range(2):
        hooked.append(chunk_ms(r, r._run_steps, chunk, it))
        plain.append(chunk_ms(r, r.kernel.run, chunk, it + chunk))
        it += 2 * chunk
    h, p = statistics.median(hooked), statistics.median(plain)
    return h, p, (h - p) / h


def hooked_main_path(path, sim_cls, cfg, name, copy_bw, check, chunk=500,
                     chunks=2):
    """A scene whose statistics run through a device hook, through the
    controller with the default engine (launch counts zeroed just before,
    read just after): MLUPS per chunk, ``check(runner)`` on the run's
    result (it returns a line to print), the kernel against its plain
    version from the final state, ms per launch, and the hooks' share of a
    chunk (``hook_share``). Returns the result row."""
    steps = chunk * chunks
    ls.reset_launch_counts()
    r = run(sim_cls, max_iters=steps, every=chunk, **cfg)
    counts = dict(ls.LAUNCHES)
    ks = r.kernel
    assert r.engine == 'kernel' and ks.name == name, (r.engine, ks.name)
    assert counts[name] == steps == r.sim.iteration == ks.launches, counts
    assert sum(counts.values()) == steps, counts
    assert len(r.device_hook_state) == 1
    assert st.is_finite(r.f)
    grid = r.sim.grid.name
    mlups = statistics.median(r.mlups_history[1:])
    eff = mlups * 1e6 * BYTES[grid]
    shape = 'x'.join(str(n) for n in reversed(ks.shape))
    say(f'main path {path} {shape} ({grid}, engine {r.engine}): {steps} '
        f'{name} launches, one per step; MLUPS per {chunk}-step chunk '
        f'{[round(m, 1) for m in r.mlups_history]}; median {mlups:.1f} '
        f'MLUPS; {eff / 1e9:.1f} GB/s effective ({BYTES[grid]} B/node), '
        f'{eff / copy_bw:.3f} of the copy bandwidth')
    say(f'{path}: {check(r)}')
    # the kernel against its plain version on the main path's own state
    # and shapes (10 steps), then each timed alone on the same tensors,
    # then the hook's share of a chunk from where that leaves the state
    f0 = r.f.clone()
    fk = ks.run(f0, 10)
    fr = f0
    for _ in range(10):
        fr = ks.reference(fr)
    err = float((fk - fr)[:, wet_mask(ks)].abs().max())
    say(f'compare main path {path}: 10 steps from the state after {steps}, '
        f'wet max|df| = {err:.3e} (tol {TOL:g})')
    assert np.isfinite(err) and err <= TOL, err
    r.f = fk
    del f0, fr
    a, b = ks.a, ks.b
    ms = util.cuda_time_ms(lambda: ks.step_into(a, b), 50, warmup=5)
    plain_ms = util.cuda_time_ms(lambda: ks.reference(a), 5)
    nodes = int(np.prod(ks.shape))
    bound = nodes * BYTES[grid] / PEAK_BYTES * 1e3
    say(f'kernel {name} at {shape}: {ms:.4f} ms per launch (CUDA events); '
        f'step_reference {plain_ms:.3f} ms; bound {bound:.4f} ms '
        f'({BYTES[grid]} B per node at {PEAK_BYTES / 1e12:.2f} TB/s): '
        f'{bound / ms:.3f} of it')
    r.f = b
    h, p, share = hook_share(r, chunk)
    say(f'{path}: a {chunk}-step chunk with the hook {h:.2f} ms, without '
        f'{p:.2f} ms, in turns: the hook takes {share:.4f} of it')
    assert st.is_finite(r.f)
    del r, ks, a, b
    torch.cuda.empty_cache()
    return dict(launches=steps, mlups=mlups, ms=ms, plain_ms=plain_ms,
                err=err, hooked_ms=h, unhooked_ms=p, hook_share=share)


def kida_main_path(copy_bw, chunk=500, chunks=2):
    """``kida_vortex`` at the scene's defaults (D3Q15, visc 0.001375,
    max_v 0.05) at 256^3 with its KE/enstrophy hook every
    ``STATS_EVERY`` steps: one ``lbm_step_d3q15`` launch per step, the
    samples at 20, 40, ..., the last one equal to the mixin's kinetic
    energy and enstrophy of the final state, the mass kept, and the hook's
    share of a chunk."""
    steps = chunk * chunks

    def check(r):
        series = r.sim.ke_enstrophy_series()
        assert series[:, 0].tolist() == list(range(
            STATS_EVERY, steps + 1, STATS_EVERY)), series[:, 0]
        assert np.all(np.isfinite(series)) and np.all(series[:, 1:] > 0)
        # a periodic box keeps its mass (fp32 drift, MASS_TOL) and the
        # flow stays well below the lattice's speed of sound
        r._fields_to_host()
        mean_rho = float(np.mean(r.sim.rho, dtype=np.float64))
        vmax = float(np.sqrt(r.sim.vx ** 2 + r.sim.vy ** 2
                             + r.sim.vz ** 2).max())
        assert abs(mean_rho - 1.0) <= MASS_TOL and vmax < 0.3, \
            (mean_rho, vmax)
        ke, ens = r.sim.compute_ke_enstrophy(r)
        np.testing.assert_allclose(series[-1, 1:], [ke, ens], rtol=1e-5)
        return (f'KE {series[0, 1]:.6e} at {int(series[0, 0])} -> '
                f'{series[-1, 1]:.6e} at {int(series[-1, 0])}, enstrophy '
                f'{series[0, 2]:.6e} -> {series[-1, 2]:.6e} ({len(series)} '
                f'samples of the hook; the last the mixin\'s values of the '
                f'final state), mean rho - 1 = {mean_rho - 1.0:+.2e}, max '
                f'|u| {vmax:.4f}')

    return hooked_main_path(
        'kida_vortex_256', KIDA, dict(lat_nx=256, lat_ny=256, lat_nz=256,
                                      stats_every=STATS_EVERY),
        'lbm_step_d3q15', copy_bw, check, chunk, chunks)


def channel_flow_stats(from_iter=0):
    """``channel_flow`` with its Reynolds statistics sampled every
    ``STATS_EVERY`` steps from ``from_iter`` (the scene starts after two
    flow-through times)."""

    class Sim(CHANNEL_FLOW):
        def before_main_loop(self, runner):
            self.prepare_reynolds_stats(runner, axis='y', every=STATS_EVERY,
                                        from_iter=from_iter)

    return Sim


def channel_flow_main_path(copy_bw, chunk=500, chunks=2):
    """``channel_flow`` at its published settings (H = 40, Re_tau = 180,
    --wall=hbb: 240 x 82 x 80, D3Q19, Guo) with the Reynolds statistics
    hook every ``STATS_EVERY`` steps from iteration 0: one
    ``lbm_step_force_d3q19`` launch per step, a sample at 20, 40, ...,
    finite profiles with the mean streamwise velocity positive inside the
    channel, and the hook's share of a chunk."""
    steps = chunk * chunks

    def check(r):
        assert tuple(r.kernel.shape) == (80, 82, 240), r.kernel.shape
        cnt, _acc = r.device_hook_state[0]
        assert int(cnt) == steps // STATS_EVERY, int(cnt)
        stats = r.sim.reynolds_stats()
        assert all(np.all(np.isfinite(v)) for v in stats.values())
        u_mean = stats['u'][0]
        assert np.all(u_mean[1:-1] > 0) and u_mean.max() < 0.1, u_mean
        return (f'{int(cnt)} Reynolds samples (every {STATS_EVERY} steps '
                f'from 0), mean u at the centre '
                f'{u_mean[len(u_mean) // 2]:.5f}, at the first fluid row '
                f'{u_mean[1]:.5f}')

    return hooked_main_path(
        'channel_flow', channel_flow_stats(),
        dict(H=40, Re_tau=180, wall='hbb'), 'lbm_step_force_d3q19', copy_bw,
        check, chunk, chunks)


def mixed_hook_bitwise():
    """``--precision=mixed`` on the kernel engine: the cavity at 64^3 with
    a hook every 7 steps ends 100 steps in the same bits as without it (the
    hook sees a dequantized copy; the int16 buffers are stepped across the
    splits)."""
    steps, every = 100, 7

    class Hooked(LDC_3D):
        def before_main_loop(self, runner):
            def hook(f, acc, it):
                if it % every == 0:
                    rho, _ = runner.builder.macro_fields(f)
                    acc = acc + rho.sum(dtype=torch.float64)
                return acc
            self.add_device_hook(torch.zeros((), dtype=torch.float64), hook,
                                 every=every)

    finals = []
    for sim in (LDC_3D, Hooked):
        r = run(sim, max_iters=steps, every=50, precision='mixed',
                **LATTICE_CUBE)
        assert r.engine == 'kernel' and r.kernel.mixed is not None
        finals.append(r.f.clone())
    (acc,) = r.device_hook_state
    assert float(acc) > 0
    same = torch.equal(*finals)
    say(f'mixed cavity 64^3, {steps} steps, hook every {every}: the final '
        f'state with the hook is bitwise the state without it: {same}')
    assert same


def checkpoint_continues(tmp):
    """A checkpoint with the Reynolds hook's state written at step 40 and
    restored: the restored run's accumulators at step 60 are the unbroken
    run's (the channel at H = 8 on the kernel engine)."""
    steps, half = 60, 40
    flags = dict(H=8, Re_tau=60, wall='tms')
    base = os.path.join(tmp, 'cp')
    run(channel_flow_stats(), max_iters=half, every=half,
        checkpoint_file=base, final_checkpoint=True, **flags)
    cpoint = [n for n in os.listdir(tmp) if n.endswith('.cpoint.npz')]
    assert len(cpoint) == 1, cpoint
    with np.load(os.path.join(tmp, cpoint[0])) as cp:
        n_hook = sum(k.startswith('hook') for k in cp.files)
        assert int(cp['hook0']) == half // STATS_EVERY
    restored = run(channel_flow_stats(), max_iters=steps, every=steps,
                   restore_from=os.path.join(tmp, cpoint[0]), **flags)
    whole = run(channel_flow_stats(), max_iters=steps, every=steps,
                **flags)
    assert restored.engine == whole.engine == 'kernel'
    a, b = restored.sim.reynolds_stats(), whole.sim.reynolds_stats()
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)
    cnt = int(restored.device_hook_state[0][0])
    say(f'checkpoint with hook state ({n_hook} hook leaves) written at '
        f'{half}, restored and run to {steps}: {cnt} Reynolds samples, the '
        f'accumulators the unbroken run\'s bits: {same}')
    assert same and cnt == steps // STATS_EVERY


#: the outflow family's kernel comparisons (``outflow_compare``): each
#: kernel-borne type on D3Q19 64^3 and D2Q9 1024x512, the outlet normal to
#: x, or to z / y, in turns, unforced and under each force model in turns,
#: 200 steps from a random state. The compressible equilibrium only: from a
#: random state several of these channels diverge under the incompressible
#: one on every engine (``torch_scenes.INCOMPRESSIBLE_UNSTABLE``; at
#: 1024x512 the Grad channel too); tests/test_torch_cuda.py holds the
#: incompressible instantiations on smaller channels
OUTFLOW_STEPS = 200
OUTFLOW_SIZE = {3: dict(lat_nx=64, lat_ny=64, lat_nz=64),
                2: dict(lat_nx=1024, lat_ny=512)}
OUTFLOW_ACCEL = (1e-5, -4e-6, 2.5e-6)
#: the outflow family's main paths: open-channel flow past a sphere and a
#: cylinder, drag read by a force object after every chunk (``torch_scenes.
#: open_channel``); and the 2D laminarize channel, the laminarize
#: pre-pass's path (``torch_scenes.outflow_channel``)
OPEN_MAIN = {'open_sphere_3d': (3, (512, 256, 256)),
             'open_cylinder_2d': (2, (8192, 2048))}
LAMINARIZE_MAIN = (8192, 2048)


def outflow_compare(kind, dim, axis, force_model):
    """The outflow rows of ``kind`` against ``step_reference`` on the
    card from one random state: the inflow/outflow channel of
    ``torch_scenes.outflow_channel`` (a block of excluded nodes added)
    under ``force_model`` (or none); the laminarize pre-pass against its
    plain version (``RHO_TOL``), one launch within ``TOL``, and
    ``OUTFLOW_STEPS`` steps within ``TOL`` or, where the fp32 arithmetics
    part, ``sw_fp64_check``'s rule (Yu's extrapolation 2 f(x + n) - f(x +
    2n) feeds each step's rounding back at the outlet: on the 2D channel
    the fp32 and the fp64 plain versions part by 1.6e-5 in 200 steps).
    ``NTGradFreeflow`` nodes collide as fluid nodes (mask code 0): its
    channel runs the plain instantiation."""
    sim = outflow_channel(kind, dim, axis)
    flags = {}
    if force_model:
        sim = forced(sim, OUTFLOW_ACCEL[:dim])
        flags = dict(force_implementation=force_model)
    r = run(with_keep_block(sim), platform=DEVICE, engine='kernel',
            max_iters=0, **OUTFLOW_SIZE[dim], **flags)
    ks = r.kernel
    assert ks.outflow == (kind != 'NTGradFreeflow'), ks.name
    f0 = random_feq(ks.grid, ks.shape, seed=1234, device=DEVICE)
    wet = wet_mask(ks)
    lam_err = None
    if ks.lam is not None:
        mean = torch.empty_like(ks.lam.mean)
        ks.mean_into(f0, mean)
        lam_err = float((mean - ks.laminarize_mean_reference(f0))
                        .abs().max())
        assert lam_err <= RHO_TOL, lam_err
    one = float((ks.run(f0, 1) - ks.reference(f0))[:, wet].abs().max())
    fk = ks.run(f0, OUTFLOW_STEPS)
    fr = f0
    for _ in range(OUTFLOW_STEPS):
        fr = ks.reference(fr)
    util.synchronize(DEVICE)
    err = float((fk - fr)[:, wet].abs().max())
    moved = float((fk - f0)[:, wet].abs().max())
    assert ks.launches == 1 + OUTFLOW_STEPS
    assert ks.prepass_launches == (ks.launches + 1 if ks.lam is not None
                                   else 0)
    assert np.isfinite(one) and one <= TOL, one
    fp64 = '' if err <= TOL else \
        sw_fp64_check(ks, f0, fk, fr, OUTFLOW_STEPS)
    say(f'compare outflow {kind} {ks.grid.name} {ks.shape} outlet normal '
        f'to {axis}, force {force_model}: '
        f'{ks.name}, one launch wet max|df| = {one:.3e}, '
        f'{OUTFLOW_STEPS} steps {err:.3e} (tol {TOL:g}){fp64}; the state '
        f'moved by {moved:.3e}'
        + ('' if lam_err is None else
           f'; {ks.lam_name} plane means max|d| = {lam_err:.3e} (tol '
           f'{RHO_TOL:g})'))
    assert moved > 100 * TOL, moved
    name = ks.name
    del r, ks, f0, fk, fr
    torch.cuda.empty_cache()
    return name, max(one, err), lam_err


def with_outlet(sim_cls, kind='NTCopy'):
    """``sim_cls`` with an outflow row of ``kind`` on its x = X - 1 face
    (inward normal -x)."""
    block = sim_cls.subdomain

    class Outlet(block):
        def boundary_conditions(self, *h):
            super().boundary_conditions(*h)
            self.set_node(h[0] == self.shape[-1] - 1, getattr(nt, kind)())

    class Sim(sim_cls):
        subdomain = Outlet

    return Sim


def outflow_refusals():
    """On the card, the default engine refuses by name the scenes with
    outflow rows that the kernels leave out, and changes no engine: MRT,
    LES, ELBM, int16 state, the D3Q15 / D3Q27 lattices, the extended copy,
    Guo's density BC beside a half-way wall, the Shan-Chen modes (single
    component and mixture) and the free-energy kernel."""
    cube = dict(lat_nx=32, lat_ny=16, lat_nz=16)
    sq = dict(lat_nx=64, lat_ny=32)
    cases = [
        ('MRT', outflow_channel('NTYuOutflow', 3, 'x'),
         dict(cube, model='mrt'), 'outflow rows (NTYuOutflow) with model=mrt'),
        ('LES', outflow_channel('NTCopy', 2, 'x'),
         dict(sq, subgrid='les-smagorinsky'),
         'outflow rows (NTCopy) with the Smagorinsky LES model'),
        ('ELBM', outflow_channel('NTDoNothing', 2, 'y'),
         dict(sq, model='elbm'), 'outflow rows (NTDoNothing) with model=elbm'),
        ('int16 state', outflow_channel('NTNeumann', 2, 'x'),
         dict(sq, precision='mixed'),
         'outflow rows (NTNeumann) under --precision=mixed'),
        ('D3Q15', outflow_channel('NTLaminarize', 3, 'z'),
         dict(cube, grid='D3Q15'), 'outflow rows (NTLaminarize) on D3Q15'),
        ('D3Q27', outflow_channel('NTGuoDensity', 3, 'x'),
         dict(cube, grid='D3Q27'), 'outflow rows (NTGuoDensity) on D3Q27'),
        ('the extended copy', outflow_channel('NTExtendedCopy', 2, 'x'), sq,
         'node type NTExtendedCopy'),
        ('Guo beside a half-way wall', guo_beside_halfbb(), sq,
         'NTGuoDensity (orientation 1) beside'),
        ('single-component Shan-Chen', with_outlet(twin('sc_drop')), sq,
         'Shan-Chen with BC rows (NTCopy'),
        ('a Shan-Chen mixture', with_outlet(SEP_2D), sq,
         'boundary conditions NTCopy (the Shan-Chen kernel'),
        ('a free-energy mixture', with_outlet(FE['fe_separation_2d']), sq,
         'boundary conditions NTCopy (the free-energy kernel'),
    ]
    for what, sim_cls, cfg, reason in cases:
        try:
            run(sim_cls, max_iters=0, **cfg)
        except NotImplementedError as exc:
            assert reason in str(exc), (what, str(exc))
            say(f'refused on the default engine: outflow rows with {what} '
                f'({reason!r} in: {str(exc)[:160]})')
            continue
        raise AssertionError(f'outflow rows with {what} were not refused')


def open_main_path(path, dim, size, copy_bw, chunk=250, chunks=8):
    """``open_channel`` at full width through the controller with the
    default engine, the launch counts zeroed just before and read just
    after: one ``lbm_step_outflow_<grid>`` launch per step and no other,
    finite fields, the drag of the force object sampled after every chunk
    and positive along +x on average over the samples (the impulsive start
    sends pressure waves between the inlet and the body, and a sample of
    the 2D channel's first 2,000 steps can be negative); then the kernel
    against its plain version for
    2 steps from the final state, ms per launch (CUDA events) against the
    bound and the plain version, ms per step of the chunks, the device's
    idle share of one more chunk traced with ``torch.profiler``
    (``tools/trace_main_path.trace_runner_chunk``; the trace is written
    under ``chiprun_out/traces``) and the host ms of one
    ``update_force_objects`` sample."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    steps = chunk * chunks
    ls.reset_launch_counts()
    r = run(open_channel(dim), max_iters=steps, every=chunk, **cfg)
    counts = {k: v for k, v in ls.LAUNCHES.items() if v}
    assert r.engine == 'kernel', r.engine
    name = f'lbm_step_outflow_{r.sim.grid.name.lower()}'
    assert r.kernel.name == name, r.kernel.name
    launches = counts.get(name, 0)
    assert launches == steps == r.sim.iteration == r.kernel.launches, \
        (counts, steps)
    assert counts == {name: launches}, counts
    r._fields_to_host()
    shape = tuple(reversed(size))
    fields = [r.sim.rho, r.sim.vx, r.sim.vy] + ([r.sim.vz] if dim == 3
                                                else [])
    for arr in fields:
        assert arr.shape == shape and np.all(np.isfinite(arr))
    ks = r.kernel
    wet = wet_mask(ks)
    wet_np = wet.cpu().numpy()
    vmax = float(np.sqrt(sum(v[wet_np] ** 2 for v in fields[1:])).max())
    mean_rho = float(np.mean(r.sim.rho[wet_np], dtype=np.float64))
    drag = [(it, tuple(F)) for it, F in r.sim.drag]
    assert [it for it, _F in drag] == list(range(chunk, steps + 1, chunk))
    assert np.all(np.isfinite([F for _it, F in drag])), drag
    mean_drag = float(np.mean([F[0] for _it, F in drag]))
    assert mean_drag > 0, drag
    # no wet node beyond the lattice's speed of sound
    assert vmax < 0.3, vmax
    grid = r.sim.grid.name
    nodes = int(np.prod(size))
    mlups = statistics.median(r.mlups_history[1:])
    history = list(r.mlups_history)
    step_ms = 1e3 * nodes / (mlups * 1e6)
    # the state and drag series the mesh paths are held to
    final = r.f.clone()
    trace_dir = os.path.join(REPO, 'chiprun_out', 'traces')
    os.makedirs(trace_dir, exist_ok=True)
    traced = trace_runner_chunk(r, path, chunk, trace_dir)
    idle = traced['idle_share']
    f0 = r.f.clone()
    fk = ks.run(f0, 2)
    fr = ks.reference(ks.reference(f0))
    err = float((fk - fr)[:, wet].abs().max())
    assert np.isfinite(err) and err <= TOL, err
    del f0, fk, fr
    a, b = ks.a, ks.b
    ms = util.cuda_time_ms(lambda: ks.step_into(a, b), 50, warmup=5)
    plain_ms = util.cuda_time_ms(lambda: ks.reference(a), 3)
    fo_ms = []
    for _ in range(5):
        util.synchronize(DEVICE)
        t0 = time.perf_counter()
        r.update_force_objects()
        fo_ms.append(1e3 * (time.perf_counter() - t0))
    bound, bound_by = bound_ms(name, nodes)
    say(f'main path {path} {"x".join(map(str, size))} ({grid}, engine '
        f'{r.engine}): lbm_step.LAUNCHES {counts}; MLUPS per {chunk}-step '
        f'chunk {[round(m, 1) for m in history]}; median '
        f'{mlups:.1f} MLUPS, {step_ms:.4f} ms per step; {name} {ms:.4f} ms '
        f'per launch against a bound of {bound:.4f} ms ({bound_by}): '
        f'{bound / ms:.3f} of it; device idle share of a traced chunk '
        f'{idle:.5f} (busy {traced["busy_us"]:.1f} of '
        f'{traced["window_us"]:.1f} us, gaps {traced["gaps_us"]:.1f} us, '
        f'{traced["other_kernels_per_step"]:.2f} other kernels per step); '
        f'step_reference {plain_ms:.3f} ms; kernel vs plain '
        f'version 2 steps from the final state wet max|df| = {err:.3e} '
        f'(tol {TOL:g}); mean wet rho - 1 = {mean_rho - 1.0:+.3e}, max '
        f'|u| {vmax:.4f}; drag (iteration, force) {drag}, mean along x '
        f'{mean_drag:.6f}; '
        f'update_force_objects {statistics.median(fo_ms):.3f} ms per '
        f'sample (host, synchronized; median of 5)')
    result = dict(launches=launches, mlups=mlups, ms=ms, plain_ms=plain_ms,
                  err=err, nodes=nodes, step_ms=step_ms, idle_share=idle,
                  drag=mean_drag,
                  force_object_ms=statistics.median(fo_ms))
    flat = dict(final=final, drag=drag, chunk=chunk, chunks=chunks,
                force_object_ms=result['force_object_ms'], ms=ms)
    del r, ks, a, b
    free_memory()
    return name, result, flat


def laminarize_main_path(size=LAMINARIZE_MAIN, chunk=500, chunks=2):
    """The 2D laminarize channel (``outflow_channel('NTLaminarize', 2,
    'x')``: an equilibrium-velocity inlet, a laminarize outlet whose alpha
    rises across the channel) at full width through the controller with
    the default engine: per step one ``laminarize_mean_d2q9`` pre-pass and
    one ``lbm_step_outflow_d2q9`` launch and no other, finite fields; then
    the pre-pass against its plain version on the final state and its ms
    per launch (CUDA events) against its bound (its laminarize nodes' Q
    pulled values and indices, the means and offsets written / read)."""
    cfg = dict(lat_nx=size[0], lat_ny=size[1])
    steps = chunk * chunks
    ls.reset_launch_counts()
    r = run(outflow_channel('NTLaminarize', 2, 'x'), max_iters=steps,
            every=chunk, **cfg)
    counts = {k: v for k, v in ls.LAUNCHES.items() if v}
    ks = r.kernel
    assert r.engine == 'kernel' and ks.lam is not None
    assert counts == {'lbm_step_outflow_d2q9': steps,
                      'laminarize_mean_d2q9': steps}, counts
    r._fields_to_host()
    for arr in (r.sim.rho, r.sim.vx, r.sim.vy):
        assert np.all(np.isfinite(arr))
    mean = torch.empty_like(ks.lam.mean)
    ks.mean_into(r.f, mean)
    err = float((mean - ks.laminarize_mean_reference(r.f)).abs().max())
    assert err <= RHO_TOL, err
    ms = util.cuda_time_ms(lambda: ks.mean_into(ks.a, mean), 200,
                           warmup=10)
    plain_ms = util.cuda_time_ms(
        lambda: ks.laminarize_mean_reference(ks.a), 5)
    step_ms = util.cuda_time_ms(lambda: ks.step_into(ks.a, ks.b), 20,
                                warmup=3)
    lam_nodes = int(ks.lam.nodes.numel())
    entries = int(ks.lam.mean.shape[0])
    extra = entries * ks.grid.Q * 4 + (entries + 1) * 4
    bound, bound_by = bound_ms('laminarize_mean_d2q9', lam_nodes, extra)
    mlups = statistics.median(r.mlups_history[1:])
    say(f'main path laminarize_channel_2d {size[0]}x{size[1]} (D2Q9, engine '
        f'{r.engine}): lbm_step.LAUNCHES {counts}; median {mlups:.1f} '
        f'MLUPS; laminarize_mean_d2q9 over {lam_nodes} nodes in {entries} '
        f'plane(s): {ms:.5f} ms per launch against a bound of {bound:.6f} '
        f'ms ({bound_by}): {bound / ms:.4f} of it; plain version '
        f'{plain_ms:.3f} ms; max|d| against it {err:.3e} (tol '
        f'{RHO_TOL:g}); the step with the pre-pass {step_ms:.4f} ms')
    result = dict(launches=steps, ms=ms, plain_ms=plain_ms, err=err,
                  nodes=lam_nodes, extra_bytes=extra,
                  step_with_prepass_ms=step_ms, mlups=mlups)
    del r, ks, mean
    torch.cuda.empty_cache()
    return result



# -- the outflow family, the laminarize plane mean and force objects on a
# -- mesh

#: the open channels' mesh paths, by their unsharded path
OPEN_MESH_NAMES = {'open_sphere_3d': 'open_sphere_3d_zmesh1',
                   'open_cylinder_2d': 'open_cylinder_2d_ymesh1'}
#: the outflow comparisons on a mesh: each outflow type on its channel,
#: flowing along the sharded outer axis (3D z, 2D y) and across it (3D x;
#: 2D x, whose outlet is normal to the sharded x of ('y', 'x')): (dimension,
#: flow axis) -> (size, meshes), from a random state
OUTFLOW_MESH = {(3, 'z'): (dict(lat_nx=64, lat_ny=32, lat_nz=64),
                           ('2', '2x2')),
                (3, 'x'): (dict(lat_nx=64, lat_ny=32, lat_nz=32),
                           ('2', '2x2')),
                (2, 'y'): (dict(lat_nx=512, lat_ny=512), ('2', '2x2')),
                (2, 'x'): (dict(lat_nx=1024, lat_ny=256), ('1x2', '2x2'))}
OUTFLOW_MESH_STEPS = 50


def free_memory():
    """Collect the runners a phase dropped (a runner and its
    ``TimeProfile`` refer to each other, so only the collector frees them
    and the card memory their engines hold), then return the cached
    blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def mesh_from(text, dim):
    """The mesh of a ``--mesh`` string with all its shards on the card."""
    shape = tuple(int(c) for c in text.split('x'))
    return pmesh.make_mesh(shape, dim, [DEVICE] * int(np.prod(shape)))


def outflow_mesh_compare(kind, where, force_model):
    """The outflow channel of ``kind`` (``where``: dimension and flow axis)
    under ``force_model`` (Guo, or none) over the meshes of
    ``OUTFLOW_MESH``, the shards on the one card: ``OUTFLOW_MESH_STEPS``
    steps from a random state equal the unsharded kernel's bit for bit,
    with one ghost launch per shard and step (the outflow instantiation's
    key where the shard holds an outflow row), the laminarize pre-pass over
    the mesh once per step and one exchange per step."""
    dim, axis = where
    size, meshes = OUTFLOW_MESH[where]
    sim = outflow_channel(kind, dim, axis)
    flags = {}
    if force_model:
        sim = forced(sim, OUTFLOW_ACCEL[:dim])
        flags = dict(force_implementation=force_model)
    r = run(sim, platform=DEVICE, engine='kernel', max_iters=0, **size,
            **flags)
    shape = r._domain_shape()
    f0 = random_feq(r.sim.grid, shape, seed=11, device=DEVICE)
    ref = r.kernel.run(f0, OUTFLOW_MESH_STEPS).clone()
    steps = OUTFLOW_MESH_STEPS
    names = []
    for mesh in meshes:
        stp = halo.ShardedStep(r.builder, shape, mesh_from(mesh, dim),
                               'kernel')
        reset_all_counts()
        got = stp.gather(stp.run(f0, steps))
        counts = {k: v for k, v in kernel_counts().items() if v}
        n = stp.mesh.size
        ghost = {k: v for k, v in counts.items()
                 if k.startswith('lbm_step_ghost_')}
        assert sum(ghost.values()) == n * steps, counts
        assert counts.get(stp.lam_name, 0) == \
            (steps if kind == 'NTLaminarize' else 0), counts
        assert sum(counts.values()) == sum(ghost.values()) \
            + counts.get(stp.lam_name, 0), counts
        assert halo.LAUNCHES[stp.name] == steps \
            == sum(halo.LAUNCHES.values()), dict(halo.LAUNCHES)
        if kind != 'NTGradFreeflow':
            assert any(k.startswith('lbm_step_ghost_outflow_')
                       for k in ghost), ghost
        same, diff = same_bits(got, ref)
        assert same, (kind, where, mesh, diff)
        names.append(f'--mesh={mesh} ({", ".join(sorted(ghost))}'
                     + (f', {stp.lam_name}' if stp.lam is not None else '')
                     + ')')
        del stp, got
    say(f'compare outflow on a mesh: {kind} {r.sim.grid.name} '
        f'{tuple(reversed(shape))} flowing along {axis}, force '
        f'{force_model}: {steps} steps from a random state over '
        f'{"; ".join(names)} equal the unsharded '
        f'{r.kernel.name} run bit for bit')
    del r, f0, ref
    free_memory()


def state_gib(kernels):
    """GiB of the A and B buffers of ``kernels``."""
    return sum(ks.a.nbytes + ks.b.nbytes for ks in kernels) / 2 ** 30


def drag_ms(r, samples=5):
    """Host milliseconds of one ``update_force_objects`` sample, after a
    synchronization (median of ``samples``)."""
    out = []
    for _ in range(samples):
        r._synchronize()
        t0 = time.perf_counter()
        r.update_force_objects()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def open_mesh_main_path(path, dim, size, flat, turn_steps=100):
    """``open_channel`` at full width through the controller with
    ``--mesh=1`` and with ``--mesh=1x1`` on the kernel engine, as many
    steps and chunks as the unsharded path (``flat``: its final state and
    drag series), the counts zeroed just before and read just after each
    run: per step one ``lbm_step_ghost_outflow_<grid>`` launch and one
    exchange, nothing else (the drag's sums come at the chunk ends, as
    PyTorch reductions); both drag series and final states the unsharded
    run's bits. Then, on the final state: ``turn_steps``-step runs in turns
    of --mesh=1x1, --mesh=1 and the unsharded kernel (MLUPS, host clock;
    the same bits after each turn), ms per ghost launch against the
    unsharded launch in turns (CUDA events), the host ms of one drag
    sample on the mesh against the unsharded one, and 2x2 shards on the
    card: ``SHARD_STEPS`` steps with the unsharded bits, MLUPS in turns,
    the buffers' GiB. Returns (row name, row, {exchange: launches})."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    chunk, chunks = flat['chunk'], flat['chunks']
    steps = chunk * chunks
    g = 'd3q19' if dim == 3 else 'd2q9'
    name = f'lbm_step_ghost_outflow_{g}'
    runs, xall, lines = {}, {}, []
    for mesh in ('1', '1x1'):
        reset_all_counts()
        r = run(open_channel(dim), max_iters=steps, every=chunk, mesh=mesh,
                **cfg)
        counts = {k: v for k, v in kernel_counts().items() if v}
        xcounts = {k: v for k, v in halo.LAUNCHES.items() if v}
        stp = r.stepper
        assert r.engine == 'kernel' and r.kernel is stp, r.engine
        assert stp.kernels[0].name == name, stp.kernels[0].name
        assert counts == {name: steps}, counts
        assert xcounts == {stp.name: steps}, xcounts
        for k, v in xcounts.items():
            xall[k] = xall.get(k, 0) + v
        drag = [(it, tuple(F)) for it, F in r.sim.drag]
        assert drag == flat['drag'], (mesh, drag, flat['drag'])
        same, diff = same_bits(r.f, flat['final'])
        assert same, (mesh, diff)
        mlups = statistics.median(r.mlups_history[1:])
        lines.append(f'--mesh={mesh}: {steps} {name} + {steps} {stp.name} '
                     f'launches, nothing else; median {mlups:.1f} MLUPS; '
                     f'{len(drag)} drag samples and the final state equal '
                     f'the unsharded run\'s bit for bit')
        runs[mesh] = (r, mlups)
    say(f'main path {path} {"x".join(map(str, size))} (engine kernel): '
        + '; '.join(lines) + f'; last drag {flat["drag"][-1]}')
    r1, m1 = runs['1']
    r2, m2 = runs['1x1']
    stp, one = r2.stepper, r1.stepper
    del flat['final']
    free_memory()
    # its plain version for 5 steps from the final state
    f0 = r2.f.clone()
    wet = torch.as_tensor(wet_map(r2.maps), device=DEVICE)
    fk = stp.gather(stp.run(f0, 5, steps))
    s = stp.shard(f0)
    for i in range(5):
        s = stp.reference(s, steps + i)
    err = float((fk - stp.gather(s))[:, wet].abs().max())
    assert np.isfinite(err) and err <= TOL, err
    del s, fk
    free_memory()
    # in turns: --mesh=1x1, --mesh=1 and the unsharded kernel
    ks1 = ls.KernelStep(r2.builder)
    nodes = int(np.prod(size))
    variants = {'1x1': stp, '1': one, 'unsharded': ks1}
    state = dict.fromkeys(variants, f0)
    mlups_of = {k: [] for k in variants}
    for _ in range(2):
        for key, eng in variants.items():
            m, out = host_mlups(lambda: eng.run(state[key], turn_steps),
                                nodes, turn_steps)
            mlups_of[key].append(m)
            state[key] = (out if key == 'unsharded'
                          else eng.gather(out)).clone()
        for key in ('1x1', '1'):
            same, diff = same_bits(state[key], state['unsharded'])
            assert same, (key, diff)
    med = {k: statistics.median(v) for k, v in mlups_of.items()}
    kg, kg1 = stp.kernels[0], one.kernels[0]
    ms_g, ms_1, ms_u = [], [], []
    for _ in range(2):
        ms_g.append(util.cuda_time_ms(lambda: kg.step_into(kg.a, kg.b), 30,
                                      warmup=3))
        ms_1.append(util.cuda_time_ms(lambda: kg1.step_into(kg1.a, kg1.b),
                                      30, warmup=3))
        ms_u.append(util.cuda_time_ms(lambda: ks1.step_into(ks1.a, ks1.b),
                                      30, warmup=3))
    ms, ms1, ms_flat = (statistics.median(v) for v in (ms_g, ms_1, ms_u))
    plain_ms = util.cuda_time_ms(lambda: kg.reference(kg.a), 3)
    fo1, fo2 = drag_ms(r1), drag_ms(r2)
    bound, bound_by = bound_ms(name, nodes)
    say(f'{path}: {turn_steps}-step runs in turns from the final state, '
        f'MLUPS --mesh=1x1 {[round(v, 1) for v in mlups_of["1x1"]]}, '
        f'--mesh=1 {[round(v, 1) for v in mlups_of["1"]]}, unsharded '
        f'{[round(v, 1) for v in mlups_of["unsharded"]]}: 1x1 over '
        f'unsharded {med["1x1"] / med["unsharded"]:.4f}, 1 over unsharded '
        f'{med["1"] / med["unsharded"]:.4f}; the states equal bit for bit '
        f'after each turn; 5 steps against the plain version wet max|df| '
        f'{err:.3e} (tol {TOL:g}); {name} {ms:.4f} ms per launch on 1x1 '
        f'({tuple(kg.shape)}), {ms1:.4f} on 1 ({tuple(kg1.shape)}) against '
        f'{ms_flat:.4f} unsharded, in turns ({ms / ms_flat:.4f}, '
        f'{ms1 / ms_flat:.4f}); bound {bound:.4f} ms ({bound_by}): '
        f'{bound / ms:.3f} of the 1x1 launch; step_reference {plain_ms:.3f} '
        f'ms; one drag sample {fo2:.3f} ms on 1x1, {fo1:.3f} on 1 against '
        f'{flat["force_object_ms"]:.3f} unsharded (host, synchronized; '
        f'median of 5); A/B buffers {state_gib(stp.kernels):.3f} GiB on '
        f'1x1 against {state_gib([ks1]):.3f} unsharded')
    start = state['unsharded']
    del state, variants, runs, r1
    free_memory()
    # 2x2 shards on the card
    sn = halo.ShardedStep(r2.builder, r2._domain_shape(), mesh_from(
        '2x2', dim), 'kernel')
    mn, out = host_mlups(lambda: sn.run(start, SHARD_STEPS), nodes,
                         SHARD_STEPS)
    un, ref = host_mlups(lambda: ks1.run(start, SHARD_STEPS), nodes,
                         SHARD_STEPS)
    same, diff = same_bits(sn.gather(out), ref)
    gib = state_gib(sn.kernels)
    say(f'{path} over 2x2 shards on the one card '
        f'({tuple(sn.kernels[0].shape)} each): {SHARD_STEPS} steps equal to '
        f'the unsharded kernel\'s bit for bit: {same}; {mn:.1f} MLUPS '
        f'against {un:.1f} unsharded, in turns ({mn / un:.4f}); A/B buffers '
        f'{gib:.3f} GiB')
    assert same, diff
    row = dict(launches=2 * steps, mlups=m1, ms=ms, plain_ms=plain_ms,
               err=err, nodes=nodes, unsharded_ms=ms_flat,
               mesh_mlups=med['1'], unsharded_mlups=med['unsharded'],
               mesh_over_unsharded=med['1'] / med['unsharded'],
               two_axis={path.replace('mesh1', 'mesh1x1'): dict(
                   mlups=m2, mesh_1x1_mlups=med['1x1'],
                   over_unsharded=med['1x1'] / med['unsharded'],
                   ms=ms, one_axis_ms=ms1)},
               force_object_ms=fo1, drag=flat['drag'][-1][1][0],
               shards={'2x2': dict(mlups=mn, unsharded_mlups=un,
                                   gib=gib)})
    del r2, stp, one, ks1, sn, out, ref, start, f0, kg, kg1, wet
    free_memory()
    return name, row, xall


def laminarize_mesh_main_path(size=LAMINARIZE_MAIN, chunk=500, chunks=2,
                              turn_steps=100):
    """The 2D laminarize channel at full width through the controller with
    ``--mesh=1x1``: per step one ``laminarize_mean_ghost_d2q9`` pre-pass
    over the mesh, one ``lbm_step_ghost_outflow_d2q9`` launch and one edge
    exchange, nothing else. Then the mesh pre-pass on the final state
    against its plain version (``RHO_TOL``) and against the unsharded
    ``laminarize_mean_d2q9`` (bit for bit) on 1x1 and 2x2, its ms per
    launch (CUDA events) against its bound and the unsharded pre-pass's;
    ``turn_steps``-step runs in turns of 1x1 and the unsharded kernel with
    the same bits; 2x2 shards on the card, ``SHARD_STEPS`` steps, the
    unsharded bits. Returns ({JSON row: measurements}, {exchange:
    launches})."""
    cfg = dict(lat_nx=size[0], lat_ny=size[1])
    steps = chunk * chunks
    reset_all_counts()
    r = run(outflow_channel('NTLaminarize', 2, 'x'), max_iters=steps,
            every=chunk, mesh='1x1', **cfg)
    counts = {k: v for k, v in kernel_counts().items() if v}
    xcounts = {k: v for k, v in halo.LAUNCHES.items() if v}
    stp = r.stepper
    name = 'lbm_step_ghost_outflow_d2q9'
    assert r.engine == 'kernel' and stp.lam is not None
    assert counts == {name: steps, stp.lam_name: steps}, counts
    assert xcounts == {stp.name: steps}, xcounts
    r._fields_to_host()
    for arr in (r.sim.rho, r.sim.vx, r.sim.vy):
        assert np.all(np.isfinite(arr))
    mlups = statistics.median(r.mlups_history[1:])
    f0 = r.f.clone()
    ks1 = ls.KernelStep(r.builder)
    flat_mean = torch.empty_like(ks1.lam.mean)
    ks1.mean_into(f0, flat_mean)
    padded = torch.cat([flat_mean, flat_mean.new_zeros((1, 9))])
    rows, lines = {}, []
    for mesh in ('1x1', '2x2'):
        sx = stp if mesh == '1x1' else halo.ShardedStep(
            r.builder, r._domain_shape(), mesh_from(mesh, 2), 'kernel')
        parts = sx.shard(f0).parts
        sx.lam_prepass(parts)
        got = [None if ks.lam is None else ks.lam.mean.clone()
               for ks in sx.kernels]
        sx.lam.plain_into(parts, sx.kernels)
        err, same = 0.0, True
        for s_, (ks, m) in enumerate(zip(sx.kernels, got)):
            if ks.lam is None:
                continue
            err = max(err, float((m - ks.lam.mean).abs().max()))
            idx = sx.lam.shard_entries(s_, ks)
            inside = torch.as_tensor(idx >= 0, device=DEVICE)
            want = padded[torch.as_tensor(np.where(idx < 0, -1, idx),
                                          device=DEVICE)]
            same = same and torch.equal(m[inside], want[inside])
        assert err <= RHO_TOL, err
        assert same, mesh
        ms = util.cuda_time_ms(lambda: sx.lam_prepass(parts), 200,
                               warmup=10)
        lines.append(f'--mesh={mesh}: {sx.lam_name} {ms:.5f} ms per launch, '
                     f'max|d| against its plain version {err:.3e} (tol '
                     f'{RHO_TOL:g}), the unsharded means bit for bit')
        rows[mesh] = dict(ms=ms, err=err)
        if mesh == '2x2':
            mn, out = host_mlups(lambda: sx.run(f0, SHARD_STEPS),
                                 int(np.prod(size)), SHARD_STEPS)
            un, ref = host_mlups(lambda: ks1.run(f0, SHARD_STEPS),
                                 int(np.prod(size)), SHARD_STEPS)
            same2, diff = same_bits(sx.gather(out), ref)
            assert same2, diff
            lines.append(f'2x2 shards ({tuple(sx.kernels[0].shape)} each) '
                         f'{SHARD_STEPS} steps equal the unsharded kernel\'s '
                         f'bit for bit; {mn:.1f} against {un:.1f} MLUPS')
            rows[mesh].update(mlups=mn, unsharded_mlups=un)
            del sx, out, ref
        del parts, got
    flat_ms = util.cuda_time_ms(lambda: ks1.mean_into(ks1.a, flat_mean),
                                200, warmup=10)
    plain_ms = util.cuda_time_ms(
        lambda: stp.lam.plain_into(stp.shard(f0).parts, stp.kernels), 5)
    # in turns: 1x1 and the unsharded kernel
    nodes = int(np.prod(size))
    fm = fu = f0
    mesh_m, flat_m = [], []
    for _ in range(2):
        m, sm_ = host_mlups(lambda: stp.run(fm, turn_steps), nodes,
                            turn_steps)
        u, fu = host_mlups(lambda: ks1.run(fu, turn_steps), nodes,
                           turn_steps)
        fm = stp.gather(sm_)
        same, diff = same_bits(fm, fu)
        assert same, diff
        fu = fu.clone()
        mesh_m.append(m)
        flat_m.append(u)
    lam_nodes = int(ks1.lam.nodes.numel())
    entries = int(stp.lam.entries)
    extra = entries * 9 * 4 * 2 + (entries + 1) * 4 * 2 + 8 * entries
    bound, bound_by = bound_ms(stp.lam_name, lam_nodes, extra)
    say(f'main path laminarize_channel_2d_yxmesh1 {size[0]}x{size[1]} (D2Q9, '
        f'engine {r.engine}, --mesh=1x1): {steps} {stp.lam_name} + {steps} '
        f'{name} + {steps} {stp.name} launches, nothing else; median '
        f'{mlups:.1f} MLUPS; ' + '; '.join(lines) + f'; unsharded '
        f'laminarize_mean_d2q9 {flat_ms:.5f} ms; bound {bound:.6f} ms '
        f'({bound_by}) over {lam_nodes} nodes in {entries} plane(s): '
        f'{bound / rows["1x1"]["ms"]:.4f} of the 1x1 launch; plain version '
        f'{plain_ms:.3f} ms; {turn_steps}-step runs in turns 1x1 '
        f'{[round(v, 1) for v in mesh_m]} against unsharded '
        f'{[round(v, 1) for v in flat_m]} MLUPS, the same bits after each')
    out = {
        stp.lam_name: dict(launches=steps, ms=rows['1x1']['ms'],
                           plain_ms=plain_ms,
                           err=max(v['err'] for v in rows.values()),
                           nodes=lam_nodes, extra_bytes=extra,
                           unsharded_ms=flat_ms,
                           shards={'2x2': rows['2x2']}),
        name: dict(launches=steps, err=0.0)}
    del r, stp, ks1, f0, fm, fu
    free_memory()
    return out, xcounts


# -- sharded runs (--mesh): the ghost-plane mode and its exchange -----------

#: the one-axis mesh main paths at full size: path -> (scene, size)
MESH_MAIN = {
    'ldc_3d_zmesh1': (LDC_3D, (256, 256, 256)),
    'ldc_2d_ymesh1': (LDC_2D, (4096, 4096)),
}
#: shard counts held bit for bit on the one card at full size (3D), and
#: the steps of those runs
MESH_SHARDS = (2, 4)
SHARD_STEPS = 100
#: one scene per mode class over 2 shards at 64^3 / 1024^2, bit for bit
#: against the unsharded kernel run: name -> (sim class, flags)
MESH_BITWISE = {
    'ldc_3d_mrt': (LDC_3D, dict(lat_nx=64, lat_ny=64, lat_nz=64,
                                model='mrt', visc=0.05)),
    'sphere_3d_les_guo': (twin('sphere_3d'),
                          dict(lat_nx=64, lat_ny=64, lat_nz=64, visc=0.05,
                               subgrid='les-smagorinsky')),
    'ldc_2d_entropic': (twin('ldc_2d_entropic'),
                        dict(lat_nx=1024, lat_ny=1024)),
    'ldc_3d_int16': (LDC_3D, dict(lat_nx=64, lat_ny=64, lat_nz=64,
                                  precision='mixed')),
    'duct_flow': (twin('duct_flow'), dict(lat_nx=64, lat_ny=64,
                                          lat_nz=64)),
    'womersley': (twin('womersley'), dict(lat_nx=64, lat_ny=64,
                                          lat_nz=64)),
    'poiseuille_sa': (twin('poiseuille_sa'),
                      dict(lat_nx=1024, lat_ny=1024,
                           velocity='spatial_array')),
    'kida_vortex': (turbulence_twin('kida_vortex'),
                    dict(lat_nx=64, lat_ny=64, lat_nz=64, stats_every=20)),
    'inlet_x_across_shards': (
        channel_sim('regularized', 'x', profile='parabolic'),
        dict(lat_nx=64, lat_ny=64, lat_nz=64, periodic_z=True)),
}


def mesh_of(n, dim):
    """A one-axis mesh of ``n`` shards, all on the one card."""
    return pmesh.make_mesh((n,), dim, [DEVICE] * n)


def mesh_size(mesh):
    """The shards of a ``--mesh`` string ('2', '2x2', ...)."""
    return int(np.prod([int(c) for c in mesh.split('x')]))


def mesh_bitwise(name, sim_cls, cfg, steps=100, mesh='2'):
    """The scene through the controller over the shards of ``mesh`` on
    the one card against the unsharded kernel run: the same bits, one
    ghost-plane launch per shard and step, one exchange per step (the
    edge mode on two axes)."""
    n = mesh_size(mesh)
    ref = run(sim_cls, max_iters=steps, every=steps // 2, **cfg)
    ls.reset_launch_counts()
    halo.reset_launch_counts()
    with pmesh.devices_override([DEVICE] * n):
        r = run(sim_cls, max_iters=steps, every=steps // 2, mesh=mesh, **cfg)
    assert r.engine == 'kernel' and r.kernel is r.stepper, r.engine
    # each shard's launches under its own mode's ghost key
    names = sorted({ks.name for ks in r.stepper.kernels})
    assert all(n.startswith('lbm_step_ghost_') for n in names), names
    assert sum(ls.LAUNCHES[k] for k in names) == n * steps \
        == sum(ls.LAUNCHES.values()), dict(ls.LAUNCHES)
    assert halo.LAUNCHES[r.stepper.name] == steps \
        == sum(halo.LAUNCHES.values()), dict(halo.LAUNCHES)
    assert st.is_finite(ref.f), name
    same = torch.equal(r.f, ref.f)
    diff = float((r.f - ref.f).abs().max())
    say(f'mesh {name}: {r.sim.grid.name} {tuple(ref.f.shape[1:])}, '
        f'{steps} steps over --mesh={mesh} on the card ({", ".join(names)}, '
        f'{r.stepper.name}; {ref.kernel.name} unsharded): the same bits '
        f'{same} (max |df| {diff:.3e})')
    assert same, (name, diff)
    del r, ref
    torch.cuda.empty_cache()


def ghost_mode_check(scene, sim_cls, size, steps=200):
    """The ghost-plane mode over 2 shards against its plain version (the
    torch engine's sharded step on the same padded slabs), ``steps`` steps
    from a random state: wet max |df| <= TOL; and the exchange kernel
    against its plain version on random buffers: the same bits. Returns
    (ghost error, exchange error)."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    with pmesh.devices_override([DEVICE] * 2):
        r = run(sim_cls, max_iters=0, mesh='2', **cfg)
    stp = r.stepper
    plain = halo.ShardedStep(r.builder, r._domain_shape(), r.mesh, 'torch')
    g = torch.Generator(device=DEVICE).manual_seed(5)
    parts = [torch.rand(ks.a.shape, generator=g, device=DEVICE)
             for ks in stp.kernels]
    ref = [p.clone() for p in parts]
    stp.exchange(parts)
    stp.exchange_reference(ref)
    x_err = max(float((a - b).abs().max()) for a, b in zip(parts, ref))
    f0 = random_feq(r.sim.grid, r._domain_shape(), seed=3, device=DEVICE)
    fk = stp.gather(stp.run(f0, steps))
    fr = plain.gather(plain.run(f0, steps))
    wet = torch.cat([wet_mask(ks)[1:-1] for ks in stp.kernels], 0)
    err = float((fk - fr)[:, wet].abs().max())
    say(f'compare ghost-plane mode {scene} {"x".join(map(str, size))}: 2 '
        f'shards, {steps} steps from a random state, kernel against the '
        f'torch engine\'s sharded step, wet max|df| = {err:.3e} (tol '
        f'{TOL:g}); {stp.name} against its plain version on random '
        f'buffers: max |d| = {x_err:g}')
    assert np.isfinite(err) and err <= TOL, err
    assert x_err == 0.0, x_err
    del r, stp, plain, parts, ref, f0, fk, fr
    torch.cuda.empty_cache()
    return err, x_err


def exchange_kernel_ms(stp, parts, iters=2000):
    """Device milliseconds per ``halo_exchange`` launch on ``parts``, the
    C entry called back to back with its parameter block built once (CUDA
    events around ``iters`` launches, as ``empty_launch_ms`` times the
    empty kernel): the exchange's time in a stream of launches, without
    the host's Python per ``ShardedStep.exchange`` call."""
    stp.exchange(parts)
    (_device, params, _peers), = stp._plan_for(parts)
    params = ctypes.byref(params)
    stream = torch.cuda.current_stream().cuda_stream
    fn = stp._fn

    def launch():
        rc = fn(params, stream)
        if rc != 0:
            raise RuntimeError(f'{stp.name} launch failed: error {rc}')

    return util.cuda_time_ms(launch, iters, warmup=10)


def host_mlups(fn, nodes, steps):
    """MLUPS of ``fn()`` (``steps`` steps on ``nodes`` nodes) between
    device synchronizations, host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return nodes * steps / (time.perf_counter() - t0) / 1e6, out


def mesh_main_path(path, sim_cls, size, copy_bw, chunk=250, chunks=4,
                   turn_steps=100):
    """The scene through the controller with ``--mesh=1`` on the kernel
    engine: the main path of the ghost-plane mode (one ``lbm_step_ghost``
    launch and one ``halo_exchange`` launch per step, counts zeroed just
    before and read just after). Then, on the main path's own state: its
    plain version for 10 steps; in turns against the unsharded kernel on
    the same builder (MLUPS over ``turn_steps``, and the two states equal
    bit for bit); ms per launch of the ghost-mode step and of the
    unsharded one in turns; the exchange's ms per step; and in 3D the
    state over ``MESH_SHARDS`` shards on the one card, ``SHARD_STEPS``
    steps, the same
    bits as the unsharded kernel. Returns (step row, exchange row)."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    steps = chunk * chunks
    ls.reset_launch_counts()
    halo.reset_launch_counts()
    r = run(sim_cls, max_iters=steps, every=chunk, mesh='1', **cfg)
    counts, xcounts = dict(ls.LAUNCHES), dict(halo.LAUNCHES)
    stp = r.stepper
    grid = r.sim.grid.name
    g = grid.lower()
    name, xname = f'lbm_step_ghost_{g}', f'halo_exchange_{g}'
    assert r.engine == 'kernel' and r.kernel is stp and stp.mesh.size == 1
    assert stp.kernels[0].name == name, stp.kernels[0].name
    assert counts[name] == steps == r.sim.iteration \
        == sum(counts.values()), counts
    assert xcounts[xname] == steps == sum(xcounts.values()), xcounts
    r._fields_to_host()
    shape = tuple(reversed(size))
    for field in ('rho', 'vx'):
        arr = getattr(r.sim, field)
        assert arr.shape == shape and np.all(np.isfinite(arr)), field
    wet = wet_map(r.maps)
    mean_rho = float(np.mean(r.sim.rho[wet], dtype=np.float64))
    assert np.abs(r.sim.vx[wet]).max() <= 1.01 * sim_cls.subdomain.max_v
    assert abs(mean_rho - 1.0) < 0.01
    mlups = statistics.median(r.mlups_history[1:])
    nodes = int(np.prod(size))
    eff = mlups * 1e6 * BYTES[grid]
    say(f'main path {path} {"x".join(map(str, size))} ({grid}, engine '
        f'{r.engine}, --mesh=1): {steps} {name} and {steps} {xname} '
        f'launches; MLUPS per {chunk}-step chunk '
        f'{[round(m, 1) for m in r.mlups_history]}; median {mlups:.1f} '
        f'MLUPS; {eff / 1e9:.1f} GB/s effective ({BYTES[grid]} B/node), '
        f'{eff / copy_bw:.3f} of the copy bandwidth; mean wet rho '
        f'{mean_rho:.8f}')
    # its plain version on the main path's own state (10 steps)
    f0 = r.f.clone()
    wet_t = torch.as_tensor(wet, device=DEVICE)
    fk = stp.gather(stp.run(f0, 10, steps))
    s = stp.shard(f0)
    for i in range(10):
        s = stp.reference(s, steps + i)
    err = float((fk - stp.gather(s))[:, wet_t].abs().max())
    say(f'compare main path {path}: 10 steps from the state after {steps}, '
        f'wet max|df| = {err:.3e} (tol {TOL:g})')
    assert np.isfinite(err) and err <= TOL, err
    del s, fk
    # in turns against the unsharded kernel on the same builder
    ks1 = ls.KernelStep(r.builder)
    mesh_m, flat_m = [], []
    fm = fu = f0
    for _ in range(2):
        m, sm_ = host_mlups(lambda: stp.run(fm, turn_steps), nodes,
                            turn_steps)
        u, fu = host_mlups(lambda: ks1.run(fu, turn_steps), nodes,
                           turn_steps)
        fm = stp.gather(sm_)
        same = torch.equal(fm, fu)
        assert same, float((fm - fu).abs().max())
        fu = fu.clone()
        mesh_m.append(m)
        flat_m.append(u)
    m_med, u_med = statistics.median(mesh_m), statistics.median(flat_m)
    say(f'{path}: {turn_steps}-step runs in turns from the same state, '
        f'--mesh=1 {[round(v, 1) for v in mesh_m]} against unsharded '
        f'{[round(v, 1) for v in flat_m]} MLUPS: {m_med / u_med:.4f} of it; '
        f'the two states equal bit for bit after each turn')
    kg = stp.kernels[0]
    ga, gb, ua, ub = kg.a, kg.b, ks1.a, ks1.b
    ms_g, ms_u = [], []
    for _ in range(2):
        ms_g.append(util.cuda_time_ms(lambda: kg.step_into(ga, gb), 50,
                                      warmup=5))
        ms_u.append(util.cuda_time_ms(lambda: ks1.step_into(ua, ub), 50,
                                      warmup=5))
    ms, ms_flat = statistics.median(ms_g), statistics.median(ms_u)
    parts = [ks.a for ks in stp.kernels]
    x_call_ms = util.cuda_time_ms(lambda: stp.exchange(parts), 200,
                                  warmup=5)
    x_ms = exchange_kernel_ms(stp, parts)
    x_plain = util.cuda_time_ms(lambda: stp.exchange_reference(parts), 20,
                                warmup=2)
    plain_ms = util.cuda_time_ms(lambda: kg.reference(ga), 5)
    plane = int(np.prod(size[:-1]))
    say(f'kernel {name} at {"x".join(map(str, size))} (one shard of '
        f'{tuple(kg.shape)} with its two ghost planes): {ms:.4f} ms per '
        f'launch against {ms_flat:.4f} unsharded, in turns '
        f'({ms / ms_flat:.4f}); step_reference {plain_ms:.3f} ms; '
        f'{xname} {x_ms:.5f} ms per launch from C ({plane} nodes per '
        f'plane, {len(stp.lo)} + {len(stp.hi)} directions), '
        f'{x_call_ms:.5f} ms per call of ShardedStep.exchange alone (the '
        f'host\'s Python per call, hidden behind a step in a run), plain '
        f'version {x_plain:.4f} ms')
    row = dict(launches=steps, mlups=mlups, ms=ms, plain_ms=plain_ms,
               err=err, unsharded_ms=ms_flat, mesh_mlups=m_med,
               unsharded_mlups=u_med, mesh_over_unsharded=m_med / u_med,
               exchange_ms=x_ms, exchange_call_ms=x_call_ms)
    if len(size) == 3:
        shards = {}
        start = fu
        ref = ks1.run(start, SHARD_STEPS).clone()
        for n in MESH_SHARDS:
            sn = halo.ShardedStep(r.builder, r._domain_shape(),
                                  mesh_of(n, 3), 'kernel')
            mn, out = host_mlups(lambda: sn.run(start, SHARD_STEPS), nodes,
                                 SHARD_STEPS)
            un, _ = host_mlups(lambda: ks1.run(start, SHARD_STEPS), nodes,
                               SHARD_STEPS)
            got = sn.gather(out)
            same = torch.equal(got, ref)
            pn = [ks.a for ks in sn.kernels]
            sn.exchange(pn)
            xn = exchange_kernel_ms(sn, pn)
            say(f'{path} over {n} shards on the one card '
                f'({tuple(sn.kernels[0].shape)} each): {SHARD_STEPS} '
                f'steps equal to '
                f'the unsharded kernel\'s bit for bit: {same}; {mn:.1f} '
                f'MLUPS against {un:.1f} '
                f'unsharded, in turns ({mn / un:.4f}); exchange {xn:.5f} ms '
                f'per step')
            assert same, float((got - ref).abs().max())
            shards[n] = dict(mlups=mn, unsharded_mlups=un, exchange_ms=xn)
            del sn, out, got, pn
            torch.cuda.empty_cache()
        row['shards'] = shards
    xrow = dict(launches=steps, ms=x_ms, plain_ms=x_plain, err=0.0,
                nodes=plane)
    del r, stp, ks1, f0, fm, fu, parts, ga, gb, ua, ub, kg, wet_t
    torch.cuda.empty_cache()
    return row, xrow


#: the zoo's d3q19_tms_channel_h63_zmesh1 (benchmark/model_zoo.py:136)
#: without its mesh, and the (z, y, x) shape it gives
CHANNEL_MESH = dict(H=63, wall='tms', streamwise=384)
CHANNEL_MESH_SHAPE = (126, 128, 384)


def channel_flow_mesh_path(copy_bw, chunk=500, chunks=2, cfg=CHANNEL_MESH,
                           shape=CHANNEL_MESH_SHAPE):
    """``channel_flow`` at the zoo's ``d3q19_tms_channel_h63_zmesh1``
    (H = 63, TMS walls, streamwise 384: 384 x 128 x 126, D3Q19, Guo) with
    the Reynolds statistics hook every ``STATS_EVERY`` steps, through the
    controller with ``--mesh=1`` (counts zeroed just before, read just
    after: one ghost-plane launch of the wall kind and one exchange per
    step) and without: the same state bit for bit, the statistics within
    rtol 1e-5, MLUPS of both; then 10 steps from the final state against
    the plain version, and ms per launch of the ghost-plane step and of
    its plain version. Returns the ``lbm_step_ghost_wall_d3q19`` row."""
    steps = chunk * chunks
    ref = run(channel_flow_stats(), max_iters=steps, every=chunk, **cfg)
    ls.reset_launch_counts()
    halo.reset_launch_counts()
    r = run(channel_flow_stats(), max_iters=steps, every=chunk, mesh='1',
            **cfg)
    counts, xcounts = dict(ls.LAUNCHES), dict(halo.LAUNCHES)
    stp = r.stepper
    name = 'lbm_step_ghost_wall_d3q19'
    assert r.engine == 'kernel' and r.kernel is stp
    assert stp.kernels[0].name == name, stp.kernels[0].name
    assert counts[name] == steps == sum(counts.values()), counts
    assert xcounts['halo_exchange_d3q19'] == steps, xcounts
    assert tuple(r.f.shape[1:]) == shape, tuple(r.f.shape)
    cnt, _acc = r.device_hook_state[0]
    assert int(cnt) == steps // STATS_EVERY, int(cnt)
    mine, theirs = r.sim.reynolds_stats(), ref.sim.reynolds_stats()
    for key in theirs:
        np.testing.assert_allclose(mine[key], theirs[key], rtol=1e-5,
                                   atol=0, err_msg=key)
    same = torch.equal(r.f, ref.f)
    assert same
    m = statistics.median(r.mlups_history[1:])
    u = statistics.median(ref.mlups_history[1:])
    u_mean = mine['u'][0]
    say(f'main path channel_flow_zmesh1 '
        f'{"x".join(map(str, reversed(shape)))} (D3Q19, engine kernel, '
        f'--mesh=1, TMS walls, Guo, Reynolds hook every {STATS_EVERY}): '
        f'{steps} {name} and halo_exchange_d3q19 launches; '
        f'MLUPS per {chunk}-step chunk '
        f'{[round(v, 1) for v in r.mlups_history]}; median {m:.1f} against '
        f'{u:.1f} unsharded ({m / u:.4f}); {int(cnt)} Reynolds samples equal '
        f'to the unsharded run\'s (rtol 1e-5), mean u at the centre '
        f'{u_mean[len(u_mean) // 2]:.5f}; the final state the same bits: '
        f'{same}')
    wet = torch.as_tensor(wet_map(r.maps), device=DEVICE)
    f0 = r.f.clone()
    fk = stp.gather(stp.run(f0, 10, steps))
    fr = stp.shard(f0)
    for i in range(10):
        fr = stp.reference(fr, steps + i)
    err = float((fk - stp.gather(fr))[:, wet].abs().max())
    assert np.isfinite(err) and err <= TOL, err
    kg = stp.kernels[0]
    ga, gb = kg.a, kg.b
    ms = util.cuda_time_ms(lambda: kg.step_into(ga, gb), 50, warmup=5)
    plain_ms = util.cuda_time_ms(lambda: kg.reference(ga), 5)
    say(f'compare main path channel_flow_zmesh1: 10 steps from the state '
        f'after {steps}, wet max|df| = {err:.3e} (tol {TOL:g}); kernel '
        f'{name}: {ms:.4f} ms per launch (one shard of {tuple(kg.shape)} '
        f'with its two ghost planes), step_reference {plain_ms:.3f} ms')
    del r, ref, stp, kg, ga, gb, f0, fk, fr, wet
    torch.cuda.empty_cache()
    return dict(launches=steps, mlups=m, unsharded_mlups=u, ms=ms,
                plain_ms=plain_ms, err=err, nodes=int(np.prod(shape)),
                mesh_over_unsharded=m / u)


#: the Shan-Chen and free-energy main paths on a one-axis mesh, through
#: the controller with --mesh=1 on the kernel engine: path -> (sim class,
#: size); the 3D ones also over 2 and 4 shards on the one card
MESH_MULTI_MAIN = {
    'sc_separation_3d_zmesh1': (SEP_3D, (256, 256, 256)),
    'fe_separation_3d_zmesh1': (FE['fe_separation_3d'], (256, 256, 256)),
    'sc_phase_separation_3d_zmesh1': (SC_3D, (256, 256, 256)),
    'sc_separation_2d_ymesh1': (SEP_2D, (4096, 4096)),
    'fe_separation_2d_ymesh1': (FE['fe_separation_2d'], (4096, 4096)),
    'sc_phase_separation_ymesh1': (SC_2D, (4096, 4096)),
}
#: the ghost-mode kernels and both exchanges against their plain versions
#: over 2 shards on the card, 20 steps, and the sharded run's bits against
#: the unsharded kernel's: K = 3 with forces and walls, walls across the
#: shard boundary, Guo forcing in 2D, FE-MRT, wetting in 3D (z cut from
#: 37 to 36 to split evenly) and 2D, single-component Shan-Chen
MESH_MULTI_CASES = {
    'ternary_3d_walls_forced': (
        forced_mixture(ternary_separation(3, walls=True)),
        dict(lat_nx=128, lat_ny=128, lat_nz=128)),
    'sc_separation_3d_walls': (SEP_3D_WALLS,
                               dict(lat_nx=128, lat_ny=128, lat_nz=128)),
    'sc_rayleigh_taylor_2d': (RT_2D, dict(lat_nx=1024, lat_ny=1024)),
    'fe_separation_3d_mrt': (FE['fe_separation_3d'],
                             dict(lat_nx=128, lat_ny=128, lat_nz=128,
                                  model='mrt', tau_a=3.0, tau_b=0.8)),
    'fe_viscous_fingering': (FE['fe_viscous_fingering'],
                             dict(lat_nx=320, lat_ny=101, lat_nz=36)),
    'fe_poiseuille_2d_wetting': (FE['fe_poiseuille_2d'],
                                 dict(lat_nx=1024, lat_ny=512,
                                      bc_wall_grad_phase=0.05)),
    'sc_phase_separation_3d': (SC_3D,
                               dict(lat_nx=128, lat_ny=128, lat_nz=128)),
    'sc_phase_separation': (SC_2D, dict(lat_nx=1024, lat_ny=1024)),
}


def leaves(f):
    """The components of a state: (f,) of a single fluid's tensor."""
    return (f,) if torch.is_tensor(f) else tuple(f)


def same_bits(a, b):
    """(whether the states ``a`` and ``b`` are equal bit for bit, their
    largest difference)."""
    pairs = list(zip(leaves(a), leaves(b)))
    return (all(torch.equal(x, y) for x, y in pairs),
            max(float((x - y).abs().max()) for x, y in pairs))


def reset_all_counts():
    """Zero the launch counts of every kernel engine and of the
    exchanges."""
    for counts in (ls.LAUNCHES, sm.LAUNCHES, fe.LAUNCHES, halo.LAUNCHES):
        for k in counts:
            counts[k] = 0


def kernel_counts():
    """The launch counts of every kernel engine, one dict."""
    return {**ls.LAUNCHES, **sm.LAUNCHES, **fe.LAUNCHES}


def density_of(stp, ks):
    """A shard kernel's density buffer: phi of the free-energy model, the
    (K, ...) densities of a mixture, a single fluid's rho."""
    return ks.phi if getattr(stp, 'fe', False) else ks.rho


def shard_prepass(stp, ks, src):
    """The shard kernel's pre-pass from its buffer ``src``."""
    if getattr(stp, 'fe', False):
        ks.phi_into(src, ks.phi)
    else:
        ks.density_into(src, ks.rho)


def shard_step(stp, ks, src, dst):
    """The shard kernel's step from ``src`` into ``dst`` after its
    pre-pass."""
    if hasattr(stp, 'K'):
        ks.collide_into(src, density_of(stp, ks), dst)
    else:
        ks.collide_into(src, dst)


def shard_prepass_plain(stp, src):
    """The plain pre-pass of a shard buffer ``src``."""
    if getattr(stp, 'fe', False):
        return sm.rho_reference(src[1], stp.grid)
    if hasattr(stp, 'K'):
        return torch.stack([sm.rho_reference(f, stp.grid) for f in src])
    return sm.rho_reference(src, stp.grid)


def shard_step_plain(stp, ks, src):
    """The plain step of a shard buffer ``src`` from its kernel's density
    buffer."""
    rho = density_of(stp, ks)
    if getattr(stp, 'fe', False):
        return fe.fe_step_reference(src.unbind(0), rho, ks.mask, ks.orient,
                                    ks.builder)
    if hasattr(stp, 'K'):
        return ks.reference(src.unbind(0), rho.unbind(0))
    return ks.reference(src, rho)


def exchanges_check(stp):
    """Both exchange kernels of ``stp`` on random buffers of its shards'
    shapes against their plain versions: (max |d| of the distributions'
    exchange, of the density exchange)."""
    g = torch.Generator(device=DEVICE).manual_seed(5)
    bufs = [torch.rand(ks.a.shape, generator=g, device=DEVICE)
            for ks in stp.kernels]
    ref = [b.clone() for b in bufs]
    if hasattr(stp, 'K'):
        stp.exchange_buffers(bufs)
        stp.exchange_reference([r.unbind(0) for r in ref])
    else:
        stp.exchange(bufs)
        stp.exchange_reference(ref)
    rhos = [torch.rand(density_of(stp, ks).shape, generator=g,
                       device=DEVICE) for ks in stp.kernels]
    rref = [r.clone() for r in rhos]
    stp.density_exchange(rhos)
    stp.density_exchange_reference(rref)
    return (max(float((a - b).abs().max()) for a, b in zip(bufs, ref)),
            max(float((a - b).abs().max()) for a, b in zip(rhos, rref)))


def mesh_multi_compare(name, sim_cls, cfg, steps=20, mesh='2'):
    """The scene over the shards of ``mesh`` on the card: both exchange
    kernels against their plain versions (the same bits), the ghost-mode
    pre-pass against its plain version on the scene's start (<=
    ``RHO_TOL``), ``steps`` steps of the sharded kernel run against the
    plain version of the sharded step (wet max |df| <= ``TOL``) and
    against the unsharded kernel run (the same bits). Returns {kernel
    name: error}."""
    with pmesh.devices_override([DEVICE] * mesh_size(mesh)):
        r = run(sim_cls, max_iters=0, mesh=mesh, seed=1, **cfg)
    stp = r.stepper
    x_err, xr_err = exchanges_check(stp)
    f0 = tuple(f.clone() for f in leaves(r.f))
    f0 = f0[0] if torch.is_tensor(r.f) else f0
    s0 = stp.run(f0, 0)
    rho_err = 0.0
    for ks, part in zip(stp.kernels, s0.parts):
        src = part if torch.is_tensor(part) else ks._buffer_of(part)
        shard_prepass(stp, ks, src)
        d = density_of(stp, ks) - shard_prepass_plain(stp, src)
        d = stp.interior(d, d.dim() - len(ks.shape))
        rho_err = max(rho_err, float(d.abs().max()))
    fk = stp.gather(stp.run(f0, steps))
    sr = stp.shard(f0)
    for i in range(steps):
        sr = stp.reference(sr, i)
    fr = stp.gather(sr)
    wet = torch.as_tensor(wet_map(r.maps), device=DEVICE)
    err = max(float((a - b)[:, wet].abs().max())
              for a, b in zip(leaves(fk), leaves(fr)))
    flat = r._kernel_engine(r.builder)
    fu = flat.run(f0, steps)
    same, diff = same_bits(fk, fu)
    ks = stp.kernels[0]
    say(f'compare mesh {name}: {r.sim.grid.name} {tuple(r._domain_shape())}'
        f' over --mesh={mesh} (ghost {stp.ghost}; {ks.rho_name}, {ks.name}): '
        f'{stp.name} and {stp.rho_name} against their plain versions on '
        f'random buffers max |d| {x_err:g} / {xr_err:g}; pre-pass '
        f'max|drho| = {rho_err:.3e} (tol {RHO_TOL:g}); {steps} steps against '
        f'the plain version wet max|df| = {err:.3e} (tol {TOL:g}); the '
        f'unsharded kernel\'s bits: {same} (max |df| {diff:.3e})')
    assert x_err == 0.0 and xr_err == 0.0, (x_err, xr_err)
    assert rho_err <= RHO_TOL, rho_err
    assert np.isfinite(err) and err <= TOL, err
    assert same, diff
    out = {ks.name: err, ks.rho_name: rho_err, stp.name: x_err,
           stp.rho_name: xr_err}
    del r, stp, s0, fk, sr, fr, fu, flat, ks, f0
    torch.cuda.empty_cache()
    return out


def plan_ms(stp, plan, iters=2000):
    """Device milliseconds per launch of the exchange kernel with the one
    parameter block of ``plan`` (shards on one card), called back to back
    from C (CUDA events), as ``exchange_kernel_ms`` times it."""
    (_device, params, _peers), = plan
    params = ctypes.byref(params)
    stream = torch.cuda.current_stream().cuda_stream
    fn = stp._fn

    def launch():
        rc = fn(params, stream)
        if rc != 0:
            raise RuntimeError(f'{stp.name} launch failed: error {rc}')

    return util.cuda_time_ms(launch, iters, warmup=10)


def mesh_multi_main_path(path, sim_cls, size, copy_bw, chunk=250, chunks=2,
                         turn_steps=100):
    """A Shan-Chen or free-energy scene through the controller with
    ``--mesh=1`` on the kernel engine: per step one ghost-mode pre-pass,
    one ``halo_rho_exchange``, one ghost-mode step and one
    ``halo_exchange`` launch, nothing else (counts zeroed just before and
    read just after). Then, on the main path's own state: 10 steps against
    the plain version of the sharded step; in turns against the unsharded
    kernel on the same builder (MLUPS over ``turn_steps``, the same bits
    after each turn); ms per launch of the ghost-mode pre-pass and step
    against the unsharded ones in turns, of both exchanges from C, and
    their plain versions; in 3D the state over ``MESH_SHARDS`` shards on
    the one card, ``SHARD_STEPS`` steps, the unsharded kernel's bits.
    Returns {JSON
    row: measurements}."""
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size))
    steps = chunk * chunks
    reset_all_counts()
    r = run(sim_cls, max_iters=steps, every=chunk, mesh='1', seed=1, **cfg)
    counts, xcounts = kernel_counts(), dict(halo.LAUNCHES)
    stp = r.stepper
    grid = r.sim.grid.name
    g = grid.lower()
    ks = stp.kernels[0]
    assert r.engine == 'kernel' and r.kernel is stp and stp.mesh.size == 1
    assert 'ghost_' in ks.name and 'ghost_' in ks.rho_name, ks.name
    assert counts[ks.name] == counts[ks.rho_name] == steps \
        == r.sim.iteration, counts
    assert sum(counts.values()) == 2 * steps, counts
    assert xcounts[stp.name] == xcounts[stp.rho_name] == steps \
        == sum(xcounts.values()) // 2, xcounts
    assert stp.is_finite(r.state)
    r._fields_to_host()
    shape = tuple(reversed(size))
    for field in ('rho', 'vx') + (('phi',) if hasattr(stp, 'K') else ()):
        arr = getattr(r.sim, field)
        assert arr.shape == shape and np.all(np.isfinite(arr)), field
    mlups = statistics.median(r.mlups_history[1:])
    say(f'main path {path} {"x".join(map(str, size))} ({grid}, engine '
        f'{r.engine}, --mesh=1, ghost {stp.ghost}): {steps} {ks.rho_name} + '
        f'{steps} {stp.rho_name} + {steps} {ks.name} + {steps} {stp.name} '
        f'launches; MLUPS per {chunk}-step chunk '
        f'{[round(m, 1) for m in r.mlups_history]}; median {mlups:.1f}')
    f0 = tuple(f.clone() for f in leaves(r.f))
    f0 = f0[0] if torch.is_tensor(r.f) else f0
    wet = torch.as_tensor(wet_map(r.maps), device=DEVICE)
    fk = stp.gather(stp.run(f0, 10, steps))
    s = stp.shard(f0)
    for i in range(10):
        s = stp.reference(s, steps + i)
    err = max(float((a - b)[:, wet].abs().max())
              for a, b in zip(leaves(fk), leaves(stp.gather(s))))
    say(f'compare main path {path}: 10 steps from the state after {steps}, '
        f'wet max|df| = {err:.3e} (tol {TOL:g})')
    assert np.isfinite(err) and err <= TOL, err
    del s, fk
    flat = r._kernel_engine(r.builder)
    nodes = int(np.prod(size))
    mesh_m, flat_m = [], []
    fm = fu = f0
    for _ in range(2):
        m, sm_ = host_mlups(lambda: stp.run(fm, turn_steps), nodes,
                            turn_steps)
        u, fu = host_mlups(lambda: flat.run(fu, turn_steps), nodes,
                           turn_steps)
        fm = stp.gather(sm_)
        same, diff = same_bits(fm, fu)
        assert same, diff
        fu = tuple(f.clone() for f in leaves(fu))
        fu = fu[0] if torch.is_tensor(r.f) else fu
        mesh_m.append(m)
        flat_m.append(u)
    m_med, u_med = statistics.median(mesh_m), statistics.median(flat_m)
    say(f'{path}: {turn_steps}-step runs in turns from the same state, '
        f'--mesh=1 {[round(v, 1) for v in mesh_m]} against unsharded '
        f'{[round(v, 1) for v in flat_m]} MLUPS: {m_med / u_med:.4f} of it; '
        f'the two states equal bit for bit after each turn')
    ga, gb = ks.a, ks.b
    ua, ub = flat.a, flat.b
    times = {k: [] for k in ('pre', 'step', 'upre', 'ustep')}
    for _ in range(2):
        times['pre'].append(util.cuda_time_ms(
            lambda: shard_prepass(stp, ks, ga), 50, warmup=5))
        times['step'].append(util.cuda_time_ms(
            lambda: shard_step(stp, ks, ga, gb), 50, warmup=5))
        times['upre'].append(util.cuda_time_ms(
            lambda: shard_prepass(stp, flat, ua), 50, warmup=5))
        times['ustep'].append(util.cuda_time_ms(
            lambda: shard_step(stp, flat, ua, ub), 50, warmup=5))
    pre_ms, ms, upre_ms, u_ms = (statistics.median(times[k]) for k in
                                 ('pre', 'step', 'upre', 'ustep'))
    plain_pre = util.cuda_time_ms(lambda: shard_prepass_plain(stp, ga), 5)
    plain_ms = util.cuda_time_ms(lambda: shard_step_plain(stp, ks, ga), 3)
    bufs = [ks.a]
    if hasattr(stp, 'K'):
        stp.exchange_buffers(bufs)
        x_plain = util.cuda_time_ms(
            lambda: stp.exchange_reference([b.unbind(0) for b in bufs]), 20,
            warmup=2)
    else:
        stp.exchange(bufs)
        x_plain = util.cuda_time_ms(lambda: stp.exchange_reference(bufs),
                                    20, warmup=2)
    rhos = [density_of(stp, ks)]
    stp.density_exchange(rhos)
    x_ms = plan_ms(stp, stp._plans['f'][1])
    xr_ms = plan_ms(stp, stp._plans['rho'][1])
    xr_plain = util.cuda_time_ms(
        lambda: stp.density_exchange_reference(rhos), 20, warmup=2)
    plane = int(np.prod(size[1:]))
    say(f'kernel {ks.rho_name} at {"x".join(map(str, size))} (one shard of '
        f'{tuple(ks.shape)}): {pre_ms:.4f} ms per launch against '
        f'{upre_ms:.4f} unsharded, in turns ({pre_ms / upre_ms:.4f}); plain '
        f'{plain_pre:.3f} ms')
    say(f'kernel {ks.name} at {"x".join(map(str, size))}: {ms:.4f} ms per '
        f'launch against {u_ms:.4f} unsharded, in turns ({ms / u_ms:.4f}); '
        f'plain {plain_ms:.3f} ms')
    say(f'{path}: {stp.name} {x_ms:.5f} ms and {stp.rho_name} {xr_ms:.5f} '
        f'ms per launch from C ({plane} nodes per plane; plain versions '
        f'{x_plain:.4f} / {xr_plain:.4f} ms); the two exchanges '
        f'{(x_ms + xr_ms) / (pre_ms + ms):.4f} of a step')
    rows = {
        ks.name: dict(launches=steps, ms=ms, plain_ms=plain_ms, err=err,
                      mlups=mlups, unsharded_ms=u_ms, mesh_mlups=m_med,
                      unsharded_mlups=u_med,
                      mesh_over_unsharded=m_med / u_med,
                      exchange_ms=x_ms + xr_ms),
        ks.rho_name: dict(launches=steps, ms=pre_ms, plain_ms=plain_pre,
                          err=0.0, unsharded_ms=upre_ms),
        stp.name: dict(launches=steps, ms=x_ms, plain_ms=x_plain, err=0.0,
                       nodes=plane),
        stp.rho_name: dict(launches=steps, ms=xr_ms, plain_ms=xr_plain,
                           err=0.0, nodes=plane),
    }
    if len(size) == 3:
        shards = {}
        start = fu
        ref = tuple(f.clone() for f in leaves(flat.run(start,
                                                      SHARD_STEPS)))
        for n in MESH_SHARDS:
            sn = type(stp)(r.builder, r._domain_shape(), mesh_of(n, 3),
                           'kernel')
            mn, out = host_mlups(lambda: sn.run(start, SHARD_STEPS), nodes,
                                 SHARD_STEPS)
            un, _ = host_mlups(lambda: flat.run(start, SHARD_STEPS), nodes,
                               SHARD_STEPS)
            same, diff = same_bits(sn.gather(out), ref if len(ref) > 1
                                   else ref[0])
            say(f'{path} over {n} shards on the one card '
                f'({tuple(sn.kernels[0].shape)} each): {SHARD_STEPS} '
                f'steps equal to '
                f'the unsharded kernel\'s bit for bit: {same}; {mn:.1f} '
                f'MLUPS against {un:.1f} unsharded, in turns '
                f'({mn / un:.4f})')
            assert same, diff
            shards[n] = dict(mlups=mn, unsharded_mlups=un)
            del sn, out
            torch.cuda.empty_cache()
        rows[ks.name]['shards'] = shards
        del ref, start
    del r, stp, ks, flat, f0, fm, fu, ga, gb, ua, ub, bufs, rhos, wet
    torch.cuda.empty_cache()
    return rows


# -- two-axis meshes: the edge mode of the exchanges ------------------------

#: the edge mode against its plain version on random buffers: label ->
#: (sim class, flags, meshes); K = 1 (fp32 and int16), 2 and 3, one and two
#: ghost layers (free energy with walls), single-fluid densities
EDGE_CASES = {
    'ldc_3d': (LDC_3D, dict(lat_nx=64, lat_ny=64, lat_nz=64)),
    'ldc_3d_int16': (LDC_3D, dict(lat_nx=64, lat_ny=64, lat_nz=64,
                                  precision='mixed')),
    'sc_phase_separation_3d': (SC_3D, dict(lat_nx=64, lat_ny=64,
                                           lat_nz=64)),
    'sc_separation_3d': (SEP_3D, dict(lat_nx=64, lat_ny=64, lat_nz=64)),
    'ternary_separation_3d': (TERNARY_3D, dict(lat_nx=64, lat_ny=64,
                                               lat_nz=64)),
    'fe_viscous_fingering': (FE['fe_viscous_fingering'],
                             dict(lat_nx=320, lat_ny=100, lat_nz=36)),
    'ldc_2d': (LDC_2D, dict(lat_nx=1024, lat_ny=1024)),
    'sc_phase_separation': (SC_2D, dict(lat_nx=1024, lat_ny=1024)),
    'sc_separation_2d': (SEP_2D, dict(lat_nx=1024, lat_ny=1024)),
    'ternary_sc_drop_2d': (DROP_3, dict(lat_nx=1024, lat_ny=1024)),
    'fe_poiseuille_2d': (FE['fe_poiseuille_2d'],
                         dict(lat_nx=1024, lat_ny=512,
                              bc_wall_grad_phase=0.05)),
}
#: the two-axis meshes of the comparisons, per dimension
EDGE_MESHES = {3: ('2x2', '1x4'), 2: ('2x2', '1x2')}
#: the mesh of the mode classes' comparisons on two axes (``MESH_BITWISE``,
#: ``MESH_MULTI_CASES``), and the sizes that differ there (y cut from 101
#: to 100 to split evenly)
MESH2 = '2x2'
MESH2_SIZES = {'fe_viscous_fingering': dict(lat_nx=320, lat_ny=100,
                                            lat_nz=36)}
#: the two-axis main paths at full width, through the controller with
#: --mesh=1x1 (the zoo's rows, benchmark/model_zoo.py:172, :184, :189,
#: :200; the free-energy row at 4096^2): path -> (sim class, size, flags)
MESH2_MAIN = {
    'ldc_3d_zymesh1': (LDC_3D, (256, 256, 256), {}),
    'sc_separation_3d_zymesh1': (SEP_3D, (256, 256, 256), {}),
    'taylor_green_2d_yxmesh1': (twin('taylor_green_2d'), (4096, 4096),
                                dict(visc=0.01)),
    'fe_separation_2d_yxmesh1': (FE['fe_separation_2d'], (4096, 4096), {}),
}


def edge_exchange_check(label, sim_cls, cfg, mesh):
    """Both exchanges of the scene's sharded step over ``mesh`` (two axes,
    the shards on the one card) on random buffers of its shards' shapes
    against their plain versions: the distributions' exchange on the
    state's dtype (int16 codes too) and the density exchange on fp32
    densities of the step's layout (K components, ``ghost`` layers).
    Returns (exchange name, max |d|, density exchange name, max |d|)."""
    with pmesh.devices_override([DEVICE] * mesh_size(mesh)):
        r = run(sim_cls, max_iters=0, mesh=mesh, seed=1, **cfg)
    stp = r.stepper
    assert stp.inner is not None and 'edge_' in stp.name, stp.name
    g = torch.Generator(device=DEVICE).manual_seed(5)

    def rand(shape, dtype):
        x = torch.rand(shape, generator=g, device=DEVICE)
        return x if dtype == torch.float32 else (x * 3e4).to(dtype)

    bufs = [rand(ks.a.shape, ks.a.dtype) for ks in stp.kernels]
    ref = [b.clone() for b in bufs]
    halo.reset_launch_counts()
    if hasattr(stp, 'K'):
        stp.exchange_buffers(bufs)
        stp.exchange_reference([x.unbind(0) for x in ref])
        shape = density_of(stp, stp.kernels[0]).shape
    else:
        stp.exchange(bufs)
        stp.exchange_reference(ref)
        shape = stp.kernels[0].shape
    rhos = [rand(shape, torch.float32) for _ in stp.kernels]
    rref = [x.clone() for x in rhos]
    stp.density_exchange(rhos)
    stp.density_exchange_reference(rref)
    assert halo.LAUNCHES[stp.name] == halo.LAUNCHES[stp.rho_name] == 1
    f_err = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(bufs, ref))
    r_err = max(float((a - b).abs().max()) for a, b in zip(rhos, rref))
    k = getattr(stp, 'K', 1)
    say(f'compare edge exchange {label} --mesh={mesh} (shards '
        f'{tuple(stp.kernels[0].shape)}, K = {k}, ghost {stp.ghost}, '
        f'{bufs[0].dtype}): {stp.name} and {stp.rho_name} against '
        f'ghost_copy on random buffers, max |d| {f_err:g} / {r_err:g}')
    assert f_err == 0.0 and r_err == 0.0, (f_err, r_err)
    out = (stp.name, f_err, stp.rho_name, r_err)
    del r, stp, bufs, ref, rhos, rref
    torch.cuda.empty_cache()
    return out


def mesh2_main_path(path, sim_cls, size, flags, chunk=250, chunks=2,
                    turn_steps=100, shard_steps=SHARD_STEPS):
    """A scene through the controller with ``--mesh=1x1`` on the kernel
    engine: per step the shard's ghost-mode launch (after its pre-pass and
    the density edge exchange for the couplings) and one edge exchange,
    nothing else (counts zeroed just before, read just after). Then, on
    the main path's own state: 10 steps against the plain version of the
    sharded step; ``turn_steps``-step runs in turns of ``--mesh=1x1``,
    ``--mesh=1`` and the unsharded kernel on the same builder (MLUPS, host
    clock; the same bits after each turn); ms per launch of the edge
    exchanges from C against the one-axis exchanges; and 2x2 shards on
    the card, ``shard_steps`` steps, the unsharded kernel's bits, MLUPS in
    turns. Returns ({JSON row: measurements}, the path's summary)."""
    dim = len(size)
    cfg = dict(zip(('lat_nx', 'lat_ny', 'lat_nz'), size), **flags)
    steps = chunk * chunks
    reset_all_counts()
    r = run(sim_cls, max_iters=steps, every=chunk, mesh='1x1', seed=1, **cfg)
    counts, xcounts = kernel_counts(), dict(halo.LAUNCHES)
    stp = r.stepper
    grid = r.sim.grid.name
    ks = stp.kernels[0]
    coupled = hasattr(stp, 'K') or stp.sc
    names = [ks.rho_name, ks.name] if coupled else [ks.name]
    xnames = [stp.rho_name, stp.name] if coupled else [stp.name]
    assert r.engine == 'kernel' and r.kernel is stp and stp.mesh.size == 1
    assert stp.inner == (1, size[-2]), stp.inner
    assert all('ghost_' in n for n in names), names
    assert all('edge_' in n for n in xnames), xnames
    for n in names:
        assert counts[n] == steps == r.sim.iteration, (n, counts)
    assert sum(counts.values()) == len(names) * steps, counts
    for n in xnames:
        assert xcounts[n] == steps, (n, xcounts)
    assert sum(xcounts.values()) == len(xnames) * steps, xcounts
    assert stp.is_finite(r.state)
    r._fields_to_host()
    shape = tuple(reversed(size))
    for field in ('rho', 'vx') + (('phi',) if hasattr(stp, 'K') else ()):
        arr = getattr(r.sim, field)
        assert arr.shape == shape and np.all(np.isfinite(arr)), field
    mlups = statistics.median(r.mlups_history[1:])
    say(f'main path {path} {"x".join(map(str, size))} ({grid}, engine '
        f'{r.engine}, --mesh=1x1, a shard {tuple(ks.shape)}): '
        f'{" + ".join(f"{steps} {n}" for n in names + xnames)} launches; '
        f'MLUPS per {chunk}-step chunk '
        f'{[round(m, 1) for m in r.mlups_history]}; median {mlups:.1f}')
    f0 = tuple(f.clone() for f in leaves(r.f))
    f0 = f0[0] if torch.is_tensor(r.f) else f0
    wet = torch.as_tensor(wet_map(r.maps), device=DEVICE)
    fk = stp.gather(stp.run(f0, 10, steps))
    s = stp.shard(f0)
    for i in range(10):
        s = stp.reference(s, steps + i)
    err = max(float((a - b)[:, wet].abs().max())
              for a, b in zip(leaves(fk), leaves(stp.gather(s))))
    say(f'compare main path {path}: 10 steps from the state after {steps}, '
        f'wet max|df| = {err:.3e} (tol {TOL:g})')
    assert np.isfinite(err) and err <= TOL, err
    del s, fk
    # in turns: --mesh=1x1, --mesh=1 and the unsharded kernel
    one = type(stp)(r.builder, r._domain_shape(), mesh_of(1, dim), 'kernel')
    flat = r._kernel_engine(r.builder)
    nodes = int(np.prod(size))
    variants = {'1x1': stp, '1': one, 'unsharded': flat}
    state = dict.fromkeys(variants, f0)
    mlups_of = {k: [] for k in variants}
    for _ in range(2):
        for key, eng in variants.items():
            m, out = host_mlups(lambda: eng.run(state[key], turn_steps),
                                nodes, turn_steps)
            mlups_of[key].append(m)
            out = out if key == 'unsharded' else eng.gather(out)
            out = tuple(f.clone() for f in leaves(out))
            state[key] = out[0] if torch.is_tensor(r.f) else out
        for key in ('1x1', '1'):
            same, diff = same_bits(state[key], state['unsharded'])
            assert same, (key, diff)
    med = {k: statistics.median(v) for k, v in mlups_of.items()}
    say(f'{path}: {turn_steps}-step runs in turns from the same state, '
        f'MLUPS --mesh=1x1 {[round(v, 1) for v in mlups_of["1x1"]]}, '
        f'--mesh=1 {[round(v, 1) for v in mlups_of["1"]]}, unsharded '
        f'{[round(v, 1) for v in mlups_of["unsharded"]]}: 1x1 over 1 '
        f'{med["1x1"] / med["1"]:.4f}, 1x1 over unsharded '
        f'{med["1x1"] / med["unsharded"]:.4f}, 1 over unsharded '
        f'{med["1"] / med["unsharded"]:.4f}; the three states equal bit '
        f'for bit after each turn')
    # the exchanges from C, and their plain versions
    x_ms = plan_ms(stp, stp._plan_for([ks.a for ks in stp.kernels]))
    x1_ms = plan_ms(one, one._plan_for([k.a for k in one.kernels]))
    if hasattr(stp, 'K'):
        x_plain = util.cuda_time_ms(lambda: stp.exchange_reference(
            [ks.a.unbind(0)]), 20, warmup=2)
    else:
        x_plain = util.cuda_time_ms(lambda: stp.exchange_reference(
            [ks.a]), 20, warmup=2)
    rows_x = {stp.name: dict(launches=steps, ms=x_ms, plain_ms=x_plain,
                             err=0.0, nodes=int(np.prod(size[1:])),
                             extra_bytes=edge_bytes(stp, size, 'f'),
                             one_axis_ms=x1_ms)}
    line = (f'{stp.name} {x_ms:.5f} ms per launch from C against the '
            f'one-axis {one.name} {x1_ms:.5f} (plain {x_plain:.4f} ms)')
    if coupled:
        rhos = [density_of(stp, ks)]
        stp.density_exchange(rhos)
        xr_ms = plan_ms(stp, stp._plans['rho'][1])
        one.density_exchange([density_of(one, one.kernels[0])])
        xr1_ms = plan_ms(one, one._plans['rho'][1])
        xr_plain = util.cuda_time_ms(
            lambda: stp.density_exchange_reference(rhos), 20, warmup=2)
        rows_x[stp.rho_name] = dict(
            launches=steps, ms=xr_ms, plain_ms=xr_plain, err=0.0,
            nodes=int(np.prod(size[1:])),
            extra_bytes=edge_bytes(stp, size, 'rho'), one_axis_ms=xr1_ms)
        line += (f'; {stp.rho_name} {xr_ms:.5f} against {one.rho_name} '
                 f'{xr1_ms:.5f} (plain {xr_plain:.4f} ms)')
    say(f'{path}: {line}')
    # 2x2 shards on the card
    start = state['unsharded']
    sn = type(stp)(r.builder, r._domain_shape(),
                   pmesh.make_mesh((2, 2), dim, [DEVICE] * 4), 'kernel')
    mn, out = host_mlups(lambda: sn.run(start, shard_steps), nodes,
                         shard_steps)
    un, ref = host_mlups(lambda: flat.run(start, shard_steps), nodes,
                         shard_steps)
    same, diff = same_bits(sn.gather(out), ref)
    xn = plan_ms(sn, sn._plan_for([k.a for k in sn.kernels]))
    say(f'{path} over 2x2 shards on the one card '
        f'({tuple(sn.kernels[0].shape)} each): {shard_steps} steps equal '
        f'to the unsharded kernel\'s bit for bit: {same}; {mn:.1f} MLUPS '
        f'against {un:.1f} unsharded, in turns ({mn / un:.4f}); '
        f'{sn.name} {xn:.5f} ms per launch')
    assert same, diff
    summary = dict(mlups=mlups, err=err, mesh_1x1_mlups=med['1x1'],
                   mesh_1_mlups=med['1'], unsharded_mlups=med['unsharded'],
                   over_mesh_1=med['1x1'] / med['1'],
                   over_unsharded=med['1x1'] / med['unsharded'],
                   shards_2x2=dict(mlups=mn, unsharded_mlups=un,
                                   exchange_ms=xn))
    rows = {n: dict(launches=steps, err=err if n == ks.name else 0.0)
            for n in names}
    rows.update(rows_x)
    del r, stp, one, flat, sn, out, ref, start, state, f0, ks, wet
    torch.cuda.empty_cache()
    return rows, summary


def edge_bytes(stp, size, which):
    """The bytes of an edge exchange on ``--mesh=1x1`` beyond its planes'
    and rows' (``NODE_BYTES`` per node of a plane): the edges' (3D) or
    corners' (2D) values, read and written."""
    k = getattr(stp, 'K', 1)
    if which == 'rho':
        per = (1 if getattr(stp, 'fe', False) else k) * stp.ghost ** 2
        dirs = 1
    else:
        per, dirs = k, len(stp.regions[(-1, -1)])
    row = size[0] if len(size) == 3 else 1
    return 4 * dirs * per * row * 2 * 4


#: ibm_cylinder at a full width: the marker spacing 2 pi 256 / 1600 =
#: 1.005 nodes, the spacing the IBM method needs
IBM_MAIN = dict(lat_nx=4096, lat_ny=2048, radius=256, n_markers=1600)
IBM_STEPS = 500
IBM_CHUNK = 100
#: the card against the CPU: the golden harness's size, 200 steps
IBM_COMPARE_STEPS = 200
#: tracers on the kernel's main path: ldc_3d 256^3, updated every
#: TRACER_EVERY of TRACER_STEPS steps
TRACERS = 100_000
TRACER_STEPS = 1000
TRACER_EVERY = 100
CUBE_256 = dict(lat_nx=256, lat_ny=256, lat_nz=256)


def ibm_card_against_cpu():
    """``ibm_cylinder`` at the golden harness's 48x24 for 200 steps on the
    card's torch engine against the CPU's: f within ``TOL`` on wet nodes,
    the positions within ``FP64_FACTOR`` times the CPU fp32 run's
    distance to the CPU fp64 run; two card runs give the same bits (the
    spreading sums each node's contributions in a fixed order, no
    atomics)."""
    cfg = dict(SINGLE_GOLDEN_FLAGS['ibm_cylinder'], engine='torch',
               max_iters=IBM_COMPARE_STEPS, every=IBM_COMPARE_STEPS)
    sim_cls = twin('ibm_cylinder')
    card = [run(sim_cls, platform=DEVICE, **cfg) for _ in range(2)]
    assert all(r.engine == 'torch' and r.device.type == DEVICE
               for r in card)
    same = all(torch.equal(a, b) for a, b in zip(card[0].f, card[1].f))
    cpu = run(sim_cls, platform='cpu', **cfg)
    cpu64 = run(sim_cls, platform='cpu', precision='double', **cfg)
    wet = wet_map(cpu.maps)
    f, pos = (x.cpu().numpy() for x in card[0].f)
    f32, pos32 = (x.numpy() for x in cpu.f)
    pos64 = cpu64.f[1].numpy()
    f_err = float(np.abs(f - f32)[:, wet].max())
    p_err = float(np.abs(pos - pos64).max())
    p_ref = float(np.abs(pos32 - pos64).max())
    say(f'ibm_cylinder 48x24, {IBM_COMPARE_STEPS} steps, card torch engine '
        f'against the CPU\'s: wet max|df| = {f_err:.3e} (tol {TOL:g}); '
        f'positions {p_err:.3e} from the CPU fp64 run, the CPU fp32 run '
        f'{p_ref:.3e} from it (factor {FP64_FACTOR:g}), card against CPU '
        f'fp32 {float(np.abs(pos - pos32).max()):.3e}; two card runs the '
        f'same bits: {same}')
    assert np.isfinite(f_err) and f_err <= TOL, f_err
    assert p_err <= FP64_FACTOR * max(p_ref, float(np.spacing(
        np.float32(1.0)))), (p_err, p_ref)
    assert same
    del card, cpu, cpu64
    free_memory()


def ibm_main_path():
    """``ibm_cylinder`` at ``IBM_MAIN`` through the controller on the
    torch engine (the kernels refuse it by name), ``IBM_STEPS`` steps in
    ``IBM_CHUNK``-step chunks: ms per step (median of the chunks after the
    first), the ms of ``spread_forces`` + ``interpolate_velocity`` alone
    on the final positions and velocity (CUDA events; the spreading holds
    one host sync), the PyTorch kernels per step and the device's idle
    share of one more traced chunk (``tools/trace_main_path``), and the
    markers' displacement: finite, and downstream (+x) on average."""
    from sailfish_tpu_torch.ops import ibm
    ls.reset_launch_counts()
    r = run(twin('ibm_cylinder'), engine='torch', max_iters=IBM_STEPS,
            every=IBM_CHUNK, **IBM_MAIN)
    assert r.engine == 'torch' and r.kernel is None, r.engine
    assert not any(ls.LAUNCHES.values()), dict(ls.LAUNCHES)
    nodes = IBM_MAIN['lat_nx'] * IBM_MAIN['lat_ny']
    history = list(r.mlups_history)
    mlups = statistics.median(history[1:])
    step_ms = 1e3 * nodes / (mlups * 1e6)
    b = r.builder
    f, pos = r.f
    disp = (pos - b.ref_pos).cpu().numpy()
    assert np.all(np.isfinite(disp)), disp
    mean_dx = float(disp[0].mean())
    largest = float(np.abs(disp).max())
    assert mean_dx > 0.0, mean_dx
    r._fields_to_host()
    assert np.all(np.isfinite(r.sim.vx)) and np.all(np.isfinite(r.sim.rho))
    _rho, u = b.macro_fields(r.f)
    shape = b.maps.type_map.shape
    ibm_ms = util.cuda_time_ms(
        lambda: (ibm.spread_forces(pos, b.ref_pos, b.stiffness, shape,
                                   b.dtype),
                 ibm.interpolate_velocity(u, pos)), 20, warmup=2)
    trace_dir = os.path.join(REPO, 'chiprun_out', 'traces')
    os.makedirs(trace_dir, exist_ok=True)
    traced = trace_runner_chunk(r, 'ibm_cylinder', 20, trace_dir)
    say(f'main path ibm_cylinder {IBM_MAIN["lat_nx"]}x{IBM_MAIN["lat_ny"]} '
        f'({IBM_MAIN["n_markers"]} markers, radius {IBM_MAIN["radius"]}; '
        f'engine {r.engine}): MLUPS per {IBM_CHUNK}-step chunk '
        f'{[round(m, 1) for m in history]}; median {mlups:.1f} '
        f'MLUPS, {step_ms:.4f} ms per step; spread_forces + '
        f'interpolate_velocity {ibm_ms:.4f} ms ({ibm_ms / step_ms:.4f} of '
        f'a step); {traced["other_kernels_per_step"]:.1f} PyTorch kernels '
        f'per step, device idle share of a traced 20-step chunk '
        f'{traced["idle_share"]:.5f}; markers displaced by {largest:.5f} '
        f'at most, {mean_dx:.6f} along +x on average')
    del r, b, f, pos, u
    free_memory()
    return dict(step_ms=step_ms, ibm_ms=ibm_ms,
                kernels_per_step=traced['other_kernels_per_step'],
                idle_share=traced['idle_share'], largest=largest)


def tracer_main_path():
    """``ldc_3d`` 256^3 on the kernel engine carrying ``TRACERS`` tracers
    (``torch_scenes.with_tracers``) updated every ``TRACER_EVERY`` of
    ``TRACER_STEPS`` steps, the launch counts zeroed just before and read
    just after: one ``lbm_step_d3q19`` launch per step; the host ms per
    update (synchronized; the velocity read from the kernel's state
    through ``runner.macro_fields``); every tracer in the domain; and on
    one velocity field from the kernel's state the card's advection equals
    the CPU's bit for bit. Returns the launches."""
    from sailfish_tpu_torch.tracers import TracerParticles
    shape = tuple(CUBE_256[k] for k in ('lat_nz', 'lat_ny', 'lat_nx'))
    sizes = np.array(tuple(reversed(shape)), dtype=np.float32)[:, None]
    pos = np.random.default_rng(5).uniform(0.0, 1.0, (3, TRACERS)) * sizes

    class Sim(with_tracers(LDC_3D, pos, TRACER_EVERY)):
        update_ms = []

        def after_step(self, runner):
            util.synchronize(DEVICE)
            t0 = time.perf_counter()
            super().after_step(runner)
            util.synchronize(DEVICE)
            Sim.update_ms.append(1e3 * (time.perf_counter() - t0))

    ls.reset_launch_counts()
    r = run(Sim, max_iters=TRACER_STEPS, **CUBE_256)
    counts = {k: v for k, v in ls.LAUNCHES.items() if v}
    assert r.engine == 'kernel', r.engine
    assert counts == {'lbm_step_d3q19': TRACER_STEPS}, counts
    tp = r.sim.tp
    assert tp.positions.device.type == DEVICE
    assert len(Sim.update_ms) == TRACER_STEPS // TRACER_EVERY
    now = tp.to_numpy()
    inside = bool(np.all((now >= 0.0) & (now < sizes)))
    # the displacement, a wrap across the domain taken out
    d = now - pos.astype(np.float32)
    moved = float(np.abs(d - np.round(d / sizes) * sizes).max())
    _rho, u = r.macro_fields()
    on_card = tp.advect(u).cpu().numpy()
    on_cpu = TracerParticles(now, shape).advect(u.cpu()).numpy()
    same = np.array_equal(on_card, on_cpu)
    say(f'tracers: {TRACERS} on ldc_3d 256^3 (kernel engine, '
        f'lbm_step.LAUNCHES {counts}), updated every {TRACER_EVERY} of '
        f'{TRACER_STEPS} steps: {statistics.median(Sim.update_ms):.3f} ms '
        f'per update (host, synchronized; median of '
        f'{len(Sim.update_ms)}: {[round(m, 3) for m in Sim.update_ms]}); '
        f'all in the domain: {inside}; moved by {moved:.4f} at most; one '
        f'advection on the card equals the CPU\'s bit for bit: {same}')
    assert inside and moved > 0.0 and same
    del r, tp, u
    free_memory()
    return counts['lbm_step_d3q19'], statistics.median(Sim.update_ms)


def missing(module):
    """True, saying so, when ``module`` is not installed: the phase that
    needs it does not run (a host package, no fault of the port)."""
    try:
        __import__(module)
    except ImportError:
        say(f'{module} is not installed on this machine: the phase that '
            'needs it did not run')
        return True
    return False


def visualization_main_path():
    """``ldc_3d`` 256^3 on the kernel engine under ``--mode=visualization``
    (the matplotlib engine), 200 steps with output every 100: one frame
    per output event, named as the JAX package names them, and the host
    ms per frame. Returns the launches (0 when matplotlib is missing)."""
    if missing('matplotlib'):
        return 0, None
    from sailfish_tpu_torch.vis_mpl import MatplotlibVis
    frame_ms = []
    update = MatplotlibVis.update

    def timed(self, iteration):
        t0 = time.perf_counter()
        out = update(self, iteration)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        # without --output the frames go to vis_frames in the working
        # directory (no 256^3 npz output is written)
        os.chdir(tmp)
        MatplotlibVis.update = timed
        try:
            ls.reset_launch_counts()
            r = run(LDC_3D, max_iters=200, every=100, mode='visualization',
                    **CUBE_256)
            counts = {k: v for k, v in ls.LAUNCHES.items() if v}
            frames = sorted(os.listdir('vis_frames'))
            sizes = [os.path.getsize(os.path.join('vis_frames', n))
                     for n in frames]
        finally:
            MatplotlibVis.update = update
            os.chdir(here)
    assert r.engine == 'kernel' and isinstance(r.vis, MatplotlibVis)
    assert counts == {'lbm_step_d3q19': 200}, counts
    assert frames == ['frame_0000100.png', 'frame_0000200.png'], frames
    assert min(sizes) > 1000, sizes
    say(f'--mode=visualization on ldc_3d 256^3 (kernel engine, '
        f'lbm_step.LAUNCHES {counts}): frames {frames} ({sizes} B), '
        f'{frame_ms[-1]:.1f} ms per frame (host, the mid-plane of the '
        f'256^3 fields; the first frame, with matplotlib\'s set-up, '
        f'{frame_ms[0]:.1f} ms)')
    del r
    free_memory()
    return counts['lbm_step_d3q19'], frame_ms[-1]


def slice_server_main_path():
    """``ldc_3d`` 256^3 on the kernel engine serving slices
    (``Vis2DSliceMixIn``) to a subscriber on 127.0.0.1
    (``torch_scenes.with_slice_subscriber``; every receive times out after
    ``SLICE_TIMEOUT_MS``), 300 steps with a slice every 100: three slices,
    the last equal to the host field's slice bit for bit. Returns the
    launches (0 when pyzmq is missing)."""
    if missing('zmq'):
        return 0
    ls.reset_launch_counts()
    r = run(with_slice_subscriber(LDC_3D), max_iters=300, every=100,
            **CUBE_256)
    counts = {k: v for k, v in ls.LAUNCHES.items() if v}
    sim = r.sim
    try:
        got = [next(sim.subscriber) for _ in range(3)]
    finally:
        sim.subscriber.close()
        sim.close_slice_server()
    assert r.engine == 'kernel'
    assert counts == {'lbm_step_d3q19': 300}, counts
    meta = [(m['iteration'], m['field'], m['axis'], m['position'])
            for m, _a in got]
    assert meta == [(it, 'rho', 0, 0) for it in (100, 200, 300)], meta
    # axis 0 is x: the array's last axis
    expect = np.ascontiguousarray(sim.rho[:, :, 0], dtype=np.float32)
    same = np.array_equal(got[-1][1], expect)
    say(f'slice server on ldc_3d 256^3 (kernel engine, lbm_step.LAUNCHES '
        f'{counts}): received {meta} on 127.0.0.1; the last slice equals '
        f'the host field\'s bit for bit: {same}')
    assert same
    del r, sim
    free_memory()
    return counts['lbm_step_d3q19']


#: the lbm_step libraries and the other sources the smoke builds
LBM_LIBRARIES = list(ls.LIBRARIES.values()) \
    + list(ls.MIXED_LIBRARIES.values()) + [ls.LATTICES_LIBRARY,
                                            ls.OUTFLOW_LIBRARY]
SOURCES = LBM_LIBRARIES + ['sc_multi', 'fe_step', 'halo']
#: the sources the first comparisons (fp32 and mixtures) use
FIRST_SOURCES = [ls.LIBRARIES[0], ls.LIBRARIES[1], ls.LIBRARIES[2],
                 'sc_multi']


def build_report(sources=SOURCES, lbm_libraries=LBM_LIBRARIES):
    """Wait for the builds of ``sources`` (started by ``build.start_all``)
    and print what the compiler made of each: every ``lbm_step`` and
    Shan-Chen instantiation's registers, stack frame and spills, asserted
    in registers (0 B frame, <= 128 registers), each in its library, and
    the number of instantiation classes."""
    kinds, sc_kinds = set(), set()
    for name, lib in build.load_all(sources).items():
        say(f'build {name}: {lib.path.name}, ready {lib.seconds:.1f} s '
            'after its compiler started (0 = cached)')
        for line in lib.log.splitlines():
            if 'entry function' in line or 'registers' in line \
                    or 'spill' in line:
                say('  ptxas:', line.strip())
        if name in lbm_libraries:
            for fn, use in sorted(build.ptxas_usage(lib.log).items()):
                inst = ls.instantiation(fn)
                if inst is None:
                    continue
                kinds.add(tuple(inst.values()))
                say(f'lbm_step d{inst["dim"]}q{inst["q"]} force '
                    f'{inst["force"]}, walls {int(inst["walls"])}, model '
                    f'{inst["model"]}, equilibrium {inst["equilibrium"]}, '
                    f'sc {int(inst["sc"])}, storage {inst["storage"]}, '
                    f'outflow {int(inst["outflow"])}: '
                    f'{use["registers"]} '
                    f'registers, stack frame {use["stack_frame"]} B, spill '
                    f'{use["spill_stores"]} / {use["spill_loads"]} B')
                # the BC chain, the walls and the collision models run in
                # registers: no local memory
                assert use['stack_frame'] == use['spill_stores'] \
                    == use['spill_loads'] == 0, (fn, use)
                assert use['registers'] <= 128, (fn, use)
                # each library holds its collision model's instantiations
                # of its storage; the other lattices have one of their own
                if inst['q'] in (15, 27):
                    assert name == ls.LATTICES_LIBRARY, (name, fn)
                    continue
                if inst['outflow']:
                    assert name == ls.OUTFLOW_LIBRARY, (name, fn)
                    continue
                libs = ls.LIBRARIES if inst['storage'] == 'fp32' \
                    else ls.MIXED_LIBRARIES
                assert libs[ls.MODEL_CODES[inst['model']]] == name

        if name == 'sc_multi':
            for fn, use in sorted(build.ptxas_usage(lib.log).items()):
                inst = sm.instantiation(fn)
                if inst is None or 'registers' not in use:
                    continue
                sc_kinds.add(tuple(inst.values()))
                say(f'sc_multi d{inst["dim"]}q{inst["q"]} K={inst["k"]} '
                    f'forced {int(inst["forced"])}: {use["registers"]} '
                    f'registers, stack frame {use["stack_frame"]} B, spill '
                    f'{use["spill_stores"]} / {use["spill_loads"]} B')
                if inst['dim'] == 3:
                    # the D3Q19 tile runs in registers, 16 warps per SM
                    assert 'sc3_kernel' in fn, fn
                    assert use['stack_frame'] == use['spill_stores'] \
                        == use['spill_loads'] == 0, (fn, use)
                    assert use['registers'] <= 128, (fn, use)
        if name == 'fe_step':
            for fn, use in sorted(build.ptxas_usage(lib.log).items()):
                if 'fe3_kernel' in fn and 'registers' in use:
                    say(f'fe_step_d3q19 {fn}: {use["registers"]} registers,'
                        f' spill stores {use.get("spill_stores")} B, spill '
                        f'loads {use.get("spill_loads")} B')
    # two lattices x (no force + three force models) x wall rows or not x
    # three collision models x two equilibria, in fp32 and in int16; ELBM
    # with the compressible equilibrium in both; the
    # shallow-water equilibrium (D2Q9 BGK, three force models, wall rows or
    # not) and the Shan-Chen mode (two lattices, no force or Guo) in fp32;
    # BGK on D3Q15 and D3Q27 (every force model, wall rows or not, two
    # equilibria) in fp32; the outflow rows (two lattices, every force
    # model, two equilibria; BGK with wall rows, fp32)
    assert len(kinds) == 2 * (2 * (1 + len(FORCE_MODELS)) * 2 * 3 * 2) \
        + 2 * (2 * (1 + len(FORCE_MODELS)) * 2) + 6 + 4 \
        + 2 * (1 + len(FORCE_MODELS)) * 2 * 2 \
        + 2 * (1 + len(FORCE_MODELS)) * 2, len(kinds)
    # two lattices x K = 2, 3 x forced or not
    assert len(sc_kinds) == 2 * 2 * 2, sc_kinds
    for name, tile in (('fe_step_d3q19', fe.TILE_3D),
                       ('sc_multi D3Q19 step', sm.TILE_3D)):
        say(f'{name} tile: {tile[0]}x{tile[1]} threads over (x, y), '
            f'{tile[2]} z-planes per block')


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch sees no CUDA device')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    say(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')

    # the libraries of the first comparisons first, the others after them,
    # all building while the first comparisons run
    build.start_all(FIRST_SOURCES)
    build.start_all(SOURCES)
    phase_done('builds started')
    errs = {}

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    duct = dict(lat_nx=128, lat_ny=64, lat_nz=64)
    for name, sim_cls, cfg in (
            ('ldc_3d', LDC_3D, dict(lat_nx=128, lat_ny=128, lat_nz=128)),
            ('duct_zouhe', channel_sim('zouhe', 'x'), duct),
            ('duct_equilibrium', channel_sim('equilibrium', 'x'), duct),
            ('duct_regularized', channel_sim('regularized', 'x'), duct),
            ('ldc_2d', LDC_2D, dict(lat_nx=1024, lat_ny=1024))):
        grid, err = compare(name, sim_cls, **cfg)
        note(f'lbm_step_{grid.lower()}', err)
    for pair in sorted(BC_PAIRS):
        for dim, axis, cfg in (
                (3, 'z', dict(duct, periodic_x=True)),
                (3, 'y', dict(duct, periodic_x=True)),
                (3, 'x', dict(duct, periodic_z=True)),
                (2, 'y', dict(lat_nx=1024, lat_ny=1024)),
                (2, 'x', dict(lat_nx=1024, lat_ny=1024))):
            grid, err = vary_compare(f'parabolic_{pair}_{dim}d_{axis}', dim,
                                     axis, pair, **cfg)
            note(f'lbm_step_vary_{grid.lower()}', err)
    forced_cases = [
        (f'{scene}_{model}', twin(scene), model, False, cfg)
        for scene, cfg in (('sphere_3d', duct),
                           ('cylinder', dict(lat_nx=1024, lat_ny=512)))
        for model in FORCE_MODELS]
    forced_cases.append(('poiseuille_3d_guo', twin('poiseuille_3d'), 'guo',
                         False, dict(lat_nx=64, lat_ny=64, lat_nz=64)))
    # BC nodes take the force in bc_face: a face normal to each axis for
    # the regularized and the Zou-He pair, the models in turn
    faces = [(pair, axis) for pair in ('regularized', 'zouhe')
             for axis in 'xyz']
    for k, (pair, axis) in enumerate(faces):
        model = FORCE_MODELS[k % len(FORCE_MODELS)]
        periodic = 'periodic_z' if axis == 'x' else 'periodic_x'
        forced_cases.append((
            f'forced_channel_{pair}_{axis}_{model}',
            forced_channel_sim(pair, axis), model, True,
            dict(duct, **{periodic: True})))
    for name, sim_cls, model, bc, cfg in forced_cases:
        grid, err = compare(name, sim_cls, force_model=model, bc=bc, **cfg)
        note(f'lbm_step_force_{grid.lower()}', err)
    # the wall rows and the per-step values at 64^3 / 1024^2, 200 steps
    cube64 = dict(lat_nx=64, lat_ny=64, lat_nz=64)
    sq1024 = dict(lat_nx=1024, lat_ny=1024)
    slice_cases = []
    for dim in (3, 2):
        axes = tuple(range(dim))
        size = dict(box_cfg(dim, axes), **(cube64 if dim == 3 else sq1024))
        for model in (None,) + FORCE_MODELS:
            slice_cases.append((
                f'halfbb_box_{dim}d_{model}',
                box_sim(WALLS['halfbb'], dim, axes, ACCEL if model else None),
                0, model, size))
        periodic = dict(periodic_x=True, periodic_z=True)
        slice_cases.append((f'tms_channel_{dim}d', tms_channel_sim(dim), 0,
                            'guo', dict(cube64 if dim == 3 else sq1024,
                                        **periodic)))
        for a in range(dim):
            slice_cases.append((
                f'slip_{dim}d_{"xyz"[a]}', slip_sim(dim, a), 0, 'guo',
                dict(cube64 if dim == 3 else sq1024,
                     **{f'periodic_{"xyz"[b]}': b != a
                        for b in range(dim)})))
        slice_cases.append((f'halfbb_parabolic_inlet_{dim}d',
                            halfbb_beside_parabolic_inlet(dim), 0, None,
                            dict(cube64, periodic_x=True) if dim == 3
                            else sq1024))
    # poiseuille_pulsatile sizes its drive for the channel's width (a =
    # 8 u_max nu / W^2): 1024 x 64, a 62-row channel, where 200 steps of it
    # move the state well beyond the tolerance
    pulsatile = dict(lat_nx=1024, lat_ny=64)
    slice_cases += [
        ('womersley_64', twin('womersley'), 3000, None, cube64),
        ('pulsatile_force', twin('poiseuille_pulsatile'), 500, None,
         dict(pulsatile, drive='force')),
        ('pulsatile_pressure', twin('poiseuille_pulsatile'), 500, None,
         pulsatile),
        ('time_series_density', time_series_density_sim(), 60, None,
         sq1024),
        ('poiseuille_sa_1024', twin('poiseuille_sa'), 2500, None,
         dict(sq1024, velocity='spatial_array')),
    ]
    for name, sim_cls, it0, model, cfg in slice_cases:
        key, err = slice_compare(name, sim_cls, it0, force_model=model,
                                 **cfg)
        note(key, err)
    # the collision-model mode, 200 steps: every instantiation of a new
    # model or equilibrium, without wall rows on the forced sphere and
    # cylinder (unforced and under each force model; trt and mrt + les are
    # mrt's instantiation), with them on half-way and TMS boxes, on
    # native-BC faces normal to each axis, and with time-only rows
    sq512 = dict(lat_nx=1024, lat_ny=512)
    # tau = 0.65 where a scene has no viscosity of its own: at tau = 1 the
    # odd MRT rate equals the even one (MRT is BGK) and BGK leaves no
    # non-equilibrium stress for the subgrid rate
    visc = dict(visc=0.05)
    new_models = ('mrt', 'les', 'incompressible', 'incompressible_mrt',
                  'incompressible_les')
    model_cases = []
    for scene, cfg in (('sphere_3d', duct), ('cylinder', sq512)):
        for coll in new_models:
            for force in (None,) + FORCE_MODELS:
                sim = twin(scene) if force else unforced(twin(scene))
                model_cases.append((f'{scene}_{coll}_{force}',
                                    with_keep_block(sim), coll, force, 0,
                                    cfg))
        for coll in ('trt', 'mrt_les'):
            model_cases.append((f'{scene}_{coll}_guo',
                                with_keep_block(twin(scene)), coll, 'guo', 0,
                                cfg))
    for dim in (3, 2):
        axes = tuple(range(dim))
        size = dict(box_cfg(dim, axes), **(cube64 if dim == 3 else sq1024),
                    **visc)
        for k, coll in enumerate(new_models):
            for j, force in enumerate((None,) + FORCE_MODELS):
                wall = ('halfbb', 'tms')[(j + k) % 2]
                model_cases.append((
                    f'{wall}_box_{dim}d_{coll}_{force}',
                    box_sim(WALLS[wall], dim, axes, ACCEL if force else None),
                    coll, force, 0, size))
        for a in range(dim):
            coll = ('mrt', 'les')[a % 2]
            model_cases.append((
                f'slip_{dim}d_{"xyz"[a]}_{coll}', slip_sim(dim, a), coll,
                'guo', 0, dict(cube64 if dim == 3 else sq1024, **visc,
                               **{f'periodic_{"xyz"[b]}': b != a
                                  for b in range(dim)})))
    for k, axis in enumerate('xyz'):
        pair = ('regularized', 'zouhe')[k % 2]
        periodic = 'periodic_z' if axis == 'x' else 'periodic_x'
        for coll in ('mrt', 'les'):
            model_cases.append((
                f'channel_{pair}_{axis}_{coll}',
                with_patch_row_mix(with_keep_block(
                    forced_channel_sim(pair, axis, 'parabolic')), axis),
                coll, 'guo', 0, dict(duct, **visc, **{periodic: True})))
    for axis in 'yx':
        for coll in ('mrt', 'les'):
            model_cases.append((
                f'channel_2d_{axis}_{coll}',
                with_patch_row_mix(with_keep_block(
                    channel_sim_2d('zouhe', axis=axis)), axis),
                coll, None, 0, dict(sq1024, **visc)))
    model_cases.append(('womersley_64_mrt', twin('womersley'), 'mrt', None,
                        3000, cube64))
    for name, sim_cls, coll, force, it0, cfg in model_cases:
        key, err = model_compare(name, sim_cls, coll, force, it0, **cfg)
        note(key, err)
    cube = dict(lat_nx=128, lat_ny=128, lat_nz=128)
    sq = dict(lat_nx=1024, lat_ny=1024)
    for name, sim_cls, cfg in (
            ('sc_separation_2d', SEP_2D, sq),
            ('sc_separation_3d', SEP_3D, cube),
            ('sc_separation_3d_classic', SEP_3D,
             dict(cube, sc_potential='classic')),
            ('sc_separation_3d_walls', SEP_3D_WALLS, cube),
            # the forced and K = 3 modes: the Guo force with the
            # pseudopotential force (a wrong order of the two velocity
            # shifts shows only when both act)
            ('sc_rayleigh_taylor_2d', RT_2D, sq),
            ('sc_separation_3d_walls_forced',
             forced_mixture(SEP_3D_WALLS), cube),
            ('ternary_sc_drop_2d', DROP_3, sq),
            ('ternary_separation_3d', TERNARY_3D, cube),
            ('ternary_separation_3d_classic', TERNARY_3D,
             dict(cube, sc_potential='classic', G11=-0.3, G33=0.2)),
            ('ternary_sc_drop_2d_forced', forced_mixture(DROP_3), sq),
            ('ternary_separation_3d_walls_forced',
             forced_mixture(ternary_separation(3, walls=True)),
             dict(cube, G22=-0.3))):
        step_name, rho_name, rho_err, err = sc_compare(name, sim_cls, **cfg)
        note(rho_name, rho_err)
        note(step_name, err)
    for name, sim_cls, cfg, tile in SC3_RAGGED:
        step_name, rho_name, rho_err, err = sc_compare(name, sim_cls,
                                                       tile=tile, **cfg)
        note(rho_name, rho_err)
        note(step_name, err)
    sc_refusals()
    # the single-component Shan-Chen and shallow-water modes, 20 steps
    for name, sim_cls, cfg in SINGLE_MODE_CASES:
        step_name, rho_name, err, rho_err = single_mode_compare(
            name, sim_cls, **cfg)
        note(step_name, err)
        if rho_name:
            note(rho_name, rho_err)
    single_mode_refusals()
    # --precision=mixed: the int16 kernel against its plain version in
    # codes, 200 steps; every code through its conversions; the shear wave;
    # what the mode refuses
    phase_done('kernel comparisons (fp32 and mixtures)')
    build_report()
    phase_done('builds')
    for name, sim_cls, cfg, it0 in MIXED_CASES:
        key, err = mixed_compare(name, sim_cls, it0, **cfg)
        note(key, err)
    mixed_round_trip()
    mixed_shear_wave()
    mixed_refusals()
    phase_done('kernel comparisons (mixed)')
    # the ELBM mode: smooth states, the Newton branch, the cavities' own
    # start, each force model and the wall rows; then on int16 state
    for name, sim_cls, cfg, state in ELBM_CASES:
        key, err = elbm_compare(name, sim_cls, cfg, state)
        note(key, err)
    for name, sim_cls, cfg in ELBM_MIXED_CASES:
        key, err = elbm_mixed_compare(name, sim_cls, cfg)
        note(key, err)
    phase_done('kernel comparisons (ELBM)')
    # the D3Q15 / D3Q27 library: every instantiation class, 200 steps at
    # 64^3, on the lid cavity (no wall rows) and on a half-way or TMS box
    for grid_name in ls.OTHER_LATTICES:
        for incompressible in (False, True):
            for force_model in (None,) + FORCE_MODELS:
                for wall in (None, 'tms' if incompressible else 'halfbb'):
                    key, err = lattice_compare(grid_name, wall, force_model,
                                               incompressible)
                    note(key, err)
    # device hooks: the int16 state across the splits; hook state through
    # a checkpoint
    mixed_hook_bitwise()
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint_continues(tmp)
    phase_done('kernel comparisons (D3Q15 / D3Q27, hooks)')
    # the outflow rows: each kernel-borne type in 3D and 2D, the outlet
    # normal to x or to z / y and the force models in turns; the refusals
    for k, kind in enumerate(KERNEL_OUTFLOW_KINDS):
        for dim in (3, 2):
            axis = ('x', 'z' if dim == 3 else 'y')[k % 2]
            force_model = ((None,) + FORCE_MODELS)[(k + dim) % 4]
            key, err, lam_err = outflow_compare(kind, dim, axis,
                                                force_model)
            note(key, err)
            if lam_err is not None:
                note(f'laminarize_mean_{key.rsplit("_", 1)[1]}', lam_err)
    outflow_refusals()
    phase_done('kernel comparisons (outflow)')
    # the ghost-plane mode and its exchange against their plain versions;
    # one scene per mode class over 2 shards, the unsharded run's bits
    for name, scene, sim_cls, size in (
            ('lbm_step_ghost_d3q19', 'ldc_3d', LDC_3D, (128, 128, 128)),
            ('lbm_step_ghost_d2q9', 'ldc_2d', LDC_2D, (1024, 1024))):
        err, x_err = ghost_mode_check(scene, sim_cls, size)
        note(name, err)
        note(name.replace('lbm_step_ghost', 'halo_exchange'), x_err)
    for name, (sim_cls, cfg) in MESH_BITWISE.items():
        mesh_bitwise(name, sim_cls, cfg)
    # the Shan-Chen and free-energy ghost modes and both exchanges
    for name, (sim_cls, cfg) in MESH_MULTI_CASES.items():
        for key, err in mesh_multi_compare(name, sim_cls, cfg).items():
            note(key, err)
    phase_done('kernel comparisons (mesh)')
    # two axes: the edge mode of both exchanges against its plain version;
    # every mode class over 2x2 shards, the unsharded run's bits
    for label, (sim_cls, cfg) in EDGE_CASES.items():
        for mesh in EDGE_MESHES[3 if 'lat_nz' in cfg else 2]:
            xname, x_err, rname, r_err = edge_exchange_check(
                label, sim_cls, cfg, mesh)
            note(xname, x_err)
            note(rname, r_err)
    for name, (sim_cls, cfg) in MESH_BITWISE.items():
        mesh_bitwise(name, sim_cls, cfg, mesh=MESH2)
    for name, (sim_cls, cfg) in MESH_MULTI_CASES.items():
        for key, err in mesh_multi_compare(name, sim_cls,
                                           MESH2_SIZES.get(name, cfg),
                                           mesh=MESH2).items():
            note(key, err)
    phase_done('kernel comparisons (two-axis meshes)')
    # the outflow family on one- and two-axis meshes, with and without a
    # Guo force: every type along a sharded and an unsharded axis
    for kind in KERNEL_OUTFLOW_KINDS:
        for where in sorted(OUTFLOW_MESH):
            for force_model in (None, 'guo'):
                outflow_mesh_compare(kind, where, force_model)
    phase_done('kernel comparisons (outflow on meshes)')
    fe_cube = dict(lat_nx=128, lat_ny=128, lat_nz=128)
    for name, scene, cfg in (
            ('fe_separation_2d', 'fe_separation_2d',
             dict(lat_nx=1024, lat_ny=1024)),
            ('fe_separation_3d', 'fe_separation_3d', fe_cube),
            ('fe_separation_3d_mrt', 'fe_separation_3d',
             dict(fe_cube, model='mrt', tau_a=3.0, tau_b=0.8)),
            ('fe_poiseuille_2d_wetting', 'fe_poiseuille_2d',
             dict(lat_nx=1024, lat_ny=512, bc_wall_grad_phase=0.05)),
            ('fe_viscous_fingering', 'fe_viscous_fingering',
             dict(lat_nx=320, lat_ny=101, lat_nz=37)),
            ('binary_microchannel', 'binary_microchannel', dict(H=51))):
        grid, phi_err, err = fe_compare(name, FE[scene], **cfg)
        note(f'rho_poststream_{grid.lower()}', phi_err)
        note(f'fe_step_{grid.lower()}', err)
    golden('ldc_3d', LDC_3D, lat_nx=16, lat_ny=16, lat_nz=16)
    golden('ldc_2d', LDC_2D, lat_nx=32, lat_ny=32)
    golden('sc_separation_2d', SEP_2D, 'binary_fluid_sc_separation_2d',
           lat_nx=32, lat_ny=32)
    golden('sc_separation_3d', SEP_3D, 'binary_fluid_sc_separation_3d',
           lat_nx=16, lat_ny=16, lat_nz=16)
    golden('sc_separation_3d_walls', SEP_3D_WALLS,
           'binary_fluid_sc_separation_3d_walls', lat_nx=24, lat_ny=24,
           lat_nz=24)
    for scene in FE_SCENES:
        golden(scene, FE[scene], f'binary_fluid_{scene}',
               **FE_GOLDEN_FLAGS[scene])
    # the force-driven twins on the forced kernel, the periodic vortex on
    # the unforced one; a per-node force and a forced mixture are refused
    # by the kernels by name and run on the torch engine on the card
    for scene in FORCED_SCENES + ('taylor_green_2d',):
        golden(scene, twin(scene), **SINGLE_GOLDEN_FLAGS[scene])
    golden('four_rolls_mill', twin('four_rolls_mill'), engine='torch',
           **SINGLE_GOLDEN_FLAGS['four_rolls_mill'])
    # the immersed-boundary step runs on the torch engine: the kernels
    # refuse it by name, as the JAX runner keeps it off its fused kernels
    golden('ibm_cylinder', twin('ibm_cylinder'), engine='torch',
           **SINGLE_GOLDEN_FLAGS['ibm_cylinder'])
    # half-way walls, time-only densities and forces, a space- and
    # time-dependent inlet: all on the kernel engine
    for scene in WALL_DYNAMIC_SCENES:
        golden(scene, twin(scene), **SINGLE_GOLDEN_FLAGS[scene])
    # the forced mixtures on the forced mixture kernel; half-way walls in a
    # mixture are refused by the kernels by name and run on the torch
    # engine on the card
    for scene in SC_MORE_SCENES:
        golden(scene, binary_twin(scene), f'binary_fluid_{scene}',
               engine='torch' if scene in SC_HALFWAY_SCENES else 'kernel',
               **SC_MORE_GOLDEN_FLAGS[scene])
    golden('ternary_sc_drop_2d', DROP_3, 'ternary_fluid_sc_drop_2d',
           **TERNARY_GOLDEN_FLAGS['sc_drop_2d'])
    # single-component Shan-Chen (pre-pass + the sc mode) and shallow water
    for scene in SC_SINGLE_SCENES + SHALLOW_WATER_SCENES:
        golden(scene, twin(scene), **SINGLE_GOLDEN_FLAGS[scene])
    # the scenes with device hooks: the Kida vortex (D3Q15), the channel
    # (TMS walls) and the MRT cavity on the kernel engine; the channel
    # around a cube (a composite step) and the free-energy capillary wave
    # (half-way walls) on the torch engine, which the kernels refuse by name
    for scene in ('kida_vortex', 'channel_flow'):
        golden(scene, turbulence_twin(scene), f'turbulence_{scene}',
               **TURBULENCE_GOLDEN_FLAGS[scene])
    # at tau = 0.5005 two correct fp32 engines carry their ulps up to 1e-6
    # apart in the velocity within 20 steps (9.5e-7 in vz on the CPU,
    # tests/test_torch_stats.py; 5.9e-7 in vx on the card)
    golden('channel_cube', turbulence_twin('channel_cube'),
           'turbulence_channel_cube', engine='torch',
           atol=dict.fromkeys(('vx', 'vy', 'vz'), 1e-6),
           **TURBULENCE_GOLDEN_FLAGS['channel_cube'])
    golden('ldc_2d_unorm', twin('ldc_2d_unorm'),
           **SINGLE_GOLDEN_FLAGS['ldc_2d_unorm'])
    golden('fe_capillary_wave_2d', binary_twin('fe_capillary_wave_2d'),
           'binary_fluid_fe_capillary_wave_2d', engine='torch',
           **FE_HALFWAY_GOLDEN_FLAGS['fe_capillary_wave_2d'])

    phase_done('goldens')
    copy_bw = copy_bandwidth()
    say(f'device-to-device copy bandwidth (1 GiB): {copy_bw / 1e9:.1f} GB/s')
    results = {}
    for scene, sim_cls, size in (('ldc_3d', LDC_3D, (256, 256, 256)),
                                 ('ldc_2d', LDC_2D, (4096, 4096))):
        grid, res = main_path(scene, sim_cls, size, copy_bw,
                              timed='collision')
        results[f'lbm_step_{grid.lower()}'] = res
    for scene, size in FORCED_MAIN.items():
        grid, res = main_path(scene, twin(scene), size, copy_bw,
                              accel=FORCED_ACCEL, timed='force')
        results[f'lbm_step_force_{grid.lower()}'] = res
        ldc = results[f'lbm_step_{grid.lower()}']
        say(f'{scene}: {res["mlups"]:.1f} MLUPS against {ldc["mlups"]:.1f} '
            f'on the lid-driven cavity of the same size: '
            f'{res["mlups"] / ldc["mlups"]:.4f} of it; {res["ms"]:.4f} '
            f'against {ldc["ms"]:.4f} ms per launch')
    for path, (scene, size, flags, accel, kind) in COLLISION_MAIN.items():
        grid, res = main_path(path, twin(scene), size, copy_bw, accel=accel,
                              flags=flags, kind=kind)
        results[f'lbm_step_{kind}{grid.lower()}'] = res
        ref = results[f'lbm_step_{"force_" if accel else ""}{grid.lower()}']
        say(f'{path}: {res["mlups"]:.1f} MLUPS, {res["ms"]:.4f} ms per '
            f'launch against {ref["mlups"]:.1f} MLUPS, {ref["ms"]:.4f} ms of '
            f'the BGK main path on the same geometry: '
            f'{res["ms"] / ref["ms"]:.4f}')
    channel_ms = {}
    for scene in CHANNELS:
        grid, res = channel_main_path(scene, copy_bw)
        channel_ms[scene] = res['ms']
        ldc = results[f'lbm_step_{grid.lower()}']['mlups']
        say(f'{scene}: {res["mlups"]:.1f} MLUPS against {ldc:.1f} on the '
            f'lid-driven cavity of the same size: '
            f'{res["mlups"] / ldc - 1.0:+.4f}')
        name = f'lbm_step_vary_{grid.lower()}'
        if name in results:
            # the x-normal channel: launches of both main paths; the time
            # and bound of the z- / y-normal one stay in the JSON line
            res = dict(results[name], x_normal_ms=res['ms'],
                       launches=results[name]['launches'] + res['launches'],
                       err=max(results[name]['err'], res['err']))
        results[name] = res
    for scene in SLICE_MAIN:
        res = slice_main_path(scene, copy_bw)
        grid = 'd2q9' if scene == 'poiseuille_sa' else 'd3q19'
        name = 'lbm_step_wall_d3q19' if scene == 'duct_flow' else \
            f'lbm_step_dyn_{grid}'
        results[name] = res
        ref = results[f'lbm_step_{"force_" if scene == "duct_flow" else ""}'
                      f'{grid}']
        say(f'{scene}: {res["mlups"]:.1f} MLUPS, {res["ms"]:.4f} ms per '
            f'launch against {ref["mlups"]:.1f} MLUPS, {ref["ms"]:.4f} ms '
            f'on {"sphere_3d (forced)" if scene == "duct_flow" else "the "
                  "lid-driven cavity"} of the same size: '
            f'{res["ms"] / ref["ms"]:.4f}')
    for dim in (3, 2):
        # a face normal to x puts one BC node at each end of every x-row,
        # so one warp in four (3D) runs the BC chain with a single lane
        along, across = (channel_ms[f'parabolic_inlet_{a}{dim}d']
                         for a in ('x_', ''))
        say(f'x-normal over {"z" if dim == 3 else "y"}-normal step, '
            f'{dim}D: {along:.4f} / {across:.4f} ms = {along / across:.4f}')
    phase_done('single-fluid main paths (fp32)')
    for path, (scene, size) in MIXED_MAIN.items():
        grid = 'd3q19' if len(size) == 3 else 'd2q9'
        fp32 = results[f'lbm_step_{grid}']
        key, res = mixed_main_path(path, scene, size, copy_bw, fp32)
        results[key] = res
        say(f'{path}: {res["mlups"]:.1f} MLUPS against {fp32["mlups"]:.1f} '
            f'on the fp32 main path of the same size: '
            f'{res["mlups"] / fp32["mlups"]:.4f} of it')
    for path in ELBM_MAIN:
        row, res = elbm_main_path(path, copy_bw)
        results[row] = res
        note(row, res['err'])
    phase_done('single-fluid main paths')
    # D3Q15 and D3Q27: the Kida vortex with its hook, bench.py's cavity on
    # D3Q27; the channel's Reynolds statistics on the D3Q19 forced kernel
    results['lbm_step_d3q15'] = kida_main_path(copy_bw)
    _grid, results['lbm_step_d3q27'] = main_path(
        'ldc_3d_d3q27', LDC_3D, (256, 256, 256), copy_bw, chunks=2,
        flags=dict(grid='D3Q27'))
    for name in ('lbm_step_d3q15', 'lbm_step_d3q27'):
        res, bgk = results[name], results['lbm_step_d3q19']
        say(f'{name}: {res["mlups"]:.1f} MLUPS, {res["ms"]:.4f} ms per '
            f'launch against D3Q19\'s {bgk["mlups"]:.1f} MLUPS, '
            f'{bgk["ms"]:.4f} ms on the cavity of the same size')
    channel = channel_flow_main_path(copy_bw)
    phase_done('D3Q15 / D3Q27 and hooked main paths')
    flat_open = {}
    for path, (dim, size) in OPEN_MAIN.items():
        name, res, flat_open[path] = open_main_path(path, dim, size, copy_bw)
        results[name] = res
    results['laminarize_mean_d2q9'] = laminarize_main_path()
    phase_done('outflow main paths')
    # the same paths on --mesh=1 and --mesh=1x1, 2x2 on the card; the
    # laminarize channel on 1x1 and 2x2
    mesh_exchanges = {}
    for path, (dim, size) in OPEN_MAIN.items():
        name, row, xcounts = open_mesh_main_path(
            OPEN_MESH_NAMES[path], dim, size, flat_open.pop(path))
        merge_rows(results, {name: row})
        for k, v in xcounts.items():
            mesh_exchanges[k] = mesh_exchanges.get(k, 0) + v
    rows, xcounts = laminarize_mesh_main_path()
    merge_rows(results, rows)
    for k, v in xcounts.items():
        mesh_exchanges[k] = mesh_exchanges.get(k, 0) + v
    phase_done('outflow mesh main paths')
    for path, (sim_cls, size) in MESH_MAIN.items():
        row, xrow = mesh_main_path(path, sim_cls, size, copy_bw)
        g = 'd3q19' if len(size) == 3 else 'd2q9'
        flat = results[f'lbm_step_{g}']
        say(f'{path}: {row["mlups"]:.1f} MLUPS against {flat["mlups"]:.1f} '
            f'on the unsharded main path ({row["mlups"] / flat["mlups"]:.4f}'
            f'); in turns {row["mesh_over_unsharded"]:.4f}; exchange '
            f'{row["exchange_ms"]:.5f} ms per step, '
            f'{row["exchange_ms"] / row["ms"]:.4f} of a step')
        results[f'lbm_step_ghost_{g}'] = row
        results[f'halo_exchange_{g}'] = xrow
    channel_mesh = channel_flow_mesh_path(copy_bw)
    results['lbm_step_ghost_wall_d3q19'] = channel_mesh
    results['halo_exchange_d3q19']['launches'] += channel_mesh['launches']
    phase_done('mesh main paths')
    for scene, (sim_cls, size, name, demix) in SC_MAIN.items():
        merge_rows(results, sc_main_path(scene, sim_cls, size, copy_bw,
                                         name, demix))
    for scene, (sim_cls, size, name) in SC_MODE_MAIN.items():
        merge_rows(results, sc_main_path(scene, sim_cls, size, copy_bw,
                                         name, chunk=250, chunks=2))
    for scene, (size, name) in SINGLE_MODE_MAIN.items():
        merge_rows(results, single_mode_main_path(scene, size, name,
                                                  copy_bw))
    for scene, size in (('fe_separation_3d', (256, 256, 256)),
                        ('fe_separation_2d', (4096, 4096))):
        # the pre-pass: launches of every main path; its time at the
        # Shan-Chen paths' K = 2 stays in the JSON line
        merge_rows(results, fe_main_path(scene, FE[scene], size, copy_bw))
    phase_done('main paths')
    for path, (sim_cls, size) in MESH_MULTI_MAIN.items():
        rows = mesh_multi_main_path(path, sim_cls, size, copy_bw)
        step = next(k for k in rows if k.startswith(('sc_multi', 'fe_step',
                                                      'lbm_step')))
        flat = results[step.replace('ghost_', '', 1)]
        say(f'{path}: {rows[step]["mlups"]:.1f} MLUPS against '
            f'{flat["mlups"]:.1f} on the unsharded main path '
            f'({rows[step]["mlups"] / flat["mlups"]:.4f}); in turns '
            f'{rows[step]["mesh_over_unsharded"]:.4f}')
        merge_rows(results, rows)
    phase_done('Shan-Chen and free-energy mesh main paths')
    for path, (sim_cls, size, flags) in MESH2_MAIN.items():
        rows, summary = mesh2_main_path(path, sim_cls, size, flags)
        merge_rows(results, rows)
        step = next(n for n in rows if n.startswith(('sc_multi', 'fe_step',
                                                     'lbm_step')))
        results[step].setdefault('two_axis', {})[path] = summary
        for name in rows:
            if 'edge_' in name:
                results[name].setdefault('paths', []).append(path)
    phase_done('two-axis mesh main paths')
    ibm_card_against_cpu()
    ibm_main_path()
    phase_done('IBM main path')
    # the tracers and the visualization on the kernel's main path: their
    # lbm_step launches join the cavity's row
    tracer_launches, _tracer_ms = tracer_main_path()
    vis_launches, _frame_ms = visualization_main_path()
    slice_launches = slice_server_main_path()
    results['lbm_step_d3q19']['launches'] += \
        tracer_launches + vis_launches + slice_launches
    phase_done('tracer and visualization main paths')
    fe_mrt_time()
    fe_demix()
    # chunks of about a second of the plain engine each
    plain_path('ldc_3d', LDC_3D, (128, 128, 128), chunk=100)
    plain_path('ldc_3d', LDC_3D, (256, 256, 256), chunk=20)
    plain_path('ldc_2d', LDC_2D, (4096, 4096), chunk=40)
    plain_path('sc_separation_3d', SEP_3D, (128, 128, 128), chunk=50)
    plain_path('sc_separation_3d', SEP_3D, (256, 256, 256), chunk=10)
    plain_path('sc_separation_2d', SEP_2D, (4096, 4096), chunk=20)
    plain_path('fe_separation_3d', FE['fe_separation_3d'], (256, 256, 256),
               chunk=10)
    plain_path('fe_separation_2d', FE['fe_separation_2d'], (4096, 4096),
               chunk=20)

    phase_done('plain paths')
    # the exchanges of the outflow mesh paths
    for xname, launches in mesh_exchanges.items():
        results[xname]['launches'] += launches
    empty_ms = empty_launch_ms()
    say(f'empty kernel launch: {empty_ms:.5f} ms per launch (2000 '
        'back-to-back launches of one empty block, CUDA events): no '
        'kernel in a stream of launches takes less, whatever its bound')
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        res = results[name]
        assert res['launches'] > 0, name
        note(name, res['err'])
        nodes = res.get('nodes', 4096 ** 2 if 'd2q9' in name else 256 ** 3)
        bound, bound_by = bound_ms(name, nodes, res.get('extra_bytes', 0))
        say(f'kernel {name}: {res["ms"]:.4f} ms against a bound of '
            f'{bound:.4f} ms ({bound_by}): {bound / res["ms"]:.3f} of it')
        kernels.append(dict(name=name, route='cuda', source=CSRC + src,
                            replaces=replaces, launches=res['launches'],
                            max_abs_err=errs[name], ms=res['ms'],
                            plain_ms=res['plain_ms'], bound_ms=bound,
                            bound_by=bound_by, library_ms=None))
        for key in ('x_normal_ms', 'models_ms', 'collision_ms', 'step_ms',
                    'dynamic_share', 'unforced_ms', 'mlups', 'fp32_ms',
                    'mixed_over_fp32', 'convert_ms', 'bgk_ms',
                    'elbm_over_bgk', 'newton_share', 'hooked_ms',
                    'unhooked_ms', 'hook_share', 'idle_share', 'drag',
                    'force_object_ms', 'step_with_prepass_ms',
                    'unsharded_ms', 'mesh_mlups', 'unsharded_mlups',
                    'mesh_over_unsharded', 'exchange_ms',
                    'exchange_call_ms', 'shards', 'two_axis', 'one_axis_ms',
                    'paths'):
            if key in res:
                kernels[-1][key] = res[key]
        if name in MODES:
            kernels[-1]['mode'] = MODES[name]
    say(f'channel_flow (lbm_step_force_d3q19, 240x82x80): '
        f'{channel["mlups"]:.1f} MLUPS, {channel["ms"]:.4f} ms per launch, '
        f'hook share {channel["hook_share"]:.4f}')
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
