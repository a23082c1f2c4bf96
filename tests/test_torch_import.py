"""The port stands alone: it imports torch and never jax, and nothing of
the JAX package ``sailfish_tpu``.

The import check runs in a subprocess: the pytest process has jax and the
JAX package imported already (tests/conftest.py). The port's own copies of
the JAX package's scene modules keep its node-type ids, lattice tables and
lazy parameter evaluators; the last tests hold them against the JAX
package's.
"""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sailfish_tpu import lattice as jlattice
from sailfish_tpu import node_type as jnt
from sailfish_tpu_torch import lattice
from sailfish_tpu_torch import node_type as nt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: scripts and test helpers that must run where jax is absent
JAX_FREE_SCRIPTS = ('chip_smoke.py', os.path.join('tests', 'torch_scenes.py'),
                    os.path.join('tests', 'test_torch_cuda.py'))


def _port_sources():
    files = [os.path.join(REPO, p) for p in JAX_FREE_SCRIPTS]
    for base in ('sailfish_tpu_torch', os.path.join('examples', 'torch'),
                 'tools'):
        for root, _dirs, names in os.walk(os.path.join(REPO, base)):
            files += [os.path.join(root, n) for n in names
                      if n.endswith('.py')]
    return files


def test_importing_the_port_leaves_jax_out():
    program = '\n'.join([
        'import importlib, importlib.util, pkgutil, sys',
        'import sailfish_tpu_torch',
        "names = ['sailfish_tpu_torch'] + [m.name for m in "
        "pkgutil.walk_packages(sailfish_tpu_torch.__path__, "
        "'sailfish_tpu_torch.')]",
        'for name in names:',
        '    importlib.import_module(name)',
        'for i, path in enumerate(sys.argv[1:]):',
        "    spec = importlib.util.spec_from_file_location(f'm{i}', path)",
        '    spec.loader.exec_module(importlib.util.module_from_spec(spec))',
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sailfish_tpu'))",
        'assert bad == [], bad',
        'print(len(names))',
    ])
    scripts = [p for p in _port_sources()
               if not p.startswith(os.path.join(REPO, 'sailfish_tpu_torch'))]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, 'tests')]))
    r = subprocess.run([sys.executable, '-c', program, *scripts],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 18


def test_no_jax_import_statements():
    pattern = re.compile(r'^\s*(import jax|from jax)', re.M)
    offenders = [p for p in _port_sources()
                 if pattern.search(open(p).read())]
    assert offenders == []


def test_scripts_reach_the_jax_package_only_through_the_port():
    """No file of the port -- the package, its examples, tools and scripts
    -- imports ``sailfish_tpu`` (the port keeps its own copies of the
    scene modules)."""
    pattern = re.compile(r'^\s*(from|import)\s+sailfish_tpu(?!_torch)\b',
                         re.M)
    offenders = [p for p in _port_sources()
                 if pattern.search(open(p).read())]
    assert offenders == []


def test_port_modules_are_packaged():
    import sailfish_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(
        sailfish_tpu_torch.__path__, 'sailfish_tpu_torch.')}
    assert {'sailfish_tpu_torch.ops.lbm_step', 'sailfish_tpu_torch.runner',
            'sailfish_tpu_torch.controller', 'sailfish_tpu_torch.ops.sc_multi',
            'sailfish_tpu_torch.ops.multigrid',
            'sailfish_tpu_torch.ops.fe_step',
            'sailfish_tpu_torch.models.base',
            'sailfish_tpu_torch.models.binary',
            'sailfish_tpu_torch.models.ternary',
            'sailfish_tpu_torch.ops.bc_patch', 'sailfish_tpu_torch.lattice',
            'sailfish_tpu_torch.geo', 'sailfish_tpu_torch.profile',
            'sailfish_tpu_torch.ops.mixed',
            'sailfish_tpu_torch.ops.entropic', 'sailfish_tpu_torch.stats',
            'sailfish_tpu_torch.data_processing',
            'sailfish_tpu_torch.converter',
            'sailfish_tpu_torch.parallel.mesh',
            'sailfish_tpu_torch.parallel.halo',
            'sailfish_tpu_torch.ops.ibm', 'sailfish_tpu_torch.tracers',
            'sailfish_tpu_torch.vis', 'sailfish_tpu_torch.vis_mpl',
            'sailfish_tpu_torch.vis_mixin'} <= names
    csrc = os.path.join(os.path.dirname(sailfish_tpu_torch.__file__), 'ops',
                        'csrc')
    # every source, and no other: a source without a wrapper would be
    # dead code (the patch kernel went when lbm_step took over its work)
    assert sorted(os.listdir(csrc)) == [
        'fe_step.cu', 'halo.cu', 'lattice_tables.cuh', 'lbm_common.cuh', 'lbm_step.cu',
        'lbm_step_elbm.cu', 'lbm_step_lattices.cu', 'lbm_step_les.cu',
        'lbm_step_mixed.cu',
        'lbm_step_mixed_elbm.cu', 'lbm_step_mixed_les.cu',
        'lbm_step_mixed_mrt.cu', 'lbm_step_mrt.cu', 'lbm_step_outflow.cu',
        'sc_multi.cu']


def test_package_data_carries_every_file_a_build_hashes():
    """setup.py's ``package_data`` patterns match every file
    ``ops/build.py`` reads for a build (each source and the headers
    beside it): an installed package can build its kernels."""
    import ast
    import fnmatch

    import sailfish_tpu_torch
    from sailfish_tpu_torch.ops import build
    tree = ast.parse(open(os.path.join(REPO, 'setup.py')).read())
    (call,) = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and getattr(n.func, 'id', '') == 'setup']
    (data,) = [ast.literal_eval(k.value) for k in call.keywords
               if k.arg == 'package_data']
    patterns = data['sailfish_tpu_torch']
    root = os.path.dirname(sailfish_tpu_torch.__file__)
    sources = sorted(build.CSRC.glob('*.cu'))
    assert len(sources) == 13
    files = {f for src in sources for f in build.hashed_files(src)}
    # a source that builds lbm_step.cu with another collision model hashes
    # it too
    assert build.CSRC / 'lbm_step.cu' in build.hashed_files(
        build.CSRC / 'lbm_step_mrt.cu')
    assert build.CSRC / 'lbm_step.cu' in build.hashed_files(
        build.CSRC / 'lbm_step_mixed_les.cu')
    assert build.CSRC / 'lbm_step.cu' in build.hashed_files(
        build.CSRC / 'lbm_step_outflow.cu')
    assert {f.suffix for f in files} == {'.cu', '.cuh'}
    for f in files:
        rel = os.path.relpath(f, root).replace(os.sep, '/')
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel


def test_a_started_build_is_finished_once(monkeypatch):
    """``build.start_all`` starts each source's compiler once; ``load`` then
    waits for that build only, and a later ``load_all`` starts none
    again."""
    from sailfish_tpu_torch.ops import build
    started, finished = [], []
    monkeypatch.setattr(build, '_loaded', {})
    monkeypatch.setattr(build, '_pending', {})
    monkeypatch.setattr(build, '_start_build',
                        lambda src: started.append(src.stem)
                        or (src.stem,))
    monkeypatch.setattr(build, '_finish_build',
                        lambda name: finished.append(name) or name.upper())
    build.start_all(['lbm_step', 'halo'])
    build.start_all(['halo'])
    assert started == ['lbm_step', 'halo'] and finished == []
    assert build.load('halo') == 'HALO' and finished == ['halo']
    assert build.load_all(['lbm_step', 'halo', 'fe_step']) == {
        'lbm_step': 'LBM_STEP', 'halo': 'HALO', 'fe_step': 'FE_STEP'}
    assert started == ['lbm_step', 'halo', 'fe_step']
    assert finished == ['halo', 'lbm_step', 'fe_step']


def test_binary_twins_are_checked():
    twins = {os.path.basename(p) for p in _port_sources()
             if os.sep + 'binary_fluid' + os.sep in p}
    assert twins == {'sc_separation_2d.py', 'sc_separation_3d.py',
                     'sc_separation_3d_walls.py', 'fe_separation_2d.py',
                     'fe_separation_3d.py', 'fe_poiseuille_2d.py',
                     'fe_viscous_fingering.py', 'binary_microchannel.py',
                     'sc_drop_2d.py', 'sc_laplace_2d.py',
                     'sc_rayleigh_taylor_2d.py', 'sc_capillary.py',
                     'sc_poiseuille_2d.py', 'sc_capillary_wave_2d.py',
                     'fe_capillary_wave_2d.py'}
    from torch_scenes import FE_HALFWAY_SCENES, binary_twin
    for scene, name in FE_HALFWAY_SCENES.items():
        assert binary_twin(scene).__name__ == name


def test_ternary_twins_are_checked():
    """Every ternary twin is registered with its sim class and the golden
    harness's flags (``torch_scenes.TERNARY_SCENES``)."""
    from torch_scenes import TERNARY_GOLDEN_FLAGS, TERNARY_SCENES, \
        ternary_twin
    top = os.path.join(REPO, 'examples', 'torch', 'ternary_fluid')
    twins = {n[:-3] for n in os.listdir(top) if n.endswith('.py')}
    assert twins == set(TERNARY_SCENES) == set(TERNARY_GOLDEN_FLAGS)
    for scene in TERNARY_SCENES:
        assert ternary_twin(scene).__name__ == TERNARY_SCENES[scene]


def test_single_fluid_twins_are_checked():
    """Every single-fluid twin is registered with its sim class and the
    golden harness's flags (``torch_scenes.SINGLE_SCENES``)."""
    from torch_scenes import SINGLE_GOLDEN_FLAGS, SINGLE_SCENES, twin
    top = os.path.join(REPO, 'examples', 'torch')
    twins = {n[:-3] for n in os.listdir(top) if n.endswith('.py')}
    assert twins == set(SINGLE_SCENES) == set(SINGLE_GOLDEN_FLAGS)
    for scene in SINGLE_SCENES:
        assert twin(scene).__name__ == SINGLE_SCENES[scene]


def test_turbulence_twins_are_checked():
    """Every turbulence twin is registered with its sim class and the
    golden harness's flags (``torch_scenes.TURBULENCE_SCENES``)."""
    from torch_scenes import (TURBULENCE_GOLDEN_FLAGS, TURBULENCE_SCENES,
                              turbulence_twin)
    top = os.path.join(REPO, 'examples', 'torch', 'turbulence')
    twins = {n[:-3] for n in os.listdir(top) if n.endswith('.py')}
    assert twins == set(TURBULENCE_SCENES) == set(TURBULENCE_GOLDEN_FLAGS)
    for scene in TURBULENCE_SCENES:
        assert turbulence_twin(scene).__name__ == TURBULENCE_SCENES[scene]


def test_node_type_ids_match_the_jax_package():
    """Node-type ids are part of the checkpoint format: the port's copy
    registers the same classes under the same ids."""
    ours = {i: c.__name__ for i, c in nt._NODE_TYPES.items()}
    theirs = {i: c.__name__ for i, c in jnt._NODE_TYPES.items()}
    assert ours == theirs
    for i, c in nt._NODE_TYPES.items():
        j = jnt.get_node_type(i)
        for attr in ('wet_node', 'excluded', 'propagation_only',
                     'needs_orientation', 'link_tags', 'param_names'):
            assert getattr(c, attr) == getattr(j, attr), (c, attr)


@pytest.mark.parametrize('name', sorted(jlattice.KNOWN_GRIDS))
def test_lattice_tables_match_the_jax_package(name):
    g, j = lattice.get_grid(name), jlattice.get_grid(name)
    assert g.name == j.name and (g.dim, g.Q) == (j.dim, j.Q)
    np.testing.assert_array_equal(g.basis, j.basis)
    np.testing.assert_array_equal(g.weights, j.weights)
    np.testing.assert_array_equal(g.opposite, j.opposite)
    np.testing.assert_array_equal(g.orientation_vectors,
                                  j.orientation_vectors)
    for n in g.orientation_vectors:
        np.testing.assert_array_equal(g.unknown_mask(n), j.unknown_mask(n))


def test_spatial_array_matches_the_jax_package():
    rng = np.random.default_rng(5)
    hz, hy, hx = np.mgrid[0:3, 0:4, 0:5]
    for values, index in ((rng.random((3, 4, 5)), 'x'),
                          (rng.random((4, 5)), 'x'),
                          (rng.random(4), 'y'), (rng.random(3), 'z')):
        ours = nt.SpatialArray(values, index=index)
        theirs = jnt.SpatialArray(values, index=index)
        args = (2, hx, hy, hz) if ours._dyn_arity == 4 else (2, hx, hy)
        got = ours(*args)
        assert isinstance(got, torch.Tensor)
        # the JAX evaluators run in fp32, the port's in fp64
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs(*args)),
                                   rtol=1e-7)
        ramp = (lambda t: 0.5 * t)
        np.testing.assert_allclose(np.asarray((ours * ramp)(*args)),
                                   np.asarray((theirs * ramp)(*args)),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray((1.0 - ours)(*args)),
                                   np.asarray((1.0 - theirs)(*args)),
                                   rtol=1e-6, atol=1e-7)


def test_time_series_matches_the_jax_package():
    data = np.array([0.0, 1.0, 4.0, 2.0])
    ours = nt.LinearlyInterpolatedTimeSeries(data, step_size=3)
    theirs = jnt.LinearlyInterpolatedTimeSeries(data, step_size=3)
    for t in (0, 1, 2.5, 7, 11, 12, 13.5):
        (fo,), (fj,) = tuple(ours), tuple(theirs)
        np.testing.assert_allclose(float(fo(t)), float(fj(t)), rtol=1e-6)
