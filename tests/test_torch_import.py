"""The port imports torch and never jax.

The check runs in a subprocess: this test session has jax imported
already (tests/conftest.py).
"""

import os
import pkgutil
import re
import subprocess
import sys

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
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))",
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
    """Outside ``sailfish_tpu_torch`` itself, the port's scripts import the
    shared numpy-only modules (node types, geometry) from the port's
    re-exports, never from ``sailfish_tpu``."""
    pattern = re.compile(r'^\s*(from|import)\s+sailfish_tpu(?!_torch)\b',
                         re.M)
    port = os.path.join(REPO, 'sailfish_tpu_torch')
    offenders = [p for p in _port_sources() if not p.startswith(port)
                 and pattern.search(open(p).read())]
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
            'sailfish_tpu_torch.models.binary'} <= names
    for src in ('lbm_step.cu', 'sc_multi.cu', 'fe_step.cu'):
        assert os.path.exists(os.path.join(
            os.path.dirname(sailfish_tpu_torch.__file__), 'ops', 'csrc', src))


def test_binary_twins_are_checked():
    twins = {os.path.basename(p) for p in _port_sources()
             if os.sep + 'binary_fluid' + os.sep in p}
    assert twins == {'sc_separation_2d.py', 'sc_separation_3d.py',
                     'sc_separation_3d_walls.py', 'fe_separation_2d.py',
                     'fe_separation_3d.py', 'fe_poiseuille_2d.py',
                     'fe_viscous_fingering.py', 'binary_microchannel.py'}
