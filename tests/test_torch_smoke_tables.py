"""The tables of ``chip_smoke.py``, checked without a card.

``chip_smoke.py`` prints one JSON row per kernel of ``KERNELS`` with its
bound (``bound_ms``, from ``NODE_BYTES`` and ``NODE_OPS``) and, where one
TPU kernel has several rows, the mode a row stands for (``MODES``). A row
missing from one of those tables, or a main path whose row is not a kernel
of the table, fails only at the end of a chip run; these tests find it on
the CPU. Importing ``chip_smoke`` needs no card: it decides nothing about
the device until ``main`` runs.
"""

import ast
import collections
import importlib.util
import math
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_tables', os.path.join(REPO, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load_smoke()


def _nodes(name):
    """The main paths' node count of a row, as ``chip_smoke.main`` takes
    it: 256^3 for D3Q19, 4096^2 for D2Q9."""
    return 256 ** 3 if 'd3q19' in name else 4096 ** 2


@pytest.mark.parametrize('name', sorted(smoke.KERNELS))
def test_every_kernel_row_has_its_bytes_and_operations(name):
    assert name in smoke.NODE_BYTES
    assert name in smoke.NODE_OPS
    assert smoke.NODE_BYTES[name] > 0 and smoke.NODE_OPS[name] > 0


@pytest.mark.parametrize('name', sorted(smoke.KERNELS))
def test_every_kernel_row_has_a_finite_positive_bound(name):
    bound, bound_by = smoke.bound_ms(name, _nodes(name))
    assert math.isfinite(bound) and bound > 0
    assert bound_by in ('bytes', 'operations')


@pytest.mark.parametrize('name', sorted(smoke.KERNELS))
def test_every_kernel_row_names_its_source_and_tpu_kernel(name):
    """The row's source is a file of the port, and the TPU kernel it
    replaces is the ``def`` of a function of the JAX package that reaches
    ``pl.pallas_call``."""
    src, replaces = smoke.KERNELS[name]
    assert os.path.isfile(os.path.join(REPO, smoke.CSRC, src))
    path, line = replaces.split(':')
    text = open(os.path.join(REPO, path)).read()
    fn = next(node for node in ast.parse(text).body
              if isinstance(node, ast.FunctionDef)
              and node.lineno == int(line))
    assert 'pallas_call' in ast.get_source_segment(text, fn)


def test_no_table_has_a_row_outside_the_kernels():
    kernels = set(smoke.KERNELS)
    for table in (smoke.NODE_BYTES, smoke.NODE_OPS, smoke.MODES):
        assert set(table) <= kernels, sorted(set(table) - kernels)


def test_rows_of_one_tpu_kernel_name_their_modes():
    """Where several rows replace one TPU kernel, every row but its main
    mode's says which mode it stands for."""
    rows = collections.defaultdict(list)
    for name, (_src, replaces) in smoke.KERNELS.items():
        rows[replaces].append(name)
    for replaces, names in rows.items():
        unnamed = [n for n in names if n not in smoke.MODES]
        assert len(unnamed) <= 1, (replaces, unnamed)


@pytest.mark.parametrize('path', sorted(smoke.ELBM_MAIN))
def test_every_elbm_main_path_is_a_kernel_row(path):
    _sim, size, flags, row = smoke.ELBM_MAIN[path]
    assert row in smoke.KERNELS
    grid = 'd3q19' if len(size) == 3 else 'd2q9'
    mixed = flags.get('precision') == 'mixed'
    assert row == f'lbm_step_{"mixed_" if mixed else ""}elbm_{grid}'
    src = smoke.KERNELS[row][0]
    assert src == ('lbm_step_mixed_elbm.cu' if mixed else 'lbm_step_elbm.cu')


@pytest.mark.parametrize('path', sorted(smoke.MIXED_MAIN))
def test_every_mixed_main_path_is_a_kernel_row(path):
    _scene, size = smoke.MIXED_MAIN[path]
    grid = 'd3q19' if len(size) == 3 else 'd2q9'
    assert f'lbm_step_mixed_{grid}' in smoke.KERNELS


def test_every_lattice_has_an_elbm_main_path_in_each_storage():
    rows = {row for _sim, _size, _flags, row in smoke.ELBM_MAIN.values()}
    assert rows == {f'lbm_step_{s}elbm_{g}' for s in ('', 'mixed_')
                    for g in ('d2q9', 'd3q19')}


@pytest.mark.parametrize('grid,q,expect_ms', [('d3q19', 19, 0.3856),
                                              ('d2q9', 9, 0.1853)])
def test_int16_elbm_rows_are_bound_by_their_codes(grid, q, expect_ms):
    """An int16 ELBM step moves Q codes in, Q out and the mask byte, as the
    int16 BGK step does: 77 / 37 B per node, the bound of ``PERF.md``."""
    name = f'lbm_step_mixed_elbm_{grid}'
    assert smoke.NODE_BYTES[name] == 2 * q * 2 + 1 \
        == smoke.NODE_BYTES[f'lbm_step_mixed_{grid}']
    bound, bound_by = smoke.bound_ms(name, _nodes(name))
    assert bound_by == 'bytes'
    assert round(bound, 4) == expect_ms
