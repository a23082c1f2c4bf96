"""The port's ``converter.py`` against the JAX package's module: the same
coordinate maps (physical -> lattice, rounded and not, and back) and the
same unit systems (every property, with each member of a triple left for
the similarity to complete), on the same configurations."""

import numpy as np
import pytest

from sailfish_tpu import converter as jconv
from sailfish_tpu_torch import converter as tconv

#: voxelizer .config contracts: axis orders, boxes, sizes (z, y, x),
#: paddings and cuts
COORD_CONFIGS = [
    dict(axes='xyz', bounding_box=[(0.0, 1.0), (0.0, 0.5), (0.0, 0.25)],
         size=(34, 66, 130), padding=[1, 1, 1, 1, 1, 1]),
    dict(axes='zxy', bounding_box=[(-2.0, 3.0), (1.0, 4.0), (0.5, 1.5)],
         size=(40, 60, 90), padding=[2, 0, 0, 3, 1, 1],
         cuts=((1, 2), (0, 1), (3, 0))),
    dict(axes='yzx', bounding_box=[(0.1, 0.9), (-0.3, 0.3), (2.0, 2.2)],
         size=(21, 31, 41), padding=[0, 0, 0, 0, 0, 0]),
]


@pytest.mark.parametrize('config', COORD_CONFIGS)
def test_coordinate_converter(config):
    mine, ref = tconv.CoordinateConverter(config), \
        jconv.CoordinateConverter(config)
    rng = np.random.default_rng(7)
    lo = np.array([b[0] for b in config['bounding_box']])
    hi = np.array([b[1] for b in config['bounding_box']])
    for pos in lo + (hi - lo) * rng.random((20, 3)):
        assert mine.to_lb(pos) == ref.to_lb(pos)
        assert mine.to_lb(pos, round_=False) == ref.to_lb(pos, round_=False)
        lb = ref.to_lb(pos, round_=False)
        assert mine.from_lb(lb) == ref.from_lb(lb)
        np.testing.assert_allclose(mine.from_lb(lb), pos, rtol=1e-12,
                                   atol=1e-12)


#: (physical triple with one member left to Re, the lattice pair whose
#: third member the similarity completes)
UNIT_CASES = [
    (dict(visc=1e-6, length=0.1, velocity=0.5), dict(visc=0.01, length=64)),
    (dict(visc=1e-6, length=0.1, Re=1000.0, freq=2.0),
     dict(length=64, velocity=0.05)),
    (dict(length=0.02, velocity=1.0, Re=200.0), dict(velocity=0.05,
                                                    visc=0.02)),
    (dict(visc=1.5e-5, velocity=3.0, Re=500.0, freq=0.5),
     dict(length=128, velocity=0.02)),
]
PROPERTIES = ('Re', 'Re_lb', 'visc_lb', 'velocity_lb', 'len_lb', 'freq_lb',
              'dx', 'dt', 'info_lb')


@pytest.mark.parametrize('phys,lb', UNIT_CASES)
def test_unit_converter(phys, lb):
    mine, ref = tconv.UnitConverter(**phys), jconv.UnitConverter(**phys)
    mine.set_lb(**lb)
    ref.set_lb(**lb)
    for name in PROPERTIES:
        assert getattr(mine, name) == getattr(ref, name), name
    if phys.get('freq'):
        assert mine.Womersley == ref.Womersley
        assert mine.Womersley_lb == ref.Womersley_lb
    # back from lattice to physical units: dx and dt recover the
    # physical length, velocity and viscosity
    assert mine.len_lb * mine.dx == pytest.approx(ref._phys_len)
    assert mine.velocity_lb * mine.dx / mine.dt == \
        pytest.approx(ref._phys_vel)
    assert mine.visc_lb * mine.dx ** 2 / mine.dt == \
        pytest.approx(ref._phys_visc)


def test_lattice_viscosity_guard():
    """Both refuse a completed lattice viscosity above 1/6."""
    for mod in (tconv, jconv):
        conv = mod.UnitConverter(visc=1.0, length=1.0, velocity=1.0)
        with pytest.raises(AssertionError, match='viscosity too high'):
            conv.set_lb(length=10, velocity=0.1)
