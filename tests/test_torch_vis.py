"""The port's visualization (``sailfish_tpu_torch/vis.py``, ``vis_mpl.py``,
``vis_mixin.py``) on the CPU.

* The engine registry, and the unknown-engine error (the JAX package's
  message).
* ``--mode=visualization`` writes one frame per output event under the
  JAX package's file names, and the fields the engine is given are within
  1e-6 of those the JAX package gives its engine.
* A live ``Vis2DSliceMixIn`` run with a subscriber on 127.0.0.1: a request
  with a wrong token is refused and changes nothing, one with the token
  moves the slice (``axis``, ``position``, ``field``), and the slices
  received equal the host fields' slices bit for bit, unsharded and on
  ``--mesh=2`` (the gathered fields). Every wait has a timeout of at most
  ``torch_scenes.SLICE_TIMEOUT_MS`` (5 s).
* ``utils/visualizer.py``'s client decodes what the server publishes.
"""

import copy
import importlib.util
import os
import zlib

import numpy as np
import pytest
import torch
import zmq

from sailfish_tpu import vis as jvis
from sailfish_tpu.controller import \
    LBSimulationController as JaxController
from sailfish_tpu_torch import vis
from sailfish_tpu_torch.vis_mixin import VisConfig, parse_slice, \
    slice_header
from torch_scenes import (REPO, SLICE_TIMEOUT_MS, load_example, run, twin,
                          with_slice_subscriber)

torch.set_num_threads(1)


def test_engine_registry_and_unknown_engine():
    from sailfish_tpu_torch.vis_mpl import MatplotlibVis
    assert vis.engine_by_name('mpl') is MatplotlibVis
    with pytest.raises(ValueError) as ours:
        vis.engine_by_name('pygame')
    with pytest.raises(ValueError) as theirs:
        jvis.engine_by_name('pygame')
    assert str(ours.value) == str(theirs.value)


def _spy(base):
    """An engine class of ``base`` (either package's FluidVis) keeping a
    copy of the fields it is given at each update."""

    class Spy(base):
        name = 'spy'
        seen = []

        def update(self, iteration):
            Spy.seen.append((iteration, copy.deepcopy(self.fields_fn())))

    return Spy


CFG = dict(lat_nx=32, lat_ny=32, max_iters=20, every=10,
           mode='visualization', platform='cpu')


def test_visualization_mode_frames_and_fields(tmp_path, monkeypatch):
    ours = _spy(vis.FluidVis)
    theirs = _spy(jvis.FluidVis)
    monkeypatch.setitem(vis._ENGINES, 'spy', ours)
    monkeypatch.setitem(jvis._ENGINES, 'spy', theirs)
    run(twin('ldc_2d'), vis_engine='spy', **CFG)
    jax_sim = load_example('ldc_2d.py', 'jax_ldc_2d').LDCSim
    JaxController(jax_sim, default_config=dict(
        vis_engine='spy', quiet=True, **CFG)).run(ignore_cmdline=True)
    assert [it for it, _ in ours.seen] == [it for it, _ in theirs.seen] \
        == [10, 20]
    for (_, got), (_, ref) in zip(ours.seen, theirs.seen):
        assert sorted(got) == sorted(ref) == ['rho', 'v']
        assert np.abs(got['rho'] - ref['rho']).max() <= 1e-6
        for a, b in zip(got['v'], ref['v']):
            assert np.abs(a - b).max() <= 1e-6
    # the matplotlib engine: one frame per output event, JAX's names
    names = {}
    for who, ctrl in (('port', run), ('jax', None)):
        out = str(tmp_path / who / 'out')
        if ctrl is None:
            JaxController(jax_sim, default_config=dict(
                output=out, quiet=True, **CFG)).run(ignore_cmdline=True)
        else:
            r = run(twin('ldc_2d'), output=out, **CFG)
            assert r.vis is not None
        names[who] = sorted(os.listdir(out + '_frames'))
    assert names['port'] == names['jax'] == ['frame_0000010.png',
                                             'frame_0000020.png']
    assert os.path.getsize(str(tmp_path / 'port' / 'out_frames' /
                               'frame_0000020.png')) > 1000


def _wait(sock, what):
    if not sock.poll(SLICE_TIMEOUT_MS, zmq.POLLIN):
        raise TimeoutError(f'{what}: nothing within {SLICE_TIMEOUT_MS} ms')


@pytest.mark.parametrize('mesh', ['', '2'])
def test_slice_server_live(mesh):
    """At 100 a request with a wrong token (refused), at 200 one with the
    token (axis z, position 5, field vx); slices at 100, 200, 300."""
    replies = []

    class Sim(with_slice_subscriber(twin('ldc_3d'))):
        def after_step(self, runner):
            super().after_step(runner)
            if self.iteration == 100:
                self.req = self._ctx.socket(zmq.REQ)
                self.req.setsockopt(zmq.LINGER, 0)
                self.req.connect(f'tcp://127.0.0.1:{self._ctrl_port}')
                self.req.send_json({'token': 'wrong', 'axis': 1})
            elif self.iteration == 200:
                _wait(self.req, 'the refusal')
                replies.append(self.req.recv_json())
                self.req.send_json({'token': self._authtoken, 'axis': 2,
                                    'position': 5, 'field': 1})
            else:
                _wait(self.req, 'the ack')
                replies.append(self.req.recv_json())
                return
            # the request is at the server before its after_step polls
            _wait(self._ctrl_sock, 'the request')

    r = run(Sim, platform='cpu', lat_nx=16, lat_ny=16, lat_nz=16,
            max_iters=300, every=100, mesh=mesh)
    sim = r.sim
    try:
        got = [next(sim.subscriber) for _ in range(3)]
    finally:
        sim.subscriber.close()
        sim.req.close()
        sim.close_slice_server()
    assert replies == [{'ack': False}, {'ack': True}]
    assert [(m['iteration'], m['axis'], m['position'], m['field'])
            for m, _ in got] == [(100, 0, 0, 'rho'), (200, 2, 5, 'vx'),
                                 (300, 2, 5, 'vx')]
    assert got[0][0]['fields'] == ['rho', 'vx', 'vy', 'vz']
    # the host fields hold iteration 300: z = 5 is the array's plane 5
    expect = sim.vx[5].astype(np.float32)
    assert got[2][1].shape == (16, 16)
    np.testing.assert_array_equal(got[2][1], expect)
    assert np.abs(expect).max() > 1e-4


def test_visualizer_client_parses_a_slice(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        'utils_visualizer', os.path.join(REPO, 'utils', 'visualizer.py'))
    viz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(viz)
    args = viz.parse_args(['--data_port', '5555', '--axis', '2',
                           '--position', '3', '--frames', '1'])
    assert (args.host, args.data_port, args.axis, args.position,
            args.frames) == ('127.0.0.1', 5555, 2, 3, 1)
    arr = np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0
    vc = VisConfig()
    vc.axis, vc.position = 2, 3
    message = [slice_header('vy', ['rho', 'vy'], arr, 40, vc),
               zlib.compress(arr.tobytes())]

    class Socket:
        def connect(self, address):
            assert address == 'tcp://127.0.0.1:5555'

        def setsockopt(self, *a):
            pass

        def recv_multipart(self):
            return message

    class Context:
        def socket(self, kind):
            assert kind == zmq.SUB
            return Socket()

    monkeypatch.setattr(zmq.Context, 'instance', lambda: Context())
    meta, got = next(viz.frames(args))
    assert meta == parse_slice(*message)[0]
    assert (meta['field'], meta['iteration'], meta['axis'],
            meta['position'], meta['shape']) == ('vy', 40, 2, 3, [3, 4])
    np.testing.assert_array_equal(got, arr)
