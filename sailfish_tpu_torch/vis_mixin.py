"""On-line 2D slice visualization server.

Port of ``sailfish_tpu/vis_mixin.py`` (the reference's
``sailfish/vis_mixin.py``, Vis2DSliceMixIn :36): cuts 2D slices of the 3D
(or 2D) host fields and serves them over ZeroMQ, so that a remote viewer
(``utils/visualizer.py``) can watch a running simulation. Protocol: an
XPUB data socket publishing zlib-compressed float32 slices with a JSON
header, and a REP control socket taking {'token', 'axis', 'position',
'field', 'every'} updates, checked against the auth token. The slices come
from the host fields the runner copies out (on a mesh, the gathered
fields). ``zmq`` is imported inside the methods, so the rest of the port
runs without it.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib

import numpy as np

from sailfish_tpu_torch import util
from sailfish_tpu_torch.models.base import LBMixIn


class VisConfig:
    """(reference vis_mixin.py:26-33)"""

    def __init__(self):
        self.every = 100
        self.axis = 0
        self.position = 0
        self.field = 0
        self.levels = 256


def slice_header(name, names, arr, iteration, vc):
    """The JSON header of a published slice."""
    return json.dumps({
        'field': name, 'fields': names, 'shape': arr.shape,
        'iteration': iteration, 'axis': vc.axis,
        'position': vc.position}).encode()


def parse_slice(header, payload):
    """(header dict, 2D float32 array) of a published message."""
    meta = json.loads(header.decode())
    arr = np.frombuffer(zlib.decompress(payload),
                        dtype=np.float32).reshape(meta['shape'])
    return meta, arr


class Vis2DSliceMixIn(LBMixIn):
    """Serves 2D slices of the velocity and scalar fields over zmq
    (reference vis_mixin.py:36-270)."""

    @classmethod
    def add_options(cls, group, dim):
        group.add_argument('--visualizer_port', type=int, default=0,
                           help='control (REP) port; 0 = random')
        group.add_argument('--visualizer_data_port', type=int, default=0,
                           help='data (XPUB) port; 0 = random')
        group.add_argument('--visualizer_auth_token', type=str, default='',
                           help='control auth token; empty = generated')

    def before_main_loop(self, runner):
        import zmq
        self._vis_config = VisConfig()
        self._ctx = zmq.Context()
        self._sock = self._ctx.socket(zmq.XPUB)
        self._ctrl_sock = self._ctx.socket(zmq.REP)
        for sock in (self._sock, self._ctrl_sock):
            sock.setsockopt(zmq.LINGER, 0)

        cfg = runner.config
        if cfg.visualizer_data_port > 0:
            self._port = cfg.visualizer_data_port
            self._sock.bind(f'tcp://*:{self._port}')
        else:
            self._port = self._sock.bind_to_random_port('tcp://*')
        if cfg.visualizer_port > 0:
            self._ctrl_port = cfg.visualizer_port
            self._ctrl_sock.bind(f'tcp://*:{self._ctrl_port}')
        else:
            self._ctrl_port = self._ctrl_sock.bind_to_random_port('tcp://*')

        if cfg.visualizer_auth_token:
            self._authtoken = cfg.visualizer_auth_token
        else:
            self._authtoken = hashlib.md5(os.urandom(64)).hexdigest()
        util.get_logger(cfg).info(
            'Visualization data port %d, control port %d, token %s',
            self._port, self._ctrl_port, self._authtoken)

    def close_slice_server(self):
        """Close the sockets and the zmq context (a no-op before
        ``before_main_loop`` and after a first call)."""
        ctx = getattr(self, '_ctx', None)
        if ctx is None:
            return
        self._sock.close()
        self._ctrl_sock.close()
        ctx.term()
        self._ctx = None
        self._vis_config = None

    def _field_slices(self, runner):
        """name -> 2D numpy slice according to the current VisConfig."""
        runner._fields_to_host()
        fields = dict(runner.sim.host_fields())
        v = fields.pop('v', None)
        out = {}
        if v is not None:
            for name, comp in zip(('vx', 'vy', 'vz'), v):
                out[name] = comp
        out.update(fields)
        vc = self._vis_config
        sliced = {}
        for name, arr in out.items():
            if arr.ndim == 3:
                # axis 0 = x, 1 = y, 2 = z (user convention); array axes
                # are (z, y, x)
                ax = arr.ndim - 1 - vc.axis
                pos = int(np.clip(vc.position, 0, arr.shape[ax] - 1))
                sliced[name] = np.take(arr, pos, axis=ax)
            else:
                sliced[name] = arr
        return sliced

    def _poll_control(self):
        import zmq
        while True:
            try:
                msg = self._ctrl_sock.recv_json(flags=zmq.NOBLOCK)
            except zmq.Again:
                return
            ok = isinstance(msg, dict) and \
                msg.get('token') == self._authtoken
            if ok:
                vc = self._vis_config
                for key in ('every', 'axis', 'position', 'field'):
                    if key in msg:
                        setattr(vc, key, int(msg[key]))
            self._ctrl_sock.send_json({'ack': bool(ok)})

    def after_step(self, runner):
        vc = getattr(self, '_vis_config', None)
        if vc is None:
            return
        if runner.sim.iteration % vc.every != 0:
            return
        self._poll_control()
        slices = self._field_slices(runner)
        names = sorted(slices)
        name = names[vc.field % len(names)]
        arr = np.ascontiguousarray(slices[name], dtype=np.float32)
        self._sock.send_multipart([
            slice_header(name, names, arr, runner.sim.iteration, vc),
            zlib.compress(arr.tobytes())])


def connect_slice_client(data_port, host='127.0.0.1', timeout_ms=None):
    """Client: an iterator of (header dict, 2D array) published by a
    running Vis2DSliceMixIn (the data path of utils/visualizer.py). With
    ``timeout_ms`` a wait longer than that for the next slice raises
    TimeoutError. Closing the iterator closes its socket."""
    import zmq
    ctx = zmq.Context.instance()
    sock = ctx.socket(zmq.SUB)
    sock.setsockopt(zmq.LINGER, 0)
    sock.connect(f'tcp://{host}:{data_port}')
    sock.setsockopt(zmq.SUBSCRIBE, b'')

    def gen():
        try:
            while True:
                if timeout_ms is not None and \
                        not sock.poll(timeout_ms, zmq.POLLIN):
                    raise TimeoutError(
                        f'no slice from port {data_port} within '
                        f'{timeout_ms} ms')
                yield parse_slice(*sock.recv_multipart())
        finally:
            sock.close()

    return gen()
