"""Simulation output backends: npz, VTK, Matlab + checkpoint filenames.

Counterpart of the reference's ``sailfish/io.py`` (LBOutput :32, NPYOutput
:301, VTKOutput :218, MatlabOutput :350, filename schemes :163-216); the
port's copy of ``sailfish_tpu/io.py``, with the same file names and
layouts, so outputs and checkpoints carry over between the two packages.
Fields are cast to the simulation precision through ``config.np_dtype``
(the port's ``config.dtype`` is a torch dtype, which numpy cannot read).
"""

from __future__ import annotations

import glob
import os

import numpy as np


def filename_iter_digits(max_iters):
    return max(len(str(max_iters)), 7)


def filename(base, digits, subdomain_id, it, suffix='.npz'):
    """(reference io.py:163-175)"""
    return f'{base}.{subdomain_id}.{it:0{digits}d}{suffix}'


def merged_filename(base, digits, it, suffix='.npz'):
    return f'{base}.{it:0{digits}d}{suffix}'


def checkpoint_filename(base, digits, subdomain_id, it):
    """(reference io.py:177-186)"""
    return f'{base}.{subdomain_id}.{it:0{digits}d}.cpoint.npz'


def dists_filename(base, digits, subdomain_id, it):
    """(reference io.py:177-178)"""
    return filename(base + '_dists', digits, subdomain_id, it)


def node_type_filename(base, subdomain_id):
    """(reference io.py:180-181)"""
    return filename(base + '_node_type_map', 1, subdomain_id, 0,
                    suffix='.npy')


def resolve_checkpoint(path):
    """Resolve '<base>.last' to the newest matching checkpoint
    (reference io.py:193-202)."""
    if path.endswith('.last'):
        pattern = path[:-len('.last')] + '*.cpoint.npz'
        files = sorted(glob.glob(pattern))
        if not files:
            raise FileNotFoundError(f'no checkpoints matching {pattern}')
        return files[-1]
    if not os.path.exists(path) and os.path.exists(path + '.cpoint.npz'):
        return path + '.cpoint.npz'
    return path


class LBOutput:
    """Base output class (reference io.py:32-86)."""

    format_name = None

    def __init__(self, config, subdomain_id=0):
        self.config = config
        self.subdomain_id = subdomain_id
        self.basename = config.output
        self.digits = filename_iter_digits(config.max_iters)
        self._scalar_fields = {}
        self._vector_fields = {}

    def register_field(self, field, name, vector=False):
        if vector:
            self._vector_fields[name] = field
        else:
            self._scalar_fields[name] = field

    def fields_dict(self, cast=False):
        out = dict(self._scalar_fields)
        for name, comps in self._vector_fields.items():
            for suffix, arr in zip('xyz', comps):
                out[name + suffix] = arr
        if cast:
            # host fields are kept float64 for initial-condition
            # precision; on-disk outputs carry the simulation precision
            # (the reference saves its float32 host fields directly)
            dt = np.dtype(self.config.np_dtype)
            out = {k: (np.asarray(v, dtype=dt)
                       if np.issubdtype(np.asarray(v).dtype, np.floating)
                       else np.asarray(v))
                   for k, v in out.items()}
        return out

    def close(self):
        """Flush any pending asynchronous writes."""

    def verify(self):
        """NaN/Inf check (reference io.py:77-82)."""
        return all(np.all(np.isfinite(f)) for f in self.fields_dict().values())

    def dump_dists(self, dists, i):
        """--debug_dump_dists escape (reference io.py:338-341 /
        subdomain_runner.py:1680-1684): the raw distribution arrays as
        an npz, one file per output event."""
        fname = dists_filename(self.basename or 'debug', self.digits,
                               self.subdomain_id, i)
        np.savez(fname, *[np.asarray(d) for d in dists])
        return fname

    def dump_node_type(self, node_type_map):
        """--debug_dump_node_type_map escape (reference
        io.py:343-345, subdomain_runner.py:356-357)."""
        fname = node_type_filename(self.basename or 'debug',
                                   self.subdomain_id)
        np.save(fname, np.asarray(node_type_map))
        return fname

    def save(self, i):
        raise NotImplementedError


class VisualizationWrapper(LBOutput):
    """Passes fields to a live visualization callback."""

    format_name = 'vis'

    def __init__(self, config, callback, subdomain_id=0):
        super().__init__(config, subdomain_id)
        self.callback = callback

    def save(self, i):
        self.callback(self.fields_dict(), i)


class NPYOutput(LBOutput):
    """.npz output with an asynchronous saver thread: the field dict is
    snapshotted and written in the background so disk I/O does not
    stall the hot loop on large 3D domains (reference io.py:271-298
    saver thread + .tmp rename protocol)."""

    format_name = 'npy'

    def __init__(self, config, subdomain_id=0):
        super().__init__(config, subdomain_id)
        # --nooutput_compress (reference io.py:306-311; compressed is
        # the default both there and here)
        self._do_save = (np.savez_compressed
                         if getattr(config, 'output_compress', True)
                         else np.savez)
        import queue
        import threading
        self._queue = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._writer_loop,
                                        daemon=True)
        self._thread.start()

    def _writer_loop(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    break
                fname, snapshot = item
                tmp = fname + '.tmp.npz'
                self._do_save(tmp, **snapshot)
                os.rename(tmp, fname + '.npz')
            except Exception as e:      # surface on the next save/close
                self._error = e
            finally:
                self._queue.task_done()

    _error = None

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f'async output write failed: {err}') \
                from err

    def save(self, i):
        self._raise_pending()
        fname = filename(self.basename, self.digits, self.subdomain_id, i,
                         suffix='')
        snapshot = {k: np.array(v, copy=True)
                    for k, v in self.fields_dict(cast=True).items()}
        self._queue.put((fname, snapshot))

    def close(self):
        if self._thread.is_alive():
            self._queue.put(None)
            self._queue.join()
            self._thread.join(timeout=60)
        self._raise_pending()


class MatlabOutput(LBOutput):
    """.mat output (reference io.py:350-377)."""

    format_name = 'mat'

    def save(self, i):
        import scipy.io
        fname = filename(self.basename, self.digits, self.subdomain_id, i,
                         suffix='.mat')
        scipy.io.savemat(fname, self.fields_dict(cast=True))


class VTKOutput(LBOutput):
    """Legacy-format VTK structured-points output (reference io.py:218-299;
    the reference uses tvtk, unavailable here, so we emit plain legacy VTK
    which ParaView/VisIt read natively)."""

    format_name = 'vtk'

    def save(self, i):
        fname = filename(self.basename, self.digits, self.subdomain_id, i,
                         suffix='.vtk')
        fields = self.fields_dict(cast=True)
        first = next(iter(fields.values()))
        shape = first.shape              # (gy, gx) or (gz, gy, gx)
        dims = tuple(reversed(shape)) + (1,) * (3 - len(shape))
        npts = int(np.prod(shape))
        with open(fname, 'wb') as fp:
            def w(s):
                fp.write(s.encode())
            w('# vtk DataFile Version 3.0\n')
            w(f'sailfish_tpu output, iteration {i}\n')
            w('BINARY\nDATASET STRUCTURED_POINTS\n')
            w(f'DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n')
            w('ORIGIN 0 0 0\nSPACING 1 1 1\n')
            w(f'POINT_DATA {npts}\n')
            for name, arr in fields.items():
                w(f'SCALARS {name} float 1\nLOOKUP_TABLE default\n')
                arr.astype('>f4').tofile(fp)
                w('\n')


FORMATS = {c.format_name: c for c in (NPYOutput, VTKOutput, MatlabOutput)}


def format_name_to_cls(name):
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f'unknown output format {name!r}; '
                         f'known: {sorted(FORMATS)}')
