"""Logging, timing and device helpers of the port.

The logger, quit event and timing record are copies of the numpy parts of
``sailfish_tpu/util.py``. What changes is how a device computation is
waited for: PyTorch launches asynchronously, so a host clock measures the
work only after ``torch.cuda.synchronize()``, and a kernel's own time
comes from CUDA events.
"""

from __future__ import annotations

import logging
from collections import namedtuple

import torch

TimingInfo = namedtuple('TimingInfo', ('iters', 'elapsed', 'mlups'))


class SimpleEvent:
    """Single-process stand-in for multiprocessing.Event (the reference's
    quit_event; master.py:94-97)."""

    def __init__(self):
        self._flag = False

    def set(self):
        self._flag = True

    def is_set(self):
        return self._flag

    def clear(self):
        self._flag = False


_logger = None


def get_logger(config=None):
    """Console+file logger (reference util.py:187-213)."""
    global _logger
    if _logger is not None:
        return _logger
    logger = logging.getLogger('sailfish_tpu_torch')
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            '[%(relativeCreated)6.0f %(levelname)5s] %(message)s'))
        logger.addHandler(handler)
        if config is not None and getattr(config, 'log', None):
            fh = logging.FileHandler(config.log)
            logger.addHandler(fh)
    if config is not None:
        if getattr(config, 'silent', False):
            logger.setLevel(logging.ERROR)
        elif getattr(config, 'quiet', False):
            logger.setLevel(logging.WARNING)
        elif getattr(config, 'verbose', False):
            logger.setLevel(logging.DEBUG)
        else:
            logger.setLevel(logging.INFO)
    _logger = logger
    return logger


def reset_logger():
    global _logger
    _logger = None


def synchronize(device):
    """Wait for all queued work on ``device`` (no-op on the CPU, where
    torch runs eagerly and synchronously)."""
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def cuda_time_ms(fn, iters, warmup=1):
    """Mean device milliseconds per call of ``fn()`` over ``iters`` calls,
    from CUDA events around the whole run (after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
