"""Logging, timing and device helpers of the port.

The logger, quit event and timing record are the JAX package's own
(``sailfish_tpu.util`` is numpy-only at import time). What changes is how
a device computation is waited for: PyTorch launches asynchronously, so a
host clock measures the work only after ``torch.cuda.synchronize()``, and
a kernel's own time comes from CUDA events.
"""

from __future__ import annotations

import torch

from sailfish_tpu.util import (  # noqa: F401  (re-exported)
    SimpleEvent, TimingInfo, get_logger, reset_logger)


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
