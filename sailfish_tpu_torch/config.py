"""Flag/config system of the port: the JAX package's parser with torch
dtype and device selection.

``sailfish_tpu.config`` is numpy-only at import time; only its
``LBConfig.dtype`` reaches for ``jax.numpy``. The port overrides that
property (and adds ``device``) and keeps the parser, the rc-file chain and
the override order unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from sailfish_tpu import config as _config


class LBConfig(_config.LBConfig):
    """Parsed configuration with torch dtype/device properties."""

    @property
    def dtype(self):
        return torch.float64 if self.precision == 'double' else torch.float32

    @property
    def np_dtype(self):
        """The simulation precision as a numpy dtype (output casting)."""
        return np.float64 if self.precision == 'double' else np.float32

    @property
    def device(self):
        """``--platform``: 'cuda', 'cpu', or '' for the CUDA device when
        torch sees one and the CPU otherwise. An explicit 'cuda' without a
        visible device raises instead of running somewhere else."""
        platform = getattr(self, 'platform', '') or ''
        if not platform:
            platform = 'cuda' if torch.cuda.is_available() else 'cpu'
        if platform == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                '--platform=cuda requested but torch sees no CUDA device')
        if platform not in ('cpu', 'cuda'):
            raise ValueError(f'unknown --platform {platform!r}')
        return torch.device(platform)


class LBConfigParser(_config.LBConfigParser):
    """The JAX package's parser, filling the port's ``LBConfig``."""

    def __init__(self, description=None):
        super().__init__(description)
        fresh = LBConfig()
        fresh.__dict__.update(vars(self.config))
        self.config = fresh
