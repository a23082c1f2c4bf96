"""Flag/config system of the port: argparse groups + rc-file overrides.

The port's copy of ``sailfish_tpu/config.py`` (the reference's
``sailfish/config.py``: LBConfig :17, LBConfigParser.parse :59 with the
/etc -> ~ -> ./ rc-file chain) with torch dtype and device selection. The
override order is the JAX package's: rc files -> class update_defaults ->
script default_config -> command line (reference controller.py:466-472).
"""

from __future__ import annotations

import argparse
import configparser
import os
import shlex

import numpy as np
import torch


class LBConfig(argparse.Namespace):
    """Parsed simulation configuration.

    Derived convenience properties mirror reference config.py:27-29,83-89.
    """

    @property
    def output_required(self):
        return bool(self.output) or self.mode == 'visualization'

    @property
    def needs_iteration_num(self):
        return self.time_dependence or self.access_pattern == 'AA'

    @property
    def dtype(self):
        return torch.float64 if self.precision == 'double' else torch.float32

    @property
    def np_dtype(self):
        """The simulation precision as a numpy dtype (output casting)."""
        return np.float64 if self.precision == 'double' else np.float32

    @property
    def device(self):
        """``--platform``: 'cuda' (also when unset) or 'cpu'. A CUDA run
        without a visible device raises instead of running somewhere
        else; the CPU runs only when asked for."""
        platform = getattr(self, 'platform', '') or 'cuda'
        if platform not in ('cpu', 'cuda'):
            raise ValueError(f'unknown --platform {platform!r}')
        if platform == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                'torch sees no CUDA device; the port runs on the card '
                'unless asked for the CPU: pass --platform=cpu')
        return torch.device(platform)


class LBConfigParser:
    """argparse wrapper with option groups and rc files
    (reference config.py:32-92)."""

    RC_FILES = ['/etc/sailfishtpurc',
                os.path.expanduser('~/.sailfishtpurc'),
                '.sailfishtpurc']

    def __init__(self, description=None):
        self._parser = argparse.ArgumentParser(description=description)
        self._parser.add_argument('-q', '--quiet', action='store_true',
                                  default=False, help='reduce logging')
        self._parser.add_argument('-v', '--verbose', action='store_true',
                                  default=False)
        self._parser.add_argument('--silent', action='store_true',
                                  default=False)
        self.config = LBConfig()
        # internal, non-flag state
        self.config.time_dependence = False
        self.config.space_dependence = False
        self.config.unit_test = False

    def add_group(self, name):
        return self._parser.add_argument_group(name)

    def set_defaults(self, defaults):
        return self._parser.set_defaults(**defaults)

    def parse(self, args=None, internal_defaults=None):
        # rc files first (lowest priority beyond hard defaults)
        cp = configparser.ConfigParser()
        cp.read(self.RC_FILES)
        if cp.has_section('main'):
            rc = {}
            for key, val in cp.items('main'):
                for s, t in ((cp.getboolean, bool), (cp.getint, int),
                             (cp.getfloat, float)):
                    try:
                        rc[key] = s('main', key)
                        break
                    except ValueError:
                        continue
                else:
                    rc[key] = val
            self._parser.set_defaults(**rc)
        if internal_defaults:
            self._parser.set_defaults(**internal_defaults)
        env = os.environ.get('SAILFISH_TPU_FLAGS')
        if env and args is None:
            args = shlex.split(env)
        self._parser.parse_args(args=args, namespace=self.config)
        return self.config
