"""Moving distribution states between numpy (and so the JAX package) and
the port.

Both sides use the (Q, *S) layout in the standard direction order of
``sailfish_tpu.lattice``, so a state from a JAX run or checkpoint carries
over unchanged: this is how the tests hand a JAX state to the port.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(f, device, dtype=torch.float32):
    """A (Q, *S) numpy state as a contiguous tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(f), dtype=dtype,
                           device=device).contiguous()


def state_to_numpy(f):
    """A (Q, *S) tensor state as a numpy array on the host."""
    return f.detach().cpu().numpy()
