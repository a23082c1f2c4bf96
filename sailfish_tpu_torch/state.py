"""Moving distribution states between numpy (and so the JAX package) and
the port.

Both sides use the (Q, *S) layout in the standard direction order of
``lattice`` (identical in both packages), so a state from a JAX run or
checkpoint carries over unchanged: this is how the tests hand a JAX state
to the port. A single-fluid state is one tensor; a K-component state is
a K-tuple of them, stored in checkpoints as ``dist0a`` ...
``dist{K-1}a`` in component order, exactly as the JAX runner stores its
state's pytree leaves.
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


def leaves(state):
    """The state's (Q, *S) tensors in checkpoint order: ``[f]`` for a
    single-fluid state, the components of a K-tuple."""
    return list(state) if isinstance(state, tuple) else [state]


def from_leaves(like, tensors):
    """A state of ``like``'s structure (tensor or K-tuple) holding
    ``tensors``."""
    if isinstance(like, tuple):
        if len(tensors) != len(like):
            raise ValueError(f'{len(tensors)} distribution arrays for a '
                             f'{len(like)}-component state')
        return tuple(tensors)
    (f,) = tensors
    return f


def is_finite(state):
    """True when every distribution value of the state is finite."""
    return all(bool(torch.isfinite(f).all()) for f in leaves(state))
