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


def tree_leaves(tree):
    """The tensors (or arrays) of a nested structure of tuples, lists and
    dicts, in the order of ``jax.tree.leaves``: dict keys sorted, tuple
    and list items in order; None holds no leaf. This is the order in
    which checkpoints store device-hook states (``hook0`` ...), so the
    two packages read each other's."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_unflatten(like, leaves):
    """A structure of ``like``'s shape holding ``leaves`` (in
    ``tree_leaves`` order); raises ValueError when their number differs
    from ``like``'s."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(item) for item in node)
        try:
            return next(it)
        except StopIteration:
            raise ValueError('fewer leaves than the structure holds') \
                from None

    out = build(like)
    if next(it, None) is not None:
        raise ValueError('more leaves than the structure holds')
    return out


def tree_map(fn, tree):
    """``fn`` applied to every leaf of ``tree``, the structure kept."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])
