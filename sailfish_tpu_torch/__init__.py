"""sailfish_tpu_torch: the PyTorch/CUDA port of sailfish_tpu.

A second package beside the JAX one. It keeps the scene API (``LBSim``
subclasses, ``Subdomain`` geometry, the ``node_type`` catalog), the flags
and the npz output/checkpoint formats, and runs the step either as plain
PyTorch tensor code (the "torch" engine, the port's semantics reference on
every device) or through hand-written CUDA kernels for Hopper (the
"kernel" engine, ``ops/lbm_step.py``).

The scene modules (``lattice``, ``node_type``, ``subdomain``, ``geo``,
``config``, ``io``, ``util``, ``profile``, ``models/*``) are the port's
own copies of the JAX package's: the node-type ids, the lattice direction
order and the output and checkpoint formats are the same in both
packages, but nothing here imports jax or the JAX package.
"""

__version__ = '0.1.0'
