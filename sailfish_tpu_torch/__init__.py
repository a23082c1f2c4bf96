"""sailfish_tpu_torch: the PyTorch/CUDA port of sailfish_tpu.

A second package beside the JAX one. It keeps the scene API (``LBSim``
subclasses, ``Subdomain`` geometry, the ``node_type`` catalog), the flags
and the npz output/checkpoint formats, and runs the step either as plain
PyTorch tensor code (the "torch" engine, the port's semantics reference on
every device) or through hand-written CUDA kernels for Hopper (the
"kernel" engine, ``ops/lbm_step.py``).

The numpy-only scene modules of the JAX package (``lattice``,
``node_type``, ``subdomain``, ``geo``, ``io``, ``profile``,
``models/base``) are imported, not copied, so both packages share one
node-type catalog, one lattice direction order and one output format.
Nothing here imports jax.
"""

__version__ = '0.1.0'
