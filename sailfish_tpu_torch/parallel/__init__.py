"""Sharded runs (``--mesh``): the device mesh (``mesh.py``) and the
ghost-plane stepping of single-fluid scenes on one-axis meshes
(``halo.py``)."""
