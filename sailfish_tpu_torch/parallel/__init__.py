"""Sharded runs (``--mesh``): the device mesh (``mesh.py``) and the
ghost-plane stepping on meshes of one or two axes: single-fluid scenes
(``halo.py``), the mixtures and the free-energy model (``halo_multi.py``)."""
