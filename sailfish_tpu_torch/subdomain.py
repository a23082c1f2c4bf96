"""Scene geometry (``Subdomain2D`` / ``Subdomain3D``), shared with the JAX
package: ``sailfish_tpu/subdomain.py`` is numpy-only at import time and
encodes the node maps both packages' step builders read."""

from sailfish_tpu.subdomain import (  # noqa: F401  (re-exported)
    NodeMaps, Subdomain, Subdomain2D, Subdomain3D, SubdomainSpec,
    SubdomainSpec2D, SubdomainSpec3D)
