"""The boundary-condition node-type catalog, shared with the JAX package.

``sailfish_tpu/node_type.py`` is numpy-only at import time. Both packages
use its classes, so node-type ids (part of the checkpoint format),
orientations and parameters agree between them.
"""

from sailfish_tpu.node_type import *  # noqa: F401,F403  (re-exported)
from sailfish_tpu.node_type import (  # noqa: F401  (re-exported)
    _NTFluid, _NTGhost, _NTPropagationOnly, _NTUnused)
