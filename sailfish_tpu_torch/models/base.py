"""Base sim classes, shared with the JAX package:
``sailfish_tpu/models/base.py`` is numpy-only at import time, and scenes
subclass its ``LBForcedSim`` for body forces (``add_body_force``,
``use_force_for_equilibrium``)."""

from sailfish_tpu.models.base import (  # noqa: F401  (re-exported)
    LBForcedSim, LBSim, ScalarField, VectorField)
