"""Profiling: the GraceState footprint model (:mod:`.recorder`); the
counterpart of the JAX package's ``profiling`` footprint functions."""

from grace_tpu_torch.profiling.recorder import (check_state_footprint,
                                                expected_state_footprint,
                                                grace_state_footprint)

__all__ = ["grace_state_footprint", "expected_state_footprint",
           "check_state_footprint"]
