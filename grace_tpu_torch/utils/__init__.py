"""Utilities; counterpart of the JAX package's ``utils``: the wire-byte
count (``metrics.payload_nbytes``) and the loggers (``logging``)."""

from grace_tpu_torch.utils.logging import (TableLogger, Timer, TSVLogger,
                                           git_commit, localtime,
                                           rank_zero_only, rank_zero_print,
                                           run_provenance)
from grace_tpu_torch.utils.metrics import payload_nbytes

__all__ = ["payload_nbytes", "Timer", "TableLogger", "TSVLogger",
           "localtime", "rank_zero_only", "rank_zero_print",
           "run_provenance", "git_commit"]
