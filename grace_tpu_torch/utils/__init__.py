"""Utilities; counterpart of the JAX package's ``utils``: the wire-byte
count and report (``metrics.payload_nbytes``, ``metrics.wire_report``) and
the loggers (``logging``)."""

from grace_tpu_torch.utils.logging import (TableLogger, Timer, TSVLogger,
                                           git_commit, localtime,
                                           rank_zero_only, rank_zero_print,
                                           run_provenance)
from grace_tpu_torch.utils.metrics import (CompressionReport, LeafReport,
                                           payload_nbytes, wire_report)

__all__ = ["payload_nbytes", "wire_report", "CompressionReport",
           "LeafReport", "Timer", "TableLogger", "TSVLogger",
           "localtime", "rank_zero_only", "rank_zero_print",
           "run_provenance", "git_commit"]
