"""Utilities; counterpart of the JAX package's ``utils``: the wire-byte
count and report (``metrics.payload_nbytes``, ``metrics.wire_report``), the
guard's health readers (``metrics.guard_report``,
``metrics.debug_nan_residuals``) and the loggers (``logging``, with
``GuardMonitor`` and ``ConsensusMonitor``)."""

from grace_tpu_torch.utils.logging import (ConsensusMonitor, GuardMonitor,
                                           TableLogger, Timer, TSVLogger,
                                           git_commit, localtime,
                                           rank_zero_only, rank_zero_print,
                                           run_provenance)
from grace_tpu_torch.utils.metrics import (CompressionReport, LeafReport,
                                           debug_nan_residuals, guard_report,
                                           payload_nbytes, wire_report)

__all__ = ["payload_nbytes", "wire_report", "CompressionReport",
           "LeafReport", "guard_report", "debug_nan_residuals",
           "GuardMonitor", "ConsensusMonitor", "Timer", "TableLogger",
           "TSVLogger", "localtime", "rank_zero_only", "rank_zero_print",
           "run_provenance", "git_commit"]
