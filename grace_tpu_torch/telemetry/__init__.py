"""Telemetry: the device ring of per-step scalars, named trace stages,
sinks and the host drain; counterpart of the JAX package's ``telemetry``
(its ``state``, ``scopes``, ``sinks`` and ``reader``; the cross-rank watch
ring, the anomaly detectors and the timeline are not ported yet).

* :mod:`~grace_tpu_torch.telemetry.state` — :class:`TelemetryState`, the
  ring that ``grace_transform(telemetry=...)`` writes on the device each
  update.
* :mod:`~grace_tpu_torch.telemetry.reader` — :class:`TelemetryReader`,
  one device-to-host transfer a flush window, the guard's counters in it.
* :mod:`~grace_tpu_torch.telemetry.sinks` — :class:`JSONLSink`,
  :class:`TensorBoardSink`, :class:`MultiSink`.
* :func:`trace_stage` — ``torch.profiler`` spans named by stage.
"""

from grace_tpu_torch.telemetry.reader import TelemetryReader
from grace_tpu_torch.telemetry.scopes import trace_stage
from grace_tpu_torch.telemetry.sinks import (JSONLSink, MultiSink, Sink,
                                             TensorBoardSink)
from grace_tpu_torch.telemetry.state import (FIELDS, TelemetryConfig,
                                             TelemetryState, telemetry_init,
                                             telemetry_record)

__all__ = ["FIELDS", "TelemetryConfig", "TelemetryState", "telemetry_init",
           "telemetry_record", "TelemetryReader", "Sink", "JSONLSink",
           "TensorBoardSink", "MultiSink", "trace_stage"]
