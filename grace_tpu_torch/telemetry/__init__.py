"""Telemetry: the device ring of per-step scalars, the cross-rank watch
ring, named trace stages, sinks, the host drain, the anomaly detectors and
the run timeline; counterpart of the JAX package's ``telemetry``.

* :mod:`~grace_tpu_torch.telemetry.state` — :class:`TelemetryState`, the
  ring that ``grace_transform(telemetry=...)`` writes on the device each
  update.
* :mod:`~grace_tpu_torch.telemetry.aggregate` — graft-watch:
  ``grace_transform(watch=...)`` gathers every rank's health scalars every
  window (one tiny ``all_gather``) and writes the replicated
  mean/min/max and the per-rank skew into :class:`WatchState`, its bytes
  folded into the ring's ``wire_bytes`` as ``watch_bytes``.
* :mod:`~grace_tpu_torch.telemetry.reader` — :class:`TelemetryReader`,
  one device-to-host transfer a flush window, the watch rings and the
  guard's counters in it; ``anomaly=...`` runs the detectors on each flush.
* :mod:`~grace_tpu_torch.telemetry.anomaly` — :class:`WatchMonitor`:
  per-rank skew outliers, EWMA spikes, wire-model drift, step-time and
  retrace records → ``watch_anomaly`` records.
* :mod:`~grace_tpu_torch.telemetry.timeline` — :class:`Timeline`, every
  sink record kind in one step-keyed sequence.
* :mod:`~grace_tpu_torch.telemetry.sinks` — :class:`JSONLSink`,
  :class:`TensorBoardSink`, :class:`MultiSink`.
* :func:`trace_stage` — ``torch.profiler`` spans named by stage.
"""

from grace_tpu_torch._lazy import lazy_exports

__all__ = ["FIELDS", "TelemetryConfig", "TelemetryState", "telemetry_init",
           "telemetry_record", "WATCH_FIELDS", "WatchConfig", "WatchState",
           "watch_init", "watch_record", "AnomalyConfig", "WatchMonitor",
           "Timeline", "TelemetryReader", "Sink", "JSONLSink",
           "TensorBoardSink", "MultiSink", "trace_stage"]

__getattr__, __dir__ = lazy_exports(__name__, {
    ".aggregate": ("WATCH_FIELDS", "WatchConfig", "WatchState", "watch_init",
                   "watch_record"),
    ".anomaly": ("AnomalyConfig", "WatchMonitor"),
    ".reader": ("TelemetryReader",),
    ".scopes": ("trace_stage",),
    ".sinks": ("JSONLSink", "MultiSink", "Sink", "TensorBoardSink"),
    ".state": ("FIELDS", "TelemetryConfig", "TelemetryState", "telemetry_init",
               "telemetry_record"),
    ".timeline": ("Timeline",)})
