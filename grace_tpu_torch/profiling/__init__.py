"""Performance attribution: the read side of the observability stack; the
counterpart of the JAX package's ``profiling``.

* :mod:`~grace_tpu_torch.profiling.trace_analysis`: parse a
  ``torch.profiler`` Chrome trace into a per-stage device-time breakdown
  (kernels attributed to the ``grace/...`` ranges through launch
  correlation and containment), a compute-vs-collective split, an overlap
  fraction and step-time percentiles.
* :mod:`~grace_tpu_torch.profiling.trace_export`: spans back out as a
  Chrome trace, and :func:`merge_host_traces`.
* :mod:`~grace_tpu_torch.profiling.recorder`: :class:`ProfileRecorder`
  (step-time percentiles, kernel builds, memory watermarks, sink
  emission) and the GraceState footprint model.

Not ported, with their reason: the JAX package's XPlane half
(``parse_xplane``, ``hlo_scope_map``, ``enrich_spans``) decodes XLA's
XSpace protobuf and its HLO metadata; ``torch.profiler`` writes neither,
and its Chrome trace carries the ranges and launch correlations that
attribute kernels to stages instead.
"""

from grace_tpu_torch._lazy import lazy_exports

__all__ = [
    "ProfileRecorder", "check_state_footprint", "compile_count",
    "device_memory_watermarks", "expected_state_footprint",
    "grace_state_footprint",
    "Span", "TraceAnalysis", "analyze_spans", "analyze_trace",
    "find_latest_trace", "interval_union_us", "load_trace_events",
    "overlap_us", "parse_chrome_trace",
    "chrome_trace_doc", "merge_host_traces", "write_chrome_trace",
]

__getattr__, __dir__ = lazy_exports(__name__, {
    ".recorder": ("ProfileRecorder", "check_state_footprint", "compile_count",
                  "device_memory_watermarks", "expected_state_footprint",
                  "grace_state_footprint"),
    ".trace_analysis": ("Span", "TraceAnalysis", "analyze_spans",
                        "analyze_trace", "find_latest_trace",
                        "interval_union_us", "load_trace_events", "overlap_us",
                        "parse_chrome_trace"),
    ".trace_export": ("chrome_trace_doc", "merge_host_traces",
                      "write_chrome_trace")})
