"""graft-watch's host-side streaming anomaly detectors; counterpart of the
JAX package's ``telemetry/anomaly.py``, line for line (pure Python).

The device half (:mod:`grace_tpu_torch.telemetry.aggregate`) makes the
cross-rank health summary a replicated fact; these detectors read it. They
run in the :class:`~grace_tpu_torch.telemetry.reader.TelemetryReader` flush
(``anomaly=...``) or offline over a saved JSONL artifact, and turn
summaries into attributed ``watch_anomaly`` records before the guard or
the consensus audit has anything to say:

* **per-rank skew outliers**: for each watch summary's skew vector
  (``compression_error_skew``, ``grad_norm_skew``,
  ``residual_norm_skew``), the deviation from the rank median scaled by
  the median absolute deviation of the *other* ranks (one drifting rank
  cannot widen its own yardstick), floored at ``skew_floor`` of the
  metric's mean;
* **EWMA z-score spikes** over the replicated ``compression_error_mean``
  and over ``perf_step_times`` p50;
* **wire-model drift**: every telemetry row's exchange bytes
  (``wire_bytes`` less the audit, watch, negotiation and adapt bytes) must
  stay within ``wire_rtol`` of the first value seen in its (fallback,
  rung) phase, or of ``expected_wire``;
* **retraces**: every ``perf_retrace`` record is flagged as it is.

Each detector fires on the rising edge of its score and re-arms only after
the score falls below half its threshold: one record an episode. Records
are flat dicts through the same sink as the telemetry rows::

    {"event": "watch_anomaly", "step": 120, "kind": "skew",
     "metric": "compression_error", "rank": 5,
     "value": 0.31, "score": 14.2, "threshold": 6.0}

``rank`` is -1 for fleet-wide anomalies (spikes, wire drift, retraces).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional

__all__ = ["AnomalyConfig", "Ewma", "WatchMonitor"]


@dataclasses.dataclass(frozen=True)
class AnomalyConfig:
    """Static detector thresholds.

    ``skew_threshold`` — robust score (|dev from median| / MAD scale) a
    rank must exceed to be flagged; ``skew_floor`` — minimum deviation
    scale as a fraction of the metric's cross-rank mean, so a fleet of
    near-identical healthy ranks (tiny MAD) doesn't flag noise.
    ``z_threshold``/``ewma_alpha``/``warmup`` parameterize the temporal
    EWMA z-score detectors (warmup = observations before a detector may
    fire). ``wire_rtol`` — relative tolerance of the wire-model drift
    check, matching the static auditor's contract.
    """

    skew_threshold: float = 6.0
    skew_floor: float = 0.05
    z_threshold: float = 4.0
    ewma_alpha: float = 0.25
    warmup: int = 3
    wire_rtol: float = 0.10

    def __post_init__(self):
        if self.skew_threshold <= 0 or self.z_threshold <= 0:
            raise ValueError("anomaly thresholds must be > 0")
        if not 0 < self.ewma_alpha <= 1:
            raise ValueError(f"ewma_alpha must be in (0, 1]; "
                             f"got {self.ewma_alpha}")
        if self.warmup < 1:
            raise ValueError(f"warmup must be >= 1; got {self.warmup}")


class Ewma:
    """Streaming exponentially-weighted mean/variance with a z-score.

    ``update(x)`` returns the z-score of ``x`` against the statistics
    *before* folding it in (so a spike scores against the healthy past,
    not against itself), or ``None`` during warmup.
    """

    def __init__(self, alpha: float = 0.25, warmup: int = 3):
        self.alpha = alpha
        self.warmup = warmup
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, x: float) -> Optional[float]:
        x = float(x)
        z = None
        if self.n >= self.warmup:
            std = math.sqrt(max(self.var, 0.0))
            z = abs(x - self.mean) / max(std, 1e-12,
                                         1e-3 * abs(self.mean))
        if self.n == 0:
            self.mean = x
        else:
            delta = x - self.mean
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var
                                           + self.alpha * delta * delta)
        self.n += 1
        return z


def _median(values: List[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    mid = n // 2
    return vs[mid] if n % 2 else 0.5 * (vs[mid - 1] + vs[mid])


class WatchMonitor:
    """Streaming consumer of sink records; emits ``watch_anomaly`` records.

    ``observe(records)`` takes any iterable of flat record dicts (the
    reader's flush output, or a whole JSONL artifact replayed offline),
    dispatches each to the relevant detector, writes every anomaly to
    ``sink`` (when given) and returns them. All anomalies ever seen
    accumulate in :attr:`anomalies`.

    ``expected_wire`` (optional): the modeled exchange bytes per
    non-fallback step — e.g.
    ``grace.communicator.recv_wire_bytes(payload, n, world)`` — for the
    wire-model drift check. Without it the detector locks onto the first
    observed value per fallback phase (drift is then *change*, which still
    catches a schedule silently re-routing mid-run).
    """

    _SKEW_METRICS = ("compression_error", "grad_norm", "residual_norm")

    def __init__(self, sink=None, config: Optional[AnomalyConfig] = None,
                 expected_wire: Optional[float] = None):
        self.sink = sink
        self.config = config or AnomalyConfig()
        self.expected_wire = expected_wire
        self.anomalies: List[dict] = []
        self._ewma: Dict[str, Ewma] = {}
        self._active: set = set()          # (kind, metric, rank) hysteresis
        # Expected exchange bytes per (fallback, adapt_rung) phase: the
        # fallback flip and graft-adapt's rung transitions both change
        # the honest wire bill, so each phase carries its own baseline.
        self._wire_expected: Dict[tuple, float] = {}
        if expected_wire is not None:
            self._wire_expected[(False, -1)] = float(expected_wire)

    # -- plumbing -----------------------------------------------------------
    def _emit(self, step, kind: str, metric: str, rank: int, value: float,
              score: float, threshold: float, **extra) -> dict:
        rec = {"event": "watch_anomaly", "step": step, "kind": kind,
               "metric": metric, "rank": rank, "value": float(value),
               "score": float(score), "threshold": float(threshold),
               **extra}
        self.anomalies.append(rec)
        if self.sink is not None:
            self.sink.write(rec)
        return rec

    def _hysteresis(self, key, score: float, threshold: float) -> bool:
        """True exactly on the rising edge of ``score > threshold``. The
        key stays latched (no re-fire) until the score falls back below
        ``threshold / 2`` — one record per anomaly episode, not per
        window."""
        if score > threshold:
            if key in self._active:
                return False
            self._active.add(key)
            return True
        if score < threshold / 2:
            self._active.discard(key)
        return False

    def _zscore(self, name: str, value: float) -> Optional[float]:
        det = self._ewma.get(name)
        if det is None:
            det = self._ewma[name] = Ewma(self.config.ewma_alpha,
                                          self.config.warmup)
        return det.update(value)

    # -- the dispatcher -----------------------------------------------------
    def observe(self, records) -> List[dict]:
        out: List[dict] = []
        for rec in records:
            if not isinstance(rec, Mapping):
                continue
            event = rec.get("event")
            if event == "watch":
                out.extend(self._observe_watch(rec))
            elif event == "perf_step_times":
                out.extend(self._observe_step_times(rec))
            elif event == "perf_retrace":
                out.extend(self._observe_retrace(rec))
            elif event is None and "wire_bytes" in rec:
                out.extend(self._observe_telemetry(rec))
        return out

    # -- detectors ----------------------------------------------------------
    def _observe_watch(self, rec: Mapping[str, Any]) -> List[dict]:
        cfg = self.config
        step = rec.get("step")
        out: List[dict] = []
        for metric in self._SKEW_METRICS:
            vec = rec.get(f"{metric}_skew")
            if not isinstance(vec, (list, tuple)) or len(vec) < 3:
                continue
            vec = [float(v) for v in vec]
            mean = abs(float(rec.get(f"{metric}_mean", 0.0)))
            med = _median(vec)
            # MAD over the OTHER ranks: the candidate outlier must not
            # widen its own acceptance band.
            for rank, v in enumerate(vec):
                others = [abs(u - med) for i, u in enumerate(vec)
                          if i != rank]
                mad = _median(others)
                scale = max(1.4826 * mad, cfg.skew_floor * (mean + 1e-12))
                score = abs(v - med) / max(scale, 1e-300)
                if self._hysteresis(("skew", metric, rank), score,
                                    cfg.skew_threshold):
                    out.append(self._emit(
                        step, "skew", metric, rank, v, score,
                        cfg.skew_threshold,
                        mean=float(rec.get(f"{metric}_mean", 0.0))))
        # Fleet-wide compression-error spike (temporal).
        err_mean = rec.get("compression_error_mean")
        if err_mean is not None:
            z = self._zscore("compression_error_mean", float(err_mean))
            if z is not None and self._hysteresis(
                    ("spike", "compression_error_mean", -1), z,
                    cfg.z_threshold):
                out.append(self._emit(step, "spike",
                                      "compression_error_mean", -1,
                                      float(err_mean), z, cfg.z_threshold))
        return out

    def _observe_telemetry(self, rec: Mapping[str, Any]) -> List[dict]:
        cfg = self.config
        wire = rec.get("wire_bytes")
        if wire is None:
            return []
        exchange = (float(wire) - float(rec.get("audit_bytes", 0.0))
                    - float(rec.get("watch_bytes", 0.0))
                    - float(rec.get("negotiation_bytes", 0.0))
                    - float(rec.get("adapt_bytes", 0.0)))
        fallback = bool(rec.get("fallback"))
        # graft-adapt makes the exchange bytes legitimately
        # state-dependent: the expectation is keyed per (fallback, rung)
        # phase — a rung transition opens a new phase instead of reading
        # as drift (the per-rung twin of the fallback-phase split).
        rung = int(rec.get("adapt_rung", -1))
        phase = (fallback, rung)
        expected = self._wire_expected.get(phase)
        if expected is None:
            self._wire_expected[phase] = exchange
            return []
        drift = abs(exchange - expected)
        score = drift / max(cfg.wire_rtol * max(expected, 1.0), 1e-12)
        if self._hysteresis(("wire_drift", "wire_bytes", -1), score, 1.0):
            return [self._emit(
                rec.get("step"), "wire_drift", "wire_bytes", -1, exchange,
                score, 1.0, expected=expected, fallback=fallback)]
        return []

    def _observe_step_times(self, rec: Mapping[str, Any]) -> List[dict]:
        cfg = self.config
        p50 = rec.get("p50_ms")
        if p50 is None:
            return []
        z = self._zscore("step_p50_ms", float(p50))
        if z is not None and self._hysteresis(("step_time", "p50_ms", -1),
                                              z, cfg.z_threshold):
            return [self._emit(rec.get("step"), "step_time", "p50_ms", -1,
                               float(p50), z, cfg.z_threshold)]
        return []

    def _observe_retrace(self, rec: Mapping[str, Any]) -> List[dict]:
        # A retrace is categorical, not statistical: flag each one.
        return [self._emit(rec.get("step"), "retrace", "compile_cache", -1,
                           float(rec.get("cache_size", 0)), 1.0, 0.0,
                           retraces=rec.get("retraces"))]
