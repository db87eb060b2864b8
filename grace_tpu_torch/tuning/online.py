"""The online re-tuning funnel: the tuner's decision loop, bounded;
counterpart of the JAX package's ``tuning/online.py``.

:func:`grace_tpu_torch.tuning.run_tune` is an offline ceremony: it owns
its process and profiles at leisure. A re-tune taken mid-run cannot: a
hung candidate must cost a bounded number of seconds. So
:func:`online_funnel` is ``run_tune``'s funnel with the offline parts cut
away and the bounded parts forced on: the same static funnel
(:func:`~grace_tpu_torch.tuning.prune.static_prune`), the same measured
shortlist (:func:`~grace_tpu_torch.tuning.measure.measure_shortlist`) with
a finite ``measure_timeout_s`` by default, no overlap sandwich and no
evidence file, and ``include``/``exclude`` hooks for the incumbent and
prescribed candidates.

The static stage traces over a fake default process group of its own
(:mod:`grace_tpu_torch.analysis.trace`), so the funnel runs where no
default group exists yet: it then measures in a one-rank group it makes
on ``device`` (:func:`~grace_tpu_torch.tuning.measure.measuring_group`).
Beside a live default group (a re-tune taken mid-run), the static stage
(:func:`online_static`) runs in a process of its own and
:func:`online_measure` measures its shortlist over the live group
(:meth:`grace_tpu_torch.resilience.retune.RetuneController.propose`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from grace_tpu_torch.tuning.candidates import Candidate, enumerate_candidates
from grace_tpu_torch.tuning.cost import TuneTopology
from grace_tpu_torch.tuning.measure import (measure_shortlist,
                                            measuring_group, model_structs)
from grace_tpu_torch.tuning.prune import static_prune

__all__ = ["ONLINE_MEASURE_TIMEOUT_S", "online_candidates",
           "online_static", "online_measure", "online_funnel"]

# Finite: a decision taken mid-run never inherits the offline tuner's
# unbounded wait. None opts back into it, on purpose.
ONLINE_MEASURE_TIMEOUT_S = 120.0


def online_candidates(spec: TuneTopology,
                      include: Optional[Sequence[Candidate]] = None,
                      exclude: Iterable[str] = ()) -> List[Candidate]:
    """The field of one decision: ``spec``'s candidates, plus
    ``include``, minus the ``exclude``\\ d names."""
    cands = list(enumerate_candidates(spec))
    if include:
        names = {c.name for c in cands}
        cands += [c for c in include if c.name not in names]
    drop = set(exclude)
    return [c for c in cands if c.name not in drop]


def online_static(topology: Union[str, TuneTopology], *,
                  model: str = "toy", shortlist_n: int = 3,
                  audit_world: int = 8,
                  include: Optional[Sequence[Candidate]] = None,
                  exclude: Iterable[str] = ()) -> Dict[str, Any]:
    """The decision's static funnel alone (it traces over a fake default
    group, so it runs where no default group exists: before one, or in a
    process of its own beside a training run's). The ``include``\\ d
    candidates are measured besides the shortlist when they pass the price
    stage (the JAX package only adds them to the field)."""
    spec = (topology if isinstance(topology, TuneTopology)
            else TuneTopology.parse(topology))
    return static_prune(online_candidates(spec, include, exclude), spec,
                        model_structs(model), audit_world=audit_world,
                        shortlist_n=shortlist_n,
                        include=[c.name for c in include or ()])


def online_measure(topology: Union[str, TuneTopology],
                   funnel: Dict[str, Any], group=None, *, device="cuda",
                   model: str = "toy", timed_steps: int = 4,
                   repeats: int = 1, seed: int = 0,
                   measure_timeout_s: Optional[float]
                   = ONLINE_MEASURE_TIMEOUT_S,
                   measure_retries: int = 1,
                   include: Optional[Sequence[Candidate]] = None,
                   exclude: Iterable[str] = ()) -> Dict[str, Any]:
    """Measure the shortlist of :func:`online_static`'s ``funnel`` over
    ``group`` (None: the default group) with bounded per-candidate waits;
    ``include``/``exclude`` as given to the static stage. Returns
    ``{"topology", "static", "measured", "winner", "winner_params"}``."""
    spec = (topology if isinstance(topology, TuneTopology)
            else TuneTopology.parse(topology))
    by_name = {c.name: c for c in online_candidates(spec, include, exclude)}
    measured = measure_shortlist(
        [by_name[n] for n in funnel["shortlist"]], spec, group,
        model=model, timed_steps=timed_steps, repeats=repeats, seed=seed,
        measure_timeout_s=measure_timeout_s,
        measure_retries=measure_retries, device=device)
    winner = measured["winner"]
    return {"topology": spec.label, "static": funnel, "measured": measured,
            "winner": winner,
            "winner_params": (dict(by_name[winner].params)
                              if winner is not None else None)}


def online_funnel(topology: Union[str, TuneTopology], *, device="cuda",
                  model: str = "toy", shortlist_n: int = 3,
                  audit_world: int = 8, timed_steps: int = 4,
                  repeats: int = 1, seed: int = 0,
                  measure_timeout_s: Optional[float]
                  = ONLINE_MEASURE_TIMEOUT_S,
                  measure_retries: int = 1,
                  include: Optional[Sequence[Candidate]] = None,
                  exclude: Iterable[str] = ()) -> Dict[str, Any]:
    """One bounded re-tune decision: the candidates of ``topology`` (plus
    ``include``, minus ``exclude``), the static funnel, the shortlist
    measured with bounded per-candidate waits. Returns ``{"topology",
    "static", "measured", "winner", "winner_params"}``; ``winner`` is None
    when nothing reached a measurement (stay on the incumbent)."""
    funnel = online_static(topology, model=model, shortlist_n=shortlist_n,
                           audit_world=audit_world, include=include,
                           exclude=exclude)
    with measuring_group(device) as (group, dev):
        return online_measure(
            topology, funnel, group, device=dev, model=model,
            timed_steps=timed_steps, repeats=repeats, seed=seed,
            measure_timeout_s=measure_timeout_s,
            measure_retries=measure_retries, include=include,
            exclude=exclude)
