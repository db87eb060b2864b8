"""The chaos drills as the port's command line, ``python -m
grace_tpu_torch.resilience.smoke``: the counterpart of the repository's
``tools/chaos_smoke.py``, with its flags, scenarios, acceptance facts,
exit codes and evidence documents.

Each rank is one process of a ``torch.distributed`` group (``--world N``
ranks, gloo on the CPU with ``--device cpu``, NCCL on the cards by
default), and every rank runs the whole scenario in lockstep: it feeds the
same aggregated telemetry to its own monitors and controllers, reaches the
same decisions and judges the same acceptance facts. The run exits 0 only
when every rank does.

Scenarios (one module each):

* :mod:`.base` — the default NaN-injection run (the guard must trip and
  contain the faults) and its variants ``--sdc`` (single-rank parameter
  corruption, repaired by the consensus audit), ``--hier``, ``--homo``,
  ``--watch`` (single-rank drift flagged by the watch), ``--pipeline N``
  (the double-buffered packed ring) and ``--lint`` (the static auditor
  first), ``--profile``;
* :mod:`.adapt` — ``--adapt``: drift → tighten before any guard event →
  quiet → loosen → NaN → the guard trips and the ladder escalates;
* :mod:`.elastic` — ``--elastic``: drift → watch drain → the flagged rank
  (its slice with ``--hier``) leaves → W−1 → rejoin behind the barrier;
* :mod:`.region` — ``--region``: the same over a whole region of a
  2 regions × 2 slices × 2 ranks layout;
* :mod:`.retune` — ``--retune``: fleet drift → a two-phase promotion →
  probation → promotion back → a sabotaged promotion demoted bit for bit;
* :mod:`.fsdp` — ``--fsdp``: the chaos matrix over a dp×fsdp mesh.

The evidence documents (:mod:`.evidence`) have the keys of the JAX
package's ``ADAPT_LAST.json``, ``ELASTIC_LAST.json``, ``REGION_LAST.json``
and ``RETUNE_LAST.json``; by default they land in ``grace_tpu_torch/``
(never over the repository root's), and the port's evidence summary
(``python -m grace_tpu_torch.evidence.summary``) renders them.
"""
