"""The cross-rank consistency audit and its repair; counterpart of the JAX
package's ``resilience/consensus.py``.

Error feedback is only correct while every replica holds the same state:
the parameters, the optimizer's state, the guard's counters and the
replicated GraceState fields (``count``, ``seed``, ``fallback``,
``audit``, ``adapt``). ``mem`` and ``comp`` are per rank by design, and so are the
rings. A bit flipped in one rank's copy of the parameters is finite, and
the exchanged updates stay the same on every rank, so the guard never sees
it and the replicas stay apart for good. This module closes that gap:

**Fingerprint** (:func:`fingerprint_tree`): fold the replicated state into
a ``(2·segments,)`` vector. Leaf ``i`` folds into segment ``i % segments``
twice: a position-weighted bit checksum (the leaf's bit pattern as 32-bit
words, each XORed with a per-leaf salt, times an odd per-position weight,
summed mod 2^32, so ``-0.0`` and ``+0.0``, NaN payloads and swapped
elements all differ) and a float32 sum of the values of its floating
leaves. The checksum words equal the JAX package's bit for bit on the same
list of arrays; the float fold sums in another order, within float32
rounding. The port computes it over one flat stream of words a chunk at a
time (the leaves ordered by segment, 2^24 words a chunk): a few dozen
launches for any number of leaves, and integer sums, which give the same
words in any order.

**Audit** (:func:`consensus_step`, every ``audit_every`` steps): all-gather
the fingerprints over the group and read the ``(W, 2·segments)`` matrix to
the host, the one synchronizing read of an audit step. Every rank reads
the same matrix, so every rank elects the same reference rank (the lowest
rank among those whose fingerprint matches the most others) and takes the
same branch, and the repair's collectives meet.

**Repair** (on a divergence): broadcast the reference rank's replicated
state bit for bit (:func:`~grace_tpu_torch.comm.masked_broadcast_`, a
masked SUM in integer bit space), in place into the live tensors; zero the
divergent rank's residuals in place (they are per rank and suspect, and
error feedback re-accumulates them; a kernel that writes its residual in
place keeps writing the same buffer); advance the replicated
:class:`~grace_tpu_torch.transform.AuditState`; and **escalate** when the
same rank diverges again within ``escalate_window`` steps of its last
repair: the GraceState's ``fallback`` is set and a guard's
``fallback_remaining`` raised to ``escalate_steps``, so the next update
runs the dense escape and the guard's countdown owns the window.

The audit clock is the guard's ``step`` (kept on the host, it advances on
every step, skipped ones too) when a guard wraps the transform, else
``GraceState.count``; neither is read from the device. The audit's wire
bytes (the fingerprint gather, and the repair's broadcast) are folded into
the telemetry row of the step that ran, as ``audit_bytes`` and in
``wire_bytes``.

Wiring: build the transform with ``consensus=...``
(``grace_from_params({"consensus": ...})``) and pass the config to
``train.make_train_step(consensus=...)``; the hook runs after the
optimizer step (and the guard).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.comm import _all_gather_into, masked_broadcast_
from grace_tpu_torch.resilience.adapt import ADAPT_HOST_FIELDS
from grace_tpu_torch.resilience.guard import _COUNTERS, GuardState
from grace_tpu_torch.telemetry.scopes import STAGE_CONSENSUS, trace_stage
from grace_tpu_torch.telemetry.state import FIELD_INDEX, TelemetryState
from grace_tpu_torch.transform import AuditState, GraceState, _state_tensors

__all__ = ["ConsensusConfig", "normalize_consensus", "replicated_view",
           "fingerprint_tree", "consensus_step", "force_audit",
           "audit_report"]

# Knuth multiplicative-hash constants of the position-weighted fold.
_PRIME_POS = 2654435761
_PRIME_LEAF = 2246822519
_SALT = 374761393
_MASK32 = 0xFFFFFFFF
# Words a chunk of the fingerprint's stream: bounds its temporaries.
_CHUNK = 1 << 24


def _i32(v: int) -> int:
    """The low 32 bits of ``v`` as a signed int32 value (two's complement):
    int32 tensor arithmetic wraps mod 2^32 exactly as uint32 does."""
    v &= _MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """``audit_every``: steps between audits. ``segments``: leaves fold
    into this many buckets, two words each. ``zero_residuals``: zero the
    divergent rank's ``mem`` on repair. ``escalate_window`` and
    ``escalate_steps``: when the same rank diverges again within the
    window of its last repair, the dense escape runs for that many steps
    (set both or neither)."""

    audit_every: int = 50
    segments: int = 8
    zero_residuals: bool = True
    escalate_window: Optional[int] = None
    escalate_steps: Optional[int] = None

    def __post_init__(self):
        if self.audit_every < 1:
            raise ValueError(f"audit_every must be >= 1; "
                             f"got {self.audit_every}")
        if self.segments < 1:
            raise ValueError(f"segments must be >= 1; got {self.segments}")
        if (self.escalate_window is None) != (self.escalate_steps is None):
            raise ValueError("escalate_window and escalate_steps must be "
                             "set together")
        if self.escalate_steps is not None and self.escalate_steps < 1:
            raise ValueError(f"escalate_steps must be >= 1; "
                             f"got {self.escalate_steps}")


def normalize_consensus(consensus) -> Optional[ConsensusConfig]:
    """The knob's spellings: None/False (off), True (defaults), an int
    (``audit_every``), a dict (config kwargs) or a ConsensusConfig."""
    if consensus is None or consensus is False:
        return None
    if consensus is True:
        return ConsensusConfig()
    if isinstance(consensus, ConsensusConfig):
        return consensus
    if isinstance(consensus, int):
        return ConsensusConfig(audit_every=consensus)
    if isinstance(consensus, dict):
        return ConsensusConfig(**consensus)
    raise TypeError(f"consensus must be None/bool/int/dict/ConsensusConfig; "
                    f"got {type(consensus).__name__}")


# -- the state tree ----------------------------------------------------------

def _children(node) -> Optional[list]:
    """A state node's children, or None for a leaf. A guard's GraceState is
    reached without settling its step."""
    if isinstance(node, GuardState):
        return [node._inner]
    if isinstance(node, (list, tuple)):
        return list(node)
    if isinstance(node, dict):
        return list(node.values())
    if dataclasses.is_dataclass(node) and not isinstance(node, type) \
            and not isinstance(node, GraceState):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    return None


def _nodes(tree, cls) -> list:
    """Every node of type ``cls`` in ``tree``, in walk order."""
    found, stack = [], [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, cls):
            found.append(node)
        kids = _children(node)
        if kids:
            stack.extend(reversed(kids))
    return found


def _host_scalars(g: GraceState) -> torch.Tensor:
    """A GraceState's replicated host fields as one int64 CPU tensor:
    ``count``, ``seed`` (mod 2^64, as the streams use it), ``fallback``,
    the AuditState's five counters and the AdaptState's eight host ints
    (its pending boundary decision made first)."""
    seed = g.seed & ((1 << 64) - 1)
    vals = [g.count, seed - (1 << 64) if seed >= 1 << 63 else seed,
            int(bool(g.fallback))]
    if g.audit is not None:
        vals += list(g.audit)
    if g.adapt is not None:
        vals += g.adapt.host_fields()
    return torch.tensor(vals, dtype=torch.int64)


def _from_host_scalars(g: GraceState, vals: list) -> GraceState:
    n = 3 + (len(AuditState._fields) if g.audit is not None else 0)
    audit = AuditState(*vals[3:n]) if g.audit is not None else None
    adapt = g.adapt
    if adapt is not None:
        adapt = adapt.replace(**dict(zip(ADAPT_HOST_FIELDS, vals[n:])))
    return dataclasses.replace(g, count=vals[0], seed=vals[1] % (1 << 64),
                               fallback=bool(vals[2]), audit=audit,
                               adapt=adapt)


# The JAX package's byte widths of a GraceState's replicated fields: an
# int32 count, a two-word threefry key, a bool flag, five int32 counters;
# the AdaptState's eight int32 host fields (its two float32 statistics are
# tensors of the view).
_GRACE_SCALAR_NBYTES = 4 + 8 + 1
_AUDIT_NBYTES = 5 * 4
_ADAPT_HOST_NBYTES = 8 * 4


def _view(tree, leaves: list, graces: list) -> None:
    def walk(node):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            # A view: a repair writes through it.
            leaves.append(node.detach() if node.requires_grad else node)
        elif isinstance(node, torch.nn.Module):
            leaves.extend(node.state_dict().values())
        elif isinstance(node, torch.optim.Optimizer):
            for group in node.param_groups:
                for p in group["params"]:
                    st = node.state.get(p, {})
                    leaves.extend(st[k] for k in sorted(st)
                                  if torch.is_tensor(st[k]))
        elif isinstance(node, GuardState):
            leaves.extend(getattr(node, name) for name in _COUNTERS)
            walk(node._inner)
        elif isinstance(node, GraceState):
            graces.append((node, len(leaves)))
            leaves.append(_host_scalars(node))
            if node.adapt is not None:
                # The window statistics, on the device: a repair writes
                # through them.
                leaves.extend([node.adapt.err_sum, node.adapt.err_peak])
        else:
            for child in _children(node) or ():
                walk(child)

    walk(tree)


def replicated_view(tree) -> list:
    """The tensors that must be the same on every rank, in walk order:
    a module's ``state_dict`` (parameters and buffers), an optimizer's
    tensor state (parameter by parameter, keys sorted), a guard's five
    counters, and each GraceState's replicated host fields as one int64
    tensor (``count``, ``seed``, ``fallback``, the audit's counters, the
    adaptive controller's host ints), then the controller's two window
    statistics. The per-rank ``mem``, ``comp`` and rings are left out. Tensors and dicts,
    lists, tuples and dataclasses of them walk as they are."""
    leaves: list = []
    _view(tree, leaves, [])
    return leaves


def _view_nbytes(leaves: list, graces: list) -> int:
    """The replicated view's bytes as the JAX package counts them: tensors
    at their size, a GraceState's host fields at JAX's widths."""
    host = {idx for _, idx in graces}
    total = sum(t.numel() * t.element_size()
                for i, t in enumerate(leaves) if i not in host)
    for g, _ in graces:
        total += (_GRACE_SCALAR_NBYTES + (_AUDIT_NBYTES if g.audit else 0)
                  + (_ADAPT_HOST_NBYTES if g.adapt is not None else 0))
    return total


# -- the fingerprint ---------------------------------------------------------

def _words(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bit pattern as a 1-D int32 stream of 32-bit words (JAX's
    ``_word_stream``): 4-byte elements as they are, narrower ones
    zero-extended, bools as 0/1, 8-byte ones split into all low words then
    all high words."""
    flat = t.reshape(-1)
    if t.dtype == torch.bool:
        return flat.to(torch.int32)
    size = t.element_size()
    if size == 4:
        return flat.view(torch.int32)
    if size == 8:
        v = flat.view(torch.int64)
        return torch.cat([v.to(torch.int32), (v >> 32).to(torch.int32)])
    if size == 2:
        return flat.view(torch.int16).to(torch.int32) & 0xFFFF
    return flat.view(torch.uint8).to(torch.int32)


@functools.lru_cache(maxsize=16)
def _plan(sig: tuple, segments: int):
    """The stream layout of leaves ``sig`` (``(index, words, is float32)``
    each, non-empty): the float32 leaves first, then the rest, each part
    ordered by segment, cut into chunks of at most ``_CHUNK`` words. Each
    chunk is ``(pieces, runs)``: ``pieces`` as ``(index, first word,
    words)``, ``runs`` as ``(segment, start, end, float32)`` contiguous
    ranges of the chunk."""
    order = sorted(sig, key=lambda e: (not e[2], e[0] % segments, e[0]))
    chunks, pieces, runs, used = [], [], [], 0
    for i, n, f32 in order:
        a = 0
        while a < n:
            take = min(n - a, _CHUNK - used)
            seg = i % segments
            if not runs or runs[-1][0] != seg or runs[-1][3] != f32:
                runs.append([seg, used, used, f32])
            runs[-1][2] = used + take
            pieces.append((i, a, take))
            used += take
            a += take
            if used == _CHUNK:
                chunks.append((tuple(pieces), tuple(map(tuple, runs))))
                pieces, runs, used = [], [], 0
    if pieces:
        chunks.append((tuple(pieces), tuple(map(tuple, runs))))
    return tuple(chunks)


@functools.lru_cache(maxsize=64)
def _piece_tables(pieces: tuple, device: str):
    """One chunk's per-element salt and position shift as sparse deltas on
    ``device`` (cached: built and copied once a layout): the chunk offsets
    where a piece starts, and each piece's salt and shift less the
    previous piece's, mod 2^32. A cumulative sum of the deltas scattered
    at those offsets is the per-element value."""
    starts, dsalt, dshift, off = [], [], [], 0
    prev_salt = prev_shift = 0
    for i, a, take in pieces:
        salt, shift = i * _PRIME_LEAF + _SALT, off - a
        starts.append(off)
        dsalt.append(_i32(salt - prev_salt))
        dshift.append(_i32(shift - prev_shift))
        prev_salt, prev_shift = salt, shift
        off += take
    dev = torch.device(device)
    return (torch.tensor(starts, dtype=torch.int64).to(dev),
            torch.tensor(dsalt, dtype=torch.int32).to(dev),
            torch.tensor(dshift, dtype=torch.int32).to(dev))


def _expand(starts, deltas, m: int) -> torch.Tensor:
    """The per-element int32 values of a chunk: ``deltas`` scattered at
    ``starts`` and summed cumulatively (int32 wraps as uint32 does)."""
    d = torch.zeros(m, dtype=torch.int32, device=deltas.device)
    d.index_put_((starts,), deltas)
    return torch.cumsum(d, 0, dtype=torch.int32)


def _fold(indexed: list, segments: int, device: torch.device):
    """``(bits, vals)`` of ``indexed`` (``(leaf index, tensor)`` on
    ``device``, none empty): the int64 sums of the weighted words and the
    float32 value sums, each ``(segments,)``, on ``device``."""
    tensors = dict(indexed)
    f32 = {i for i, t in indexed if t.dtype == torch.float32}
    words = {i: _words(t) for i, t in indexed if i not in f32}
    sig = tuple((i, t.numel() if i in f32 else words[i].numel(), i in f32)
                for i, t in indexed)
    bit_parts = [[] for _ in range(segments)]
    val_parts = [[] for _ in range(segments)]
    prime_pos = _i32(_PRIME_POS)
    for pieces, runs in _plan(sig, segments):
        parts, whole = [], []
        for i, a, take in pieces:
            t = tensors[i]
            if i in f32 and a == 0 and take == t.numel():
                whole.append(t)           # whole float32 leaves: one cat
                continue
            if whole:
                parts.append(torch._utils._flatten_dense_tensors(whole))
                whole = []
            src = t.reshape(-1) if i in f32 else words[i]
            parts.append(src[a:a + take].view(src.dtype))
        if whole:
            parts.append(torch._utils._flatten_dense_tensors(whole))
        parts = [q.view(torch.int32) for q in parts]
        buf = parts[0] if len(parts) == 1 else torch.cat(parts)
        m = buf.numel()
        for seg, start, end, is_f32 in runs:
            if is_f32:
                val_parts[seg].append(buf[start:end].view(torch.float32)
                                      .sum())
        if len(pieces) == 1:
            i, a, _ = pieces[0]
            weight = torch.arange(a, a + m, dtype=torch.int32, device=device)
            mixed = buf ^ _i32(i * _PRIME_LEAF + _SALT)
        else:
            starts, dsalt, dshift = _piece_tables(pieces, str(device))
            weight = torch.arange(m, dtype=torch.int32, device=device)
            weight -= _expand(starts, dshift, m)
            mixed = buf ^ _expand(starts, dsalt, m)
        weight.mul_(prime_pos).bitwise_or_(1)      # (p·PRIME_POS) | 1
        mixed.mul_(weight)                         # wraps mod 2^32
        for seg, start, end, _ in runs:
            bit_parts[seg].append(mixed[start:end].sum(dtype=torch.int64))
    # Floating leaves that are not float32 fold their values one by one.
    for i, t in indexed:
        if t.is_floating_point() and i not in f32:
            val_parts[i % segments].append(t.float().sum())
    return (_segment_sums(bit_parts, torch.int64, device),
            _segment_sums(val_parts, torch.float32, device))


def _segment_sums(parts: list, dtype, device) -> torch.Tensor:
    """``(segments,)``: each segment's parts summed in a fixed order (a
    padded matrix's row sums: the same bits on every rank)."""
    width = max(len(p) for p in parts)
    if width == 0:
        return torch.zeros(len(parts), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    rows = [torch.stack(p + [zero] * (width - len(p))) for p in parts]
    return torch.stack(rows).sum(1, dtype=dtype)


def fingerprint_tree(tree, segments: int = 8) -> torch.Tensor:
    """This rank's fingerprint of ``tree``: a ``(2·segments,)`` int64
    tensor of 32-bit words (``[0, 2^32)``), the bit checksums then the
    float32 value folds' bit patterns (module docstring). ``tree`` is a
    list of tensors (leaf ``i`` is its ``i``-th), or any state
    :func:`replicated_view` walks. Leaves on another device than the first
    device tensor's (an optimizer's CPU counters beside CUDA parameters)
    fold on the host and join as scalars. No collective, no device read;
    ranks holding the same bits compute the same words."""
    leaves = replicated_view(tree)
    device = next((t.device for t in leaves if t.device.type != "cpu"),
                  torch.device("cpu"))
    near = [(i, t) for i, t in enumerate(leaves)
            if t.numel() and t.device == device]
    far = [(i, t.cpu()) for i, t in enumerate(leaves)
           if t.numel() and t.device != device]
    if near:
        bits, vals = _fold(near, segments, device)
    else:
        bits = torch.zeros(segments, dtype=torch.int64, device=device)
        vals = torch.zeros(segments, dtype=torch.float32, device=device)
    if far:
        hbits, hvals = _fold(far, segments, torch.device("cpu"))
        for s, (b, v) in enumerate(zip(hbits.tolist(), hvals.tolist())):
            if b:
                bits[s].add_(b)
            if v:
                vals[s].add_(v)
    return torch.cat([bits & _MASK32,
                      vals.view(torch.int32).to(torch.int64) & _MASK32])


# -- the audit and its repair ------------------------------------------------

def _rank_world(group) -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def _armed(tree) -> list:
    armed = [g for g in _nodes(tree, GraceState) if g.audit is not None]
    if not armed:
        raise ValueError(
            "consensus auditing is configured but the state carries no "
            "AuditState — build the grace transform with consensus=... "
            "(grace_from_params({'consensus': ...})) and re-init the "
            "optimizer state, or restore a checkpoint written with a "
            "consensus-armed transform.")
    return armed


def consensus_step(tree, consensus, group=None):
    """The audit-and-repair hook over a whole train state (``tree``: a
    ``train.TrainState``, or any tree of modules, optimizers, guard and
    GraceStates, tensors, dicts, lists and tuples holding at least one
    consensus-armed GraceState). On every ``audit_every``-th step of the
    clock (the guard's host-side ``step`` when a guard is present, else
    ``GraceState.count``) it audits and, on a divergence, repairs (module
    docstring); other steps return ``tree`` as it is, with no device work.
    Tensors are repaired in place; the returned tree carries the new
    GraceStates (and guard states). Every rank of ``group`` calls it at
    the same steps."""
    config = normalize_consensus(consensus)
    if config is None:
        return tree
    armed = _armed(tree)
    guards = _nodes(tree, GuardState)
    clock = guards[0].host_step if guards else armed[0].count
    if clock % config.audit_every:
        return tree
    return _audit(tree, config, group)


def force_audit(tree, consensus, group=None):
    """One audit and repair now, whatever the clock: the scheduled
    :func:`consensus_step` without its gate (a rejoining rank's admission
    check)."""
    config = normalize_consensus(consensus)
    if config is None:
        raise ValueError(
            "force_audit needs an armed consensus config (True / "
            "audit_every / ConsensusConfig) — None/False disables the "
            "auditor, which cannot gate a rejoin.")
    _armed(tree)
    return _audit(tree, config, group)


def _audit(tree, config: ConsensusConfig, group):
    with trace_stage(STAGE_CONSENSUS):
        for guard in _nodes(tree, GuardState):
            guard.settle()    # the matrix read below waits for the step
        leaves, graces = [], []
        _view(tree, leaves, graces)
        rank, world = _rank_world(group)
        fp = fingerprint_tree(leaves, config.segments)
        if world > 1:
            out = torch.empty(world * fp.numel(), dtype=fp.dtype,
                              device=fp.device)
            _all_gather_into(out, fp, group=group)
            fp = out
        fps = fp.view(world, -1).cpu().numpy()   # the one read an audit

        # The agreement matrix is the same on every rank, so the election
        # and every branch below are too.
        eq = np.all(fps[:, None, :] == fps[None, :, :], axis=-1)
        matches = eq.sum(axis=1)
        best = matches.max()
        ref = int(np.argmax(matches == best))    # lowest rank of majority
        any_div = bool(best < world)
        divergent = int(np.argmax(~eq[ref])) if any_div else -1
        count = graces[0][0].count
        extra = np.float32(world * 2 * config.segments * 4)
        current = [g for g, _ in graces]
        if any_div:
            extra += np.float32(_view_nbytes(leaves, graces))
            current = _repair(leaves, graces, ref, not eq[rank, ref],
                              config, group)
        escalate = any_div and _escalates(current, config, count, divergent)
        advanced = {id(orig): _advance(g, any_div, escalate, count,
                                       divergent)
                    for (orig, _), g in zip(graces, current)}
        for g in advanced.values():
            _account_audit_bytes(g, count, float(extra))
        return _rebuild(tree, advanced,
                        config.escalate_steps if escalate else None)


def _repair(leaves, graces, ref, diverged_me, config, group) -> list:
    """The reference rank's replicated tensors into every rank's, bit for
    bit and in place (host tensors through the group's device), and the
    divergent rank's residuals zeroed in place. Returns the GraceStates
    rebuilt from the broadcast host fields."""
    host = {idx for _, idx in graces}
    device = next((t.device for t in leaves if t.device.type != "cpu"),
                  torch.device("cpu"))
    masked_broadcast_([t for i, t in enumerate(leaves)
                       if i not in host and t.device == device], ref, group)
    far = [t for i, t in enumerate(leaves)
           if i in host or t.device != device]
    if far:
        moved = [t.to(device) for t in far]
        masked_broadcast_(moved, ref, group)
        for t, m in zip(far, moved):
            t.copy_(m.cpu())       # host tensors: a read, on repairs only
    out = []
    for g, idx in graces:
        if diverged_me and config.zero_residuals:
            for t in _state_tensors(g.mem):
                t.zero_()          # the same storage a kernel writes
        out.append(_from_host_scalars(g, leaves[idx].tolist()))
    return out


def _escalates(graces, config, count, divergent) -> bool:
    """The same rank diverged again within ``escalate_window`` steps of
    its last repair (read from the reference's AuditState)."""
    if config.escalate_window is None:
        return False
    prev = next(g.audit for g in graces if g.audit is not None)
    return (divergent == prev.last_divergent_rank
            and count - prev.last_repair_step <= config.escalate_window)


def _advance(g: GraceState, any_div: bool, escalate: bool, count: int,
             divergent: int) -> GraceState:
    """``g`` with its AuditState bumped and, on an escalation, its
    fallback flag set."""
    audit = g.audit
    if audit is not None:
        audit = AuditState(
            audits=audit.audits + 1,
            repairs=audit.repairs + int(any_div),
            escalations=audit.escalations + int(escalate),
            last_divergent_rank=(divergent if any_div
                                 else audit.last_divergent_rank),
            last_repair_step=count if any_div else audit.last_repair_step)
    return dataclasses.replace(g, audit=audit,
                               fallback=bool(g.fallback) or escalate)


def _account_audit_bytes(g: GraceState, count: int, extra: float) -> None:
    """The audit's wire bytes into the telemetry row of the step that just
    ran (``count - 1``), in ``wire_bytes`` and ``audit_bytes``, on the
    device and in place; only where that slot holds that step (JAX's
    guard on the row's step id)."""
    t = g.telem
    if not isinstance(t, TelemetryState):
        return
    row = count - 1
    slot = row % t.steps.shape[0]
    add = (t.steps[slot] == row).to(torch.float32) * extra
    t.rings[slot, FIELD_INDEX["wire_bytes"]].add_(add)
    t.rings[slot, FIELD_INDEX["audit_bytes"]].add_(add)


def _rebuild(tree, graces: dict, escalate_steps: Optional[int]):
    """``tree`` with its GraceStates replaced by ``graces`` (keyed by the
    old ones' ids), and each guard's dense window armed for
    ``escalate_steps`` (None: no escalation)."""
    if isinstance(tree, GraceState):
        return graces.get(id(tree), tree)
    if isinstance(tree, GuardState):
        out = tree.replace(inner=_rebuild(tree._inner, graces,
                                          escalate_steps))
        return out if escalate_steps is None else \
            out.escalate(escalate_steps)
    if isinstance(tree, (torch.Tensor, torch.nn.Module,
                         torch.optim.Optimizer)):
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, graces, escalate_steps)
                            for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, graces, escalate_steps) for v in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, graces, escalate_steps)
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), graces, escalate_steps)
            for f in dataclasses.fields(tree)})
    return tree


# -- host-side reporting -----------------------------------------------------

def audit_report(state: Any) -> dict:
    """The first armed AuditState's counters in ``state``::

        {"audits", "repairs", "escalations",
         "last_divergent_rank", "last_repair_step"}

    (host values: no transfer, and a guard's pending step is not waited
    for). An empty dict when no GraceState carries one."""
    audits = [g.audit for g in _nodes(state, GraceState)
              if g.audit is not None]
    return dict(audits[0]._asdict()) if audits else {}
