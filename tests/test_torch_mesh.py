"""The port's 2-D dp×fsdp mesh against the JAX package's, on the CPU.

One spawned gloo group of 8 ranks runs every multi-rank case; the JAX
references run on the 8-device CPU mesh in the parent meanwhile. The
workers import no JAX (this module imports it inside the functions that
need it).

* ``MeshSpec`` gives JAX's validation errors; ``parallel.make_mesh`` lays
  rank ``r`` out at dp index ``r // fsdp`` and fsdp index ``r % fsdp``,
  and the groups hold the ranks JAX's axes hold.
* Degenerate collapse: ``tests/test_shard.py``'s three configurations
  (topk-allgather, fp16-rscatter, homoqsgd-ring) on an 8×1 mesh equal the
  port's 1-D path and JAX's ``_update_once`` bit for bit (homoqsgd given
  JAX's uniforms through a table key).
* JAX's ``test_fsdp_train_step_per_shard_residuals`` at 4×2: its MLP, its
  init, the routed ``rscatter`` config, 8 steps. The losses equal JAX's
  within rtol 1e-5, and each rank's ``w1``/``w2`` residuals equal JAX's
  device row ``r`` within rtol 2e-4, atol 2e-5 (float32 matmul and softmax
  orders, compounded over 8 steps of error feedback: 1.25e-5 at most
  measured), with the shard shapes ``(8, 8)`` and ``(8, 10)``; the step-0 per-shard gradients (through the port's
  differentiable ``parallel.psum`` and ``parallel.all_gather``) equal
  JAX's, the fsdp width's factor of the ``psum`` transpose included.
* The drill: ``tools/chaos_smoke.py --fsdp``'s configuration (every
  parameter sharded over fsdp, the routed ``rscatter`` exchange with the
  fp16 bias route, ``slice_size`` 2 inside the dp axis, the fp16 escape,
  the guard and the consensus audit), 16 steps. A NaN planted in one fsdp
  shard's gradient on one rank skips the step on all 8 ranks (the
  mesh-wide OR), as in JAX; two ``ChaosParams`` bit flips on rank 5 are
  repaired within its dp group, with JAX's per-fsdp-group repair counts
  ``[0, 2]``; after every step the guard's counters, each rank's
  ``AuditState`` and its telemetry ring's byte columns (all DCN: 1176 B a
  compressed step) equal JAX's, and the parameters JAX's device rows
  within atol 1e-5 (matmul and fp16 all-reduce orders), bit-identical
  across each dp group's replicas. The JAX scenario's NaN implant
  (``ChaosCommunicator``) draws a probability per (step, leaf); its rank
  gate reads the dp rank, which the workers check on the port's.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from grace_tpu_torch.core import LeafKey

WORLD = 8
TIMEOUT_S = 240

# -- the degenerate collapse: tests/test_shard.py:236-251 -------------------------
COLLAPSE = {
    "topk-allgather": {"compressor": "topk", "compress_ratio": 0.3,
                       "memory": "residual", "communicator": "allgather"},
    "fp16-rscatter": {"compressor": "fp16", "memory": "none",
                      "communicator": "rscatter", "fusion": "flat"},
    "homoqsgd-ring": {"compressor": "homoqsgd", "quantum_num": 7,
                      "memory": "residual", "communicator": "ring",
                      "fusion": "flat"},
}


def int_grads():
    rng = np.random.default_rng(0)
    return rng.integers(-8, 8, (8, 64)).astype(np.float32)


def tie_free_grads():
    """The integer gradients with a distinct 1/1024 step added to every
    magnitude of a row: ``torch.topk`` and ``lax.top_k`` order ties
    differently (ROADMAP queue 3, "Tie order"), so exact Top-K is held
    against JAX on tie-free rows; the sums stay exact in float32."""
    g = int_grads()
    k = np.argsort(np.random.default_rng(1).random((8, 64)), axis=1)
    mag = np.abs(g) + (k + 1).astype(np.float32) / 1024
    return np.where(g < 0, -mag, mag).astype(np.float32)


GRADS = {"int": int_grads, "tie_free": tie_free_grads}


class TableKey(LeafKey):
    """A key whose uniforms are JAX's ``jax.random.uniform`` under
    ``fold_in(fold_in(fold_in(key(seed), count), leaf), *folds)``, from a
    table made in the parent (the workers import no JAX)."""

    TABLE: dict = {}

    def uniform(self, shape, device):
        got = self.TABLE[(self.seed, self.count, self.leaf, self.folds,
                          tuple(shape))]
        return torch.from_numpy(got.copy()).to(device)


def jax_uniform_table():
    """The ring's eight shard encodes at step 0 of a flat (one-bucket)
    exchange of 64 elements over 8 ranks: shards of 8."""
    import jax
    out = {}
    for c in range(WORLD):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.key(0), 0), 0), c)
        out[(0, 0, 0, (c,), (8,))] = np.asarray(jax.random.uniform(k, (8,)))
    return out


# -- the 4×2 train step: tests/test_shard.py:324-399 ----------------------------
FEAT, HID, CLASSES = 16, 8, 10
SHARD = FEAT // 2
B_STEPS = 8
B_CFG = {"compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
         "communicator": "rscatter", "fsdp_axis": "fsdp",
         "route": [("b1", {"compressor": "fp16", "memory": "none",
                           "communicator": "allreduce"})]}


def b_data():
    """JAX's test draws, in its order: the params, then the batch."""
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(FEAT, HID)).astype(np.float32),
              "b1": np.zeros((HID,), np.float32),
              "w2": rng.normal(size=(HID, CLASSES)).astype(np.float32)}
    x = rng.normal(size=(16, FEAT)).astype(np.float32)
    y = rng.integers(0, CLASSES, (16,)).astype(np.int32)
    return params, x, y


# -- the drill: tools/chaos_smoke.py --fsdp's configuration ----------------------
C_FEAT, C_HID, C_CLASSES = 32, 16, 8
C_STEPS, C_BATCH, C_LR = 16, 32, 0.01
C_POISON_STEP, C_POISON_DP = 8, 1          # NaN on rank 3: dp 1, fsdp 1
C_SDC = {"rank": 5, "at_steps": (5, 11), "seed": 2}
C_AUDIT = {"audit_every": 4, "escalate_window": 16, "escalate_steps": 8}
C_SPECS = {"w1": 0, "b1": 0, "w2": 0, "b2": 0}   # every param on fsdp
C_ROW_FIELDS = ("wire_bytes", "wire_bytes_ici", "wire_bytes_dcn")


def c_params(consensus):
    return {
        "compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
        "communicator": "rscatter", "fsdp_axis": "fsdp", "slice_size": 2,
        "route": [("b*", {"compressor": "fp16", "memory": "none",
                          "communicator": "allreduce"})],
        "escape": "fp16", "consensus": consensus, "telemetry": 32}


def c_data():
    rng = np.random.default_rng(0)
    params = {
        "w1": rng.normal(scale=0.3, size=(C_FEAT, C_HID)).astype(np.float32),
        "b1": np.zeros((C_HID,), np.float32),
        "w2": rng.normal(scale=0.3, size=(C_HID, C_CLASSES)).astype(
            np.float32),
        "b2": np.zeros((C_CLASSES,), np.float32)}
    images = rng.normal(size=(4 * C_BATCH, C_FEAT)).astype(np.float32)
    labels = rng.integers(0, C_CLASSES, size=(4 * C_BATCH,)).astype(np.int32)
    return params, images, labels


def c_batch(images, labels, i):
    lo = (i * C_BATCH) % len(images)
    poison = np.zeros((C_BATCH,), np.float32)
    if i == C_POISON_STEP:
        rows = C_BATCH // 4
        poison[C_POISON_DP * rows:(C_POISON_DP + 1) * rows] = 1.0
    return images[lo:lo + C_BATCH], labels[lo:lo + C_BATCH], poison


# -- the port's side ---------------------------------------------------------------

def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _collapse_port(group, rank):
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch import transform as T
    from grace_tpu_torch.parallel import make_mesh

    mesh = make_mesh((WORLD, 1), ("data", "fsdp"), group=group)
    out = {"mesh": np.array([mesh.dp_index, mesh.fsdp_index,
                             mesh.dp_group is group,
                             mesh.fsdp_group is not None])}
    saved = T.LeafKey
    T.LeafKey = TableKey
    try:
        for name, cfg in COLLAPSE.items():
            for gname, make in GRADS.items():
                g = torch.from_numpy(make()[rank:rank + 1].copy())
                for label, grc in (
                        ("1d", grace_from_params(cfg, group=group)),
                        ("2d", grace_from_params(
                            {**cfg, "fsdp_axis": "fsdp"}, group=mesh))):
                    tx = grc.transform(0)
                    upd, _ = tx.update({"g": g.clone()}, tx.init({"g": g}))
                    out[f"collapse/{name}/{gname}/{label}"] = \
                        upd["g"].numpy().copy()
    finally:
        T.LeafKey = saved
    return out


def _b_model(mesh):
    params, _, _ = b_data()
    from grace_tpu_torch.train import shard_params
    local = shard_params({n: torch.from_numpy(a) for n, a in params.items()},
                         {"w1": 0, "b1": None, "w2": None}, mesh)
    return torch.nn.ParameterDict(
        {n: torch.nn.Parameter(t.clone()) for n, t in local.items()})


def _b_loss(mesh):
    from grace_tpu_torch.parallel import psum

    def loss_fn(model, batch):
        x, y = batch
        f = mesh.fsdp_index
        xs = x[:, f * SHARD:(f + 1) * SHARD]
        h = psum(xs @ model["w1"], mesh.fsdp_group) + model["b1"]
        logits = torch.tanh(h) @ model["w2"]
        return torch.nn.functional.cross_entropy(logits, y.long())

    return loss_fn


def _train_b_port(group, rank):
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.parallel import make_mesh
    from grace_tpu_torch.train import init_train_state, make_train_step

    mesh = make_mesh((4, 2), ("data", "fsdp"), group=group)
    specs = {"w1": 0, "b1": None, "w2": None}
    grc = grace_from_params(B_CFG, group=mesh)
    out = {"b/dp_ranks": np.array(
        torch.distributed.get_process_group_ranks(mesh.dp_group)),
        "b/fsdp_ranks": np.array(
        torch.distributed.get_process_group_ranks(mesh.fsdp_group)),
        "b/comm_is_dp": np.array(grc.communicator.group is mesh.dp_group)}
    _, x, y = b_data()
    batch = mesh.dp_rows((torch.from_numpy(x), torch.from_numpy(y)))
    # Step 0's per-shard gradients, before any update.
    model = _b_model(mesh)
    _b_loss(mesh)(model, batch).backward()
    for n, p in model.items():
        out[f"b/grad0/{n}"] = p.grad.numpy().copy()
    model = _b_model(mesh)
    tx = grc.transform(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = init_train_state(model, tx, opt, mesh=mesh, param_specs=specs)
    step = make_train_step(_b_loss(mesh), tx, mesh=mesh, param_specs=specs)
    losses = []
    for _ in range(B_STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    out["b/losses"] = np.array(losses)
    names = sorted(model.keys())
    for n, m in zip(names, state.grace.mem):
        out[f"b/mem/{n}"] = (np.zeros(0) if m is None
                             else m.numpy().copy())
    return out


def _c_model(mesh):
    from grace_tpu_torch.train import shard_params
    params, _, _ = c_data()
    local = shard_params({n: torch.from_numpy(a) for n, a in params.items()},
                         C_SPECS, mesh)
    return torch.nn.ParameterDict(
        {n: torch.nn.Parameter(t.clone()) for n, t in local.items()})


def _c_loss(mesh):
    from grace_tpu_torch.parallel import all_gather, psum
    fs, hs = C_FEAT // 2, C_HID // 2

    def loss_fn(model, batch):
        x, y, poison = batch
        f, grp = mesh.fsdp_index, mesh.fsdp_group
        b1 = all_gather(model["b1"], grp)
        b2 = all_gather(model["b2"], grp)
        xs = x[:, f * fs:(f + 1) * fs]
        h = torch.tanh(psum(xs @ model["w1"], grp) + b1)
        logits = psum(h[:, f * hs:(f + 1) * hs] @ model["w2"], grp) + b2
        ce = torch.nn.functional.cross_entropy(logits, y.long())
        bad = bool(poison.sum() > 0) and f == 1
        return ce + (float("nan") if bad else 0.0) * model["w1"].sum()

    return loss_fn


def _drill_port(group, rank):
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.parallel import make_mesh
    from grace_tpu_torch.resilience import (ChaosCommunicator, ChaosParams,
                                            ConsensusConfig, guarded_chain)
    from grace_tpu_torch.resilience.chaos import _gate
    from grace_tpu_torch.telemetry.state import FIELD_INDEX
    from grace_tpu_torch.train import init_train_state, make_train_step

    mesh = make_mesh((4, 2), ("data", "fsdp"), group=group)
    consensus = ConsensusConfig(**C_AUDIT)
    grc = grace_from_params(c_params(consensus), group=mesh)
    out = {"c/gate": np.array([_gate(r, grc.communicator.group)
                               for r in range(4)]),
           "c/chaos_gate": np.array(ChaosCommunicator(
               inner=grc.communicator, nan_prob=1.0, rank=1).group
               is mesh.dp_group)}
    chain = guarded_chain(grc, fallback_after=3, fallback_steps=8)
    model = _c_model(mesh)
    opt = torch.optim.SGD(model.parameters(), lr=C_LR)
    state = init_train_state(model, chain, opt, mesh=mesh,
                             param_specs=C_SPECS)
    step = make_train_step(_c_loss(mesh), chain, mesh=mesh,
                           param_specs=C_SPECS, consensus=consensus)
    sdc = ChaosParams(**C_SDC)
    _, images, labels = c_data()
    rows = [FIELD_INDEX[f] for f in C_ROW_FIELDS]
    for i in range(C_STEPS):
        state = sdc(state, i)
        x, y, poison = c_batch(images, labels, i)
        batch = mesh.dp_rows((torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(poison)))
        state, loss = step(state, batch)
        guard = state.grace
        out[f"c/{i}/loss"] = np.array(float(loss))
        out[f"c/{i}/counters"] = guard.counters().numpy().copy()
        inner = guard.inner
        out[f"c/{i}/audit"] = np.array(list(inner.audit))
        out[f"c/{i}/fallback"] = np.array(inner.fallback)
        for n, p in model.items():
            out[f"c/{i}/param/{n}"] = p.detach().numpy().copy()
        ring = inner.telem.rings.numpy()
        steps = inner.telem.steps.numpy()
        out[f"c/{i}/rows"] = ring[:, rows].copy()
        out[f"c/{i}/ring_steps"] = steps.copy()
    out["c/injections"] = np.array(sdc.injections)
    return out


def _worker(rank, init_file, table, out_path):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    torch.set_num_threads(1)
    TableKey.TABLE = table
    try:
        out = _collapse_port(group, rank)
        out.update(_train_b_port(group, rank))
        out.update(_drill_port(group, rank))
        np.savez(out_path, **out)
    finally:
        torch.distributed.destroy_process_group()


# -- the JAX side ------------------------------------------------------------------

def _jax_collapse():
    from jax.sharding import PartitionSpec as P

    from grace_tpu.parallel import data_parallel_mesh, make_mesh
    from test_shard import _update_once
    import jax
    import jax.numpy as jnp

    mesh1 = data_parallel_mesh(jax.devices())
    mesh2 = make_mesh((8, 1), ("data", "fsdp"))
    out = {}
    for name, cfg in COLLAPSE.items():
        for gname, make in GRADS.items():
            grads = jnp.asarray(make())
            out[name, gname] = (
                _update_once(cfg, grads, mesh1),
                _update_once({**cfg, "fsdp_axis": "fsdp"}, grads, mesh2,
                             in_spec=P("data")))
    return out


def _find_grace(tree):
    import jax

    from grace_tpu.transform import GraceState
    found = []
    jax.tree_util.tree_map(
        lambda n: found.append(n) if isinstance(n, GraceState) else n,
        tree, is_leaf=lambda n: isinstance(n, GraceState))
    return found[0]


def _per_device(leaf):
    return np.stack([np.asarray(s.data) for s in sorted(
        leaf.addressable_shards, key=lambda s: s.device.id)])


def _jax_train_b():
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from grace_tpu import grace_from_params as jax_grace
    from grace_tpu.parallel import make_mesh, shard_map
    from grace_tpu.train import init_train_state, make_train_step
    from grace_tpu.transform import MeshSpec

    mesh2 = make_mesh((4, 2), ("data", "fsdp"))
    ms = MeshSpec("data", "fsdp")
    p_np, x_np, y_np = b_data()
    params = {n: jnp.asarray(a) for n, a in p_np.items()}
    param_specs = {"w1": P("fsdp", None), "b1": P(), "w2": P()}

    def loss_fn(p, b):
        x, y = b
        f = lax.axis_index("fsdp")
        xs = lax.dynamic_slice_in_dim(x, f * SHARD, SHARD, 1)
        h = lax.psum(xs @ p["w1"], "fsdp") + p["b1"]
        logits = jnp.tanh(h) @ p["w2"]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    batch = (jnp.asarray(x_np), jnp.asarray(y_np))
    grad_fn = shard_map(
        lambda p, b: jax.grad(loss_fn)(p, b), mesh=mesh2,
        in_specs=(param_specs, P("data")),
        out_specs={"w1": P(("data", "fsdp")), "b1": P(("data", "fsdp")),
                   "w2": P(("data", "fsdp"))}, check_vma=False)
    g0 = jax.jit(grad_fn)(params, batch)
    grads0 = {"w1": np.asarray(g0["w1"]).reshape(8, SHARD, HID),
              "b1": np.asarray(g0["b1"]).reshape(8, HID),
              "w2": np.asarray(g0["w2"]).reshape(8, HID, CLASSES)}

    g = jax_grace(B_CFG)
    tx = optax.chain(g.transform(0), optax.sgd(0.1))
    st = init_train_state(params, tx, mesh2, axis_name=ms,
                          param_specs=param_specs)
    step = make_train_step(loss_fn, tx, mesh2, axis_name=ms,
                           param_specs=param_specs, donate=False)
    losses = []
    for _ in range(B_STEPS):
        st, loss = step(st, batch)
        losses.append(float(loss))
    gs = _find_grace(st.opt_state)
    names = sorted(params)
    mem = {n: (None if m is None else np.asarray(m))
           for n, m in zip(names, gs.mem)}
    return {"losses": np.array(losses), "mem": mem, "grads0": grads0}


def _jax_drill():
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from grace_tpu import grace_from_params as jax_grace
    from grace_tpu.parallel import make_mesh
    from grace_tpu.resilience import (ChaosParams, ConsensusConfig,
                                      guarded_chain)
    from grace_tpu.telemetry.state import FIELD_INDEX
    from grace_tpu.train import init_train_state, make_train_step
    from grace_tpu.transform import MeshSpec

    mesh = make_mesh((4, 2), ("data", "fsdp"))
    ms = MeshSpec("data", "fsdp")
    p_np, images, labels = c_data()
    params = {n: jnp.asarray(a) for n, a in p_np.items()}
    param_specs = {"w1": P("fsdp", None), "b1": P("fsdp"),
                   "w2": P("fsdp", None), "b2": P("fsdp")}
    fs, hs = C_FEAT // 2, C_HID // 2

    def loss_fn(p, b):
        x, y, poison = b
        f = lax.axis_index("fsdp")
        b1 = lax.all_gather(p["b1"], "fsdp", axis=0, tiled=True)
        b2 = lax.all_gather(p["b2"], "fsdp", axis=0, tiled=True)
        xs = lax.dynamic_slice_in_dim(x, f * fs, fs, 1)
        h = jnp.tanh(lax.psum(xs @ p["w1"], "fsdp") + b1)
        hsl = lax.dynamic_slice_in_dim(h, f * hs, hs, 1)
        logits = lax.psum(hsl @ p["w2"], "fsdp") + b2
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        bad = (jnp.sum(poison) > 0) & (f == 1)
        return ce + jnp.where(bad, jnp.nan, 0.0) * jnp.sum(p["w1"])

    consensus = ConsensusConfig(**C_AUDIT)
    grc = jax_grace(c_params(consensus))
    tx = guarded_chain(grc, optax.sgd(C_LR), fallback_after=3,
                       fallback_steps=8)
    state = init_train_state(params, tx, mesh, axis_name=ms,
                             param_specs=param_specs)
    step = make_train_step(loss_fn, tx, mesh, axis_name=ms,
                           param_specs=param_specs, donate=False,
                           consensus=consensus)
    sdc = ChaosParams(**C_SDC)
    rows = [FIELD_INDEX[f] for f in C_ROW_FIELDS]
    out = []
    for i in range(C_STEPS):
        state = sdc(state, i)
        state, loss = step(state, tuple(jnp.asarray(a) for a in
                                        c_batch(images, labels, i)))
        guard = state.opt_state
        gs = _find_grace(guard)
        out.append({
            "loss": float(loss),
            "counters": np.stack([_per_device(getattr(guard, f)).reshape(-1)
                                  for f in ("notfinite_count",
                                            "last_bad_step", "consecutive",
                                            "fallback_remaining", "step")],
                                 1),
            "audit": np.stack([_per_device(v).reshape(-1)
                               for v in gs.audit], 1),
            "fallback": _per_device(gs.fallback).reshape(-1),
            "params": {n: _per_device(leaf)
                       for n, leaf in state.params.items()},
            "rows": np.asarray(gs.telem.rings)[:, :, rows],
            "ring_steps": np.asarray(gs.telem.steps)})
    return out, sdc.injections


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    table = jax_uniform_table()
    out = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    procs = []
    mpctx = mp.get_context("spawn")
    for r in range(WORLD):
        p = mpctx.Process(target=_worker,
                          args=(r, str(tmp / "store"), table, out[r]))
        p.start()
        procs.append(p)
    jax_out = {"collapse": _jax_collapse(), "b": _jax_train_b(),
               "c": _jax_drill()}
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
        pytest.fail(f"eight-rank gloo run did not finish in {TIMEOUT_S} s")
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    port = []
    for o in out:
        with np.load(o, allow_pickle=False) as data:
            port.append({k: data[k] for k in data.files})
    return port, jax_out


# -- single-process checks -----------------------------------------------------------

def test_meshspec_validation_gives_jaxs_errors():
    from grace_tpu.transform import MeshSpec as JaxMeshSpec

    from grace_tpu_torch import comm, grace_from_params
    from grace_tpu_torch.compressors import NoneCompressor
    from grace_tpu_torch.memories import NoneMemory
    from grace_tpu_torch.parallel import make_mesh
    from grace_tpu_torch.transform import MeshSpec, grace_transform

    for cls in (MeshSpec, JaxMeshSpec):
        with pytest.raises(ValueError, match="fsdp_axis must differ"):
            cls("data", "data")
        spec = cls("data", "fsdp")
        assert spec.axes == ("data", "fsdp") and spec.is_2d
        assert cls.normalize("data") == cls("data")
        assert cls.normalize(None) == cls()
        assert cls.normalize(spec) is spec
        with pytest.raises(TypeError, match="axis-name str or MeshSpec"):
            cls.normalize(3)
    assert MeshSpec("x", "y") == MeshSpec("x", "y")
    # a 2-D Grace builds its transform, as JAX's does
    grc = grace_from_params({"compressor": "none", "memory": "none",
                             "communicator": "allreduce",
                             "fsdp_axis": "fsdp"})
    assert grc.mesh == MeshSpec("data", "fsdp") and not grc.mesh.bound
    assert grc.transform(0).mesh == MeshSpec("data", "fsdp")
    # a bound mesh whose dp group is not the communicator's
    mesh = make_mesh((1, 1), ("data", "fsdp"))
    assert mesh.bound and (mesh.dp_index, mesh.fsdp_index) == (0, 0)
    other = MeshSpec("data", "fsdp", shape=(1, 1), dp_group=object())
    with pytest.raises(ValueError, match="dp_axis"):
        grace_transform(NoneCompressor(), NoneMemory(), comm.Allreduce(),
                        mesh=other)
    grace_transform(NoneCompressor(), NoneMemory(), comm.Allreduce(),
                    mesh=mesh)
    with pytest.raises(ValueError, match="fsdp_axis 'model'"):
        grace_from_params({"compressor": "none", "fsdp_axis": "model"},
                          group=mesh)


def test_mesh_layout_and_shards():
    from grace_tpu_torch.parallel import make_mesh
    from grace_tpu_torch.train import shard_params
    from grace_tpu_torch.transform import MeshSpec

    with pytest.raises(ValueError, match="has 8 ranks but the group has 1"):
        make_mesh((4, 2))
    with pytest.raises(ValueError, match=r"\(dp,\) or \(dp, fsdp\)"):
        make_mesh((1, 1, 1))
    spec = MeshSpec("data", "fsdp", shape=(4, 2), dp_index=2, fsdp_index=1)
    w = torch.arange(32.0).reshape(8, 4)
    assert torch.equal(spec.local_shard(w, 0), w[4:])
    assert torch.equal(spec.local_shard(w, 1), w[:, 2:])
    assert spec.local_shard(w, None) is w
    with pytest.raises(ValueError, match="does not split evenly"):
        spec.local_shard(torch.zeros(3), 0)
    x, y = spec.dp_rows((torch.arange(16.0), torch.arange(16)))
    assert torch.equal(x, torch.arange(8.0, 12.0)) and y.tolist() == \
        [8, 9, 10, 11]
    local = shard_params({"w": w, "b": torch.zeros(4)}, {"w": 0}, spec)
    assert local["w"].shape == (4, 4) and local["b"].shape == (4,)


# -- the eight-rank checks -------------------------------------------------------------

def test_make_mesh_groups_are_jaxs_axes(eight_ranks):
    port, _ = eight_ranks
    for r, got in enumerate(port):
        dp_i, f_i, same, has_f = got["mesh"]
        assert (dp_i, f_i) == (r, 0) and same and has_f
        assert got["b/dp_ranks"].tolist() == [d * 2 + r % 2
                                              for d in range(4)]
        assert got["b/fsdp_ranks"].tolist() == [r // 2 * 2, r // 2 * 2 + 1]
        assert bool(got["b/comm_is_dp"])


@pytest.mark.parametrize("name", list(COLLAPSE))
def test_degenerate_mesh_collapses_bit_for_bit(eight_ranks, name):
    """8×1 = the 1-D path in both packages on both gradient sets, and the
    port = JAX on the tie-free one (and on the integer one where no Top-K
    tie is broken)."""
    port, jax_out = eight_ranks
    for gname in GRADS:
        one_d, two_d = jax_out["collapse"][name, gname]
        np.testing.assert_array_equal(_bits(one_d), _bits(two_d))
        for r, got in enumerate(port):
            label = f"{gname} rank {r}"
            mine = got[f"collapse/{name}/{gname}/2d"]
            np.testing.assert_array_equal(
                _bits(mine), _bits(got[f"collapse/{name}/{gname}/1d"]),
                err_msg=label)
            if gname == "tie_free" or name != "topk-allgather":
                np.testing.assert_array_equal(_bits(mine[0]),
                                              _bits(two_d[r]), err_msg=label)


def test_fsdp_train_step_per_shard_residuals_equal_jax(eight_ranks):
    port, jax_out = eight_ranks
    ref = jax_out["b"]
    for r, got in enumerate(port):
        # step 0's per-shard gradients: the psum transpose's factor 2
        for n in ("w1", "b1", "w2"):
            np.testing.assert_allclose(got[f"b/grad0/{n}"],
                                       ref["grads0"][n][r], rtol=1e-5,
                                       atol=1e-6, err_msg=f"rank {r} {n}")
        np.testing.assert_allclose(got["b/losses"], ref["losses"],
                                   rtol=1e-5)
        assert got["b/mem/w1"].shape == (SHARD, HID)
        assert got["b/mem/w2"].shape == (HID, CLASSES)
        assert got["b/mem/b1"].size == 0 and ref["mem"]["b1"] is None
        for n in ("w1", "w2"):
            assert ref["mem"][n].shape[0] == WORLD
            np.testing.assert_allclose(got[f"b/mem/{n}"], ref["mem"][n][r],
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"rank {r} {n}")
    assert port[0]["b/losses"][-1] < port[0]["b/losses"][0]
    # the w1 residual really differs across the fsdp shard owners
    assert not np.array_equal(port[0]["b/mem/w1"], port[1]["b/mem/w1"])


def test_chaos_communicator_gates_on_the_dp_rank(eight_ranks):
    port, _ = eight_ranks
    for r, got in enumerate(port):
        assert got["c/gate"].tolist() == [d == r // 2 for d in range(4)]
        assert bool(got["c/chaos_gate"])


def test_drill_guard_or_spans_the_mesh(eight_ranks):
    """The NaN sits in one fsdp shard's gradient on one rank: the clean
    fsdp group's exchange is finite, yet every rank skips the step."""
    port, jax_out = eight_ranks
    ref, _ = jax_out["c"]
    s = C_POISON_STEP
    for r, got in enumerate(port):
        np.testing.assert_array_equal(got[f"c/{s}/counters"],
                                      ref[s]["counters"][r], err_msg=f"{r}")
        assert got[f"c/{s}/counters"][0] == ref[s - 1]["counters"][r][0] + 1
        for n in ("w1", "b1", "w2", "b2"):
            np.testing.assert_array_equal(
                _bits(got[f"c/{s}/param/{n}"]),
                _bits(got[f"c/{s - 1}/param/{n}"]), err_msg=f"{r} {n}")


def test_drill_audit_repairs_per_fsdp_group_as_jax(eight_ranks):
    port, jax_out = eight_ranks
    ref, injections = jax_out["c"]
    assert [tuple(int(v) for v in row) for row in port[0]["c/injections"]] \
        == [tuple(row) for row in injections]
    last = C_STEPS - 1
    repairs = [max(int(port[d * 2 + f][f"c/{last}/audit"][1])
                   for d in range(4)) for f in range(2)]
    want = [max(int(ref[last]["audit"][d * 2 + f, 1]) for d in range(4))
            for f in range(2)]
    assert repairs == want == [0, 2]
    for i in range(C_STEPS):
        for r, got in enumerate(port):
            label = f"step {i} rank {r}"
            np.testing.assert_array_equal(got[f"c/{i}/counters"],
                                          ref[i]["counters"][r],
                                          err_msg=label)
            assert got[f"c/{i}/audit"].tolist() == \
                ref[i]["audit"][r].tolist(), label
            assert bool(got[f"c/{i}/fallback"]) == \
                bool(ref[i]["fallback"][r]), label
            for n in ("w1", "b1", "w2", "b2"):
                np.testing.assert_allclose(
                    got[f"c/{i}/param/{n}"], ref[i]["params"][n][r],
                    rtol=0, atol=1e-5, err_msg=f"{label} {n}")
            # replicas bit-identical within the dp group after an audit
            peer = port[r % 2]
            audited = i == 0 or got[f"c/{i}/audit"][0] > \
                got[f"c/{i - 1}/audit"][0]
            if audited or i == C_STEPS - 1:
                for n in ("w1", "b1", "w2", "b2"):
                    np.testing.assert_array_equal(
                        _bits(got[f"c/{i}/param/{n}"]),
                        _bits(peer[f"c/{i}/param/{n}"]),
                        err_msg=f"{label} {n}")
        if i != C_POISON_STEP:
            assert port[0][f"c/{i}/loss"] == pytest.approx(ref[i]["loss"],
                                                           rel=1e-5)


def test_drill_rings_price_the_dp_axis_over_dcn(eight_ranks):
    """slice_size 2 inside the 4-wide dp axis: the flat reduce-scatter's
    bytes all cross a slice boundary, as JAX prices them (1176 B a
    compressed step); the ring's byte columns equal JAX's rows."""
    port, jax_out = eight_ranks
    ref, _ = jax_out["c"]
    last = C_STEPS - 1
    for r, got in enumerate(port):
        np.testing.assert_array_equal(got[f"c/{last}/ring_steps"],
                                      ref[last]["ring_steps"][r])
        np.testing.assert_array_equal(got[f"c/{last}/rows"],
                                      ref[last]["rows"][r], err_msg=f"{r}")
    written = ref[last]["ring_steps"][0] >= 0
    rows = ref[last]["rows"][0][written]
    assert (rows[:, 1] == 0).all() and (rows[:, 2] > 0).all()
    assert 1176.0 in rows[:, 0]
