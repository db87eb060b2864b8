"""The port's fusion plans and its grouped and bucketed executors against
the JAX package's, on the CPU.

* The bucket plan, the common dtype, the payload structures and their byte
  counts equal JAX's integers: the cases of ``tests/test_fusion.py``'s
  ``TestBucketize`` and ResNet-50's 161 leaves at 1024 B, 32 MiB and 64 MiB.
* ``fusion='grouped'`` on the MLP of ``tests/test_fusion.py`` equals
  ``fusion=None`` bit for bit (updates and states) and JAX's ``'grouped'``
  step: bit for bit for none and Top-K (exact and chunk), within atol 2e-5
  for warm-start PowerSGD (matmuls and QRs sum in other orders, as in
  ``tests/test_torch_catalog.py``), and within rtol 1e-6 for Signum (its
  momentum, a dict state a row, is XLA's fused multiply-add, as in
  ``tests/test_torch_qsgd_signsgd.py``). Staged QSGD, fed JAX's draws
  through :class:`JaxKey`, equals JAX's grouped step within rtol 1e-5 (its
  norm is a float sum). JAX's refusals and state-mismatch errors hold.
* The bucketed executor equals ``'flat'`` bit for bit on integer
  gradients, and JAX's bucketed step on the registry's
  ``topk-allgather-bucketed`` and ``qsgd4-ring-packed-bucketed``.
* Two gloo ranks: the grouped and bucketed Top-K steps equal the per-leaf
  and flat ones, and JAX's on a two-device mesh.

The JAX side runs ``grace_transform`` inside ``shard_map`` on a submesh of
as many devices as the port has ranks; one port rank is a gloo group of
one in this process.
"""

import dataclasses
import functools
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, PartitionSpec as P

from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.analysis.configs import AUDIT_CONFIGS
from grace_tpu.parallel import shard_map
from grace_tpu.transform import _bucketize as jax_bucketize
from grace_tpu.transform import \
    fusion_payload_nbytes as jax_fusion_payload_nbytes
from grace_tpu.transform import \
    fusion_payload_structs as jax_fusion_payload_structs

import grace_tpu_torch.transform as T
from grace_tpu_torch import grace_from_params
from grace_tpu_torch.core import LeafKey
from grace_tpu_torch.transform import (_bucketize, fusion_payload_nbytes,
                                       fusion_payload_structs, leaf_order)

STEPS = 3
TIMEOUT_S = 180


def registry(name):
    return next(dict(e["params"]) for e in AUDIT_CONFIGS
                if e["name"] == name)


# -- the plans -----------------------------------------------------------------

F32, BF16 = (jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)


@functools.cache
def _resnet50_specs():
    from grace_tpu_torch.models.resnet import resnet50
    params = dict(resnet50(device="cpu").named_parameters())
    return [(tuple(params[n].shape), F32) for n in leaf_order(params)]


# (specs as (shape, (jax dtype, torch dtype)), bucket bytes)
PLAN_CASES = {
    "flat_is_one_bucket": ([((10,), F32), ((5, 5), F32)], None),
    "byte_limit_500": ([((100,), F32)] * 3, 500),
    "byte_limit_800": ([((100,), F32)] * 3, 800),
    "oversized_leaf_own_bucket": ([((10,), F32), ((1000,), F32),
                                   ((10,), F32)], 100),
    "common_dtype_promotion": ([((4,), BF16), ((4,), F32)], None),
    "empty_flat": ([], None),
    "empty_512": ([], 512),
    "single_leaf_larger_than_bucket": ([((1000,), F32)], 64),
    "oversized_leaf_keeps_order": ([((1000,), F32)] + [((10,), F32)] * 3,
                                   100),
    "mixed_dtype_prices_at_common_dtype": ([((100,), BF16), ((100,), BF16),
                                            ((100,), F32)], 800),
    "resnet50_1024B": ("resnet50", 1024),
    "resnet50_32MiB": ("resnet50", 32 * 2**20),
    "resnet50_64MiB": ("resnet50", 64 * 2**20),
}
PRICED = {"topk1pct_chunk": {"compressor": "topk", "compress_ratio": 0.01,
                             "topk_algorithm": "chunk"},
          "qsgd4": {"compressor": "qsgd", "quantum_num": 7},
          "none": {"compressor": "none"}}


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_fusion_plans_and_byte_counts_equal_jax(case):
    specs, bucket_bytes = PLAN_CASES[case]
    if specs == "resnet50":
        specs = _resnet50_specs()
        assert len(specs) == 161
    jspecs = [(s, d[0]) for s, d in specs]
    tspecs = [(s, d[1]) for s, d in specs]
    jb, jdt = jax_bucketize(jspecs, bucket_bytes)
    tb, tdt = _bucketize(tspecs, bucket_bytes)
    assert tb == jb
    assert _dtype_name(tdt) == _dtype_name(jdt)
    assert [i for b in tb for i in b] == list(range(len(specs)))
    jstructs = [jax.ShapeDtypeStruct(s, d) for s, d in jspecs]
    fusions = [None, "flat", "grouped"] + (
        [bucket_bytes] if bucket_bytes is not None else [])
    for fusion in fusions:
        want = [((tuple(s.shape), _dtype_name(s.dtype)), c)
                for s, c in jax_fusion_payload_structs(jstructs, fusion)]
        got = [((tuple(s), _dtype_name(d)), c)
               for (s, d), c in fusion_payload_structs(tspecs, fusion)]
        assert got == want, fusion
    if not specs:
        return
    for name, params in PRICED.items():
        jc = jax_grace_from_params(params).compressor
        tc = grace_from_params(params).compressor
        for fusion in ([None, "grouped"] if len(specs) < 20 else []) + [
                "flat"] + ([bucket_bytes] if bucket_bytes else []):
            assert fusion_payload_nbytes(tc, tspecs, fusion) == \
                jax_fusion_payload_nbytes(jc, jstructs, fusion), \
                (name, fusion)


# -- the executors at one rank ---------------------------------------------------

def _mlp_shapes():
    """``tests/test_fusion.py``'s MLP: three (12, 12) hidden weights, three
    (12,) biases, a (12, 3) head and a (3,) bias."""
    return {"h1": (12, 12), "h2": (12, 12), "h3": (12, 12), "b1": (12,),
            "b2": (12,), "b3": (12,), "w": (12, 3), "b": (3,)}


def _grads(shapes, seed=0, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return {n: rng.integers(-8, 9, (STEPS,) + s).astype(np.float32)
                for n, s in shapes.items()}
    return {n: (rng.standard_normal((STEPS,) + s) * 0.5).astype(np.float32)
            for n, s in shapes.items()}


def _nest(flat):
    tree = {}
    for name, a in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _np_state(entry):
    if entry is None:
        return None
    if isinstance(entry, dict):
        return {k: _np_state(v) for k, v in entry.items()}
    return np.asarray(entry)


def run_jax(cfg, grads, world=1, seed=1):
    """JAX's transform over ``STEPS`` steps of ``grads`` (name → (STEPS,
    ...) or, at ``world`` > 1, (world, STEPS, ...)), on a ``world``-device
    submesh: each step's updates and the final ``mem``/``comp``, rank 0's
    (or every rank's, stacked, at ``world`` > 1)."""
    tx = jax_grace_from_params(cfg).transform(seed=seed)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    tree = _nest({n: jnp.asarray(a if world > 1 else a[None])
                  for n, a in grads.items()})

    def body(g):
        g = jax.tree.map(lambda a: a[0], g)
        state = tx.init(jax.tree.map(lambda a: a[0], g))
        outs = []
        for s in range(STEPS):
            upd, state = tx.update(jax.tree.map(lambda a: a[s], g), state)
            outs.append(upd)
        add = lambda x: x[None]                          # noqa: E731
        return (jax.tree.map(add, outs), jax.tree.map(add, state.mem),
                jax.tree.map(add, state.comp))

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                           out_specs=P("data"), check_vma=False))
    outs, mem, comp = fn(tree)
    flat_outs = [{".".join(str(k.key) for k in path): np.asarray(leaf)
                  for path, leaf in jax.tree_util.tree_flatten_with_path(o)[0]}
                 for o in outs]
    pick = (lambda a: a) if world > 1 else (lambda a: a[0])
    return ([{n: pick(v) for n, v in o.items()} for o in flat_outs],
            [jax.tree.map(pick, _np_state(m)) for m in mem],
            [jax.tree.map(pick, _np_state(c)) for c in comp])


def run_port(cfg, grads, group, seed=1):
    """The port's transform over the same steps: each step's updates and
    the final ``mem``/``comp``, as numpy."""
    tx = grace_from_params(cfg, group=group).transform(seed=seed)
    state = tx.init({n: torch.from_numpy(a[0]) for n, a in grads.items()})
    outs = []
    for s in range(STEPS):
        upd, state = tx.update({n: torch.from_numpy(a[s].copy())
                                for n, a in grads.items()}, state)
        outs.append({n: u.numpy().copy() for n, u in upd.items()})
    as_np = lambda e: None if e is None else (              # noqa: E731
        {k: v.numpy() for k, v in e.items()} if isinstance(e, dict)
        else e.numpy())
    return outs, [as_np(m) for m in state.mem], [as_np(c) for c in state.comp]


@pytest.fixture
def group(tmp_path):
    from grace_tpu_torch.parallel import init_process_group
    g, _ = init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    yield g
    torch.distributed.destroy_process_group()


def assert_same(got, want, tol=None):
    """Equal bit for bit (``tol=None``) or within ``(rtol, atol)``."""
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], tol)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if tol is None:
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
    else:
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


def assert_runs_same(port, ref, tol=None):
    for po, ro in zip(port[0], ref[0]):
        assert sorted(po) == sorted(ro)
        for n in ro:
            assert_same(po[n], ro[n], tol)
    for pe, re_ in zip(port[1] + port[2], ref[1] + ref[2]):
        assert_same(pe, re_, tol)


GROUPED_CASES = {
    "none": ({"compressor": "none", "memory": "none",
              "communicator": "allreduce"}, None),
    "topk": ({"compressor": "topk", "compress_ratio": 0.3,
              "memory": "residual", "communicator": "allgather"}, None),
    "topk_chunk": ({"compressor": "topk", "compress_ratio": 0.3,
                    "topk_algorithm": "chunk", "memory": "residual",
                    "communicator": "allgather"}, None),
    "powersgd": ({"compressor": "powersgd", "compress_rank": 2,
                  "memory": "powersgd", "communicator": "allreduce"},
                 (0, 2e-5)),
    # A dict state a row (the momentum), stacked key by key. Against JAX
    # the momentum moves by an ulp where XLA fuses its multiply-add.
    "signum": ({"compressor": "signum", "memory": "none",
                "communicator": "allreduce"}, (1e-6, 1e-7)),
}


def _regroup(run, leaves):
    """A per-leaf run's states stacked as the grouped executor keeps them."""
    outs, mem, comp = run
    groups = T._group_views([(leaves[n], torch.float32)
                             for n in leaf_order(leaves)])
    stack = lambda es: None if es[0] is None else (         # noqa: E731
        {k: np.stack([e[k] for e in es]) for k in es[0]}
        if isinstance(es[0], dict) else np.stack(es))
    return (outs, [stack([mem[i] for i in g]) for g in groups],
            [stack([comp[i] for i in g]) for g in groups])


@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_matches_per_leaf_and_jax(group, case):
    cfg, tol = GROUPED_CASES[case]
    shapes = _mlp_shapes()
    grads = _grads(shapes)
    grouped = run_port({**cfg, "fusion": "grouped"}, grads, group)
    per_leaf = run_port(cfg, grads, group)
    assert_runs_same(grouped, _regroup(per_leaf, shapes))
    assert_runs_same(grouped, run_jax({**cfg, "fusion": "grouped"}, grads),
                     tol)


def test_grouped_state_is_per_group(group):
    cfg = {**GROUPED_CASES["topk"][0], "fusion": "grouped"}
    shapes = _mlp_shapes()
    tx = grace_from_params(cfg, group=group).transform(seed=1)
    state = tx.init({n: torch.zeros(s) for n, s in shapes.items()})
    # leaf order b, b1-3, h1-3, w: groups (3,)x1, (12,)x3, (12,12)x3,
    # (12,3)x1
    assert [tuple(m.shape) for m in state.mem] == [
        (1, 3), (3, 12), (3, 12, 12), (1, 12, 3)]


@dataclasses.dataclass(frozen=True)
class JaxKey(LeafKey):
    """A key whose uniforms are JAX's draws: the key of
    ``fold_in(fold_in(key(seed), count), leaf)`` and then each fold, where
    ``('split', n, j)`` is ``split(k, n)[j]``."""

    def split(self, n=2):
        return tuple(dataclasses.replace(self, folds=self.folds
                                         + (("split", n, j),))
                     for j in range(n))

    def jax_key(self):
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.key(self.seed), self.count), self.leaf)
        for f in self.folds:
            k = (jax.random.split(k, f[1])[f[2]] if isinstance(f, tuple)
                 else jax.random.fold_in(k, f))
        return k

    def uniform(self, shape, device):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.jax_key(), tuple(shape)))).to(device)


def test_grouped_stochastic_codec_equals_jax_with_jax_keys(group,
                                                           monkeypatch):
    """Staged QSGD draws its noise from the row's key; given JAX's draws
    (row j of group g: ``split(fold_in(step_key, g), G)[j]``), the grouped
    step is JAX's."""
    monkeypatch.setattr(T, "LeafKey", JaxKey)
    cfg = {"compressor": "qsgd", "quantum_num": 64, "use_pallas": False,
           "memory": "residual", "communicator": "allgather",
           "fusion": "grouped"}
    grads = _grads(_mlp_shapes(), seed=4)
    assert_runs_same(run_port(cfg, grads, group), run_jax(cfg, grads),
                     (1e-5, 1e-6))


def _mlp_step(cfg, state_cfg, group, shapes):
    tx = grace_from_params(cfg, group=group).transform(seed=1)
    stale = grace_from_params(state_cfg, group=group).transform(seed=1)
    zeros = {n: torch.zeros(s) for n, s in shapes.items()}
    return tx, stale.init(zeros), zeros


TOPK03 = {"compressor": "topk", "compress_ratio": 0.3, "memory": "residual",
          "communicator": "allgather"}


def test_grouped_state_mismatch_raises(group):
    """8 per-leaf entries against 4 groups: JAX's re-init message."""
    tx, state, g = _mlp_step({**TOPK03, "fusion": "grouped"}, TOPK03, group,
                             _mlp_shapes())
    with pytest.raises(ValueError,
                       match="different fusion setting.*Re-init"):
        tx.update(g, state)


def test_grouped_state_count_coincidence_raises(group):
    """Two leaves of distinct shapes: as many groups as per-leaf entries,
    so the stacked leading dimension must catch the stale state."""
    tx, state, g = _mlp_step({**TOPK03, "fusion": "grouped"}, TOPK03, group,
                             {"w": (12, 3), "b": (3,)})
    with pytest.raises(ValueError,
                       match="leading dim.*different fusion setting"):
        tx.update(g, state)


@pytest.mark.parametrize("communicator", ["twoshot", "ring", "rscatter",
                                          "hier"])
def test_grouped_shard_parallel_rejected(communicator):
    """In ``grace_transform`` itself, as in JAX: the bundle builds and
    ``transform()`` refuses."""
    grc = grace_from_params({**TOPK03, "communicator": communicator,
                             "fusion": "grouped"})
    with pytest.raises(ValueError, match="shard-parallel"):
        grc.transform()
    with pytest.raises(ValueError, match="shard-parallel"):
        T.grace_transform(grc.compressor, grc.memory, grc.communicator,
                          fusion="grouped")


@pytest.mark.parametrize("fusion", ["banana", 1.5, True])
def test_invalid_fusion_rejected(fusion):
    grc = grace_from_params({"compressor": "none"})
    with pytest.raises(ValueError, match="fusion"):
        T.grace_transform(grc.compressor, grc.memory, grc.communicator,
                          fusion=fusion)


# -- the bucketed executor ---------------------------------------------------

@pytest.mark.parametrize("compressor", ["none", "fp16"])
def test_bucketed_bit_identical_to_flat_for_exact_codecs(group, compressor):
    """Integer gradients: each bucket's step is the flat step's, element
    for element; and both equal JAX's."""
    base = {"compressor": compressor, "memory": "none",
            "communicator": "allreduce"}
    grads = _grads(_mlp_shapes(), integer=True)
    flat = run_port({**base, "fusion": "flat"}, grads, group)
    bucketed = run_port({**base, "fusion": 128}, grads, group)
    for fo, bo in zip(flat[0], bucketed[0]):
        for n in fo:
            assert_same(bo[n], fo[n])
    assert_runs_same(bucketed, run_jax({**base, "fusion": 128}, grads))


@pytest.mark.parametrize("name", ["topk-allgather-bucketed",
                                  "qsgd4-ring-packed-bucketed"])
def test_bucketed_registry_config_equals_jax(group, monkeypatch, name):
    """The registry's bucketed configurations (1024-byte buckets) build in
    the port and equal JAX's step: exact Top-K bit for bit; staged 4-bit
    QSGD over the ring, given JAX's draws, within rtol 1e-5 (its norm is a
    float sum)."""
    cfg = registry(name)
    assert cfg["fusion"] == 1024
    monkeypatch.setattr(T, "LeafKey", JaxKey)
    grads = _grads(_mlp_shapes(), seed=5)
    port = run_port(cfg, grads, group)
    buckets, _ = _bucketize([(s, torch.float32)
                             for s in (_mlp_shapes()[n]
                                       for n in leaf_order(grads))], 1024)
    assert len(port[1]) == len(buckets) > 1
    assert_runs_same(port, run_jax(cfg, grads),
                     None if name.startswith("topk") else (1e-5, 1e-6))


def test_bucketed_state_mismatch_raises(group):
    tx, state, g = _mlp_step({**TOPK03, "fusion": 256},
                             {**TOPK03, "fusion": "flat"}, group,
                             _mlp_shapes())
    with pytest.raises(ValueError, match="fusion plan has .* buckets"):
        tx.update(g, state)


def test_bucketed_mixed_dtypes_cast_back(group):
    """A bfloat16 and a float32 leaf share a float32 bucket; each update
    returns in its leaf's dtype, equal to the leaf for the identity
    codec."""
    tx = grace_from_params({"compressor": "none", "memory": "none",
                            "communicator": "allreduce", "fusion": 1 << 20},
                           group=group).transform(seed=0)
    g = {"w": torch.arange(12, dtype=torch.bfloat16).reshape(4, 3),
         "b": torch.arange(3, dtype=torch.float32)}
    upd, state = tx.update(g, tx.init(g))
    assert upd["w"].dtype == torch.bfloat16 and upd["b"].dtype == \
        torch.float32
    assert torch.equal(upd["w"], g["w"]) and torch.equal(upd["b"], g["b"])
    assert state.count == 1 and len(state.mem) == 1


# -- two gloo ranks ----------------------------------------------------------

WORLD = 2
DIST_CFGS = {
    "grouped": {**GROUPED_CASES["topk_chunk"][0], "fusion": "grouped"},
    "per_leaf": GROUPED_CASES["topk_chunk"][0],
    "bucketed": {**GROUPED_CASES["topk_chunk"][0], "fusion": 1024},
    "flat": {**GROUPED_CASES["topk_chunk"][0], "fusion": "flat"},
}


def _worker(rank, init_file, grads_path, out_paths):
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cpu", rank=rank, world_size=WORLD,
                                  init_method=f"file://{init_file}")
    try:
        with np.load(grads_path) as data:
            grads = {n: data[n][rank] for n in data.files}
        out = {}
        for label, cfg in DIST_CFGS.items():
            outs, mem, _ = run_port(cfg, grads, group)
            for s, o in enumerate(outs):
                out.update({f"{label}/out/{s}/{n}": v for n, v in o.items()})
            out.update({f"{label}/mem/{i}": m for i, m in enumerate(mem)})
        np.savez(out_paths[rank], **out)
    finally:
        torch.distributed.destroy_process_group()


def test_two_ranks_grouped_and_bucketed_match_per_leaf_and_jax(tmp_path):
    """At W=2 the stacked gathers of the grouped rows, and the buckets'
    gathers, give each leaf the per-leaf (grouped) and flat-equivalent
    (bucketed: JAX's bucketed step) results, bit for bit."""
    shapes = _mlp_shapes()
    rng = np.random.default_rng(11)
    grads = {n: (rng.standard_normal((WORLD, STEPS) + s) * 0.5).astype(
        np.float32) for n, s in shapes.items()}
    grads_path = tmp_path / "grads.npz"
    np.savez(grads_path, **grads)
    outs = [tmp_path / f"rank{r}.npz" for r in range(WORLD)]
    ctx = mp.start_processes(
        _worker, args=(str(tmp_path / "store"), str(grads_path),
                       [str(o) for o in outs]),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two-rank gloo run did not finish in {TIMEOUT_S} s")
    port = []
    for o in outs:
        with np.load(o) as data:
            port.append({k: data[k] for k in data.files})
    names = leaf_order(shapes)
    jax_runs = {label: run_jax(DIST_CFGS[label], grads, world=WORLD)
                for label in ("grouped", "bucketed")}
    for r in range(WORLD):
        for s in range(STEPS):
            for n in names:
                key = f"/out/{s}/{n}"
                assert_same(port[r]["grouped" + key],
                            port[r]["per_leaf" + key])
                for label, (jouts, _, _) in jax_runs.items():
                    assert_same(port[r][label + key], jouts[s][n][r])
        for label, (_, jmem, _) in jax_runs.items():
            for i, m in enumerate(jmem):
                assert_same(port[r][f"{label}/mem/{i}"], m[r])
    for key in port[0]:
        if "/out/" in key:
            assert_same(port[0][key], port[1][key])
    assert math.isfinite(float(port[0]["flat/out/0/w"].sum()))
