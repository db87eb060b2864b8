"""Per-leaf codec routes in the port against the JAX package's, on the CPU.

* The routed step equals JAX's on the registry's ``routed-topk-fp16`` (bit
  for bit: exact Top-K on tie-free gradients and fp16 sum no floats
  differently), and, leaf for leaf, the two unrouted steps it is made of.
* ``leaf_path_str`` spells the port's dotted names as JAX spells the tree
  paths of all 161 ResNet-50 leaves, so one route table matches the same
  leaves in both packages.
* ``route_leaves`` and ``routed_recv_link_bytes`` equal JAX's at W in
  {2, 8, 16} under two topologies.
* ``fsdp_axis`` builds a 2-D routed ``Grace`` whose communicators, the
  routes' too, run over the mesh's dp group; an unknown key still raises.
* The refusals: routes need ``fusion=None``; a route's communicator must
  run over the base one's group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu import grace_from_params as jax_grace_from_params
from grace_tpu.core import Topology as JaxTopology
from grace_tpu.helper import route_leaves as jax_route_leaves
from grace_tpu.helper import \
    routed_recv_link_bytes as jax_routed_recv_link_bytes
from grace_tpu.transform import leaf_path_str as jax_leaf_path_str

from grace_tpu_torch import comm, grace_from_params
from grace_tpu_torch.core import Topology
from grace_tpu_torch.helper import route_leaves, routed_recv_link_bytes
from grace_tpu_torch.transform import (grace_transform, leaf_order,
                                       leaf_path_str, normalize_routes,
                                       route_for)
from test_torch_fusion import (_grads, _mlp_shapes, _nest,  # noqa: F401
                               assert_runs_same, assert_same, group,
                               registry, run_jax, run_port)

FP16_DENSE = {"compressor": "fp16", "memory": "none",
              "communicator": "allreduce"}
TOPK_CHUNK = {"compressor": "topk", "compress_ratio": 0.01,
              "topk_algorithm": "chunk", "memory": "residual",
              "communicator": "allgather"}
BN_ROUTED = {**TOPK_CHUNK, "route": [("*bn*", FP16_DENSE)]}


def test_routed_registry_config_equals_jax(group):
    cfg = registry("routed-topk-fp16")
    assert cfg["route"][0][0] == "b"
    grads = _grads(_mlp_shapes(), seed=2)
    port = run_port(cfg, grads, group)
    # The routed leaf "b" keeps no residual; the others do.
    names = leaf_order(grads)
    assert [m is None for m in port[1]] == [n == "b" for n in names]
    assert_runs_same(port, run_jax(cfg, grads))


# A few of ResNet-50's names: BatchNorm leaves (routed dense) and others.
RESNET_LIKE = {"stem.w": (7, 7, 3, 64), "stem_bn.scale": (64,),
               "stem_bn.bias": (64,), "s0b0.conv1.w": (1, 1, 64, 64),
               "s0b0.bn1.scale": (64,), "s0b0.bn1.bias": (64,),
               "s0b0.proj_bn.scale": (256,), "fc.w": (256, 10),
               "fc.b": (10,)}


def test_routed_step_equals_its_two_unrouted_steps(group):
    grads = _grads(RESNET_LIKE, seed=3)
    routed = run_port(BN_ROUTED, grads, group)
    dense = run_port(FP16_DENSE, grads, group)
    topk = run_port(TOPK_CHUNK, grads, group)
    names = leaf_order(grads)
    bn = [i for i, n in enumerate(names) if "bn" in n]
    assert len(bn) == 5
    for i, n in enumerate(names):
        ref = dense if i in bn else topk
        for s in range(len(routed[0])):
            assert_same(routed[0][s][n], ref[0][s][n])
        assert_same(routed[1][i], ref[1][i])
        assert_same(routed[2][i], ref[2][i])
    assert_runs_same(routed, run_jax(BN_ROUTED, grads))


def _jax_resnet50_paths():
    from grace_tpu.models import resnet as jresnet
    params, _ = jax.eval_shape(lambda k: jresnet.init(k, 50),
                               jax.random.key(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return [jax_leaf_path_str(p) for p, _ in flat]


def test_leaf_path_str_maps_resnet50_names_onto_jax_paths():
    from grace_tpu_torch.models.resnet import resnet50
    names = leaf_order(dict(resnet50(device="cpu").named_parameters()))
    paths = [leaf_path_str(n) for n in names]
    assert len(paths) == 161
    assert paths == _jax_resnet50_paths()
    # The BatchNorm route of the card's routed row: 106 leaves dense, 55
    # through Top-K.
    assert sum(route_for(((("*bn*",) + (None,) * 3),), p, None) is not None
               for p in paths) == 106


ROUTED_CONFIGS = {
    "topk_fp16": {"compressor": "topk", "compress_ratio": 0.3,
                  "memory": "residual", "communicator": "allgather",
                  "route": [("b*", FP16_DENSE)]},
    # A negotiated shared scale (homoqsgd) on the base leaves, ring routes.
    "homoqsgd_negotiated": {"compressor": "homoqsgd", "quantum_num": 7,
                            "memory": "residual",
                            "communicator": "allreduce",
                            "route": [("h*", {"communicator": "ring"}),
                                      ("b", FP16_DENSE)]},
}
TOPOLOGIES = {"single_slice": (None, None),
              "slices_of_4": (Topology(slice_size=4),
                              JaxTopology(slice_size=4))}


@pytest.mark.parametrize("world", [2, 8, 16])
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("config", list(ROUTED_CONFIGS))
def test_routed_recv_link_bytes_equal_jax(config, topology, world):
    cfg = ROUTED_CONFIGS[config]
    shapes = {**_mlp_shapes(), "c.w": (3, 3, 16, 16)}
    tree = {n: (s, torch.float32) for n, s in shapes.items()}
    jtree = _nest({n: jax.ShapeDtypeStruct(s, jnp.float32)
                   for n, s in shapes.items()})
    grc, jgrc = grace_from_params(cfg), jax_grace_from_params(cfg)
    port_leaves, jax_leaves = route_leaves(grc, tree), \
        jax_route_leaves(jgrc, jtree)
    assert [(p, s[0]) for p, s, *_ in port_leaves] == \
        [(p, tuple(s.shape)) for p, s, *_ in jax_leaves]
    assert [tuple(type(x).__name__ for x in r[2:]) for r in port_leaves] == \
        [tuple(type(x).__name__ for x in r[2:]) for r in jax_leaves]
    topo, jtopo = TOPOLOGIES[topology]
    got = routed_recv_link_bytes(grc, tree, world, topology=topo)
    want = jax_routed_recv_link_bytes(jgrc, jtree, world, topology=jtopo)
    assert tuple(got) == tuple(int(v) for v in want)
    assert got.total > 0


def test_fsdp_axis_still_raises():
    """``fsdp_axis`` is ported: the 2-D routed Grace builds on a mesh, every
    communicator on its dp group; a misspelt key still raises, naming it."""
    from grace_tpu_torch.parallel import make_mesh
    from grace_tpu_torch.transform import MeshSpec

    mesh = make_mesh((1, 1), ("data", "fsdp"))
    grc = grace_from_params({**BN_ROUTED, "fsdp_axis": "fsdp"}, group=mesh)
    assert grc.mesh is mesh and grc.mesh == MeshSpec("data", "fsdp")
    assert grc.communicator.group is mesh.dp_group
    assert all(cm.group is mesh.dp_group for _p, _c, _m, cm in grc.routes)
    assert grc.transform(0).mesh is mesh
    with pytest.raises(ValueError, match="fsdp_axes"):
        grace_from_params({**TOPK_CHUNK, "fsdp_axes": "fsdp"})


@pytest.mark.parametrize("fusion", ["flat", "grouped", 1024])
def test_routes_require_fusion_none(fusion):
    with pytest.raises(ValueError, match="fusion=None"):
        grace_from_params({**BN_ROUTED, "fusion": fusion})
    grc = grace_from_params(BN_ROUTED)
    with pytest.raises(ValueError, match="fusion=None"):
        grace_transform(grc.compressor, grc.memory, grc.communicator,
                        fusion=fusion, routes=grc.routes)


def test_route_on_another_group_raises():
    base = comm.Allgather()
    grc = grace_from_params(FP16_DENSE)
    other = comm.Allreduce(group="another group")
    with pytest.raises(ValueError, match="one process group"):
        normalize_routes([("*", (grc.compressor, grc.memory, other))], base)
    with pytest.raises(ValueError, match="triad"):
        normalize_routes([("*", (grc.compressor, grc.memory))], base)


def test_route_overrides_merge_over_the_base_params():
    grc = grace_from_params({**TOPK_CHUNK, "route": [
        ("fc/*", {"compress_ratio": 0.1}), ("*bn*", FP16_DENSE),
        ("*", {"compressor": "none"})]})
    (p0, c0, m0, cm0), (p1, c1, _, cm1), (_, c2, _, _) = grc.routes
    assert (p0, c0.compress_ratio, c0.algorithm) == ("fc/*", 0.1, "chunk")
    assert type(m0).__name__ == "ResidualMemory"
    assert type(cm0) is comm.Allgather and type(cm1) is comm.Allreduce
    assert type(c1).__name__ == "FP16Compressor"
    assert type(c2).__name__ == "NoneCompressor"
    base = (grc.compressor, grc.memory, grc.communicator)
    # First match wins: "fc/b" takes the fc route, not the catch-all.
    assert route_for(grc.routes, "fc/b", base)[0] is c0
    assert route_for(grc.routes, "s0b0/bn1/scale", base)[0] is c1
    assert route_for(grc.routes, "stem/w", base)[0] is c2
    assert route_for((), "stem/w", base) is base
    np.testing.assert_equal(len(grc.transform(seed=0).routes), 3)
