"""The port's three-level hierarchical all-reduce, its link topology and its
wire-byte models, against the JAX package's.

* The three-level schedule at W=8 (slices of 2, regions of 4: two regions
  of two slices) over real gloo groups, through the workers of
  ``tests/test_torch_hier.py``: bit for bit against JAX's for ``none``,
  ``fp16``, randomk, homoqsgd and the count sketch, and for signSGD and
  Top-K (Top-K with
  the zero-sign reading that file explains); the aggressive WAN codec
  over Top-K likewise; one region equals the two-level schedule bit for
  bit.
* The ``wan_compressor`` gates, the WAN leg's width, ``shrunk``.
* ``LinkBytes``, ``Topology``'s checks, ``shrink`` and ``detect`` (fake
  device lists, and the default process group).
* Every ``recv_link_bytes``, ``recv_wire_bytes`` and
  ``wire_overlap_fraction`` of every ported communicator over a grid of
  worlds, topologies and vote flags equals the JAX package's integers, as
  do ``payload_nbytes`` for every ported codec at three shapes and
  ``negotiation_bytes_for``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_hier import (REGION_CODECS, check_against_jax, inputs,
                             port_results)

from grace_tpu_torch import comm
from grace_tpu_torch import compressors as C
from grace_tpu_torch.core import LinkBytes, Topology

W = 8
TOPO3 = Topology(slice_size=2, region_size=4)


@pytest.fixture(scope="module")
def port8(tmp_path_factory):
    return port_results(W, str(tmp_path_factory.mktemp("region")))


# -- the three-level schedule -------------------------------------------------

@pytest.mark.parametrize("codec", REGION_CODECS)
def test_three_levels_match_jax_bit_for_bit(port8, codec):
    check_against_jax(port8, W, f"{codec}/s2r4")


def test_wan_codec_over_topk_matches_jax(port8):
    """Top-K 25% inside the regions, Top-K 5% (exact) across them: the one
    region-boundary encode under ``fold(2S+2)`` through the WAN codec,
    aggregated with the base codec, as in JAX."""
    check_against_jax(port8, W, "topk/s2r4_wan")
    out = port8[0]["topk/s2r4_wan/out"]
    assert 0 < (out != 0).sum() < (port8[0]["topk/s2r4/out"] != 0).sum()


@pytest.mark.parametrize("codec", REGION_CODECS)
def test_one_region_is_the_two_level_schedule(port8, codec):
    """``region_size`` equal to the world is one region: bit for bit the
    two-level schedule, outputs and residuals, on every rank."""
    for r in range(W):
        for part in ("out", "mem"):
            key = f"{codec}/s2/{part}"
            if key in port8[r]:
                np.testing.assert_array_equal(
                    port8[r][f"{codec}/s2r8/{part}"].view(np.int32),
                    port8[r][key].view(np.int32))


def test_exact_codecs_cross_regions_exactly(port8):
    """On homoqsgd's lattice the three-level sum is exact: the mean, with a
    zero residual."""
    x = inputs(W, "homo7")
    for r in range(W):
        np.testing.assert_array_equal(port8[r]["homo7/s2r4/out"],
                                      x.sum(0) * np.float32(1 / W))
        np.testing.assert_array_equal(port8[r]["homo7/s2r4/mem"],
                                      np.zeros(x.shape[1], np.float32))


def test_wan_compressor_gates_and_wan_leg_width(port8):
    """The WAN codec is refused over exact payloads and when it is not a
    hop-requant codec (at the step, in the 8-rank group), and without a
    region tier (at construction); armed, the WAN leg is priced at its own
    payload width, as in JAX."""
    from grace_tpu import comm as jcomm
    from grace_tpu import compressors as JC
    err = str(port8[0]["fp16/s2r4_wan/error"])
    assert err.startswith("TypeError") and "exactly-summable" in err
    err = str(port8[0]["topk/s2r4_wanfp16/error"])
    assert err.startswith("TypeError") and "supports_hop_requant" in err
    wan = C.TopKCompressor(compress_ratio=0.05)
    with pytest.raises(ValueError, match="region_size"):
        comm.HierarchicalAllreduce(slice_size=2, wan_compressor=wan)
    base = comm.HierarchicalAllreduce(slice_size=2, region_size=4)
    armed = comm.HierarchicalAllreduce(slice_size=2, region_size=4,
                                       wan_compressor=wan)
    p, n = 1600, 400
    lb0 = base.recv_link_bytes(p, n, W, topology=TOPO3)
    lb1 = armed.recv_link_bytes(p, n, W, topology=TOPO3)
    assert (lb1.ici, lb1.dcn) == (lb0.ici, lb0.dcn)
    assert 0 < lb1.wan < lb0.wan
    assert lb1.total == armed.recv_wire_bytes(p, n, W)
    jarmed = jcomm.HierarchicalAllreduce(
        slice_size=2, region_size=4,
        wan_compressor=JC.TopKCompressor(compress_ratio=0.05))
    jtopo = _jax_topology(TOPO3)
    assert tuple(lb1) == tuple(jarmed.recv_link_bytes(p, n, W,
                                                      topology=jtopo))
    assert armed.shrunk(Topology(slice_size=2)).wan_compressor is None
    assert armed.shrunk(TOPO3).wan_compressor is wan
    assert armed.shrunk(Topology()) == comm.HierarchicalAllreduce()


# -- LinkBytes and Topology ---------------------------------------------------

def test_linkbytes_two_tier_constructor_is_exact_alias():
    two = LinkBytes(ici=3, dcn=4)
    assert two == LinkBytes(ici=3, dcn=4, wan=0)
    assert two.wan == 0 and two.total == 7 and two.tiers == (3, 4, 0)
    assert LinkBytes(1, 2, 5).total == 8
    assert LinkBytes(1, 2, 5).tiers == (1, 2, 5)


def test_topology_checks_and_tiers():
    with pytest.raises(ValueError, match="slice_size"):
        Topology(slice_size=0)
    with pytest.raises(ValueError, match="requires slice_size"):
        Topology(region_size=4)
    for rz in (1, 3, 6):
        with pytest.raises(ValueError, match="whole"):
            Topology(slice_size=4, region_size=rz)
    assert TOPO3.flat_tier(W) == "wan"
    assert TOPO3.flat_tier(4) == "dcn"
    assert TOPO3.flat_tier(2) == "ici"
    assert Topology().flat_tier(10**6) == "ici"
    assert not Topology(slice_size=2, region_size=8).crosses_wan(W)


def test_shrink_granularity_matrix():
    """The finest violated level decides what survives, as in JAX."""
    t = Topology(slice_size=2, region_size=4)
    assert t.shrink(16, range(12, 16)) == (t, 12)
    assert t.shrink(16, range(4, 12)) == (t, 8)
    assert t.shrink(16, range(4, 16)) == (Topology(slice_size=2), 4)
    assert t.shrink(8, range(4, 8)) == (Topology(slice_size=2), 4)
    assert t.shrink(16, (2, 3)) == (Topology(slice_size=2), 14)
    assert t.shrink(16, (5,)) == (Topology(), 15)
    assert t.shrink(16, ()) == (t, 16)
    assert Topology().shrink(8, (1, 2)) == (Topology(), 6)
    with pytest.raises(ValueError, match="outside"):
        t.shrink(8, (8,))
    with pytest.raises(ValueError, match="no survivors"):
        t.shrink(2, (0, 1))
    with pytest.raises(ValueError, match="not a multiple"):
        t.shrink(7, (0, 1))


def _jax_topology(topo):
    from grace_tpu.core import Topology as JTopology
    return JTopology(slice_size=topo.slice_size,
                     region_size=topo.region_size)


def test_shrink_matches_jax():
    for topo in (Topology(), Topology(slice_size=2), TOPO3,
                 Topology(slice_size=4, region_size=8)):
        for lost in ((), (0,), (0, 1), (2, 3), (4, 5, 6, 7), range(8, 16),
                     range(4, 16), (1, 9)):
            got = topo.shrink(16, lost)
            want = _jax_topology(topo).shrink(16, lost)
            assert (got[0].slice_size, got[0].region_size, got[1]) == \
                (want[0].slice_size, want[0].region_size, want[1])


class _Dev:
    def __init__(self, slice_index=None, region_index=None):
        if slice_index is not None:
            self.slice_index = slice_index
        if region_index is not None:
            self.region_index = region_index


DETECT_CASES = {
    "even_slices": [_Dev(i // 4) for i in range(16)],
    "one_slice": [_Dev(0) for _ in range(8)],
    "no_attr": [_Dev() for _ in range(8)],
    "empty": [],
    "regions": [_Dev(i // 2, i // 4) for i in range(8)],
    "one_region": [_Dev(i // 2, 0) for i in range(8)],
    "heterogeneous_slice": [_Dev(0), _Dev(0), _Dev(), _Dev(1)],
    "uneven_slices": [_Dev(0)] * 5 + [_Dev(1)] * 3,
    "none_among_indices": [_Dev(None), _Dev(1), _Dev(1)],
    "partial_regions": [_Dev(i // 2, i // 4 if i < 4 else None)
                        for i in range(8)],
    "uneven_regions": ([_Dev(i, 0) for i in range(5)]
                       + [_Dev(5 + i, 1) for i in range(3)]),
    "region_without_slices": [_Dev(region_index=i // 4) for i in range(8)],
    "slice_straddles_region": [_Dev(i // 3, i // 4) for i in range(12)],
}


@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_detect_matches_jax_on_fake_devices(case):
    """The same layouts, the same refusals and the same messages."""
    from grace_tpu.core import Topology as JTopology
    devs = DETECT_CASES[case]
    try:
        want = JTopology.detect(devs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            Topology.detect(devs)
        assert str(got.value) == str(e)
        return
    got = Topology.detect(devs)
    assert (got.slice_size, got.region_size) == (want.slice_size,
                                                 want.region_size)


def test_detect_reads_the_process_group(tmp_path):
    """No group: one slice. A group on one host: one slice."""
    from grace_tpu_torch.parallel import init_process_group
    assert Topology.detect() == Topology()
    init_process_group("cpu", init_method=f"file://{tmp_path}/store")
    try:
        assert Topology.detect() == Topology()
    finally:
        torch.distributed.destroy_process_group()


# -- the wire-byte models -----------------------------------------------------

WORLDS = (0, 1, 2, 3, 4, 8, 16, 256)
TOPOLOGIES = (None, Topology(slice_size=8),
              Topology(slice_size=8, region_size=32))
SIZES = ((8192, 2048), (1000, 250), (2_044_104, 25_557_032))


def _comm_pairs():
    """(port communicator, JAX communicator) for every ported class and
    the options its model reads."""
    from grace_tpu import comm as jcomm
    from grace_tpu import compressors as JC
    pairs = [(comm.Allreduce(), jcomm.Allreduce()),
             (comm.Allgather(), jcomm.Allgather()),
             (comm.Broadcast(), jcomm.Broadcast()),
             (comm.SignAllreduce(), jcomm.SignAllreduce()),
             (comm.TwoShotAllreduce(), jcomm.TwoShotAllreduce()),
             (comm.RingAllreduce(), jcomm.RingAllreduce()),
             (comm.RingAllreduce(pipeline=3), jcomm.RingAllreduce(pipeline=3)),
             (comm.ReduceScatterAllreduce(), jcomm.ReduceScatterAllreduce()),
             (comm.Identity(), jcomm.Identity())]
    for kw in (dict(), dict(slice_size=8), dict(slice_size=4),
               dict(slice_size=8, region_size=32), dict(slice_size=1),
               dict(slice_size=8, pipeline=2)):
        pairs.append((comm.HierarchicalAllreduce(**kw),
                      jcomm.HierarchicalAllreduce(**kw)))
    pairs.append((comm.HierarchicalAllreduce(
        slice_size=8, region_size=32,
        wan_compressor=C.TopKCompressor(compress_ratio=0.01)),
        jcomm.HierarchicalAllreduce(
            slice_size=8, region_size=32,
            wan_compressor=JC.TopKCompressor(compress_ratio=0.01))))
    return pairs


def _ids(pairs):
    return [f"{i}-{type(p).__name__}" for i, (p, _) in enumerate(pairs)]


@pytest.mark.parametrize("i", range(len(_comm_pairs())),
                         ids=_ids(_comm_pairs()))
def test_byte_models_equal_jax(i):
    port, jax_comm = _comm_pairs()[i]
    assert port.wire_overlap_fraction() == jax_comm.wire_overlap_fraction()
    checked = 0
    for w in WORLDS:
        for payload, n in SIZES:
            for vote in (False, True):
                try:
                    want_total = jax_comm.recv_wire_bytes(payload, n, w,
                                                          vote=vote)
                except ValueError as e:
                    with pytest.raises(ValueError, match="does not divide"):
                        port.recv_wire_bytes(payload, n, w, vote=vote)
                    assert "does not divide" in str(e)
                    continue
                got_total = port.recv_wire_bytes(payload, n, w, vote=vote)
                assert type(got_total) is int
                assert got_total == want_total, (w, payload, vote)
                for topo in TOPOLOGIES:
                    jt = None if topo is None else _jax_topology(topo)
                    got = port.recv_link_bytes(payload, n, w, topology=topo,
                                               vote=vote)
                    want = jax_comm.recv_link_bytes(payload, n, w,
                                                    topology=jt, vote=vote)
                    assert tuple(got) == tuple(want), (w, topo, vote)
                    assert got.total == got_total
                    checked += 1
    assert checked >= 100


_CLASSES = ("Allreduce", "Allgather", "Broadcast", "SignAllreduce",
            "TwoShotAllreduce", "RingAllreduce", "HierarchicalAllreduce",
            "Identity", "ReduceScatterAllreduce")


@pytest.mark.parametrize("name", _CLASSES)
def test_degenerate_worlds(name):
    """W=0 and W=1 price to 0 on every tier, even under a topology that
    spans regions; W=2 is positive for every real communicator and bounded
    by a dense two-rank exchange."""
    c = getattr(comm, name)()
    payload, n = 4096, 1024
    for vote in (False, True):
        for world in (0, 1):
            assert c.recv_wire_bytes(payload, n, world, vote=vote) == 0
            assert c.recv_link_bytes(payload, n, world, topology=TOPO3,
                                     vote=vote) == LinkBytes(0, 0, 0)
    two = c.recv_wire_bytes(payload, n, 2)
    if name == "Identity":
        assert two == 0
    else:
        assert 0 < two <= 2 * payload + 4 * n
    for hier in (comm.HierarchicalAllreduce(slice_size=2),
                 comm.HierarchicalAllreduce(slice_size=2, region_size=4)):
        for world in (0, 1):
            assert hier.recv_link_bytes(1000, 250, world, topology=TOPO3,
                                        vote=True) == LinkBytes(0, 0, 0)


def test_hier_split_formula():
    """The documented three legs at W=8, S=2, Rz=4: ICI ``2p(S−1)/S``, DCN
    ``(Kr−1)p/S``, WAN ``(R−1)p/S``; a two-level schedule over three tiers
    puts its whole cross bill on WAN."""
    p = 1600
    h = comm.HierarchicalAllreduce(slice_size=2, region_size=4)
    lb = h.recv_link_bytes(p, 400, W, topology=TOPO3)
    assert lb == LinkBytes(ici=p, dcn=p // 2, wan=p // 2)
    h2 = comm.HierarchicalAllreduce(slice_size=2)
    lb2 = h2.recv_link_bytes(p, 400, W, topology=TOPO3)
    flat2 = h2.recv_link_bytes(p, 400, W, topology=Topology(slice_size=2))
    assert (lb2.ici, lb2.dcn, lb2.wan) == (flat2.ici, 0, flat2.dcn)
    ring = comm.RingAllreduce().recv_link_bytes(p, 400, W, topology=TOPO3)
    assert (ring.ici, ring.dcn) == (0, 0) and ring.wan > 0


def _codec_pairs():
    from grace_tpu import compressors as JC
    return [
        (C.NoneCompressor(), JC.NoneCompressor()),
        (C.FP16Compressor(), JC.FP16Compressor()),
        (C.FP16Compressor(dtype="float16"), JC.FP16Compressor(dtype="float16")),
        (C.TopKCompressor(compress_ratio=0.01),
         JC.TopKCompressor(compress_ratio=0.01)),
        (C.TopKCompressor(compress_ratio=0.3, algorithm="chunk"),
         JC.TopKCompressor(compress_ratio=0.3, algorithm="chunk")),
        (C.TopKCompressor(compress_ratio=0.1, wire_dtype="bfloat16"),
         JC.TopKCompressor(compress_ratio=0.1, wire_dtype="bfloat16")),
        (C.RandomKCompressor(compress_ratio=0.3),
         JC.RandomKCompressor(compress_ratio=0.3)),
        (C.QSGDCompressor(quantum_num=64), JC.QSGDCompressor(quantum_num=64)),
        (C.QSGDCompressor(quantum_num=200),
         JC.QSGDCompressor(quantum_num=200)),
        (C.QSGDCompressor(quantum_num=7), JC.QSGDCompressor(quantum_num=7)),
        (C.QSGDCompressor(quantum_num=3), JC.QSGDCompressor(quantum_num=3)),
        (C.QSGDCompressor(quantum_num=1), JC.QSGDCompressor(quantum_num=1)),
        (C.SignSGDCompressor(), JC.SignSGDCompressor()),
        (C.SignumCompressor(), JC.SignumCompressor()),
        (C.HomoQSGDCompressor(quantum_num=7),
         JC.HomoQSGDCompressor(quantum_num=7)),
        (C.HomoQSGDCompressor(quantum_num=1, accum_bits=4),
         JC.HomoQSGDCompressor(quantum_num=1, accum_bits=4)),
        (C.HomoQSGDCompressor(quantum_num=3, accum_bits=3),
         JC.HomoQSGDCompressor(quantum_num=3, accum_bits=3)),
        (C.CountSketchCompressor(compress_ratio=0.25),
         JC.CountSketchCompressor(compress_ratio=0.25)),
    ]


@pytest.mark.parametrize("i", range(len(_codec_pairs())),
                         ids=[type(p).__name__ + str(i) for i, (p, _) in
                              enumerate(_codec_pairs())])
def test_payload_nbytes_equal_jax(i):
    import jax
    import jax.numpy as jnp

    from grace_tpu.utils.metrics import payload_nbytes as jax_nbytes
    from grace_tpu_torch.utils.metrics import payload_nbytes
    port, jax_codec = _codec_pairs()[i]
    for shape in ((1000,), (37, 5), (3, 3, 16, 8)):
        want = jax_nbytes(jax_codec, jax.ShapeDtypeStruct(shape,
                                                          jnp.float32))
        assert payload_nbytes(port, (shape, torch.float32)) == want, shape
        assert payload_nbytes(port, torch.ones(shape)) == want


def test_payload_nbytes_prefers_the_analytic_count():
    from grace_tpu_torch.utils.metrics import payload_nbytes

    @dataclasses.dataclass(frozen=True)
    class Declared(C.NoneCompressor):
        def wire_nbytes(self, shape, dtype):
            return 12345

    assert payload_nbytes(Declared(), ((10,), torch.float32)) == 12345
    assert payload_nbytes(C.NoneCompressor(), ((10,), torch.float32)) == 40


def test_negotiation_bytes_for_matches_jax():
    """The one accessor of a negotiation's bytes: the world-only
    ``negotiation_nbytes`` (homoqsgd's scalar MAX), 0 for a codec without
    a negotiation, and a leaf-aware ``negotiation_nbytes_for`` where a
    codec declares one."""
    from grace_tpu import compressors as JC
    from grace_tpu.core import negotiation_bytes_for as jax_bytes_for
    from grace_tpu_torch.core import negotiation_bytes_for
    pairs = [(C.HomoQSGDCompressor(quantum_num=7),
              JC.HomoQSGDCompressor(quantum_num=7)),
             (C.TopKCompressor(compress_ratio=0.01),
              JC.TopKCompressor(compress_ratio=0.01))]
    for port, jax_codec in pairs:
        for w in WORLDS:
            for n in (1, 1000, 25_557_032):
                assert negotiation_bytes_for(port, n, w) == \
                    jax_bytes_for(jax_codec, n, w)

    @dataclasses.dataclass(frozen=True)
    class LeafAware(C.NoneCompressor):
        def negotiation_nbytes_for(self, n_elems, world):
            return 4 * n_elems * max(0, world - 1)

    assert negotiation_bytes_for(LeafAware(), 100, 3) == 800
    assert negotiation_bytes_for(C.HomoQSGDCompressor(), 100, 1) == 0
