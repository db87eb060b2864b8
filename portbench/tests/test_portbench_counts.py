"""The benchmark's operation and byte counts, pinned to the repo's own
figures."""

import math

import pytest

from portbench.counts import bert, chunk_topk, resnet
from portbench.harness import manifest
from portbench.reference.models import bert as ref_bert
from portbench.reference.models import resnet as ref_resnet

RESNET = manifest.load_json(manifest.BENCH_DIR / "configs" / "resnet50.json")
BERT = manifest.load_json(manifest.BENCH_DIR / "configs" / "bert_base.json")


def test_bert_base_step_is_n_flops():
    # models/transformer.n_flops at (32, 384): 6.78 TFLOP a step.
    assert bert.step_flops(BERT, 32) == 6_783_900_844_032


def test_resnet50_forward_is_torchvision_4_09_gmac():
    assert resnet.forward_macs(RESNET) == pytest.approx(4.09e9, rel=0.01)
    assert resnet.step_flops(RESNET, 256) == 6 * 256 * resnet.forward_macs(
        RESNET)


@pytest.mark.parametrize("config,module", [(RESNET, ref_resnet),
                                           (BERT, ref_bert)])
def test_leaves_and_parameters_as_the_configuration_states(config, module):
    shapes = module.param_shapes(config)
    assert len(shapes) == config["leaves"]
    assert sum(math.prod(s) for s in shapes.values()) == config["parameters"]


def test_bert_keeps_the_published_position_table():
    # 98,304 over the 384-row table of chip_smoke.py's BERT-base.
    assert BERT["parameters"] - 108_793_346 == 128 * 768


def test_chunk_bytes_at_resnet50_w1():
    ns = [math.prod(s) for s in ref_resnet.param_shapes(RESNET).values()]
    assert chunk_topk.compress_bytes(ns, 0.01) / 1e6 == pytest.approx(
        308.7, abs=0.05)
    assert chunk_topk.aggregate_bytes(ns, 0.01, 1) / 1e6 == pytest.approx(
        104.3, abs=0.05)
    n, k = chunk_topk.totals(ns, 0.01)
    assert chunk_topk.aggregate_bytes(ns, 0.01, 4) == 4 * n + 32 * k


def test_kept_is_the_codec_rule():
    assert [chunk_topk.kept(n, 0.01) for n in (1, 64, 100, 2048)] == [1, 1,
                                                                       1, 20]
    assert chunk_topk.totals([1], 0.01) == (0, 0)       # n < 2k: staged
