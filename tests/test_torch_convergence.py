"""The catalog's LeNet curves: the port against the JAX package's.

Each entry of ``CURVES`` is one committed curve of the port
(``grace_tpu_torch/examples/logs/``, eight gloo ranks on the CPU) beside
the JAX package's curve of the same flags (``examples/logs/``; the
``--fusion none`` PowerSGD one under the port's logs, since the committed
JAX PowerSGD curves equal the uncompressed ones byte for byte). The
tolerances:

* exact Top-K, the dense runs and PowerSGD: the final epoch within 0.5 pp
  on MNIST (10 of 2,000 images), 1.1 pp on the digits (4 of 360);
* QSGD: the final epoch within 1.0 pp on MNIST, 1.5 pp on the digits (the
  draws differ: the port's counter hash against JAX's threefry);
* the signSGD vote: the best epoch within 0.5 pp, and each of the first 5
  epochs within 1 pp (fixed-step signSGD wanders, so its final epoch is
  reported, not held).

The committed curves are held here on every run; the slow tests run each
curve again and hold the new run to the same tolerance, and carry the
port's counterparts of ``tests/test_convergence.py``'s floors.
"""

import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LOGS = os.path.join(REPO, "examples", "logs")
PORT_LOGS = os.path.join(REPO, "grace_tpu_torch", "examples", "logs")

MNIST_RULE = {"final": 0.005}
DIGITS_RULE = {"final": 0.011}
VOTE_RULE = {"best": 0.005, "first5": 0.01}
_TOPK = ["--compressor", "topk", "--memory", "residual"]
# name: (example, flags, JAX's curve, rule)
CURVES = {
    "mnist10k_qsgd64": (
        "mnist10k_lenet", ["--compressor", "qsgd", "--quantum-num", "64"],
        "mnist10k_qsgd64.tsv", {"final": 0.010}),
    "mnist10k_signsgd_vote": (
        "mnist10k_lenet", ["--compressor", "signsgd", "--communicator",
                           "sign_allreduce", "--sgd-momentum", "0",
                           "--cosine-lr", "--lr", "0.001"],
        "mnist10k_signsgd_vote.tsv", VOTE_RULE),
    "mnist10k_topk1pct": (
        "mnist10k_lenet", _TOPK, "mnist10k_topk1pct.tsv", MNIST_RULE),
    "mnist10k_uncompressed": (
        "mnist10k_lenet", ["--communicator", "allreduce"],
        "mnist10k_uncompressed.tsv", MNIST_RULE),
    "digits_uncompressed": (
        "digits_lenet", ["--communicator", "allreduce"],
        "digits_uncompressed.tsv", DIGITS_RULE),
    "digits_topk1pct": (
        "digits_lenet", _TOPK, "digits_topk1pct.tsv", DIGITS_RULE),
    "digits_topk1pct_perleaf": (
        "digits_lenet", _TOPK + ["--fusion", "none"],
        "digits_topk1pct_perleaf.tsv", DIGITS_RULE),
    "digits_topk1pct_rbf16": (
        "digits_lenet", _TOPK + ["--topk-algorithm", "chunk",
                                 "--memory-dtype", "bfloat16"],
        "digits_topk1pct_rbf16.tsv", DIGITS_RULE),
    "digits_topk1pct_twoshot": (
        "digits_lenet", _TOPK + ["--communicator", "twoshot"],
        "digits_topk1pct_twoshot.tsv", DIGITS_RULE),
    "digits_qsgd64": (
        "digits_lenet", ["--compressor", "qsgd", "--quantum-num", "64"],
        "digits_qsgd64.tsv", {"final": 0.015}),
    "digits_signsgd_vote": (
        "digits_lenet", ["--compressor", "signsgd", "--communicator",
                         "sign_allreduce", "--lr", "0.0003"],
        "digits_signsgd_vote.tsv", VOTE_RULE),
    "digits_powersgd_r4_none": (
        "digits_lenet", ["--compressor", "powersgd", "--memory", "powersgd",
                         "--communicator", "allreduce", "--compress-rank",
                         "4", "--fusion", "none"],
        os.path.join(PORT_LOGS, "jax_digits_powersgd_r4_none.tsv"),
        DIGITS_RULE),
}
EPOCHS = {"mnist10k_lenet": 50, "digits_lenet": 60}


def read_curve(path):
    """(header dict, test accuracies) of a curve file."""
    header, accs = {}, []
    for line in open(path).read().splitlines():
        if line.startswith("# "):
            key, _, value = line[2:].partition(": ")
            header[key] = value
        elif line and not line.startswith("epoch"):
            accs.append(float(line.split("\t")[2]))
    return header, np.array(accs)


def hold(got, want, rule):
    """Assert the rule: ``final`` (last epochs within), ``best`` (best
    epochs within), ``first5`` (each of the first five within)."""
    assert len(got) == len(want), (len(got), len(want))
    if "final" in rule:
        assert abs(got[-1] - want[-1]) <= rule["final"] + 1e-9, \
            f"final {got[-1]:.4f} against JAX's {want[-1]:.4f}"
    if "best" in rule:
        assert abs(got.max() - want.max()) <= rule["best"] + 1e-9, \
            f"best {got.max():.4f} against JAX's {want.max():.4f}"
    if "first5" in rule:
        np.testing.assert_allclose(got[:5], want[:5], rtol=0,
                                   atol=rule["first5"] + 1e-9)


def _jax_path(name):
    ref = CURVES[name][2]
    return ref if os.path.isabs(ref) else os.path.join(JAX_LOGS, ref)


@pytest.mark.parametrize("name", list(CURVES))
def test_committed_curve_meets_its_tolerance(name):
    """The port's committed curve: eight ranks, the flags of ``CURVES``
    in its header, and within its tolerance of JAX's."""
    example, flags, _, rule = CURVES[name]
    header, got = read_curve(os.path.join(PORT_LOGS, f"{name}.tsv"))
    _, want = read_curve(_jax_path(name))
    assert len(got) == EPOCHS[example]
    assert header["world" if "world" in header else "world_size"] == "8"
    assert header["backend"] == "gloo"
    for flag, value in zip(flags, flags[1:]):
        if flag.startswith("--") and not value.startswith("--"):
            if flag in ("--compressor", "--memory", "--communicator"):
                assert f'"{flag[2:]}": "{value}"' in header["config"], flag
    hold(got, want, rule)


def test_the_jax_powersgd_reference_is_powersgd():
    """The ``--fusion none`` JAX PowerSGD run departs from the dense curve
    (the committed flat ones equal it byte for byte), so it is evidence of
    PowerSGD."""
    header, ps = read_curve(_jax_path("digits_powersgd_r4_none"))
    assert (header["compressor"], header["fusion"]) == ("powersgd", "none")
    _, dense = read_curve(os.path.join(JAX_LOGS, "digits_uncompressed.tsv"))
    assert not np.array_equal(ps, dense)


def _run(example, flags, epochs, tmp_path):
    from grace_tpu_torch.examples import digits_lenet, mnist10k_lenet
    argv = ["--device", "cpu", "--nproc", "8", "--epochs", str(epochs),
            "--tsv", str(tmp_path / "curve.tsv"), *flags]
    if example == "digits_lenet":
        pytest.importorskip("sklearn", reason="the digits ship with "
                            "scikit-learn")
        return digits_lenet.run(argv)["test_acc"]
    return mnist10k_lenet.run(argv)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CURVES))
def test_curve_reruns_within_its_tolerance(name, tmp_path):
    example, flags, _, rule = CURVES[name]
    _run(example, flags, EPOCHS[example], tmp_path)
    _, got = read_curve(tmp_path / "curve.tsv")
    _, want = read_curve(_jax_path(name))
    hold(got, want, rule)


# -- the port's counterparts of tests/test_convergence.py ---------------------

@pytest.mark.slow
def test_digits_topk_reaches_97pct(tmp_path):
    acc = _run("digits_lenet", _TOPK, 30, tmp_path)
    assert acc >= 0.97, f"digits Top-K 1% convergence regressed: acc={acc}"


@pytest.mark.slow
def test_digits_topk_bf16_residual_floor(tmp_path):
    acc = _run("digits_lenet", _TOPK + ["--topk-algorithm", "chunk",
                                        "--memory-dtype", "bfloat16"],
               30, tmp_path)
    assert acc >= 0.97, f"bf16-residual convergence regressed: acc={acc}"


@pytest.mark.slow
def test_digits_topk_ring_floor(tmp_path):
    acc = _run("digits_lenet", _TOPK + ["--communicator", "ring"], 45,
               tmp_path)
    assert acc >= 0.96, f"digits Top-K 1% + ring convergence regressed: " \
        f"acc={acc}"


@pytest.mark.slow
def test_real_mnist_topk_floor(tmp_path):
    acc = _run("mnist10k_lenet", _TOPK, 10, tmp_path)
    assert acc >= 0.94, f"real-MNIST Top-K 1% convergence regressed: " \
        f"acc={acc}"
