"""The rest of the catalog's registry configurations at two ranks over a
real gloo group, against the JAX package's ``grace_transform`` on a
two-device mesh, through the workers of ``tests/test_torch_catalog_dist.py``
(three steps, every update and state; JAX's draws through ``JaxKey``).

The configurations are the JAX package's analysis registry entries for
terngrad, 1-bit, threshold, sketch, u8bit, AdaQ and inceptionn, their
params copied here, and ``bench_all.py``'s ``topk1pct_approx`` row at
ratio 0.05 (the test's leaves are small). Bit for bit where the codec sums
no floats; see ``TOLERANCE`` for the others.
"""

import numpy as np
import pytest
from test_torch_catalog_dist import (WORLD, check_config, grads, run_jax,
                                     run_port)

CONFIGS = {
    "terngrad-allgather": {"compressor": "terngrad", "memory": "none",
                           "communicator": "allgather"},
    "onebit-allgather": {"compressor": "onebit", "memory": "residual",
                         "communicator": "allgather"},
    "threshold-allgather": {"compressor": "threshold", "threshold": 0.01,
                            "memory": "residual",
                            "communicator": "allgather"},
    "sketch-allgather": {"compressor": "sketch", "quantum_num": 64,
                         "memory": "none", "communicator": "allgather"},
    "u8bit-allgather": {"compressor": "u8bit", "memory": "none",
                        "communicator": "allgather"},
    "adaq-allgather": {"compressor": "adaq", "compress_ratio": 0.3,
                       "memory": "residual", "communicator": "allgather"},
    "inceptionn-allgather": {"compressor": "inceptionn", "memory": "none",
                             "communicator": "allgather"},
    "topk5pct_approx": {"compressor": "topk", "compress_ratio": 0.05,
                        "topk_algorithm": "approx", "memory": "residual",
                        "communicator": "allgather", "fusion": "flat"},
}

TOLERANCE = {
    # the standard deviation (the clip and the scale).
    "terngrad-allgather": (1e-5, 1e-6),
    # each side's sum, divided by its count.
    "onebit-allgather": (1e-5, 1e-6),
    # each side's mean over its selected entries.
    "adaq-allgather": (1e-5, 1e-6),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    g = grads()
    ref = {name: run_jax(cfg, g) for name, cfg in CONFIGS.items()}
    port = run_port(str(tmp_path_factory.mktemp("catalog2")), CONFIGS, g)
    return port, ref


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_registry_config_matches_jax_over_three_steps(results, name):
    port, ref = results
    check_config(name, port, ref[name], TOLERANCE.get(name))


def test_every_update_is_finite_and_moves(results):
    """Sanity of the comparison: every update is finite and nonzero on
    both ranks."""
    port, _ = results
    for name in CONFIGS:
        for r in range(WORLD):
            for key, v in port[r].items():
                if key.startswith(f"{name}/out/"):
                    assert np.all(np.isfinite(v)) and np.any(v != 0), key
