"""Operations of a BERT-style encoder's training step: the arithmetic of
the port's ``models/transformer.n_flops``, copied.

The projections (qkv, proj, ff1, ff2) and the attention's two products,
2 operations a multiply-add, forward and backward (3 × the forward). The
embeddings and the span head are left out.
"""

from __future__ import annotations


def step_flops(config, batch: int) -> int:
    """Operations of one rank's training step at ``batch`` sequences."""
    d, f = config["hidden_size"], config["intermediate_size"]
    seq = config["seq_len"]
    tokens = batch * seq
    proj = 2 * tokens * (3 * d * d + d * d + 2 * d * f)
    attn = 2 * 2 * tokens * seq * d
    return 3 * config["num_hidden_layers"] * (proj + attn)
