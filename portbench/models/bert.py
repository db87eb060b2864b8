"""The port's BERT-style encoder (``grace_tpu_torch.models.transformer``)
under the benchmark: built without weights, and the span loss the train
step takes (the port's example's ``span_loss``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def build(config, device) -> torch.nn.Module:
    """The port's model on ``device`` with its parameters unset: the
    benchmark draws them. Built on the meta device, since the port's
    constructor draws every weight on the host first."""
    from grace_tpu_torch.models import transformer as T

    if (config["layer_norm_eps"], config["hidden_act"],
            config["type_vocab_size"], config["hidden_dropout_prob"],
            config["attention_probs_dropout_prob"]) != (
                1e-6, "gelu_tanh", 0, 0.0, 0.0):
        raise ValueError("the port's encoder has LayerNorm eps 1e-6, the "
                         "tanh GELU, no token-type table and no dropout")
    cfg = T.Config(vocab_size=config["vocab_size"],
                   d_model=config["hidden_size"],
                   num_heads=config["num_attention_heads"],
                   num_layers=config["num_hidden_layers"],
                   d_ff=config["intermediate_size"],
                   max_len=config["max_position_embeddings"],
                   num_classes=config["num_labels"])

    class Unplaced(T.Transformer):
        def to(self, *args, **kwargs):
            return self

    with torch.device("meta"):
        model = Unplaced(cfg, device="cpu", seed=0)
    model.__class__ = T.Transformer
    model.to_empty(device=device)
    return model


def loss(config, half_batch: bool = False):
    """``loss(model, (ids, spans))``: the start and end cross-entropies of
    the head's two columns over the sequence, summed, with the encoder in
    the compute dtype. ``half_batch`` plants a fault: the first half of
    the batch alone."""
    dtype = getattr(torch, config["compute_dtype"])

    def fn(model, batch):
        ids, spans = batch
        if half_batch:
            ids, spans = ids[:ids.shape[0] // 2], spans[:spans.shape[0] // 2]
        x = model.encode(ids, dtype=dtype)
        z = model.cls(x.float())                        # (N, T, 2)
        return (F.cross_entropy(z[..., 0], spans[:, 0])
                + F.cross_entropy(z[..., 1], spans[:, 1]))

    return fn
