"""Plain BERT-style encoder with a span head (Devlin et al. 2018), written
from the configuration file alone.

The configuration's encoder: token and position tables, pre-LN blocks
(LayerNorm, self-attention over ``num_attention_heads`` heads, residual;
LayerNorm, dense → tanh GELU → dense, residual), a final LayerNorm, and a
2-way dense head on every token whose two columns are the start and end
logits over the sequence, read in float32 as the configuration's model
reads it. The loss is the sum of the start's and the
end's cross-entropies. Parameters are a flat dict of float32 tensors
(``tok_emb.table``, ``layers.0.qkv.w``, …), dense kernels ``(din,
dout)``; ``qkv`` splits as ``(N, T, 3, H, Dh)``. Also the inputs: uniform
token ids, span starts in the sequence's first half and ends in its
second, drawn from a generator on the device.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision


def param_shapes(config) -> Dict[str, Tuple[int, ...]]:
    d, f = config["hidden_size"], config["intermediate_size"]
    shapes = {"tok_emb.table": (config["vocab_size"], d),
              "pos_emb.table": (config["max_position_embeddings"], d),
              "ln_f.scale": (d,), "ln_f.bias": (d,),
              "cls.w": (d, config["num_labels"]),
              "cls.b": (config["num_labels"],)}
    for i in range(config["num_hidden_layers"]):
        pre = f"layers.{i}"
        shapes.update({
            f"{pre}.ln1.scale": (d,), f"{pre}.ln1.bias": (d,),
            f"{pre}.qkv.w": (d, 3 * d), f"{pre}.qkv.b": (3 * d,),
            f"{pre}.proj.w": (d, d), f"{pre}.proj.b": (d,),
            f"{pre}.ln2.scale": (d,), f"{pre}.ln2.bias": (d,),
            f"{pre}.ff1.w": (d, f), f"{pre}.ff1.b": (f,),
            f"{pre}.ff2.w": (f, d), f"{pre}.ff2.b": (d,)})
    return shapes


def make_batches(config, count: int, batch: int, gen: torch.Generator,
                 device) -> list:
    """``count`` distinct (token ids, (start, end) spans) batches."""
    t = config["seq_len"]
    ids = torch.randint(0, config["vocab_size"], (count, batch, t),
                        generator=gen, device=device)
    starts = torch.randint(0, t // 2, (count, batch), generator=gen,
                           device=device)
    ends = torch.randint(t // 2, t, (count, batch), generator=gen,
                         device=device)
    spans = torch.stack([starts, ends], dim=-1)
    return [(ids[i], spans[i]) for i in range(count)]


def _ln(x, p, name, eps, prec: Precision):
    return prec.act(F.layer_norm(x, (x.shape[-1],), p[f"{name}.scale"],
                                 p[f"{name}.bias"], eps))


def _dense(x, p, name, prec: Precision):
    return prec.act(x @ prec.weight(p[f"{name}.w"])
                    + prec.weight(p[f"{name}.b"]))


def span_logits(p: Dict[str, torch.Tensor], ids: torch.Tensor, config,
                prec: Precision) -> torch.Tensor:
    n, t = ids.shape
    d, h = config["hidden_size"], config["num_attention_heads"]
    dh = d // h
    eps = config["layer_norm_eps"]
    act = prec.act
    x = act(prec.weight(p["tok_emb.table"])[ids]
            + prec.weight(p["pos_emb.table"][:t]))
    for i in range(config["num_hidden_layers"]):
        pre = f"layers.{i}"
        qkv = _dense(_ln(x, p, f"{pre}.ln1", eps, prec), p, f"{pre}.qkv",
                     prec).reshape(n, t, 3, h, dh)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        scores = act(act(q @ k.transpose(-1, -2)) / math.sqrt(dh))
        attn = act(torch.softmax(scores, dim=-1))
        out = act(attn @ v).transpose(1, 2).reshape(n, t, d)
        x = act(x + _dense(out, p, f"{pre}.proj", prec))
        y = act(F.gelu(_dense(_ln(x, p, f"{pre}.ln2", eps, prec), p,
                              f"{pre}.ff1", prec), approximate="tanh"))
        x = act(x + _dense(y, p, f"{pre}.ff2", prec))
    x = _ln(x, p, "ln_f", eps, prec)
    return x @ p["cls.w"] + p["cls.b"]       # (N, T, 2); the head in float32


def loss(p: Dict[str, torch.Tensor], batch, config,
         prec: Precision) -> torch.Tensor:
    ids, spans = batch
    z = span_logits(p, ids, config, prec)
    return (F.cross_entropy(z[..., 0], spans[:, 0])
            + F.cross_entropy(z[..., 1], spans[:, 1]))
