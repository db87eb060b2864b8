"""BERT-style encoder; counterpart of the JAX ``models/transformer.py``.

Pre-LN blocks (LayerNorm, multi-head self-attention, residual; LayerNorm,
dense → GELU → dense, residual), a final LayerNorm, a classification head
over the first token (``forward``) and masked-LM logits tied to the token
embedding (``mlm_logits``). LayerNorm only, so no buffers.

Parameter names are the JAX tree paths: ``tok_emb.table``,
``pos_emb.table``, ``ln_f.{scale,bias}``, ``cls.{w,b}`` and
``layers.<i>.{ln1,qkv,proj,ln2,ff1,ff2}.*``, where ``layers`` is an
``nn.ModuleList``, as the JAX tree's ``"layers"`` is a list; layouts stay
JAX's (``(din, dout)`` dense weights), so ``convert.from_jax`` carries
``transformer.init``'s parameters across unchanged.

Numerics follow the JAX model:

* GELU is the tanh approximation (``jax.nn.gelu``'s default);
* the attention logits are divided by ``sqrt(dh)`` cast to the activation
  dtype, masked with ``-1e9`` in the logits' dtype, and the softmax runs in
  float32 and casts back;
* ``qkv`` splits as ``(N, T, 3, H, Dh)``;
* the attention is plain tensor algebra (``matmul`` and ``softmax``), as
  JAX computes it outside any kernel;
* under a bfloat16 compute dtype the tables and weights are cast per call
  over float32 parameters, and the heads read float32 activations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from grace_tpu_torch.models.layers import Dense, Embedding, LayerNorm
from grace_tpu_torch.parallel import resolve_device

_MASKED = -1e9


@dataclasses.dataclass(frozen=True)
class Config:
    vocab_size: int = 30522
    d_model: int = 768
    num_heads: int = 12
    num_layers: int = 12
    d_ff: int = 3072
    max_len: int = 512
    num_classes: int = 2


def base(**kw) -> Config:
    """BERT-base: 12 layers, 768 wide, 12 heads."""
    return Config(**kw)


def tiny(**kw) -> Config:
    """Test-scale config."""
    d = dict(vocab_size=1000, d_model=64, num_heads=4, num_layers=2,
             d_ff=128, max_len=64, num_classes=2)
    d.update(kw)
    return Config(**d)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Config, *, generator: torch.Generator):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.num_heads = cfg.num_heads
        self.ln1 = LayerNorm(d)
        self.qkv = Dense(d, 3 * d, init="trunc", generator=generator)
        self.proj = Dense(d, d, init="trunc", generator=generator)
        self.ln2 = LayerNorm(d)
        self.ff1 = Dense(d, f, init="trunc", generator=generator)
        self.ff2 = Dense(f, d, init="trunc", generator=generator)

    def attention(self, x: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
        n, t, d = x.shape
        h = self.num_heads
        dh = d // h
        qkv = self.qkv(x).reshape(n, t, 3, h, dh)
        q = qkv[:, :, 0].transpose(1, 2)            # (N, H, T, Dh)
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        scale = torch.tensor(float(dh)).sqrt().to(x.dtype)
        logits = (q @ k.transpose(-1, -2)) / scale  # (N, H, Tq, Tk)
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :].bool(),
                                        _MASKED)
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(n, t, d)
        return self.proj(out)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attention(self.ln1(x), mask)
        y = self.ff2(F.gelu(self.ff1(self.ln2(x)), approximate="tanh"))
        return x + y


class Transformer(nn.Module):
    """``encode(ids)``: ``(N, T)`` token ids → hidden states ``(N, T, D)``
    in the compute ``dtype``; ``forward``: classification logits over the
    first token, float32; ``mlm_logits``: float32 logits over the
    vocabulary."""

    def __init__(self, cfg: Config, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        # Initialise on the CPU from one seeded stream, then move.
        gen = torch.Generator().manual_seed(seed)
        self.tok_emb = Embedding(cfg.vocab_size, cfg.d_model, generator=gen)
        self.pos_emb = Embedding(cfg.max_len, cfg.d_model, generator=gen)
        self.ln_f = LayerNorm(cfg.d_model)
        self.cls = Dense(cfg.d_model, cfg.num_classes, init="trunc",
                         generator=gen)
        self.layers = nn.ModuleList(EncoderLayer(cfg, generator=gen)
                                    for _ in range(cfg.num_layers))
        self.to(dev)

    def encode(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
               dtype=torch.float32) -> torch.Tensor:
        t = ids.shape[1]
        if t > self.cfg.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len "
                             f"{self.cfg.max_len}")
        x = self.tok_emb(ids, dtype)
        x = x + self.pos_emb.table[:t].to(dtype)
        for layer in self.layers:
            x = layer(x, mask)
        return self.ln_f(x)

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
                dtype=torch.float32) -> torch.Tensor:
        x = self.encode(ids, mask, dtype)
        return self.cls(x[:, 0].float())

    def mlm_logits(self, ids: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   dtype=torch.float32) -> torch.Tensor:
        """Masked-LM logits, the head tied to the token embedding."""
        x = self.encode(ids, mask, dtype)
        return x.float() @ self.tok_emb.table.T


def n_flops(cfg: Config, batch: int, seq: int) -> int:
    """Matmul operations of one training step (forward and backward, 3×
    the forward): the projections (qkv, proj, ff1, ff2) and the attention's
    two products, 2 operations a multiply-add."""
    d, f = cfg.d_model, cfg.d_ff
    tokens = batch * seq
    proj = 2 * tokens * (3 * d * d + d * d + 2 * d * f)
    attn = 2 * 2 * tokens * seq * d
    return 3 * cfg.num_layers * (proj + attn)


__all__ = ["Config", "base", "tiny", "Transformer", "EncoderLayer",
           "n_flops"]
