"""BERT-base + PowerSGD rank 4 on synthetic SQuAD-like spans.

The port's twin of the repository's ``examples/bert_powersgd.py``, with
the same flags and defaults: BERT-base (``transformer.base()``), sequence
384, a global batch of 32, AdamW at 5e-5 (optax's decay of 1e-4),
PowerSGD rank 4 with its memory over the all-reduce, one exchange a leaf
(``--fusion none``), 1,024 synthetic sequences and one epoch (32 steps).
The head is a per-token span head: ``cls`` maps each hidden state to a
start and an end logit, and the loss is the sum of the start and end
cross-entropies. Each rank takes its contiguous ``B/W`` rows of every
global batch.

The data is synthetic: each context hides one contiguous answer span drawn
from the top tenth of the vocabulary, so the span is learnable from token
identity alone. ``synthetic_squad`` draws the JAX example's arrays from the
same seed.

One rank on the card:

    python -m grace_tpu_torch.examples.bert_powersgd

Two gloo ranks on the CPU, a tiny encoder:

    python -m grace_tpu_torch.examples.bert_powersgd --device cpu \\
        --nproc 2 --size tiny --seq-len 64 --batch-size 8 --train-size 32
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from grace_tpu_torch import grace_from_params
from grace_tpu_torch.data import batches
from grace_tpu_torch.examples import common
from grace_tpu_torch.models import transformer
from grace_tpu_torch.train import init_train_state, make_train_step
from grace_tpu_torch.utils import (TableLogger, Timer, rank_zero_print,
                                   wire_report)


def synthetic_squad(n, cfg, seq_len, seed=0):
    """Contexts with one hidden answer span; labels ``(start, end)``.

    Context tokens come from the lower 90% of the vocabulary; the answer
    span (1-8 tokens) from the top 10%. The JAX example's draws, in its
    order."""
    if seq_len < 16:
        raise ValueError(f"--seq-len must be >=16 (got {seq_len}): contexts "
                         "need room for a 1-8 token answer span")
    rng = np.random.default_rng(seed)
    answer_lo = int(cfg.vocab_size * 0.9)
    ids = rng.integers(0, answer_lo, (n, seq_len)).astype(np.int32)
    span_len = rng.integers(1, 9, n)
    start = rng.integers(0, seq_len - 8, n)
    end = start + span_len - 1
    for i in range(n):
        ids[i, start[i]:end[i] + 1] = rng.integers(
            answer_lo, cfg.vocab_size, span_len[i])
    return ids, np.stack([start, end], 1).astype(np.int32)


def span_loss(model, batch, dtype) -> torch.Tensor:
    """Mean over the batch of the start and end cross-entropies: ``cls``
    applied to every token's float32 hidden state."""
    ids, spans = batch
    x = model.encode(ids, dtype=dtype)
    logits = model.cls(x.float())                   # (N, T, 2)
    return (F.cross_entropy(logits[..., 0], spans[:, 0])
            + F.cross_entropy(logits[..., 1], spans[:, 1]))


def adamw(params, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)``: its betas, eps and weight decay of 1e-4."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    common.add_grace_args(parser)
    parser.set_defaults(compressor="powersgd", memory="powersgd",
                        communicator="allreduce", fusion="none")
    parser.add_argument("--size", default="base", help="base|tiny")
    parser.add_argument("--seq-len", type=int, default=384,
                        help="384 = standard SQuAD fine-tuning length")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=32,
                        help="global batch (split across the ranks)")
    parser.add_argument("--train-size", type=int, default=1024)
    parser.add_argument("--lr", type=float, default=5e-5)
    common.add_rank_args(parser)
    return parser


def train(args, group, dev, log=rank_zero_print) -> dict:
    """Train under ``args`` as this rank of ``group`` on ``dev``. Returns
    the per-step losses (floats) and the per-epoch seq/s."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if args.batch_size % world:
        raise ValueError(f"--batch-size {args.batch_size} does not split "
                         f"over {world} ranks")
    local = args.batch_size // world
    if args.size == "tiny":
        cfg = transformer.tiny(num_classes=2, max_len=max(64, args.seq_len))
    else:
        cfg = transformer.base(num_classes=2, max_len=args.seq_len)
    model = transformer.Transformer(cfg, device=dev, seed=args.seed)
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    log(f"BERT-{args.size}: {n_params / 1e6:.1f}M params, seq_len "
        f"{args.seq_len}, {len(named)} leaves")
    ids, spans = synthetic_squad(args.train_size, cfg, args.seq_len,
                                 args.seed)
    grace = grace_from_params(common.grace_params_from_args(args),
                              group=group)
    log(f"PowerSGD rank {args.compress_rank}; wire cost:",
        wire_report(grace.compressor, named)
        if args.compressor != "powersgd" else
        "(PowerSGD communicates P/Q factors inside compress)")
    tx = grace.transform(seed=args.seed)
    state = init_train_state(model, tx, adamw(model.parameters(), args.lr),
                             group)
    dtype = common.compute_dtype(dev)
    step = make_train_step(lambda m, b: span_loss(m, b, dtype), tx, group)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    table, timer = TableLogger(), Timer(sync)
    losses, rates = [], []
    rows_of = slice(rank * local, (rank + 1) * local)
    for epoch in range(1, args.epochs + 1):
        epoch_losses, n_seq = [], 0
        sync()
        t0 = time.perf_counter()
        for idb, spanb in batches(ids, spans, args.batch_size, shuffle=True,
                                  seed=args.seed + epoch):
            batch = (torch.from_numpy(idb[rows_of]).long().to(dev),
                     torch.from_numpy(spanb[rows_of]).long().to(dev))
            state, loss = step(state, batch)
            epoch_losses.append(loss)
            n_seq += idb.shape[0]
        epoch_losses = [float(l) for l in epoch_losses]     # synchronises
        rates.append(n_seq / (time.perf_counter() - t0))
        losses += epoch_losses
        if rank == 0:
            table.append({"epoch": epoch,
                          "train loss": sum(epoch_losses) / len(epoch_losses),
                          "epoch time": timer(), "seq/sec": rates[-1]})
    if losses:
        log(f"Seq/sec: {np.mean(rates):.1f}; train loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} over {len(losses)} steps")
    if not all(math.isfinite(l) for l in losses):
        raise RuntimeError(f"non-finite training loss: {losses}")
    return {"losses": losses, "seq_per_s": rates}


def run(argv, group, dev) -> dict:
    return train(build_parser().parse_args(argv), group, dev)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    common.run_ranks(run, argv, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
