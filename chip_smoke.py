#!/usr/bin/env python3
"""Drive grace_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --times-from ROOT
    python3 chip_smoke.py --profile-callout NPY

Runs as one process on one card, in a world-size-1 NCCL group (the
collectives are real calls). Every phase passes or ends the script with a
non-zero exit; nothing is caught and allowed to continue. It refuses to
start while any GRACE_DISABLE_PALLAS* variable is set: a kernel family
turned off would make its checks compare plain versions with themselves.
With ``--times-from ROOT`` it runs phase 3's, 8's and 12's timings alone,
of the kernels of the checkout at ROOT (an earlier commit, unpacked with
``git archive``), so that two versions compare within one call. With
``--profile-callout NPY`` it is phase 37's profiler reading, which phase
37 runs in a process of its own.

Every timed kernel row of phases 3, 8 and 12 reads the kernel alone with
two clocks: the profiler's device time of the kernel, and CUDA events
around R back-to-back calls queued behind a ``torch.cuda._sleep``
(divided by R); and both again with the card's L2 cache flushed before
each call (an input of up to ~40 MB stays in the 50 MB L2 from one call
to the next). A profiler reading under the kernel's bound, or more than
25% from the event reading, is printed on a line of its own
(``MEASUREMENT FAULT``): a fault of the measurement, which does not fail
the run.

1. Identify the card and build the CUDA kernels from grace_tpu_torch/csrc
   (one nvcc process per source, all started together).
2. Hold each chunk Top-K kernel against its plain PyTorch version on the
   card, bit for bit: one leaf at a time over every distinct ResNet-50 leaf
   size at 1% and the edge cases, then grouped, all 161 ResNet-50 leaves
   and the edge-column leaf in one launch (the four compress variants; the
   aggregate at W in {1, 8} x {f32, bf16} with colliding and out-of-range
   rows in the group), and the aggregate at W=1000 on a few small leaves
   (past one rank tile of its shared memory).
3. Time the grouped chunk Top-K kernels at the main path's shapes (all 161
   ResNet-50 leaves in one launch), beside their byte bound, the kernel
   alone, their plain versions and a one-call library yardstick, and the
   161 one-leaf calls that the main path made before it was grouped; the
   yardstick's scatter kernel alone too.
4. Check the port against a reference on a small input: a reduced ResNet
   on the card against the same model on the CPU (forward and backward
   within a tolerance, then the GRACE exchange of identical gradients bit
   for bit: CUDA kernels against their plain versions; the Top-K exchange
   through the grouped path).
5. Train full-width ResNet-50 (batch 256, 224x224 NHWC input cast to
   bfloat16, SGD lr 1e-3) through grace_from_params for both benchmark
   configurations, the Top-K 1% chunk + residual + allgather main path (one
   grouped launch of each chunk Top-K kernel a step) and the dense none +
   allreduce anchor; count the kernels' launches.

The quantized wire path:

6. Hold the quantize, quantize-and-pack, sign-pack and decode-accumulate
   kernels against their plain versions on the card, bit for bit: the
   lengths around the kernels' hash block, every distinct ResNet-50 leaf
   size and the flat gradient; q in {1, 3, 7, 64, 127, 200}; a zero norm;
   a seed of 2^31 - 2; signs of +-0.0 and NaN in three float types; every
   wire width, K in {1, 2, 8}, sign and vote. Then the grouped sign-pack
   over all 161 ResNet-50 leaves and the edge lengths in one launch, with
   error feedback at two (beta, gamma) and pack only in three float types
   and a mix (+-0.0, NaN and +-inf planted); quantize-and-pack (every
   width) and quantize (int8 and int16) on shard views at element offsets
   0-3; decode-accumulate over five row layouts (contiguous rows off the
   16-byte grid, an extra byte a row, rows padded to 16 bytes, a base off
   the grid, rows 17 bytes apart) at K in {1, 2, 3, 8} and every mode, and
   at K=40 (the staged scales run in tiles); and the signSGD vote's decode
   of the grouped 161-leaf sign payload.
7. The ring-hop phase: two ranks' real ResNet-50 flat gradients, split into
   W in {2, 8} shards and encoded by the QSGD (q=7 and q=1) and signSGD
   kernels, decoded as the ring hop decodes them
   (``Compressor.decode_accumulate((recv, own), ...)``), bit for bit
   against the plain version and against the staged decompress + add.
   A one-card group makes no hop, so this phase is where the kernel runs.
8. Time the four kernels at the wire path's shapes, the kernel alone too:
   the grouped sign-pack over the 161 leaves with error feedback and pack
   only, beside the 161 one-leaf calls; quantize-and-pack at widths 4, 2
   and 3 and on a shard view that is not 16-byte aligned; quantize at int8,
   int16 and on that view; decode-accumulate on the W=2 ring hop (rows
   padded to 16 bytes, as the codecs stack them, and contiguous), the W=8
   hop and the grouped vote's decode.
9. Train full-width ResNet-50 under the three wire-path configurations
   (bench_all.py) and assert their kernels' launches a step (the signSGD
   vote: one grouped sign-pack and one decode a step).

The homomorphic path:

10. Hold the packed integer accumulate kernel against its plain version on
    the card, byte for byte: widths 2, 3 and 4; K in {1, 2, 3, 7} with
    levels bounded to the field; one wrap case a width; lengths around the
    byte and 3-byte boundaries, every distinct ResNet-50 leaf size and the
    flat gradient; one input that is not 4-byte aligned. Then random bytes
    (sums that leave the field) over the five row layouts of phase 6 at
    numel = every slot, one fewer and half, through the stacked entry and
    the rows entry (``packed_int_accumulate_rows``), and rows from separate
    allocations on and off the 16-byte grid, at K in {1, 2, 3, 7, 40}
    (K=40: more rows than the kernel's table, chained launches).
11. The packed hop: two ranks' real ResNet-50 flat gradients, encoded by
    homoqsgd (q=1, 4-bit fields at W in {2, 4, 7}, 3-bit at W in {2, 3})
    against their shared scale, each shard's W payloads summed as the ring
    hop (``payload_add``) and the reduce-scatter (``payload_sum``) call
    the kernel: byte for byte against the plain version and the staged
    unpack -> add -> repack, and the true integer sum of the levels; each
    call launches the kernel once and allocates only its output (the
    payloads are read in place, not stacked). Then a lattice input through
    the one-card reduce-scatter comes back exact.
12. Time the kernel at K=1 on the flat buffer, K=2 on a W=2 shard and K=7
    on a W=7 shard, on a contiguous stack and on the rows the callers pass
    (K=2 at width 3 too), and the ring hop's whole ``payload_add`` call.
13. Train full-width ResNet-50 under the homomorphic path's configurations
    (homoqsgd4_ring_bs256, the fused 4-bit homoqsgd over the reduce-
    scatter, topk1pct_rscatter_bs256) and assert their launches a step.

The MNIST convergence path and the two-shot all-reduce:

14. Hold the chunk Top-K pair against its plain versions on LeNet's 8
    leaves (10 to 16,000 elements; k=1, one column, on the three smallest,
    one with a tie): grouped in one launch (the four compress variants,
    the aggregate at W in {1, 8} x {f32, bf16}), and one-leaf over the
    flat 21,840-element buffer.
15. Train LeNet on the bundled MNIST split through the port's entry point
    (grace_tpu_torch/examples/mnist10k_lenet.py, its batches through
    data.prefetch_to_device), W=1, 40 epochs from the seeded init, in five
    configurations: Top-K 1% chunk + residual + allgather at fusion flat
    (the committed curve's) and per leaf, the dense anchor, QSGD 64 levels
    + allgather (one quantize_stochastic launch a step) and the signSGD
    majority vote through sign_allreduce (one grouped sign_pack and one
    decode_accumulate a step). Print every epoch's test accuracy; each
    final accuracy (the vote: its best epoch's) must reach the committed
    W=1 CPU run's less 1.0 pp, and every run launches its kernels once a
    step (over the run and in a profiled step).
16. Train full-width ResNet-50 under topk1pct_twoshot_bs256
    (bench_all.py), as in 5; then signSGD + residual through the two-shot
    all-reduce over the 161 ResNet-50 leaves must equal the all-gather vote
    bit for bit, every encode through the sign-pack kernel.

The hierarchical all-reduce:

17. Train full-width ResNet-50 under bench_all.py's four hier rows
    (topk1pct_hier_bs256, qsgd_hier, none_hier, homoqsgd4_hier_slice8,
    their params verbatim, batch 256) and a fifth with the quantize-and-pack
    kernel on (qsgd4_hier, the hier sibling of qsgd4_ring), one warm-up and
    three timed steps a row (to stay well inside the time limit). At W=1
    with slice_size=8 the schedule is one slice, the flat ring's. Then, on
    two steps of a real ResNet-50 flat gradient, each row's step equals its
    ring twin (the same params with "communicator": "ring") bit for bit,
    outputs and residuals; the twin runs under a key that names its final
    encode fold(W) fold(2W+1), the key hier encodes its owned shard under
    (as in the JAX package).
18. The hier schedule's boundary kernels at the shapes of a W=8 world over
    the ResNet-50 flat buffer, for S=4, K=2 and for S=2, Kr=2, R=2: the
    exact boundary sum (packed_int_accumulate over K, then R, 4-bit
    homoqsgd payloads of one S-shard, through payload_sum), the cascaded
    vote (decode_accumulate with vote over K signSGD shard payloads,
    through the schedule's _gathered_aggregate) and the boundary re-encode
    (quantize-and-pack of one shard under fold(2S)): each bit for bit
    against its plain version (the vote against the staged decode too),
    then timed. And randomk's shared indices on the card: two draws under
    one key give the same indices, two keys different ones.

The rest of the codec catalog:

19. One step of each new codec's configuration (the analysis registry's:
    PowerSGD rank 2, DGC with and without gradient clipping, EF-SignSGD,
    cyclic Top-K over the ring, natural, TernGrad, 1-bit, threshold, the
    sketch, u8bit, AdaQ, inceptionn; approx Top-K 1% per leaf) over the 161
    ResNet-50 leaves on the card against the same step on the CPU, with
    gradients whose magnitudes are distinct within a leaf and the same
    noise on both sides (drawn once, by the CPU generator): every update
    and state bit for bit where the codec sums no floats, else within the
    CPU tests' tolerance (the sketch within rtol 1e-5: the card adds its
    bin sums in a fixed order, and its two runs on the card must give the
    same bits). Then PowerSGD at rank 4 on the card: each factored leaf's
    P, and the Q that the next step orthogonalises, are orthonormal within
    1e-4.
20. Train full-width ResNet-50 (batch 256, as the other rows, 1 warm-up +
    2 timed steps) under bench_all.py's powersgd_r4, onebit, terngrad and
    topk1pct_approx rows and the registry configurations of DGC,
    EF-SignSGD, cyclic Top-K over the ring, natural, threshold, the sketch,
    u8bit, AdaQ and inceptionn, params verbatim. None launches a kernel.

The executors and the front end:

21. Train full-width ResNet-50 (batch 256, 1 warm-up + 3 timed steps)
    under four executor configurations: HEADLINE's Top-K 1% with fusion
    'grouped' (28 groups: each chunk Top-K kernel 28 times a step, two
    gathers a group), bench_all.py's topk1pct_64mib (2 buckets, one launch
    of each kernel and two gathers a bucket) and
    qsgd4_packed_bucketed_pallas_bs256 (143
    buckets of 1024 bytes over the ring: quantize-and-pack twice a
    bucket), verbatim, and HEADLINE's params with the 106 BatchNorm leaves
    routed to a dense fp16 all-reduce; assert each row's launches and the
    exchange's collectives a step. Then, on two steps of real ResNet-50
    gradients: 'grouped' equals fusion=None bit for bit (outputs and
    residuals), the bucketed none and fp16 steps on integer-valued
    gradients equal 'flat', and the routed step equals, leaf for leaf, the
    two unrouted steps it is made of.
22. Train full-width ResNet-50 under torch.optim.SGD(lr=1e-3) wrapped by
    DistributedOptimizer with HEADLINE's Top-K grace, at bucket_cap_mb=32
    and None (1 warm-up + 3 timed steps each): img/s, device ms, the chunk
    kernels' launches (one a bucket a step), the host ms from backward's
    return to the end of synchronize. Then the optimizer's synchronized
    gradients equal, bit for bit, GraceBridge over the same bucket buffers
    (seed + bi) and the same optimizer with use_pallas=False.
23. Run grace_tpu_torch/examples/torch_synthetic_benchmark.py under Top-K
    1% chunk for a few iterations: it must exit 0 and print its img/s.

The rest of the model zoo:

24. A 12-layer tiny BERT in float32 on the card (TF32 off) against the CPU:
    logits and MLM logits under a mask, and every leaf's gradient, within
    rtol 1e-4 and 1e-5 of each leaf's largest value. The chunk Top-K pair
    over BERT-base's 150 leaves (2 to 23,440,896 elements) in one launch
    of each, bit for bit against the plain versions. Then BERT-base (150
    leaves, 108,793,346 parameters; sequence 384, batch 32, bfloat16
    compute over float32 parameters, AdamW 5e-5, the span loss of
    tools/tpu_bert_bench.py) under that tool's four configurations, params
    verbatim (dense, PowerSGD rank 4, Top-K 1% chunk over the reduce-
    scatter, and routed with BERT_ROUTE), and topk1pct's params (the
    grouped chunk kernels once each a step), 1 warm-up + 3 timed steps a
    row: tokens/s, step ms, device ms and kernels in one profiled step,
    peak GB, busy share, beside the step's matmul operations.
25. Run python -m grace_tpu_torch.examples.bert_powersgd at its defaults
    (one epoch, 32 steps): it must exit 0 with finite losses and print its
    seq/s.
26. cifar10_dawn at one rank with its defaults (24 epochs, batch 512,
    synthetic 8,192 / 2,048 images), dense and Top-K 1% chunk + residual
    over the flat buffer (each chunk kernel once a step): each must reach
    0.99 test accuracy at epoch 24; every epoch's accuracy is printed.
27. The chunk Top-K pair over VGG-16's 45 leaves (fc1: 102,760,448
    elements) bit for bit, as in 24; VGG-16 with BatchNorm (45 leaves,
    138,361,768 parameters), batch 32 at 224x224, dense and topk1pct (the grouped chunk kernels once each a
    step over the 45 leaves), 1 warm-up + 3 timed steps; then
    grace_tpu_torch/examples/synthetic_benchmark.py on VGG-16 under Top-K
    1% chunk per leaf: it must exit 0 and print its img/s.

The guarded training step:

28. ResNet-50 (batch 256, SGD lr 1e-3) under topk1pct with the fp16
    escape and the telemetry ring (capacity 128, compression error on)
    through guarded_chain(fallback_after=2, fallback_steps=3) and
    make_stateful_train_step, 12 steps, a NaN planted by a tensor hook in
    one lane of fc.w's gradient at steps 4 and 5: after each bad step the
    parameters, the SGD state and every mem/comp tensor are bit for bit
    those after step 3 (both chunk kernels ran in it and wrote in place);
    steps 6-8 run the escape with no chunk launch and mem/comp untouched;
    9-11 compress again (two compress launches a step with the error's
    round-trip, one aggregate). The ring, flushed by a TelemetryReader
    through JSONL and TensorBoard sinks, holds 10 rows (fallback 1.0 on
    the escape's three, their wire_bytes the escape's), guard_report reads
    2 skips, last bad step 5, no window left, and the port's report
    (``python -m grace_tpu_torch.telemetry``, JSON and text) reads the
    JSONL back: its fallback windows are the escape's rows, its per-metric
    count the reader's 10 rows, its wire_bytes statistics those of the
    rows, and its guard log the GuardMonitor's 2 skips. Checkpoints at
    steps 3 (good) and 5 (not good):
    restore_last_good gives step 3 back bit for bit, and one update from
    it equals the same update from a copy kept in memory. A healthy
    guarded + telemetry run of 5 steps equals the unguarded topk1pct run
    bit for bit (parameters and residuals). Then topk1pct, +telemetry,
    +guard and +guard+telemetry timed (1 warm-up + 3 steps; device ms,
    kernels, busy share, host ms by stage, peak memory, launches a step),
    and each row's exchange alone from an idle card (host ms to enqueue
    it, ms until done, synchronizing calls counted).

The cross-rank watch and the consistency audit:

29. At W=1 on the card (NCCL refuses two ranks on one device; detection,
    repair and escalation across ranks are held over gloo on the CPU):
    topk1pct + telemetry + the watch ring (window 5) + the fp16 escape +
    the consensus audit through guarded_chain(fallback_after=2,
    fallback_steps=3), the audit at every step, beside the same chain
    without the audit on the same gradients, 5 steps: parameters,
    residuals, the guard's counters and the GRACE count bit for bit after
    every step; audit_report 5 audits and no repair, ConsensusMonitor and
    the reader's anomaly detectors silent, the reader's flush one
    transfer with the watch ring armed, audit_bytes the W=1 gather's 64 B
    a row, and Timeline.from_jsonl of the run's JSONL summarising it.
    ``python -m grace_tpu_torch.telemetry.watch`` over that JSONL
    (--timeline --anomalies --json): no anomaly recorded or re-derived,
    its timeline's metric rows the 5 audited steps, --write-baseline then
    --baseline on the same file exit 0, and a copy with one planted
    watch_anomaly record exits 1. fingerprint_tree of the card's state against the same tensors on the
    CPU (checksum words bit for bit, float folds within 1e-5 of each
    segment's sum of |x|); ChaosParams(rank=0, at_steps=(2,)) flips
    exactly its logged bit; masked_broadcast at W=1 is the identity; a
    ChaosCompressor run launches no chunk kernel. The audit's cost on the
    HEADLINE state and a fingerprint of BERT-base's parameters and AdamW
    moments (1.31 GB). Then topk1pct + telemetry + watch, + guard +
    consensus (audit every step) and all of them (audit every 5) timed as
    [28]'s rows, each row's exchange with the consensus hook alone from an
    idle card, synchronizing calls counted.

The adaptive compression ladder and elastic resize:

30. At W=1, ResNet-50 (batch 256): topk1pct with the fp16 escape, the
    telemetry ring and the ladder fp16 → Top-K 4% → Top-K 1% (window 5)
    for 1 + 20 steps: the ring's rung trajectory must visit every rung and
    equal a float32 host replay of adapt_advance over the errors the ring
    recorded; each chunk kernel launches 2+1 a step on rungs 1-2 and 0 on
    rung 0; the controller waits for one boundary read a window and adds
    no synchronizing call beyond it; AdaptMonitor emits one event a
    transition; both chunk kernels at the 4% rung's k equal their plain
    versions bit for bit on the run's gradients. One profiled step at each
    pinned rung, of the static twin and of its forced escape. The
    bench_all.py row adapt_homoqsgd4_ring_bs256 beside homoqsgd4_ring_bs256
    (1 warm-up + 3 timed). The ladder under guarded_chain(fallback_after=3,
    fallback_steps=8) and the audit: three NaN steps open the dense window,
    whose steps run rung 0 with no chunk launch, the rungs and
    adapt_report equal a host replay, and a healthy audited adaptive run
    equals the unaudited one bit for bit. Elastic, from the HEADLINE state
    under JAX's elastic fixture config: ElasticController.drain (timed,
    its size on disk), the re-shard onto a fresh one-rank group
    (replicated fields, the guard's counters and the parameters bit for
    bit, residuals zero, rings reset, validate_resharded), the next step
    (both chunk kernels) and the rejoin barrier (timed, no repair).

The data path:

31. The threaded native loader (grace_tpu_torch/csrc/dataloader.cpp, built
    with the host C++ compiler; no fallback) on the bundled MNIST split,
    batch 256: each epoch a permutation, the ranks of world 1 and 8
    disjoint, values equal to MemoryDataset.normalize bit for bit, the
    short final batch wrapping; make_loader takes it. prefetch_to_device
    on the card yields, over three epochs, tensors equal bit for bit to a
    blocking .to(dev) of the same batches in the same order. A 3-epoch
    LeNet chunk Top-K run through prefetch equals the same run with
    blocking copies bit for bit (accuracies and final parameters; cuDNN
    deterministic). Printed beside the card's name and power limit: the
    host ms a batch of the native and the Python loader (back to back, and
    with a step's 5 ms between pulls), and the wall ms
    a step and the profiler's busy share of a LeNet epoch with and without
    prefetch.

The 2-D mesh and the profiler's read side:

32. [5]'s HEADLINE topk1pct (same model, batch and seed) on a 1×1
    dp×fsdp mesh from parallel.make_mesh over NCCL ("fsdp_axis": "fsdp",
    make_train_step(mesh=...)): its 2 + 5 steps equal [5]'s 1-D steps,
    re-run beside it with cuDNN deterministic, bit for bit (losses,
    parameters and BatchNorm statistics, residuals), with one launch of
    each chunk kernel a step. Real ResNet-50 gradients of one step split in
    two on each leaf's last axis (HWIO's and (din, dout)'s output channels:
    JAX's P(..., "fsdp")): shard 0's leaves through the 2-D transform at
    dp=1 hold residuals of the shard shapes, and both chunk kernels equal
    their plain versions on them bit for bit. One 2-D step under
    utils.profiling.trace, exported as a Chrome trace and read by
    profiling.analyze_trace: the stage table, its device total against
    device_events' sum of the same capture (within 2%, or the line says
    why), the overlap fraction, StepTimer's p50 over the 5 timed steps,
    device_memory_watermarks against torch.cuda.max_memory_allocated and
    one ProfileRecorder flush record through a JSONLSink, each time and
    size beside the card's name and power limit. ``python -m
    grace_tpu_torch.profiling --trace`` over the capture: its stage table
    and device total exactly the in-process reading's, the overlap
    sandwich against the HEADLINE's registry entry (topk-allgather)
    holding, its own baseline exit 0 and that baseline with every stage's
    ms halved exit 1.

The static auditor (grace_tpu_torch.analysis), in processes of their own
(the script's NCCL group owns the default process group; the auditor
traces over a fake one), all started together:

33. The HEADLINE topk1pct at full ResNet-50 width traced on the card's
    route at W=8 (python -m grace_tpu_torch.analysis --model resnet50):
    one chunk_compress_feedback and one chunk_aggregate_dense node (the
    grouped launches), no host read, and the received bytes counted from
    its collectives equal to the wire model's integer. Its W=1 trace
    against one real step on the card: the kernel nodes equal
    launch_counts() (1 + 1) and the card syncs equal the calls
    torch.cuda.set_sync_debug_mode flags (0); a W=1 trace of
    phase29_consensus's audit step shows one sync, [29]'s audit its one
    flagged call. footprint_model for the HEADLINE against what a real
    init requests of the caching allocator (memory_stats'
    requested_bytes, within 512 B a state tensor of the model; its
    allocated bytes, rounded blocks, are printed beside it). The whole registry audited on both routes gives
    the same findings. The cost of the kernel wrappers' fake check (one
    isinstance a call) on a real tensor and the phase's seconds are
    printed. Every audit runs all ten passes, the registry's children the
    four AST repo rules too (--rules), each with 0 findings; the registry
    runs in three shards a route. The guarded HEADLINE train step at
    ResNet-50 width (HEADLINE + fp16 escape, the registry's guard) traced
    at W=8 as rank 0 and as rank 7 (--rank): 1 + 1 chunk kernel nodes, 0
    findings (the state passes compare each with the other end's trace).
    The first registry shard on the card's route also writes --evidence
    (LINT_LAST.json): 0 findings over its configs and the four rules.

The tuner (grace_tpu_torch.tuning), in processes of its own (the
measured one started before phase 33's audits, beside them):

34. The static funnel at ResNet-50 width (--model resnet50) for the
    targets 8 and 256,8 under the port's H100 cost model: the funnel's
    counts and the shortlists. The W=8 target's shortlist measured on the
    card at W=1 with the toy model (as the JAX package measures), the
    candidates named with --include (TUNE_INCLUDE: the kernel twin of the
    packed qsgd4 ring, and the bucketed chunk Top-K all-gather) measured
    with it: each row's measured and projected ms, the kernels it
    launched in its timed steps (ops.launch_counts() around them), the
    winner and its overlap sandwich (the capture's measured overlap
    against the static bound). Fails unless the document is ok, the
    sandwich holds and each named candidate launched its kernels. Its
    winner is recorded as ``tune-winner`` in a temporary evidence ledger
    (--ledger), which phase 35 reads.

The online re-tuner (grace_tpu_torch.resilience.retune) and the evidence
package (grace_tpu_torch.evidence):

35. The retune drill of the JAX package's ``chaos_smoke --retune`` on
    [5]'s HEADLINE at ResNet-50 width (batch 256, seed 0), W=1: the
    incumbent topk1pct with the fp16 escape, telemetry and the audit
    every 5 through guarded_chain, an IncidentRecorder and a JSONL sink on
    its records. A healthy baseline, then fleet drift
    (ChaosCompressor(drift_scale=RETUNE_DRIFT_SCALE, rank=None)) until
    retune_drift, the guard silent; propose (the static funnel in a child
    process, the toy shortlist with the incumbent and the candidate
    forced in measured over the live group); a promotion to JAX's
    candidate (PowerSGD rank 4, a rank-1 ladder: PREPARE's lint child,
    migration, footprint and good checkpoint, COMMIT's barrier) through a
    quiet probation, a promotion back to topk1pct through another, then a
    promotion sabotaged with ChaosCompressor(nan_prob=1.0), which the
    guard trips in probation and demote restores. Fails unless every
    PREPARE leaves the incumbent's state_digest unchanged, the demotion is
    bit-exact (the PREPARE-time witness), one topk1pct step after it
    equals the same step of a twin taken from the PREPARE-time state (cuDNN
    deterministic), the events come in order, the chunk kernels launch 2 +
    1 a step on topk1pct and 0 under PowerSGD, an incident is written for
    each trigger, the ledger's tune-winner and retune-drill records
    (platform gpu, the card's name and power limit) verify through
    gate_report as MEASURED (or as an unresolvable rev where the checkout
    has no .git), and the summary renders the drill's document. Each leg's
    time is printed beside the card's name and power limit. Then the same
    through the command lines: ``python -m grace_tpu_torch.evidence --json
    --ledger <the phase's ledger> --root <the checkout>`` (retune-drill
    MEASURED, or the unresolvable rev without .git), and ``python -m
    grace_tpu_torch.evidence.summary`` over a directory holding the
    LINT/PROF/WATCH documents of [29], [32] and [33], [34]'s measured tune
    and [35]'s drill renders each section.

The flagship example:

36. ``python -m grace_tpu_torch.examples.mnist_lenet --epochs 1
    --compressor topk --topk-algorithm chunk --memory residual --ckpt-dir
    <tmp>`` in a process of its own (the bundled MNIST split, batch 512):
    exit 0, each chunk kernel launched once a step (15 steps), and its
    checkpoint restored into the example's own fresh state
    (``mnist_lenet.build``) reproduces the state digest it printed.

The last front end and the drills' command line:

37. The TensorFlow front end's host callout on the card, where TensorFlow
    is not installed: ``TFExchanger(grace_from_params(topk1pct),
    device="cuda")`` fed the flat buffer of real ResNet-50 gradients
    (25,557,032 floats, 102.2 MB) through ``_host_exchange``, 1 warm-up
    and 5 timed calls. Each output equals, bit for bit, a ``GraceBridge``
    of the same Grace fed the same buffer resident on the card and the
    same Grace with ``use_pallas=False`` (the staged chunk path), the
    state carried. Each call launches each chunk kernel once (the wrappers'
    counters, and one more call under torch.profiler in a process of its
    own, ``--profile-callout``); the wall ms a call
    of the callout and of the resident bridge are printed, their difference
    the host round trip of the buffer. ``DistributedGradientTape`` raises
    ImportError naming tensorflow. It runs after [31], before [33] starts
    the first child process that shares the card.
38. ``python -m grace_tpu_torch.resilience.smoke --world 1 --device cuda``
    as four child processes started together beside [36] (whose checks
    are launches and a digest, not time) and collected after it: the
    default drill (the guard
    trips, the loss finite), ``--homo``, ``--pipeline 2`` (the
    quantize-and-pack kernel live: 5 launches a compressed step, none on
    the dense escape's steps) and ``--adapt
    --adapt-rank 0``, each at reduced steps, each writing into a temporary
    directory; each exits 0, and ``python -m
    grace_tpu_torch.evidence.summary`` renders the adapt section from the
    adapt child's document. The wall seconds of each child are printed.

Every read-side command line's wall seconds are printed on a line of their
own beside the card's name and power limit.

Output: progress lines, then a JSON line with one entry per kernel, the
card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}. Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

# The benchmark pair, verbatim (bench.py HEADLINE).
HEADLINE = [
    {"name": "none", "per_device_bs": 256,
     "params": {"compressor": "none", "memory": "none",
                "communicator": "allreduce",
                "fusion": "none"}},
    {"name": "topk1pct", "per_device_bs": 256,
     "params": {"compressor": "topk",
                "compress_ratio": 0.01,
                "topk_algorithm": "chunk",
                "memory": "residual",
                "communicator": "allgather",
                "fusion": "none"}},
]
# The quantized wire path's configurations (bench_all.py: the serial
# sibling of qsgd4_packed_ring_pipelined_bs256 with the kernel on, and
# qsgd_pallas and signsgd_vote_bs256 verbatim), and each kernel's expected
# launches a step on one card.
WIRE_PATH = [
    {"name": "qsgd4_ring", "per_device_bs": 256,
     "params": {"compressor": "qsgd", "quantum_num": 7, "use_pallas": True,
                "memory": "none", "communicator": "ring", "fusion": "flat"},
     "per_step": {"quantize_pack_stochastic": 2}},
    {"name": "qsgd_pallas", "per_device_bs": 256,
     "params": {"compressor": "qsgd", "quantum_num": 64, "use_pallas": True,
                "memory": "none", "communicator": "allgather",
                "fusion": "flat"},
     "per_step": {"quantize_stochastic": 1}},
    {"name": "signsgd_vote_bs256", "per_device_bs": 256,
     "params": {"compressor": "signsgd", "memory": "residual",
                "communicator": "sign_allreduce", "fusion": "none"},
     # One grouped sign-pack over the 161 leaves and one decode of the
     # concatenated payload a step.
     "per_step": {"sign_pack": 1, "decode_accumulate": 1}},
]
# The homomorphic path's configurations and their launches a step on one
# card: bench_all.py's homoqsgd4_ring_bs256 (int16 wire: no kernel; one
# rank: no hop) and topk1pct_rscatter_bs256 (the single-requant path: the
# staged chunk encode, no kernel) verbatim, and the homoqsgd4-ring-fused
# registry entry (grace_tpu/analysis/configs.py) with the reduce-scatter as
# its communicator, whose owned-chunk sum runs the kernel once a step.
HOMO_PATH = [
    {"name": "homoqsgd4_ring_bs256", "per_device_bs": 256,
     "params": {"compressor": "homoqsgd", "quantum_num": 7,
                "memory": "residual", "communicator": "ring",
                "fusion": "flat"},
     "per_step": {}},
    {"name": "homoqsgd4_rscatter_fused", "per_device_bs": 256,
     "params": {"compressor": "homoqsgd", "quantum_num": 1, "accum_bits": 4,
                "use_pallas": True, "memory": "residual",
                "communicator": "rscatter", "fusion": "flat"},
     "per_step": {"packed_int_accumulate": 1}},
    {"name": "topk1pct_rscatter_bs256", "per_device_bs": 256,
     "params": {"compressor": "topk", "compress_ratio": 0.01,
                "topk_algorithm": "chunk", "memory": "residual",
                "communicator": "rscatter", "fusion": "flat"},
     "per_step": {}},
]
HEADLINE[0]["per_step"] = {}
# The main path groups its 161 leaves: one launch of each kernel a step.
HEADLINE[1]["per_step"] = {"chunk_compress_feedback": 1,
                           "chunk_aggregate_dense": 1}
# The MNIST convergence path (phase 15): the port's MNIST entry point
# (grace_tpu_torch/examples/mnist10k_lenet.py) at W=1 on the card, 40 epochs
# from the seeded init, in three configurations: the committed curve's
# (Top-K 1% chunk + residual + allgather, fusion flat: one one-leaf launch of
# each chunk kernel a step), the same one exchange a leaf (one grouped launch
# over the 8 leaves a step) and the dense anchor. Each must reach the test
# accuracy of the port's own W=1 run on the CPU at epoch 40
# (grace_tpu_torch/examples/logs/mnist10k_w1cpu_*.tsv), less MNIST_FLOOR.
MNIST_PATH = [
    {"name": "lenet_topk1pct_chunk_flat",
     "argv": ["--compressor", "topk", "--topk-algorithm", "chunk",
              "--memory", "residual"],
     "cpu_log": "mnist10k_w1cpu_topk1pct_chunk.tsv",
     "per_step": {"chunk_compress_feedback": 1, "chunk_aggregate_dense": 1}},
    {"name": "lenet_topk1pct_chunk_none",
     "argv": ["--compressor", "topk", "--topk-algorithm", "chunk",
              "--memory", "residual", "--fusion", "none"],
     "cpu_log": "mnist10k_w1cpu_topk1pct_chunk_none.tsv",
     "per_step": {"chunk_compress_feedback": 1, "chunk_aggregate_dense": 1}},
    {"name": "lenet_dense",
     "argv": ["--communicator", "allreduce"],
     "cpu_log": "mnist10k_w1cpu_uncompressed.tsv",
     "per_step": {}},
    # The catalog's QSGD and signSGD-vote curves (examples/logs/
    # mnist10k_{qsgd64,signsgd_vote}.tsv), their JAX flags verbatim.
    {"name": "lenet_qsgd64",
     "argv": ["--compressor", "qsgd", "--quantum-num", "64"],
     "cpu_log": "mnist10k_w1cpu_qsgd64.tsv",
     "per_step": {"quantize_stochastic": 1}},
    # Fixed-step signSGD wanders near the optimum: held at its best epoch.
    {"name": "lenet_signsgd_vote",
     "argv": ["--compressor", "signsgd", "--communicator", "sign_allreduce",
              "--sgd-momentum", "0", "--cosine-lr", "--lr", "0.001"],
     "cpu_log": "mnist10k_w1cpu_signsgd_vote.tsv", "best_epoch": True,
     "per_step": {"sign_pack": 1, "decode_accumulate": 1}},
]
MNIST_FLOOR = 0.01                # 1.0 pp under the CPU run
MNIST_KERNELS = ("chunk_compress_feedback", "chunk_aggregate_dense",
                 "quantize_stochastic", "sign_pack", "decode_accumulate")
MNIST_LOGS = Path(__file__).resolve().parent / "grace_tpu_torch" / "examples" \
    / "logs"
# The two-shot all-reduce (phase 16): bench_all.py's topk1pct_twoshot_bs256
# verbatim. Its chunk encodes run the staged selection (compress, not the
# fused feedback path), so no kernel launches on one card.
TWOSHOT_PATH = [
    {"name": "topk1pct_twoshot_bs256", "per_device_bs": 256,
     "params": {"compressor": "topk", "compress_ratio": 0.01,
                "topk_algorithm": "chunk", "memory": "residual",
                "communicator": "twoshot", "fusion": "flat"},
     "per_step": {}},
]
# The hierarchical all-reduce (phase 17): bench_all.py's four hier rows
# verbatim, and qsgd4_hier, qsgd4_ring's params with the hier communicator.
# At W=1 no row makes a hop or a boundary exchange; only qsgd4_hier launches
# a kernel (its stage-1 and owned-shard encodes).
HIER_PATH = [
    {"name": "topk1pct_hier_bs256", "per_device_bs": 256,
     "params": {"compressor": "topk", "compress_ratio": 0.01,
                "topk_algorithm": "chunk", "memory": "residual",
                "communicator": "hier", "slice_size": 8,
                "fusion": "flat"},
     "per_step": {}},
    {"name": "qsgd_hier",
     "params": {"compressor": "qsgd", "quantum_num": 64,
                "use_pallas": False, "memory": "none",
                "communicator": "hier", "slice_size": 8, "fusion": "flat"},
     "per_step": {}},
    {"name": "none_hier",
     "params": {"compressor": "none", "memory": "none",
                "communicator": "hier", "slice_size": 8, "fusion": "flat"},
     "per_step": {}},
    {"name": "homoqsgd4_hier_slice8", "per_device_bs": 256,
     "params": {"compressor": "homoqsgd", "quantum_num": 7,
                "memory": "residual", "communicator": "hier",
                "slice_size": 8, "fusion": "flat"},
     "per_step": {}},
    {"name": "qsgd4_hier", "per_device_bs": 256,
     "params": {"compressor": "qsgd", "quantum_num": 7, "use_pallas": True,
                "memory": "none", "communicator": "hier", "slice_size": 8,
                "fusion": "flat"},
     "per_step": {"quantize_pack_stochastic": 2}},
]
HIER_WARMUP_STEPS = 1
HIER_TIMED_STEPS = 3
# Phase 20's catalog rows, host-bound (up to ~3 s a step): 1 timed step (2
# before phases 33-34 came), to keep the call near its time; each row's
# device ms comes from its profiled step.
CATALOG_TIMED_STEPS = 1
# The rest of the codec catalog (phases 19 and 20). Phase 19: one step of
# each new codec over the 161 ResNet-50 leaves on the card against the
# same step on the CPU, under the analysis registry's configuration of the
# codec (grace_tpu/analysis/configs.py, params verbatim; DGC also with
# gradient clipping; approx Top-K per leaf, since a flat buffer of several
# leaves has ties in |x|), with the tolerance of the CPU tests (None: bit
# for bit; else (rtol, atol), by what the codec sums in floats).
CATALOG_CHECKS = [
    ("powersgd-allreduce", {"compressor": "powersgd", "compress_rank": 2,
                            "memory": "powersgd",
                            "communicator": "allreduce"}, (0, 2e-5)),
    ("dgc-allgather", {"compressor": "dgc", "compress_ratio": 0.3,
                       "memory": "dgc", "communicator": "allgather"},
     (1e-5, 1e-6)),
    ("dgc-clip-allgather", {"compressor": "dgc", "compress_ratio": 0.3,
                            "memory": "dgc", "gradient_clipping": True,
                            "communicator": "allgather"}, (1e-5, 1e-6)),
    ("efsignsgd-allgather", {"compressor": "efsignsgd", "lr": 0.1,
                             "memory": "efsignsgd",
                             "communicator": "allgather"}, (1e-5, 1e-6)),
    ("cyclictopk-ring", {"compressor": "cyclictopk", "compress_ratio": 0.3,
                         "memory": "residual", "communicator": "ring",
                         "fusion": "flat"}, None),
    ("natural-allgather", {"compressor": "natural", "memory": "residual",
                           "communicator": "allgather"}, None),
    ("terngrad-allgather", {"compressor": "terngrad", "memory": "none",
                            "communicator": "allgather"}, (1e-5, 1e-6)),
    ("onebit-allgather", {"compressor": "onebit", "memory": "residual",
                          "communicator": "allgather"}, (1e-5, 1e-6)),
    ("threshold-allgather", {"compressor": "threshold", "threshold": 0.01,
                             "memory": "residual",
                             "communicator": "allgather"}, None),
    # Each bin's sum adds in one fixed order on both devices (a segmented
    # sum over the ids sorted stably), the CPU's in element order: within
    # the CPU tests' tolerance, and the same bits in two runs on the card
    # (REPEATED).
    ("sketch-allgather", {"compressor": "sketch", "quantum_num": 64,
                          "memory": "none", "communicator": "allgather"},
     (1e-5, 1e-6)),
    ("u8bit-allgather", {"compressor": "u8bit", "memory": "none",
                         "communicator": "allgather"}, None),
    ("adaq-allgather", {"compressor": "adaq", "compress_ratio": 0.3,
                        "memory": "residual", "communicator": "allgather"},
     (1e-5, 1e-6)),
    ("inceptionn-allgather", {"compressor": "inceptionn", "memory": "none",
                              "communicator": "allgather"}, None),
    ("topk1pct_approx-per-leaf", {"compressor": "topk",
                                  "compress_ratio": 0.01,
                                  "topk_algorithm": "approx",
                                  "memory": "residual",
                                  "communicator": "allgather"}, None),
]
POWERSGD_ORTHO_ATOL = 1e-4
# Phase 19 runs these configurations twice on the card: every tensor of the
# two runs must be the same bits.
REPEATED = ("sketch-allgather",)
# Phase 20: full-width ResNet-50 under bench_all.py's powersgd_r4, onebit,
# terngrad and topk1pct_approx rows and the registry configurations of the
# other new codecs, params verbatim, batch 256, 1 warm-up + 3 timed steps.
# None launches a kernel.
CATALOG_PATH = [
    {"name": "powersgd_r4", "per_device_bs": 256,
     "params": {"compressor": "powersgd", "compress_rank": 4,
                "memory": "powersgd", "communicator": "allreduce",
                "fusion": "none"}},
    {"name": "onebit", "per_device_bs": 256,
     "params": {"compressor": "onebit", "memory": "residual",
                "communicator": "allgather", "fusion": "flat"}},
    {"name": "terngrad", "per_device_bs": 256,
     "params": {"compressor": "terngrad", "memory": "none",
                "communicator": "allgather", "fusion": "flat"}},
    {"name": "topk1pct_approx", "per_device_bs": 256,
     "params": {"compressor": "topk", "compress_ratio": 0.01,
                "topk_algorithm": "approx", "memory": "residual",
                "communicator": "allgather", "fusion": "flat"}},
] + [{"name": name, "per_device_bs": 256, "params": params}
     for name, params, _ in CATALOG_CHECKS
     if name not in ("powersgd-allreduce", "onebit-allgather",
                     "terngrad-allgather", "dgc-clip-allgather",
                     "topk1pct_approx-per-leaf")]
for _cfg in CATALOG_PATH:
    _cfg["per_step"] = {}
# The executors (phase 21): bench.py HEADLINE's Top-K 1% main path with
# fusion 'grouped' (28 groups over the 161 leaves: one grouped compress, two
# gathers and one grouped aggregate a group), bench_all.py's topk1pct_64mib
# (2 buckets, each its own pipeline: one grouped launch a bucket) and
# qsgd4_packed_bucketed_pallas_bs256 (1024-byte buckets over the ring,
# verbatim), and HEADLINE's params with the 106 BatchNorm leaves routed to a
# dense fp16 all-reduce (the routing grace_tpu/helper.py's docstring gives
# for norm leaves). Launches and the exchange's collectives a step are set
# from the plans in phase 21 ("per_group", "per_bucket").
_TOPK1 = HEADLINE[1]["params"]
EXEC_PATH = [
    {"name": "topk1pct_grouped", "per_device_bs": 256,
     "params": {**_TOPK1, "fusion": "grouped"},
     "per_group": {"chunk_compress_feedback": 1, "chunk_aggregate_dense": 1,
                   "collectives": 2}},
    {"name": "topk1pct_64mib", "per_device_bs": 256,
     "params": {"compressor": "topk", "compress_ratio": 0.01,
                "topk_algorithm": "chunk", "memory": "residual",
                "communicator": "allgather", "fusion": 64 * 2**20},
     "per_bucket": {"chunk_compress_feedback": 1,
                    "chunk_aggregate_dense": 1}},
    {"name": "qsgd4_packed_bucketed_pallas_bs256", "per_device_bs": 256,
     "params": {"compressor": "qsgd", "quantum_num": 7,
                "use_pallas": True, "memory": "none",
                "communicator": "ring", "fusion": 1024},
     # Stage 1 and the owned shard's encode a bucket; the collectives are
     # those of one ring step, counted in phase 21.
     "per_bucket": {"quantize_pack_stochastic": 2}},
    {"name": "topk1pct_routed_bn_fp16", "per_device_bs": 256,
     "params": {**_TOPK1, "route": [("*bn*", {
         "compressor": "fp16", "memory": "none",
         "communicator": "allreduce"})]},
     # 55 leaves through the grouped Top-K (two gathers), 106 through one
     # all-reduce each.
     "per_step": {"chunk_compress_feedback": 1, "chunk_aggregate_dense": 1},
     "collectives_per_step": 2 + 106},
]
EXEC_GROUPS = 28          # (shape, dtype) groups of the 161 ResNet-50 leaves
EXEC_BN_LEAVES = 106
# The front end (phase 22): torch.optim.SGD(lr=1e-3) wrapped with
# HEADLINE's Top-K grace by DistributedOptimizer, at these bucket caps.
OPTIMIZER_CAPS = (32, None)
# Phase 23: the synthetic benchmark example under Top-K 1% chunk.
EXAMPLE_ARGV = ["--compressor", "topk", "--topk-algorithm", "chunk",
                "--compress-ratio", "0.01", "--memory", "residual",
                "--num-iters", "3", "--num-batches-per-iter", "5",
                "--num-warmup-batches", "3"]
EXAMPLE_TIMEOUT_S = 300
# A read-side command line's limit (each reads a file; the sandwich's child
# traces one registry entry).
CLI_TIMEOUT_S = 300
# Phase 24: BERT-base (base(num_classes=2, max_len=384)) under the four
# configurations of tools/tpu_bert_bench.py:52-80, params verbatim (its
# BERT_ROUTE too), and topk1pct's HEADLINE params; the span loss of
# tools/tpu_bert_bench.py:188-196 in bfloat16 over float32 parameters,
# AdamW 5e-5, sequence 384 and batch 32 (the BERT example's defaults).
_FP16_DENSE = {"compressor": "fp16", "memory": "none",
               "communicator": "allreduce"}
BERT_ROUTE = [("*ln*", _FP16_DENSE), ("*bias*", _FP16_DENSE),
              ("*/b", _FP16_DENSE)]
BERT_PATH = [
    {"name": "bert_dense", "params": {"compressor": "none", "memory": "none",
                                      "communicator": "allreduce",
                                      "fusion": "none"}},
    {"name": "bert_powersgd_r4", "params": {"compressor": "powersgd",
                                            "compress_rank": 4,
                                            "memory": "powersgd",
                                            "communicator": "allreduce",
                                            "fusion": "none"}},
    {"name": "bert_topk1pct_rscatter",
     "params": {"compressor": "topk", "compress_ratio": 0.01,
                "topk_algorithm": "chunk", "memory": "residual",
                "communicator": "rscatter", "fusion": "none"}},
    {"name": "bert_routed_rscatter",
     "params": {"compressor": "topk", "compress_ratio": 0.01,
                "topk_algorithm": "chunk", "memory": "residual",
                "communicator": "rscatter", "fusion": "none",
                "route": BERT_ROUTE}},
    {"name": "bert_topk1pct", "params": HEADLINE[1]["params"],
     "per_step": {"chunk_compress_feedback": 1, "chunk_aggregate_dense": 1}},
]
BERT_SEQ, BERT_BATCH, BERT_LR = 384, 32, 5e-5
BERT_SHAPE = (150, 108_793_346)           # leaves, parameters (JAX's count)
BERT_WARMUP_STEPS, BERT_TIMED_STEPS = 1, 3
# The 12-layer tiny BERT, float32 on the card against the CPU.
BERT_TINY_RTOL, BERT_TINY_ATOL = 1e-4, 1e-5     # atol: × each leaf's max
# Phase 25: the BERT example at its defaults, in a process of its own.
BERT_EXAMPLE_TIMEOUT_S = 300
# A read-side command line's limit (each reads a file; the sandwich's child
# traces one registry entry).
CLI_TIMEOUT_S = 300
# Phase 26: cifar10_dawn at one rank with its defaults (24 epochs, batch
# 512, 8,192 train and 2,048 test images), dense and Top-K 1% chunk over the
# flat buffer; the JAX 8-device synthetic curves read 100.00 from epochs 13
# and 5 (examples/logs/cifar10_dawn_24ep_{,topk1pct_}synthetic.tsv).
CIFAR_PATH = [
    {"name": "cifar10_dawn_dense", "argv": [], "per_step": {}},
    {"name": "cifar10_dawn_topk1pct", "argv": [
        "--compressor", "topk", "--topk-algorithm", "chunk", "--memory",
        "residual"],
     "per_step": {"chunk_compress_feedback": 1, "chunk_aggregate_dense": 1}},
]
CIFAR_FLOOR = 0.99                        # test accuracy at epoch 24
CIFAR_SHAPE = (25, 6_573_120)             # leaves, parameters: the flat buffer
# Phase 27: VGG-16 with BatchNorm, batch 32 at 224x224, dense and topk1pct
# (HEADLINE params), then the synthetic benchmark example on VGG-16.
VGG_PATH = [
    {"name": "vgg16_bn_dense", "params": HEADLINE[0]["params"]},
    {"name": "vgg16_bn_topk1pct", "params": HEADLINE[1]["params"],
     "per_step": {"chunk_compress_feedback": 1, "chunk_aggregate_dense": 1}},
]
for _cfg in BERT_PATH + VGG_PATH:
    _cfg.setdefault("per_step", {})
VGG_BATCH = 32
VGG_SHAPE = (45, 138_361_768)
VGG_EXAMPLE_SHAPE = (32, 138_357_544)     # the example's VGG-16, no BatchNorm
VGG_EXAMPLE_ARGV = ["--model", "vgg16", "--compressor", "topk",
                    "--topk-algorithm", "chunk", "--memory", "residual",
                    "--fusion", "none", "--num-iters", "3",
                    "--num-batches-per-iter", "5", "--num-warmup-batches", "3"]
# Phase 18: (label, S, Kr, R) of a W=8 world.
HIER_LAYOUTS = (("S=4 K=2", 4, 2, 1), ("S=2 Kr=2 R=2", 2, 2, 2))
IMAGE_HW = 224
NUM_CLASSES = 1000
WARMUP_STEPS = 2
TIMED_STEPS = 5
TIMING_RUNS = 25          # CUDA-event timings per kernel; the median is kept
PROFILER_ATTEMPTS = 6     # profiler sessions a kernel reading may take
SEED = 0

# Published H100 SXM rates (NVIDIA data sheet, at the full 700 W limit):
# device-memory bandwidth and the FP32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12                  # dense, on the tensor cores


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def same_bits(a, b) -> bool:
    """Bit-pattern equality (-0.0 differs from +0.0); two NaNs count as equal
    whatever their payload bits, which CUDA arithmetic canonicalises."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        iv = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
              torch.float16: torch.int16}[a.dtype]
        eq = (a.view(iv) == b.view(iv)) | (torch.isnan(a) & torch.isnan(b))
    else:
        eq = a == b
    return bool(eq.all())


def max_abs_err(a, b) -> float:
    import torch
    a, b = a.float(), b.float()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = (a - b).abs().masked_fill(both_nan, 0.0)
    return float(d.max()) if d.numel() else 0.0


def cuda_time_ms(fn, runs: int = TIMING_RUNS, host: bool = False):
    """Median over ``runs`` of the CUDA-event time of one call of ``fn``
    (after two warm-up calls); with ``host``, also the median host time to
    enqueue it (when that is as long, the host's launches set the time)."""
    import torch
    for _ in range(2):
        fn()
    times, host_times = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        fn()
        host_times.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if host:
        return statistics.median(times), statistics.median(host_times)
    return statistics.median(times)


EVENT_LAUNCHES = 512      # launches queued at most behind the sleep
L2_FLUSH_BYTES = 128 << 20  # read between calls: over twice the 50 MB L2


@functools.cache
def _flush_buffer():
    import torch
    return torch.ones(L2_FLUSH_BYTES // 4, device="cuda")


def flush_l2() -> None:
    """Fill the card's L2 cache with clean lines of a buffer of its own
    (a read, so nothing dirty is left to write back during the next
    kernel): the next call finds its inputs in device memory, as a caller
    whose data has left the cache would."""
    _flush_buffer().amax()


@functools.cache
def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` a millisecond on this card,
    measured once with CUDA events."""
    import torch
    cycles = 20_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def event_device_ms(fn, runs: int = TIMING_RUNS, launches_per_call: int = 1,
                    cold: bool = False):
    """A second device time of one call of ``fn``, independent of the
    profiler, from CUDA events on calls that the host queued behind a
    ``torch.cuda._sleep``, so that the device runs them with no wait for
    the host: around ``runs`` back-to-back calls, over ``runs``; with
    ``cold``, around each call, the L2 flushed before each (flush_l2), the
    mean. It holds every device operation ``fn`` enqueues (and, back to
    back, the gaps between launches). None when the host could not queue
    the calls inside the sleep (a call that synchronises, or launches that
    fill the queue)."""
    import torch
    runs = max(1, min(runs, EVENT_LAUNCHES // launches_per_call))

    def event():
        return torch.cuda.Event(enable_timing=True)

    def enqueue():
        if not cold:
            pairs = [(event(), event())]
            pairs[0][0].record()
            for _ in range(runs):
                fn()
            pairs[0][1].record()
            return pairs
        pairs = []
        for _ in range(runs):
            flush_l2()
            pairs.append((event(), event()))
            pairs[-1][0].record()
            fn()
            pairs[-1][1].record()
        return pairs

    enqueue()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enqueue()
    sleep_ms = 2 * (time.perf_counter() - t0) * 1e3 + 1.0
    torch.cuda.synchronize()
    for _ in range(3):
        torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms()))
        t0 = time.perf_counter()
        pairs = enqueue()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued_ms < sleep_ms:            # all queued before the first ran
            return sum(a.elapsed_time(b) for a, b in pairs) / runs
        sleep_ms *= 4
    return None


def cross_check(name: str, unit: str, t: dict) -> None:
    """Print, on a line of its own, a kernel-alone reading of the profiler
    that lies under the kernel's bound, or more than 25% from the event
    reading of the same calls back to back; or, with the L2 flushed, more
    than 25% over the event pairs that bracket each call (those add the
    launch of a kernel after a recorded event, a few microseconds, so they
    read more than the kernel and never less). A fault of the measurement,
    not of the kernel, so the run goes on. Neither number replaces the
    other."""
    b = t["bound_ms"]
    for how, k, e in (("warm", t["kernel_ms"], t["event_ms"]),
                      ("L2 flushed", t.get("cold_ms"), t.get("cold_event_ms"))):
        if k is None:
            continue
        faults = []
        if k < b:
            faults.append(f"under its bound of {b:.4f} ms")
        if e is None:
            faults.append("no event reading (the host could not queue the "
                          "calls ahead of the device)")
        elif how == "warm" and abs(k - e) > 0.25 * e:
            faults.append(f"{abs(k - e) / e:.0%} from the event reading")
        elif how != "warm" and k > 1.25 * e:
            faults.append(f"{k / e - 1:.0%} over the event reading")
        if faults:
            log(f"  MEASUREMENT FAULT {name} ({unit}, {how}): the profiler "
                f"read the kernel alone at {k:.4f} ms, the events at "
                f"{fmt_ms(e)} ms: {'; '.join(faults)}")


def fmt_ms(v) -> str:
    return "none" if v is None else f"{v:.4f}"


def alone(fn, kname, per_call=1) -> dict:
    """The kernel-alone readings of ``fn`` (which launches kernel ``kname``
    ``per_call`` times): the profiler's and the events', on calls back to
    back (their inputs warm in the L2 from the call before) and with the
    L2 flushed before each call."""
    return {"kernel_ms": kernel_device_ms(fn, kname,
                                          launches_per_call=per_call),
            "event_ms": event_device_ms(fn, launches_per_call=per_call),
            "cold_ms": kernel_device_ms(fn, kname, launches_per_call=per_call,
                                        cold=True),
            "cold_event_ms": event_device_ms(fn, launches_per_call=per_call,
                                             cold=True)}


def resnet50_leaves():
    """(name, numel) of the 161 ResNet-50 parameter leaves, in the GRACE
    leaf order."""
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.transform import leaf_order
    params = dict(resnet50(NUM_CLASSES, device="cpu").named_parameters())
    return [(n, params[n].numel()) for n in leaf_order(params)]


# -- phase 2 -----------------------------------------------------------------

EDGE_N, EDGE_K = 1000, 10
BIG_WORLD = 1000          # past the aggregate's 840-rank tile


def edge_columns(g, r, k):
    """Edge columns, in place: a NaN in column 7, an all -0.0 column 5 (the
    winner is -0.0 and must ship as +0.0), an all-zero column 3, and a tied
    column 1 (the first row must win)."""
    g[437] = float("nan")
    g[5::k] = -0.0
    r[5::k] = -0.0
    g[3::k] = 0.0
    r[3::k] = 0.0
    g[1::k] = 2.0
    r[1::k] = 0.0


def check_kernels(dev, leaves, errs):
    import torch
    from grace_tpu_torch.compressors import static_k
    from grace_tpu_torch.ops import chunk_topk as ck

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(n, scale=1.0):
        return torch.randn(n, generator=gen, device=dev) * scale

    def compress_case(label, g, r, k, beta=1.0, gamma=1.0, bf16=False):
        want = ck.chunk_compress_feedback_plain(g, r, k, beta, gamma, bf16)
        got = ck.chunk_compress_feedback(
            g, None if r is None else r.clone(), k, beta, gamma, bf16)
        torch.cuda.synchronize()
        for part, w, o in zip(("vals", "win", "resid"), want, got):
            if not same_bits(w, o):
                fail(f"chunk_compress_feedback {label}: {part} differs from "
                     f"the plain version (max abs err {max_abs_err(w, o)})")
            if part != "win":
                errs["chunk_compress_feedback"] = max(
                    errs["chunk_compress_feedback"], max_abs_err(w, o))
        return got

    def aggregate_case(label, vals, win, k, n):
        for average in (True, False):
            want = ck.chunk_aggregate_dense_plain(vals, win, k, n, average)
            got = ck.chunk_aggregate_dense(vals, win, k, n, average)
            torch.cuda.synchronize()
            if not same_bits(want, got):
                fail(f"chunk_aggregate_dense {label} average={average}: "
                     f"differs from the plain version (max abs err "
                     f"{max_abs_err(want, got)})")
            errs["chunk_aggregate_dense"] = max(
                errs["chunk_aggregate_dense"], max_abs_err(want, got))

    cases = 0
    sizes = sorted({n for _, n in leaves})
    for n in sizes:                               # every distinct leaf size
        k = static_k(n, 0.01)
        g, r = randn(n), randn(n, 0.1)
        compress_case(f"n={n}", g, r, k)
        compress_case(f"n={n} residual=None", g, None, k)
        compress_case(f"n={n} beta,gamma=0.9,0.5", g, r, k, 0.9, 0.5)
        compress_case(f"n={n} wire_bf16", g, r, k, bf16=True)
        cases += 4
        for world in (1, 8):                      # eight synthetic payloads
            for bf16 in (False, True):
                pays = [ck.chunk_compress_feedback_plain(
                    randn(n), None, k, wire_bf16=bf16) for _ in range(world)]
                vals = torch.stack([p[0] for p in pays])
                win = torch.stack([p[1] for p in pays])
                aggregate_case(f"n={n} W={world} bf16={bf16}", vals, win, k, n)
                cases += 2
    for n, ratio in ((1003, 0.013), (257, 0.04)):
        k = static_k(n, ratio)
        g, r = randn(n), randn(n, 0.1)
        for beta, gamma, bf16 in ((1.0, 1.0, False), (0.9, 0.5, False),
                                  (1.0, 1.0, True)):
            compress_case(f"n={n} k={k}", g, r, k, beta, gamma, bf16)
            compress_case(f"n={n} k={k} residual=None", g, None, k, beta,
                          gamma, bf16)
            cases += 2
    n, k = EDGE_N, EDGE_K
    g, r = randn(n), randn(n, 0.1)
    edge_columns(g, r, k)
    for beta, gamma, bf16 in ((1.0, 1.0, False), (0.9, 0.5, True)):
        vals, win, _ = compress_case("edge columns", g, r, k, beta, gamma,
                                     bf16)
        compress_case("edge columns residual=None", g, None, k, beta, gamma,
                      bf16)
        cases += 2
        if int(win[7]) != 0 or int(win[3]) != 0 or int(win[1]) != 0:
            fail(f"edge columns: winners {win.tolist()} (NaN, zero and tied "
                 "columns must pick row 0)")
        if vals[5].float().view(torch.int32) != 0:
            fail("edge columns: a -0.0 winner must ship as +0.0")
    pays = [ck.chunk_compress_feedback_plain(randn(n), None, k)
            for _ in range(8)]
    pays[3] = (pays[3][0], pays[0][1].clone())     # colliding rows
    vals = torch.stack([p[0] for p in pays])
    win = torch.stack([p[1] for p in pays])
    win[2, 4] = n // k + 5                         # out of range: dropped
    aggregate_case("collisions", vals, win, k, n)
    cases += 2
    return cases


def check_grouped_kernels(dev, leaves, errs):
    """Phase 2, grouped: the 161 ResNet-50 leaves at 1% and the edge-column
    leaf in one launch of each kernel, against the grouped plain versions,
    bit for bit."""
    import torch
    from grace_tpu_torch.compressors import static_k
    from grace_tpu_torch.ops import chunk_topk as ck

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)

    def randn(n, scale=1.0):
        return torch.randn(n, generator=gen, device=dev) * scale

    ns = [n for _, n in leaves] + [EDGE_N]
    ks = [static_k(n, 0.01) for _, n in leaves] + [EDGE_K]
    gs = [randn(n) for n in ns]
    rs = [randn(n, 0.1) for n in ns]
    edge_columns(gs[-1], rs[-1], EDGE_K)

    def one_launch(wrapper, label):
        if wrapper.launches != 1:
            fail(f"{wrapper.__name__} {label}: {wrapper.launches} launches "
                 f"for {len(ns)} leaves, expected one")
        wrapper.launches = 0

    def same(kname, label, want, got):
        if not same_bits(want, got):
            fail(f"{kname} grouped {label}: differs from the grouped plain "
                 f"version (max abs err {max_abs_err(want, got)})")
        if want.is_floating_point():
            errs[kname] = max(errs[kname], max_abs_err(want, got))

    cases = 0
    ck.reset_launch_counts()
    for label, feedback, beta, gamma, bf16 in (
            ("", True, 1.0, 1.0, False), ("residual=None", False, 1.0, 1.0, False),
            ("beta,gamma=0.9,0.5", True, 0.9, 0.5, False),
            ("wire_bf16", True, 1.0, 1.0, True)):
        resids = rs if feedback else [None] * len(rs)
        want = ck.chunk_compress_feedback_grouped_plain(gs, resids, ks, beta,
                                                        gamma, bf16)
        got = ck.chunk_compress_feedback_grouped(
            gs, [None if r is None else r.clone() for r in resids], ks, beta,
            gamma, bf16)
        torch.cuda.synchronize()
        one_launch(ck.chunk_compress_feedback_grouped, label)
        same("chunk_compress_feedback", f"{label} vals", want[0], got[0])
        same("chunk_compress_feedback", f"{label} indices", want[1], got[1])
        for (name, _), w, o in zip(leaves + [("edge", 0)], want[2], got[2]):
            same("chunk_compress_feedback", f"{label} residual of {name}", w,
                 o.reshape(-1))
        cases += 1
    edge = int(ck.leaf_plan(tuple(ks), tuple(ns)).koff[-2])  # its K-offset
    for world in (1, 8):
        for bf16 in (False, True):
            pays = [ck.chunk_compress_feedback_grouped_plain(
                [randn(n) for n in ns], [None] * len(ns), ks, wire_bf16=bf16)
                for _ in range(world)]
            vals = torch.stack([p[0] for p in pays])
            idx = torch.stack([p[1] for p in pays])
            idx[-1, edge:] = idx[0, edge:]          # colliding rows (W=8)
            idx[world // 2, edge + 4] = (EDGE_N // EDGE_K + 5) * EDGE_K + 4
            for average in (True, False):
                label = f"W={world} bf16={bf16} average={average}"
                want = ck.chunk_aggregate_dense_grouped_plain(vals, idx, ks, ns,
                                                              average)
                got = ck.chunk_aggregate_dense_grouped(vals, idx, ks, ns,
                                                       average)
                torch.cuda.synchronize()
                one_launch(ck.chunk_aggregate_dense_grouped, label)
                same("chunk_aggregate_dense", label, want, got)
                cases += 1
    # A world past one rank tile of the kernel's shared memory: the ranks'
    # partial sums carry from tile to tile. Rows drawn over every real row
    # of each leaf, the tail row and one past it (out of range), so that
    # many ranks collide on a row.
    big_ns = [64, 256, 2048, EDGE_N]
    big_ks = [static_k(n, 0.01) for n in big_ns[:-1]] + [EDGE_K]
    for bf16 in (False, True):
        vals = torch.randn(BIG_WORLD, sum(big_ks), generator=gen, device=dev)
        vals = vals.to(torch.bfloat16) if bf16 else vals
        idx = torch.cat([
            torch.randint(0, n // k + 2, (BIG_WORLD, k), generator=gen,
                          device=dev, dtype=torch.int32) * k
            + torch.arange(k, dtype=torch.int32, device=dev)
            for n, k in zip(big_ns, big_ks)], dim=1)
        for average in (True, False):
            label = f"W={BIG_WORLD} bf16={bf16} average={average}"
            want = ck.chunk_aggregate_dense_grouped_plain(vals, idx, big_ks,
                                                          big_ns, average)
            got = ck.chunk_aggregate_dense_grouped(vals, idx, big_ks, big_ns,
                                                   average)
            torch.cuda.synchronize()
            one_launch(ck.chunk_aggregate_dense_grouped, label)
            same("chunk_aggregate_dense", label, want, got)
            cases += 1
    return cases


# -- phase 3 -----------------------------------------------------------------

def time_kernels(dev, leaves):
    """The grouped kernels over the 161 leaves, one launch each, and beside
    them the 161 one-leaf calls a step of the path before it was grouped."""
    import torch
    from grace_tpu_torch.compressors import static_k
    from grace_tpu_torch.ops import chunk_topk as ck

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    ns = [n for _, n in leaves]
    ks = [static_k(n, 0.01) for n in ns]
    gs = [torch.randn(n, generator=gen, device=dev) for n in ns]
    rs = [torch.randn(n, generator=gen, device=dev) * 0.1 for n in ns]
    vals, idx, _ = ck.chunk_compress_feedback_grouped_plain(gs, rs, ks)
    vals, idx = vals[None], idx[None]                 # W = 1
    plan = ck.leaf_plan(tuple(ks), tuple(ns))
    wins = [idx[:, lo:lo + k] // k for lo, k in zip(plan.koff.tolist(), ks)]
    one_vals = [vals[:, lo:lo + k].contiguous()
                for lo, k in zip(plan.koff.tolist(), ks)]
    # The library yardstick: one scatter_add_ over the concatenated buffer,
    # at global indices (the leaf's N-offset plus its wire index).
    noff = torch.repeat_interleave(
        torch.tensor(plan.noff[:-1].tolist(), device=dev),
        torch.tensor(ks, device=dev))
    gidx = noff + idx[0].long()
    n_tot, k_tot = plan.n_total, plan.k_total

    def compress_grouped():               # new residuals written over rs
        ck.chunk_compress_feedback_grouped(gs, rs, ks)

    def compress_one_leaf():
        for g, r, k in zip(gs, rs, ks):
            ck.chunk_compress_feedback(g, r, k)

    def compress_plain():
        ck.chunk_compress_feedback_grouped_plain(gs, rs, ks)

    def aggregate_grouped():
        ck.chunk_aggregate_dense_grouped(vals, idx, ks, ns)

    def aggregate_one_leaf():
        for v, w, k, n in zip(one_vals, wins, ks, ns):
            ck.chunk_aggregate_dense(v, w, k, n)

    def aggregate_plain():
        ck.chunk_aggregate_dense_grouped_plain(vals, idx, ks, ns)

    def aggregate_library():              # yardstick only; the port never calls it
        torch.zeros(n_tot, device=dev).scatter_add_(0, gidx, vals[0])

    # Bytes each function must move (inputs read once, outputs written
    # once) and the fp32 operations it does, for this run's shapes.
    world = 1
    c_bytes = 12 * n_tot + 8 * k_tot      # g, r in; resid, vals, idx out
    c_ops = 5 * n_tot + k_tot             # scale+add, |.|, compare; subtract
    a_bytes = 4 * n_tot + 8 * world * k_tot
    a_ops = world * k_tot
    out = {}
    for name, grouped, one_leaf, plain, lib, nbytes, nops in (
            ("chunk_compress_feedback", compress_grouped, compress_one_leaf,
             compress_plain, None, c_bytes, c_ops),
            ("chunk_aggregate_dense", aggregate_grouped, aggregate_one_leaf,
             aggregate_plain, aggregate_library, a_bytes, a_ops)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_FLOP_PER_S * 1e3
        kernel = f"{name}_kernel"
        ms, host_ms = cuda_time_ms(grouped, host=True)
        one_ms, one_host_ms = cuda_time_ms(one_leaf, host=True)
        bound = max(bytes_ms, ops_ms)
        t = out[name] = {
            "ms": ms, "host_ms": host_ms, **alone(grouped, kernel),
            "plain_ms": cuda_time_ms(plain),
            "library_ms": cuda_time_ms(lib) if lib is not None else None,
            "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "one_leaf": {"ms": one_ms, "host_ms": one_host_ms,
                         **alone(one_leaf, kernel, len(ns)),
                         "bound_ms": bound}}
        if lib is not None:
            # The yardstick's own kernel alone (its output's zero fill is a
            # kernel of its own), beside the event time of the whole call.
            t["library_kernel"] = kernel_named(lib, "scatter")
            t["library_kernel_ms"] = kernel_device_ms(lib, t["library_kernel"])
        log(f"  {name}: grouped, one launch over {len(ns)} leaves: {ms:.4f} "
            f"ms, {host_ms:.4f} ms of it to enqueue, {log_alone(t)}, bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({nbytes / 1e6:.1f} "
            f"MB), plain {t['plain_ms']:.4f} ms, library {t['library_ms']} ms"
            + (f" (its kernel alone {t['library_kernel_ms']:.4f} ms: "
               f"{t['library_kernel'][:60]})" if lib is not None else "")
            + f"; the {len(ns)} one-leaf calls {one_ms:.4f} ms, "
            f"{one_host_ms:.4f} ms to enqueue, "
            f"{log_alone(t['one_leaf'], 'their kernels')}")
        cross_check(name, "grouped", t)
        cross_check(name, f"the {len(ns)} one-leaf calls", t["one_leaf"])
    return out


# -- phases 4 and 5 ----------------------------------------------------------

def loss_fn(model, batch):
    import torch
    import torch.nn.functional as F
    x, y = batch
    return F.cross_entropy(model(x.to(torch.bfloat16)), y)


def check_reference(dev, group):
    """Reduced ResNet, f32, 32x32, batch 2: the card against the CPU."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.models.resnet import ResNet

    cpu_group = dist.new_group(backend="gloo")
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (2,)))
    models = {}
    for d in ("cpu", dev):
        m = ResNet((1, 1, 0, 0), 10, device=d, seed=SEED)
        logits = m(x.to(d))
        loss = F.cross_entropy(logits, y.to(d))
        loss.backward()
        models[d] = (m, logits.detach().cpu(), loss.item())
    (mc, lc, loss_c), (mg, lg, loss_g) = models["cpu"], models[dev]
    # Both TF32 flags are off here: float32 convolutions and products in
    # full precision; the tolerance covers their summation order.
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-5)
    if not math.isclose(loss_g, loss_c, rel_tol=1e-5):
        fail(f"reference: loss {loss_g} on the card vs {loss_c} on the CPU")
    grads_c = {n: p.grad for n, p in mc.named_parameters()}
    for n, p in mg.named_parameters():
        torch.testing.assert_close(p.grad.cpu(), grads_c[n], rtol=1e-4,
                                   atol=1e-5)
    for n, b in mg.named_buffers():
        torch.testing.assert_close(b.cpu(), dict(mc.named_buffers())[n],
                                   rtol=1e-4, atol=1e-5)
    # The GRACE exchange of identical gradients: kernels vs plain versions,
    # for the Top-K main path (through the grouped kernels, one launch each
    # a step) and the (deterministic) signSGD vote.
    from grace_tpu_torch.ops import chunk_topk as ck
    from grace_tpu_torch.ops import quant as Q
    ck.reset_launch_counts()
    Q.reset_launch_counts()
    for params in (HEADLINE[1]["params"], WIRE_PATH[2]["params"]):
        tx_c = grace_from_params(params, group=cpu_group).transform(SEED)
        tx_g = grace_from_params(params, group=group).transform(SEED)
        st_c = tx_c.init(dict(mc.named_parameters()))
        st_g = tx_g.init(dict(mg.named_parameters()))
        for step in range(2):
            grads = {n: g * (step + 1) for n, g in grads_c.items()}
            up_c, st_c = tx_c.update(
                {n: g.clone() for n, g in grads.items()}, st_c)
            up_g, st_g = tx_g.update(
                {n: g.to(dev) for n, g in grads.items()}, st_g)
            for n in up_c:
                if not same_bits(up_g[n].cpu(), up_c[n]):
                    fail(f"reference: {params['compressor']} update of {n} "
                         f"at step {step} differs between the card and the "
                         "CPU")
            for a, b in zip(st_g.mem, st_c.mem):
                if not same_bits(a.cpu(), b):
                    fail(f"reference: {params['compressor']} residual "
                         f"differs at step {step}")
    dist.destroy_process_group(cpu_group)
    grouped = (ck.chunk_compress_feedback_grouped.launches,
               ck.chunk_aggregate_dense_grouped.launches)
    if grouped != (2, 2) or ck.chunk_compress_feedback.launches:
        fail(f"reference: the Top-K exchange made {grouped} grouped launches "
             f"and {ck.chunk_compress_feedback.launches} one-leaf ones in two "
             "steps, expected (2, 2) and 0")
    if (Q.sign_pack_grouped.launches, Q.sign_pack.launches) != (2, 0):
        fail(f"reference: the signSGD vote made {Q.sign_pack_grouped.launches}"
             f" grouped sign-pack launches and {Q.sign_pack.launches} one-leaf "
             "ones in two steps, expected 2 and 0")


def device_events(prof, averages=None) -> list:
    """The profiler's kernel rows: CUDA events, less the device ranges of
    the pipeline's named stages (``telemetry.scopes``' ``grace/...``
    spans), which would count their kernels' time twice. ``averages``:
    ``prof.key_averages()`` when the caller has it (each call walks every
    event again)."""
    from torch.autograd import DeviceType
    averages = prof.key_averages() if averages is None else averages
    return [e for e in averages
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("grace/")]


def profile_step(step, state, batch, label):
    """One more step under torch.profiler: the device time by kernel and
    its sum against the step's wall time (a busy share that counts
    overlapping kernels twice, so an upper bound), and the host ms of each
    named pipeline stage (``telemetry.scopes``' spans, nested ones
    included in their parents)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: an operator's own row repeats its kernels' time.
    averages = prof.key_averages()
    events = device_events(prof, averages)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    total_ms = sum(dev_us(e) for e in events) / 1e3
    kernels = sum(e.count for e in events)
    log(f"  {label} profiled step: wall {wall_ms:.1f} ms, {kernels} kernels, "
        f"device time {total_ms:.1f} ms (busy share <= "
        f"{total_ms / wall_ms:.2f})")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        log(f"    {dev_us(e) / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")
    stages = {e.key: e.cpu_time_total / 1e3 for e in averages
              if e.device_type == DeviceType.CPU
              and e.key.startswith("grace/")}
    top = ("grace/forward_backward", "grace/optimizer", "grace/telemetry",
           "grace/dense_escape")
    log("    host ms by stage: " + ", ".join(
        f"{k} {stages[k]:.2f}" for k in top if k in stages))
    return {"wall_ms": wall_ms, "device_ms": total_ms, "kernels": kernels,
            "stage_host_ms": stages}


def exchange_collectives() -> int:
    """Collectives the GRACE exchange issued while the port's collective
    counters were armed (``telemetry.counters``): every counted call but
    the train step's own buffer and loss averages and its audit. A batch of
    point-to-point calls counts once."""
    from grace_tpu_torch.telemetry import counters, scopes

    own = (scopes.STAGE_BUFFER_MEAN, scopes.STAGE_LOSS_MEAN,
           scopes.STAGE_CONSENSUS)
    return sum(n for (_, stage), n in
               counters.collective_counts()["calls"].items()
               if stage not in own)


def train(dev, group, cfg, x, y, warmup=WARMUP_STEPS, timed=TIMED_STEPS, *,
          model=None, loss=loss_fn, shape=(161, 25_557_032),
          optimizer=None):
    """Train ``model`` (full-width ResNet-50 by default, which must have
    ``shape``: leaves, parameters) under ``cfg`` on the batch ``(x, y)``
    with ``optimizer(parameters)`` (SGD lr 1e-3 by default): warm-up and
    timed steps, the launches and exchange collectives between them
    asserted against ``cfg``, then one profiled step. With ``cfg["guard"]``
    (``guarded_chain``'s keywords) the step runs the guarded chain, whose
    collectives are not counted; ``cfg["consensus"]`` is the train step's
    audit config."""
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.telemetry import counters
    from grace_tpu_torch.train import (init_stateful_train_state,
                                       make_stateful_train_step)

    if model is None:
        model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    n_leaves = sum(1 for _ in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    if (n_leaves, n_params) != shape:
        fail(f"{cfg['name']}: the model has {n_leaves} leaves / {n_params} "
             f"parameters, expected {shape}")
    grace = grace_from_params(cfg["params"], group=group)
    counted = cfg.get("guard") is None
    if counted:
        tx = grace.transform(seed=SEED)
    else:
        from grace_tpu_torch.resilience import guarded_chain
        tx = guarded_chain(grace, seed=SEED, **cfg["guard"])
    opt = (optimizer or (lambda ps: torch.optim.SGD(ps, lr=1e-3)))(
        model.parameters())
    state = init_stateful_train_state(model, tx, opt, group)
    step = make_stateful_train_step(loss, tx, group,
                                    consensus=cfg.get("consensus"))
    _flush_buffer.cache_clear()           # the timing phases' L2 flush buffer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()                 # just before the main path
    losses = []
    # The warm-up steps' collectives, counted by the port's counters; the
    # timed steps run with them disarmed.
    counters.arm()
    for _ in range(warmup):
        state, loss = step(state, (x, y))
        losses.append(float(loss))
    counters.disarm()
    collectives = exchange_collectives() if counted and warmup else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, loss = step(state, (x, y))
    losses.append(float(loss))                # synchronises
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()            # just after it
    profiled = profile_step(step, state, (x, y), cfg["name"])
    steps = warmup + timed
    res = {"name": cfg["name"], "img_per_s": x.shape[0] * timed / seconds,
           "step_ms": seconds / timed * 1e3, "first_loss": losses[0],
           "last_loss": losses[-1],
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": launches, "steps": steps, "profiled": profiled,
           "collectives_per_step": (None if collectives is None
                                    else collectives / warmup)}
    log(f"  {cfg['name']}: {res['img_per_s']:.1f} img/s "
        f"({res['step_ms']:.1f} ms/step), loss {res['first_loss']:.4f} -> "
        f"{res['last_loss']:.4f}, peak {res['peak_mem_gb']:.2f} GB, "
        f"launches {launches} over {steps} steps, {collectives} exchange "
        f"collectives over {warmup}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{cfg['name']}: non-finite loss {losses}")
    for name, count in launches.items():
        want = cfg["per_step"].get(name, 0) * steps
        if count != want:
            fail(f"{cfg['name']}: {name} launched {count} times over {steps} "
                 f"steps, expected {want} ({cfg['per_step'].get(name, 0)} a "
                 "step)")
    want = cfg.get("collectives_per_step")
    if want is not None and collectives is not None \
            and collectives != want * warmup:
        fail(f"{cfg['name']}: the exchange issued {collectives} collectives "
             f"over {warmup} steps, expected {want * warmup} ({want} a step)")
    return res


# -- phases 6 to 8: the quantized wire path ----------------------------------

WIRE_KERNELS = ("quantize_stochastic", "quantize_pack_stochastic",
                "sign_pack", "decode_accumulate")
LEVELS = (1, 3, 7, 64, 127, 200)          # 200: the int16 wire
HASH_EDGES = (1, 7, 8, 16383, 16384, 16385, 40000)
BIG_SEED = 2**31 - 2                      # seed + block id wraps int32
DECODE_MODES = ((1, False, False), (2, False, False), (3, False, False),
                (4, False, False), (1, True, False), (1, True, True))


def narrowest_width(q: int) -> int:
    return 2 if q <= 1 else 3 if q <= 3 else 4


def check_wire_kernels(dev, leaves, errs):
    """Phase 6: every wire-path kernel against its plain version."""
    import torch
    from grace_tpu_torch.ops import quant as Q
    from grace_tpu_torch.ops import wire as Wr

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    flat_n = sum(n for _, n in leaves)
    sizes = sorted(set(HASH_EDGES) | {n for _, n in leaves} | {flat_n})
    cases = 0

    def same(kname, label, want, got):
        nonlocal cases
        torch.cuda.synchronize()
        if not same_bits(want, got):
            fail(f"{kname} {label}: differs from the plain version (max abs "
                 f"err {max_abs_err(want, got)})")
        errs[kname] = max(errs[kname], max_abs_err(want, got))
        cases += 1

    for n in sizes:
        x = torch.randn(n, generator=gen, device=dev)
        norm = torch.linalg.vector_norm(x)
        zero = torch.zeros((), device=dev)
        runs = [(q, nrm, sd) for q in LEVELS for nrm, sd in
                ((norm, 12345 + q), (zero, 5), (norm, BIG_SEED))]
        for q, nrm, sd in runs:
            label = f"n={n} q={q} seed={sd} zero_norm={nrm is zero}"
            dt = torch.int8 if q < 128 else torch.int16
            same("quantize_stochastic", label,
                 Q.quantize_stochastic_plain(x, nrm, sd, q, dt),
                 Q.quantize_stochastic(x, nrm, sd, q, dt))
            if q <= 7:
                for w in range(narrowest_width(q), 5):
                    same("quantize_pack_stochastic", f"{label} width={w}",
                         Q.quantize_pack_stochastic_plain(x, nrm, sd, q, w),
                         Q.quantize_pack_stochastic(x, nrm, sd, q, w))
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            xs = x.to(dt)
            edge = torch.tensor([0.0, -0.0, float("nan")], dtype=dt,
                                device=dev)
            xs[:3] = edge[:min(n, 3)]
            same("sign_pack", f"n={n} {dt}", Q.sign_pack_plain(xs),
                 Q.sign_pack(xs))
        for w, sign, vote in DECODE_MODES:
            for k in (1, 2, 8):
                st = torch.randint(0, 256, (k, -(-n * w // 8)), generator=gen,
                                   device=dev, dtype=torch.uint8)
                sc = torch.rand(k, generator=gen, device=dev) * 3
                same("decode_accumulate",
                     f"n={n} width={w} K={k} sign={sign} vote={vote}",
                     Wr.decode_accumulate_plain(st, sc, n, w, sign, vote),
                     Wr.decode_accumulate(st, sc, n, w, sign, vote))
    return cases


SIGN_EDGES = (1, 7, 8, 9, 31, 32, 33, 127, 4097)     # elements
PACK_VIEW_EDGES = (1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 127, 128, 129, 16385,
                   1_000_003)                       # codes
SIGN_FEEDBACK = ((1.0, 1.0), (0.9, 0.5))             # (beta, gamma)


def plant_sign_edges(x):
    """-0.0, +0.0, NaN, +inf and -inf at the head of ``x``, in place."""
    import torch
    edge = torch.tensor([-0.0, 0.0, float("nan"), float("inf"),
                         float("-inf")], dtype=x.dtype, device=x.device)
    x[:min(x.numel(), 5)] = edge[:min(x.numel(), 5)]


def sign_leaves(dev, leaves, gen):
    """Gradients and residuals of the 161 ResNet-50 leaves (their shapes
    flattened) and the edge lengths, edge values planted in each."""
    import torch
    ns = [n for _, n in leaves] + list(SIGN_EDGES)
    gs = [torch.randn(n, generator=gen, device=dev) for n in ns]
    rs = [torch.randn(n, generator=gen, device=dev) * 0.5 for n in ns]
    for g in gs:
        plant_sign_edges(g)
    return gs, rs


def check_sign_grouped(dev, leaves, errs):
    """Phase 6, grouped sign-pack: all 161 ResNet-50 leaves and the edge
    lengths in one launch, with error feedback at two (beta, gamma) and
    without (float32, bfloat16, float16 and a mix), against the grouped
    plain version: the whole payload (every leaf's segment and its
    padding) byte for byte, and each new residual bit for bit."""
    import torch
    from grace_tpu_torch.ops import quant as Q

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    gs, rs = sign_leaves(dev, leaves, gen)
    cases = 0

    def same(label, want, got):
        nonlocal cases
        torch.cuda.synchronize()
        if Q.sign_pack_grouped.launches != 1:
            fail(f"sign_pack grouped {label}: {Q.sign_pack_grouped.launches} "
                 f"launches for {len(gs)} leaves, expected one")
        Q.sign_pack_grouped.launches = 0
        if not torch.equal(want[0], got[0]):
            fail(f"sign_pack grouped {label}: the payload differs from the "
                 "grouped plain version")
        if want[1] is not None:
            for i, (w, o) in enumerate(zip(want[1], got[1])):
                if not same_bits(w, o):
                    fail(f"sign_pack grouped {label}: residual of leaf {i} "
                         f"differs (max abs err {max_abs_err(w, o)})")
                errs["sign_pack"] = max(errs["sign_pack"], max_abs_err(w, o))
        cases += 1

    Q.reset_launch_counts()
    for beta, gamma in SIGN_FEEDBACK:
        want = Q.sign_pack_grouped_plain(gs, rs, beta, gamma)
        got = Q.sign_pack_grouped(gs, [r.clone() for r in rs], beta, gamma)
        same(f"feedback beta,gamma={beta},{gamma}", want, got)
    mixed = [g.to((torch.float32, torch.bfloat16, torch.float16)[i % 3])
             for i, g in enumerate(gs)]
    for label, xs in (("float32", gs), ("mixed dtypes", mixed),
                      ("bfloat16", [g.bfloat16() for g in gs]),
                      ("float16", [g.half() for g in gs])):
        same(f"pack only {label}", Q.sign_pack_grouped_plain(xs),
             Q.sign_pack_grouped(xs))
    return cases


def check_pack_views(dev, errs):
    """Phase 6, quantize-and-pack and quantize on ring-shard views at
    element offsets 0-3 (offsets 1-3 do not start on a 16-byte boundary)
    and lengths around the word and row boundaries, at every width and
    both level types: bit for bit."""
    import torch
    from grace_tpu_torch.ops import quant as Q

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    cases = 0
    for n in PACK_VIEW_EDGES:
        base = torch.randn(n + 3, generator=gen, device=dev)
        for off in range(4):
            x = base[off:off + n]
            norm = torch.linalg.vector_norm(x)
            for width, q in ((2, 1), (3, 3), (4, 7), (4, 1)):
                label = f"n={n} offset={off} width={width} q={q}"
                want = Q.quantize_pack_stochastic_plain(x, norm, 777 + off, q,
                                                        width)
                got = Q.quantize_pack_stochastic(x, norm, 777 + off, q, width)
                torch.cuda.synchronize()
                if not torch.equal(want, got):
                    fail(f"quantize_pack_stochastic {label}: differs from the "
                         "plain version")
                cases += 1
            for q, dt in ((64, torch.int8), (200, torch.int16)):
                label = f"n={n} offset={off} q={q} {dt}"
                want = Q.quantize_stochastic_plain(x, norm, 555 + off, q, dt)
                got = Q.quantize_stochastic(x, norm, 555 + off, q, dt)
                torch.cuda.synchronize()
                if not same_bits(want, got):
                    fail(f"quantize_stochastic {label}: differs from the "
                         "plain version")
                cases += 1
    return cases


DECODE_VIEW_EDGES = (1, 7, 127, 128, 129, 1000, 16385)      # outputs
DECODE_KS = (1, 2, 3, 8)
BIG_K = 40                  # past the decode kernel's tile of 32 scales


def decode_layouts(buf, k, nbytes):
    """``(k, nbytes)`` payload stacks over the bytes of ``buf`` in every
    row layout a caller can give decode_accumulate: contiguous (rows off
    the 16-byte grid where nbytes is not a multiple of 16), one extra byte
    a row, the padded rows of ``wire.stack_payloads``, a base off the
    16-byte grid, and rows 17 bytes apart."""
    from grace_tpu_torch.ops import wire as Wr
    padded = Wr.stack_payloads([buf[i * nbytes:(i + 1) * nbytes]
                                for i in range(k)])
    if padded.data_ptr() % 16 or padded.stride(0) % 16:
        fail(f"stack_payloads: rows at {padded.data_ptr()} + "
             f"{padded.stride(0)}*i are not on 16-byte boundaries")
    return {"contiguous": buf[:k * nbytes].view(k, nbytes),
            "extra byte": buf[:k * (nbytes + 1)].view(k, nbytes + 1),
            "padded rows": padded,
            "unaligned base": buf[1:1 + k * nbytes].view(k, nbytes),
            "stride +17": buf[:k * (nbytes + 17)].view(k, nbytes + 17)[
                :, :nbytes]}


def check_decode_layouts(dev, errs):
    """Phase 6, decode_accumulate over every row layout (decode_layouts),
    at every mode, K in {1, 2, 3, 8} and, at two lengths, K=40 (the
    staged scales run in tiles): bit for bit against the plain version."""
    import torch
    from grace_tpu_torch.ops import wire as Wr

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    cases = 0
    for n in DECODE_VIEW_EDGES:
        for w, sign, vote in DECODE_MODES:
            nbytes = -(-n * w // 8)
            for k in DECODE_KS + ((BIG_K,) if n in (129, 16385) else ()):
                buf = torch.randint(0, 256, (k * (nbytes + 17) + 1,),
                                    generator=gen, device=dev,
                                    dtype=torch.uint8)
                sc = torch.rand(k, generator=gen, device=dev) * 3
                for layout, st in decode_layouts(buf, k, nbytes).items():
                    label = (f"n={n} width={w} K={k} sign={sign} vote={vote} "
                             f"{layout}")
                    want = Wr.decode_accumulate_plain(st, sc, n, w, sign, vote)
                    got = Wr.decode_accumulate(st, sc, n, w, sign, vote)
                    torch.cuda.synchronize()
                    if not same_bits(want, got):
                        fail(f"decode_accumulate {label}: differs from the "
                             f"plain version (max abs err "
                             f"{max_abs_err(want, got)})")
                    errs["decode_accumulate"] = max(
                        errs["decode_accumulate"], max_abs_err(want, got))
                    cases += 1
    return cases


def check_vote_decode(dev, leaves, errs):
    """Phase 6, the grouped vote's decode: the signSGD codec's one K=1
    sign decode over the grouped sign-pack payload of the 161 ResNet-50
    leaves and the edge lengths (padding lanes included), and its vote
    re-sign, bit for bit against the plain version."""
    import torch
    from grace_tpu_torch.compressors import SignSGDCompressor
    from grace_tpu_torch.ops import wire as Wr

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    gs, _ = sign_leaves(dev, leaves, gen)
    codec = SignSGDCompressor(use_pallas=True)
    _, (payload,), ctx, _ = codec.fused_feedback_compress_leaves(
        gs, [None] * len(gs), None, [None] * len(gs))
    numel = payload.numel() * 8
    ones = torch.ones(1, device=dev)
    Wr.reset_launch_counts()
    got = codec.decompress_leaves((payload,), ctx)
    if Wr.decode_accumulate.launches != 1:
        fail(f"vote decode: {Wr.decode_accumulate.launches} launches for the "
             "grouped payload, expected one")
    cases = 0
    for vote, out in ((False, got), (True, Wr.decode_accumulate(
            payload[None], ones, numel, 1, sign=True, vote=True))):
        want = Wr.decode_accumulate_plain(payload[None], ones, numel, 1,
                                          sign=True, vote=vote)
        torch.cuda.synchronize()
        if not same_bits(want, out):
            fail(f"vote decode vote={vote} over {numel} lanes: differs from "
                 f"the plain version (max abs err {max_abs_err(want, out)})")
        cases += 1
    return cases, numel


def resnet50_flat_grads(dev, count=2, batch=32):
    """``count`` real ResNet-50 flat gradients (leaf order), one a batch of
    synthetic images each: the ranks' gradients of the ring-hop phase."""
    import numpy as np
    import torch
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.transform import leaf_order

    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    grads = []
    for _ in range(count):
        x = torch.from_numpy(rng.standard_normal(
            (batch, IMAGE_HW, IMAGE_HW, 3), dtype=np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, NUM_CLASSES, (batch,))).to(dev)
        model.zero_grad(set_to_none=True)
        loss_fn(model, (x, y)).backward()
        named = dict(model.named_parameters())
        grads.append(torch.cat([named[n].grad.reshape(-1)
                                for n in leaf_order(named)]))
    return grads


def check_ring_hop(dev, flat_a, flat_b, errs):
    """Phase 7: the ring hop's decode of two ranks' shards, exactly as
    RingAllreduce calls it, against the plain version and the staged
    decompress + add. Returns (cases, hop launches)."""
    import torch
    from grace_tpu_torch.compressors import QSGDCompressor, SignSGDCompressor
    from grace_tpu_torch.core import LeafKey
    from grace_tpu_torch.ops import wire as Wr

    def shards(flat, w):
        pad = -flat.numel() % w
        return torch.cat([flat, flat.new_zeros(pad)]).view(w, -1)

    cases = 0
    hops = 0
    Wr.reset_launch_counts()
    for w in (2, 8):
        ra, rb = shards(flat_a, w), shards(flat_b, w)
        m = ra.shape[1]
        for codec in (QSGDCompressor(quantum_num=7, use_pallas=True),
                      QSGDCompressor(quantum_num=1, use_pallas=True),
                      SignSGDCompressor(use_pallas=True)):
            qsgd = isinstance(codec, QSGDCompressor)
            for c in range(w):
                recv, ctx, _ = codec.compress(ra[c], None,
                                              LeafKey(SEED, 0, 0).fold(c))
                own, _, _ = codec.compress(rb[c], None,
                                           LeafKey(SEED, 1, 0).fold(c))
                got = codec.decode_accumulate((recv, own), (ctx, ctx))
                hops += 1
                stacked = torch.stack([recv[0], own[0]])
                if qsgd:
                    scales = torch.stack([codec.decode_scale(recv[1]),
                                          codec.decode_scale(own[1])])
                    plain = Wr.decode_accumulate_plain(
                        stacked, scales, m, codec.pack_width)
                else:
                    plain = Wr.decode_accumulate_plain(
                        stacked, torch.ones(2, device=dev), m, 1, sign=True)
                staged = (codec.decompress(recv, ctx)
                          + codec.decompress(own, ctx))
                torch.cuda.synchronize()
                label = f"W={w} shard {c} {codec}"
                for ref, what in ((plain, "plain version"),
                                  (staged, "staged decompress + add")):
                    if not same_bits(ref.reshape(-1), got.reshape(-1)):
                        fail(f"ring hop {label}: differs from the {what} "
                             f"(max abs err {max_abs_err(ref, got)})")
                errs["decode_accumulate"] = max(errs["decode_accumulate"],
                                                max_abs_err(plain, got))
                cases += 1
    launches = Wr.decode_accumulate.launches
    if launches != hops:
        fail(f"ring hop: {hops} hops launched decode_accumulate {launches} "
             "times")
    return cases, launches


# Operations an element (a packed byte for the packers' bytes), counted at
# the fp32 rate: the guide's table gives no int32 rate, and the bytes bound
# these kernels many times over either way.
QUANT_OPS = 20          # 11 for the hash, 9 for the level and its sign
PACK_OPS = 24           # the same plus clamp, fold, shift and or
SIGN_OPS = 3            # convert, compare, or
SIGN_FEEDBACK_OPS = 6   # two products, a sum, compare, or, the residual
DECODE_OPS = 8          # a payload: extract, sign-extend, convert, mul, add


def timed(kern, plain, nbytes, nops, kname, per_call=1, library=None):
    """Event ms and host ms of one call of ``kern``, the kernel alone, the
    plain version's ms, a library call's ms, and the bound of ``nbytes``
    bytes and ``nops`` operations."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP32_FLOP_PER_S * 1e3
    ms, host_ms = cuda_time_ms(kern, host=True)
    return {"ms": ms, "host_ms": host_ms, **alone(kern, kname, per_call),
            "plain_ms": cuda_time_ms(plain) if plain is not None else None,
            "library_ms": cuda_time_ms(library) if library else None,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "mb": nbytes / 1e6}


def log_alone(t, what: str = "the kernel") -> str:
    return (f"{what} alone {t['kernel_ms']:.4f} ms (events "
            f"{fmt_ms(t['event_ms'])}), the L2 flushed "
            f"{fmt_ms(t['cold_ms'])} ms (events {fmt_ms(t['cold_event_ms'])})")


def log_timed(name, unit, t):
    log(f"  {name}: {t['ms']:.4f} ms {unit}, {t['host_ms']:.4f} ms of it to "
        f"enqueue, {log_alone(t)}, bound {t['bound_ms']:.4f} ms by "
        f"{t['bound_by']} ({t['mb']:.2f} MB), plain "
        f"{fmt_ms(t['plain_ms'])} ms, library {t['library_ms']} ms")
    cross_check(name, unit, t)


def time_wire_kernels(dev, leaves, flat):
    """Phase 8: the four kernels at the wire path's shapes. Per launch for
    the flat-buffer kernels (the flat path calls each once or twice a
    step), per step over the 161 leaves for sign_pack (one grouped launch
    with error feedback, as signsgd_vote_bs256 makes it; beside it without
    feedback, and the 161 one-leaf calls of the per-leaf path before it was
    grouped), per hop for decode_accumulate. Quantize-and-pack also at
    widths 2 and 3 and on a shard view that does not start on a 16-byte
    boundary; quantize at int16 and on that view; decode_accumulate on the
    W=2 hop's rows as torch.stack lays them out (row 1 off the 16-byte
    grid) and as wire.stack_payloads pads them, at W=8, and at the grouped
    vote's unit (one K=1 sign decode over the 161 leaves' payload).

    Uses only wrapper calls that every slice of the port has, so that it
    also times an earlier checkout's kernels (``--times-from``)."""
    import torch
    from grace_tpu_torch.ops import quant as Q
    from grace_tpu_torch.ops import wire as Wr

    n = flat.numel()
    norm = torch.linalg.vector_norm(flat)
    gs, off = [], 0
    for _, size in leaves:                 # the 161 leaves, as the step has them
        gs.append(flat[off:off + size].clone())
        off += size
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rs = [torch.randn(g.numel(), generator=gen, device=dev) * 0.01
          for g in gs]
    shard = torch.cat([flat[:1], flat])[1:]      # element offset 1 of a buffer
    shard_norm = torch.linalg.vector_norm(shard)

    def hop_inputs(w, padded):
        """The K=2 w=4 payload stack of a hop on a W=w shard: contiguous
        (torch.stack's layout) or in rows padded to 16 bytes."""
        m = -(-n // w)
        nbytes = -(-m * 4 // 8)
        pitch = -(-nbytes // 16) * 16 if padded else nbytes
        st = torch.randint(0, 256, (2, pitch), generator=gen, device=dev,
                           dtype=torch.uint8)[:, :nbytes]
        return st, torch.rand(2, generator=gen, device=dev), m

    def packed(width):
        return -(-n * width // 8)

    def decode_timed(st, sc, m, sign=False):
        k, nbytes = st.shape
        return timed(lambda: Wr.decode_accumulate(st, sc, m, 1 if sign else 4,
                                                  sign),
                     lambda: Wr.decode_accumulate_plain(
                         st, sc, m, 1 if sign else 4, sign),
                     k * nbytes + 4 * m, k * DECODE_OPS * m,
                     "decode_accumulate_kernel")

    seg = sum(-(-g.numel() // 8) for g in gs)
    out = {
        "quantize_pack_stochastic": timed(
            lambda: Q.quantize_pack_stochastic(flat, norm, 1, 7, 4),
            lambda: Q.quantize_pack_stochastic_plain(flat, norm, 1, 7, 4),
            4 * n + packed(4), PACK_OPS * n, "quantize_pack_kernel"),
        "quantize_stochastic": timed(
            lambda: Q.quantize_stochastic(flat, norm, 1, 64),
            lambda: Q.quantize_stochastic_plain(flat, norm, 1, 64),
            5 * n, QUANT_OPS * n, "quantize_stochastic_kernel"),
        "sign_pack": timed(                  # residuals written in place
            lambda: Q.sign_pack_grouped(gs, rs),
            lambda: Q.sign_pack_grouped_plain(gs, rs),
            12 * n + seg, SIGN_FEEDBACK_OPS * n, "sign_pack_kernel"),
        "decode_accumulate": decode_timed(*hop_inputs(2, padded=True)),
    }
    units = {"quantize_pack_stochastic": "a launch, flat n, width 4",
             "quantize_stochastic": "a launch, flat n, int8 (q=64)",
             "sign_pack": "a step, 161 leaves in one launch, error feedback",
             "decode_accumulate": "a hop, K=2 w=4 at W=2, rows padded to 16 "
                                  "bytes"}
    for name, unit in units.items():
        log_timed(name, unit, out[name])
    sp, qp = out["sign_pack"], out["quantize_pack_stochastic"]
    qs, da = out["quantize_stochastic"], out["decode_accumulate"]
    sp["pack_only"] = timed(
        lambda: Q.sign_pack_grouped(gs), lambda: Q.sign_pack_grouped_plain(gs),
        4 * n + seg, SIGN_OPS * n, "sign_pack_kernel")
    log_timed("sign_pack", "a step, 161 leaves in one launch, pack only",
              sp["pack_only"])
    sp["one_leaf"] = timed(
        lambda: [Q.sign_pack(g) for g in gs],
        lambda: [Q.sign_pack_plain(g) for g in gs],
        4 * n + seg, SIGN_OPS * n, "sign_pack_kernel", per_call=len(gs))
    log_timed("sign_pack", "a step, the 161 one-leaf calls, pack only",
              sp["one_leaf"])
    for label, width, q in (("width2", 2, 1), ("width3", 3, 3)):
        qp[label] = timed(
            lambda: Q.quantize_pack_stochastic(flat, norm, 1, q, width),
            lambda: Q.quantize_pack_stochastic_plain(flat, norm, 1, q, width),
            4 * n + packed(width), PACK_OPS * n, "quantize_pack_kernel")
        log_timed("quantize_pack_stochastic", f"a launch, flat n, {label}",
                  qp[label])
    qp["unaligned"] = timed(
        lambda: Q.quantize_pack_stochastic(shard, shard_norm, 1, 7, 4),
        lambda: Q.quantize_pack_stochastic_plain(shard, shard_norm, 1, 7, 4),
        4 * n + packed(4), PACK_OPS * n, "quantize_pack_kernel")
    log_timed("quantize_pack_stochastic", "a launch, flat n at element "
              "offset 1 (not 16-byte aligned), width 4", qp["unaligned"])
    qs["int16"] = timed(
        lambda: Q.quantize_stochastic(flat, norm, 1, 200, torch.int16),
        lambda: Q.quantize_stochastic_plain(flat, norm, 1, 200, torch.int16),
        6 * n, QUANT_OPS * n, "quantize_stochastic_kernel")
    log_timed("quantize_stochastic", "a launch, flat n, int16 (q=200)",
              qs["int16"])
    qs["unaligned"] = timed(
        lambda: Q.quantize_stochastic(shard, shard_norm, 1, 64),
        lambda: Q.quantize_stochastic_plain(shard, shard_norm, 1, 64),
        5 * n, QUANT_OPS * n, "quantize_stochastic_kernel")
    log_timed("quantize_stochastic", "a launch, flat n at element offset 1 "
              "(not 16-byte aligned), int8", qs["unaligned"])
    da["contiguous"] = decode_timed(*hop_inputs(2, padded=False))
    log_timed("decode_accumulate", "a hop, K=2 w=4 at W=2, contiguous rows "
              "(row 1 off the 16-byte grid)", da["contiguous"])
    da["w8"] = decode_timed(*hop_inputs(8, padded=True))
    log_timed("decode_accumulate", "a hop, K=2 w=4 at W=8, rows padded to 16 "
              "bytes", da["w8"])
    payload, _ = Q.sign_pack_grouped(gs)
    da["vote"] = decode_timed(payload[None], torch.ones(1, device=dev),
                              payload.numel() * 8, sign=True)
    log_timed("decode_accumulate", f"a step, the grouped vote's K=1 sign "
              f"decode of {payload.numel()} bytes", da["vote"])
    return out


# -- phases 10 to 12: the homomorphic path ----------------------------------

ACCUM_KS = (1, 2, 3, 7)
ACCUM_EDGES = (1, 2, 3, 4, 5, 7, 8, 9, 10, 11, 15, 16, 17, 23, 24, 25, 31,
               32, 33, 16383, 16384, 16385)    # codes
ACCUM_LAYOUT_CODES = (1001, 4097, 16385)       # rows of 126 to 8193 bytes
ACCUM_BIG_K = 40       # past the kernel's table of 32 rows: chained launches
ACCUM_OPS = 6          # a 32-bit word a payload: two masks, add, xor, and, xor


def bounded_levels(gen, k, n, width, dev):
    """``(k, n)`` int32 levels whose K-way sums fit the ``width``-bit
    field: uniform in ``±(ceil // k)``, or where that is 0 one nonzero
    level a slot in ``±ceil`` (``ceil = 2^(width-1) - 1``)."""
    import torch
    ceil = (1 << (width - 1)) - 1
    q = ceil // k
    if q >= 1:
        return torch.randint(-q, q + 1, (k, n), generator=gen, device=dev,
                             dtype=torch.int32)
    levels = torch.zeros((k, n), dtype=torch.int32, device=dev)
    owner = torch.randint(0, k, (n,), generator=gen, device=dev)
    levels[owner, torch.arange(n, device=dev)] = torch.randint(
        -ceil, ceil + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    return levels


def pack_levels(levels, width):
    import torch
    from grace_tpu_torch.ops.packing import PACKERS
    return torch.stack([PACKERS[width][0](
        torch.remainder(lv, 1 << width).to(torch.uint8)) for lv in levels])


def check_accum_kernel(dev, leaves, errs):
    """Phase 10: packed_int_accumulate against its plain version. Returns
    (cases, of which row-layout and separate-row cases)."""
    import torch
    from grace_tpu_torch.ops import wire as Wr

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    flat_n = sum(n for _, n in leaves)
    cases = 0

    def check(label, got, want, width):
        nonlocal cases
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        if not torch.equal(got, want):
            fail(f"packed_int_accumulate {label} width={width}: differs "
                 f"from the plain version (max abs err {err})")
        errs["packed_int_accumulate"] = max(errs["packed_int_accumulate"],
                                            err)
        cases += 1

    def same(label, stacked, width, numel=None):
        slots = stacked.shape[1] * 8 // width if numel is None else numel
        check(label, Wr.packed_int_accumulate(stacked, slots, width),
              Wr.packed_int_accumulate_plain(stacked, slots, width), width)

    def same_rows(label, rows, width, numel):
        check(f"{label} (separate rows)",
              Wr.packed_int_accumulate_rows(rows, numel, width),
              Wr.packed_int_accumulate_plain(torch.stack(rows), numel, width),
              width)

    def randbytes(n):
        return torch.randint(0, 256, (n,), generator=gen, device=dev,
                             dtype=torch.uint8)

    sizes = sorted(set(ACCUM_EDGES) | {n for _, n in leaves})
    for width in (2, 3, 4):
        for n in sizes:
            for k in ACCUM_KS:
                same(f"n={n} K={k}",
                     pack_levels(bounded_levels(gen, k, n, width, dev),
                                 width), width)
        for k in (1, 2, 7):
            same(f"flat n={flat_n} K={k}",
                 pack_levels(bounded_levels(gen, k, flat_n, width, dev),
                             width), width)
        for n in (9, 1001, 16385):                # sums beyond the field
            nbytes = -(-n * width // 8)
            same(f"wrap n={n} K=7", torch.randint(
                0, 256, (7, nbytes), generator=gen, device=dev,
                dtype=torch.uint8), width)
        # Rows that do not start on 4-byte boundaries.
        buf = torch.randint(0, 256, (1 + 3 * 4000,), generator=gen,
                            device=dev, dtype=torch.uint8)
        same("unaligned K=3", buf[1:].view(3, 4000), width)
    base = cases
    for width in (2, 3, 4):
        for n in ACCUM_LAYOUT_CODES:
            nbytes = -(-n * width // 8)
            slots = nbytes * 8 // width
            for k in ACCUM_KS + (ACCUM_BIG_K,):
                # Random bytes: the sums leave the field (the wraps).
                buf = randbytes(k * (nbytes + 17) + 1)
                for layout, st in decode_layouts(buf, k, nbytes).items():
                    for numel in (slots, slots - 1, slots // 2):
                        label = f"n={n} K={k} numel={numel} {layout}"
                        same(label, st, width, numel)
                        same_rows(label, list(st), width, numel)
                # Rows from separate allocations, on the 16-byte grid and
                # each at its own offset off it.
                for label, rows in (
                        ("allocations", [randbytes(nbytes) for _ in range(k)]),
                        ("allocations off the grid",
                         [randbytes(nbytes + 16)[1 + i % 15:][:nbytes]
                          for i in range(k)])):
                    same_rows(f"n={n} K={k} {label}", rows, width, slots)
    return cases, cases - base


def check_packed_hop(dev, flat_a, flat_b, errs):
    """Phase 11: the packed hop of homoqsgd over two ranks' gradients, as
    RingAllreduce (payload_add) and ReduceScatterAllreduce (payload_sum)
    call it. Returns (cases, launches)."""
    import dataclasses
    import torch
    from grace_tpu_torch.comm import ReduceScatterAllreduce
    from grace_tpu_torch.compressors import HomoQSGDCompressor
    from grace_tpu_torch.core import LeafKey
    from grace_tpu_torch.memories import ResidualMemory
    from grace_tpu_torch.ops import wire as Wr

    def shards(flat, w):
        pad = -flat.numel() % w
        return torch.cat([flat, flat.new_zeros(pad)]).view(w, -1)

    def allocations():
        return torch.cuda.memory_stats(dev)["allocation.all.allocated"]

    def no_copy(call, what):
        """``call`` launches the kernel once and allocates its output and
        nothing else: the payloads are read where they lie, not stacked."""
        launches, allocated = Wr.packed_int_accumulate.launches, allocations()
        out = call()
        launches = Wr.packed_int_accumulate.launches - launches
        allocated = allocations() - allocated
        if launches != 1 or allocated != 1:
            fail(f"packed hop: {what} launched the kernel {launches} times "
                 f"and made {allocated} allocations (one launch, one output "
                 "and no stacking copy expected)")
        return out

    cases = 0
    calls = 0
    Wr.reset_launch_counts()
    # The negotiated scale of a group holding both gradients.
    scale = torch.maximum(flat_a.abs().max(), flat_b.abs().max()).float()
    for bits, worlds in ((4, (2, 4, 7)), (3, (2, 3))):
        codec = HomoQSGDCompressor(quantum_num=1, accum_bits=bits,
                                   use_pallas=True)
        staged = dataclasses.replace(codec, use_pallas=False)
        for w in worlds:
            grads = (shards(flat_a, w), shards(flat_b, w))
            m = grads[0].shape[1]
            for c in range(w):
                pays = [codec.compress(grads[r % 2][c], None,
                                       LeafKey(SEED, r, 0).fold(c),
                                       shared=scale)[0][0]
                        for r in range(w)]
                stacked = torch.stack(pays)
                (summed,) = no_copy(lambda: codec.payload_sum((stacked,)),
                                    "payload_sum")
                ring = pays[0]
                for p in pays[1:]:
                    (ring,) = no_copy(lambda: codec.payload_add((ring,), (p,)),
                                      "payload_add")
                calls += w
                slots = stacked.shape[1] * 8 // bits
                plain = Wr.packed_int_accumulate_plain(stacked, slots, bits)
                (want,) = staged.payload_sum((stacked,))
                levels = sum(codec._unpack_levels(p, m) for p in pays)
                torch.cuda.synchronize()
                label = f"{bits}-bit W={w} shard {c}"
                for got, what in ((summed, "payload_sum"),
                                  (ring, "the ring's payload_add chain")):
                    for ref, name in ((plain, "plain version"),
                                      (want, "staged unpack-add-repack")):
                        if not torch.equal(got, ref):
                            fail(f"packed hop {label}: {what} differs from "
                                 f"the {name}")
                if not torch.equal(codec._unpack_levels(summed, m), levels):
                    fail(f"packed hop {label}: the packed sum is not the "
                         "integer sum of the levels")
                cases += 1
    launches = Wr.packed_int_accumulate.launches
    if launches != calls:
        fail(f"packed hop: {calls} accumulates launched the kernel "
             f"{launches} times")
    # End to end on one card: a lattice input is encoded without loss, and
    # the one-rank reduce-scatter's sum and mean give it back exactly.
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randint(-1, 2, (100_003,), generator=gen, device=dev).float()
    x[0] = 1.0
    mem = ResidualMemory()
    codec = HomoQSGDCompressor(quantum_num=1, accum_bits=4, use_pallas=True)
    out, resid, _ = ReduceScatterAllreduce().step(
        x, mem.init_state(x), None, mem, codec, LeafKey(SEED, 0, 0))
    torch.cuda.synchronize()
    if not same_bits(out, x) or bool(resid.abs().max() != 0):
        fail("packed hop: the one-card reduce-scatter of a lattice input "
             "does not return it exactly")
    if Wr.packed_int_accumulate.launches != launches + 1:
        fail("packed hop: the reduce-scatter did not launch the kernel once")
    return cases, launches


def time_accum_kernel(dev, flat):
    """Phase 12: packed_int_accumulate at its shapes on the 4-bit wire of
    the flat buffer: K=1 (the one-card reduce-scatter), K=2 on a W=2 shard
    (a ring hop) and K=7 on a W=7 shard, each on a contiguous stack (rows
    nbytes apart, off the 16-byte grid at K=2 and 7) and on the rows the
    callers pass (payload_add: two separate payloads; payload_sum: the
    rows of the all-to-all's stack); K=2 on the 3-bit wire too; and the
    ring hop's whole payload_add call on a W=2 shard.

    Uses only calls that every slice of the port has, so that it also
    times an earlier checkout's kernels (``--times-from``): where the rows
    entry is missing, the rows go as that checkout's callers passed them
    (payload_add stacked its two payloads, payload_sum passed its stack)."""
    import torch
    from grace_tpu_torch.compressors import HomoQSGDCompressor
    from grace_tpu_torch.ops import wire as Wr

    rows_entry = getattr(Wr, "packed_int_accumulate_rows", None)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    n = flat.numel()
    out = {}
    for label, k, width in (("K=1", 1, 4), ("K=2", 2, 4), ("K=7", 7, 4),
                            ("K=2 width 3", 2, 3)):
        m = -(-n // k)                             # the shard's codes
        nbytes = -(-m * width // 8)
        st = torch.randint(0, 256, (k, nbytes), generator=gen, device=dev,
                           dtype=torch.uint8)
        if k == 2:       # a ring hop: the received payload and this rank's
            rows = [st[i].clone() for i in range(k)]
            stack_of_rows = None
        else:            # the reduce-scatter: the all-to-all's stack
            rows = list(st.unbind(0))
            stack_of_rows = st
        slots = nbytes * 8 // width
        nbytes_moved = (k + 1) * nbytes
        bytes_ms = nbytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ACCUM_OPS * k * (nbytes // 4) / FP32_FLOP_PER_S * 1e3

        def on_stack(st=st, slots=slots, width=width):
            Wr.packed_int_accumulate(st, slots, width)

        def on_rows(rows=rows, stack_of_rows=stack_of_rows, slots=slots,
                    width=width):
            if rows_entry is not None:
                rows_entry(rows, slots, width)
            else:
                Wr.packed_int_accumulate(
                    torch.stack(rows) if stack_of_rows is None
                    else stack_of_rows, slots, width)

        for spelling, fn in (("stack", on_stack), ("rows", on_rows)):
            ms, host_ms = cuda_time_ms(fn, host=True)
            t = {"ms": ms, "host_ms": host_ms,
                 **alone(fn, "packed_int_accumulate_kernel"),
                 "plain_ms": cuda_time_ms(
                     lambda: Wr.packed_int_accumulate_plain(st, slots,
                                                            width)),
                 "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "mb": nbytes_moved / 1e6}
            if spelling == "stack":
                out[label] = t
            else:
                out[label]["rows"] = t
            unit = (f"{label}, {nbytes} bytes a payload, " + (
                "a contiguous stack" if spelling == "stack" else
                "two separate payloads" if k == 2 else
                "the rows of the all-to-all's stack"))
            log_timed("packed_int_accumulate", unit, t)
        if label == "K=2":
            codec = HomoQSGDCompressor(quantum_num=1, accum_bits=4,
                                       use_pallas=True)
            a, b = (rows[0],), (rows[1],)

            def hop(codec=codec, a=a, b=b):
                codec.payload_add(a, b)

            ms, host_ms = cuda_time_ms(hop, host=True)
            t = out[label]["payload_add"] = {
                "ms": ms, "host_ms": host_ms, "event_ms": event_device_ms(hop),
                "cold_event_ms": event_device_ms(hop, cold=True)}
            log(f"  homoqsgd payload_add, the ring hop on a W=2 shard "
                f"({nbytes} bytes a payload): {ms:.4f} ms a call, "
                f"{host_ms:.4f} ms of it to enqueue, its device work "
                f"{fmt_ms(t['event_ms'])} ms (events over back-to-back "
                f"calls), the L2 flushed {fmt_ms(t['cold_event_ms'])} ms")
    return out


# -- phases 14 to 16: the MNIST convergence path and the two-shot all-reduce --

def lenet_leaves():
    """(name, numel) of LeNet's 8 parameter leaves, in the GRACE leaf
    order: 10, 250, 20, 5000, 50, 16000, 10 and 500 elements."""
    from grace_tpu_torch.models.lenet import LeNet
    from grace_tpu_torch.transform import leaf_order
    params = dict(LeNet(device="cpu").named_parameters())
    return [(n, params[n].numel()) for n in leaf_order(params)]


def check_lenet_kernels(dev, errs):
    """Phase 14: the chunk Top-K pair on LeNet's leaves at 1% (k = 1 on the
    10-, 20- and 50-element leaves: one column), grouped over the 8 leaves
    in one launch of each kernel (the four compress variants; the
    aggregate at W in {1, 8} x {f32, bf16} x average), and one-leaf over
    the flat 21,840-element buffer (``fusion='flat'``), bit for bit against
    the plain versions."""
    import torch
    from grace_tpu_torch.compressors import static_k
    from grace_tpu_torch.ops import chunk_topk as ck

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)

    def randn(n, scale=1.0):
        return torch.randn(n, generator=gen, device=dev) * scale

    def same(kname, label, want, got):
        if not same_bits(want, got):
            fail(f"[14] {kname} {label}: differs from the plain version "
                 f"(max abs err {max_abs_err(want, got)})")
        if want.is_floating_point():
            errs[kname] = max(errs[kname], max_abs_err(want, got))

    leaves = lenet_leaves()
    ns = [n for _, n in leaves]
    ks = [static_k(n, 0.01) for n in ns]
    gs = [randn(n) for n in ns]
    rs = [randn(n, 0.1) for n in ns]
    # The first leaf is one column of 10 rows (k=1): a tie at rows 2 and 7,
    # which row 2 must win, and a zero.
    gs[0].mul_(0.1)
    gs[0][2] = gs[0][7] = 1.5
    rs[0][2] = rs[0][7] = rs[0][3] = gs[0][3] = 0.0
    cases = 0
    ck.reset_launch_counts()
    variants = (("", True, 1.0, 1.0, False),
                ("residual=None", False, 1.0, 1.0, False),
                ("beta,gamma=0.9,0.5", True, 0.9, 0.5, False),
                ("wire_bf16", True, 1.0, 1.0, True))
    for label, feedback, beta, gamma, bf16 in variants:
        resids = rs if feedback else [None] * len(rs)
        want = ck.chunk_compress_feedback_grouped_plain(gs, resids, ks, beta,
                                                        gamma, bf16)
        got = ck.chunk_compress_feedback_grouped(
            gs, [None if r is None else r.clone() for r in resids], ks, beta,
            gamma, bf16)
        torch.cuda.synchronize()
        same("chunk_compress_feedback", f"grouped {label} vals", want[0],
             got[0])
        same("chunk_compress_feedback", f"grouped {label} indices", want[1],
             got[1])
        if int(got[1][0]) != 2:
            fail(f"[14] grouped {label}: the tied one-column leaf picked row "
                 f"{int(got[1][0])}, expected the first, row 2")
        for (name, _), w, o in zip(leaves, want[2], got[2]):
            same("chunk_compress_feedback", f"grouped {label} residual of "
                 f"{name}", w, o.reshape(-1))
        cases += 1
    for world in (1, 8):
        for bf16 in (False, True):
            pays = [ck.chunk_compress_feedback_grouped_plain(
                [randn(n) for n in ns], [None] * len(ns), ks, wire_bf16=bf16)
                for _ in range(world)]
            vals = torch.stack([p[0] for p in pays])
            idx = torch.stack([p[1] for p in pays])
            idx[-1] = idx[0]                     # colliding rows (W=8)
            for average in (True, False):
                want = ck.chunk_aggregate_dense_grouped_plain(
                    vals, idx, ks, ns, average)
                got = ck.chunk_aggregate_dense_grouped(vals, idx, ks, ns,
                                                       average)
                torch.cuda.synchronize()
                same("chunk_aggregate_dense", f"grouped W={world} "
                     f"bf16={bf16} average={average}", want, got)
                cases += 1
    n = sum(ns)
    k = static_k(n, 0.01)
    g, r = torch.cat(gs), torch.cat(rs)
    for label, feedback, beta, gamma, bf16 in variants:
        resid = r if feedback else None
        want = ck.chunk_compress_feedback_plain(g, resid, k, beta, gamma, bf16)
        got = ck.chunk_compress_feedback(g, None if resid is None
                                         else resid.clone(), k, beta, gamma,
                                         bf16)
        torch.cuda.synchronize()
        for part, w, o in zip(("vals", "win", "resid"), want, got):
            same("chunk_compress_feedback", f"flat n={n} {label} {part}", w,
                 o)
        cases += 1
    for world in (1, 8):
        pays = [ck.chunk_compress_feedback_plain(randn(n), None, k)
                for _ in range(world)]
        vals = torch.stack([p[0] for p in pays])
        win = torch.stack([p[1] for p in pays])
        for average in (True, False):
            want = ck.chunk_aggregate_dense_plain(vals, win, k, n, average)
            got = ck.chunk_aggregate_dense(vals, win, k, n, average)
            torch.cuda.synchronize()
            same("chunk_aggregate_dense", f"flat n={n} W={world} "
                 f"average={average}", want, got)
            cases += 1
    counts = ck.launch_counts()
    want_counts = {"chunk_compress_feedback": 2 * len(variants),
                   "chunk_aggregate_dense": 12}
    if counts != want_counts:
        fail(f"[14] launches {counts}, expected {want_counts} (one a call)")
    return cases, leaves


def profiled_kernel_launches(fn, words, want, what="step") -> dict:
    """Launches of the kernels whose names hold each of ``words`` in one
    more call of ``fn`` (one ``what``) under torch.profiler (the
    profiler's own count). A session that records no kernels, or fewer
    launches of a word than ``want`` gives it (the launches the wrappers
    count a call), is a fault of the profiler: a short session first, as at
    the start of a process, then after a growing pause the call is profiled
    again, up to PROFILER_ATTEMPTS times (as kernel_device_ms does); the
    last session's counts are returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    warm_profiler()
    for attempt in range(PROFILER_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        counts = {w: sum(e.count for e in events if w in e.key)
                  for w in words}
        if events and all(counts[w] >= want.get(w, 0) for w in words):
            break
        log(f"  (the profiler recorded {len(events)} kernels and {counts} "
            f"in one {what}; profiling another {what})")
        warm_profiler.__wrapped__()
        time.sleep(0.1 * (attempt + 1))
    return counts


def curve_accs(tsv: Path) -> list:
    """Every row's test accuracy of a committed MNIST curve."""
    rows = [line.split("\t") for line in tsv.read_text().splitlines()
            if line and not line.startswith(("#", "epoch"))]
    return [float(r[2]) for r in rows]


def train_mnist(dev, group, cfg):
    """Phase 15: one configuration through the MNIST entry point on the
    card, from the seeded init, every epoch evaluated; the kernels'
    launches over the run and in one profiled step. The floor is the
    committed W=1 CPU run's final accuracy less MNIST_FLOOR."""
    import torch
    from grace_tpu_torch import ops
    from grace_tpu_torch.examples import mnist10k_lenet as ex

    args = ex.build_parser().parse_args(cfg["argv"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()                 # just before the run
    res = ex.train(args, group, dev, log=lambda *a: None)
    torch.cuda.synchronize()
    launches = ops.launch_counts()            # just after it
    profiled = profiled_kernel_launches(
        lambda: res["step"](res["state"], res["batch"]), MNIST_KERNELS,
        cfg["per_step"])
    # The vote is held at its best epoch (on both sides), the rest at the
    # final one.
    pick = max if cfg.get("best_epoch") else (lambda a: a[-1])
    which = "best" if cfg.get("best_epoch") else "final"
    cpu_acc = pick(curve_accs(MNIST_LOGS / cfg["cpu_log"]))
    floor = cpu_acc - MNIST_FLOOR
    accs = res["accs"]
    log(f"  {cfg['name']}: test accuracy by epoch "
        f"{' '.join(f'{a:.4f}' for a in accs)}")
    log(f"  {cfg['name']}: {which} {pick(accs):.4f} (final {accs[-1]:.4f}) "
        f"after {res['steps']} steps in {res['seconds']:.1f} s "
        f"({res['seconds'] / res['steps'] * 1e3:.2f} ms a step, evaluation "
        f"included); floor {floor:.4f} (the port's W=1 CPU run: "
        f"{cpu_acc:.4f}, less {MNIST_FLOOR * 100:.1f} pp); launches "
        f"{launches}; in one profiled step {profiled}")
    if len(accs) != args.epochs or not all(math.isfinite(a) for a in accs):
        fail(f"[15] {cfg['name']}: accuracies {accs}")
    if pick(accs) < floor:
        fail(f"[15] {cfg['name']}: {which} test accuracy {pick(accs):.4f} "
             f"under its floor {floor:.4f}")
    for name, count in launches.items():
        want = cfg["per_step"].get(name, 0) * res["steps"]
        if count != want:
            fail(f"[15] {cfg['name']}: {name} launched {count} times over "
                 f"{res['steps']} steps, expected {want}")
    for name, count in profiled.items():
        if count != cfg["per_step"].get(name, 0):
            fail(f"[15] {cfg['name']}: {count} launches of {name} in the "
                 f"profiled step, expected {cfg['per_step'].get(name, 0)}")
    return {"name": cfg["name"], "accs": accs, "final_acc": accs[-1],
            "held": which, "floor": floor, "cpu_acc": cpu_acc,
            "steps": res["steps"],
            "seconds": res["seconds"], "launches": launches,
            "profiled_step_launches": profiled}


def check_twoshot_vote(dev, group, leaves):
    """Phase 16, second part: signSGD + residual through two-shot equals the
    all-gather vote bit for bit over the 161 ResNet-50 leaves (outputs and
    residuals, two steps; ±0.0 and NaN planted), with every leaf's two
    encodes (stage 1 and stage 2) through the sign-pack kernel."""
    import torch
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.ops import quant as Q

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    grads = {name: torch.randn(n, generator=gen, device=dev)
             for name, n in leaves}
    first = grads[leaves[0][0]]
    first[:4] = torch.tensor([0.0, -0.0, float("nan"), -1.0], device=dev)
    outs, launches = {}, None
    for comm in ("twoshot", "allgather"):
        tx = grace_from_params({"compressor": "signsgd", "memory": "residual",
                                "communicator": comm, "fusion": "none"},
                               group=group).transform(SEED)
        state = tx.init(grads)
        torch.cuda.synchronize()
        Q.reset_launch_counts()
        ups = []
        for step in range(2):
            up, state = tx.update({n: g * (step + 1) for n, g in
                                   grads.items()}, state)
            ups.append(up)
        torch.cuda.synchronize()
        if comm == "twoshot":
            launches = Q.launch_counts()["sign_pack"]
        outs[comm] = (ups, state.mem)
    (ups_t, mem_t), (ups_g, mem_g) = outs["twoshot"], outs["allgather"]
    for step in range(2):
        for n in ups_t[step]:
            if not same_bits(ups_t[step][n], ups_g[step][n]):
                fail(f"[16] two-shot signSGD update of {n} at step {step} "
                     "differs from the all-gather vote")
    for a, b in zip(mem_t, mem_g):
        if not same_bits(a, b):
            fail("[16] two-shot signSGD residual differs from the all-gather "
                 "vote's")
    want = 2 * 2 * len(leaves)            # two steps, two encodes a leaf
    if launches != want:
        fail(f"[16] two-shot signSGD launched sign_pack {launches} times, "
             f"expected {want}")
    return launches


# -- phases 17 and 18: the hierarchical all-reduce ----------------------------

def _refold_key(seed: int, count: int, world: int):
    """``LeafKey(seed, count, 0)`` whose top-level ``fold(world)`` is
    ``fold(2·world + 1)``: the ring's owned-shard encode then draws under
    the key the hier schedule (in both packages) draws it under at one
    slice, and the two steps must agree bit for bit."""
    import dataclasses
    from grace_tpu_torch.core import LeafKey

    @dataclasses.dataclass(frozen=True)
    class RefoldKey(LeafKey):
        def fold(self, i):
            if not self.folds and int(i) == world:
                i = 2 * world + 1
            return super().fold(i)

    return RefoldKey(seed, count, 0)


def check_hier_collapse(dev, group, flat):
    """Phase 17, second part: each HIER_PATH row's step on a real ResNet-50
    flat gradient equals its ring twin bit for bit, outputs and residuals,
    two steps (the twin under _refold_key)."""
    import torch
    import torch.distributed as dist
    from grace_tpu_torch import comm, grace_from_params
    from grace_tpu_torch.core import LeafKey

    world = dist.get_world_size(group)
    for cfg in HIER_PATH:
        hier = grace_from_params(cfg["params"], group=group)
        ring = grace_from_params({**cfg["params"], "communicator": "ring"},
                                 group=group)
        if not isinstance(hier.communicator, comm.HierarchicalAllreduce):
            fail(f"[17] {cfg['name']} built {hier.communicator}")
        mem_h = hier.memory.init_state(flat)
        mem_r = ring.memory.init_state(flat)
        for step in range(2):
            g = flat * (step + 1)
            out_h, mem_h, _ = hier.communicator.step(
                g.clone(), mem_h, None, hier.memory, hier.compressor,
                LeafKey(SEED, step, 0))
            out_r, mem_r, _ = ring.communicator.step(
                g.clone(), mem_r, None, ring.memory, ring.compressor,
                _refold_key(SEED, step, world))
            torch.cuda.synchronize()
            if not same_bits(out_h, out_r):
                fail(f"[17] {cfg['name']}: step {step}'s output differs from "
                     f"the ring twin's (max abs err "
                     f"{max_abs_err(out_h, out_r)})")
            if mem_h is not None and not same_bits(mem_h, mem_r):
                fail(f"[17] {cfg['name']}: step {step}'s residual differs "
                     "from the ring twin's")
            if not bool(torch.isfinite(out_h).all()):
                fail(f"[17] {cfg['name']}: non-finite output")


def check_hier_boundaries(dev, flat_a, flat_b, errs):
    """Phase 18: the boundary kernels of the hier schedule at the shapes of
    a W=8 world over the ResNet-50 flat buffer (HIER_LAYOUTS), each bit for
    bit against its plain version and then timed; randomk's shared indices
    on the card. Returns ({layout: {kernel: times}}, cases)."""
    import torch
    from grace_tpu_torch import comm
    from grace_tpu_torch.compressors import (HomoQSGDCompressor,
                                             QSGDCompressor,
                                             RandomKCompressor,
                                             SignSGDCompressor)
    from grace_tpu_torch.core import LeafKey
    from grace_tpu_torch.ops import quant as Q
    from grace_tpu_torch.ops import wire as Wr

    def shards(flat, s):
        pad = -flat.numel() % s
        return torch.cat([flat, flat.new_zeros(pad)]).view(s, -1)

    homo = HomoQSGDCompressor(quantum_num=1, accum_bits=4, use_pallas=True)
    sign = SignSGDCompressor(use_pallas=True)
    qsgd = QSGDCompressor(quantum_num=7, use_pallas=True)
    scale = torch.maximum(flat_a.abs().max(), flat_b.abs().max()).float()
    out, cases = {}, 0
    for label, s, kr, r in HIER_LAYOUTS:
        grads = (shards(flat_a, s), shards(flat_b, s))
        m = grads[0].shape[1]
        c = s - 1                       # the last shard, padded
        times = out[label] = {}
        # The exact boundary sum: Kr gathered 4-bit payloads of shard c,
        # then (three levels) the R region sums.
        regions = []
        for rho in range(r):
            pays = torch.stack([
                homo.compress(grads[(rho + j) % 2][c], None,
                              LeafKey(SEED, rho * kr + j, 0).fold(c),
                              shared=scale)[0][0] for j in range(kr)])
            regions.append(pays)
        stacks = regions + ([torch.stack([homo.payload_sum((p,))[0]
                                          for p in regions])]
                            if r > 1 else [])
        for st in stacks:
            slots = st.shape[1] * 8 // 4
            Wr.reset_launch_counts()
            (got,) = homo.payload_sum((st,))
            launched = Wr.packed_int_accumulate.launches
            plain = Wr.packed_int_accumulate_plain(st, slots, 4)
            torch.cuda.synchronize()
            if launched != 1 or not torch.equal(got, plain):
                fail(f"[18] {label}: the boundary payload_sum launched "
                     f"{launched} kernels or differs from the plain version")
            cases += 1
        st = stacks[-1]
        nb = st.shape[1]
        times["packed_int_accumulate"] = timed(
            lambda: homo.payload_sum((st,)),
            lambda: Wr.packed_int_accumulate_plain(st, nb * 2, 4),
            (st.shape[0] + 1) * nb, ACCUM_OPS * st.shape[0] * (nb // 4),
            "packed_int_accumulate_kernel")
        log_timed("packed_int_accumulate", f"{label}: the boundary sum of "
                  f"{st.shape[0]} payloads of {nb} bytes",
                  times["packed_int_accumulate"])
        # The cascaded vote over Kr signSGD shard payloads.
        pays = torch.stack([sign.compress(grads[j % 2][c] * (j + 1), None,
                                          LeafKey(SEED, j, 0))[0][0]
                            for j in range(kr)])
        ctx = (m, (m,), torch.float32)
        Wr.reset_launch_counts()
        got = comm._gathered_aggregate(sign, sign, (pays,), ctx, kr)
        launched = Wr.decode_accumulate.launches
        ones = torch.ones(kr, device=dev)
        plain = sign.aggregate(Wr.decode_accumulate_plain(
            pays, ones, m, 1, sign=True)[None])
        staged = sign.aggregate(torch.stack([
            sign.decompress((pays[j],), ctx) for j in range(kr)]))
        torch.cuda.synchronize()
        for ref, what in ((plain, "plain version"), (staged, "staged vote")):
            if launched != 1 or not same_bits(got, ref):
                fail(f"[18] {label}: the cascaded vote launched {launched} "
                     f"kernels or differs from the {what}")
        errs["decode_accumulate"] = max(errs["decode_accumulate"],
                                        max_abs_err(plain, got))
        cases += 1
        nb = pays.shape[1]
        times["decode_accumulate"] = timed(
            lambda: Wr.decode_accumulate(pays, ones, m, 1, True),
            lambda: Wr.decode_accumulate_plain(pays, ones, m, 1, True),
            kr * nb + 4 * m, kr * DECODE_OPS * m, "decode_accumulate_kernel")
        log_timed("decode_accumulate", f"{label}: the cascaded vote over "
                  f"{kr} payloads of {nb} bytes", times["decode_accumulate"])
        # The boundary re-encode of one shard partial under fold(2S).
        partial = grads[0][c] + grads[1][c]
        key = LeafKey(SEED, 0, 0).fold(2 * s)
        norm = torch.linalg.vector_norm(partial)
        Q.reset_launch_counts()
        (got, _), _, _ = qsgd.compress(partial, None, key)
        launched = Q.quantize_pack_stochastic.launches
        plain = Q.quantize_pack_stochastic_plain(partial, norm,
                                                 key.seed_int32(), 7, 4)
        torch.cuda.synchronize()
        if launched != 1 or not torch.equal(got, plain):
            fail(f"[18] {label}: the boundary re-encode launched {launched} "
                 "kernels or differs from the plain version")
        cases += 1
        seed = key.seed_int32()
        times["quantize_pack_stochastic"] = timed(
            lambda: Q.quantize_pack_stochastic(partial, norm, seed, 7, 4),
            lambda: Q.quantize_pack_stochastic_plain(partial, norm, seed, 7,
                                                     4),
            4 * m + -(-m * 4 // 8), PACK_OPS * m, "quantize_pack_kernel")
        log_timed("quantize_pack_stochastic", f"{label}: the boundary "
                  f"re-encode of a {m}-element shard",
                  times["quantize_pack_stochastic"])
    # randomk's contract on the card: one key, one index set, on any rank.
    rk = RandomKCompressor(compress_ratio=0.01)
    m = grads[0].shape[1]
    key = LeafKey(SEED, 3, 5).fold(1)
    a = rk._indices(key, m, dev)
    b = rk._indices(LeafKey(SEED, 3, 5).fold(1), m, dev)
    other = rk._indices(LeafKey(SEED, 3, 6).fold(1), m, dev)
    if a.device.type != "cuda" or not torch.equal(a, b) \
            or torch.equal(a, other) or a.unique().numel() != a.numel():
        fail("[18] randomk: equal keys drew different indices, or two keys "
             "the same ones")
    cases += 1
    return out, cases


# -- phases 19 and 20: the rest of the codec catalog -------------------------

def tie_free_leaves():
    """CPU float32 gradients of the 161 ResNet-50 leaves (leaf order) whose
    magnitudes are distinct within a leaf: ``±(p + 1)·2^-20`` for a
    permutation ``p`` (up to 2.25), so that every Top-K selection is the
    same on the card and on the CPU."""
    import numpy as np
    import torch
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.transform import leaf_order

    params = dict(resnet50(NUM_CLASSES, device="cpu").named_parameters())
    rng = np.random.default_rng(SEED + 19)
    out = {}
    for n in leaf_order(params):
        shape = tuple(params[n].shape)
        size = params[n].numel()
        mag = (rng.permutation(size) + 1).astype(np.float32) \
            * np.float32(2.0 ** -20)
        sign = np.where(rng.random(size) < 0.5, -1.0, 1.0).astype(np.float32)
        out[n] = torch.from_numpy((mag * sign).reshape(shape))
    return out


def _cpu_noise_key():
    """A ``LeafKey`` whose draws are made by the CPU generator and moved to
    the device asked for: the card and the CPU draw the same noise."""
    import dataclasses
    from grace_tpu_torch.core import LeafKey

    @dataclasses.dataclass(frozen=True)
    class CpuNoiseKey(LeafKey):
        def uniform(self, shape, device):
            return super().uniform(shape, "cpu").to(device)

        def randint(self, shape, low, high, device):
            return super().randint(shape, low, high, "cpu").to(device)

        def normal(self, shape, device):
            return super().normal(shape, "cpu").to(device)

        def permutation(self, n, device):
            return super().permutation(n, "cpu").to(device)

    return CpuNoiseKey


def _state_tensors(prefix, entries):
    out = {}
    for i, e in enumerate(entries):
        if isinstance(e, dict):
            out.update({f"{prefix}{i}.{k}": v for k, v in e.items()})
        elif e is not None:
            out[f"{prefix}{i}"] = e
    return out


def check_catalog_steps(dev, group):
    """Phase 19: one step of each CATALOG_CHECKS configuration over the
    161 ResNet-50 leaves on the card against the same step on the CPU
    (a gloo group), the same noise on both sides: every update and every
    memory and compressor state within the row's tolerance. Then PowerSGD
    at rank 4 on the card: each factored leaf's P, and the Q that the next
    step orthogonalises, orthonormal within POWERSGD_ORTHO_ATOL. Returns
    {name: (max abs err, seconds)}."""
    import torch
    import torch.distributed as dist
    import grace_tpu_torch.transform as T
    from grace_tpu_torch import compressors as C
    from grace_tpu_torch import grace_from_params

    grads = tie_free_leaves()
    cpu_group = dist.new_group(backend="gloo")
    patched, T.LeafKey = T.LeafKey, _cpu_noise_key()
    results = {}
    try:
        for name, params, tol in CATALOG_CHECKS:
            t0 = time.perf_counter()
            runs = {}
            sides = [("cpu", cpu_group), (dev, group)]
            if name in REPEATED:
                sides.append(("again", group))
            for d, grp in sides:
                d_ = dev if d == "again" else d
                tx = grace_from_params(params, group=grp).transform(SEED)
                g = {n: t.to(d_) for n, t in grads.items()}
                state = tx.init(g)
                upd, state = tx.update({n: t.clone() for n, t in g.items()},
                                       state)
                runs[d] = {**{f"update {n}": u for n, u in upd.items()},
                           **_state_tensors("mem ", state.mem),
                           **_state_tensors("comp ", state.comp)}
            torch.cuda.synchronize()
            if name in REPEATED:
                again = runs.pop("again")
                for key, got in runs[dev].items():
                    if not same_bits(got, again[key]):
                        fail(f"[19] {name}: {key} differs between two runs "
                             f"on the card (max abs err "
                             f"{max_abs_err(got, again[key])})")
            if sorted(runs["cpu"]) != sorted(runs[dev]):
                fail(f"[19] {name}: the card's and the CPU's states differ "
                     "in structure")
            worst = 0.0
            for key, want in runs["cpu"].items():
                got = runs[dev][key].cpu()
                if not bool(torch.isfinite(got).all()):
                    fail(f"[19] {name}: non-finite {key} on the card")
                err = max_abs_err(got, want)
                worst = max(worst, err)
                if tol is None:
                    ok = same_bits(got, want)
                else:
                    ok = bool(torch.isclose(got, want, rtol=tol[0],
                                            atol=tol[1]).all())
                if not ok:
                    fail(f"[19] {name}: {key} differs between the card and "
                         f"the CPU (max abs err {err}, tolerance "
                         f"{'bit for bit' if tol is None else tol})")
            results[name] = (worst, time.perf_counter() - t0)
            log(f"    {name}: {len(runs['cpu'])} tensors "
                f"{'bit for bit' if tol is None else f'within {tol}'}, max "
                f"abs err {worst:.3g}, {results[name][1]:.1f} s"
                + ("; two runs on the card the same bits"
                   if name in REPEATED else ""))
    finally:
        T.LeafKey = patched
        dist.destroy_process_group(cpu_group)
    codec = C.PowerSGDCompressor(rank=4, group=group)
    key = _cpu_noise_key()(SEED, 0, 0)
    checked, worst = 0, 0.0
    for n, g in grads.items():
        if g.dim() <= 1:
            continue
        g = g.to(dev)
        _, (p, _, _), state = codec.compress(g, codec.init_state(g), key)
        q = torch.linalg.qr(state[:, :p.shape[1]])[0]
        for f in (p, q):
            eye = torch.eye(f.shape[1], device=dev)
            worst = max(worst, float((f.T @ f - eye).abs().max()))
        checked += 1
    if worst > POWERSGD_ORTHO_ATOL:
        fail(f"[19] PowerSGD rank 4: P or Q off orthonormal by {worst}")
    results["powersgd_orthonormal"] = (worst, checked)
    return results


# -- phases 21 to 23: the executors and the front end ------------------------

def resnet50_plan():
    """ResNet-50's (shape, dtype) leaves in leaf order, and its names."""
    import torch
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.transform import leaf_order
    params = dict(resnet50(NUM_CLASSES, device="cpu").named_parameters())
    names = leaf_order(params)
    return names, [(tuple(params[n].shape), torch.float32) for n in names]


def exec_path(dev, group):
    """EXEC_PATH with each row's launches and exchange collectives a step
    set from its plan: 28 groups, the buckets of 1024 bytes (the ring
    step's collectives counted on one small buffer), 106 routed leaves."""
    import torch
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.core import LeafKey
    from grace_tpu_torch.telemetry import counters
    from grace_tpu_torch.transform import _bucketize, _group_views

    names, specs = resnet50_plan()
    groups = len(_group_views(specs))
    if groups != EXEC_GROUPS:
        fail(f"[21] ResNet-50's leaves form {groups} groups, not "
             f"{EXEC_GROUPS}")
    if sum("bn" in n for n in names) != EXEC_BN_LEAVES:
        fail("[21] the BatchNorm route does not take 106 leaves")
    rows = []
    for cfg in EXEC_PATH:
        cfg = dict(cfg)
        if "per_group" in cfg:
            per = dict(cfg.pop("per_group"))
            cfg["collectives_per_step"] = per.pop("collectives") * groups
            cfg["per_step"] = {k: v * groups for k, v in per.items()}
            cfg["plan"] = f"{groups} groups"
        elif "per_bucket" in cfg:
            per = dict(cfg.pop("per_bucket"))
            buckets = len(_bucketize(specs, cfg["params"]["fusion"])[0])
            grace = grace_from_params({**cfg["params"], "fusion": "flat"},
                                      group=group)
            flat = torch.ones(1000, device=dev)
            counters.arm()
            grace.communicator.step(
                flat, grace.memory.init_state(flat),
                grace.compressor.init_state(flat), grace.memory,
                grace.compressor, LeafKey(SEED, 0, 0))
            counters.disarm()
            cfg["collectives_per_step"] = exchange_collectives() * buckets
            cfg["per_step"] = {k: v * buckets for k, v in per.items()}
            cfg["plan"] = f"{buckets} buckets"
        else:
            cfg["plan"] = f"{EXEC_BN_LEAVES} routed leaves"
        rows.append(cfg)
    return rows


def resnet50_leaf_grads(dev, count=2, batch=32):
    """``count`` real ResNet-50 gradients (name → tensor), one a batch of
    synthetic images each."""
    import numpy as np
    import torch
    from grace_tpu_torch.models.resnet import resnet50

    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    rng = np.random.default_rng(SEED + 21)
    grads = []
    for _ in range(count):
        x = torch.from_numpy(rng.standard_normal(
            (batch, IMAGE_HW, IMAGE_HW, 3), dtype=np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, NUM_CLASSES, (batch,))).to(dev)
        model.zero_grad(set_to_none=True)
        loss_fn(model, (x, y)).backward()
        grads.append({n: p.grad.detach().clone()
                      for n, p in model.named_parameters()})
    return grads


def _two_steps(params, group, grads):
    """Two steps of ``params``' transform over ``grads``: each step's
    updates and the final state."""
    from grace_tpu_torch import grace_from_params
    tx = grace_from_params(params, group=group).transform(seed=SEED)
    state = tx.init(grads[0])
    outs = []
    for g in grads:
        upd, state = tx.update({n: t.clone() for n, t in g.items()}, state)
        outs.append(upd)
    return outs, state


def _check_leaves(label, got, want):
    for n, w in want.items():
        if not same_bits(got[n], w):
            fail(f"[21] {label}: leaf {n} differs (max abs err "
                 f"{max_abs_err(got[n], w)})")


def check_executors(dev, group):
    """Phase 21, second part, on two steps of real ResNet-50 gradients:
    'grouped' equals fusion=None bit for bit (outputs and residuals); the
    bucketed none and fp16 steps on integer-valued gradients equal 'flat';
    the routed step equals, leaf for leaf, the two unrouted steps it is
    made of. Returns the number of tensors compared."""
    import torch
    from grace_tpu_torch.transform import _group_views, leaf_order

    grads = resnet50_leaf_grads(dev)
    names = leaf_order(grads[0])
    compared = 0
    # grouped against per leaf
    g_outs, g_state = _two_steps({**_TOPK1, "fusion": "grouped"}, group,
                                 grads)
    n_outs, n_state = _two_steps(_TOPK1, group, grads)
    torch.cuda.synchronize()
    for s in range(2):
        _check_leaves(f"grouped step {s}", g_outs[s], n_outs[s])
        compared += len(names)
    groups = _group_views([grads[0][n] for n in names])
    for gi, idxs in enumerate(groups):
        for j, i in enumerate(idxs):
            if not same_bits(g_state.mem[gi][j], n_state.mem[i]):
                fail(f"[21] grouped: the residual of {names[i]} differs "
                     "from the per-leaf one")
            compared += 1
    # bucketed against flat, on integer-valued gradients (exact in fp16)
    ints = [{n: torch.round(t / t.abs().max().clamp_min(1e-30) * 1000)
             for n, t in g.items()} for g in grads]
    for codec in ("none", "fp16"):
        base = {"compressor": codec, "memory": "none",
                "communicator": "allreduce"}
        flat, _ = _two_steps({**base, "fusion": "flat"}, group, ints)
        for fusion in (64 * 2**20, 1024):
            outs, state = _two_steps({**base, "fusion": fusion}, group, ints)
            for s in range(2):
                _check_leaves(f"{codec} bucketed at {fusion} B step {s}",
                              outs[s], flat[s])
                compared += len(names)
    # routed against its two unrouted steps
    r_outs, r_state = _two_steps(EXEC_PATH[3]["params"], group, grads)
    d_outs, d_state = _two_steps(EXEC_PATH[3]["params"]["route"][0][1],
                                 group, grads)
    for s in range(2):
        for n in names:
            ref = d_outs if "bn" in n else n_outs
            _check_leaves(f"routed step {s}", {n: r_outs[s][n]},
                          {n: ref[s][n]})
            compared += 1
    for i, n in enumerate(names):
        want = d_state.mem[i] if "bn" in n else n_state.mem[i]
        if (want is None) != (r_state.mem[i] is None) or (
                want is not None and not same_bits(r_state.mem[i], want)):
            fail(f"[21] routed: the state of {n} differs")
        compared += 1
    return compared


def train_optimizer(dev, group, cap, x, y, warmup=HIER_WARMUP_STEPS,
                    timed=HIER_TIMED_STEPS):
    """Phase 22: full-width ResNet-50 under torch.optim.SGD(lr=1e-3)
    wrapped by DistributedOptimizer with HEADLINE's Top-K grace at
    ``bucket_cap_mb=cap``: img/s, the chunk kernels' launches, the buckets,
    the host ms from backward's return to the end of ``synchronize``, and
    one profiled step."""
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.interop.torch import DistributedOptimizer
    from grace_tpu_torch.models.resnet import resnet50

    label = f"optimizer_topk1pct_cap{cap}"
    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    opt = DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=1e-3),
        grace_from_params(_TOPK1, group=group),
        named_parameters=model.named_parameters(), group=group, seed=SEED,
        bucket_cap_mb=cap)
    sync_ms = []

    def step(_state, batch):
        opt.zero_grad()
        loss = loss_fn(model, batch)
        loss.backward()
        t = time.perf_counter()
        opt.synchronize()
        sync_ms.append((time.perf_counter() - t) * 1e3)
        with opt.skip_synchronize():
            opt.step()
        return None, loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()                 # just before the main path
    losses = []
    for _ in range(warmup):
        losses.append(float(step(None, (x, y))[1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        _, loss = step(None, (x, y))
    losses.append(float(loss))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()            # just after it
    steps = warmup + timed
    buckets = len(opt._buckets)
    profiled = profile_step(step, None, (x, y), label)
    res = {"name": label, "img_per_s": x.shape[0] * timed / seconds,
           "step_ms": seconds / timed * 1e3, "first_loss": losses[0],
           "last_loss": losses[-1], "buckets": buckets,
           "sync_host_ms": statistics.median(sync_ms[warmup:steps]),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": launches, "steps": steps, "profiled": profiled}
    log(f"  {label}: {buckets} buckets, {res['img_per_s']:.1f} img/s "
        f"({res['step_ms']:.1f} ms/step), loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, backward's return to synchronize's end "
        f"{res['sync_host_ms']:.2f} host ms (median of {timed}), peak "
        f"{res['peak_mem_gb']:.2f} GB, launches {launches} over {steps} "
        "steps")
    if not all(math.isfinite(v) for v in losses):
        fail(f"[22] {label}: non-finite loss {losses}")
    for name in ("chunk_compress_feedback", "chunk_aggregate_dense"):
        if launches.get(name) != buckets * steps:
            fail(f"[22] {label}: {name} launched {launches.get(name)} times "
                 f"over {steps} steps, expected {buckets * steps} (one a "
                 "bucket a step)")
    return res


def check_optimizer(dev, group):
    """Phase 22, second part: the optimizer's synchronized gradients, two
    steps of real ResNet-50 gradients at bucket_cap_mb=32, equal bit for
    bit GraceBridge over the same bucket buffers seeded seed + bi, and the
    same optimizer with use_pallas=False (the staged chunk path). Returns
    the bucket count."""
    import torch
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.interop import GraceBridge
    from grace_tpu_torch.interop.torch import DistributedOptimizer
    from grace_tpu_torch.models.resnet import resnet50

    grads = resnet50_leaf_grads(dev)
    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    named = dict(model.named_parameters())
    name_of = {id(p): n for n, p in named.items()}

    def synchronized(params):
        opt = DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=1e-3),
            grace_from_params(params, group=group),
            named_parameters=model.named_parameters(), group=group,
            seed=SEED, bucket_cap_mb=OPTIMIZER_CAPS[0])
        outs = []
        for g in grads:
            for n, p in named.items():
                p.grad = g[n].clone()
            opt.synchronize()
            outs.append({n: p.grad.clone() for n, p in named.items()})
        for h in opt._hook_handles:
            h.remove()
        return opt, outs

    opt, kernel = synchronized(_TOPK1)
    _, staged = synchronized({**_TOPK1, "use_pallas": False})
    grace = grace_from_params(_TOPK1, group=group)
    bridges = [GraceBridge(grace, n=sum(p.numel() for p in b), group=group,
                           seed=SEED + bi, device=dev)
               for bi, b in enumerate(opt._buckets)]
    for s, g in enumerate(grads):
        for bi, (bucket, bridge) in enumerate(zip(opt._buckets, bridges)):
            names = [name_of[id(p)] for p in bucket]
            want = bridge.exchange(torch.cat([g[n].reshape(-1)
                                              for n in names]))
            got = torch.cat([kernel[s][n].reshape(-1) for n in names])
            if not same_bits(got, want):
                fail(f"[22] step {s} bucket {bi}: the optimizer's gradients "
                     f"differ from GraceBridge's (max abs err "
                     f"{max_abs_err(got, want)})")
        for n in named:
            if not same_bits(kernel[s][n], staged[s][n]):
                fail(f"[22] step {s}: {n} differs between the kernels and "
                     "the staged chunk path")
    torch.cuda.synchronize()
    return len(opt._buckets)


def run_example(module, argv, prefix, timeout, phase) -> str:
    """Runs ``python -m grace_tpu_torch.examples.<module> <argv>`` in a
    process of its own on the card; the last stdout line that starts with
    ``prefix`` (a tuple: each prefix's last line, in order). Phases 23,
    25, 27 and 36."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", f"grace_tpu_torch.examples.{module}"] + argv
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=timeout,
                         env={**os.environ, "PYTHONPATH": str(root)})
    for line in out.stdout.splitlines():
        log(f"    {line}")
    if out.returncode != 0:
        fail(f"{phase} {module} exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    found = []
    for p in (prefix if isinstance(prefix, tuple) else (prefix,)):
        lines = [l for l in out.stdout.splitlines() if l.startswith(p)]
        if not lines:
            fail(f"{phase} {module} printed no {p!r} line")
        found.append(lines[-1])
    return tuple(found) if isinstance(prefix, tuple) else found[0]


def read_side_cli(phase: str, module: str, *args: str, expect: int = 0,
                  smi: str = "", seconds: dict = None) -> str:
    """``python -m <module> <args>`` in a process of its own, from the
    checkout: its stdout. Fails unless it exits ``expect``. Its wall
    seconds are logged beside the card and added to ``seconds`` under the
    command (paths shortened to their file names)."""
    root = Path(__file__).resolve().parent
    label = " ".join([module] + [os.path.basename(a) if os.sep in a
                                 else a or "''" for a in args])
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                         capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S,
                         env={**os.environ, "PYTHONPATH": str(root)})
    wall = time.perf_counter() - t0
    log(f"{phase} python -m {label}: exit {out.returncode} in {wall:.2f} s "
        f"| {smi or nvidia_smi_line()}")
    if out.returncode != expect:
        fail(f"{phase} python -m {label} exited {out.returncode}, expected "
             f"{expect}: {out.stderr[-2000:]}")
    if seconds is not None:
        seconds[label] = wall
    return out.stdout


def rate(line: str) -> float:
    """The number after the colon of an example's rate line."""
    return float(line.split(":")[1].split(";")[0].split()[0])


# -- phases 24 to 27: BERT-base, its example, DAWNBench, VGG-16 --------------

def check_bert_tiny(dev):
    """A 12-layer tiny BERT in float32 on the card (TF32 off) against the
    same model on the CPU: classification and MLM logits under a mask, and
    every leaf's gradient of a loss over both heads."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from grace_tpu_torch.models import transformer as T

    cfg = T.tiny(num_layers=12, num_classes=3)
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
    mask = torch.from_numpy(rng.random((4, 32)) < 0.8)
    y = torch.from_numpy(rng.integers(0, 3, (4,)))
    r = torch.from_numpy(rng.standard_normal(
        (4, 32, cfg.vocab_size)).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        model = T.Transformer(cfg, device=d, seed=SEED)
        logits = model(ids.to(d), mask.to(d))
        mlm = model.mlm_logits(ids.to(d), mask.to(d))
        loss = F.cross_entropy(logits, y.to(d)) + (mlm * r.to(d)).mean()
        loss.backward()
        out[str(d)] = {"logits": logits.detach().cpu(),
                       "mlm": mlm.detach().cpu(),
                       **{n: q.grad.cpu() for n, q in model.named_parameters()}}
    want, got = out["cpu"], out[str(dev)]
    worst = 0.0
    for name, w in want.items():
        atol = BERT_TINY_ATOL * float(w.abs().max())
        torch.testing.assert_close(got[name], w, rtol=BERT_TINY_RTOL,
                                   atol=atol, msg=lambda m: f"[24] tiny "
                                   f"BERT {name}: {m}")
        worst = max(worst, float(((got[name] - w).abs()
                                  / (atol + BERT_TINY_RTOL * w.abs())).max()))
    return len(want) - 2, worst


def model_leaves(model):
    """(name, numel) of a model's leaves in the GRACE leaf order."""
    from grace_tpu_torch.transform import leaf_order
    params = dict(model.named_parameters())
    return [(n, params[n].numel()) for n in leaf_order(params)]


def check_model_kernels(dev, leaves, errs, label):
    """The chunk Top-K pair at a model's shapes, as topk1pct runs it: every
    leaf at 1% in one grouped launch of the compress (residual feedback)
    and of the aggregate (W=1, averaged), bit for bit against the grouped
    plain versions."""
    import torch
    from grace_tpu_torch.compressors import static_k
    from grace_tpu_torch.ops import chunk_topk as ck

    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    ns = [n for _, n in leaves]
    ks = [static_k(n, 0.01) for n in ns]
    gs = [torch.randn(n, generator=gen, device=dev) for n in ns]
    rs = [torch.randn(n, generator=gen, device=dev) * 0.1 for n in ns]
    want = ck.chunk_compress_feedback_grouped_plain(gs, rs, ks)
    ck.reset_launch_counts()
    got = ck.chunk_compress_feedback_grouped(gs, [r.clone() for r in rs], ks)
    agg_want = ck.chunk_aggregate_dense_grouped_plain(
        want[0][None], want[1][None], ks, ns, True)
    agg = ck.chunk_aggregate_dense_grouped(want[0][None], want[1][None], ks,
                                           ns, True)
    torch.cuda.synchronize()
    counts = (ck.chunk_compress_feedback_grouped.launches,
              ck.chunk_aggregate_dense_grouped.launches)
    ck.reset_launch_counts()
    if counts != (1, 1):
        fail(f"{label}: {counts} launches over {len(ns)} leaves, expected "
             "one of each kernel")
    pairs = [("chunk_compress_feedback", "values", want[0], got[0]),
             ("chunk_compress_feedback", "rows", want[1], got[1]),
             ("chunk_aggregate_dense", "aggregate", agg_want, agg)]
    pairs += [("chunk_compress_feedback", f"residual of {name}", w,
               o.reshape(-1)) for (name, _), w, o in zip(leaves, want[2],
                                                         got[2])]
    for kname, what, w, o in pairs:
        if not same_bits(w, o):
            fail(f"{label}: {kname} {what} differs from the plain version "
                 f"(max abs err {max_abs_err(w, o)})")
        if w.is_floating_point():
            errs[kname] = max(errs[kname], max_abs_err(w, o))
    return len(pairs)


def bert_batch(dev, cfg):
    """tools/tpu_bert_bench.py's batch: token ids and (start, end) spans
    from numpy seed 0."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ))
    spans = np.stack([rng.integers(0, BERT_SEQ // 2, BERT_BATCH),
                      rng.integers(BERT_SEQ // 2, BERT_SEQ, BERT_BATCH)], 1)
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(spans).to(dev))


def train_bert(dev, group, runs, errs):
    """Phase 24: the chunk Top-K pair at BERT-base's 150 leaves, then
    BERT-base under each BERT_PATH row, 1 warm-up + 3 timed steps a row,
    from one seeded init."""
    import copy

    import torch
    from grace_tpu_torch.examples.bert_powersgd import adamw, span_loss
    from grace_tpu_torch.models import transformer as T

    cfg = T.base(num_classes=2, max_len=BERT_SEQ)
    flops = T.n_flops(cfg, BERT_BATCH, BERT_SEQ)
    template = T.Transformer(cfg, device=dev, seed=SEED)
    leaves = model_leaves(template)
    cases = check_model_kernels(dev, leaves, errs, "[24] BERT-base")
    log(f"[24] the chunk Top-K pair bit for bit against its plain versions "
        f"over BERT-base's {len(leaves)} leaves ({min(n for _, n in leaves)}"
        f" to {max(n for _, n in leaves):,} elements) in one launch each: "
        f"{cases} tensors")
    ids, spans = bert_batch(dev, cfg)
    loss = functools.partial(span_loss, dtype=torch.bfloat16)
    log(f"[24] BERT-base, {BERT_SHAPE[0]} leaves, {BERT_SHAPE[1]:,} "
        f"parameters, sequence {BERT_SEQ}, batch {BERT_BATCH}, bf16 compute, "
        f"AdamW {BERT_LR}; {flops / 1e12:.3f} TFLOP a step (projections and "
        f"attention, forward and backward), bound "
        f"{flops / BF16_FLOP_PER_S * 1e3:.2f} ms at {BF16_FLOP_PER_S / 1e12:g}"
        f" bf16 TFLOP/s")
    rows = []
    for c in BERT_PATH:
        res = train(dev, group, c, ids, spans, BERT_WARMUP_STEPS,
                    BERT_TIMED_STEPS, model=copy.deepcopy(template),
                    loss=loss, shape=BERT_SHAPE,
                    optimizer=lambda ps: adamw(ps, BERT_LR))
        prof = res["profiled"]
        res["tokens_per_s"] = res["img_per_s"] * BERT_SEQ
        res["flops_per_step"] = flops
        res["busy_share"] = prof["device_ms"] / prof["wall_ms"]
        log(f"  {c['name']}: {res['tokens_per_s']:.0f} tokens/s, "
            f"{res['step_ms']:.1f} ms a step, {prof['device_ms']:.1f} device "
            f"ms and {prof['kernels']} kernels in the profiled step (busy "
            f"share <= {res['busy_share']:.2f}), peak {res['peak_mem_gb']:.2f}"
            f" GB; {flops / (res['step_ms'] * 1e-3) / 1e12:.1f} TFLOP/s of "
            "step time")
        runs[c["name"]] = res
        rows.append(res)
        torch.cuda.empty_cache()
    del template
    torch.cuda.empty_cache()
    return rows


def run_bert_example() -> dict:
    """Phase 25: python -m grace_tpu_torch.examples.bert_powersgd at its
    defaults, in a process of its own: exit 0, finite losses, seq/s."""
    line = run_example("bert_powersgd", [], "Seq/sec:",
                       BERT_EXAMPLE_TIMEOUT_S, "[25]")
    # "Seq/sec: S; train loss A -> B over N steps"
    words = line.replace(";", "").split()
    seq_s, first, last, steps = (float(words[1]), float(words[4]),
                                 float(words[6]), int(words[8]))
    if not (math.isfinite(first) and math.isfinite(last)) or steps != 32:
        fail(f"[25] the BERT example: {line!r}")
    return {"launches": {}, "seq_per_s": seq_s, "first_loss": first,
            "last_loss": last, "steps": steps}


def train_cifar(dev, group, cfg, tmp) -> dict:
    """Phase 26: one cifar10_dawn run at its defaults through the entry
    point's train(), the kernels' launches counted over the run."""
    import torch
    from grace_tpu_torch import ops
    from grace_tpu_torch.examples import cifar10_dawn as ex

    args = ex.build_parser().parse_args(
        cfg["argv"] + ["--tsv", str(Path(tmp) / f"{cfg['name']}.tsv")])
    torch.cuda.synchronize()
    ops.reset_launch_counts()                 # just before the run
    t0 = time.perf_counter()
    res = ex.train(args, group, dev, log=lambda *a: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()            # just after it
    accs = [r["test acc"] for r in res["rows"]]
    train_s = res["rows"][-1]["total time"]
    log(f"  {cfg['name']}: test accuracy by epoch "
        f"{' '.join(f'{a:.4f}' for a in accs)}")
    log(f"  {cfg['name']}: {res['steps']} steps, {train_s:.1f} s of training "
        f"(evaluation excluded; {train_s / res['steps'] * 1e3:.2f} ms a step), "
        f"{seconds:.1f} s in all; final loss "
        f"{res['rows'][-1]['train loss']:.4f}; launches {launches}")
    if len(accs) != args.epochs or accs[-1] < CIFAR_FLOOR:
        fail(f"[26] {cfg['name']}: test accuracy {accs[-1]:.4f} at epoch "
             f"{len(accs)}, under {CIFAR_FLOOR}")
    for name, count in launches.items():
        want = cfg["per_step"].get(name, 0) * res["steps"]
        if count != want:
            fail(f"[26] {cfg['name']}: {name} launched {count} times over "
                 f"{res['steps']} steps, expected {want}")
    return {"name": cfg["name"], "accs": accs, "final_acc": accs[-1],
            "steps": res["steps"], "train_seconds": train_s,
            "seconds": seconds, "launches": launches,
            "losses": [r["train loss"] for r in res["rows"]]}


def train_vgg(dev, group, runs, errs):
    """Phase 27: the chunk Top-K pair at VGG-16_bn's 45 leaves, then VGG-16
    with BatchNorm under VGG_PATH, batch 32 at 224x224, 1 warm-up + 3
    timed steps a row."""
    import numpy as np
    import torch
    from grace_tpu_torch.models.vgg import vgg

    leaves = model_leaves(vgg("vgg16_bn", NUM_CLASSES, device="cpu"))
    cases = check_model_kernels(dev, leaves, errs, "[27] VGG-16_bn")
    log(f"[27] the chunk Top-K pair bit for bit against its plain versions "
        f"over VGG-16_bn's {len(leaves)} leaves (up to "
        f"{max(n for _, n in leaves):,} elements) in one launch each: "
        f"{cases} tensors")
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal(
        (VGG_BATCH, IMAGE_HW, IMAGE_HW, 3), dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, NUM_CLASSES, (VGG_BATCH,))).to(dev)
    rows = []
    for c in VGG_PATH:
        res = train(dev, group, c, x, y, HIER_WARMUP_STEPS, HIER_TIMED_STEPS,
                    model=vgg("vgg16_bn", NUM_CLASSES, device=dev, seed=SEED),
                    shape=VGG_SHAPE)
        prof = res["profiled"]
        res["busy_share"] = prof["device_ms"] / prof["wall_ms"]
        log(f"  {c['name']}: {res['img_per_s']:.1f} img/s, "
            f"{prof['device_ms']:.1f} device ms and {prof['kernels']} kernels "
            f"in the profiled step (busy share <= {res['busy_share']:.2f})")
        runs[c["name"]] = res
        rows.append(res)
        torch.cuda.empty_cache()
    return rows


def new_model_phases(dev, group, runs, errs) -> None:
    """Phases 24 to 27, each driven with the kernels' counts set to 0 just
    before it and read just after it (inside ``train`` and
    ``train_cifar``)."""
    import tempfile

    import torch
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    leaves, worst = check_bert_tiny(dev)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    log(f"[24] a 12-layer tiny BERT in float32 on the card agrees with the "
        f"CPU (TF32 off): logits, MLM logits and {leaves} gradients within "
        f"rtol {BERT_TINY_RTOL} and {BERT_TINY_ATOL} of each leaf's largest "
        f"value ({worst:.2f} of the bound at worst)")
    t0 = time.perf_counter()
    train_bert(dev, group, runs, errs)
    log(f"[24] {len(BERT_PATH)} BERT-base rows in "
        f"{time.perf_counter() - t0:.1f} s")
    log("[25] python -m grace_tpu_torch.examples.bert_powersgd (defaults: "
        "base, sequence 384, batch 32, AdamW 5e-5, PowerSGD rank 4, "
        "allreduce, fusion none, one epoch)")
    t0 = time.perf_counter()
    runs["bert_powersgd_example"] = run_bert_example()
    log(f"[25] exited 0: {runs['bert_powersgd_example']['seq_per_s']:.1f} "
        f"seq/s; {time.perf_counter() - t0:.1f} s")
    log(f"[26] cifar10_dawn on synthetic CIFAR-10, one rank, its defaults "
        f"(24 epochs, batch 512, 8,192 / 2,048 images); limit "
        f"{CIFAR_FLOOR} at epoch 24")
    t0 = time.perf_counter()
    from grace_tpu_torch.models.resnet_cifar import ResNetCifar
    leaves = model_leaves(ResNetCifar(device="cpu", seed=SEED))
    flat = sum(n for _, n in leaves)
    if (len(leaves), flat) != CIFAR_SHAPE:
        fail(f"[26] resnet_cifar: {len(leaves)} leaves, {flat:,} parameters, "
             f"expected {CIFAR_SHAPE}")
    cases = check_model_kernels(dev, [("flat", flat)], errs,
                                "[26] resnet_cifar flat")
    log(f"[26] the chunk Top-K pair bit for bit against its plain versions "
        f"over resnet_cifar's flat buffer ({len(leaves)} leaves, {flat:,} "
        f"elements; fusion='flat') in one launch each: {cases} tensors")
    with tempfile.TemporaryDirectory() as tmp:
        for cfg in CIFAR_PATH:
            runs[cfg["name"]] = train_cifar(dev, group, cfg, tmp)
            torch.cuda.empty_cache()
    log(f"[26] both runs in {time.perf_counter() - t0:.1f} s")
    log(f"[27] VGG-16 with BatchNorm, batch {VGG_BATCH}, {IMAGE_HW}x"
        f"{IMAGE_HW} bf16, SGD lr 1e-3, {HIER_WARMUP_STEPS} warm-up + "
        f"{HIER_TIMED_STEPS} timed steps")
    t0 = time.perf_counter()
    train_vgg(dev, group, runs, errs)
    from grace_tpu_torch.models.vgg import vgg
    leaves = model_leaves(vgg("vgg16", NUM_CLASSES, device="cpu"))
    if (len(leaves), sum(n for _, n in leaves)) != VGG_EXAMPLE_SHAPE:
        fail(f"[27] VGG-16: {len(leaves)} leaves, expected "
             f"{VGG_EXAMPLE_SHAPE}")
    cases = check_model_kernels(dev, leaves, errs, "[27] VGG-16 (no BN)")
    torch.cuda.empty_cache()
    log(f"[27] the chunk Top-K pair bit for bit against its plain versions "
        f"over the example's VGG-16 (no BatchNorm), {len(leaves)} leaves, in "
        f"one launch each: {cases} tensors")
    log(f"[27] grace_tpu_torch/examples/synthetic_benchmark.py "
        f"{' '.join(VGG_EXAMPLE_ARGV)}")
    ips = rate(run_example("synthetic_benchmark", VGG_EXAMPLE_ARGV,
                           "img/sec:", EXAMPLE_TIMEOUT_S, "[27]"))
    runs["synthetic_benchmark_vgg16"] = {"launches": {}, "img_per_s": ips}
    log(f"[27] exited 0: {ips:.1f} img/s; {time.perf_counter() - t0:.1f} s")


# -- phase 28: the guarded training step -------------------------------------

# HEADLINE's topk1pct with the dense fp16 escape and the telemetry ring, run
# through guarded_chain(fallback_after=2, fallback_steps=3).
GUARD_PARAMS = {**HEADLINE[1]["params"], "escape": "fp16",
                "telemetry": {"capacity": 128, "compression_error": True}}
GUARD_KW = {"fallback_after": 2, "fallback_steps": 3}
GUARD_STEPS = 12
GUARD_BAD = (4, 5)                 # steps whose gradient gets a NaN lane
GUARD_WINDOW = (6, 7, 8)           # the dense fp16 steps that follow
GUARD_LEAF = "fc.w"                # the poisoned leaf
GUARD_HEALTHY_STEPS = 5
_TOPK_ONCE = {"chunk_compress_feedback": 1, "chunk_aggregate_dense": 1}
# The round-trip of the compression error adds one compress launch a step.
_TOPK_TELEM = {"chunk_compress_feedback": 2, "chunk_aggregate_dense": 1}
GUARD_ROWS = [
    {"name": "phase28_topk1pct", "params": HEADLINE[1]["params"],
     "per_step": _TOPK_ONCE},
    {"name": "phase28_telemetry",
     "params": {**HEADLINE[1]["params"],
                "telemetry": GUARD_PARAMS["telemetry"]},
     "per_step": _TOPK_TELEM},
    {"name": "phase28_guard",
     "params": {**HEADLINE[1]["params"], "escape": "fp16"},
     "guard": GUARD_KW, "per_step": _TOPK_ONCE},
    {"name": "phase28_guard_telemetry", "params": GUARD_PARAMS,
     "guard": GUARD_KW, "per_step": _TOPK_TELEM},
]


def _guard_tensors(state) -> dict:
    """Copies of what a skipped step must leave as it was: the parameters,
    the optimizer's state tensors and every GraceState tensor (mem, comp,
    the ring), by path; plus the GRACE counter."""
    import torch
    from grace_tpu_torch.checkpoint import state_leaves

    params = dict(state.model.named_parameters())
    out = {}
    for path, (leaf, _) in state_leaves(state).items():
        if path.startswith("model/") and path[6:] not in params:
            continue                      # BatchNorm statistics: forward's
        if isinstance(leaf, torch.Tensor):
            out[path] = leaf.detach().clone()
        elif path.endswith("/count"):
            out[path] = leaf
    return out


def _same_state(label, got: dict, want: dict, skip=()) -> int:
    """Fail unless ``got`` equals ``want`` bit for bit, path by path (the
    guard's counters and the paths under ``skip`` left out)."""
    from grace_tpu_torch.resilience.guard import _COUNTERS

    checked = 0
    for path, w in want.items():
        if path.rsplit("/", 1)[-1] in _COUNTERS or path.startswith(skip):
            continue
        g = got.get(path)
        if isinstance(w, int):
            if g != w:
                fail(f"{label}: {path} is {g}, expected {w}")
        elif g is None or not same_bits(g.cpu(), w.cpu()):
            fail(f"{label}: {path} differs bit for bit")
        checked += 1
    return checked


def guarded_injection_run(dev, group, x, y, tmp, seconds=None) -> dict:
    """The guarded chain with NaN steps, its fallback window, its
    telemetry through the sinks and the port's report, and its checkpoints
    (phase 28's first half). Returns the run's launches; the report's wall
    seconds go to ``seconds``."""
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.checkpoint import Checkpointer
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.resilience import guarded_chain
    from grace_tpu_torch.telemetry import (JSONLSink, MultiSink,
                                           TelemetryReader, TensorBoardSink)
    from grace_tpu_torch.train import (init_stateful_train_state,
                                       make_stateful_train_step)
    from grace_tpu_torch.transform import leaf_order
    from grace_tpu_torch.utils.logging import GuardMonitor, run_provenance
    from grace_tpu_torch.utils.metrics import guard_report
    import numpy as np

    jsonl, tbdir = tmp / "telemetry.jsonl", tmp / "tb"
    jsonl_sink = JSONLSink(jsonl, provenance=run_provenance(
        "synthetic", tool="chip_smoke.py [28]"))
    monitor = GuardMonitor(printer=lambda *a: None, sink=jsonl_sink)
    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    chain = guarded_chain(grace_from_params(GUARD_PARAMS, group=group),
                          seed=SEED, **GUARD_KW)
    state = init_stateful_train_state(model, chain, opt, group)
    step = make_stateful_train_step(loss_fn, chain, group)
    named = dict(model.named_parameters())
    current = [0]

    def poison(g):
        if current[0] in GUARD_BAD:
            g = g.clone(memory_format=torch.contiguous_format)
            g.view(-1)[0] = float("nan")
        return g

    hook = named[GUARD_LEAF].register_hook(poison)
    ckpt = Checkpointer(tmp / "ckpt", max_to_keep=None)
    per_step, after3 = [], None
    ops.reset_launch_counts()             # just before the main path
    for i in range(GUARD_STEPS):
        current[0] = i
        before = ops.launch_counts()
        state, loss = step(state, (x, y))
        now = ops.launch_counts()
        per_step.append({k: now[k] - before[k] for k in now})
        monitor.update(i, guard_report(state))
        if i == 3:
            after3 = _guard_tensors(state)
            state.grace.settle()
            memory = {"model": {k: v.clone()
                                for k, v in model.state_dict().items()},
                      "opt": copy.deepcopy(opt.state_dict()),
                      "grace": copy.deepcopy(state.grace)}
            ckpt.save(3, state, good=True)
        if i in GUARD_BAD:
            n = _same_state(f"[28] after bad step {i}", _guard_tensors(state),
                            after3)
            if i == GUARD_BAD[-1]:
                ckpt.save(i, state, good=False)
        if i == GUARD_WINDOW[-1]:
            _same_state("[28] mem/comp after the fallback window",
                        _guard_tensors(state), after3,
                        skip=("model/", "optimizer/", "grace/inner/telem",
                              "grace/inner/count"))
    launches = ops.launch_counts()        # just after it
    hook.remove()
    if not math.isfinite(float(loss)):
        fail(f"[28] non-finite loss {float(loss)} after {GUARD_STEPS} steps")
    for i, got in enumerate(per_step):
        want = ({} if i in GUARD_WINDOW else _TOPK_TELEM)
        got = {k: v for k, v in got.items() if v}
        if got != want:
            fail(f"[28] step {i} launched {got}, expected {want}")
    log(f"[28] injected run: {GUARD_STEPS} steps, a NaN lane in {GUARD_LEAF}'s "
        f"gradient at steps {GUARD_BAD}: after each, {n} parameters, SGD and "
        f"GraceState tensors bit for bit those after step 3 (both chunk "
        f"kernels launched in them, writing in place); steps {GUARD_WINDOW} "
        f"ran the fp16 escape with 0 chunk launches and mem/comp untouched; "
        f"steps 9-11 compress again; per-step launches "
        + " ".join(f"{i}:{p.get('chunk_compress_feedback', 0)}/"
                   f"{p.get('chunk_aggregate_dense', 0)}"
                   for i, p in enumerate(per_step)))
    report = guard_report(state)
    want = {"notfinite_count": 2, "last_bad_step": GUARD_BAD[-1],
            "fallback_remaining": 0, "step": GUARD_STEPS}
    if {k: report[k] for k in want} != want:
        fail(f"[28] guard_report {report}, expected {want}")
    # Telemetry: one flush through both sinks (the guard's transitions are
    # in the JSONL already), then the port's report reads it back.
    reader = TelemetryReader(MultiSink(jsonl_sink, TensorBoardSink(tbdir)),
                             every=GUARD_STEPS)
    records = reader.update(GUARD_STEPS - 1, state)
    reader.close()
    inner = chain.inner
    leaves = [named[n] for n in leaf_order(named)]
    dense_b, link, esc_link, _ = inner._wire_plan(leaf_order(named), leaves,
                                                  1)
    accepted = GUARD_STEPS - len(GUARD_BAD)
    if [r["step"] for r in records] != list(range(accepted)):
        fail(f"[28] ring rows {[r['step'] for r in records]}, expected "
             f"0..{accepted - 1} (no row for the skipped steps)")
    window_rows = {GUARD_WINDOW[0] - len(GUARD_BAD) + j
                   for j in range(len(GUARD_WINDOW))}
    for r in records:
        fb = r["step"] in window_rows
        wire = esc_link.total if fb else link.total
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        if (bad or r["fallback"] != float(fb) or r["wire_bytes"] != wire
                or r["dense_bytes"] != float(np.float32(dense_b))
                or (r["compression_error"] == 0.0) != fb):
            fail(f"[28] telemetry row {r}: expected fallback {float(fb)}, "
                 f"wire_bytes {wire}, dense_bytes {dense_b}, a compression "
                 f"error {'of 0' if fb else 'above 0'}, finite values")
    if (records[-1].get("guard_notfinite_count"),
            records[-1].get("guard_last_bad_step")) != (2, GUARD_BAD[-1]):
        fail(f"[28] the flush's guard fields: {records[-1]}")
    cli = read_side_cli("[28]", "grace_tpu_torch.telemetry", str(jsonl),
                        "--json", seconds=seconds)
    doc = json.loads(cli)
    text = read_side_cli("[28]", "grace_tpu_torch.telemetry", str(jsonl),
                         seconds=seconds)
    wire = [float(r["wire_bytes"]) for r in records]
    want_wire = {"count": len(wire), "mean": sum(wire) / len(wire),
                 "min": min(wire), "max": max(wire), "last": wire[-1]}
    # The monitor sees a step's verdict once the next exchange has read it:
    # each skip names its bad step as last_bad_step.
    skips = [e["last_bad_step"] for e in doc["guard_events"]
             if e["event"] == "guard_skip"]
    if doc["fallback_windows"] != [[min(window_rows), max(window_rows)]] \
            or doc["records"] != len(records) \
            or {m["count"] for k, m in doc["metrics"].items()
                if not k.startswith("guard_")} != {len(records)} \
            or doc["metrics"]["wire_bytes"] != want_wire \
            or skips != list(GUARD_BAD):
        fail(f"[28] the report of the JSONL: fallback windows "
             f"{doc['fallback_windows']} (the escape's rows "
             f"{sorted(window_rows)}), {doc['records']} records, counts "
             f"{ {k: m['count'] for k, m in doc['metrics'].items()} }, "
             f"wire_bytes {doc['metrics'].get('wire_bytes')} (the rows' "
             f"{want_wire}), guard skips at {skips} (want {GUARD_BAD})")
    spans = f"{min(window_rows)}..{max(window_rows)}"
    if f"  dense-fallback windows (recorded steps): {spans}" not in \
            text.splitlines() or f"== guard events " \
            f"({len(doc['guard_events'])}) ==" not in text:
        fail(f"[28] the text report lacks the fallback windows {spans} or "
             f"the guard log:\n{text[-3000:]}")
    events = list(tbdir.glob("events.out.tfevents.*"))
    if len(events) != 1 or events[0].stat().st_size < 1000:
        fail(f"[28] TensorBoard events: {events}")
    log(f"[28] telemetry: {len(records)} rows (steps 0-{accepted - 1}; "
        f"fallback 1.0 on rows {sorted(window_rows)}, where wire_bytes is the "
        f"escape's {esc_link.total} B against Top-K's {link.total} B at W=1, "
        f"dense_bytes {dense_b}); guard_report {report}; JSONL "
        f"{jsonl.stat().st_size} B and TensorBoard {events[0].stat().st_size} "
        f"B written; python -m grace_tpu_torch.telemetry read back fallback "
        f"windows {doc['fallback_windows']}, {doc['records']} rows a metric, "
        f"wire_bytes {doc['metrics']['wire_bytes']}, guard log "
        f"{[(e['step'], e['event'], e['last_bad_step']) for e in doc['guard_events']]}"
        f" (loop step, event, last bad step); its "
        f"text ({len(text.splitlines())} lines):")
    for line in text.splitlines()[:40]:
        log(f"    | {line}")
    # Last-known-good: step 3 back bit for bit, then one update from it
    # equals the same update from the copy kept in memory.
    if (ckpt.all_steps(), ckpt.last_good_step()) != ([3, 5], 3):
        fail(f"[28] checkpoints {ckpt.all_steps()}, last good "
             f"{ckpt.last_good_step()}")
    restored = ckpt.restore_last_good(state)
    n = _same_state("[28] restore_last_good", _guard_tensors(restored),
                    after3)
    for label, (k, v) in (("guard step", ("step", 4)),
                          ("notfinite_count", ("notfinite_count", 0))):
        if int(getattr(restored.grace, k)) != v:
            fail(f"[28] restored {label} {int(getattr(restored.grace, k))}")
    opt.zero_grad(set_to_none=True)
    loss_fn(model, (x, y)).backward()
    grads = {k: p.grad.detach().clone() for k, p in named.items()}
    a = chain.apply(named, {k: g.clone() for k, g in grads.items()},
                    restored.grace, opt)
    got = {"params": {k: p.detach().clone() for k, p in named.items()},
           "mem": [t.clone() for t in a.inner.mem]}
    model.load_state_dict(memory["model"])
    opt.load_state_dict(memory["opt"])
    b = chain.apply(named, {k: g.clone() for k, g in grads.items()},
                    memory["grace"], opt)
    for k, p in named.items():
        if not same_bits(p.detach().cpu(), got["params"][k].cpu()):
            fail(f"[28] the update from the restored state differs at {k}")
    for i, (m1, m2) in enumerate(zip(got["mem"], b.inner.mem)):
        if not same_bits(m1.cpu(), m2.cpu()):
            fail(f"[28] the residual after the restored update differs at "
                 f"leaf {i}")
    log(f"[28] checkpoints at steps 3 (good) and 5 (not good): "
        f"restore_last_good gave step 3 back, {n} tensors bit for bit; one "
        f"update on real gradients from it equals the update from the copy "
        f"kept in memory (parameters and residuals)")
    return launches


def guarded_healthy_run(dev, group, x, y) -> dict:
    """An uninjected guarded + telemetry run beside the unguarded topk1pct
    one: one forward and backward a step, the same gradients to both;
    their parameters and residuals must agree bit for bit after every
    step. Returns the guarded side's launches."""
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.resilience import guarded_chain

    ma = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    mb = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    na, nb = dict(ma.named_parameters()), dict(mb.named_parameters())
    opt_a = torch.optim.SGD(ma.parameters(), lr=1e-3)
    opt_b = torch.optim.SGD(mb.parameters(), lr=1e-3)
    tx = grace_from_params(HEADLINE[1]["params"], group=group) \
        .transform(seed=SEED)
    chain = guarded_chain(grace_from_params(GUARD_PARAMS, group=group),
                          seed=SEED, **GUARD_KW)
    sa, sb = tx.init(na), chain.init(nb)
    launches = {}
    for s in range(GUARD_HEALTHY_STEPS):
        opt_a.zero_grad(set_to_none=True)
        loss_fn(ma, (x, y)).backward()
        grads_b = {k: p.grad.detach().clone() for k, p in na.items()}
        updates, sa = tx.update({k: p.grad for k, p in na.items()}, sa)
        for k, p in na.items():
            p.grad = updates[k]
        opt_a.step()
        ops.reset_launch_counts()
        sb = chain.apply(nb, grads_b, sb, opt_b)
        for k, v in ops.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        for k in na:
            if not same_bits(na[k].detach().cpu(), nb[k].detach().cpu()):
                fail(f"[28] healthy guarded step {s}: parameter {k} differs "
                     "from the unguarded run's")
        for i, (m1, m2) in enumerate(zip(sa.mem, sb.inner.mem)):
            if not same_bits(m1.cpu(), m2.cpu()):
                fail(f"[28] healthy guarded step {s}: residual {i} differs "
                     "from the unguarded run's")
    if sb.inner.count != GUARD_HEALTHY_STEPS:
        fail(f"[28] healthy guarded run: count {sb.inner.count}")
    log(f"[28] healthy run: {GUARD_HEALTHY_STEPS} guarded + telemetry steps "
        f"on the unguarded topk1pct run's gradients: parameters and "
        f"residuals bit for bit those of the unguarded run after every step; "
        f"launches {launches}")
    return launches


def _sync_count(fn):
    """``fn()``'s result and the synchronizing calls it made
    (``torch.cuda.set_sync_debug_mode``)."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def exchange_host_ms(dev, group, x, y, reps=5, rows=GUARD_ROWS) -> dict:
    """Each of ``rows``' exchanges alone (the GRACE update and the SGD
    step, guarded or not, and the consensus hook where the row has one) on
    one set of real ResNet-50 gradients, started on an idle card: the host
    ms to enqueue it and the ms until the card finishes it, medians of
    ``reps``; any synchronizing call the exchange makes is counted
    (``torch.cuda.set_sync_debug_mode``)."""
    import torch
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.resilience import consensus_step, guarded_chain

    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    named = dict(model.named_parameters())
    loss_fn(model, (x, y)).backward()
    grads = {k: p.grad.detach().clone() for k, p in named.items()}
    out = {}
    for cfg in rows:
        grace = grace_from_params(cfg["params"], group=group)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        if cfg.get("guard") is None:
            tx = grace.transform(seed=SEED)
            st = [tx.init(named)]

            def run():
                updates, st[0] = tx.update(
                    {k: g.clone() for k, g in grads.items()}, st[0])
                for k, p in named.items():
                    p.grad = updates[k]
                opt.step()
        else:
            chain = guarded_chain(grace, seed=SEED, **cfg["guard"])
            st = [chain.init(named)]

            def run():
                st[0] = chain.apply(named, {k: g.clone()
                                            for k, g in grads.items()},
                                    st[0], opt)
                if cfg.get("consensus"):
                    st[0] = consensus_step((model, opt, st[0]),
                                           cfg["consensus"], group)[2]
        run()
        run()
        host, total = [], []

        def timed():
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                host.append((t1 - t0) * 1e3)
                total.append((time.perf_counter() - t0) * 1e3)

        # torch.cuda.synchronize() is not a call the debug mode flags.
        _, syncs = _sync_count(timed)
        out[cfg["name"]] = {"host_ms": statistics.median(host),
                            "until_done_ms": statistics.median(total),
                            "syncs": syncs / reps}
        log(f"  {cfg['name']}: the exchange alone enqueues in "
            f"{out[cfg['name']]['host_ms']:.2f} ms of host time, done after "
            f"{out[cfg['name']]['until_done_ms']:.2f} ms; "
            f"{syncs / reps:g} synchronizing calls a step")
    return out


def guarded_phase(dev, group, x, y, runs) -> None:
    """Phase 28, each part driven with the kernels' counts set to 0 just
    before it and read just after it."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    seconds: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs["phase28_injected"] = {"launches": guarded_injection_run(
            dev, group, x, y, Path(tmp), seconds), "cli_seconds": seconds}
    torch.cuda.empty_cache()
    runs["phase28_healthy"] = {"launches": guarded_healthy_run(dev, group,
                                                               x, y)}
    torch.cuda.empty_cache()
    n_params = 25_557_032
    log(f"[28] the guard's snapshot a step: the parameters and the residuals, "
        f"2 x {n_params:,} float32 = {2 * 4 * n_params / 1e6:.1f} MB (SGD "
        f"without momentum keeps no state)")
    for cfg in GUARD_ROWS:
        runs[cfg["name"]] = train(dev, group, cfg, x, y, HIER_WARMUP_STEPS,
                                  HIER_TIMED_STEPS)
        torch.cuda.empty_cache()
    log("[28] the four rows' exchanges alone, from an idle card")
    for name, t in exchange_host_ms(dev, group, x, y).items():
        runs[name]["exchange"] = t
    torch.cuda.empty_cache()
    log("[28] " + "; ".join(
        f"{c['name']}: device {runs[c['name']]['profiled']['device_ms']:.1f}"
        f" ms, {runs[c['name']]['profiled']['kernels']} kernels, busy <= "
        f"{runs[c['name']]['profiled']['device_ms'] / runs[c['name']]['profiled']['wall_ms']:.2f}, "
        f"{runs[c['name']]['step_ms']:.1f} ms/step, peak "
        f"{runs[c['name']]['peak_mem_gb']:.2f} GB, chunk launches a step "
        f"{c['per_step']['chunk_compress_feedback']}+"
        f"{c['per_step']['chunk_aggregate_dense']}"
        for c in GUARD_ROWS) + f"; {time.perf_counter() - t0:.1f} s")


# -- phase 29: the cross-rank watch and the consistency audit ----------------

WATCH_WINDOW = 5
AUDIT_EVERY = 5
# HEADLINE's topk1pct with the telemetry ring and the watch ring; the
# consensus row adds the fp16 escape, the guard and the audit at every
# step; the last row is the slice's path: all of them, audit every 5.
WATCH_PARAMS = {**HEADLINE[1]["params"],
                "telemetry": GUARD_PARAMS["telemetry"],
                "watch": WATCH_WINDOW}
ALL_PARAMS = {**WATCH_PARAMS, "escape": "fp16", "consensus": True}
WATCH_ROWS = [
    {"name": "phase29_watch", "params": WATCH_PARAMS,
     "per_step": _TOPK_TELEM},
    {"name": "phase29_consensus",
     "params": {**HEADLINE[1]["params"], "escape": "fp16",
                "consensus": True},
     "guard": GUARD_KW, "consensus": {"audit_every": 1},
     "per_step": _TOPK_ONCE},
    {"name": "phase29_all", "params": ALL_PARAMS, "guard": GUARD_KW,
     "consensus": {"audit_every": AUDIT_EVERY}, "per_step": _TOPK_TELEM},
]
WATCH_HEALTHY_STEPS = 5
FP_FOLD_RTOL = 1e-5          # the float fold, of each segment's sum of |x|


def check_fingerprint_on_the_card(tree, segments=8) -> int:
    """fingerprint_tree of ``tree`` on the card against the same tensors'
    fingerprint on the CPU: checksum words bit for bit, each float fold
    within FP_FOLD_RTOL of its segment's sum of |x|. Returns the leaves."""
    import numpy as np
    from grace_tpu_torch.resilience import fingerprint_tree, replicated_view

    leaves = replicated_view(tree)
    dev_fp = fingerprint_tree(leaves, segments).cpu().numpy()
    host = [t.detach().cpu() for t in leaves]
    cpu_fp = fingerprint_tree(host, segments).numpy()
    if not np.array_equal(dev_fp[:segments], cpu_fp[:segments]):
        fail(f"[29] fingerprint checksum words differ between the card and "
             f"the CPU: {dev_fp[:segments]} vs {cpu_fp[:segments]}")
    mags = np.zeros(segments)
    for i, t in enumerate(host):
        if t.is_floating_point():
            mags[i % segments] += float(t.double().abs().sum())
    dev_v = dev_fp[segments:].astype(np.uint32).view(np.float32)
    cpu_v = cpu_fp[segments:].astype(np.uint32).view(np.float32)
    err = np.abs(dev_v.astype(np.float64) - cpu_v)
    if not np.all(err <= FP_FOLD_RTOL * mags + 1e-6):
        fail(f"[29] fingerprint float folds differ beyond {FP_FOLD_RTOL} of "
             f"the segments' sum of |x|: {dev_v} vs {cpu_v}")
    return len(leaves)


def consensus_healthy_run(dev, group, x, y, tmp) -> dict:
    """The slice's path (ALL_PARAMS, guarded, the audit at every step)
    beside the same chain without the audit, on the same gradients: bit
    for bit after every step; the reader (anomaly detectors armed),
    audit_report and ConsensusMonitor silent; the timeline of the run's
    JSONL; the reader's flush one transfer. Returns the audited side's
    launches and its state, for the checks that follow."""
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.resilience import (ConsensusConfig, audit_report,
                                            consensus_step, guarded_chain)
    from grace_tpu_torch.telemetry import (JSONLSink, TelemetryReader,
                                           Timeline)
    from grace_tpu_torch.utils.logging import ConsensusMonitor, run_provenance

    ma = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    mb = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    na, nb = dict(ma.named_parameters()), dict(mb.named_parameters())
    opt_a = torch.optim.SGD(ma.parameters(), lr=1e-3)
    opt_b = torch.optim.SGD(mb.parameters(), lr=1e-3)
    chain_a = guarded_chain(grace_from_params(ALL_PARAMS, group=group),
                            seed=SEED, **GUARD_KW)
    chain_b = guarded_chain(grace_from_params(
        {**ALL_PARAMS, "consensus": None}, group=group), seed=SEED,
        **GUARD_KW)
    audit = ConsensusConfig(audit_every=1)
    sa, sb = chain_a.init(na), chain_b.init(nb)
    jsonl = tmp / "phase29.jsonl"
    sink = JSONLSink(jsonl, provenance=run_provenance(
        "synthetic", tool="chip_smoke.py [29]"))
    reader = TelemetryReader(sink, every=WATCH_HEALTHY_STEPS, anomaly=True)
    printed = []
    monitor = ConsensusMonitor(printer=printed.append, sink=sink)
    launches, records = {}, []
    for s in range(WATCH_HEALTHY_STEPS):
        opt_a.zero_grad(set_to_none=True)
        loss_fn(ma, (x, y)).backward()
        grads_b = {k: p.grad.detach().clone() for k, p in na.items()}
        ops.reset_launch_counts()
        sa = chain_a.apply(na, {k: p.grad for k, p in na.items()}, sa,
                           opt_a)
        sa = consensus_step((ma, opt_a, sa), audit, group)[2]
        for k, v in ops.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        sb = chain_b.apply(nb, grads_b, sb, opt_b)
        monitor.update(s, audit_report(sa))
        if s == WATCH_HEALTHY_STEPS - 1:
            calls = [0]
            cpu = torch.Tensor.cpu

            def counting(self, *a, **k):
                calls[0] += 1
                return cpu(self, *a, **k)

            torch.Tensor.cpu = counting
            try:
                out, syncs = _sync_count(lambda: reader.update(s, sa))
            finally:
                torch.Tensor.cpu = cpu
            if calls[0] != 1:
                fail(f"[29] the reader's flush made {calls[0]} device-to-host"
                     " transfers with the watch ring armed, expected 1")
            records += out
        else:
            records += reader.update(s, sa)
        for k in na:
            if not same_bits(na[k].detach().cpu(), nb[k].detach().cpu()):
                fail(f"[29] healthy step {s}: parameter {k} differs between "
                     "the audited and the unaudited run")
        for i, (m1, m2) in enumerate(zip(sa.inner.mem, sb.inner.mem)):
            if not same_bits(m1.cpu(), m2.cpu()):
                fail(f"[29] healthy step {s}: residual {i} differs between "
                     "the audited and the unaudited run")
        if not same_bits(sa.counters().cpu(), sb.counters().cpu()) or \
                sa.inner.count != sb.inner.count:
            fail(f"[29] healthy step {s}: the guard's counters or the GRACE "
                 "count differ between the audited and the unaudited run")
    reader.close()
    report = audit_report(sa)
    want = {"audits": WATCH_HEALTHY_STEPS, "repairs": 0, "escalations": 0,
            "last_divergent_rank": -1, "last_repair_step": -1}
    if report != want or printed:
        fail(f"[29] healthy run: audit_report {report} (expected {want}), "
             f"ConsensusMonitor printed {printed}")
    anomalies = [r for r in records if r.get("event") == "watch_anomaly"]
    watch_rows = [r for r in records if r.get("event") == "watch"]
    metric_rows = [r for r in records if "wire_bytes" in r]
    if anomalies or [r["step"] for r in watch_rows] != list(
            range(0, WATCH_HEALTHY_STEPS, WATCH_WINDOW)):
        fail(f"[29] healthy run: anomalies {anomalies}, watch rows at "
             f"{[r['step'] for r in watch_rows]}")
    audit_bytes = [r["audit_bytes"] for r in metric_rows]
    if audit_bytes != [float(1 * 2 * 8 * 4)] * WATCH_HEALTHY_STEPS:
        fail(f"[29] audit_bytes {audit_bytes}: expected the W=1 gather's "
             "64 B on every row")
    summary = Timeline.from_jsonl(str(jsonl)).summary()
    want = {"events": len(records),
            "kind_counts": {"telemetry": len(metric_rows),
                            "watch": len(watch_rows)},
            "step_span": [0, WATCH_HEALTHY_STEPS - 1], "anomalies": 0,
            "anomalies_by_kind": {}, "anomaly_max_score": {},
            "anomalous_ranks": []}
    if summary != want:
        fail(f"[29] Timeline.from_jsonl summary {summary}, expected {want}")
    log(f"[29] healthy run: {WATCH_HEALTHY_STEPS} steps of the slice's path "
        f"with the audit at every step, and without it, on the same "
        f"gradients: parameters, residuals, the guard's counters and the "
        f"GRACE count bit for bit after every step; audit_report {report}; "
        f"ConsensusMonitor and the anomaly detectors silent; the reader's "
        f"flush one transfer ({syncs} synchronizing calls); the JSONL's "
        f"timeline: {summary['kind_counts']}, steps {summary['step_span']}; "
        f"launches {launches}")
    del mb, opt_b, sb, chain_b
    return {"launches": launches, "model": ma, "opt": opt_a, "state": sa}


def check_chaos_on_the_card(dev, group, x, y, healthy) -> dict:
    """ChaosParams flips exactly the logged (leaf, element, bit) of rank 0's
    parameters; masked_broadcast at W=1 is the identity; a ChaosCompressor
    run launches no chunk kernel. Returns the chaos run's launches."""
    import dataclasses

    import numpy as np
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.comm import masked_broadcast
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.resilience import ChaosCompressor, ChaosParams
    from grace_tpu_torch.train import (TrainState, init_stateful_train_state,
                                       make_stateful_train_step)
    from grace_tpu_torch.transform import leaf_order

    model, opt = healthy["model"], healthy["opt"]
    named = dict(model.named_parameters())
    order = leaf_order(named)
    before = {k: p.detach().clone() for k, p in named.items()}
    chaos = ChaosParams(rank=0, at_steps=(2,), seed=SEED, group=group)
    state = TrainState(model, opt, healthy["state"])
    chaos(state, 1)
    chaos(state, 2)
    if len(chaos.injections) != 1:
        fail(f"[29] ChaosParams injections {chaos.injections}")
    _, li, pos, bit = chaos.injections[0]
    for i, k in enumerate(order):
        diff = (named[k].detach().reshape(-1).view(torch.int32)
                ^ before[k].reshape(-1).view(torch.int32)).cpu().numpy()
        hits = np.flatnonzero(diff)
        want = [pos] if i == li else []
        if hits.tolist() != want or (
                want and int(diff[pos]) & 0xFFFFFFFF != 1 << bit):
            fail(f"[29] ChaosParams: leaf {k} changed at {hits.tolist()}, "
                 f"expected one bit ({bit}) of element {want}")
    with torch.no_grad():
        named[order[li]].copy_(before[order[li]])       # undo the flip
    probe = torch.randn(4099, device=dev)
    probe[3] = -0.0
    probe.view(torch.int32)[5] = 0x7FC00123
    for t in (probe, probe.to(torch.bfloat16), probe > 0,
              torch.arange(-7, 9, device=dev, dtype=torch.int64)):
        if not same_bits(masked_broadcast(t, 0, group).cpu(), t.cpu()):
            fail(f"[29] masked_broadcast at W=1 changed a {t.dtype} tensor")
    grc = grace_from_params(WATCH_PARAMS, group=group)
    grc = dataclasses.replace(grc, compressor=ChaosCompressor(
        inner=grc.compressor, drift_scale=0.5, rank=0, group=group))
    m = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    o = torch.optim.SGD(m.parameters(), lr=1e-3)
    tx = grc.transform(seed=SEED)
    st = init_stateful_train_state(m, tx, o, group)
    step = make_stateful_train_step(loss_fn, tx, group)
    ops.reset_launch_counts()             # just before the chaos run
    for _ in range(2):
        st, loss = step(st, (x, y))
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    if launches or not math.isfinite(float(loss)):
        fail(f"[29] the ChaosCompressor run launched {launches} (expected no "
             f"chunk kernel: the wrapper takes the staged path), loss "
             f"{float(loss)}")
    log(f"[29] ChaosParams(rank=0, at_steps=(2,)) flipped bit {bit} of "
        f"element {pos} of {order[li]} and nothing else; masked_broadcast at "
        f"W=1 the identity bit for bit (float32 with -0.0 and a NaN payload, "
        f"bf16, bool, int64); a ChaosCompressor (drift 0.5) run of 2 steps "
        f"launched no chunk kernel, loss {float(loss):.4f}")
    return {"launches": ops.launch_counts()}


def kernels_in(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches, by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in device_events(prof))


def audit_cost(dev, group, healthy) -> dict:
    """One audit of the HEADLINE state and one fingerprint of it, and one
    fingerprint of BERT-base's parameters and AdamW moments: ms (medians
    of 5), synchronizing calls, bytes and the bound."""
    import torch
    from grace_tpu_torch.models import transformer as T
    from grace_tpu_torch.resilience import (ConsensusConfig, fingerprint_tree,
                                            force_audit, replicated_view)

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        host, total = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(host), statistics.median(total)

    tree = (healthy["model"], healthy["opt"], healthy["state"])
    cfg = ConsensusConfig()
    leaves = replicated_view(tree)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    audit_host, audit_ms = timed(lambda: force_audit(tree, cfg, group))
    _, audit_syncs = _sync_count(lambda: force_audit(tree, cfg, group))
    audit_kernels = kernels_in(lambda: force_audit(tree, cfg, group))
    fp_host, fp_ms = timed(lambda: fingerprint_tree(leaves))
    n_leaves = check_fingerprint_on_the_card(tree)
    out = {"resnet50": {"leaves": n_leaves, "bytes": nbytes,
                        "audit_ms": audit_ms, "audit_host_ms": audit_host,
                        "audit_syncs": audit_syncs,
                        "audit_kernels": audit_kernels,
                        "fingerprint_ms": fp_ms,
                        "fingerprint_host_ms": fp_host,
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}}
    log(f"[29] one audit of the HEADLINE state ({n_leaves} leaves, "
        f"{nbytes / 1e6:.1f} MB: parameters, BatchNorm statistics, the "
        f"guard's counters): {audit_ms:.3f} ms until done, {audit_host:.3f} "
        f"ms of host, {audit_kernels} kernels, {audit_syncs} synchronizing "
        f"call; fingerprint_tree "
        f"alone {fp_ms:.3f} ms ({fp_host:.3f} host; bound "
        f"{out['resnet50']['bound_ms']:.4f} ms at 3.35 TB/s); its words "
        f"equal the CPU's fingerprint of the same tensors bit for bit, the "
        f"float folds within {FP_FOLD_RTOL} of each segment's sum of |x|")
    bert = T.Transformer(T.base(num_classes=2, max_len=BERT_SEQ),
                         device=dev, seed=SEED)
    params = [p.detach() for p in bert.parameters()]
    moments = [torch.randn_like(p) for p in params for _ in range(2)]
    big = params + moments
    bbytes = sum(t.numel() * t.element_size() for t in big)
    b_host, b_ms = timed(lambda: fingerprint_tree(big), reps=3)
    b_kernels = kernels_in(lambda: fingerprint_tree(big))
    out["bert_base_adamw"] = {"leaves": len(big), "bytes": bbytes,
                              "fingerprint_ms": b_ms,
                              "fingerprint_kernels": b_kernels,
                              "fingerprint_host_ms": b_host,
                              "bound_ms": bbytes / HBM_BYTES_PER_S * 1e3}
    log(f"[29] fingerprint_tree over BERT-base's parameters and AdamW "
        f"moments ({len(big)} leaves, {bbytes / 1e9:.2f} GB): {b_ms:.3f} ms "
        f"({b_host:.3f} host, {b_kernels} kernels), bound {bbytes / HBM_BYTES_PER_S * 1e3:.3f} ms"
        f" at 3.35 TB/s")
    del bert, params, moments, big
    return out


def watch_read_side(jsonl: Path, tmp: Path, docs: Path, smi: str) -> dict:
    """[29]'s healthy JSONL through ``python -m
    grace_tpu_torch.telemetry.watch``: no anomaly re-derived (the live
    detectors were silent), the timeline's metric rows the run's audited
    steps, its own baseline clean (exit 0) and a copy with one planted
    ``watch_anomaly`` a regression (exit 1). The document goes to
    ``docs/WATCH_LAST.json``. Returns the command lines' wall seconds."""
    seconds: dict = {}
    module = "grace_tpu_torch.telemetry.watch"
    doc = json.loads(read_side_cli(
        "[29]", module, str(jsonl), "--timeline", "--anomalies", "--json",
        "--out", str(docs / "WATCH_LAST.json"), smi=smi, seconds=seconds))
    if doc["recorded_anomalies"] or doc["derived_anomalies"] \
            or doc["anomalies"]:
        fail(f"[29] the watch re-derived anomalies from a run whose live "
             f"detectors were silent: {doc['derived_anomalies']}")
    base = tmp / "watch_baseline.json"
    text = read_side_cli("[29]", module, str(jsonl), "--timeline", "--kinds",
                         "telemetry", "--write-baseline", str(base), "--out",
                         "", smi=smi, seconds=seconds)
    rows = [line for line in text.splitlines() if "[telemetry" in line]
    steps = [int(line.split()[1]) for line in rows]
    with open(jsonl) as f:
        audited = [r["step"] for r in map(json.loads, f)
                   if "wire_bytes" in r and r.get("audit_bytes", 0) > 0]
    if steps != list(range(WATCH_HEALTHY_STEPS)) or audited != steps:
        fail(f"[29] the watch's timeline holds metric rows at {steps}, "
             f"audited rows at {audited}; want the "
             f"{WATCH_HEALTHY_STEPS} audited steps")
    read_side_cli("[29]", module, str(jsonl), "--baseline", str(base),
                  "--out", "", smi=smi, seconds=seconds)
    planted = tmp / "planted.jsonl"
    planted.write_text(jsonl.read_text() + json.dumps(
        {"event": "watch_anomaly", "step": 2, "kind": "skew",
         "metric": "compression_error", "rank": 0, "score": 9.0,
         "threshold": 6.0, "value": 0.5}) + "\n")
    out = read_side_cli("[29]", module, str(planted), "--baseline",
                        str(base), "--out", "", expect=1, smi=smi,
                        seconds=seconds)
    log(f"[29] the watch: 0 anomalies recorded or re-derived; timeline "
        f"metric rows at steps {steps}, each an audited step; its own "
        f"baseline clean; the planted anomaly: "
        + "; ".join(l.strip() for l in out.splitlines() if "REGRESSION" in l))
    return seconds


def watch_phase(dev, group, x, y, runs, docs_dir=None) -> None:
    """Phase 29, each part driven with the kernels' counts set to 0 just
    before it and read just after it. The watch's evidence document goes
    to ``docs_dir`` (default: a temporary directory)."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    log("[29] W=1 on one card (NCCL refuses two ranks on one device): "
        "detection, repair and escalation across ranks are held on the CPU "
        "over gloo at W=4 against JAX's four-device mesh "
        "(tests/test_torch_consensus.py, test_torch_watch.py, "
        "test_torch_chaos.py)")
    with tempfile.TemporaryDirectory() as tmp:
        healthy = consensus_healthy_run(dev, group, x, y, Path(tmp))
        watch_seconds = watch_read_side(Path(tmp) / "phase29.jsonl",
                                        Path(tmp), Path(docs_dir or tmp),
                                        nvidia_smi_line())
    runs["phase29_healthy"] = {"launches": healthy["launches"],
                               "cli_seconds": watch_seconds}
    runs["phase29_chaos"] = check_chaos_on_the_card(dev, group, x, y,
                                                    healthy)
    torch.cuda.empty_cache()
    runs["phase29_audit_cost"] = {"launches": {}, **audit_cost(
        dev, group, healthy)}
    del healthy
    torch.cuda.empty_cache()
    for cfg in WATCH_ROWS:
        runs[cfg["name"]] = train(dev, group, cfg, x, y, HIER_WARMUP_STEPS,
                                  HIER_TIMED_STEPS)
        torch.cuda.empty_cache()
    log("[29] the three rows' exchanges alone (with the consensus hook), "
        "from an idle card")
    for name, t in exchange_host_ms(dev, group, x, y,
                                    rows=WATCH_ROWS).items():
        runs[name]["exchange"] = t
    torch.cuda.empty_cache()
    log("[29] " + "; ".join(
        f"{c['name']}: device {runs[c['name']]['profiled']['device_ms']:.1f}"
        f" ms, {runs[c['name']]['profiled']['kernels']} kernels, busy <= "
        f"{runs[c['name']]['profiled']['device_ms'] / runs[c['name']]['profiled']['wall_ms']:.2f}, "
        f"{runs[c['name']]['step_ms']:.1f} ms/step, peak "
        f"{runs[c['name']]['peak_mem_gb']:.2f} GB, chunk launches a step "
        f"{c['per_step']['chunk_compress_feedback']}+"
        f"{c['per_step']['chunk_aggregate_dense']}, exchange host "
        f"{runs[c['name']]['exchange']['host_ms']:.2f} ms, "
        f"{runs[c['name']]['exchange']['syncs']:g} synchronizing calls a "
        "step" for c in WATCH_ROWS) + f"; {time.perf_counter() - t0:.1f} s")


# -- phase 30: the adaptive compression ladder and elastic resize ------------

ADAPT_WINDOW = 5
# The slice's path: HEADLINE's topk1pct with the fp16 escape, the telemetry
# ring and the ladder of the registry entry adapt-topk-hier
# (grace_tpu/analysis/configs.py:414-419): rungs fp16, Top-K 4%, Top-K 1%.
ADAPT_PARAMS = {**HEADLINE[1]["params"], "escape": "fp16", "telemetry": True,
                "adapt": {"window": ADAPT_WINDOW,
                          "ladder": [{"compress_ratio": 0.04}]}}
ADAPT_RUNG_RATIO = 0.04
ADAPT_STEPS = 20                   # after one warm-up step
# Thresholds no real signal crosses: one rung for a profiled step.
_PINNED = {"tighten_error": 1e5, "tighten_peak": 1e5, "loosen_error": 1e-9}
# bench_all.py:179-186 verbatim, its static twin with the same escape and
# telemetry ring (so the gap between the two is the ladder alone), and the
# bare static twin (HOMO_PATH's row).
ADAPT_HOMO_ROWS = [
    {"name": "phase30_adapt_homoqsgd4_ring_bs256", "per_device_bs": 256,
     "params": {"compressor": "homoqsgd", "quantum_num": 7,
                "memory": "residual", "communicator": "ring",
                "fusion": "flat", "escape": "fp16", "telemetry": 16,
                "adapt": {"window": 25, "ladder": [{"quantum_num": 127}]}},
     "per_step": {}},
    {**HOMO_PATH[0], "name": "phase30_homoqsgd4_ring_telemetry_bs256",
     "params": {**HOMO_PATH[0]["params"], "escape": "fp16",
                "telemetry": 16}},
    {**HOMO_PATH[0], "name": "phase30_homoqsgd4_ring_bs256"},
]
# The registry entry adapt-guard-consensus (configs.py:427-431) moved onto
# topk1pct: its ladder rung, guard and audit. fallback_after=3 needs three
# bad steps in a row to open the dense window.
ADAPT_GUARD_PARAMS = {**HEADLINE[1]["params"], "escape": "fp16",
                      "telemetry": True, "consensus": True,
                      "adapt": {"window": ADAPT_WINDOW,
                                "ladder": [{"compress_ratio": 0.2}]}}
ADAPT_GUARD_KW = {"fallback_after": 3, "fallback_steps": 8}
ADAPT_GUARD_BAD = (3, 4, 5)
ADAPT_GUARD_STEPS = 16
ADAPT_AUDIT_EVERY = 5
ADAPT_HEALTHY_STEPS = 5
# JAX's elastic fixture config (tests/test_elastic.py:43-55) on topk1pct.
ELASTIC_PARAMS = {**HEADLINE[1]["params"], "escape": "fp16",
                  "consensus": {"audit_every": 50}, "telemetry": 8,
                  "watch": {"window": 2, "capacity": 4}}
ELASTIC_GUARD_KW = {"fallback_after": 3, "fallback_steps": 4}
ELASTIC_STEPS = 3


def _replay(cfg, rows):
    """The effective rungs a host replay of the controller gives over the
    ring's rows (each row's compression error and fallback flag, W=1: the
    local error is the mean and the worst rank's), in float32, and the
    replayed state after the last row."""
    import torch
    from grace_tpu_torch.resilience import adapt as A

    a, rungs = A.adapt_init(cfg), []
    for r in rows:
        fb = bool(r["fallback"])
        rungs.append(0 if fb else a.settle().rung)
        e = torch.tensor(r["compression_error"], dtype=torch.float32)
        a = A.adapt_advance(a, cfg, int(r["step"]), fb, e, e)
    return rungs, a.settle()


def _ring_rows(state) -> list:
    from grace_tpu_torch.telemetry import TelemetryReader
    rows = [r for r in TelemetryReader(every=1).flush(state)
            if "adapt_rung" in r]
    return sorted(rows, key=lambda r: r["step"])


def check_rung_kernels(dev, grads, resids, ratio, errs) -> int:
    """Both chunk Top-K kernels at a rung's k (grouped over every leaf, one
    launch each) against their grouped plain versions on real gradients,
    bit for bit: the compress with the run's residuals and without
    feedback, the aggregate of its payload at W=1."""
    import torch
    from grace_tpu_torch.compressors import static_k
    from grace_tpu_torch.ops import chunk_topk as ck

    gs = [g.reshape(-1) for g in grads]
    ns = [g.numel() for g in gs]
    ks = [static_k(n, ratio) for n in ns]
    cases = 0
    for label, rs in (("feedback", [r.reshape(-1) for r in resids]),
                      ("round-trip", [None] * len(gs))):
        want = ck.chunk_compress_feedback_grouped_plain(gs, rs, ks)
        got = ck.chunk_compress_feedback_grouped(
            gs, [None if r is None else r.clone() for r in rs], ks)
        torch.cuda.synchronize()
        parts = [("vals", want[0], got[0]), ("indices", want[1], got[1])] + [
            (f"residual {i}", w, o.reshape(-1))
            for i, (w, o) in enumerate(zip(want[2], got[2]))]
        for part, w, o in parts:
            if not same_bits(w, o):
                fail(f"[30] chunk_compress_feedback at {ratio:g} {label}: "
                     f"{part} differs from the plain version (max abs err "
                     f"{max_abs_err(w, o)})")
            if w.is_floating_point():
                errs["chunk_compress_feedback"] = max(
                    errs["chunk_compress_feedback"], max_abs_err(w, o))
        cases += 1
        for average in (True, False):
            agg_w = ck.chunk_aggregate_dense_grouped_plain(
                want[0][None], want[1][None], ks, ns, average)
            agg_g = ck.chunk_aggregate_dense_grouped(
                got[0][None], got[1][None], ks, ns, average)
            torch.cuda.synchronize()
            if not same_bits(agg_w, agg_g):
                fail(f"[30] chunk_aggregate_dense at {ratio:g} {label} "
                     f"average={average}: differs from the plain version "
                     f"(max abs err {max_abs_err(agg_w, agg_g)})")
            errs["chunk_aggregate_dense"] = max(
                errs["chunk_aggregate_dense"], max_abs_err(agg_w, agg_g))
            cases += 1
    return cases


def adapt_trajectory_run(dev, group, x, y, errs) -> dict:
    """The slice's path: topk1pct under the ladder, 1 warm-up + ADAPT_STEPS
    steps. Per step its launches, wall ms, synchronizing calls (the debug
    mode) and the controller's waits for a boundary's pinned copy; the
    ring's rung trajectory against a host replay of the controller; the
    AdaptMonitor's events; both chunk kernels at the 4% rung's k against
    their plain versions on the run's gradients and residuals."""
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.resilience import adapt as A
    from grace_tpu_torch.train import (init_stateful_train_state,
                                       make_stateful_train_step)
    from grace_tpu_torch.transform import leaf_order

    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    grace = grace_from_params(ADAPT_PARAMS, group=group)
    tx = grace.transform(seed=SEED)
    state = init_stateful_train_state(model, tx, opt, group)
    step = make_stateful_train_step(loss_fn, tx, group)
    reads, read = [0], A._Boundary.read

    def counted(self):
        reads[0] += 1
        return read(self)

    A._Boundary.read = counted
    per_step = []
    try:
        ops.reset_launch_counts()             # just before the main path
        for _ in range(1 + ADAPT_STEPS):
            before, r0 = ops.launch_counts(), reads[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (state, loss), syncs = _sync_count(
                lambda: step(state, (x, y)))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            now = ops.launch_counts()
            per_step.append({
                "launches": {k: now[k] - before[k] for k in now
                             if now[k] - before[k]},
                "syncs": syncs, "reads": reads[0] - r0, "ms": ms})
        launches = ops.launch_counts()        # just after it
    finally:
        A._Boundary.read = read
    if not math.isfinite(float(loss)):
        fail(f"[30] non-finite loss {float(loss)}")
    rows = _ring_rows(state)
    traj = [int(r["adapt_rung"]) for r in rows]
    if [r["step"] for r in rows] != list(range(1 + ADAPT_STEPS)):
        fail(f"[30] ring rows {[r['step'] for r in rows]}")
    want, _ = _replay(grace.adapt, rows)
    if traj != want:
        fail(f"[30] the card's rung trajectory {traj} differs from the host "
             f"replay of adapt_advance over the ring's errors {want}")
    if set(traj) != {0, 1, 2}:
        fail(f"[30] the trajectory {traj} did not visit every rung")
    # The step's own synchronizing calls (if any) are the baseline; the
    # controller may add one, where it reads a boundary's statistics.
    base = min(p["syncs"] for p in per_step)
    for i, (rung, p) in enumerate(zip(traj, per_step)):
        expect = _TOPK_TELEM if rung else {}
        if p["launches"] != expect:
            fail(f"[30] step {i} at rung {rung} launched {p['launches']}, "
                 f"expected {expect}")
        boundary_before = i > 0 and i % ADAPT_WINDOW == 0
        if p["reads"] != int(boundary_before) or \
                p["syncs"] - base > p["reads"]:
            fail(f"[30] step {i}: {p['reads']} boundary reads and "
                 f"{p['syncs']} synchronizing calls (expected "
                 f"{int(boundary_before)} and at most {base} + reads)")
    events = A.AdaptMonitor().observe(rows)
    moves = sum(1 for a, b in zip(traj, traj[1:]) if a != b)
    if len(events) != moves:
        fail(f"[30] AdaptMonitor emitted {events} for {moves} transitions")
    report = A.adapt_report(state)
    by_rung = {r: statistics.median(p["ms"] for p, t in zip(per_step, traj)
                                    if t == r) for r in sorted(set(traj))}
    log(f"[30] trajectory over 1 + {ADAPT_STEPS} steps: {traj} (equal to the "
        f"host replay of adapt_advance over the ring's float32 errors "
        f"{[round(r['compression_error'], 4) for r in rows]}); AdaptMonitor "
        f"{[(e['event'], e['step']) for e in events]}; adapt_report "
        f"{report}; chunk launches a step "
        + " ".join(f"{p['launches'].get('chunk_compress_feedback', 0)}+"
                   f"{p['launches'].get('chunk_aggregate_dense', 0)}"
                   for p in per_step)
        + f"; boundary reads {sum(p['reads'] for p in per_step)} "
        f"(steps {[i for i, p in enumerate(per_step) if p['reads']]}), "
        f"debug-mode synchronizing calls {sum(p['syncs'] for p in per_step)}"
        f"; median wall ms a step by rung {by_rung}")
    # Both kernels at the 4% rung's k on this run's gradients.
    opt.zero_grad(set_to_none=True)
    loss_fn(model, (x, y)).backward()
    named = dict(model.named_parameters())
    order = leaf_order(named)
    grads = [named[n].grad.detach() for n in order]
    cases = check_rung_kernels(dev, grads, list(state.grace.mem),
                               ADAPT_RUNG_RATIO, errs)
    log(f"[30] both chunk kernels at the 4% rung's k over the {len(grads)} "
        f"leaves ({cases} grouped cases: compress with the run's residuals "
        f"and without feedback, the aggregate of each at W=1, averaged and "
        f"summed) bit for bit against their plain versions")
    return {"launches": launches, "trajectory": traj, "events": events,
            "report": report, "per_step": per_step,
            "median_ms_by_rung": by_rung, "loss": float(loss)}


def profile_rungs(dev, group, x, y) -> dict:
    """One profiled step (after one warm-up) at each pinned rung of the
    ladder, of the static twin (topk1pct + fp16 escape + telemetry) and of
    the twin with its escape forced: device ms, kernels, busy share,
    launches and synchronizing calls."""
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.train import (TrainState, init_stateful_train_state,
                                       make_stateful_train_step)
    from grace_tpu_torch.transform import set_fallback_flag

    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    static = {k: v for k, v in ADAPT_PARAMS.items() if k != "adapt"}
    rows = [(f"phase30_rung{r}", {**ADAPT_PARAMS, "adapt": {
        **ADAPT_PARAMS["adapt"], **_PINNED, "start_rung": r}}, False)
        for r in (2, 1, 0)]
    rows += [("phase30_static", static, False),
             ("phase30_escape", static, True)]
    out = {}
    for name, params, forced in rows:
        tx = grace_from_params(params, group=group).transform(seed=SEED)
        state = init_stateful_train_state(model, tx, opt, group)
        if forced:
            state = TrainState(model, opt, set_fallback_flag(state.grace,
                                                             True))
        step = make_stateful_train_step(loss_fn, tx, group)
        state, _ = step(state, (x, y))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        _, syncs = _sync_count(lambda: step(state, (x, y)))
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        prof = profile_step(step, state, (x, y), name)
        out[name] = {"launches": launches, "profiled": prof, "syncs": syncs}
    for r in (2, 1):
        if out[f"phase30_rung{r}"]["launches"] != _TOPK_TELEM:
            fail(f"[30] rung {r}: launches {out[f'phase30_rung{r}']}")
    for name in ("phase30_rung0", "phase30_escape"):
        if out[name]["launches"]:
            fail(f"[30] {name} launched {out[name]['launches']}")
    log("[30] one profiled step each: " + "; ".join(
        f"{k}: device {v['profiled']['device_ms']:.2f} ms, "
        f"{v['profiled']['kernels']} kernels, busy <= "
        f"{v['profiled']['device_ms'] / v['profiled']['wall_ms']:.2f}, wall "
        f"{v['profiled']['wall_ms']:.1f} ms, launches {v['launches']}, "
        f"{v['syncs']} synchronizing calls" for k, v in out.items()))
    return out


def adapt_guard_consensus_run(dev, group, x, y) -> dict:
    """ADAPT_GUARD_PARAMS through the guard and the audit (every
    ADAPT_AUDIT_EVERY steps): NaN lanes at ADAPT_GUARD_BAD open the dense
    window, whose steps run rung 0 with no chunk launch; the ring's rungs
    and adapt_report against a host replay (each boundary whose window
    held a fallback step escalates). Then the healthy adaptive run with
    the audit at every step against the same run without it, bit for
    bit. Returns the injected run's launches."""
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.resilience import (ConsensusConfig, adapt_report,
                                            audit_report, consensus_step,
                                            guarded_chain)
    from grace_tpu_torch.train import (init_stateful_train_state,
                                       make_stateful_train_step)
    from grace_tpu_torch.utils.metrics import guard_report

    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    grace = grace_from_params(ADAPT_GUARD_PARAMS, group=group)
    chain = guarded_chain(grace, seed=SEED, **ADAPT_GUARD_KW)
    state = init_stateful_train_state(model, chain, opt, group)
    step = make_stateful_train_step(
        loss_fn, chain, group,
        consensus=ConsensusConfig(audit_every=ADAPT_AUDIT_EVERY))
    named = dict(model.named_parameters())
    current = [0]

    def poison(g):
        if current[0] in ADAPT_GUARD_BAD:
            g = g.clone(memory_format=torch.contiguous_format)
            g.view(-1)[0] = float("nan")
        return g

    hook = named[GUARD_LEAF].register_hook(poison)
    per_step = []
    try:
        ops.reset_launch_counts()             # just before the main path
        for i in range(ADAPT_GUARD_STEPS):
            current[0] = i
            before = ops.launch_counts()
            state, loss = step(state, (x, y))
            now = ops.launch_counts()
            per_step.append({k: now[k] - before[k] for k in now
                             if now[k] - before[k]})
        launches = ops.launch_counts()        # just after it
    finally:
        hook.remove()
    if not math.isfinite(float(loss)):
        fail(f"[30] guarded adaptive run: non-finite loss {float(loss)}")
    rows = _ring_rows(state)
    accepted = [i for i in range(ADAPT_GUARD_STEPS)
                if i not in ADAPT_GUARD_BAD]
    if len(rows) != len(accepted):
        fail(f"[30] guarded adaptive run: {len(rows)} ring rows for "
             f"{len(accepted)} accepted steps")
    window = [i for i, r in zip(accepted, rows) if r["fallback"]]
    if window != list(range(ADAPT_GUARD_BAD[-1] + 1, ADAPT_GUARD_BAD[-1] + 1
                            + ADAPT_GUARD_KW["fallback_steps"])):
        fail(f"[30] the dense window ran at steps {window}")
    want, replayed = _replay(grace.adapt, rows)
    traj = [int(r["adapt_rung"]) for r in rows]
    if traj != want:
        fail(f"[30] guarded adaptive run: rungs {traj}, host replay {want}")
    for i, r in zip(accepted, rows):
        expect = _TOPK_TELEM if int(r["adapt_rung"]) else {}
        if per_step[i] != expect or (r["fallback"] and per_step[i]):
            fail(f"[30] guarded adaptive step {i} (rung "
                 f"{int(r['adapt_rung'])}, fallback {r['fallback']}) "
                 f"launched {per_step[i]}")
    report, guard = adapt_report(state), guard_report(state)
    windows = {}
    for r in rows:
        windows.setdefault(int(r["step"]) // ADAPT_WINDOW, []).append(
            bool(r["fallback"]))
    decided = len(rows) // ADAPT_WINDOW
    expect_esc = sum(any(windows[w]) for w in range(decided))
    got = {k: report[k] for k in ("rung", "tightens", "loosens",
                                  "escalations", "hold", "quiet")}
    want_rep = {k: getattr(replayed, k) for k in got}
    if got != want_rep or report["escalations"] != expect_esc \
            or expect_esc < 1 or guard["notfinite_count"] != len(
                ADAPT_GUARD_BAD):
        fail(f"[30] guarded adaptive run: adapt_report {report} (replay "
             f"{want_rep}, {expect_esc} windows held fallback steps), "
             f"guard_report {guard}")
    log(f"[30] guarded adaptive run ({ADAPT_GUARD_STEPS} steps, NaN at "
        f"{ADAPT_GUARD_BAD}, audit every {ADAPT_AUDIT_EVERY}): dense window "
        f"at steps {window} on rung 0 with no chunk launch; rungs {traj} = "
        f"the host replay; adapt_report {report} ({expect_esc} boundaries "
        f"saw fallback steps: one escalation each); guard skips "
        f"{guard['notfinite_count']}; launches a step "
        + " ".join(f"{i}:{p.get('chunk_compress_feedback', 0)}/"
                   f"{p.get('chunk_aggregate_dense', 0)}"
                   for i, p in enumerate(per_step)))
    del state, chain, model, opt
    torch.cuda.empty_cache()
    # The audit over a healthy adaptive run changes nothing.
    ma = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    mb = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    na, nb = dict(ma.named_parameters()), dict(mb.named_parameters())
    opt_a = torch.optim.SGD(ma.parameters(), lr=1e-3)
    opt_b = torch.optim.SGD(mb.parameters(), lr=1e-3)
    chain_a = guarded_chain(grace_from_params(ADAPT_GUARD_PARAMS,
                                              group=group),
                            seed=SEED, **ADAPT_GUARD_KW)
    chain_b = guarded_chain(grace_from_params(
        {**ADAPT_GUARD_PARAMS, "consensus": None}, group=group), seed=SEED,
        **ADAPT_GUARD_KW)
    audit = ConsensusConfig(audit_every=1)
    sa, sb = chain_a.init(na), chain_b.init(nb)
    for s in range(ADAPT_HEALTHY_STEPS):
        opt_a.zero_grad(set_to_none=True)
        loss_fn(ma, (x, y)).backward()
        grads_b = {k: p.grad.detach().clone() for k, p in na.items()}
        sa = chain_a.apply(na, {k: p.grad for k, p in na.items()}, sa,
                           opt_a)
        sa = consensus_step((ma, opt_a, sa), audit, group)[2]
        sb = chain_b.apply(nb, grads_b, sb, opt_b)
        for k in na:
            if not same_bits(na[k].detach().cpu(), nb[k].detach().cpu()):
                fail(f"[30] healthy audited step {s}: parameter {k} differs")
        for i, (m1, m2) in enumerate(zip(sa.inner.mem, sb.inner.mem)):
            if not same_bits(m1.cpu(), m2.cpu()):
                fail(f"[30] healthy audited step {s}: residual {i} differs")
        if adapt_report(sa) != adapt_report(sb):
            fail(f"[30] healthy audited step {s}: adapt_report "
                 f"{adapt_report(sa)} vs {adapt_report(sb)}")
    audits = audit_report(sa)
    if (audits["audits"], audits["repairs"]) != (ADAPT_HEALTHY_STEPS, 0):
        fail(f"[30] healthy audited run: audit_report {audits}")
    log(f"[30] healthy adaptive run, audit at every step, and without it: "
        f"{ADAPT_HEALTHY_STEPS} steps, parameters, residuals and "
        f"adapt_report {adapt_report(sa)} bit for bit; audit_report "
        f"{audits}")
    return {"launches": launches}


def elastic_run(dev, group, x, y, tmp) -> dict:
    """The HEADLINE state under JAX's elastic fixture config after
    ELASTIC_STEPS steps: ElasticController.drain (the last-known-good save,
    timed, its size), the re-shard onto a fresh one-rank group (replicated
    fields, the guard's counters and the parameters bit for bit, residuals
    zero, rings reset, validate_resharded), the next step on it (both chunk
    kernels), and the rejoin barrier (timed, no repair). Returns the next
    step's launches."""
    import torch
    import torch.distributed as dist
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.checkpoint import Checkpointer
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.resilience import (ElasticController, guarded_chain,
                                            plan_resize, resize_group)
    from grace_tpu_torch.resilience.guard import _COUNTERS
    from grace_tpu_torch.train import (init_stateful_train_state,
                                       make_stateful_train_step)

    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    chain = guarded_chain(grace_from_params(ELASTIC_PARAMS, group=group),
                          seed=SEED, **ELASTIC_GUARD_KW)
    state = init_stateful_train_state(model, chain, opt, group)
    consensus = ELASTIC_PARAMS["consensus"]
    step = make_stateful_train_step(loss_fn, chain, group,
                                    consensus=consensus)
    for _ in range(ELASTIC_STEPS):
        state, loss = step(state, (x, y))
    old = state.grace.inner
    if not any(float(m.abs().sum()) > 0 for m in old.mem):
        fail("[30] elastic: the run left no residual to re-initialize")
    ckpt = Checkpointer(tmp / "ck", max_to_keep=None)
    ctl = ElasticController(consensus=consensus, checkpointer=ckpt,
                            group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = ctl.drain(ELASTIC_STEPS, state, rank=0)
    drain_ms = (time.perf_counter() - t0) * 1e3
    drain_mb = sum(f.stat().st_size for f in (tmp / "ck").rglob("*")
                   if f.is_file()) / 1e6
    if not rec["checkpointed"] or ckpt.last_good_step() != ELASTIC_STEPS:
        fail(f"[30] elastic drain: {rec}, last good {ckpt.last_good_step()}")
    keep = {"params": {k: p.detach().clone()
                       for k, p in model.named_parameters()},
            "counters": state.grace.counters().clone(),
            "host": (old.count, old.seed, old.fallback, old.audit)}
    plan = plan_resize(1, [])
    new_group = resize_group(plan, group)
    grace1 = grace_from_params(ELASTIC_PARAMS, group=new_group)
    chain1 = guarded_chain(grace1, seed=SEED, **ELASTIC_GUARD_KW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, event = ctl.resize(ELASTIC_STEPS, state, chain1, group, new_group,
                            plan, grace=grace1)
    torch.cuda.synchronize()
    resize_ms = (time.perf_counter() - t0) * 1e3
    inner = new.grace.inner
    if (inner.count, inner.seed, inner.fallback, inner.audit) \
            != keep["host"] or not same_bits(new.grace.counters().cpu(),
                                             keep["counters"].cpu()):
        fail(f"[30] elastic resize: replicated fields {inner.count}, "
             f"{inner.seed}, {inner.fallback}, {inner.audit} or the "
             f"guard's counters changed")
    for k, p in model.named_parameters():
        if not same_bits(p.detach().cpu(), keep["params"][k].cpu()):
            fail(f"[30] elastic resize: parameter {k} changed")
    if any(float(m.abs().sum()) for m in inner.mem) or \
            int((inner.telem.steps != -1).sum()) or \
            float(inner.telem.rings.abs().sum()) or \
            int((inner.watch.steps != -1).sum()) or \
            not event["footprint_matches"]:
        fail(f"[30] elastic resize: residuals, rings or footprint not "
             f"re-initialized ({event})")
    step1 = make_stateful_train_step(loss_fn, chain1, new_group,
                                     consensus=consensus)
    ops.reset_launch_counts()             # just before the next step
    new, loss = step1(new, (x, y))
    launches = ops.launch_counts()        # just after it
    if {k: v for k, v in launches.items() if v} != _TOPK_TELEM or \
            not math.isfinite(float(loss)):
        fail(f"[30] elastic: the step after the resize launched {launches}, "
             f"loss {float(loss)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, report = ctl.rejoin(ELASTIC_STEPS + 1, new, new_group)
    rejoin_ms = (time.perf_counter() - t0) * 1e3
    if report["barrier_repairs"] or report["replica_variants"] != 1:
        fail(f"[30] elastic rejoin: {report}")
    kinds = [e["event"] for e in ctl.events]
    if kinds != ["elastic_drain", "elastic_resize", "elastic_rejoin"]:
        fail(f"[30] elastic events {kinds}")
    dist.destroy_process_group(new_group)
    log(f"[30] elastic: drain (last-known-good save of step "
        f"{ELASTIC_STEPS}) {drain_ms:.1f} ms, {drain_mb:.1f} MB on disk; "
        f"re-shard onto a fresh one-rank group {resize_ms:.1f} ms: count, "
        f"seed, fallback, audit, the guard's counters and the parameters "
        f"bit for bit, residuals zero, rings reset, footprint "
        f"{event['footprint_matches']}; the next step launched "
        f"{ {k: v for k, v in launches.items() if v} }; rejoin barrier "
        f"{rejoin_ms:.1f} ms, {report['barrier_repairs']} repairs, "
        f"{report['replica_variants']} replica variant(s)")
    return {"launches": launches, "drain_ms": drain_ms, "drain_mb": drain_mb,
            "resize_ms": resize_ms, "rejoin_ms": rejoin_ms}


def adapt_phase(dev, group, x, y, runs, errs) -> None:
    """Phase 30, each part driven with the kernels' counts set to 0 just
    before it and read just after it."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    runs["phase30_adapt_topk1pct"] = adapt_trajectory_run(dev, group, x, y,
                                                          errs)
    torch.cuda.empty_cache()
    runs.update(profile_rungs(dev, group, x, y))
    torch.cuda.empty_cache()
    for cfg in ADAPT_HOMO_ROWS:
        runs[cfg["name"]] = train(dev, group, cfg, x, y, HIER_WARMUP_STEPS,
                                  HIER_TIMED_STEPS)
        torch.cuda.empty_cache()
    runs["phase30_adapt_guard_consensus"] = adapt_guard_consensus_run(
        dev, group, x, y)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        runs["phase30_elastic"] = elastic_run(dev, group, x, y, Path(tmp))
    torch.cuda.empty_cache()
    a, t, s = (runs[c["name"]] for c in ADAPT_HOMO_ROWS)
    log(f"[30] homoqsgd4_ring_bs256 with the ladder (window 25), without it "
        f"(same escape and telemetry ring) and bare: device "
        f"{a['profiled']['device_ms']:.2f} vs {t['profiled']['device_ms']:.2f}"
        f" vs {s['profiled']['device_ms']:.2f} ms, "
        f"{a['profiled']['kernels']} vs {t['profiled']['kernels']} vs "
        f"{s['profiled']['kernels']} kernels, {a['step_ms']:.2f} vs "
        f"{t['step_ms']:.2f} vs {s['step_ms']:.2f} ms/step; "
        f"{time.perf_counter() - t0:.1f} s")


def kernel_named(fn, word: str) -> str:
    """The name of the one CUDA kernel whose name holds ``word`` among those
    one call of ``fn`` launches, as the profiler names it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in device_events(prof)})
        hits = [n for n in names if word in n]
        if len(hits) == 1:
            return hits[0]
        if names:
            break
    fail(f"one call launched {len(hits)} kernels named *{word}*: {names}")


# -- phase 31: the data path ----------------------------------------------------

DATA_BATCH = 256
DATA_EPOCHS = 3                  # the prefetch checks and the bit-for-bit run
PREFETCH_SIZES = (1, 2, 4)
LOADER_TIMING_EPOCHS = 3


def _indexed(ds):
    """``ds`` with each image's index as its label, so a batch names the
    images it holds."""
    import numpy as np
    from grace_tpu_torch.data import MemoryDataset
    return MemoryDataset(ds.images, np.arange(len(ds.images), dtype=np.int32),
                         ds.mean, ds.std)


def check_loader_contract(ds) -> int:
    """Phase 31, first part: the native loader over the MNIST split at
    batch 256, ``drop_last=False``: for world 1 and 8, every rank's epoch
    holds its share of a permutation (the ranks disjoint, their union every
    image), the short final batch wraps to its own front, and every value
    equals MemoryDataset.normalize bit for bit; make_loader takes the
    native loader. Returns the batches checked."""
    import numpy as np
    from grace_tpu_torch import data

    idx = _indexed(ds)
    n = len(ds.images)
    if data.make_loader(idx, DATA_BATCH, rank=0, world=1).kind != "native":
        fail("[31] make_loader fell back to PythonLoader: the native loader "
             "did not build")
    checked = 0
    for world in (1, 8):
        for epoch in (0, 5):
            seen = []
            for rank in range(world):
                ld = data.NativeLoader(idx, DATA_BATCH, drop_last=False,
                                       seed=42, rank=rank, world=world)
                share = len(range(rank, n, world))
                ys = []
                for x, y in ld.epoch(epoch):
                    if not np.array_equal(x, ds.normalize(ds.images[y])):
                        fail(f"[31] world {world} rank {rank} epoch {epoch}: "
                             f"a batch differs from MemoryDataset.normalize")
                    ys.append(y)
                    checked += 1
                ld.close()
                y = np.concatenate(ys)
                tail = share % DATA_BATCH
                if tail:
                    last = y[-DATA_BATCH:]
                    want = last[np.arange(DATA_BATCH) % tail]
                    if not np.array_equal(last, want):
                        fail(f"[31] world {world} rank {rank}: the short "
                             f"final batch does not wrap to its front")
                seen.append(y[:share])
            if not np.array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(n)):
                fail(f"[31] world {world} epoch {epoch}: the ranks' shares "
                     f"are not a permutation of the {n} images")
    return checked


def _batch_sums(x, y):
    import torch
    return torch.stack([x.double().sum(), (x.double() ** 2).sum(),
                        (x.double() * torch.arange(
                            x.shape[0], device=x.device,
                            dtype=torch.float64).view(-1, 1, 1, 1)).sum(),
                        y.double().sum()])


def check_prefetch(dev, ds) -> int:
    """Phase 31, second part: prefetch_to_device on the card, at each of
    PREFETCH_SIZES and over DATA_EPOCHS epochs of the native loader, yields
    the same batches as a blocking ``.to(dev)`` of each, bit for bit and in
    order. Each batch is compared at once (a copy still in flight would
    show), and also read by sums queued behind a ``torch.cuda._sleep`` and
    dropped before they run; the sums are compared after the epoch with
    the same sums of the blocking copies (a buffer handed on while the
    caller's stream still reads it would show). Returns the batches
    compared."""
    import torch
    from grace_tpu_torch import data

    loader = data.NativeLoader(ds, DATA_BATCH, seed=42, rank=0, world=1)
    compared = 0
    for size in PREFETCH_SIZES:
        for epoch in range(DATA_EPOCHS):
            host = list(loader.epoch(epoch))
            sums = []
            for i, (x, y) in enumerate(data.prefetch_to_device(
                    iter(host), dev, size=size)):
                if not (torch.equal(x, torch.from_numpy(host[i][0]).to(dev))
                        and torch.equal(y, torch.from_numpy(host[i][1]).to(
                            dev))):
                    fail(f"[31] prefetch size {size} epoch {epoch}: batch "
                         f"{i} differs from a blocking copy")
                torch.cuda._sleep(1_000_000)
                sums.append(_batch_sums(x, y))
                del x, y
            if len(sums) != len(host):
                fail(f"[31] prefetch size {size}: {len(sums)} batches of "
                     f"{len(host)}")
            for i, (hx, hy) in enumerate(host):
                want = _batch_sums(torch.from_numpy(hx).to(dev),
                                   torch.from_numpy(hy).to(dev))
                if not torch.equal(sums[i], want):
                    fail(f"[31] prefetch size {size} epoch {epoch}: batch {i} "
                         f"read after its hand-over differs from a blocking "
                         f"copy")
            compared += len(host)
    loader.close()
    return compared


STEP_GAP_S = 0.005               # a LeNet step's host time, between pulls


def loader_host_ms(ds) -> dict:
    """Host ms a batch (MNIST split, batch 256, one rank) of the native
    loader (4 threads, a ring of 4) and of PythonLoader, over
    LOADER_TIMING_EPOCHS epochs each after one warm epoch, in turns: pulled
    back to back (the loader's throughput), and with STEP_GAP_S of busy
    host between pulls, timing the pulls alone (what the training thread waits
    for a batch while the native workers fill the ring during its step)."""
    from grace_tpu_torch import data

    loaders = {"native": data.NativeLoader(ds, DATA_BATCH, seed=42, rank=0,
                                           world=1),
               "python": data.PythonLoader(ds, DATA_BATCH, seed=42, rank=0,
                                           world=1)}
    for ld in loaders.values():
        list(ld.epoch(0))
    out = {}
    for gap in (0.0, STEP_GAP_S):
        spent = {k: 0.0 for k in loaders}
        count = {k: 0 for k in loaders}
        for epoch in range(1, LOADER_TIMING_EPOCHS + 1):
            for kind, ld in loaders.items():
                it = iter(ld.epoch(epoch))
                while True:
                    t0 = time.perf_counter()
                    batch = next(it, None)
                    spent[kind] += time.perf_counter() - t0
                    if batch is None:
                        break
                    count[kind] += 1
                    until = time.perf_counter() + gap
                    while time.perf_counter() < until:     # a busy host
                        pass
        for k in loaders:
            out[f"{k}{'_with_step_gap' if gap else ''}"] = \
                spent[k] / count[k] * 1e3
    loaders["native"].close()
    return out


def lenet_epoch(dev, res, args, prefetch: int, profiled: bool) -> dict:
    """One more epoch of the MNIST entry point's loop (its batches, its
    device_batches, its step and its per-step loss read) from ``res``'s
    state: the wall ms a step, and under the profiler the device time of
    its kernels and copies against the wall (a busy share that counts
    overlapping work twice: an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from grace_tpu_torch.data import batches, load_mnist_auto
    from grace_tpu_torch.examples import mnist10k_lenet as ex

    x_train, y_train = load_mnist_auto(args.data_dir)[:2]
    step = res["step"]

    def epoch():
        host = ((xb, yb.astype("int64")) for xb, yb in batches(
            x_train, y_train, args.batch_size, shuffle=True, seed=args.seed))
        n = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in ex.device_batches(host, dev, prefetch):
            res["state"], loss = step(res["state"], batch)
            float(loss)
            n += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, n

    if not profiled:
        wall, n = epoch()
        return {"wall_ms": wall, "steps": n, "ms_per_step": wall / n}
    warm_profiler()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, n = epoch()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in device_events(prof)) / 1e3
    return {"wall_ms": wall, "steps": n, "ms_per_step": wall / n,
            "device_ms": busy, "busy_share": busy / wall}


def lenet_pair(dev, group, prefetch: int):
    """The MNIST entry point, chunk Top-K 1% + residual, DATA_EPOCHS epochs
    at ``--prefetch prefetch``: the curve and the final parameters."""
    import torch
    from grace_tpu_torch.examples import mnist10k_lenet as ex

    args = ex.build_parser().parse_args(
        ["--compressor", "topk", "--topk-algorithm", "chunk", "--memory",
         "residual", "--epochs", str(DATA_EPOCHS), "--prefetch",
         str(prefetch)])
    res = ex.train(args, group, dev, log=lambda *a: None)
    torch.cuda.synchronize()
    params = {n: p.detach().clone() for n, p in
              res["state"].model.named_parameters()}
    return res, args, params


def data_path_phase(dev, group, runs, smi) -> None:
    """Phase 31: the native loader's contract, the prefetch against
    blocking copies, the bit-for-bit LeNet pair and the data path's
    times."""
    import torch
    from grace_tpu_torch.data import mnist_split_dataset
    from grace_tpu_torch.examples import mnist10k_lenet as ex
    from grace_tpu_torch.ops import _build

    t0 = time.perf_counter()
    ds = mnist_split_dataset(ex.BUNDLED_MNIST_DIR, train=True)
    lib = _build.host_library("dataloader")
    checked = check_loader_contract(ds)
    log(f"[31] native loader {Path(lib._name).name} (host C++): {checked} "
        f"batches of {DATA_BATCH} at world 1 and 8 over two epochs: "
        f"permutations, ranks disjoint, values equal to "
        f"MemoryDataset.normalize bit for bit, the short batch wrapped")
    compared = check_prefetch(dev, ds)
    log(f"[31] prefetch_to_device at sizes {PREFETCH_SIZES}: {compared} "
        f"batches equal to blocking copies bit for bit, in order")
    determ = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with_pf, args, p_with = lenet_pair(dev, group, 2)
        without, _, p_without = lenet_pair(dev, group, 0)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = determ
    if with_pf["accs"] != without["accs"]:
        fail(f"[31] LeNet with prefetch {with_pf['accs']} against blocking "
             f"copies {without['accs']}")
    differ = [n for n in p_with if not same_bits(p_with[n], p_without[n])]
    if differ:
        fail(f"[31] LeNet's parameters after {DATA_EPOCHS} epochs differ "
             f"with and without prefetch: {differ}")
    log(f"[31] LeNet chunk Top-K, {DATA_EPOCHS} epochs: with prefetch and "
        f"with blocking copies the same accuracies "
        f"({' '.join(f'{a:.4f}' for a in with_pf['accs'])}) and the same "
        f"{len(p_with)} parameter tensors bit for bit")
    host_ms = loader_host_ms(ds)
    epochs = {}
    for label, prefetch in (("prefetch", 2), ("blocking", 0),
                            ("blocking", 0), ("prefetch", 2)):
        for profiled in (False, True):
            key = f"{label}{'_profiled' if profiled else ''}"
            epochs.setdefault(key, []).append(
                lenet_epoch(dev, with_pf, args, prefetch, profiled))
    rows = {}
    for label in ("prefetch", "blocking"):
        plain, prof = epochs[label], epochs[f"{label}_profiled"]
        rows[label] = {
            "ms_per_step": [e["ms_per_step"] for e in plain],
            "profiled_ms_per_step": [e["ms_per_step"] for e in prof],
            "device_ms_per_step": [e["device_ms"] / e["steps"] for e in prof],
            "busy_share": [e["busy_share"] for e in prof]}
    log(f"[31] {smi}: host ms a batch (MNIST split, batch {DATA_BATCH}, "
        f"{LOADER_TIMING_EPOCHS} epochs): back to back, native loader "
        f"{host_ms['native']:.3f}, PythonLoader {host_ms['python']:.3f}; "
        f"with {STEP_GAP_S * 1e3:.0f} ms between pulls, native "
        f"{host_ms['native_with_step_gap']:.3f}, PythonLoader "
        f"{host_ms['python_with_step_gap']:.3f}")
    for label, r in rows.items():
        log(f"[31] {smi}: LeNet epoch ({label}, two turns): wall ms a step "
            f"{' '.join(f'{v:.3f}' for v in r['ms_per_step'])}; profiled "
            f"{' '.join(f'{v:.3f}' for v in r['profiled_ms_per_step'])}, "
            f"device ms a step "
            f"{' '.join(f'{v:.3f}' for v in r['device_ms_per_step'])}, busy "
            f"share <= {' '.join(f'{v:.3f}' for v in r['busy_share'])}")
    runs["data_path"] = {"launches": {}, "card": smi,
                         "loader_host_ms_per_batch": host_ms,
                         "lenet_epoch": rows,
                         "prefetch_batches_compared": compared,
                         "loader_batches_checked": checked,
                         "seconds": time.perf_counter() - t0}
    log(f"[31] {time.perf_counter() - t0:.1f} s")


# -- phase 32: the 2-D mesh and the profiler's read side ----------------------

def _mesh_headline_run(dev, group, x, y, mesh=None, recorder=None):
    """[5]'s topk1pct steps (2 + 5, SGD lr 1e-3, seed 0): over ``group``
    through make_stateful_train_step as [5] runs them, or over the 2-D
    ``mesh`` through make_train_step(mesh=...). The chunk kernels' launch
    counts are set to 0 just before the steps and read just after."""
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.train import (init_stateful_train_state,
                                       init_train_state, make_train_step,
                                       make_stateful_train_step)

    params = HEADLINE[1]["params"]
    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    if mesh is None:
        tx = grace_from_params(params, group=group).transform(seed=SEED)
        state = init_stateful_train_state(model, tx, opt, group)
        step = make_stateful_train_step(loss_fn, tx, group)
    else:
        tx = grace_from_params({**params, "fsdp_axis": "fsdp"},
                               group=mesh).transform(seed=SEED)
        state = init_train_state(model, tx, opt, mesh=mesh, param_specs={})
        step = make_train_step(loss_fn, tx, mesh=mesh, param_specs={})
    torch.cuda.synchronize()
    ops.reset_launch_counts()                 # just before the main path
    losses = []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        if recorder is None:
            state, loss = step(state, (x, y))
        else:
            with recorder.step():
                state, loss = step(state, (x, y))
                recorder.sync_on(loss)
        losses.append(loss.detach().clone())
    torch.cuda.synchronize()
    launches = ops.launch_counts()            # just after it
    return state, step, torch.stack(losses), launches


def _mesh_state_bits(state) -> dict:
    out = {f"model/{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    out.update({f"mem/{i}": m.detach().clone()
                for i, m in enumerate(state.grace.mem) if m is not None})
    return out


def check_shard_kernels(dev, shards, errs) -> int:
    """Both chunk kernels on the shard leaves' real gradients (1%, one
    grouped launch each, residual feedback, W=1), bit for bit against the
    grouped plain versions."""
    import torch
    from grace_tpu_torch.compressors import static_k
    from grace_tpu_torch.ops import chunk_topk as ck

    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    gs = [g.reshape(-1) for g in shards]
    ns = [g.numel() for g in gs]
    ks = [static_k(n, 0.01) for n in ns]
    rs = [torch.randn(n, generator=gen, device=dev) * 1e-3 for n in ns]
    want = ck.chunk_compress_feedback_grouped_plain(gs, rs, ks)
    got = ck.chunk_compress_feedback_grouped(gs, [r.clone() for r in rs], ks)
    agg_want = ck.chunk_aggregate_dense_grouped_plain(
        want[0][None], want[1][None], ks, ns, True)
    agg = ck.chunk_aggregate_dense_grouped(want[0][None], want[1][None], ks,
                                           ns, True)
    torch.cuda.synchronize()
    pairs = [("chunk_compress_feedback", "values", want[0], got[0]),
             ("chunk_compress_feedback", "rows", want[1], got[1]),
             ("chunk_aggregate_dense", "aggregate", agg_want, agg)]
    pairs += [("chunk_compress_feedback", f"residual {i}", w, o.reshape(-1))
              for i, (w, o) in enumerate(zip(want[2], got[2]))]
    for kname, what, w, o in pairs:
        if not same_bits(w, o):
            fail(f"[32] shard 0: {kname} {what} differs from the plain "
                 f"version (max abs err {max_abs_err(w, o)})")
        if w.is_floating_point():
            errs[kname] = max(errs[kname], max_abs_err(w, o))
    return len(pairs)


# The registry entry of the HEADLINE's family (per-leaf Top-K over the
# all-gather, grace_tpu/analysis/configs.py's topk-allgather): the static
# overlap bound [32]'s capture is held under.
HEADLINE_REGISTRY_ENTRY = "topk-allgather"


def profiling_read_side(logdir: str, analysis, tmp: Path, docs: Path,
                        smi: str) -> dict:
    """[32]'s capture through ``python -m grace_tpu_torch.profiling``: the
    stage table and device total exactly the in-process ``analyze_trace``
    reading's, the overlap sandwich against the HEADLINE's registry entry
    holding, its own baseline clean (exit 0) and that baseline with every
    stage's ms halved a regression (exit 1). The document goes to
    ``docs/PROF_LAST.json``. Returns the command lines' wall seconds."""
    seconds: dict = {}
    module = "grace_tpu_torch.profiling"
    base = tmp / "prof_baseline.json"
    doc = json.loads(read_side_cli(
        "[32]", module, "--trace", logdir, "--json", "--overlap-config",
        HEADLINE_REGISTRY_ENTRY, "--write-baseline", str(base), "--out",
        str(docs / "PROF_LAST.json"), smi=smi, seconds=seconds))
    want = analysis.as_dict()
    sandwich = doc.get("overlap_sandwich") or {}
    if doc["stages_ms"] != want["stages_ms"] \
            or doc["total_device_ms"] != want["total_device_ms"] \
            or sandwich.get("violations") != [] \
            or sandwich.get("static_overlap_bound") is None:
        fail(f"[32] python -m {module}: stages {doc['stages_ms']}, total "
             f"{doc['total_device_ms']} ms (in process: {want['stages_ms']}, "
             f"{want['total_device_ms']} ms); sandwich {sandwich}")
    read_side_cli("[32]", module, "--trace", logdir, "--baseline", str(base),
                  "--out", "", smi=smi, seconds=seconds)
    halved = json.loads(base.read_text())
    halved["stages_ms"] = {k: v / 2 for k, v in halved["stages_ms"].items()}
    halved_path = tmp / "prof_halved.json"
    halved_path.write_text(json.dumps(halved))
    out = read_side_cli("[32]", module, "--trace", logdir, "--baseline",
                        str(halved_path), "--out", "", expect=1, smi=smi,
                        seconds=seconds)
    log(f"[32c] python -m {module}: the stage table and device total "
        f"{doc['total_device_ms']} ms = analyze_trace's in process; overlap "
        f"sandwich vs {HEADLINE_REGISTRY_ENTRY}: measured "
        f"{sandwich['measured_overlap']} <= static bound "
        f"{sandwich['static_overlap_bound']} (+{sandwich['slack']}): holds; "
        f"its own baseline clean, the halved one "
        f"{sum('REGRESSION' in l for l in out.splitlines())} regression(s)")
    return seconds


def mesh_profiling_phase(dev, group, x, y, runs, errs, smi,
                         docs_dir=None) -> None:
    """Phase 32 (module docstring): the HEADLINE on a 1×1 dp×fsdp mesh
    against [5]'s 1-D steps, shard 0 of real gradients through the 2-D
    transform and the chunk kernels, and one 2-D step read back through the
    ported profiler, in process and through its command line (whose
    document goes to ``docs_dir``, default a temporary directory)."""
    import tempfile

    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.parallel import make_mesh
    from grace_tpu_torch.profiling import (ProfileRecorder, analyze_trace,
                                           device_memory_watermarks,
                                           find_latest_trace,
                                           load_trace_events)
    from grace_tpu_torch.telemetry import JSONLSink
    from grace_tpu_torch.transform import leaf_order

    t0 = time.perf_counter()
    want = {"chunk_compress_feedback": WARMUP_STEPS + TIMED_STEPS,
            "chunk_aggregate_dense": WARMUP_STEPS + TIMED_STEPS}
    mesh = make_mesh((1, 1), ("data", "fsdp"), group=group)
    if mesh.dp_group is not group or (mesh.dp_index, mesh.fsdp_index) != \
            (0, 0):
        fail(f"[32] the 1×1 mesh's dp group is not the world group "
             f"({mesh})")
    # -- 32a: the 2-D HEADLINE against [5]'s 1-D steps ----------------------
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        one_d, _, loss_1d, launches_1d = _mesh_headline_run(dev, group, x, y)
        want_bits = _mesh_state_bits(one_d)
        del one_d
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tmp = tempfile.mkdtemp(prefix="grace_mesh_")
        sink_path = os.path.join(tmp, "profile.jsonl")
        rec = ProfileRecorder(JSONLSink(sink_path), every=1000,
                              warmup=WARMUP_STEPS)
        two_d, step, loss_2d, launches = _mesh_headline_run(
            dev, group, x, y, mesh=mesh, recorder=rec)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
    launches_1d = {k: v for k, v in launches_1d.items() if v}
    launches = {k: v for k, v in launches.items() if v}
    for label, got in (("1-D", launches_1d), ("2-D", launches)):
        if got != want:
            fail(f"[32] the {label} HEADLINE launched {got} over "
                 f"{WARMUP_STEPS + TIMED_STEPS} steps, expected {want}")
    if not same_bits(loss_1d, loss_2d):
        fail(f"[32] the 2-D losses {loss_2d.tolist()} differ from the 1-D "
             f"{loss_1d.tolist()}")
    got_bits = _mesh_state_bits(two_d)
    if set(got_bits) != set(want_bits):
        fail("[32] the 2-D state's tensors are not the 1-D state's")
    for path, w in want_bits.items():
        if not same_bits(got_bits[path], w):
            fail(f"[32] {path} after {WARMUP_STEPS + TIMED_STEPS} steps "
                 f"differs between the 2-D and the 1-D run")
    p50_ms = rec.timer.p50_sec * 1e3
    runs["mesh_1x1_topk1pct"] = {"launches": launches,
                                 "steps": WARMUP_STEPS + TIMED_STEPS,
                                 "p50_ms": p50_ms,
                                 "losses": loss_2d.tolist()}
    log(f"[32a] topk1pct on the 1×1 mesh (make_mesh over NCCL, "
        f"make_train_step(mesh=...)) = [5]'s 1-D steps re-run with cuDNN "
        f"deterministic, bit for bit over {WARMUP_STEPS + TIMED_STEPS} "
        f"steps: losses {loss_2d[0].item():.4f} -> {loss_2d[-1].item():.4f} "
        f"([5]: {runs['topk1pct']['first_loss']:.4f} -> "
        f"{runs['topk1pct']['last_loss']:.4f}), {len(got_bits)} tensors "
        f"(parameters, BatchNorm statistics, residuals); launches {launches}")
    # -- 32b: shard 0 of real gradients through the 2-D transform ----------
    grads = resnet50_leaf_grads(dev, count=1)[0]
    shards, split = {}, 0
    for n, g in grads.items():
        if g.shape[-1] >= 2 and g.shape[-1] % 2 == 0:
            shards[n] = g.narrow(-1, 0, g.shape[-1] // 2).contiguous()
            split += 1
        else:
            shards[n] = g
    del grads
    tx = grace_from_params({**HEADLINE[1]["params"], "fsdp_axis": "fsdp"},
                           group=mesh).transform(seed=SEED)
    st = tx.init(shards)
    names = leaf_order(shards)
    for n, m in zip(names, st.mem):
        if m is None or tuple(m.shape) != tuple(shards[n].shape):
            fail(f"[32] shard 0's residual of {n} is "
                 f"{None if m is None else tuple(m.shape)}, expected the "
                 f"shard's {tuple(shards[n].shape)}")
    torch.cuda.synchronize()
    ops.reset_launch_counts()                 # just before the shard path
    tx.update({n: g.clone() for n, g in shards.items()}, st)
    torch.cuda.synchronize()
    shard_launches = {k: v for k, v in ops.launch_counts().items()
                      if v}                   # just after it
    if shard_launches != {k: 1 for k in want}:
        fail(f"[32] the shard-0 update launched {shard_launches}, expected "
             "one of each chunk kernel")
    runs["mesh_shard0_update"] = {"launches": shard_launches, "steps": 1}
    cases = check_shard_kernels(dev, [shards[n] for n in names], errs)
    half = sum(g.numel() for g in shards.values())
    log(f"[32b] shard 0 of real ResNet-50 gradients ({split} of "
        f"{len(shards)} leaves split on their last axis, {half} elements): "
        f"residuals of the shard shapes, one launch of each chunk kernel, "
        f"both kernels bit for bit against their plain versions in {cases} "
        "cases")
    del shards, st
    torch.cuda.empty_cache()
    # -- 32c: one 2-D step through the ported profiler ----------------------
    from grace_tpu_torch.utils.profiling import trace
    warm_profiler()
    logdir = os.path.join(tmp, "trace")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with trace(logdir, device=dev) as prof:
        two_d, _ = step(two_d, (x, y))
    profiled = {k: v for k, v in ops.launch_counts().items() if v}
    if profiled != {k: 1 for k in want}:
        fail(f"[32] the profiled 2-D step launched {profiled}, expected one "
             "of each chunk kernel")
    path = find_latest_trace(logdir)
    if path is None:
        fail(f"[32] utils.profiling.trace wrote no trace under {logdir}")
    analysis = analyze_trace(logdir)
    events = device_events(prof)
    ev_ms = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in events) / 1e3
    total_ms = analysis.total_us / 1e3
    spans = load_trace_events(path)
    lanes = sorted({(s.device, s.lane) for s in spans if s.cat == "kernel"})
    kernels = [s for s in spans if s.cat == "kernel"]
    staged = sum(1 for s in kernels if s.stage())
    ranges_ms = sum(s.dur for s in spans if s.cat == "gpu_user_annotation"
                    and not s.stage()) / 1e3
    if not analysis.device_lanes_detected or not any(
            s.stage() for s in spans if s.cat == "kernel"):
        fail(f"[32] the analyzer found no device lane or attributed no "
             f"kernel to a grace/ stage (kernel lanes {lanes})")
    rel = abs(total_ms - ev_ms) / max(ev_ms, 1e-9)
    why = "" if rel <= 0.02 else (
        f"; not within 2%: device_events sums the profiler's CUDA rows, "
        f"which hold {ranges_ms:.3f} ms of non-grace gpu_user_annotation "
        f"ranges (the optimizer's) that the analyzer leaves out")
    log(f"[32c] {smi}: one 2-D step under utils.profiling.trace "
        f"({os.path.basename(path)}, {len(spans)} spans, kernel lanes "
        f"{lanes}, {staged} of {len(kernels)} kernels attributed to a "
        f"grace/ stage); analyze_trace:")
    for line in analysis.render().splitlines():
        log(f"      {line}")
    log(f"[32c] {smi}: analyzer device total {total_ms:.3f} ms against "
        f"device_events' {ev_ms:.3f} ms over {sum(e.count for e in events)} "
        f"CUDA rows ({100 * rel:.2f}% apart){why}; overlap fraction "
        f"{analysis.overlap_fraction}")
    cli_seconds = profiling_read_side(logdir, analysis, Path(tmp),
                                      Path(docs_dir or tmp), smi)
    rec.flush(WARMUP_STEPS + TIMED_STEPS - 1)
    rec.close()
    with open(sink_path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    mem = device_memory_watermarks()
    peak = torch.cuda.max_memory_allocated(dev)
    if mem is None or mem["peak_bytes_in_use"] != peak:
        fail(f"[32] device_memory_watermarks {mem} against "
             f"max_memory_allocated {peak}")
    log(f"[32c] {smi}: StepTimer p50 over the {TIMED_STEPS} timed 2-D steps "
        f"{p50_ms:.3f} ms; device_memory_watermarks peak "
        f"{mem['peak_bytes_in_use'] / 1e9:.3f} GB = max_memory_allocated "
        f"{peak / 1e9:.3f} GB (in use {mem['bytes_in_use'] / 1e9:.3f} GB)")
    for r in records:
        if r.get("event") != "perf_step_times" or "sync_missing" in r:
            continue
        log(f"[32c] ProfileRecorder flush record: {json.dumps(r)}")
        break
    else:
        fail(f"[32] no synchronised perf_step_times record in {records}")
    runs["mesh_1x1_topk1pct"].update(
        profiled_launches=profiled, analyzer_total_ms=total_ms,
        device_events_ms=ev_ms, overlap_fraction=analysis.overlap_fraction,
        stages_ms=analysis.as_dict()["stages_ms"],
        peak_mem_gb=peak / 1e9, cli_seconds=cli_seconds)
    log(f"[32] {time.perf_counter() - t0:.1f} s")


@functools.cache
def warm_profiler() -> None:
    """One short profiler session, once a process: the first session of a
    process has recorded few of its launches or none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()


def kernel_device_ms(fn, kernel_name: str, runs: int = TIMING_RUNS,
                     launches_per_call: int = 1, cold: bool = False):
    """The device time of the CUDA kernel named ``kernel_name`` in one call
    of ``fn`` (which launches it ``launches_per_call`` times), from
    ``runs`` calls under torch.profiler: the kernel alone, without the
    host's enqueue that a CUDA-event pair around one call also holds when
    the host is the slower. The mean is over the launches the profiler
    recorded, which can miss one at the edge of the window. With ``cold``
    the L2 is flushed before each call (flush_l2, a kernel of another
    name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    warm_profiler()
    if cold:
        fn = (lambda call: lambda: (flush_l2(), call()))(fn)
    fn()
    torch.cuda.synchronize()
    want = runs * launches_per_call
    for attempt in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in device_events(prof) if kernel_name in e.key]
        seen = sum(e.count for e in hits)
        if want // 2 <= seen <= want:
            break
        # A profiler session now and then records few launches or none (the
        # first session of a process most of all, and on a fast host
        # several in a row); a short session first, as at the start of a
        # process, then another session measures the same calls.
        log(f"  (the profiler recorded {seen} launches of {kernel_name} in "
            f"{runs} calls of {launches_per_call}; profiling them again)")
        warm_profiler.__wrapped__()
        time.sleep(0.1 * (attempt + 1))
    if not want // 2 <= seen <= want:
        kernels = sorted({e.key[:60] for e in device_events(prof)})
        fail(f"the profiler saw {seen} launches of {kernel_name} in {runs} "
             f"calls of {launches_per_call} (kernels it saw: {kernels})")
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in hits)
    return total / seen * launches_per_call / 1e3


def times_from(root: str) -> int:
    """``--times-from ROOT``: phase 3's, 8's and 12's timings alone, of
    the kernels and wrappers of the checkout at ROOT (an earlier commit
    unpacked with ``git archive``), for a comparison inside one call.
    Prints one JSON line."""
    import torch
    sys.path.insert(0, str(Path(root).resolve()))
    import grace_tpu_torch
    if not grace_tpu_torch.__file__.startswith(str(Path(root).resolve())):
        fail(f"--times-from {root}: imported {grace_tpu_torch.__file__}")
    from grace_tpu_torch.ops import _build
    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    leaves = resnet50_leaves()
    log(f"[3] the kernels of {root}: chunk Top-K times")
    times = time_kernels(dev, leaves)
    (flat,) = resnet50_flat_grads(dev, count=1)
    log(f"[8] the kernels of {root}: wire-path times (flat n={flat.numel()})")
    wire_times = time_wire_kernels(dev, leaves, flat)
    log(f"[12] the kernels of {root}: packed_int_accumulate times")
    print(json.dumps({"times_from": root, "times": times,
                      "wire_times": wire_times,
                      "accum_times": time_accum_kernel(dev, flat)}))
    print(nvidia_smi_line(), flush=True)
    return 0


# -- phase 33 -----------------------------------------------------------------

AUDIT_TIMEOUT_S = 240
# The registry's children a route (--shard I/N), and its entries.
REGISTRY_SHARDS = 3
REGISTRY_ENTRIES = 79
# The registry's guard (grace_tpu/analysis/configs.py's train entries).
GUARD_33 = {"fallback_after": 3, "fallback_steps": 8}
# Allocator rounding: each state tensor's block is a multiple of 512 B.
ALLOC_ROUND = 512


def _audit_cli(out_dir: Path, name: str, *args: str) -> subprocess.Popen:
    """``python -m grace_tpu_torch.analysis ... --json <out>/<name>.json``
    started (not waited for), from the repository root."""
    return subprocess.Popen(
        [sys.executable, "-m", "grace_tpu_torch.analysis", *args,
         "--json", str(out_dir / f"{name}.json")],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def static_audit_phase(dev, group, x, y, runs, smi, docs_dir=None) -> None:
    """Phase 33 (module docstring). Every audit runs in a child process:
    the auditor owns a fake default process group, which this process's
    NCCL group excludes. The first registry shard on the card's route also
    writes its ``LINT_LAST.json`` evidence document to ``docs_dir``
    (default: a temporary directory)."""
    import tempfile

    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.analysis.flow import footprint_model
    from grace_tpu_torch.models.resnet import resnet50

    t0 = time.perf_counter()
    headline = json.dumps(HEADLINE[1]["params"])
    guarded = json.dumps({**HEADLINE[1]["params"], "escape": "fp16"})
    consensus = WATCH_ROWS[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        lint_doc = Path(docs_dir or tmp) / "LINT_LAST.json"
        procs = {
            "w8": _audit_cli(out, "w8", "--params", headline, "--model",
                             "resnet50", "--world", "8"),
            "w1": _audit_cli(out, "w1", "--params", headline, "--model",
                             "resnet50", "--world", "1"),
            "audit_w1": _audit_cli(
                out, "audit_w1", "--params", json.dumps(
                    {**consensus["params"], "consensus": {"audit_every": 1}}),
                "--mode", "train", "--guard", json.dumps(consensus["guard"]),
                "--world", "1"),
            # The guarded HEADLINE train step at ResNet-50 width, as rank 0
            # and as rank W-1 (each against the other in the state passes).
            **{f"train_r{r}": _audit_cli(
                out, f"train_r{r}", "--params", guarded, "--mode", "train",
                "--guard", json.dumps(GUARD_33), "--model", "resnet50",
                "--world", "8", "--rank", str(r)) for r in (0, 7)},
            # The registry on each route, all ten passes and the repo
            # rules, in shards.
            **{f"{d}{i}": _audit_cli(
                out, f"{d}{i}", "--all-configs", "--device", d, "--rules",
                "--shard", f"{i}/{REGISTRY_SHARDS}",
                *(("--evidence", str(lint_doc)) if (d, i) == ("cuda", 0)
                  else ()))
               for d in ("cpu", "cuda") for i in range(REGISTRY_SHARDS)},
        }
        # The real side while the children trace: one HEADLINE step on the
        # card, its launches and synchronizing calls, and init's memory.
        model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
        named = dict(model.named_parameters())
        loss_fn(model, (x, y)).backward()
        grads = {k: p.grad.detach().clone() for k, p in named.items()}
        model.zero_grad(set_to_none=True)
        grace = grace_from_params(HEADLINE[1]["params"], group=group)
        tx = grace.transform(seed=SEED)
        torch.cuda.synchronize()
        stats0 = torch.cuda.memory_stats(dev)
        state = tx.init(named)
        torch.cuda.synchronize()
        stats1 = torch.cuda.memory_stats(dev)
        # Requested bytes are the tensors' sizes; allocated bytes also hold
        # the allocator's rounding (a large-pool block is not split when
        # less than 1 MB would remain).
        requested, grown = (stats1[k] - stats0[k] for k in (
            "requested_bytes.all.current", "allocated_bytes.all.current"))
        structs = {k: (tuple(p.shape), p.dtype) for k, p in named.items()}
        model_fp = footprint_model(grace, structs)
        # The fake branch's whole cost on a real tensor: the one check
        # every wrapper call now makes first.
        from timeit import timeit

        from grace_tpu_torch.ops.fake import is_fake
        leaf = grads["fc.w"]
        check_us = timeit(lambda: is_fake(leaf), number=100_000) * 10
        ops.reset_launch_counts()                 # just before the step
        _, step_syncs = _sync_count(lambda: tx.update(grads, state))
        torch.cuda.synchronize()
        step_launches = ops.launch_counts()       # just after it
        step_launches = {k: v for k, v in step_launches.items() if v}
        del model, named, grads, state
        torch.cuda.empty_cache()
        docs = {}
        for key, proc in procs.items():
            text, _ = proc.communicate(timeout=AUDIT_TIMEOUT_S)
            path = out / f"{key}.json"
            if not path.exists():
                raise SystemExit(f"[33] the {key} audit wrote nothing "
                                 f"(exit {proc.returncode}):\n{text[-2000:]}")
            docs[key] = json.loads(path.read_text())
            docs[key]["returncode"] = proc.returncode
        lint = json.loads(lint_doc.read_text()) if lint_doc.exists() else {}
    if lint.get("errors") != 0 or lint.get("findings") != [] \
            or lint.get("configs_audited") != docs["cuda0"]["configs_audited"] \
            or lint.get("rules_checked") != 4 \
            or any(lint.get("pass_counts", {"?": 1}).values()):
        raise SystemExit(f"[33] the cuda0 shard's --evidence document: "
                         f"{ {k: lint.get(k) for k in ('errors', 'configs_audited', 'rules_checked', 'pass_counts')} }")
    # (a) the HEADLINE at ResNet-50 width, W=8, the card's route.
    w8 = docs["w8"]["configs"]["adhoc"]
    base8 = w8["branches"]["base"]
    want = {"chunk_compress_feedback": 1, "chunk_aggregate_dense": 1}
    if docs["w8"]["returncode"] or docs["w8"]["errors"]:
        raise SystemExit(f"[33] the W=8 HEADLINE audit has findings: "
                         f"{w8['findings']}")
    if base8["kernels"] != want or base8["host_reads"]:
        raise SystemExit(f"[33] the W=8 HEADLINE trace launches "
                         f"{base8['kernels']} with {base8['host_reads']} "
                         f"host reads; want {want} and none")
    if base8["recv_bytes"] != w8["model_bytes"]:
        raise SystemExit(f"[33] the W=8 HEADLINE moves {base8['recv_bytes']}"
                         f" B a rank, the wire model says {w8['model_bytes']}")
    # (b) the W=1 trace against the real step; the audit step's one read.
    base1 = docs["w1"]["configs"]["adhoc"]["branches"]["base"]
    if base1["kernels"] != step_launches or base1["syncs"] != step_syncs:
        raise SystemExit(f"[33] the W=1 trace launches {base1['kernels']} "
                         f"with {base1['syncs']} card syncs; the real step "
                         f"{step_launches} with {step_syncs} flagged calls")
    # (b') the guarded step at ResNet-50 width, as rank 0 and rank W-1.
    trains = {}
    for r in (0, 7):
        doc = docs[f"train_r{r}"]
        rep = doc["configs"]["adhoc"]
        if doc["returncode"] or rep["findings"] or doc["rank"] != r \
                or len(doc["passes_run"]) != 10:
            raise SystemExit(f"[33] the guarded HEADLINE train step as rank "
                             f"{r} has findings over {doc['passes_run']}: "
                             f"{rep['findings']}")
        if rep["branches"]["base"]["kernels"] != want:
            raise SystemExit(f"[33] the guarded train step as rank {r} "
                             f"launches {rep['branches']['base']['kernels']}"
                             f"; want {want}")
        trains[r] = {"branches": sorted(rep["branches"]),
                     "kernels": rep["branches"]["base"]["kernels"],
                     "recv_bytes": rep["branches"]["base"]["recv_bytes"],
                     "trace_s": doc["seconds"]}
    audit1 = docs["audit_w1"]["configs"]["adhoc"]["branches"]["audit"]
    audit_real = runs["phase29_audit_cost"]["resnet50"]["audit_syncs"]
    if audit1["syncs"] != audit_real or audit1["syncs"] != 1:
        raise SystemExit(f"[33] phase29_consensus's traced audit step syncs "
                         f"{audit1['syncs']} times ({audit1['sync_sites']}); "
                         f"[29]'s audit made {audit_real} flagged calls")
    # (c) the footprint model against init's real allocations.
    device_model = (model_fp["mem_bytes"] + model_fp["comp_bytes"]
                    + model_fp["telem_bytes"])
    slack = ALLOC_ROUND * docs["w1"]["configs"]["adhoc"]["state_tensors"]
    if not device_model <= requested <= device_model + slack \
            or grown < requested:
        raise SystemExit(f"[33] init requested {requested} B (allocated "
                         f"{grown} B); the footprint model says "
                         f"{device_model} B (+{slack} B slack)")
    # (d) the registry on both routes, ten passes and the rules, clean.
    route = {d: {"findings": [f for i in range(REGISTRY_SHARDS)
                              for f in docs[f"{d}{i}"]["findings"]],
                 "configs": sum(docs[f"{d}{i}"]["configs_audited"]
                                for i in range(REGISTRY_SHARDS)),
                 "rules": min(docs[f"{d}{i}"]["rules_checked"]
                              for i in range(REGISTRY_SHARDS)),
                 "passes": sorted({p for i in range(REGISTRY_SHARDS)
                                   for p in docs[f"{d}{i}"]["passes_run"]}),
                 "seconds": max(docs[f"{d}{i}"]["seconds"]
                                for i in range(REGISTRY_SHARDS))}
             for d in ("cpu", "cuda")}
    for d, v in route.items():
        if v["findings"] or v["configs"] != REGISTRY_ENTRIES \
                or v["rules"] != 4 or len(v["passes"]) != 10:
            raise SystemExit(f"[33] the registry on the {d} route: "
                             f"{v['configs']} configs, {v['rules']} rules, "
                             f"passes {v['passes']}, findings "
                             f"{v['findings']}")
    log(f"[33] python -m grace_tpu_torch.analysis --all-configs --device "
        f"cuda --rules --shard 0/{REGISTRY_SHARDS} --evidence "
        f"LINT_LAST.json: {lint['configs_audited']} configs, "
        f"{lint['rules_checked']} rules, {lint['errors']} errors, overlap "
        f"bounds {lint['overlap_bounds']}; the shard traced in "
        f"{docs['cuda0']['seconds']:.2f} s | {smi}")
    seconds = time.perf_counter() - t0
    runs["phase33_static_audit"] = {
        "launches": {}, "seconds": seconds,
        "headline_w8": {"kernels": base8["kernels"],
                        "host_reads": base8["host_reads"],
                        "recv_bytes": base8["recv_bytes"],
                        "model_bytes": w8["model_bytes"],
                        "trace_s": w8["seconds"]},
        "headline_w1": {"kernels": base1["kernels"],
                        "syncs": base1["syncs"],
                        "real_launches": step_launches,
                        "real_flagged_syncs": step_syncs},
        "audit_step_w1": {"syncs": audit1["syncs"],
                          "sites": audit1["sync_sites"],
                          "real_flagged_syncs": audit_real},
        "fake_check_us": check_us,
        "footprint": {"model_device_bytes": device_model,
                      "init_requested_bytes": requested,
                      "init_allocated_bytes": grown, "slack_bytes": slack},
        "guarded_train_w8": trains,
        "registry": {d: {"configs": v["configs"], "rules": v["rules"],
                         "passes": len(v["passes"]),
                         "findings": len(v["findings"]),
                         "seconds": v["seconds"]}
                     for d, v in route.items()}}
    log(f"[33] HEADLINE at W=8 on the card's route: {base8['kernels']}, "
        f"{base8['host_reads']} host reads, {base8['recv_bytes']} B a rank "
        f"= the model's {w8['model_bytes']} B (traced in {w8['seconds']:.1f} "
        f"s); W=1: {base1['kernels']} and {base1['syncs']} syncs = the real "
        f"step's {step_launches} and {step_syncs} flagged calls; the audit "
        f"step: {audit1['syncs']} sync = [29]'s {audit_real}; init "
        f"requested {requested} B (allocated {grown} B) for the model's "
        f"{device_model} B; the guarded step at ResNet-50 width as rank 0 "
        f"and rank 7: {trains[0]['kernels']} and {trains[7]['kernels']}, 0 "
        f"findings over 10 passes (branches {trains[0]['branches']}; "
        f"{trains[0]['trace_s']:.1f}, {trains[7]['trace_s']:.1f} s); the "
        f"registry ({route['cuda']['configs']} configs, 10 passes, 4 repo "
        f"rules) has 0 findings on both routes (cpu "
        f"{route['cpu']['seconds']:.1f} s, cuda "
        f"{route['cuda']['seconds']:.1f} s a shard); the wrappers' fake "
        f"check costs {check_us:.3f} µs a call; phase {seconds:.1f} s | "
        f"{smi}")


# -- phase 34 -----------------------------------------------------------------

TUNE_TIMEOUT_S = 300
# The measured candidates named besides the shortlist, with the kernels
# each must launch: the kernel twin of the packed qsgd4 ring, and the
# bucketed chunk Top-K all-gather (the HEADLINE's two chunk kernels).
TUNE_INCLUDE = {
    "tune-qsgd4-ring-packed-bucketed-pallas": ("quantize_pack_stochastic",),
    "tune-topk1pct-allgather-bucketed": ("chunk_compress_feedback",
                                         "chunk_aggregate_dense")}


def _tune_cli(out_dir: Path, name: str, *args: str) -> subprocess.Popen:
    """``python -m grace_tpu_torch.tuning ... --out <out>/<name>.json``
    started (not waited for), from the repository root."""
    return subprocess.Popen(
        [sys.executable, "-m", "grace_tpu_torch.tuning", *args,
         "--out", str(out_dir / f"{name}.json")],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def start_measured_tune(out: Path) -> subprocess.Popen:
    """[34]'s measured tune (the W8 shortlist and the named candidates on
    the card), started ahead of phase 33: it needs the card and little of
    the host, so it runs while [33]'s audits trace. Its winner goes to the
    evidence ledger ``out/ledger.jsonl`` ([35] reads it)."""
    return _tune_cli(out, "measured", "--topology", "8",
                     *(a for n in TUNE_INCLUDE for a in ("--include", n)),
                     "--ledger", str(out / "ledger.jsonl"))


def tuner_phase(runs, smi, measured_proc: subprocess.Popen,
                out: Path) -> None:
    """Phase 34 (module docstring): the tuner in processes of its own (its
    static stage traces over a fake default process group, and its
    measured stage makes a one-rank NCCL group of its own):
    ``measured_proc`` (:func:`start_measured_tune`) and the static funnel
    at ResNet-50 width, both writing into ``out``."""
    t0 = time.perf_counter()
    procs = {"static": _tune_cli(out, "static", "--static-only", "--model",
                                 "resnet50", "--topology", "8",
                                 "--topology", "256,8"),
             "measured": measured_proc}
    docs, texts = {}, {}
    for key, proc in procs.items():
        texts[key], _ = proc.communicate(timeout=TUNE_TIMEOUT_S)
        path = out / f"{key}.json"
        if not path.exists():
            raise SystemExit(f"[34] the {key} tuner wrote nothing (exit "
                             f"{proc.returncode}):\n{texts[key][-3000:]}")
        docs[key] = json.loads(path.read_text())
        docs[key]["returncode"] = proc.returncode
    static, measured = docs["static"], docs["measured"]
    for label, st in static["static"].items():
        c = st["counts"]
        log(f"[34] static funnel at ResNet-50 width, {label} (the port's "
            f"H100 cost model): {c['enumerated']} enumerated, "
            f"{c['capability_rejected']} capability, {c['numeric_rejected']} "
            f"numeric, {c['degradation_rejected']} degradation rejected, "
            f"{c['priced']} priced, {c['flow_rejected']} flow rejected; "
            f"shortlist {st['shortlist']}")
    if static["returncode"] or not static["ok"] or not all(
            st["shortlist"] for st in static["static"].values()):
        raise SystemExit(f"[34] the static funnel failed:\n"
                         f"{texts['static'][-3000:]}")
    m = measured.get("measured") or {}
    rows = {r["candidate"]: r for r in m.get("rows", ())}
    for r in rows.values():
        log(f"[34] {r['candidate']}: measured {r['measured_step_ms']:.4f} "
            f"ms a step (dense {r['baseline_step_ms']:.4f}; samples "
            f"{r['samples_ms']}) -> projected {r['projected_step_ms']:.4f} "
            f"ms at W8; kernels {r['launches'] or 'none'} in "
            f"{r['steps_run']} steps")
    for r in m.get("skipped", ()):
        log(f"[34] {r['candidate']}: skipped ({r['reason']})")
    winner = measured.get("winner") or {}
    sandwich = winner.get("overlap_sandwich") or {}
    silent = {n: ks for n, ks in TUNE_INCLUDE.items()
              if not all(rows.get(n, {}).get("launches", {}).get(k)
                         for k in ks)}
    if measured["returncode"] or not measured["ok"] \
            or m.get("device", "").split(":")[0] != "cuda" \
            or not sandwich.get("holds") or silent:
        raise SystemExit(f"[34] the measured tune failed (ok "
                         f"{measured['ok']}, sandwich {sandwich}, kernels "
                         f"not launched {silent}):\n"
                         f"{texts['measured'][-3000:]}")
    launches: dict = {}
    for r in rows.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    seconds = time.perf_counter() - t0
    runs["phase34_tune"] = {
        "launches": launches, "seconds": seconds,
        "static": {label: {"counts": st["counts"],
                           "shortlist": st["shortlist"],
                           "head": st["ranking"][:3]}
                   for label, st in static["static"].items()},
        "measured": {n: {k: r[k] for k in (
            "measured_step_ms", "baseline_step_ms", "samples_ms",
            "projected_step_ms", "launches", "steps_run")}
            for n, r in rows.items()},
        "winner": winner.get("candidate"), "sandwich": sandwich,
        "measured_world": m.get("measured_world")}
    log(f"[34] winner {winner['candidate']}: measured "
        f"{winner['measured']['measured_step_ms']:.4f} ms, projected "
        f"{winner['measured']['projected_step_ms']:.4f} ms at W8; overlap "
        f"sandwich: measured {sandwich['measured_overlap']} <= static bound "
        f"{sandwich['static_overlap_bound']} (+{sandwich['slack']}): holds; "
        f"kernels {launches}; phase {seconds:.1f} s after [33] (the "
        f"measured tune ran beside [33]) | {smi}")


# -- phase 35 -----------------------------------------------------------------

RETUNE_WINDOW = 5                  # steps a drift window (and the ladder's)
RETUNE_PROBATION = 5               # steps of probation after a cutover
# The drift: every sent value lane scaled by 1 - RETUNE_DRIFT_SCALE (0: an
# encoder that sends nothing, the compression error at its ceiling of 1).
# The telemetry's error is relative (||g - decompress(compress(g))|| /
# ||g||), and a Top-K at ratio r keeps at least the fraction r of the
# energy, so a healthy topk1pct window's mean is at most sqrt(1 - 0.01):
# RETUNE_DRIFT_ERROR, the controller's absolute threshold (drift_error).
# JAX's drill's relative factor (1.4x the baseline) cannot fire on an error
# this close to its ceiling; it stays armed beside the threshold.
RETUNE_DRIFT_SCALE = 1.0
RETUNE_DRIFT_ERROR = math.sqrt(1.0 - HEADLINE[1]["params"]["compress_ratio"])
RETUNE_DRIFT_FACTOR = 1.4
RETUNE_AUDIT_EVERY = 5
RETUNE_GUARD_KW = {"fallback_after": 3, "fallback_steps": 4}
RETUNE_LEG_TIMEOUT_S = 120.0
RETUNE_DRIFT_WINDOWS = 4           # drifting windows allowed before failing
# SGD with momentum: the optimizer has per-parameter state for PREPARE to
# carry, the checkpoint to hold and the demotion to restore.
RETUNE_SGD = {"lr": 1e-3, "momentum": 0.9}
_NO_LAUNCHES: dict = {}


def _retune_params():
    """The drill's incumbent (the HEADLINE's topk1pct with the fp16 escape,
    telemetry with the compression error and the audit every 5) and JAX's
    candidate (tests/test_retune.py:326-330: PowerSGD rank 4 with a rank-1
    ladder), on the same escape, telemetry and audit."""
    from grace_tpu_torch.resilience import ConsensusConfig

    consensus = ConsensusConfig(audit_every=RETUNE_AUDIT_EVERY)
    common = {"escape": "fp16", "telemetry": GUARD_PARAMS["telemetry"],
              "consensus": consensus}
    incumbent = {**HEADLINE[1]["params"], **common}
    candidate = {"compressor": "powersgd", "compress_rank": 4,
                 "memory": "powersgd", "communicator": "allreduce",
                 **common, "adapt": {"window": RETUNE_WINDOW,
                                     "ladder": [{"compress_rank": 1}]}}
    return incumbent, candidate


def evidence_read_side(root: Path, ledger: Path, claims: Path, has_git,
                       unresolvable, out: Path, docs: Path, drill_path: Path,
                       smi: str) -> dict:
    """[35]'s records through ``python -m grace_tpu_torch.evidence`` (the
    ``retune-drill`` citation MEASURED, or STALE only on the unresolvable
    rev of a tree without ``.git``), then ``python -m
    grace_tpu_torch.evidence.summary`` over ``docs``, which holds the
    LINT/PROF/WATCH documents of [29], [32] and [33] and gets [34]'s
    measured tune and [35]'s drill as TUNE/RETUNE: each section renders.
    Returns the command lines' wall seconds."""
    seconds: dict = {}
    gate = json.loads(read_side_cli(
        "[35]", "grace_tpu_torch.evidence", "--json", "--ledger",
        str(ledger), "--root", str(root), "--doc", str(claims), smi=smi,
        seconds=seconds))
    for rid in ("tune-winner", "retune-drill"):
        res = gate["records"].get(rid) or {}
        if not (res.get("status") == "MEASURED" or (
                not has_git and res.get("status") == "STALE"
                and res.get("failures") == unresolvable)):
            fail(f"[35] python -m grace_tpu_torch.evidence on {rid}: {res}")
    (docs / "TUNE_LAST.json").write_text((out / "measured.json").read_text())
    (docs / "RETUNE_LAST.json").write_text(drill_path.read_text())
    md = read_side_cli("[35]", "grace_tpu_torch.evidence.summary", "--root",
                       str(docs), "--ledger", str(ledger), smi=smi,
                       seconds=seconds)
    heads = ("Static analysis: `python -m grace_tpu_torch.analysis "
             "--all-configs`", "Performance attribution: `python -m "
             "grace_tpu_torch.profiling", "Run health (graft-watch): "
             "`python -m grace_tpu_torch.telemetry.watch",
             "Online re-tuning (graft-retune): `chip_smoke.py [35]`",
             "Autotuning (graft-tune): `grace_tpu_torch.tuning`")
    missing = [h for h in heads if h not in md]
    if missing:
        fail(f"[35] the summary over {sorted(p.name for p in docs.iterdir())}"
             f" lacks {missing}:\n{md[-3000:]}")
    log(f"[35] python -m grace_tpu_torch.evidence: "
        f"{ {rid: gate['records'][rid]['status'] for rid in ('tune-winner', 'retune-drill')} }"
        f"; python -m grace_tpu_torch.evidence.summary rendered "
        f"{len(heads)} sections over "
        f"{sorted(p.name for p in docs.iterdir())}:")
    for line in md.splitlines():
        if line.strip():
            log(f"    | {line[:240]}")
    return seconds


def retune_phase(dev, group, x, y, runs, smi, out: Path,
                 docs_dir=None) -> None:
    """Phase 35 (module docstring): the retune drill on the HEADLINE, the
    evidence records of [34] and [35] through the gate in process and
    through its command line, the summary's command line over
    ``docs_dir`` (default: ``out``)."""
    import torch
    from grace_tpu_torch import ops
    from grace_tpu_torch.checkpoint import Checkpointer
    from grace_tpu_torch.evidence import (IncidentRecorder, gate_report,
                                          latest_by_id, load_ledger,
                                          record_artifact)
    from grace_tpu_torch.evidence.incident import DEFAULT_TRIGGERS
    from grace_tpu_torch.evidence.ledger import git_head_rev
    from grace_tpu_torch.evidence.summary import sec_retune
    from grace_tpu_torch.models.resnet import resnet50
    from grace_tpu_torch.resilience import (RetuneController,
                                            replica_variants, state_digest)
    from grace_tpu_torch.resilience.smoke.retune import chaos_build
    from grace_tpu_torch.telemetry import (JSONLSink, MultiSink, Sink,
                                           TelemetryReader, Timeline)
    from grace_tpu_torch.train import (TrainState, init_stateful_train_state,
                                       make_stateful_train_step)
    from grace_tpu_torch.tuning.candidates import Candidate
    from grace_tpu_torch.utils.logging import GuardMonitor, run_provenance
    from grace_tpu_torch.utils.metrics import guard_report

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    incumbent, candidate = _retune_params()
    chaos = {"drift": False, "nan": False}
    # The run's chain factory is the drill's (python -m
    # grace_tpu_torch.resilience.smoke --retune): the chaos flags wrap the
    # codec and a ladder's rungs outside the controller.
    build = chaos_build(group, chaos, drift_scale=RETUNE_DRIFT_SCALE,
                        rank=0, seed=SEED, guard_kw=RETUNE_GUARD_KW,
                        tx_seed=SEED)

    def step_of(tx, p):
        return make_stateful_train_step(loss_fn, tx, group,
                                        consensus=p["consensus"])

    class Tape(Sink):
        def __init__(self):
            self.records = []

        def write(self, rec):
            self.records.append(dict(rec))

    tape = Tape()
    ledger = out / "ledger.jsonl"
    jsonl = out / "phase35.jsonl"
    prov = {"platform": "gpu", "device": smi, "n_devices": 1}
    # Two flight recorders on one stream: one opens an incident on every
    # trigger (each promotion and demotion), the other debounces at the
    # JAX package's default gap, as its drill runs.
    recorder = IncidentRecorder(str(out / "incidents"), run_tag="phase35",
                                min_gap_steps=0, ledger_path=str(ledger),
                                provenance=prov)
    debounced = IncidentRecorder(str(out / "incidents_debounced"),
                                 run_tag="phase35-debounced",
                                 ledger_path=str(ledger), provenance=prov)
    sink = MultiSink(JSONLSink(jsonl, provenance=run_provenance(
        "synthetic", tool="chip_smoke.py [35]")), tape, recorder, debounced)
    reader = TelemetryReader(sink, every=RETUNE_WINDOW)
    monitor = GuardMonitor(printer=lambda *a: None, sink=sink)
    ckpt = Checkpointer(out / "ckpt35", max_to_keep=2)
    ctl = RetuneController(
        build=build, params=incumbent, consensus=incumbent["consensus"],
        checkpointer=ckpt, sink=sink, window=RETUNE_WINDOW,
        drift_factor=RETUNE_DRIFT_FACTOR, drift_error=RETUNE_DRIFT_ERROR,
        drift_windows=2,
        probation_steps=RETUNE_PROBATION,
        leg_timeout_s=RETUNE_LEG_TIMEOUT_S, leg_retries=1, audit_world=8,
        group=group)

    model = resnet50(NUM_CLASSES, device=dev, seed=SEED)
    _, tx = build(incumbent)
    state = init_stateful_train_state(
        model, tx, torch.optim.SGD(model.parameters(), **RETUNE_SGD), group)
    steps = []                           # (label, step, launches)
    errors = []                          # (step, compression_error)
    clock = [0]

    def run(state, step_fn, n, label, observe=False):
        """``n`` steps (fewer when drift fires or probation trips):
        ``(state, loss, drift_step, trigger)``."""
        drift, trig, loss = None, None, None
        for _ in range(n):
            i = clock[0]
            clock[0] += 1
            before = ops.launch_counts()
            state, loss = step_fn(state, (x, y))
            now = ops.launch_counts()
            steps.append((label, i, {k: v - before.get(k, 0)
                                     for k, v in now.items()
                                     if v - before.get(k, 0)}))
            n0 = len(tape.records)
            monitor.update(i, guard_report(state))
            for row in reader.update(i, state):
                err = row.get("compression_error")
                errors.append((row["step"], err))
                if observe and ctl.observe(row["step"], err) \
                        and drift is None:
                    drift = int(row["step"])
            if ctl.phase == "probation":
                trig = ctl.watch(i, tape.records[n0:])
            if drift is not None or trig:
                break
        if not math.isfinite(float(loss)):
            fail(f"[35] {label}: non-finite loss {float(loss)}")
        return state, loss, drift, trig

    def promote(state, params, label):
        """PREPARE (the incumbent's digest unchanged) and COMMIT."""
        pre = state_digest(state)
        staged = ctl.prepare(clock[0], state, params)
        if staged is None:
            fail(f"[35] PREPARE aborted ({label}): {ctl.events[-1]}")
        if state_digest(state) != pre or staged.lkg_digest != pre:
            fail(f"[35] PREPARE ({label}) wrote the live state")
        legs = dict(ctl.leg_seconds)
        committed = ctl.commit(clock[0])
        if committed is None:
            fail(f"[35] COMMIT timed out ({label}): {ctl.events[-1]}")
        state, (_, tx), ev = committed
        legs["commit"] = ctl.leg_seconds["commit"]
        return state, tx, ev, staged, legs, pre

    # -- 1, 2: the incumbent, its baseline, then fleet drift ------------------
    ops.reset_launch_counts()             # just before the drill's main path
    step1 = step_of(tx, incumbent)
    state, _, _, _ = run(state, step1, 1, "warm-up")
    # Rows are windowed from step 0: the drift's onset on a window edge.
    state, _, drift, _ = run(state, step1, 2 * RETUNE_WINDOW - 1,
                             "incumbent", observe=True)
    if drift is not None:
        fail(f"[35] retune_drift at step {drift} on healthy windows: "
             f"errors {errors}")
    onset = clock[0]
    chaos["drift"] = True
    _, tx_drift = build(incumbent)
    chaos["drift"] = False
    state, _, drift, _ = run(state, step_of(tx_drift, incumbent),
                             RETUNE_DRIFT_WINDOWS * RETUNE_WINDOW, "drift",
                             observe=True)
    guard_skips = guard_report(state)["notfinite_count"]
    if drift is None or drift < onset or guard_skips:
        fail(f"[35] fleet drift from step {onset}: retune_drift at "
             f"{drift}, guard skips {guard_skips}; windows' errors {errors}")
    log(f"[35] drift: baseline window mean "
        f"{ctl.events[-1]['baseline']:.6f}, drifting window mean "
        f"{ctl.events[-1]['window_mean']:.6f} (threshold "
        f"{RETUNE_DRIFT_ERROR:.6f} or x{RETUNE_DRIFT_FACTOR} the baseline; "
        f"drift_scale {RETUNE_DRIFT_SCALE} from step {onset}): retune_drift "
        f"at step {drift}, the guard silent")

    # -- 3: propose ------------------------------------------------------------
    inc_triad = {k: v for k, v in incumbent.items()
                 if k not in ("escape", "telemetry", "consensus")}
    cand_params = {k: v for k, v in candidate.items() if k != "consensus"}
    include = [Candidate("retune-incumbent", inc_triad, "generated", True),
               Candidate("retune-candidate", cand_params, "generated")]
    t0 = time.perf_counter()
    funnel = ctl.propose(clock[0], "8", device=dev, model="toy",
                         shortlist_n=2, timed_steps=2, repeats=1, seed=SEED,
                         include=include)
    propose_s = time.perf_counter() - t0
    measure = [e for e in ctl.events if e["event"] == "retune_measure"]
    if not measure or not measure[-1]["measured"]:
        fail(f"[35] propose measured nothing: {ctl.events[-1]}")
    static = (funnel or {}).get("static") or {}
    log(f"[35] propose: the static funnel in a child process "
        f"({ctl.leg_seconds['funnel']:.1f} s; shortlist "
        f"{static.get('shortlist')}), the toy shortlist measured over the "
        f"live group: {measure[-1]['measured']} measured, "
        f"{measure[-1]['skipped']} skipped, winner "
        f"{measure[-1]['winner']}; {propose_s:.1f} s | {smi}")

    # -- 4: promote to JAX's candidate, a quiet probation ---------------------
    state, tx2, ev_fwd, staged_fwd, legs_fwd, _ = promote(
        state, candidate, "topk1pct -> powersgd ladder")
    variants_fwd = replica_variants(state, group)
    state, _, _, trig = run(state, step_of(tx2, candidate),
                            RETUNE_PROBATION + 1, "powersgd")
    if trig is not None or ctl.phase != "idle" or variants_fwd != 1:
        fail(f"[35] the forward promotion's probation: trigger {trig}, "
             f"phase {ctl.phase}, replica variants {variants_fwd}")

    # -- 5: promote back to topk1pct ------------------------------------------
    state, tx3, ev_back, staged_back, legs_back, _ = promote(
        state, incumbent, "powersgd ladder -> topk1pct")
    state, _, _, trig = run(state, step_of(tx3, incumbent),
                            RETUNE_PROBATION + 1, "topk1pct back")
    if trig is not None or ctl.phase != "idle":
        fail(f"[35] the back promotion's probation: trigger {trig}, phase "
             f"{ctl.phase}")
    healthy_guard = [r for r in tape.records
                     if str(r.get("event", "")).startswith("guard")]
    if healthy_guard:
        fail(f"[35] the guard fired in the healthy drill: {healthy_guard}")

    # -- 6: the sabotaged promotion, demoted ----------------------------------
    state.grace.settle()
    twin_model = copy.deepcopy(state.model)
    twin = TrainState(twin_model, torch.optim.SGD(twin_model.parameters(),
                                                  **RETUNE_SGD),
                      copy.deepcopy(state.grace))
    twin.optimizer.load_state_dict(
        copy.deepcopy(state.optimizer.state_dict()))
    chaos["nan"] = True
    try:
        state, tx_sab, ev_sab, staged_sab, legs_sab, witness = promote(
            state, candidate, "sabotaged powersgd ladder")
    finally:
        chaos["nan"] = False
    state, _, _, trig = run(state, step_of(tx_sab, candidate),
                            RETUNE_PROBATION + 1, "sabotaged")
    if trig is None:
        fail("[35] the sabotaged promotion survived its probation")
    # The demotion takes the trigger's step: the guard's record carries the
    # guard's own step count (guard_report's "step", the next step's).
    trig_step = [r["step"] for r in tape.records
                 if r.get("event") == trig][-1]
    within = trig_step < ev_sab["probation_until"]
    t0 = time.perf_counter()
    state, (_, tx4), ev_dem = ctl.demote(trig_step, state, trigger=trig)
    demote_ms = (time.perf_counter() - t0) * 1e3
    restored_digest = state_digest(state)
    if not (within and ev_dem["restored"] and ev_dem["bit_exact"]
            and restored_digest == witness):
        fail(f"[35] the demotion: within probation {within}, {ev_dem}, "
             f"digest {restored_digest} against the witness {witness}")
    # One topk1pct step after the demotion against the twin's, cuDNN
    # deterministic on both sides.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state, loss_a, _, _ = run(state, step_of(tx4, incumbent), 1,
                                  "after demotion")
        _, twin_tx = build(incumbent)
        twin, loss_b = step_of(twin_tx, incumbent)(twin, (x, y))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    compared = 0
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              twin.model.state_dict().items()):
        if not same_bits(a.cpu(), b.cpu()):
            fail(f"[35] after the demotion, {k} differs from the twin's")
        compared += 1
    for i, (a, b) in enumerate(zip(state.grace.inner.mem,
                                   twin.grace.inner.mem)):
        if not same_bits(a.cpu(), b.cpu()):
            fail(f"[35] after the demotion, residual {i} differs from the "
                 "twin's")
        compared += 1
    if not same_bits(loss_a.cpu(), loss_b.cpu()):
        fail(f"[35] loss {float(loss_a)} after the demotion, the twin's "
             f"{float(loss_b)}")
    reader.close()
    ckpt_mb = sum(f.stat().st_size for f in (out / "ckpt35").rglob("*")
                  if f.is_file()) / 2**20
    ckpt.close()

    # -- the checks on the drill's records ------------------------------------
    want = {"warm-up": _TOPK_TELEM, "incumbent": _TOPK_TELEM,
            "drift": _NO_LAUNCHES, "powersgd": _NO_LAUNCHES,
            "topk1pct back": _TOPK_TELEM, "sabotaged": _NO_LAUNCHES,
            "after demotion": _TOPK_TELEM}
    for label, i, got in steps:
        if got != want[label]:
            fail(f"[35] {label} step {i} launched {got}, expected "
                 f"{want[label]}")
    launches: dict = {}
    for _, _, got in steps:
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    firsts, lasts = {}, {}
    for e in Timeline.from_jsonl(str(jsonl)).kinds("retune"):
        name = str(e.record.get("event"))
        firsts.setdefault(name, e.step)
        lasts[name] = e.step
    order = ["retune_drift", "retune_prepare", "retune_promote",
             "retune_probation_clear"]
    ordering_ok = (all(n in firsts for n in order)
                   and all(firsts[a] <= firsts[b]
                           for a, b in zip(order, order[1:]))
                   and "retune_demote" in lasts
                   and lasts["retune_prepare"] <= lasts["retune_promote"]
                   <= lasts["retune_demote"]
                   and lasts["retune_probation_clear"]
                   < lasts["retune_prepare"])
    if not ordering_ok:
        fail(f"[35] the retune events' order: firsts {firsts}, lasts "
             f"{lasts}")

    def opened(rec):
        return [(d["trigger"]["event"], d["step"]) for d in (
            json.loads(Path(path).read_text()) for path in rec.incidents)]

    incidents, collapsed = opened(recorder), opened(debounced)
    triggers = [(str(r["event"]), r["step"]) for r in tape.records
                if str(r.get("event", "")).startswith(DEFAULT_TRIGGERS)]
    transitions = [(e["event"], e["step"]) for e in ctl.events
                   if e["event"] in ("retune_promote", "retune_demote")]
    if incidents != triggers[:recorder.max_incidents] \
            or not set(transitions) <= set(incidents):
        fail(f"[35] incidents {incidents}, expected one a trigger "
             f"{triggers} (every promotion and demotion: {transitions})")
    # The debounce: a trigger opens an incident where it comes at least
    # the gap after the last one opened, and none opens otherwise; the
    # drill's triggers lie closer than that, so some collapse.
    gap, want, last = debounced.min_gap_steps, [], None
    for trig_ev in triggers:
        if last is None or trig_ev[1] - last >= gap:
            want.append(trig_ev)
            last = trig_ev[1]
    if collapsed != want or len(collapsed) >= len(triggers):
        fail(f"[35] the debounced incidents {collapsed} at a gap of {gap} "
             f"steps, expected {want} from the triggers {triggers}")

    drill = {
        "tool": "chip_smoke",
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "argv": "chip_smoke.py [35]", "world": 1, "device": smi,
        "window": RETUNE_WINDOW, "probation_steps": RETUNE_PROBATION,
        "incumbent": "topk1pct (chunk Top-K 1%, residual, allgather) + "
                     "fp16 escape + telemetry + audit every 5",
        "candidate": "powersgd rank 4 + rank-1 adapt ladder",
        "drift": {"scale": RETUNE_DRIFT_SCALE, "from_step": onset,
                  "verdict_step": drift},
        "funnel": (None if funnel is None else {
            "winner": funnel.get("winner"),
            "measured": [{"candidate": r["candidate"],
                          "measured_step_ms": r["measured_step_ms"],
                          "projected_step_ms": r["projected_step_ms"]}
                         for r in funnel["measured"]["rows"]],
            "skipped": funnel["measured"]["skipped"]}),
        "forward_promotion": {"step": ev_fwd["step"],
                              "migration": staged_fwd.migration,
                              "replica_variants": variants_fwd,
                              "probation_until": ev_fwd["probation_until"]},
        "back_promotion": {"step": ev_back["step"],
                           "migration": staged_back.migration,
                           "probation_until": ev_back["probation_until"]},
        "sabotage": {"promote_step": ev_sab["step"], "trigger": trig,
                     "trigger_step": trig_step,
                     "probation_until": ev_sab["probation_until"],
                     "within_probation": bool(within),
                     "restored": bool(ev_dem["restored"]),
                     "bit_exact": bool(ev_dem["bit_exact"])},
        "guard_events_during_healthy_drill": len(healthy_guard),
        "ordering_ok": bool(ordering_ok), "first_steps": firsts,
        "incidents": incidents, "incidents_debounced": collapsed,
        "launches": launches,
        "final_loss": float(loss_a),
    }
    doc_path = out / "phase35_retune.json"
    doc_path.write_text(json.dumps(drill, indent=1, default=str) + "\n")
    rec = record_artifact(
        str(doc_path), id="retune-drill", metric="retune_demote_bit_exact",
        value=bool(ev_dem["bit_exact"]), claim_class="measured",
        tool="chip_smoke", platform="gpu", chip=smi, n_devices=1,
        topology={"world": 1, "tiers": None, "slice": None, "region": None},
        config={"incumbent": "topk1pct", "candidate": "powersgd_r4_ladder"},
        lint_clean=True, ledger_path=str(ledger))
    records = latest_by_id(load_ledger(str(ledger)))
    for rid in ("tune-winner", "retune-drill"):
        r = records.get(rid)
        if rec is None or r is None or r["platform"] != "gpu" \
                or r["chip"] != smi:
            fail(f"[35] ledger record {rid}: {r} (the card: {smi})")
    claims = out / "claims.md"
    claims.write_text("The tuner's winner on the card and the retune drill's "
                      "bit-exact demotion.\n<!-- evidence: tune-winner "
                      "retune-drill -->\n")
    gate = gate_report(root=str(root), ledger_path=str(ledger),
                       docs=(str(claims),))
    has_git = git_head_rev(str(root)) is not None
    unresolvable = ["git_rev None does not resolve in this clone — "
                    "ancestry unprovable"]
    for rid in ("tune-winner", "retune-drill"):
        res = gate["records"].get(rid) or {}
        if not (res.get("status") == "MEASURED" or (
                not has_git and res.get("status") == "STALE"
                and res.get("failures") == unresolvable)):
            fail(f"[35] the gate on {rid}: {res}")
    text = sec_retune(drill, doc_path.name)
    if not text or "bit-exact" not in text[0] \
            or "ordering holds" not in text[0]:
        fail(f"[35] the summary of the drill: {text}")
    cli_seconds = evidence_read_side(root, ledger, claims, has_git,
                                     unresolvable, out,
                                     Path(docs_dir or out), doc_path, smi)

    seconds = time.perf_counter() - t_phase
    runs["phase35_retune"] = {
        "launches": launches, "seconds": seconds,
        "drift_step": drift, "trigger": trig, "trigger_step": trig_step,
        "migration": {"forward": staged_fwd.migration,
                      "back": staged_back.migration},
        "legs_s": {"forward": legs_fwd, "back": legs_back,
                   "sabotage": legs_sab},
        "checkpoint_mb": ckpt_mb, "demote_ms": demote_ms,
        "gate": {rid: gate["records"][rid]["status"]
                 for rid in ("tune-winner", "retune-drill")},
        "incidents": incidents, "incidents_debounced": collapsed,
        "cli_seconds": cli_seconds}
    log(f"[35] PREPARE legs (forward, back, sabotage): lint child "
        f"{legs_fwd['lint']:.2f} / {legs_back['lint']:.2f} / "
        f"{legs_sab['lint']:.2f} s; migrate "
        f"and footprint {legs_fwd['migrate'] * 1e3:.1f} / "
        f"{legs_back['migrate'] * 1e3:.1f} / "
        f"{legs_sab['migrate'] * 1e3:.1f} ms; good checkpoint "
        f"{legs_fwd['prepare_checkpoint'] * 1e3:.1f} / "
        f"{legs_back['prepare_checkpoint'] * 1e3:.1f} / "
        f"{legs_sab['prepare_checkpoint'] * 1e3:.1f} ms ({ckpt_mb:.1f} MB "
        f"on disk, two kept); COMMIT barrier {legs_fwd['commit'] * 1e3:.1f}"
        f" / {legs_back['commit'] * 1e3:.1f} / "
        f"{legs_sab['commit'] * 1e3:.1f} ms | {smi}")
    log(f"[35] migration forward {staged_fwd.migration['mem']} / "
        f"{staged_fwd.migration['comp']}, back "
        f"{staged_back.migration['mem']} / {staged_back.migration['comp']}; "
        f"replicas after the forward commit {variants_fwd}; probation "
        f"quiet twice; the sabotaged promotion at step {ev_sab['step']} "
        f"tripped {trig} at step {trig_step} (probation until "
        f"{ev_sab['probation_until']}); demote restore "
        f"{ctl.leg_seconds['demote_restore'] * 1e3:.1f} ms "
        f"(demote {demote_ms:.1f} ms in all), bit-exact, the digest the "
        f"PREPARE-time witness; the next topk1pct step equals the twin's in "
        f"{compared} tensors and the loss | {smi}")
    log(f"[35] every PREPARE left the incumbent's digest unchanged; events "
        f"in order ({' <= '.join(f'{n[7:]}@{firsts[n]}' for n in order)}, "
        f"then prepare@{lasts['retune_prepare']} <= "
        f"promote@{lasts['retune_promote']} <= "
        f"demote@{lasts['retune_demote']}); chunk launches 2 + 1 a topk1pct "
        f"step, 0 under PowerSGD and the chaos codec: {launches} in "
        f"{len(steps)} steps; incidents {incidents}, at JAX's "
        f"{debounced.min_gap_steps}-step debounce {collapsed}; ledger records "
        f"tune-winner and retune-drill on {smi}, the gate "
        f"{runs['phase35_retune']['gate']}"
        f"{'' if has_git else ' (no .git: the rev is unresolvable)'}; the "
        f"summary: {text[0][:160]}...; phase {seconds:.1f} s | {smi}")


# -- phase 36: the flagship example -------------------------------------------

FLAGSHIP_ARGV = ["--epochs", "1", "--compressor", "topk", "--topk-algorithm",
                 "chunk", "--memory", "residual"]


def flagship_phase(dev, group, runs, smi) -> None:
    """Phase 36 (module docstring): ``examples/mnist_lenet.py`` for one
    epoch on the bundled split under Top-K 1% chunk + residual, in a
    process of its own; both chunk kernels launch once a step, and its
    checkpoint restores into the example's own fresh state with the digest
    it printed."""
    import tempfile

    from grace_tpu_torch.checkpoint import Checkpointer
    from grace_tpu_torch.data import BUNDLED_MNIST_DIR, load_mnist_auto
    from grace_tpu_torch.examples import mnist_lenet
    from grace_tpu_torch.resilience import state_digest

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        argv = FLAGSHIP_ARGV + ["--ckpt-dir", ckpt]
        t0 = time.perf_counter()
        launch_line, ckpt_line, acc_line = run_example(
            "mnist_lenet", argv, ("kernel launches:", "checkpoint",
                                  "final test accuracy:"),
            EXAMPLE_TIMEOUT_S, "[36]")
        wall = time.perf_counter() - t0
        launches = json.loads(launch_line.split(":", 1)[1])
        digest = ckpt_line.rsplit("digest ", 1)[1].rstrip(")")
        args = mnist_lenet.build_parser().parse_args(argv)
        steps = len(load_mnist_auto(BUNDLED_MNIST_DIR)[0]) // args.batch_size
        want = {"chunk_compress_feedback": steps,
                "chunk_aggregate_dense": steps}
        if launches != want:
            fail(f"[36] mnist_lenet launched {launches} in {steps} steps, "
                 f"expected {want}")
        _, state, _, _ = mnist_lenet.build(args, group, dev)
        restored = Checkpointer(ckpt, group=group).restore(state)
        got = state_digest(restored)
        if got != digest:
            fail(f"[36] the checkpoint restored with digest {got}, the "
                 f"example saved {digest}")
    runs["mnist_lenet_example"] = {"launches": launches, "seconds": wall,
                                   "digest": digest,
                                   "test_acc": rate(acc_line)}
    log(f"[36] python -m grace_tpu_torch.examples.mnist_lenet "
        f"{' '.join(FLAGSHIP_ARGV)}: exit 0 in {wall:.2f} s; launches "
        f"{launches} in {steps} steps; the checkpoint restored bit for bit "
        f"(digest {digest[:16]}...); {acc_line} | {smi}")


# -- phase 37: the TensorFlow front end's host callout ----------------------------

TF_CALLOUT_CALLS = 6             # 1 warm-up + 5 timed
RESNET50_NUMEL = 25_557_032
# Predicted before the call: the callout's bridge holds one flat leaf, so
# one launch of each chunk kernel a call.
TF_CALLOUT_PER_CALL = {"chunk_compress_feedback": 1,
                       "chunk_aggregate_dense": 1}


def tf_callout_phase(dev, group, runs, smi) -> None:
    """Phase 37 (module docstring)."""
    import importlib.util

    import numpy as np
    import torch
    from grace_tpu_torch import grace_from_params, ops
    from grace_tpu_torch.interop import GraceBridge
    from grace_tpu_torch.interop import tensorflow as port_tf

    t_phase = time.perf_counter()
    flat = resnet50_flat_grads(dev, count=1)[0]
    if flat.numel() != RESNET50_NUMEL:
        fail(f"[37] the flat ResNet-50 gradient has {flat.numel()} floats")
    host = flat.cpu().numpy()
    mb = host.nbytes / 1e6
    grace = grace_from_params(_TOPK1, group=group)
    callout = port_tf.TFExchanger(grace, device="cuda")
    resident = GraceBridge(grace, n=flat.numel(), seed=0, device=dev)
    staged = GraceBridge(grace_from_params({**_TOPK1, "use_pallas": False},
                                           group=group),
                         n=flat.numel(), seed=0, device=dev)
    call_ms, res_ms, per_call = [], [], []
    for c in range(TF_CALLOUT_CALLS):
        torch.cuda.synchronize()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        got = callout._host_exchange(host)        # back on the host: synced
        t1 = time.perf_counter()
        now = ops.launch_counts()
        per_call.append({k: now[k] - before.get(k, 0)
                         for k in TF_CALLOUT_PER_CALL})
        mine = flat.clone()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want = resident.exchange(mine)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        plain = staged.exchange(flat.clone())
        if not same_bits(torch.from_numpy(got), want.cpu()):
            fail(f"[37] call {c}: the callout differs from the resident "
                 f"bridge (max abs err "
                 f"{max_abs_err(torch.from_numpy(got), want.cpu())})")
        if not same_bits(want, plain):
            fail(f"[37] call {c}: the kernels differ from the staged chunk "
                 "path")
        if c:
            call_ms.append((t1 - t0) * 1e3)
            res_ms.append((t3 - t2) * 1e3)
    if any(p != TF_CALLOUT_PER_CALL for p in per_call):
        fail(f"[37] launches a call {per_call}, predicted "
             f"{TF_CALLOUT_PER_CALL}")
    profiled, profile_s = profile_callout_apart(host)
    if profiled != TF_CALLOUT_PER_CALL:
        fail(f"[37] the profiler counted {profiled} in one call, predicted "
             f"{TF_CALLOUT_PER_CALL}")
    tape_refused = None
    if importlib.util.find_spec("tensorflow") is None:
        try:
            port_tf.DistributedGradientTape(None, grace, device="cuda")
        except ImportError as e:
            tape_refused = str(e)
        if not tape_refused or "tensorflow" not in tape_refused:
            fail(f"[37] DistributedGradientTape without tensorflow: "
                 f"{tape_refused}")
    launches = {k: sum(p[k] for p in per_call) + profiled[k]
                for k in TF_CALLOUT_PER_CALL}
    call = statistics.median(call_ms)
    res = statistics.median(res_ms)
    runs["tf_callout"] = {"launches": launches, "callout_ms": call_ms,
                          "resident_ms": res_ms, "mb_each_way": mb,
                          "round_trip_ms": call - res}
    del flat, host, callout, resident, staged
    torch.cuda.empty_cache()
    log(f"[37] TFExchanger._host_exchange over the {RESNET50_NUMEL}-float "
        f"ResNet-50 gradient ({mb:.1f} MB each way): {TF_CALLOUT_CALLS} "
        f"calls bit for bit equal to the resident GraceBridge and to the "
        f"staged chunk path; launches a call {per_call[-1]} (predicted "
        f"{TF_CALLOUT_PER_CALL}; the profiler, a process of its own: "
        f"{profiled} in {profile_s:.1f} s); median of 5: "
        f"callout {call:.3f} ms, resident bridge {res:.3f} ms, host round "
        f"trip {call - res:.3f} ms (callout {[round(v, 3) for v in call_ms]}"
        f", resident {[round(v, 3) for v in res_ms]}); "
        f"DistributedGradientTape without tensorflow: "
        f"{'ImportError' if tape_refused else 'tensorflow present'}; "
        f"{time.perf_counter() - t_phase:.1f} s | {smi}")


def profile_callout_apart(host):
    """[37]'s profiler count of one callout call over ``host``, read in a
    process of its own (``chip_smoke.py --profile-callout``): after the
    hundreds of profiler sessions of the phases before it, this process's
    profiler has recorded no device event at all, where a fresh process
    reads each session of the callout. Returns the counts and the child's
    wall seconds."""
    import tempfile

    import numpy as np

    with tempfile.TemporaryDirectory(prefix="grace_callout_") as tmp:
        npy = Path(tmp) / "flat.npy"
        np.save(npy, host)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--profile-callout", str(npy)],
            capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
        wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"[37] chip_smoke.py --profile-callout exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"  [37] {line}")
    return json.loads(lines[-1])["profiled"], wall


def profile_callout(npy: str) -> int:
    """``--profile-callout NPY``: [37]'s callout, built as [37] builds it,
    over the float32 buffer in NPY; one call to load the kernels, then one
    call under torch.profiler (``profiled_kernel_launches``). Prints the
    counts as one JSON line."""
    import numpy as np
    import torch.distributed as dist
    from grace_tpu_torch import grace_from_params
    from grace_tpu_torch.interop import tensorflow as port_tf
    from grace_tpu_torch.parallel import init_process_group

    group, _ = init_process_group("cuda")
    try:
        host = np.load(npy)
        callout = port_tf.TFExchanger(grace_from_params(_TOPK1, group=group),
                                      device="cuda")
        callout._host_exchange(host)
        profiled = profiled_kernel_launches(
            lambda: callout._host_exchange(host), list(TF_CALLOUT_PER_CALL),
            TF_CALLOUT_PER_CALL, what="call")
    finally:
        dist.destroy_process_group()
    print(json.dumps({"profiled": profiled}))
    return 0


# -- phase 38: the drills' command line -------------------------------------------

DRILLS = {
    "default": ["--steps", "40", "--nan-prob", "0.05", "--telemetry-every",
                "10"],
    "homo": ["--homo", "--steps", "30", "--nan-prob", "0.05",
             "--telemetry-every", "10"],
    "pipeline2": ["--pipeline", "2", "--steps", "30", "--nan-prob", "0.05",
                  "--telemetry-every", "10"],
    "adapt": ["--adapt", "--adapt-rank", "0", "--steps", "60",
              "--adapt-window", "6", "--telemetry-every", "6"],
}
DRILL_TIMEOUT_S = 240
# The W=1 ring encodes each of the pipeline's 2 segments twice and the
# telemetry's compression-error probe the flat buffer once: 5 a compressed
# step; the dense escape's steps launch nothing. (The CPU's count of the
# wrapper's calls has a sixth on the first step, the wire model's payload
# probe, which the card runs on fake tensors: no launch.)
PIPELINE_LAUNCHES = {"quantize_pack_stochastic": {
    "first_compressed_step": 5, "later_compressed_steps": [5],
    "dense_launches": 0}}


def start_drills() -> dict:
    """Phase 38's four children, started together into a temporary
    directory (``DRILLS``); they run beside [36], whose own process only
    checks launches and a digest, and are collected after it."""
    import tempfile

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="grace_drills_"))
    procs = {}
    try:
        for name, argv in DRILLS.items():
            out = tmp / name
            out.mkdir()
            cmd = [sys.executable, "-m", "grace_tpu_torch.resilience.smoke",
                   "--world", "1", "--device", "cuda", "--telemetry-out",
                   str(out / "run.jsonl"), "--adapt-out",
                   str(out / "ADAPT_LAST.json"), *argv]
            with open(out / "stdout", "w") as so, \
                    open(out / "stderr", "w") as se:
                procs[name] = (subprocess.Popen(
                    cmd, cwd=root, stdout=so, stderr=se,
                    env={**os.environ, "PYTHONPATH": str(root)}),
                    time.perf_counter())
    except BaseException:
        stop_drills({"tmp": tmp, "procs": procs})
        raise
    return {"tmp": tmp, "procs": procs, "t0": time.perf_counter()}


def stop_drills(drills: dict) -> None:
    """Kill what is left of phase 38's children and remove their
    directory."""
    for proc, _ in drills["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(drills["tmp"], ignore_errors=True)


def drills_phase(drills: dict, runs, smi) -> None:
    """Phase 38 (module docstring): wait for the children of
    :func:`start_drills` and check them."""
    tmp, procs = drills["tmp"], drills["procs"]
    try:
        # Each child's own wall: polled together, none waits on another.
        results, deadline = {}, time.perf_counter() + DRILL_TIMEOUT_S
        while len(results) < len(procs):
            if time.perf_counter() > deadline:
                fail(f"[38] drills still running after {DRILL_TIMEOUT_S} "
                     f"s: {sorted(set(procs) - set(results))}")
            for name, (proc, t0) in procs.items():
                if name not in results and proc.poll() is not None:
                    results[name] = (
                        proc.returncode,
                        (tmp / name / "stdout").read_text(),
                        (tmp / name / "stderr").read_text(),
                        time.perf_counter() - t0)
            time.sleep(0.05)
        for name, (rc, stdout, stderr, wall) in results.items():
            for line in stdout.splitlines():
                if line.startswith("[chaos_smoke]"):
                    log(f"    {name}: {line}")
            if rc != 0 or "[chaos_smoke] OK" not in stdout:
                fail(f"[38] the {name} drill exited {rc}: {stderr[-2000:]}")
        tally = {}
        for name, (_, stdout, _, _) in results.items():
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith("[chaos_smoke] kernel launches:")]
            tally[name] = json.loads(lines[-1].split(":", 1)[1]) \
                if lines else {}
        for name in ("default", "homo"):
            if any(t["total"] for t in tally[name].values()):
                fail(f"[38] the {name} drill launched {tally[name]}, "
                     "predicted none")
        pipe = tally["pipeline2"].get("quantize_pack_stochastic")
        want = PIPELINE_LAUNCHES["quantize_pack_stochastic"]
        if not pipe or any(pipe[k] != v for k, v in want.items()) \
                or pipe["total"] != 5 * pipe["compressed_steps"]:
            fail(f"[38] the pipelined drill launched {pipe}, predicted "
                 f"{want} (5 a compressed step)")
        md = read_side_cli("[38]", "grace_tpu_torch.evidence.summary",
                           "--root", str(tmp / "adapt"), smi=smi)
        if "`chaos_smoke --adapt`" not in md:
            fail(f"[38] the summary of the adapt drill's document: {md}")
        adapt_line = next(ln for ln in md.splitlines()
                          if "`chaos_smoke --adapt`" in ln)
    finally:
        stop_drills(drills)
    runs["drill_pipeline2"] = {"launches": {
        "quantize_pack_stochastic": pipe["total"]}, "tally": pipe}
    walls = {name: round(r[3], 2) for name, r in results.items()}
    runs["drills"] = {"launches": {}, "wall_s": walls}
    log(f"[38] python -m grace_tpu_torch.resilience.smoke --world 1 --device "
        f"cuda, four children together (beside [36]): each exited 0; wall s "
        f"{walls}; the pipelined drill's quantize-and-pack launches {pipe} "
        f"(predicted {want}); the summary: {adapt_line[:300]}; "
        f"{time.perf_counter() - drills['t0']:.1f} s after [36]'s start | "
        f"{smi}")


def main() -> int:
    # A kernel family disabled by the environment would run its plain
    # version in place of the kernel, and the checks would compare plain
    # with plain.
    switched = sorted(k for k in os.environ
                      if k.startswith("GRACE_DISABLE_PALLAS"))
    if switched:
        print(f"chip_smoke: {', '.join(switched)} set: unset every "
              "GRACE_DISABLE_PALLAS* variable, which would turn kernels "
              "off", file=sys.stderr)
        return 2
    if len(sys.argv) not in (1, 3) or sys.argv[1:2] not in (
            [], ["--times-from"], ["--profile-callout"]):
        print("usage: chip_smoke.py [--times-from ROOT | --profile-callout "
              "NPY]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--times-from"]:
        return times_from(sys.argv[2])
    if sys.argv[1:2] == ["--profile-callout"]:
        return profile_callout(sys.argv[2])
    try:
        import grace_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: grace_tpu_torch not importable ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2
    import numpy as np

    from grace_tpu_torch.ops import _build
    from grace_tpu_torch.parallel import init_process_group

    # -- 1. identify ---------------------------------------------------------
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi} | {name} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")
    log(f"    tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32} | bounds from the H100 SXM data "
        f"sheet: {HBM_BYTES_PER_S / 1e12} TB/s, "
        f"{FP32_FLOP_PER_S / 1e12} fp32 TFLOP/s")
    t0 = time.perf_counter()
    _build.build_all()                    # one nvcc a source, in parallel
    for src in _build.sources():
        _build.library(src)
    log(f"    kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for src in _build.sources():
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas {src}: {line.strip()}")

    group, dev = init_process_group("cuda")
    try:
        leaves = resnet50_leaves()
        # -- 2. kernels against their plain versions -------------------------
        errs = {"chunk_compress_feedback": 0.0, "chunk_aggregate_dense": 0.0}
        cases = check_kernels(dev, leaves, errs)
        grouped_cases = check_grouped_kernels(dev, leaves, errs)
        log(f"[2] kernels bit-identical to their plain versions in {cases} "
            f"one-leaf cases and {grouped_cases} grouped cases ({len(leaves)} "
            f"ResNet-50 leaves and the edge-column leaf in one launch each) "
            f"on the card")
        # -- 3. timing -------------------------------------------------------
        log(f"[3] kernel times at the main path's shapes ({len(leaves)} "
            f"leaves, W=1)")
        times = time_kernels(dev, leaves)
        # -- 4. reference on a small input -----------------------------------
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        check_reference(dev, group)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        log("[4] reduced ResNet on the card agrees with the CPU (forward and "
            "backward within rtol 1e-4/atol 1e-5; Top-K and signSGD GRACE "
            "exchanges bit for bit)")
        # -- 5. train full width ---------------------------------------------
        log(f"[5] ResNet-50, batch {HEADLINE[0]['per_device_bs']}, "
            f"{IMAGE_HW}x{IMAGE_HW} bf16, SGD lr 1e-3, {WARMUP_STEPS} warm-up "
            f"+ {TIMED_STEPS} timed steps")
        rng = np.random.default_rng(SEED)
        bs = HEADLINE[0]["per_device_bs"]
        x = torch.from_numpy(rng.standard_normal(
            (bs, IMAGE_HW, IMAGE_HW, 3), dtype=np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, NUM_CLASSES, (bs,))).to(dev)
        runs = {}
        for cfg in HEADLINE:
            runs[cfg["name"]] = train(dev, group, cfg, x, y)
            torch.cuda.empty_cache()
        # -- 6. wire-path kernels against their plain versions -------------
        wire_errs = {k: 0.0 for k in WIRE_KERNELS}
        cases = check_wire_kernels(dev, leaves, wire_errs)
        sign_cases = check_sign_grouped(dev, leaves, wire_errs)
        view_cases = check_pack_views(dev, wire_errs)
        layout_cases = check_decode_layouts(dev, wire_errs)
        vote_cases, vote_numel = check_vote_decode(dev, leaves, wire_errs)
        log(f"[6] wire-path kernels bit-identical to their plain versions in "
            f"{cases} cases on the card; the grouped sign-pack in "
            f"{sign_cases} one-launch cases over {len(leaves)} ResNet-50 "
            f"leaves and {len(SIGN_EDGES)} edge lengths (error feedback at "
            f"two beta,gamma; pack only in three float types and a mix); "
            f"quantize-and-pack and quantize in {view_cases} cases on shard "
            f"views at element offsets 0-3; decode_accumulate in "
            f"{layout_cases} cases over five row layouts (contiguous, an "
            f"extra byte, padded to 16 bytes, an unaligned base, stride +17) "
            f"at K in {DECODE_KS + (BIG_K,)}; the vote's decode of the "
            f"grouped payload ({vote_numel} lanes) in {vote_cases} cases")
        # -- 7. the ring hop -------------------------------------------------
        flat_a, flat_b = resnet50_flat_grads(dev)
        cases, hop_launches = check_ring_hop(dev, flat_a, flat_b, wire_errs)
        log(f"[7] ring hop: {cases} shard decodes of two ranks' ResNet-50 "
            f"gradients at W=2 and W=8 (qsgd q=7, q=1, signsgd) bit for bit "
            f"against the plain version and the staged decode; "
            f"decode_accumulate launched {hop_launches} times")
        # -- 8. timing -------------------------------------------------------
        log("[8] wire-path kernel times at the wire path's shapes (flat "
            f"n={flat_a.numel()}, 161 leaves, W=1)")
        wire_times = time_wire_kernels(dev, leaves, flat_a)
        # -- 10. the packed integer accumulate against its plain version -----
        wire_errs["packed_int_accumulate"] = 0.0
        cases, layout_cases = check_accum_kernel(dev, leaves, wire_errs)
        log(f"[10] packed_int_accumulate byte-identical to its plain version "
            f"in {cases} cases on the card, {layout_cases} of them over the "
            f"five row layouts (at numel = every slot, one fewer and half) "
            f"through the stacked and the rows entry, and over rows from "
            f"separate allocations on and off the 16-byte grid, at K in "
            f"{ACCUM_KS + (ACCUM_BIG_K,)} (K={ACCUM_BIG_K}: chained launches)")
        # -- 11. the packed hop ----------------------------------------------
        cases, accum_launches = check_packed_hop(dev, flat_a, flat_b,
                                                 wire_errs)
        del flat_b
        log(f"[11] packed hop: {cases} shard sums of W ranks' homoqsgd "
            f"payloads (4-bit at W=2, 4, 7; 3-bit at W=2, 3), each as "
            f"payload_sum and as the ring's payload_add chain, byte for byte "
            f"against the plain version and the staged path and equal to "
            f"the levels' integer sum; packed_int_accumulate launched "
            f"{accum_launches} times, once a call, and no call allocated "
            f"more than its output (no stacking copy); a lattice input "
            f"through the one-card reduce-scatter came back exact")
        # -- 12. timing -------------------------------------------------------
        log("[12] packed_int_accumulate times on the 4-bit wire of the flat "
            "buffer")
        accum_times = time_accum_kernel(dev, flat_a)
        del flat_a
        torch.cuda.empty_cache()
        # -- 9. train the wire path ------------------------------------------
        log(f"[9] ResNet-50 under the wire-path configurations, batch {bs}, "
            f"{WARMUP_STEPS} warm-up + {TIMED_STEPS} timed steps")
        for cfg in WIRE_PATH:
            runs[cfg["name"]] = train(dev, group, cfg, x, y)
            torch.cuda.empty_cache()
        # -- 13. train the homomorphic path ----------------------------------
        log(f"[13] ResNet-50 under the homomorphic path's configurations, "
            f"batch {bs}, {WARMUP_STEPS} warm-up + {TIMED_STEPS} timed steps")
        for cfg in HOMO_PATH:
            runs[cfg["name"]] = train(dev, group, cfg, x, y)
            torch.cuda.empty_cache()
        # -- 14. the chunk Top-K pair on LeNet's leaves -----------------------
        cases, lenet = check_lenet_kernels(dev, errs)
        sizes = ", ".join(str(n) for _, n in lenet)
        log(f"[14] chunk Top-K pair bit-identical to its plain versions on "
            f"LeNet's {len(lenet)} leaves ({sizes} elements, k=1 on the "
            f"three smallest) in {cases} cases: grouped "
            f"(four compress variants, the aggregate at W in {{1, 8}}) and "
            f"over the flat {sum(n for _, n in lenet)}-element buffer, one "
            f"launch a call")
        # -- 15. LeNet on the bundled MNIST ----------------------------------
        log(f"[15] LeNet on the bundled MNIST split, W=1, 40 epochs, batch "
            f"256, SGD lr 0.02 momentum 0.9 (the vote: lr 0.001 cosine, no "
            f"momentum), seed 42, prefetch 2 (tf32: cudnn "
            f"{torch.backends.cudnn.allow_tf32}, matmul "
            f"{torch.backends.cuda.matmul.allow_tf32})")
        mnist = {}
        for cfg in MNIST_PATH:
            mnist[cfg["name"]] = train_mnist(dev, group, cfg)
            runs[cfg["name"]] = mnist[cfg["name"]]
        # -- 16. the two-shot all-reduce -------------------------------------
        log(f"[16] ResNet-50 under the two-shot configuration, batch {bs}, "
            f"{WARMUP_STEPS} warm-up + {TIMED_STEPS} timed steps")
        for cfg in TWOSHOT_PATH:
            runs[cfg["name"]] = train(dev, group, cfg, x, y)
            torch.cuda.empty_cache()
        vote_launches = check_twoshot_vote(dev, group, leaves)
        runs["twoshot_signsgd_vote"] = {"launches": {"sign_pack":
                                                     vote_launches}}
        log(f"[16] two-shot signSGD + residual over the {len(leaves)} "
            f"ResNet-50 leaves equals the all-gather vote bit for bit "
            f"(updates and residuals, two steps); sign_pack launched "
            f"{vote_launches} times (both encodes of every leaf)")
        # -- 17. the hierarchical all-reduce --------------------------------
        log(f"[17] ResNet-50 under the hier configurations, batch {bs}, "
            f"{HIER_WARMUP_STEPS} warm-up + {HIER_TIMED_STEPS} timed steps "
            f"(W=1 with slice_size=8: one slice, the flat ring's schedule)")
        for cfg in HIER_PATH:
            runs[cfg["name"]] = train(dev, group, cfg, x, y,
                                      HIER_WARMUP_STEPS, HIER_TIMED_STEPS)
            torch.cuda.empty_cache()
        flat_a, flat_b = resnet50_flat_grads(dev)
        check_hier_collapse(dev, group, flat_a)
        log(f"[17] each of the {len(HIER_PATH)} hier rows' steps on a "
            f"ResNet-50 flat gradient ({flat_a.numel()} elements) equals its "
            f"ring twin bit for bit, outputs and residuals, two steps")
        # -- 18. the boundary kernels at a W=8 world's shapes ---------------
        log("[18] the hier boundary kernels at the shapes of a W=8 world "
            "over the ResNet-50 flat buffer")
        hier_times, cases = check_hier_boundaries(dev, flat_a, flat_b,
                                                  wire_errs)
        del flat_a, flat_b
        torch.cuda.empty_cache()
        log(f"[18] {cases} cases bit for bit against the plain versions "
            f"(the exact boundary sums, the cascaded vote, the boundary "
            f"re-encode at {', '.join(h[0] for h in HIER_LAYOUTS)}); "
            f"randomk drew one index set under one key on the card")
        # -- 19. the catalog's codecs on the card against the CPU ----------
        log(f"[19] {len(CATALOG_CHECKS)} catalog configurations, one step "
            f"over the {len(leaves)} ResNet-50 leaves (tie-free gradients), "
            "the card against the CPU under the same noise")
        t0 = time.perf_counter()
        catalog = check_catalog_steps(dev, group)
        worst, checked = catalog.pop("powersgd_orthonormal")
        log(f"[19] every configuration agrees with the CPU within its "
            f"tolerance; PowerSGD rank 4: P and Q of {checked} factored "
            f"leaves orthonormal within {worst:.2g} (limit "
            f"{POWERSGD_ORTHO_ATOL}); {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        # -- 20. train the catalog ------------------------------------------
        log(f"[20] ResNet-50 under the catalog's configurations, batch {bs}, "
            f"{HIER_WARMUP_STEPS} warm-up + {CATALOG_TIMED_STEPS} timed steps")
        t0 = time.perf_counter()
        for cfg in CATALOG_PATH:
            runs[cfg["name"]] = train(dev, group, cfg, x, y,
                                      HIER_WARMUP_STEPS, CATALOG_TIMED_STEPS)
            torch.cuda.empty_cache()
        log(f"[20] {len(CATALOG_PATH)} rows trained in "
            f"{time.perf_counter() - t0:.1f} s")
        runs["catalog_checks"] = {"launches": {}, "max_abs_err": {
            k: v[0] for k, v in catalog.items()},
            "powersgd_orthonormal_err": worst}
        # -- 21. the executors ----------------------------------------------
        rows = exec_path(dev, group)
        log(f"[21] ResNet-50 under the executors' configurations, batch {bs}, "
            f"{HIER_WARMUP_STEPS} warm-up + {HIER_TIMED_STEPS} timed steps: "
            + "; ".join(f"{c['name']} ({c['plan']})" for c in rows))
        t0 = time.perf_counter()
        for cfg in rows:
            runs[cfg["name"]] = train(dev, group, cfg, x, y,
                                      HIER_WARMUP_STEPS, HIER_TIMED_STEPS)
            runs[cfg["name"]]["plan"] = cfg["plan"]
            torch.cuda.empty_cache()
        compared = check_executors(dev, group)
        torch.cuda.empty_cache()
        log(f"[21] on two steps of real ResNet-50 gradients, {compared} "
            f"tensors bit for bit: 'grouped' equals fusion=None (outputs and "
            f"residuals), the none and fp16 buckets (64 MiB, 1024 B) on "
            f"integer-valued gradients equal 'flat', the routed step equals "
            f"its two unrouted steps leaf for leaf; "
            f"{time.perf_counter() - t0:.1f} s")
        # -- 22. the DistributedOptimizer ------------------------------------
        log(f"[22] ResNet-50 under DistributedOptimizer(SGD lr 1e-3) with "
            f"topk1pct's grace, batch {bs}, {HIER_WARMUP_STEPS} warm-up + "
            f"{HIER_TIMED_STEPS} timed steps, bucket_cap_mb in "
            f"{OPTIMIZER_CAPS}")
        t0 = time.perf_counter()
        for cap in OPTIMIZER_CAPS:
            res = train_optimizer(dev, group, cap, x, y)
            runs[res["name"]] = res
            torch.cuda.empty_cache()
        buckets = check_optimizer(dev, group)
        torch.cuda.empty_cache()
        log(f"[22] the optimizer's synchronized gradients ({buckets} buckets, "
            f"two steps) equal GraceBridge's over the same bucket buffers "
            f"(seed + bi) and the staged chunk path's, bit for bit; "
            f"{time.perf_counter() - t0:.1f} s")
        # -- 23. the example --------------------------------------------------
        log(f"[23] grace_tpu_torch/examples/torch_synthetic_benchmark.py "
            f"{' '.join(EXAMPLE_ARGV)}")
        t0 = time.perf_counter()
        example_ips = rate(run_example(
            "torch_synthetic_benchmark", EXAMPLE_ARGV, "Img/sec per process:",
            EXAMPLE_TIMEOUT_S, "[23]"))
        runs["torch_synthetic_benchmark"] = {"launches": {},
                                             "img_per_s": example_ips}
        log(f"[23] exited 0: {example_ips:.1f} img/s; "
            f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        # -- 24 to 27. BERT-base, its example, DAWNBench, VGG-16 ------------
        new_model_phases(dev, group, runs, errs)
        # -- 28. the guarded training step -----------------------------------
        log(f"[28] ResNet-50, batch {bs}, under topk1pct + fp16 escape + "
            f"telemetry through guarded_chain(fallback_after=2, "
            f"fallback_steps=3): {GUARD_STEPS} steps with NaN steps "
            f"{GUARD_BAD}, checkpoints, a healthy run, four timed rows")
        # The evidence documents of [29], [32] to [35], for [35]'s summary.
        import tempfile
        docs_dir = Path(tempfile.mkdtemp(prefix="grace_docs_"))
        guarded_phase(dev, group, x, y, runs)
        # -- 29. the cross-rank watch and the consistency audit -------------
        log(f"[29] ResNet-50, batch {bs}, under topk1pct + telemetry + watch "
            f"(window {WATCH_WINDOW}) + fp16 escape + consensus through "
            f"guarded_chain and make_stateful_train_step(consensus=...): a "
            f"healthy run against the unaudited one, the chaos injectors, "
            f"the audit's cost, three timed rows")
        watch_phase(dev, group, x, y, runs, docs_dir)
        # -- 30. the adaptive ladder and elastic resize ---------------------
        log(f"[30] ResNet-50, batch {bs}: topk1pct under the adaptive ladder "
            f"(fp16, Top-K 4%, Top-K 1%; window {ADAPT_WINDOW}) for 1 + "
            f"{ADAPT_STEPS} steps, each rung profiled, the homoqsgd ladder "
            f"beside its static twin, the ladder under the guard and the "
            f"audit, and the elastic drain, re-shard and rejoin")
        adapt_phase(dev, group, x, y, runs, errs)
        # -- 31. the data path ------------------------------------------------
        log(f"[31] the data path: the native loader, prefetch_to_device and "
            f"LeNet on the bundled MNIST split, batch {DATA_BATCH}")
        data_path_phase(dev, group, runs, smi)
        # -- 37. the TensorFlow front end's host callout -------------------
        log("[37] the TF front end's host callout over the ResNet-50 flat "
            f"gradient under topk1pct, {TF_CALLOUT_CALLS} calls")
        tf_callout_phase(dev, group, runs, smi)
        # -- 32. the 2-D mesh and the profiler's read side ------------------
        log(f"[32] ResNet-50, batch {bs}: topk1pct on a 1×1 dp×fsdp mesh "
            f"against [5]'s steps, shard 0 of real gradients, one step "
            f"through the ported profiler")
        mesh_profiling_phase(dev, group, x, y, runs, errs, smi, docs_dir)
        # -- 33. the static auditor ------------------------------------------
        log("[33] the static auditor: the HEADLINE at ResNet-50 width traced "
            "on the card's route at W=8 and W=1, phase29_consensus's audit "
            "step, the footprint model, the registry on both routes")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tune_dir:
            measured = start_measured_tune(Path(tune_dir))
            try:
                static_audit_phase(dev, group, x, y, runs, smi, docs_dir)
                # -- 34. the tuner --------------------------------------------
                log("[34] the tuner: the static funnel at ResNet-50 width for "
                    "W8 and W256/slice8, the W8 shortlist measured on the "
                    "card (toy model, W=1) with the kernel candidates named, "
                    "the winner's overlap sandwich")
                tuner_phase(runs, smi, measured, Path(tune_dir))
                # -- 35. the online re-tuner and the evidence ---------------
                log(f"[35] the retune drill on the HEADLINE at ResNet-50 "
                    f"width, batch {bs}, W=1: topk1pct + fp16 escape + "
                    f"telemetry + audit every {RETUNE_AUDIT_EVERY}, drift, "
                    f"propose, promote to PowerSGD r4 + rank-1 ladder and "
                    f"back, a sabotaged promotion demoted; the evidence "
                    f"ledger, the gate and the summary")
                retune_phase(dev, group, x, y, runs, smi, Path(tune_dir),
                             docs_dir)
            finally:
                if measured.poll() is None:
                    measured.kill()
                    measured.wait()
                shutil.rmtree(docs_dir, ignore_errors=True)
        # -- 36. the flagship example, [38]'s drills beside it --------------
        log(f"[38] python -m grace_tpu_torch.resilience.smoke --world 1: "
            f"{', '.join(DRILLS)}, started beside [36]")
        drills = start_drills()
        try:
            log("[36] grace_tpu_torch/examples/mnist_lenet.py "
                f"{' '.join(FLAGSHIP_ARGV)} --ckpt-dir <tmp>")
            flagship_phase(dev, group, runs, smi)
            # -- 38. the drills' command line -------------------------------
            drills_phase(drills, runs, smi)
        finally:
            stop_drills(drills)
        wire_times["packed_int_accumulate"] = {
            **accum_times["K=1"],
            "hop": {k: accum_times[k] for k in ("K=2", "K=7",
                                                "K=2 width 3")}}
        for kname, key in (("packed_int_accumulate", "hier_boundary"),
                           ("decode_accumulate", "hier_vote"),
                           ("quantize_pack_stochastic", "hier_reencode")):
            wire_times[kname][key] = {label: t[kname]
                                      for label, t in hier_times.items()}
        kernels = []
        for kname, src, line, run in (
                ("chunk_compress_feedback", "pallas_topk.py", 132, "topk1pct"),
                ("chunk_aggregate_dense", "pallas_topk.py", 237, "topk1pct"),
                ("quantize_stochastic", "pallas_quant.py", 111,
                 "qsgd_pallas"),
                ("quantize_pack_stochastic", "pallas_quant.py", 247,
                 "qsgd4_ring"),
                ("sign_pack", "pallas_quant.py", 316, "signsgd_vote_bs256"),
                ("decode_accumulate", "pallas_wire.py", 180,
                 "signsgd_vote_bs256"),
                ("packed_int_accumulate", "pallas_wire.py", 254,
                 "homoqsgd4_rscatter_fused")):
            t = times[kname] if kname in times else wire_times[kname]
            extra = {key: t[key] for key in (
                "pack_only", "one_leaf", "width2", "width3", "unaligned",
                "int16", "contiguous", "w8", "vote", "rows", "hop",
                "hier_boundary", "hier_vote", "hier_reencode",
                "library_kernel", "library_kernel_ms") if key in t}
            kernels.append({
                "name": kname, "route": "cuda",
                "source": "grace_tpu_torch/csrc/" + (
                    "chunk_topk.cu" if src == "pallas_topk.py" else
                    "quant.cu" if src == "pallas_quant.py" else "wire.cu"),
                "replaces": f"grace_tpu/ops/{src}:{line}",
                "launches": runs[run]["launches"][kname],
                "launches_from": f"the {run} run",
                "launches_by_run": {
                    r: v["launches"][kname] for r, v in runs.items()
                    if v["launches"].get(kname)},
                "max_abs_err": {**errs, **wire_errs}[kname], "ms": t["ms"],
                "host_ms": t["host_ms"], "kernel_ms": t["kernel_ms"],
                "event_ms": t["event_ms"], "cold_ms": t["cold_ms"],
                "cold_event_ms": t["cold_event_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                **extra})
        log(json.dumps({"runs": runs}))
        print(json.dumps({"kernels": kernels}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
