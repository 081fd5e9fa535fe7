#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of WoW (``src/repro_torch``) on one NVIDIA card
and check it end to end.

    python3 chip_smoke.py

Phases (no failure is caught; any failed check exits non-zero).  Every
phase that drives a path sets every kernel's launch counter to 0 just
before the path and reads the counters just after it:

  1. build — every CUDA source under ``src/repro_torch/csrc`` is compiled by
     ``nvcc`` (one process per source, all started together), with its
     ptxas report;
  1b. lint — the port's wowlint (``repro_torch.analysis``) in processes of
     their own: ``--fail-on-findings`` over the shipped tree must exit 0
     (the empty ``wowlint_torch_baseline.json``), and ``--compile-smoke``
     must count a hop chunk's capture once and nothing at its replay;
  1c. tools — the port's planning tools (``repro_torch.launch``) in this
     process: ``quant_roofline.main(["--gate", "--measure"])``: the counted
     arithmetic-intensity gate (``op_cost`` over the plain
     ``gather_norm_dot`` on ``meta`` tensors, int8 >= 2.5x and bf16 >=
     1.5x f32) and the CUDA ``gather_norm_dot`` timed per storage mode at
     the record's shape (n 2^17, d 128, B 128, W 48; each launch its own
     ids, a graph of 20 replayed after an L2 eviction) against its byte
     bound, each mode held to its plain version first; the kernel must
     have launched.  Then one dry-run cell, ``rwkv6-1.6b decode_32k`` on
     the 16 x 16 production mesh (``dryrun.build_cell``: one rank's
     decode on ``FakeTensor``s under the ``fake`` process group, nothing
     on the card): no error, a compute term, a rank's total bytes under
     80 GB; its record is printed;
  2. host-built serve (the first slice's path) — ``repro_torch.launch.
     serve.main`` builds an 8,192-vector d = 128 index on the host with
     ``--build-backend ops`` (the host search, every hop's distances
     through the ``gather_norm_dot`` kernel on the card; m = 16,
     ef_construction = 64, o = 4) and serves 256 queries of the paper's
     mixed workload (in-range fractions 2^-10 .. 2^0), k = 10, width = 64,
     for vec_dtype {f32, int8, bf16} x visited {bitmap, hash} x compact
     {none, (8, 8)}, each through the kernel and through the plain torch
     version.  Checks: the kernel was launched by the build and in every
     kernel configuration; kernel and plain runs agree under the tie rule
     (``compare_results``: ids, DC and hops equal, dists within 1e-5 of the
     terms, differing queries only as tie flips, at most 2%); f32
     recall@10 >= 0.90; int8 within 0.03 and bf16 within 0.01 of f32;
  3. device build + ingest (the second slice's path) — ``serve.main`` with
     ``--build-backend device`` builds N_DEVICE vectors (d = 128, the same
     parameters, micro-batch 128, f32) on the card, serves the 256 queries
     through pipeline {fused, reference} x visited {bitmap, hash} x compact
     {none, (8, 8)}, each through the kernels and the plain versions, then
     ingests 4,096 more vectors with the device backend, refreshes the
     snapshot incrementally and re-serves.  Checks: ``gather_norm_dot``
     launched by the build and the ingest, by every fused kernel run and
     by no reference run; ``batched_dot`` launched by every reference
     kernel run and by no fused run; kernel vs plain and reference vs
     fused agree under the tie rule, before and after the ingest; the
     compacted runs (hop chunks replayed as CUDA graphs) equal the eager
     lock-step runs bitwise through the kernels, and through the plain
     versions too unless this run shows that the plain versions' results
     depend on the batch size (compaction shrinks the batch; their einsum
     goes to cuBLAS): then under the tie rule; f32 recall@10 >= 0.90
     before and after the ingest.  Then, on the device-built index, one
     8-hop chunk captured as a CUDA graph (``_GraphedChunk``) against the
     eager ``_run_hops`` from the same state, for every pipeline x visited
     x backend of a serving search and for a construction search: state
     bitwise equal, times of both, and the captured chunks' shared memory
     pool in bytes;
  4. int8 device build — ``--build-backend device --vec-dtype int8`` at
     n = 8,192, served fused through the kernel: its recall@10 within 0.03
     of phase 2's f32 recall on the same workload;
  5. trace — ``torch.profiler`` over one warm batch of each pipeline,
     lock-step and compacted, on the device-built index, and over one
     device-build micro-batch of 128 inserts: wall time, device busy time
     (union of kernel/copy spans), the device's idle share, device-to-host
     copies (host syncs) and the top device ops (traces in
     ``build/*_trace.json``).  The wrappers count only the launches they
     make, not those of replayed CUDA graphs, so each traced run also
     checks that the kernel events the profiler recorded equal the
     wrappers' launches plus one per replayed hop (``GRAPH_REPLAYS``);
     each profiler session opens with a prelude of spin kernels that
     takes the profiler's loss of a session's first records (``_trace``);
  5b. engine — the request-lifecycle ``ServeEngine`` on the device-built
     index of phase 3 (its current snapshot; no second build), through
     ``repro_torch.launch.serve._serve_engine`` with ``backend="cuda"``
     and then ``"ref"``, m/k/width as above, max_wave 64: per backend
     ``warmup()`` then three runs over the 256 queries, each its own
     engine: (a) a closed burst — recall@10 >= 0.90, through the kernel
     every undegraded reply (ids, dists, hops, DC) equal to the kernel's
     one-shot ``search_batch`` bit for bit (the plain versions: the tie
     rule); (c) the same burst on the same snapshot under a deadline at
     (a)'s p50 latency: degraded replies > 0, each a valid prefix
     (distances sorted, at least one id, no more hops than in (a), some
     with fewer; through the kernel a late one with all its hops equal to
     (a)'s reply, an expired one empty); (b) open-loop arrivals at half
     of (a)'s QPS while 4,096 rows (attributes above every query range)
     are ingested through ``submit_ingest`` with the device build: ingest
     rows/s, whether the snapshot refreshed, the graph cache before and
     after.  Each run prints QPS, latency p50/p95/p99 from
     admission to reply, waves, chunks, shed waves, degraded and expired
     counts, the chunk schedule, the ``gather_norm_dot`` launches and
     replayed hops (one of the two > 0 in every kernel run, none in a
     plain run) and the graph captures after warm-up; (b) also prints its
     captures after warm-up split into serving chunks (which must be 0:
     its ingest stays within the snapshot's capacity) and the device
     build's construction-search chunks (``CaptureCounter``), its rows/s
     applied and its p99 beside those of the design whose every refresh
     re-keyed the graph cache (REKEYED_5B);
  5b2. guard — the capture guard (``repro_torch.analysis.CaptureCounter``)
     on the shape-stable-ingest contract, on the index as phase 5b leaves
     it (its pow2 capacities): a ``ServeEngine`` (kernel, bitmap, static
     knobs, max_wave 64, the host build for its ingest, as the JAX
     package's gate has it: the device build's own construction-search
     chunks are not the engine's) warms up and serves the 256 queries as a
     closed burst, then GUARD_WAVES more bursts with GUARD_ROWS rows
     (attributes above every query range) ingested in micro-batches of
     GUARD_BATCH, a quarter admitted with each burst and applied between
     its chunks, then a final burst.  Checks: the capacity (rows, unique
     values, layers) unchanged, no capture and no kernel build or load
     after warm-up, every reply bitwise the kernel's ``search_batch`` on
     the snapshot its wave launched with (waves in flight across a refresh
     finish on theirs), recall@10 >= 0.90.  Prints the warm-up seconds and
     captures, the serving set's bytes and copy-ins, one copy-in's time
     (CUDA events over 10) beside its bound (the set's bytes read and
     written over 3.35 TB/s), rows/s, QPS, p50/p99, the launches and
     replayed hops;
  5c. durable — the durable lifecycle (``repro_torch.persist``) on the
     same index of phase 3 (after phase 5b's ingests; no second build),
     under a fresh ``tempfile.mkdtemp()`` root removed at the end:
     (1) a full checkpoint (seconds, MB, MB/s); (2) the cold start:
     ``load_serving_snapshot`` (mapped slabs), ``to_device_index``, the
     256 queries through ``search_batch``'s body with the kernel (ms to
     map, to the device index, to the first reply); the replies must equal
     those of ``take_snapshot(materialize(load_state(root)))`` and of the
     live index bit for bit (ids, dists, hops, DC), and
     ``gather_norm_dot`` must have launched; (3) ``open_durable(root)``
     and a ``ServeEngine`` on it (device build, ``ingest_batch`` 128)
     ingest 1,024 rows with attributes above every query range, in 8
     ``submit_ingest`` acks of 128 while the 256 queries are served: ack
     latency p50/p99, fsyncs, rows/s applied; (4) a second engine on the
     same index and log acks 256 more rows under
     ``EngineFaultPlan(crash_after_ingest_applies=1)`` and dies entering
     the second apply; both engines and the index are dropped without a
     checkpoint and ``recover(root)`` replays the 10 records through the
     device build: its ``state_digest`` must equal a twin's
     (``materialize`` of the checkpoint + the same ten 128-row micro-
     batches through the device build, no log) and that of the phase-3
     index after the same micro-batches (its build's delta-maintained
     arena against the replay's fresh one), the engine's index before the
     crash must equal the twin after nine, the replies through the kernel
     must be bitwise the twin's and the phase-3 index's, and the replay
     must have launched ``gather_norm_dot`` (recover seconds, materialize
     and replay, replayed rows/s); (5) an incremental checkpoint of the
     recovered index (a delta; seconds and MB beside the full one's);
  5d. cluster — replication and the serving cluster
     (``repro_torch.persist.replicate``, ``repro_torch.serve.cluster``) on
     the phase-3 index after phase 5c (no second build), under a fresh
     ``tempfile.mkdtemp()`` root removed at the end; every member's
     engine serves through the kernel (``backend="cuda"``, the device
     build, static knobs).  Leg (a), three members in this process: (1) a
     full checkpoint of the index is member n0's root, ``Cluster`` opens
     it as the primary (quorum 2, the majority) and the two replicas
     stream it (seconds, MB, chunks, MB/s, materialize seconds each), all
     three ``state_digest`` equal to the index's; (2) 1,024 rows in 8
     quorum-durable ``submit_ingest`` acks of 128 (attributes above every
     query range), stepping between them: ack p50/p99, rows/s to
     quorum-durable and applied, each replica's lag and the graph
     captures; each replica durable through the last ack, its log ending
     there, the digests equal; (3) ``warmup()``, then the 256 queries
     through ``Cluster.submit``/``drain``: QPS, latency p50/p95/p99,
     replies per member, degraded; every reply bitwise the kernel's
     ``search_batch`` on the primary's snapshot, no capture after
     warm-up, recall@10 >= 0.90; (4) 64 queries in flight, ``kill("n0")``
     and steps on the real clock until the heartbeat timeout promotes a
     replica: every query answered once, one unplanned failover to epoch
     1 (on disk too), no acked LSN lost, the promoted index equal to
     ``recover(n0's root, upto_lsn=the promotion LSN)``; (5) 128 rows
     acked under epoch 1 at the next LSN, n0 rejoins as a replica, then
     ``rolling_restart()`` with 64 queries outstanding: each answered
     once, three restarts and one handover, every member back and the
     digests equal.  Leg (b): a primary in a child process that imports
     only the port opens a copy of (1)'s checkpoint on the card, streams
     it over localhost TCP to a ``ReplicaReplicator`` here (both
     ``SocketEndpoint``s), ingests batches of 128 with quorum 2 and
     SIGKILLs itself after its 4th ack: return code -SIGKILL, 4 acks,
     the replica durable through the 4th, the primary dead after the
     heartbeat timeout, ``promote()`` to epoch 1, the promoted index
     equal to the child's disk recovered at its LSN, and a
     ``ServeEngine`` on it answering the 256 bitwise ``search_batch``
     through the kernel (the child's start-up seconds, bootstrap MB/s,
     ack p50, kill to promotion).  The kernel's launches are counted per
     step and must be > 0 where the path runs it;
  5e. sharded — the sharded build and mesh serving
     (``insert_batch(backend="sharded")``, ``repro_torch.core.
     distributed``, ``repro_torch.parallel``), run after phase 7, the
     last before the report: in the one run where a traced phase
     followed its spawned ranks, the profiler lost kernel events of the
     Jamba prefill (one of its four ``mamba_scan`` launches); whether the
     ranks caused that is not known, so no traced phase follows them.
     First the hop loop's query norms
     (``device_search._row_sq``) at D in {128, 3,584}: every row's bits
     at B = 1..300 equal its bits at B = 300, where torch's plain row
     sum is also counted (on the card it splits a short row over more
     threads below 16 rows).  The first N_SHARDED =
     2,048 rows of phase 3's stream (d 128, m 16, ef_construction 64,
     micro-batch 128, f32; a time cut: phase 3's 32,768 rows took ~120 s a
     build, and 8,192 rows, then 4,096, this phase's size before phase 7c
     came and then gated its second step, left too little of the time
     limit) are built three ways on the card: ``backend="device"``,
     ``"sharded"`` at ``shards=1`` in this process, and ``"sharded"`` on
     SHARDED_RANKS = 2 ranks sharing the one card (processes spawned by
     ``torch.multiprocessing``, joined by gloo over a ``FileStore``, each
     importing only the port).  Checks: every build's neighbor arrays and
     ``state_digest`` bitwise equal across the builds and on both ranks,
     and the ranks' arenas hold the same bytes.  Prints each build's
     rows/s, launches, replayed launches and graph captures, and per rank
     its phase-1 seconds (the sharded searches, gathers included), its
     gather ms and the rest of its build (the phase-2 commit and the
     carry).  Then ``make_serving_fn`` (kernel, lock-step) on a 1 x 1
     mesh over phase 3's index (its current snapshot, full size) with the
     256 queries: with the adaptive hashed filter and with the bitmap,
     each reply bitwise ``search_batch`` at the same filter, the hash
     run's histogram that of ``search_batch``'s hops; and on a 2 x 1 mesh
     over the two ranks (each serving the index it built): every rank's
     gathered result and histogram equal to the 1 x 1 run on the device
     build's index in this process.  Prints QPS and the p50 of 5 timed
     waves of each.  ``gather_norm_dot`` must have launched in every path
     and on every rank, ``batched_dot`` never; a rank that fails or hangs
     fails the phase;
  6. LM serve — ``repro_torch.serve.LMServer`` serves qwen2-7b (28
     layers, d 3,584, 28/4 heads x 128, d_ff 18,944, vocab 152,064) in
     f32, the same model again in bf16 (15.2 GB; ``compute_dtype=torch.
     bfloat16``, the tensor-core ``flash_attention``, Jamba's bf16 rule
     below), then rwkv6-1.6b (24 layers, d 2,048, 32 heads x 64, d_ff
     7,168, vocab 65,536) in f32, at full width, weights from
     ``init_params`` with a generator seeded 0 (plus small noise from it
     on the tensors JAX initialises to zero: the QKV biases; the LoRA
     up-projections, the decay LoRA and u).  Three batches of 8 greedy
     requests, prompts of
     T in {512, 1,000, 2,048} tokens, 32 decoded tokens each (max_len =
     T + 32), each batch through the kernels (``backend="auto"``) and the
     plain versions (``"ref"``); then ``embed`` of 8 x 64 tokens both ways.
     Checks: ``flash_attention`` (qwen) / ``wkv6`` (rwkv) launched once a
     layer by every kernel prefill and embed and never in decode, no kernel
     launched by a plain run; last-position prefill logits within
     LM_REL_TOL of max |logit|, kernel against plain; generated tokens
     equal, or the plain run's top-2 margin at the first step that differs
     below LM_REL_TOL * max |logit| (a near tie); the embeds within
     LM_REL_TOL of max |embed|, or within 4x how far a one-ulp
     perturbation of the input embeddings moves the plain embed, whichever
     is larger (the run measures its own conditioning).  Prints each
     batch's prefill ms (time to first token), decode ms per token and peak
     device memory (after one warm-up request per backend), and traces one
     T = 2,048 kernel prefill and one decode step after it, for each model
     (device busy, idle share, each kernel's share, top device ops).  Each
     model's weights are freed before the next is built.  In the bf16
     run of qwen2-7b, the RAG phase reuses its weights:
     ``repro_torch.serve.RagPipeline`` at full width (d 3,584, f32 slab,
     ``build_backend="device"``, m 16) embeds RAG_DOCS documents of 64
     seeded tokens (years 1990-2024), 512 a call, retrieves 256 queries
     of 16 tokens under mixed year ranges (``retrieve_batch``, k 5, width
     48), ingests 512 more documents, re-serves, and serves the same 256
     through ``engine()`` (after ``warmup()``), whose replies must equal
     ``retrieve_batch``'s bit for bit; ``gather_norm_dot`` at D = 3,584
     (B 256, K 17, the pipeline's own table and query embeddings) held to
     its plain version and timed like phase 7's cases; ``flash_attention``
     launched 28 times by every embed; the kernel path's embeds of 512
     documents x 64 tokens and of the 256 queries x 16 held to a
     ``backend="ref"`` server's on the same weights by the embed rule
     above (LM_REL_TOL of max |embed| or 4x the one-ulp sensitivity).  Prints docs embedded/s, ingest
     rows/s, the batch latency, recall@5 against brute force (not gated:
     random-weight embeddings), the launches.  Its durable leg: a
     ``RagPipeline(index_dir=...)`` embeds 512 of the documents with the
     device build and a logged ingest and writes a checkpoint; a second
     pipeline on the directory cold-starts off it and serves the 256
     queries, bitwise the first's ``retrieve_batch``; 64 more documents go
     in through its lazy recovery and it serves again (every reply in its
     range; 5 embeds of 28 ``flash_attention`` launches);
  6b. Jamba serve — the same batches, checks and traces for
     jamba-1.5-large-398b at full width (d 8,192, d_ff 24,576, 64/8 heads
     x 128, 16 experts top-2 on odd layers, Mamba expand 2, d_state 16,
     vocab 65,536) cut from 72 to the first 5 layers of its pattern
     (Mamba + MLP, Mamba + MoE, Mamba + MLP, Mamba + MoE, attention +
     MLP; 24.05 B parameters, 44.8 GiB in bf16): an 8-layer unit is
     45.2 B parameters, 84.3 GiB in bf16, more than the card holds, and
     these five layers are the shortest prefix that holds every kind of
     layer the model has.  bf16 weights (``init_params``, a generator
     seeded 0, plus noise from it on ``mamba.conv_b``, which JAX
     initialises to zero) served with ``compute_dtype=torch.bfloat16``.
     Checks: ``mamba_scan`` launched 4 times and ``flash_attention`` once
     by every kernel prefill and embed, no kernel in decode or in a plain
     run.  In bf16 the kernels' f32 rounding can move an output by one
     bf16 ulp, so the run measures its own conditioning: how far a
     one-ulp bf16 perturbation of the input embeddings moves the plain
     path's last-position logits (per batch) and its embed; kernel and
     plain logits must agree within max(LM_REL_TOL * max |logit|, 4x
     that), tokens be equal or a near tie at that tolerance, and the
     embed the same with its own sensitivity.  The traced T = 2,048
     prefill must show 4 ``mamba_scan`` and 1 ``flash_attention`` events;
     each trace prints its GEMM share;
  7. kernels — each kernel against its plain version on the card, with
     tolerance rtol 1e-5 + atol 1e-5*|v|*|q|: ``gather_norm_dot`` at the
     serving shapes (B in {8, 256}, K = 17, D = 128, n = 32,768) and a
     deployment-size table (n = 2^21 x D = 128; B = 128, K = 48), in
     f32/bf16/int8; ``batched_dot`` at B in {8, 256}, K = 17, D = 128,
     B = 128, K = 48, D = 128, and D in {24, 33} (the scalar tail).  Median
     time per launch (CUDA events over 20 launches, 5 rounds, after
     warm-up) beside the plain version's, ``torch.bmm``'s for
     ``batched_dot`` (the one PyTorch call for the same function), and the
     bound (bytes over 3.35 TB/s or flops over 67 TFLOP/s f32, whichever is
     larger); for kernels of a few us those times are the host's enqueue
     rate, so each is also timed device to device (``device_ms``,
     ``plain_device_ms``, ``library_device_ms``): the 20 launches captured
     as one CUDA graph, its replay timed by CUDA events (for
     ``batched_dot``, the kernel's, the plain version's and
     ``torch.bmm``'s graphs replayed in turns, 11 rounds, so that the
     ratio compares them under the same clock; for ``gather_norm_dot``,
     the kernel's and the plain version's, and for its 2^21-row table
     after evicting L2 before each replay, as a gather from a table far
     larger than L2 finds it: ``_cold_l2``).
     ``flash_attention`` at qwen2-7b's prefill (B 8, T 2,048,
     Hq 28, Hkv 4, D 128) in f32 and bf16, at Jamba's (64/8 heads, bf16),
     at T = 1,000 (the ragged tail) in f32 and bf16, at h2o-danube-3-4b's
     (B 1, T 8,192, Hq 32, Hkv 8, D 120, window 4,096) in f32 and bf16
     and with a q_offset (512 queries after 1,536 cached keys), against
     ``mha_ref`` on the inputs upcast to f32 within ``ref.mha_tolerance``
     (f32: 2e-4; bf16: 2e-4 + 2^-8 |ref| for the output rounding + 2^-8
     ``mha_ref(q, k, |v|)`` for the probabilities rounded to bf16 on the
     tensor cores), beside ``scaled_dot_product_attention``
     (``library_ms``; nothing in the port calls it), with the TFLOP/s
     achieved, the share of the bound's rate and the ratio to
     ``scaled_dot_product_attention``'s time; bound: bytes over 3.35 TB/s
     or the unmasked flops over 989 TFLOP/s bf16, and for f32 three times
     the flops over 495 TFLOP/s TF32 (the kernel's 3xTF32 split: three
     TF32 products for each f32 one), with the bound on the CUDA cores
     (flops over 67 TFLOP/s) beside it.  ``wkv6`` at
     rwkv6-1.6b's prefill (B 8, H 32, N 64, T in {2,048, 1,000}) from a
     nonzero state against ``wkv6_ref`` and ``wkv6_chunked`` within rtol
     and atol 3e-4 (no single PyTorch call computes it).
     ``mamba_scan`` at Jamba's prefill (B 8, T 2,048, di 16,384, N 16)
     with A and dt as Mamba's init draws them (A = -(1..N), dt
     log-uniform on [1e-3, 1e-1], the main path's draw), its first 256
     channels against a scan in f64 within rtol and atol 2e-5 (the JAX
     package's tolerance for this kernel; the f32 plain version is itself
     off the f64 scan where decays stay close to 1); then at Jamba's
     prefill, at T = 1,000, at a ragged di (B 2, T 100, di 200) and at
     T = 1 with dt = softplus(randn - 1), f32 from a nonzero h0, against
     ``mamba_scan_ref`` within the same 2e-5 (no single PyTorch call
     computes it); bound: bytes over 3.35 TB/s or 6 flops per
     (b, t, d, n) over 67 TFLOP/s f32, with the exponentials counted
     beside it, and the SFU bound beside that (every exponential on the
     SFUs, at 16 a clock per SM at the card's maximum SM clock).
     ``batched_dot``'s device time is also given as a ratio to
     ``torch.bmm``'s (``device_to_bmm``, per shape);
  7b. train — training on the card (``repro_torch.train``), run after
     phase 7 and before phase 5e, with the previous model freed.  Leg
     (a), full width: qwen2-7b (d 3,584, 28/4 heads x 128, d_ff 18,944,
     vocab 152,064) cut in depth to its first TRAIN_LAYERS = 2 layers (as
     phase 6b cuts Jamba), f32 master weights from ``init_params`` (a
     generator seeded 0), bf16 compute, f32 AdamW moments; the bytes of
     parameters, gradients and moments are reckoned from
     ``abstract_params`` (the ``meta`` device) before anything is
     allocated.  ``make_train_step(microbatches=1)`` with a zero learning
     rate (the weights stay as they are) gives step 1's loss and grad
     norm on the first batch; then ``make_train_step(microbatches=2,
     remat=True)`` runs TRAIN_STEPS = 4 steps on ``DataConfig(kind=
     "random")`` batches of 8 x 512 tokens (the Markov source's V x V
     table would be 185 GB at this vocabulary).  Checks: step 1 equals
     the one-microbatch step within TRAIN_MICRO_TOL, the loss absolute and
     the grad norm relative (read on an H100 80GB HBM3 at 700 W: loss
     equal to 6 decimals, grad norm 1.8e-6 apart; ``tests/test_train.py``
     allows 2e-3 and 2e-2, which would miss a small accumulation fault);
     every loss finite, step 1's within 0.5 of ln 152,064; every
     parameter received a gradient (its first moment is nonzero) and
     changed.  Prints each step's ms,
     tokens/s, the model FLOP/s against 6 x (the layers' and the head's
     parameters) x tokens plus the rematerialised forward of the layers
     (2 x their parameters x tokens), the peak device memory beside the
     reckoning, and the AdamW update's own time (CUDA events, three
     updates) as a share of the step; a fifth step is traced (device busy,
     idle share, GEMM share, top ops) and must show no kernel event.  The trained parameters are then
     served as they are (f32) through ``LMServer``: a prefill of 2 x 256
     prompts through ``backend="auto"`` against ``"ref"``, the
     last-position logits within LM_REL_TOL of max |logit|,
     ``flash_attention`` launched once a layer.  Leg (b), resume: the
     reduced qwen2-7b on Markov data as ``launch.train --reduced`` sets it
     up (vocab 256, seq 64, global batch 16, lr 1e-3, warmup 8 of 40): a
     ``Trainer`` runs 20 steps with a checkpoint every 10 and
     ``finish()``es, a new ``Trainer`` on the directory resumes at step
     20 and runs 20 more, and an uninterrupted 40-step ``Trainer`` runs in
     another directory (both under a ``tempfile.mkdtemp()`` root removed
     at the end).  Checks: the two runs' parameters, moments and step
     equal bit for bit, and their logged losses; step 40's loss below
     step 1's and nearer the chain's entropy rate; then ``python -m
     repro_torch.launch.train --arch qwen2-7b --reduced --steps 20
     --device cuda`` exits 0 in a subprocess;
  7c. mesh train — the train step over a mesh of ranks
     (``train.jit_train_step``: ZeRO-3 by ``parallel.param_shardings``
     with ``RULES_TP_FSDP``, per-layer all-gather over the FSDP axes in
     bf16 and reduce-scatter, tensor and expert parallelism over
     ``model``; gloo staged through the host), run after phase 7b: two
     legs of MESH_RANKS = 2 processes spawned as phase 5e spawns its
     ranks, both on the one card, phase 7b's model (qwen2-7b at full
     width cut to 2 layers, f32 master weights from the same seeded
     generator, bf16 compute, f32 moments), its optimizer and batches,
     MESH_STEPS steps of 8 x 512 tokens in 2 microbatches.  Leg (a), a
     ``(data 2, model 1)`` mesh, each rank taking 4 rows of a
     microbatch: step 1's loss within TRAIN_MICRO_TOL and its grad norm
     within 2e-2 relative (the reference's own bar); step 2, after the
     sharded AdamW update, its loss and grad norm within MESH_STEP2_TOL
     (absolute, relative) of phase 7b's step 2; each rank's resident
     parameter and moment bytes are half of phase 7b's (12 bytes a
     parameter), within one row of the widest leaf for the three tensors
     (the leaves the spec leaves whole, the QKV biases, sit on both
     ranks).  Leg (b), a ``(data 1, model 2)`` mesh, each rank computing
     its half of every head, mlp column and vocab row of all 8 rows:
     MESH_TP_TOLS (the CPU 2 x 2 test's bf16 bars: step 1's loss within
     1e-3 and grad norm within 2e-2 relative, step 2's within 5e-3 and
     2e-2); resident bytes half of phase 7b's within the leaves that
     stay whole over ``model`` (the norms); no parameter gather in
     either step.  Leg (c), after it in the same spawn: the (data 1,
     model 2) leg again under ``residual_spec = RES_SPEC`` (the batch
     rows of the residual stream split over ``model`` between the
     layers, 2 rows a rank a microbatch: each product's input gathered
     and its output reduce-scattered), with leg (b)'s bars and checks;
     then, on the same ranks with the trained weights at f32 compute,
     RES_SERVE: a prefill of 2 x 510 seeded tokens (one row a rank
     between the layers, ``flash_attention`` on the gathered rows, one
     launch a layer a rank) into a 516-slot cache of the rank's 2 kv
     heads and one greedy decode step, held to the one-rank forward on
     the card within LM_REL_TOL of max |logit|; the launches join the
     ``flash_attention`` row.  All legs: both ranks report the same
     metrics.  Prints each step's ms, the gathers', reduce-scatters' and
     all-reduces' n, ms and bytes (the ``model`` group's by kind, with
     the ring model's wire bytes a rank), each rank's peak device bytes;
  7d. expert parallelism over ``data`` and sequence-parallel attention
     (cut in depth as phase 7b cuts it, full width; each leg prints an
     ``ok`` line with the card's name and power limit).  Leg (a) runs in
     phase 7c's spawn, its third leg: first, in this process, the one-rank
     plain step of EP_ARCH = qwen2-moe-a2.7b (d 2,048, 16/16 heads x 128,
     60 experts padded to 64, top-4, expert ff 1,408, 4 shared, vocab
     151,936) cut to TRAIN_LAYERS = 2 layers, f32 master weights from a
     generator seeded 0, bf16 compute and bf16 AdamW moments, MESH_STEPS
     steps of phase 7b's batches (8 x 512 in 2 microbatches), freed after;
     then the ranks as a ``(data 2, model 1)`` mesh under
     ``RULES_EP_DATA`` and the ``moe_ep_data`` preset: each expert leaf's
     experts on ``data``, never gathered nor reduce-scattered, the tokens
     sent to them by an all-to-all over ``data``.  Checks: phase 7c (data
     2, model 1)'s bars against the one-rank steps (step 1 loss within
     TRAIN_MICRO_TOL, grad norm 2e-2 relative; step 2 within
     MESH_STEP2_TOL); every rank's gathered bytes equal, exactly, the
     reckoned bytes of the non-expert leaves (the top-level leaves once in
     f32, each layer's bucket in bf16 in each microbatch's forward and its
     rematerialised backward) and no expert leaf is in a bucket; resident
     bytes half of the one rank's 8 bytes a parameter, within a row of the
     widest leaf; all-to-alls ran.  Prints both byte counts and the
     all-to-alls' n, ms and GB a rank.  Leg (b) (the ``seq_parallel``
     phase, its own spawn of SEQ_RANKS = 3 ranks on the card): phase 7b's
     model as ``(data 1, model 3)`` under SEQ_TUNE (``seq_parallel_attn,
     cache_seq_shard``; 28 q and 4 kv heads divide 3 neither, so each rank
     attends for its slice of the 512 query rows, 171/171/170, and the
     rows are all-gathered over ``model``; the vocab splits 3 ways, the
     rest is whole): 2 steps against phase 7b's with MESH_TP_TOLS, no
     parameter gather, each rank's parameters and their f32 state
     reckoned beside its peak bytes.  Then, on the same ranks with the
     trained weights at f32 compute, SEQ_SERVE: a prefill of 2 x 510
     seeded tokens into a 516-slot cache, 172 slots a rank, through the
     CUDA ``flash_attention`` at ``q_offset`` > 0 (one launch a layer a
     rank), then 4 greedy decode steps on the split cache (flash-decoding
     across ``model``), held to the one-rank forward on the card (rank 0,
     the split leaves sent to it) fed the same tokens: every step's
     logits within LM_REL_TOL of max |logit|, tokens equal or a near tie
     at that tolerance, each rank's cache ``[2, 172, 4, 128]`` a layer;
     the kernel's launches join the ``flash_attention`` row;
  8. report — the kernels JSON line, then the ok line last.  The WoW
     kernels' entries add ``executions``: the wrapper's launches in the
     device-build phase plus the launches that the phase's replayed hop
     graphs ran (``device_search.KERNEL_REPLAYS``); ``gather_norm_dot``'s
     adds ``device_by_case``, its device time in us at each of the nine
     cases, and ``rag_d3584``, its case at the RAG width; both kernels of
     the engine, durable and RAG paths add ``launches_by_path``;
     ``gather_norm_dot``'s ``launches`` are the device-build phase's plus
     the durable, cluster and sharded phases', and its entry adds those
     phases' numbers under ``durable``, ``cluster`` and ``sharded``.

N_DEVICE is 2^14, a time cut of a million-vector deployment: at 2^16 the
device build took 217-278 s on H100s (PERF.md), and with phase 7c's second
leg the whole smoke took 1,188 s of its 1,200 s limit on a slow machine, so
it went to 2^15 (the build 137-146 s); phase 7d then brought the whole
smoke to 1,040.8 s on a normal machine, and 2^14 halves the build again and
shrinks the phases that serve, log and replicate its index.

Needs one card; exits non-zero without CUDA or outside a checkout of the
repository, before printing any result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CARD = ["card not read"]  # name and power limit, as nvidia-smi gives them
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
TIE_FLIP_SHARE = 0.02
N_HOST = 8192  # host-built (ops) serve phase
N_DEVICE = 16384  # device-build phase (see the module docstring)
N_INGEST = 4096
QUERIES = 256
RAG_ARCH_RUN = "qwen2-7b-bf16"  # the LM run the RAG phase rides on
RAG_DOCS = 4096  # corpus documents (64 seeded tokens each)
RAG_INGEST = 512
RAG_QUERIES = 256
CLUSTER_INGEST = 1024  # cluster leg (a): rows acked through the primary
CLUSTER_BATCH = 128  # rows an ack (both legs)
CLUSTER_OUTSTANDING = 64  # queries in flight at the kill and the restart
SIGKILL_BATCHES = 6  # cluster leg (b): the child's batches
SIGKILL_ACKED = 4  # ... it SIGKILLs itself after this many acks
GUARD_ROWS = 1024  # phase 5b2: rows ingested within the snapshot capacity
GUARD_BATCH = 128  # ... in micro-batches of this many rows
GUARD_WAVES = 4  # ... spread over this many bursts of the queries
# phase 5b (b) before the refresh kept the engine's graphs: every refresh
# re-keyed the graph cache (chip_smoke.py's phase 5b (b) then, on an H100
# 80GB HBM3 at 700 W)
REKEYED_5B = "31-32 captures, 31-36 rows/s applied, p99 5.4 s"
N_SHARDED = 2048  # phase 5e: rows of phase 3's stream built three ways
SHARDED_RANKS = 2  # phase 5e: ranks on the one card
SHARDED_KW = dict(m=16, ef_construction=64, o=4, seed=0)  # phase 3's
LM_PROMPTS = (512, 1000, 2048)  # prompt lengths of the LM serve batches
LM_BATCH = 8
LM_DECODE = 32
LM_EMBED = (8, 64)  # embed: queries x tokens
LM_REL_TOL = 1e-4  # kernel vs plain, relative to max |logit| (or |embed|)
JAMBA = "jamba-1.5-large-398b"
TRAIN_ARCH = "qwen2-7b"  # phase 7b: full width, cut in depth
TRAIN_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 512, 2, 4
TRAIN_SERVE = (2, 256)  # the serve-after-train prefill: batch x tokens
TRAIN_MICRO_TOL = 1e-4  # 2 microbatches against 1: loss abs., grad norm rel.
RESUME_STEPS = 20  # leg (b): steps before and after the resume
MESH_RANKS, MESH_STEPS = 2, 2  # phase 7c: ranks on the one card, steps
MESH_NORM_TOL = 2e-2  # phase 7c: grad norm against 7b's, relative
# phase 7c step 2 (after a sharded AdamW update) against 7b's step 2: the
# loss absolute, the grad norm relative (read 1.42e-4 and 8.4e-5 before
# this gate on the H100, from bf16 gradients that round elsewhere)
MESH_STEP2_TOL = 1e-3
# phase 7c (data 1, model 2): the CPU 2 x 2 test's bf16 bars, (loss
# absolute, grad norm relative) at steps 1 and 2
MESH_TP_TOLS = ((1e-3, 2e-2), (5e-3, 2e-2))
EP_ARCH = "qwen2-moe-a2.7b"  # phase 7d (a): full width, TRAIN_LAYERS deep
EP_TUNE = "moe_ep_data"
SEQ_RANKS = 3  # phase 7d (b): a (data 1, model 3) mesh on the one card
SEQ_TUNE = "seq_parallel_attn,cache_seq_shard"
SEQ_SERVE = (2, 510, 516, 4)  # batch, prompt tokens, cache slots, decodes
# phase 7c leg (c): the residual stream's batch rows split over model
RES_SPEC = (("data", "model"), None, None)
RES_SERVE = (2, 510, 516, 1)  # batch, prompt tokens, cache slots, decodes
LM_MODELS = {  # run -> arch, kernel launches per prefill or embed, the
    # tensors given seeded noise (JAX's zero inits, and the rwkv bonus u),
    # the weights' and compute type, and the depth cut (layers, or None)
    "qwen2-7b": dict(arch="qwen2-7b", launches={"flash_attention": 28},
                     noise=("attn.bq", "attn.bk", "attn.bv"),
                     dtype=torch.float32, layers=None),
    "qwen2-7b-bf16": dict(arch="qwen2-7b", launches={"flash_attention": 28},
                          noise=("attn.bq", "attn.bk", "attn.bv"),
                          dtype=torch.bfloat16, layers=None),
    "rwkv6-1.6b": dict(arch="rwkv6-1.6b", launches={"wkv6": 24},
                       noise=tuple(f"rwkv_tm.lora_b_{m}" for m in "wkvrg")
                       + ("rwkv_tm.decay_b", "rwkv_tm.u"),
                       dtype=torch.float32, layers=None),
    JAMBA: dict(arch=JAMBA, launches={"mamba_scan": 4, "flash_attention": 1},
                noise=("mamba.conv_b",), dtype=torch.bfloat16, layers=5),
}
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")  # cuBLAS kernel names
PRELUDE = 256  # spin kernels that open each profiler session (``_trace``)
PRELUDE_CYCLES = 1_000_000  # ... of about 0.5 ms each
COMMON = ["--dim", "128", "--queries", str(QUERIES), "--k", "10",
          "--width", "64", "--m", "16", "--ef-construction", "64",
          "--o", "4", "--build-batch", "128", "--device", "cuda"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def reset_counts() -> None:
    from repro_torch.core.device_search import GRAPH_REPLAYS, KERNEL_REPLAYS
    from repro_torch.kernels import launch_counters

    for c in (*launch_counters(), GRAPH_REPLAYS, KERNEL_REPLAYS):
        for key in c:
            c[key] = 0


def read_replays() -> dict:
    from repro_torch.core.device_search import GRAPH_REPLAYS

    return dict(GRAPH_REPLAYS)


def read_counts() -> dict:
    from repro_torch.kernels import launch_counters

    return {k: v for c in launch_counters() for k, v in c.items()}


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.time()
    names = _build.build_all()
    print(f"built {names} in {time.time() - t0:.2f}s")
    for name, log in _build.BUILD_LOG.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}")


def _scale(out: dict, snap=None) -> float:
    """|v|^2 + |q|^2 bound of a distance's terms (the tie rule's scale)."""
    snap = snap or out["snapshot"]
    wl = out["workload"]
    return float(snap.sq_norms.max() + (wl.queries**2).sum(1).max())


def _agree(tag: str, a, b, scale: float) -> int:
    from repro_torch.core.device_search import compare_results

    rep = compare_results(a, b, scale=scale)
    if rep["faults"] or len(rep["tie_flips"]) > TIE_FLIP_SHARE * QUERIES:
        fail(f"{tag}: results differ {rep}")
    return len(rep["tie_flips"])


def phase_host_serve() -> dict:
    from repro_torch.launch import serve

    args = ["--n", str(N_HOST), *COMMON, "--build-backend", "ops",
            "--vec-dtype", "f32", "int8", "bf16",
            "--visited", "bitmap", "hash", "--compact", "none", "8,8",
            "--backend", "cuda", "ref"]
    reset_counts()
    out = serve.main(args)
    counts = read_counts()
    if out["build_launches"]["gather_norm_dot"] <= 0:
        fail("ops build: gather_norm_dot was never launched")
    scale = _scale(out)
    runs = {(r["vec_dtype"], r["visited"], r["compact"], r["backend"]): r
            for r in out["runs"]}
    for (vd, vis, comp, backend), run in runs.items():
        if backend != "cuda":
            continue
        tag = f"host {vd}/{vis}/compact={comp}"
        if run["launches"]["gather_norm_dot"] <= 0:
            fail(f"{tag}: gather_norm_dot was never launched")
        plain = runs[(vd, vis, comp, "ref")]
        flips = _agree(f"{tag} kernel vs plain", run["result"],
                       plain["result"], scale)
        f32 = runs[("f32", vis, comp, "cuda")]["recall"]
        if vd == "f32" and run["recall"] < 0.90:
            fail(f"{tag}: f32 recall@10 {run['recall']:.4f} < 0.90")
        tol = {"f32": 0.0, "int8": 0.03, "bf16": 0.01}[vd]
        if run["recall"] < f32 - tol:
            fail(f"{tag}: recall {run['recall']:.4f} more than {tol} "
                 f"below f32 {f32:.4f}")
        print(f"ok {tag}: recall@10 {run['recall']:.4f}, "
              f"{run['qps']:.1f} QPS (plain {plain['qps']:.1f}), hops "
              f"p50 {run['hops_p50']:.0f} p99 {run['hops_p99']:.0f}, "
              f"launches {run['launches']}, tie flips {flips}")
    print(f"host-built serve path launches: {counts}")
    return {"launches": counts, "out": out,
            "f32_recall": runs[("f32", "bitmap", None, "cuda")]["recall"]}


def _check_device_runs(runs: list, scale: float, when: str,
                       plain_bitwise: bool) -> None:
    by = {(r["pipeline"], r["visited"], r["compact"], r["backend"]): r
          for r in runs}
    for (pipe, vis, comp, backend), run in by.items():
        tag = f"device-built {when} {pipe}/{vis}/compact={comp}/{backend}"
        if run["recall"] < 0.90:
            fail(f"{tag}: f32 recall@10 {run['recall']:.4f} < 0.90")
        own, other = (("batched_dot", "gather_norm_dot")
                      if pipe == "reference"
                      else ("gather_norm_dot", "batched_dot"))
        n = run["launches"]
        if backend == "cuda" and (n[own] <= 0 or n[other] != 0):
            fail(f"{tag}: launches {n} (expected {own} only)")
        if backend == "ref" and any(n.values()):
            fail(f"{tag}: the plain run launched kernels {n}")
        if comp is not None:  # compacted (graph replays) vs lock-step
            eager = by[(pipe, vis, None, backend)]["result"]
            if backend == "ref" and not plain_bitwise:
                # shown by plain_batch_dependence: the plain versions'
                # cuBLAS products round differently once compaction has
                # shrunk the batch, so only the tie rule holds
                _agree(f"{tag} compacted vs lock-step", run["result"], eager,
                       scale)
            elif not all((a == b).all() for a, b in zip(run["result"],
                                                         eager)):
                fail(f"{tag}: compacted (CUDA graph) results differ from "
                     "the lock-step eager loop")
        if backend != "cuda":
            continue
        plain = by[(pipe, vis, comp, "ref")]
        flips = _agree(f"{tag} kernel vs plain", run["result"],
                       plain["result"], scale)
        line = (f"ok {tag}: recall@10 {run['recall']:.4f}, "
                f"{run['qps']:.1f} QPS (plain {plain['qps']:.1f}), mean DC "
                f"{run['mean_dc']:.1f}, hops p50 {run['hops_p50']:.0f} p99 "
                f"{run['hops_p99']:.0f}, launches {n}, tie flips vs plain "
                f"{flips}")
        if pipe == "reference":
            fused = by[("fused", vis, comp, "cuda")]
            line += (", tie flips vs fused "
                     f"{_agree(tag + ' vs fused', run['result'], fused['result'], scale)}")
        print(line)


def plain_batch_dependence(di) -> bool:
    """Whether the plain versions give a row the same bits at every batch
    size the compaction driver runs (and under CUDA-graph capture): one
    draw of 256 x 17 candidates on the device-built table through
    ``gather_norm_dot_ref`` and ``batched_dot_ref`` (the plain evals of the
    two pipelines), and through the kernels, whose rows are independent."""
    from repro_torch.kernels.distance import batched_dot
    from repro_torch.kernels.gather_distance import gather_norm_dot
    from repro_torch.kernels.ref import batched_dot_ref, gather_norm_dot_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    n_live = int(torch.isfinite(di.attrs).sum())
    ids = torch.randint(0, n_live, (256, 17), device="cuda", generator=gen)
    q = torch.randn(256, di.vectors.shape[1], device="cuda", generator=gen)
    rows = di.vectors[ids]
    fns = {  # name -> (is the plain version, fn of the batch size)
        "gather_norm_dot_ref": (True, lambda b: gather_norm_dot_ref(
            di.vectors, ids[:b], q[:b])),
        "batched_dot_ref": (True, lambda b: (batched_dot_ref(rows[:b],
                                                             q[:b]),)),
        "gather_norm_dot": (False, lambda b: gather_norm_dot(
            di.vectors, ids[:b], q[:b])),
        "batched_dot": (False, lambda b: (batched_dot(rows[:b], q[:b]),)),
    }
    plain_same = True
    for name, (plain, fn) in fns.items():
        full = fn(256)
        diffs, max_err = {}, 0.0
        for b in (8, 16, 32, 64, 128):
            part = fn(b)
            diffs[b] = sum(int((p != f[:b]).sum()) for p, f in zip(part, full))
            max_err = max(max_err, *(float((p.double() - f[:b].double())
                                           .abs().max())
                                     for p, f in zip(part, full)))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = fn(256)
        graph.replay()
        torch.cuda.synchronize()
        cap = sum(int((c != f).sum()) for c, f in zip(captured, full))
        print(f"{name}: elements differing from the B = 256 result, by "
              f"batch size {diffs} (max abs diff {max_err}); captured vs "
              f"eager at B = 256: {cap}")
        if cap or (not plain and any(diffs.values())):
            fail(f"{name}: rows change under capture or with the batch size")
        if plain and any(diffs.values()):
            plain_same = False
    return plain_same


def _fresh(st):
    from repro_torch.core.device_search import _STATE_TENSORS

    return st._replace(**{f: getattr(st, f).clone() for f in _STATE_TENSORS})


def _chunk_pair(tag: str, di, cfg, st, h: int = 8) -> None:
    """One ``h``-hop chunk from state ``st``: the eager ``_run_hops`` and a
    captured ``_GraphedChunk`` must leave bitwise the same state; prints
    the median of 5 timed runs of each."""
    from repro_torch.core import device_search as tds

    eager = tds._run_hops(di, _fresh(st), cfg, h)  # warms every op up
    chunk = tds._GraphedChunk(di, cfg, _fresh(st), h)
    graphed = chunk.run(_fresh(st))
    for f in tds._STATE_TENSORS:
        if not torch.equal(getattr(eager, f), getattr(graphed, f)):
            fail(f"{tag}: replayed chunk differs from the eager loop in {f}")

    def timed(fn) -> float:
        ts = []
        for _ in range(5):
            s = _fresh(st)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(s)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e3

    e_ms = timed(lambda s: tds._run_hops(di, s, cfg, h))
    g_ms = timed(chunk.run)
    active = int(st.active.sum())
    print(f"ok {tag}: {h}-hop chunk, B = {st.res_i.shape[0]} ({active} "
          f"active), replay == eager bitwise; eager {e_ms:.3f} ms, replay "
          f"{g_ms:.3f} ms")


def check_graphs(idx, snap, wl) -> None:
    """Captured chunks against the eager loop from the same states: serving
    searches (pipeline x visited x backend, 8 hops in) and a construction
    search of 128 members over the whole layer span."""
    import itertools

    import numpy as np

    from repro_torch.core import device_search as tds

    di = tds.to_device_index(snap, vec_dtype="f32", device="cuda")
    q, r = tds.pad_queries(
        torch.as_tensor(wl.queries, device="cuda"),
        torch.as_tensor(wl.ranges, dtype=torch.float32, device="cuda"))
    for pipeline, visited, backend in itertools.product(
            ("fused", "reference"), ("bitmap", "hash"), ("cuda", "ref")):
        cfg = tds.hop_cfg(k=10, width=64, m=snap.m, o=snap.o,
                          backend=backend, pipeline=pipeline, visited=visited)
        st = tds._init_state(di, q, r, cfg)
        st = tds._run_hops(di, st, cfg, 9)  # the seed iteration + 8 hops
        _chunk_pair(f"serve {pipeline}/{visited}/{backend}", di, cfg, st)

    rng = np.random.default_rng(3)
    pick = rng.choice(idx.store.n, 128, replace=False)
    targets = idx.store.vectors[pick] + 0.01 * rng.standard_normal(
        (128, idx.dim)).astype(np.float32)
    val = idx.store.attrs[pick]
    ranges = np.stack([val - 500.0, val + 500.0], axis=1)
    for backend in ("cuda", "ref"):
        prep = tds._prep_build_inputs(
            idx._arena.device_index(), targets, ranges, pick, 0,
            idx.graph.top, None, None, width=64, m=idx.params.m,
            o=idx.params.o, metric="l2", seed_width=None, backend=backend,
            visited="hash", visited_bits=None, visited_fp=0.02,
            visited_hashes=2, merge="auto", max_hops=None)
        st = tds._init_build_state(prep.di, *prep.args, prep.cfg)
        _chunk_pair(f"build search/{backend}", prep.di, prep.cfg, st)


def phase_device_build() -> dict:
    from repro_torch.launch import serve

    args = ["--n", str(N_DEVICE), *COMMON, "--build-backend", "device",
            "--pipeline", "fused", "reference",
            "--visited", "bitmap", "hash", "--compact", "none", "8,8",
            "--backend", "cuda", "ref", "--ingest", str(N_INGEST)]
    reset_counts()
    out = serve.main(args)
    counts = read_counts()
    for what, n in (("build", out["build_launches"]),
                    ("ingest", out["ingest_launches"])):
        if n["gather_norm_dot"] <= 0 or n["batched_dot"] != 0:
            fail(f"device {what}: launches {n}")
    replays = read_replays()
    from repro_torch.core.device_search import (
        KERNEL_REPLAYS, graph_cache_stats, to_device_index)

    kernel_replays = dict(KERNEL_REPLAYS)

    graphs = graph_cache_stats()
    plain_bitwise = plain_batch_dependence(
        to_device_index(out["snapshot"], vec_dtype="f32", device="cuda"))
    _check_device_runs(out["runs"], _scale(out), "before ingest",
                       plain_bitwise)
    _check_device_runs(out["ingest_runs"],
                       _scale(out, out["snapshot_after"]), "after ingest",
                       plain_bitwise)
    check_graphs(out["index"], out["snapshot_after"], out["workload"])
    st = out["build_stats"]
    print(f"device build: n = {N_DEVICE}, {out['build_s']:.2f} s, "
          f"{out['inserts_per_s']:.1f} inserts/s, {st.searches} searches, "
          f"DC {st.dc}, arena {out['arena_bytes']} bytes; ingest "
          f"{N_INGEST} in {out['ingest_s']:.2f} s "
          f"({N_INGEST / out['ingest_s']:.1f} inserts/s)")
    executions = {k: counts[k] + kernel_replays[k] for k in kernel_replays}
    print(f"device-build path launches: {counts}; graph replays {replays}, "
          f"kernel launches they replayed {kernel_replays} (executions "
          f"{executions}); {graphs['graphs']} captured chunks cached in a "
          f"shared pool of {graphs['pool_bytes']} bytes (memory reserved "
          f"{torch.cuda.memory_reserved()} bytes)")
    return {"launches": counts, "replays": replays,
            "executions": executions, "out": out}


def phase_int8_build(f32_recall: float) -> dict:
    from repro_torch.launch import serve

    args = ["--n", str(N_HOST), *COMMON, "--build-backend", "device",
            "--vec-dtype", "int8", "--backend", "cuda"]
    reset_counts()
    out = serve.main(args)
    counts = read_counts()
    run = out["runs"][0]
    if out["build_launches"]["gather_norm_dot"] <= 0:
        fail("int8 device build: gather_norm_dot was never launched")
    if run["recall"] < f32_recall - 0.03:
        fail(f"int8 device build: recall {run['recall']:.4f} more than 0.03 "
             f"below f32 {f32_recall:.4f}")
    print(f"ok int8 device build: n = {N_HOST}, {out['build_s']:.2f} s "
          f"({out['inserts_per_s']:.1f} inserts/s), recall@10 "
          f"{run['recall']:.4f} (f32 {f32_recall:.4f}), launches {counts}")
    return {"launches": counts, "out": out}


def _trace(fn, name: str) -> dict:
    """Profile one call of ``fn``: wall, device busy (union of device
    spans), idle share, device-to-host copies and the top device ops.

    The profiler (kineto) files the first device records of a session as
    out of its window and drops them, one more with every session of the
    process on some machines (``PERF.md`` section 7).  So each session
    opens with PRELUDE spin kernels, synchronised before ``fn`` starts,
    which take that loss; every figure below leaves them out, and the
    trace fails if the loss reached past them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PRELUDE):
            torch.cuda._sleep(PRELUDE_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    outdir = os.path.join(HERE, "build")  # tens of MB: kept out of git
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{name}_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    dev = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spin = [e for e in dev if "spin_kernel" in e["name"]]
    dev = [e for e in dev if "spin_kernel" not in e["name"]]
    if not spin:
        fail(f"trace {name}: the profiler dropped all {PRELUDE} prelude "
             "records, so it may have dropped records of the traced run")
    print(f"trace {name}: the profiler dropped {PRELUDE - len(spin)} of "
          f"the {PRELUDE} prelude records")
    if not dev:
        fail(f"trace {name}: the profiler recorded no device activity")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy, end = 0.0, -1.0  # union of device intervals, us
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in dev:
        t, c = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + float(e["dur"]), c + 1)
    dtoh = sum(c for k, (_, c) in by_name.items() if "DtoH" in k)
    n_ops = sum(c for _, c in by_name.values())
    print(f"trace {name}: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / 1e6 / wall:.4f}, "
          f"{n_ops} device ops, {dtoh} device-to-host copies")
    kernels, shares = {}, {}
    for k in read_counts():  # each kernel's event name holds its wrapper's
        t = sum(v[0] for kk, v in by_name.items() if k in kk)
        c = sum(v[1] for kk, v in by_name.items() if k in kk)
        kernels[k], shares[k] = c, t / busy
        if c:
            print(f"  {k}: {t / 1e3:.3f} ms over {c} kernel events "
                  f"({t / c:.2f} us each, {t / busy:.4f} of busy)")
    for k, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {t / 1e3:9.3f} ms {c:6d}x  {k[:100]}")
    gemm = sum(t for k, (t, _) in by_name.items()
               if any(g in k.lower() for g in GEMM_NAMES))
    print(f"  GEMMs {gemm / 1e3:.3f} ms, {gemm / busy:.4f} of busy")
    top = [(k, t / 1e3, c) for k, (t, c) in
           sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]]
    return {"wall_s": wall, "busy_s": busy / 1e6, "ops": n_ops,
            "dtoh": dtoh, "kernels": kernels, "shares": shares,
            "gemm_share": gemm / busy, "top": top}


def _traced_launches(fn, name: str) -> dict:
    """Trace ``fn`` and hold the profiler's kernel events against the
    wrappers' launches plus one per hop that a replayed graph ran (each
    hop evaluates its candidates with one kernel launch)."""
    before, rep0 = read_counts(), read_replays()
    tr = _trace(fn, name)
    wrapped = {k: v - before[k] for k, v in read_counts().items()}
    hops = read_replays()["hops"] - rep0["hops"]
    if sum(tr["kernels"].values()) != sum(wrapped.values()) + hops:
        fail(f"trace {name}: kernel events {tr['kernels']} != wrapper "
             f"launches {wrapped} + replayed hops {hops}")
    print(f"  kernel events {tr['kernels']} = wrapper launches {wrapped} + "
          f"{hops} replayed hops")
    return {"run": name, "kernel_events": tr["kernels"],
            "wrapper_launches": wrapped, "replayed_hops": hops}


def phase_trace(out: dict) -> dict:
    import numpy as np

    from repro_torch.core.datasets import make_attrs, make_vectors
    from repro_torch.core.device_search import (
        device_search, pad_queries, to_device_index,
    )

    snap, wl, idx = out["snapshot_after"], out["workload"], out["index"]
    di = to_device_index(snap, vec_dtype="f32", device="cuda")
    q, r = pad_queries(torch.as_tensor(wl.queries, device="cuda"),
                       torch.as_tensor(wl.ranges, dtype=torch.float32,
                                       device="cuda"))
    traced = {}
    for pipeline in ("fused", "reference"):
        for compact in (None, (8, 8)):
            def batch(pipeline=pipeline, compact=compact):
                return device_search(di, q, r, k=10, width=64, m=snap.m,
                                     o=snap.o, backend="cuda",
                                     pipeline=pipeline, compact=compact)

            batch()  # a chunk shape's first sight runs eagerly ...
            batch()  # ... and its second captures the graph
            name = (f"serve_{pipeline}"
                    + ("_compact" if compact is not None else ""))
            traced[name] = _traced_launches(batch, name)

    vecs = make_vectors(128, snap.vectors.shape[1], seed=7)
    attrs = make_attrs(vecs, seed=7) + float(np.max(snap.attrs)) + 1.0
    n_searches = idx.build_stats.searches
    traced["device_build_batch"] = _traced_launches(
        lambda: idx.insert_batch(vecs, attrs, batch_size=128,
                                 backend="device"), "device_build_batch")
    print(f"  (one micro-batch of 128 inserts: "
          f"{idx.build_stats.searches - n_searches} member searches)")
    return traced


def _engine_run(tag: str, backend: str, wl, idx, snap, extra=(),
                ingest=None) -> dict:
    """One ``_serve_engine`` run of the launcher on ``idx`` with the
    counts set to 0 just before it and read just after it."""
    from repro_torch.launch import serve

    args = serve._parser().parse_args(
        [*COMMON, "--backend", backend, "--build-backend", "device",
         "--engine", *extra])
    reset_counts()
    run = serve._serve_engine(args, wl, idx, snap, "cuda", ingest=ingest)
    run["path_counts"] = read_counts()
    c, st = run["counts"], run["stats"]
    gnd = c["gather_norm_dot"] + c["replayed_gather_norm_dot"]
    if backend == "cuda" and gnd <= 0:
        fail(f"engine {tag}: gather_norm_dot neither launched nor replayed")
    # (the device build of an ingest launches the kernel in either run)
    if backend == "ref" and ingest is None and any(
            run["path_counts"].values()):
        fail(f"engine {tag}: the plain run launched kernels "
             f"{run['path_counts']}")
    if not run["answered"].all():
        fail(f"engine {tag}: {int((~run['answered']).sum())} queries "
             "without a reply")
    lat = run["latency_ms"]
    print(f"engine {tag}: warmup {run['warmup_s']:.3f} s "
          f"({run['warmup_counts']['captures']} captures); "
          f"{run['qps']:.1f} QPS, latency p50 {lat['p50']:.3f} p95 "
          f"{lat['p95']:.3f} p99 {lat['p99']:.3f} ms, waves {st['waves']}, "
          f"chunks {st['chunks']}, shed waves {st['shed_waves']}, degraded "
          f"{st['degraded']}, expired {st['expired']}, rejected "
          f"{run['rejected']}, chunk schedule {st['chunk_schedule']}, "
          f"recall@10 {run['recall']:.4f}; gather_norm_dot launches "
          f"{c['gather_norm_dot']} + replayed {c['replayed_gather_norm_dot']}"
          f", graph replays {c['graph_chunks']}, captures after warmup "
          f"{run['captures_after_warmup']}; path launches "
          f"{run['path_counts']}")
    return run


def _engine_bitwise(tag: str, run: dict, ref, snap, scale: float,
                    kernel: bool) -> int:
    """Undegraded replies against the one-shot ``search_batch`` on the
    snapshot the engine served: bitwise through the kernel, else the tie
    rule.  Returns the tie flips."""
    import numpy as np

    from repro_torch.core.device_search import SearchResult

    want = SearchResult(
        ids=np.where(ref.ids >= 0,
                     snap.ids_map[np.clip(ref.ids, 0, None)], -1),
        dists=ref.dists, dc=ref.dc, hops=ref.hops)
    got = run["result"]
    ok = run["answered"] & ~run["degraded"]
    if kernel:
        for a, b in zip(got, want):
            if not (np.asarray(a)[ok] == np.asarray(b)[ok]).all():
                fail(f"engine {tag}: replies differ from the kernel's "
                     "one-shot search_batch")
        return 0
    return _agree(f"engine {tag}", SearchResult(*(np.asarray(a)[ok]
                                                  for a in got)),
                  SearchResult(*(np.asarray(b)[ok] for b in want)), scale)


def _capture_kinds(cc) -> dict:
    """A ``CaptureCounter``'s events split into serving chunks (k < W),
    construction-search chunks (k = W) and kernel builds and loads."""
    out = {"serving": 0, "build": 0, "other": 0}
    for kind, name, _ in cc.events:
        if kind != "capture":
            out["other"] += 1
            continue
        f = dict(kv.split("=") for kv in name.split() if "=" in kv)
        out["build" if f["k"] == f["W"] else "serving"] += 1
    return out


def phase_engine(out: dict) -> dict:
    """The request-lifecycle engine on the device-built index (see the
    module docstring, phase 5b)."""
    import numpy as np

    from repro_torch.analysis import CaptureCounter
    from repro_torch.core.datasets import make_attrs, make_vectors
    from repro_torch.core.device_search import search_batch
    from repro_torch.core.snapshot import take_snapshot
    from repro_torch.serve import ServeEngine

    idx, wl = out["index"], out["workload"]
    snap = take_snapshot(idx, prev=out["snapshot_after"])
    scale = _scale(out, snap)
    top = float(np.max(idx.store.attrs[: idx.store.n])) + 1.0
    runs = {}
    for b, backend in enumerate(("cuda", "ref")):
        kernel = backend == "cuda"
        a = _engine_run(f"{backend} (a) closed burst", backend, wl, idx,
                        snap)
        if a["recall"] < 0.90:
            fail(f"engine {backend} (a): recall@10 {a['recall']:.4f} < 0.90")
        if a["captures_after_warmup"]:
            fail(f"engine {backend} (a): {a['captures_after_warmup']} "
                 "chunks captured after warmup on a static engine")
        ref = search_batch(snap, wl.queries, wl.ranges, k=a["config"].k,
                           width=a["config"].width, backend=backend,
                           device="cuda")
        flips = _engine_bitwise(f"{backend} (a)", a, ref, snap, scale,
                                kernel)
        print(f"ok engine {backend} (a): {'bitwise' if kernel else 'tie rule'}"
              f" equal to the one-shot search_batch ({flips} tie flips)")
        if kernel:  # where the engine's time goes: one more burst, traced
            eng = ServeEngine(index=idx, snapshot=snap, config=a["config"],
                              device="cuda")
            eng.warmup()

            def burst(eng=eng):
                for i in range(len(wl.queries)):
                    eng.submit(wl.queries[i], wl.ranges[i])
                eng.drain()

            traced = _traced_launches(burst, "engine_burst")

        # (c) on (a)'s snapshot: the same work under a deadline at (a)'s
        # median latency; (a)'s replies are the undeadlined run
        dl = a["latency_ms"]["p50"]
        c = _engine_run(f"{backend} (c) deadline {dl:.3f} ms", backend, wl,
                        idx, snap, extra=("--deadline-ms", str(dl)))
        full = a["result"]
        deg = np.flatnonzero(c["degraded"])
        if deg.size == 0:
            fail(f"engine {backend} (c): no degraded reply")
        res, kinds = c["result"], {"truncated": 0, "late": 0, "expired": 0}
        for i in deg:
            ids, d = res.ids[i], res.dists[i]
            if c["reason"][i] == "queue_deadline":
                if (ids != -1).any() or res.hops[i] != 0:
                    fail(f"engine {backend} (c): expired reply {i} not empty")
                kinds["expired"] += 1
                continue
            if not ((ids >= 0).any() and (np.diff(d[ids >= 0]) >= 0).all()):
                fail(f"engine {backend} (c): degraded reply {i} is not a "
                     "valid prefix")
            if kernel and res.hops[i] > full.hops[i]:
                fail(f"engine {backend} (c): degraded reply {i} ran "
                     f"{res.hops[i]} hops > {full.hops[i]}")
            if res.hops[i] < full.hops[i]:
                kinds["truncated"] += 1
            else:
                kinds["late"] += 1
                if kernel and not np.array_equal(ids, full.ids[i]):
                    fail(f"engine {backend} (c): late reply {i} differs "
                         "from the undeadlined run")
        if kinds["truncated"] == 0:
            fail(f"engine {backend} (c): no reply truncated in flight")
        print(f"ok engine {backend} (c): {deg.size} degraded replies, all "
              f"valid prefixes {kinds}")

        vecs = make_vectors(N_INGEST, snap.vectors.shape[1], seed=200 + b)
        attrs = make_attrs(vecs, seed=200 + b) + top
        rate = a["qps"] / 2.0
        with CaptureCounter() as bcc:
            bb = _engine_run(f"{backend} (b) open loop at {rate:.1f} QPS + "
                             f"{N_INGEST} ingested", backend, wl, idx, snap,
                             extra=("--rate", str(rate), "--ingest",
                                    str(N_INGEST)), ingest=(vecs, attrs))
        if bb["stats"]["ingest"]["rows"] != N_INGEST or len(idx) != \
                len(snap.attrs) + N_INGEST:
            fail(f"engine {backend} (b): ingest incomplete")
        print(f"engine {backend} (b): ingested {N_INGEST} rows in "
              f"{bb['ingest_s']:.3f} s ({N_INGEST / bb['ingest_s']:.1f} "
              f"rows/s), snapshot refreshed {bb['snapshot_refreshed']}; "
              f"graph cache before {bb['graphs_before']}, after "
              f"{bb['graphs_after']}")
        # the engine's chunks run at k 10 < width 64, the device build's
        # construction searches at k = width; the counter spans the run's
        # warm-up too, whose captures are all serving chunks
        kinds = _capture_kinds(bcc)
        kinds["serving"] -= bb["warmup_counts"]["captures"]
        print(f"engine {backend} (b) under ingest: "
              f"{bb['captures_after_warmup']} captures after warm-up "
              f"(serving chunks {kinds['serving']}, construction-search "
              f"chunks {kinds['build']}, kernel builds/loads "
              f"{kinds['other']}), {N_INGEST / bb['ingest_s']:.1f} rows/s "
              f"applied while serving, p99 "
              f"{bb['latency_ms']['p99'] / 1e3:.3f} s; with each refresh "
              f"re-keying the graph cache: {REKEYED_5B}")
        bb["capture_kinds"] = kinds
        if kinds["serving"]:
            fail(f"engine {backend} (b): {kinds['serving']} serving chunks "
                 "captured after warm-up under an ingest within the "
                 "snapshot's capacity")
        snap = take_snapshot(idx, prev=snap)
        top = float(np.max(attrs)) + 1.0
        runs[backend] = {"a": a, "b": bb, "c": c}
    launches = {k: sum(r["path_counts"][k] for rr in runs.values()
                       for r in rr.values())
                for k in ("gather_norm_dot", "batched_dot")}
    replayed = sum(r["counts"]["replayed_gather_norm_dot"]
                   for rr in runs.values() for r in rr.values())
    return {"runs": runs, "launches": launches, "replayed": replayed,
            "traced": traced}


def phase_lint() -> dict:
    """The port's wowlint in processes of its own (phase 1b):
    ``python -m repro_torch.analysis --fail-on-findings`` over the shipped
    tree, then ``--compile-smoke`` on the card; a non-zero exit of either
    fails the run."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out = {}
    for flag in ("--fail-on-findings", "--compile-smoke"):
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", flag],
            capture_output=True, text=True, env=env, cwd=HERE, timeout=300)
        lines = res.stdout.strip().splitlines()
        last = lines[-1] if lines else ""
        print(f"wowlint {flag}: exit {res.returncode} in "
              f"{time.time() - t0:.1f} s: {last}")
        if res.returncode != 0:
            fail(f"wowlint {flag} exited {res.returncode}:\n{res.stdout}"
                 f"{res.stderr}")
        out[flag] = last
    return out


def phase_guard(out: dict) -> dict:
    """The capture-guard leg (phase 5b2; see the module docstring): the
    engine on the index as phase 5b leaves it, warmed up, then bursts of
    the queries with GUARD_ROWS rows ingested between and under them, in
    ``CaptureCounter``."""
    import numpy as np

    from repro_torch.analysis import CaptureCounter
    from repro_torch.core import recall
    from repro_torch.core.datasets import make_attrs, make_vectors
    from repro_torch.core.device_search import search_batch
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.lifecycle import EngineConfig

    idx, wl = out["index"], out["workload"]
    t_leg = time.time()
    cfg = EngineConfig(k=10, width=64, backend="cuda", visited="bitmap",
                       adaptive=False, max_wave=64, build_backend="numpy",
                       ingest_batch=GUARD_BATCH)
    eng = ServeEngine(index=idx, config=cfg, device="cuda")
    with CaptureCounter("warmup") as warm:
        warm_s = eng.warmup()
    di = eng._di
    cap = (di.vectors.shape[0], di.uvals.shape[0], di.neighbors.shape[0])
    top = float(np.max(idx.store.attrs[: idx.store.n])) + 1.0
    vecs = make_vectors(GUARD_ROWS, idx.dim, seed=300)
    attrs = make_attrs(vecs, seed=300) + top
    per = GUARD_ROWS // GUARD_WAVES
    n0, launched, replies = len(idx), {}, []
    reset_counts()
    t0 = time.time()
    with CaptureCounter("after warmup") as cc:
        for burst in range(GUARD_WAVES + 2):  # first, interleaved, final
            if 1 <= burst <= GUARD_WAVES:
                lo = (burst - 1) * per
                eng.submit_ingest(vecs[lo:lo + per], attrs[lo:lo + per])
            qi = {eng.submit(wl.queries[i], wl.ranges[i]).rid: i
                  for i in range(QUERIES)}
            while not eng.idle:
                queued, waves = list(eng._queue), eng.stats.waves
                replies.extend((qi, r) for r in eng.step())
                if eng.stats.waves > waves:  # a wave launched on eng._snap
                    for req in queued[: len(queued) - len(eng._queue)]:
                        launched[req.rid] = eng._snap
        torch.cuda.synchronize()
    serve_s = time.time() - t0
    counts, replays = read_counts(), read_replays()
    di = eng._di
    cap_after = (di.vectors.shape[0], di.uvals.shape[0],
                 di.neighbors.shape[0])
    if len(idx) != n0 + GUARD_ROWS or cap_after != cap:
        fail(f"guard: {len(idx) - n0} rows ingested, capacity {cap} -> "
             f"{cap_after}")
    if cc.count:
        fail(f"guard: {cc.count} captures/builds after warm-up: "
             f"{cc.events[:8]}")
    if counts["gather_norm_dot"] + replays["hops"] <= 0:
        fail("guard: gather_norm_dot neither launched nor replayed")
    snaps = {id(s): s for s in launched.values()}
    want = {k: search_batch(s, wl.queries, wl.ranges, k=10, width=64,
                            backend="cuda", device="cuda")
            for k, s in snaps.items()}
    recs = []
    for qmap, r in replies:
        i, snap = qmap[r.rid], launched[r.rid]
        ref = want[id(snap)]
        ids = np.where(ref.ids[i] >= 0,
                       snap.ids_map[np.clip(ref.ids[i], 0, None)], -1)
        if r.degraded or not (np.array_equal(r.ids, ids)
                              and np.array_equal(r.dists, ref.dists[i])
                              and (r.hops, r.dc) == (ref.hops[i],
                                                     ref.dc[i])):
            fail(f"guard: reply {r.rid} differs from search_batch on the "
                 "snapshot its wave launched with")
        recs.append(recall(np.asarray([j for j in r.ids if j >= 0]),
                           wl.gt[i]))
    rec = float(np.mean(recs))
    if len(replies) != QUERIES * (GUARD_WAVES + 2) or rec < 0.90:
        fail(f"guard: {len(replies)} replies, recall@10 {rec:.4f}")
    st, sets = eng.engine_stats(), eng.serving_set_stats()
    # one copy-in: every tensor of the set rewritten from a snapshot of
    # the same capacity, timed by CUDA events over 10 of them
    (buf, _), = eng._sets._sets.values()
    src = [t.clone() for t in buf]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for rep in range(11):  # the first one warms up
        if rep == 1:
            ev[0].record()
        for dst, t in zip(buf, src):
            dst.copy_(t)
    ev[1].record()
    torch.cuda.synchronize()
    copy_ms = ev[0].elapsed_time(ev[1]) / 10
    copy_bound_ms = 2 * sets["bytes"] / HBM_BYTES_PER_S * 1e3
    del src
    res = {"warmup_s": warm_s, "warmup_captures": warm.by_kind,
           "copy_in_ms": copy_ms, "copy_in_bound_ms": copy_bound_ms,
           "serve_s": serve_s, "replies": len(replies),
           "snapshots": len(snaps), "recall": rec,
           "captures_after_warmup": cc.count, "capacity": cap,
           "set_bytes": sets["bytes"], "set_copies": sets["copies"],
           "rows_per_s": GUARD_ROWS / serve_s, "qps": st["qps"],
           "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
           "waves": st["waves"], "chunks": st["chunks"],
           "launches": counts["gather_norm_dot"],
           "replayed_hops": replays["hops"], "s": time.time() - t_leg}
    print(f"guard: warm-up {warm_s:.3f} s ({warm.by_kind}), capacity "
          f"(rows, uvals, layers) {cap}; {len(replies)} replies in "
          f"{serve_s:.3f} s with {GUARD_ROWS} rows ingested in "
          f"{GUARD_ROWS // GUARD_BATCH} micro-batches over "
          f"{GUARD_WAVES} of {GUARD_WAVES + 2} bursts: 0 captures after "
          f"warm-up, every reply bitwise search_batch on its wave's "
          f"snapshot ({len(snaps)} snapshots), recall@10 {rec:.4f}, "
          f"{st['qps']:.1f} QPS, p50 {st['p50_ms']:.3f} p99 "
          f"{st['p99_ms']:.3f} ms, waves {st['waves']}, chunks "
          f"{st['chunks']}; serving set {sets['bytes']} bytes, "
          f"{sets['copies']} copy-ins of {copy_ms:.4f} ms each (bound "
          f"{copy_bound_ms:.4f} ms); gather_norm_dot launches "
          f"{counts['gather_norm_dot']} + replayed hops {replays['hops']}")
    return res


def _dir_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 1e6


def _same_replies(tag: str, a, b) -> None:
    """ids, dists, hops and DC bit for bit."""
    import numpy as np

    for name, x, y in zip(("ids", "dists", "dc", "hops"), a, b):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            fail(f"{tag}: {name} differ")


def _micro_batches(idx, batches, backend: str = "device") -> None:
    for vs, as_ in batches:
        idx.insert_batch(vs, as_, batch_size=len(as_), backend=backend)


def phase_durable(out: dict) -> dict:
    """The durable lifecycle on the device-built index of phase 3 (see the
    module docstring, phase 5c)."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core.datasets import make_attrs, make_vectors
    from repro_torch.core.device_search import (
        GRAPH_CAPTURES, SearchResult, device_search, pad_queries,
        search_batch, to_device_index,
    )
    from repro_torch.core.snapshot import take_snapshot
    from repro_torch.persist import (
        CrashError, EngineFaultPlan, OsIO, load_serving_snapshot,
        open_durable, recover, save, state_digest,
    )
    from repro_torch.persist.checkpoint import load_state, materialize
    from repro_torch.persist.format import read_manifest
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.lifecycle import EngineConfig

    class CountingIO(OsIO):
        """The real filesystem, counting file and directory fsyncs."""

        fsyncs = 0

        def fsync(self, f) -> None:
            self.fsyncs += 1
            super().fsync(f)

        def fsync_dir(self, path: str) -> None:
            self.fsyncs += 1
            super().fsync_dir(path)

    idx, wl = out["index"], out["workload"]
    n0 = idx.store.n
    k, width = 10, 64
    launches = {}

    def note(step: str) -> None:
        launches[step] = read_counts()

    def serve(snap) -> SearchResult:
        return search_batch(snap, wl.queries, wl.ranges, k=k, width=width,
                            backend="cuda", device="cuda")

    root = tempfile.mkdtemp(prefix="wow-durable-")
    try:
        # (1) a full checkpoint of the live index
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(idx, root, incremental=False)
        full_s = time.perf_counter() - t0
        full_mb = _dir_mb(path)
        print(f"durable (1) full checkpoint of n = {n0} x d "
              f"{idx.store.dim}: {full_s:.3f} s, {full_mb:.1f} MB, "
              f"{full_mb / full_s:.1f} MB/s")

        # (2) cold start: mapped slabs -> device index -> first reply
        reset_counts()
        t0 = time.perf_counter()
        snap, meta = load_serving_snapshot(root)
        map_s = time.perf_counter() - t0
        di = to_device_index(snap, device="cuda")
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        q, r = pad_queries(
            torch.as_tensor(wl.queries, device="cuda"),
            torch.as_tensor(wl.ranges, dtype=torch.float32, device="cuda"))
        res = device_search(di, q, r, k=k, width=width, m=snap.m, o=snap.o,
                            metric="l2", backend="cuda")
        cold = SearchResult(*(np.asarray(a)[:QUERIES] for a in res))
        first_s = time.perf_counter() - t0
        note("cold_start")
        if launches["cold_start"]["gather_norm_dot"] <= 0:
            fail("durable cold start: gather_norm_dot was never launched")
        _same_replies("durable cold start vs materialize(load_state)", cold,
                      serve(take_snapshot(materialize(load_state(root),
                                                      device="cuda"))))
        _same_replies("durable cold start vs the live index", cold,
                      serve(take_snapshot(idx)))
        print(f"ok durable (2) cold start (checkpoint lsn {meta['lsn']}): "
              f"mapped in {map_s * 1e3:.1f} ms, device index at "
              f"{dev_s * 1e3:.1f} ms, first reply of {QUERIES} at "
              f"{first_s * 1e3:.1f} ms; replies bitwise those of "
              f"take_snapshot(materialize(load_state)) and of the live "
              f"index through the kernel; launches "
              f"{launches['cold_start']}")
        del snap, di

        # (3) durable engine ingest while the queries are served
        top = float(np.max(idx.store.attrs[:n0])) + 1.0
        vecs = make_vectors(1280, idx.store.dim, seed=300)
        attrs = make_attrs(vecs, seed=300) + top
        batches = [(vecs[s:s + 128],
                    attrs[s:s + 128].astype(np.float32).astype(np.float64))
                   for s in range(0, 1280, 128)]
        io = CountingIO()
        reset_counts()
        t0 = time.perf_counter()
        live = open_durable(root, io=io, device="cuda")
        open_s = time.perf_counter() - t0
        cfg = EngineConfig(k=k, width=width, backend="cuda", max_wave=64,
                           build_backend="device", ingest_batch=128)
        eng = ServeEngine(index=live, config=cfg, device="cuda")
        eng.warmup()
        acks, ack_ms, replies = [], [], []
        fs0 = io.fsyncs
        t_ing = time.perf_counter()
        t_done = None
        for i in range(QUERIES):
            eng.submit(wl.queries[i], wl.ranges[i])
            if i % 32 == 0:  # 8 acks of 128 rows over the 256 queries
                vs, as_ = batches[i // 32]
                t1 = time.perf_counter()
                acks.append(eng.submit_ingest(vs, as_))
                ack_ms.append((time.perf_counter() - t1) * 1e3)
            replies.extend(eng.step())
        while not eng.idle:
            replies.extend(eng.step())
            if t_done is None and eng.pending_ingest == 0:
                t_done = time.perf_counter()
        torch.cuda.synchronize()
        t_done = t_done or time.perf_counter()
        note("engine_ingest")
        fsyncs = io.fsyncs - fs0
        if [a.lsn for a in acks] != list(range(1, 9)) or \
                live._applied_lsn != 8 or live.store.n != n0 + 1024:
            fail(f"durable (3): acks {[a.lsn for a in acks]}, applied lsn "
                 f"{live._applied_lsn}, n {live.store.n}")
        if len(replies) != QUERIES:
            fail(f"durable (3): {len(replies)} replies of {QUERIES}")
        if launches["engine_ingest"]["gather_norm_dot"] <= 0:
            fail("durable (3): gather_norm_dot was never launched")
        p50, p99 = np.percentile(ack_ms, [50, 99])
        print(f"ok durable (3) engine on open_durable (recovered in "
              f"{open_s:.2f} s): 1,024 rows in 8 submit_ingest acks of 128, "
              f"ack latency p50 {p50:.3f} ms p99 {p99:.3f} ms, {fsyncs} "
              f"fsyncs (one group commit an ack), applied at "
              f"{1024 / (t_done - t_ing):.1f} rows/s while serving "
              f"{QUERIES} queries; launches {launches['engine_ingest']}")

        # (4) acked, then a crash entering the second apply
        reset_counts()
        plan = EngineFaultPlan(crash_after_ingest_applies=1)
        eng2 = ServeEngine(index=live, config=cfg, device="cuda",
                           fault_plan=plan)
        ack = eng2.submit_ingest(np.concatenate([b[0] for b in batches[8:]]),
                                 np.concatenate([b[1] for b in batches[8:]]))
        if ack.lsn != 10 or eng2.pending_ingest != 2:
            fail(f"durable (4): ack {ack!r}")
        try:
            eng2.drain()
            fail("durable (4): the injected crash did not happen")
        except CrashError:
            pass
        if live._applied_lsn != 9 or eng2.pending_ingest != 1:
            fail(f"durable (4): applied lsn {live._applied_lsn}, pending "
                 f"{eng2.pending_ingest}")
        live_digest = state_digest(live)
        del eng, eng2, live  # no checkpoint, no close: a crash
        gc.collect()
        note("crash_engine")
        reset_counts()
        t0 = time.perf_counter()
        caps = GRAPH_CAPTURES["chunks"]
        rec = recover(root)  # device None: the card
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        note("replay")
        replay_graphs = (read_replays()["chunks"],
                         GRAPH_CAPTURES["chunks"] - caps)
        if rec._applied_lsn != 10 or rec.store.n != n0 + 1280:
            fail(f"durable (4): recovered lsn {rec._applied_lsn}, n "
                 f"{rec.store.n}")
        if launches["replay"]["gather_norm_dot"] <= 0:
            fail("durable (4): the replay never launched gather_norm_dot")
        reset_counts()
        t0 = time.perf_counter()
        twin = materialize(load_state(root), device="cuda")
        mat_s = time.perf_counter() - t0
        _micro_batches(twin, batches[:9])
        twin9 = state_digest(twin)
        _micro_batches(twin, batches[9:])
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        # the phase-3 index carries its build's delta-maintained arena
        t0 = time.perf_counter()
        _micro_batches(idx, batches)
        torch.cuda.synchronize()
        live3_s = time.perf_counter() - t0
        note("twins")
        d_rec, d_twin = state_digest(rec), state_digest(twin)
        if live_digest != twin9:
            fail("durable (4): the engine's live index after 9 applies is "
                 "not the twin's after 9")
        if d_rec != d_twin:
            fail(f"durable (4): recovered digest {d_rec} != twin {d_twin}")
        if state_digest(idx) != d_rec:
            fail("durable (4): the phase-3 index (its build's arena) after "
                 "the same 10 micro-batches differs from the recovered one")
        _same_replies("durable (4) recovered vs twin",
                      serve(take_snapshot(rec)), serve(take_snapshot(twin)))
        _same_replies("durable (4) recovered vs the phase-3 index",
                      serve(take_snapshot(rec)), serve(take_snapshot(idx)))
        replay_s = rec_s - mat_s
        print(f"ok durable (4) crash after 2 acks, 1 apply: recover "
              f"{rec_s:.2f} s (materialize {mat_s:.2f} s as the twin's, "
              f"replay of 10 records ~{replay_s:.2f} s, "
              f"{1280 / replay_s:.1f} rows/s; {replay_graphs[0]} chunks "
              f"replayed as graphs, {replay_graphs[1]} captured); digest "
              f"{d_rec[:16]} = the "
              f"twin's (materialize + 10 device micro-batches, "
              f"{twin_s:.2f} s) = the phase-3 index's after the same "
              f"micro-batches ({live3_s:.2f} s, {1280 / live3_s:.1f} "
              f"rows/s); the engine's index before the crash = the twin "
              f"after 9; replies through the kernel bitwise; launches: "
              f"replay {launches['replay']}, twins {launches['twins']}")

        # (5) an incremental checkpoint of the recovered index
        t0 = time.perf_counter()
        path = save(rec, root)
        inc_s = time.perf_counter() - t0
        man = read_manifest(path)
        if man["kind"] != "delta":
            fail(f"durable (5): a {man['kind']} checkpoint, not a delta")
        inc_mb = _dir_mb(path)
        print(f"ok durable (5) incremental checkpoint: {inc_s:.3f} s, "
              f"{inc_mb:.2f} MB (the full one: {full_s:.3f} s, "
              f"{full_mb:.1f} MB)")
        del rec, twin
        gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = {key: sum(c[key] for c in launches.values())
             for key in ("gather_norm_dot", "batched_dot")}
    return {"launches": total, "by_step": launches,
            "full_ckpt": {"s": full_s, "mb": full_mb},
            "incremental_ckpt": {"s": inc_s, "mb": inc_mb},
            "cold_start_ms": {"map": map_s * 1e3, "device_index":
                              dev_s * 1e3, "first_reply": first_s * 1e3},
            "ack_ms": {"p50": p50, "p99": p99}, "fsyncs": fsyncs,
            "engine_rows_per_s": 1024 / (t_done - t_ing),
            "recover_s": rec_s, "materialize_s": mat_s,
            "replay_rows_per_s": 1280 / replay_s}


# leg (b)'s primary: a process of its own that imports only the port,
# opens a copy of the cluster's first checkpoint on the card, streams it
# to the replica in this process, ingests and SIGKILLs itself
SIGKILL_CHILD = """
import os, signal, time
t0 = time.perf_counter()
from repro_torch.core.datasets import make_attrs, make_vectors
from repro_torch.persist import open_durable
from repro_torch.persist.replicate import (
    MSG_ACK, PrimaryReplicator, SocketEndpoint, decode_msg)

class Primary(PrimaryReplicator):
    acks = 0

    def _on_msg(self, src, data, now):
        if decode_msg(data)[0] == MSG_ACK:
            self.acks += 1
        super()._on_msg(src, data, now)

idx = open_durable({root!r}, device="cuda")
ep = SocketEndpoint("P")
ep.connect("R", ({host!r}, {port}))
prim = Primary(idx, {root!r}, ep, node_id="P", quorum=2, idle_s=0.0005)
wal = prim.attach()
print("READY", time.perf_counter() - t0, flush=True)
while prim.acks == 0:  # the replica acks once its bootstrap is served
    prim.pump()
sync, sync_ms = wal.sync, []

def timed_sync():
    t = time.perf_counter()
    sync()
    sync_ms.append((time.perf_counter() - t) * 1e3)

wal.sync = timed_sync
vecs = make_vectors({rows}, idx.store.dim, seed=500)
attrs = make_attrs(vecs, seed=500) + {top!r}
b = {batch}
for i in range({batches}):
    t = time.perf_counter()
    idx.insert_batch(vecs[b * i:b * (i + 1)], attrs[b * i:b * (i + 1)],
                     batch_size=b, backend="device")
    print("ACK", i, idx._applied_lsn, sync_ms[-1],
          (time.perf_counter() - t) * 1e3, flush=True)
    if i == {acked} - 1:
        os.kill(os.getpid(), signal.SIGKILL)
"""


def _pct(xs, qs=(50, 95, 99)) -> list:
    import numpy as np

    return [float(v) for v in np.percentile(xs, qs)]


def phase_cluster(out: dict) -> dict:
    """Replication and the serving cluster on the phase-3 index after the
    durable phase (see the module docstring, phase 5d)."""
    import gc
    import shutil
    import tempfile

    from repro_torch.persist import checkpoint as ckpt_mod

    timed = []  # (seconds) of every materialize in the phase, in order
    materialize = ckpt_mod.materialize

    def timed_materialize(state, device=None):
        t0 = time.perf_counter()
        ix = materialize(state, device=device)
        timed.append(time.perf_counter() - t0)
        return ix

    base = tempfile.mkdtemp(prefix="wow-cluster-")
    ckpt_mod.materialize = timed_materialize
    try:
        a = _cluster_leg_a(out, base, timed)
        gc.collect()
        b = _cluster_leg_b(out, base, timed, a)
        gc.collect()
    finally:
        ckpt_mod.materialize = materialize
        shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    a.pop("top")
    launches = {**a.pop("launches"), **b.pop("launches")}
    total = sum(c["gather_norm_dot"] for c in launches.values())
    return {"launches": {"gather_norm_dot": total, "batched_dot": sum(
        c["batched_dot"] for c in launches.values())},
        "by_step": launches, "a": a, "b": b}


def _step_counts() -> dict:
    """This step's wrapper launches, and the kernel launches its replayed
    hop graphs ran (``replayed_*``)."""
    from repro_torch.core.device_search import KERNEL_REPLAYS

    c = read_counts()
    c.update({f"replayed_{k}": v for k, v in KERNEL_REPLAYS.items()})
    return c


def _cluster_leg_a(out: dict, base: str, timed: list) -> dict:
    """Three members in one process: bootstrap, quorum-durable ingest,
    warm-up and a burst, an unplanned failover, ingest under the new
    epoch, the deposed primary's rejoin and a rolling restart."""
    import shutil

    import numpy as np

    from repro_torch.core import recall
    from repro_torch.core.datasets import make_attrs, make_vectors
    from repro_torch.core.device_search import GRAPH_CAPTURES, search_batch
    from repro_torch.core.snapshot import take_snapshot
    from repro_torch.persist import (
        InProcTransport, recover, save, state_digest, wal_dir,
    )
    from repro_torch.persist import wal as walmod
    from repro_torch.persist.replicate import MSG_CKPT_CHUNK, decode_msg
    from repro_torch.serve import Cluster
    from repro_torch.serve.lifecycle import EngineConfig, Rejected

    class Wire(InProcTransport):
        """In-process queues that count the checkpoint chunks and their
        bytes sent to each member."""

        def __init__(self):
            super().__init__()
            self.chunks, self.chunk_bytes = {}, {}

        def send(self, src, dst, data):
            kind, _, payload = decode_msg(data)
            if kind == MSG_CKPT_CHUNK:
                self.chunks[dst] = self.chunks.get(dst, 0) + 1
                self.chunk_bytes[dst] = (self.chunk_bytes.get(dst, 0)
                                         + len(payload))
            return super().send(src, dst, data)

    idx, wl = out["index"], out["workload"]
    n0, d = idx.store.n, idx.store.dim
    nq = len(wl.queries)
    launches = {}
    roots = [os.path.join(base, f"n{i}") for i in range(3)]
    t0 = time.perf_counter()
    save(idx, roots[0], incremental=False)
    save_s = time.perf_counter() - t0
    # leg (b)'s primary starts from a copy of this checkpoint (epoch 0)
    shutil.copytree(roots[0], os.path.join(base, "sigkill-primary"))

    # (1) three members; the replicas stream the primary's checkpoint
    cfg = EngineConfig(k=10, width=64, max_wave=64, backend="cuda",
                       build_backend="device", adaptive=False)
    wire = Wire()
    reset_counts()
    t0 = time.perf_counter()
    c = Cluster(roots, config=cfg, transport=wire, device="cuda")
    open_s = time.perf_counter() - t0
    if c.quorum != 2:
        fail(f"cluster (1): quorum {c.quorum}, not the majority 2")
    prim = c.members["n0"].replicator
    mat0 = len(timed)
    t0 = time.perf_counter()
    prim.pump()  # serves both replicas' HELLOs: every chunk is queued
    stream_s = time.perf_counter() - t0
    boot = {}
    for nid in ("n1", "n2"):
        rep = c.members[nid].replicator
        t0 = time.perf_counter()
        for _ in range(100):
            if rep.index is not None:
                break
            rep.pump()
        torch.cuda.synchronize()
        if rep.index is None:
            fail(f"cluster (1): {nid} never finished its bootstrap")
        s = stream_s + time.perf_counter() - t0
        mb = wire.chunk_bytes.get(nid, 0) / 1e6
        mat = timed[mat0 + len(boot)]
        boot[nid] = {"s": s, "mb": mb, "mb_per_s": mb / (s - mat),
                     "chunks": wire.chunks.get(nid, 0), "materialize_s": mat}
    c.step()  # the primary takes the acks; every replica gets its engine
    launches["bootstrap"] = _step_counts()
    want = state_digest(idx)
    digests = {nid: state_digest(m.replicator.index)
               for nid, m in c.members.items()}
    if set(digests.values()) != {want}:
        fail(f"cluster (1): digests after bootstrap {digests} != the "
             f"phase-3 index's {want}")
    print(f"ok cluster (1) three members on the card: full checkpoint of "
          f"n = {n0} in {save_s:.3f} s, primary opened (recover) in "
          f"{open_s:.2f} s, its stream framed in {stream_s:.3f} s; "
          + "; ".join(f"{nid} bootstrap {b['s']:.2f} s, {b['mb']:.1f} MB "
                      f"in {b['chunks']} chunks at {b['mb_per_s']:.1f} "
                      f"MB/s, materialize {b['materialize_s']:.2f} s"
                      for nid, b in boot.items())
          + f"; digests all {want[:16]}")

    # (2) 1,024 rows in 8 quorum-durable acks of 128, stepping between
    top = float(np.max(idx.store.attrs[:n0])) + 1.0
    rows = CLUSTER_INGEST + CLUSTER_BATCH
    vecs = make_vectors(rows, d, seed=400)
    attrs = (make_attrs(vecs, seed=400) + top).astype(np.float32).astype(
        np.float64)
    batches = [(vecs[s:s + CLUSTER_BATCH], attrs[s:s + CLUSTER_BATCH])
               for s in range(0, rows, CLUSTER_BATCH)]
    reset_counts()
    caps = GRAPH_CAPTURES["chunks"]
    ack_ms, acks = [], []
    t_ing = time.perf_counter()
    for vs, as_ in batches[:-1]:
        t0 = time.perf_counter()
        acks.append(c.submit_ingest(vs, as_).lsn)
        ack_ms.append((time.perf_counter() - t0) * 1e3)
        c.step()
    c.drain()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t_ing
    launches["ingest"] = _step_counts()
    ingest_caps = GRAPH_CAPTURES["chunks"] - caps
    acked = acks[-1]
    if acks != list(range(1, len(batches))):
        fail(f"cluster (2): acked LSNs {acks}")
    lag = {}
    for nid in ("n1", "n2"):
        rep = c.members[nid].replicator
        recs = walmod.read_log(wal_dir(c.members[nid].root))
        lag[nid] = rep.lag()
        if rep.durable_lsn < acked or not recs or recs[-1][0] != acked:
            fail(f"cluster (2): {nid} durable through {rep.durable_lsn}, "
                 f"its log ends at {recs[-1][0] if recs else None}, the "
                 f"last ack was {acked}")
    digests = {nid: state_digest(m.replicator.index)
               for nid, m in c.members.items()}
    if len(set(digests.values())) != 1:
        fail(f"cluster (2): digests differ after the ingest: {digests}")
    if launches["ingest"]["gather_norm_dot"] <= 0:
        fail("cluster (2): the replicated applies never launched "
             "gather_norm_dot")
    a50, a99 = _pct(ack_ms, (50, 99))
    print(f"ok cluster (2) {CLUSTER_INGEST} rows in {len(acks)} quorum-"
          f"durable acks of {CLUSTER_BATCH}: ack p50 {a50:.1f} ms p99 "
          f"{a99:.1f} ms, {CLUSTER_INGEST / (sum(ack_ms) / 1e3):.1f} rows/s "
          f"to quorum-durable ({CLUSTER_INGEST / ingest_s:.1f} rows/s "
          f"applied on every member, {ingest_s:.2f} s), lag after drain "
          f"{lag}, {ingest_caps} graph captures during the ingest; logs "
          f"end at {acked}; digests all {digests['n0'][:16]}; launches "
          f"{launches['ingest']}")

    # (3) warm-up, then the 256 queries routed across the members
    t0 = time.perf_counter()
    c.warmup()
    warm_s = time.perf_counter() - t0
    caps = GRAPH_CAPTURES["chunks"]
    reset_counts()
    crid_qi = {}
    t0 = time.perf_counter()
    for i in range(nq):
        t = c.submit(wl.queries[i], wl.ranges[i])
        if isinstance(t, Rejected):
            fail(f"cluster (3): query {i} rejected")
        crid_qi[t.crid] = i
    replies = c.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["serve"] = _step_counts()
    serve_caps = GRAPH_CAPTURES["chunks"] - caps
    snap = take_snapshot(c.members["n0"].replicator.index)
    ref = search_batch(snap, wl.queries, wl.ranges, k=10, width=64,
                       backend="cuda", device="cuda")
    if sorted(r.crid for r in replies) != sorted(crid_qi):
        fail(f"cluster (3): {len(replies)} replies for {nq} queries")
    by_node, recs, lat, degraded = {}, [], [], 0
    for r in replies:
        i = crid_qi[r.crid]
        want_ids = np.where(ref.ids[i] >= 0,
                            snap.ids_map[np.clip(ref.ids[i], 0, None)], -1)
        if not (np.array_equal(r.reply.ids, want_ids)
                and np.array_equal(r.reply.dists, ref.dists[i])
                and (r.reply.hops, r.reply.dc) == (ref.hops[i],
                                                   ref.dc[i])):
            fail(f"cluster (3): query {i}'s reply from {r.node} differs "
                 f"from search_batch through the kernel")
        by_node[r.node] = by_node.get(r.node, 0) + 1
        recs.append(recall(r.reply.ids[r.reply.ids >= 0], wl.gt[i]))
        lat.append(r.reply.latency_s * 1e3)
        degraded += int(r.reply.degraded)
    rec = float(np.mean(recs))
    if serve_caps:
        fail(f"cluster (3): {serve_caps} graph captures after warm-up")
    if rec < 0.90:
        fail(f"cluster (3): recall@10 {rec:.4f} < 0.90")
    if launches["serve"]["gather_norm_dot"] \
            + launches["serve"]["replayed_gather_norm_dot"] <= 0:
        fail("cluster (3): gather_norm_dot neither launched nor replayed")
    l50, l95, l99 = _pct(lat)
    qps = nq / wall
    print(f"ok cluster (3) warm-up {warm_s:.2f} s; {nq} queries in "
          f"{wall * 1e3:.1f} ms, {qps:.1f} QPS, latency p50 {l50:.1f} p95 "
          f"{l95:.1f} p99 {l99:.1f} ms, replies by member {by_node}, "
          f"degraded {degraded}, captures after warm-up {serve_caps}, "
          f"recall@10 {rec:.4f}; every reply bitwise search_batch through "
          f"the kernel; launches {launches['serve']}")

    # (4) an unplanned failover with 64 queries in flight
    reset_counts()
    crids = set()
    for i in range(CLUSTER_OUTSTANDING):
        crids.add(c.submit(wl.queries[i], wl.ranges[i]).crid)
    # one live turn first: the replicas hear a heartbeat, so the timeout
    # counts from the kill, as in a cluster that was serving all along
    got = [r.crid for r in c.step()]
    in_flight = len(crids) - len(got)
    t_kill = time.monotonic()
    c.kill("n0")
    while time.monotonic() - t_kill < 60.0:
        got.extend(r.crid for r in c.step())
        if c.failovers and set(got) >= crids:
            break
    torch.cuda.synchronize()
    failover_s = time.monotonic() - t_kill
    launches["failover"] = _step_counts()
    if sorted(got) != sorted(crids):
        fail(f"cluster (4): {len(got)} replies ({len(set(got))} distinct) "
             f"for {len(crids)} queries in flight")
    if [f["planned"] for f in c.failovers] != [False]:
        fail(f"cluster (4): failovers {c.failovers}")
    new = c.members[c.primary_id]
    promo_s = c.failovers[0]["t"] - t_kill
    promo_lsn = new.replicator.epoch_base
    epoch = new.replicator.epoch
    if epoch != 1 or walmod.log_epoch(wal_dir(new.root)) != 1:
        fail(f"cluster (4): epoch {epoch}, on disk "
             f"{walmod.log_epoch(wal_dir(new.root))}")
    if new.replicator._last_lsn < acked:
        fail(f"cluster (4): the new primary ends at "
             f"{new.replicator._last_lsn} < the last ack {acked}")
    reset_counts()
    t0 = time.perf_counter()
    deposed = recover(roots[0], upto_lsn=promo_lsn, device="cuda")
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    launches["recover_deposed"] = _step_counts()
    d_new = state_digest(new.replicator.index)
    if state_digest(deposed) != d_new:
        fail("cluster (4): the promoted index differs from the deposed "
             "primary's disk at the promotion LSN")
    del deposed
    print(f"ok cluster (4) kill n0 with {in_flight} of {len(crids)} "
          f"queries in flight: "
          f"promoted {c.primary_id} to epoch {epoch} {promo_s:.3f} s after "
          f"the kill (heartbeat timeout {c.heartbeat_timeout_s} s) at LSN "
          f"{promo_lsn}; all {len(crids)} answered once in "
          f"{failover_s:.3f} s; digest {d_new[:16]} = recover(n0's disk, "
          f"upto_lsn={promo_lsn}) ({rec_s:.2f} s); launches "
          f"{launches['failover']}")

    # (5) ingest under the new epoch, the deposed primary rejoins, then
    # every member restarts with 64 queries outstanding
    reset_counts()
    t0 = time.perf_counter()
    post = c.submit_ingest(*batches[-1]).lsn
    post_ms = (time.perf_counter() - t0) * 1e3
    if post != acked + 1:
        fail(f"cluster (5): the first ack of epoch 1 is LSN {post}, not "
             f"{acked + 1}")
    c.drain()
    t0 = time.perf_counter()
    c.restart("n0")
    for _ in range(100_000):
        rep = c.members["n0"].replicator
        if rep.caught_up() and rep.durable_lsn == post:
            break
        c.step()
    torch.cuda.synchronize()
    rejoin_s = time.perf_counter() - t0
    crids = set()
    for i in range(CLUSTER_OUTSTANDING):
        crids.add(c.submit(wl.queries[i], wl.ranges[i]).crid)
    t0 = time.perf_counter()
    res = c.rolling_restart()
    roll_s = time.perf_counter() - t0
    got = [r.crid for r in res["replies"]] + [r.crid for r in c.drain()]
    torch.cuda.synchronize()
    launches["rolling"] = _step_counts()
    kinds = [w for w, _ in res["events"]]
    if sorted(got) != sorted(crids):
        fail(f"cluster (5): {len(got)} replies ({len(set(got))} distinct) "
             f"for {len(crids)} queries outstanding")
    if kinds.count("restarted") != 3 or kinds.count("handover") != 1 \
            or [f["planned"] for f in c.failovers] != [False, True]:
        fail(f"cluster (5): events {res['events']}, failovers "
             f"{c.failovers}")
    if not all(m.admitted and m.role != "down" for m in c.members.values()):
        fail("cluster (5): a member is not back")
    digests = {nid: state_digest(m.replicator.index)
               for nid, m in c.members.items()}
    if len(set(digests.values())) != 1:
        fail(f"cluster (5): digests differ after the restart: {digests}")
    print(f"ok cluster (5) ack of epoch 1 at LSN {post} in {post_ms:.1f} "
          f"ms; n0 rejoined (recover + catch-up) in {rejoin_s:.2f} s; "
          f"rolling restart {roll_s:.2f} s: {res['events']}; "
          f"{len(crids)} queries answered once; primary {c.primary_id} "
          f"epoch {c.members[c.primary_id].replicator.epoch}; digests all "
          f"{digests['n0'][:16]}; launches {launches['rolling']}")
    for nid, m in c.members.items():
        if m.role != "down":
            c.kill(nid)
    return {"launches": launches, "save_s": save_s, "open_s": open_s,
            "stream_s": stream_s, "bootstrap": boot,
            "ack_ms": {"p50": a50, "p99": a99},
            "quorum_rows_per_s": CLUSTER_INGEST / (sum(ack_ms) / 1e3),
            "applied_rows_per_s": CLUSTER_INGEST / ingest_s,
            "ingest_captures": ingest_caps, "warmup_s": warm_s, "qps": qps,
            "latency_ms": {"p50": l50, "p95": l95, "p99": l99},
            "by_node": by_node, "recall": rec, "promotion_s": promo_s,
            "failover_s": failover_s, "promotion_lsn": promo_lsn,
            "recover_deposed_s": rec_s, "rejoin_s": rejoin_s,
            "rolling_restart_s": roll_s, "events": res["events"],
            "top": float(np.max(attrs)) + 1.0}


def _cluster_leg_b(out: dict, base: str, timed: list, a: dict) -> dict:
    """A primary in a process of its own, over localhost TCP, SIGKILLed
    after its 4th ack; the replica here promotes itself and serves."""
    import signal

    import numpy as np

    from repro_torch.core.device_search import search_batch
    from repro_torch.core.snapshot import take_snapshot
    from repro_torch.persist import (
        ReplicaReplicator, SocketEndpoint, recover, state_digest, wal_dir,
    )
    from repro_torch.persist import wal as walmod
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.lifecycle import EngineConfig

    wl = out["workload"]
    nq = len(wl.queries)
    launches = {}
    proot = os.path.join(base, "sigkill-primary")
    ep = SocketEndpoint("R")
    host, port = ep.addr
    rep = ReplicaReplicator(os.path.join(base, "sigkill-replica"), ep, "R",
                            device="cuda")
    rep.start()
    child = SIGKILL_CHILD.format(
        root=proot, host=host, port=port, top=a["top"],
        rows=SIGKILL_BATCHES * CLUSTER_BATCH, batch=CLUSTER_BATCH,
        batches=SIGKILL_BATCHES, acked=SIGKILL_ACKED)
    free, total = torch.cuda.mem_get_info()
    print(f"cluster (b): device memory before the child: "
          f"{free / 2**30:.2f} GiB free of {total / 2**30:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated here")
    reset_counts()
    mat0 = len(timed)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    logs = [os.path.join(base, f"child.{s}") for s in ("out", "err")]
    man = t_meta = t_ready = None
    # the child's output goes to files: a full pipe would block it
    with open(logs[0], "w") as fo, open(logs[1], "w") as fe:
        t_spawn = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", child], stdout=fo,
                                stderr=fe, env=env)
        try:
            while proc.poll() is None and \
                    time.perf_counter() - t_spawn < 400:
                rep.pump()
                if t_meta is None and rep._boot is not None:
                    t_meta, man = time.perf_counter(), rep._boot["man"]
                if t_ready is None and rep.index is not None:
                    t_ready = time.perf_counter()
                time.sleep(0.001)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
    t_dead = time.perf_counter()
    with open(logs[0]) as f:
        stdout = f.read()
    with open(logs[1]) as f:
        stderr = f.read()
    if proc.returncode != -signal.SIGKILL:
        fail(f"cluster (b): the child ended with {proc.returncode}, not "
             f"SIGKILL:\n{stdout}\n{stderr[-4000:]}")
    lines = [ln.split() for ln in stdout.splitlines()]
    ack_lines = [ln for ln in lines if ln and ln[0] == "ACK"]
    if len(ack_lines) != SIGKILL_ACKED:
        fail(f"cluster (b): {len(ack_lines)} acks, not {SIGKILL_ACKED}:\n"
             f"{stdout}")
    ready_s = next(float(ln[1]) for ln in lines if ln and ln[0] == "READY")
    acked_lsn = int(ack_lines[-1][2])
    for _ in range(200):  # what is still in the socket buffers
        rep.pump()
        time.sleep(0.001)
    launches["sigkill_replica"] = _step_counts()
    if rep.index is None or rep.durable_lsn < acked_lsn:
        fail(f"cluster (b): the replica is durable through "
             f"{rep.durable_lsn}, the child acked {acked_lsn}")
    if launches["sigkill_replica"]["gather_norm_dot"] <= 0:
        fail("cluster (b): the replica's applies never launched "
             "gather_norm_dot")
    time.sleep(rep.heartbeat_timeout_s + 0.1)
    if rep.primary_alive():
        fail("cluster (b): the dead primary still counts as alive")
    epoch = rep.promote()
    t_promoted = time.perf_counter()
    if epoch != 1 or walmod.log_epoch(wal_dir(rep.root)) != 1:
        fail(f"cluster (b): promoted to epoch {epoch}")
    reset_counts()
    t0 = time.perf_counter()
    disk = recover(proot, upto_lsn=rep.index._applied_lsn, device="cuda")
    rec_s = time.perf_counter() - t0
    if state_digest(disk) != state_digest(rep.index):
        fail("cluster (b): the promoted replica differs from the dead "
             "primary's disk at the promotion LSN")
    del disk
    eng = ServeEngine(index=rep.index, device="cuda", config=EngineConfig(
        k=10, width=64, max_wave=64, backend="cuda", adaptive=False))
    tickets = [eng.submit(wl.queries[i], wl.ranges[i]) for i in range(nq)]
    replies = {r.rid: r for r in eng.drain()}
    launches["sigkill_serve"] = _step_counts()
    snap = take_snapshot(rep.index)
    ref = search_batch(snap, wl.queries, wl.ranges, k=10, width=64,
                       backend="cuda", device="cuda")
    for i, t in enumerate(tickets):
        r = replies[t.rid]
        want = np.where(ref.ids[i] >= 0,
                        snap.ids_map[np.clip(ref.ids[i], 0, None)], -1)
        if not (np.array_equal(r.ids, want)
                and np.array_equal(r.dists, ref.dists[i])
                and (r.hops, r.dc) == (ref.hops[i], ref.dc[i])):
            fail(f"cluster (b): the promoted replica's reply {i} differs "
                 f"from search_batch through the kernel")
    if launches["sigkill_serve"]["gather_norm_dot"] \
            + launches["sigkill_serve"]["replayed_gather_norm_dot"] <= 0:
        fail("cluster (b): serving never launched gather_norm_dot")
    boot_mb = sum(e["nbytes"] for e in man["sections"].values()) / 1e6
    mat = timed[mat0] if len(timed) > mat0 else 0.0
    boot_s = t_ready - t_meta
    ack50 = _pct([float(ln[3]) for ln in ack_lines], (50,))[0]
    rep.wal.close()
    ep.close()
    print(f"ok cluster (b) SIGKILLed primary over TCP: child ready "
          f"(imports, open_durable on the card) {ready_s:.2f} s; bootstrap "
          f"{boot_mb:.1f} MB in {boot_s:.2f} s (materialize {mat:.2f} s, "
          f"stream {boot_mb / (boot_s - mat):.1f} MB/s); "
          f"{SIGKILL_ACKED} acks, quorum wait p50 {ack50:.1f} ms (whole "
          f"insert_batch p50 "
          f"{_pct([float(ln[4]) for ln in ack_lines], (50,))[0]:.1f} ms); "
          f"replica durable through {rep.durable_lsn}; kill -> promotion "
          f"{t_promoted - t_dead:.2f} s (heartbeat timeout "
          f"{rep.heartbeat_timeout_s} s) to epoch {epoch}; digest = "
          f"recover(the child's disk, upto_lsn={rep.index._applied_lsn}) "
          f"({rec_s:.2f} s); {nq} replies bitwise search_batch through "
          f"the kernel; launches {launches}")
    return {"launches": launches, "child_ready_s": ready_s,
            "bootstrap_s": boot_s, "bootstrap_mb": boot_mb,
            "bootstrap_mb_per_s": boot_mb / (boot_s - mat),
            "ack_ms_p50": ack50, "kill_to_promotion_s": t_promoted - t_dead,
            "recover_s": rec_s,
            "free_gib_before_child": free / 2**30}


def _graph_digest(idx) -> str:
    """sha256 over an index's neighbor arrays and degree counts."""
    import hashlib

    h = hashlib.sha256()
    for arrs in (idx.graph.layers, idx.graph.counts):
        for a in arrs:
            h.update(a.tobytes())
    return h.hexdigest()


def _arena_digest(arena) -> str:
    """sha256 over the bytes of a build arena's device buffers."""
    import hashlib

    h = hashlib.sha256()
    for t in (arena.vectors, arena.q_scales, arena.sq_norms, arena.attrs,
              arena.neighbors):
        if t is not None:
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()


def _timed_build(vectors, attrs, backend: str, **extra) -> tuple:
    """One build of ``vectors`` on ``cuda:0`` in micro-batches of 128 (the
    parameters of phase 3), with the counts set to 0 just before it and
    read just after it -> (index, what it measured)."""
    from repro_torch import monitoring
    from repro_torch.core import WoWIndex
    from repro_torch.core.device_search import GRAPH_CAPTURES, KERNEL_REPLAYS
    from repro_torch.persist import state_digest

    idx = WoWIndex(dim=vectors.shape[1], device="cuda:0", **SHARDED_KW)
    reset_counts()
    caps = GRAPH_CAPTURES["chunks"]
    n0 = len(monitoring.spans())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the sharded arena's searches and their all-gathers are spans
    with monitoring.tracing(backend == "sharded"):
        idx.insert_batch(vectors, attrs, batch_size=128, backend=backend,
                         **extra)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    counts = read_counts()
    spans = monitoring.spans()[n0:]

    def span_s(name: str) -> float:
        return sum(r["t1"] - r["t0"] for r in spans
                   if r["name"] == f"repro_torch.build.{name}")

    run = {"backend": backend, **extra, "s": s,
           "rows_per_s": len(attrs) / s, "launches": counts,
           "replayed": KERNEL_REPLAYS["gather_norm_dot"],
           "captures": GRAPH_CAPTURES["chunks"] - caps,
           "graph": _graph_digest(idx), "digest": state_digest(idx),
           "arena": _arena_digest(idx._arena)}
    if backend == "sharded":
        run.update(phase1_s=span_s("sharded_search"),
                   phase2_s=s - span_s("sharded_search"),
                   gather_ms=span_s("gather") * 1e3)
    return idx, run


def _mesh_waves(mesh, snap, queries, ranges, visited: str = "hash",
                waves: int = 5) -> dict:
    """``make_serving_fn`` on ``mesh`` through the kernel (lock-step; the
    hashed filter sized adaptively): one checked wave with the counts set
    to 0 just before it and read just after it, then ``waves`` timed
    waves (p50 latency, QPS)."""
    from repro_torch.core.distributed import make_serving_fn

    fn = make_serving_fn(mesh, snap, k=10, width=64, backend="cuda",
                         visited=visited,
                         visited_adaptive=visited == "hash")
    bits0 = fn.state["bits"]
    reset_counts()
    res = fn(queries, ranges)
    counts = read_counts()
    hist = fn.state["hist"].copy()
    times = []
    for _ in range(waves):
        t0 = time.perf_counter()
        fn(queries, ranges)  # host arrays back: the wave has finished
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    return {"result": tuple(res), "bits0": bits0, "hist": hist,
            "launches": counts, "p50_ms": p50 * 1e3,
            "qps": len(queries) / p50}


def _sharded_rank(rank: int, world: int, store: str, vectors, attrs,
                  queries, ranges, results) -> None:
    """One rank of phase 5e's multi-rank run: a process of its own on
    ``cuda:0`` (the one card), joined to the others by gloo over a
    ``FileStore``; the sharded build of the phase's rows, then the
    ``world`` x 1 mesh serving over the index it built.  Puts what it
    measured on ``results``; a failure ends the process non-zero."""
    import torch.distributed as dist

    from repro_torch.core.snapshot import take_snapshot
    from repro_torch.parallel import serving_mesh

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        idx, build = _timed_build(vectors, attrs, "sharded", shards=world)
        mesh = serving_mesh(world, 1, device="cuda:0")
        serve = _mesh_waves(mesh, take_snapshot(idx), queries, ranges)
        results.put((rank, {"build": build, "serve": serve,
                            "data": mesh.coord("data")}))
    finally:
        dist.destroy_process_group()


def _spawn_sharded_ranks(vectors, attrs, queries, ranges) -> list:
    """Run ``_sharded_rank`` on SHARDED_RANKS processes -> their results
    in rank order (``_spawn_ranks``)."""
    return _spawn_ranks(_sharded_rank, SHARDED_RANKS, "sharded",
                        (vectors, attrs, queries, ranges))


def _spawn_ranks(target, world: int, tag: str, args: tuple,
                 timeout: float = 600) -> list:
    """Run ``target(rank, world, store, *args, results)`` on ``world``
    processes spawned with ``torch.multiprocessing``, joined by a
    ``FileStore`` under a fresh temporary directory -> their results in
    rank order.  A rank that fails, or hangs for ``timeout`` s, fails the
    phase."""
    import queue
    import shutil
    import tempfile

    import torch.multiprocessing as tmp

    base = tempfile.mkdtemp(prefix=f"wow-{tag}-")
    results = tmp.get_context("spawn").Queue()
    ctx = tmp.start_processes(
        target, nprocs=world, join=False, start_method="spawn",
        args=(world, os.path.join(base, "store"), *args, results))
    got = {}
    deadline = time.perf_counter() + timeout
    try:
        while len(got) < world:
            try:
                rank, res = results.get(timeout=1.0)
                got[rank] = res
                continue
            except queue.Empty:
                pass
            # join raises when a rank failed, and is True once all exited
            if ctx.join(timeout=0.1) or time.perf_counter() > deadline:
                fail(f"{tag}: {world - len(got)} rank(s) ended or hung "
                     f"without a result")
        while not ctx.join(timeout=60):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        shutil.rmtree(base, ignore_errors=True)
    return [got[r] for r in range(world)]


def _row_sq_check() -> dict:
    """How many batch sizes B in 1..300 give some row other bits than at
    B = 300: torch's plain row sum and ``device_search._row_sq`` (which
    must give none), at D 128 and 3,584."""
    from repro_torch.core.device_search import _row_sq

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for D in (128, 3584):
        x = torch.randn(300, D, device="cuda", generator=gen)
        plain, rows = (x * x).sum(1), _row_sq(x)
        out[D] = {
            "plain": sum(not torch.equal((x[:b] * x[:b]).sum(1), plain[:b])
                         for b in range(1, 301)),
            "row_sq": sum(not torch.equal(_row_sq(x[:b]), rows[:b])
                          for b in range(1, 301))}
        print(f"sharded: query norms at D {D}: batch sizes of 1..300 whose "
              f"rows differ from B = 300's: plain row sum {out[D]['plain']}, "
              f"_row_sq {out[D]['row_sq']}")
        if out[D]["row_sq"]:
            fail(f"sharded: _row_sq depends on the batch size at D {D}")
    return out


def phase_sharded(out: dict) -> dict:
    """The sharded build and mesh serving (phase 5e of the module
    docstring): three builds of the first N_SHARDED rows of phase 3's
    stream, 1 x 1 mesh serving over phase 3's index and SHARDED_RANKS x 1
    over the ranks' own index."""
    import gc

    import numpy as np

    from repro_torch.core.device_search import search_batch
    from repro_torch.core.snapshot import take_snapshot
    from repro_torch.parallel import serving_mesh

    gc.collect()
    torch.cuda.empty_cache()  # the ranks' contexts share the card
    row_sq = _row_sq_check()
    wl = out["workload"]
    vec, att = wl.vectors[:N_SHARDED], wl.attrs[:N_SHARDED]
    q, r = wl.queries, wl.ranges
    dev_idx, dev = _timed_build(vec, att, "device")
    _, one = _timed_build(vec, att, "sharded", shards=1)
    small = _mesh_waves(serving_mesh(1, 1, device="cuda:0"),
                        take_snapshot(dev_idx), q, r)
    del dev_idx
    ranks = _spawn_sharded_ranks(vec, att, q, r)
    builds = {"device": dev, "sharded@1": one,
              **{f"sharded@{SHARDED_RANKS} rank {i}": rk["build"]
                 for i, rk in enumerate(ranks)}}
    for tag, b in builds.items():
        extra = (f", phase 1 {b['phase1_s']:.2f} s (its gathers "
                 f"{b['gather_ms']:.1f} ms), the rest (phase 2 and the "
                 f"carry) {b['phase2_s']:.2f} s" if "phase1_s" in b else "")
        print(f"sharded: {tag} build of {N_SHARDED} rows: {b['s']:.2f} s, "
              f"{b['rows_per_s']:.1f} rows/s, gather_norm_dot launches "
              f"{b['launches']['gather_norm_dot']} + {b['replayed']} "
              f"replayed, {b['captures']} graphs captured{extra}")
        if b["launches"]["gather_norm_dot"] <= 0 or \
                b["launches"]["batched_dot"]:
            fail(f"sharded: {tag} build launches {b['launches']}")
        if (b["graph"], b["digest"]) != (dev["graph"], dev["digest"]):
            fail(f"sharded: the {tag} build's neighbor arrays or "
                 f"state_digest differ from the device build's")
    if len({rk["build"]["arena"] for rk in ranks}) != 1:
        fail("sharded: the ranks' arenas hold different bytes")
    print(f"ok sharded builds: device, sharded@1 and sharded@"
          f"{SHARDED_RANKS} (every rank) bitwise equal (neighbor arrays, "
          f"state_digest, the ranks' arena bytes)")

    runs = {f"1x1 ({N_SHARDED:,}-row index)": small,
            **{f"{SHARDED_RANKS}x1 rank {i}": rk["serve"]
               for i, rk in enumerate(ranks)}}
    for i, rk in enumerate(ranks):
        _same_replies(f"sharded: {SHARDED_RANKS} x 1 rank {i} vs 1 x 1",
                     rk["serve"]["result"], small["result"])
        if not np.array_equal(rk["serve"]["hist"], small["hist"]):
            fail(f"sharded: rank {i}'s hop histogram differs from 1 x 1's")
    snap = take_snapshot(out["index"])
    for visited in ("hash", "bitmap"):
        run = runs[f"1x1 {visited} (phase 3's index)"] = _mesh_waves(
            serving_mesh(1, 1, device="cuda:0"), snap, q, r, visited)
        exp = search_batch(snap, q, r, k=10, width=64, backend="cuda",
                           visited=visited, visited_bits=run["bits0"],
                           device="cuda:0")
        _same_replies(f"sharded: 1 x 1 {visited} vs search_batch",
                     run["result"], exp)
        H = len(run["hist"]) - 1
        if visited == "hash" and not np.array_equal(
                run["hist"],
                np.bincount(np.clip(exp.hops, 0, H), minlength=H + 1)):
            fail("sharded: the 1 x 1 histogram differs from search_batch's "
                 "hops")
    for tag, run in runs.items():
        print(f"sharded: serve {tag}: {run['qps']:.1f} QPS, p50 "
              f"{run['p50_ms']:.1f} ms a wave of {len(q)}, launches "
              f"{run['launches']}")
        if run["launches"]["gather_norm_dot"] <= 0 or \
                run["launches"]["batched_dot"]:
            fail(f"sharded: serve {tag} launches {run['launches']}")
    print(f"ok sharded serving: 1 x 1 over phase 3's index ({snap.n} rows) "
          f"bitwise search_batch (hash with its histogram, bitmap); "
          f"{SHARDED_RANKS} x 1 on every rank bitwise 1 x 1")
    paths = {**{f"build {k}": b["launches"] for k, b in builds.items()},
             **{f"serve {k}": s["launches"] for k, s in runs.items()}}
    return {
        "launches": {k: sum(c[k] for c in paths.values())
                     for k in ("gather_norm_dot", "batched_dot")},
        "by_path": {k: c["gather_norm_dot"] for k, c in paths.items()},
        "rows_per_s": {k: b["rows_per_s"] for k, b in builds.items()},
        "ranks": [{k: rk["build"][k] for k in ("phase1_s", "phase2_s",
                                               "gather_ms", "captures")}
                  for rk in ranks],
        "serve": {k: {"qps": s["qps"], "p50_ms": s["p50_ms"]}
                  for k, s in runs.items()},
        "row_sq": row_sq,
    }


def phase_rag(cfg, params, kw: dict) -> dict:
    """The RAG pipeline at qwen2-7b's full width on the bf16 model's
    weights (see the module docstring, phase 6)."""
    import numpy as np

    from repro_torch.core.device_search import to_device_index
    from repro_torch.kernels.gather_distance import gather_norm_dot
    from repro_torch.kernels.ref import gather_norm_dot_ref
    from repro_torch.serve import LMServer, RagPipeline

    rng = np.random.default_rng(11)
    server = LMServer(cfg, params, backend="auto", **kw)
    rag = RagPipeline(server, dim=cfg.d_model, build_backend="device")
    docs = rng.integers(0, cfg.vocab_size, (RAG_DOCS + RAG_INGEST, 64)
                        ).astype(np.int32)
    years = 1990.0 + rng.integers(0, 35, RAG_DOCS + RAG_INGEST)
    qt = rng.integers(0, cfg.vocab_size, (RAG_QUERIES, 16)).astype(np.int32)
    lo = rng.integers(1990, 2025, RAG_QUERIES)
    span = rng.choice([0, 1, 4, 9, 34], RAG_QUERIES)
    qr = np.stack([lo, np.minimum(lo + span, 2024)], 1).astype(np.float32)

    server.embed(docs[:8])  # warm (first-call costs out of the timings)
    reset_counts()
    t0 = time.perf_counter()
    embs = server.embed(docs[:512])
    embed_s = time.perf_counter() - t0
    n_embed = read_counts()["flash_attention"]
    if n_embed != cfg.num_layers:
        fail(f"rag embed: {n_embed} flash_attention launches, expected "
             f"{cfg.num_layers}")
    if not np.isfinite(embs).all():
        fail("rag embed: non-finite embedding")
    # the kernel's embeds held to the plain path's at the two shapes this
    # phase sends it: 512 documents x 64 tokens and the 256 queries x 16
    plain = LMServer(cfg, params, backend="ref", **kw)
    gen = torch.Generator(device="cuda").manual_seed(12)
    q_emb = server.embed(qt)
    reset_counts()
    held = {"docs_512x64": _hold_embed(
                "rag embed 512 x 64", params, cfg, docs[:512], embs,
                plain.embed(docs[:512]), gen, kw["compute_dtype"]),
            "queries_256x16": _hold_embed(
                "rag embed 256 x 16", params, cfg, qt, q_emb,
                plain.embed(qt), gen, kw["compute_dtype"])}
    if any(read_counts().values()):
        fail(f"rag: the plain embeds launched a kernel {read_counts()}")
    for name, h in held.items():
        print(f"ok rag embed {name}, kernel against plain: {h['text']}")
    del plain

    embed, embed_s_in = server.embed, [0.0]

    def timed_embed(tokens):  # the embed's share of add_documents
        t = time.perf_counter()
        out = embed(tokens)  # a host array: the device has finished
        embed_s_in[0] += time.perf_counter() - t
        return out

    server.embed = timed_embed
    reset_counts()
    t0 = time.perf_counter()
    for s in range(0, RAG_DOCS, 512):
        res = rag.add_documents(docs[s:s + 512], years[s:s + 512])
        if res.accepted != min(512, RAG_DOCS - s):
            fail(f"rag add_documents: {res!r}")
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    corpus_embed_s = embed_s_in[0]
    server.embed = embed
    t0 = time.perf_counter()
    ids, dists = rag.retrieve_batch(qt, qr)
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rag.add_documents(docs[RAG_DOCS:], years[RAG_DOCS:])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids, dists = rag.retrieve_batch(qt, qr)
    batch2_s = time.perf_counter() - t0
    counts = read_counts()
    calls = RAG_DOCS // 512 + 3  # corpus, two query batches, the ingest
    if counts["flash_attention"] != calls * cfg.num_layers:
        fail(f"rag: flash_attention launched {counts['flash_attention']} "
             f"times, expected {calls * cfg.num_layers}")
    if counts["gather_norm_dot"] <= 0:
        fail("rag: gather_norm_dot was never launched")

    # the same 256 through the request lifecycle
    emb = server.embed(qt)
    if not (np.array_equal(emb, q_emb)
            and np.array_equal(emb, server.embed(qt))):
        fail("rag: embed is not deterministic")
    eng = rag.engine(k=5, width=48)
    reset_counts()
    warm_s = eng.warmup()
    tickets = [eng.submit(emb[i], qr[i]) for i in range(RAG_QUERIES)]
    replies = {r.rid: r for r in eng.drain()}
    eng_counts = read_counts()
    for i, t in enumerate(tickets):
        r = replies[t.rid]
        if r.degraded or not (np.array_equal(r.ids, ids[i])
                              and np.array_equal(r.dists, dists[i])):
            fail(f"rag engine(): reply {i} differs from retrieve_batch")
    est = eng.engine_stats()
    if eng_counts["gather_norm_dot"] <= 0:
        fail("rag engine(): gather_norm_dot was never launched")

    # recall@5 against brute force over the stored embeddings
    store = rag.index.store
    vecs = store.vectors[: store.n].astype(np.float64)
    attrs = store.attrs[: store.n]
    recs, ties = [], 0
    for i in range(RAG_QUERIES):
        inr = np.flatnonzero((attrs >= qr[i, 0]) & (attrs <= qr[i, 1]))
        d = ((vecs[inr] - emb[i].astype(np.float64)) ** 2).sum(1)
        order = np.argsort(d, kind="stable")
        gt = inr[order[:5]]
        if len(order) > 5 and d[order[4]] == d[order[5]]:
            ties += 1
        got = ids[i][ids[i] >= 0]
        recs.append(len(set(got.tolist()) & set(gt.tolist()))
                    / max(min(5, len(inr)), 1))
    rec = float(np.mean(recs))

    # gather_norm_dot at the RAG width, on the pipeline's own table
    di = to_device_index(rag._snap, device="cuda")
    n_live = store.n
    q = torch.as_tensor(emb, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    K = rag.index.params.m + 1
    idl = [torch.randint(0, n_live, (RAG_QUERIES, K), device="cuda",
                         generator=gen) for _ in range(20)]
    kd, kv = gather_norm_dot(di.vectors, idl[0], q)
    rd, rv = gather_norm_dot_ref(di.vectors, idl[0], q)
    torch.cuda.synchronize()
    vn = rv.double().sqrt()
    qn = q.double().norm(dim=1)[:, None]
    tag = f"gather_norm_dot f32 D={cfg.d_model}"
    err = max(_check_close(tag, kd, rd, vn * qn),
              _check_close(tag, kv, rv, vn * vn))
    kern = lambda i: gather_norm_dot(di.vectors, idl[i], q)  # noqa: E731
    plain = lambda i: gather_norm_dot_ref(di.vectors, idl[i], q)  # noqa: E731
    ms, plain_ms = _time_ms(kern, 20), _time_ms(plain, 20)
    dev_ms, plain_dev_ms = _graph_ms_alternating((kern, plain), 20)
    D, B = cfg.d_model, RAG_QUERIES
    rows = int(torch.unique(idl[0]).numel())
    nbytes = rows * D * 4 + B * K * 8 + B * D * 4 + 2 * B * K * 4
    bound_ms, bound_by = _bound(nbytes, 4 * B * K * D)
    case = {"vec_dtype": "f32", "n": n_live, "B": B, "K": K, "D": D,
            "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}
    print(f"{tag} n={n_live} B={B} K={K}: {ms * 1e3:.2f} us (plain "
          f"{plain_ms * 1e3:.2f} us); device, graph-replayed: "
          f"{dev_ms * 1e3:.3f} us (plain {plain_dev_ms * 1e3:.3f} us), "
          f"bound {bound_ms * 1e3:.3f} us ({bound_by}, {nbytes} B), max err "
          f"{err:.3e}")
    durable = _rag_durable(cfg, server, docs, years, qt, qr)
    st = rag.stats()
    print(f"ok rag (d {cfg.d_model}, {RAG_DOCS} + {RAG_INGEST} documents): "
          f"embed {512 / embed_s:.1f} docs/s (512 x 64 tokens in "
          f"{embed_s:.3f} s); corpus embedded and built in {corpus_s:.2f} s "
          f"({RAG_DOCS / corpus_s:.1f} docs/s; embeds {corpus_embed_s:.2f} "
          f"s, the device build {RAG_DOCS / (corpus_s - corpus_embed_s):.1f} "
          f"rows/s); ingest {RAG_INGEST} in "
          f"{ingest_s:.2f} s ({RAG_INGEST / ingest_s:.1f} rows/s); "
          f"retrieve_batch of {RAG_QUERIES}: {batch_s * 1e3:.1f} ms, after "
          f"the ingest {batch2_s * 1e3:.1f} ms; recall@5 vs brute force "
          f"{rec:.4f} ({ties} queries with a tie at the 5th); engine() "
          f"equal to retrieve_batch bitwise (warmup {warm_s:.2f} s, "
          f"{est['waves']} waves, {est['chunks']} chunks, p50 "
          f"{est['p50_ms']:.1f} ms); launches {counts}, engine "
          f"{eng_counts}; index {st['index_size']} rows")
    return {"launches": counts, "engine_launches": eng_counts,
            "durable": durable,
            "recall": rec, "embed_docs_per_s": 512 / embed_s,
            "corpus_s": corpus_s, "corpus_embed_s": corpus_embed_s,
            "ingest_rows_per_s": RAG_INGEST / ingest_s,
            "batch_ms": batch_s * 1e3, "batch_after_ingest_ms":
            batch2_s * 1e3, "gather": case,
            "embed_vs_plain": {k: {f: v for f, v in h.items() if f != "text"}
                               for k, h in held.items()}}


def _rag_durable(cfg, server, docs, years, qt, qr) -> dict:
    """The RAG pipeline's durable leg at the model's width (see the module
    docstring, phase 6): a logged build of 512 documents and a checkpoint,
    a second pipeline's cold start off it, bitwise the first's replies,
    then 64 more documents through its lazy recovery."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.serve import RagPipeline

    root = tempfile.mkdtemp(prefix="wow-rag-")
    try:
        reset_counts()
        t0 = time.perf_counter()
        rag = RagPipeline(server, dim=cfg.d_model, build_backend="device",
                          index_dir=root)
        res = rag.add_documents(docs[:512], years[:512])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if res.accepted != 512 or res.lsn != 4:
            fail(f"rag durable build: {res!r}")
        t0 = time.perf_counter()
        rag.checkpoint()
        ckpt_s = time.perf_counter() - t0
        ids, dists = rag.retrieve_batch(qt, qr)
        t0 = time.perf_counter()
        cold = RagPipeline(server, dim=cfg.d_model, build_backend="device",
                           index_dir=root)
        cids, cdists = cold.retrieve_batch(qt, qr)
        cold_s = time.perf_counter() - t0
        if cold._index is not None:
            fail("rag durable: the cold start recovered the index")
        if not (np.array_equal(cids, ids) and np.array_equal(cdists, dists)):
            fail("rag durable: the cold start's replies differ from the "
                 "first pipeline's")
        t0 = time.perf_counter()
        more = cold.add_documents(docs[512:576], years[512:576])
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        nids, ndists = cold.retrieve_batch(qt, qr)
        counts = read_counts()
        if more.accepted != 64 or len(cold.index) != 576:
            fail(f"rag durable ingest: {more!r}, {len(cold.index)} rows")
        inr = (years[np.clip(nids, 0, None)] >= qr[:, :1]) & \
            (years[np.clip(nids, 0, None)] <= qr[:, 1:])
        if not (inr | (nids < 0)).all() or not np.isfinite(
                ndists[nids >= 0]).all():
            fail("rag durable: a reply after the ingest is out of range")
        if counts["gather_norm_dot"] <= 0 or \
                counts["flash_attention"] != 5 * cfg.num_layers:
            fail(f"rag durable: launches {counts}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"ok rag durable (d {cfg.d_model}): 512 documents embedded and "
          f"built with the log in {build_s:.2f} s, checkpoint "
          f"{ckpt_s:.2f} s; a second pipeline's cold start answered "
          f"{len(qt)} queries in {cold_s * 1e3:.1f} ms, bitwise the "
          f"first's; 64 more documents through its lazy recovery in "
          f"{ingest_s:.2f} s (lsn {more.lsn}); launches {counts}")
    return {"launches": counts, "build_s": build_s, "checkpoint_s": ckpt_s,
            "cold_first_reply_ms": cold_s * 1e3, "ingest_s": ingest_s}


def _noise(params, names, gen) -> None:
    """Add 0.02 * N(0, 1) from ``gen`` to the tensors ``names`` (dotted
    paths under each layer) of every layer that has them, in place."""
    for blk in params["blocks"]:
        for name in names:
            if name.split(".")[0] not in blk.keys():
                continue
            t = blk
            for part in name.split("."):
                t = t[part]
            t.add_(torch.randn(t.shape, generator=gen, device=t.device),
                   alpha=0.02)


def _near_tie_ok(got, want, margins, tol: float):
    """Generated tokens equal, or at each row's first differing step the
    plain run's top-2 margin is below ``tol`` -> (ok, rows that differ)."""
    rows = []
    for b in range(got.shape[0]):
        diff = (got[b] != want[b]).nonzero()[0]
        if diff.size:
            step = int(diff[0])
            rows.append((b, step, float(margins[b, step])))
    return all(m < tol for _, _, m in rows), rows


def _sensitivity(params, cfg, toks, gen, dtype) -> tuple[float, float]:
    """How far the plain path's last-position logits and its ``embed``
    move when the input embeddings are perturbed by one ulp of the
    compute type (relative ``finfo(dtype).eps``: 2^-23 in f32, 2^-7 in
    bf16; random signs) -> (logits, embed): the conditioning of the
    model on these tokens.  Kernel and plain round in other places, so
    they can differ by about this much whatever the kernel does; with
    random weights rwkv6's first positions amplify such rounding."""
    from repro_torch.models import forward

    x = params["embed"][torch.as_tensor(toks, device="cuda").long()]
    sign = torch.randint(0, 2, x.shape, device="cuda", generator=gen) * 2 - 1
    eps = torch.finfo(x.dtype).eps
    xp = (x.float() * (1.0 + eps * sign)).to(x.dtype)
    # the int64 signs and the f32 table (~3 GiB at Jamba's T = 2,048) are
    # not held across the forwards, whose plain attention peaks near the
    # card's memory
    del sign
    logits = []
    with torch.inference_mode():
        for inp in (x, xp):
            lg, _, _ = forward(params, cfg, inp, mode="train",
                               backend="ref", compute_dtype=dtype,
                               last_only=True)
            logits.append(lg[:, -1].float())
            del lg
    del x, xp
    table = params["embed"].float()
    embs = [torch.softmax(lg, -1) @ table for lg in logits]
    return (float((logits[0] - logits[1]).abs().max()),
            float((embs[0] - embs[1]).abs().max()))


def _hold_embed(tag: str, params, cfg, toks, ek, ep, gen, dtype) -> dict:
    """Hold the kernel path's embed ``ek`` of ``toks`` to the plain path's
    ``ep``: finite, and within LM_REL_TOL of max |embed| or 4x how far a
    one-ulp perturbation of the input embeddings moves the plain embed,
    whichever is larger; fails the phase otherwise."""
    import numpy as np

    e_err = float(np.abs(ek - ep).max())
    e_scale = float(np.abs(ep).max())
    _, sens = _sensitivity(params, cfg, toks, gen, dtype)
    e_tol = max(LM_REL_TOL * e_scale, 4.0 * sens)
    if not (np.isfinite(ek).all() and e_err <= e_tol):
        fail(f"{tag}: differs by {e_err} > {e_tol} (max |embed| "
             f"{e_scale}, one-ulp input sensitivity {sens})")
    return {"err": e_err, "max_embed": e_scale, "sensitivity": sens,
            "tol": e_tol, "text": (
                f"err {e_err:.3e} of max {e_scale:.4e} (tolerance "
                f"{e_tol:.3e}; a one-ulp perturbation of the input "
                f"embeddings moves the plain embed by {sens:.3e})")}


def phase_lm(run: str) -> dict:
    """Serve the model of ``LM_MODELS[run]`` at full width through the
    kernels and the plain versions (see the module docstring, phases 6
    and 6b)."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, param_count
    from repro_torch.serve import LMServer

    spec = LM_MODELS[run]
    per_run, dtype = spec["launches"], spec["dtype"]
    cfg = get_arch(spec["arch"])
    if spec["layers"] is not None:  # depth cut: the first layers of the
        n = spec["layers"]  # pattern, full width
        cfg = dataclasses.replace(cfg, num_layers=n,
                                  block_pattern=cfg.block_pattern[:n])
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{run}: before the weights, {torch.cuda.memory_allocated()} bytes "
          f"allocated, {torch.cuda.memory_reserved()} reserved on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda", dtype=dtype)
    _noise(params, spec["noise"], gen)
    torch.cuda.synchronize()
    n_params = param_count(params)
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"{run}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{n_params} parameters ({n_bytes} bytes, "
          f"{str(dtype).split('.')[-1]}), built in "
          f"{time.perf_counter() - t0:.2f} s")
    kw = dict(device="cuda", compute_dtype=dtype)
    rng = np.random.default_rng(0)
    for backend in ("auto", "ref"):  # first-call costs out of the timings
        LMServer(cfg, params, max_len=96, backend=backend, **kw).generate(
            rng.integers(0, cfg.vocab_size, (LM_BATCH, 64)).astype(np.int32),
            steps=2)
    batches, launches = [], {k: 0 for k in per_run}
    for T in LM_PROMPTS:
        prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, T)).astype(
            np.int32)
        runs = {}
        for backend in ("auto", "ref"):
            srv = LMServer(cfg, params, max_len=T + LM_DECODE,
                           backend=backend, **kw)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            toks = srv.generate(prompts, steps=LM_DECODE)
            counts = read_counts()
            runs[backend] = (toks, dict(srv.last_run), counts,
                             torch.cuda.max_memory_allocated())
        (tk, rk, ck, mk), (tp, rp, cp, mp) = runs["auto"], runs["ref"]
        tag = f"{run} T={T}"
        want = {k: per_run.get(k, 0) for k in ck}
        if ck != want or any(cp.values()):
            fail(f"{tag}: launches {ck} (expected {want}), plain {cp}")
        for k in launches:
            launches[k] += ck[k]
        scale = float(rp["prefill_logits"].abs().max())
        err = float((rk["prefill_logits"] - rp["prefill_logits"]).abs().max())
        sens = None
        tol = LM_REL_TOL * scale
        if dtype != torch.float32:  # the bf16 rule: the run's conditioning
            sens, _ = _sensitivity(params, cfg, prompts, gen, dtype)
            tol = max(tol, 4.0 * sens)
        if not err <= tol:
            fail(f"{tag}: prefill logits differ by {err} > {tol} (max "
                 f"|logit| {scale}, one-ulp input sensitivity {sens})")
        ok, rows = _near_tie_ok(tk, tp, rp["margins"], tol)
        if not ok:
            fail(f"{tag}: tokens differ beyond a near tie {rows}")
        b = {"T": T, "logit_err": err, "max_logit": scale,
             "logit_sensitivity": sens, "logit_tol": tol,
             "differing_rows": rows}
        for name, r, peak in (("kernel", rk, mk), ("plain", rp, mp)):
            b[name] = {"prefill_ms": r["prefill_s"] * 1e3,
                       "decode_ms_per_token": r["decode_s"] * 1e3
                       / r["decode_steps"], "peak_bytes": peak}
        batches.append(b)
        print(f"ok {tag}: prefill {b['kernel']['prefill_ms']:.1f} ms "
              f"(plain {b['plain']['prefill_ms']:.1f}), decode "
              f"{b['kernel']['decode_ms_per_token']:.2f} ms/token (plain "
              f"{b['plain']['decode_ms_per_token']:.2f}), peak "
              f"{mk / 2**30:.2f} GiB (plain {mp / 2**30:.2f}); logits err "
              f"{err:.3e} of max {scale:.3f} (tolerance {tol:.3e}, one-ulp "
              f"input sensitivity {sens}); {len(rows)} of {LM_BATCH} rows "
              f"differ (first step, plain margin: {rows}); launches {ck}")

    toks = rng.integers(0, cfg.vocab_size, LM_EMBED).astype(np.int32)
    embeds = {}
    for backend in ("auto", "ref"):
        srv = LMServer(cfg, params, backend=backend, **kw)
        reset_counts()
        embeds[backend] = (srv.embed(toks), read_counts())
    (ek, ck), (ep, cp) = embeds["auto"], embeds["ref"]
    if ck != {k: per_run.get(k, 0) for k in ck} or any(cp.values()):
        fail(f"{run} embed: launches {ck}, plain {cp}")
    for k in launches:
        launches[k] += ck[k]
    held = _hold_embed(f"{run} embed {LM_EMBED}", params, cfg, toks, ek, ep,
                       gen, dtype)
    print(f"ok {run} embed {LM_EMBED}: {held['text']}, launches {ck}")

    rag = phase_rag(cfg, params, kw) if run == RAG_ARCH_RUN else None

    srv = LMServer(cfg, params, max_len=LM_PROMPTS[-1] + LM_DECODE,
                   backend="auto", **kw)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPTS[-1])).astype(np.int32),
        device="cuda")
    srv._prefill(tokens)  # warm
    trace = _trace(lambda: srv._prefill(tokens), f"lm_{run}_prefill")
    if {k: trace["kernels"][k] for k in per_run} != per_run:
        fail(f"{run} prefill trace: {trace['kernels']} kernel events, "
             f"expected {per_run}")
    logits, caches = srv._prefill(tokens)
    tok = torch.argmax(logits.float(), dim=-1)[:, None].to(torch.int32)
    pos = torch.full((LM_BATCH,), LM_PROMPTS[-1], dtype=torch.int32,
                     device="cuda")
    srv._decode(tok, pos, caches)  # warm (rewrites the same cache slot)
    decode_trace = _trace(lambda: srv._decode(tok, pos, caches),
                          f"lm_{run}_decode")
    if any(decode_trace["kernels"].values()):
        fail(f"{run} decode trace: kernels {decode_trace['kernels']}")
    del logits, caches
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "arch": spec["arch"], "launches": launches,
            "params": n_params, "param_bytes": n_bytes, "batches": batches,
            "embed_err": held["err"], "trace": trace,
            "decode_trace": decode_trace,
            "rag": rag}


# ------------------------------------------------------------- 7b. train
def _checksums(params) -> torch.Tensor:
    """One int64 per parameter: the sum of its words (a changed value
    changes it)."""
    return torch.stack([p.detach().view(-1).view(torch.int32).to(
        torch.int64).sum() for p in params.parameters()])


def _train_full_width() -> dict:
    """Leg (a) of phase 7b (see the module docstring)."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import abstract_params, init_params, param_count
    from repro_torch.serve import LMServer
    from repro_torch.train import AdamW, DataConfig, TokenSource
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import decay_mask

    cfg = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS,
                              block_pattern=cfg.block_pattern[:TRAIN_LAYERS])
    meta = abstract_params(cfg)
    n_params = param_count(meta)
    n_vocab = cfg.vocab_size * cfg.d_model
    n_layers = sum(p.numel() for n, p in meta.named_parameters()
                   if n.startswith("blocks."))
    reckon = 16 * n_params  # f32 weights, gradients, m and v
    del meta
    print(f"train: {cfg.name} cut to {cfg.num_layers} layers, {n_params} "
          f"parameters ({n_layers} in the layers, {n_vocab} each in embed "
          f"and lm_head); weights + gradients + m + v reckoned at {reckon} "
          f"bytes ({reckon / 1e9:.2f} GB)")
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    params.requires_grad_(True)
    data = TokenSource(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  kind="random"))

    def batch(step: int):
        tok, lab = data.host_batch(step, 0, [0])
        return (torch.as_tensor(tok, device="cuda"),
                torch.as_tensor(lab, device="cuda"))

    # step 1 on one microbatch, the weights left as they are (lr 0; bf16
    # moments, which this step never reads back, to save 6 GB)
    tok, lab = batch(0)
    before = _checksums(params)
    zero = AdamW(lr=0.0, warmup=0, state_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    _, st0, m1 = make_train_step(cfg, zero, microbatches=1)(
        params, zero.init(params), tok, lab)
    one = {k: float(v) for k, v in m1.items()}
    peak_one = torch.cuda.max_memory_allocated()
    if not torch.equal(_checksums(params), before):
        fail("train: a zero learning rate changed the weights")
    del st0
    gc.collect()
    torch.cuda.empty_cache()

    opt = AdamW(lr=3e-4, warmup=2, total_steps=100)
    state = opt.init(params)
    step = make_train_step(cfg, opt, microbatches=TRAIN_MICRO, remat=True)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        tok, lab = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, m = step(params, state, tok, lab)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append({"ms": ms, **{k: float(v) for k, v in m.items()}})
        if i == 0:
            no_grad = [n for n, t in state.m.items() if not bool(
                (t != 0).any())]
            same = [n for (n, _), a, b in zip(
                params.named_parameters(), before, _checksums(params))
                if a == b]
            if no_grad or same:
                fail(f"train: without a gradient {no_grad}, unchanged "
                     f"{same}")
    peak = torch.cuda.max_memory_allocated()
    tok, lab = batch(TRAIN_STEPS)  # one more step, traced
    trace = _trace(lambda: step(params, state, tok, lab), "train_step")
    if any(trace["kernels"].values()):
        fail(f"train step trace: kernel events {trace['kernels']} (the "
             "step runs the plain versions)")
    s1 = steps[0]
    loss_gap = abs(s1["loss"] - one["loss"])
    norm_gap = abs(s1["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
    if not (loss_gap < TRAIN_MICRO_TOL and norm_gap < TRAIN_MICRO_TOL):
        fail(f"train: {TRAIN_MICRO} microbatches {s1} against one {one}")
    losses = [s["loss"] for s in steps]
    if not (all(math.isfinite(x) for x in losses)
            and abs(losses[0] - math.log(cfg.vocab_size)) < 0.5):
        fail(f"train: losses {losses}, ln V {math.log(cfg.vocab_size)}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = (6 * (n_layers + n_vocab) + 2 * n_layers) * tokens
    warm = statistics.median(s["ms"] for s in steps[1:])
    for i, s in enumerate(steps):
        print(f"train step {i + 1}: {s['ms']:.1f} ms, {tokens / s['ms'] * 1e3:.0f} "
              f"tokens/s, {flops / s['ms'] / 1e9:.1f} TFLOP/s; loss "
              f"{s['loss']:.4f}, grad norm {s['grad_norm']:.4f}, lr "
              f"{s['lr']:.3e}")

    # the AdamW update alone (the moments stand in for gradients: the same
    # tensors to read); it moves the weights, which the serve check below
    # takes as they come
    decay = decay_mask(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    upd = []
    for _ in range(3):
        ev[0].record()
        opt.update(state.m, state, params, decay)
        ev[1].record()
        torch.cuda.synchronize()
        upd.append(ev[0].elapsed_time(ev[1]))
    adamw_ms = statistics.median(upd)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"ok train full width: step {warm:.1f} ms (median of steps 2-"
          f"{TRAIN_STEPS}), {tokens / warm * 1e3:.0f} tokens/s, "
          f"{flops / warm / 1e9:.1f} TFLOP/s of {flops:.4e} flops a step "
          f"({flops / warm / 1e9 / (BF16_FLOPS / 1e12):.3f} of the bf16 "
          f"peak); one microbatch: loss {one['loss']:.6f}, grad norm "
          f"{one['grad_norm']:.6f}, {TRAIN_MICRO}: {s1['loss']:.6f}, "
          f"{s1['grad_norm']:.6f} (gaps {loss_gap:.3e}, {norm_gap:.3e} "
          f"relative, limit {TRAIN_MICRO_TOL:g}); peak {peak} bytes "
          f"({peak / 1e9:.2f} GB; one-microbatch check "
          f"{peak_one / 1e9:.2f} GB) against {reckon / 1e9:.2f} GB reckoned; AdamW update {adamw_ms:.1f} ms "
          f"({adamw_ms / warm:.3f} of the step)")

    # serve the trained weights as they are
    B, T = TRAIN_SERVE
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    runs = {}
    for backend in ("auto", "ref"):
        srv = LMServer(cfg, params, max_len=T + 1, device="cuda",
                       backend=backend, compute_dtype=torch.float32)
        reset_counts()
        srv.generate(prompts, steps=1)
        runs[backend] = (srv.last_run["prefill_logits"], read_counts())
    (lk, ck), (lp, cp) = runs["auto"], runs["ref"]
    want = {k: (cfg.num_layers if k == "flash_attention" else 0) for k in ck}
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    if ck != want or any(cp.values()) or not (
            torch.isfinite(lk).all() and err <= LM_REL_TOL * scale):
        fail(f"train serve: launches {ck} (expected {want}), plain {cp}; "
             f"logits differ by {err} of max {scale}")
    print(f"ok train serve {B} x {T} (f32, the trained weights): logits err "
          f"{err:.3e} of max {scale:.3f}, launches {ck}")
    del params, srv
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, "layer_params": n_layers,
            "reckoned_bytes": reckon, "peak_bytes": peak,
            "peak_bytes_one_microbatch": peak_one, "steps": steps,
            "step_ms": warm, "tokens_per_s": tokens / warm * 1e3,
            "tflops": flops / warm / 1e9, "flops_per_step": flops,
            "adamw_ms": adamw_ms, "adamw_share": adamw_ms / warm,
            "one_microbatch": one, "serve_err": err, "serve_max": scale,
            "launches": ck, "trace": trace}


def _train_resume() -> dict:
    """Leg (b) of phase 7b (see the module docstring)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.train import AdamW, DataConfig, TokenSource, Trainer

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).reduced(), vocab_size=256)
    data = TokenSource(DataConfig(vocab_size=256, seq_len=64,
                                  global_batch=16, kind="markov"))
    total = 2 * RESUME_STEPS
    opt = AdamW(lr=1e-3, warmup=min(20, total // 5), total_steps=total)
    root = tempfile.mkdtemp()
    try:
        kw = dict(log_every=10, ckpt_every=10)
        t0 = time.perf_counter()
        a = Trainer(cfg, opt, data, ckpt_dir=os.path.join(root, "a"), **kw)
        hist = a.run(RESUME_STEPS)
        a.finish()
        a = Trainer(cfg, opt, data, ckpt_dir=os.path.join(root, "a"), **kw)
        if a.step_idx != RESUME_STEPS:
            fail(f"train resume: at step {a.step_idx}")
        hist += a.run(RESUME_STEPS)
        a.finish()
        resumed_s = time.perf_counter() - t0
        b = Trainer(cfg, opt, data, ckpt_dir=os.path.join(root, "b"), **kw)
        whole = b.run(total)
        b.finish()
        same = [n for (n, p), q in zip(a.params.named_parameters(),
                                       b.params.parameters())
                if not torch.equal(p, q)]
        same += [f"m {n}" for n in a.opt_state.m
                 if not torch.equal(a.opt_state.m[n], b.opt_state.m[n])]
        same += [f"v {n}" for n in a.opt_state.v
                 if not torch.equal(a.opt_state.v[n], b.opt_state.v[n])]
        if same or {int(a.opt_state.step), int(b.opt_state.step)} != {total}:
            fail(f"train resume: differs from the uninterrupted run in "
                 f"{same[:5]} ({len(same)} tensors)")
        la = [(h["step"], h["loss"]) for h in hist]
        lb = [(h["step"], h["loss"]) for h in whole]
        floor = data.entropy_rate()
        first, last = lb[0][1], lb[-1][1]
        if la != lb or not (last < first and abs(last - floor)
                            < abs(first - floor)):
            fail(f"train resume: losses {la} against {lb} (floor {floor})")
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        t1 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             TRAIN_ARCH, "--reduced", "--steps", str(RESUME_STEPS),
             "--device", "cuda"], capture_output=True, text=True, env=env,
            timeout=300, cwd=root)
        launcher_s = time.perf_counter() - t1
        if res.returncode != 0:
            fail(f"train launcher exited {res.returncode}:\n{res.stdout}\n"
                 f"{res.stderr}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"ok train resume: {total} steps resumed at {RESUME_STEPS} bitwise "
          f"the uninterrupted run (parameters, m, v, step; losses {lb}); "
          f"loss floor {floor:.4f}; the resumed pair {resumed_s:.2f} s; "
          f"launcher {launcher_s:.2f} s: "
          f"{res.stdout.strip().splitlines()[-1]}")
    return {"losses": lb, "entropy_rate": floor, "resumed_s": resumed_s,
            "launcher_s": launcher_s}


def phase_train() -> dict:
    return {"full_width": _train_full_width(), "resume": _train_resume()}


def _train_cfg():
    """Phase 7b's model: TRAIN_ARCH at full width cut to TRAIN_LAYERS."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(TRAIN_ARCH)
    return dataclasses.replace(cfg, num_layers=TRAIN_LAYERS,
                               block_pattern=cfg.block_pattern[:TRAIN_LAYERS])


def _mesh_rank(rank: int, world: int, store: str, legs: tuple,
               results) -> None:
    """One rank of phases 7c and 7d: a process of its own on ``cuda:0``,
    joined to the others by gloo over a ``FileStore``; the mesh train
    step on each ``(kind, (data, model))`` leg of ``legs`` in turn
    (``_mesh_leg``).  Puts what it measured on ``results``; a failure
    ends the process non-zero."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        results.put((rank, [_mesh_leg(shape, kind) for kind, shape in legs]))
    finally:
        dist.destroy_process_group()


def _leg_setup(kind: str):
    """A leg's model, rules, presets (or a dict of knobs) and optimizer:
    "tp" phase 7b's (phase 7c), "res" the same under ``residual_spec =
    RES_SPEC`` (phase 7c leg (c)), "ep" phase 7d (a)'s MoE under
    ``RULES_EP_DATA``, "seq" phase 7b's model under SEQ_TUNE (phase 7d
    (b))."""
    from repro_torch.parallel import RULES_EP_DATA, RULES_TP_FSDP
    from repro_torch.train import AdamW

    if kind == "ep":
        return (_ep_cfg(), RULES_EP_DATA, EP_TUNE,
                AdamW(lr=3e-4, warmup=2, total_steps=100,
                      state_dtype="bfloat16"))
    tune = {"seq": SEQ_TUNE, "res": {"residual_spec": RES_SPEC}}.get(kind, "")
    return (_train_cfg(), RULES_TP_FSDP, tune,
            AdamW(lr=3e-4, warmup=2, total_steps=100))  # phase 7b's


def _ep_cfg():
    """Phase 7d (a)'s model: EP_ARCH at full width cut to TRAIN_LAYERS."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(EP_ARCH)
    return dataclasses.replace(cfg, num_layers=TRAIN_LAYERS,
                               block_pattern=cfg.block_pattern[:TRAIN_LAYERS])


def _mesh_leg(shape: tuple, kind: str = "tp") -> dict:
    """This rank's MESH_STEPS steps of a leg's model (``_leg_setup``) on a
    ``shape`` mesh of the ranks, under its presets: what it measured (and
    for "seq" the serving leg, ``_seq_serve``)."""
    import dataclasses

    from repro_torch.models.tuning import TUNING, apply_preset, set_tuning

    cfg, rules, tune, opt = _leg_setup(kind)
    saved = dataclasses.asdict(TUNING)
    set_tuning(**tune) if isinstance(tune, dict) else apply_preset(tune)
    try:
        return _run_leg(cfg, rules, opt, shape, kind)
    finally:
        for k, v in saved.items():
            setattr(TUNING, k, v)


def _run_leg(cfg, rules, opt, shape: tuple, kind: str) -> dict:
    """``_mesh_leg``'s steps under the presets already applied."""
    import gc

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.parallel import param_shardings, token_sharding
    from repro_torch.train import (
        DataConfig, TokenSource, jit_train_step, make_train_step,
    )

    mesh = make_host_mesh(shape, ("data", "model"), device="cuda:0")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")  # the one-rank weights
    specs = param_shardings(params, rules, mesh)
    blocks = {n: sp for n, sp in specs.items()
              if n.startswith("blocks.")}
    step = make_train_step(cfg, opt, microbatches=TRAIN_MICRO,
                           grad_shardings=specs, block_param_specs=blocks)
    js = jit_train_step(step, mesh, specs,
                        token_sharding(mesh, TRAIN_BATCH))
    js.sharded.shard(params)  # the full tensors go
    gc.collect()
    torch.cuda.empty_cache()
    params.requires_grad_(True)
    state = opt.init(params)
    resident = js.sharded.resident_bytes(params, state)
    widest_row = max(math.prod(lay.shape[1:])
                     for lay in js.sharded.layouts.values())
    whole = sum(math.prod(lay.shape) for n, lay in
                js.sharded.layouts.items()
                if js.sharded.parts[n] is None)  # whole over model
    data = TokenSource(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH,
                                  kind="random"))
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(MESH_STEPS):
        tok, lab = data.host_batch(i, 0, [0])
        tok = torch.as_tensor(tok, device="cuda")
        lab = torch.as_tensor(lab, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, m = js(params, state, tok, lab)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        st = js.stats
        steps.append({"ms": ms, **{k: float(v) for k, v in m.items()},
                      **{f"{k[:-2]}_ms" if k.endswith("_s") else k:
                         (v * 1e3 if k.endswith("_s") else v)
                         for k, v in st.items()}})
    sp = js.sharded
    out = {"coord": (mesh.coord("data"), mesh.coord("model")),
           "steps": steps, "resident_bytes": resident,
           "widest_row": widest_row, "whole_params": whole,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "params": sum(math.prod(lay.shape) for lay in
                         sp.layouts.values()),
           "local_params": sum(lay.numel for lay in sp.layouts.values()),
           # a step's gathers: the top-level leaves once in f32, each
           # layer's bucket (bf16) in each microbatch's forward and again
           # in its rematerialised backward; expert leaves on data never
           "reckoned_gather_bytes": sum(
               sp.compute_layouts[n].chunk * 4 for n in sp.top.names)
           + 2 * TRAIN_MICRO * sum(sp.compute_layouts[n].chunk * 2
                                   for b in sp.layer_buckets
                                   for n in b.names),
           "expert_leaves": len(sp.expert_leaves),
           "experts_in_buckets": len(sp.expert_leaves & {
               n for b in [sp.top, *sp.layer_buckets] for n in b.names})}
    if kind in ("seq", "res"):
        out["serve"] = _seq_serve(cfg, js, params,
                                  SEQ_SERVE if kind == "seq" else RES_SERVE)
    del params, state, js, step, sp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _check_leg(train: dict, shape: tuple, ranks: list, wall: float,
               kind: str = "tp") -> dict:
    """One leg of phase 7c or 7d (the ranks' ``_mesh_leg`` results on a
    ``shape`` mesh) held to the one-rank steps ``train`` (phase 7b's, or
    phase 7d (a)'s for "ep"; see the module docstring)."""
    tp = shape[1] > 1
    name = {"tp": "mesh train", "ep": "ep data", "seq": "seq parallel",
            "res": "residual split"}[kind] + \
        f" (data {shape[0]}, model {shape[1]})"
    ref = train["full_width"]["steps"][0]
    r0 = ranks[0]
    metrics = [[{k: s[k] for k in ("loss", "nll", "aux", "grad_norm", "lr")}
                for s in r["steps"]] for r in ranks]
    if any(m != metrics[0] for m in metrics):
        fail(f"{name}: the ranks report different metrics {metrics}")
    s1 = r0["steps"][0]
    loss_gap = abs(s1["loss"] - ref["loss"])
    norm_gap = abs(s1["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    tol1 = MESH_TP_TOLS[0] if tp else (TRAIN_MICRO_TOL, MESH_NORM_TOL)
    if not (loss_gap < tol1[0] and norm_gap < tol1[1]):
        fail(f"{name}: step 1 {s1} against phase 7b's one rank {ref}")
    ref2, s2 = train["full_width"]["steps"][1], r0["steps"][1]
    loss_gap2 = abs(s2["loss"] - ref2["loss"])
    norm_gap2 = abs(s2["grad_norm"] - ref2["grad_norm"]) / ref2["grad_norm"]
    tol2 = MESH_TP_TOLS[1] if tp else (MESH_STEP2_TOL, MESH_STEP2_TOL)
    if not (loss_gap2 < tol2[0] and norm_gap2 < tol2[1]):
        fail(f"{name}: step 2 {s2} against phase 7b's one rank {ref2}")
    # f32 weights and moments (bf16 moments for "ep")
    per_param = 8 if kind == "ep" else 12
    world = len(ranks)
    half = per_param * r0["params"] / world
    # (data 2, model 1): within one row of the widest leaf for the three
    # tensors (the leaves the spec leaves whole, the QKV biases, sit on
    # both ranks); (data 1, model 2): the leaves whole over model sit on
    # both ranks; (data 1, model 3): only the vocab splits (the module
    # docstring), so no share is gated, the reckoning is printed
    slack = per_param * (r0["whole_params"] / 2 if tp
                         else r0["widest_row"])
    for r in ranks:
        if kind != "seq" and abs(r["resident_bytes"] - half) > slack:
            fail(f"{name}: rank {r['coord']} holds {r['resident_bytes']}"
                 f" bytes of parameters and moments, not half of "
                 f"{2 * half:.0f} (+- {slack})")
        if tp and any(s.get("gather_n", 0) for s in r["steps"]):
            fail(f"{name}: rank {r['coord']} gathered parameters "
                 f"{[s.get('gather_n', 0) for s in r['steps']]}")
        if kind == "ep":
            got = [s.get("gather_bytes", 0) for s in r["steps"]]
            if r["experts_in_buckets"] or not r["expert_leaves"] or any(
                    g != r["reckoned_gather_bytes"] for g in got):
                fail(f"{name}: rank {r['coord']} gathered {got} bytes "
                     f"against {r['reckoned_gather_bytes']} reckoned for "
                     f"the non-expert leaves; {r['experts_in_buckets']} "
                     f"of {r['expert_leaves']} expert leaves in a bucket")
            if not all(s.get("ep_all_to_all_n", 0) for s in r["steps"]):
                fail(f"{name}: rank {r['coord']} ran no all-to-all")
    for i, s in enumerate(r0["steps"]):
        print(f"{name} step {i + 1}: {s['ms']:.1f} ms; gathers "
              f"{s.get('gather_n', 0)} in {s.get('gather_ms', 0):.1f} ms "
              f"({s.get('gather_bytes', 0) / 1e9:.3f} GB sent), "
              f"reduce-scatters {s.get('reduce_scatter_n', 0)} in "
              f"{s.get('reduce_scatter_ms', 0):.1f} ms "
              f"({s.get('reduce_scatter_bytes', 0) / 1e9:.3f} GB), "
              f"all-reduces {s.get('all_reduce_n', 0)} in "
              f"{s.get('all_reduce_ms', 0):.1f} ms; model all-reduces "
              f"{s.get('tp_all_reduce_n', 0)} in "
              f"{s.get('tp_all_reduce_ms', 0):.1f} ms "
              f"({s.get('tp_all_reduce_bytes', 0) / 1e9:.3f} GB), model "
              f"max all-reduces {s.get('tp_all_reduce_max_n', 0)} in "
              f"{s.get('tp_all_reduce_max_ms', 0):.1f} ms; model "
              f"all-gathers {s.get('tp_gather_n', 0)} in "
              f"{s.get('tp_gather_ms', 0):.1f} ms "
              f"({s.get('tp_gather_bytes', 0) / 1e9:.3f} GB); data "
              f"all-to-alls {s.get('ep_all_to_all_n', 0)} in "
              f"{s.get('ep_all_to_all_ms', 0):.1f} ms "
              f"({s.get('ep_all_to_all_bytes', 0) / 1e9:.4f} GB); loss "
              f"{s['loss']:.6f}, grad norm {s['grad_norm']:.6f}")
    if tp:  # the model group's collectives a rank, by kind
        for i, s in enumerate(r0["steps"]):
            kinds = "; ".join(
                f"{k} {s.get(f'tp_{k}_n', 0)} in "
                f"{s.get(f'tp_{k}_ms', 0):.1f} ms "
                f"({s.get(f'tp_{k}_bytes', 0) / 1e9:.4f} GB given, "
                f"{s.get(f'tp_{k}_wire', 0) / 1e9:.4f} GB on the wire)"
                for k in ("all_reduce", "reduce_scatter", "gather",
                          "all_reduce_max"))
            print(f"{name} step {i + 1} model collectives a rank: {kinds}")
    if kind == "ep":
        print(f"{name}: gathered bytes a step "
              f"{[[s.get('gather_bytes', 0) for s in r['steps']] for r in ranks]}"
              f", reckoned for the non-expert leaves "
              f"{[r['reckoned_gather_bytes'] for r in ranks]}; "
              f"{r0['expert_leaves']} expert leaves, none in a bucket")
    if kind == "seq":
        print(f"{name}: {[r['local_params'] for r in ranks]} parameters "
              f"a rank; weights, gradients and moments in f32 reckoned at "
              f"{[16 * r['local_params'] for r in ranks]} bytes, peak "
              f"{[r['peak_bytes'] for r in ranks]}")
    print(f"ok {name} on {CARD[0]}: {world} ranks on one card; step 1 loss "
          f"{s1['loss']:.6f} / {ref['loss']:.6f} (gap {loss_gap:.3e}, "
          f"limit {tol1[0]:g}), grad norm {s1['grad_norm']:.6f} / "
          f"{ref['grad_norm']:.6f} ({norm_gap:.3e} relative, limit "
          f"{tol1[1]:g}); step 2 loss {s2['loss']:.6f} / "
          f"{ref2['loss']:.6f} (gap {loss_gap2:.3e}, limit {tol2[0]:g}), "
          f"grad norm {s2['grad_norm']:.6f} / {ref2['grad_norm']:.6f} "
          f"({norm_gap2:.3e} relative, limit {tol2[1]:g}); resident bytes "
          f"{[r['resident_bytes'] for r in ranks]} against 1/{world} of "
          f"the one rank's {world * half:.0f}: {half:.0f} (+- "
          f"{slack:.0f}{', not gated' if kind == 'seq' else ''}); peak bytes "
          f"{[r['peak_bytes'] for r in ranks]}; the phase {wall:.1f} s "
          f"with the spawn")
    return {"ranks": ranks, "loss_gap": loss_gap, "norm_gap": norm_gap,
            "loss_gap2": loss_gap2, "norm_gap2": norm_gap2}


def _ep_one_rank() -> dict:
    """Phase 7d (a)'s one-rank reference: the plain step of ``_ep_cfg()``
    (f32 master weights from a generator seeded 0, bf16 compute, bf16
    moments) over MESH_STEPS of phase 7b's batches, as phase 7b steps."""
    import gc

    from repro_torch.models import abstract_params, init_params, param_count
    from repro_torch.train import DataConfig, TokenSource, make_train_step

    cfg, _, _, opt = _leg_setup("ep")
    n = param_count(abstract_params(cfg))
    print(f"ep data: {cfg.name} cut to {cfg.num_layers} layers, {n} "
          f"parameters ({cfg.moe.num_experts} experts padded to "
          f"{cfg.moe.padded_experts}, top-{cfg.moe.top_k}); one rank's f32 "
          f"weights and gradients and bf16 moments reckoned at {12 * n} "
          f"bytes")
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    params.requires_grad_(True)
    state = opt.init(params)
    step = make_train_step(cfg, opt, microbatches=TRAIN_MICRO, remat=True)
    data = TokenSource(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  kind="random"))
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(MESH_STEPS):
        tok, lab = data.host_batch(i, 0, [0])
        tok = torch.as_tensor(tok, device="cuda")
        lab = torch.as_tensor(lab, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, m = step(params, state, tok, lab)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      **{k: float(v) for k, v in m.items()}})
        if not math.isfinite(steps[-1]["loss"]):
            fail(f"ep data: one-rank step {i + 1} {steps[-1]}")
    peak = torch.cuda.max_memory_allocated()
    print(f"ep data one rank: steps {[round(s['ms'], 1) for s in steps]} "
          f"ms, losses {[s['loss'] for s in steps]}, peak {peak} bytes")
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"full_width": {"steps": steps, "peak_bytes": peak}}


def phase_mesh_train(train: dict) -> dict:
    """Phase 7c and phase 7d (a) (see the module docstring), against
    phase 7b's ``train`` result and phase 7d (a)'s one-rank steps: one
    spawn of MESH_RANKS ranks runs the ``(data 2, model 1)`` leg, then
    ``(data 1, model 2)``, then the MoE leg under ``RULES_EP_DATA``."""
    t0 = time.perf_counter()
    ep_ref = _ep_one_rank()
    ep_ref_s = time.perf_counter() - t0
    legs = (("tp", (MESH_RANKS, 1)), ("tp", (1, MESH_RANKS)),
            ("res", (1, MESH_RANKS)), ("ep", (MESH_RANKS, 1)))
    t0 = time.perf_counter()
    ranks = _spawn_ranks(_mesh_rank, MESH_RANKS, "mesh-train", (legs,))
    wall = time.perf_counter() - t0
    out = {}
    for i, (kind, (d, m)) in enumerate(legs):
        leg = [r[i] for r in ranks]
        out[f"{kind}_data{d}_model{m}"] = _check_leg(
            ep_ref if kind == "ep" else train, (d, m), leg, wall, kind)
        if kind == "res":
            out["res_serve"] = _res_serve(leg)
    out["wall_s"] = wall
    out["ep_one_rank"] = ep_ref
    out["ep_one_rank_s"] = ep_ref_s
    return out


def _res_serve(ranks: list) -> dict:
    """Phase 7c leg (c)'s serving check (``_check_serve``): RES_SERVE's
    prefill and decode under ``residual_spec``, the batch rows split over
    ``model`` between the layers and gathered for the attention, against
    the one-rank forward within LM_REL_TOL; the kv heads split over
    ``model``."""
    B, T, S, steps = RES_SERVE
    name = f"residual split (data 1, model {MESH_RANKS}) serve"
    s0, launches = _check_serve(name, ranks, RES_SERVE, LM_REL_TOL,
                                [B, S, 4 // MESH_RANKS, 128])
    print(f"ok {name} on {CARD[0]}: prefill B {B} x T {T} ({B // MESH_RANKS}"
          f" row a rank between the layers, flash_attention on the "
          f"gathered rows) into {S} slots, {steps} decode step(s) in "
          f"{s0['serve_ms']:.1f} ms; max |logit| gaps "
          f"{[f'{g:.3e}' for g in s0['gaps']]} against the one-rank "
          f"forward (limits "
          f"{[f'{LM_REL_TOL * c:.3e}' for c in s0['scales']]}), tokens "
          f"{s0['tokens']}; flash_attention launched "
          f"{[r['serve']['launches'] for r in ranks]} + "
          f"{s0['ref_launches']}")
    return {"flash_launches": launches, "gaps": s0["gaps"],
            "scales": s0["scales"], "serve_ms": s0["serve_ms"]}


def _seq_serve(cfg, js, params, shape: tuple = SEQ_SERVE) -> dict:
    """The serving leg of phase 7d (b) (and of phase 7c leg (c)) on this
    rank, under the presets already applied: the trained weights at f32
    compute, a prefill of ``shape``'s batch x prompt (seeded tokens, the
    same on every rank) into a cache of its slots (split over ``model``
    under ``cache_seq_shard``), its attention through the kernel, then
    its decode steps, greedy on the logits gathered over ``model``.  Rank
    0 then runs the one-rank forward on the card (every leaf gathered
    whole) fed the same tokens: each step's max |logit| gap and scale,
    the tokens and its top-2 margins."""
    from repro_torch.models.model import (
        forward, init_cache, named_tensors, tree_from_named,
    )

    B, T, S, steps = shape
    sp = js.sharded
    tp = sp.model_split()
    named = {n: t.detach() for n, t in named_tensors(params).items()}
    prompt = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.
                           Generator().manual_seed(7)).to("cuda")
    kw = dict(cache_len=S, backend="auto", compute_dtype=torch.float32)

    def run(tree, split) -> tuple:
        caches = init_cache(cfg, B, S, torch.float32, device="cuda",
                            tp=split)
        shapes = [list(c.k.shape) for c in caches]
        reset_counts()
        lg, caches, _ = forward(tree, cfg, prompt, mode="prefill",
                                caches=caches, last_only=True, tp=split,
                                **kw)
        launches = read_counts()["flash_attention"]
        outs, toks = [], []
        for i in range(steps + 1):
            full = lg[:, -1].float()
            if split is not None and full.shape[-1] < cfg.vocab_size:
                full = split.all_gather(full, -1)
            outs.append(full)
            tok = fed[i] if fed else full.argmax(-1)
            toks.append(tok)
            if i == steps:
                break
            pos = torch.full((B,), T + i, dtype=torch.int32, device="cuda")
            lg, caches, _ = forward(tree, cfg, tok[:, None].int(),
                                    mode="decode", caches=caches, pos=pos,
                                    tp=split, **kw)
        return outs, toks, launches, shapes

    fed: list = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, toks, launches, shapes = run(sp.tree(named), tp)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
        top = _gather_to_rank0(sp, named)
        res = {"launches": launches, "cache_shapes": shapes,
               "serve_ms": serve_ms, "tokens": [t.tolist() for t in toks]}
        if sp.mesh.rank == 0:
            whole = tree_from_named(top)
            fed[:] = toks
            ref, _, ref_launches, _ = run(whole, None)
            gaps, scales, margins, same = [], [], [], []
            for got, want, tok in zip(outs, ref, toks):
                gaps.append(float((got - want).abs().max()))
                scales.append(float(want.abs().max()))
                top2 = want.topk(2, dim=-1).values
                margins.append((top2[:, 0] - top2[:, 1]).tolist())
                same.append((want.argmax(-1) == tok).tolist())
            res.update(ref_launches=ref_launches, gaps=gaps,
                       scales=scales, margins=margins, same=same)
            del whole, ref
        del top
    return res


def _gather_to_rank0(sp, named: dict) -> dict:
    """Every leaf whole on rank 0 of a ``(data 1, model n)`` mesh (``{}``
    elsewhere): the ``model`` parts sent to rank 0 alone
    (``torch.distributed.gather`` through the host), concatenated."""
    import torch.distributed as dist

    out = {}
    for n in named:
        part, t = sp.parts[n], named[n]
        if part is None:
            out[n] = t
            continue
        src = t.cpu()
        every = ([torch.empty_like(src) for _ in range(sp.mesh.size)]
                 if sp.mesh.rank == 0 else None)
        dist.gather(src, every, dst=0, group=sp.model.group)
        if every is not None:
            out[n] = torch.cat(every, dim=part.dim).to(t.device)
    return out if sp.mesh.rank == 0 else {}


def _seq_rank(rank: int, world: int, store: str, results) -> None:
    """One rank of phase 7d (b) (``_mesh_rank``'s "seq" leg)."""
    _mesh_rank(rank, world, store, (("seq", (1, SEQ_RANKS)),), results)


def _check_serve(name: str, ranks: list, shape: tuple, rel_tol: float,
                 cache: list) -> tuple:
    """A serving leg's checks (``_seq_serve``'s results of every rank on
    ``shape``): the ranks decoded the same tokens, each rank's KV cache
    a layer is ``cache`` and each rank and the one-rank prefill launched
    ``flash_attention`` once a layer, and every step's logits lie within
    ``rel_tol`` x max |logit| of the one-rank forward's (tokens equal or
    a near tie at that tolerance) -> (rank 0's result, the launches)."""
    serves = [r["serve"] for r in ranks]
    s0 = serves[0]
    if any(s["tokens"] != s0["tokens"] for s in serves):
        fail(f"{name}: the ranks decoded different tokens")
    for r, s in zip(ranks, serves):
        want = [cache] * TRAIN_LAYERS
        if s["cache_shapes"] != want or s["launches"] != TRAIN_LAYERS:
            fail(f"{name}: rank {r['coord']} cache {s['cache_shapes']}"
                 f" (want {want}), flash_attention launched "
                 f"{s['launches']} times in its prefill")
    if s0["ref_launches"] != TRAIN_LAYERS:
        fail(f"{name}: the one-rank prefill launched "
             f"{s0['ref_launches']} flash_attention")
    for i, (gap, scale, margin, same) in enumerate(zip(
            s0["gaps"], s0["scales"], s0["margins"], s0["same"])):
        tol = rel_tol * scale
        if gap > tol or not all(ok or m < tol
                                for ok, m in zip(same, margin)):
            fail(f"{name}: step {i} logits {gap:.3e} apart (limit "
                 f"{tol:.3e}), tokens equal {same}, margins {margin}")
    return s0, sum(s["launches"] for s in serves) + s0["ref_launches"]


def phase_seq_parallel(train: dict) -> dict:
    """Phase 7d (b) (see the module docstring): one spawn of SEQ_RANKS
    ranks, phase 7b's model under SEQ_TUNE, 2 steps held to phase 7b's,
    then the serving leg held to the one-rank forward."""
    t0 = time.perf_counter()
    ranks = [r[0] for r in _spawn_ranks(_seq_rank, SEQ_RANKS, "seq", ())]
    wall = time.perf_counter() - t0
    out = _check_leg(train, (1, SEQ_RANKS), ranks, wall, "seq")
    B, T, S, steps = SEQ_SERVE
    s0, launches = _check_serve("seq parallel", ranks, SEQ_SERVE,
                                LM_REL_TOL, [B, S // SEQ_RANKS, 4, 128])
    print(f"ok seq parallel serve on {CARD[0]}: {SEQ_RANKS} ranks, prefill "
          f"B {B} x T {T} (rows {T // SEQ_RANKS} a rank, the kernel at "
          f"q_offset > 0) into {S} slots ({S // SEQ_RANKS} a rank), {steps} "
          f"decode steps in {s0['serve_ms']:.1f} ms; max |logit| gaps "
          f"{[f'{g:.3e}' for g in s0['gaps']]} against the one-rank "
          f"forward (limits {[f'{LM_REL_TOL * c:.3e}' for c in s0['scales']]}"
          f"), tokens {s0['tokens']}; flash_attention launched "
          f"{[r['serve']['launches'] for r in ranks]} + "
          f"{s0['ref_launches']}; the "
          f"phase {wall:.1f} s with the spawn")
    out["flash_launches"] = launches
    out["wall_s"] = wall
    return out


def phase_tools() -> dict:
    """Phase 1c (see the module docstring)."""
    from repro_torch.launch import dryrun, quant_roofline
    from repro_torch.launch.mesh import make_production_mesh

    reset_counts()
    out = quant_roofline.main(["--gate", "--measure"])
    launches = read_counts()
    if not launches["gather_norm_dot"]:
        fail(f"tools: --measure launched no gather_norm_dot ({launches})")
    t0 = time.perf_counter()
    rec = dryrun.build_cell("rwkv6-1.6b", "decode_32k",
                            make_production_mesh())
    cell_s = time.perf_counter() - t0
    if rec.get("error") or not rec["terms"]["compute_s"] > 0 or \
            not rec["memory"]["total_bytes"] < 80e9:
        fail(f"tools: dry-run cell {rec}")
    print(f"dryrun record: {json.dumps(rec)}")
    print(f"ok tools: AI gate int8 "
          f"{out['counted']['int8']['ai_vs_f32']:.2f}x, bf16 "
          f"{out['counted']['bf16']['ai_vs_f32']:.2f}x; gather_norm_dot "
          f"launched {launches['gather_norm_dot']} times; dry-run cell "
          f"rwkv6-1.6b decode_32k in {cell_s:.1f} s: "
          f"{dryrun.fmt_row(rec)}")
    return {"measured": out["measured"],
            "counted": {m: {k: r.get(k) for k in ("flops", "bytes", "ai",
                                                  "ai_vs_f32")}
                        for m, r in out["counted"].items()},
            "launches": launches,
            "dryrun": {k: rec[k] for k in ("terms", "memory", "trace_s")}}


def _time_ms(fn, n_in: int, reps: int = 20, rounds: int = 5) -> float:
    """Median per-launch ms of ``fn(i)`` over ``rounds`` rounds of ``reps``
    launches, after 3 warm-up launches."""
    for i in range(3):
        fn(i % n_in)
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(i % n_in)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _graph_ms_alternating(fns, n_in: int, reps: int = 20,
                          rounds: int = 11, before=None) -> list:
    """Median per-launch device ms of each ``fn(i)`` of ``fns``: ``reps``
    launches captured as one CUDA graph, its replay timed by CUDA events,
    so the host's enqueue is not in the time (for kernels of a few us,
    where ``_time_ms`` measures the host).  The graphs are replayed in
    turns, round by round, in an order that alternates, so that functions
    compared in one run see the same clock and the same neighbours.
    ``before()``, if given, runs before each timed replay, outside the
    time (``_cold_l2``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream
        for fn in fns:
            for i in range(3):
                fn(i % n_in)
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for fn in fns:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(reps):
                fn(i % n_in)
        graphs.append(graph)
    for graph in graphs:
        graph.replay()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            if before is not None:
                before()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[j].replay()
            end.record()
            torch.cuda.synchronize()
            times[j].append(start.elapsed_time(end) / reps)
    del graphs
    return [statistics.median(t) for t in times]


def _cold_l2(keep):
    """A ``before`` for ``_graph_ms_alternating`` that evicts the card's
    50 MB L2 (it writes 128 MB) and then reads the tensors of ``keep`` back
    into it: what a caller finds that gathers rows from a table far larger
    than L2, its ids and queries fresh from the ops before it."""
    scratch = torch.empty(2**25, device="cuda")

    def before():
        scratch.zero_()
        for t in keep:
            t.sum()
    return before


def _bound(nbytes: int, flops: int,
           peak: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _quantize(f32: torch.Tensor, vec_dtype: str):
    """Device-side twin of ``repro_torch.core.store.quantize_rows``."""
    if vec_dtype == "f32":
        return f32, None
    if vec_dtype == "bf16":
        return f32.to(torch.bfloat16), None
    scales = f32.abs().amax(dim=1).clamp(min=1e-12) / 127.0
    slab = torch.round(f32 / scales[:, None]).clamp(-127, 127)
    return slab.to(torch.int8), scales


def _check_close(name: str, got, exp, atol) -> float:
    err = (got.double() - exp.double()).abs()
    if bool((err > 1e-5 * exp.double().abs() + 1e-5 * atol).any()):
        fail(f"{name}: max err {float(err.max())}")
    return float(err.max())


def kernels_gather(gen) -> dict:
    from repro_torch.kernels.gather_distance import gather_norm_dot
    from repro_torch.kernels.ref import gather_norm_dot_ref

    shapes = [(32768, 8, 17, 128), (32768, 256, 17, 128),
              (2**21, 128, 48, 128)]
    cases, max_err = [], 0.0
    for n, B, K, D in shapes:
        f32 = torch.randn(n, D, device="cuda", generator=gen)
        for vd in ("f32", "bf16", "int8"):
            table, scales = _quantize(f32, vd)
            ids = [torch.randint(0, n, (B, K), device="cuda", generator=gen)
                   for _ in range(20)]
            q = torch.randn(B, D, device="cuda", generator=gen)
            kd, kv = gather_norm_dot(table, ids[0], q, scales=scales)
            rd, rv = gather_norm_dot_ref(table, ids[0], q, scales=scales)
            torch.cuda.synchronize()
            vn = rv.double().sqrt()
            qn = q.double().norm(dim=1)[:, None]
            tag = f"gather_norm_dot {vd} n={n} B={B} K={K}"
            max_err = max(max_err, _check_close(tag, kd, rd, vn * qn),
                          _check_close(tag, kv, rv, vn * vn))
            kern = lambda i: gather_norm_dot(table, ids[i], q,  # noqa: E731
                                             scales=scales)
            plain = lambda i: gather_norm_dot_ref(  # noqa: E731
                table, ids[i], q, scales=scales)
            ms, plain_ms = _time_ms(kern, 20), _time_ms(plain, 20)
            # a table far larger than L2 is gathered from cold
            cold = _cold_l2([*ids, q]) if n > 2**20 else None
            dev_ms, plain_dev_ms = _graph_ms_alternating((kern, plain), 20,
                                                         before=cold)
            rows = int(torch.unique(ids[0]).numel())
            nbytes = (rows * D * table.element_size()
                      + (rows * 4 if scales is not None else 0)
                      + B * K * 8 + B * D * 4 + 2 * B * K * 4)
            bound_ms, bound_by = _bound(nbytes, 4 * B * K * D)
            cases.append({"vec_dtype": vd, "n": n, "B": B, "K": K, "D": D,
                          "ms": ms, "plain_ms": plain_ms,
                          "device_ms": dev_ms,
                          "plain_device_ms": plain_dev_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": None, "library_device_ms": None})
            print(f"{tag} D={D}: {ms * 1e3:.2f} us (plain "
                  f"{plain_ms * 1e3:.2f} us); device, graph-replayed: "
                  f"{dev_ms * 1e3:.3f} us (plain {plain_dev_ms * 1e3:.3f} "
                  f"us), bound {bound_ms * 1e3:.3f} us ({bound_by}, "
                  f"{nbytes} B)")
            del table, scales
        del f32
        torch.cuda.empty_cache()
    return {"cases": cases, "max_abs_err": max_err,
            "device_by_case": {
                f"{c['vec_dtype']} n{c['n']} B{c['B']} K{c['K']} D{c['D']}":
                c["device_ms"] * 1e3 for c in cases}}


def kernels_batched_dot(gen) -> dict:
    from repro_torch.kernels.distance import batched_dot
    from repro_torch.kernels.ref import batched_dot_ref

    shapes = [(8, 17, 128), (256, 17, 128), (128, 48, 128),
              (256, 17, 24), (256, 17, 33)]
    cases, max_err = [], 0.0
    for B, K, D in shapes:
        vs = [torch.randn(B, K, D, device="cuda", generator=gen)
              for _ in range(20)]
        q = torch.randn(B, D, device="cuda", generator=gen)
        got = batched_dot(vs[0], q)
        exp = batched_dot_ref(vs[0], q)
        torch.cuda.synchronize()
        atol = vs[0].double().norm(dim=2) * q.double().norm(dim=1)[:, None]
        tag = f"batched_dot B={B} K={K} D={D}"
        max_err = max(max_err, _check_close(tag, got, exp, atol))
        kern = lambda i: batched_dot(vs[i], q)  # noqa: E731
        plain = lambda i: batched_dot_ref(vs[i], q)  # noqa: E731
        lib = lambda i: torch.bmm(vs[i], q[:, :, None])  # noqa: E731
        ms, plain_ms, lib_ms = (_time_ms(f, 20) for f in (kern, plain, lib))
        dev_ms, plain_dev_ms, lib_dev_ms = _graph_ms_alternating(
            (kern, plain, lib), 20)
        bound_ms, bound_by = _bound((B * K * D + B * D + B * K) * 4,
                                    2 * B * K * D)
        cases.append({"B": B, "K": K, "D": D, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "device_ms": dev_ms,
                      "plain_device_ms": plain_dev_ms,
                      "library_device_ms": lib_dev_ms,
                      "device_to_bmm": dev_ms / lib_dev_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"{tag}: {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, "
              f"torch.bmm {lib_ms * 1e3:.2f} us); device, graph-replayed: "
              f"{dev_ms * 1e3:.3f} us (plain {plain_dev_ms * 1e3:.3f} us, "
              f"torch.bmm {lib_dev_ms * 1e3:.3f} us; kernel/torch.bmm "
              f"{dev_ms / lib_dev_ms:.3f}), bound {bound_ms * 1e3:.3f} us "
              f"({bound_by})")
    return {"cases": cases, "max_abs_err": max_err,
            "device_to_bmm": {f"B{c['B']} K{c['K']} D{c['D']}":
                              c["device_to_bmm"] for c in cases}}


def _visible_keys(Tq: int, Tk: int, window, q_offset: int) -> int:
    """Sum over query rows of the keys the causal mask (and the window)
    lets each see."""
    import numpy as np

    pos = np.arange(Tq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, Tk - 1)
    lo = np.maximum(0, pos - window + 1) if window else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def kernels_flash(gen) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import mha_tolerance

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (name, B, Tq, Tk, Hq, Hkv, D, window, q_offset, dtype)
        ("qwen2-7b prefill", 8, 2048, 2048, 28, 4, 128, None, 0, f32),
        ("qwen2-7b prefill bf16", 8, 2048, 2048, 28, 4, 128, None, 0, bf16),
        ("jamba prefill bf16", 8, 2048, 2048, 64, 8, 128, None, 0, bf16),
        ("qwen2-7b T=1000", 8, 1000, 1000, 28, 4, 128, None, 0, f32),
        ("qwen2-7b T=1000 bf16", 8, 1000, 1000, 28, 4, 128, None, 0, bf16),
        ("h2o-danube-3-4b", 1, 8192, 8192, 32, 8, 120, 4096, 0, f32),
        ("h2o-danube-3-4b bf16", 1, 8192, 8192, 32, 8, 120, 4096, 0, bf16),
        ("q_offset", 8, 512, 2048, 28, 4, 128, None, 1536, f32),
        # phase 7d (b)'s last rank: its 170 query rows after 340
        ("seq-parallel slice", 2, 170, 510, 28, 4, 128, None, 340, f32),
    ]
    out, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    for name, B, Tq, Tk, Hq, Hkv, D, window, q_offset, dt in cases:
        q = torch.randn(B, Tq, Hq, D, device="cuda", generator=gen).to(dt)
        k = torch.randn(B, Tk, Hkv, D, device="cuda", generator=gen).to(dt)
        v = torch.randn(B, Tk, Hkv, D, device="cuda", generator=gen).to(dt)
        kw = dict(causal=True, window=window, q_offset=q_offset)
        got = flash_attention(q, k, v, **kw)
        # the plain version on the inputs upcast, through the dispatch's
        # blocking policy; for bf16 also on |v| (the size of P V's terms)
        exp = ops.flash_attention(q.float(), k.float(), v.float(),
                                  backend="ref", **kw)
        exp_abs = (ops.flash_attention(q.float(), k.float(), v.float().abs(),
                                       backend="ref", **kw)
                   if dt == bf16 else None)
        torch.cuda.synchronize()
        err = (got.float() - exp).abs()
        case_err = float(err.max())
        if not bool((err <= mha_tolerance(exp, exp_abs, dt)).all()):
            fail(f"flash_attention {name}: max err {case_err}")
        dtype = str(dt).split(".")[-1]
        max_err[dtype] = max(max_err[dtype], case_err)
        del exp, exp_abs, err
        ms = _time_ms(lambda i: flash_attention(q, k, v, **kw), 1, reps=5)
        plain_ms = _time_ms(lambda i: ops.flash_attention(
            q, k, v, backend="ref", **kw), 1, reps=2, rounds=3)
        qpos = torch.arange(Tq, device="cuda")[:, None] + q_offset
        kpos = torch.arange(Tk, device="cuda")[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        sdpa = (dict(is_causal=True) if window is None and q_offset == 0
                else dict(attn_mask=mask))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib_ms = _time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa), 1, reps=5)
        flops = 4 * B * Hq * D * _visible_keys(Tq, Tk, window, q_offset)
        nbytes = (2 * B * Tq * Hq + 2 * B * Tk * Hkv) * D * q.element_size()
        if dt == bf16:
            bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
            basis, cores_ms = "bf16 operations", None
        else:  # 3xTF32: three TF32 products for each f32 one
            bound_ms, bound_by = _bound(nbytes, 3 * flops, TF32_FLOPS)
            basis = ("3xTF32 operations" if bound_by == "operations"
                     else "bytes")
            cores_ms = _bound(nbytes, flops, F32_FLOPS)[0]
        out.append({"case": name, "B": B, "Tq": Tq, "Tk": Tk, "Hq": Hq,
                    "Hkv": Hkv, "D": D, "window": window,
                    "q_offset": q_offset, "dtype": dtype,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_basis": basis, "bound_cuda_cores_ms": cores_ms,
                    "max_abs_err": case_err})
        print(f"flash_attention {name} (B {B}, Tq {Tq}, Tk {Tk}, {Hq}/{Hkv} "
              f"heads x {D}, window {window}, q_offset {q_offset}, {dt}): "
              f"{ms:.4f} ms (plain {plain_ms:.3f}, sdpa {lib_ms:.4f}: "
              f"{ms / lib_ms:.3f}x sdpa's time), bound {bound_ms:.4f} ms "
              f"({basis}, {flops / 1e9:.1f} GFLOP, {nbytes} B"
              + (f"; on the CUDA cores {cores_ms:.4f} ms" if cores_ms else "")
              + f"): {flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.4f} of "
              f"the bound's rate; max err {case_err:.3e}")
        del q, k, v, got, mask, qt, kt, vt
        torch.cuda.empty_cache()
    return {"cases": out, "max_abs_err": max_err}


def kernels_wkv6(gen) -> dict:
    from repro_torch.kernels.ref import wkv6_chunked, wkv6_ref
    from repro_torch.kernels.rwkv6 import wkv6

    out, max_err = [], 0.0
    for T in (2048, 1000):
        B, H, N = 8, 32, 64
        r, k, v = (torch.randn(B, H, T, N, device="cuda", generator=gen)
                   for _ in range(3))
        # decays spread over (0.05, 0.999), as the model's exp(-exp(.)) gives
        w = 0.05 + 0.949 * torch.rand(B, H, T, N, device="cuda",
                                      generator=gen)
        u = torch.randn(H, N, device="cuda", generator=gen)
        s0 = torch.randn(B, H, N, N, device="cuda", generator=gen)
        y, s = wkv6(r, k, v, w, u, state=s0)
        for plain in (wkv6_ref, lambda *a, **kw: wkv6_chunked(*a, **kw,
                                                              chunk=32)):
            ey, es = plain(r, k, v, w, u, state=s0)
            torch.cuda.synchronize()
            for got, exp in ((y, ey), (s, es)):
                err = (got - exp).abs()
                if not bool((err <= 3e-4 + 3e-4 * exp.abs()).all()):
                    fail(f"wkv6 T={T}: max err {float(err.max())}")
                max_err = max(max_err, float(err.max()))
        ms = _time_ms(lambda i: wkv6(r, k, v, w, u, state=s0), 1)
        plain_ms = _time_ms(lambda i: wkv6_ref(r, k, v, w, u, state=s0), 1,
                            reps=1, rounds=3)
        chunked_ms = _time_ms(lambda i: wkv6_chunked(
            r, k, v, w, u, state=s0, chunk=32), 1, reps=2, rounds=3)
        nbytes = 5 * B * H * T * N * 4 + 2 * B * H * N * N * 4
        bound_ms, bound_by = _bound(nbytes, 4 * B * H * T * N * N)
        out.append({"B": B, "H": H, "T": T, "N": N, "ms": ms,
                    "plain_ms": plain_ms, "chunked_ms": chunked_ms,
                    "library_ms": None, "bound_ms": bound_ms,
                    "bound_by": bound_by})
        print(f"wkv6 B {B} H {H} T {T} N {N}: {ms:.3f} ms (plain step "
              f"{plain_ms:.3f}, chunked {chunked_ms:.3f}), bound "
              f"{bound_ms:.3f} ms ({bound_by}, {nbytes} B), max err "
              f"{max_err:.3e}")
        del r, k, v, w, u, s0, y, s
        torch.cuda.empty_cache()
    return {"cases": out, "max_abs_err": max_err}


def _scan_f64(A, dt, Bm, Cm, x, h0):
    """The selective scan step by step in f64 -> (y, h_T) in f64."""
    A, dt, Bm, Cm, x, h = (a.double() for a in (A, dt, Bm, Cm, x, h0))
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + (
            dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def kernels_mamba(gen) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.ref import mamba_scan_ref

    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    # the SFUs retire 16 exponentials a clock per SM
    sfu_per_s = 16 * torch.cuda.get_device_properties(0).multi_processor_count \
        * max_mhz * 1e6
    print(f"mamba_scan: every exponential on the SFUs (ex2.approx), its "
          f"guard polynomial beside it on the FP32 pipe; SFU bound at the "
          f"max SM clock, {max_mhz:.0f} MHz")

    cases = [("jamba prefill, Mamba's init", 8, 2048, 16384, 16),
             ("jamba prefill", 8, 2048, 16384, 16),
             ("T=1000", 8, 1000, 16384, 16),
             ("ragged di", 2, 100, 200, 16),
             ("T=1", 8, 1, 16384, 16)]
    out, max_err = [], 0.0
    for name, B, T, di, N in cases:
        init = "init" in name
        if init:  # the main path's draw: S4D-real A, Mamba's dt init
            A = -torch.arange(1, N + 1, device="cuda").float().repeat(di, 1)
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(lo + (hi - lo) * torch.rand(
                B, T, di, device="cuda", generator=gen))
        else:  # A = -(1..N) spread per channel, dt from a softplus
            A = -(torch.arange(1, N + 1, device="cuda").float()
                  * torch.exp(0.1 * torch.randn(di, N, device="cuda",
                                                generator=gen)))
            dt = F.softplus(torch.randn(B, T, di, device="cuda",
                                        generator=gen) - 1.0)
        Bm, Cm = (torch.randn(B, T, N, device="cuda", generator=gen)
                  for _ in range(2))
        x = torch.randn(B, T, di, device="cuda", generator=gen)
        h0 = torch.randn(B, di, N, device="cuda", generator=gen)
        args = (A, dt, Bm, Cm, x, h0)
        y, hT = mamba_scan(*args)
        if init:  # the first 256 channels against the scan in f64
            pairs = zip((y[..., :256], hT[:, :256]), _scan_f64(
                A[:256], dt[..., :256], Bm, Cm, x[..., :256], h0[:, :256]))
        else:
            pairs = zip((y, hT), mamba_scan_ref(*args))
        case_err = 0.0
        for got, exp in pairs:
            err = (got.double() - exp.double()).abs()
            if not bool((err <= 2e-5 + 2e-5 * exp.double().abs()).all()):
                fail(f"mamba_scan {name}: max err {float(err.max())}")
            case_err = max(case_err, float(err.max()))
        torch.cuda.synchronize()
        max_err = max(max_err, case_err)
        del pairs
        ms = _time_ms(lambda i: mamba_scan(*args), 1, reps=5)
        plain_ms = _time_ms(lambda i: mamba_scan_ref(*args), 1, reps=1,
                            rounds=3)
        nbytes = (3 * B * T * di + 2 * B * T * N + di * N
                  + 2 * B * di * N) * 4
        exps = B * T * di * N
        bound_ms, bound_by = _bound(nbytes, 6 * exps)
        sfu_ms = exps / sfu_per_s * 1e3
        out.append({"case": name, "B": B, "T": T, "di": di, "N": N,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "sfu_bound_ms": sfu_ms, "exps": exps,
                    "max_abs_err": case_err})
        print(f"mamba_scan {name} (B {B}, T {T}, di {di}, N {N}): "
              f"{ms:.4f} ms (plain {plain_ms:.3f}), bound {bound_ms:.4f} ms "
              f"({bound_by}, {nbytes} B, {6 * exps / 1e9:.2f} GFLOP, "
              f"{exps / 1e9:.3f} G exp); SFU bound {sfu_ms:.4f} ms (every "
              f"exponential on the SFUs); max err {case_err:.3e}"
              + (" (first 256 channels, against f64)" if init else ""))
        del A, dt, Bm, Cm, x, h0, y, hT, args
        torch.cuda.empty_cache()
    return {"cases": out, "max_abs_err": max_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    CARD[0] = smi
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t_start = time.time()
    laps = {}

    def lap(name: str, fn, *args):
        t0 = time.time()
        out = fn(*args)
        laps[name] = round(time.time() - t0, 1)
        return out

    lap("build", phase_build)
    lint = lap("lint", phase_lint)
    tools = lap("tools", phase_tools)
    print(f"tools phase {laps['tools']} s")
    host = lap("host_serve", phase_host_serve)
    device = lap("device_build", phase_device_build)
    lap("int8_build", phase_int8_build, host["f32_recall"])
    traced = lap("trace", phase_trace, device["out"])
    engine = lap("engine", phase_engine, device["out"])
    guard = lap("guard", phase_guard, device["out"])
    print(f"guard phase {laps['guard']} s")
    durable = lap("durable", phase_durable, device["out"])
    cluster = lap("cluster", phase_cluster, device["out"])
    print(f"cluster phase {laps['cluster']} s")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions'
    torch.backends.cudnn.allow_tf32 = False  # einsums stay full f32
    lm = {run: lap(run, phase_lm, run) for run in LM_MODELS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    gnd = lap("kernels_gather", kernels_gather, gen)
    bd = lap("kernels_batched_dot", kernels_batched_dot, gen)
    fa = lap("kernels_flash", kernels_flash, gen)
    wk = lap("kernels_wkv6", kernels_wkv6, gen)
    mb = lap("kernels_mamba", kernels_mamba, gen)
    train = lap("train", phase_train)
    print(f"train phase {laps['train']} s")
    print(f"train: {json.dumps(train)}")
    mesh_train = lap("mesh_train", phase_mesh_train, train)
    print(f"mesh train phase {laps['mesh_train']} s (phase 7d (a)'s one "
          f"rank {mesh_train['ep_one_rank_s']:.1f} s of it)")
    print(f"mesh train: {json.dumps(mesh_train)}")
    seq = lap("seq_parallel", phase_seq_parallel, train)
    print(f"seq parallel phase {laps['seq_parallel']} s")
    print(f"seq parallel: {json.dumps(seq)}")
    # last: no traced phase may follow its spawned ranks (see phase 5e)
    sharded = lap("sharded", phase_sharded, device["out"])
    print(f"sharded phase {laps['sharded']} s")
    print(f"phase seconds: {laps}")
    g_main = next(c for c in gnd["cases"] if c["vec_dtype"] == "f32"
                  and c["B"] == 256 and c["K"] == 17)
    b_main = next(c for c in bd["cases"] if c["B"] == 256 and c["K"] == 17
                  and c["D"] == 128)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the WoW kernels' device time, replayed from a captured graph
    dev_keys = ("device_ms", "plain_device_ms", "library_device_ms")
    # each LM kernel's launches over every model that runs it
    lm_launches = {k: sum(r["launches"].get(k, 0) for r in lm.values())
                   for k in ("flash_attention", "wkv6", "mamba_scan")}
    lm_launches["flash_attention"] += seq["flash_launches"] + \
        mesh_train["res_serve"]["flash_launches"]
    report = {"kernels": [
        {"name": "gather_norm_dot", "route": "cuda",
         "source": "src/repro_torch/csrc/gather_norm_dot.cu",
         "replaces": "src/repro/kernels/gather_distance.py:123",
         "launches": device["launches"]["gather_norm_dot"]
         + durable["launches"]["gather_norm_dot"]
         + cluster["launches"]["gather_norm_dot"]
         + sharded["launches"]["gather_norm_dot"]
         + tools["launches"]["gather_norm_dot"],
         "executions": device["executions"]["gather_norm_dot"],
         "traced": traced["serve_fused_compact"],
         "max_abs_err": gnd["max_abs_err"],
         **{k: g_main[k] for k in keys + dev_keys},
         "device_by_case": gnd["device_by_case"],
         "rag_d3584": lm[RAG_ARCH_RUN]["rag"]["gather"],
         "traced_engine": engine["traced"],
         "launches_by_path": {
             "engine": engine["launches"]["gather_norm_dot"],
             "engine_replayed": engine["replayed"],
             "engine_b_under_ingest": {
                 b: {"captures": r["b"]["captures_after_warmup"],
                     **r["b"]["capture_kinds"],
                     "rows_per_s": N_INGEST / r["b"]["ingest_s"],
                     "p99_ms": r["b"]["latency_ms"]["p99"]}
                 for b, r in engine["runs"].items()},
             "guard": guard["launches"],
             "guard_replayed_hops": guard["replayed_hops"],
             "rag": lm[RAG_ARCH_RUN]["rag"]["launches"]["gather_norm_dot"],
             "rag_engine": lm[RAG_ARCH_RUN]["rag"]["engine_launches"][
                 "gather_norm_dot"],
             "device_build": device["launches"]["gather_norm_dot"],
             "durable": durable["launches"]["gather_norm_dot"],
             "durable_by_step": {k: c["gather_norm_dot"] for k, c in
                                 durable["by_step"].items()},
             "rag_durable": lm[RAG_ARCH_RUN]["rag"]["durable"]["launches"][
                 "gather_norm_dot"],
             "cluster": cluster["launches"]["gather_norm_dot"],
             "cluster_by_step": {
                 k: {"launches": c["gather_norm_dot"],
                     "replayed": c["replayed_gather_norm_dot"]}
                 for k, c in cluster["by_step"].items()},
             "sharded": sharded["launches"]["gather_norm_dot"],
             "sharded_by_path": sharded["by_path"],
             "tools_measure": tools["launches"]["gather_norm_dot"]},
         "measure_by_mode": tools["measured"],
         "durable": {k: v for k, v in durable.items()
                     if k not in ("launches", "by_step")},
         "cluster": {**cluster["a"], **{f"sigkill_{k}": v
                                        for k, v in cluster["b"].items()}},
         "sharded": {k: sharded[k]
                     for k in ("rows_per_s", "ranks", "serve", "row_sq")},
         "guard": {k: v for k, v in guard.items()
                   if k not in ("launches", "replayed_hops")},
         "wowlint": lint,
         "shape": {k: g_main[k] for k in ("vec_dtype", "n", "B", "K", "D")}},
        {"name": "batched_dot", "route": "cuda",
         "source": "src/repro_torch/csrc/batched_dot.cu",
         "replaces": "src/repro/kernels/distance.py:38",
         "launches": device["launches"]["batched_dot"],
         "executions": device["executions"]["batched_dot"],
         "traced": traced["serve_reference_compact"],
         "max_abs_err": bd["max_abs_err"],
         **{k: b_main[k] for k in keys + dev_keys},
         "device_to_bmm": bd["device_to_bmm"],
         "shape": {k: b_main[k] for k in ("B", "K", "D")}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:90",
         "launches": lm_launches["flash_attention"],
         "launches_by_model": {a: r["launches"]["flash_attention"]
                               for a, r in lm.items()
                               if "flash_attention" in r["launches"]},
         "launches_by_path": {
             "train_serve": train["full_width"]["launches"][
                 "flash_attention"],
             "rag": lm[RAG_ARCH_RUN]["rag"]["launches"]["flash_attention"],
             "rag_durable": lm[RAG_ARCH_RUN]["rag"]["durable"]["launches"][
                 "flash_attention"],
             "seq_parallel": seq["flash_launches"],
             "residual_split": mesh_train["res_serve"]["flash_launches"]},
         "traced": lm["qwen2-7b"]["trace"]["shares"],
         "traced_bf16": {r: lm[r]["trace"]["shares"]
                         for r in ("qwen2-7b-bf16", JAMBA)},
         "max_abs_err": fa["max_abs_err"]["float32"],
         **{k: fa["cases"][0][k] for k in keys + (
             "bound_basis", "bound_cuda_cores_ms")},
         "shape": {k: fa["cases"][0][k] for k in ("B", "Tq", "Hq", "Hkv",
                                                   "D", "dtype")},
         "bf16": {"max_abs_err": fa["max_abs_err"]["bfloat16"],
                  **{k: fa["cases"][1][k] for k in keys},
                  "shape": {k: fa["cases"][1][k] for k in (
                      "B", "Tq", "Hq", "Hkv", "D", "dtype")}}},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/rwkv6.py:83",
         "launches": lm_launches["wkv6"],
         "traced": lm["rwkv6-1.6b"]["trace"]["shares"],
         "max_abs_err": wk["max_abs_err"],
         **{k: wk["cases"][0][k] for k in keys},
         "shape": {k: wk["cases"][0][k] for k in ("B", "H", "T", "N")}},
        {"name": "mamba_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan.py:61",
         "launches": lm_launches["mamba_scan"],
         "traced": lm[JAMBA]["trace"]["shares"],
         "max_abs_err": mb["max_abs_err"],
         **{k: mb["cases"][0][k] for k in keys},
         "exps": mb["cases"][0]["exps"],
         "sfu_bound_ms": mb["cases"][0]["sfu_bound_ms"],
         "draw": mb["cases"][0]["case"],
         "shape": {k: mb["cases"][0][k] for k in ("B", "T", "di", "N")}},
    ]}
    print(f"chip_smoke: all phases passed in {time.time() - t_start:.1f}s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
