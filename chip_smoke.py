#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (foundationdb_tpu_torch) once on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
Phases, each of which must pass:

  1. the card (nvidia-smi name and power limit, torch and CUDA versions);
  2. the nvcc build of the kernels (K1-K13 and the six probes), with its
     seconds;
  3. each kernel against its plain PyTorch version on the card, on inputs
     captured from the main path at its full width (K=65,536, T=1,024,
     4/4, L=7) and on edge inputs, with EXACT equality (integer kernels),
     timed beside its plain version, its bound and a library yardstick,
     with its wrapper's host cost and its device launches a call (K1 must
     make at most 2). The sort-and-rank phase (K6 endpoint_sort, K8
     endpoint_ranks, K7 state_merge) is held whole, all seven outputs, and
     each kernel to its plain part; the phase may launch nothing but
     K6-K8, at most 3 device launches a call (K6 one cooperative launch
     on every path). Its edges: L=3, T=1 and
     T=1,000, a state that poisons, all-padding batches, long keys that
     collapse, and endpoints that all equal state keys; K6 alone also at
     L = 2, 5, 7 and 17 with M about its tiles' and rounds' edges, on
     all-equal keys and at 524,294 endpoints (endpoint_sort_edge_calls),
     and its sample path (forced where the plan takes the rounds) on a
     bucket filled to its cap and one below at L = 5, 17 and 32, and on
     sorted, reverse-sorted and all-equal keys at the main path's M
     (endpoint_sort_bucket_calls);
     K7 alone also about its tiles of 2,048, on tiles of state alone and
     of endpoints alone, endpoints all equal to state keys, all-equal
     keys, L = 2, 5 and 7, M = 0 and 1,024, cell B's K=2^20 and the
     bench's 32k shape (state_merge_edge_calls); K8 alone also at M = 1,
     2 and about its tiles of 512, on all-equal keys, L = 2 to 17, and at
     2,050 tiles, more than the card holds at once
     (endpoint_ranks_edge_calls). K1's edges: K on
     and off its 1,024-column tile up to 2^20 (2^19 + 1 among them); K2's
     (masks_and_history: the five masks of `step_masks` and the verdicts of
     `history_check` in one launch, held to the two plain parts; and
     `history_check`, the same launch on given owners): shuffled reads
     (rtxn unsorted), T=1 and T=33 with txns that have no reads and
     snapshots below the floor, all reads padding, inverted and empty
     reads, a kernel-bench step at T=32,768, and the glue's edges (T=1,
     all padding, both layouts, a poisoned state).
     K9 (the level geometry) field for field, also at T=1, T off a power
     of two, all padding, shuffled owners and heavy ties, at the span
     path's edges (T one below, at and above a span; txns piled on span
     edges; a pooled txn past a span's shared memory; nondecreasing owners
     against the same owners shuffled; the span size forced to 0, 1, 5 and
     n_levels; 2,049 spans at T=4,096: level_span_edge_calls), and at
     T=2^20 with one read and one
     write a txn (timed there too); K3 is the
     whole sandwich of a step: (lower, upper, converged) and its count of
     evaluations against the plain sandwich, also at rounds 0, 1 and 32,
     on a dependency chain deeper than the rounds (converged must be
     False) and at T=2^20 (its bit sets in global memory; timed); the
     rebase (K1 with the shift folded in) on the captured state and at
     K=2^20 with deltas 2^29 and 2^30, saturating; K4 also on a key
     group across its scan tiles and on steps that overflow (N off the
     tile size);
     K13 (step_verdicts, one cluster, with a scan's rows written too) on
     the captured calls and on edges: T=1, all padding, both layouts, a
     poisoned state, and at T = 1 to 2^20 from aligned and unaligned
     pointers (verdict_edge_calls);
     then the engine's chunks through its bucket CUDA graphs against the
     eager kernel step and the plain step, readback row and state for
     state, over a small trajectory that overflows and rebases, its state
     buffers unmoved; K5 (the legacy evaluator's whole fixpoint in one
     launch: commit, converged and its count of evaluations) on the calls
     of two legacy steps at the kernel bench's T=16,384 and of one at the
     bench's warmed state, and on edges (dependency chains of 64, 1,000
     and 4,097 txns, reads and writes shuffled, T=1, no reads, no writes,
     no eligible txn, random pooled owners), and its one-evaluation launch
     on every evaluation's input of those steps; and each probe at the
     Pallas scripts' shapes, the rank joins also on ties, limbs with the
     high bit set, LK = 1 to 8 and a tile that is not a power of two
     (probes.rank_edge_calls);
  4. the resolver role: the port's Resolver (CONFLICT_BACKEND=device,
     CONFLICT_DEVICE=cuda) in the port's EventLoop/SimNetwork answers
     chained ResolveTransactionBatchRequests from a proxy-like driver actor,
     served through the engine's bucket CUDA graphs (captured by the
     resolver's warmup, before the clock),
     phase A at the default knobs (K=65,536; 40 batches of 1,024 txns, 4
     point reads + 4 point writes each, zipfian 0.99 over 20,000 keys) and
     phase B at K=2^20 (a load of 48 batches of blind inserts, then 60
     batches over 400,000 keys); phase A's versions jump by 2^29 once,
     halfway, so the resolver rebases (the rebase kernel must launch, and
     the first batches after the jump read below the MVCC floor). Every
     reply must equal the port's
     OracleConflictSet on the same batches, no state may poison, every
     served chunk must converge on the device (so the sandwich kernel,
     not the host pass, decided its statuses), each kernel must have
     launched during the phase (launch counts are zeroed just before each
     phase and read just after), and K9, K3 and K6-K8 must have launched
     once a step (as often as K2; K13 too: a replay adds the launches its
     graph recorded at capture; no masks kernel of its own runs); the
     launches of K9 that took its span path and its general path are
     logged (`level_paths`).
     Then each kernel is held to its plain version again on one more step
     from phase B's final state (K=2^20).
  5. the kernel bench (foundationdb_tpu_torch/bench.py): run_kernel at
     T=16,384 (200 batches in chunks of 100, K=2^18) and T=32,768 (100 in
     chunks of 50, K=2^19: its window of history overflows 2^18), 16-byte
     keys, the strided layout, each chunk one replay of the scan's CUDA
     graph. Any overflow fails.
     The warm chunk's first batches must equal the OracleConflictSet on the
     same byte keys (8 batches at T=16,384, 2 at T=32,768: the oracle is
     pure Python), and the first timed chunk must equal a new scan graph,
     `conflict_scan` with the kernels run eagerly and with the plain phases
     on the card, statuses and the state after it; K9, K3, K6-K8, K2 and
     K13 must have launched once a step, and every K9 launch but the
     graph's warm-up step (an all-padding batch) must have taken its span
     path (`kernels.level_paths`). The timed core runs again graphed
     and eagerly in turns (ms/step, txns/s and peak memory of each). The
     last step of that plain chunk is captured,
     and K1-K4 and K6-K9 are held to their plain versions on its calls (K3
     and K9 at M = 49,152 and 98,304). One step at T=16,384 is profiled
     (no torch cummax scan and no cub radix sort may be left in it; phase
     3's default-knobs chunk is held to the same), and the level geometry
     is timed alone on that step's inputs: the plain phase, K9 and the
     lone `torch.sort` of its packed keys. Then the ablation profile
     (`bench.run_ablate` at T=16,384, 10 batches): the full scan and the
     six `ablate` modes through their graphs, each mode's run equal to
     the plain step with the same `ablate`, verdicts and state.
  6. the evaluator A/B: run_kernel_ab(16,384, 8), scan against legacy,
     each through its one-step scan graph, with equal statuses on every
     batch and K5 launched once a legacy step (and once for the capture's
     warm-up step);
  7. one launch's floor: probe_add on a one-element tensor, its device
     ms (torch.profiler), ms, host ms and ms a graph replay, printed
     first (time_floor); probe_dynwrite held to its plain version at the
     script's shape and on its edges (offsets below zero, at and past the
     last row, rows running past the end, C off a multiple of 4:
     probes.dynwrite_edge_calls); then the probes' main (ops/probes.py),
     the Pallas scripts' top level;
  8. the sharded engine (parallel/sharded_conflict.py), every shard on the
     one card, each chunk one replay of its CUDA graph (`ShardedStepGraph`:
     K10, the W shard steps, K11; the engine reports `graphed`, which must
     be true): 8a the engine at the default knobs with W=4 shards over 80
     batches of phase A's zipfian mix (the keys 16-byte hashes, whose first
     4 bytes, where the engine cuts, differ), one 2^29 version jump (every
     shard rebases) and the load check at batch 64, which must re-cut;
     every batch equal to the same engine with the plain phases on the
     card and to the clipped-oracle model (four oracles fed shard-clipped
     ranges, min-combined; the re-cut applied to them as the engine made
     it, `recut_oracles`), every shard's
     state equal at the end, K10 and K11 once a chunk and the step's
     kernels W times a chunk; 8b the resolver role with
     CONFLICT_BACKEND=sharded (CONFLICT_DEVICE=cuda, CONFLICT_NUM_SHARDS=0:
     width 1 on one card) serving phase A's 40 batches, every reply equal
     to the oracle; 8c run_sharded_kernel(16,384, 50, W) at W=1 and W=4
     (K=2^18 a shard, strided, 24-byte spread keys), no overflow, then the
     same run with the chunk eager, every batch and the final state equal
     between the two, the first
     timed batch equal to the plain phases state for state, and at W=1
     every batch equal to the unsharded step; then the step's kernels held
     to their plain versions on 8a's calls (ties at the cuts), and K10
     (shard_clip) and K11 (shard_combine) on 8a's and 8c's calls and on
     edges (W = 1, 2, 4, 8; T=1; all padding; endpoints at the cuts and the
     sentinel; the strided layout at T=16,384; and for K10 L = 1 and 17,
     N off a multiple of 4 and N = 1, no reads or no writes, W = 1 and 64,
     ranges below, above and across a cut, inverted and padding:
     clip_shape_edge_calls), timed at both shapes.
  9. the commit pipeline: the port's SimCluster (master, 2 proxies, the
     port's resolvers with CONFLICT_BACKEND=device on the card at the
     default knobs, 2 tlogs, 2 storage servers), driven through the
     client API (`c.database()`, `Transaction.get`/`set`/`commit`). 9a:
     cell A's mix with one resolver: YCSB's load (200 blind inserts of
     100 of the 20,000 keys, 100-byte values), then 512 client actors of
     40 attempts, each 4 zipfian reads, 4 zipfian writes and one commit
     with no retry; every committed attempt's writes, applied in commit
     order, must be read back through a new transaction and straight from
     the storage server that owns each key, and no attempt may end in
     commit_unknown_result. 9b: the Cycle workload across two resolvers
     (1,000 nodes, 256 rotators of 10 `db.transact` rotations); the ring
     must hold, read through a transaction and from the storage servers.
     In both, every batch each resolver decided must equal the port's
     OracleConflictSet replayed in version order, nothing may poison,
     every chunk must converge on the device, K1-K4, K6-K9 and K13 must
     launch once a resolver step and the rebase kernel once a rebase
     (counts zeroed after the load, read after the run).
 10. recovery: the port's RecoverableCluster (3 coordinators, 5 workers;
     an elected cluster controller recruits the master, 2 proxies, 2 of
     the port's resolvers on the card at the default knobs, 2 tlogs and 2
     storage servers) serving 9b's Cycle (1,000 nodes, 256 rotators of 10
     `db.transact` rotations) while the worker that hosts the first
     resolver is killed after 640 committed rotations and the elected
     cluster controller after 1,600, which forces a re-election. Every
     Resolver recruited is recorded with its process and recovery
     version. At least two recoveries (final epoch at least 3); the ring
     holds, read through a transaction and on every storage replica;
     every rotation decided; every batch each resolver of each generation
     decided equal to a fresh OracleConflictSet from its recovery
     version, in version order; no poison; every chunk converged and ran
     through its bucket's graph (no eager step); the step kernels launched
     once a resolver step, net of the launches of the recruited
     resolvers' graph captures. Printed: wall and virtual seconds,
     attempts/s, each attempt's outcome, each recovery's virtual and wall
     seconds from the kill to accepting commits, chunks by bucket for
     each resolver instance, and `torch.cuda.memory_allocated` after each
     generation (unreachable roles collected) with the peak.
 11. the randomized simulation harness (foundationdb_tpu_torch.testing):
     11a `run_randomized_spec` for each of the ten fast specs on a seed
     whose draw under allow_backends=("device", "sharded") fits it
     (SIM_RUNS: every engine, two regions, double replication, sharded
     draws at one shard a card, buggified evaluator knobs among them the
     legacy evaluator, one sandwich round, no encode ring and a 16-bucket
     sketch) at the harness's engine shape (T=16, 2/2, K=2,048); 11b the
     Cycle spec (with consistency check, clogging and attrition) on a
     double-replication device draw with its engine raised to K=65,536,
     T=1,024, 4/4. Each spec's own checks pass (a failure prints its
     repro line); every Resolver recruited is recorded as in phase 10 and
     every batch it decided equals a fresh OracleConflictSet from its
     recovery version; no poison; every engine on the card and every
     chunk through its graph; the draw's evaluator's step kernels (with
     K10 and K11 on a sharded draw) once a resolver step net of the
     captures, the rebase kernel once a rebase; no unconverged chunk
     unless the draw cuts the sandwich to one round; each device draw's
     SpecResult equal to the port's CPU run (SIM_EXPECTED). Printed for
     each run: the draw and its repro line, the SpecResult, the wall
     seconds, the resolver instances with their chunks by bucket, the
     unconverged chunks and `torch.cuda.memory_allocated` after the
     cluster is dropped and collected.
 12. backup, restore and DR (foundationdb_tpu_torch.backup, net.http,
     tools.fdbcli), every cluster's resolvers on the card at cell A's
     width (K=65,536, T=1,024, 4/4): 12a a SimCluster (2 proxies, 2
     resolvers, 2 tlogs, 2 storage servers) loaded with cell A's 20,000
     keys and 100-byte values, backed up by a BackupAgent (8 snapshot
     chunks and its log tailer) into a BlobStoreBackupContainer on a
     BlobStoreServer at 127.0.0.1 while 256 clients make 20 attempts each
     of A's mix (the first half beside the snapshot, then a point-in-time
     marker, then the second half), restored into a fresh SimCluster on
     the same loop to the end version and to the point in time (each
     equal byte for byte to the source's rows read through a transaction
     at that version), and into a RecoverableCluster where fdbcli's
     `status` and `getrange` run; 12b a DRAgent between two SimClusters
     on one loop (12a's load and mix), its switchover, the destination
     equal to the source at the switchover version and taking a commit
     after it, the primary markers flipped; 12c the backup-attrition
     spec on seed 131's device draw raised to cell A's width
     (BACKUP_SIM), its SpecResult equal to SIM_EXPECTED. Every Resolver
     built is recorded as in phase 10 and every batch it decided equals
     a fresh OracleConflictSet; no poison; every chunk through its graph;
     the step kernels once a resolver step net of the captures; device
     memory after each run, its clusters dropped and collected, no more
     than after the first. Printed: each run's wall seconds, committed
     attempts per second of wall while the backup or DR runs, snapshot
     chunks and log rows drained, restore and switchover wall seconds,
     the resolver instances with their chunks by bucket, and
     `torch.cuda.memory_allocated` after each run.
 13. real-process boot (foundationdb_tpu_torch.net: transport,
     server_main; tools: fdbbackup, trace_analyze) at cell A's width,
     every resolver on the card: 13a one RealEventLoop in this process,
     the roles built by `server_main.boot` from one spec (master, 2
     proxies, 2 resolvers split at A's median key, 2 tlogs, 2 storage
     servers, each on its own address on 127.0.0.1) and a client
     NetTransport, every hop over TCP: A's load (20,000 keys x 100
     bytes), then 256 clients x 20 attempts of A's mix (`ycsb_mix`);
     every acknowledged write read back through a transaction and from
     the storage role that owns it, every Resolver recorded as in phases
     10-12 and every batch it decided equal to a fresh OracleConflictSet,
     no poison, every chunk through its graph, the step kernels once a
     resolver step net of the captures, the resolvers' readbacks on the
     loop's worker threads (one a drain group) with at least two in
     flight at once; 13b two `python -m
     foundationdb_tpu_torch.net.server_main` processes with
     FDBTPU_TRACE_DIR set (txn: master, proxy, 2 resolvers on the card,
     tlog; storage: 2 storage servers, replicas of one shard): 9b's
     Cycle (1,000 keys over both resolvers, 256 rotators x 10), the ring
     whole on each replica; fdbbackup's main (`start -d`, `status`); each
     resolver's RESOLVER_METRICS over the wire (its backend the card, K6,
     K9 and K3 launched at least once a batch, every readback returned,
     none unconverged); SIGTERM, each process exiting 0 within 10 s; a
     restart of both on their data dirs (the tlog recovers its files),
     the ring whole again and one more commit; SIGTERM again; then
     `trace_analyze.check_well_formed` over each boot's trace files.
     Printed: attempts/s of wall and commits, chunks by bucket, readback
     wait seconds from the metrics, readbacks in flight at most, boot
     and restart wall seconds, trace_analyze's per-stage p50/p99 and
     `torch.cuda.memory_allocated` after 13a, its cluster dropped and
     collected.
 14. the port's C extension (foundationdb_tpu_torch/native/fdb_native.c,
     built at first use; the run fails, naming its build error, if it is
     not available): 14a cell A's traffic (phase 4's A: K=65,536,
     T=1,024, 4/4, 40 batches, the rebase at batch 20) served by the
     port's Resolver on the card with every chunk's packed buffer written
     by the C pass (`encode_conflict_ranges`), each recorded on the host
     before its copy to the card and held byte for byte to the numpy
     encoder and a second C pass on the same inputs (host ms a chunk of
     each, p50 and p99), every reply equal to the oracle; the same cell
     with the numpy encoder, txns/s and batch p50/p99 beside it and phase
     4's A; then the strided layout at the bench's T=16,384 (3 one-chunk
     batches of its traffic, K=2^18, 16-byte keys), each chunk held so
     and every batch equal to the oracle; 14b 13a's one-process boot at
     A's width with NET_NATIVE_TRANSPORT=1 and NET_NATIVE_CLIENT=1 and
     one proxy (the GRV plane serves a lone proxy only): every resolver
     batch equal to the oracle, every acknowledged write read back, the
     C plane's read and GRV fast-path hits above 0, each storage server
     and the proxy owning their plane, no connection degraded to Python,
     and the device bytes after the run no more than before; attempts/s
     beside 13a's. Every earlier phase runs on the C paths too: a line
     after each phase lists which planes served natively (the encoder's
     chunks by C and by numpy, the storage servers' store classes, the
     wire codec, the transports' C plane counters), and one line gathers
     them before the kernels line.
 15. the C-API bindings (foundationdb_tpu_torch.bindings: fdb_c,
     multiversion, bindingtester) and the graft entry points
     (graft_entry): 15a two server_main processes as 13b boots them at
     cell A's width — txn (master, 2 resolvers on the card split at A's
     median key, each on its own address, a tlog and a proxy; every
     Resolver recorded as in phases 10-14) and storage (one storage
     server) — and from this process tests/test_bindingtester.py's fdb_c
     lifecycle and error-mapping checks, its conformance runs
     (`bindingtester.compare_runs(977, 2000)` and `(31337, 1000)` with
     their prefixes: the C-ABI machine's and the native client's stacks
     and final rows equal, more than 500 entries compared) and its
     multiversion checks; each resolver's RESOLVER_METRICS over the wire
     (its backend the card, every main-path kernel launched and K6-K9,
     K3, K2 and K13 at least once a chunk, every readback returned, none
     unconverged, the device bytes at the end no more than after the
     first run); SIGTERM, each process exiting 0 within 10 s; every
     batch the resolvers decided equal to a fresh OracleConflictSet.
     15b `graft_entry.entry()` on the card: its step equal, field for
     field, to the plain step on a CPU copy of its state and batch, and
     its ms; `dryrun_multichip(torch.cuda.device_count())` on CUDA.
     Printed: 15a's ops and seconds, attempts and commits, resolver steps
     held to the oracle, chunks and device bytes; 15b's step ms.
 16. the end-to-end driver (foundationdb_tpu_torch/bench_e2e.py): real
     server processes over TCP (core: master, resolver, tlog and
     ratekeeper; proxies; storage) and client worker processes, the
     resolver's engine on the card. 16a `bench.run_e2e()`, one subprocess
     each for the oracle and device backends at `run`'s defaults (1,500
     clients, 5 s a phase after a 1.5 s ramp, write, read and mixed,
     merged core, 1 storage, 2 client processes; the oracle's with the
     2-proxy and 100-client rows): every report well formed (ops/s above
     0, commit p50 and p99 where the phase commits, GRV p50 where a GRV
     was timed: the driver times each client's 1st, 17th, ... GRV in a
     reading phase, so there it is due once the window held 16
     transactions a client), the device core's engine the card and its
     step kernels (K6-K9, K2, K1, K3, K4, K13) once a chunk in every
     phase that commits (none in read), read over the wire. 16b
     `bench_e2e.run` in this process on the device backend with 2 proxies
     and 2 storage servers, the mixed and mixed-contended phases, traced;
     16c on the sharded backend, two shards sharing the card, the write
     phase for 2 s. In both the core runs as `recorded_server_main`
     (the driver's `_spawn_server` wrapped): every batch its resolver
     decided equal to a fresh OracleConflictSet (16c: the clipped-oracle
     model, through every re-cut the engine made), no poison, every chunk
     through its graph, the step kernels once a chunk (16c: once a shard
     a chunk, K10 and K11 once a chunk) net of the build's launches, the
     core's device bytes equal after the first phase and at the end, every
     process the driver started exiting 0 (the servers on SIGTERM within
     10 s), and no
     process but the core holding the card's device node while the run
     lasts (nvidia-smi's compute-app pids are printed beside it; in a
     container they need not be this container's). Printed: each run's
     ops/s, committed txns/s, errors by name, error and not-committed
     rates, GRV and commit p50/p99, CPU by process, boot seconds; 16b's
     stages (Proxy.BatchAssembly, Proxy.Resolve, Resolver.Dispatch,
     Client.Commit, and Client.AdmissionWait where a commit waited),
     queueing and readback-overlap ratios; phase 16's seconds and the
     smoke's.

`python3 chip_smoke.py --serve-cells` only serves phase 4's cells A and B
(each reply checked against the oracle) and prints their numbers.
`python3 chip_smoke.py --cluster` only runs phase 9, with its checks, and
prints its numbers.
`python3 chip_smoke.py --recovery` only runs phase 10, with its checks,
and prints its numbers.
`python3 chip_smoke.py --sim` only runs phase 11, with its checks, prints
its numbers and writes them to chiprun_out/chip_smoke.json.
`python3 chip_smoke.py --backup` does the same for phase 12,
`python3 chip_smoke.py --net` for phase 13, and `python3 chip_smoke.py
--native` for phase 14 (with phase 4's A and 13a run first in the same
call, its yardsticks).
`python3 chip_smoke.py --bindings` only runs phase 15, with its checks,
after the card and build lines, and writes its numbers to
chiprun_out/chip_smoke.json.
`python3 chip_smoke.py --e2e` does the same for phase 16.
`python3 chip_smoke.py --time-kernels` only times K1-K11, K13 and bench steps
(cell A's traffic, phase B's, the bench at 16k and 32k, K9 at T=2^20):
K5's whole fixpoint and one evaluation at the bench's warmed state and
on phase 6's eight steps, and run_kernel_ab(16,384, 8); K10 and K11
(device, wall, host, and K11 replayed alone in a graph) on the sharded
step at W=1 and W=4, and the sharded bench's ms/batch with the chunk
graphed and eager in turns at W=1 and W=4; and a 20-batch bench scan
through its graph and eagerly (phase-free, same method for any version of
the port: a copy of this script beside an older checkout's package times
that checkout). Where the package has K6's sample sort, K6 is also timed
by both of its paths at each shape, and on cell A's and the bench's
traffic at 16, 32, 64 and 128 tiles (time_sort_paths); K13 also at
T = 2^18 and 2^20; the rank-join probes (join, lexjoin) at the
scripts' shapes, device ms and the scripts' ms/pass (time_probes); and
what `--time-floor` times.
`python3 chip_smoke.py --time-floor` only times one launch's floor
(probe_add on one element: device ms by torch.profiler, ms, host ms, ms
a graph replay), K10 at phase 8a's and 8c's shapes and probe_dynwrite at
the script's shape, the same four numbers with each bound, and beside
each kernel one fill_ of its output bytes (time_floor_and_redesigns);
then K10 where it runs, inside the sharded bench's chunk graph at 8c's
shape (time_clip_in_chunk). Read a kernel against max(bound, floor): a
kernel whose bound is below the floor can come no nearer than the floor.
A graph replay of one launch costs the host's graph launch, several
times the floor, so it does not tell two kernels of a few microseconds
apart.

It prints a digest of the code it runs, the kernels line
({"kernels": [...]}, each kernel with its launches on the main path, in
phase 9, `launches_cluster`, in phase 10, `launches_recovery`, in
phase 11, `launches_sim`, in phase 12, `launches_backup`, and in phase
13, `launches_net`: 13a's in this process plus 13b's txn process's, read
over the wire, and in phase 14, `launches_native`: 14a's C-fed cell A
plus 14b's, and in phase 15, `launches_bindings`: 15a's txn process's,
read over the wire, plus 15b's entry step, and in phase 16,
`launches_e2e`: 16a's device core's in its phases, read over the wire,
plus 16b's and 16c's cores' net of their builds), the
nvidia-smi line, and last {"ok": true, "device":
{...}}. Any failure exits non-zero with no result line. Details go to
chiprun_out/chip_smoke.json. The script imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_SCALAR_OPS_PER_S = 67e12  # float32 outside the tensor cores (data sheet)
PHASE_A_BATCHES = 40
PHASE_B_BATCHES = 60
PHASE_B_LOAD_BATCHES = 48


def source_digest() -> str:
    """sha256 over the path and bytes of chip_smoke.py and of every .py,
    .c, .cu and .cuh file of the port package, in path order: it names the
    code a run executed, so a recorded number can be tied to a commit."""
    import hashlib
    root = os.path.dirname(os.path.abspath(__file__))
    paths = ["chip_smoke.py"]
    pkg = os.path.join(root, "foundationdb_tpu_torch")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if not x.startswith(("_", "."))]
        paths += [os.path.relpath(os.path.join(d, f), root) for f in files
                  if f.endswith((".py", ".c", ".cu", ".cuh"))]
    h = hashlib.sha256()
    for rel in sorted(paths):
        h.update(rel.encode() + b"\0")
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


_T0 = time.perf_counter()


def log(msg: str):
    """Print `msg` after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# traffic: YCSB-style zipfian point reads and writes
# ---------------------------------------------------------------------------

def zipf_keys(n_keys: int, hex_only: bool = False):
    """(cdf, keys): a zipfian (theta 0.99, the YCSB default) distribution
    over n_keys keys of 16 to 24 bytes, hashed so hot keys scatter. Two in
    three are YCSB's "user" + hash, which share their first 4 bytes; with
    `hex_only` every key is the 16-byte hash alone, so the first 4 bytes,
    on which the sharded engine cuts, differ."""
    w = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** 0.99
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    h = np.arange(n_keys, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    keys = []
    for i, x in enumerate(h.tolist()):
        k = b"%016x" % x
        keys.append(k if i % 3 == 0 or hex_only
                    else b"user" + k + b"#" * (i % 5))
    return cdf, keys


def make_batches(rng, cdf, keys, n_batches, txns=1024, step=10_000, prev=0,
                 jump_at=None):
    """[(prev_version, version, [TxnConflictInfo])] chained from `prev`:
    each txn reads and writes 4 zipfian point keys; snapshots trail by 0-3
    batches. With `jump_at`, that batch's version jumps 2^29 further (a
    version gap the resolver must rebase across)."""
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    out = []
    for i in range(n_batches):
        version = prev + step + (1 << 29 if i == jump_at else 0)
        idx = np.searchsorted(cdf, rng.random((txns, 8)))
        lag = rng.integers(0, 4, txns) * step
        batch = []
        for t in range(txns):
            ks = [keys[i] for i in idx[t].tolist()]
            batch.append(TxnConflictInfo(
                max(0, prev - int(lag[t])),
                [(k, k + b"\x00") for k in ks[:4]],
                [(k, k + b"\x00") for k in ks[4:]]))
        out.append((prev, version, batch))
        prev = version
    return out


def make_load_batches(rng, keys, n_batches, txns=1024, step=10_000):
    """YCSB's load phase, cut to `n_batches`: blind inserts (4 point writes
    a txn, no reads, so every txn commits) of distinct keys drawn at random
    from the key space and sent in ascending key order, as a bulk loader
    does. Chained from version 0."""
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    n = n_batches * txns * 4
    chosen = sorted(keys[i] for i in rng.choice(len(keys), n, replace=False))
    out, prev = [], 0
    for b in range(n_batches):
        version = prev + step
        base = b * txns * 4
        batch = [TxnConflictInfo(prev, [], [
            (k, k + b"\x00") for k in chosen[base + 4 * t:base + 4 * t + 4]])
            for t in range(txns)]
        out.append((prev, version, batch))
        prev = version
    return out


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` back-to-back calls
    (CUDA events), after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# device functions of each kernel wrapper, as the profiler names them
DEVICE_FUNCTIONS = {
    "endpoint_sort": ("endpoint_sample_kernel", "endpoint_merge_kernel"),
    "state_merge": ("state_merge_kernel",),
    "endpoint_ranks": ("endpoint_ranks_kernel",),
    "sparse_table": ("table_low_kernel", "table_high_kernel"),
    "rebase_table": ("table_low_kernel", "table_high_kernel"),
    "masks_and_history": ("masks_history_kernel",),
    "history_check": ("masks_history_kernel",),
    "intra_levels": ("intra_levels_kernel",),
    "intra_sandwich": ("sandwich_kernel",),
    "merge_compact": ("merge_prep_kernel", "merge_scan_kernel",
                      "merge_fill_kernel"),
    "legacy_blocked": ("legacy_kernel",),
    "legacy_sweep": ("legacy_kernel",),
    "shard_clip": ("shard_clip_kernel",),
    "shard_combine": ("shard_combine_kernel",),
    "step_verdicts": ("step_verdicts_kernel",),
    "probe_add": ("probe_add_kernel",),
    "probe_stream_rows": ("probe_stream_kernel<true>",),
    "probe_join": ("probe_rank_kernel",),
    "probe_dynwrite": ("probe_dynwrite_kernel",),
    "probe_stream_limbs": ("probe_stream_kernel<false>",),
    "probe_lexjoin": ("probe_rank_kernel",),
}
SORT_KERNELS = ("endpoint_sort", "state_merge", "endpoint_ranks")
DEVICE_FUNCTIONS["sort_and_rank"] = sum(
    (DEVICE_FUNCTIONS[k] for k in SORT_KERNELS), ())
STEP_KERNELS = SORT_KERNELS + ("masks_and_history", "sparse_table",
                               "intra_levels", "intra_sandwich",
                               "merge_compact", "step_verdicts")
# every kernel of the resolver's path: the step's, and the rebase that runs
# when versions pass 2^29
PATH_KERNELS = STEP_KERNELS + ("rebase_table",)
# the sharded engine's own kernels, once a chunk around the shards' steps
SHARD_KERNELS = ("shard_clip", "shard_combine")
SORT_RANK_MAX_LAUNCHES = 3  # device launches a call of the whole phase


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_device(fn, reps: int):
    """Device time of one call of fn() by device function, from
    torch.profiler over `reps` calls after one warm-up call and a warm-up
    step of `reps` calls that it runs but does not record: {name: (ms a
    call, launches a call, launches traced)}, and the wall seconds of the
    recorded calls. The trace now and then misses launches (up to 60% of
    them in one run on the H100, fewer after the warm-up step), so a
    function's time a call is its mean launch time times its launches a
    call, counted against the function traced least often (one launch a
    call: every call of the port's wrappers and of a step has one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    us: dict = {}
    count: dict = {}
    for evt in prof.key_averages():
        t = _device_us(evt)
        if t > 0 and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type) \
                and not evt.key.startswith("ProfilerStep"):
            us[evt.key] = us.get(evt.key, 0.0) + t
            count[evt.key] = count.get(evt.key, 0) + int(evt.count)
    least = min(count.values(), default=0)
    funcs = {}
    for k in us:
        per_call = max(1, round(count[k] / least))
        funcs[k] = (us[k] / count[k] / 1e3 * per_call, per_call, count[k])
    return funcs, wall


def busy_ms(funcs: dict) -> float:
    """Device ms a call over every device function of a profile."""
    return sum(ms for ms, _n, _c in funcs.values())


def device_ms_of(funcs: dict, name: str) -> float | None:
    """Device ms a call of kernel wrapper `name`'s device functions."""
    ms = [v[0] for k, v in funcs.items()
          if any(f in k for f in DEVICE_FUNCTIONS[name])]
    return sum(ms) if ms else None


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_of(name: str, args, kw) -> tuple[float, float]:
    """(bytes, operations) the call must move and do on these inputs: each
    input read once, each output written once; gathers count only the
    elements this call's data touches."""
    if name in ("sort_and_rank", "endpoint_sort", "state_merge",
                "endpoint_ranks"):
        return sort_rank_work(name, args)
    if name == "sparse_table":
        (vals,) = args
        K = vals.shape[0]
        levels = max(1, (max(K, 2) - 1).bit_length() + 1)
        return 4.0 * K * (1 + levels), float(K * levels)
    if name == "rebase_table":
        # vals and oldest read; the shifted vals, oldest and table written
        vals = args[0]
        K = vals.shape[0]
        levels = max(1, (max(K, 2) - 1).bit_length() + 1)
        return 4.0 * K * (2 + levels) + 8, float(K * (levels + 2))
    if name == "intra_levels":
        # the six owner and rank vectors read; per level 10 B an element
        # (src, werl, is_w, bnd) and 8 B a read (qlo, qhi) written; an
        # operation an element and level
        T, wtxn_c, rtxn = args[:3]
        NW, NR = wtxn_c.shape[0], rtxn.shape[0]
        M = NW + 2 * NR
        nl = max(1, (int(T) - 1).bit_length())
        return float(12 * (NW + NR) + nl * (10 * M + 8 * NR)), float(nl * M)
    if name == "history_check":
        table, cum_state, spos, rb, re, rtxn, snapshot, txn_valid, oldest = args
        return history_work(rb, re, rtxn, snapshot,
                            skip=kw.get("skip_history", False))
    if name == "masks_and_history":
        # the verdicts' work on the owners the masks give, and the masks':
        # the four rank vectors and the write owners (strided: the length
        # limb of each write's begin key; pooled: wtxn) read; wtxn_c, the
        # two masks and the strided owners written; a few operations a
        # range. With the ranks given, the hit's rb < re compares them, so
        # no key limb is read but the strided owner's
        from foundationdb_tpu_torch.ops import conflict_ref as ref
        rb, re, wb, rtxn, wtxn, rbr, rer, wbr, wer, snapshot = args[3:13]
        strided = kw.get("strided", args[15] if len(args) > 15 else False)
        skip = kw.get("skip_history", args[16] if len(args) > 16 else False)
        owners = ref.step_masks(rb, wb, rtxn, wtxn, rbr, rer, wbr, wer,
                                snapshot.shape[0], strided)
        NR, NW = rb.shape[1], wb.shape[1]
        h_bytes, h_ops = history_work(rb, re, owners[0], snapshot,
                                      live=owners[3], skip=skip)
        m_bytes = 8 * (NR + NW) + 4 * NW + NR + 5 * NW \
            + (4 * (NR + NW) if strided else 0)
        return h_bytes + m_bytes, h_ops + float(4 * (NR + NW))
    if name == "intra_sandwich":
        g, geo, wtxn_c, w_ok, r_ok, rtxn, rbr, _rounds = args
        nl, M = geo["src"].shape
        NR, NW, T = rtxn.shape[0], wtxn_c.shape[0], g.shape[0]
        # the level geometry (10 B an element), the queries (8 B a read and
        # level), the write and read vectors and g read once; lower, upper
        # and converged written once. Operations: each evaluation that
        # this call's data needs scans every element and answers every
        # read at every level.
        nbytes = nl * M * 10 + nl * NR * 8 + NW * 5 + NR * 9 + 3 * T + 1
        evals = sandwich_evaluations(args)
        return float(nbytes), float(evals * nl * (M * 8 + NR * 4))
    if name == "merge_compact":
        skeys, scls, sval, sidx, spos, merge_commit, wb, we, wtxn = args[:9]
        L, N = skeys.shape
        NW = wb.shape[1]
        K = kw["K"]
        T = merge_commit.shape[0]
        nbytes = (N * (L + 4) * 4 + 2 * L * NW * 4 + NW * 4 + T
                  + (L + 1) * K * 4)
        return float(nbytes), float(N * (2 * L + 24) + K * L)
    if name in ("legacy_blocked", "legacy_sweep"):
        # the fixpoint (g, ...) or one evaluation (c, g, ...): each input
        # read once, the output (and the fixpoint's converged flag)
        # written once; 4 integer operations a (write, read) pair that an
        # evaluation needs: the write active in its input, the read live
        # (r_ok, its txn eligible), the write's txn before the read's
        g = args[0] if name == "legacy_blocked" else args[1]
        T = g.shape[0]
        NW, NR = args[-8].shape[0], args[-7].shape[0]
        nbytes = (2 if name == "legacy_blocked" else 3) * T + 1 \
            + NW * 13 + NR * 13
        return float(nbytes), float(4 * sum(
            legacy_pairs(c, *args[-9:]) for c in legacy_inputs(name, args)))
    if name == "shard_clip":
        # the endpoints read once and written once a shard, the cuts read;
        # up to L limb comparisons a column and shard
        rb, _re, wb, _we, lo, _hi = args
        L, W = rb.shape[0], lo.shape[0]
        M = 2 * rb.shape[1] + 2 * wb.shape[1]
        return float(4 * L * M * (1 + W) + 8 * W * L), float(W * M * L)
    if name == "step_verdicts":
        # commit, too_old, txn_valid and eligible (1 B a txn) and two flags
        # read; the row (4 B a txn twice, two words) and the count written
        # (a scan's int8 row and two entries too); a few operations a txn
        T = args[0].shape[0]
        scan = 5 + T if kw.get("scan_out") is not None else 0
        return float(4 * T + 2 + 4 * (2 * T + 2) + 4 + scan), float(4 * T)
    if name == "shard_combine":
        # per shard the statuses (4 B) and eligible (1 B) of every txn and
        # three scalars read, txn_valid read; the combined vectors and
        # scalars written; a min and an and a txn and shard
        # (the row, eligible, two scalars and two flags)
        statuses, _el, _ov, _bd, _cv, txn_valid = args
        W, T = len(statuses), txn_valid.shape[0]
        return float(W * (5 * T + 6) + T + 9 * T + 18), float(2 * W * T + T)
    if name == "probe_add":
        (x,) = args
        return 8.0 * x.numel(), float(x.numel())
    if name.startswith("probe_stream"):
        (state,) = args
        return 4.0 * state.numel() + 4 * min(state.shape), \
            float(state.numel())
    if name in ("probe_join", "probe_lexjoin"):
        # the state, the queries and the counts; a lower bound of
        # ceil(log2 TILE) + 1 compares of LK limbs a query
        state, queries = args
        nt = queries.shape[0]
        qt = queries.shape[1 if name == "probe_join" else 2]
        # (join: whole rows, a row a 32-byte sector; lexjoin: the LK limb
        # rows of the limb-major state and queries that it reads)
        if name == "probe_join":
            lk, tile = 1, state.shape[0] // nt
            nbytes = 4.0 * (state.numel() + queries.numel() + nt * qt)
        else:
            lk, tile = kw["limbs"], state.shape[1] // nt
            nbytes = 4.0 * (lk * state.shape[1] + lk * nt * qt + nt * qt)
        return nbytes, float(nt * qt * lk * ((tile - 1).bit_length() + 1))
    if name == "probe_dynwrite":
        off, x = args
        return 4.0 * (x.numel() + kw["rows"] * x.shape[1] + 1), \
            float(kw["rows"] * x.shape[1])
    raise KeyError(name)


def history_work(rb, re, rtxn, snapshot, live=None,
                 skip=False) -> tuple[float, float]:
    """(bytes, operations) of K2's verdicts: per read its owner; per real
    read (owner < T) two spos and two cum_state gathered, and two table
    entries where its range is not empty; per txn its snapshot and valid
    flag read and two verdicts written. `live` is the fused launch's r_ok:
    there the ranks (counted with the masks) say which ranges are not
    empty; without it (`history_check`) each real read compares its 2L
    key limbs. With `skip` (no_hist) no read is gathered."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    L, NR = rb.shape
    T = snapshot.shape[0]
    fixed = float(NR * 4 + T * (4 + 1 + 2) + 4)
    if skip:
        return fixed, float(NR + T)
    real = rtxn < T
    nv = int(real.sum())
    if live is None:
        live = real & ref.key_lt(rb, re)
        keys = 2 * L
    else:
        keys = 0
    nl = int(live.sum())
    return fixed + 4.0 * (nv * (4 + keys) + 2 * nl), \
        float(nv * (keys + 8) + 4 * nl + T)


def legacy_inputs(name, args) -> list:
    """The committed sets each evaluation of this K5 call takes as its
    input: the call's c for one evaluation (`legacy_sweep`), and every
    evaluation's input of the plain fixpoint for the whole fixpoint."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    if name == "legacy_sweep":
        return [args[0]]
    seen = []

    def sweep(c):
        seen.append(c)
        return ref.legacy_sweep(c, *args)
    ref.run_legacy(sweep, args[0])
    return seen


def legacy_pairs(c, g, wtxn, rtxn, w_ok, r_ok, *_ranks) -> int:
    """(write, read) pairs one evaluation of f on `c` needs: the write
    active (w_ok, its txn in c), the read live (r_ok, its txn in g), the
    write's txn before the read's."""
    import torch
    T = g.shape[0]
    act = w_ok & (wtxn < T) & c[wtxn.clamp(0, T - 1).long()]
    live = r_ok & (rtxn < T) & g[rtxn.clamp(0, T - 1).long()]
    owners = torch.sort(wtxn[act]).values
    return int(torch.searchsorted(owners, rtxn[live]).sum())


def sort_rank_work(name, args) -> tuple[float, float]:
    """(bytes, operations) of the sort-and-rank phase and of its parts:
    inputs read once, outputs written once. A sort of M keys needs M
    ceil(log2 M) comparisons, a merge or a rank pass one a key; each
    comparison counts one operation a limb."""
    if name == "sort_and_rank":
        bkeys, _bval, rb, _re, wb, _we = args
        L, K = bkeys.shape
        M = 2 * rb.shape[1] + 2 * wb.shape[1]
        N = K + M
        nbytes = 4 * (L * N + K) + 4 * ((L + 5) * N + M)
        return float(nbytes), float(L * (M * max(1, (M - 1).bit_length())
                                         + N))
    if name == "endpoint_sort":
        rb, _re, wb, _we = args
        L = rb.shape[0]
        M = 2 * rb.shape[1] + 2 * wb.shape[1]
        return float(4 * (2 * L + 1) * M), \
            float(L * M * max(1, (M - 1).bit_length()))
    if name == "endpoint_ranks":
        ekeys, _eidx = args
        L, M = ekeys.shape
        return float(4 * (L + 2) * M), float(L * M)
    bkeys, _bval, ekeys, _eidx, _nr = args
    L, K = bkeys.shape
    M = ekeys.shape[1]
    N = K + M
    return float(4 * (L * N + K + M) + 4 * (L + 5) * N), float(L * N)


def sort_rank_part_calls(calls):
    """The calls of K6, K8 and K7 (endpoint_sort, endpoint_ranks,
    state_merge) that the sort-and-rank calls `calls` make, their inputs
    from the plain parts."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    out = {k: [] for k in SORT_KERNELS}
    for a, _kw in calls:
        bkeys, bval, rb, re, wb, we = a
        ekeys, eidx = ref.endpoint_sort(rb, re, wb, we)
        out["endpoint_sort"].append(((rb, re, wb, we), {}))
        out["endpoint_ranks"].append(((ekeys, eidx), {}))
        out["state_merge"].append(((bkeys, bval, ekeys, eidx, rb.shape[1]),
                                   {}))
    return out


def sandwich_evaluations(args) -> int:
    """Evaluations of f the plain sandwich runs on these inputs (the ones
    its pinch test does not skip)."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    n = torch.zeros((), dtype=torch.int32, device=args[0].device)
    ref.intra_sandwich(*args, evals=n)
    return int(n)


def library_call(name: str, args, kw=None):
    """One PyTorch yardstick for the same function, or None: for the
    sparse table, the level doubling with max_pool1d (NEG padding); for
    one evaluation of the legacy evaluator (`legacy_sweep`), torch.mv of
    the materialised (NR, NW) overlap matrix in fp16 with the
    committed-write vector (the matrix is built once, outside the timed
    call; no one call computes the whole fixpoint); for add, torch.add; for the stream
    probes, torch.amax over the rows (the probes' data lies below 2^31, so
    the signed max is the unsigned one); for the endpoint ranks,
    torch.unique over the endpoint keys in endpoint order (put back in that
    order once, outside the timed call), whose inverse is the dense rank
    (the limbs are sign-flipped int32, so signed order is key order); it
    is held to the plain ranks here; for the level geometry, the one
    stable `torch.sort` of its packed keys (`conflict_ref.level_sort_keys`,
    packed outside the timed call), which gives each level's order but not
    the six arrays; for the shard combine, torch.amin over the shards'
    statuses (stacked outside the timed call), the statuses alone; for the
    step's verdicts, the readback row by torch.where and torch.cat (the
    row alone, not the committed count); for the join probe, two calls:
    torch.sort of each tile's limb-0 column, then torch.searchsorted of
    the queries' (the scripts' data lie below 2^31, so int32 order is
    their uint32 order; held to the plain join here)."""
    import torch
    if name == "endpoint_ranks":
        from foundationdb_tpu_torch.ops import conflict_ref as ref
        ekeys, eidx = args
        keys = torch.empty_like(ekeys)
        keys[:, eidx.long()] = ekeys

        def unique_ranks():
            return torch.unique(keys, dim=1, return_inverse=True)[1]
        if not torch.equal(unique_ranks().to(torch.int32),
                           ref.endpoint_ranks(ekeys, eidx)):
            fail("endpoint_ranks: torch.unique's inverse is not the plain "
                 "rank")
        return unique_ranks
    if name == "intra_levels":
        from foundationdb_tpu_torch.ops import conflict_ref as ref
        packed = ref.level_sort_keys(*args)
        return lambda: torch.sort(packed, dim=1, stable=True)
    if name == "legacy_sweep":
        c, g, wtxn, rtxn, w_ok, r_ok, wbr, wer, rbr, rer = args
        T = c.shape[0]
        overlap_t = ((wbr[None, :] < rer[:, None])
                     & (rbr[:, None] < wer[None, :])
                     & w_ok[None, :] & r_ok[:, None]
                     & (wtxn[None, :] < rtxn[:, None])).to(torch.float16)
        cw = (c[wtxn.clamp(max=T - 1).long()] & (wtxn < T)).to(torch.float16)
        return lambda: torch.mv(overlap_t, cw)
    if name == "shard_combine":
        stacked = torch.stack(list(args[0]))
        return lambda: torch.amin(stacked, dim=0)
    if name == "step_verdicts":
        commit, too_old, valid, eligible, overflow, converged = args[:6]

        def row():
            st = torch.where(valid, torch.where(
                commit, 2, torch.where(too_old, 1, 0)), 2)
            return torch.cat([st.to(torch.int32), eligible.to(torch.int32),
                              overflow.to(torch.int32).reshape(1),
                              converged.to(torch.int32).reshape(1)])
        return row
    if name == "probe_join":
        from foundationdb_tpu_torch.ops import probes
        state, queries = args
        nt = queries.shape[0]
        col = state[:, 0].reshape(nt, -1)
        q0 = queries[:, :, 0].contiguous()

        def sort_search():
            return torch.searchsorted(torch.sort(col, dim=1).values, q0,
                                      side="left", out_int32=True)
        if not torch.equal(sort_search(), probes.join_plain(*args, **kw)):
            fail("probe_join: torch.sort + torch.searchsorted is not the "
                 "plain join on these inputs")
        return sort_search
    if name == "probe_add":
        return lambda: torch.add(args[0], 1)
    if name.startswith("probe_stream"):
        dim = 0 if kw["layout"] == "rows" else 1
        return lambda: torch.amax(args[0], dim=dim, keepdim=True)
    if name != "sparse_table":
        return None
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    (vals,) = args
    K = vals.shape[0]

    def run():
        rows = [vals]
        cur = vals.to(torch.float64)[None, None, :]
        for lvl in range(1, ref.table_levels(K)):
            s = 1 << (lvl - 1)
            padded = torch.nn.functional.pad(cur, (0, s), value=float(ref.NEG))
            cur = torch.nn.functional.max_pool1d(padded, 2, stride=1,
                                                 dilation=s)[..., :K]
            rows.append(cur[0, 0].to(torch.int32))
        return torch.stack(rows)
    return run


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def clone_to(obj, device):
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    if isinstance(obj, dict):
        return {k: clone_to(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(clone_to(v, device) for v in obj)
    return obj


def spied_phases(calls: dict, dev, last_step_only=False, record=None,
                 sandwich=None):
    """The plain phases, each keeping a copy of every call's inputs on
    `dev` in `calls[name]`; with `last_step_only`, the calls of earlier
    steps are dropped when a step begins (its sort); with `record` (a
    dict), only while record["on"] is true. `sandwich` replaces the plain
    sandwich (`pinch_read_sandwich`)."""
    from types import SimpleNamespace

    from foundationdb_tpu_torch.ops import conflict_ref as ref

    def spy(name, fn):
        def wrapped(*a, **kw):
            if last_step_only and name == "sort_and_rank":
                calls.clear()
            if record is None or record["on"]:
                # not `out`: a kernel and its plain version held to each
                # other on a call must not write into the same tensors
                calls.setdefault(name, []).append(clone_to(
                    (a, {k: v for k, v in kw.items() if k != "out"}), dev))
            return fn(*a, **kw)
        return wrapped
    phases = SimpleNamespace(
        build_table=spy("sparse_table", ref.build_table),
        history_check=spy("history_check", ref.history_check),
        intra_levels=spy("intra_levels", ref.intra_levels),
        intra_sandwich=spy("intra_sandwich",
                           sandwich or ref.intra_sandwich),
        merge_compact=spy("merge_compact", ref.merge_compact))
    if hasattr(ref, "legacy_fixpoint"):  # K5 as the whole fixpoint
        phases.legacy_fixpoint = spy("legacy_blocked", ref.legacy_fixpoint)
    else:
        phases.legacy_sweep = spy("legacy_blocked", ref.legacy_sweep)
    if hasattr(ref, "sort_and_rank"):  # a package older than K6-K8 lacks it
        phases.sort_and_rank = spy("sort_and_rank", ref.sort_and_rank)
    if hasattr(ref, "clip_ranges"):  # older than the sharded engine
        phases.rebase_table = spy("rebase_table", ref.rebase_table)
        phases.clip_ranges = spy("shard_clip", ref.clip_ranges)
        phases.shard_combine = spy("shard_combine", ref.shard_combine)
    if hasattr(ref, "step_masks"):  # older than K12 and K13
        phases.step_masks = spy("step_masks", ref.step_masks)
        phases.step_verdicts = spy("step_verdicts", ref.step_verdicts)
    if hasattr(ref, "masks_and_history"):  # K2 with the masks
        phases.masks_and_history = spy("masks_and_history",
                                       ref.masks_and_history)
    return phases


def capture_main_path_calls(dev, batches):
    """Run the main path's step with the PLAIN phases on the card over
    `batches` (phase A traffic, default knobs) and keep the phase calls of
    the last step: the kernels' inputs at the main path's shapes."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    calls: dict = {}
    spied = spied_phases(calls, dev)
    cs = DeviceConflictSet(device=dev)
    for _prev, version, txns in batches:
        calls.clear()
        batch = cs.encoder.encode_batch(txns, version)
        cs._state, _s, _i = ref.conflict_step(
            cs._state, batch, max_write_life=5_000_000, phases=spied)
    return calls


def capture_calls_from(dev, cs, next_batch):
    """The phase calls of one more step, with the PLAIN phases, from a copy
    of a served conflict set's state: the kernels' inputs at that cell's
    shapes and state size."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    calls: dict = {}
    _prev, version, txns = next_batch
    batch = cs.encoder.encode_batch(txns, version)
    ref.conflict_step(clone_to(cs._state, dev), batch,
                      max_write_life=5_000_000,
                      phases=spied_phases(calls, dev))
    return calls


def table_edge_calls(dev):
    """K1's edge inputs: table widths on and off the 1,024-column tile (one
    launch up to K=1,024, two above), all-NEG values, and the extreme int32
    values the engine never stores but the kernel must not mishandle."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    g = torch.Generator().manual_seed(5)
    out = []
    for K in (1, 2, 1000, 1025, 2047, 2049, 65_536, 1 << 18, (1 << 19) + 1,
              1 << 20):
        vals = torch.randint(ref.NEG, 1 << 30, (K,), generator=g,
                             dtype=torch.int32)
        out.append(((vals.to(dev),), {}))
    out.append(((torch.full((4096,), ref.NEG, dtype=torch.int32,
                            device=dev),), {}))
    return out


def spied_history_calls(cs, steps, max_write_life, strided=False):
    """K2's inputs (`masks_and_history` calls) of each step of `steps`
    ((txns, version) pairs) through the plain step from `cs`'s state, on
    its device."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    calls: dict = {}
    spied = type(ref.PLAIN)(**dict(
        vars(ref.PLAIN),
        masks_and_history=spied_phases(calls, cs.device).masks_and_history))
    for txns, version in steps:
        batch = cs.encoder.encode_batch(txns, version)
        cs._state, _s, _i = ref.conflict_step(
            cs._state, batch, max_write_life=max_write_life, strided=strided,
            phases=spied)
    return calls["masks_and_history"]


def history_calls(calls):
    """The `history_check` calls that K2's `masks_and_history` calls make
    (their verdict half), on the owners the plain masks give."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    out = []
    for a, kw in calls:
        table, cum_state, spos, rb, re, wb, rtxn, wtxn, rbr, rer, wbr, wer, \
            snapshot, txn_valid, oldest = a
        owner = ref.step_masks(rb, wb, rtxn, wtxn, rbr, rer, wbr, wer,
                               snapshot.shape[0], kw.get("strided", False))[0]
        out.append(((table, cum_state, spos, rb, re, owner, snapshot,
                     txn_valid, oldest),
                    {k: v for k, v in kw.items() if k == "skip_history"}))
    return out


def shuffled_reads(call, seed):
    """A K2 call with its reads in a random order: rb, re, the owners (and
    for a `masks_and_history` call, pooled, rbr and rer) and the reads'
    sorted positions in spos permuted alike."""
    import torch
    a, kw = call
    a = list(a)
    fused = len(a) > 9  # masks_and_history, else history_check
    K, NR = a[0].shape[1], a[3].shape[1]
    g = torch.Generator().manual_seed(seed)
    p = torch.randperm(NR, generator=g).to(a[3].device)
    spos = a[2]
    a[2] = torch.cat([spos[:K], spos[K:K + NR][p],
                      spos[K + NR:K + 2 * NR][p], spos[K + 2 * NR:]])
    for i in (3, 4) + ((6, 8, 9) if fused else (5,)):
        a[i] = (a[i][:, p] if a[i].dim() == 2 else a[i][p]).contiguous()
    return (tuple(a), kw)


def inverted_read_calls(dev):
    """K2's calls (`masks_and_history`) on reads that are inverted or empty
    over keys written after the readers' snapshots (every such read would
    be a hit were it not inverted), beside txns whose proper reads of the
    same keys are hits: the two steps of a pooled T=64 set. Clipping to a
    shard makes such reads (begin' > end' when a range lies wholly
    outside)."""
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    keys = [b"v%04d" % i for i in range(200)]
    write = [TxnConflictInfo(0, [], [(keys[3 * t], keys[3 * t + 2])])
             for t in range(64)]
    read = [TxnConflictInfo(500, [(keys[3 * t + 2], keys[3 * t]),
                                  (keys[3 * t + 1], keys[3 * t + 1])]
                            + ([(keys[3 * t], keys[3 * t + 1])]
                               if t % 4 == 0 else []), [])
            for t in range(64)]
    cs = DeviceConflictSet(device=dev, capacity=1 << 10, txns=64,
                           reads_per_txn=4, writes_per_txn=4)
    return spied_history_calls(cs, [(write, 1000), (read, 2000)],
                               max_write_life=5_000_000)


def history_edge_calls(dev):
    """K2's edge inputs (`masks_and_history` calls), from plain steps on
    the card: a pooled T=1,024
    call with its reads shuffled (rtxn unsorted), pooled steps at T=1 and
    T=33 with txns that have no reads and snapshots below the MVCC floor,
    a step whose reads are all padding, inverted and empty reads over
    newer writes (`inverted_read_calls`), and a kernel-bench step at
    T=32,768 (strided, K=2^19) after one batch."""
    import torch

    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    rng = np.random.default_rng(31)
    keys = [b"h%04d" % i for i in range(300)]

    def rng_range():
        a, b = sorted(keys[i] for i in rng.integers(0, len(keys), 2))
        return (a, a + b"\x00") if rng.random() < 0.6 else (a, b + b"\x00")

    def batch(n, version, reads=True):
        return [TxnConflictInfo(
            int(rng.integers(0, version)),
            [rng_range() for _ in range(rng.integers(0, 5) if reads else 0)],
            [rng_range() for _ in range(rng.integers(1, 5))])
            for _ in range(n)]
    out = []
    for T in (1024, 33, 1):
        cs = DeviceConflictSet(device=dev, capacity=1 << 13, txns=T,
                               reads_per_txn=4, writes_per_txn=4)
        # a 3,000-version window: the floor passes the older snapshots
        steps = [(batch(T, 1000 * (i + 1)), 1000 * (i + 1)) for i in range(6)]
        steps.append((batch(T, 7000, reads=False), 7000))
        calls = spied_history_calls(cs, steps, max_write_life=3000)
        if T == 1024:
            calls = [shuffled_reads(c, i) for i, c in enumerate(calls)]
        out += calls
    rtxn = out[-1][0][6]
    if bool((rtxn < 1).any()):
        fail("history edge inputs: the last step has a real read")
    out += inverted_read_calls(dev)
    _state, _batch, calls = bench_step_calls(dev, 32768, 1 << 19,
                                             warm_batches=1)
    out += calls["masks_and_history"]
    del calls, _state, _batch
    torch.cuda.empty_cache()
    return out


def bench_step_calls(dev, T, capacity, warm_batches=12, intra_mode="scan"):
    """A kernel-bench state after `warm_batches` strided batches of T txns
    (the bench's traffic, run with the kernels), the next batch, and that
    step's phase calls with the plain phases and `intra_mode`'s
    evaluator."""
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    batches = bench.stage(bench._encode_batches(
        warm_batches + 1, seed=1, version0=bench.WINDOW, T=T), dev)
    state = ref.init_state(capacity, bench.LIMBS, dev)
    state, _st, _comm, _ovf = ref.conflict_scan(
        state, {k: v[:warm_batches] for k, v in batches.items()},
        max_write_life=bench.WINDOW, strided=True, phases=kernels.PHASES)
    batch = {k: v[warm_batches] for k, v in batches.items()}
    calls: dict = {}
    ref.conflict_step(state, batch, max_write_life=bench.WINDOW, strided=True,
                      intra_mode=intra_mode, phases=spied_phases(calls, dev))
    return state, batch, calls


def legacy_chain_args(dev, T=64):
    """The legacy fixpoint's inputs for a dependency chain through all T
    txns (txn t reads the key txn t - 1 writes, `chain_sandwich_args`' ranks):
    the committed set alternates, and the fixpoint needs about an
    evaluation a txn."""
    import torch
    ar = torch.arange(T, dtype=torch.int32, device=dev)
    ok = torch.ones(T, dtype=torch.bool, device=dev)
    return (ok, ar, ar, ok, ok, ar + 1, ar + 2, ar, ar + 1)


def legacy_edge_calls(dev, bench_call):
    """K5's edge inputs (fixpoint arguments): the chain at T = 64, 1,000
    and 4,097 (many bodies; tiles about the chain's diagonal); the chain
    and `bench_call` with their reads shuffled and their writes shuffled
    (owners in no order); T = 1; no reads; no writes; no eligible txn;
    random pooled owners with repeats and padding over few ranks (many
    overlaps)."""
    import torch
    g = torch.Generator().manual_seed(71)
    out = [(legacy_chain_args(dev, T), {}) for T in (64, 1000, 4097)]

    def shuffled(a, reads):
        a = list(a)
        idx = (2, 4, 7, 8) if reads else (1, 3, 5, 6)
        n = a[idx[0]].shape[0]
        perm = torch.randperm(n, generator=g).to(dev)
        for i in idx:
            a[i] = a[i][perm].contiguous()
        return tuple(a)
    for base in (legacy_chain_args(dev, 1000), bench_call[0]):
        out += [(shuffled(base, True), {}), (shuffled(base, False), {}),
                (shuffled(shuffled(base, True), False), {})]
    chain = legacy_chain_args(dev, 300)
    out.append((legacy_chain_args(dev, 1), {}))
    out.append((tuple(x[:0] if i in (2, 4, 7, 8) else x
                      for i, x in enumerate(chain)), {}))
    out.append((tuple(x[:0] if i in (1, 3, 5, 6) else x
                      for i, x in enumerate(chain)), {}))
    out.append(((torch.zeros_like(chain[0]),) + chain[1:], {}))
    for T, NW, NR in ((700, 2100, 1900), (64, 4096, 4096)):
        def owners(n):
            return torch.randint(0, T + 1, (n,), generator=g,
                                 dtype=torch.int32).to(dev)

        def ranks(n):
            b = torch.randint(0, 40, (n,), generator=g, dtype=torch.int32)
            return b.to(dev), (b + torch.randint(0, 5, (n,), generator=g,
                                                 dtype=torch.int32)).to(dev)
        wt, rt = owners(NW), owners(NR)
        (wb, we), (rb, re) = ranks(NW), ranks(NR)
        elig = (torch.rand(T, generator=g) < 0.9).to(dev)
        out.append(((elig, wt, rt, (wt < T) & (wb < we), (rt < T) & (rb < re),
                     wb, we, rb, re), {}))
    return out


def counted_legacy(fixpoint):
    """A legacy fixpoint function that also returns its evaluation
    count."""
    import torch

    def run(*a, **kw):
        n = torch.zeros((), dtype=torch.int32, device=a[0].device)
        return tuple(fixpoint(*a, **kw, evals=n)) + (n,)
    return run


def chain_sandwich_args(dev, T=128):
    """The sandwich's inputs for a dependency chain through all T txns (txn
    t reads the key txn t - 1 writes): it needs T / 2 rounds to pinch."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    ar = torch.arange(T, dtype=torch.int32, device=dev)
    ok = torch.ones(T, dtype=torch.bool, device=dev)
    geo = ref.intra_levels(T, ar, ar, ar, ar + 1, ar + 1, ar + 2)
    return (ok, geo, ar, ok, ok, ar, ar)


def big_step_calls(dev, T=1 << 20, seed=61):
    """K9's and K3's calls at T txns with one read and one write each:
    begins over 4T endpoint ranks, ends 0-7 ranks past them (an eighth of
    the ranges empty). At T = 2^20 K3's three bit sets (3 T / 8 bytes)
    overflow an SM's shared memory, so it keeps them in global memory.
    Returns (levels call, sandwich call) as (args, kwargs) pairs."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    g = torch.Generator().manual_seed(seed)
    ar = torch.arange(T, dtype=torch.int32)
    rbr, wbr = (torch.randint(0, 4 * T, (T,), generator=g, dtype=torch.int32)
                for _ in range(2))
    rer, wer = (b + torch.randint(0, 8, (T,), generator=g, dtype=torch.int32)
                for b in (rbr, wbr))
    eligible = torch.rand(T, generator=g) < 0.9
    wtxn_c, rtxn, rbr, rer, wbr, wer = (x.to(dev) for x in (ar, ar, rbr, rer,
                                                            wbr, wer))
    geo = ref.intra_levels(T, wtxn_c, rtxn, rbr, rer, wbr, wer)
    sandwich = (eligible.to(dev), geo, wtxn_c, wbr < wer, rbr < rer, rtxn,
                rbr, ref.auto_rounds(T))
    return ((T, wtxn_c, rtxn, rbr, rer, wbr, wer), {}), (sandwich, {})


def level_edge_calls(dev):
    """K9's edge inputs: T=1; T=1,000 (off a power of two); all padding
    (every write of txn T - 1, every read padding); shuffled owners at
    T=4,096; heavy ties (3 ranks) at T=2,048, pooled and shuffled."""
    import torch
    g = torch.Generator().manual_seed(51)

    def call(T, n, owners, ranks):
        if owners == "padding":
            wt, rt = torch.full((n,), T - 1), torch.full((n,), T)
        else:
            wt = torch.randint(0, T, (n,), generator=g)
            rt = torch.randint(0, T + 1, (n,), generator=g)
            if owners == "pooled":
                wt, rt = wt.sort().values, rt.sort().values
        rbr, rer, wbr, wer = (torch.randint(0, ranks, (n,), generator=g)
                              for _ in range(4))
        return ((T, *(x.to(torch.int32).to(dev)
                      for x in (wt, rt, rbr, rer, wbr, wer))), {})
    return [call(1, 3, "pooled", 12), call(1000, 4000, "pooled", 32_000),
            call(64, 256, "padding", 2048),
            call(4096, 16_384, "shuffled", 131_072),
            call(2048, 8192, "pooled", 3), call(2048, 8192, "shuffled", 3)]


def level_span_edge_calls(dev):
    """K9's span-path edges (`kernels.level_plan`), each call with
    nondecreasing owners and again with the same owners shuffled (which
    takes the general path), at spread ranks and at 3 (ties): T one below,
    at and one above the span (4 writes and 4 reads a txn: spans of 128
    txns), the resolver's shape (T=1,024, 4/4, pooled) with a padding tail
    of reads, T=1; txns piled on both sides of each span edge; a pooled
    txn past a span's shared memory (the general path however the owners
    lie); the bench's strided shape at T=2,048; and the resolver's shape
    with the span size forced (`span_log2` 0, the general path, 1, 5 and
    n_levels); and T=4,096 at `span_log2` 1, 2,049 spans, each CTA of the
    launch taking many in turn."""
    import torch
    g = torch.Generator().manual_seed(53)

    def call(T, wt, rt, ranks, **kw):
        rbr, rer = (torch.randint(0, ranks, (rt.numel(),), generator=g)
                    for _ in range(2))
        wbr, wer = (torch.randint(0, ranks, (wt.numel(),), generator=g)
                    for _ in range(2))
        return ((T, *(x.to(torch.int32).to(dev)
                      for x in (wt, rt, rbr, rer, wbr, wer))), kw)

    def owners(T, n, pool=None):
        if pool is None:
            return torch.randint(0, T, (n,), generator=g).sort().values
        pick = torch.randint(0, pool.numel(), (n,), generator=g)
        return pool[pick].sort().values

    edges = torch.arange(128, 1024, 128)
    piled = torch.cat([edges - 1, edges])
    cases = []  # (T, write owners, read owners)
    for T in (127, 128, 129, 1):
        cases.append((T, owners(T, 4 * T), owners(T, 4 * T)))
    wt, rt = owners(1024, 4096), owners(1024, 4096)
    rt[-300:] = 1024
    cases.append((1024, wt, rt))
    cases.append((1024, owners(1024, 4096, piled),
                  owners(1024, 4096, piled)))
    big = torch.full((3000,), 20)
    cases.append((64, torch.cat([owners(64, 256), big]).sort().values,
                  torch.cat([owners(64, 256), big]).sort().values))
    ar = torch.arange(2048)
    cases.append((2048, ar, ar))
    out = []
    for T, wt, rt in cases:
        for ranks in (8 * (wt.numel() + rt.numel()), 3):
            out.append(call(T, wt, rt, ranks))
            out.append(call(T, wt[torch.randperm(wt.numel(), generator=g)],
                            rt[torch.randperm(rt.numel(), generator=g)],
                            ranks))
    T, wt, rt = cases[4]
    for s in (0, 1, 5, 10):
        out.append(call(T, wt, rt, 3 * 4096, span_log2=s))
    ar = torch.arange(4096)
    out.append(call(4096, ar, ar, 3 * 4096, span_log2=1))
    return out


def endpoint_sort_edge_calls(dev):
    """K6's edges beyond the phase's calls: L = 2, 5, 7 and 17, M = 2 NR +
    2 NW two below and two above its tile of 1,024 and of 8,192 (the third
    merge round), and 25,602 (five rounds, the last tile short), on keys
    that share their first limb and take 4 values a limb after it (ties of
    every kind, across tiles too); 6,000 endpoints that are all one key
    (L = 7); and 524,294 (L = 5: ten merge rounds of 1,025 merge tiles
    each)."""
    import torch

    from foundationdb_tpu_torch.ops import kernels
    g = torch.Generator().manual_seed(47)

    def split(keys):
        M = keys.shape[1]
        NR = M // 4
        NW = M // 2 - NR
        ends = torch.split(keys, [NR, NR, NW, NW], dim=1)
        return tuple(e.contiguous().to(dev) for e in ends), {}
    out = []
    for L in (2, 5, 7, 17):
        for M in (1022, 1026, 8190, 8194, 25602):
            keys = torch.randint(-2, 2, (L, M), generator=g,
                                 dtype=torch.int32)
            keys[0] = 7
            out.append(split(keys))
    out.append(split(torch.full((7, 6000), 5, dtype=torch.int32)))
    keys = torch.randint(-2, 2, (5, 524_294), generator=g, dtype=torch.int32)
    keys[0] = 7
    out.append(split(keys))
    return out


def sort_worst_keys(M: int, L: int, short: int = 0, seed: int = 0):
    """Keys (L, M) int32 (numpy) whose first bucket under K6's sample path
    (kernels.sort_samples samples a tile) holds the bucket cap less `short`
    endpoints: tile 0 holds keys 0, 2, ..., 2,046, so its samples are the
    smallest and its largest key is the first splitter; every other tile
    holds g - 1 odd keys below it (the first `short` tiles one fewer) and
    the rest far above. The keys differ in their last limb only; each tile
    is shuffled. The last tile must hold g - 1 endpoints at least."""
    from foundationdb_tpu_torch.ops import kernels
    tile = kernels.SORT_TILE
    g = tile // kernels.sort_samples(M, L)
    rng = np.random.default_rng(seed)
    v = np.empty(M, np.int64)
    for i in range(-(-M // tile)):
        n = min(tile, M - i * tile)
        if i == 0:
            vals = 2 * np.arange(n)
        else:
            small = g - 1 - (1 if i <= short else 0)
            assert n >= small, "the last tile is too short"
            vals = np.concatenate([2 * rng.integers(0, tile - 1, small) + 1,
                                   10 ** 6 + rng.integers(0, 10 ** 6,
                                                          n - small)])
        v[i * tile:i * tile + n] = rng.permutation(vals)
    keys = np.full((L, M), 7, np.int32)
    keys[L - 1] = v.astype(np.int32)
    return keys


def endpoint_sort_bucket_calls(dev):
    """K6's sample sort at its buckets' edges, forced (`samples`, the
    plan's sort_samples; never turned to the rounds) where the plan takes
    the rounds path: for L = 5, 17 and 32, inputs whose first bucket holds
    exactly the cap and one less (`sort_worst_keys`: the most a bucket can
    hold), at 4 and 9 tiles (L = 32, the last short) or 4 and 16 (else);
    and the CPU model's other worst inputs at the main path's M of 16,384
    (L = 7), 65,536 and 131,072 (L = 5): keys sorted, reverse sorted and
    all equal (they differ by class and index only), by the plan's path,
    by the sample sort and by the sample path's kernel turned to the merge
    rounds."""
    import torch

    from foundationdb_tpu_torch.ops import kernels
    out = []

    def split(keys, **kw):
        keys = torch.from_numpy(np.ascontiguousarray(keys))
        M = keys.shape[1]
        NR = M // 4
        NW = M // 2 - NR
        ends = torch.split(keys, [NR, NR, NW, NW], dim=1)
        return tuple(e.contiguous().to(dev) for e in ends), kw
    for L in (5, 17, 32):
        for M in ((4096, 9214) if L == 32 else (4096, 16384)):
            s = kernels.sort_samples(M, L)
            assert s > 0
            for short in (0, 1):
                out.append(split(sort_worst_keys(M, L, short, seed=M + L),
                                 samples=s, tie_limit=2 ** 31 - 1))
    rng = np.random.default_rng(53)
    for M, L in ((16384, 7), (65536, 5), (131072, 5)):
        v = np.sort(rng.integers(-2 ** 31, 2 ** 31, M)).astype(np.int32)
        for kind in ("sorted", "reversed", "equal"):
            keys = np.full((L, M), 3, np.int32)
            keys[1] = {"sorted": v, "reversed": v[::-1],
                       "equal": np.full(M, 5, np.int32)}[kind]
            out.append(split(keys))
            for tie_limit in (2 ** 31 - 1, -1):
                out.append(split(keys, samples=kernels.sort_samples(M, L),
                                 tie_limit=tie_limit))
    return out


def plain_sort(rb, re, wb, we, samples=None, tie_limit=None):
    """K6's plain version, for calls that force the kernel's samples."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    return ref.endpoint_sort(rb, re, wb, we)


def forced_sort(rb, re, wb, we, samples=None, tie_limit=None):
    """K6 with `samples` samples a tile (0: the tile sort and the merge
    rounds; None: the plan's path) and the sample path's `tie_limit` (-1:
    always the merge rounds; 2**31 - 1: never; None: the plan's), through
    the wrapper's override."""
    from foundationdb_tpu_torch.ops import kernels
    old = kernels.SORT_OVERRIDE
    kernels.SORT_OVERRIDE = {k: v for k, v in (
        ("samples", samples), ("tie_limit", tie_limit)) if v is not None}
    try:
        return kernels.endpoint_sort(rb, re, wb, we)
    finally:
        kernels.SORT_OVERRIDE = old


def verdict_edge_calls(dev):
    """K13's edges: T = 1, 15, 16, 17, 1,024, 16,384, 16,385, 32,768 and
    2^20 txns of random flags (both scalar flags set and cleared), each
    from pointers one byte past a 16-byte boundary as well (the scalar
    path); the scan's rows are written by `with_scan_rows`."""
    import torch
    g = torch.Generator().manual_seed(59)
    out = []
    for T in (1, 15, 16, 17, 1024, 16384, 16385, 32768, 1 << 20):
        for offset in (0, 1):
            flags = [(torch.rand(T + offset, generator=g) < p)
                     .to(dev)[offset:] for p in (0.6, 0.2, 0.9, 0.5)]
            scalars = [torch.tensor(bool((T + offset) % 2), device=dev),
                       torch.tensor(bool(offset == 0), device=dev)]
            out.append(((*flags, *scalars), {}))
    return out


def endpoint_ranks_edge_calls(dev):
    """K8's edges beyond the phase's calls, as (keys, ids) calls on sorted
    keys: M = 1 and 2; M one below, at and one above a tile of 512 and of
    four; all keys equal; L = 2, 5, 7 and 17 with many ties; and
    M = 1,049,089 at L = 5 (2,050 tiles: more than the card holds CTAs at
    once, so each loops over tiles and flags them again after the
    barrier)."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    g = torch.Generator().manual_seed(61)

    def call(L, M, values=4):
        keys = torch.randint(0, values, (L, M), generator=g,
                             dtype=torch.int32).to(dev)
        keys[0] = 7
        keys = keys[:, ref.lex_sort_perm(keys, torch.zeros(
            M, dtype=torch.int32, device=dev))].contiguous()
        ids = torch.randperm(M, generator=g).to(torch.int32).to(dev)
        return ((keys, ids), {})
    out = [call(5, M) for M in (1, 2, 511, 512, 513, 2047, 2048, 2049)]
    out.append(call(7, 6000, values=1))
    out += [call(L, 9001) for L in (2, 5, 7, 17)]
    out.append(call(5, 2049 * 512 + 1, values=1 << 20))
    return out


def merge_case(dev, g, L, K, NR, NW, live=None, values=3, from_state=0.3,
               pad=0.1):
    """One K7 call (bkeys, bval, ekeys, eidx, NR) on `dev`: `live` sorted
    state keys (all K by default) then a padding tail, each limb one of
    `values` small integers (ties of every kind) or, with `values` None,
    any int32; the endpoints drawn from the same space, a share
    `from_state` of them equal to state keys (padding tail included), a
    share `pad` padding, then sorted by the plain K6."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    live = K if live is None else live

    def limbs(n):
        if values is None:
            return torch.randint(-(1 << 31), (1 << 31) - 1, (L, n),
                                 generator=g, dtype=torch.int32)
        return torch.randint(-(values // 2), values - values // 2, (L, n),
                             generator=g, dtype=torch.int32)
    keys = limbs(live).to(dev)
    keys = keys[:, ref.lex_sort_perm(keys, torch.zeros(
        live, dtype=torch.int32, device=dev))]
    bkeys = torch.full((L, K), ref.PAD_LIMB, dtype=torch.int32, device=dev)
    bkeys[:, :live] = keys
    bval = torch.randint(ref.NEG, 10_000, (K,), generator=g,
                         dtype=torch.int32).to(dev)

    def ends(n):
        e = limbs(n).to(dev)
        take = (torch.rand(n, generator=g) < from_state).to(dev)
        pick = torch.randint(0, max(K, 1), (n,), generator=g).to(dev)
        if K:
            e = torch.where(take[None, :], bkeys[:, pick], e)
        padded = (torch.rand(n, generator=g) < pad).to(dev)
        return torch.where(padded[None, :], ref.PAD_LIMB, e).contiguous()
    ekeys, eidx = ref.endpoint_sort(ends(NR), ends(NR), ends(NW), ends(NW))
    return ((bkeys, bval, ekeys, eidx, NR), {})


def state_merge_edge_calls(dev):
    """K7's edges beyond the phase's calls: N = K + M one below, at and
    one above two tiles of 2,048 outputs; a long padding tail (tiles of
    state alone); a tiny state (tiles of endpoints alone); every endpoint
    a state key, live or padding, in every class; all-equal keys; L = 2, 5
    and 7; M = 0 and M = 1,024; and the shapes of cell B (K=2^20, L=7,
    M=16,384, ~400k live boundaries) and of the 32k bench step (K=2^19,
    L=5, M=131,072)."""
    import torch
    g = torch.Generator().manual_seed(53)
    out = [merge_case(dev, g, 5, 4096 - 400 + d, 100, 100)
           for d in (-1, 0, 1)]
    out += [merge_case(dev, g, 7, 20_000, 50, 50, live=3000, pad=0.0),
            merge_case(dev, g, 5, 3, 3000, 3000),
            merge_case(dev, g, 7, 8192, 1500, 1500, live=6000,
                       from_state=1.0, pad=0.0),
            merge_case(dev, g, 7, 4096, 2000, 2000, values=1, pad=0.0)]
    out += [merge_case(dev, g, L, 10_000, 1500, 1500, values=5)
            for L in (2, 5, 7)]
    out += [merge_case(dev, g, 5, 5000, 0, 0),
            merge_case(dev, g, 5, 9000, 256, 256, values=5)]
    out += [merge_b_call(dev, g),
            merge_case(dev, g, 5, 1 << 19, 32768, 32768, live=450_000,
                       values=None)]
    return out


def merge_b_call(dev, g=None):
    """A K7 call at cell B's shape: K=2^20 with ~400k live boundaries, L=7,
    T=1,024 txns of 4 reads and 4 writes (M=16,384)."""
    import torch
    g = g or torch.Generator().manual_seed(59)
    return merge_case(dev, g, 7, 1 << 20, 4096, 4096, live=400_000,
                      values=None)


def rebase_call(calls):
    """The rebase's call on a cell: the step's merged values (the table
    build's input), oldest 0, delta 2^29."""
    import torch
    vals = calls["sparse_table"][-1][0][0]
    return ((vals, torch.zeros((), dtype=torch.int32, device=vals.device),
             1 << 29), {})


def rebase_edge_calls(dev, K=1 << 20):
    """The rebase's edge inputs: K=2^20 values from NEG up (every seventh
    at NEG), deltas 2^29 and 2^30, oldest at NEG, 0 and 2^30 - 1: most
    values, and some oldests, saturate at NEG."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    g = torch.Generator().manual_seed(71)
    bval = torch.randint(ref.NEG, 1 << 30, (K,), generator=g,
                         dtype=torch.int32)
    bval[::7] = ref.NEG
    bval = bval.to(dev)
    return [((bval, torch.tensor(o, dtype=torch.int32, device=dev), d), {})
            for d in (1 << 29, 1 << 30) for o in (ref.NEG, 0, (1 << 30) - 1)]


def sandwich_edge_calls(dev, main, big):
    """K3's edge inputs: a captured call at rounds 0, 1 and 32, the call
    `big` (T = 2^20, `big_step_calls`), and the 128-deep chain at rounds 1
    and 32 (unconverged) and 70 (converged)."""
    (a, kw) = main
    out = [((*a[:7], r), kw) for r in (0, 1, 32)] + [big]
    chain = chain_sandwich_args(dev)
    out += [((*chain, r), {}) for r in (1, 32, 70)]
    return out


def pinch_read_sandwich(*a, **kw):
    """The plain sandwich counting its evaluations, so that it reads its
    pinch flag on the host and stops there: the same outputs as the plain
    phase, without the rounds that the card would skip one by one (the
    sharded engine runs T // 2 + 1 of them, 513 at T=1,024)."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    n = torch.zeros((), dtype=torch.int32, device=a[0].device)
    return ref.intra_sandwich(*a, **kw, evals=n)


def counted(sandwich):
    """A sandwich phase function that also returns its evaluation count."""
    import torch

    def run(*a, **kw):
        n = torch.zeros((), dtype=torch.int32, device=a[0].device)
        return tuple(sandwich(*a, **kw, evals=n)) + (n,)
    return run


def merge_edge_calls(dev):
    """K4's edge inputs, from plain steps on the card: 1,024 txns writing
    one key (its begin and end groups hold 4,096 sorted elements each,
    across 2,048-element scan tiles), and a K=1,536 state that 64 txns of
    4 fresh point writes a step overflow and poison (N = 1,536 + 2 * 256
    + 2 * 256 = 2,560 is not a multiple of the tile)."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    rng = np.random.default_rng(21)

    def pt(k):
        return (k, k + b"\x00")
    hot = [TxnConflictInfo(0, [], [pt(b"hot")] * 4) for _ in range(1024)]
    mixed = [TxnConflictInfo(0, [pt(b"hot")], [pt(b"k%d" % i)])
             for i in range(1024)]
    fresh = [[TxnConflictInfo(0, [], [pt(b"%08d" % k) for k in
                                      rng.integers(0, 10 ** 8, 4)])
              for _ in range(64)] for _ in range(6)]
    calls: list = []
    for capacity, txns, batches in ((1 << 13, 1024, [hot, mixed, hot]),
                                    (1536, 64, fresh)):
        store: dict = {}
        spied = type(ref.PLAIN)(**dict(
            vars(ref.PLAIN),
            merge_compact=spied_phases(store, dev).merge_compact))
        cs = DeviceConflictSet(device=dev, capacity=capacity, txns=txns,
                               reads_per_txn=4, writes_per_txn=4)
        for i, b in enumerate(batches):
            batch = cs.encoder.encode_batch(b, 1000 * (i + 1))
            cs._state, _s, info = ref.conflict_step(
                cs._state, batch, max_write_life=5_000_000, phases=spied)
        if capacity == 1536 and not bool(info["overflow"]):
            fail("merge edge inputs: the small state never overflowed")
        calls += store["merge_compact"]
    return calls


def sort_rank_edge_calls(dev):
    """The sort-and-rank phase's edge inputs, from plain steps on the card:
    8-byte keys (L=3); T=1 and T=1,000 txns; a K=1,536 state that 64 txns
    of 4 fresh point writes a step overflow and poison, and the steps
    after; batches that are all padding; keys longer than 24 bytes that
    collapse onto one prefix; and calls whose every endpoint equals a key
    of the L=3 state, in every class, live or in the padding tail."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    rng = np.random.default_rng(41)
    pool = [b"s%05d" % i for i in range(3000)]
    pool += [b"L" * 30 + b"%d" % i for i in range(40)]  # one 24-byte prefix

    def rng_range():
        a, b = sorted(pool[i] for i in rng.integers(0, len(pool), 2))
        return (a, a + b"\x00") if rng.random() < 0.5 else (a, b + b"\x00")

    def batch(n, version):
        return [TxnConflictInfo(
            int(rng.integers(0, version)),
            [rng_range() for _ in range(rng.integers(0, 5))],
            [rng_range() for _ in range(rng.integers(1, 5))])
            for _ in range(n)]

    def pt(k):
        return (k, k + b"\x00")
    empty = [TxnConflictInfo(0, [], []) for _ in range(8)]
    fresh = [[TxnConflictInfo(0, [], [pt(b"%08d" % k) for k in
                                      rng.integers(0, 10 ** 8, 4)])
              for _ in range(64)] for _ in range(6)]
    runs = (  # (capacity, txns, key_bytes, batches)
        (1 << 12, 64, 8, [batch(64, 1000 * (i + 1)) for i in range(3)]),
        (1 << 10, 1, None, [batch(1, 1000), empty[:1], batch(1, 3000)]),
        (1 << 14, 1000, None, [batch(1000, 1000), batch(1000, 2000)]),
        (1536, 64, None, fresh + [empty]))
    out: list = []
    poisoned = False
    for capacity, txns, key_bytes, batches in runs:
        store: dict = {}
        spied = type(ref.PLAIN)(**dict(
            vars(ref.PLAIN),
            sort_and_rank=spied_phases(store, dev).sort_and_rank))
        cs = DeviceConflictSet(device=dev, capacity=capacity, txns=txns,
                               reads_per_txn=4, writes_per_txn=4,
                               key_bytes=key_bytes)
        for i, b in enumerate(batches):
            enc = cs.encoder.encode_batch(b, 1000 * (i + 1))
            cs._state, _s, info = ref.conflict_step(
                cs._state, enc, max_write_life=5_000_000, phases=spied)
            poisoned |= bool(info["overflow"])
        out += store["sort_and_rank"]
    if not poisoned:
        fail("sort-and-rank edge inputs: no state poisoned")
    # every endpoint a state key: live boundaries, and some the padding tail
    (bkeys, bval, rb, re, wb, we), _kw = out[2]
    live = int((bkeys[-1] != ref.PAD_LIMB).sum())
    g = torch.Generator().manual_seed(43)
    for hi in (live, bkeys.shape[1]):
        ends = [bkeys[:, torch.randint(0, hi, (x.shape[1],),
                                       generator=g).to(dev)].contiguous()
                for x in (rb, re, wb, we)]
        out.append(((bkeys, bval, *ends), {}))
    return out


def glue_edge_calls(dev):
    """K2's (`masks_and_history`) and K13's edge inputs, from plain steps
    on the card: T=1 txn;
    batches that are all padding; the strided layout (T=64, two reads and
    two writes a txn) beside the pooled; and a K=1,536 state that 64 txns
    of 4 fresh point writes a step overflow and poison (K13's overflow
    flag set, and kept set by the poisoned steps after)."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    rng = np.random.default_rng(81)
    pool = [b"g%05d" % i for i in range(2000)]

    def rng_range():
        a, b = sorted(pool[i] for i in rng.integers(0, len(pool), 2))
        return (a, a + b"\x00") if rng.random() < 0.5 else (a, b + b"\x00")

    def batch(n, version):
        return [TxnConflictInfo(
            int(rng.integers(0, version)),
            [rng_range() for _ in range(rng.integers(0, 3))],
            [rng_range() for _ in range(rng.integers(0, 3))])
            for _ in range(n)]

    def pt(k):
        return (k, k + b"\x00")
    empty = [TxnConflictInfo(0, [], []) for _ in range(8)]
    fresh = [[TxnConflictInfo(0, [], [pt(b"%08d" % k) for k in
                                      rng.integers(0, 10 ** 8, 4)])
              for _ in range(64)] for _ in range(6)]
    runs = (  # (capacity, txns, strided, batches)
        (1 << 10, 1, False, [batch(1, 1000), empty[:1], batch(1, 3000)]),
        (1 << 12, 64, True, [batch(64, 1000 * (i + 1)) for i in range(3)]
         + [empty]),
        (1536, 64, False, fresh + [empty]))
    out: dict = {"masks_and_history": [], "step_verdicts": []}
    poisoned = False
    for capacity, txns, strided, batches in runs:
        store: dict = {}
        spy = spied_phases(store, dev)
        spied = type(ref.PLAIN)(**dict(
            vars(ref.PLAIN), masks_and_history=spy.masks_and_history,
            step_verdicts=spy.step_verdicts))
        per = 2 if strided else 4
        cs = DeviceConflictSet(device=dev, capacity=capacity, txns=txns,
                               reads_per_txn=per, writes_per_txn=per,
                               strided=strided)
        for i, b in enumerate(batches):
            enc = cs.encoder.encode_batch(b, 1000 * (i + 1))
            cs._state, _s, info = ref.conflict_step(
                cs._state, enc, max_write_life=5_000_000, strided=strided,
                phases=spied)
            poisoned |= bool(info["overflow"])
        for k in out:
            out[k] += store[k]
    if not poisoned:
        fail("glue edge inputs: no state poisoned")
    return out


def hold_to_plain(name, kern, plain, calls, main_call, cell, reps=50,
                  check=None):
    """Hold kernel wrapper `kern` to its plain version on every call of
    `calls` ((args, kwargs) pairs), with exact equality (integer kernels),
    then time `main_call`: kernel, plain version, library yardstick,
    device time and bound. `check`, a (kernel, plain) pair, replaces the
    two functions in the equality checks. Returns the numbers."""
    import torch
    n, max_err = 0, 0
    check_kern, check_plain = check or (kern, plain)
    for a, kw in calls:
        want = check_plain(*a, **kw)
        got = check_kern(*a, **kw)
        torch.cuda.synchronize()
        if isinstance(want, dict):  # the level geometry: its six fields
            if list(got) != list(want):
                fail(f"{name}: fields {list(got)}, plain {list(want)}")
            want, got = tuple(want.values()), tuple(got.values())
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for i, (w, g_) in enumerate(zip(want, got)):
            if w.shape != g_.shape or w.dtype != g_.dtype:
                fail(f"{name} output {i}: {g_.dtype} {tuple(g_.shape)}, "
                     f"plain {w.dtype} {tuple(w.shape)}")
            err = int((w.long() - g_.long()).abs().max()) \
                if w.numel() else 0
            max_err = max(max_err, err)
            if err:  # integer kernels: the tolerance is zero
                fail(f"{name} output {i} differs from its plain version "
                     f"(max |diff| {err})")
        n += 1
    a, kw = main_call
    ms = time_cuda(lambda: kern(*a, **kw), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the wrapper's host cost: enqueue, no sync
    for _ in range(reps):
        kern(*a, **kw)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    plain_ms = time_cuda(lambda: plain(*a, **kw), max(reps // 5, 5))
    lib = library_call(name, a, kw)
    lib_ms = lib_device_ms = None
    if lib is not None:  # its wall time a call, and its device time
        lib_ms = time_cuda(lib, reps)
        lib_device_ms = busy_ms(profile_device(lib, reps)[0])
    del lib
    # device time and launches a call
    device_ms = launches_per_call = functions_ms = traced = None
    others = []
    for _try in range(3):  # the profiler now and then reports no kernels
        funcs, _wall = profile_device(lambda: kern(*a, **kw), reps)
        device_ms = device_ms_of(funcs, name)
        if device_ms is not None:
            mine = {k: v for k, v in funcs.items()
                    if any(f in k for f in DEVICE_FUNCTIONS[name])}
            others = sorted(k[:80] for k in funcs if k not in mine)
            launches_per_call = sum(n for _ms, n, _c in mine.values())
            traced = min(c for _ms, _n, c in mine.values())
            functions_ms = {f: sum(v[0] for k, v in mine.items() if f in k)
                            for f in DEVICE_FUNCTIONS[name]}
            break
    nbytes, nops = work_of(name, a, kw)
    b_ms, b_by = bound_ms(nbytes, nops)
    extra = {}
    if name == "sparse_table":
        # a floor for the same bytes: torch's fill_ of a table of that size
        table = kern(*a, **kw)
        extra["fill_ms"] = time_cuda(lambda: table.fill_(0), reps)
        del table
    if name == "sort_and_rank":
        # no one call gives all seven outputs; the ranks alone: torch.unique
        # over [rb | re | wb | we] (endpoint_ranks' yardstick)
        ends = torch.cat(a[2:6], dim=1)
        extra["library_qranks_ms"] = time_cuda(
            lambda: torch.unique(ends, dim=1, return_inverse=True), reps)
        del ends
    log(f"cell {cell} kernel {name}: {n} calls equal to plain; "
        f"kernel_ms={ms:.4f} "
        f"(device-only {device_ms}) plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by}) library_ms={lib_ms} "
        f"(device-only {lib_device_ms}) "
        f"host_ms={host_ms:.4f} device launches a call={launches_per_call}")
    if name == "sparse_table" and (launches_per_call or 0) > 2:
        fail(f"sparse_table: {launches_per_call} device launches a call "
             f"(at most 2)")
    if name == "sort_and_rank":
        # K6-K8 alone: no torch sort, cumsum or cummax, few launches
        if others:
            fail(f"sort_and_rank launched other device functions: {others}")
        if (launches_per_call or 0) > SORT_RANK_MAX_LAUNCHES:
            fail(f"sort_and_rank: {launches_per_call} device launches a "
                 f"call (at most {SORT_RANK_MAX_LAUNCHES})")
    return {"checked_calls": n, "max_abs_err": max_err,
            "ms": ms, "device_ms": device_ms, "host_ms": host_ms,
            "launches_per_call": launches_per_call,
            "profiled_calls": f"{traced} of {reps}",
            "functions_ms": functions_ms, **extra,
            "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "library_device_ms": lib_device_ms,
            "bytes": nbytes, "operations": nops}


def step_wrappers():
    """({name: (kernel wrapper, plain version)} of the step's kernels and
    the rebase, {name: (kernel, plain)} pairs that replace them in the
    equality checks: K3 with its evaluation count)."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    wrappers = {"sort_and_rank": (kernels.sort_and_rank, ref.sort_and_rank),
                "endpoint_sort": (kernels.endpoint_sort, ref.endpoint_sort),
                "endpoint_ranks": (kernels.endpoint_ranks,
                                   ref.endpoint_ranks),
                "state_merge": (kernels.state_merge, ref.state_merge),
                "sparse_table": (kernels.build_table, ref.build_table),
                "rebase_table": (kernels.rebase_table, ref.rebase_table),
                "masks_and_history": (kernels.masks_and_history,
                                      ref.masks_and_history),
                "intra_levels": (kernels.intra_levels, ref.intra_levels),
                "intra_sandwich": (kernels.intra_sandwich,
                                   ref.intra_sandwich),
                "merge_compact": (kernels.merge_compact, ref.merge_compact),
                "step_verdicts": (kernels.step_verdicts, ref.step_verdicts)}
    checks = {"endpoint_sort": (forced_sort, plain_sort),
              "intra_levels": (kernels.intra_levels, plain_levels),
              "intra_sandwich": (counted(kernels.intra_sandwich),
                                 counted(ref.intra_sandwich)),
              "step_verdicts": (with_scan_rows(kernels.step_verdicts),
                                with_scan_rows(ref.step_verdicts))}
    return wrappers, checks


def plain_levels(*a, span_log2=None):
    """The plain level geometry, for calls that force K9's span size."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    return ref.intra_levels(*a)


def with_scan_rows(verdicts, M=3):
    """A step-verdicts function that writes a scan's rows too, into new
    buffers (entry 1 of M, or the call's own index and M), and returns them
    after its three outputs, so that they are compared as well."""
    import torch

    def run(*a, **kw):
        T, dev = a[0].shape[0], a[0].device
        scan = kw.get("scan_out")
        m = scan[0].shape[0] if scan is not None else M
        rows = (torch.full((m, T), -1, dtype=torch.int8, device=dev),
                torch.full((m,), -1, dtype=torch.int32, device=dev),
                torch.zeros(m, dtype=torch.bool, device=dev))
        out = verdicts(*a, scan_out=rows, index=kw.get("index", 1))
        return tuple(out) + rows
    return run


def check_kernels(dev, calls, results, cell, edges=True):
    """Hold each kernel of the path (K1-K4, K6-K9, K13 and the rebase) to
    its plain version on every captured call of `cell` (and, with `edges`,
    on the edge inputs), then time the cell's main-path call: the last one
    captured from the step (the rebase's: `rebase_call`). K13 is held with
    a scan's rows written too (`with_scan_rows`). K2 is held whole (its
    five masks and two verdicts against `step_masks` then
    `history_check`), and its launch on given owners (`history_check`) to
    the verdict half of the same calls (`history_calls`), timed on the
    main call's.
    The sort-and-rank phase is held whole (all seven outputs) and each of
    its kernels to its plain part, on the calls the phase makes (K7 also on
    `state_merge_edge_calls`, K8 on `endpoint_ranks_edge_calls`). K3 is
    checked with its evaluation count; on the edge chain at 1 and 32 rounds
    it must report converged = False."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    wrappers, checks = step_wrappers()
    calls = dict(calls, **sort_rank_part_calls(calls["sort_and_rank"][-1:]),
                 rebase_table=[rebase_call(calls)])
    all_calls = dict(calls)
    if edges:
        big_levels, big_sandwich = big_step_calls(dev)
        all_calls["intra_levels"] = calls["intra_levels"] + \
            level_edge_calls(dev) + level_span_edge_calls(dev) + \
            [big_levels]
        all_calls["rebase_table"] = calls["rebase_table"] + \
            rebase_edge_calls(dev)
        all_calls["sort_and_rank"] = calls["sort_and_rank"] + \
            sort_rank_edge_calls(dev)
        all_calls["sparse_table"] = calls["sparse_table"] + \
            table_edge_calls(dev)
        all_calls["masks_and_history"] = calls["masks_and_history"] + \
            history_edge_calls(dev)
        all_calls["intra_sandwich"] = calls["intra_sandwich"] + \
            sandwich_edge_calls(dev, calls["intra_sandwich"][-1],
                                big_sandwich)
        all_calls["merge_compact"] = calls["merge_compact"] + \
            merge_edge_calls(dev)
        for name, edge in glue_edge_calls(dev).items():
            all_calls[name] = calls[name] + edge
        for a, kw in all_calls["intra_sandwich"][-3:-1]:
            if bool(kernels.intra_sandwich(*a, **kw)[2]):
                fail(f"intra_sandwich: a {a[0].shape[0]}-deep chain "
                     f"converged in {a[7]} rounds")
    all_calls.update(sort_rank_part_calls(all_calls["sort_and_rank"]))
    if edges:
        all_calls["endpoint_sort"] += endpoint_sort_edge_calls(dev) + \
            endpoint_sort_bucket_calls(dev)
        all_calls["step_verdicts"] += verdict_edge_calls(dev)
        all_calls["state_merge"] += state_merge_edge_calls(dev)
        all_calls["endpoint_ranks"] += endpoint_ranks_edge_calls(dev)
    for name, (kern, plain) in wrappers.items():
        main = calls[name][-1]
        results[name] = hold_to_plain(
            name, kern, plain, all_calls[name], main, cell,
            reps=20 if name in ("merge_compact", "sort_and_rank") else 50,
            check=checks.get(name))
        if name == "intra_sandwich":
            results[name]["M"] = int(main[0][1]["src"].shape[1])
            results[name]["evaluations"] = sandwich_evaluations(main[0])
        if name == "masks_and_history":  # the verdicts alone, same launch
            results[name]["history_check"] = hold_to_plain(
                "history_check", kernels.history_check, ref.history_check,
                history_calls(all_calls[name]), history_calls([main])[0],
                cell)
    if edges:
        # K9 and K3 timed at T = 2^20 too (K3's bit sets in global memory)
        for name, big in (("intra_levels", big_levels),
                          ("intra_sandwich", big_sandwich)):
            kern, plain = wrappers[name]
            results[name]["t_2_20"] = hold_to_plain(
                name, kern, plain, [], big, f"{cell} T=2^20", reps=5,
                check=checks.get(name))
        results["intra_sandwich"]["t_2_20"]["evaluations"] = \
            sandwich_evaluations(big_sandwich[0])


def legacy_ab_calls(dev, T=16384, n=2, per_step=False):
    """The K5 calls of the first `n` steps of phase 6's trajectory
    (`run_kernel_ab`'s batches, T=16,384, strided, K=2^18), with the plain
    phases: a list, or with `per_step` a list a step."""
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    batches = bench.stage(bench._encode_batches(n, seed=3,
                                                version0=bench.WINDOW, T=T),
                          dev)
    state = ref.init_state(bench.CAPACITY, bench.LIMBS, dev)
    steps = []
    for i in range(n):
        calls: dict = {}
        state, _st, _info = ref.conflict_step(
            state, {k: v[i] for k, v in batches.items()},
            max_write_life=bench.WINDOW, intra_mode="legacy", strided=True,
            phases=spied_phases(calls, dev))
        steps.append(calls["legacy_blocked"])
    return steps if per_step else [c for step in steps for c in step]


def check_legacy(dev, results, T=16384):
    """K5 against its plain version: the whole fixpoint (commit, converged
    and its count of evaluations) on the calls of two legacy steps at the
    kernel bench's shape (phase 6's first two batches, T=16,384, strided,
    K=2^18), of a legacy step at the bench's warmed state, and on the
    edges (`legacy_edge_calls`); one evaluation (`legacy_sweep`) on every
    evaluation's input of those steps' fixpoints. The plain version
    materialises the (NW, NR) matrix. Timed on the second step's call."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    calls = legacy_ab_calls(dev, T)
    _state, _batch, warmed = bench_step_calls(dev, T, 1 << 18,
                                              intra_mode="legacy")
    calls += warmed["legacy_blocked"]
    del _state, _batch, warmed
    sweeps = [((c, *a), kw) for a, kw in calls
              for c in legacy_inputs("legacy_blocked", a)]
    main = calls[1]
    res = results["legacy_blocked"] = hold_to_plain(
        "legacy_blocked", kernels.legacy_fixpoint, ref.legacy_fixpoint,
        calls + legacy_edge_calls(dev, main), main, f"bench T={T}", reps=20,
        check=(counted_legacy(kernels.legacy_fixpoint),
               counted_legacy(ref.legacy_fixpoint)))
    n = torch.zeros((), dtype=torch.int32, device=dev)
    kernels.legacy_fixpoint(*main[0], evals=n)
    res["evaluations"] = int(n)
    res["per_evaluation"] = hold_to_plain(
        "legacy_sweep", kernels.legacy_sweep, ref.legacy_sweep, sweeps,
        sweeps[len(legacy_inputs("legacy_blocked", calls[0][0]))],
        f"bench T={T} one evaluation", reps=20)
    res["per_evaluation"]["checked_evaluations"] = len(sweeps)
    res["ms_per_evaluation"] = res["ms"] / res["evaluations"]
    res["device_ms_per_evaluation"] = (res["device_ms"] / res["evaluations"]
                                       if res["device_ms"] else None)
    for a, _kw in calls:
        kernels.legacy_fixpoint(*a, evals=n)
        if int(n) != len(legacy_inputs("legacy_blocked", a)):
            fail(f"legacy_blocked: {int(n)} evaluations, the plain fixpoint "
                 f"{len(legacy_inputs('legacy_blocked', a))}")
    del calls, sweeps, main


def check_probes(dev, results):
    """Each probe against its plain version at the Pallas scripts' shapes,
    the rank joins also on their edges (`probes.rank_edge_calls`: ties,
    high bits, LK = 1 to 8, tiles that are not a power of two); timed at
    the scripts' shapes."""
    from foundationdb_tpu_torch.ops import probes
    edges: dict = {}
    for name, a, kw in probes.rank_edge_calls(dev):
        edges.setdefault(name, []).append((a, kw))
    for name, call in probes.script_calls(dev).items():
        results[name] = hold_to_plain(name, probes.WRAPPERS[name],
                                      probes.PLAIN[name],
                                      [call] + edges.get(name, []), call,
                                      "probes", reps=20)


def eager_engine(cs, phases=None):
    """`cs` made to run its chunks eagerly, with the kernels or `phases`:
    the yardsticks the bucket graphs are held and timed against."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    cs._graph = lambda shapes: None
    if phases is not None:
        def step(batch):
            return ref.conflict_step(
                cs._state, batch, max_write_life=5_000_000, phases=phases,
                out=cs._state)[2]["readback"]
        cs._step = step
    return cs


def chunk_shapes(cs, txns):
    nr = sum(len(t.read_ranges) for t in txns)
    nw = sum(len(t.write_ranges) for t in txns)
    return cs.plan_chunk(nr, nw)


def profile_step(dev, batches):
    """Where one main-path chunk's time goes (default knobs): wall ms per
    chunk (encode, dispatch, the one readback) through the bucket graphs,
    through the eager kernel step and through the plain phases on the
    card, and a profiler breakdown of the graphed chunk: device-busy ms,
    the kernels' share, the top device functions and the device's idle
    share of the wall time."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    out = {}
    for label in ("graph", "eager", "plain"):
        cs = DeviceConflictSet(device=dev)
        if label != "graph":
            eager_engine(cs, ref.PLAIN if label == "plain" else None)
        cs.warmup()  # captures the bucket graphs, outside the clock
        it = iter(batches)

        def one(cs=cs, it=it):
            _prev, version, txns = next(it)
            cs.dispatch_chunk(txns, version, [False] * len(txns),
                              chunk_shapes(cs, txns), True).cpu()
        one()
        torch.cuda.synchronize()
        n = 5
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        out[f"{label}_chunk_ms"] = (time.perf_counter() - t0) / n * 1e3
        if label == "graph":
            funcs, wall = profile_device(one, 3)
            busy = busy_ms(funcs)
            ours = sum(device_ms_of(funcs, k) or 0.0 for k in STEP_KERNELS)
            top = sorted(funcs.items(), key=lambda kv: -kv[1][0])[:10]
            out.update(
                device_busy_ms=busy, kernels_device_ms=ours,
                wall_ms=wall / 3 * 1e3,
                device_idle_share=max(0.0, 1 - busy / (wall / 3 * 1e3)),
                radix_sort_device_ms=radix_sort_ms(funcs),
                masks_functions=[k[:80] for k in funcs if "step_masks" in k],
                top_device_functions=[(k[:80], v[0]) for k, v in top])
    log("step profile: " + json.dumps(out))
    if out["masks_functions"]:
        fail(f"the default-knobs step launches a masks kernel: "
             f"{out['masks_functions']}")
    if out["radix_sort_device_ms"] > 0:
        fail(f"the default-knobs step still runs a cub radix sort "
             f"({out['radix_sort_device_ms']} ms)")
    return out


def radix_sort_ms(funcs: dict) -> float:
    """Device ms a call of every cub radix-sort function of a profile."""
    return sum(v[0] for k, v in funcs.items() if "RadixSort" in k)


def check_step_trajectory(dev):
    """The engine's chunks through its bucket graphs (card) against the
    eager kernel step on fixed buffers (card) and the plain step (CPU),
    over a small trajectory that overflows, poisons and rebases (through
    the fixed buffers): every readback row and state field equal after
    every step, and the graphed engine's state buffers at the same
    addresses from start to end."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import (DeviceConflictSet,
                                                     state_to_numpy)
    rng = np.random.default_rng(12)
    keys = [b"k%05d" % i for i in range(20_000)]
    cpu = DeviceConflictSet(capacity=1024, txns=64, device="cpu")
    eager = eager_engine(DeviceConflictSet(capacity=1024, txns=64,
                                           device=dev))
    graphed = DeviceConflictSet(capacity=1024, txns=64, device=dev)
    graphed.warmup()
    engines = (cpu, eager, graphed)
    ptrs = {k: v.data_ptr() for k, v in graphed._state.items()}
    kernels.reset_launches()
    version, steps, poisoned = 0, 0, False
    for i in range(12):
        if i == 6:
            for cs in engines:
                ref.rebase_state(cs._state, 40_000, phases=kernels.PHASES,
                                 out=cs._state)
            version -= 40_000
        version += 10_000
        txns = []
        for _ in range(64):
            ks = [keys[j] for j in rng.integers(0, len(keys), 6).tolist()]
            a, b = sorted(ks[:2])
            reads = ([(ks[2], ks[2] + b"\x00"), (a, b)]
                     if rng.random() < 0.3 else [])
            txns.append(TxnConflictInfo(
                max(0, version - int(rng.integers(0, 30_000))), reads,
                [(k, k + b"\x00") for k in ks[3:]]
                + [(b, a)]))  # an inverted range: inert
        rows = [cs.dispatch_chunk(txns, version, [False] * 64,
                                  chunk_shapes(cs, txns), True).cpu()
                for cs in engines]
        torch.cuda.synchronize()
        for label, row in (("eager kernels", rows[1]), ("graph", rows[2])):
            if not torch.equal(rows[0], row):
                fail(f"step {i}: the {label}' readback row differs from the "
                     f"plain step's")
        want = state_to_numpy(cpu._state)
        for label, cs in (("eager kernels", eager), ("graph", graphed)):
            got = state_to_numpy(cs._state)
            for k in want:
                if not np.array_equal(want[k], got[k]):
                    fail(f"step {i}: state[{k}] of the {label} differs "
                         f"from the plain step's")
        poisoned |= bool(rows[0][2 * 64])
        steps += 1
    if {k: v.data_ptr() for k, v in graphed._state.items()} != ptrs:
        fail("the graphed engine's state buffers moved")
    graphs = [g for g in graphed._graphs.values() if g.graph is not None]
    if not graphs or kernels.LAUNCHES["step_verdicts"] != 2 * steps:
        fail(f"step trajectory: {len(graphs)} bucket graphs, "
             f"{kernels.LAUNCHES['step_verdicts']} K13 launches for "
             f"{steps} steps each eager and graphed")
    if not poisoned:
        fail("the step trajectory never overflowed: the poison path is "
             "unchecked")
    log(f"step trajectory: {steps} steps through the bucket graphs equal to "
        f"the eager kernels and the plain step (overflow and rebase "
        f"included; state buffers unmoved)")
    return {"steps": steps, "poisoned": poisoned,
            "bucket_graphs": len(graphs)}


# ---------------------------------------------------------------------------
# phase 4: the resolver role serving commit batches
# ---------------------------------------------------------------------------

def once_a_step(where, launches):
    """Every step launches K2 (the masks and the verdicts) once; the level
    geometry, the sandwich, the sort-and-rank phase and the verdict glue
    (K9, K3, K6-K8, K13) must run once a step too (on replays: the counts
    a graph recorded at capture, added at each replay). No kernel of the
    library but these runs the masks (`kernels.KERNELS` has none)."""
    from foundationdb_tpu_torch.ops import kernels
    if "step_masks" in kernels.KERNELS:
        fail(f"{where}: the package still has a masks kernel of its own")
    for name in ("intra_levels", "intra_sandwich",
                 "step_verdicts") + SORT_KERNELS:
        if launches[name] != launches["masks_and_history"]:
            fail(f"{where}: {launches[name]} {name} launches for "
                 f"{launches['masks_and_history']} steps")


def serve_phase(name, dev, capacity, n_batches, n_keys, seed, n_load=0,
                window=4, jump_at=None, backend="device"):
    """Serve `n_load` load batches, then `n_batches` run batches, through
    the port's Resolver; check every reply against the oracle. With
    `jump_at`, run batch `jump_at`'s version jumps by 2^29, so the resolver
    rebases and the rebase kernel must launch. `backend` "sharded" serves
    through the sharded engine on every attached card (CONFLICT_DEVICE=cuda,
    CONFLICT_NUM_SHARDS=0), whose K10 and K11 must then launch once a
    chunk. Returns the phase's numbers (throughput and latency of the run
    batches), the resolver's conflict set and one more run batch past the
    last served."""
    import torch

    from foundationdb_tpu_torch.core.eventloop import EventLoop
    from foundationdb_tpu_torch.core.sim import Endpoint, SimNetwork
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.conflict import kernel_metrics
    from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
    from foundationdb_tpu_torch.server.interfaces import (
        ResolveTransactionBatchRequest, Token)
    from foundationdb_tpu_torch.server.resolver import Resolver
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    from foundationdb_tpu_torch.utils.rng import DeterministicRandom

    rng = np.random.default_rng(seed)
    cdf, keys = zipf_keys(n_keys)
    t0 = time.perf_counter()
    load = make_load_batches(rng, keys, n_load) if n_load else []
    run = make_batches(rng, cdf, keys, n_batches + 1,
                       prev=load[-1][1] if load else 0, jump_at=jump_at)
    run, extra = run[:-1], run[-1]
    batches = load + run
    gen_s = time.perf_counter() - t0

    KNOBS.reset()
    KNOBS.overrides(CONFLICT_BACKEND=backend,
                    CONFLICT_DEVICE=str(dev) if backend == "device" else "cuda",
                    CONFLICT_STATE_CAPACITY=capacity)
    loop = EventLoop()
    net = SimNetwork(loop, DeterministicRandom(seed))
    proc = net.new_process("resolver")
    proxy = net.new_process("proxy")
    t0 = time.perf_counter()
    resolver = Resolver(proc)  # warmup: every serving bucket once
    boot_s = time.perf_counter() - t0
    ep = Endpoint("resolver", Token.RESOLVER_RESOLVE)
    # host seconds by part of the role over the run batches: dispatch
    # (encode + enqueue of every chunk), readback wait + result (drain),
    # and the reply bookkeeping
    host = {"dispatch_s": 0.0, "drain_s": 0.0, "finish_s": 0.0}

    def timed(key, fn):
        def run_timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[key] += time.perf_counter() - t
        return run_timed
    resolver.conflict_set.detect_async = timed(
        "dispatch_s", resolver.conflict_set.detect_async)
    resolver._finish_batch = timed("finish_s", resolver._finish_batch)
    import foundationdb_tpu_torch.server.resolver as resolver_mod
    drain = resolver_mod.drain_and_collect
    resolver_mod.drain_and_collect = timed("drain_s", drain)
    latency = [None] * len(batches)
    replies = [None] * len(batches)
    marks = {}

    async def send(first, last):
        inflight = []
        for i in range(first, last):
            prev, version, txns = batches[i]
            req = ResolveTransactionBatchRequest(
                prev_version=prev, version=version,
                last_receive_version=prev, transactions=txns)
            t_send = time.perf_counter()
            fut = net.request(proxy, ep, req, timeout=None)

            def done(f, i=i, t_send=t_send):
                latency[i] = time.perf_counter() - t_send
            fut.add_callback(done)
            inflight.append((i, fut))
            while len(inflight) >= window or (inflight and i == last - 1):
                j, f = inflight.pop(0)
                replies[j] = (await f).committed

    async def drive():
        # the load completes before the run starts, so the run's numbers
        # are its own
        marks["t0"] = time.perf_counter()
        await send(0, len(load))
        marks["t_run"] = time.perf_counter()
        for k in host:
            host[k] = 0.0
        await send(len(load), len(batches))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted = ("KernelDispatches", "UnconvergedChunks")
    before = {k: kernel_metrics.as_dict()[k] for k in counted}
    kernels.reset_launches()
    kernels.level_paths(reset=True)
    loop.run_future(proxy.spawn(drive(), "proxyDriver"), max_time=1e9)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    path = STEP_KERNELS if jump_at is None else PATH_KERNELS
    if backend == "sharded":
        path += SHARD_KERNELS
    launches = {k: kernels.LAUNCHES[k] for k in path}
    level_paths = kernels.level_paths()
    chunks, unconverged = (kernel_metrics.as_dict()[k] - before[k]
                           for k in counted)
    resolver_mod.drain_and_collect = drain
    wall = t_end - marks["t_run"]
    peak = torch.cuda.max_memory_allocated()
    state = resolver.conflict_set._state
    graphs = getattr(resolver.conflict_set, "_graphs", {})
    shards = state["shards"] if backend == "sharded" else [state]
    boundaries = sum(int(s["nb"]) for s in shards)
    poisoned = any(bool(s["poisoned"]) for s in shards)

    t0 = time.perf_counter()
    oracle = OracleConflictSet()
    mismatches = 0
    for (prev, version, txns), got in zip(batches, replies):
        want = oracle.detect(txns, version)
        mismatches += got != want
    oracle_s = time.perf_counter() - t0
    n_txns = sum(len(b[2]) for b in run)
    statuses = np.concatenate([np.asarray(r) for r in replies[len(load):]])
    lat_ms = np.asarray(latency[len(load):], dtype=np.float64) * 1e3
    out = {
        "phase": name, "backend": resolver.conflict_set.backend_label
        if hasattr(resolver.conflict_set, "backend_label") else backend,
        "capacity": capacity, "batches": n_batches,
        "txns": n_txns, "keys": n_keys, "in_flight": window,
        "wall_s": wall, "txns_per_s": n_txns / wall,
        "batch_latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "batch_latency_ms_p99": float(np.percentile(lat_ms, 99)),
        "committed_share": float((statuses == 2).mean()),
        "load_batches": len(load),
        "load_wall_s": marks["t_run"] - marks["t0"],
        "boundaries": boundaries, "poisoned": poisoned,
        "chunks": chunks, "unconverged_chunks": unconverged,
        "peak_device_bytes": peak, "launches": launches,
        "level_paths": level_paths,
        "graphed": getattr(resolver.conflict_set, "graphed", None),
        "bucket_graphs": sorted(f"{r}x{w}" for (r, w), g in graphs.items()
                                if g.graph is not None),
        "host_share": {k: v / wall for k, v in host.items()},
        "boot_s": boot_s, "traffic_gen_s": gen_s, "oracle_s": oracle_s,
        "mismatched_batches": mismatches}
    log(f"phase {name}: " + json.dumps(out))
    if mismatches:
        fail(f"phase {name}: {mismatches} batch replies differ from the "
             f"oracle")
    if poisoned:
        fail(f"phase {name}: the conflict state poisoned")
    if any(v <= 0 for v in launches.values()):
        fail(f"phase {name}: a kernel never launched: {launches}")
    once_a_step(f"phase {name}", launches)
    if backend == "device" and not out["bucket_graphs"]:
        fail(f"phase {name}: the resolver served through no bucket graph")
    if backend == "sharded" and not out["graphed"]:
        fail(f"phase {name}: the sharded engine's chunk is not graphed")
    for k in SHARD_KERNELS if backend == "sharded" else ():
        if launches[k] != chunks:
            fail(f"phase {name}: {launches[k]} {k} launches for {chunks} "
                 f"chunks")
    if unconverged:
        # such a chunk's intra-batch verdicts come from the host pass, so
        # the oracle check would not show that the kernel decided them
        fail(f"phase {name}: {unconverged} of {chunks} chunks did not "
             f"converge on the device")
    resolver.shutdown()
    return out, resolver.conflict_set, extra


# ---------------------------------------------------------------------------
# phase 9: the commit pipeline under simulation
# ---------------------------------------------------------------------------

CLUSTER_CLIENTS = 512
CLUSTER_ATTEMPTS = 40
CLUSTER_LOAD_TXNS = 200  # YCSB's load: 200 blind inserts of 100 keys
CLUSTER_VALUE_BYTES = 100  # one YCSB field
CYCLE_NODES = 1_000
CYCLE_ROTATORS = 256
CYCLE_TXNS = 10
# an attempt's outcomes other than a commit: the resolver's verdicts
CLUSTER_REJECTIONS = ("not_committed", "transaction_too_old")


def boot_cluster(dev, seed, n_resolvers, knobs=None):
    """The port's SimCluster (2 proxies, `n_resolvers` resolvers, 2 tlogs,
    2 storage servers) at the default knobs (with `knobs` over them: the
    CPU tests' small shapes), its resolvers' engines on `dev`, with each
    resolver's decided batches recorded (request and statuses, by
    version) and its host time split as phase 4 splits it. Returns
    (cluster, probe): `probe` holds the records, the host seconds and
    each resolver's chunks by bucket."""
    from foundationdb_tpu_torch.server import resolver as resolver_mod
    from foundationdb_tpu_torch.server.cluster import SimCluster
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    KNOBS.reset()
    KNOBS.overrides(CONFLICT_BACKEND="device", CONFLICT_DEVICE=str(dev),
                    **(knobs or {}))
    t0 = time.perf_counter()
    c = SimCluster(seed, n_proxies=2, n_resolvers=n_resolvers, n_tlogs=2,
                   n_storage=2)
    probe = {"boot_s": time.perf_counter() - t0,
             "host": {"dispatch_s": 0.0, "drain_s": 0.0, "finish_s": 0.0},
             "requests": [{} for _ in c.resolvers],
             "replies": [{} for _ in c.resolvers],
             "buckets": [{} for _ in c.resolvers]}
    host = probe["host"]

    def timed(key, fn):
        def run_timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[key] += time.perf_counter() - t
        return run_timed

    for i, r in enumerate(c.resolvers):
        cs = r.conflict_set

        def resolve(req, reply, fn=r._resolve_batch,
                    seen=probe["requests"][i]):
            seen.setdefault(req.version, req)
            return fn(req, reply)

        def finish(req, reply, statuses, fn=r._finish_batch,
                   got=probe["replies"][i]):
            got[req.version] = list(statuses)
            return fn(req, reply, statuses)

        def dispatch(sub, commit_version, skip, shapes, advance_floor,
                     fn=cs.dispatch_chunk, seen=probe["buckets"][i]):
            key = f"{shapes.reads}x{shapes.writes}"
            seen[key] = seen.get(key, 0) + 1
            return fn(sub, commit_version, skip, shapes, advance_floor)

        r._resolve_batch = resolve
        r._finish_batch = timed("finish_s", finish)
        cs.detect_async = timed("dispatch_s", cs.detect_async)
        cs.dispatch_chunk = dispatch
    probe["drain"] = resolver_mod.drain_and_collect
    resolver_mod.drain_and_collect = timed("drain_s", probe["drain"])
    return c, probe


def drive_cluster(name, dev, c, probe, load, run):
    """Run `load()`, then `run()` (coroutine functions) on the cluster's
    loop, with every kernel count, the chunk and rebase counts and the
    host split zeroed between them and read after the run; then hold the
    resolvers to the phase's checks: every decided batch (the load's too)
    equal to the port's OracleConflictSet replayed in version order, every
    received request decided, no poison, every chunk converged, each step
    kernel launched once a chunk and the rebase kernel once a rebase.
    Returns the run's numbers."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.conflict import kernel_metrics
    from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
    from foundationdb_tpu_torch.server import resolver as resolver_mod

    cuda = dev.type == "cuda"
    c.run(c.loop.spawn(load()), max_time=1e9)
    rebases = [0]
    rebase = ref.rebase_state

    def counted_rebase(*a, **kw):
        rebases[0] += 1
        return rebase(*a, **kw)
    ref.rebase_state = counted_rebase
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counted = ("KernelDispatches", "UnconvergedChunks")
    before = {k: kernel_metrics.as_dict()[k] for k in counted}
    for k in probe["host"]:
        probe["host"][k] = 0.0
    for b in probe["buckets"]:
        b.clear()
    v0 = c.loop.now()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        c.run(c.loop.spawn(run()), max_time=1e9)
        if cuda:
            torch.cuda.synchronize()
    finally:
        ref.rebase_state = rebase
        resolver_mod.drain_and_collect = probe["drain"]
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    chunks, unconverged = (kernel_metrics.as_dict()[k] - before[k]
                           for k in counted)
    out = {
        "phase": name, "wall_s": wall, "virtual_s": c.loop.now() - v0,
        "chunks": chunks, "unconverged_chunks": unconverged,
        "rebases": rebases[0], "launches": launches,
        "buckets": probe["buckets"],
        "host_share": {k: v / wall for k, v in probe["host"].items()},
        "peak_device_bytes": torch.cuda.max_memory_allocated() if cuda
        else None, "boot_s": probe["boot_s"],
        "backends": [r.conflict_set.backend_label for r in c.resolvers],
        "bucket_graphs": [sorted(f"{r}x{w}" for (r, w), g
                                 in r_.conflict_set._graphs.items()
                                 if g.graph is not None)
                          for r_ in c.resolvers]}
    # every batch a resolver decided, replayed in version order into the
    # oracle; the requests are the whole run's, load included
    t1 = time.perf_counter()
    batches = mismatches = 0
    for i, r in enumerate(c.resolvers):
        reqs, got = probe["requests"][i], probe["replies"][i]
        if set(reqs) != set(got):
            fail(f"phase {name}: resolver {i} decided {len(got)} of the "
                 f"{len(reqs)} batches it received")
        oracle = OracleConflictSet()
        for version in sorted(reqs):
            want = oracle.detect(reqs[version].transactions, version)
            mismatches += got[version] != want
            batches += 1
        state = r.conflict_set._state
        if r._poisoned is not None or bool(state["poisoned"]):
            fail(f"phase {name}: resolver {i}'s conflict state poisoned")
    out["resolved_batches"] = batches
    out["oracle_s"] = time.perf_counter() - t1
    out["mismatched_batches"] = mismatches
    if mismatches:
        fail(f"phase {name}: {mismatches} of {batches} resolver replies "
             f"differ from the oracle")
    if cuda and any(b != "cuda" for b in out["backends"]):
        fail(f"phase {name}: a resolver is not on the card: "
             f"{out['backends']}")
    if unconverged:
        fail(f"phase {name}: {unconverged} of {chunks} chunks did not "
             f"converge on the device")
    for k in STEP_KERNELS if cuda else ():
        if launches[k] != chunks:
            fail(f"phase {name}: {launches[k]} {k} launches for {chunks} "
                 f"resolver steps")
    if cuda and launches["rebase_table"] != rebases[0]:
        fail(f"phase {name}: {launches['rebase_table']} rebase launches "
             f"for {rebases[0]} rebases")
    return out


def storage_read(c, key):
    """`key`'s value read straight from the storage server that owns it,
    at that server's latest version."""
    from foundationdb_tpu_torch.utils.keys import partition_index
    ss = c.storages[partition_index(c.shard_boundaries, key)]
    return ss.data.get(key, ss.version.get())


async def ycsb_load(c, db, keys):
    """YCSB's load phase (9a, 12a, 12b): CLUSTER_LOAD_TXNS blind inserts
    of every key with one CLUSTER_VALUE_BYTES field."""
    from foundationdb_tpu_torch.core.future import all_of

    async def insert(ks):
        tr = db.create_transaction()
        for k in sorted(ks):
            tr.set(k, k.ljust(CLUSTER_VALUE_BYTES, b"."))
        await tr.commit()
    n = min(CLUSTER_LOAD_TXNS, len(keys))
    await all_of([c.loop.spawn(insert(keys[i::n]), name=f"load{i}")
                  for i in range(n)])


def ycsb_traffic(seed, n_keys, n_clients, n_attempts):
    """Cell A's traffic (9a, 12a, 12b): its keys, and each client's
    attempts' 8 zipfian picks (4 reads, then 4 writes)."""
    rng = np.random.default_rng(seed)
    cdf, keys = zipf_keys(n_keys)
    picks = np.searchsorted(cdf, rng.random((n_clients, n_attempts, 8)))
    return keys, picks


async def ycsb_mix(c, db, keys, picks, outcomes, first=0, on_commit=None):
    """Cell A's mix from every client at once (`picks`: clients x attempts
    x 8, the attempts numbered from `first`): each attempt 4 zipfian
    reads, 4 zipfian writes of a value made from (client, attempt), one
    commit and no retry; `outcomes` counts each attempt's end, and
    `on_commit(tr, written_keys, value)` sees each commit."""
    from foundationdb_tpu_torch.core.future import all_of
    from foundationdb_tpu_torch.utils.errors import FDBError

    async def client(ci):
        for ai in range(picks.shape[1]):
            idx = picks[ci, ai].tolist()
            v = (b"c%05d.a%03d" % (ci, first + ai)).ljust(
                CLUSTER_VALUE_BYTES, b".")
            tr = db.create_transaction()
            try:
                for i in idx[:4]:
                    await tr.get(keys[i])
                for i in idx[4:]:
                    tr.set(keys[i], v)
                await tr.commit()
            except FDBError as e:
                outcomes[e.name] = outcomes.get(e.name, 0) + 1
                continue
            outcomes["committed"] = outcomes.get("committed", 0) + 1
            if on_commit is not None:
                on_commit(tr, [keys[i] for i in idx[4:]], v)
    await all_of([c.loop.spawn(client(ci), name=f"client{ci}")
                  for ci in range(picks.shape[0])])


def cluster_ycsb_phase(dev, seed, n_clients=CLUSTER_CLIENTS,
                       n_attempts=CLUSTER_ATTEMPTS, n_keys=20_000,
                       knobs=None):
    """9a: cell A's mix through the whole pipeline. YCSB's load (200
    blind inserts of 100 keys, one 100-byte field a key), then `n_clients`
    client actors of `n_attempts` attempts each: 4 zipfian reads, 4
    zipfian writes of a value made from (client, attempt), one commit and
    no retry. Every committed attempt's writes, applied in commit order
    (version, then place in its proxy batch), make the model that the
    client and each storage server must read back."""
    keys, picks = ycsb_traffic(seed, n_keys, n_clients, n_attempts)
    c, probe = boot_cluster(dev, seed, n_resolvers=1, knobs=knobs)
    db = c.database()
    # each commit's place in its proxy batch, keyed by its value
    order: dict = {}
    for p in c.proxies:
        def commit_batch(batch_n, batch, t_arrival=None,
                         fn=p._commit_batch):
            for pos, (req, _rep, _t) in enumerate(batch):
                if req.mutations:
                    order[req.mutations[0].param2] = pos
            return fn(batch_n, batch, t_arrival)
        p._commit_batch = commit_batch

    def value(tag: bytes) -> bytes:
        return tag.ljust(CLUSTER_VALUE_BYTES, b".")

    committed: list = []  # (version, place, keys, value)
    outcomes: dict = {}

    async def load():
        await ycsb_load(c, db, keys)

    def on_commit(tr, ks, v):
        committed.append((tr.committed_version, order[v], ks, v))

    async def run():
        await ycsb_mix(c, db, keys, picks, outcomes, on_commit=on_commit)

    out = drive_cluster("9a", dev, c, probe, load, run)
    attempts = n_clients * n_attempts
    out.update({"clients": n_clients, "attempts_per_client": n_attempts,
                "attempts": attempts, "keys": n_keys,
                "load_txns": CLUSTER_LOAD_TXNS,
                "committed": outcomes.get("committed", 0),
                "conflicted": outcomes.get("not_committed", 0),
                "too_old": outcomes.get("transaction_too_old", 0),
                "outcomes": outcomes,
                "attempts_per_wall_s": attempts / out["wall_s"]})
    out["commit_share"] = out["committed"] / attempts

    # the model: the load, then every committed attempt in commit order
    model = {k: value(k) for k in keys}
    for _v, _pos, ks, v in sorted(committed, key=lambda x: x[:2]):
        for k in ks:
            model[k] = v
    t0 = time.perf_counter()

    async def read_back():
        tr = db.create_transaction()
        return await tr.get_many(keys)
    got = c.run(c.loop.spawn(read_back()), max_time=1e9)
    client_bad = sum(g != model[k] for k, g in zip(keys, got))
    storage_bad = sum(storage_read(c, k) != model[k] for k in keys)
    out["read_back_s"] = time.perf_counter() - t0
    out["read_back_mismatches"] = {"client": client_bad,
                                   "storage": storage_bad}
    log("phase 9a: " + json.dumps(out))
    if outcomes.get("commit_unknown_result"):
        fail(f"phase 9a: {outcomes['commit_unknown_result']} attempts ended "
             f"in commit_unknown_result")
    if sum(outcomes.values()) != attempts:
        fail(f"phase 9a: {sum(outcomes.values())} outcomes for {attempts} "
             f"attempts")
    unknown = set(outcomes) - {"committed", *CLUSTER_REJECTIONS}
    if unknown:
        fail(f"phase 9a: attempts ended in {sorted(unknown)}")
    if not out["committed"] or not out["conflicted"]:
        fail(f"phase 9a: no commit or no conflict among the attempts: "
             f"{outcomes}")
    if client_bad or storage_bad:
        fail(f"phase 9a: acknowledged writes not read back: {client_bad} "
             f"keys through a transaction, {storage_bad} from the storage "
             f"servers")
    return out


def cluster_cycle_phase(dev, seed, n_nodes=CYCLE_NODES,
                        n_rotators=CYCLE_ROTATORS, n_txns=CYCLE_TXNS,
                        knobs=None):
    """9b: the Cycle workload (Cycle.actor.cpp) across two resolvers: a
    ring of `n_nodes` keys by value, spread over both resolvers' and both
    storage servers' key ranges; `n_rotators` actors each run `n_txns`
    three-key rotations through `db.transact`; then the ring must still
    be one cycle through every node, read through a transaction and from
    the storage servers alike."""
    import random

    from foundationdb_tpu_torch.core.future import all_of

    rnd = random.Random(seed)
    c, probe = boot_cluster(dev, seed, n_resolvers=2, knobs=knobs)
    db = c.database()

    def key(i):
        return bytes([i * 251 % 256]) + b"/cycle/%04d" % i

    async def setup(tr):
        for i in range(n_nodes):
            tr.set(key(i), b"%04d" % ((i + 1) % n_nodes))

    tries = [0]
    errors: dict = {}

    async def rotate(tr):
        if "on_error" not in vars(tr):  # count each retried attempt's error
            def on_error(e, fn=tr.on_error):
                name = getattr(e, "name", repr(e))
                errors[name] = errors.get(name, 0) + 1
                return fn(e)
            tr.on_error = on_error
        tries[0] += 1
        a = key(rnd.randrange(n_nodes))
        b_idx = int(await tr.get(a))
        b = key(b_idx)
        c_idx = int(await tr.get(b))
        cc = key(c_idx)
        d_idx = int(await tr.get(cc))
        tr.set(a, b"%04d" % c_idx)
        tr.set(b, b"%04d" % d_idx)
        tr.set(cc, b"%04d" % b_idx)

    async def rotator():
        for _ in range(n_txns):
            await db.transact(rotate)

    async def run():
        await all_of([c.loop.spawn(rotator(), name=f"rot{i}")
                      for i in range(n_rotators)])

    async def load():
        await db.transact(setup)

    out = drive_cluster("9b", dev, c, probe, load, run)

    async def read_ring():
        tr = db.create_transaction()
        return await tr.get_many([key(i) for i in range(n_nodes)])
    ring = [int(v) for v in c.run(c.loop.spawn(read_ring()), max_time=1e9)]
    stored = [int(storage_read(c, key(i))) for i in range(n_nodes)]
    seen, i = set(), 0
    for _ in range(n_nodes):
        seen.add(i)
        i = ring[i]
    committed = n_rotators * n_txns
    out.update({"nodes": n_nodes, "rotators": n_rotators,
                "txns_per_rotator": n_txns, "attempts": tries[0],
                "committed": committed,
                "conflicted": errors.get("not_committed", 0),
                "too_old": errors.get("transaction_too_old", 0),
                "retried_errors": errors,
                "commit_share": committed / tries[0],
                "attempts_per_wall_s": tries[0] / out["wall_s"],
                "ring_holds": i == 0 and len(seen) == n_nodes,
                "storage_equals_client": stored == ring})
    log("phase 9b: " + json.dumps(out))
    if errors.get("commit_unknown_result"):
        fail(f"phase 9b: {errors['commit_unknown_result']} attempts ended in "
             f"commit_unknown_result")
    if tries[0] != committed + sum(errors.values()):
        fail(f"phase 9b: {tries[0]} attempts for {committed} commits and "
             f"{sum(errors.values())} retried errors")
    if not out["ring_holds"]:
        fail(f"phase 9b: the ring broke: {len(seen)} nodes from 0, back at "
             f"{i}")
    if not out["storage_equals_client"]:
        fail("phase 9b: the storage servers' ring differs from the one "
             "read through a transaction")
    if min(sum(b.values()) for b in out["buckets"]) == 0:
        fail(f"phase 9b: a resolver decided no chunk: {out['buckets']}")
    return out


def cluster_phase(dev, seed, ycsb=None, cycle=None):
    """Phase 9: 9a and 9b, each on its own cluster (`ycsb` and `cycle`:
    keyword arguments of each run, the CPU tests' small sizes). The roles'
    trace events (counters, commit spans) are dropped: nothing here reads
    them."""
    from foundationdb_tpu_torch.utils import trace
    trace.set_sink(lambda _fields: None)
    try:
        return {"9a": cluster_ycsb_phase(dev, seed + 9, **(ycsb or {})),
                "9b": cluster_cycle_phase(dev, seed + 19, **(cycle or {}))}
    finally:
        trace.set_sink(None)


# ---------------------------------------------------------------------------
# phase 10: recovery, the resolvers recruited anew on the card
# ---------------------------------------------------------------------------

# the rotations committed before each kill: the worker that hosts the first
# resolver, then the elected cluster controller
RECOVERY_KILLS = ((640, "resolver"), (1600, "cluster_controller"))


def storage_replicas(c, info, key):
    """`key`'s value from every storage replica that the generation `info`
    (a DBInfo) says serves it, each read at that server's latest version."""
    from foundationdb_tpu_torch.utils.keys import partition_index
    addr_of = {tag: addr for addr, tag in info.storages}
    team = info.teams()[partition_index(info.shard_boundaries, key)]
    out = []
    for tag in team:
        ss = c.net.processes[addr_of[tag]].worker.roles[f"storage:{tag}"]
        out.append(ss.data.get(key, ss.version.get()))
    return out


def engine_poisoned(cs) -> bool:
    """Whether an engine's conflict state poisoned (the sharded engine's:
    any shard's)."""
    shards = cs._state.get("shards", [cs._state])
    return any(bool(shard["poisoned"]) for shard in shards)


def engine_program(cs, shapes):
    """The program a chunk of `shapes` replays: the sharded engine's one
    program, or the single-device engine's bucket graph (None before it
    exists)."""
    program = getattr(cs, "_program", None)
    if program is None:
        program = cs._graphs.get((shapes.reads, shapes.writes))
    return program


def record_resolvers(kernels):
    """Phases 10 to 12: a hook on `Resolver.__init__` that records every
    Resolver built while it is installed (`hook.install()`,
    `hook.remove()`): its process, device, recovery version, virtual and
    wall build time, the requests it received and the statuses it replied
    by version, its chunks by bucket, the chunks that ran outside a
    captured graph, its eager steps, and whether it poisoned by its
    shutdown. The launches the builds make (the graphs' captures, and the
    sharded engine's warm-up chunk) add up in `hook.build_launches`, and
    the chunks they dispatch in `hook.build_chunks`. The records hold no
    reference to the role; `hook.roles` holds weak ones, beside
    `hook.instances`."""
    import weakref

    from foundationdb_tpu_torch.ops.conflict import kernel_metrics
    from foundationdb_tpu_torch.server import resolver as resolver_mod

    init = resolver_mod.Resolver.__init__
    hook = argparse.Namespace(instances=[], roles=[], build_chunks=0,
                              build_launches={k: 0 for k in kernels.LAUNCHES})

    def poisoned(r):
        return r._poisoned is not None or engine_poisoned(r.conflict_set)
    hook.poisoned = poisoned

    def recorded_init(r, process, *a, **kw):
        before = dict(kernels.LAUNCHES)
        dispatched = kernel_metrics.as_dict()["KernelDispatches"]
        t0 = time.perf_counter()
        init(r, process, *a, **kw)
        hook.build_chunks += (kernel_metrics.as_dict()["KernelDispatches"]
                              - dispatched)
        rec = {"process": process.address, "recovery_version": r.version.get(),
               "built_at_virtual_s": process.net.loop.now(),
               "build_s": time.perf_counter() - t0,
               "device": str(getattr(r.conflict_set, "device", "host")),
               "requests": {}, "replies": {}, "buckets": {},
               "ungraphed_chunks": 0, "eager_steps": 0, "poisoned": None}
        for k in hook.build_launches:
            hook.build_launches[k] += kernels.LAUNCHES[k] - before.get(k, 0)
        hook.instances.append(rec)
        hook.roles.append(weakref.ref(r))
        cs = r.conflict_set

        def resolve(req, reply, fn=r._resolve_batch):
            rec["requests"].setdefault(req.version, req)
            return fn(req, reply)

        def finish(req, reply, statuses, fn=r._finish_batch):
            rec["replies"][req.version] = list(statuses)
            return fn(req, reply, statuses)

        buckets = rec["buckets"]

        def dispatch(sub, commit_version, skip, shapes, advance_floor,
                     fn=cs.dispatch_chunk):
            key = f"{shapes.reads}x{shapes.writes}"
            buckets[key] = buckets.get(key, 0) + 1
            program = engine_program(cs, shapes)
            if program is None or not program.graphed \
                    or program.graph is None:
                rec["ungraphed_chunks"] += 1
            return fn(sub, commit_version, skip, shapes, advance_floor)

        def shutdown(fn=r.shutdown, role=weakref.ref(r)):
            rec["poisoned"] = poisoned(role())
            return fn()

        r._resolve_batch = resolve
        r._finish_batch = finish
        cs.dispatch_chunk = dispatch
        if hasattr(cs, "cut_bytes"):
            record_cuts(cs, rec)
        if hasattr(cs, "_step"):  # the single-device engine's eager step
            def step(batch, fn=cs._step):
                rec["eager_steps"] += 1
                return fn(batch)
            cs._step = step
        r.shutdown = shutdown

    def install():
        resolver_mod.Resolver.__init__ = recorded_init

    def remove():
        resolver_mod.Resolver.__init__ = init
    hook.install, hook.remove = install, remove
    return hook


def record_cuts(cs, rec):
    """Records a sharded engine's partition into `rec`: its cuts when
    recorded (`cuts0`), each re-cut as (version, cuts) in the order the
    engine made them (`recuts`), and the cuts each batch was decided
    under, by version (`cuts`)."""
    rec["cuts0"], rec["recuts"], rec["cuts"] = list(cs.cut_bytes), [], {}

    def rebalance_cuts(new_cut_bytes, at_version, fn=cs.rebalance_cuts):
        rec["recuts"].append((at_version, list(new_cut_bytes)))
        return fn(new_cut_bytes, at_version)

    def detect_async(txns, commit_version, fn=cs.detect_async):
        handle = fn(txns, commit_version)
        rec["cuts"][commit_version] = list(cs.cut_bytes)
        return handle
    cs.rebalance_cuts = rebalance_cuts
    cs.detect_async = detect_async


def recut_oracles(oracles, old_cuts, new_cuts, version):
    """The clipped-oracle model through the sharded engine's
    `rebalance_cuts(new_cuts, version)`: shard d keeps its history where
    its new range overlaps its old one, and the rest of its new range
    (all of it where they do not overlap) is filled at `version`, the
    conservative value that makes a read older than the re-cut
    conflict."""
    n = len(oracles)

    def hi_of(cuts, d):
        return cuts[d + 1] if d + 1 < n else None

    def below(a, b):  # a < b, None the top of the keyspace
        return a is not None and (b is None or a < b)

    def fill(oracle, lo, hi):
        if not below(lo, hi):
            return
        if hi is not None:
            oracle.add_range(lo, hi, version)
            return
        oracle._ensure_boundary(lo)
        i = oracle._seg_of(lo)
        oracle.vals[i:] = [max(v, version) for v in oracle.vals[i:]]
    for d, oracle in enumerate(oracles):
        lo, hi = new_cuts[d], hi_of(new_cuts, d)
        a = max(lo, old_cuts[d])
        old_hi = hi_of(old_cuts, d)
        b = hi if below(hi, old_hi) or hi == old_hi else old_hi
        if below(a, b):
            fill(oracle, lo, a)
            fill(oracle, b, hi)
        else:
            fill(oracle, lo, hi)


def replay_into_oracles(hook, clipped=False):
    """Every batch each recorded resolver decided, replayed in version
    order into a fresh OracleConflictSet from that resolver's recovery
    version: (batches, mismatches, gaps); each record gains its backend,
    device, poison, decided and undecided batches and chunks. With
    `clipped`, a sharded engine's batches go to the clipped-oracle model
    (`shard_oracle_detect`, one oracle a shard) from its recorded cuts,
    each recorded re-cut applied to the model (`recut_oracles`) before the
    batch it came with, so the batches after a re-cut are held too; a
    batch the engine decided under other cuts than the model's counts as
    a mismatch. The record gains `recuts_replayed` and `after_recut`, the
    batches replayed after the first re-cut."""
    from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
    batches = mismatches = gaps = 0
    for rec, role in zip(hook.instances, hook.roles):
        reqs, got = rec["requests"], rec["replies"]
        order = sorted(reqs)
        if sorted(got) != order[:len(got)]:
            gaps += 1
        cuts = rec.get("cuts") if clipped else None
        now = rec["cuts0"] if cuts is not None else [b""]
        recuts = list(rec.get("recuts", ())) if cuts is not None else []
        oracles = [OracleConflictSet(oldest_version=rec["recovery_version"])
                   for _ in now]
        rec["after_recut"] = rec["recuts_replayed"] = 0
        for version in sorted(got):
            txns = reqs[version].transactions
            while recuts and recuts[0][0] <= version:
                at, new = recuts.pop(0)
                recut_oracles(oracles, now, new, at)
                now = new
                rec["recuts_replayed"] += 1
            if cuts is None:
                want = oracles[0].detect(txns, version)
            else:
                want = shard_oracle_detect(oracles, now, txns, version)
                mismatches += cuts.get(version, now) != now
                rec["after_recut"] += rec["recuts_replayed"] > 0
            mismatches += got[version] != want
            batches += 1
        r = role()
        if r is not None:
            rec["poisoned"] = hook.poisoned(r)
            rec["backend"] = r.conflict_set.backend_label
        rec["decided_batches"] = len(got)
        rec["undecided_batches"] = len(reqs) - len(got)
        rec["chunks"] = sum(rec["buckets"].values())
    return batches, mismatches, gaps


def recovery_phase(dev, seed, n_nodes=CYCLE_NODES, n_rotators=CYCLE_ROTATORS,
                   n_txns=CYCLE_TXNS, kills=RECOVERY_KILLS, knobs=None):
    """Phase 10: the port's RecoverableCluster (3 coordinators, 5 workers,
    2 proxies, 2 resolvers, 2 tlogs, 2 storage servers) with its resolvers'
    engines on `dev`, serving 9b's Cycle (`n_nodes` keys over both
    resolvers' and both storage servers' ranges, `n_rotators` actors of
    `n_txns` rotations through `db.transact`) while `kills` takes out, once
    its number of rotations has committed, the worker that hosts the
    current generation's first resolver, then the elected cluster
    controller. Every Resolver the cluster controllers recruit is recorded
    (its process, its recovery version, its build) and probed as in phase
    9. Checks: at least two recoveries (final epoch >= 3); the ring holds
    through a transaction and on every storage replica; every rotation
    decided; every batch each resolver of each generation decided equal to
    a fresh OracleConflictSet from that resolver's recovery version; no
    poison; every chunk converged; on the card every chunk through its
    bucket's graph (no eager step) and the step kernels once a resolver
    step, net of the launches the recruited resolvers' graph captures
    made."""
    import gc
    import random

    import torch

    from foundationdb_tpu_torch.core.future import all_of
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.conflict import kernel_metrics
    from foundationdb_tpu_torch.server.cluster import RecoverableCluster
    from foundationdb_tpu_torch.utils import trace
    from foundationdb_tpu_torch.utils.errors import FDBError
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    cuda = dev.type == "cuda"
    KNOBS.reset()
    KNOBS.overrides(CONFLICT_BACKEND="device", CONFLICT_DEVICE=str(dev),
                    **(knobs or {}))
    rnd = random.Random(seed)
    c = RecoverableCluster(seed, n_coordinators=3, n_workers=5, n_proxies=2,
                           n_resolvers=2, n_tlogs=2, n_storage=2)
    db = c.database()
    recovered: list = []  # (epoch, virtual s, wall s) of each CCRecovered
    events: list = []  # what triggered each recovery, and failed attempts

    def sink(fields):
        kind = fields.get("Type")
        if kind == "CCRecovered":
            recovered.append((fields["Epoch"], c.loop.now(),
                              time.perf_counter()))
        if kind in ("CCRecovered", "CCRecoveryTriggered", "CCRecoveryFailed"):
            events.append([kind, fields.get("ID"), round(c.loop.now(), 6),
                           fields.get("Epoch", fields.get(
                               "Reason", fields.get("Detail")))])
    trace.set_sink(sink)

    # every Resolver the cluster controllers recruit, probed as phase 9
    # probes its resolvers
    hook = record_resolvers(kernels)
    instances, build_launches = hook.instances, hook.build_launches

    def key(i):
        return bytes([i * 251 % 256]) + b"/cycle/%04d" % i

    async def setup(tr):
        for i in range(n_nodes):
            tr.set(key(i), b"%04d" % ((i + 1) % n_nodes))

    tries = [0]
    done = [0]
    outcomes: dict = {}

    def count(name):
        outcomes[name] = outcomes.get(name, 0) + 1

    async def rotate(tr):
        if "commit" not in vars(tr):  # each attempt's commit outcome
            async def commit(fn=tr.commit):
                try:
                    await fn()
                except FDBError as e:
                    count(e.name)
                    raise
                count("committed")
            tr.commit = commit
        tries[0] += 1
        try:
            a = key(rnd.randrange(n_nodes))
            b_idx = int(await tr.get(a))
            b = key(b_idx)
            c_idx = int(await tr.get(b))
            cc = key(c_idx)
            d_idx = int(await tr.get(cc))
        except FDBError as e:
            count(e.name)
            raise
        tr.set(a, b"%04d" % c_idx)
        tr.set(b, b"%04d" % d_idx)
        tr.set(cc, b"%04d" % b_idx)

    async def rotator():
        for _ in range(n_txns):
            await db.transact(rotate, max_retries=500)
            done[0] += 1

    def footprint():
        """Live device bytes, unreachable roles collected first."""
        if not cuda:
            return None
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    recoveries: list = []

    async def killer():
        for at, what in kills:
            while done[0] < at:
                await c.loop.delay(0.01)
            cc = c.current_cc()
            while cc is None:
                await c.loop.delay(0.01)
                cc = c.current_cc()
            info = cc.dbinfo
            victim = (info.resolvers[0] if what == "resolver"
                      else cc.process.address)
            r = {"kill": what, "victim": victim, "epoch_before": info.epoch,
                 "rotations_before": done[0], "killed_virtual_s": c.loop.now()}
            t0 = time.perf_counter()
            n_seen = len(recovered)
            c.net.kill(victim)
            while True:
                new = [e for e in recovered[n_seen:] if e[0] > info.epoch]
                if new:
                    break
                await c.loop.delay(0.01)
            epoch, at_virtual, at_wall = new[0]
            r.update({"epoch_after": epoch,
                      "virtual_s": at_virtual - r["killed_virtual_s"],
                      "wall_s": at_wall - t0,
                      "memory_allocated": footprint()})
            recoveries.append(r)

    async def load():
        await db.refresh()
        await db.transact(setup)

    hook.install()
    rebases = [0]
    rebase = ref.rebase_state

    def counted_rebase(*a, **kw):
        rebases[0] += 1
        return rebase(*a, **kw)
    try:
        c.run(c.loop.spawn(load()), max_time=1e9)
        generations = [{"epoch": c.current_cc().dbinfo.epoch,
                        "memory_allocated": footprint()}]
        ref.rebase_state = counted_rebase
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        counted = ("KernelDispatches", "UnconvergedChunks")
        before = {k: kernel_metrics.as_dict()[k] for k in counted}
        for k in build_launches:
            build_launches[k] = 0
        for rec in instances:
            rec["buckets"].clear()
        kernels.reset_launches()
        v0 = c.loop.now()
        t0 = time.perf_counter()
        c.run(all_of([c.loop.spawn(rotator(), name=f"rot{i}")
                      for i in range(n_rotators)]
                     + [c.loop.spawn(killer(), name="killer")]),
              max_time=1e9)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        run_builds = dict(build_launches)
        chunks, unconverged = (kernel_metrics.as_dict()[k] - before[k]
                               for k in counted)
        virtual = c.loop.now() - v0
        for rec in instances:  # the run's chunks (the reads below add more)
            rec["buckets"] = dict(rec["buckets"])

        async def read_ring():
            async def read(tr):
                return await tr.get_many([key(i) for i in range(n_nodes)])
            ring = await db.transact(read, max_retries=500)
            while c.current_cc() is None:  # a recovery still under way
                await c.loop.delay(0.01)
            return ring, c.current_cc().dbinfo
        ring, info = c.run(c.loop.spawn(read_ring()), max_time=1e9)
        ring = [int(v) for v in ring]
        replicas = [storage_replicas(c, info, key(i)) for i in range(n_nodes)]
        final_epoch = info.epoch
        final_footprint = footprint()
    finally:
        hook.remove()
        ref.rebase_state = rebase
        trace.set_sink(None)
    generations += [{"epoch": r["epoch_after"],
                     "memory_allocated": r["memory_allocated"]}
                    for r in recoveries]
    if final_epoch != generations[-1]["epoch"]:  # a recovery no kill made
        generations.append({"epoch": final_epoch,
                            "memory_allocated": final_footprint})

    seen, i = set(), 0
    for _ in range(n_nodes):
        seen.add(i)
        i = ring[i]
    ring_holds = i == 0 and len(seen) == n_nodes
    replicas_equal = all(all(int(v) == ring[n] for v in vals) and vals
                         for n, vals in enumerate(replicas))

    # every batch each recruited resolver decided, replayed in version
    # order into a fresh oracle from that resolver's recovery version
    t1 = time.perf_counter()
    batches, mismatches, gaps = replay_into_oracles(hook)
    oracle_s = time.perf_counter() - t1
    committed = n_rotators * n_txns
    out = {
        "phase": "10", "wall_s": wall, "virtual_s": virtual,
        "nodes": n_nodes, "rotators": n_rotators, "txns_per_rotator": n_txns,
        "attempts": tries[0], "committed": done[0],
        "attempts_per_wall_s": tries[0] / wall, "outcomes": outcomes,
        "commit_unknown_results": outcomes.get("commit_unknown_result", 0),
        "recoveries": recoveries, "final_epoch": final_epoch,
        "recovery_events": events,
        "generations": generations,
        "peak_device_bytes": torch.cuda.max_memory_allocated() if cuda
        else None,
        "resolvers": [{k: rec[k] for k in (
            "process", "recovery_version", "built_at_virtual_s", "build_s",
            "buckets", "chunks", "decided_batches", "undecided_batches",
            "ungraphed_chunks", "eager_steps", "poisoned")}
            for rec in instances],
        "chunks": chunks, "unconverged_chunks": unconverged,
        "rebases": rebases[0], "launches": launches,
        "build_launches": run_builds, "resolved_batches": batches,
        "mismatched_batches": mismatches, "oracle_s": oracle_s,
        "ring_holds": ring_holds, "storage_equals_client": replicas_equal}
    log("phase 10: " + json.dumps(out))
    if final_epoch < 3 or len(recoveries) < len(kills):
        fail(f"phase 10: {len(recoveries)} recoveries, final epoch "
             f"{final_epoch} (want at least 3)")
    if done[0] != committed:
        fail(f"phase 10: {done[0]} of {committed} rotations decided")
    if not ring_holds:
        fail(f"phase 10: the ring broke: {len(seen)} nodes from 0, back at "
             f"{i}")
    if not replicas_equal:
        fail("phase 10: a storage replica's ring differs from the one read "
             "through a transaction")
    if gaps:
        fail(f"phase 10: {gaps} resolvers left a received batch undecided "
             f"before one they decided")
    if mismatches:
        fail(f"phase 10: {mismatches} of {batches} resolver replies differ "
             f"from the oracle")
    if any(rec["poisoned"] for rec in instances):
        fail("phase 10: a resolver's conflict state poisoned")
    if unconverged:
        fail(f"phase 10: {unconverged} of {chunks} chunks did not converge "
             f"on the device")
    if sum(rec["chunks"] for rec in instances) != chunks:
        fail(f"phase 10: the resolvers' {sum(r['chunks'] for r in instances)}"
             f" chunks are not the engine's {chunks}")
    if len({rec["recovery_version"] for rec in instances
            if rec["chunks"]}) < 3:
        fail("phase 10: fewer than three generations of resolvers decided "
             "a chunk")
    if cuda:
        if any(rec["device"].split(":")[0] != "cuda" for rec in instances):
            fail("phase 10: a resolver is not on the card")
        eager = sum(rec["eager_steps"] + rec["ungraphed_chunks"]
                    for rec in instances)
        if eager:
            fail(f"phase 10: {eager} chunks ran outside a bucket graph")
        for k in STEP_KERNELS:
            if launches[k] - run_builds[k] != chunks:
                fail(f"phase 10: {launches[k]} {k} launches, "
                     f"{run_builds[k]} of them the recruited resolvers' "
                     f"captures, for {chunks} resolver steps")
        if launches["rebase_table"] - run_builds["rebase_table"] \
                != rebases[0]:
            fail(f"phase 10: {launches['rebase_table']} rebase launches for "
                 f"{rebases[0]} rebases")
    return out


# phase 11: the randomized harness's fast tier. Each fast spec on a seed
# whose draw under SIM_BACKENDS fits the spec's needs (picked on the CPU,
# as tests/test_sim_tiers.py pins its pairs); the comments are the port's
# `ClusterDraw.draw(seed, allow_backends=SIM_BACKENDS)`: replication,
# engine, backend, the evaluator knobs its buggified subset sets
SIM_BACKENDS = ("device", "sharded")
SIM_RUNS = (
    ("cycle", 25),                 # double/memory/device, legacy
    ("fuzz-api", 13),              # double/redwood/device, ENCODE_RING=0
    ("zipfian-hotkey", 2),         # single/memory/device, INTRA_ROUNDS=1
    ("zipfian-read-hotspot", 38),  # single/ssd/device, legacy
    ("serializability", 3),        # two_region/redwood/device, legacy,
                                   # HOTSPOT_MAX_BUCKETS=16
    ("ryow", 7),                   # double/memory/sharded
    ("conflict-range", 20),        # single/redwood/device, legacy,
                                   # INTRA_ROUNDS=1
    ("change-config", 0),          # single/ssd/device, 2 resolvers
    ("remove-servers", 9),         # double/ssd/sharded, a spare
    ("kill-region", 28),           # two_region/memory/device,
                                   # INTRA_ROUNDS=1, ENCODE_RING=0
)
# 11b: Cycle, ConsistencyCheck, RandomClogging and Attrition on seed 131's
# double/redwood/device draw (1 proxy, 2 resolvers, 1 tlog, 2 storage
# servers x 2 replicas; the scan evaluator), its engine raised by the
# spec's knobs to the default width, cells A's, 9a's and 10's: K=65,536,
# T=1,024, 4 reads and 4 writes a txn
SIM_WIDE = ("cycle", 131, (("CONFLICT_STATE_CAPACITY", 1 << 16),
                          ("CONFLICT_BATCH_TXNS", 1024),
                          ("CONFLICT_BATCH_READS_PER_TXN", 4),
                          ("CONFLICT_BATCH_WRITES_PER_TXN", 4)))
# each device draw's SpecResult (rotations, epochs, virtual end time) as
# the port computes it on the CPU at the run's own knobs
# (tests/test_torch_sim_phase11.py holds these to the port's and the JAX
# package's CPU runs); the card must repeat them
SIM_EXPECTED = {
    ("cycle", 25): (487, 1, 153.3022760885728),
    ("fuzz-api", 13): (117, 5, 154.95497356039127),
    ("zipfian-hotkey", 2): (0, 3, 34.636478596596326),
    ("zipfian-read-hotspot", 38): (0, 1, 147.9491943818923),
    ("serializability", 3): (0, 2, 153.0101215492871),
    ("conflict-range", 20): (0, 1, 149.52004355343996),
    ("change-config", 0): (408, 3, 31.153917466907107),
    ("kill-region", 28): (18, 4, 160.58299605360017),
    ("cycle", 131): (210, 3, 30.621630577581907),
    # 12c (BACKUP_SIM): epochs -1, no cluster controller elected when the
    # run ends (Attrition's last kill), as in the JAX harness
    ("backup-attrition", 131): (219, -1, 44.6577044581421),
}
# the step kernels each evaluator launches once a step; the sharded engine
# adds K10 and K11 once a chunk
EVALUATOR_KERNELS = {
    "scan": STEP_KERNELS,
    "legacy": tuple(k for k in STEP_KERNELS
                    if k not in ("intra_levels", "intra_sandwich"))
    + ("legacy_blocked",),
}


def sim_spec(name, knobs=()):
    """The harness's spec `name`, with `knobs` applied after its own (and
    so after the draw's, as run_randomized_spec applies a spec's)."""
    import dataclasses

    from foundationdb_tpu_torch.testing import simulated_cluster as SC
    spec = SC.SPECS[name]
    return dataclasses.replace(spec, knobs=spec.knobs + tuple(knobs)) \
        if knobs else spec


def recorded_run(dev, body):
    """Run `body(note)` with every Resolver built during it recorded
    (`record_resolvers`) and every kernel count, the chunk and rebase
    counts zeroed before it and read after it. `note()` records each live
    recorded resolver's poison and backend: a body that drops clusters
    calls it first. Returns (what `body` returned, the run's counts: the
    hook, wall s, launches, launches net of the builds' `net`, the served
    chunks, the unconverged chunks and the rebases)."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.conflict import kernel_metrics

    hook = record_resolvers(kernels)
    rebases = [0]
    rebase = ref.rebase_state

    def counted_rebase(*a, **kw):
        rebases[0] += 1
        return rebase(*a, **kw)

    def note():
        for rec, role in zip(hook.instances, hook.roles):
            r = role()
            if r is not None:
                rec["poisoned"] = hook.poisoned(r)
                rec["backend"] = r.conflict_set.backend_label
    counted = ("KernelDispatches", "UnconvergedChunks")
    before = {k: kernel_metrics.as_dict()[k] for k in counted}
    kernels.reset_launches()
    hook.install()
    ref.rebase_state = counted_rebase
    t0 = time.perf_counter()
    try:
        value = body(note)
    finally:
        hook.remove()
        ref.rebase_state = rebase
        if dev.type == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    dispatched, unconverged = (kernel_metrics.as_dict()[k] - before[k]
                               for k in counted)
    return value, argparse.Namespace(
        hook=hook, wall_s=wall, launches=launches,
        net={k: launches[k] - hook.build_launches[k] for k in launches},
        chunks=dispatched - hook.build_chunks, unconverged=unconverged,
        rebases=rebases[0])


def resolver_failures(where, dev, run, run_kernels, may_stop=False):
    """Every batch each recorded resolver of `run` (recorded_run's counts)
    decided, replayed into a fresh oracle, and the checks phases 11 and 12
    hold a run to: no batch different from the oracle, none received and
    left undecided before one decided, no poison, the resolvers' chunks
    the engines', no unconverged chunk (unless `may_stop`), every engine
    on `dev`; on the card every chunk through its graph, each kernel of
    `run_kernels` once a resolver step net of the builds' launches and no
    other step kernel, and the rebase kernel once a rebase. Returns
    (batches, mismatches, failures); each record gains its decided
    batches and chunks."""
    hook, chunks = run.hook, run.chunks
    batches, mismatches, gaps = replay_into_oracles(hook)
    failures = []
    if not hook.instances or not chunks:
        failures.append(f"{where}: no resolver decided a chunk")
    if gaps:
        failures.append(f"{where}: {gaps} resolvers left a received batch "
                        f"undecided before one they decided")
    if mismatches:
        failures.append(f"{where}: {mismatches} of {batches} resolver "
                        f"replies differ from the oracle")
    if any(rec["poisoned"] for rec in hook.instances):
        failures.append(f"{where}: a resolver's conflict state poisoned")
    if sum(rec["chunks"] for rec in hook.instances) != chunks:
        failures.append(f"{where}: the resolvers' chunks are not the "
                        f"engines' {chunks}")
    if run.unconverged and not may_stop:
        failures.append(f"{where}: {run.unconverged} of {chunks} chunks did "
                        f"not converge")
    if any(rec["device"].split(":")[0] != dev.type
           for rec in hook.instances):
        failures.append(f"{where}: an engine is not on {dev}")
    if dev.type == "cuda":
        eager = sum(rec["eager_steps"] + rec["ungraphed_chunks"]
                    for rec in hook.instances)
        if eager:
            failures.append(f"{where}: {eager} chunks ran outside a graph")
        for k in run_kernels:
            if run.net[k] != chunks:
                failures.append(f"{where}: {run.net[k]} {k} launches net of "
                                f"the captures' for {chunks} resolver steps")
        for k in set(STEP_KERNELS + SHARD_KERNELS
                     + ("legacy_blocked",)) - set(run_kernels):
            if run.launches[k]:
                failures.append(f"{where}: {k} launched {run.launches[k]} "
                                f"times outside the run's evaluator")
        if run.net["rebase_table"] != run.rebases:
            failures.append(f"{where}: {run.net['rebase_table']} rebase "
                            f"launches for {run.rebases} rebases")
    return batches, mismatches, failures


RESOLVER_FIELDS = ("process", "recovery_version", "built_at_virtual_s",
                   "build_s", "device", "backend", "buckets", "chunks",
                   "decided_batches", "undecided_batches",
                   "ungraphed_chunks", "eager_steps", "poisoned")


def sim_run(dev, name, seed, knobs=(), expected=None):
    """One run of phase 11: `run_randomized_spec(seed, spec)` under
    SIM_BACKENDS with the engines on `dev`, every Resolver the cluster
    controllers recruit recorded (`recorded_run`). Returns the run's
    record and its failures (strings)."""
    from foundationdb_tpu_torch.testing import simulated_cluster as SC
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    spec = sim_spec(name, knobs)
    draw = SC.ClusterDraw.draw(seed, allow_backends=SIM_BACKENDS)
    drawn = dict(draw.knobs)
    drawn.update(spec.knobs)
    mode = drawn.get("CONFLICT_INTRA_MODE", KNOBS._defs[
        "CONFLICT_INTRA_MODE"].default)
    KNOBS.reset()
    KNOBS.set("CONFLICT_DEVICE", str(dev))

    def body(_note):
        try:
            return SC.run_randomized_spec(seed, spec=spec,
                                          allow_backends=SIM_BACKENDS), []
        except SC.SpecFailure as e:
            return None, [f"{name} seed {seed}: {e}"]
    (result, failures), run = recorded_run(dev, body)
    run_kernels = EVALUATOR_KERNELS[mode] + (
        SHARD_KERNELS if draw.conflict_backend == "sharded" else ())
    # a chunk may stay unconverged only where the draw cuts the scan
    # sandwich to one round on the single-device engine (which then takes
    # its exact host pass); the sharded engine runs full rounds
    may_stop = (draw.conflict_backend == "device" and mode == "scan"
                and drawn.get("CONFLICT_INTRA_ROUNDS") == 1)
    where = f"{name} seed {seed}"
    batches, mismatches, bad = resolver_failures(where, dev, run,
                                                 run_kernels, may_stop)
    failures += bad
    out = {
        "spec": name, "seed": seed, "summary": draw.summary(),
        "repro": draw.repro_line(name, spec.duration),
        "backend": draw.conflict_backend, "evaluator": mode,
        "spec_knobs": [list(kv) for kv in knobs],
        "result": None if result is None else [
            result.result.rotations, result.result.epochs,
            result.result.elapsed],
        "expected": None if expected is None else list(expected),
        "wall_s": run.wall_s, "chunks": run.chunks,
        "unconverged_chunks": run.unconverged, "rebases": run.rebases,
        "launches": run.launches,
        "build_launches": dict(run.hook.build_launches),
        "resolved_batches": batches, "mismatched_batches": mismatches,
        "resolvers": [{k: rec.get(k) for k in RESOLVER_FIELDS}
                      for rec in run.hook.instances],
        "memory_allocated": None}
    if result is not None and expected is not None \
            and out["result"] != list(expected):
        failures.append(f"{where}: SpecResult {out['result']}, the CPU's "
                        f"{list(expected)}")
    return out, failures


def collected_memory(dev):
    """`torch.cuda.memory_allocated` once what is unreachable is collected
    (None on the CPU). A dropped cluster's cycles hold finalizers: the
    first collection runs them, a later one frees what they held."""
    import gc

    import torch

    while gc.collect():
        pass
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def sim_phase(dev, runs=SIM_RUNS, wide=SIM_WIDE):
    """Phase 11: the port's randomized simulation harness with its
    resolvers' engines on `dev`. 11a: `run_randomized_spec` for each of
    `runs` ((spec, seed) pairs; by default the ten fast specs) with
    allow_backends=SIM_BACKENDS at the harness's own engine shape
    (_ACCEL_FAST_SHAPE: T=16, 2 reads and 2 writes a txn, K=2,048). 11b:
    `wide` (spec, seed, knobs), the Cycle spec with its engine raised to
    the default width. For every run: the spec's own checks pass (a
    SpecFailure fails the phase with its repro line); every batch each
    recruited Resolver decided equals a fresh OracleConflictSet from its
    recovery version (a sharded draw runs one shard a card, so the oracle
    is the clipped-oracle model there); nothing poisons; every engine is
    on `dev`; on the card every chunk runs through its graph, the draw's
    evaluator's step kernels (and K10, K11 on a sharded draw) launch once a
    resolver step, net of the recruited resolvers' captures, and the
    rebase kernel once a rebase; no chunk stays unconverged unless the
    draw cuts the scan sandwich to one round; and each device draw's
    SpecResult equals SIM_EXPECTED's (the port's CPU runs). Sharded draws
    (two shards on the CPU, one on one card) are not held to it: per-shard
    "earlier txns win" may abort other txns at another width."""
    from foundationdb_tpu_torch.testing import simulated_cluster as SC
    from foundationdb_tpu_torch.utils import trace
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    todo = [(name, seed, ()) for name, seed in runs]
    if wide is not None:
        todo.append(wide)
    trace.set_sink(lambda _fields: None)
    out: list = []
    failures: list = []
    try:
        for name, seed, knobs in todo:
            draw = SC.ClusterDraw.draw(seed, allow_backends=SIM_BACKENDS)
            want = SIM_EXPECTED.get((name, seed)) \
                if draw.conflict_backend == "device" else None
            run, bad = sim_run(dev, name, seed, knobs, want)
            run["memory_allocated"] = collected_memory(dev)
            log(f"phase 11 {name} seed {seed}: " + json.dumps({
                k: run[k] for k in (
                    "summary", "repro", "result", "wall_s", "chunks",
                    "unconverged_chunks", "resolvers", "memory_allocated")}))
            out.append(run)
            failures += bad
    finally:
        trace.set_sink(None)
        KNOBS.reset()
    summary = {"phase": "11", "runs": out,
               "wall_s": sum(r["wall_s"] for r in out),
               "chunks": sum(r["chunks"] for r in out),
               "launches": {k: sum(r["launches"][k] for r in out)
                            for k in out[0]["launches"]}}
    log("phase 11: " + json.dumps({k: summary[k] for k in (
        "wall_s", "chunks")}))
    if failures:
        fail("phase 11: " + "; ".join(failures))
    return summary


# ---------------------------------------------------------------------------
# phase 12: backup, restore and DR, every cluster's resolvers on the card
# ---------------------------------------------------------------------------

BACKUP_KEYS = 20_000  # cell A's keys, loaded as 9a loads them
BACKUP_CLIENTS = 256
BACKUP_ATTEMPTS = 20
BACKUP_CHUNKS = 8
BACKUP_CLI_ROWS = 25  # fdbcli's getrange default limit
# 12c: the backup-attrition spec on seed 131's double/redwood/device draw
# at cell A's width (SIM_WIDE's knobs): at the harness's own engine shape
# (16 txns x 2 writes a batch) the spec's 40-key setup transaction is
# transaction_too_large in both packages
BACKUP_SIM = ("backup-attrition", 131, SIM_WIDE[2])


def backup_run(name, dev, knobs, body):
    """One run of phase 12 (12a or 12b): `body(note)` (a function that
    boots its clusters at the port's default knobs with
    CONFLICT_BACKEND=device on `dev`, `knobs` over them, and returns the
    run's numbers and its failures) through `recorded_run`, held to
    `resolver_failures` with the scan evaluator's kernels; then its
    clusters are collected and `torch.cuda.memory_allocated` read.
    Returns (record, failures)."""
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    KNOBS.reset()
    KNOBS.overrides(CONFLICT_BACKEND="device", CONFLICT_DEVICE=str(dev),
                    **(knobs or {}))
    try:
        (out, failures), run = recorded_run(dev, body)
    finally:
        KNOBS.reset()
    batches, mismatches, bad = resolver_failures(f"phase {name}", dev, run,
                                                 STEP_KERNELS)
    out.update({
        "phase": name, "wall_s": run.wall_s, "chunks": run.chunks,
        "unconverged_chunks": run.unconverged, "rebases": run.rebases,
        "launches": run.launches,
        "build_launches": dict(run.hook.build_launches),
        "resolved_batches": batches, "mismatched_batches": mismatches,
        "resolvers": [{k: rec.get(k) for k in RESOLVER_FIELDS}
                      for rec in run.hook.instances]})
    del run, body
    out["memory_allocated"] = collected_memory(dev)
    return out, failures + bad


async def user_rows_at(db, version=None):
    """Every user row, read through one transaction (at `version` when
    given)."""
    async def read(tr):
        if version is not None:
            tr.set_read_version(version)
        return await tr.get_range(b"", b"\xff")
    return [tuple(kv) for kv in await db.transact(read, max_retries=500)]


def mix_failures(where, outcomes, attempts):
    """An attempt ends committed or rejected by a resolver; nothing else."""
    bad = []
    if sum(outcomes.values()) != attempts:
        bad.append(f"{where}: {sum(outcomes.values())} outcomes for "
                   f"{attempts} attempts")
    unknown = set(outcomes) - {"committed", *CLUSTER_REJECTIONS}
    if unknown:
        bad.append(f"{where}: attempts ended in {sorted(unknown)}")
    if not outcomes.get("committed"):
        bad.append(f"{where}: no attempt committed: {outcomes}")
    return bad


def backup_restore_phase(dev, seed, n_keys=BACKUP_KEYS,
                         n_clients=BACKUP_CLIENTS,
                         n_attempts=BACKUP_ATTEMPTS, chunks=BACKUP_CHUNKS,
                         knobs=None):
    """12a: a SimCluster (2 proxies, 2 resolvers, 2 tlogs, 2 storage
    servers) loaded with `n_keys` of cell A's keys, backed up by a
    BackupAgent (`chunks` snapshot chunks, and its log tailer) into a
    BlobStoreBackupContainer on a BlobStoreServer at 127.0.0.1 while
    `n_clients` clients make `n_attempts` attempts each of cell A's mix;
    the first half of each client's attempts runs beside the snapshot;
    then a marker commit fixes a point-in-time version, the second half
    starts and the source's rows are read through a transaction at that
    version; when the clients are done the backup stops and the rows are
    read at its end version. Restored into a fresh
    SimCluster (1 proxy, 1 resolver) on the same loop and network, to the
    end version and then to the point in time, each equal to the source's
    rows at that version byte for byte; then into a RecoverableCluster on
    its own loop (one resolver), where fdbcli's `status` reports the
    recovered cluster and its `getrange` prints the source's first rows."""
    from foundationdb_tpu_torch.backup import BackupAgent, RestoreAgent
    from foundationdb_tpu_torch.backup.container import (
        BlobStoreBackupContainer)
    from foundationdb_tpu_torch.net.http import BlobStoreServer
    from foundationdb_tpu_torch.server.cluster import (RecoverableCluster,
                                                       SimCluster)
    from foundationdb_tpu_torch.tools.fdbcli import FdbCli, _fmt_key

    keys, picks = ycsb_traffic(seed, n_keys, n_clients, n_attempts)
    attempts = n_clients * n_attempts

    def body(note):
        srv = BlobStoreServer("127.0.0.1")
        try:
            return run(srv, note)
        finally:
            srv.close()

    def run(srv, note):
        failures: list = []
        out: dict = {"keys": n_keys, "clients": n_clients,
                     "attempts_per_client": n_attempts, "attempts": attempts,
                     "snapshot_chunks_asked": chunks}
        src = SimCluster(seed, n_proxies=2, n_resolvers=2, n_tlogs=2,
                         n_storage=2)
        db = src.database()
        t0 = time.perf_counter()
        src.run(src.loop.spawn(ycsb_load(src, db, keys)), max_time=1e9)
        out["load_s"] = time.perf_counter() - t0
        container = BlobStoreBackupContainer(srv.url)
        agent = BackupAgent(db, container, chunks=chunks)
        drained = [0]
        drain_log = agent.drain_log

        async def counted_drain(limit=500):
            moved = await drain_log(limit)
            drained[0] += moved
            return moved
        agent.drain_log = counted_drain
        outcomes: dict = {}
        pit: dict = {}
        half = n_attempts // 2

        async def backup():
            await agent.start()
            snapshot = src.loop.spawn(agent.run_agent(), name="bkAgent")
            tailer = src.loop.spawn(agent.run_log_tailer(), name="bkTailer")
            # the first half of every client's attempts beside the
            # snapshot; then the point in time, and the second half
            await ycsb_mix(src, db, keys, picks[:, :half], outcomes)
            await snapshot
            marker = [None]

            async def fence(tr):
                marker[0] = tr
                tr.set(b"\xff/pit-fence", b"x")
            await db.transact(fence, max_retries=500)
            pit["version"] = marker[0].committed_version
            rest = src.loop.spawn(ycsb_mix(src, db, keys, picks[:, half:],
                                             outcomes, half), name="bkMix")
            pit["rows"] = await user_rows_at(db, pit["version"])
            await rest
            end_version = await agent.stop()
            await tailer
            return end_version, await user_rows_at(db, end_version)

        t0 = time.perf_counter()
        end_version, truth = src.run(src.loop.spawn(backup()), max_time=1e9)
        out["backup_s"] = time.perf_counter() - t0
        failures += mix_failures("phase 12a", outcomes, attempts)
        out.update({
            "outcomes": outcomes, "committed": outcomes.get("committed", 0),
            "committed_per_wall_s": outcomes.get("committed", 0)
            / out["backup_s"],
            "end_version": end_version, "pit_version": pit["version"],
            "rows_at_end": len(truth), "rows_at_pit": len(pit["rows"]),
            "snapshot_chunks": len(container.list_files("kvrange-")),
            "log_files": len(container.list_files("log-")),
            "log_rows_drained": drained[0]})
        applied = sum(
            len(entries) for entries in (
                container.read_file(n) for n in container.list_files("log-")))
        out["log_entries"] = applied
        if truth == pit["rows"]:
            failures.append("phase 12a: no write landed between the point "
                            "in time and the end version")

        dst = SimCluster(seed + 1, n_proxies=1, n_resolvers=1, n_tlogs=1,
                         n_storage=1, loop=src.loop, net=src.net,
                         name_prefix="restore-")
        ddb = dst.database("clientR:0")

        async def restore(target):
            applied = await RestoreAgent(ddb, container).restore(
                target_version=target)
            return applied, await user_rows_at(ddb)
        restores = {}
        for label, target, want in (("end", None, truth),
                                    ("pit", pit["version"], pit["rows"])):
            t0 = time.perf_counter()
            applied, got = src.run(src.loop.spawn(restore(target)),
                                   max_time=1e9)
            restores[label] = {"wall_s": time.perf_counter() - t0,
                               "mutations_applied": applied,
                               "rows": len(got), "equal": got == want}
            if got != want:
                failures.append(
                    f"phase 12a: the {label} restore differs from the "
                    f"source: {len(got)} rows against {len(want)}, "
                    f"{len(set(got) ^ set(want))} differing")
        out["restores"] = restores
        note()
        del src, dst, db, ddb

        # fdbcli on a restore into a RecoverableCluster: status needs an
        # elected cluster controller, which a SimCluster does not have
        rc = RecoverableCluster(seed + 2, n_resolvers=1)
        rdb = rc.database()

        async def restore_rc():
            await rdb.refresh()
            await RestoreAgent(rdb, container).restore()
        t0 = time.perf_counter()
        rc.run(rc.loop.spawn(restore_rc()), max_time=1e9)
        cli = FdbCli(rc, rdb)
        status = cli.execute("status")
        listed = cli.execute(f"getrange 0 z {BACKUP_CLI_ROWS}")
        out["fdbcli"] = {"wall_s": time.perf_counter() - t0,
                         "status": status, "getrange_lines": len(listed)}
        note()
        want = [f"`{_fmt_key(k)}' is `{v.decode(errors='replace')}'"
                for k, v in truth if b"0" <= k < b"z"][:BACKUP_CLI_ROWS]
        if not any("accepting_commits" in line for line in status) or \
                not any("Storage servers - 2" in line for line in status):
            failures.append(f"phase 12a: fdbcli status on the restored "
                            f"cluster: {status}")
        if listed[1:] != want:
            failures.append(f"phase 12a: fdbcli getrange printed "
                            f"{listed[:3]}..., the source's rows "
                            f"{want[:2]}...")
        log("phase 12a: " + json.dumps({k: out[k] for k in (
            "committed_per_wall_s", "snapshot_chunks", "log_rows_drained",
            "restores", "fdbcli")}))
        return out, failures

    return backup_run("12a", dev, knobs, body)


def dr_phase(dev, seed, n_keys=BACKUP_KEYS, n_clients=BACKUP_CLIENTS,
             n_attempts=BACKUP_ATTEMPTS, knobs=None):
    """12b: DR between two SimClusters on one loop and network, as
    tests/test_dr.py sets them up (the source with 2 proxies, 2 resolvers,
    2 tlogs and 2 storage servers; the destination with 1 proxy, 1
    resolver, 1 tlog, 2 storage servers): the source loaded as in 12a, a
    DRAgent's initial snapshot and its drain tail running while 12a's mix
    runs on the source, then `switchover` once the clients are done. The
    destination's user rows must equal the source's at the switchover
    version; afterwards the destination commits a user write, and the
    primary markers say the destination serves writes and the source no
    longer does. (The source keeps taking commits: neither package has a
    database lock, and the DR agent asks its caller to quiesce writers.)"""
    from foundationdb_tpu_torch.backup.dr import DR_PRIMARY, DRAgent
    from foundationdb_tpu_torch.core.eventloop import EventLoop
    from foundationdb_tpu_torch.core.sim import SimNetwork
    from foundationdb_tpu_torch.server.cluster import SimCluster
    from foundationdb_tpu_torch.utils.rng import DeterministicRandom

    keys, picks = ycsb_traffic(seed, n_keys, n_clients, n_attempts)
    attempts = n_clients * n_attempts

    def body(note):
        failures: list = []
        out: dict = {"keys": n_keys, "clients": n_clients,
                     "attempts_per_client": n_attempts, "attempts": attempts}
        loop = EventLoop()
        net = SimNetwork(loop, DeterministicRandom(seed).fork())
        a = SimCluster(seed, n_proxies=2, n_resolvers=2, n_tlogs=2,
                       n_storage=2, loop=loop, net=net, name_prefix="a-")
        b = SimCluster(seed + 1, n_storage=2, loop=loop, net=net,
                       name_prefix="b-")
        src = a.database("clientA:0")
        dst = b.database("clientB:0")
        t0 = time.perf_counter()
        a.run(loop.spawn(ycsb_load(a, src, keys)), max_time=1e9)
        out["load_s"] = time.perf_counter() - t0
        agent = DRAgent(src, dst)
        drained = [0]
        drain_once = agent.drain_once

        async def counted_drain(limit=200):
            moved = await drain_once(limit)
            drained[0] += moved
            return moved
        agent.drain_once = counted_drain
        outcomes: dict = {}

        async def replicate():
            await agent.start()
            t = time.perf_counter()
            v0 = await agent.initial_snapshot()
            out["snapshot_s"] = time.perf_counter() - t
            out["snapshot_version"] = v0
            tail = loop.spawn(agent.run(), name="drTail")
            t = time.perf_counter()
            await ycsb_mix(a, src, keys, picks, outcomes)
            out["mix_s"] = time.perf_counter() - t
            t = time.perf_counter()
            end_version = await agent.switchover()
            await tail
            out["switchover_s"] = time.perf_counter() - t
            truth = await user_rows_at(src, end_version)
            got = await user_rows_at(dst)

            async def primary(tr):
                return await tr.get(DR_PRIMARY)

            async def after(tr):
                tr.set(b"dr/after-switchover", b"x")
            await dst.transact(after, max_retries=100)
            note()
            return (end_version, truth, got,
                    await src.transact(primary), await dst.transact(primary),
                    await agent.applied_version(),
                    await user_rows_at(dst))

        t0 = time.perf_counter()
        (end_version, truth, got, src_primary, dst_primary, applied,
         later) = a.run(loop.spawn(replicate()), max_time=1e9)
        out["dr_s"] = time.perf_counter() - t0
        failures += mix_failures("phase 12b", outcomes, attempts)
        out.update({
            "outcomes": outcomes, "committed": outcomes.get("committed", 0),
            "committed_per_wall_s": outcomes.get("committed", 0)
            / out["mix_s"],
            "switchover_version": end_version, "applied_version": applied,
            "rows": len(truth), "equal": got == truth,
            "log_rows_drained": drained[0],
            "primary": {"source": src_primary, "destination": dst_primary}})
        if got != truth:
            failures.append(
                f"phase 12b: the destination differs from the source at the "
                f"switchover version: {len(got)} rows against {len(truth)}, "
                f"{len(set(got) ^ set(truth))} differing")
        if dict(later).get(b"dr/after-switchover") != b"x":
            failures.append("phase 12b: the destination did not commit after "
                            "the switchover")
        if (src_primary, dst_primary) != (b"remote", b"primary"):
            failures.append(f"phase 12b: primary markers {src_primary!r} on "
                            f"the source, {dst_primary!r} on the destination")
        if applied < out["snapshot_version"] or not drained[0]:
            failures.append(f"phase 12b: the drain applied to {applied} from "
                            f"{out['snapshot_version']}, {drained[0]} rows")
        log("phase 12b: " + json.dumps({k: out[k] for k in (
            "committed_per_wall_s", "snapshot_s", "switchover_s",
            "log_rows_drained", "equal")}))
        return out, failures

    return backup_run("12b", dev, knobs, body)


def backup_phase(dev, seed, backup=None, dr=None, sim=BACKUP_SIM):
    """Phase 12: 12a backup and restore, 12b DR, 12c the backup-attrition
    spec on a device draw at cell A's width (`sim_run`, its SpecResult held
    to SIM_EXPECTED); `backup` and `dr` are keyword arguments of 12a and
    12b (the CPU tests' small sizes). Each run drops its clusters before
    the next, and `torch.cuda.memory_allocated` after each must not grow
    past the first's. The roles' trace events are dropped."""
    from foundationdb_tpu_torch.utils import trace
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    cuda = dev.type == "cuda"
    trace.set_sink(lambda _fields: None)
    runs: list = []
    failures: list = []
    try:
        for run in (lambda: backup_restore_phase(dev, seed + 12,
                                                 **(backup or {})),
                    lambda: dr_phase(dev, seed + 22, **(dr or {}))):
            out, bad = run()
            runs.append(out)
            failures += bad
        if sim is not None:
            name, sim_seed, knobs = sim
            out, bad = sim_run(dev, name, sim_seed, knobs,
                               SIM_EXPECTED.get((name, sim_seed)))
            out["memory_allocated"] = collected_memory(dev)
            out["phase"] = "12c"
            runs.append(out)
            failures += bad
            log("phase 12c: " + json.dumps({k: out[k] for k in (
                "summary", "repro", "result", "expected", "wall_s", "chunks",
                "resolvers", "memory_allocated")}))
    finally:
        trace.set_sink(None)
        KNOBS.reset()
    memory = [r["memory_allocated"] for r in runs]
    if cuda and any(m > memory[0] for m in memory[1:]):
        failures.append(f"phase 12: device memory grew from run to run: "
                        f"{memory} bytes after each")
    summary = {"phase": "12", "runs": runs, "memory_allocated": memory,
               "wall_s": sum(r["wall_s"] for r in runs),
               "chunks": sum(r["chunks"] for r in runs),
               "launches": {k: sum(r["launches"][k] for r in runs)
                            for k in runs[0]["launches"]}}
    log("phase 12: " + json.dumps({k: summary[k] for k in (
        "wall_s", "chunks", "memory_allocated")}))
    log("phase 12 resolvers, chunks by bucket: " + json.dumps({
        r["phase"]: [[x["process"], x["buckets"]] for x in r["resolvers"]]
        for r in runs}))
    if failures:
        fail("phase 12: " + "; ".join(failures))
    return summary


# ---------------------------------------------------------------------------
# phase 13: real-process boot, the resolvers on the card
# ---------------------------------------------------------------------------

NET_KEYS = 20_000  # cell A's keys, loaded as 9a loads them
NET_CLIENTS = 256
NET_ATTEMPTS = 20
NET_STOP_S = 10.0  # a SIGTERMed server process must exit 0 within this
NET_READY_S = 300.0  # a server process's boot, its resolvers' captures in it
NET_RUN_S = 1800.0  # wall limit of one workload over the real transport


def net_addresses(n):
    """`n` distinct free addresses on 127.0.0.1 (every socket held until
    all are drawn, so no two repeat)."""
    import socket
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    finally:
        for s in socks:
            s.close()


def net_endpoint(address, token):
    """A server_main spec's endpoint."""
    return {"address": address, "token": int(token)}


def net_proxy_role(i, listen, master, resolvers, resolver_bounds, tlogs,
                   shard_bounds, shard_tags, proxies):
    """A server_main spec's proxy: its master, resolver map, tlogs and
    shard map (the bytes hex-encoded, as the spec carries them)."""
    from foundationdb_tpu_torch.server.interfaces import Token
    return {"role": "proxy", "listen": listen, "args": {
        "proxy_id": i,
        "master": net_endpoint(master, Token.MASTER_GET_COMMIT_VERSION),
        "resolvers": {"boundaries": [b.hex() for b in resolver_bounds],
                      "endpoints": [net_endpoint(r, Token.RESOLVER_RESOLVE)
                                    for r in resolvers]},
        "tlogs": [net_endpoint(t, Token.TLOG_COMMIT) for t in tlogs],
        "shards": {"boundaries": [b.hex() for b in shard_bounds],
                   "tags": shard_tags},
        "other_proxies": [p for p in proxies if p != listen],
        "n_proxies": len(proxies)}}


def net_request(loop, client, address, token, payload=None, wall=60.0):
    """One request over the real transport, waited for on `loop`."""
    from foundationdb_tpu_torch.core.sim import Endpoint

    async def ask():
        return await client.request(client.process,
                                    Endpoint(address, token), payload)
    return loop.run_future(loop.spawn(ask()), max_time=wall)


def net_resolver_metrics(loop, client, resolvers):
    """Each resolver's RESOLVER_METRICS snapshot, read over the wire."""
    from foundationdb_tpu_torch.server.interfaces import Token
    return [net_request(loop, client, r, Token.RESOLVER_METRICS)
            for r in resolvers]


def count_readbacks(loop):
    """Wrap `loop.run_blocking` to count the resolvers' readbacks (the
    calls made from server/resolver.py; the storage servers' engine
    commits also run there): submitted, pending until resolved on the loop
    thread, and running on a worker thread at once. Returns the tally
    ({"calls", "pending", "max_pending", "running", "max_running"})."""
    import threading

    from foundationdb_tpu_torch.server import resolver as resolver_mod

    tally = {"calls": 0, "pending": 0, "max_pending": 0, "running": 0,
             "max_running": 0}
    lock = threading.Lock()
    run_blocking = loop.run_blocking

    def counted(fn):
        code = getattr(fn, "__code__", None)
        if code is None or code.co_filename != resolver_mod.__file__:
            return run_blocking(fn)
        tally["calls"] += 1
        tally["pending"] += 1
        tally["max_pending"] = max(tally["max_pending"], tally["pending"])

        def readback():
            with lock:
                tally["running"] += 1
                tally["max_running"] = max(tally["max_running"],
                                           tally["running"])
            try:
                return fn()
            finally:
                with lock:
                    tally["running"] -= 1
        out = run_blocking(readback)

        def done(_f):
            tally["pending"] -= 1
        out.add_callback(done)
        return out
    loop.run_blocking = counted
    return tally


def net_inprocess_phase(dev, seed, n_keys=NET_KEYS, n_clients=NET_CLIENTS,
                        n_attempts=NET_ATTEMPTS, knobs=None, n_proxies=2,
                        name="13a"):
    """13a: one RealEventLoop in this process; the roles, built by the
    port's `server_main.boot` from one spec (master, `n_proxies` proxies,
    2 resolvers split at A's median key, 2 tlogs, 2 storage servers, each
    on its own address on 127.0.0.1), and a client NetTransport on
    another. A's load (`n_keys` keys x 100 bytes), then `n_clients`
    clients x `n_attempts` attempts of A's mix (`ycsb_mix`), every hop
    over TCP. Checks: every acknowledged write, applied in commit order,
    read back through a transaction and from the storage role that owns
    it; every resolver batch equal to the oracle, no poison, every chunk
    through its graph, the step kernels once a resolver step net of the
    captures (`backup_run`); at least two readbacks in flight on the
    loop's worker threads at once, and one a drain group. Also returned:
    the transports' C plane counters (`planes`: summed over every role's
    transport and, apart, the client's; the tables, storage and GRV plane
    owners) and the connections that degraded from a C plane to Python.
    Phase 14b is this run under `knobs` that open the C planes, with one
    proxy (`name` "14b")."""
    import tempfile

    from foundationdb_tpu_torch.client.database import Database, LocationCache
    from foundationdb_tpu_torch.net import server_main
    from foundationdb_tpu_torch.net import transport as transport_mod
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    from foundationdb_tpu_torch.server.proxy import Proxy
    from foundationdb_tpu_torch.server.storage import StorageServer
    from foundationdb_tpu_torch.utils.keys import (partition_boundaries,
                                                   partition_index)

    keys, picks = ycsb_traffic(seed, n_keys, n_clients, n_attempts)
    attempts = n_clients * n_attempts
    addrs = net_addresses(8 + n_proxies)
    master, r0, r1, t0_, t1_, s0, s1, cli = addrs[:8]
    proxies, resolvers, tlogs = addrs[8:], [r0, r1], [t0_, t1_]
    storages = [s0, s1]
    resolver_bounds = [b"", sorted(keys)[len(keys) // 2]]
    shard_bounds = partition_boundaries(2)

    def body(note):
        failures: list = []
        out: dict = {"keys": n_keys, "clients": n_clients,
                     "attempts_per_client": n_attempts, "attempts": attempts,
                     "resolver_split": resolver_bounds[1].decode()}
        with tempfile.TemporaryDirectory() as tmp:
            spec = {"listen": master, "data_dir": tmp, "roles": [
                {"role": "master", "args": {}},
                *({"role": "resolver", "listen": r, "args": {
                    "n_proxies": n_proxies,
                    "key_range_begin": resolver_bounds[i].hex(),
                    "key_range_end": (resolver_bounds[i + 1].hex()
                                      if i + 1 < 2 else None)}}
                  for i, r in enumerate(resolvers)),
                *({"role": "tlog", "listen": t, "args": {}} for t in tlogs),
                *({"role": "storage", "listen": s, "args": {
                    "tag": i, "tlog_addrs": tlogs[i:] + tlogs[:i]}}
                  for i, s in enumerate(storages)),
                *(net_proxy_role(i, p, master, resolvers, resolver_bounds,
                                 tlogs, shard_bounds, [[0], [1]], proxies)
                  for i, p in enumerate(proxies))]}
            loop = RealEventLoop()
            tally = count_readbacks(loop)
            residue_reader = transport_mod._ResidueReader
            degraded = []

            class CountedResidueReader(residue_reader):
                """A connection a C plane handed to the Python loop."""

                def __init__(self, residue, reader):
                    degraded.append(len(residue))
                    super().__init__(residue, reader)
            transport_mod._ResidueReader = CountedResidueReader
            t0 = time.perf_counter()
            nets, roles = server_main.boot(loop, json.loads(json.dumps(spec)))
            out["boot_s"] = time.perf_counter() - t0
            client = NetTransport(loop, cli)
            client.start()
            try:
                out.update(run(loop, client, roles, tally, failures))
                out["planes"] = transport_planes(nets, client)
                out["degraded_connections"] = len(degraded)
            finally:
                transport_mod._ResidueReader = residue_reader
                note()
                # the asyncio loop's queued callbacks hold the roles'
                # actors: close it too, so the cluster can be collected
                server_main.shutdown(loop, [client, *nets], roles)
                loop.aio.close()
                del nets, roles, client
        return out, failures

    def run(loop, client, roles, tally, failures):
        from foundationdb_tpu_torch.ops.conflict import kernel_metrics
        out: dict = {}
        waited = kernel_metrics.as_dict()["ReadbackWaitSeconds"]
        db = Database(client.process, proxies=proxies,
                      locations=LocationCache(shard_bounds, storages))
        ns = argparse.Namespace(loop=loop)
        order: dict = {}
        for p in (r for r in roles if isinstance(r, Proxy)):
            def commit_batch(batch_n, batch, t_arrival=None,
                             fn=p._commit_batch):
                for pos, (req, _rep, _t) in enumerate(batch):
                    if req.mutations:
                        order[req.mutations[0].param2] = pos
                return fn(batch_n, batch, t_arrival)
            p._commit_batch = commit_batch
        committed: list = []
        outcomes: dict = {}

        def on_commit(tr, ks, v):
            committed.append((tr.committed_version, order[v], ks, v))
        t0 = time.perf_counter()
        loop.run_future(loop.spawn(ycsb_load(ns, db, keys)),
                        max_time=NET_RUN_S)
        out["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loop.run_future(loop.spawn(ycsb_mix(ns, db, keys, picks, outcomes,
                                            on_commit=on_commit)),
                        max_time=NET_RUN_S)
        out["mix_s"] = wall = time.perf_counter() - t0
        failures += mix_failures(f"phase {name}", outcomes, attempts)
        out.update({"outcomes": outcomes,
                    "committed": outcomes.get("committed", 0),
                    "attempts_per_wall_s": attempts / wall,
                    "committed_per_wall_s": outcomes.get("committed", 0)
                    / wall})
        model = {k: k.ljust(CLUSTER_VALUE_BYTES, b".") for k in keys}
        for _v, _pos, ks, v in sorted(committed, key=lambda x: x[:2]):
            for k in ks:
                model[k] = v

        async def read_back():
            tr = db.create_transaction()
            return await tr.get_many(keys)
        got = loop.run_future(loop.spawn(read_back()), max_time=NET_RUN_S)
        ss = [r for r in roles if isinstance(r, StorageServer)]
        stored = [ss[partition_index(shard_bounds, k)] for k in keys]
        client_bad = sum(g != model[k] for k, g in zip(keys, got))
        storage_bad = sum(s.data.get(k, s.version.get()) != model[k]
                          for s, k in zip(stored, keys))
        out["read_back_mismatches"] = {"client": client_bad,
                                       "storage": storage_bad}
        if client_bad or storage_bad:
            failures.append(f"phase {name}: acknowledged writes not read "
                            f"back: "
                            f"{client_bad} keys through a transaction, "
                            f"{storage_bad} from the storage roles")
        metrics = net_resolver_metrics(loop, client, resolvers)
        out["resolver_metrics"] = [{k: m.get(k) for k in NET_METRICS}
                                   for m in metrics]
        groups = sum(m["DrainGroups"] for m in metrics)
        out.update({"drain_groups": groups,
                    "readbacks": tally["calls"],
                    "max_readbacks_in_flight": tally["max_pending"],
                    "max_readbacks_running": tally["max_running"],
                    "readback_wait_s": metrics[0]["ReadbackWaitSeconds"]
                    - waited})
        if tally["calls"] != groups:
            failures.append(f"phase {name}: {tally['calls']} readbacks on the "
                            f"loop's threads for {groups} drain groups")
        if tally["max_pending"] < 2:
            failures.append(f"phase {name}: at most {tally['max_pending']} "
                            f"readback in flight at once")
        log(f"phase {name}: " + json.dumps({k: out[k] for k in (
            "load_s", "mix_s", "attempts_per_wall_s", "committed",
            "drain_groups", "max_readbacks_in_flight",
            "max_readbacks_running", "readback_wait_s",
            "read_back_mismatches")}))
        return out

    return backup_run(name, dev, knobs, body)


# the RESOLVER_METRICS fields phase 13 prints and checks
NET_METRICS = ("Backend", "BatchesIn", "TxnResolved", "DrainGroups",
               "KernelDispatches", "UnconvergedChunks", "ReadbackWaits",
               "ReadbackWaitSeconds", "KernelLaunches.endpoint_sort",
               "KernelLaunches.intra_levels", "KernelLaunches.intra_sandwich",
               "TransportFramesIn", "TransportFramesOut")
# the step kernels 13b reads over the wire: K6, K9 and K3
NET_STEP_KERNELS = ("endpoint_sort", "intra_levels", "intra_sandwich")


def start_server(spec, env, log_path, phase="13b", record=None):
    """`python -m foundationdb_tpu_torch.net.server_main <spec>` from the
    repository root (fork and exec: no CUDA state crosses), its stderr to
    `log_path`; waits for its `ready` line (NET_READY_S). With `record` (a
    path), the process is `recorded_server_main`, which writes its
    resolvers' replay into the oracles there at its exit. Returns
    (process, boot wall s)."""
    import select
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = ([sys.executable, "-m", "foundationdb_tpu_torch.net.server_main",
            json.dumps(spec)] if record is None else
           [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
            "chip_smoke.recorded_server_main(sys.argv[1], sys.argv[2]))",
            json.dumps(spec), record])
    t0 = time.perf_counter()
    with open(log_path, "ab") as err:
        proc = subprocess.Popen(cmd, cwd=root, env=env,
                                stdout=subprocess.PIPE, stderr=err)
    ready, _w, _x = select.select([proc.stdout], [], [], NET_READY_S)
    line = proc.stdout.readline().decode() if ready else ""
    if not line.startswith("ready"):
        proc.kill()
        proc.wait()
        with open(log_path, errors="replace") as f:
            tail = f.read()[-2000:]
        fail(f"phase {phase}: server {spec['listen']} did not print ready "
             f"(rc {proc.returncode}, {line!r}): {tail}")
    return proc, time.perf_counter() - t0


def stop_servers(procs, phase="13b"):
    """SIGTERM every process; each must exit 0 within NET_STOP_S (one that
    does not is killed, and the phase fails). Returns the failures."""
    import signal
    import subprocess

    bad = []
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            rc = p.wait(timeout=NET_STOP_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            bad.append(f"phase {phase}: pid {p.pid} did not exit within "
                       f"{NET_STOP_S} s of SIGTERM")
            continue
        if rc != 0:
            bad.append(f"phase {phase}: pid {p.pid} exited {rc} on SIGTERM")
    return bad


def net_process_phase(dev, seed, n_nodes=CYCLE_NODES,
                      n_rotators=CYCLE_ROTATORS, n_txns=CYCLE_TXNS,
                      knobs=None):
    """13b: two `server_main` OS processes with FDBTPU_TRACE_DIR set: txn
    (master, proxy, 2 resolvers on `dev`, each on its own address, and a
    tlog; master and resolvers fenced by '@recover:local_tlog') and
    storage (2 storage servers, replicas of one shard). From this process:
    9b's Cycle (`n_nodes` keys over both resolvers, `n_rotators` x
    `n_txns`), the ring read from each replica; fdbbackup's main (`start
    -d`, then `status`); each resolver's RESOLVER_METRICS over the wire
    (its engine on `dev`, the step kernels at least once a batch, every
    readback returned, none unconverged); SIGTERM (exit 0 within
    NET_STOP_S); a restart of both processes on their data dirs, the ring
    whole again and one more commit; SIGTERM again; then trace_analyze
    over every trace file (`check_well_formed`, per-stage p50/p99)."""
    import contextlib
    import io
    import random
    import shutil
    import tempfile

    from foundationdb_tpu_torch.client.database import Database, LocationCache
    from foundationdb_tpu_torch.core.future import all_of
    from foundationdb_tpu_torch.net import server_main
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    from foundationdb_tpu_torch.tools import fdbbackup, trace_analyze
    from foundationdb_tpu_torch.utils import trace
    from foundationdb_tpu_torch.utils.keys import partition_boundaries

    failures: list = []
    out: dict = {"nodes": n_nodes, "rotators": n_rotators,
                 "txns_per_rotator": n_txns}
    rnd = random.Random(seed)
    txn, r0, r1, s0, s1 = net_addresses(5)
    resolvers = [r0, r1]
    resolver_bounds = partition_boundaries(2)
    tmp = tempfile.mkdtemp()
    # one trace directory a boot: a restarted proxy numbers its batches
    # from 1 again, so each boot's span stream is checked on its own
    trace_dirs = [os.path.join(tmp, "trace", f"boot{i}") for i in (1, 2)]
    knob_spec = {"CONFLICT_BACKEND": "device", "CONFLICT_DEVICE": str(dev),
                 **(knobs or {})}
    recover = "@recover:local_tlog"
    txn_spec = {"listen": txn, "data_dir": os.path.join(tmp, "txn"),
                "knobs": knob_spec, "roles": [
                    {"role": "master",
                     "args": {"recovery_version": recover}},
                    *({"role": "resolver", "listen": r, "args": {
                        "recovery_version": recover,
                        "key_range_begin": resolver_bounds[i].hex(),
                        "key_range_end": (resolver_bounds[i + 1].hex()
                                          if i + 1 < 2 else None)}}
                      for i, r in enumerate(resolvers)),
                    {"role": "tlog", "args": {}},
                    net_proxy_role(0, txn, txn, resolvers, resolver_bounds,
                                   [txn], [b""], [[0, 1]], [txn])]}
    # the proxy listens on the spec's own address
    txn_spec["roles"][-1].pop("listen")
    storage_spec = {"listen": s0, "data_dir": os.path.join(tmp, "storage"),
                    "knobs": knob_spec, "roles": [
                        {"role": "storage",
                         "args": {"tag": 0, "tlog_addrs": [txn]}},
                        {"role": "storage", "listen": s1,
                         "args": {"tag": 1, "tlog_addrs": [txn]}}]}
    log_path = os.path.join(tmp, "servers.log")
    procs: list = []
    trace_file = [None]

    def boot(gen):
        """Start both servers with the boot's trace directory, and write
        this process's own records (the client's spans) there too."""
        env = dict(os.environ, FDBTPU_TRACE_DIR=trace_dirs[gen])
        env.pop("FDBTPU_PROFILE", None)
        if trace_file[0] is not None:
            trace.g_trace_batch.dump()
            trace_file[0].close()
        trace_file[0] = trace.RollingTraceFile(
            os.path.join(trace_dirs[gen], "trace.client.jsonl"))
        trace.set_sink(trace_file[0].write)
        boots = [start_server(s, env, log_path)
                 for s in (txn_spec, storage_spec)]
        return [p for p, _s in boots], [s for _p, s in boots]

    def key(i):
        return bytes([i * 251 % 256]) + b"/cycle/%04d" % i

    tries = [0]
    errors: dict = {}

    async def rotate(tr):
        if "on_error" not in vars(tr):
            def on_error(e, fn=tr.on_error):
                name = getattr(e, "name", repr(e))
                errors[name] = errors.get(name, 0) + 1
                return fn(e)
            tr.on_error = on_error
        tries[0] += 1
        a = key(rnd.randrange(n_nodes))
        b_idx = int(await tr.get(a))
        b = key(b_idx)
        c_idx = int(await tr.get(b))
        cc = key(c_idx)
        d_idx = int(await tr.get(cc))
        tr.set(a, b"%04d" % c_idx)
        tr.set(b, b"%04d" % d_idx)
        tr.set(cc, b"%04d" % b_idx)

    def ring_of(db):
        async def read(tr):
            return await tr.get_many([key(i) for i in range(n_nodes)])
        return [int(v) for v in loop.run_future(
            loop.spawn(db.transact(read, max_retries=500)),
            max_time=NET_RUN_S)]

    def ring_whole(ring):
        seen, i = set(), 0
        for _ in range(n_nodes):
            seen.add(i)
            i = ring[i]
        return i == 0 and len(seen) == n_nodes

    def replica_rings(where):
        rings = [ring_of(Database(client.process, proxies=[txn],
                                  locations=LocationCache([b""], [[s]])))
                 for s in (s0, s1)]
        whole = [ring_whole(r) for r in rings]
        if not all(whole) or rings[0] != rings[1]:
            failures.append(f"phase 13b: the ring {where}: whole on each "
                            f"replica {whole}, replicas equal "
                            f"{rings[0] == rings[1]}")
        return all(whole) and rings[0] == rings[1]

    loop = client = None
    try:
        procs, out["boot_s"] = boot(0)
        loop = RealEventLoop()
        client = NetTransport(loop, net_addresses(1)[0])
        client.start()
        db = Database(client.process, proxies=[txn],
                      locations=LocationCache([b""], [[s0, s1]]))

        async def setup(tr):
            for i in range(n_nodes):
                tr.set(key(i), b"%04d" % ((i + 1) % n_nodes))
        loop.run_future(loop.spawn(db.transact(setup, max_retries=500)),
                        max_time=NET_RUN_S)

        async def rotator():
            for _ in range(n_txns):
                await db.transact(rotate)

        async def cycle():
            await all_of([loop.spawn(rotator(), name=f"rot{i}")
                          for i in range(n_rotators)])
        t0 = time.perf_counter()
        loop.run_future(loop.spawn(cycle()), max_time=NET_RUN_S)
        wall = time.perf_counter() - t0
        committed = n_rotators * n_txns
        out.update({"attempts": tries[0], "committed": committed,
                    "retried_errors": dict(errors), "cycle_s": wall,
                    "attempts_per_wall_s": tries[0] / wall,
                    "committed_per_wall_s": committed / wall})
        if set(errors) - {"not_committed", "transaction_too_old"}:
            failures.append(f"phase 13b: attempts ended in {errors}")
        out["ring_whole"] = replica_rings("after the Cycle")

        # fdbbackup's main against the cluster: start, then status
        backup_dir = os.path.join(tmp, "backup")
        said = {}
        for cmd in (["start", "-d", backup_dir], ["status"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = fdbbackup.main(["--cluster", txn, "--storage", s0, *cmd])
            said[cmd[0]] = buf.getvalue().strip()
            if rc != 0:
                failures.append(f"phase 13b: fdbbackup {cmd[0]} exited {rc}")
        out["fdbbackup"] = said
        if not said["start"].startswith("backup started") or \
                not said["status"].startswith("state: "):
            failures.append(f"phase 13b: fdbbackup printed {said}")

        metrics = net_resolver_metrics(loop, client, resolvers)
        out["resolver_metrics"] = [{k: m.get(k) for k in NET_METRICS}
                                   for m in metrics]
        out["launches"] = {k[len("KernelLaunches."):]: v
                           for k, v in metrics[0].items()
                           if k.startswith("KernelLaunches.")}
        out["readback_wait_s"] = metrics[0]["ReadbackWaitSeconds"]
        for r, m in zip(resolvers, metrics):
            if m["Backend"] != dev.type:
                failures.append(f"phase 13b: resolver {r} reports backend "
                                f"{m['Backend']!r}, not {dev.type!r}")
            if not m["BatchesIn"]:
                failures.append(f"phase 13b: resolver {r} took no batch")
            for k in NET_STEP_KERNELS if dev.type == "cuda" else ():
                if m[f"KernelLaunches.{k}"] < m["BatchesIn"]:
                    failures.append(
                        f"phase 13b: {m[f'KernelLaunches.{k}']} {k} launches "
                        f"for resolver {r}'s {m['BatchesIn']} batches")
        groups = sum(m["DrainGroups"] for m in metrics)
        if metrics[0]["ReadbackWaits"] != groups or \
                metrics[0]["UnconvergedChunks"]:
            failures.append(f"phase 13b: {metrics[0]['ReadbackWaits']} "
                            f"readbacks returned for {groups} drain groups, "
                            f"{metrics[0]['UnconvergedChunks']} chunks "
                            f"unconverged")

        failures += stop_servers(procs)
        t0 = time.perf_counter()
        procs, _boot_s = boot(1)

        async def one_more(tr):
            tr.set(b"after-restart", b"%d" % n_nodes)
        loop.run_future(loop.spawn(db.transact(one_more, max_retries=500)),
                        max_time=NET_RUN_S)
        out["restart_s"] = time.perf_counter() - t0
        out["ring_whole_after_restart"] = replica_rings("after the restart")

        async def read_one(tr):
            return await tr.get(b"after-restart")
        if loop.run_future(loop.spawn(db.transact(read_one, max_retries=500)),
                           max_time=NET_RUN_S) != b"%d" % n_nodes:
            failures.append("phase 13b: the commit after the restart is "
                            "not read back")
        failures += stop_servers(procs)
        procs = []
    finally:
        stop_servers(procs)
        trace.g_trace_batch.dump()
        trace.set_sink(None)
        if trace_file[0] is not None:
            trace_file[0].close()
        if loop is not None:
            server_main.shutdown(loop, [client] if client else [], [])
            loop.aio.close()

    import glob
    out["trace"] = []
    for gen, trace_dir in enumerate(trace_dirs):
        paths = sorted(glob.glob(os.path.join(trace_dir, "trace.*")))
        events = trace_analyze.load_events(paths)
        problems = trace_analyze.check_well_formed(events)
        report = trace_analyze.analyze(events)
        out["trace"].append({
            "boot": gen + 1, "files": [os.path.basename(p) for p in paths],
            "events": report["events"], "spans": report["spans"],
            "problems": problems[:10],
            "stages": {st: {k: v[k] for k in ("n", "p50", "p99")}
                       for st, v in report["stages"].items()},
            "readback_overlap_ratio": report["readback_overlap_ratio"],
            "transport": report["transport"]})
        if problems:
            failures.append(f"phase 13b: trace_analyze found {len(problems)} "
                            f"problems in boot {gen + 1}'s trace files: "
                            f"{problems[:3]}")
        if not report["spans"]:
            failures.append(f"phase 13b: boot {gen + 1}'s trace files hold "
                            f"no span")
    shutil.rmtree(tmp, ignore_errors=True)
    log("phase 13b: " + json.dumps({k: out.get(k) for k in (
        "boot_s", "attempts", "committed", "cycle_s", "attempts_per_wall_s",
        "ring_whole", "ring_whole_after_restart", "restart_s",
        "readback_wait_s", "fdbbackup")}))
    return out, failures


def net_phase(dev, seed, inprocess=None, processes=None):
    """Phase 13: 13a and 13b (`inprocess` and `processes`: keyword
    arguments of each, the CPU tests' small sizes). The in-process roles'
    trace events are dropped, their buffered spans too; 13b's go to the
    servers' trace files and this process's client spans beside them."""
    from foundationdb_tpu_torch.utils import trace
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    trace.set_sink(lambda _fields: None)
    try:
        a, bad_a = net_inprocess_phase(dev, seed + 13, **(inprocess or {}))
    finally:
        trace.g_trace_batch.dump()  # 13a's buffered spans, dropped too
        trace.set_sink(None)
        KNOBS.reset()
    b, bad_b = net_process_phase(dev, seed + 23, **(processes or {}))
    summary = {"phase": "13", "13a": a, "13b": b,
               "launches": {k: a["launches"][k] + b["launches"].get(k, 0)
                            for k in a["launches"]}}
    log("phase 13 per-stage p50 / p99 s (13b's first boot's trace files): "
        + json.dumps({s: [v["p50"], v["p99"]]
                      for s, v in b["trace"][0]["stages"].items()}))
    log("phase 13a resolvers, chunks by bucket: " + json.dumps(
        [[x["process"], x["buckets"]] for x in a["resolvers"]]))
    failures = bad_a + bad_b
    if failures:
        fail("phase 13: " + "; ".join(failures))
    return summary


# ---------------------------------------------------------------------------
# phase 14: the port's C extension on the main path
# ---------------------------------------------------------------------------

# the C plane counters a phase reports (the transport's counters merge its
# server table's; the client plane's are the transport's own)
PLANE_COUNTERS = ("NativeFastPathHits", "NativeGetValueHits",
                  "NativeGetValuesHits", "NativeGetRangeHits",
                  "NativeGRVHits", "PySlowPathFalls", "ClientNativeBatches",
                  "ClientNativeSettles", "ClientPyFalls")
NATIVE_STRIDED_T = 16_384  # the kernel bench's T
NATIVE_STRIDED_CHUNKS = 3


def transport_planes(nets, client=None):
    """The C plane counters summed over `nets` (`servers`) and, apart,
    `client`'s; how many of `nets` run a C server table, and which own a
    storage or GRV plane."""
    def tally(ts):
        out = dict.fromkeys(PLANE_COUNTERS, 0)
        for t in ts:
            c = t.transport_counters()
            for k in PLANE_COUNTERS:
                out[k] += c.get(k, 0)
        return out
    planes = {"servers": tally(nets),
              "tables": sum(t.native_table is not None for t in nets),
              "storage_owners": sum(
                  getattr(t, "_native_storage_owner", None) is not None
                  for t in nets),
              "grv_owners": sum(getattr(t, "_native_grv_owner", None)
                                is not None for t in nets),
              "client_planes": sum(bool(t.native_client) for t in nets)}
    if client is not None:
        planes["client"] = tally([client])
        planes["client_plane"] = bool(client.native_client)
    return planes


class NativeTally:
    """Which planes a phase ran natively: the chunks the resolvers'
    encoders wrote by the C pass and by numpy, the class of every storage
    server's versioned map, the wire codec, and the C plane counters of
    every NetTransport closed or still open at the end (`summary()`)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        import weakref

        from foundationdb_tpu_torch.net import transport as transport_mod
        from foundationdb_tpu_torch.ops.conflict import kernel_metrics
        from foundationdb_tpu_torch.server import storage as storage_mod

        self.metrics = kernel_metrics
        self.before = kernel_metrics.as_dict()
        self.stores: dict = {}
        self.counters = dict.fromkeys(PLANE_COUNTERS, 0)
        self.transports = {"built": 0, "server_tables": 0,
                           "client_planes": 0}
        live = self.live = weakref.WeakSet()
        tally = self
        self.mods = (transport_mod, storage_mod)
        self.saved = (transport_mod.NetTransport.__init__,
                      transport_mod.NetTransport.close,
                      storage_mod.make_versioned_map)
        init, close, make = self.saved

        def counted_init(t, *a, **kw):
            init(t, *a, **kw)
            tally.transports["built"] += 1
            tally.transports["server_tables"] += t.native_table is not None
            tally.transports["client_planes"] += bool(t.native_client)
            live.add(t)

        def counted_close(t):
            if t in live:
                live.discard(t)
                tally.add(t)
            return close(t)

        def counted_make(*a, **kw):
            vm = make(*a, **kw)
            n = type(vm).__name__
            tally.stores[n] = tally.stores.get(n, 0) + 1
            return vm
        transport_mod.NetTransport.__init__ = counted_init
        transport_mod.NetTransport.close = counted_close
        storage_mod.make_versioned_map = counted_make
        return self

    def add(self, t):
        c = t.transport_counters()
        for k in PLANE_COUNTERS:
            self.counters[k] += c.get(k, 0)

    def __exit__(self, *exc):
        transport_mod, storage_mod = self.mods
        for t in list(self.live):
            self.add(t)
        (transport_mod.NetTransport.__init__, transport_mod.NetTransport.close,
         storage_mod.make_versioned_map) = self.saved
        self.after = self.metrics.as_dict()
        return False

    def summary(self):
        from foundationdb_tpu_torch import native
        from foundationdb_tpu_torch.utils import wire
        wire._ensure_registry()
        return {"encoder_chunks": {
                    "c": self.after["EncodedChunksC"]
                    - self.before["EncodedChunksC"],
                    "python": self.after["EncodedChunksPy"]
                    - self.before["EncodedChunksPy"]},
                "stores": self.stores,
                "wire_codec": ("c" if wire._native is not None
                               and wire._native is native.mod
                               else "python"),
                "transports": self.transports,
                "plane_counters": self.counters}


def native_status():
    """The extension's build: available, its library and its error; fails
    the run where it is not available."""
    from foundationdb_tpu_torch import native
    t0 = time.perf_counter()
    ok = native.available()
    out = {"available": ok, "seconds": time.perf_counter() - t0,
           "build_error": native.build_error(),
           "library": getattr(native.mod, "__file__", None)}
    log("native extension: " + json.dumps(out))
    if not ok:
        fail(f"the port's C extension is not available on the card's "
             f"machine: {native.build_error()}")
    return out


def record_encodes():
    """Hook BatchEncoder's C pass: every chunk it writes is recorded (its
    inputs, base version, shape, the C pass's host ms, and a copy of the
    fields it wrote, taken on the host before the chunk's copy to the
    card). Returns (records, restore)."""
    from foundationdb_tpu_torch.ops import conflict as conf

    records: list = []
    encode_c = conf.BatchEncoder._encode_c

    def recorded(self, host, txns, skip, sh):
        t0 = time.perf_counter()
        encode_c(self, host, txns, skip, sh)
        ms = (time.perf_counter() - t0) * 1e3
        records.append({
            "txns": list(txns), "skip": None if skip is None else list(skip),
            "shapes": sh, "base": self.base_version, "ms": ms,
            "fields": {k: np.array(host[k], copy=True) for k in ENCODED}})
    conf.BatchEncoder._encode_c = recorded

    def restore():
        conf.BatchEncoder._encode_c = encode_c
    return records, restore


# the packed batch fields the encoder writes (commit_version and
# advance_floor are set by encode_batch after it)
ENCODED = ("rb", "re", "wb", "we", "rtxn", "wtxn", "snapshot", "txn_valid")


def check_encodes(records, where):
    """Each recorded chunk encoded again on the host by the numpy path and
    by the C pass, from its own inputs: both must equal the recorded
    fields byte for byte. Returns (numbers, failures): host ms a chunk of
    the C pass in the run and of both paths here, p50 and p99."""
    import torch

    from foundationdb_tpu_torch.ops.conflict import BatchEncoder
    from foundationdb_tpu_torch.ops.step_graph import batch_views

    failures, times = [], {"c_run": [], "c": [], "numpy": []}
    for i, r in enumerate(records):
        enc = BatchEncoder(r["shapes"], torch.device("cpu"),
                           base_version=r["base"])
        slot = enc._slot(r["shapes"])
        for path, fn in (("numpy", enc._encode_numpy), ("c", enc._encode_c)):
            buf = slot["buf"].numpy()
            buf.fill(-1)
            views = batch_views(buf, slot["layout"])
            t0 = time.perf_counter()
            fn(views, r["txns"], r["skip"], r["shapes"])
            times[path].append((time.perf_counter() - t0) * 1e3)
            bad = [k for k in ENCODED
                   if views[k].tobytes() != r["fields"][k].tobytes()]
            if bad:
                failures.append(f"{where}: chunk {i}'s {path} encode differs "
                                f"from the served C buffer in {bad}")
        times["c_run"].append(r["ms"])

    def pct(v):
        a = np.asarray(v, dtype=np.float64)
        return {"p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "mean": float(a.mean())} if a.size else None
    out = {"chunks": len(records),
           "encode_ms": {k: pct(v) for k, v in times.items()}}
    return out, failures


def native_strided(dev, seed, T=NATIVE_STRIDED_T, n=NATIVE_STRIDED_CHUNKS):
    """14a's strided half: the kernel bench's traffic (`bench.
    _encode_batches`, its setK byte keys, one read and one write a txn)
    through a strided DeviceConflictSet at T=`T` on the card (K=2^18,
    16-byte keys), `n` one-chunk batches, its C-encoded chunks recorded;
    every batch equal to the oracle. Returns (records, numbers,
    failures)."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import (DeviceConflictSet,
                                                     kernel_metrics)
    from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet

    w = bench._encode_batches(n, seed, 2 * bench.WINDOW, T)
    rb, re, wb, we = (bench_byte_keys(w[k], n) for k in ("rb", "re", "wb",
                                                         "we"))
    batches = []
    for i in range(n):
        o = i * T
        batches.append((int(w["commit_version"][i]), [
            TxnConflictInfo(int(w["snapshot"][i, t]), [(rb[o + t], re[o + t])],
                            [(wb[o + t], we[o + t])]) for t in range(T)]))
    cs = DeviceConflictSet(device=dev, capacity=bench.CAPACITY, txns=T,
                           reads_per_txn=1, writes_per_txn=1,
                           key_bytes=bench.KEY_BYTES, strided=True)
    cs.warmup()
    torch.cuda.synchronize()
    before = kernel_metrics.as_dict()
    records, restore = record_encodes()
    oracle, failures, got = OracleConflictSet(), [], []
    try:
        t0 = time.perf_counter()
        for version, txns in batches:
            got.append(cs.detect(txns, version))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    after = kernel_metrics.as_dict()
    mismatches = sum(g != oracle.detect(txns, version)
                     for g, (version, txns) in zip(got, batches))
    if mismatches:
        failures.append(f"phase 14a strided: {mismatches} of {n} batches "
                        f"differ from the oracle")
    chunks = after["KernelDispatches"] - before["KernelDispatches"]
    c_chunks = after["EncodedChunksC"] - before["EncodedChunksC"]
    py_chunks = after["EncodedChunksPy"] - before["EncodedChunksPy"]
    if not (chunks == c_chunks == len(records) == n) or py_chunks:
        failures.append(f"phase 14a strided: {chunks} chunks, {c_chunks} "
                        f"by C, {py_chunks} by numpy, {len(records)} "
                        f"recorded (want {n} by C)")
    out = {"T": T, "batches": n, "chunks": chunks, "wall_s": wall,
           "txns_per_s": n * T / wall, "mismatched_batches": mismatches}
    del cs
    return records, out, failures


def native_planes_phase(dev, seed, net_a=None, knobs=None, **inprocess):
    """14b: 13a's one-process boot (`net_inprocess_phase`, its checks) at
    A's width with NET_NATIVE_TRANSPORT=1 and NET_NATIVE_CLIENT=1 over
    `knobs`, and one proxy (the GRV plane serves a lone proxy only).
    Checks: the read and GRV fast paths hit, each storage server and the
    proxy own their transport's plane, the client plane settled replies,
    no connection degraded to Python, and the device bytes after the run
    (its cluster collected) no more than before. Returns (numbers,
    failures, its NativeTally)."""
    from foundationdb_tpu_torch.utils import trace
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    base = collected_memory(dev)
    trace.set_sink(lambda _fields: None)
    try:
        with NativeTally("14b") as tally:
            b, failures = net_inprocess_phase(
                dev, seed, knobs={**(knobs or {}), "NET_NATIVE_TRANSPORT": 1,
                                  "NET_NATIVE_CLIENT": 1},
                n_proxies=1, name="14b", **inprocess)
    finally:
        trace.g_trace_batch.dump()
        trace.set_sink(None)
        KNOBS.reset()
    planes = b["planes"]
    srv = planes["servers"]
    reads = (srv["NativeGetValueHits"] + srv["NativeGetValuesHits"]
             + srv["NativeGetRangeHits"])
    b.update({"device_bytes_before": base, "native_read_hits": reads,
              "native_grv_hits": srv["NativeGRVHits"],
              "beside_13a": ({k: net_a.get(k) for k in (
                  "attempts_per_wall_s", "mix_s", "committed")}
                  if net_a else None)})
    if not reads:
        failures.append(f"phase 14b: no read served by the C plane: {srv}")
    if not srv["NativeGRVHits"]:
        failures.append(f"phase 14b: no GRV served by the C plane: {srv}")
    if planes["storage_owners"] != 2 or planes["grv_owners"] != 1:
        failures.append(f"phase 14b: plane owners {planes}")
    if not planes.get("client_plane") or not planes["client"][
            "ClientNativeSettles"]:
        failures.append(f"phase 14b: the client plane settled nothing: "
                        f"{planes.get('client')}")
    if b["degraded_connections"]:
        failures.append(f"phase 14b: {b['degraded_connections']} "
                        f"connections degraded from a C plane to Python")
    if base is not None and b["memory_allocated"] > base:
        failures.append(f"phase 14b: device bytes grew from {base} to "
                        f"{b['memory_allocated']}")
    log("phase 14b: " + json.dumps({k: b.get(k) for k in (
        "attempts_per_wall_s", "mix_s", "committed", "native_read_hits",
        "native_grv_hits", "degraded_connections", "device_bytes_before",
        "memory_allocated", "beside_13a", "planes")}))
    return b, failures, tally


def native_phase(dev, seed, phase_a=None, net_a=None, inprocess=None):
    """Phase 14 (after `native_status` found the extension built): the
    port's C extension on the main path. 14a: cell A's
    traffic served by the port's Resolver on the card (`serve_phase`, its
    checks: every reply equal to the oracle, every kernel launched) with
    every chunk's packed buffer written by the C pass, recorded on the
    host before its copy and held byte for byte to the numpy encoder and
    to a second C pass on the same inputs, their host ms a chunk compared;
    the same cell served with the numpy encoder (the yardstick) and, when
    given, beside phase 4's A (`phase_a`); then the strided layout at the
    bench's T=16,384 for 3 chunks (`native_strided`). 14b: 13a's
    one-process boot at A's width with NET_NATIVE_TRANSPORT=1 and
    NET_NATIVE_CLIENT=1 and one proxy (the GRV plane serves a lone proxy
    only), its checks, and: the read and GRV fast paths hit, no
    connection degraded, the device bytes after it no more than before;
    beside 13a's (`net_a`). `inprocess`: 14b's keyword arguments (the CPU
    tests' small sizes)."""
    from foundationdb_tpu_torch import native

    failures, out = [], {"phase": "14"}
    a_args = ("14a", dev, 1 << 16, PHASE_A_BATCHES, 20_000, seed + 1)
    a_kw = {"jump_at": PHASE_A_BATCHES // 2}
    # 14a: cell A, its chunks by the C pass, recorded
    records, restore = record_encodes()
    try:
        with NativeTally("14a") as tally:
            served, cs, _next = serve_phase(*a_args, **a_kw)
    finally:
        restore()
    del cs
    enc = tally.summary()["encoder_chunks"]
    if enc["python"] or enc["c"] != len(records) or not records:
        failures.append(f"phase 14a: encoder chunks {enc}, {len(records)} "
                        f"recorded: the C pass did not serve every chunk")
    checked, bad = check_encodes(records, "phase 14a")
    failures += bad
    del records
    # the yardstick: the same cell with the numpy encoder, as where the
    # extension is not built (the resolver alone runs here)
    available = native.available
    native.available = lambda: False
    try:
        with NativeTally("14a-numpy") as tally_np:
            yard, cs, _next = serve_phase("14a-numpy", *a_args[1:], **a_kw)
    finally:
        native.available = available
    del cs
    if tally_np.summary()["encoder_chunks"]["c"]:
        failures.append("phase 14a-numpy: a chunk took the C pass")
    served_keys = ("txns_per_s", "batch_latency_ms_p50",
                   "batch_latency_ms_p99", "wall_s", "chunks", "host_share")
    out["14a"] = {"c": {k: served[k] for k in served_keys},
                  "numpy": {k: yard[k] for k in served_keys},
                  "phase_4a": ({k: phase_a[k] for k in served_keys}
                               if phase_a else None),
                  "encode": checked, "launches": served["launches"]}
    records, s_out, bad = native_strided(dev, seed + 14)
    failures += bad
    s_checked, bad = check_encodes(records, "phase 14a strided")
    failures += bad
    del records
    s_out["encode"] = s_checked
    out["14a_strided"] = s_out
    log("phase 14a: " + json.dumps({
        "served": {k: out["14a"][k] for k in ("c", "numpy", "phase_4a")},
        "encode_ms": checked, "strided": s_out}))
    # 14b: the transport's C planes
    b, bad, tally_b = native_planes_phase(dev, seed + 13, net_a,
                                          **(inprocess or {}))
    failures += bad
    out["14b"] = b
    out["native_planes"] = {"14a": tally.summary(),
                            "14a-numpy": tally_np.summary(),
                            "14b": tally_b.summary()}
    out["launches"] = {k: served["launches"][k] + b["launches"].get(k, 0)
                       for k in served["launches"]}
    if failures:
        fail("phase 14: " + "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# phases 5-7: the kernel bench, the evaluator A/B and the probes
# ---------------------------------------------------------------------------

def bench_byte_keys(limbs, n_batches):
    """The setK byte keys ('.' x 12, then the 4-byte big-endian integer of
    limb 3) of the first `n_batches` of a stacked (n, L, T) limb array, in
    batch-major order."""
    from foundationdb_tpu_torch.utils import keys as keylib
    v = keylib.from_signed_limbs(limbs[:n_batches, 3, :]).reshape(-1)
    arr = np.full((v.size, 16), ord("."), dtype=np.uint8)
    arr[:, 12:] = v.astype(">u4").view(np.uint8).reshape(-1, 4)
    buf = arr.tobytes()
    return [buf[i * 16:(i + 1) * 16] for i in range(v.size)]


def bench_oracle_check(detail, T, n_check):
    """The statuses of the warm chunk's first `n_check` batches against the
    port's OracleConflictSet fed the same transactions as byte keys."""
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
    w = detail["warm_np"]
    got = detail["warm_statuses"][:n_check].cpu().numpy()
    rb, re, wb, we = (bench_byte_keys(w[k], n_check)
                      for k in ("rb", "re", "wb", "we"))
    oracle = OracleConflictSet()
    for i in range(n_check):
        o = i * T
        txns = [TxnConflictInfo(int(w["snapshot"][i, t]),
                                [(rb[o + t], re[o + t])],
                                [(wb[o + t], we[o + t])]) for t in range(T)]
        want = np.asarray(oracle.detect(txns, int(w["commit_version"][i])),
                          dtype=np.int8)
        if not np.array_equal(want, got[i]):
            fail(f"kernel bench T={T}: warm batch {i} differs from the "
                 f"oracle in {int((want != got[i]).sum())} txns")


def bench_plain_check(dev, detail, T):
    """The first timed chunk again from the same post-warm-up state, three
    ways on the card: through a new scan graph, through `conflict_scan`
    with the kernels run eagerly, and with the plain phases. The timed
    (graphed) run's statuses and committed counts, and all three's, must
    be equal, and so must the three states after the chunk. Returns the
    phase calls of the plain chunk's last step (the kernels' inputs at the
    bench's shapes)."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.step_graph import ScanGraph
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    life = KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS
    chunk = detail["chunks"][0]
    M = chunk["snapshot"].shape[0]
    calls: dict = {}
    runs = {}
    for label, phases in (("eager kernels", kernels.PHASES),
                          ("plain", spied_phases(calls, dev,
                                                 last_step_only=True))):
        state = clone_to(detail["state_after_warm"], dev)
        _s, st, comm, ovf = ref.conflict_scan(
            state, chunk, max_write_life=life, strided=True, phases=phases,
            out=state)
        runs[label] = (st, comm, ovf, state)
    state = clone_to(detail["state_after_warm"], dev)
    prog = ScanGraph(state, steps=M, txns=T, reads=T, writes=T,
                     max_write_life=life, strided=True)
    runs["graph"] = (*(t.clone() for t in prog.run(chunk)), state)
    torch.cuda.synchronize()
    if not torch.equal(runs["graph"][0], detail["statuses"][0]):
        fail(f"kernel bench T={T}: a new scan graph's statuses differ from "
             f"the timed run's")
    for label in ("eager kernels", "plain"):
        st, comm, ovf, state = runs[label]
        if not torch.equal(st, detail["statuses"][0]):
            fail(f"kernel bench T={T}: the first timed chunk's statuses "
                 f"differ between the graph and the {label}")
        if not np.array_equal(comm.cpu().numpy(), detail["committed"][:M]):
            fail(f"kernel bench T={T}: committed counts differ from the "
                 f"{label}")
        if bool(ovf.any()):
            fail(f"kernel bench T={T}: the {label} overflowed")
        for k, v in runs["graph"][3].items():
            if not torch.equal(v, state[k]):
                fail(f"kernel bench T={T}: state[{k}] after the chunk "
                     f"differs between the graph and the {label}")
    return calls


def bench_graph_ab(dev, detail, T, rounds=("graph", "eager", "eager",
                                           "graph")):
    """The bench's timed core (`timed_scan`) again on the staged batches,
    graphed and eager in turns, from an empty state each time: ms/step,
    txns/s and peak device memory of each run; every run's statuses equal
    to the first timed run's."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    K = detail["state"]["bval"].shape[0]
    n = sum(c["snapshot"].shape[0] for c in detail["chunks"])
    out: dict = {label: [] for label in set(rounds)}
    for label in rounds:
        state = ref.init_state(K, bench.LIMBS, dev, phases=kernels.PHASES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = bench.timed_scan(state, detail["warm"], detail["chunks"],
                               graphed=label == "graph")
        torch.cuda.synchronize()
        for a, b in zip(res["statuses"], detail["statuses"]):
            if not torch.equal(a, b):
                fail(f"kernel bench T={T}: a {label} run's statuses differ "
                     f"from the timed run's")
        out[label].append({"ms_per_step": 1e3 * res["seconds"] / n,
                           "txns_per_s": n * T / res["seconds"],
                           "peak_device_bytes":
                               torch.cuda.max_memory_allocated()})
        del res, state
    log(f"kernel bench T={T} graphed and eager in turns: " + json.dumps(out))
    return out


def profile_bench_step(dev, detail):
    """Where one kernel-bench step's device time goes: one strided step
    with the kernels from the post-warm-up state, under the profiler. No
    torch `cummax` scan (the endpoint ranks are K8's) and no cub radix sort
    (the level geometry is K9's) may be left in it."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    state = detail["state_after_warm"]
    batch = {k: v[0] for k, v in detail["chunks"][0].items()}

    def one():
        ref.conflict_step(
            state, batch,
            max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
            strided=True, phases=kernels.PHASES)
    funcs, wall = profile_device(one, 3)
    busy = busy_ms(funcs)
    wall_ms = wall / 3 * 1e3
    top = sorted(funcs.items(), key=lambda kv: -kv[1][0])[:10]
    scans = [k[:80] for k in funcs if "scan_innermost_dim_with_indices" in k]
    if scans:
        fail(f"the bench step still runs torch cummax scans: {scans}")
    if radix_sort_ms(funcs) > 0:
        fail(f"the bench step still runs a cub radix sort "
             f"({radix_sort_ms(funcs)} ms)")
    # the same step as a one-step scan graph: one replay (and the copies
    # of its ten input fields) a call
    from foundationdb_tpu_torch.ops.step_graph import ScanGraph
    T = batch["snapshot"].shape[0]
    prog = ScanGraph(clone_to(state, state["bval"].device), steps=1, txns=T,
                     reads=T, writes=T,
                     max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
                     strided=True)
    one_batch = {k: v[None] for k, v in batch.items()}
    gfuncs, gwall = profile_device(lambda: prog.run(one_batch), 3)
    gbusy = busy_ms(gfuncs)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / wall_ms),
            "kernels_device_ms": {k: device_ms_of(funcs, k)
                                  for k in STEP_KERNELS},
            "radix_sort_device_ms": radix_sort_ms(funcs),
            "top_device_functions": [(k[:80], v[0]) for k, v in top],
            "graph": {"wall_ms": gwall / 3 * 1e3, "device_busy_ms": gbusy,
                      "device_idle_share": max(
                          0.0, 1 - gbusy / (gwall / 3 * 1e3)),
                      "kernels_device_ms": {k: device_ms_of(gfuncs, k)
                                            for k in STEP_KERNELS},
                      "top_device_functions": [
                          (k[:80], v[0]) for k, v in sorted(
                              gfuncs.items(), key=lambda kv: -kv[1][0])[:12]]}}


def level_sort_time(calls, reps=20):
    """The level geometry of the scan evaluator timed alone on the
    captured step's call: the plain phase (CUDA-event ms, device ms, and
    its cub radix sort's device ms), K9 (ms, device ms) and the library
    call, the lone stable `torch.sort` of the plain phase's packed keys
    (ms, device ms)."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    a, kw = calls["intra_levels"][-1]
    packed = ref.level_sort_keys(*a)
    runs = {"plain": lambda: ref.intra_levels(*a, **kw),
            "k9": lambda: kernels.intra_levels(*a, **kw),
            "library": lambda: torch.sort(packed, dim=1, stable=True)}
    out = {}
    for label, run in runs.items():
        funcs, _wall = profile_device(run, reps)
        out[f"{label}_ms"] = time_cuda(run, reps)
        out[f"{label}_device_ms"] = busy_ms(funcs)
        if label == "plain":
            out["plain_sort_device_ms"] = radix_sort_ms(funcs)
    return out


def kernel_bench_phase(dev, T, n_batches, chunk, n_oracle, capacity):
    """Phase 5 at one batch size: the port's run_kernel on the card (its
    launches counted), then the oracle and plain-phase checks of its
    statuses, then K1-K4, K6-K9 and the rebase held to their plain versions
    on the calls of the plain chunk's last step. Returns (bench numbers,
    kernel numbers)."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    KNOBS.reset()
    detail: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    kernels.level_paths(reset=True)
    t0 = time.perf_counter()
    res = bench.run_kernel(T, n_batches, chunk, capacity=capacity,
                           device=dev, detail=detail)
    res["launches"] = {k: kernels.LAUNCHES[k] for k in STEP_KERNELS}
    res["level_paths"] = kernels.level_paths()
    res["call_s"] = time.perf_counter() - t0
    res["boundaries_final"] = int(detail["state"]["nb"])
    res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    log(f"kernel bench T={T}: " + json.dumps(res))
    if any(v <= 0 for v in res["launches"].values()):
        fail(f"kernel bench T={T}: a kernel never launched: "
             f"{res['launches']}")
    once_a_step(f"kernel bench T={T}", res["launches"])
    # the strided layout's owners are in order and no span overfills, so
    # every K9 launch of the bench takes the span path but one: the scan
    # graph's warm-up step before its capture runs on an all-padding
    # batch, whose elements all fall in the last span
    if res["level_paths"]["general"] > 1:
        fail(f"kernel bench T={T}: K9 took the general path on bench "
             f"batches: {res['level_paths']}")
    t0 = time.perf_counter()
    bench_oracle_check(detail, T, n_oracle)
    res["oracle_batches"] = n_oracle
    res["oracle_check_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    calls = bench_plain_check(dev, detail, T)
    res["plain_chunk_check_s"] = time.perf_counter() - t0
    log(f"kernel bench T={T}: {n_oracle} warm batches equal to the oracle "
        f"({res['oracle_check_s']:.1f} s); the first timed chunk equal to "
        f"the eager kernels and the plain phases, statuses and state "
        f"({res['plain_chunk_check_s']:.1f} s)")
    res["graph_ab"] = bench_graph_ab(dev, detail, T)
    if T == 16384:
        res["step_profile"] = profile_bench_step(dev, detail)
        log(f"kernel bench T={T} step profile: "
            + json.dumps(res["step_profile"]))
    del detail
    res["level_sort"] = level_sort_time(calls)
    log(f"kernel bench T={T} level geometry alone (plain, K9, torch.sort): "
        + json.dumps(res["level_sort"]))
    kres: dict = {}
    check_kernels(dev, calls, kres, f"bench T={T}", edges=False)
    res["sort_and_rank"] = {k: kres["sort_and_rank"][k] for k in (
        "device_ms", "ms", "host_ms", "bound_ms", "launches_per_call")}
    del calls
    torch.cuda.empty_cache()
    return res, kres


def ablate_phase(dev, T=16384, n_batches=10):
    """Phase 5's ablation profile (`bench.run_ablate`, the counterpart of
    scripts/profile_kernel.py) at T=16,384: the full scan and the six
    ablations through their graphs; each mode's first run (statuses,
    committed, overflow and the state after it) must equal `conflict_scan`
    with the plain phases and the same `ablate`, from the same state."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    KNOBS.reset()
    detail: dict = {}
    out = bench.run_ablate(T, n_batches, device=dev, detail=detail)
    plain = type(ref.PLAIN)(**dict(vars(ref.PLAIN),
                                   intra_sandwich=pinch_read_sandwich))
    for mode, run in detail["runs"].items():
        state = clone_to(detail["warmed"], dev)
        _s, st, comm, ovf = ref.conflict_scan(
            state, detail["batches"],
            max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
            strided=True, phases=plain, ablate=mode, out=state)
        torch.cuda.synchronize()
        got = (run["statuses"], run["committed"], run["overflow"])
        if not all(torch.equal(a, b) for a, b in zip(got, (st, comm, ovf))):
            fail(f"--ablate {mode or 'full'}: the graph's verdicts differ "
                 f"from the plain step's")
        for k, v in state.items():
            if not torch.equal(v, run["state"][k]):
                fail(f"--ablate {mode or 'full'}: state[{k}] differs from "
                     f"the plain step's")
    out["modes_equal_to_plain"] = len(detail["runs"])
    log("ablation profile: " + json.dumps(out))
    return out


def ab_phase(dev, T=16384, n_batches=8):
    """Phase 6: scan against legacy at T=16,384 over 8 batches, each
    evaluator through its one-step scan graph; equal statuses on every
    batch, and K5 launched once a step (the whole fixpoint) and once for
    the capture's warm-up step."""
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    KNOBS.reset()
    kernels.reset_launches()
    out = bench.run_kernel_ab(T, n_batches, device=dev)
    out["launches"] = {k: kernels.LAUNCHES[k]
                       for k in STEP_KERNELS + ("legacy_blocked",)}
    log("evaluator A/B: " + json.dumps(out))
    if not out["statuses_equal"]:
        fail("evaluator A/B: scan and legacy statuses differ")
    if any(v <= 0 for v in out["launches"].values()):
        fail(f"evaluator A/B: a kernel never launched: {out['launches']}")
    if not out["graphed"]:
        fail("evaluator A/B: the steps did not run through their graphs")
    if out["launches"]["legacy_blocked"] != n_batches + 1:
        fail(f"evaluator A/B: {out['launches']['legacy_blocked']} K5 "
             f"launches for {n_batches} legacy steps and a warm-up step")
    return out


def probes_phase(dev):
    """Phase 7: one launch's floor (time_floor), printed first; then
    probe_dynwrite held to its plain version at the script's shape and on
    its edges (`probes.dynwrite_edge_calls`: offsets below zero, at and
    past the last row, rows running past the end, C off a multiple of 4);
    then the probes' main at the Pallas scripts' shapes, its launches
    counted alone."""
    from foundationdb_tpu_torch.ops import kernels, probes
    floor = time_floor(dev)
    log("phase 7: one launch's floor (probe_add on one element): "
        + json.dumps(floor))
    dyn = [probes.script_calls(dev)["probe_dynwrite"]] \
        + probes.dynwrite_edge_calls(dev)
    equal_on_calls("probe_dynwrite", probes.dynwrite, probes.dynwrite_plain,
                   dyn)
    log(f"phase 7: probe_dynwrite equal to plain on {len(dyn)} calls")
    kernels.reset_launches()
    out = {"floor": floor, "dynwrite_calls_equal": len(dyn),
           "ms_per_pass": probes.main(dev)}
    out["launches"] = {k: kernels.LAUNCHES[k] for k in probes.WRAPPERS}
    log("probes: " + json.dumps(out))
    if any(v <= 0 for v in out["launches"].values()):
        fail(f"probes: a kernel never launched: {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the sharded engine
# ---------------------------------------------------------------------------

SHARDED_W = 4  # shards on the one card
SHARDED_BATCHES = 80  # 8a: the load check comes due at batch 64
SHARDED_JUMP_AT = 32  # 8a: this batch's version jumps 2^29 (every shard rebases)
SHARDED_BENCH_T = 16384
SHARDED_BENCH_BATCHES = 50
INFO_FIELDS = ("overflow", "boundaries", "committed", "converged",
               "eligible")


def shard_oracle_detect(oracles, cuts, txns, version):
    """The clipped-oracle model (tests/test_sharded.py:66-97): oracle d is
    fed every txn with its ranges clipped to [cuts[d], cuts[d + 1]) (empty
    ones dropped); the verdicts combine by min, the proxy's rule."""
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    n = len(oracles)

    def clip(pairs, lo, hi):
        out = []
        for b, e in pairs:
            b2, e2 = max(b, lo), (e if hi is None else min(e, hi))
            if b2 < e2:
                out.append((b2, e2))
        return out
    verdicts = []
    for d in range(n):
        lo, hi = cuts[d], (cuts[d + 1] if d + 1 < n else None)
        verdicts.append(oracles[d].detect(
            [TxnConflictInfo(t.read_snapshot, clip(t.read_ranges, lo, hi),
                             clip(t.write_ranges, lo, hi)) for t in txns],
            version))
    return [min(v[t] for v in verdicts) for t in range(len(txns))]


def flat_combine(fn):
    """K11 or its plain version, returning (statuses, *info, row) flat."""
    def run(*a, **kw):
        st, info, row = fn(*a, **kw)
        if list(info) != list(INFO_FIELDS):
            fail(f"shard_combine: info fields {list(info)}")
        return (st, *info.values(), row)
    return run


def shard_cuts(dev, W):
    """(lo, hi), (W, L) int32 on `dev`: the equal cuts of W shards, the
    last hi the all-ones sentinel."""
    import torch

    from foundationdb_tpu_torch.parallel.sharded_conflict import shard_cut_keys
    c = torch.from_numpy(shard_cut_keys(W)).to(dev)
    return c[:W].contiguous(), c[1:].contiguous()


# K10's shape edges (W, L, NR, NW): one limb and the widest key, column
# counts off a multiple of 4 (1 among them), no reads or no writes, one
# shard and 64
CLIP_SHAPE_EDGES = ((1, 1, 5, 3), (4, 1, 1, 0), (64, 7, 1, 1),
                    (4, 17, 6, 0), (4, 17, 0, 9), (64, 17, 13, 7),
                    (8, 1, 4, 4), (1, 17, 1, 1), (2, 7, 4099, 4097),
                    (64, 5, 256, 256))


def clip_shape_edge_calls(dev):
    """K10's inputs at CLIP_SHAPE_EDGES, sign-flipped int32 limbs drawn
    from a seeded numpy generator: W + 1 increasing cuts from the empty
    key's limbs (all INT_MIN) to the all-ones sentinel (PAD_LIMB), limbs
    drawn from few values so that keys share prefixes; endpoints drawn
    from the cuts, the cuts one below and one above in their last limb,
    random keys and the padding key, and where a call has five columns or
    more, its first five a range wholly below a cut, one wholly above it,
    one straddling it, an inverted one and a padding one. Shared with
    tests/test_torch_sharded.py, which holds the plain clip to JAX's
    `_clip_ranges` on them."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    rng = np.random.default_rng(83)
    lo32, pad = np.int32(-2 ** 31), np.int32(ref.PAD_LIMB)
    out = []
    for W, L, NR, NW in CLIP_SHAPE_EDGES:
        vals = (np.array([lo32, -5, 0, 7, pad - 1], np.int32) if L > 1
                else None)
        keys = set()
        while len(keys) < W - 1:
            k = (rng.choice(vals, L) if vals is not None
                 else rng.integers(-2 ** 31 + 2, 2 ** 31 - 2, 1)).astype(
                     np.int32)
            keys.add(tuple(int(v) for v in k))
        cuts = np.array([(int(lo32),) * L] + sorted(keys) + [(int(pad),) * L],
                        np.int32)

        def nudge(k, delta):  # k one step away in its last limb
            k = k.copy()
            k[-1] = np.int32(min(max(int(k[-1]) + delta, -2 ** 31), int(pad)))
            return k
        near = [nudge(c, d) for c in cuts[1:-1] for d in (-1, 1)]
        rand = (rng.choice(vals, (16, L)) if vals is not None
                else rng.integers(-2 ** 31, 2 ** 31, (16, L))).astype(np.int32)
        pool = np.concatenate([cuts, np.array(near, np.int32).reshape(-1, L),
                               rand, np.full((2, L), pad, np.int32)])
        m = cuts[(W + 1) // 2]  # a cut inside the keyspace (or the top)
        below, above = nudge(m, -1), nudge(m, 1)
        kinds = ((cuts[0], below), (above, np.full(L, pad, np.int32)),
                 (below, above), (above, below),
                 (np.full(L, pad, np.int32), np.full(L, pad, np.int32)))

        def ends(n):
            b = pool[rng.integers(0, len(pool), n)].T.copy()
            e = pool[rng.integers(0, len(pool), n)].T.copy()
            if n >= len(kinds):
                for j, (kb, ke) in enumerate(kinds):
                    b[:, j], e[:, j] = kb, ke
            return b, e
        rb, re = ends(NR)
        wb, we = ends(NW)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (rb, re, wb, we, cuts[:W], cuts[1:])]
        out.append((tuple(t), {}))
    return out


def clip_edge_calls(dev):
    """K10's edge inputs: W = 1, 2, 4 and 8 on pooled batches (T=64) whose
    ranges begin or end at the cuts, lie wholly below, above or across
    them, are inverted or empty, or run to the top of the keyspace; T=1;
    an all-padding batch; endpoints that all equal a lo or a hi row, the
    last shard's all-ones sentinel among them; the strided layout at
    T=16,384 (the sharded bench's spread keys) at W = 4 and 8; and the
    shape edges of `clip_shape_edge_calls` (L = 1 and 17, N off a
    multiple of 4 and N = 1, no reads or no writes, W = 1 and 64)."""
    import torch

    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import (BatchEncoder,
                                                     _resolve_shapes)
    from foundationdb_tpu_torch.parallel.sharded_conflict import (
        shard_cut_bytes)
    rng = np.random.default_rng(81)
    g = torch.Generator().manual_seed(82)
    out = []
    for W in (1, 2, 4, 8):
        cb = shard_cut_bytes(W)[1:]
        pool = cb + [c + b"\x00" for c in cb] + [b"\xff" * 30] + [
            bytes(rng.integers(0, 256, rng.integers(1, 6)).astype(np.uint8))
            for _ in range(40)]

        def rrange():
            a, b = (pool[i] for i in rng.integers(0, len(pool), 2))
            kind = rng.integers(4)
            if kind == 0:
                return (max(a, b), min(a, b))  # inverted or empty
            if kind == 1:
                return (a, a + b"\x00")
            return (min(a, b), max(a, b) + b"\x00")
        lo, hi = shard_cuts(dev, W)
        for T, n in ((64, 64), (1, 1), (64, 0)):
            enc = BatchEncoder(_resolve_shapes(1024, T, 4, 4), dev)
            b = enc.encode_batch([TxnConflictInfo(
                0, [rrange() for _ in range(rng.integers(0, 5))],
                [rrange() for _ in range(rng.integers(0, 5))])
                for _ in range(n)], 100)
            out.append((tuple(b[k].clone() for k in ("rb", "re", "wb", "we"))
                        + (lo, hi), {}))
        rows = torch.cat([lo, hi[-1:]])  # every cut and the sentinel
        ends = tuple(rows[torch.randint(0, W + 1, (256,), generator=g)
                          .to(dev)].T.contiguous() for _ in range(4))
        out.append((ends + (lo, hi), {}))
    return out + [clip_8c_call(dev, W) for W in (4, 8)] \
        + clip_shape_edge_calls(dev)


def combine_edge_calls(dev):
    """K11's edge inputs: W = 1, 2, 4 and 8 shards' random verdicts
    (statuses in {0, 1, 2}, eligible, overflow, boundaries, converged),
    at T = 1, 1,000, 1,024 and 16,384, with txn_valid all, some or none
    (an all-padding chunk)."""
    import torch
    g = torch.Generator().manual_seed(91)
    out = []
    for W, T, p_valid in ((1, 1, 1.0), (2, 1000, 0.7), (4, 16384, 0.9),
                          (8, 1024, 0.0), (8, 16384, 1.0), (4, 1, 0.0)):
        def flags(p, shape=()):
            return [(torch.rand(shape, generator=g) < p).to(dev)
                    for _ in range(W)]
        st = [torch.randint(0, 3, (T,), generator=g, dtype=torch.int32)
              .to(dev) for _ in range(W)]
        bd = [torch.randint(0, 1 << 20, (), generator=g, dtype=torch.int32)
              .to(dev) for _ in range(W)]
        valid = (torch.rand(T, generator=g) < p_valid).to(dev)
        out.append(((st, flags(0.8, (T,)), flags(0.3), bd, flags(0.8),
                     valid), {}))
    return out


def equal_on_calls(name, kern, plain, calls) -> int:
    """Hold `kern` to `plain` on every call, exactly; no timing. Returns
    the number of calls."""
    import torch
    for a, kw in calls:
        want, got = plain(*a, **kw), kern(*a, **kw)
        torch.cuda.synchronize()
        if isinstance(want, dict):
            want, got = tuple(want.values()), tuple(got.values())
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for i, (w, g_) in enumerate(zip(want, got)):
            if w.dtype != g_.dtype or not torch.equal(w, g_):
                fail(f"{name} output {i} differs from its plain version")
    return len(calls)


def sharded_engine_phase(dev, seed):
    """8a: the sharded engine at the default knobs (K=65,536 a shard,
    T=1,024, 4 point reads and 4 point writes a txn), W=4 shards on the one
    card, over SHARDED_BATCHES batches of phase A's zipfian mix over 20,000
    keys (16-byte hashes: see `zipf_keys`), batch SHARDED_JUMP_AT's
    version 2^29 further (every shard rebases). Every chunk must be one
    replay of the engine's chunk graph (`graphed`). Every batch must equal the
    same engine with the plain phases on the card (its sandwich stopping at
    the pinch, `pinch_read_sandwich`), and the clipped-oracle model, each
    re-cut applied to it before the batch the engine made it for; the
    load check at batch
    64 must re-cut; no chunk may be unconverged and no shard poison; after
    the last batch every shard's state must equal the plain engine's,
    field for field. Launch counts are zeroed just before the run: K10 and
    K11 once a chunk, the step's kernels W times a chunk. Returns the
    numbers and the plain engine's phase calls of four batches (the first,
    the jump, the re-cut and the last)."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.conflict import kernel_metrics
    from foundationdb_tpu_torch.ops.conflict_oracle import OracleConflictSet
    from foundationdb_tpu_torch.parallel.sharded_conflict import (
        ShardedDeviceConflictSet)
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    KNOBS.reset()
    W = SHARDED_W
    cdf, keys = zipf_keys(20_000, hex_only=True)
    t0 = time.perf_counter()
    batches = make_batches(np.random.default_rng(seed), cdf, keys,
                           SHARDED_BATCHES, jump_at=SHARDED_JUMP_AT)
    gen_s = time.perf_counter() - t0
    calls: dict = {}
    record = {"on": False}
    plain = ShardedDeviceConflictSet(
        devices=[dev] * W, phases=spied_phases(calls, dev, record=record,
                                               sandwich=pinch_read_sandwich))
    eng = ShardedDeviceConflictSet(devices=[dev] * W)
    if not eng.graphed or plain.graphed:
        fail(f"phase 8a: the engine's chunk graphed={eng.graphed}, the "
             f"plain engine's {plain.graphed} (want True, False)")
    eng._program.capture()  # before the counts are zeroed, as a warmup
    cuts0 = list(eng.cut_bytes)
    cuts_now, recorded = cuts0, {}
    record_cuts(eng, recorded)
    oracles = [OracleConflictSet() for _ in range(W)]

    def dispatches():
        return kernel_metrics.as_dict()["KernelDispatches"]
    unconverged0 = kernel_metrics.as_dict()["UnconvergedChunks"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    chunks, eng_s, model_checked, first_recut = 0, 0.0, 0, None
    for i, (_prev, version, txns) in enumerate(batches):
        d0, t = dispatches(), time.perf_counter()
        got = eng.detect(txns, version)
        eng_s += time.perf_counter() - t
        chunks += dispatches() - d0
        if eng.rebalances and first_recut is None:
            first_recut = i
        record["on"] = i in (0, SHARDED_JUMP_AT, first_recut,
                             SHARDED_BATCHES - 1)
        if plain.detect(txns, version) != got:
            fail(f"phase 8a: batch {i}'s statuses differ between the "
                 f"kernels and the plain phases")
        record["on"] = False
        while recorded["recuts"]:
            at, new = recorded["recuts"].pop(0)
            recut_oracles(oracles, cuts_now, new, at)
            cuts_now = new
        if shard_oracle_detect(oracles, cuts_now, txns, version) != got:
            fail(f"phase 8a: batch {i} differs from the clipped-oracle "
                 f"model")
        model_checked += 1
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in PATH_KERNELS + SHARD_KERNELS}
    unconverged = kernel_metrics.as_dict()["UnconvergedChunks"] - unconverged0
    got_np = ref.sharded_state_to_numpy(eng._state)
    want_np = ref.sharded_state_to_numpy(plain._state)
    for k in want_np:
        if not np.array_equal(got_np[k], want_np[k]):
            fail(f"phase 8a: state[{k}] differs between the kernels and the "
                 f"plain phases after the last batch")
    n_txns = sum(len(b[2]) for b in batches)
    out = {"shards": W, "batches": len(batches), "txns": n_txns,
           "graphed": eng.graphed,
           "chunks": chunks, "unconverged_chunks": unconverged,
           "rebalances": eng.rebalances, "first_recut_batch": first_recut,
           "cuts_before": [c.hex() for c in cuts0],
           "cuts_after": [c.hex() for c in eng.cut_bytes],
           "model_checked_batches": model_checked,
           "boundaries": got_np["nb"].tolist(),
           "poisoned": got_np["poisoned"].tolist(),
           "base_version": eng.base_version,
           "engine_ms_per_batch": eng_s / len(batches) * 1e3,
           "traffic_gen_s": gen_s, "launches": launches}
    log("phase 8a: " + json.dumps(out))
    if eng.rebalances == 0:
        fail("phase 8a: the load check never re-cut the shards")
    if first_recut is None or first_recut < 16 \
            or model_checked != len(batches):
        fail(f"phase 8a: the re-cut came at batch {first_recut}, "
             f"{model_checked} of {len(batches)} batches held to the "
             f"clipped-oracle model")
    if unconverged or any(got_np["poisoned"]):
        fail(f"phase 8a: {unconverged} unconverged chunks, poisoned "
             f"{got_np['poisoned'].tolist()}")
    if eng.base_version == 0:
        fail("phase 8a: the version jump did not rebase")
    for k, n in launches.items():
        want = chunks if k in SHARD_KERNELS else W * chunks
        if k == "rebase_table":
            want = W
        if k == "sparse_table":
            want = W * (chunks + eng.rebalances)
        if n != want or n == 0:
            fail(f"phase 8a: {n} {k} launches, {want} expected ({chunks} "
                 f"chunks, {W} shards, {eng.rebalances} re-cuts, 1 rebase)")
    return out, calls


def sharded_bench_phase(dev, W):
    """8c at one width: run_sharded_kernel(16,384, SHARDED_BENCH_BATCHES, W)
    with every shard on the card (K=2^18 a shard, strided, 24-byte spread
    keys), a batch a replay of the chunk's graph, then the same run with
    the chunk eager (`graphed=False`, its ms/batch beside the graph's).
    No shard may overflow; every batch's statuses and the final state must
    equal between the two; the first timed batch must equal the sharded
    step with the plain phases on the card, state for state; at W = 1
    every timed batch's statuses must equal the unsharded step with the
    kernels. Returns the numbers and the plain step's K10 and K11
    calls."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.conflict import ConflictShapes
    from foundationdb_tpu_torch.parallel.sharded_conflict import (
        sharded_conflict_step)
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    KNOBS.reset()
    T = SHARDED_BENCH_T
    detail: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = bench.run_sharded_kernel(T, SHARDED_BENCH_BATCHES, W,
                                   devices=[dev] * W, detail=detail)
    res["call_s"] = time.perf_counter() - t0
    res["launches"] = {k: kernels.LAUNCHES[k]
                       for k in STEP_KERNELS + SHARD_KERNELS}
    if not res["graphed"]:
        fail(f"phase 8c W={W}: the sharded chunk did not run as a graph")
    eager_detail: dict = {}
    eager = bench.run_sharded_kernel(T, SHARDED_BENCH_BATCHES, W,
                                     devices=[dev] * W, graphed=False,
                                     detail=eager_detail)
    res["eager_ms_per_batch"] = eager["ms_per_batch"]
    for i, (a, b) in enumerate(zip(detail["statuses"],
                                   eager_detail["statuses"])):
        if not torch.equal(a, b):
            fail(f"phase 8c W={W}: batch {i}'s statuses differ between the "
                 f"graph and the eager chunk")
    want_np = ref.sharded_state_to_numpy(eager_detail["state"])
    for k, v in ref.sharded_state_to_numpy(detail["state"]).items():
        if not np.array_equal(want_np[k], v):
            fail(f"phase 8c W={W}: state[{k}] differs between the graph and "
                 f"the eager chunk")
    del eager_detail, want_np
    res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    res["boundaries_final"] = [int(s["nb"]) for s in detail["state"]["shards"]]
    if W > 1:
        res["note"] = (f"{W} shards share one card: about {W} steps a "
                       f"batch, the cost of sharding, not its scaling")
    log(f"phase 8c W={W}: " + json.dumps(res))
    # the warm-up batch, the timed ones and the capture's warm-up step
    steps = SHARDED_BENCH_BATCHES + 2
    for k, n in res["launches"].items():
        # K1 also built each shard's empty table
        want = steps if k in SHARD_KERNELS else W * steps
        if n != want + (W if k == "sparse_table" else 0):
            fail(f"phase 8c W={W}: {n} {k} launches for {steps} batches")
    calls: dict = {}
    shapes = ConflictShapes(capacity=bench.CAPACITY, txns=T, reads=T,
                            writes=T, strided=True)
    spied = spied_phases(calls, dev)
    phases = type(ref.PLAIN)(**dict(vars(ref.PLAIN),
                                    intra_sandwich=pinch_read_sandwich,
                                    clip_ranges=spied.clip_ranges,
                                    shard_combine=spied.shard_combine))
    step = sharded_conflict_step(
        [dev] * W, shapes, KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS, "scan",
        T // 2 + 1, phases=phases)
    state1, st1, _info = step(detail["state_after_warm"],
                              detail["batches"][0])
    torch.cuda.synchronize()
    if not torch.equal(st1, detail["statuses"][0]):
        fail(f"phase 8c W={W}: the first timed batch's statuses differ "
             f"from the plain phases")
    got_np = ref.sharded_state_to_numpy(detail["state_after_first"])
    for k, v in ref.sharded_state_to_numpy(state1).items():
        if not np.array_equal(got_np[k], v):
            fail(f"phase 8c W={W}: state[{k}] after the first timed batch "
                 f"differs from the plain phases")
    del state1
    if W == 1:
        state = ref.init_state(bench.CAPACITY, shapes.limbs, dev,
                               phases=kernels.PHASES)
        for i, b in enumerate([detail["warm"]] + detail["batches"]):
            state, st, _info = ref.conflict_step(
                state, b, max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
                intra_rounds=T // 2 + 1, strided=True, phases=kernels.PHASES)
            if i and not torch.equal(st, detail["statuses"][i - 1]):
                fail(f"phase 8c W=1: batch {i - 1}'s statuses differ from "
                     f"the unsharded step")
        res["equal_to_unsharded_batches"] = SHARDED_BENCH_BATCHES
        del state
    del detail
    torch.cuda.empty_cache()
    return res, calls


def check_sharded_kernels(dev, calls8a, calls8c) -> dict:
    """The step's kernels held to their plain versions on 8a's captured
    calls (ties at the cuts, clipped-inverted reads, the rebase at the
    jump, the tables of the re-cut), exactly, untimed; then K10 and K11
    held to theirs on 8a's and 8c's calls and the edges, timed at 8a's
    shapes (W=4, T=1,024, NR=NW=4,096) and at 8c's (W=4, T=16,384)."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    wrappers, checks = step_wrappers()
    calls = dict(calls8a, **sort_rank_part_calls(calls8a["sort_and_rank"]))
    held = {}
    for name, (kern, plain) in wrappers.items():
        kern, plain = checks.get(name, (kern, plain))
        if not calls.get(name):
            fail(f"phase 8: no {name} call was captured from 8a")
        held[name] = equal_on_calls(name, kern, plain, calls[name])
    log(f"phase 8: the step's kernels equal to plain on 8a's calls: {held}")
    res = {"held_on_8a_calls": held}
    combine = (flat_combine(kernels.shard_combine),
               flat_combine(ref.shard_combine))
    for name, kern, plain, edges, check in (
            ("shard_clip", kernels.clip_ranges, ref.clip_ranges,
             clip_edge_calls(dev), None),
            ("shard_combine", kernels.shard_combine, ref.shard_combine,
             combine_edge_calls(dev), combine)):
        res[name] = hold_to_plain(name, kern, plain,
                                  calls8a[name] + calls8c[name] + edges,
                                  calls8a[name][-1], "8a", check=check)
        res[name]["bench_16384_w4"] = hold_to_plain(
            name, kern, plain, [], calls8c[name][-1], "8c W=4", check=check)
    return res


# ---------------------------------------------------------------------------
# --time-kernels: the step kernels' device time, alone
# ---------------------------------------------------------------------------

def time_step_kernels(dev, reps=50):
    """Device ms a call of K1-K4, K6-K9, K13 and the rebase (and of the
    whole sort-and-rank phase; K2 as `masks_and_history` and as
    `history_check` on given owners, and K12 `step_masks` where the package
    still has it) on the captured calls of cell A's step,
    of a default-knobs step on phase B's traffic (`B_traffic`: K2's masks,
    K6, K8 and K9 see B's batches; the state is K=65,536, not B's 2^20)
    and of a
    kernel-bench step at T=16,384 (K=2^18) and T=32,768 (K=2^19), of K9
    alone at T=2^20 (`intra_levels_t_2_20`, big_step_calls), of K7 at cell
    B's K=2^20 (`B_k_2_20`, merge_b_call),
    and of that bench step with the kernels: every device function the
    call launches (profile_device), the step's radix-sort and cummax-scan
    share; each wrapper's host ms a call (`reps` enqueues, no sync); and
    ms a step of a 20-batch bench scan through its graph and eagerly
    (`time_scan_graph`). Then K5 (`time_legacy`), K10 and K11 at W = 1
    and 4 (`time_sharded_step`) and the sharded chunk graphed and eager
    (`time_sharded_chunk`). K6 also by each of its two paths at each
    shape, whichever the plan takes (`endpoint_sort_rounds`: the tile sort
    and the merge rounds; `endpoint_sort_sample`: the sample sort), and
    K6's two paths on cell A's and the bench's traffic at 16 to 128 tiles
    (`sort_paths`, time_sort_paths), and K13 at T = 2^18 and 2^20
    (`step_verdicts_t_2_18`, `_t_2_20`), and the rank-join probes
    (`probes`, time_probes). K6-K8, K9, the rebase, K10-K13 and the graphs
    are timed where the package has them, so a copy of this script beside
    an older checkout's package times that checkout alike."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    wrappers = {"sparse_table": kernels.build_table,
                "history_check": kernels.history_check,
                "intra_sandwich": kernels.intra_sandwich,
                "merge_compact": kernels.merge_compact}
    if hasattr(kernels, "sort_and_rank"):
        wrappers.update(sort_and_rank=kernels.sort_and_rank,
                        endpoint_sort=kernels.endpoint_sort,
                        endpoint_ranks=kernels.endpoint_ranks,
                        state_merge=kernels.state_merge)
    if hasattr(kernels, "intra_levels"):
        wrappers.update(intra_levels=kernels.intra_levels,
                        rebase_table=kernels.rebase_table)
    if hasattr(kernels, "step_masks"):
        wrappers["step_masks"] = kernels.step_masks
    if hasattr(kernels, "step_verdicts"):
        wrappers["step_verdicts"] = kernels.step_verdicts
    if hasattr(kernels, "masks_and_history"):
        wrappers["masks_and_history"] = kernels.masks_and_history
    if hasattr(kernels, "sort_plan"):  # K6 by its rounds and sample paths
        wrappers["endpoint_sort_rounds"] = \
            lambda *a: forced_sort(*a, samples=0)
        wrappers["endpoint_sort_sample"] = \
            lambda *a: forced_sort(*a, samples=kernels.sort_samples(
                2 * a[0].shape[1] + 2 * a[2].shape[1], a[0].shape[0]),
                tie_limit=2 ** 31 - 1)
    cdf, keys = zipf_keys(20_000)
    cells = {"A": (None, None, capture_main_path_calls(dev, make_batches(
        np.random.default_rng(100), cdf, keys, 4)))}
    # phase B's traffic (zipfian over 400,000 keys) at the default knobs:
    # the batch-only kernels (K6, K8, K9, K3, K2's masks) see B's inputs,
    # the state-sized ones (K1, K2, K4, K7) K=65,536, not B's 2^20
    cdf_b, keys_b = zipf_keys(400_000)
    cells["B_traffic"] = (None, None, capture_main_path_calls(
        dev, make_batches(np.random.default_rng(102), cdf_b, keys_b, 4)))
    for T, capacity in ((16384, 1 << 18), (32768, 1 << 19)):
        cells[f"bench_{T}"] = bench_step_calls(dev, T, capacity)
    out = {}
    if hasattr(kernels, "intra_levels"):  # K9 at T = 2^20, 1 read/write
        (big, _kw), _sandwich = big_step_calls(dev)
        funcs, _wall = profile_device(lambda: kernels.intra_levels(*big), 5)
        out["intra_levels_t_2_20"] = {"device_ms": busy_ms(funcs)}
        del big, _sandwich
        kernels.release_scratch()
    out["legacy"] = time_legacy(dev)
    if hasattr(kernels, "clip_ranges"):
        for W in (1, SHARDED_W):
            out[f"sharded_bench_16384_w{W}"] = time_sharded_step(dev, reps, W)
        out["sharded_chunk_16384"] = time_sharded_chunk(dev)
    if "state_merge" in wrappers:  # K7 at cell B's K = 2^20
        a, _kw = merge_b_call(dev)
        funcs, _wall = profile_device(lambda: kernels.state_merge(*a), reps)
        out["B_k_2_20"] = {"state_merge": {"device_ms": busy_ms(funcs)}}
        del a
    if "step_verdicts" in wrappers:  # K13 past the cluster's one pass
        g = torch.Generator().manual_seed(67)
        for log2 in (18, 20):
            a = [(torch.rand(1 << log2, generator=g) < p).to(dev)
                 for p in (0.6, 0.2, 0.9, 0.5)]
            a += [torch.tensor(True, device=dev),
                  torch.tensor(False, device=dev)]
            funcs, _wall = profile_device(
                lambda: kernels.step_verdicts(*a), reps)
            out[f"step_verdicts_t_2_{log2}"] = {"device_ms": busy_ms(funcs)}
        del a
    if hasattr(kernels, "sort_plan"):
        out["sort_paths"] = time_sort_paths(dev, reps)
    out["probes"] = time_probes(dev)
    out["floor_and_redesigns"] = time_floor_and_redesigns(dev, reps)
    for cell, (state, batch, calls) in cells.items():
        row = out[cell] = {}
        if "sort_and_rank" in calls:
            calls.update(sort_rank_part_calls(calls["sort_and_rank"][-1:]))
            calls["endpoint_sort_rounds"] = calls["endpoint_sort"]
            calls["endpoint_sort_sample"] = calls["endpoint_sort"]
        calls["rebase_table"] = [rebase_call(calls)]
        if "masks_and_history" in calls:  # K2 on given owners too
            calls["history_check"] = history_calls(calls["masks_and_history"])
        for name, kern in wrappers.items():
            a, kw = calls[name][-1]
            funcs, _wall = profile_device(lambda: kern(*a, **kw), reps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                kern(*a, **kw)
            host_ms = (time.perf_counter() - t0) / reps * 1e3
            torch.cuda.synchronize()
            row[name] = {"device_ms": busy_ms(funcs), "host_ms": host_ms}
        if state is not None:
            funcs, _wall = profile_device(lambda: ref.conflict_step(
                state, batch, max_write_life=bench.WINDOW, strided=True,
                phases=kernels.PHASES), 5)
            row["step"] = {
                "device_ms": busy_ms(funcs),
                "radix_sort_device_ms": sum(
                    v[0] for k, v in funcs.items() if "RadixSort" in k),
                "cummax_device_ms": sum(
                    v[0] for k, v in funcs.items()
                    if "scan_innermost_dim_with_indices" in k)}
            if hasattr(kernels, "step_verdicts"):  # the package has graphs
                row["scan"] = time_scan_graph(dev, state,
                                              batch["snapshot"].shape[0])
    return out


def time_floor(dev, reps=50) -> dict:
    """One launch's floor on the card: `probes.add` (probe_add) on a
    one-element tensor, its device ms a call by torch.profiler as every
    kernel row is timed (profile_device), its ms a call by CUDA events,
    its wrapper's host ms a call, and its ms a replay of a CUDA graph that
    holds that one launch."""
    import torch

    from foundationdb_tpu_torch.ops import probes
    x = torch.zeros(1, dtype=torch.int32, device=dev)
    return time_launch("probe_add", lambda: probes.add(x), reps)


def time_launch(name, fn, reps) -> dict:
    """Kernel wrapper `name` called as fn(): device ms a call (its device
    functions in profile_device), ms a call (CUDA events), host ms a call
    (`reps` enqueues, no sync) and ms a replay of a CUDA graph holding
    the one call."""
    import torch
    device_ms = None
    for _try in range(3):  # the profiler now and then reports no kernels
        device_ms = device_ms_of(profile_device(fn, reps)[0], name)
        if device_ms is not None:
            break
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    out = {"device_ms": device_ms, "ms": time_cuda(fn, reps),
           "host_ms": host_ms}
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # its scratch exists before the capture
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    out["graph_ms"] = time_cuda(graph.replay, reps)
    del graph
    return out


def clip_8a_call(dev, seed=84):
    """K10's inputs at phase 8a's chunk shape: W = 4 cuts, 1,024 txns of 4
    reads and 4 writes (NR = NW = 4,096, L = 7) over 16-byte random keys,
    pooled, through the engine's encoder."""
    from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
    from foundationdb_tpu_torch.ops.conflict import (BatchEncoder,
                                                     _resolve_shapes)
    rng = np.random.default_rng(seed)

    def key():
        return bytes(rng.integers(0, 256, 16).astype(np.uint8))
    enc = BatchEncoder(_resolve_shapes(1 << 16, 1024, 4, 4), dev)
    b = enc.encode_batch([TxnConflictInfo(
        0, [(k, k + b"\x00") for k in (key() for _ in range(4))],
        [(k, k + b"\x00") for k in (key() for _ in range(4))])
        for _ in range(1024)], 100)
    return (tuple(b[k].clone() for k in ("rb", "re", "wb", "we"))
            + shard_cuts(dev, SHARDED_W), {})


def clip_8c_call(dev, W=SHARDED_W):
    """K10's inputs at phase 8c's shape: the sharded bench's first staged
    batch at T = 16,384 (strided, NR = NW = 16,384, L = 7), W shards."""
    from foundationdb_tpu_torch import bench
    sp = bench.stage(bench._encode_spread_batches(
        1, seed=3, version0=bench.WINDOW, T=SHARDED_BENCH_T), dev)
    return (tuple(sp[k][0].contiguous() for k in ("rb", "re", "wb", "we"))
            + shard_cuts(dev, W), {})


def write_floor(n: int, dev, reps) -> float | None:
    """Device ms of one `fill_` of n int32 on the card: what one launch
    that writes a kernel's output bytes, and reads nothing, costs."""
    import torch
    buf = torch.empty(n, dtype=torch.int32, device=dev)
    return busy_ms(profile_device(lambda: buf.fill_(0), reps)[0])


def time_floor_and_redesigns(dev, reps=50) -> dict:
    """The one-launch floor (time_floor), then K10 at phase 8a's and 8c's
    shapes (clip_8a_call, clip_8c_call) and probe_dynwrite at the Pallas
    script's shape, each by time_launch with its bound (work_of), and
    beside each the device ms of one fill_ of its output bytes
    (write_floor); then K10 inside the sharded chunk's graph
    (time_clip_in_chunk). Each K10 and dynwrite call is first held to its
    plain version. The same method for any version of the port, so a copy
    of this script beside an older checkout's package times that checkout
    alike (`--time-floor`)."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels, probes
    out = {"floor": time_floor(dev, reps)}
    log("one launch's floor (probe_add, one element): "
        + json.dumps(out["floor"]))
    for label, (a, kw) in (("shard_clip_8a", clip_8a_call(dev)),
                           ("shard_clip_8c", clip_8c_call(dev))):
        want = ref.clip_ranges(*a)
        for g, w in zip(kernels.clip_ranges(*a), want):
            if not torch.equal(g, w):
                fail(f"{label}: K10 differs from its plain version")
        outs = tuple(torch.empty_like(w) for w in want)
        row = out[label] = time_launch(
            "shard_clip", lambda: kernels.clip_ranges(*a, out=outs), reps)
        row["bound_ms"], row["bound_by"] = bound_ms(*work_of(
            "shard_clip", a, kw))
        row["write_floor_device_ms"] = write_floor(
            sum(w.numel() for w in want), dev, reps)
        del outs, want, a
    (off, x), kw = probes.script_calls(dev)["probe_dynwrite"]
    if not torch.equal(probes.dynwrite(off, x, **kw),
                       probes.dynwrite_plain(off, x, **kw)):
        fail("probe_dynwrite differs from its plain version")
    row = out["probe_dynwrite"] = time_launch(
        "probe_dynwrite", lambda: probes.dynwrite(off, x, **kw), reps)
    row["bound_ms"], row["bound_by"] = bound_ms(*work_of(
        "probe_dynwrite", (off, x), kw))
    row["write_floor_device_ms"] = write_floor(
        kw["rows"] * x.shape[1], dev, reps)
    out["shard_clip_in_chunk"] = time_clip_in_chunk(dev)
    log("floor, K10 and probe_dynwrite: " + json.dumps(out))
    return out


def time_clip_in_chunk(dev, W=SHARDED_W, T=SHARDED_BENCH_T, n=20,
                       runs=3) -> dict:
    """K10 where the sharded engine runs it: `run_sharded_kernel(T, n, W)`
    on the card with the chunk graphed (K10, the W shard steps and K11
    one replay a batch), `runs` times: the ms a batch of every run but
    the middle one, which torch.profiler traces, capture included. From
    that trace, K10's device ms a launch, and the port's kernels' device
    ms a chunk (the step's and the shard kernels' device functions,
    summed, over K10's launches, one a chunk: the capture's eager warm-up
    step and the n + 1 replays), in all and by device function."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from foundationdb_tpu_torch import bench
    ours = sum((DEVICE_FUNCTIONS[k] for k in STEP_KERNELS + SHARD_KERNELS),
               ())
    out: dict = {"ms_per_batch": []}
    for i in range(runs):
        if i != runs // 2:
            out["ms_per_batch"].append(bench.run_sharded_kernel(
                T, n, W, devices=[dev] * W, graphed=True)["ms_per_batch"])
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bench.run_sharded_kernel(T, n, W, devices=[dev] * W,
                                     graphed=True)
            torch.cuda.synchronize()
        us: dict = {}
        clip_us = clip_n = 0.0
        for evt in prof.key_averages():
            t = _device_us(evt)
            if t <= 0 or not any(f in evt.key for f in ours):
                continue
            us[evt.key] = us.get(evt.key, 0.0) + t
            if any(f in evt.key for f in DEVICE_FUNCTIONS["shard_clip"]):
                clip_us, clip_n = clip_us + t, clip_n + int(evt.count)
        out["shard_clip_launches_traced"] = int(clip_n)
        if clip_n:
            out["shard_clip_device_ms"] = clip_us / clip_n / 1e3
            out["chunk_device_ms"] = sum(us.values()) / clip_n / 1e3
            out["chunk_device_ms_by_function"] = {
                k: v / clip_n / 1e3 for k, v in sorted(us.items())}
    return out


def time_probes(dev, reps=20):
    """The rank-join probes at the Pallas scripts' shapes: {probe: device
    ms a call (profile_device), ms a call (CUDA events), and ms/pass as
    phase 7 prints it (`probes.time_passes`)}."""
    from foundationdb_tpu_torch.ops import probes
    calls = probes.script_calls(dev)
    out = {}
    for name in ("probe_join", "probe_lexjoin"):
        a, kw = calls[name]
        fn = probes.WRAPPERS[name]

        def run(fn=fn, a=a, kw=kw):
            return fn(*a, **kw)
        out[name] = {"device_ms": busy_ms(profile_device(run, reps)[0]),
                     "ms": time_cuda(run, reps),
                     "ms_per_pass": probes.time_passes(run)}
    log("probes: " + json.dumps(out))
    return out


def sort_ties(keys: np.ndarray) -> int:
    """The ties K6's sample path counts in keys (L, M): in each sorted
    tile of SORT_TILE, the endpoints whose primary key (the tile's first
    varying limb and the next, unsigned) equals their predecessor's."""
    from foundationdb_tpu_torch.ops import kernels
    L, M = keys.shape
    u = keys.astype(np.int64) + 2 ** 31
    ties = 0
    for base in range(0, M, kernels.SORT_TILE):
        t = u[:, base:base + kernels.SORT_TILE]
        vary = np.flatnonzero((t != t[:, :1]).any(axis=1))
        if len(vary) == 0:
            ties += t.shape[1] - 1
            continue
        f = vary[0]
        prim = t[f] << 32 | (t[f + 1] if f + 1 < L else 0)
        ties += t.shape[1] - len(np.unique(prim))
    return ties


def tied_keys(M: int, L: int, share: float, seed: int) -> np.ndarray:
    """Keys (L, M) int32: random after a shared first limb, with a `share`
    of the endpoints copies of 64 hot keys (the ties of skewed traffic)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2 ** 31, 2 ** 31, (L, M)).astype(np.int32)
    keys[0] = 7
    hot = keys[:, :64].copy()
    pick = rng.random(M) < share
    keys[:, pick] = hot[:, rng.integers(0, 64, int(pick.sum()))]
    return keys


def time_sort_paths(dev, reps=50):
    """K6's device ms a call by each of its designs: `rounds` (the tile
    sort and the merge rounds, endpoint_merge_kernel), `sample` (the
    sample sort, never turning to the rounds), `turned` (the sample path's
    kernel turned to the merge rounds from its runs) and `plan` (the
    wrapper's own choice), at 16, 32, 64 and 128 tiles on cell A's traffic
    (zipfian, L = 7: 1, 2, 4 and 8 of its 1,024-txn batches side by side)
    and on the bench's (strided, L = 5: T = 4,096 to 32,768); and the
    first three at 16 and 128 tiles on `tied_keys` (L = 5) with 0 to 1/4
    of the endpoints copies of hot keys. Each output is held to the plain
    sort; `ties` is `sort_ties`' count, `ties_share` it over M."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.conflict import DeviceConflictSet
    sms = kernels._sm_count(dev)
    cdf, keys = zipf_keys(20_000)
    cs = DeviceConflictSet(device=dev)
    cell_a = [cs.encoder.encode_batch(txns, version) for _prev, version, txns
              in make_batches(np.random.default_rng(104), cdf, keys, 8)]
    ends = ("rb", "re", "wb", "we")
    inputs = {}
    for tiles in (16, 32, 64, 128):
        inputs[f"A_{tiles}_tiles"] = tuple(torch.cat(
            [b[k].to(dev) for b in cell_a[:tiles // 16]], dim=1).contiguous()
            for k in ends)
        staged = bench.stage(bench._encode_batches(
            1, seed=1, version0=bench.WINDOW, T=256 * tiles), dev)
        inputs[f"bench_{tiles}_tiles"] = tuple(
            staged[k][0].contiguous() for k in ends)
    for tiles in (16, 128):
        for share in (0, 1 / 64, 1 / 32, 1 / 16, 1 / 8, 1 / 4):
            M = tiles * kernels.SORT_TILE
            t = torch.from_numpy(tied_keys(M, 5, share, seed=tiles))
            inputs[f"tied_{share:.4f}_{tiles}_tiles"] = tuple(
                e.contiguous().to(dev)
                for e in torch.split(t, [M // 4] * 4, dim=1))
    never = 2 ** 31 - 1
    out = {}
    for name, a in inputs.items():
        L, M = a[0].shape[0], 2 * a[0].shape[1] + 2 * a[2].shape[1]
        s = kernels.sort_samples(M, L, sms)
        ties = sort_ties(torch.cat(a, dim=1).cpu().numpy())
        row = out[name] = {"M": M, "L": L, "samples": s, "ties": ties,
                           "ties_share": ties / M,
                           "plan_path": kernels.sort_plan(M, L, sms)["path"]}
        want = ref.endpoint_sort(*a)
        modes = {"rounds": {"samples": 0}}
        if s:
            modes.update(sample={"samples": s, "tie_limit": never},
                         turned={"samples": s, "tie_limit": -1})
        if not name.startswith("tied"):
            modes["plan"] = {}
        for mode, kw in modes.items():
            got = forced_sort(*a, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                fail(f"K6 ({mode}) differs from the plain sort on {name}")
            funcs, _wall = profile_device(lambda: forced_sort(*a, **kw), reps)
            row[mode] = busy_ms(funcs)
    return out


def time_scan_graph(dev, state, T, M=20, reps=3,
                    rounds=("graph", "eager", "eager", "graph")):
    """ms a step of a bench scan of M batches past `state` (CUDA events
    over `reps` runs after a warm-up run, each run from a copy of
    `state`), through the scan graph and eagerly, in turns."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops.step_graph import ScanGraph
    stacked = bench.stage(bench._encode_batches(
        M, seed=7, version0=bench.WINDOW + 13 * bench.VERSION_STEP, T=T), dev)
    out: dict = {label: [] for label in set(rounds)}
    for label in rounds:
        fixed = clone_to(state, dev)
        prog = ScanGraph(fixed, steps=M, txns=T, reads=T, writes=T,
                         max_write_life=bench.WINDOW, strided=True,
                         graphed=label == "graph")
        prog.run(stacked)
        total = 0.0
        for _ in range(reps):
            for k, v in state.items():
                fixed[k].copy_(v)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            prog.run(stacked)
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        out[label].append(total / reps / M)
        del prog, fixed
    return {f"{label}_ms_per_step": v for label, v in out.items()}


def legacy_fixpoint_args(call):
    """The fixpoint's arguments (g, wtxn, ...) from a recorded K5 call: the
    fixpoint's own, or, for a package whose K5 is one evaluation, its
    step's first evaluation (c = g, then the same arguments)."""
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    a, _kw = call
    return a if hasattr(ref, "legacy_fixpoint") else a[1:]


def time_legacy(dev, T=16384, reps=20):
    """K5 at T=16,384 (strided, K=2^18): the whole fixpoint of a legacy
    step and one evaluation of f (its first, c = g): device ms
    (profile_device), wall ms (CUDA events a call) and host ms; on the
    legacy step at the bench's warmed state (`bench_16384`) and on phase
    6's eight steps (`ab_16384`, summed; each step's fixpoint from the
    plain trajectory); then `run_kernel_ab(16384, 8)` itself
    (`legacy_ms_per_step`, through its graph where the package has one).
    For a package whose K5 is one evaluation, the fixpoint is
    `run_legacy` over it, as that package's step ran it: launches and a
    host read a body."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    KNOBS.reset()
    if hasattr(kernels, "legacy_fixpoint"):
        fixpoint = kernels.legacy_fixpoint
    else:
        def fixpoint(*a):
            return ref.run_legacy(lambda c: kernels.legacy_sweep(c, *a),
                                  a[0])

    def timed(fn, n):
        funcs, _wall = profile_device(fn, n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        return {"device_ms": busy_ms(funcs), "ms": time_cuda(fn, n),
                "host_ms": host_ms,
                "launches_per_call": sum(v[1] for v in funcs.values())}

    def one(args):
        return {"evaluations": len(legacy_inputs("legacy_blocked", args)),
                "fixpoint": timed(lambda: fixpoint(*args), reps),
                "evaluation": timed(
                    lambda: kernels.legacy_sweep(args[0], *args), reps)}
    out = {}
    _state, _batch, calls = bench_step_calls(dev, T, 1 << 18,
                                             intra_mode="legacy")
    out["bench_16384"] = one(legacy_fixpoint_args(calls["legacy_blocked"][0]))
    del _state, _batch, calls
    per = [one(legacy_fixpoint_args(step[0]))  # each step's first K5 call
           for step in legacy_ab_calls(dev, T, 8, per_step=True)]
    out["ab_16384"] = {
        "steps": len(per),
        "evaluations": [p["evaluations"] for p in per],
        **{f"{k}_{f}_sum": sum(p[k][f] for p in per)
           for k in ("fixpoint", "evaluation") for f in ("device_ms", "ms")}}
    out["run_kernel_ab"] = bench.run_kernel_ab(T, 8, device=dev)
    return out


def time_sharded_chunk(dev, T=SHARDED_BENCH_T, n=20,
                       rounds=("graph", "eager", "eager", "graph")):
    """ms a batch of `run_sharded_kernel(16,384, n, W)` at W = 1 and 4 on
    the card, the chunk graphed and eager in turns (a package without the
    chunk graph runs its eager chunk only)."""
    import inspect

    from foundationdb_tpu_torch import bench
    has_graph = "graphed" in inspect.signature(
        bench.run_sharded_kernel).parameters
    out = {}
    for W in (1, SHARDED_W):
        row = out[f"w{W}"] = {}
        for label in rounds if has_graph else ("eager", "eager"):
            kw = {"graphed": label == "graph"} if has_graph else {}
            res = bench.run_sharded_kernel(T, n, W, devices=[dev] * W, **kw)
            row.setdefault(f"{label}_ms_per_batch", []).append(
                res["ms_per_batch"])
    return out


def time_sharded_step(dev, reps, W=SHARDED_W, T=SHARDED_BENCH_T):
    """K10's and K11's device, wall and host ms a call and ms replayed
    alone in a CUDA graph (time_launch) on the calls of one sharded bench
    step (W shards on the card, T=16,384, K=2^18 a shard, after two
    batches), and that whole step's device ms with the kernels, run
    eagerly."""
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.conflict import ConflictShapes
    from foundationdb_tpu_torch.parallel.sharded_conflict import (
        sharded_conflict_step)
    detail: dict = {}
    bench.run_sharded_kernel(T, 2, W, devices=[dev] * W, detail=detail)
    state, batch = detail["state_after_first"], detail["batches"][1]
    shapes = ConflictShapes(capacity=bench.CAPACITY, txns=T, reads=T,
                            writes=T, strided=True)
    calls: dict = {}
    spied = spied_phases(calls, dev)
    plain_step = sharded_conflict_step(
        [dev] * W, shapes, bench.WINDOW, "scan", T // 2 + 1,
        phases=type(ref.PLAIN)(**dict(vars(ref.PLAIN),
                                      intra_sandwich=pinch_read_sandwich,
                                      clip_ranges=spied.clip_ranges,
                                      shard_combine=spied.shard_combine)))
    plain_step(state, batch)
    out = {}
    for name, kern in (("shard_clip", kernels.clip_ranges),
                       ("shard_combine", kernels.shard_combine)):
        a, kw = calls[name][-1]
        out[name] = time_launch(name, lambda: kern(*a, **kw), reps)
    step = sharded_conflict_step([dev] * W, shapes, bench.WINDOW, "scan",
                                 T // 2 + 1)
    funcs, wall = profile_device(lambda: step(state, batch), 5)
    out["step"] = {"device_ms": busy_ms(funcs), "wall_ms": wall / 5 * 1e3}
    return out


def serve_cells(dev, seed):
    """Phase 4's cells through the resolver: A at the default knobs, its
    versions jumping 2^29 halfway; B at K=2^20 after YCSB's load phase,
    cut to 48 batches. [(name, serve_phase's result)]."""
    return [("A", serve_phase("A", dev, 1 << 16, PHASE_A_BATCHES, 20_000,
                              seed + 1, jump_at=PHASE_A_BATCHES // 2)),
            ("B", serve_phase("B", dev, 1 << 20, PHASE_B_BATCHES, 400_000,
                              seed + 2, n_load=PHASE_B_LOAD_BATCHES))]


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 15: the C-API bindings and their conformance tester against server
# processes whose resolvers run on the card, and the graft entry points
# ---------------------------------------------------------------------------

# (seed, ops, C-API prefix, native prefix): tests/test_bindingtester.py's
# two conformance runs
BINDINGS_RUNS = ((977, 2000, b"bt_c/", b"bt_n/"),
                 (31337, 1000, b"bt2_c/", b"bt2_n/"))
BINDINGS_MIN_COMPARED = 500  # stack entries compared over the runs, at least
# the step kernels that run once a resolver step (K6-K9, K3, K2, K13); K1
# and K4 (sparse_table, merge_compact) must launch, at least once
ONCE_A_STEP = ("endpoint_sort", "state_merge", "endpoint_ranks",
               "intra_levels", "intra_sandwich", "masks_and_history",
               "step_verdicts")


def recorded_server_main(spec_json: str, record_path: str) -> int:
    """A `server_main` process whose resolvers are recorded as in phases
    10-14 (`record_resolvers`) and whose RESOLVER_METRICS replies carry
    `DeviceBytes` (`torch.cuda.memory_allocated` once what is unreachable
    is collected; None off the card). At its exit (SIGTERM) it replays
    every batch each resolver decided into a fresh OracleConflictSet (a
    sharded backend's into the clipped-oracle model) and writes the tally,
    the kernel launches and those of the resolvers' builds to
    `record_path`."""
    import torch

    from foundationdb_tpu_torch.net import server_main
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.server import resolver as resolver_mod

    hook = record_resolvers(kernels)
    hook.install()
    fold = resolver_mod.fold_transport_counters
    knobs = json.loads(spec_json).get("knobs", {})
    dev = torch.device("cuda" if str(knobs.get(
        "CONFLICT_DEVICE", "cuda")).startswith("cuda") else "cpu")

    def with_device_bytes(process, snap):
        snap["DeviceBytes"] = collected_memory(dev)
        return fold(process, snap)
    resolver_mod.fold_transport_counters = with_device_bytes
    try:
        rc = server_main.main(spec_json)
    finally:
        hook.remove()
        resolver_mod.fold_transport_counters = fold
    batches, mismatches, gaps = replay_into_oracles(
        hook, clipped=knobs.get("CONFLICT_BACKEND") == "sharded")
    with open(record_path, "w") as f:
        json.dump({"batches": batches, "mismatches": mismatches,
                   "gaps": gaps, "resolvers": [
                       {k: rec.get(k) for k in (
                           "process", "device", "backend", "poisoned",
                           "decided_batches", "undecided_batches", "chunks",
                           "buckets", "ungraphed_chunks", "eager_steps",
                           "recuts_replayed", "after_recut")}
                       for rec in hook.instances],
                   "launches": dict(kernels.LAUNCHES),
                   "build_launches": hook.build_launches,
                   "build_chunks": hook.build_chunks}, f)
    return rc


def capi_lifecycle_checks(fdb_c, cluster) -> tuple:
    """tests/test_bindingtester.py's fdb_c.h lifecycle, future and
    error-mapping checks on the port's surface: (network thread, database,
    failures). The thread runs until `fdb_c.fdb_stop_network()`."""
    import threading

    bad = []

    def check(ok, what):
        if not ok:
            bad.append(f"phase 15a: fdb_c {what}")
    fdb_c._reset_for_tests()
    check(fdb_c.fdb_setup_network() != 0, "setup before a version succeeded")
    check(fdb_c.fdb_select_api_version(fdb_c.HEADER_API_VERSION + 1) != 0,
          "selected a version above the header's")
    check(fdb_c.fdb_select_api_version(610) == 0, "refused version 610")
    check(fdb_c.fdb_select_api_version(610) == 0, "refused a re-select")
    check(fdb_c.fdb_setup_network() == 0, "setup failed")
    check(fdb_c.fdb_setup_network() != 0, "a double setup succeeded")
    thread = threading.Thread(target=fdb_c.fdb_run_network, daemon=True)
    thread.start()
    err, db = fdb_c.fdb_create_database(cluster)
    check(err == 0 and db is not None, f"create_database gave {err}")
    if db is None:
        return thread, None, bad
    tr = db.create_transaction()
    fut = tr.get(b"bt_c/none")
    check(fut.block_until_ready() == 0 and fut.is_ready(),
          "get did not become ready")
    check(fut.get_value() == (0, False, None),
          f"get of an absent key gave {fut.get_value()}")
    fired = threading.Event()
    fut2 = tr.get_read_version()
    fut2.set_callback(lambda f, arg: fired.set(), None)
    fut2.block_until_ready()
    check(fired.wait(5.0), "callback not delivered within 5 s")
    check(fdb_c.fdb_get_error(1020) == "not_committed", "error name of 1020")
    check(fdb_c.fdb_error_predicate("RETRYABLE", 1020), "1020 not retryable")
    check(fdb_c.fdb_error_predicate("MAYBE_COMMITTED", 1021),
          "1021 not maybe-committed")
    check(not fdb_c.fdb_error_predicate("RETRYABLE", 4100),
          "4100 retryable")
    return thread, db, bad


def multiversion_checks(fdb_c) -> list:
    """tests/test_bindingtester.py's MultiVersionApi selection rules on the
    port's surface; returns the failures (fdb_c's version reset after)."""
    import types

    from foundationdb_tpu_torch.bindings.multiversion import MultiVersionApi

    bad = []

    def check(ok, what):
        if not ok:
            bad.append(f"phase 15a: multiversion {what}")

    def fake_client(max_api):
        m = types.SimpleNamespace()
        m.fdb_get_max_api_version = lambda: max_api
        m.fdb_select_api_version = lambda v: 0 if v <= max_api else 1
        m.fdb_create_database = lambda cluster: (0, ("db", max_api))
        return m

    try:
        api = MultiVersionApi()
        check(api.add_external_client("v700", fake_client(700)) == 0,
              "refused v700")
        check(api.add_external_client("v520", fake_client(520)) == 0,
              "refused v520")
        check(api.add_external_client("bogus", object()) != 0,
              "took a client without the surface")
        check(api.fdb_select_api_version(800) != 0, "selected 800")
        fdb_c._reset_for_tests()
        check(api.fdb_select_api_version(600) == 0, "refused 600")
        check(api.active_client is fdb_c, "600 did not elect the local one")
        check(api.fdb_select_api_version(520) != 0, "re-selected 520")
        check(api.fdb_select_api_version(600) == 0, "refused re-select 600")
        check(api.fdb_get_max_api_version() == fdb_c.HEADER_API_VERSION,
              "delegation missed the active client")
        api2 = MultiVersionApi()
        api2.add_external_client("v700", fake_client(700))
        api2.add_external_client("v520", fake_client(520))
        fdb_c._reset_for_tests()
        check(api2.fdb_select_api_version(500) == 0, "refused 500")
        check(api2.fdb_get_max_api_version() == 520, "500 did not elect v520")
        check(api2.fdb_create_database({}) == (0, ("db", 520)),
              "create_database missed v520")
        api3 = MultiVersionApi()
        api3.add_external_client("v520", fake_client(520))
        check(api3.disable_multi_version_client_api() == 0,
              "refused the disable option")
        fdb_c._reset_for_tests()
        check(api3.fdb_select_api_version(500) == 0, "pinned: refused 500")
        check(api3.active_client is fdb_c, "the disable option did not pin")
    finally:
        fdb_c._reset_for_tests()
    return bad


def bindings_process_phase(dev, seed, runs=BINDINGS_RUNS, knobs=None,
                           min_compared=BINDINGS_MIN_COMPARED):
    """15a: two `server_main` processes as 13b boots them — txn (master,
    2 resolvers on `dev` split at A's median key, each on its own address,
    a tlog and a proxy; recorded, `recorded_server_main`) and storage (one
    storage server) — at cell A's width (the default knobs, or `knobs`).
    From this process: the fdb_c lifecycle and error-mapping checks, the
    conformance runs (`bindingtester.compare_runs` through the C-ABI
    machine and the native client, stacks and final rows equal, more than
    `min_compared` entries), the multiversion checks; each resolver's
    RESOLVER_METRICS over the wire after the first run and at the end
    (its backend `dev`, every step kernel launched, K6-K9, K3, K2 and K13
    at least once a chunk on the card, every readback returned, none
    unconverged, DeviceBytes not grown); SIGTERM (each exits 0 within
    NET_STOP_S); every batch the resolvers decided equal to a fresh
    oracle's. Returns (summary, failures)."""
    import shutil
    import tempfile

    from foundationdb_tpu_torch.bindings import bindingtester, fdb_c
    from foundationdb_tpu_torch.client.database import Database, LocationCache
    from foundationdb_tpu_torch.net import server_main
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop

    failures: list = []
    keys, _picks = ycsb_traffic(seed, NET_KEYS, 1, 1)
    resolver_bounds = [b"", sorted(keys)[len(keys) // 2]]
    txn, r0, r1, s0, cli = net_addresses(5)
    resolvers = [r0, r1]
    tmp = tempfile.mkdtemp()
    knob_spec = {"CONFLICT_BACKEND": "device", "CONFLICT_DEVICE": str(dev),
                 **(knobs or {})}
    txn_spec = {"listen": txn, "data_dir": os.path.join(tmp, "txn"),
                "knobs": knob_spec, "roles": [
                    {"role": "master", "args": {}},
                    *({"role": "resolver", "listen": r, "args": {
                        "key_range_begin": resolver_bounds[i].hex(),
                        "key_range_end": (resolver_bounds[i + 1].hex()
                                          if i + 1 < 2 else None)}}
                      for i, r in enumerate(resolvers)),
                    {"role": "tlog", "args": {}},
                    net_proxy_role(0, txn, txn, resolvers, resolver_bounds,
                                   [txn], [b""], [[0]], [txn])]}
    txn_spec["roles"][-1].pop("listen")
    storage_spec = {"listen": s0, "data_dir": os.path.join(tmp, "storage"),
                    "knobs": knob_spec, "roles": [
                        {"role": "storage",
                         "args": {"tag": 0, "tlog_addrs": [txn]}}]}
    log_path = os.path.join(tmp, "servers.log")
    record_path = os.path.join(tmp, "resolvers.json")
    env = dict(os.environ)
    env.pop("FDBTPU_TRACE_DIR", None)
    env.pop("FDBTPU_PROFILE", None)
    out: dict = {"runs": [list(r[:2]) for r in runs],
                 "resolver_split": resolver_bounds[1].decode()}
    procs, loop, client, net_thread = [], None, None, None
    machines: list = []
    capi_run = bindingtester.CApiMachine.run
    native_run = bindingtester.NativeMachine.run

    def kept(run):
        def recorded(self, ops):
            machines.append(self)
            return run(self, ops)
        return recorded
    try:
        t0 = time.perf_counter()
        procs.append(start_server(txn_spec, env, log_path, "15a",
                                  record=record_path)[0])
        procs.append(start_server(storage_spec, env, log_path, "15a")[0])
        out["boot_s"] = time.perf_counter() - t0
        cluster = {"proxies": [txn], "boundaries": [b""], "storages": [[s0]]}
        net_thread, capi_db, bad = capi_lifecycle_checks(fdb_c, cluster)
        failures += bad
        loop = RealEventLoop()
        client = NetTransport(loop, cli)
        client.start()
        ndb = Database(client.process, proxies=[txn],
                       locations=LocationCache([b""], [[s0]]))
        bindingtester.CApiMachine.run = kept(capi_run)
        bindingtester.NativeMachine.run = kept(native_run)
        compared, metrics = 0, []
        t0 = time.perf_counter()
        for seed_i, n_ops, prefix_c, prefix_n in runs:
            try:
                compared += bindingtester.compare_runs(
                    seed_i, n_ops, capi_db, loop, ndb, prefix_c=prefix_c,
                    prefix_n=prefix_n)
            except AssertionError as e:
                failures.append(f"phase 15a: seed {seed_i} x {n_ops} ops: "
                                f"{str(e)[:500]}")
            metrics.append(net_resolver_metrics(loop, client, resolvers))
        out["runs_s"] = time.perf_counter() - t0
        bindingtester.CApiMachine.run = capi_run
        bindingtester.NativeMachine.run = native_run
        commits = [sum(1 for e in m.stack if e[0] == "commit")
                   for m in machines]
        out.update({
            "ops": sum(r[1] for r in runs) * 2, "compared": compared,
            "attempts": sum(commits),
            "commits": sum(sum(1 for e in m.stack if e == ("commit", 0))
                           for m in machines),
            "ops_per_s": sum(r[1] for r in runs) * 2 / out["runs_s"]})
        if compared <= min_compared:
            failures.append(f"phase 15a: {compared} stack entries compared, "
                            f"not more than {min_compared}")
        first, last = metrics[0], metrics[-1]
        m = last[0]
        out["launches"] = {k[len("KernelLaunches."):]: v
                           for k, v in m.items()
                           if k.startswith("KernelLaunches.")}
        out["chunks"] = m["KernelDispatches"]
        out["device_bytes"] = [first[0]["DeviceBytes"], m["DeviceBytes"]]
        out["resolver_metrics"] = [{k: x.get(k) for k in NET_METRICS}
                                   for x in last]
        for r, x in zip(resolvers, last):
            if x["Backend"] != dev.type:
                failures.append(f"phase 15a: resolver {r} reports backend "
                                f"{x['Backend']!r}, not {dev.type!r}")
        if dev.type == "cuda":
            for k in STEP_KERNELS:
                if not out["launches"][k]:
                    failures.append(f"phase 15a: {k} never launched")
            for k in ONCE_A_STEP:
                if out["launches"][k] < m["KernelDispatches"]:
                    failures.append(
                        f"phase 15a: {out['launches'][k]} {k} launches for "
                        f"{m['KernelDispatches']} chunks")
            if m["DeviceBytes"] > first[0]["DeviceBytes"]:
                failures.append(f"phase 15a: device bytes grew from "
                                f"{first[0]['DeviceBytes']} to "
                                f"{m['DeviceBytes']}")
        groups = sum(x["DrainGroups"] for x in last)
        if m["ReadbackWaits"] != groups or m["UnconvergedChunks"]:
            failures.append(f"phase 15a: {m['ReadbackWaits']} readbacks "
                            f"returned for {groups} drain groups, "
                            f"{m['UnconvergedChunks']} chunks unconverged")
    finally:
        bindingtester.CApiMachine.run = capi_run
        bindingtester.NativeMachine.run = native_run
        if net_thread is not None:
            fdb_c.fdb_stop_network()
            net_thread.join(timeout=NET_STOP_S)
            if net_thread.is_alive():
                failures.append("phase 15a: the fdb_c network thread did "
                                "not stop")
        fdb_c._reset_for_tests()
        if loop is not None:
            server_main.shutdown(loop, [client] if client else [], [])
            loop.aio.close()
        t0 = time.perf_counter()
        failures += stop_servers(procs, "15a")
        out["stop_s"] = time.perf_counter() - t0
    # after the network thread stopped: the checks reset fdb_c's version
    failures += multiversion_checks(fdb_c)
    try:
        with open(record_path) as f:
            rec = json.load(f)
    except OSError as e:
        rec = None
        failures.append(f"phase 15a: no resolver record from the txn "
                        f"process ({e})")
    if rec is not None:
        out["resolved_batches"] = rec["batches"]
        out["mismatched_batches"] = rec["mismatches"]
        out["resolvers"] = rec["resolvers"]
        if rec["mismatches"] or rec["gaps"] or not rec["batches"]:
            failures.append(f"phase 15a: {rec['mismatches']} of "
                            f"{rec['batches']} resolver batches differ from "
                            f"the oracle, {rec['gaps']} resolvers with gaps")
        for r in rec["resolvers"]:
            if r["poisoned"] or (dev.type == "cuda"
                                 and r["ungraphed_chunks"]):
                failures.append(f"phase 15a: resolver {r['process']} "
                                f"poisoned {r['poisoned']}, "
                                f"{r['ungraphed_chunks']} chunks outside "
                                f"their graph")
    if failures:
        with open(log_path, errors="replace") as f:
            log("phase 15a servers.log tail: " + f.read()[-2000:])
    shutil.rmtree(tmp, ignore_errors=True)
    log("phase 15a: " + json.dumps({k: out.get(k) for k in (
        "boot_s", "ops", "runs_s", "ops_per_s", "compared", "attempts",
        "commits", "resolved_batches", "mismatched_batches", "chunks",
        "device_bytes", "stop_s")}))
    return out, failures


def graft_phase(dev, shards=None):
    """15b: `graft_entry.entry()` on `dev` (the knob's device when it is
    the card): one step, every field (state, statuses, info) equal to the
    plain step on a CPU copy of the same state and batch, and its ms; then
    `dryrun_multichip` over `shards` (every attached card on CUDA).
    Returns (summary, failures)."""
    import functools

    import torch

    from foundationdb_tpu_torch import graft_entry
    from foundationdb_tpu_torch.ops import conflict_ref as ref
    from foundationdb_tpu_torch.ops import kernels
    from foundationdb_tpu_torch.ops.batch import COMMITTED

    failures: list = []
    fn, (state, batch) = graft_entry.entry(
        None if dev.type == "cuda" else dev)
    cpu = torch.device("cpu")
    plain = functools.partial(ref.conflict_step,
                              max_write_life=graft_entry.MAX_WRITE_LIFE,
                              phases=ref.PLAIN)
    want = plain(clone_to(state, cpu), clone_to(batch, cpu))
    before = dict(kernels.LAUNCHES)
    got = fn(state, batch)
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    names = (["state." + k for k in want[0]] + ["statuses"]
             + ["info." + k for k in want[2]])
    flat_want = list(want[0].values()) + [want[1]] + list(want[2].values())
    flat_got = ([got[0][k] for k in want[0]] + [got[1]]
                + [got[2].get(k) for k in want[2]])
    differ = [n for n, w, g in zip(names, flat_want, flat_got)
              if g is None or not torch.equal(g.cpu(), w)]
    if differ:
        failures.append(f"phase 15b: entry()'s step differs from the plain "
                        f"step in {differ}")
    out = {"device": str(state["bkeys"].device), "fields": len(names),
           "committed": int((got[1] == COMMITTED).sum()),
           "launches": {k: v for k, v in launches.items() if v}}
    if dev.type == "cuda":
        out["step_ms"] = time_cuda(lambda: fn(state, batch), 20)
        if not all(launches[k] for k in ONCE_A_STEP):
            failures.append(f"phase 15b: entry()'s step launched "
                            f"{out['launches']}")
    n = shards if shards is not None else (
        torch.cuda.device_count() if dev.type == "cuda" else 1)
    try:
        out["dryrun"] = graft_entry.dryrun_multichip(n, device=dev.type)
    except Exception as e:  # a failed dryrun is this phase's failure
        failures.append(f"phase 15b: dryrun_multichip({n}) failed: "
                        f"{type(e).__name__}: {e}")
    log("phase 15b: " + json.dumps(out, default=str))
    return out, failures


def bindings_phase(dev, seed, processes=None, shards=None):
    """Phase 15: 15a and 15b (`processes`: keyword arguments of 15a, the
    CPU tests' small sizes). The kernels line's `launches_bindings` is
    15a's txn process's counts, read over the wire, plus 15b's step. The
    clients' trace events in this process are dropped, their buffered
    spans too."""
    from foundationdb_tpu_torch.utils import trace

    trace.set_sink(lambda _fields: None)
    try:
        a, bad_a = bindings_process_phase(dev, seed + 15,
                                          **(processes or {}))
    finally:
        trace.g_trace_batch.dump()
        trace.set_sink(None)
    b, bad_b = graft_phase(dev, shards)
    failures = bad_a + bad_b
    if failures:
        fail("phase 15: " + "; ".join(failures))
    launches = dict(a.get("launches", {}))
    for k, v in b["launches"].items():
        launches[k] = launches.get(k, 0) + v
    return {"phase": "15", "15a": a, "15b": b, "launches": launches}


# phase 16: the end-to-end driver (foundationdb_tpu_torch/bench_e2e.py)
E2E_PHASES = ("write", "read", "mixed")  # run()'s defaults
E2E_COMMIT_PHASES = ("write", "mixed", "mixed-contended")
# 16b: a contended OLTP mix on a fanned-out commit path
E2E_16B = {"backend": "device", "n_proxies": 2, "n_storage": 2,
           "phases": ("mixed", "mixed-contended"), "trace": True}
# 16c: the sharded engine, two shards sharing the card
E2E_16C = {"backend": "sharded", "phases": ("write",), "seconds": 2.0,
           "extra_knobs": {"CONFLICT_NUM_SHARDS": 2}}
E2E_FIELDS = ("ops_per_sec", "committed_txns_per_sec", "error_rate",
              "not_committed_rate", "grv_ms_p50", "grv_ms_p99",
              "commit_ms_p50", "commit_ms_p99")
E2E_STAGES = ("Proxy.BatchAssembly", "Proxy.Resolve", "Resolver.Dispatch",
              "Client.Commit")
# printed where the trace has it: a commit's wait at the client's admission
# budget, before Client.Commit's span starts
E2E_WAIT_STAGE = "Client.AdmissionWait"


def e2e_report_failures(where, report, phases, backend_label=None,
                        clients=1500, seconds=5.0):
    """A run report's checks: it round-trips through JSON; each phase's
    ops/s above 0, its commit p50 and p99 where the phase commits, and
    its GRV p50 where a GRV was timed. The driver, as the reference's,
    times the GRV of every transaction in the write and mixed-contended
    phases, but in a reading phase only each client's 1st, 17th, 33rd...
    (`_run_phase`): there the p50 must be present once the measured
    window held at least 16 transactions a client, and may be absent
    below that. The core's engine is `backend_label` where given."""
    failures = []
    try:
        report = json.loads(json.dumps(report))
    except (TypeError, ValueError) as e:
        return [f"{where}: the report does not round-trip through JSON "
                f"({e})"]
    for kind in phases:
        entry = report.get(kind)
        if not isinstance(entry, dict):
            failures.append(f"{where}: no {kind} phase in the report")
            continue
        if not entry.get("ops_per_sec", 0) > 0:
            failures.append(f"{where}: {kind} ran {entry.get('ops_per_sec')}"
                            f" ops/s")
        txns = (entry.get("committed_txns_per_sec", 0) * seconds
                + sum((entry.get("errors") or {}).values()))
        timed = (kind in ("write", "mixed-contended")
                 or txns >= 16 * clients)
        want = (["grv_ms_p50"] if timed else []) + (
            ["commit_ms_p50", "commit_ms_p99"]
            if kind in E2E_COMMIT_PHASES else [])
        missing = [k for k in want if k not in entry]
        if missing:
            failures.append(f"{where}: {kind} lacks {missing} ({txns:.0f} "
                            f"transactions for {clients} clients)")
    got = (report.get("resolver") or {}).get("backend")
    if backend_label is not None and got != backend_label:
        failures.append(f"{where}: the core's engine is {got!r}, not "
                        f"{backend_label!r}")
    return failures


def e2e_summary(report, phases):
    return {kind: {**{k: report[kind].get(k) for k in E2E_FIELDS},
                   "errors": report[kind].get("errors"),
                   "by_proc": report[kind]["cpu_split"]["by_proc"],
                   "chunks": report[kind].get("resolver", {}).get("chunks")}
            for kind in phases if isinstance(report.get(kind), dict)}


def once_a_chunk(where, launches, chunks, kernels_once, kernels_never=(),
                 times=1):
    """Each of `kernels_once` launched `times` a chunk, none of
    `kernels_never` at all."""
    failures = []
    if not chunks:
        failures.append(f"{where}: no chunk ran")
    for k in kernels_once:
        if launches.get(k, 0) != times * chunks:
            failures.append(f"{where}: {launches.get(k, 0)} {k} launches "
                            f"for {chunks} chunks")
    for k in kernels_never:
        if launches.get(k, 0):
            failures.append(f"{where}: {k} launched {launches[k]} times")
    return failures


def e2e_methodology_phase():
    """16a: the port's `bench.run_e2e()`: one subprocess each for the oracle
    and the device backends (the device run's core on the card), at
    `run`'s defaults, the oracle's with bench_e2e's two extra rows. Every
    report well formed (`e2e_report_failures`); the device core's engine
    the card, its step kernels once a chunk in every phase and the shard
    kernels never. Returns (summary, launches of the device run, failures)."""
    from foundationdb_tpu_torch import bench

    t0 = time.perf_counter()
    out = bench.run_e2e()
    wall = time.perf_counter() - t0
    failures, summary, launches = [], {"wall_s": wall}, {}
    for backend in ("oracle", "device"):
        rep = out.get(backend) or {}
        if "error" in rep:
            failures.append(f"phase 16a: the {backend} run failed: "
                            f"{rep['error']}")
            continue
        failures += e2e_report_failures(
            f"phase 16a {backend}", rep, E2E_PHASES,
            "oracle" if backend == "oracle" else "cuda")
        summary[backend] = {"boot_s": rep.get("boot_s"),
                            "resolver": rep.get("resolver"),
                            **e2e_summary(rep, E2E_PHASES)}
        for row in ("n_proxies_2", "latency_100_clients"):
            if row in rep:
                summary[backend][row] = e2e_summary(rep[row], E2E_PHASES)
        if backend == "device":
            for kind in E2E_PHASES:
                res = (rep.get(kind) or {}).get("resolver") or {}
                if kind not in E2E_COMMIT_PHASES:  # nothing to resolve
                    if res.get("chunks") or res.get("launches"):
                        failures.append(f"phase 16a {kind}: {res}")
                    continue
                failures += once_a_chunk(
                    f"phase 16a {kind}", res.get("launches", {}),
                    res.get("chunks", 0), STEP_KERNELS, SHARD_KERNELS)
                for k, v in res.get("launches", {}).items():
                    launches[k] = launches.get(k, 0) + v
    return summary, launches, failures


def nvidia_nodes(pid) -> set:
    """The /dev/nvidia* nodes that process `pid` holds open: a process
    that made a CUDA context holds its card's node (/dev/nvidiaN)."""
    out = set()
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                out.add(target)
    except OSError:
        pass
    return out


def compute_apps() -> list:
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return [x.strip() for x in smi.stdout.splitlines() if x.strip()]


def e2e_recorded_run(where, dev, kw, backend_label, kernels_once,
                     kernels_never):
    """One `bench_e2e.run(**kw)` in this process with the core started as
    `recorded_server_main` (the driver's `_spawn_server` wrapped for the
    spec that holds the resolver): every batch its resolver decided held
    to the oracle (the clipped-oracle model on the sharded backend), no
    poison, on the card every chunk through its graph and each of
    `kernels_once` launched once a chunk net of the build's launches,
    none of `kernels_never`; the core's device bytes equal after the first
    phase and at the end; every process the driver started exiting 0 (the
    servers on SIGTERM, within the driver's 10 s); and, polled each second
    while the run lasts, no process but the core holding a card's device
    node. Returns (summary, net launches, failures)."""
    import shutil
    import tempfile
    import threading

    from foundationdb_tpu_torch import bench_e2e

    tmp = tempfile.mkdtemp(prefix="fdbtpu-smoke-16-")
    record_path = os.path.join(tmp, "core.json")
    spawned, labels, snaps, core = [], {}, [], {}
    popen, spawn_server = bench_e2e._popen, bench_e2e._spawn_server
    resolver_metrics = bench_e2e._resolver_metrics

    def kept_popen(cmd, **pkw):
        p = popen(cmd, **pkw)
        spawned.append(p)
        labels.setdefault(p.pid, "worker" if "--worker" in cmd else "server")
        return p

    def recorded_spawn(spec, env):
        if not any(r["role"] == "resolver" for r in spec["roles"]):
            p = spawn_server(spec, env)
        else:
            p = bench_e2e._popen(
                [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
                 "chip_smoke.recorded_server_main(sys.argv[1], sys.argv[2]))",
                 json.dumps(spec), record_path],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env)
            core["pid"] = p.pid
        labels[p.pid] = os.path.basename(spec["data_dir"])
        return p

    def kept_metrics(address):
        snap = resolver_metrics(address)
        snaps.append(snap)
        return snap

    holders: dict = {}
    smi: set = set()
    stop = threading.Event()

    def poll():
        while not stop.wait(1.0):
            for p in list(spawned):
                if p.poll() is None:
                    holders.setdefault(p.pid, set()).update(
                        nvidia_nodes(p.pid))
            if dev.type == "cuda":
                smi.update(compute_apps())

    poller = threading.Thread(target=poll, daemon=True)
    failures: list = []
    bench_e2e._popen = kept_popen
    bench_e2e._spawn_server = recorded_spawn
    bench_e2e._resolver_metrics = kept_metrics
    poller.start()
    t0 = time.perf_counter()
    try:
        report = bench_e2e.run(device=str(dev), **kw)
    finally:
        wall = time.perf_counter() - t0
        stop.set()
        poller.join()
        bench_e2e._popen = popen
        bench_e2e._spawn_server = spawn_server
        bench_e2e._resolver_metrics = resolver_metrics
    phases = kw["phases"]
    failures += e2e_report_failures(where, report, phases, backend_label,
                                    kw.get("clients", 1500),
                                    kw.get("seconds", 5.0))
    for p in spawned:
        if p.returncode != 0:
            failures.append(f"{where}: {labels.get(p.pid)} (pid {p.pid}) "
                            f"exited {p.returncode}")
    card_nodes = {pid: sorted(n for n in nodes if n[len("/dev/nvidia"):]
                              .isdigit())
                  for pid, nodes in holders.items()}
    if dev.type == "cuda":
        if not card_nodes.get(core.get("pid")):
            failures.append(f"{where}: the core held no card's device node")
        others = {labels.get(pid): sorted(holders[pid])
                  for pid in holders if pid != core.get("pid")
                  and holders[pid]}
        if others:
            failures.append(f"{where}: processes besides the core opened "
                            f"the card: {others}")
    try:
        with open(record_path) as f:
            rec = json.load(f)
    except OSError as e:
        rec = None
        failures.append(f"{where}: no record from the core ({e})")
    net: dict = {}
    chunks = 0
    if rec is not None:
        net = {k: rec["launches"][k] - rec["build_launches"].get(k, 0)
               for k in rec["launches"]}
        chunks = sum(r["chunks"] or 0 for r in rec["resolvers"])
        if rec["mismatches"] or rec["gaps"] or not rec["batches"]:
            failures.append(f"{where}: {rec['mismatches']} of "
                            f"{rec['batches']} resolver batches differ from "
                            f"the oracle, {rec['gaps']} resolvers with gaps")
        for r in rec["resolvers"]:
            if r["poisoned"] or r["backend"] != backend_label or (
                    dev.type == "cuda" and r["ungraphed_chunks"]):
                failures.append(f"{where}: resolver {r['process']} backend "
                                f"{r['backend']}, poisoned {r['poisoned']}, "
                                f"{r['ungraphed_chunks']} chunks outside "
                                f"their graph")
        if dev.type == "cuda":
            failures += once_a_chunk(where, net, chunks, kernels_once,
                                     kernels_never)
    device_bytes = [x.get("DeviceBytes") for x in snaps]
    if dev.type == "cuda" and (len(device_bytes) < 2
                               or device_bytes[1] != device_bytes[-1]):
        failures.append(f"{where}: the core's device bytes "
                        f"{device_bytes} (after the preload, then each "
                        f"phase) moved after the first phase")
    breakdown = report.get("stage_breakdown") or {}
    stages = breakdown.get("stages") or {}
    summary = {
        "wall_s": wall, "boot_s": report.get("boot_s"),
        "resolver": report.get("resolver"),
        **e2e_summary(report, phases),
        "resolved_batches": rec and rec["batches"],
        "mismatched_batches": rec and rec["mismatches"],
        "recuts": rec and sum(r["recuts_replayed"] or 0
                              for r in rec["resolvers"]),
        "after_recut": rec and sum(r["after_recut"] or 0
                                   for r in rec["resolvers"]),
        "chunks": chunks, "launches": {k: v for k, v in net.items() if v},
        "device_bytes": device_bytes,
        "card_nodes": {labels.get(pid): nodes
                       for pid, nodes in card_nodes.items()},
        "nvidia_smi_compute_apps": sorted(smi),
        "core_pid": core.get("pid"),
        "driver_pids": {labels.get(p.pid): p.pid for p in spawned
                        if labels.get(p.pid) != "worker"}}
    if stages:
        summary["stages"] = {k: {q: stages[k][q] for q in ("n", "p50", "p99")}
                             for k in E2E_STAGES + (E2E_WAIT_STAGE,)
                             if k in stages}
        summary["queueing_ratio"] = breakdown.get("queueing_ratio")
        summary["readback_overlap_ratio"] = breakdown.get(
            "readback_overlap_ratio")
        missing = [k for k in E2E_STAGES if k not in stages]
        if missing:
            failures.append(f"{where}: no {missing} spans in the trace")
    shutil.rmtree(tmp, ignore_errors=True)
    return summary, net, failures


def e2e_phase(dev, runs=("16a", "16b", "16c"), sizes=None):
    """Phase 16: the port's end-to-end driver through real server processes
    whose resolvers run on `dev`. 16a `bench.run_e2e()` (benchmarking.rst's
    point: both backends at `run`'s defaults); 16b the device backend on
    E2E_16B (2 proxies, 2 storage, the mixed and mixed-contended phases,
    traced), its core recorded and held to the oracle; 16c the sharded
    backend on E2E_16C (two shards sharing the card), held to the
    clipped-oracle model, K10 and K11 once a chunk and the step's kernels
    once a shard a chunk. `runs` picks the parts and `sizes` overrides
    16b's and 16c's `run` arguments (the CPU tests run them small). The
    kernels line's `launches_e2e` is 16a's device run's launches in its
    phases plus 16b's and 16c's net of the builds'. Returns the summary;
    a failed check fails the smoke."""
    from foundationdb_tpu_torch.utils import trace

    sizes = sizes or {}
    t0 = time.perf_counter()
    out: dict = {"phase": "16"}
    failures: list = []
    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    if "16a" in runs:
        a, counts, bad = e2e_methodology_phase()
        out["16a"] = a
        add(counts)
        failures += bad
        log("phase 16a: " + json.dumps(a, default=str))
    trace.set_sink(lambda _fields: None)
    try:
        if "16b" in runs:
            b, counts, bad = e2e_recorded_run(
                "phase 16b", dev, dict(E2E_16B, **sizes.get("16b", {})),
                dev.type, STEP_KERNELS, SHARD_KERNELS)
            out["16b"] = b
            add(counts)
            failures += bad
            log("phase 16b: " + json.dumps(b, default=str))
        if "16c" in runs:
            kw = dict(E2E_16C, **sizes.get("16c", {}))
            shards = kw["extra_knobs"]["CONFLICT_NUM_SHARDS"]
            c, counts, bad = e2e_recorded_run(
                "phase 16c", dev, kw, f"{dev.type}x{shards}", SHARD_KERNELS,
                ())
            if dev.type == "cuda":
                bad += once_a_chunk("phase 16c", counts, c["chunks"],
                                    STEP_KERNELS, times=shards)
            out["16c"] = c
            add(counts)
            failures += bad
            log("phase 16c: " + json.dumps(c, default=str))
    finally:
        trace.g_trace_batch.dump()
        trace.set_sink(None)
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    if failures:
        fail("phase 16: " + "; ".join(failures))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    ap.add_argument("--time-kernels", action="store_true",
                    help="only time K1-K13, bench steps and the sharded "
                         "chunk on the card (time_step_kernels), print them "
                         "as JSON and exit")
    ap.add_argument("--time-floor", action="store_true",
                    help="only time one launch's floor (probe_add on one "
                         "element), K10 at phase 8a's and 8c's shapes and "
                         "inside the sharded chunk's graph, and "
                         "probe_dynwrite at the script's, print them as "
                         "JSON and exit")
    ap.add_argument("--serve-cells", action="store_true",
                    help="only serve cells A and B through the resolver "
                         "(phase 4, oracle-checked), print their numbers as "
                         "JSON and exit")
    ap.add_argument("--cluster", action="store_true",
                    help="only run phase 9 (the port's SimCluster, its "
                         "resolvers on the card: 9a cell A's mix, 9b "
                         "Cycle), print its numbers as JSON and exit")
    ap.add_argument("--recovery", action="store_true",
                    help="only run phase 10 (the port's RecoverableCluster, "
                         "its recruited resolvers on the card, through two "
                         "kills), print its numbers as JSON and exit")
    ap.add_argument("--backup", action="store_true",
                    help="only run phase 12 (backup and restore through the "
                         "blob store, DR with a switchover, and the "
                         "backup-attrition spec, every cluster's resolvers "
                         "on the card), print its numbers as JSON and exit")
    ap.add_argument("--net", action="store_true",
                    help="only run phase 13 (real-process boot: 13a the "
                         "roles over TCP in this process, 13b two "
                         "server_main processes, their resolvers on the "
                         "card), print its numbers as JSON and exit")
    ap.add_argument("--native", action="store_true",
                    help="only run phase 14 (the port's C extension on the "
                         "main path: 14a cell A fed by the C encoder, each "
                         "chunk held to numpy, beside the same cell with "
                         "numpy's and the strided layout; 14b 13a's boot "
                         "on the transport's C planes), with phase 4's A "
                         "and 13a as yardsticks, print its numbers as JSON "
                         "and exit")
    ap.add_argument("--bindings", action="store_true",
                    help="only run phase 15 (the C-API bindings' lifecycle, "
                         "conformance and multiversion checks against two "
                         "server_main processes whose resolvers run on the "
                         "card, and the graft entry points), print its "
                         "numbers as JSON and exit")
    ap.add_argument("--e2e", action="store_true",
                    help="only run phase 16 (the port's end-to-end driver: "
                         "16a bench.run_e2e(), 16b the device backend on "
                         "a fanned-out, contended run, 16c the sharded "
                         "backend; real server processes whose resolvers "
                         "run on the card), print its numbers as JSON and "
                         "exit")
    ap.add_argument("--sim", action="store_true",
                    help="only run phase 11 (the randomized simulation "
                         "harness: the ten fast specs on device and "
                         "sharded draws, and Cycle at the default width), "
                         "print its numbers as JSON and exit")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    # the port: a missing package (the script alone) fails here
    from foundationdb_tpu_torch.ops import kernels
    dev = torch.device("cuda", 0)
    report: dict = {}

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    report["card"] = card
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda
    report["device_name"] = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    digest = source_digest()
    report["source_digest"] = digest
    log(f"source digest (sha256 of chip_smoke.py and the package's .py, .c, "
        f".cu and .cuh files): {digest}")

    # 2. the build
    t0 = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t0
    if args.time_kernels:
        print(json.dumps({"card": card, "source_digest": digest,
                          "device_ms": time_step_kernels(dev)}), flush=True)
        return 0
    if args.time_floor:
        print(json.dumps({"card": card, "source_digest": digest,
                          "device_ms": time_floor_and_redesigns(dev)}),
              flush=True)
        return 0
    if args.serve_cells:
        cells = {name: {k: out[k] for k in (
            "txns_per_s", "batch_latency_ms_p50", "batch_latency_ms_p99",
            "wall_s", "chunks", "launches", "host_share")}
            for name, (out, _cs, _next) in serve_cells(dev, args.seed)}
        print(json.dumps({"card": card, "source_digest": digest,
                          "cells": cells}), flush=True)
        return 0
    if args.cluster:
        print(json.dumps({"card": card, "source_digest": digest,
                          "cluster": cluster_phase(dev, args.seed)}),
              flush=True)
        return 0
    if args.recovery:
        print(json.dumps({"card": card, "source_digest": digest,
                          "recovery": recovery_phase(dev, args.seed + 29)}),
              flush=True)
        return 0
    if args.backup:
        out = {"card": card, "source_digest": digest,
               "backup": backup_phase(dev, args.seed)}
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
        print(json.dumps(out, default=str), flush=True)
        return 0
    if args.net:
        out = {"card": card, "source_digest": digest,
               "net": net_phase(dev, args.seed)}
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
        log(f"phase 13 on {card}")
        print(json.dumps(out, default=str), flush=True)
        return 0
    if args.native:
        native = native_status()
        with NativeTally("4") as t4:
            phase_a, _cs, _next = serve_phase(
                "A", dev, 1 << 16, PHASE_A_BATCHES, 20_000, args.seed + 1,
                jump_at=PHASE_A_BATCHES // 2)
        del _cs
        from foundationdb_tpu_torch.utils import trace
        trace.set_sink(lambda _fields: None)
        try:
            with NativeTally("13a") as t13:
                net_a, bad = net_inprocess_phase(dev, args.seed + 13)
        finally:
            trace.g_trace_batch.dump()
            trace.set_sink(None)
        if bad:
            fail("phase 13a: " + "; ".join(bad))
        log("native planes by phase: " + json.dumps(
            {"4": t4.summary(), "13a": t13.summary()}))
        out = {"card": card, "source_digest": digest, "native": native,
               "phase_14": native_phase(dev, args.seed, phase_a, net_a)}
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
        log(f"phase 14 on {card}")
        print(json.dumps(out["phase_14"]["native_planes"]), flush=True)
        return 0
    if args.bindings:
        out = {"card": card, "source_digest": digest,
               "bindings": bindings_phase(dev, args.seed)}
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
        log(f"phase 15 on {card}")
        print(json.dumps(out, default=str), flush=True)
        return 0
    if args.e2e:
        out = {"card": card, "source_digest": digest, "e2e": e2e_phase(dev)}
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
        log(f"phase 16 on {card}: {out['e2e']['wall_s']:.1f} s")
        print(json.dumps(out, default=str), flush=True)
        return 0
    if args.sim:
        out = {"card": card, "source_digest": digest, "sim": sim_phase(dev)}
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
        print(json.dumps(out, default=str), flush=True)
        return 0
    report["native"] = native_status()
    planes: dict = {}
    report["native_planes"] = planes
    report["build"] = {"seconds": build_s,
                       "library": kernels.BUILD_INFO.get("library")}
    log(f"build: {build_s:.1f} s ({kernels.BUILD_INFO.get('library')})")
    for line in kernels.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    # 3. kernels against their plain versions at the main path's shapes
    cdf, keys = zipf_keys(20_000)
    warm = make_batches(np.random.default_rng(args.seed + 100), cdf, keys, 4)
    kres: dict = {}
    check_kernels(dev, capture_main_path_calls(dev, warm), kres, "A")
    report["kernels"] = kres
    report["step_trajectory"] = check_step_trajectory(dev)
    report["step_profile"] = profile_step(dev, make_batches(
        np.random.default_rng(args.seed + 200), cdf, keys, 24))
    check_legacy(dev, kres)
    check_probes(dev, kres)
    # the T = 2^20 edge calls leave ~0.8 GB of kernel scratch cached: give
    # it back, so that the served phases' peak memory is their own
    kernels.release_scratch()
    torch.cuda.empty_cache()

    # 4. the resolver role, phases A and B; B starts with YCSB's load
    # phase, cut to 48 batches (196,608 of its 400,000 keys), so its state
    # holds about 400k boundaries; then every kernel is held to its plain
    # version again at B's shapes (K=2^20), from B's final state
    with NativeTally("4") as tally:
        (_a, (phase_a, _cs, _next)), (_b, (phase_b, cs_b, next_b)) = \
            serve_cells(dev, args.seed)
    planes["4"] = tally.summary()
    log("native planes, phase 4: " + json.dumps(planes["4"]))
    report["phases"] = [phase_a, phase_b]
    kres_b: dict = {}
    check_kernels(dev, capture_calls_from(dev, cs_b, next_b), kres_b, "B",
                  edges=False)
    report["kernels_cell_b"] = kres_b
    del cs_b

    # 5. the kernel bench; 6. the evaluator A/B; 7. the probes
    # bench.py's K=2^18 holds the ~8 batches of history at T=16,384; at
    # T=32,768 their ~450k boundaries overflow it, so that point runs at
    # K=2^19
    benches, kres_bench = {}, {}
    for T, n, chunk, n_oracle, cap in ((16384, 200, 100, 8, 1 << 18),
                                       (32768, 100, 50, 2, 1 << 19)):
        benches[T], kres_bench[T] = kernel_bench_phase(dev, T, n, chunk,
                                                       n_oracle, cap)
    report["kernel_bench"] = benches
    report["kernels_bench"] = kres_bench
    report["ablate"] = ablate_phase(dev)
    ab = report["evaluator_ab"] = ab_phase(dev)
    probe_run = report["probes"] = probes_phase(dev)

    # 8. the sharded engine: 8b the resolver role on the sharded backend
    # (width 1 on one card; first, so that its peak memory is its own),
    # 8a the engine (W=4 on the card), 8c the sharded kernel bench at W=1
    # and W=4; then K10 and K11 against their plain versions
    kernels.release_scratch()
    torch.cuda.empty_cache()
    phase_8b, _cs, _next = serve_phase(
        "8b", dev, 1 << 16, PHASE_A_BATCHES, 20_000, args.seed + 1,
        jump_at=PHASE_A_BATCHES // 2, backend="sharded")
    del _cs
    sharded, calls8a = sharded_engine_phase(dev, args.seed + 8)
    bench8, calls8c = {}, None
    for W in (1, SHARDED_W):
        bench8[W], calls8c = sharded_bench_phase(dev, W)
    kres8 = check_sharded_kernels(dev, calls8a, calls8c)
    del calls8a, calls8c
    report["sharded"] = {"8a": sharded, "8b": phase_8b, "8c": bench8,
                         "kernels": kres8}
    log("phase 8b beside phase A: " + json.dumps({
        k: (phase_a[k], phase_8b[k]) for k in (
            "txns_per_s", "batch_latency_ms_p50", "batch_latency_ms_p99")}))
    kres.update({k: kres8[k] for k in SHARD_KERNELS})

    # 9. the commit pipeline: the port's SimCluster, its resolvers on the
    # card; 9a cell A's mix through client, proxies, resolver, tlogs and
    # storage, 9b the Cycle workload across two resolvers
    kernels.release_scratch()
    torch.cuda.empty_cache()
    with NativeTally("9") as tally:
        cluster = report["cluster"] = cluster_phase(dev, args.seed)
    planes["9"] = tally.summary()
    log("native planes, phase 9: " + json.dumps(planes["9"]))
    log(f"phase 9 on {card}: " + json.dumps({
        run: {k: cluster[run][k] for k in (
            "attempts", "committed", "conflicted", "too_old", "commit_share",
            "wall_s", "virtual_s", "attempts_per_wall_s", "chunks",
            "buckets", "host_share", "peak_device_bytes")}
        for run in cluster}))

    # 10. recovery: the port's RecoverableCluster, its resolvers recruited
    # on the card, through a kill of the first resolver's worker and one of
    # the elected cluster controller
    kernels.release_scratch()
    torch.cuda.empty_cache()
    with NativeTally("10") as tally:
        recovery = report["recovery"] = recovery_phase(dev, args.seed + 29)
    planes["10"] = tally.summary()
    log("native planes, phase 10: " + json.dumps(planes["10"]))
    log(f"phase 10 on {card}: " + json.dumps({k: recovery[k] for k in (
        "attempts", "committed", "outcomes", "wall_s", "virtual_s",
        "attempts_per_wall_s", "chunks", "final_epoch", "generations",
        "peak_device_bytes")}))

    # 11. the randomized simulation harness: the ten fast specs on drawn
    # clusters (device and sharded backends, every engine, two regions,
    # buggified knobs) and Cycle at the default width, every recruited
    # resolver's engine on the card
    kernels.release_scratch()
    torch.cuda.empty_cache()
    with NativeTally("11") as tally:
        sim = report["sim"] = sim_phase(dev)
    planes["11"] = tally.summary()
    log("native planes, phase 11: " + json.dumps(planes["11"]))
    log(f"phase 11 on {card}: " + json.dumps({
        f"{r['spec']}:{r['seed']}": {k: r[k] for k in (
            "result", "wall_s", "chunks", "unconverged_chunks",
            "memory_allocated")} for r in sim["runs"]}))

    # 12. backup, restore and DR: 12a a backup through the blob store while
    # cell A's mix runs, restored to its end and to a point in time (and
    # read by fdbcli); 12b DR into a second cluster with a switchover; 12c
    # the backup-attrition spec on a device draw; every cluster's resolvers
    # on the card
    kernels.release_scratch()
    torch.cuda.empty_cache()
    with NativeTally("12") as tally:
        backup = report["backup"] = backup_phase(dev, args.seed)
    planes["12"] = tally.summary()
    log("native planes, phase 12: " + json.dumps(planes["12"]))
    log(f"phase 12 on {card}: " + json.dumps({
        r["phase"]: {k: r.get(k) for k in (
            "wall_s", "committed_per_wall_s", "snapshot_chunks",
            "log_rows_drained", "restores", "switchover_s", "result",
            "chunks", "memory_allocated")} for r in backup["runs"]}))

    # 13. real-process boot: 13a the roles over TCP on a real event loop in
    # this process (the readback on its worker threads), 13b two server_main
    # processes (Cycle, fdbbackup, the resolvers' metrics over the wire,
    # SIGTERM and a restart, trace_analyze over their trace files)
    kernels.release_scratch()
    torch.cuda.empty_cache()
    with NativeTally("13") as tally:
        net = report["net"] = net_phase(dev, args.seed)
    planes["13"] = tally.summary()
    log("native planes, phase 13: " + json.dumps(planes["13"]))
    log(f"phase 13 on {card}: " + json.dumps({
        "13a": {k: net["13a"][k] for k in (
            "wall_s", "attempts_per_wall_s", "committed", "chunks",
            "max_readbacks_in_flight", "readback_wait_s",
            "memory_allocated")},
        "13b": {k: net["13b"][k] for k in (
            "attempts_per_wall_s", "committed", "restart_s",
            "readback_wait_s")}}))

    # 14. the port's C extension on the main path: 14a cell A fed by the
    # C encoder (each chunk held to numpy's, beside the same cell with
    # numpy's and phase 4's A) and the strided layout at T=16,384; 14b
    # 13a's boot on the transport's C planes with one proxy
    kernels.release_scratch()
    torch.cuda.empty_cache()
    native = report["native_phase"] = native_phase(dev, args.seed, phase_a,
                                                   net["13a"])
    planes.update(native["native_planes"])
    log(f"phase 14 on {card}: " + json.dumps({
        "14a": {k: native["14a"][k] for k in ("c", "numpy", "phase_4a")},
        "14a_encode_ms": native["14a"]["encode"]["encode_ms"],
        "14a_strided": native["14a_strided"],
        "14b": {k: native["14b"].get(k) for k in (
            "attempts_per_wall_s", "committed", "native_read_hits",
            "native_grv_hits", "degraded_connections", "memory_allocated",
            "device_bytes_before", "beside_13a")}}))
    log(f"native planes by phase on {card}: " + json.dumps(planes))

    # 15. the C-API bindings: 15a the fdb_c lifecycle, the conformance runs
    # and the multiversion checks against two server_main processes whose
    # resolvers run on the card, every resolver batch held to the oracle;
    # 15b the graft entry's step against its plain step, and the dryrun
    kernels.release_scratch()
    torch.cuda.empty_cache()
    bindings = report["bindings"] = bindings_phase(dev, args.seed)
    log(f"phase 15 on {card}: " + json.dumps({
        "15a": {k: bindings["15a"].get(k) for k in (
            "ops", "runs_s", "ops_per_s", "compared", "attempts", "commits",
            "resolved_batches", "chunks", "device_bytes")},
        "15b": {k: bindings["15b"].get(k) for k in ("step_ms", "dryrun")}},
        default=str))

    # 16. the end-to-end driver: 16a bench.run_e2e() (both backends at the
    # driver's defaults, in subprocesses), 16b the device backend on a
    # fanned-out, contended run and 16c the sharded backend, each with its
    # core recorded and every resolver batch held to the oracle
    kernels.release_scratch()
    torch.cuda.empty_cache()
    e2e = report["e2e"] = e2e_phase(dev)
    log(f"phase 16 on {card}: " + json.dumps({
        "16a": {b: {k: e2e["16a"][b].get(k) for k in E2E_PHASES}
                for b in ("oracle", "device")},
        "16b": {k: e2e["16b"].get(k) for k in (
            "mixed", "mixed-contended", "stages", "queueing_ratio",
            "readback_overlap_ratio", "resolved_batches", "chunks",
            "device_bytes")},
        "16c": {k: e2e["16c"].get(k) for k in (
            "write", "resolved_batches", "chunks", "launches")},
        "wall_s": e2e["wall_s"]}, default=str))

    timing_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms", "library_device_ms", "host_ms",
                   "launches_per_call")
    kernels_line = []
    for name, (source, replaces) in kernels.KERNELS.items():
        r = kres[name]
        entry = {"name": name, "route": "cuda",
                 "source": f"foundationdb_tpu_torch/{source}",
                 "replaces": replaces.split(" ")[0]}
        if name in SHARD_KERNELS:
            entry["launches"] = sharded["launches"][name]
            entry["launches_8b"] = phase_8b["launches"][name]
            for W in bench8:
                entry[f"launches_8c_w{W}"] = bench8[W]["launches"][name]
            entry["max_abs_err"] = r["max_abs_err"]
        elif name in PATH_KERNELS:
            entry["launches"] = phase_a["launches"][name]
            entry["launches_sharded_8a"] = sharded["launches"][name]
            if name in STEP_KERNELS:
                entry["launches_phase_b"] = phase_b["launches"][name]
                for T in benches:
                    entry[f"launches_bench_{T}"] = \
                        benches[T]["launches"][name]
                entry["launches_ab"] = ab["launches"][name]
            errs = [r["max_abs_err"], kres_b[name]["max_abs_err"]]
            errs += [kres_bench[T][name]["max_abs_err"] for T in benches]
            entry["max_abs_err"] = max(errs)
        elif name == "legacy_blocked":
            entry["launches"] = ab["launches"][name]
            entry["max_abs_err"] = max(r["max_abs_err"],
                                       r["per_evaluation"]["max_abs_err"])
            entry["evaluations"] = r["evaluations"]
            entry["per_evaluation"] = {k: r["per_evaluation"][k]
                                       for k in timing_keys}
        else:
            entry["launches"] = probe_run["launches"][name]
            entry["max_abs_err"] = r["max_abs_err"]
        entry["launches_cluster"] = sum(
            cluster[run]["launches"][name] for run in cluster)
        entry["launches_recovery"] = recovery["launches"][name]
        entry["launches_sim"] = sim["launches"][name]
        entry["launches_backup"] = backup["launches"][name]
        entry["launches_net"] = net["launches"][name]
        entry["launches_native"] = native["launches"].get(name, 0)
        entry["launches_bindings"] = bindings["launches"].get(name, 0)
        entry["launches_e2e"] = e2e["launches"].get(name, 0)
        entry.update({k: r[k] for k in timing_keys})
        if name in SHARD_KERNELS:
            entry["bench_16384_w4"] = {k: r["bench_16384_w4"][k]
                                       for k in timing_keys}
        if name in PATH_KERNELS:
            entry["cell_b"] = {k: kres_b[name][k] for k in timing_keys}
            if "t_2_20" in r:
                entry["t_2_20"] = {k: r["t_2_20"][k] for k in timing_keys}
            for T in benches:
                entry[f"bench_{T}"] = {k: kres_bench[T][name][k]
                                       for k in timing_keys}
        kernels_line.append(entry)
    report["kernels_line"] = kernels_line
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=str)

    log(f"smoke: {time.perf_counter() - _T0:.1f} s, phase 16 "
        f"{e2e['wall_s']:.1f} s, on {card}")
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
