#!/usr/bin/env python3
"""Drive the raydp_tpu_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if its check fails:

1. Build every CUDA kernel of the port from ``raydp_tpu_torch/csrc``
   (nvcc, sm_90a, one process per source), report each instance's
   registers, shared memory, resident CTAs per SM and spills (failing on
   a spill in any kernel, by the CUDA runtime's count or ptxas's), then
   hold each kernel against its plain PyTorch version on the card (exact
   f32 matmuls for the plain side):
   f32 and bf16, causal and not, at the main path's shapes, and both
   dtypes also at D 16/32/128 and S 48/96. The forward's ``out`` and
   ``lse``; the backward's delta, dq, dk and dv under a random
   cotangent. Times each kernel at the BERT shape (B 32, S 128) as a CUDA
   graph of calls, warm (inputs in L2) and cold (rotating over input
   sets larger than the 50 MB L2), beside its plain version, the forward
   against ``scaled_dot_product_attention`` and the whole backward
   against SDPA's backward, both as CUDA graphs (the library yardsticks,
   which the port never calls), SDPA's backward also as a torch.profiler
   sum of its kernels; then the f32 kernels the same way (the forward,
   delta, dq and dk/dv), with their bounds on the CUDA cores and in TF32
   x3 on the tensor cores, the f32 forward at the decode oracle's shapes
   and the whole f32 backward against SDPA's f32 backward.
2. BERT-GLUE forward: ``SequenceClassifier`` at bert_base width, bf16,
   ``attention_impl="flash"``, batch 32 x seq 128; logits held against
   the same weights with dense attention (bf16 and f32).
3. Decode server: a bert_base-width f32 ``CausalLM`` engine behind one
   ``DecodeLoop``, 8 ragged prompts (3 to 200 tokens), 16 new tokens
   each, its prefill and step replayed as CUDA graphs (one per prompt
   bucket and kv bucket used, run eagerly at first use and captured at
   the second); every stream must equal ``reference_decode``, which runs
   the flash kernel, reruns must repeat them, and each captured graph,
   replayed at a cache state, must give the eager ``decode_step``'s or
   ``prefill``'s tokens there.
4. BERT-GLUE fine-tune: (a) one batch's parameter gradients with flash
   against dense attention (bf16 and f32); (b) ``Estimator.fit`` of the
   bf16 flash ``SequenceClassifier`` at bert_base width and depth,
   dropout 0.1, AdamW, ``softmax_ce``, batch 32 x seq 128, unshuffled,
   4 epochs of 10 steps on learnable data, once with
   ``epoch_mode="stream"`` (eager steps) and once with ``"scan"`` (the
   step captured as a CUDA graph and replayed), the two held together;
   then ``evaluate`` and ``predict``, and each path's step timed and
   profiled, the flash kernels in the trace of 5 graph replays counted
   against the launch counters; (c) a short self-supervised ``lm_ce``
   fit of a bert_base-width ``CausalLM`` (causal flash backward) on both
   paths; (d) the 4b fine-tune with ``remat=True`` on the scan path, its
   blocks recomputed in the backward (24 forward launches a step, 12 of
   each backward kernel, in the counters and in a trace of 5 replays),
   its losses held against 4b's and its peak memory beside 4b's.
5. DLRM: ``PackedDLRM`` at ``criteo_dlrm``'s full width (26 tables of
   100k x 128, bf16 trunk) through ``Estimator``, bce, AdamW, batch
   1024, on both epoch paths from the same weights, over Criteo-shaped
   rows with Pareto-skewed ids; one table by ``onehot`` against ``take``.
6. MoE: ``MoEClassifier`` over bert_base with the flash trunk (8 experts
   of d_ff 3072, top-2), ``aux_losses=True``, on both epoch paths: 12
   launches of each bf16 flash kernel a step, the aux term finite, the
   share of token-slots dropped for capacity.
7. GBT: ``GBTEstimator`` at examples/gbt_nyctaxi.py's settings on
   synthetic taxi rows (squared, then logistic), on the card and on the
   CPU in the same run: histories and predictions within rtol 1e-3; the
   card's histograms sum with atomics, so where that flips a near-tie
   and the trees part, the histories within rtol 1e-3 through the round
   they parted at and the final losses within 1e-2; the split nodes
   that differ counted either way; save, restore and predict the same.
8. Keras: ``TFEstimator`` with examples/tf_nyctaxi.py's tower on the
   taxi rows (``predict`` held against the returned model), and a
   Titanic-shaped classifier with its sigmoid head fused.
9. Serve plane: (a) a ``ReplicaGroup`` of 2 replica processes on the
   card, batch mode (buckets 32/64/128, batch up to 32, SLO 10 ms),
   serving phase 2's bert_base bf16 flash classifier
   (:func:`classify_batch`, shipped by reference); 512 requests of 8-128
   random ids at once, twice (the first pass warms the replicas), every
   reply held against the driver's dense forward (no kernel) of the
   same weights on the same padded ids (the bf16 logit bound, equal
   argmax save ties at that bound), each replica reporting the card,
   the memory it holds there and flash forward launches by ``Ping``;
   phase 1 holds the kernel against its plain version at these
   batches' shapes. Then the
   same traffic under ``serve_kill:replica=0,request=8``: 512 replies,
   0 errors, a restart and both lineages alive again. (b) A decode-mode
   group of 1 replica serving the bert_base-width f32 decode engine of
   phase 3 under ``serve_kill:replica=0,request=4``: four prompts of 48
   new tokens, the trigger ``[9, 9]`` once 4 tokens have streamed; every
   stream equal to the driver's ``reference_decode`` (the f32 flash
   kernel), a restart and requeued prefills.
10. The ETL half in one process, frames built from numpy columns through
   the engine's ``from_arrow``: (a) the native host library built from
   ``raydp_tpu_torch/native/src`` and loaded (the run fails if not);
   ``hash_bucket`` over 4M int64 and float64 keys with nulls bit-exact
   with its numpy twin, directly and through the exchange's hash;
   ``gather_matrix`` (f32, i32) over a 129-column int frame of 8192 rows
   equal to numpy fancy indexing; each timed against its twin. (b)
   examples/data_process.py's taxi rows (100,000 of its 200,000 since
   phase 19) through its
   ``nyc_taxi_preprocess`` over 4 partitions and ``random_split([0.9,
   0.1], seed=42)``, held against the same features computed with numpy
   (rows and values exact, the haversine within rtol 1e-12), feeding
   ``Estimator.fit_on_df`` of the taxi MLP and ``predict_on_df`` (one
   prediction per row, in row order), ``GBTEstimator.fit_on_df`` at
   phase 7's settings and ``TFEstimator.fit_on_df`` with phase 8's
   tower; falling losses. (c) examples/bert_glue.py's rows (4,096 of its
   8192 since phase 19) as a
   frame of 4 partitions -> ``Estimator.fit_on_df(num_shards=2)`` of the
   bf16 flash classifier at bert_base width and depth, batch 64, AdamW,
   2 epochs on the path ``"auto"`` picks: 12 launches of each flash
   kernel a step, in the counters. (d) examples/dlrm_criteo.py's
   rows (250,000 of its 500,000 since phase 19) and rare-id remap (``groupBy().count()``, a udf), the
   vocab sizes against ``np.unique``, into a stream ``PackedDLRM`` fit.
   ETL seconds and rows/s, and the seconds from each ``fit_on_df``'s
   call to its first step.
11. The session: ``raydp_tpu_torch.init(app_name="chip-smoke",
   num_workers=4)``, the AppMaster and 4 ETL worker processes, the
   partitions in the shared-memory object store, stages shipped to the
   workers as closures. (a) ``init``'s seconds and the shm directory's
   capacity; 4 workers alive, a frame's executor a ``ClusterExecutor``,
   and each worker, with the engine imported, holding no torch and
   seeing no CUDA device. (b) 10b's taxi ETL and random_split on the
   workers (the haversine udf shipped by value), held against numpy as
   10b is, its input rows/s beside 10b's, then 10b's MLP
   ``fit_on_df``/``predict_on_df`` on the card. (c) 10c's fine-tune
   from a frame on the workers: 12 launches of each kernel a step, ms a
   step and seconds to the first step beside 10c's. (d)
   ``to_object_refs(owner_transfer=True)`` of 11b's output, a worker
   SIGKILLed, every ref read back equal (by the driver and a worker)
   once the respawned worker has joined, then ``stop()``: every worker
   exited and no segment of the session left in the shm directory.
12. Second drivers of a fresh 4-worker session: (a) client mode: a
   second driver process (:func:`client_main`) attaches with
   ``raydp_tpu_torch.connect`` and runs 10c's fine-tune through the
   session (the frame's ETL on the workers, every block read over the
   store agents' chunked fetch, the fit on the card in that process),
   twice (the first fit pays the process's first CUDA work): its own
   counters must read 12 launches of each kernel a step, its losses
   fall; after it disconnects the workers are alive and the refs
   it handed to the holder read back in this process; its ms a step and
   seconds to the first step beside 11c's, and each process's peak
   device memory. (b) an SPMD gang (``spmd.create_spmd_job``, 2 rank
   processes on the card) scores 10c's frame, each rank its shard of
   ``MLDataset.from_df(rank_nodes=job.rank_nodes())`` sent in
   ``per_rank_args``, with phase 2's classifier (:func:`gang_score`);
   each rank's logits equal to this process's forward of the same rows, 12 ``flash_fwd`` launches a batch by each rank's own counter,
   and the ranks' gloo ``all_reduce`` of ``[correct, rows]`` equal to
   their sums; the gang's sequences/s beside phase 2's.
13. Windows, query profiling and ``fit_spmd`` on a fresh 4-worker
   session: (a) 250,000 Criteo-shaped rows (500,000 until phase 19; 13
   dense, 26 categorical
   columns of zipf-like ids over at most 100,000 values) through the
   reference notebook's id assignment on the workers (``posexplode``,
   ``groupBy("column_id", "data").count()``, ``row_number().over(
   Window.partitionBy("column_id").orderBy(desc("count"), "data")) - 1``),
   every column's ids equal to numpy's ranking; its
   ``explain(analyze=True)`` (footer counts, every stage ``[cluster]``
   with ``workers=``), ``profile()``'s rows against the frames' and a
   converged ``Cluster.progress_report()``; the ids joined back per
   column, equal to numpy's for every row, feeding
   ``PackedDLRM(criteo_dlrm())`` through ``fit_on_df`` (stream, phase
   5's batches); ETL rows/s, stage seconds and skew. (b) ``fit_spmd`` of
   10c's bf16 flash classifier over a gang of 2 ranks on the card, each
   reading its plan's slices of 512 GLUE rows (1,024 until phase 19) from
   the object store,
   batch 32 a rank, 2 epochs: the backend the rule picks, the ranks'
   losses equal and their final parameters identical, 12 launches of
   each kernel a step by each rank's counters, a falling loss, and the
   gang's checkpoint restored into a single-process estimator with
   equal parameters; each rank's step ms and its gradient exchange's
   share (CUDA events), peak memory, ``start()`` seconds and the first
   step's seconds after the call.
14. Fault tolerance of training on a fresh 4-worker session holding
   512 of 10c's GLUE rows (store mode), 13b's classifier cut to
   ``FT_LAYERS`` (2) layers since phase 19
   (:func:`ft_factory`): (a) a clean in-process ``Estimator.fit`` (batch
   32, 2 epochs, 32 steps), then ``fit_spmd(world_size=1)`` of the same
   under ``kill:rank=0,step=8`` with ``save_every_steps=8``: one
   restart, ``step_mid_8.pt``, 0 replayed steps, the last epoch's loss
   and the final parameters equal to the clean fit's (``torch.equal``);
   the recovery seconds (the supervisor seeing the exit to the resumed
   run's first step, the backoff apart) and each checkpoint's bytes and
   write seconds. (b) ``fit_spmd(world_size=2)``, batch 32 a rank, one
   epoch, clean and under ``preempt:step=6,grace=0``: both ranks drain
   after step 6 into ``step_emergency_6.pt`` (``data_world`` 2, position
   (0, 6)), one restart, ``preemptions/total`` and ``restarts/total`` up
   by one in this process, the resumed ranks equal to each other and to
   the clean gang; drain and recovery seconds, peak memory a rank; then
   ``SPMDJob.request_preemption()`` on a running 2-rank gang
   (:func:`gang_train_until_preempted`): both ranks drain after the same
   step into one emergency checkpoint, the call inside the grace. (c)
   that ``step_emergency_6.pt`` alone in a fresh directory, resumed by
   ``fit_spmd(world_size=1, elastic=True)`` over the same 2-shard
   dataset: the skip rescaled from 6 to 12 batches, 4 steps of 32 rows,
   a finite loss. Every fit runs ``FT_LAYERS`` launches of each kernel a
   step by its process's counters; ``stop()`` leaves no segment.
15. Telemetry, one run traced, billed and watched: ``RAYDP_TPU_TELEMETRY_DIR``
   and ``RAYDP_TPU_POSTMORTEM_DIR`` set to fresh directories before a
   fresh 4-worker ``init`` (the workers and ranks inherit them); 1,024
   of 10c's GLUE rows through a ``mapPartitions`` stage and a
   ``groupBy("label").count()`` exchange on the workers under an
   ``etl`` job, then ``fit_spmd(world_size=2)`` of 13b's classifier,
   one epoch, batch 32 a rank (16 steps a rank), store mode. Held: the
   merged shards are one trace (the driver, the master's events, two or
   more ETL workers' ``worker/task`` spans, both ranks' 16 ``train/step``
   spans, every record the session's ``trace_id``, no rank span a root);
   the Chrome trace loads and every record's aligned start lies in the
   phase's wall window; ``trace_report()``'s critical path, its skew
   table of 2 ranks x 16 steps and its data-wait/compute split, and the
   ``analyze`` CLI; the ``fit-spmd`` job's chip-seconds in the gang's
   and the session's ``usage_report()`` equal to the ranks' epoch wall
   times summed (each epoch bills its own interval, so this holds that
   shipping lost nothing), those epochs between half and all of 2 x the
   launch's ``run()`` on the driver's clock, the ``etl`` job's
   task-seconds and the shuffle or staged bytes it moved;
   the Prometheus exposition's task, step-timer and ``raydp_job_*``
   families and each rank's ``hbm/peak_bytes`` within 10% of its
   ``max_memory_allocated``, ``/metrics`` and ``/healthz`` answering
   200; the gang's events in order under the fit's job; a healthy
   ``health_report()``, then a SIGTERMed ETL worker's postmortem bundle
   (its event tail, every thread's stack), its respawn and its name in
   ``dead_workers``; 12 launches of each kernel a step in each rank;
   no segment left. Prints each process's spans and dropped spans, the
   shard bytes, and the ranks' ms a step beside 13b's and 4b's beside
   their earlier runs'.
16. The device plane (run after 4b, inside 12b and 13b, and inside 15).
   (a) 4b's bf16 stream fine-tune, 1 epoch of 20 steps, with the plane
   on: its four phase fractions summing to 1 within 1e-3, ``mfu`` in
   (0, 1] against the card's bf16 peak (a card without a row in the
   peak table fails), a step's FLOPs counted on the meta device within
   5% of the closed form for bert_base at 32 x 128, a bound verdict, a
   step's device span between 0.9 x 4b's graph-replay step and the
   loop's wall a step and its compute phase inside it, 12 launches of
   each kernel a step; then the same fit (2 epochs) with
   ``RAYDP_TPU_DEVICE_PLANE`` on and off in turns, 3 runs a side, epoch
   1's ms a step and the whole fit's wall printed; the plane's own host
   work a step, timed alone, under 1% of 4b's eager step. (b) A NaN entering the loss at
   step 6 of 8, the sentinel checking every 4th step: ``nan_loss``
   tripped at the check, ``anomalies/nan_loss`` counted, a flight
   bundle written. (c) In 12b's gang, before its scoring run: each rank
   fits 8 steps with the plane on, then scores its shard in a loop while
   the driver captures 2 s of the gang (``SPMDJob.capture_profile``):
   one merged trace with both ranks' profiler processes, their span
   records and their ``flash_fwd`` kernels; ``resource_report()``
   gives each rank's ``mfu`` (in (0, 1]) and ``bound``. In 15, before
   the SIGTERM: ``Cluster.capture_profile(1.0)`` over the driver and
   the 4 workers, ``/debug/profile`` and ``/debug/dashboard`` answering
   200, ``dashboard_report()`` of one shape from the session and from a
   ``connect()``ed client, and the SLO engine's sampled series. 13b's
   and 15's ranks print their phase split, each rank's
   ``collective_frac`` within 0.05 of its step clock's
   ``allreduce_ms / step_ms`` times the wall's share outside the input
   wait.
17. The control plane (run inside 14's session, then on a fresh one).
   (a) The arbiter at capacity 2: a priority-0 ``fit_spmd`` of 14b's
   configuration on 2 ranks (:func:`marked_factory`: 8 steps a rank,
   an emergency checkpoint directory) is preempted, once its first step
   is done, by the arrival of a priority-5 ``ReplicaGroup`` of 1 replica
   of phase 2's flash classifier (``slots = replicas``): the gang drains
   after one step on both ranks and releases its lease, the group is
   admitted and serves (b), the drained gang waits queued, and once the
   group stops it re-enters admission (``sched/resume``) and resumes
   from its emergency checkpoint to parameters equal (``torch.equal``)
   to 14b's clean gang's, ``FT_LAYERS`` launches of each kernel a
   resumed step by
   each rank's counter. Printed: the seconds from the arrival to
   ``sched/preempt``, the ranks' drain seconds, the arrival's admission
   wait, the seconds from the group's release to the victim's first
   resumed step, the victim's ``sched/preempt`` -> ``sched/resume``
   episode from the event timeline, and ``dashboard_report()``'s
   scheduler section while the group serves. (b) Open-loop load on the
   admitted group: 16 replies held against the dense forward, a Poisson
   schedule of 200 requests/s for 4 s through ``GroupTarget`` and one of
   25/s for 2 s through ``HttpTarget`` on a ``ServeFrontend``, every
   outcome ``ok``; then the knee finder (p99 SLO 250 ms and shed
   threshold 0.05, ``KneeConfig``'s defaults; 1 s steps from 32
   requests/s, x1.7, 2 bisections): offered against achieved, p50/p99,
   the outcome counts and the phase breakdown of each run, the knee and
   the whole rate/p99 curve; the replica's flash launches by ``Ping``.
   (c) The autoscaler (``ClusterProvisioner``) over a fresh session of
   1 torch-free worker, max 3: an arbiter waiter queued behind a holder
   grows the pool in one evaluation, the second grow passes
   ``spawn_fail:nth=1`` by backoff, and a 96-task ETL of 8-task rounds
   runs across the drain back to 1 worker; the seconds to grow, the
   drain latency, the tasks lost (0) and the flap episodes (0).
18. The torch compat estimator (``TorchEstimator``) on the card, its
   model 13b's bf16 flash classifier at bert_base width with
   ``COMPAT_LAYERS`` (2) layers since phase 19
   (dropout 0, fed segment ids 0 so that every parameter takes part in
   the loss, as DDP needs), built by a creator on the CPU and moved to
   the card, AdamW 1e-4, ``CrossEntropyLoss``, int64 ids and labels.
   (a) ``python -m raydp_tpu_torch.cli.submit --name chip-18a
   --num-workers 2 --conf chip.phase=18a`` runs a driver script this
   script writes to a temporary file (:func:`compat_driver_main`): it
   prints the handoff ``init()`` got (app name, worker count, live
   workers, conf), each held by this process, then ``fit_on_df`` of
   1,024 GLUE rows (4 partitions of a session of 2 workers) for one
   shuffled epoch at batch 32 with a 64-row eval frame, ``evaluate``
   and ``predict`` on those 64 rows, ``save`` and ``restore`` into a
   fresh estimator; its counters show ``COMPAT_LAYERS`` launches of each
   kernel a step and as many forward launches an eval or predict
   forward; the per-step
   losses fall (the first 8 steps' mean above the last 8's), the eval
   numbers are finite, and the restored estimator's ``predict`` equals
   the first's and its model's own forward. (b) In phase 14's session,
   ``TorchEstimator(num_workers=2)`` on phase 14's 512 rows as a
   fresh ref-backed dataset (256 a rank, batch 32, one epoch) with a
   ref-backed eval set of 128 rows over 2 blocks: the store feed (the
   driver's ``_rows_range`` replaced by one that fails), DDP over gloo
   on one card, the eval reduced over the gang; each rank's own
   counters (written by a forward hook of the creator's model) show
   ``COMPAT_LAYERS`` launches of each kernel a step and as many forward
   launches an eval; the
   ranks' step losses fall (the first 3 steps' mean above the last
   3's).
19. Model parallelism (18a's process running beside it): one gang of 4
   ranks on the one card,
   one process per mesh position, over gloo (the ranks share the card:
   ``parallel/collectives.py`` stages send/recv and all_to_all through
   the host). (a) ``fit_spmd(mesh=MeshSpec(sp=2, tp=2))`` of 10c's
   bf16 classifier at bert_base width and depth with ring attention,
   dropout 0, AdamW 2e-5, the first 1,024 of 10c's rows, one unshuffled
   epoch at batch 32 (every rank reads the same rows: dp is 1): each
   rank's 32 step losses within 6e-2 of the same fit on one rank (dense
   attention, the same initial parameters from seed 9, the same rows);
   each rank holds half the rows of block 0's ``qkv`` and ``mlp_up``
   and half the columns of its ``out`` and ``mlp_down``; the trained
   model's Ulysses logits within the bf16 forward bound (2e-2) of its
   ring logits on 32 rows; the gathered epoch checkpoint restored on
   one rank predicts the ring's logits (the 12-layer bf16 logit bound);
   the ranks' gathered parameters equal; no flash launch (the ring is
   plain torch). Each rank reports its step and gradient-exchange ms
   (CUDA events), its tp/sp collectives' calls, ms and bytes staged
   through the host a step, and its peak memory. (b) ``fit_spmd(mesh=
   MeshSpec(dp=2, pp=2))`` of a ``PipelinedClassifier`` at bert_base
   width (one block a stage, as the reference builds it), bf16 flash, 4
   microbatches, 3 epochs of 4 steps a dp rank over 128 rows each: each
   rank's pipelined forward of the initial model on its rows equals the
   stages in sequence on one rank (the logit bound), the loss falls,
   each rank holds one stage, and each rank's counters read 52 forward
   (1 block x 4 microbatches x 12 steps, and 4 for the check forward)
   and 48 of each backward kernel.
20. DLRM tables over tp and MoE experts over dp, in 19's gang after
   19b (no gang of its own). (a) ``PackedDLRM(criteo_dlrm())`` (26
   tables of 100,000 x 128, phase 5's weights from seed 12) over
   ``MeshSpec(dp=2, tp=2)`` with the DLRM ``LOGICAL_RULES``, bce, AdamW
   1e-3, 8 steps at batch 1,024 (512 a dp rank, its half of each global
   batch): each rank holds 50,000 rows of every table, the step losses
   within 6e-2 of the same fit on one rank (the driver's, from the same
   weights and batches); each rank's table bytes, peak memory, the tp
   collectives' calls, ms and staged bytes a step, the tp reduction's
   bytes and the gradient exchange's ms a step. (b) ``MoEClassifier``
   at bert_base width (phase 6's experts: 8 of d_ff 3072, top-2,
   capacity factor 1.25, flash, bf16) cut to ``FT_LAYERS`` blocks,
   dropout 0, over ``MeshSpec(dp=2, tp=2)``: 4 experts a rank with
   their FFN halved over tp, ``aux_losses=True``, AdamW 1e-4, 4 steps at
   batch 32 x 128 (16 a dp rank), against the same fit on one rank: the
   kept slots of every layer and step equal on every rank and within
   ``KEPT_ATOL`` (1%) of the one-rank fit's (bf16 rounding under tp flips
   near-tie choices), the step losses within 6e-2, and each rank's flash
   launches the count predicted before the first run (``FT_LAYERS`` of
   each kernel a step).
21. A mesh in an elastic fit, and the static checker. (a) In 19's gang
   after 20 (no gang of its own): 10c's bf16 flash classifier at
   bert_base width cut to ``FT_LAYERS`` blocks, dropout 0, its initial
   parameters from seed 14, over ``MeshSpec(dp=2, tp=2)``, AdamW 2e-5,
   ``ELASTIC_K`` steps at batch 32 a dp rank (each dp rank on the first
   rows of its shard of 21's 384 GLUE rows), then a gathered checkpoint
   at that data position; tp peers' step losses equal, each rank's
   launches the predicted count.
   (b) ``fit_spmd(mesh=MeshSpec(dp=2, tp=2), elastic=True)`` of the same
   classifier over the rows as 2 shards, resuming from (a)'s checkpoint,
   its first launch stubbed to "only 2 of 4 ranks registered"
   (``create_spmd_job`` wrapped in this process): the relaunch runs
   ``MeshSpec(tp=2)`` on 2 new ranks, the rows re-planned over dp 1 and
   the skip rescaled from dp 2 (``2 * ELASTIC_K`` of 12 batches); world
   2 and one restart, the skip, the samples trained, each rank's flash
   launches (``FT_LAYERS`` of each kernel a step), the tp ranks'
   gathered parameters equal, and the step losses within 6e-2 of the
   same resume on one rank (dense attention, the same checkpoint). (c)
   ``python -m raydp_tpu_torch.analysis raydp_tpu_torch/`` in a process
   of its own that cannot import JAX or the JAX package: exit 0 and zero
   findings.

Every process started from phase 9 on logs its start's parts
(``raydp_tpu_torch/utils/startup.py``): after each phase a ``[start]``
line a process with its total and its seconds of interpreter start-up,
``import torch``, CUDA context, kernel libraries, model, optimizer
(AdamW's import of ``torch._dynamo``), first step and the rest, and at
the end a summary of each part over all starts. The card's machine
sets ``PYTHONDONTWRITEBYTECODE``, so every process compiled torch's
modules from source; the script keeps a bytecode cache for itself and
every process it starts (:func:`bytecode_cache_on`).

Each phase of 4-8 reports ms/step (CUDA events over graph replays and
eager steps, and per epoch by the host clock), samples/s, the traced
idle share and the peak device memory of each fit. Kernel launch counts
are set to 0 just before each main-path phase (2, 3, 4b, 4c, 4d, 6, 9,
10c, 11c, 12a, 12b, 13a, 13b, each fit of 14, 15, 16, 17, 18, 19, 20
and 21) and read just after; phase 9's and 17b's replicas, 12a's and
18a's second drivers and 12b's, 13b's, 14's, 15's, 16c's, 17a's, 18b's,
19's and 21b's ranks are new processes,
whose counts start at 0 and are read by ``Ping`` or returned in their
results (a rank that is killed or drains returns none). The last lines
are a ``kernels`` JSON line, the card's name and power limit, and
``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and FLOP/s by input type
# (bf16 and tf32 on the tensor cores, f32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}

TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# Backward kernels vs plain: the JAX package's gradient bounds; the slack
# over the forward's comes from summation order, which can move a bf16
# rounding of p or ds by one ulp. delta is one f32 row sum.
GRAD_TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
            "bfloat16": dict(rtol=6e-2, atol=6e-2)}
DELTA_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 logits after 12 layers: two bf16 paths differ by ~1e-2 at logits
# of ~3 (bf16 rounds every layer), so 2e-2 relative plus 5e-2 absolute.
LOGIT_TOL = dict(rtol=2e-2, atol=5e-2)

# (B, S, H, D) of the main path: decode reference prompts (B 1, S 16..256),
# BERT-GLUE (32, 128), the serve plane's classifier batches (B up to 32 at
# S 32, 64, 128: full batches and an odd one), the DataFrame fine-tune
# (64, 128), and longer sequences.
KERNEL_SHAPES = [(2, 16, 12, 64), (1, 256, 12, 64), (32, 128, 12, 64),
                 (32, 32, 12, 64), (32, 64, 12, 64), (17, 128, 12, 64),
                 (64, 128, 12, 64), (4, 512, 12, 64)]
# Every kernel but the delta pass has a wgmma instance in each dtype (f32:
# TF32 x3); each is also checked at every other head dim and at S that is
# not a multiple of its 64-row tiles.
EXTRA_SHAPES = [(2, 128, 4, 16), (2, 128, 4, 32), (2, 128, 4, 128),
                (2, 48, 12, 64), (2, 96, 12, 64)]
# The decode oracle's forward: B 1, H 12, D 64, causal, S in the prompt
# buckets of the phase-3 engine (page 16, max_len 512, prompts <= 216).
DECODE_ORACLE_SEQS = [16, 32, 64, 128, 256]
# Cold-L2 timing rotates over this many input sets at the BERT shape:
# 25 MB (bf16 forward) to 76 MB (f32 dk/dv) each, so 4 exceed the 50 MB L2.
COLD_SETS = 4
GRAPH_REPS = 10
GLUE_BATCH, GLUE_SEQ = 32, 128
DECODE_PROMPT_LENS = [3, 17, 40, 64, 90, 128, 161, 200]
DECODE_MAX_NEW = 16
# Fine-tune: 10 steps an epoch; the causal LM fit: batch 8 x seq 256, 3
# steps an epoch (scan: epoch 0 the 3 warm-up steps, epoch 1 the capture
# and 2 replays, epoch 2 replays only).
FIT_EPOCHS, FIT_STEPS = 4, 10
LM_BATCH, LM_SEQ, LM_EPOCHS, LM_STEPS = 8, 256, 3, 3
# DLRM (criteo_dlrm, batch 1024) and the MoE classifier (batch 32 x 128):
# epochs of steps on each path.
DLRM_BATCH, DLRM_EPOCHS, DLRM_STEPS = 1024, 3, 8
MOE_EPOCHS, MOE_STEPS = 4, 8
# The taxi rows of the GBT and keras phases, before the filter; GBT trees
# (examples/gbt_nyctaxi.py); keras epochs.
GBT_ROWS, GBT_TREES, TF_EPOCHS = 200_000, 60, 3
# The symbols of the bf16 kernels in a profiler trace, by counter name.
KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_bf16_kernel",
                  "flash_bwd_delta": "flash_bwd_delta_kernel",
                  "flash_bwd_dq": "flash_bwd_dq_bf16_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv_bf16_kernel"}
# Scan against stream fit losses (bf16, dropout 0.1, unshuffled): the
# JAX package's bf16 backward bound. The two paths run the same kernels,
# but the scan path's optimizer runs in its capturable mode.
FIT_TOL = dict(rtol=6e-2, atol=6e-2)
# Peak device memory of each fit, (peak, held before it), by (phase, mode).
PEAK_BYTES = {}
# Rates one phase measures and a later one is set beside, by name.
RATES = {}
# Serve plane (phase 9): the batch group's traffic and knobs, the decode
# group's prompts and new tokens, and how long a replica may take to come
# up (a process reaches the card in ~8 s) or a request to be answered.
SERVE_REPLICAS, SERVE_REQUESTS, SERVE_MAX_BATCH = 2, 512, 32
SERVE_BUCKETS, SERVE_SLO_MS, SERVE_SEED = [32, 64, 128], 10, 0
# The kill lands inside replica 0's first batch (32 requests from the
# full queue): a later index needs a second batch, which the sibling
# replica can take all of while replica 0 warms up on its first.
SERVE_KILL_PLAN = "serve_kill:replica=0,request=8"
SERVE_DECODE_PROMPT_LENS, SERVE_DECODE_MAX_NEW = [5, 17, 40, 90], 48
SERVE_DECODE_KILL_PLAN = "serve_kill:replica=0,request=4"
SERVE_UP_S, SERVE_REQUEST_S = 180.0, 300.0
# Per-parameter relative L2 error of flash against dense gradients over
# 12 bf16 layers: the two paths round at different places (bf16 P, the
# kernels' summation order) and the differences grow through depth; a
# wrong kernel output gives errors of order 1.
GRAD_REL_BOUND = 0.1


# The start log (``raydp_tpu_torch/utils/startup.py``): its directory,
# the processes already reported and each part's sum over them.
START_LOG = {"dir": None, "seen": set(), "rows": []}
START_PARTS = ("up", "torch", "cuda", "dist", "kernels", "model",
               "optimizer", "first_step", "other")


def bytecode_cache_on() -> None:
    """Keep Python's bytecode for this process and every process it
    starts, in a directory of its own. The card's machine sets
    ``PYTHONDONTWRITEBYTECODE`` and its torch install has no
    ``__pycache__``, so every process compiled torch from source: 7.0-7.4
    s for ``import torch`` and 7.1-7.7 s more for AdamW's import of
    ``torch._dynamo`` on an H100 machine (``scripts/import_probe.sh``),
    in each rank, replica and driver subprocess. Call it before ``import torch``: this process
    writes the cache, the later ones read it."""
    import tempfile

    path = tempfile.mkdtemp(prefix="chip-smoke-pycache-")
    sys.dont_write_bytecode = False
    sys.pycache_prefix = path
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = path


def start_log_on() -> None:
    """Every process started from here on logs its start's parts."""
    import tempfile

    from raydp_tpu_torch.utils import startup

    START_LOG["dir"] = tempfile.mkdtemp(prefix="chip-smoke-starts-")
    os.environ[startup.ENV] = START_LOG["dir"]


def start_report(tag: str) -> None:
    """One line a process started since the last report: its role, its
    start's total (creation to its last part) and each part's seconds on
    the host clock, after ``@`` its start in the process's life."""
    from raydp_tpu_torch.utils import startup

    if START_LOG["dir"] is None:
        return
    rows = [r for r in startup.read_starts(START_LOG["dir"],
                                           exclude={os.getpid()})
            if r["pid"] not in START_LOG["seen"]]
    for r in sorted(rows, key=lambda r: r["start"]):
        START_LOG["seen"].add(r["pid"])
        r["tag"] = tag
        START_LOG["rows"].append(r)
        log(f"[start] {tag} {r['role']} pid {r['pid']}: {r['total']:.2f} s"
            + "".join(f", {p} {r[p]:.2f}" + (f"@{r[p + '@']:.1f}"
                                              if p + "@" in r else "")
                      for p in START_PARTS if p in r))


def start_summary() -> None:
    """Each part's sum over every start of the run, by role and in all."""
    rows = START_LOG["rows"]
    by_role = {}
    for r in rows:
        by_role.setdefault(r["role"], []).append(r)

    def sums(rs):
        return ", ".join(f"{p} {sum(r.get(p, 0.0) for r in rs):.2f}"
                         for p in ("total",) + START_PARTS)

    for role, rs in sorted(by_role.items()):
        log(f"[start] summary {role}: {len(rs)} starts, {sums(rs)}")
    log(f"[start] summary: {len(rows)} starts, {sums(rows)} (seconds "
        f"summed over processes; parts overlap across processes)")


def flash_module():
    """The module ``raydp_tpu_torch.ops.flash_attention`` (the package
    re-exports a function of the same name)."""
    import importlib

    return importlib.import_module("raydp_tpu_torch.ops.flash_attention")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def gpu_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, calls, reps: int = GRAPH_REPS) -> float:
    """Device ms per call with host launch gaps removed: ``calls`` (one
    per input set, run in turn) captured ``reps`` times into one CUDA
    graph and replayed. With one input set the inputs stay in the 50 MB
    L2 between calls (warm); rotating over sets that together exceed it
    reads them from HBM (cold)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            for fn in calls:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * reps * len(calls))
    del graph
    torch.cuda.empty_cache()
    return ms


def warm_cold_ms(torch, make_call, n_sets: int = COLD_SETS):
    """(warm, cold) graph-timed ms of ``make_call(i)``, the call on input
    set i."""
    calls = [make_call(i) for i in range(n_sets)]
    return graph_ms(torch, calls[:1]), graph_ms(torch, calls)


def report_build(torch):
    """Each bf16 and f32 kernel instance's registers, shared memory,
    resident CTAs per SM and spills (from the CUDA runtime), and the ptxas
    report of the wgmma instances (``-Xptxas=-v``): the forward, dq and
    dk/dv in both dtypes. Fails on a spill in any of them, by either
    count. Returns the names (``flash_fwd_f32_kernel<64>``, ...) of the
    wgmma instances that the build compiled."""
    import re

    from raydp_tpu_torch.ops import _build

    fa = flash_module()
    compiled = set()
    for src in _build.SOURCES:
        name = None
        for line in _build.build_log(src).splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"\d(flash_[a-z0-9_]+?kernel)I"
                              r"(13__nv_bfloat16|f)?Li(\d+)E", line)
                wgmma = m and ("_bf16_" in m.group(1)
                               or "_f32_" in m.group(1))
                name = wgmma and f"{m.group(1)}<{m.group(3)}>"
                if name:
                    compiled.add(name)
            elif name and ("Used" in line or "spill" in line):
                log(f"[1] ptxas {name}: {line.strip()}")
                spills = re.findall(r"(\d+) bytes spill", line)
                check(all(n == "0" for n in spills),
                      f"ptxas reports spills in {name}: {line.strip()}")
    for kernel in ("fwd", "dq", "dkv"):
        for dtype in (torch.bfloat16, torch.float32):
            for d in (16, 32, 64, 128):
                res = fa.kernel_resources(kernel, dtype, d)
                log(f"[1] resources {kernel} {str(dtype)[6:]} D {d}: {res}")
                check(res["spill_bytes"] == 0,
                      f"{kernel} {str(dtype)[6:]} D {d} spills: {res}")
    return compiled


def device_profile(torch, label, fn, top=5):
    """Trace one call of ``fn`` with torch.profiler: the device's busy and
    idle share between its first and last kernel, and the kernels that
    took the most device time. Tracing slows the host's launches, so the
    idle share is an upper bound on the untraced run's. Returns the
    number of device events of each name (None where the profiler saw
    no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device events only; user annotations (``Optimizer.step#...``) span
    # kernels already counted and are left out.
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        log(f"[profile] {label}: the profiler saw no device activity "
            "(not measured)")
        return None
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    by_name, seen = {}, {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        seen[name] = seen.get(name, 0) + 1
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(end for _, end, _ in spans) - spans[0][0]
    idle = 1.0 - busy / window if window > 0 else 0.0
    log(f"[profile] {label}: {len(spans)} device events over "
        f"{window / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share "
        f"{idle:.3f}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile]   {t / 1e3:9.3f} ms {t / busy:6.1%}  {name[:80]}")
    return seen


def kernel_sum_ms(torch, fn, reps: int = 5):
    """Device ms per call of ``fn`` as torch.profiler sees it: the summed
    durations of the device events of ``reps`` calls, over ``reps``; None
    where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if str(e.device_type).endswith("CUDA")
             and not getattr(e, "is_user_annotation", False)]
    return sum(spans) / 1e3 / reps if spans else None


def fused_qkv(torch, shape, dtype, gen):
    """q, k, v as strided views of one [B, S, 3, H, D] tensor, the layout
    the transformer hands the kernel."""
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
    return qkv.to(dtype).unbind(dim=2)


def _kernel_cases(torch):
    """(shape, dtype) of every kernel-vs-plain check of phase 1."""
    return [(shape, dtype) for shape in KERNEL_SHAPES + EXTRA_SHAPES
            for dtype in (torch.float32, torch.bfloat16)]


def phase_kernel(torch, P):
    from raydp_tpu_torch.ops import _build
    from raydp_tpu_torch.ops.flash_attention import (
        flash_attention_forward, flash_attention_plain,
    )

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[1] built {libs} in {time.perf_counter() - t0:.2f} s")

    wgmma = report_build(torch)
    P.set_exact_float32()  # the plain versions' f32 matmuls stay exact

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    cases = _kernel_cases(torch)
    for shape, dtype in cases:
        for causal in (False, True):
            q, k, v = fused_qkv(torch, shape, dtype, gen)
            out, lse = flash_attention_forward(q, k, v, causal=causal)
            ref_out, ref_lse = flash_attention_plain(q, k, v, causal)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            tol = TOL[name]
            err_o = (out.float() - ref_out.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            ok = (torch.allclose(out.float(), ref_out.float(), **tol)
                  and torch.allclose(lse, ref_lse, **TOL["float32"])
                  and bool(torch.isfinite(out).all()))
            log(f"[1] flash_fwd {shape} {name} causal={causal}: "
                f"out err {err_o:.3e} lse err {err_l:.3e} "
                f"(tol out {tol}, lse {TOL['float32']}) "
                f"{'ok' if ok else 'MISMATCH'}")
            check(ok, f"flash_fwd disagrees with plain at {shape} "
                      f"{name} causal={causal}")
            worst = max(worst, err_o)

    # Timing at the BERT-GLUE shape (bf16, not causal): the classifier's
    # call. Kernel and SDPA by CUDA graph, warm (the 25 MB of q/k/v/o stay
    # in the 50 MB L2) and cold (rotating over COLD_SETS input sets); the
    # wrapper-paced loop as earlier runs measured it; the plain version.
    b, s, h, d = GLUE_BATCH, GLUE_SEQ, 12, 64
    sets = [fused_qkv(torch, (b, s, h, d), torch.bfloat16, gen)
            for _ in range(COLD_SETS)]
    q, k, v = sets[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel_ms, kernel_cold = warm_cold_ms(
        torch, lambda i: lambda: flash_attention_forward(*sets[i]))
    paced_ms = time_ms(torch, lambda: flash_attention_forward(q, k, v),
                       iters=50)
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v),
                       iters=10)
    heads_first = [[x.transpose(1, 2) for x in st] for st in sets]
    library_ms, library_cold = warm_cold_ms(
        torch, lambda i: lambda: sdpa(*heads_first[i]))
    kernel_ms_2 = graph_ms(torch, [lambda: flash_attention_forward(q, k, v)])
    n_bytes = 4 * b * s * h * d * 2 + b * h * s * 4
    flops = 4 * b * h * s * s * d
    bound_ms, bound_by = _bound(n_bytes, flops)
    entry = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "raydp_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "raydp_tpu/ops/flash_attention.py:63",
        "launches": 0,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "ms_cold": kernel_cold,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    log(f"[1] flash_fwd at (B {b}, S {s}, H {h}, D {d}) bf16: kernel_ms "
        f"warm {kernel_ms:.4f} (again {kernel_ms_2:.4f}) cold "
        f"{kernel_cold:.4f}, wrapper-paced {paced_ms:.4f}; plain_ms "
        f"{plain_ms:.4f}; library_ms (sdpa) warm {library_ms:.4f} cold "
        f"{library_cold:.4f}; bound_ms {bound_ms:.4f} by {bound_by} "
        f"({n_bytes} B, {flops} FLOP); cold / bound "
        f"{kernel_cold / bound_ms:.1f}x")
    return entry, wgmma


def _bound(n_bytes, flops, dtype="bfloat16"):
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


def backward_set(torch, fa, shape, dtype, gen):
    """(q, k, v, out, lse, dO, delta): fused-qkv inputs, the forward
    kernel's out and lse, a random cotangent and the delta kernel's rows."""
    q, k, v = fused_qkv(torch, shape, dtype, gen)
    out, lse = fa.flash_attention_forward(q, k, v)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, out, lse, g, fa.flash_bwd_delta(out, g)


def whole_backward_vs_sdpa(torch, fa, sets, label):
    """The whole backward (delta + dq + dk/dv) against SDPA's backward,
    both device-only: ours as a CUDA graph of backward calls; SDPA's as a
    CUDA graph of captured forward + torch.autograd.grad less one of the
    forward alone, on [B, H, S, D] leaves. Warm and cold as the kernels;
    the wrapper-paced loops beside them. ``sets`` are backward_set's."""
    b, s, h, d = sets[0][0].shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [[x.transpose(1, 2).detach().requires_grad_(True)
               for x in st[:3]] for st in sets]
    cots = [st[5].transpose(1, 2) for st in sets]

    def sdpa_fwd(i):
        return lambda: sdpa(*leaves[i])

    def sdpa_fwd_bwd(i):
        return lambda: torch.autograd.grad(sdpa(*leaves[i]), leaves[i],
                                           cots[i])

    def ours(i):
        q_, k_, v_, out_, lse_, g_, _ = sets[i]
        return lambda: fa.flash_attention_backward(q_, k_, v_, out_, lse_,
                                                   g_)

    ours_warm, ours_cold = warm_cold_ms(torch, ours)
    fwd_warm, fwd_cold = warm_cold_ms(torch, sdpa_fwd)
    both_warm, both_cold = warm_cold_ms(torch, sdpa_fwd_bwd)
    ours_paced = time_ms(torch, ours(0), iters=50)
    sdpa_paced = (time_ms(torch, sdpa_fwd_bwd(0), iters=50)
                  - time_ms(torch, sdpa_fwd(0), iters=50))
    log(f"[1] whole backward (delta + dq + dkv) at (B {b}, S {s}, H {h}, "
        f"D {d}) {label}: graph warm {ours_warm:.4f} cold {ours_cold:.4f} "
        f"ms, wrapper-paced {ours_paced:.4f}; SDPA backward, graph "
        f"(fwd+bwd {both_warm:.4f} - fwd {fwd_warm:.4f}) warm "
        f"{both_warm - fwd_warm:.4f} cold {both_cold - fwd_cold:.4f} ms, "
        f"paced {sdpa_paced:.4f}; ours / SDPA warm "
        f"{ours_warm / (both_warm - fwd_warm):.2f}x")
    # The yardstick held against a profiler sum of SDPA's backward
    # kernels alone: its forward runs before the profiled window, and
    # every device event in the window belongs to autograd.grad.
    out = sdpa(*leaves[0])
    sdpa_sum = kernel_sum_ms(torch, lambda: torch.autograd.grad(
        out, leaves[0], cots[0], retain_graph=True))
    ours_sum = kernel_sum_ms(torch, ours(0))
    sums = ["not measured" if x is None else f"{x:.4f} ms"
            for x in (sdpa_sum, ours_sum)]
    log(f"[1] backward kernel sums (torch.profiler, 5 calls) {label}: SDPA "
        f"{sums[0]} against its graph yardstick {both_warm - fwd_warm:.4f} "
        f"ms; ours {sums[1]} against its graph {ours_warm:.4f} ms")


def phase_backward_kernels(torch, P):
    """Each backward kernel against its plain version on the same inputs
    (the kernels' own delta feeds both dq versions and both dk/dv
    versions), then times and bounds at the BERT shape."""
    fa = flash_module()

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"flash_bwd_delta": 0.0, "flash_bwd_dq": 0.0,
             "flash_bwd_dkv": 0.0}
    cases = _kernel_cases(torch)
    for shape, dtype in cases:
        for causal in (False, True):
            name = str(dtype).split(".")[-1]
            q, k, v = fused_qkv(torch, shape, dtype, gen)
            out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            delta = fa.flash_bwd_delta(out, g)
            dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal)
            dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
            want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, g, lse,
                                                      delta, causal)
            checks = [  # (kernel, output, kernel's, plain's, tolerance)
                ("flash_bwd_delta", "delta", delta,
                 fa.flash_bwd_delta_plain(out, g), DELTA_TOL),
                ("flash_bwd_dq", "dq", dq,
                 fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal),
                 GRAD_TOL[name]),
                ("flash_bwd_dkv", "dk", dk, want_dk, GRAD_TOL[name]),
                ("flash_bwd_dkv", "dv", dv, want_dv, GRAD_TOL[name]),
            ]
            torch.cuda.synchronize()
            report = []
            for kname, label, got, want, tol in checks:
                err = (got.float() - want.float()).abs().max().item()
                ok = (torch.allclose(got.float(), want.float(), **tol)
                      and bool(torch.isfinite(got).all()))
                report.append(f"{label} {err:.3e}")
                check(ok, f"{kname} {label} disagrees with plain at "
                          f"{shape} {name} causal={causal} (err "
                          f"{err:.3e}, tol {tol})")
                worst[kname] = max(worst[kname], err)
            log(f"[1] backward {shape} {name} causal={causal}: "
                f"{', '.join(report)} ok")

    # Timing at the BERT shape, bf16: graph-timed warm and cold (as the
    # forward), the wrapper-paced loop, the plain version.
    b, s, h, d = GLUE_BATCH, GLUE_SEQ, 12, 64
    sets = [backward_set(torch, fa, (b, s, h, d), torch.bfloat16, gen)
            for _ in range(COLD_SETS)]
    q, k, v, out, lse, g, delta = sets[0]
    el, row = b * s * h * d * 2, b * h * s * 4  # one bf16 tensor, one row stat
    work = {  # bytes each input read once and output written once; FLOPs
        "flash_bwd_delta": (2 * el + row, 2 * b * s * h * d),
        "flash_bwd_dq": (5 * el + 2 * row, 6 * b * h * s * s * d),
        "flash_bwd_dkv": (6 * el + 2 * row, 8 * b * h * s * s * d),
    }
    def args(i):  # (q, k, v, dO, lse, delta) of input set i
        q_, k_, v_, _, lse_, g_, delta_ = sets[i]
        return q_, k_, v_, g_, lse_, delta_

    calls = {  # kernel on input set i; plain on set 0
        "flash_bwd_delta": (
            lambda i: lambda: fa.flash_bwd_delta(sets[i][3], sets[i][5]),
            lambda: fa.flash_bwd_delta_plain(out, g)),
        "flash_bwd_dq": (
            lambda i: lambda: fa.flash_bwd_dq(*args(i)),
            lambda: fa.flash_bwd_dq_plain(*args(0))),
        "flash_bwd_dkv": (
            lambda i: lambda: fa.flash_bwd_dkv(*args(i)),
            lambda: fa.flash_bwd_dkv_plain(*args(0))),
    }
    entries = []
    for kname, (kernel, plain) in calls.items():
        kernel_ms, kernel_cold = warm_cold_ms(torch, kernel)
        paced_ms = time_ms(torch, kernel(0), iters=50)
        plain_ms = time_ms(torch, plain, iters=10)
        kernel_ms_2 = graph_ms(torch, [kernel(0)])
        n_bytes, flops = work[kname]
        bound_ms, bound_by = _bound(n_bytes, flops)
        entries.append({
            "name": kname,
            "route": "cuda",
            "source": "raydp_tpu_torch/csrc/flash_bwd.cu",
            "replaces": {
                "flash_bwd_delta": "raydp_tpu/ops/flash_attention.py:229",
                "flash_bwd_dq": "raydp_tpu/ops/flash_attention.py:109",
                "flash_bwd_dkv": "raydp_tpu/ops/flash_attention.py:144",
            }[kname],
            "launches": 0,
            "max_abs_err": worst[kname],
            "ms": kernel_ms,
            "ms_cold": kernel_cold,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes it alone
        })
        log(f"[1] {kname} at (B {b}, S {s}, H {h}, D {d}) bf16: kernel_ms "
            f"warm {kernel_ms:.4f} (again {kernel_ms_2:.4f}) cold "
            f"{kernel_cold:.4f}, wrapper-paced {paced_ms:.4f}; plain_ms "
            f"{plain_ms:.4f}; bound_ms {bound_ms:.4f} by {bound_by} "
            f"({n_bytes} B, {flops} FLOP); cold / bound "
            f"{kernel_cold / bound_ms:.1f}x")

    whole_backward_vs_sdpa(torch, fa, sets, "bf16")
    return entries


def time_f32_kernels(torch, wgmma):
    """The f32 kernels at the BERT shape: the forward, dq and dk/dv
    (wgmma, TF32 x3) and the delta pass, graph-timed warm and cold, their
    plain versions, and each bound both ways against the HBM bytes: f32
    FMAs on the CUDA cores (67 TFLOP/s) and TF32 x3 on the tensor cores
    (three products at 495 TFLOP/s; the delta pass runs on the CUDA
    cores, so its bound is the first). Then SDPA's f32 forward, the
    forward at the decode oracle's shapes beside SDPA's, and the whole
    f32 backward against SDPA's f32 backward. A kernel's design in the
    log is wgmma where the build compiled an f32 wgmma instance of it
    (``wgmma``, from ``report_build``). Returns the ``f32`` object of
    each kernel's entry in the kernels line."""
    fa = flash_module()
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, s, h, d = GLUE_BATCH, GLUE_SEQ, 12, 64
    sets = [backward_set(torch, fa, (b, s, h, d), torch.float32, gen)
            for _ in range(COLD_SETS)]

    def args(i):  # (q, k, v, dO, lse, delta) of input set i
        q_, k_, v_, _, lse_, g_, delta_ = sets[i]
        return q_, k_, v_, g_, lse_, delta_

    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads_first = [[x.transpose(1, 2) for x in st[:3]] for st in sets]
    lib_warm, lib_cold = warm_cold_ms(
        torch, lambda i: lambda: sdpa(*heads_first[i]))
    log(f"[1] SDPA forward f32 at (B {b}, S {s}, H {h}, D {d}): graph warm "
        f"{lib_warm:.4f} cold {lib_cold:.4f} ms")
    el, row, sq = b * s * h * d * 4, b * h * s * 4, b * h * s * s * d
    rows = {  # kernel on set i, plain on set 0, bytes, FLOPs
        "flash_fwd": (
            lambda i: lambda: fa.flash_attention_forward(*sets[i][:3]),
            lambda: fa.flash_attention_plain(*sets[0][:3]),
            4 * el + row, 4 * sq),
        "flash_bwd_delta": (
            lambda i: lambda: fa.flash_bwd_delta(sets[i][3], sets[i][5]),
            lambda: fa.flash_bwd_delta_plain(sets[0][3], sets[0][5]),
            2 * el + row, 2 * b * s * h * d),
        "flash_bwd_dq": (
            lambda i: lambda: fa.flash_bwd_dq(*args(i)),
            lambda: fa.flash_bwd_dq_plain(*args(0)), 5 * el + 2 * row,
            6 * sq),
        "flash_bwd_dkv": (
            lambda i: lambda: fa.flash_bwd_dkv(*args(i)),
            lambda: fa.flash_bwd_dkv_plain(*args(0)), 6 * el + 2 * row,
            8 * sq),
    }
    f32 = {}
    for name, (kernel, plain, n_bytes, flops) in rows.items():
        warm, cold = warm_cold_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, iters=10)
        fma_ms, fma_by = _bound(n_bytes, flops, "float32")
        tc_ms, tc_by = _bound(n_bytes, 3 * flops, "tf32")
        design = ("wgmma TF32 x3" if f"{name}_f32_kernel<{d}>" in wgmma
                  else "scalar")
        f32[name] = {"ms": warm, "ms_cold": cold, "plain_ms": plain_ms,
                     "bound_ms": fma_ms if name == "flash_bwd_delta"
                     else tc_ms,
                     "library_ms": lib_warm if name == "flash_fwd" else None}
        log(f"[1] {name} at (B {b}, S {s}, H {h}, D {d}) f32 ({design}): "
            f"kernel_ms warm {warm:.4f} cold {cold:.4f}; plain_ms "
            f"{plain_ms:.4f}; bound_ms TF32 x3 {tc_ms:.4f} by {tc_by} "
            f"(3 x {flops} FLOP at {PEAK_FLOPS['tf32'] / 1e12:.0f} TFLOP/s), "
            f"f32 FMA {fma_ms:.4f} by {fma_by} (at "
            f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s); {n_bytes} B; "
            f"cold / TF32 x3 bound {cold / tc_ms:.1f}x")

    # The decode oracle's launches: B 1, causal, one prompt bucket each;
    # the causal work counts the live half of the scores.
    for s_ in DECODE_ORACLE_SEQS:
        q, k, v = fused_qkv(torch, (1, s_, h, d), torch.float32, gen)
        ms = graph_ms(torch, [lambda: fa.flash_attention_forward(
            q, k, v, causal=True)])
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        lib = graph_ms(torch, [lambda: sdpa(qh, kh, vh, is_causal=True)])
        n_bytes = 4 * s_ * h * d * 4 + h * s_ * 4
        flops = 4 * h * d * s_ * (s_ + 1) // 2
        bound, by = _bound(n_bytes, 3 * flops, "tf32")
        log(f"[1] flash_fwd f32 at the decode oracle's (B 1, S {s_}, H {h}, "
            f"D {d}, causal; {(s_ + 63) // 64 * h} CTAs): graph warm "
            f"{ms:.4f} ms; SDPA f32 causal {lib:.4f} ms; bound_ms TF32 x3 "
            f"{bound:.5f} by {by}")
    whole_backward_vs_sdpa(torch, fa, sets, "f32")
    return f32


def phase_glue(torch, P):
    flash_attention = P.flash_attention
    gen = torch.Generator().manual_seed(0)
    model = P.SequenceClassifier(
        P.bert_base(attention_impl="flash", dtype=torch.bfloat16),
        device="cuda", generator=gen,
    ).eval()
    dense = P.SequenceClassifier(
        P.bert_base(attention_impl="dense", dtype=torch.bfloat16),
        device="cuda",
    ).eval()
    dense.load_state_dict(model.state_dict())
    dense32 = P.SequenceClassifier(
        P.bert_base(attention_impl="dense", dtype=torch.float32),
        device="cuda",
    ).eval()
    dense32.load_state_dict(model.state_dict())
    ids_gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 30522, (GLUE_BATCH, GLUE_SEQ), generator=ids_gen)
    seg = torch.zeros_like(ids)
    seg[:, GLUE_SEQ // 2:] = 1
    ids, seg = ids.cuda(), seg.cuda()

    with torch.inference_mode():
        model(ids, seg)  # warm-up (cuBLAS handles, kernel library load)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        logits = model(ids, seg)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        want = dense(ids, seg)
        want32 = dense32(ids, seg)
        fwd_ms = time_ms(torch, lambda: model(ids, seg), iters=10)
        dense_ms = time_ms(torch, lambda: dense(ids, seg), iters=10)
    err = (logits - want).abs().max().item()
    err32 = (logits - want32).abs().max().item()
    log(f"[2] bert_base GLUE forward bf16 flash: logits {tuple(logits.shape)}"
        f", flash launches {launches}, max |flash - dense bf16| {err:.3e}, "
        f"max |flash - dense f32| {err32:.3e} (tol {LOGIT_TOL})")
    log(f"[2] forward ms: flash {fwd_ms:.3f}, dense {dense_ms:.3f} "
        f"({GLUE_BATCH / fwd_ms * 1e3:.1f} sequences/s with flash)")
    RATES["glue_forward_seq_per_s"] = GLUE_BATCH / fwd_ms * 1e3
    check(logits.shape == (GLUE_BATCH, 2), "logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(launches == 12, f"expected 12 flash launches, saw {launches}")
    check(torch.allclose(logits, want, **LOGIT_TOL),
          "flash logits disagree with dense bf16")
    check(torch.allclose(logits, want32, **LOGIT_TOL),
          "flash logits disagree with dense f32")
    with torch.inference_mode():
        device_profile(torch, "bert_base GLUE forward (flash)",
                       lambda: model(ids, seg))
    del model, dense, dense32
    torch.cuda.empty_cache()
    return launches


def _top2_gap(torch, engine, context):
    with torch.inference_mode():
        logits = engine.model(engine._padded(context))[0, len(context) - 1]
    top = torch.topk(logits.float(), 2).values
    return (top[0] - top[1]).item()


def check_decode_graphs(torch, engine, gen):
    """Each captured step graph (one per kv bucket) and prefill graph (one
    per prompt bucket), replayed at a cache state, against the eager
    ``decode_step`` or ``prefill`` at the same state: the same tokens.
    The cache is put back after each."""
    model, cache = engine.model, engine._cache
    snapshot = [(k.clone(), v.clone()) for k, v in cache]
    vocab, slots = model.cfg.vocab_size, engine.num_slots

    def restore():
        for (k, v), (k0, v0) in zip(cache, snapshot):
            k.copy_(k0)
            v.copy_(v0)

    for kv_len in sorted(engine.step_graphs):
        tokens = torch.randint(1, vocab, (slots,), generator=gen).tolist()
        lens = [max(0, kv_len - 1 - j % 5) for j in range(slots)]
        got = engine.step(tokens, lens, kv_len)
        restore()
        with torch.inference_mode():
            want = model.decode_step(
                torch.tensor(tokens, device="cuda")[:, None],
                torch.tensor(lens, device="cuda"), kv_len,
                cache).argmax(-1).tolist()
        restore()
        check(got == want, f"step graph for kv bucket {kv_len} gave {got}, "
                           f"eager decode_step {want}")
    for bucket in sorted(engine.prefill_graphs):
        n = max(1, bucket - 3)
        prompt = torch.randint(1, vocab, (n,), generator=gen).tolist()
        got = engine.prefill(1, prompt)
        restore()
        with torch.inference_mode():
            want = int(model.prefill(
                engine._padded(prompt),
                torch.tensor([n], device="cuda"), cache,
                slots=torch.tensor([1], device="cuda")).argmax(-1)[0])
        restore()
        check(got == want, f"prefill graph for bucket {bucket} gave {got}, "
                           f"eager prefill {want}")
    log(f"[3] captured graphs replayed at a cache state match eager: step "
        f"kv buckets {sorted(engine.step_graphs)}, prefill buckets "
        f"{sorted(engine.prefill_graphs)}")


def phase_decode(torch, P):
    from raydp_tpu_torch.serve.decode import (
        DecodeConfig,
        DecodeLoop,
        bucket_for,
    )

    flash_attention = P.flash_attention
    P.set_exact_float32()
    engine = P.build_transformer_engine(
        num_slots=8, page_tokens=16, seed=0, device="cuda",
        causal=True, dtype=torch.float32, attention_impl="flash",
        vocab_size=30522, max_len=512, d_model=768, n_heads=12,
        n_layers=12, d_ff=3072,
    )
    config = DecodeConfig(slots=8, page_tokens=16,
                          max_new=DECODE_MAX_NEW, round_linger_s=0.0)
    # The kv buckets the loop steps in, beside the graphs it captures.
    kv_used = set()
    graphed_step = engine.step

    def step(last, lens, kv_len):
        kv_used.add(kv_len)
        return graphed_step(last, lens, kv_len)

    engine.step = step
    # Warm-up on a short request, twice: cuBLAS handles, the first
    # launches, and the graphs of the smallest buckets (each captured at
    # its second use).
    for _ in range(2):
        warm = DecodeLoop(engine, config)
        warm.submit("warm", [1, 2, 3], max_new=2)
        warm.run_until_idle()
    engine.reference_decode([1, 2, 3], 2)
    torch.cuda.synchronize()

    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, 30522, (n,), generator=gen).tolist()
               for n in DECODE_PROMPT_LENS]

    def run_loop(tag):
        """The 8 requests through one loop: (streams, seconds, rounds,
        first-token latencies in s)."""
        first_token_s = {}
        t_start = time.perf_counter()

        def on_token(rid, index, token):
            if index == 0:
                first_token_s[rid] = time.perf_counter() - t_start

        loop = DecodeLoop(engine, config, on_token=on_token)
        for i, p in enumerate(prompts):
            loop.submit(f"r{i}", p, max_new=DECODE_MAX_NEW)
        rounds = loop.run_until_idle()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t_start
        streams = [loop.sequence_info(f"r{i}")["tokens"]
                   for i in range(len(prompts))]
        n_tokens = sum(len(s) for s in streams)
        ttft = sorted(first_token_s.values())
        log(f"[3] decode server {tag} (bert_base width, f32, 8 slots, "
            f"CUDA graphs): {n_tokens} tokens in {rounds} rounds, "
            f"{loop_s:.3f} s -> {n_tokens / loop_s:.1f} tokens/s; first-token "
            f"latency mean {sum(ttft) / len(ttft) * 1e3:.2f} ms, max "
            f"{ttft[-1] * 1e3:.2f} ms; graphs captured so far "
            f"{engine.graph_count}")
        return streams

    flash_attention.launches = 0
    streams = run_loop("first run, capturing")
    t_ref = time.perf_counter()
    refs = [engine.reference_decode(p, DECODE_MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t_ref
    launches = flash_attention.launches

    log(f"[3] reference_decode (full flash forward per token): "
        f"{sum(len(r) for r in refs)} tokens in {ref_s:.3f} s -> "
        f"{sum(len(r) for r in refs) / ref_s:.1f} tokens/s; flash launches "
        f"{launches}")
    mismatches = 0
    for p, got, want in zip(prompts, streams, refs):
        if got == want:
            continue
        mismatches += 1
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        gap = _top2_gap(torch, engine, p + want[:i])
        log(f"[3] MISMATCH prompt len {len(p)} at token {i}: loop "
            f"{got[i:i + 3]} reference {want[i:i + 3]}; reference top-2 "
            f"logit gap there {gap:.3e} (a gap above 1e-4 is a bug)")
    check(mismatches == 0, f"{mismatches} decode streams differ from "
                           "reference_decode")
    check(all(len(s) == DECODE_MAX_NEW for s in streams), "stream lengths")
    check(launches > 0, "reference_decode launched no flash kernel")
    # A bucket first used once in the first run is captured in this one.
    second = run_loop("second run, capturing the rest")
    check(second == streams, "the second run's streams differ from the "
                             "first's")
    prefill_used = {bucket_for(engine.prompt_buckets, n)
                    for n in [3] + DECODE_PROMPT_LENS}
    log(f"[3] graphs: {len(engine.step_graphs)} step (kv buckets used "
        f"{sorted(kv_used)}), {len(engine.prefill_graphs)} prefill (prompt "
        f"buckets used {sorted(prefill_used)}), {engine.graph_count} "
        f"captured")
    check(set(engine.step_graphs) == kv_used,
          "not one step graph per kv bucket used")
    check(set(engine.prefill_graphs) == prefill_used,
          "not one prefill graph per prompt bucket used")
    check(engine.graph_count == len(kv_used) + len(prefill_used),
          "a graph used twice is not captured")

    again = run_loop("steady rerun, all graphs captured")
    check(again == streams, "the rerun's streams differ from the first run's")
    device_profile(torch, "decode loop, same 8 requests (CUDA graphs)",
                   lambda: run_loop("profiled rerun"))
    engine.step = graphed_step
    check_decode_graphs(torch, engine, gen)
    return launches


def _counts():
    fa = flash_module()

    return {"flash_fwd": fa.flash_attention.launches,
            "flash_bwd_delta": fa.flash_bwd_delta.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _reset_counts():
    fa = flash_module()

    for fn in (fa.flash_attention, fa.flash_bwd_delta, fa.flash_bwd_dq,
               fa.flash_bwd_dkv):
        fn.launches = 0


def glue_columns(np, n, seq, vocab, seed):
    """Learnable stand-in for a tokenized GLUE task (as
    examples/bert_glue.py): the label is whether marker token 7 appears."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(n, seq)).astype(np.int32)
    pos = rng.random(n) < 0.5
    ids[pos, rng.integers(0, seq, pos.sum())] = 7
    cols = {f"t{i}": ids[:, i] for i in range(seq)}
    cols["label"] = pos.astype(np.int32)
    return ids, cols


def phase_grad_check(torch, P):
    """4a: one batch's parameter gradients, flash bf16 against dense bf16
    and dense f32 with the same weights."""
    import torch.nn.functional as F

    grads = {}
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(10, 30522, (GLUE_BATCH, GLUE_SEQ), generator=gen)
    labels = torch.randint(0, 2, (GLUE_BATCH,), generator=gen)
    ids, labels = ids.cuda(), labels.cuda()
    state = None
    for impl, dtype in (("flash", torch.bfloat16), ("dense", torch.bfloat16),
                        ("dense", torch.float32)):
        model = P.SequenceClassifier(
            P.bert_base(attention_impl=impl, dtype=dtype, dropout_rate=0.0),
            device="cuda", generator=torch.Generator().manual_seed(4))
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        F.cross_entropy(model(ids), labels).backward()
        grads[(impl, dtype)] = {n: p.grad.float() for n, p in
                                model.named_parameters() if p.grad is not None}
        del model
    torch.cuda.empty_cache()
    flash = grads[("flash", torch.bfloat16)]
    for ref_key in (("dense", torch.bfloat16), ("dense", torch.float32)):
        ref = grads[ref_key]
        check(flash.keys() == ref.keys(), "gradient sets differ")
        errs = {n: ((flash[n] - ref[n]).norm()
                    / ref[n].norm().clamp_min(1e-30)).item() for n in ref}
        worst = max(errs, key=errs.get)
        finite = all(bool(torch.isfinite(g).all()) for g in flash.values())
        log(f"[4a] flash bf16 vs {ref_key[0]} {str(ref_key[1])[6:]} "
            f"gradients: {len(errs)} parameters, median rel L2 "
            f"{sorted(errs.values())[len(errs) // 2]:.3e}, worst "
            f"{errs[worst]:.3e} ({worst}); bound {GRAD_REL_BOUND}")
        check(finite, "non-finite flash gradients")
        check(errs[worst] < GRAD_REL_BOUND,
              f"flash gradient {worst} off by {errs[worst]:.3e} against "
              f"{ref_key}")


def _fit_modes(torch, P, np, tag, make_estimator, cols, epochs, steps,
               modes=("stream", "scan"), per_step=None):
    """Fit one estimator per epoch mode (stream then scan) from the same
    weights and seeds, counting launches and the peak memory around each
    fit; ``per_step`` is each kernel's expected launches a step (12 of
    each by default). Returns ``{mode: (estimator, history, counts)}``."""
    per_step = per_step or {k: 12 for k in KERNEL_SYMBOLS}
    out = {}
    for mode in modes:
        est = make_estimator(mode)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        history = est.fit(P.MLDataset([cols], num_shards=1))
        torch.cuda.synchronize()
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        PEAK_BYTES[(tag, mode)] = (peak, held)
        losses = [h["train_loss"] for h in history]
        for h in history:
            log(f"[{tag}] {mode} epoch {h['epoch']}: train_loss "
                f"{h['train_loss']:.4f}, {h['samples']} samples in "
                f"{h['time_s']:.3f} s -> {h['samples_per_sec']:.1f} "
                f"samples/s, {h['time_s'] / steps * 1e3:.2f} ms/step")
        log(f"[{tag}] {mode}: launches over {epochs * steps} steps: {counts}; "
            f"peak memory allocated {peak / 2**30:.3f} GiB, "
            f"{(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} "
            f"GiB held before the fit")
        check(est.effective_epoch_mode == mode,
              f"{tag}: asked for {mode}, ran {est.effective_epoch_mode}")
        check(all(np.isfinite(losses)), f"{tag} {mode}: non-finite losses "
                                        f"{losses}")
        want = {k: n * epochs * steps for k, n in per_step.items()}
        check(counts == want, f"{tag} {mode}: expected launches {want}, saw "
                              f"{counts}")
        out[mode] = (est, history, counts)
    if len(out) == 2:
        stream = [h["train_loss"] for h in out["stream"][1]]
        scan = [h["train_loss"] for h in out["scan"][1]]
        diff = max(abs(a - b) for a, b in zip(scan, stream))
        log(f"[{tag}] scan against stream losses: max |difference| "
            f"{diff:.3e} (tolerance {FIT_TOL}); bit-identical: "
            f"{scan == stream}")
        check(np.allclose(scan, stream, **FIT_TOL),
              f"{tag}: scan losses {scan} disagree with stream {stream}")
    return out


def graph_step_report(torch, tag, est, x, y, per_step):
    """``est``'s train step captured as a CUDA graph: its time by CUDA
    events over 10 replays, then a torch.profiler trace of 5 replays
    (device busy, idle share, top kernels), whose flash kernels must
    equal the launch counters and ``per_step`` of each a step. Returns
    the step's ms."""
    est.get_model().train()
    graphed = est._captured_train_step()
    while not graphed.captured:
        graphed(x, y)
    ms = time_ms(torch, lambda: graphed(x, y), iters=10)
    log(f"[{tag}] one scan train step (graph replay, CUDA events, 10 steps): "
        f"{ms:.3f} ms -> {len(x) / ms * 1e3:.1f} samples/s")
    _reset_counts()
    seen = device_profile(torch, f"{tag}, 5 scan steps (graph replays)",
                          lambda: [graphed(x, y) for _ in range(5)], top=8)
    counted = _counts()
    # The counters add each replay's launches as recorded at capture;
    # hold them against the kernels the trace saw the replays run.
    traced = {k: sum(n for name, n in (seen or {}).items() if sym in name)
              for k, sym in KERNEL_SYMBOLS.items()}
    want = {k: per_step[k] * 5 for k in KERNEL_SYMBOLS}
    log(f"[{tag}] 5 replays: flash kernels in the trace {traced}, launch "
        f"counters {counted}")
    check(traced == counted == want, f"{tag}, 5 replays: expected {want}, "
                                     f"traced {traced}, counted {counted}")
    return ms


def _glue_estimator(torch, P, np, cfg, mode, epochs):
    """The fine-tune estimator of phases 4b and 4d: bert_base-width
    classifier from generator seed 7, AdamW, softmax_ce, batch 32 x seq
    128, unshuffled."""
    return P.Estimator(
        model=P.SequenceClassifier(
            cfg, device="cuda", generator=torch.Generator().manual_seed(7)),
        optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4, weight_decay=1e-2),
        loss="softmax_ce", metrics=["categorical_accuracy"],
        num_epochs=epochs, batch_size=GLUE_BATCH,
        feature_columns=[f"t{i}" for i in range(GLUE_SEQ)],
        label_column="label", feature_dtype=np.int32, label_dtype=np.int32,
        seed=0, shuffle=False, epoch_mode=mode, device="cuda")


def phase_finetune(torch, P):
    """4b: Estimator.fit of the bf16 flash classifier at bert_base, on
    the stream path and on the scan path (a CUDA graph of the step).
    Returns the launch counts and the scan fit's losses."""
    import numpy as np

    n_rows = GLUE_BATCH * FIT_STEPS
    ids, cols = glue_columns(np, n_rows, GLUE_SEQ, 30522, seed=5)
    _, eval_cols = glue_columns(np, 2 * GLUE_BATCH, GLUE_SEQ, 30522, seed=6)
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      dropout_rate=0.1, max_len=GLUE_SEQ)
    fits = _fit_modes(
        torch, P, np, "4b",
        lambda mode: _glue_estimator(torch, P, np, cfg, mode, FIT_EPOCHS),
        cols, FIT_EPOCHS, FIT_STEPS)
    for mode, (est, history, _) in fits.items():
        losses = [h["train_loss"] for h in history]
        later = history[1:]  # epoch 0 of scan holds warm-up and capture
        ms = sum(h["time_s"] for h in later) / (len(later) * FIT_STEPS) * 1e3
        log(f"[4b] {mode}: epochs 1-{FIT_EPOCHS - 1} {ms:.2f} ms/step, "
            f"{GLUE_BATCH / ms * 1e3:.1f} samples/s (host clock)")
        check(losses[-1] < losses[0], f"{mode}: train loss did not fall: "
                                      f"{losses}")
    est = fits["scan"][0]
    evals = est.evaluate(P.MLDataset([eval_cols], num_shards=1))
    preds = est.predict(ids[:GLUE_BATCH + 5])
    log(f"[4b] evaluate: {evals}; predict {preds.shape}")
    check(np.isfinite(evals["loss"]), "non-finite eval loss")
    check(preds.shape == (GLUE_BATCH + 5, 2) and np.isfinite(preds).all(),
          "predict output")

    x = torch.from_numpy(ids[:GLUE_BATCH]).cuda()
    y = torch.from_numpy(cols["label"][:GLUE_BATCH]).cuda()
    eager = fits["stream"][0]
    eager.get_model().train()
    stream_ms = time_ms(torch, lambda: eager._train_step(x, y), iters=10)
    RATES["4b_stream_ms"] = stream_ms
    log(f"[4b] one stream train step (CUDA events, 10 steps): "
        f"{stream_ms:.3f} ms -> {GLUE_BATCH / stream_ms * 1e3:.1f} samples/s")
    device_profile(torch, "bert_base fine-tune, one stream train step",
                   lambda: eager._train_step(x, y), top=8)
    RATES["4b_scan_ms"] = graph_step_report(torch, "4b", est, x, y,
                                            {k: 12 for k in KERNEL_SYMBOLS})
    counts = [c for _, _, c in fits.values()]
    scan_losses = [h["train_loss"] for h in fits["scan"][1]]
    del fits, est, eager
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts) for k in counts[0]}, scan_losses


def phase_causal_lm(torch, P):
    """4c: a short self-supervised lm_ce fit of a bert_base-width
    CausalLM, which runs the causal flash backward, on both paths."""
    import numpy as np

    rng = np.random.default_rng(8)
    ids = rng.integers(0, 30522, size=(LM_BATCH * LM_STEPS, LM_SEQ))
    cols = {f"t{i}": ids[:, i].astype(np.int32) for i in range(LM_SEQ)}
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      causal=True, dropout_rate=0.1, max_len=LM_SEQ)

    def make_estimator(mode):
        return P.Estimator(
            model=P.CausalLM(cfg, device="cuda"),
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4),
            loss="lm_ce", num_epochs=LM_EPOCHS, batch_size=LM_BATCH,
            feature_columns=[f"t{i}" for i in range(LM_SEQ)],
            self_supervised=True, feature_dtype=np.int32, shuffle=False,
            epoch_mode=mode, device="cuda")

    fits = _fit_modes(torch, P, np, "4c", make_estimator, cols, LM_EPOCHS,
                      LM_STEPS)
    for mode, (_, history, _) in fits.items():
        # The last epoch is eager steps (stream) or replays only (scan).
        last = history[-1]
        log(f"[4c] CausalLM bert_base width, {mode}, batch {LM_BATCH} x seq "
            f"{LM_SEQ}: losses {[h['train_loss'] for h in history]}, last "
            f"epoch {last['samples_per_sec']:.1f} samples/s, "
            f"{last['time_s'] / LM_STEPS * 1e3:.2f} ms/step")
    counts = [c for _, _, c in fits.values()]
    del fits
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_remat(torch, P, scan_losses):
    """4d: the 4b fine-tune with ``remat=True`` on the scan path, from
    4b's weights and seeds: each step recomputes every block's forward
    in the backward (24 forward launches, 12 of each backward kernel),
    the losses stay within FIT_TOL of 4b's scan losses, and the peak
    memory is held beside 4b's."""
    import numpy as np

    ids, cols = glue_columns(np, GLUE_BATCH * FIT_STEPS, GLUE_SEQ, 30522,
                             seed=5)
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      dropout_rate=0.1, max_len=GLUE_SEQ, remat=True)
    per_step = {k: 12 for k in KERNEL_SYMBOLS}
    per_step["flash_fwd"] = 24
    fits = _fit_modes(
        torch, P, np, "4d",
        lambda mode: _glue_estimator(torch, P, np, cfg, mode, FIT_EPOCHS),
        cols, FIT_EPOCHS, FIT_STEPS, modes=("scan",), per_step=per_step)
    est, history, counts = fits["scan"]
    losses = [h["train_loss"] for h in history]
    diff = max(abs(a - b) for a, b in zip(losses, scan_losses))
    log(f"[4d] remat scan losses {losses} against 4b's scan {scan_losses}: "
        f"max |difference| {diff:.3e} (tolerance {FIT_TOL})")
    check(np.allclose(losses, scan_losses, **FIT_TOL),
          "remat losses disagree with 4b's scan losses")
    later = history[1:]
    ms = sum(h["time_s"] for h in later) / (len(later) * FIT_STEPS) * 1e3
    log(f"[4d] scan epochs 1-{FIT_EPOCHS - 1}: {ms:.2f} ms/step, "
        f"{GLUE_BATCH / ms * 1e3:.1f} samples/s (host clock)")
    x = torch.from_numpy(ids[:GLUE_BATCH]).cuda()
    y = torch.from_numpy(cols["label"][:GLUE_BATCH]).cuda()
    graph_step_report(torch, "4d", est, x, y, per_step)
    (peak, held), (peak_b, held_b) = PEAK_BYTES[("4d", "scan")], \
        PEAK_BYTES[("4b", "scan")]
    log(f"[4d] fit's peak above what it held before: remat "
        f"{(peak - held) / 2**30:.3f} GiB, 4b scan (no remat) "
        f"{(peak_b - held_b) / 2**30:.3f} GiB")
    del fits, est
    torch.cuda.empty_cache()
    return counts


def criteo_columns(np, cfg, n, seed):
    """Criteo-shaped rows, drawn as examples/dlrm_criteo.py draws them:
    gamma dense features; Pareto-skewed ids (heavy heads, long tails)
    folded into each table's vocabulary, as float columns (PackedDLRM's
    form); a label from a logistic of I0, I1 and C0's parity."""
    rng = np.random.default_rng(seed)
    cols = {f"I{i}": rng.gamma(1.5, 2.0, n).astype(np.float32)
            for i in range(cfg.dense_features)}
    for t, vocab in enumerate(cfg.vocab_sizes):
        ids = (rng.pareto(1.2, n) * 17).astype(np.int64) % vocab
        cols[f"C{t}"] = ids.astype(np.float32)
    logit = -1.2 + 0.35 * cols["I0"] - 0.2 * cols["I1"] + 0.3 * (
        cols["C0"] % 2)
    cols["label"] = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(
        np.float32)
    return cols


def embedding_impls(torch, P, ids):
    """One criteo table (100k x 128, bf16 lookups) by ``onehot`` against
    ``take`` on the card: the same rows, and each lookup's time."""
    from raydp_tpu_torch.models.dlrm import ShardedEmbedding

    take = ShardedEmbedding(100_000, 128, impl="take").cuda()
    onehot = ShardedEmbedding(100_000, 128, impl="onehot").cuda()
    onehot.load_state_dict(take.state_dict())
    with torch.no_grad():
        got, want = onehot(ids), take(ids)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        take_ms = time_ms(torch, lambda: take(ids), iters=20)
        onehot_ms = time_ms(torch, lambda: onehot(ids), iters=20)
    log(f"[5] one table (100000 x 128) at batch {len(ids)}: onehot against "
        f"take max |difference| {err:.3e} (tol {TOL['bfloat16']}); forward "
        f"take {take_ms:.4f} ms, onehot {onehot_ms:.4f} ms")
    check(torch.allclose(got.float(), want.float(), **TOL["bfloat16"]),
          "onehot lookup disagrees with take")


def phase_dlrm(torch, P):
    """5: PackedDLRM at criteo_dlrm's full width through Estimator, bce,
    AdamW, batch 1024, on both epoch paths from the same weights."""
    import numpy as np

    cfg = P.criteo_dlrm()
    cols = criteo_columns(np, cfg, DLRM_BATCH * DLRM_STEPS, seed=11)
    names = [f"I{i}" for i in range(cfg.dense_features)] + [
        f"C{t}" for t in range(cfg.n_tables)]

    def make_estimator(mode):
        return P.Estimator(
            model=P.PackedDLRM(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(12)),
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3,
                                                  weight_decay=1e-2),
            loss="bce", metrics=["accuracy"], num_epochs=DLRM_EPOCHS,
            batch_size=DLRM_BATCH, feature_columns=names,
            label_column="label", seed=0, shuffle=False, epoch_mode=mode,
            device="cuda")

    no_flash = {k: 0 for k in KERNEL_SYMBOLS}
    fits = _fit_modes(torch, P, np, "5", make_estimator, cols, DLRM_EPOCHS,
                      DLRM_STEPS, per_step=no_flash)
    est = fits["scan"][0]
    n_params = sum(p.numel() for p in est.get_model().parameters())
    log(f"[5] criteo_dlrm: {n_params} parameters, {cfg.n_tables} tables "
        f"of {cfg.vocab_sizes[0]} x {cfg.embed_dim}, lookups "
        f"{cfg.impl_for(cfg.vocab_sizes[0])}")
    for mode, (_, history, _) in fits.items():
        losses = [h["train_loss"] for h in history]
        later = history[1:]
        ms = sum(h["time_s"] for h in later) / (len(later) * DLRM_STEPS) * 1e3
        log(f"[5] {mode}: epochs 1-{DLRM_EPOCHS - 1} {ms:.2f} ms/step, "
            f"{DLRM_BATCH / ms * 1e3:.1f} samples/s (host clock)")
        check(losses[-1] < losses[0], f"5 {mode}: train loss did not fall: "
                                      f"{losses}")
    x = torch.from_numpy(np.stack([cols[c] for c in names], axis=1)[
        :DLRM_BATCH]).cuda()
    y = torch.from_numpy(cols["label"][:DLRM_BATCH]).cuda()
    eager = fits["stream"][0]
    eager.get_model().train()
    stream_ms = time_ms(torch, lambda: eager._train_step(x, y), iters=10)
    log(f"[5] one stream train step (CUDA events, 10 steps): "
        f"{stream_ms:.3f} ms -> {DLRM_BATCH / stream_ms * 1e3:.1f} samples/s")
    device_profile(torch, "criteo_dlrm, one stream train step",
                   lambda: eager._train_step(x, y), top=8)
    graph_step_report(torch, "5", est, x, y, no_flash)
    embedding_impls(torch, P, x[:, cfg.dense_features].long())
    del fits, est, eager
    torch.cuda.empty_cache()


def phase_moe(torch, P):
    """6: MoEClassifier over bert_base with the flash trunk (8 experts of
    d_ff 3072, top-2, capacity factor 1.25), aux_losses=True, AdamW,
    softmax_ce, batch 32 x seq 128, dropout 0.1, on both epoch paths from
    the same weights: 12 launches of each bf16 flash kernel a step."""
    import numpy as np

    from raydp_tpu_torch.models.moe import MoELayer

    ids, cols = glue_columns(np, GLUE_BATCH * MOE_STEPS, GLUE_SEQ, 30522,
                             seed=5)
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      dropout_rate=0.1, max_len=GLUE_SEQ)
    moe = P.MoEConfig()

    def make_estimator(mode):
        return P.Estimator(
            model=P.MoEClassifier(cfg, moe, 2, device="cuda",
                                  generator=torch.Generator().manual_seed(13)),
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4,
                                                  weight_decay=1e-2),
            loss="softmax_ce", metrics=["categorical_accuracy"],
            num_epochs=MOE_EPOCHS, batch_size=GLUE_BATCH,
            feature_columns=[f"t{i}" for i in range(GLUE_SEQ)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, seed=0, shuffle=False, epoch_mode=mode,
            aux_losses=True, device="cuda")

    fits = _fit_modes(torch, P, np, "6", make_estimator, cols, MOE_EPOCHS,
                      MOE_STEPS)
    tokens = GLUE_BATCH * GLUE_SEQ
    for mode, (est, history, _) in fits.items():
        model = est.get_model()
        layers = [m for m in model.modules() if isinstance(m, MoELayer)]
        aux = float(P.moe_aux_loss(model).detach())
        kept = sum(float(m.kept_slots) for m in layers)
        slots = tokens * moe.top_k * len(layers)
        losses = [h["train_loss"] for h in history]
        later = history[1:]
        ms = sum(h["time_s"] for h in later) / (len(later) * MOE_STEPS) * 1e3
        log(f"[6] {mode}: epochs 1-{MOE_EPOCHS - 1} {ms:.2f} ms/step, "
            f"{GLUE_BATCH / ms * 1e3:.1f} samples/s (host clock); last "
            f"step's aux term {aux:.5f} (weight {moe.aux_loss_weight}); "
            f"token-slots dropped for capacity {1 - kept / slots:.4f} "
            f"({slots - kept:.0f} of {slots}; capacity "
            f"{moe.capacity(tokens)} a expert a layer)")
        check(np.isfinite(aux), f"6 {mode}: non-finite aux loss {aux}")
        check(losses[-1] < losses[0], f"6 {mode}: train loss did not fall: "
                                      f"{losses}")
    est = fits["scan"][0]
    n_params = sum(p.numel() for p in est.get_model().parameters())
    log(f"[6] MoEClassifier: {n_params} parameters")
    x = torch.from_numpy(ids[:GLUE_BATCH]).cuda()
    y = torch.from_numpy(cols["label"][:GLUE_BATCH]).cuda()
    eager = fits["stream"][0]
    eager.get_model().train()
    stream_ms = time_ms(torch, lambda: eager._train_step(x, y), iters=10)
    log(f"[6] one stream train step (CUDA events, 10 steps): "
        f"{stream_ms:.3f} ms -> {GLUE_BATCH / stream_ms * 1e3:.1f} samples/s")
    device_profile(torch, "MoE classifier, one stream train step",
                   lambda: eager._train_step(x, y), top=8)
    graph_step_report(torch, "6", est, x, y, {k: 12 for k in KERNEL_SYMBOLS})
    counts = [c for _, _, c in fits.values()]
    del fits, est, eager
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def taxi_columns(np, n_rows, seed=0):
    """examples/data_process.py's ``synthetic_taxi`` rows (the same draws
    in the same order) through its ``nyc_taxi_preprocess`` (rows with a
    passenger; hour, Spark's day of week, haversine distance), in numpy."""
    rng = np.random.default_rng(seed)
    secs = rng.integers(0, 365 * 24 * 3600, n_rows)  # from 2020-01-01 00:00
    trip_min = rng.gamma(2.0, 7.0, n_rows)
    plon = -73.98 + 0.1 * rng.standard_normal(n_rows)
    plat = 40.75 + 0.1 * rng.standard_normal(n_rows)
    dlon = -73.97 + 0.1 * rng.standard_normal(n_rows)
    dlat = 40.76 + 0.1 * rng.standard_normal(n_rows)
    dist = np.hypot((dlon - plon) * 84.3, (dlat - plat) * 111.1)
    passengers = rng.integers(0, 7, n_rows)
    fare = np.maximum(2.5, 2.5 + 1.6 * dist + 0.3 * trip_min
                      + rng.standard_normal(n_rows))
    rad = np.pi / 180.0
    a = (np.sin((dlat - plat) * rad / 2) ** 2 + np.cos(plat * rad)
         * np.cos(dlat * rad) * np.sin((dlon - plon) * rad / 2) ** 2)
    days = 18262 + secs // 86400  # 2020-01-01 is day 18262 of the epoch
    keep = (fare > 0) & (passengers > 0)
    cols = {"hour": (secs // 3600) % 24,
            "day_of_week": (days + 4) % 7 + 1,  # Sunday 1 .. Saturday 7
            "distance_km": 6371.0 * 2 * np.arcsin(np.sqrt(a)),
            "passenger_count": passengers, "fare_amount": fare}
    return {k: v[keep].astype(np.float32) for k, v in cols.items()}


def _split(np, cols, share=0.9, seed=42):
    """(train, test) row split, the examples' ``random_split([0.9, 0.1])``
    in numpy."""
    train = np.random.default_rng(seed).random(len(cols["fare_amount"])) \
        < share
    return ({k: v[train] for k, v in cols.items()},
            {k: v[~train] for k, v in cols.items()})


def _gbt_fit(torch, P, gbt_mod, device, train_ds, test_ds, label, loss):
    """One GBTEstimator fit at examples/gbt_nyctaxi.py's settings on
    ``device``; on the card each level's histogram and split search are
    timed (synchronised). Returns (estimator, history, seconds,
    histogram seconds)."""
    est = P.GBTEstimator(n_trees=GBT_TREES, max_depth=5, max_bins=64,
                         loss=loss, feature_columns=TAXI_FEATURES,
                         label_column=label, device=device)
    spent = [0.0]
    hist_fn, split_fn = gbt_mod._level_histograms, gbt_mod._best_splits

    def timed(fn):
        def run(*args):
            if device == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            if device == "cuda":
                torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            return out
        return run

    gbt_mod._level_histograms = timed(hist_fn)
    gbt_mod._best_splits = timed(split_fn)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        history = est.fit(train_ds, evaluate_ds=test_ds)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        gbt_mod._level_histograms, gbt_mod._best_splits = hist_fn, split_fn
    if device == "cuda":
        log(f"[7] GBT {loss} card fit: peak memory allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return est, history, seconds, spent[0]


def phase_gbt(torch, P, train, test):
    """7: GBTEstimator at examples/gbt_nyctaxi.py's settings (60 trees,
    depth 5, 64 bins) on the taxi rows, squared loss on the fare, then
    logistic on a thresholded fare; each on the card and on the CPU in
    this run, histories and predictions held together, split nodes that
    differ counted; save on the card, restore, predict the same."""
    import importlib

    import numpy as np

    gbt_mod = importlib.import_module("raydp_tpu_torch.train.gbt")
    threshold = float(np.median(train["fare_amount"]))
    x_test = np.stack([test[c] for c in TAXI_FEATURES], axis=1)
    for loss, label in (("squared", "fare_amount"), ("logistic", "high_fare")):
        tr, te = dict(train), dict(test)
        tr["high_fare"] = (tr["fare_amount"] > threshold).astype(np.float32)
        te["high_fare"] = (te["fare_amount"] > threshold).astype(np.float32)
        half = len(tr[label]) // 2
        blocks = [{k: v[:half] for k, v in tr.items()},
                  {k: v[half:] for k, v in tr.items()}]
        fits = {dev: _gbt_fit(torch, P, gbt_mod, dev,
                              P.MLDataset(blocks, num_shards=2),
                              P.MLDataset([te], num_shards=1), label, loss)
                for dev in ("cuda", "cpu")}
        (card, h_card, s_card, hist_card), (cpu, h_cpu, s_cpu, hist_cpu) = \
            fits["cuda"], fits["cpu"]
        parted_nodes = ((card._trees["feature"] != cpu._trees["feature"])
                        | (card._trees["bin"] != cpu._trees["bin"]))
        differ = int(parted_nodes.sum())
        parted = np.flatnonzero(parted_nodes.any(axis=1))
        first = int(parted[0]) if len(parted) else None
        n_split = int((cpu._trees["feature"] >= 0).sum())
        keys = ("train_loss", "eval_loss")

        def rel(a, b):
            return abs(a - b) / max(abs(b), 1e-12)

        worst = [max(rel(h_card[t][k], h_cpu[t][k]) for k in keys)
                 for t in range(len(h_cpu))]
        p_card, p_cpu = card.predict(x_test), cpu.predict(x_test)
        p_err = float(np.max(np.abs(p_card - p_cpu)
                             / np.maximum(np.abs(p_cpu), 1e-12)))
        rounds = len(h_card)
        log(f"[7] GBT {loss} ({len(tr[label])} train rows, {len(te[label])} "
            f"eval rows, {rounds} trees): train_loss "
            f"{h_card[0]['train_loss']:.4f} -> {h_card[-1]['train_loss']:.4f},"
            f" eval_loss {h_card[-1]['eval_loss']:.4f}; "
            f"{card.evaluate(P.MLDataset([te], num_shards=1))}")
        log(f"[7] GBT {loss}: card {s_card / rounds * 1e3:.2f} ms a round "
            f"(histogram and split search {hist_card / rounds * 1e3:.2f} ms, "
            f"the rest {(s_card - hist_card) / rounds * 1e3:.2f} ms: routing, "
            f"leaves, the host's bookkeeping and one sync a level); CPU "
            f"{s_cpu / rounds * 1e3:.2f} ms a round (histogram "
            f"{hist_cpu / rounds * 1e3:.2f})")
        log(f"[7] GBT {loss} card against CPU: {differ} of "
            f"{card._trees['feature'].size} tree nodes differ in split "
            f"({n_split} splits on the CPU), in {len(parted)} trees from "
            f"round {first}; history max relative difference "
            f"{max(worst):.3e}, predictions {p_err:.3e} (rtol 1e-3)")
        check(h_card[-1]["train_loss"] < h_card[0]["train_loss"],
              f"GBT {loss}: train loss did not fall")
        same = max(worst) <= 1e-3 and np.allclose(p_card, p_cpu, rtol=1e-3,
                                                  atol=1e-6)
        if not same:
            # The card's atomic sums can flip a near-tie, and every later
            # tree then grows on other residuals. Hold the fits together up
            # to the round where the trees parted (a near-tie leaves that
            # round's loss alike), then their final quality.
            check(first is not None, f"GBT {loss}: identical trees, yet the "
                                     f"card's fit differs from the CPU's")
            final = worst[-1]
            log(f"[7] GBT {loss}: the trees parted at round {first}; history "
                f"through it within {max(worst[:first + 1]):.3e}, final "
                f"losses within {final:.3e} (bounds 1e-3, 1e-2)")
            check(max(worst[:first + 1]) <= 1e-3,
                  f"GBT {loss}: the card's trees parted from the CPU's at "
                  f"round {first} on no near-tie")
            check(final <= 1e-2, f"GBT {loss}: after the trees parted the "
                                 f"card's final losses differ by {final:.3e}")
        if loss == "squared":
            import tempfile

            with tempfile.TemporaryDirectory() as tmp:
                again = P.GBTEstimator.restore(card.save(tmp), device="cuda")
            check(np.array_equal(again.predict(x_test), p_card),
                  "GBT restored from its save predicts otherwise")
            log("[7] GBT saved on the card, restored: the same predictions")
        # The device's idle share over 5 rounds of the same fit, refitted.
        device_profile(torch, f"GBT {loss}, 5 rounds on the card",
                       lambda: card.fit(P.MLDataset(blocks, num_shards=2),
                                        num_epochs=5))


TAXI_FEATURES = ["hour", "day_of_week", "distance_km", "passenger_count"]


def keras_taxi_model() -> str:
    """examples/tf_nyctaxi.py's ``keras_taxi_model``: the reference
    example's Dense(256..16) + BatchNormalization tower in the keras
    ``to_json()`` wire format."""
    layers = []
    for units in (256, 128, 64, 32, 16):
        layers.append({"class_name": "Dense",
                       "config": {"units": units, "activation": "relu"}})
        layers.append({"class_name": "BatchNormalization", "config": {}})
    layers.append({"class_name": "Dense",
                   "config": {"units": 1, "activation": "linear"}})
    return json.dumps({"class_name": "Sequential",
                       "config": {"name": "taxi_fare", "layers": layers}})


def titanic_columns(np, n, seed=7):
    """Titanic-shaped passengers (examples/jax_titanic.py's draws) after
    its fillna, encoding and scaling, with the class one-hot: 8 features
    and ``Survived``."""
    rng = np.random.default_rng(seed)
    female = rng.choice(["male", "female"], n) == "female"
    pclass = rng.choice([1, 2, 3], n, p=[0.24, 0.21, 0.55])
    age = rng.normal(30, 14, n).clip(0.5, 80)
    age[rng.random(n) < 0.2] = np.nan
    fare = rng.gamma(2.0, 16.0, n)
    logit = (1.2 * female - 0.45 * (pclass - 2)
             - 0.012 * np.nan_to_num(age, nan=30.0) + 0.004 * fare)
    survived = rng.random(n) < 1 / (1 + np.exp(-logit))
    cols = {"class_1": pclass == 1, "class_2": pclass == 2,
            "class_3": pclass == 3, "is_female": female,
            "age_n": np.nan_to_num(age, nan=30.0) / 40.0 - 0.75,
            "SibSp": rng.integers(0, 5, n), "Parch": rng.integers(0, 4, n),
            "fare_n": fare / 50.0 - 0.6, "Survived": survived}
    return {k: v.astype(np.float32) for k, v in cols.items()}


def phase_tf(torch, P, train, test):
    """8: TFEstimator with examples/tf_nyctaxi.py's keras tower,
    optimizer, loss and batch on the taxi rows; then a Titanic-shaped
    binary classifier with its sigmoid head fused into the loss."""
    import numpy as np

    est = P.TFEstimator(
        model=keras_taxi_model(),
        optimizer={"class_name": "Adam", "config": {"learning_rate": 1e-3}},
        loss="mean_squared_error", metrics=["mae"],
        feature_columns=TAXI_FEATURES, label_column="fare_amount",
        batch_size=256, num_epochs=TF_EPOCHS, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    history = est.fit(P.MLDataset([train], num_shards=1),
                      evaluate_ds=P.MLDataset([test], num_shards=1))
    log(f"[8] keras taxi tower fit: peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    impl = est._built()
    steps = -(-len(train["fare_amount"]) // 256)
    for h in history:
        log(f"[8] keras taxi tower ({impl.effective_epoch_mode}) epoch "
            f"{h['epoch']}: train_loss {h['train_loss']:.4f}, eval_mae "
            f"{h['eval_mae']:.4f}, {h['samples_per_sec']:.1f} samples/s, "
            f"{h['time_s'] / steps * 1e3:.3f} ms/step ({steps} steps)")
    check(history[-1]["train_loss"] < history[0]["train_loss"],
          "keras taxi tower: train loss did not fall")
    x = np.stack([test[c] for c in TAXI_FEATURES], axis=1)[:4096]
    preds = est.predict(x)
    module = est.get_model().eval()
    with torch.no_grad():
        want = module(torch.from_numpy(x).cuda()).cpu().numpy()
    check(preds.shape == (len(x), 1) and np.allclose(preds, want, rtol=1e-6,
                                                     atol=1e-6),
          "TFEstimator.predict differs from its model's forward")
    log(f"[8] predict on {len(x)} rows equals the returned model's forward")
    graph_step_report(
        torch, "8", impl,
        torch.from_numpy(np.stack([train[c] for c in TAXI_FEATURES],
                                  axis=1)[:256]).cuda(),
        torch.from_numpy(train["fare_amount"][:256]).cuda(),
        {k: 0 for k in KERNEL_SYMBOLS})

    cols = titanic_columns(np, 50_000)
    features = [c for c in cols if c != "Survived"]
    clf = P.TFEstimator(
        model=[{"class_name": "Dense",
                "config": {"units": 128, "activation": "relu"}},
               {"class_name": "Dense",
                "config": {"units": 64, "activation": "relu"}},
               {"class_name": "Dense",
                "config": {"units": 1, "activation": "sigmoid"}}],
        optimizer="adam", loss="binary_crossentropy", metrics=["accuracy"],
        feature_columns=features, label_column="Survived", batch_size=256,
        num_epochs=TF_EPOCHS, seed=0, device="cuda")
    check(clf.layer_configs[-1]["config"]["activation"] == "linear",
          "the sigmoid head was not fused into the loss")
    hist = clf.fit(P.MLDataset([cols], num_shards=1),
                   evaluate_ds=P.MLDataset([cols], num_shards=1))
    log(f"[8] Titanic-shaped classifier ({len(features)} features): losses "
        f"{[round(h['train_loss'], 4) for h in hist]}, eval accuracy "
        f"{hist[-1]['eval_accuracy']:.4f}, "
        f"{hist[-1]['samples_per_sec']:.1f} samples/s")
    check(hist[-1]["train_loss"] < hist[0]["train_loss"],
          "Titanic-shaped classifier: train loss did not fall")


# ------------------------------------------------------------ phase 9

_SERVE_MODELS = {}


def serve_classifier(seed: int, device="cuda", attention_impl="flash"):
    """Phase 2's classifier (bert_base width and depth, bf16, 2 classes)
    with weights from ``seed``, built once per process and argument
    set; ``attention_impl="dense"`` gives the same weights without the
    kernel."""
    import torch

    import raydp_tpu_torch as P

    key = (seed, str(device), attention_impl)
    if key not in _SERVE_MODELS:
        _SERVE_MODELS[key] = P.SequenceClassifier(
            P.bert_base(attention_impl=attention_impl, dtype=torch.bfloat16),
            device=device, generator=torch.Generator().manual_seed(seed),
        ).eval()
    return _SERVE_MODELS[key]


def padded_ids(torch, payloads, bucket, device):
    """Each request's ids padded with 0 to ``bucket``, as one int64
    tensor (the load generator's payloads are floats, ``[1.0] * n``)."""
    return torch.tensor([list(p)[:bucket] + [0] * (bucket - len(p))
                         for p in payloads], dtype=torch.int64, device=device)


def classify_batch(payloads, bucket, *, seed, device):
    """A batch replica's model: the requests' ids, padded to ``bucket``,
    through :func:`serve_classifier`; each request's logits as floats.
    Shipped as ``functools.partial(classify_batch, seed=...)``; a replica
    imports this file as the module ``chip_smoke`` and gives ``device``,
    the group's."""
    import torch

    model = serve_classifier(seed, device)
    with torch.inference_mode():
        logits = model(padded_ids(torch, payloads, bucket, device))
    return logits.float().cpu().tolist()


def _wait_up(group, what):
    """Until every replica of ``group`` has registered; fails the run
    after ``SERVE_UP_S``."""
    deadline = time.monotonic() + SERVE_UP_S
    while group.stats()["replicas_alive"] < group.replicas:
        check(time.monotonic() < deadline,
              f"{what}: replicas did not register within {SERVE_UP_S:.0f} "
              f"s: {group.stats()}")
        time.sleep(0.05)


def _wait_respawned(group, what):
    """Until the group has restarted a replica and every lineage is
    alive again."""
    deadline = time.monotonic() + SERVE_UP_S
    while True:
        st = group.stats()
        if st["restarts"] >= 1 and st["replicas_alive"] == group.replicas:
            return st
        check(time.monotonic() < deadline,
              f"{what}: no restart, or a lineage not back, after "
              f"{SERVE_UP_S:.0f} s: {st}")
        time.sleep(0.1)


def phase_serve_batch(torch, P):
    """9a: the bert_base classifier behind a 2-replica batch group."""
    import functools
    import importlib

    import numpy as np

    from raydp_tpu_torch.fault import FAULT_PLAN_ENV
    from raydp_tpu_torch.utils.profiling import metrics

    # By the name the replicas import it under: run as a script, this
    # file is __main__, which a replica cannot resolve.
    smoke = importlib.import_module("chip_smoke")
    model_fn = functools.partial(smoke.classify_batch, seed=SERVE_SEED)
    rng = np.random.default_rng(9)
    payloads = [rng.integers(1, 30522, size=int(n)).tolist()
                for n in rng.integers(8, 129, size=SERVE_REQUESTS)]

    # The driver's forwards of the same weights, each request padded to
    # its bucket, in the batches the queue would form from a full queue:
    # the flash model gives the in-process rate of this traffic, the
    # dense one (no kernel) the reference the replies are held against.
    model = smoke.serve_classifier(SERVE_SEED)
    dense = smoke.serve_classifier(SERVE_SEED, attention_impl="dense")
    by_bucket = {}
    for i, p in enumerate(payloads):
        b = next(b for b in SERVE_BUCKETS if len(p) <= b)
        by_bucket.setdefault(b, []).append(i)
    batches = [(b, idx[j:j + SERVE_MAX_BATCH])
               for b, idx in sorted(by_bucket.items())
               for j in range(0, len(idx), SERVE_MAX_BATCH)]

    def forward(m):
        out = [None] * len(payloads)
        for b, idx in batches:
            logits = m(padded_ids(torch, [payloads[i] for i in idx], b,
                                  "cuda")).float().cpu()
            for i, row in zip(idx, logits):
                out[i] = row
        return torch.stack(out)

    with torch.inference_mode():
        forward(model)  # warm-up
        t0 = time.perf_counter()
        inproc = forward(model)  # one host copy a batch, as a replica's
        inproc_s = time.perf_counter() - t0
        want = forward(dense)
    inproc_rate = SERVE_REQUESTS / inproc_s
    log(f"[9a] traffic: {SERVE_REQUESTS} requests of "
        f"{min(map(len, payloads))}-{max(map(len, payloads))} ids, "
        f"buckets {SERVE_BUCKETS}: "
        + ", ".join(f"{b}: {len(i)}" for b, i in sorted(by_bucket.items()))
        + f"; in-process forward of the same batches ({len(batches)}): "
        f"{inproc_s * 1e3:.2f} ms, {inproc_rate:.1f} sequences/s; max "
        f"|flash - dense| {(inproc - want).abs().max().item():.3e}")

    bound = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * want.abs()
    # Two logits nearer than their bounds allow are a tie at bf16
    # precision: either argmax is right there.
    tie = (want[:, 0] - want[:, 1]).abs() <= bound.max(dim=1).values * 2

    def check_replies(tag, got):
        got = torch.tensor(got, dtype=torch.float32)
        check(got.shape == want.shape, f"{tag}: replies {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite logits")
        outside = int(((got - want).abs() > bound).any(dim=1).sum())
        flips = got.argmax(1) != want.argmax(1)
        log(f"[9a] {tag}: {len(got)} replies, max |replica - dense| "
            f"{(got - want).abs().max().item():.3e} (tol {LOGIT_TOL}), "
            f"{outside} outside; argmax differs on {int(flips.sum())}, "
            f"{int((flips & tie).sum())} of them ties ({int(tie.sum())} "
            f"ties in all); max |replica - driver's flash| "
            f"{(got - inproc).abs().max().item():.3e}")
        check(outside == 0, f"{tag}: {outside} replies outside the bound")
        check(torch.allclose(got, inproc, **LOGIT_TOL),
              f"{tag}: replies differ from the driver's flash forward")
        check(not bool((flips & ~tie).any()),
              f"{tag}: argmax differs beyond a tie")

    def run(tag, plan, passes):
        if plan:
            os.environ[FAULT_PLAN_ENV] = plan
        metrics.reset()
        group = P.ReplicaGroup(
            replicas=SERVE_REPLICAS, device="cuda", mode="batch",
            model_fn=model_fn, buckets=SERVE_BUCKETS,
            max_batch=SERVE_MAX_BATCH, slo_ms=SERVE_SLO_MS,
            max_queue=SERVE_REQUESTS, dispatch_timeout_s=SERVE_REQUEST_S,
            label=f"smoke-{tag}")
        try:
            t0 = time.perf_counter()
            group.start()
            _wait_up(group, tag)
            up_s = time.perf_counter() - t0
            for k in range(passes):
                metrics.reset()
                t1 = time.perf_counter()
                reqs = [group.submit(p, timeout_s=SERVE_REQUEST_S)
                        for p in payloads]
                got = [r.wait(timeout=SERVE_REQUEST_S) for r in reqs]
                wall = time.perf_counter() - t1
                check_replies(f"{tag} pass {k}", got)
            stats = _wait_respawned(group, tag) if plan else group.stats()
            pongs = group.ping()
        finally:
            group.stop()
            os.environ.pop(FAULT_PLAN_ENV, None)
        log(f"[9a] {tag}: replicas up in {up_s:.2f} s; last pass "
            f"{wall * 1e3:.1f} ms -> {SERVE_REQUESTS / wall:.1f} sequences/s "
            f"through the group ({SERVE_REQUESTS / wall / inproc_rate:.3f} "
            f"of in-process); latency p50 {stats['latency_p50_s']} s, p99 "
            f"{stats['latency_p99_s']} s; batch fill {stats['batch_fill']}; "
            f"accepted {stats['accepted']:.0f}, replies "
            f"{stats['replies']:.0f}, errors {stats['errors']:.0f}, requeued "
            f"{stats['requeued']:.0f}, restarts {stats['restarts']:.0f}, "
            f"dup replies {stats['dup_replies']:.0f}; phases (mean s) "
            + ", ".join(f"{k} {v['mean_s']}" for k, v in
                        stats["phases"].items())
            + "; per replica " + json.dumps(stats["per_replica"]))
        log(f"[9a] {tag}: Ping " + "; ".join(
            f"replica {p['replica']} on {p['device']}, {p['cuda_bytes']} "
            f"B on the card, flash_fwd {p['launches']['flash_fwd']}"
            for p in pongs))
        check(stats["replies"] == SERVE_REQUESTS and stats["errors"] == 0,
              f"{tag}: {stats['replies']} replies, {stats['errors']} errors")
        check(stats["dup_replies"] == 0, f"{tag}: duplicate replies")
        check(all(p["device"] == "cuda" for p in pongs),
              f"{tag}: a replica serves on {[p['device'] for p in pongs]}")
        # A replica that ran its model holds it on the card (a respawned
        # one that served nothing has built none).
        check(all(p["cuda_bytes"] > 0 for p in pongs
                  if p["launches"]["flash_fwd"] > 0),
              f"{tag}: a replica launched kernels but holds no card memory")
        return stats, pongs, SERVE_REQUESTS / wall

    stats, pongs, rate = run("batch", None, passes=2)
    check(all(p["launches"]["flash_fwd"] > 0 for p in pongs),
          "a batch replica launched no flash forward")
    kill_stats, kill_pongs, kill_rate = run("batch-kill", SERVE_KILL_PLAN,
                                            passes=1)
    check(kill_stats["restarts"] >= 1 and kill_stats["dead_lineages"] == 0,
          "serve_kill: no restart, or a lineage lost")
    check(kill_stats["requeued"] >= 1, "serve_kill: no batch requeued")
    # By Ping, the replicas alive at each run's end: a killed
    # incarnation's launches are lost with it.
    return {"replica_launches": [
                sum(p["launches"]["flash_fwd"] for p in pongs),
                sum(p["launches"]["flash_fwd"] for p in kill_pongs)],
            "rate": rate, "inproc_rate": inproc_rate, "kill_rate": kill_rate}


def phase_serve_decode(torch, P):
    """9b: the bert_base-width f32 decode engine behind a 1-replica
    decode group, killed mid-stream."""
    import functools

    from raydp_tpu_torch.fault import FAULT_PLAN_ENV
    from raydp_tpu_torch.utils.profiling import metrics

    # No device bound: the replica gives the factory the group's.
    factory = functools.partial(
        P.build_transformer_engine, num_slots=8,
        page_tokens=16, seed=0, causal=True, attention_impl="flash",
        vocab_size=30522, max_len=512, d_model=768, n_heads=12,
        n_layers=12, d_ff=3072)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 30522, (n,), generator=gen).tolist()
               for n in SERVE_DECODE_PROMPT_LENS]
    trigger = [9, 9]
    P.set_exact_float32()
    engine = factory(device="cuda")
    want = [P.reference_decode(engine, p, SERVE_DECODE_MAX_NEW)
            for p in prompts]
    want_trigger = P.reference_decode(engine, trigger, 4)
    del engine
    torch.cuda.empty_cache()

    os.environ[FAULT_PLAN_ENV] = SERVE_DECODE_KILL_PLAN
    metrics.reset()
    group = P.ReplicaGroup(
        replicas=1, device="cuda", mode="decode", model_fn=factory,
        slo_ms=SERVE_SLO_MS, dispatch_timeout_s=SERVE_REQUEST_S,
        label="smoke-decode")
    try:
        t0 = time.perf_counter()
        group.start()
        _wait_up(group, "decode")
        # Registered; the engine is ready once Ping reports its graphs.
        deadline = time.monotonic() + SERVE_UP_S
        while "graphs" not in group.ping()[0]:
            check(time.monotonic() < deadline, "decode engine not built")
            time.sleep(0.1)
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        reqs = [group.submit_generate(p, max_new=SERVE_DECODE_MAX_NEW,
                                      timeout_s=SERVE_REQUEST_S)
                for p in prompts]
        deadline = time.monotonic() + SERVE_REQUEST_S
        while metrics.snapshot()["counters"].get("decode/tokens", 0) < 4:
            check(time.monotonic() < deadline, "no token streamed")
            time.sleep(0.005)
        trig = group.submit_generate(trigger, max_new=4,
                                     timeout_s=SERVE_REQUEST_S)
        got = [r.wait(timeout=SERVE_REQUEST_S)["tokens"] for r in reqs]
        got_trigger = trig.wait(timeout=SERVE_REQUEST_S)["tokens"]
        wall = time.perf_counter() - t1
        stats = _wait_respawned(group, "decode")
        pongs = group.ping()
    finally:
        group.stop()
        os.environ.pop(FAULT_PLAN_ENV, None)
    dec = stats["decode"]
    n_tokens = sum(map(len, got)) + len(got_trigger)
    ttfts = [r.ttft_s() for r in reqs + [trig]]
    log(f"[9b] decode group (bert_base width, f32, 1 replica, "
        f"{SERVE_DECODE_KILL_PLAN}): engine up in {up_s:.2f} s; "
        f"{n_tokens} tokens in {wall:.3f} s -> {n_tokens / wall:.1f} "
        f"tokens/s by the host clock, stats tokens/s "
        f"{dec['tokens_per_sec']}; TTFT p50 {dec['ttft_p50_s']} s, p99 "
        f"{dec['ttft_p99_s']} s; by request (prompt lengths "
        f"{SERVE_DECODE_PROMPT_LENS}, then the trigger) "
        + ", ".join(f"{t:.4f}" for t in ttfts)
        + f" s; TPOT p50 {dec['tpot_p50_s']} s; restarts "
        f"{stats['restarts']:.0f}, requeued prefills "
        f"{dec['requeued_prefills']:.0f}, dup tokens {dec['dup_tokens']:.0f}"
        f", replies {stats['replies']:.0f}, errors {stats['errors']:.0f}; "
        f"respawned replica: Ping {pongs[0]}")
    for p, g, w in zip(prompts, got, want):
        if g != w:
            i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                     min(len(g), len(w)))
            log(f"[9b] MISMATCH prompt len {len(p)} at token {i}: group "
                f"{g[i:i + 3]} reference {w[i:i + 3]}")
    check(got == want, "decode group streams differ from reference_decode")
    check(got_trigger == want_trigger, "the trigger's stream differs")
    check(stats["restarts"] >= 1, "decode: no restart")
    check(dec["requeued_prefills"] >= 1, "decode: no prefill requeued")
    check(stats["errors"] == 0 and stats["replies"] == len(prompts) + 1,
          "decode: errors or missing replies")
    check(pongs[0]["device"] == "cuda" and pongs[0]["cuda_bytes"] > 0,
          "decode replica's engine not on the card")
    return pongs[0]["launches"]["flash_fwd"]


# ----------------------------------------------------------- phase 10

# The ETL half: the taxi rows before the filter, the frames' partitions,
# the GLUE rows of the fine-tune from a frame, the Criteo rows of the DLRM
# fit; the native kernels' rows and columns (a GLUE-shaped int frame: 128
# token ids and the label).
# 100,000 taxi rows since phase 19 (200,000 before: phase 19's depth).
ETL_TAXI_ROWS, ETL_PARTS, TAXI_MLP_EPOCHS = 100_000, 4, 3
# 4,096 GLUE rows since phase 19 (8,192 before: phase 19's depth).
ETL_GLUE_ROWS, ETL_GLUE_BATCH, ETL_GLUE_EPOCHS = 4096, 64, 2
# 250,000 Criteo rows since phase 19 (500,000 before).
ETL_CRITEO_ROWS, ETL_CRITEO_EPOCHS, ETL_CRITEO_MIN_COUNT = 250_000, 5, 3
NATIVE_HASH_ROWS, NATIVE_GATHER_ROWS, NATIVE_GATHER_COLS = 4_000_000, 8192, 129
# The haversine udf runs row by row on Python floats, the numpy check on
# whole arrays: the two may round the last bit apart.
HAVERSINE_RTOL = 1e-12


def synthetic_taxi_table(np, n_rows, seed=0):
    """examples/data_process.py's ``synthetic_taxi`` rows (the same draws
    in the same order) as an Arrow table built from numpy columns, the
    pickup and dropoff times as ``datetime64[ns]``."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    secs = rng.integers(0, 365 * 24 * 3600, n_rows)
    pickup = (np.datetime64("2020-01-01", "ns")
              + secs.astype("timedelta64[s]").astype("timedelta64[ns]"))
    trip_min = rng.gamma(2.0, 7.0, n_rows)
    plon = -73.98 + 0.1 * rng.standard_normal(n_rows)
    plat = 40.75 + 0.1 * rng.standard_normal(n_rows)
    dlon = -73.97 + 0.1 * rng.standard_normal(n_rows)
    dlat = 40.76 + 0.1 * rng.standard_normal(n_rows)
    dist_km = np.hypot((dlon - plon) * 84.3, (dlat - plat) * 111.1)
    passengers = rng.integers(0, 7, n_rows)
    fare = np.maximum(2.5, 2.5 + 1.6 * dist_km + 0.3 * trip_min
                      + rng.standard_normal(n_rows))
    dropoff = pickup + np.round(trip_min * 60e9).astype("timedelta64[ns]")
    return pa.table({
        "pickup_datetime": pickup, "dropoff_datetime": dropoff,
        "passenger_count": passengers, "pickup_longitude": plon,
        "pickup_latitude": plat, "dropoff_longitude": dlon,
        "dropoff_latitude": dlat, "fare_amount": fare})


def nyc_taxi_preprocess(rdf, df):
    """examples/data_process.py's pipeline on the port's engine: drop bad
    rows, derive time and distance features, drop raw columns."""
    import numpy as np

    col = rdf.col
    df = df.filter((col("fare_amount") > 0) & (col("passenger_count") > 0))
    df = df.withColumn("hour", rdf.hour(col("pickup_datetime")))
    df = df.withColumn("day_of_week", rdf.dayofweek(col("pickup_datetime")))

    @rdf.udf("double")
    def haversine(lon1, lat1, lon2, lat2):
        rad = np.pi / 180.0
        dlon = (lon2 - lon1) * rad
        dlat = (lat2 - lat1) * rad
        a = (np.sin(dlat / 2) ** 2
             + np.cos(lat1 * rad) * np.cos(lat2 * rad) * np.sin(dlon / 2) ** 2)
        return 6371.0 * 2 * np.arcsin(np.sqrt(a))

    df = df.withColumn("distance_km", haversine(
        col("pickup_longitude"), col("pickup_latitude"),
        col("dropoff_longitude"), col("dropoff_latitude")))
    return df.select("hour", "day_of_week", "distance_km", "passenger_count",
                     "fare_amount")


def taxi_features_numpy(np, table):
    """``nyc_taxi_preprocess``'s output computed directly with numpy: the
    filter, the hour, Spark's day of week (Sunday 1) from nanoseconds
    since the epoch, and the haversine on whole arrays."""
    c = {n: table.column(n).to_numpy() for n in table.column_names}
    keep = (c["fare_amount"] > 0) & (c["passenger_count"] > 0)
    ns = c["pickup_datetime"].astype("int64")
    rad = np.pi / 180.0
    plon, plat = c["pickup_longitude"], c["pickup_latitude"]
    dlon, dlat = c["dropoff_longitude"], c["dropoff_latitude"]
    a = (np.sin((dlat - plat) * rad / 2) ** 2 + np.cos(plat * rad)
         * np.cos(dlat * rad) * np.sin((dlon - plon) * rad / 2) ** 2)
    days = ns // 86_400_000_000_000  # 1970-01-01 was a Thursday
    cols = {"hour": (ns // 3_600_000_000_000) % 24,
            "day_of_week": (days + 4) % 7 + 1,
            "distance_km": 6371.0 * 2 * np.arcsin(np.sqrt(a)),
            "passenger_count": c["passenger_count"],
            "fare_amount": c["fare_amount"]}
    return {k: v[keep] for k, v in cols.items()}


def taxi_etl_mismatch(np, got, want):
    """What differs between the engine's taxi features (an Arrow table)
    and ``taxi_features_numpy``'s: ``None`` when the row count and every
    value agree (the haversine within ``HAVERSINE_RTOL``)."""
    if got.num_rows != len(want["hour"]):
        return f"{got.num_rows} rows, want {len(want['hour'])}"
    for name, ref in want.items():
        vals = got.column(name).to_numpy()
        same = (np.allclose(vals, ref, rtol=HAVERSINE_RTOL, atol=0)
                if name == "distance_km" else np.array_equal(vals, ref))
        if not same:
            return f"column {name} differs"
    return None


def synthetic_glue(np, n, seq, vocab):
    """examples/bert_glue.py's ``synthetic_glue`` columns (seed 0): the
    label is whether marker token 7 appears."""
    rng = np.random.default_rng(0)
    ids = rng.integers(10, vocab, size=(n, seq))
    pos = rng.random(n) < 0.5
    ids[pos, rng.integers(0, seq, pos.sum())] = 7
    cols = {f"t{i}": ids[:, i] for i in range(seq)}
    cols["label"] = pos.astype(np.int64)
    return cols


def synthetic_criteo(np, n, n_dense=4, n_cat=6, vocab=1000):
    """examples/dlrm_criteo.py's ``synthetic_criteo`` columns (seed 11):
    gamma dense features, Pareto-skewed ids, a logistic label."""
    rng = np.random.default_rng(11)
    out = {}
    for i in range(n_dense):
        out[f"I{i}"] = rng.gamma(1.5, 2.0, n).astype(np.float32)
    for i in range(n_cat):
        out[f"C{i}"] = (rng.pareto(1.2, n) * 17).astype(np.int64) % vocab
    logit = -1.2 + 0.35 * out["I0"] - 0.2 * out["I1"] + 0.3 * (out["C0"] % 2)
    out["label"] = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(
        np.float32)
    return out


def remap_rare_ids(rdf, df, cat_cols, min_count):
    """examples/dlrm_criteo.py's ``remap_rare_ids`` on the port's engine:
    ids seen fewer than ``min_count`` times (``groupBy().count()``)
    collapse to 0, survivors are renumbered densely from 1 by a udf.
    The example's udf maps one id through ``pd.Series(...).map``; this
    one looks it up in the same dict, the same function at a small part
    of the cost. Returns (df, vocab sizes)."""
    vocab_sizes = []
    for c in cat_cols:
        counts = df.groupBy(c).count().to_arrow()
        ids = counts.column(c).to_numpy()
        seen = counts.column("count").to_numpy()
        keep = sorted(int(v) for v in ids[seen >= min_count])
        mapping = {v: i + 1 for i, v in enumerate(keep)}
        vocab_sizes.append(len(keep) + 1)

        @rdf.udf("int64")
        def remap(v, _m=mapping):
            return _m.get(v, 0)

        df = df.withColumn(c, remap(rdf.col(c)))
    return df, tuple(vocab_sizes)


def fit_timed(est, fit):
    """``fit()`` with the seconds from the call to ``est``'s first train
    step. Returns (history, seconds)."""
    first = []
    step = est._train_step

    def timed(x, y):
        if not first:
            first.append(time.perf_counter())
        return step(x, y)

    est._train_step = timed
    t0 = time.perf_counter()
    try:
        history = fit()
    finally:
        del est._train_step
    return history, first[0] - t0


def host_ms(fn, reps=3):
    """Best host-clock ms of ``reps`` calls (host code: no device)."""
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t) * 1e3)
    return best


def phase_native(np):
    """10a: the native host library built from raydp_tpu_torch/native/src
    and loaded; hash_bucket over 4M int64 and float64 keys with nulls
    bit-exact with its numpy twin (directly and through the engine's
    exchange hash); gather_matrix (f32 and i32) over a 129-column int
    frame of 8192 rows equal to numpy fancy indexing; each timed against
    its twin."""
    import pyarrow as pa

    from raydp_tpu_torch.dataframe import dataframe as engine
    from raydp_tpu_torch.native import build, lib as native

    t0 = time.perf_counter()
    ok = native.native_available()
    check(ok, f"the native library did not build or load: {native._error}")
    flags = build.built_flags()
    log(f"[10a] native library {build.lib_path(flags)}: built and loaded "
        f"in {time.perf_counter() - t0:.2f} s (g++ {' '.join(flags)}; "
        f"OpenMP {'-fopenmp' in flags})")
    rng = np.random.default_rng(21)
    n = NATIVE_HASH_ROWS
    ints = pa.array(rng.integers(-2**40, 2**40, n), mask=rng.random(n) < 0.05)
    floats = pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.05)
    table = pa.table({"i": ints, "f": floats})
    cols = [np.asarray(ints.fill_null(0)), np.asarray(floats.fill_null(0.0)),
            np.asarray(ints.is_valid()).astype(np.uint8),
            np.asarray(floats.is_valid()).astype(np.uint8)]
    for n_buckets in (8, 200):
        got = native.hash_bucket(cols, n_buckets, native=True)
        want = native.hash_bucket(cols, n_buckets, native=False)
        check(np.array_equal(got, want),
              f"native hash_bucket differs from its twin at {n_buckets}")
        check(np.array_equal(engine._hash_bucket(table, ["i", "f"],
                                                 n_buckets), want),
              "the engine's exchange hash differs from the twin")
    ms = host_ms(lambda: native.hash_bucket(cols, 200, native=True))
    twin = host_ms(lambda: native.hash_bucket(cols, 200, native=False))
    log(f"[10a] hash_bucket, {n} rows of int64 and float64 keys with nulls "
        f"(4 columns with validity): bit-exact with the numpy twin; native "
        f"{ms:.2f} ms, twin {twin:.2f} ms ({twin / ms:.1f}x, host clock, "
        f"best of 3)")
    gcols = [rng.integers(0, 30522, NATIVE_GATHER_ROWS)
             for _ in range(NATIVE_GATHER_COLS)]
    idx = rng.permutation(NATIVE_GATHER_ROWS)
    for out_dtype in (np.float32, np.int32):
        want = np.stack(gcols, axis=1)[idx].astype(out_dtype)
        got = native.gather_matrix(gcols, idx, out_dtype, native=True)
        check(np.array_equal(got, want),
              f"native gather_matrix {out_dtype.__name__} differs from numpy")
        ms = host_ms(lambda: native.gather_matrix(gcols, idx, out_dtype,
                                                  native=True))
        twin = host_ms(lambda: native.gather_matrix(gcols, idx, out_dtype,
                                                    native=False))
        log(f"[10a] gather_matrix {out_dtype.__name__}, {NATIVE_GATHER_ROWS} "
            f"rows x {NATIVE_GATHER_COLS} int64 columns, permuted: equal to "
            f"numpy fancy indexing; native {ms:.3f} ms, twin {twin:.3f} ms "
            f"({twin / ms:.1f}x, host clock, best of 3)")


def taxi_etl(np, tag):
    """The taxi ETL (examples/data_process.py) over 4 partitions and
    random_split on whatever executor ``from_arrow`` picks (the session's
    workers while one is live), checked against numpy. Returns (input
    rows/s, the ETL's frame, train frame, test frame, test rows)."""
    from raydp_tpu_torch import dataframe as rdf

    table = synthetic_taxi_table(np, ETL_TAXI_ROWS)
    t0 = time.perf_counter()
    raw = rdf.from_arrow(table, num_partitions=ETL_PARTS)
    t1 = time.perf_counter()
    out = nyc_taxi_preprocess(rdf, raw).persist()
    n_out = out.count()
    t2 = time.perf_counter()
    train_df, test_df = (d.persist() for d in
                         out.random_split([0.9, 0.1], seed=42))
    n_train, n_test = train_df.count(), test_df.count()
    etl_s = time.perf_counter() - t0
    rate = ETL_TAXI_ROWS / etl_s
    log(f"[{tag}] taxi ETL ({type(raw._executor).__name__}): "
        f"{ETL_TAXI_ROWS} rows over {ETL_PARTS} partitions -> {n_out} rows "
        f"-> {n_train} train + {n_test} test in {etl_s:.3f} s ({rate:.0f} "
        f"input rows/s, host clock): partitioning {t1 - t0:.3f} s, the "
        f"pipeline {t2 - t1:.3f} s, random_split {etl_s - (t2 - t0):.3f} s")
    wrong = taxi_etl_mismatch(np, out.to_arrow(),
                              taxi_features_numpy(np, table))
    check(wrong is None, f"{tag}: taxi ETL against numpy: {wrong}")
    check(n_train + n_test == n_out, f"{tag}: random_split lost or doubled "
                                     f"rows")
    log(f"[{tag}] taxi ETL equals numpy's features (rows and values exact, "
        f"haversine within rtol {HAVERSINE_RTOL})")
    return rate, out, train_df, test_df, n_test


def taxi_etl_and_mlp(torch, P, tag):
    """:func:`taxi_etl`, then Estimator.fit_on_df of the taxi MLP and
    predict_on_df on the card. Returns (input rows/s, the ETL's frame,
    train frame, test frame)."""
    import numpy as np

    rate, out, train_df, test_df, n_test = taxi_etl(np, tag)
    mlp = P.Estimator(
        model=P.taxi_fare_regressor(len(TAXI_FEATURES), device="cuda",
                                    generator=torch.Generator().manual_seed(0)),
        optimizer=lambda p: torch.optim.Adam(p, lr=1e-3), loss="smooth_l1",
        metrics=["mae"], num_epochs=TAXI_MLP_EPOCHS, batch_size=512,
        feature_columns=TAXI_FEATURES, label_column="fare_amount", seed=0,
        device="cuda")
    hist, first_s = fit_timed(mlp, lambda: mlp.fit_on_df(
        train_df, test_df, num_shards=2))
    losses = [h["train_loss"] for h in hist]
    log(f"[{tag}] taxi MLP fit_on_df ({mlp.effective_epoch_mode}): losses "
        f"{[round(v, 4) for v in losses]}, eval_mae {hist[-1]['eval_mae']:.4f},"
        f" {hist[-1]['samples_per_sec']:.0f} samples/s; {first_s:.3f} s from "
        f"the call to the first step")
    check(losses[-1] < losses[0], f"{tag}: taxi MLP: train loss did not "
                                  f"fall {losses}")
    pdf = mlp.predict_on_df(test_df, num_shards=2)
    x = pdf[TAXI_FEATURES].to_numpy(np.float32)
    want = mlp.predict(x)[:, 0]
    check(len(pdf) == n_test and np.allclose(pdf["prediction"], want,
                                             rtol=1e-5, atol=1e-5),
          f"{tag}: predict_on_df: not one prediction per row in row order")
    log(f"[{tag}] predict_on_df: {len(pdf)} rows, each row's prediction "
        f"equal to predict() on its features (rtol 1e-5)")
    return rate, out, train_df, test_df


def phase_taxi_etl(torch, P):
    """10b: the taxi ETL and MLP fit in this process
    (:func:`taxi_etl_and_mlp`), then GBTEstimator.fit_on_df and
    TFEstimator.fit_on_df on the card. Returns the ETL's input rows/s."""
    rate, _, train_df, test_df = taxi_etl_and_mlp(torch, P, "10b")

    gbt = P.GBTEstimator(n_trees=GBT_TREES, max_depth=5, max_bins=64,
                         feature_columns=TAXI_FEATURES,
                         label_column="fare_amount", device="cuda")
    started = []
    fit_matrix = gbt._fit_matrix

    def timed_fit_matrix(*args, **kw):
        started.append(time.perf_counter())
        return fit_matrix(*args, **kw)

    gbt._fit_matrix = timed_fit_matrix
    t0 = time.perf_counter()
    hist = gbt.fit_on_df(train_df, num_shards=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    metrics = gbt.evaluate(P.MLDataset.from_df(test_df, num_shards=2))
    log(f"[10b] GBT fit_on_df: {len(hist)} trees, train_loss "
        f"{hist[0]['train_loss']:.4f} -> {hist[-1]['train_loss']:.4f}, test "
        f"{metrics}; {seconds:.2f} s, {started[0] - t0:.3f} s from the call "
        f"to the first tree's data")
    check(hist[-1]["train_loss"] < hist[0]["train_loss"],
          "GBT fit_on_df: train loss did not fall")

    tf = P.TFEstimator(
        model=keras_taxi_model(),
        optimizer={"class_name": "Adam", "config": {"learning_rate": 1e-3}},
        loss="mean_squared_error", metrics=["mae"],
        feature_columns=TAXI_FEATURES, label_column="fare_amount",
        batch_size=256, num_epochs=TF_EPOCHS, seed=0, device="cuda")
    hist, first_s = fit_timed(tf._built(), lambda: tf.fit_on_df(train_df,
                                                                test_df))
    losses = [h["train_loss"] for h in hist]
    log(f"[10b] keras tower fit_on_df ({tf._built().effective_epoch_mode}): "
        f"losses {[round(v, 4) for v in losses]}, eval_mae "
        f"{hist[-1]['eval_mae']:.4f}, {hist[-1]['samples_per_sec']:.0f} "
        f"samples/s; {first_s:.3f} s from the call to the first step")
    check(losses[-1] < losses[0], "keras tower fit_on_df: train loss did "
                                  "not fall")
    return rate


def phase_glue_etl(torch, P, tag="10c"):
    """10c: examples/bert_glue.py's rows as a frame of 4 partitions (on
    the session's workers while one is live: 11c) ->
    Estimator.fit_on_df(num_shards=2) of the bf16 flash SequenceClassifier
    at bert_base width and depth, batch 64, AdamW, 2 epochs on the path
    "auto" picks: 12 launches of each flash kernel a step, in the
    counters. Returns (launch counts, ms a step of the last epoch,
    seconds from the call to the first step, the epochs' train losses)."""
    import numpy as np
    import pyarrow as pa

    from raydp_tpu_torch import dataframe as rdf

    df = rdf.from_arrow(pa.table(synthetic_glue(np, ETL_GLUE_ROWS, GLUE_SEQ,
                                                30522)),
                        num_partitions=ETL_PARTS)
    log(f"[{tag}] GLUE frame: {ETL_GLUE_ROWS} rows, {ETL_PARTS} partitions "
        f"on a {type(df._executor).__name__}")
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      max_len=GLUE_SEQ)
    est = P.Estimator(
        model=P.SequenceClassifier(
            cfg, device="cuda", generator=torch.Generator().manual_seed(9)),
        optimizer=lambda p: torch.optim.AdamW(p, lr=2e-5, weight_decay=1e-4),
        loss="softmax_ce", metrics=["categorical_accuracy"],
        num_epochs=ETL_GLUE_EPOCHS, batch_size=ETL_GLUE_BATCH,
        feature_columns=[f"t{i}" for i in range(GLUE_SEQ)],
        label_column="label", feature_dtype=np.int32, label_dtype=np.int32,
        seed=0, device="cuda")
    steps = ETL_GLUE_EPOCHS * ETL_GLUE_ROWS // ETL_GLUE_BATCH
    torch.cuda.synchronize()
    _reset_counts()
    hist, first_s = fit_timed(est, lambda: est.fit_on_df(df, num_shards=2))
    torch.cuda.synchronize()
    counts = _counts()
    losses = [h["train_loss"] for h in hist]
    per_epoch = ETL_GLUE_ROWS // ETL_GLUE_BATCH
    for h in hist:
        log(f"[{tag}] bert_base fine-tune from a DataFrame "
            f"({est.effective_epoch_mode}) epoch {h['epoch']}: train_loss "
            f"{h['train_loss']:.4f}, {h['samples']} samples in "
            f"{h['time_s']:.3f} s -> {h['samples_per_sec']:.1f} samples/s, "
            f"{h['time_s'] / per_epoch * 1e3:.2f} ms/step (host clock)")
    log(f"[{tag}] {first_s:.3f} s from fit_on_df's call to the first step; "
        f"launches over {steps} steps: {counts}")
    want = {k: 12 * steps for k in KERNEL_SYMBOLS}
    check(counts == want, f"{tag}: expected launches {want}, saw {counts}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{tag}: train loss did not fall {losses}")
    ms_per_step = hist[-1]["time_s"] / per_epoch * 1e3
    del est
    torch.cuda.empty_cache()
    return counts, ms_per_step, first_s, losses


def phase_criteo_etl(torch, P):
    """10d: examples/dlrm_criteo.py's rows and rare-id remap
    (``groupBy().count()``, a udf) -> fit_on_df of PackedDLRM at the
    example's configuration on the stream path."""
    import numpy as np
    import pyarrow as pa

    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.train.tf_estimator import OptaxAdagrad

    cols = synthetic_criteo(np, ETL_CRITEO_ROWS)
    cat = [f"C{i}" for i in range(6)]
    t0 = time.perf_counter()
    df = rdf.from_arrow(pa.table(cols), num_partitions=ETL_PARTS)
    df, vocab_sizes = remap_rare_ids(rdf, df, cat, ETL_CRITEO_MIN_COUNT)
    df = df.persist()
    n = df.count()
    etl_s = time.perf_counter() - t0
    want = tuple(int((np.unique(cols[c], return_counts=True)[1]
                      >= ETL_CRITEO_MIN_COUNT).sum()) + 1 for c in cat)
    log(f"[10d] criteo ETL: {n} rows, vocab sizes {vocab_sizes} (numpy "
        f"np.unique: {want}) in {etl_s:.3f} s ({n / etl_s:.0f} rows/s, host "
        f"clock)")
    check(vocab_sizes == want, f"remapped vocab sizes {vocab_sizes}, numpy "
                               f"{want}")
    cfg = P.DLRMConfig(dense_features=4, vocab_sizes=vocab_sizes,
                       embed_dim=32, bottom_mlp=(64, 32), top_mlp=(64, 32))
    est = P.Estimator(
        model=P.PackedDLRM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(13)),
        optimizer=lambda p: OptaxAdagrad(p, lr=5e-2), loss="bce",
        metrics=["accuracy"], num_epochs=ETL_CRITEO_EPOCHS, batch_size=1024,
        feature_columns=[f"I{i}" for i in range(4)] + cat,
        label_column="label", seed=0, epoch_mode="stream", device="cuda")
    hist, first_s = fit_timed(est, lambda: est.fit_on_df(df, num_shards=2))
    losses = [h["train_loss"] for h in hist]
    log(f"[10d] PackedDLRM fit_on_df (stream): losses "
        f"{[round(v, 4) for v in losses]}, {hist[-1]['samples_per_sec']:.0f} "
        f"samples/s; {first_s:.3f} s from the call to the first step")
    check(losses[-1] < losses[0], f"10d: train loss did not fall {losses}")


def phase_etl(torch, P):
    """10: the ETL half on the card. Returns 10c's launch counts and the
    numbers phase 11 is set beside: 10b's input rows/s, 10c's ms a step
    and seconds to its first step."""
    import numpy as np

    for lib in ("pyarrow", "pandas"):
        try:
            version = __import__(lib).__version__
        except ImportError:
            version = "missing"
        log(f"[10] {lib} {version}")
    phase_native(np)
    taxi_rate = phase_taxi_etl(torch, P)
    counts, glue_ms, glue_first_s, _ = phase_glue_etl(torch, P)
    phase_criteo_etl(torch, P)
    return counts, {"taxi_rows_per_s": taxi_rate, "glue_ms": glue_ms,
                    "glue_first_s": glue_first_s}


SESSION_WORKERS = 4
RESPAWN_WAIT_S = 60.0


def _worker_probe(ctx):
    """Runs on an ETL worker and imports nothing, so the workers stay as
    warm as ``init`` left them: whether the worker holds torch, and the
    CUDA devices it may see."""
    import os
    import sys

    return "torch" in sys.modules, os.environ.get("CUDA_VISIBLE_DEVICES")


def _log_worker_logs(log_dir, names=None):
    """Print the path and tail of each worker log (a worker failed)."""
    if not os.path.isdir(log_dir):
        log(f"[11] no worker logs at {log_dir}")
        return
    for name in sorted(names or os.listdir(log_dir)):
        path = os.path.join(log_dir, name)
        try:
            with open(path, errors="replace") as f:
                tail = f.read()[-2000:]
        except OSError as e:
            tail = f"(unreadable: {e})"
        log(f"[11] worker log {path}:\n{tail}")


def phase_session(torch, P, ref):
    """11: the session on the card. ``raydp_tpu_torch.init`` with 4 ETL
    worker processes; (a) the workers alive, torch-free and seeing no
    card; (b) 10b's taxi ETL and MLP fit on the workers; (c) 10c's
    bert_base fine-tune from a frame on the workers; (d) refs handed to
    the holder survive a SIGKILLed worker and its respawn, and ``stop()``
    leaves no segment. ``ref`` holds 10b's and 10c's numbers. Returns
    11c's launch counts and its ms a step and seconds to the first step."""
    import signal
    import tempfile

    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.dataframe.executor import ClusterExecutor
    from raydp_tpu_torch.store import shm

    st = os.statvfs(shm.shm_dir())
    log(f"[11a] shm directory {shm.shm_dir()}: "
        f"{st.f_bavail * st.f_frsize / 2**30:.2f} GiB free of "
        f"{st.f_blocks * st.f_frsize / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    try:
        session = P.init(app_name="chip-smoke", num_workers=SESSION_WORKERS)
    except Exception:
        _log_worker_logs(os.path.join(tempfile.gettempdir(),
                                      "raydp_tpu_torch",
                                      f"chip-smoke-{os.getpid()}"))
        raise
    init_s = time.perf_counter() - t0
    cluster = session.cluster
    namespace = cluster.namespace
    workers = cluster.alive_workers()
    log(f"[11a] init: {len(workers)} workers registered in {init_s:.3f} s "
        f"(host clock); namespace {namespace}, logs {cluster.log_dir}")
    check(len(workers) == SESSION_WORKERS,
          f"11a: {len(workers)} workers alive, want {SESSION_WORKERS}")
    frame = rdf.range(8, num_partitions=2)
    check(isinstance(frame._executor, ClusterExecutor),
          f"11a: a frame's executor is {type(frame._executor).__name__}")
    t0 = time.perf_counter()
    seen = {w.worker_id: cluster.submit(_worker_probe, worker_id=w.worker_id)
            for w in workers}
    log(f"[11a] each worker's (torch imported, CUDA_VISIBLE_DEVICES), "
        f"{time.perf_counter() - t0:.3f} s for the four probes: {seen}")
    check(all(v == (False, "") for v in seen.values()),
          f"11a: a worker imported torch or sees a card: {seen}")

    import numpy as np

    rate, out, _, _ = taxi_etl_and_mlp(torch, P, "11b")
    warm, _, _, _, _ = taxi_etl(np, "11b warm")
    base = ref["taxi_rows_per_s"]
    log(f"[11b] taxi ETL on {SESSION_WORKERS} workers: the first after init "
        f"{rate:.0f} input rows/s, again on warm workers {warm:.0f}, against "
        f"10b's {base:.0f} in this process ({rate / base:.2f}x; "
        f"{warm / base:.2f}x; host clock, same run)")
    seen = {w.worker_id: cluster.submit(_worker_probe, worker_id=w.worker_id)
            for w in cluster.alive_workers()}
    check(all(v == (False, "") for v in seen.values()),
          f"11b: a worker imported torch after the taxi ETL: {seen}")

    counts, ms, first_s, _ = phase_glue_etl(torch, P, tag="11c")
    log(f"[11c] bert_base from a cluster frame: {ms:.2f} ms/step against "
        f"10c's {ref['glue_ms']:.2f} ({ms / ref['glue_ms']:.3f}x); "
        f"{first_s:.3f} s from fit_on_df's call to the first step against "
        f"10c's {ref['glue_first_s']:.3f} s (host clock, same run)")

    refs = out.to_object_refs(owner_transfer=True)
    check(all(r.owner == "__holder__" for r in refs),
          "11d: to_object_refs(owner_transfer=True) left a worker owner")
    before = [cluster.resolver.get_arrow_table(r) for r in refs]
    victim = cluster.alive_workers()[0]
    os.kill(victim.pid, signal.SIGKILL)
    log(f"[11d] SIGKILLed worker {victim.worker_id} (pid {victim.pid}, log "
        f"{os.path.join(cluster.log_dir, victim.worker_id + '.log')}) "
        f"holding {len(refs)} holder-owned refs")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < RESPAWN_WAIT_S:
        alive = cluster.alive_workers()
        if (len(alive) == SESSION_WORKERS
                and victim.worker_id not in {w.worker_id for w in alive}):
            break
        time.sleep(0.1)
    alive = cluster.alive_workers()
    respawn_s = time.perf_counter() - t0
    check(len(alive) == SESSION_WORKERS
          and victim.worker_id not in {w.worker_id for w in alive},
          f"11d: no respawn within {RESPAWN_WAIT_S} s: alive "
          f"{[w.worker_id for w in alive]}")
    after = [cluster.resolver.get_arrow_table(r) for r in refs]
    check(all(a.equals(b) for a, b in zip(after, before)),
          "11d: a ref read back differs after the SIGKILL")
    rows = [cluster.submit(lambda ctx, r: ctx.get_table(r).num_rows, r,
                           worker_id=alive[-1].worker_id) for r in refs]
    check(rows == [t.num_rows for t in before],
          f"11d: a worker read other row counts {rows}")
    new = sorted({w.worker_id for w in alive}
                 - {w.worker_id for w in workers})
    log(f"[11d] {len(alive)} workers alive again {respawn_s:.2f} s after the "
        f"SIGKILL (new: {new}); all {len(refs)} refs ({sum(rows)} rows) read "
        f"back equal, by the driver and by worker {alive[-1].worker_id}")
    procs = list(cluster._procs.values())
    t0 = time.perf_counter()
    P.stop()
    stop_s = time.perf_counter() - t0
    left = shm.list_segments(f"rdp-{namespace}-")
    check(not left, f"11d: {len(left)} segments left after stop(): "
                    f"{left[:4]}")
    check(all(p.poll() is not None for p in procs),
          "11d: a worker process outlived stop()")
    check(P.current_session() is None, "11d: a session is live after stop()")
    log(f"[11d] stop() in {stop_s:.3f} s: every worker exited, no segment "
        f"of {namespace} left under {shm.shm_dir()}")
    return counts, {"glue_ms": ms, "glue_first_s": first_s}


# Phase 12: the second driver's time limit, the rows of the frame whose
# refs it hands to the holder, and the gang's ranks and batch.
CLIENT_LIMIT_S, CLIENT_REF_ROWS = 600.0, 1000
GANG_WORLD, GANG_BATCH, GANG_LIMIT_S = 2, 64, 600.0
# Each rank's logits must equal the single-process forward of the same
# rows bit for bit: the same kernels, weights and batches. A bf16 bound
# of 2e-2 could let a misaligned shard of this random-weight classifier
# pass; the log shows the logits' spread across rows beside the error.


def client_main(address: str) -> int:
    """12a's second driver, run in a process of its own: attaches to the
    session at ``address`` with ``raydp_tpu_torch.connect``, runs 10c's
    fine-tune through it (the frame's ETL on the session's workers, the
    fit on the card here) twice: the first pays this new process's first
    CUDA work, the second, on a warm process, still reads every block
    through the store agents. Then it hands a small frame's refs to the
    holder, disconnects and prints one ``RESULT`` line: the first fit's
    launch counts, each fit's ms a step, seconds to the first step and
    losses, the peak device memory and the refs."""
    import numpy as np
    import pyarrow as pa
    import torch

    import raydp_tpu_torch as P
    from raydp_tpu_torch import dataframe as rdf

    if not torch.cuda.is_available():
        raise RuntimeError("12a: the second driver sees no CUDA device")
    t0 = time.perf_counter()
    session = P.connect(address)
    connect_s = time.perf_counter() - t0
    log(f"[12a] connected to {address} in {connect_s:.3f} s: "
        f"{len(session.cluster.alive_workers())} workers")
    torch.cuda.reset_peak_memory_stats()
    counts, ms, first_s, losses = phase_glue_etl(torch, P, tag="12a")
    peak = torch.cuda.max_memory_allocated()
    _, warm_ms, warm_first_s, warm_losses = phase_glue_etl(
        torch, P, tag="12a warm")
    frame = rdf.from_arrow(pa.table({"x": np.arange(CLIENT_REF_ROWS)}),
                           num_partitions=ETL_PARTS)
    refs = frame.to_object_refs(owner_transfer=True)
    P.stop()
    print("RESULT " + json.dumps({
        "counts": counts, "ms": ms, "first_s": first_s, "losses": losses,
        "warm_ms": warm_ms, "warm_first_s": warm_first_s,
        "warm_losses": warm_losses, "connect_s": connect_s,
        "peak_bytes": peak,
        "refs": [(r.object_id, r.size, r.owner, r.num_rows, r.node_id)
                 for r in refs],
    }), flush=True)
    return 0


def gang_score(ctx, tables, seed, batch):
    """12b's rank body: phase 2's classifier (:func:`serve_classifier`,
    bf16, flash) on ``cuda:{local_rank % device_count}`` scores the
    rank's shard in batches of ``batch`` after one warm-up batch, then
    joins the gang's gloo group and all-reduces ``[correct, rows]``.
    The rank imports this file as the module ``chip_smoke``. Returns the
    logits, the rank's own launch counts, its scoring window on the host
    clock and its peak device memory."""
    import numpy as np
    import pyarrow as pa
    import torch
    import torch.distributed as dist

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise RuntimeError(f"12b: rank {ctx.rank} sees no CUDA device")
    device = f"cuda:{ctx.local_rank % torch.cuda.device_count()}"
    torch.cuda.set_device(device)
    model = cs.serve_classifier(seed, device)
    table = pa.concat_tables(tables)
    ids = torch.from_numpy(np.stack(
        [table.column(f"t{i}").to_numpy() for i in range(cs.GLUE_SEQ)],
        axis=1)).to(device)
    labels = table.column("label").to_numpy()
    with torch.inference_mode():
        model(ids[:batch])  # warm-up: cuBLAS handles, the kernel library
        torch.cuda.synchronize()
        cs._reset_counts()
        start = time.time()
        logits = torch.cat([model(ids[lo:lo + batch])
                            for lo in range(0, len(ids), batch)])
        torch.cuda.synchronize()
        end = time.time()
    counts = cs._counts()
    correct = int((logits.argmax(-1).cpu().numpy() == labels).sum())
    ctx.init_distributed(device="cpu")  # the tally lives on the host
    total = torch.tensor([correct, len(labels)], dtype=torch.int64)
    dist.all_reduce(total)
    return {"rank": ctx.rank, "device": device,
            "logits": logits.float().cpu().numpy(), "counts": counts,
            "start": start, "end": end, "correct": correct,
            "rows": len(labels), "all_reduced": total.tolist(),
            "peak_bytes": torch.cuda.max_memory_allocated(device)}


def start_client(torch, session):
    """12a's second driver process, started here and left running beside
    12b: it attaches to ``session`` by ``connect`` and runs 10c's
    fine-tune (:func:`client_main`)."""
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # two processes now share the card
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    address = session.cluster.master.address
    script = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
              f"sys.exit(chip_smoke.client_main({address!r}))")
    # Files, not pipes: nothing reads the process's output until it ends.
    tmp = tempfile.mkdtemp(prefix="chip-smoke-12a-")
    with open(os.path.join(tmp, "out"), "w") as out, \
            open(os.path.join(tmp, "err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", script], cwd=ROOT,
                                stdout=out, stderr=err, text=True)
    return proc, tmp, held, time.perf_counter()


def phase_client(torch, P, session, ref, started):
    """12a: waits for the second driver :func:`start_client` started;
    its own counters must read 12 launches of each kernel a step, its
    losses fall, and once it has disconnected the session's workers are
    alive and the refs it handed to the holder read back here. ``ref``
    holds 11c's numbers."""
    import shutil

    import numpy as np
    import pyarrow as pa

    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.store.object_store import ObjectRef

    proc, tmp, held, t0 = started
    try:
        proc.wait(timeout=CLIENT_LIMIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    wall_s = time.perf_counter() - t0
    with open(os.path.join(tmp, "out")) as f:
        stdout = f.read()
    with open(os.path.join(tmp, "err")) as f:
        stderr = f.read()
    shutil.rmtree(tmp, ignore_errors=True)
    for line in stdout.splitlines():
        if not line.startswith("RESULT "):
            log(f"  (client) {line}")
    check(proc.returncode == 0,
          f"12a: the second driver exited {proc.returncode}:\n"
          f"{stderr[-3000:]}")
    out = json.loads(next(line for line in stdout.splitlines()
                          if line.startswith("RESULT "))[len("RESULT "):])
    steps = ETL_GLUE_EPOCHS * ETL_GLUE_ROWS // ETL_GLUE_BATCH
    want = {k: 12 * steps for k in KERNEL_SYMBOLS}
    check(out["counts"] == want,
          f"12a: the client's counters read {out['counts']}, want {want}")
    for losses in (out["losses"], out["warm_losses"]):
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"12a: train loss did not fall {losses}")
    alive = session.cluster.alive_workers()
    check(len(alive) == SESSION_WORKERS,
          f"12a: {len(alive)} workers alive after the client disconnected")
    refs = [ObjectRef(*vals) for vals in out["refs"]]
    back = pa.concat_tables([session.cluster.resolver.get_arrow_table(r)
                             for r in refs])
    check(back.column("x").to_pylist() == list(range(CLIENT_REF_ROWS)),
          "12a: the refs the client handed to the holder read back other "
          "rows")
    check(rdf.from_arrow(pa.table({"x": [1, 2, 3]})).to_pandas()["x"]
          .tolist() == [1, 2, 3], "12a: the session runs no stage after "
                                  "the client left")
    log(f"[12a] second driver through connect(): {wall_s:.1f} s in all "
        f"(beside 12b; process start, imports, connect in "
        f"{out['connect_s']:.3f} s, "
        f"the ETL, the fit); {out['ms']:.2f} ms/step against 11c's "
        f"{ref['glue_ms']:.2f} ({out['ms'] / ref['glue_ms']:.3f}x); "
        f"{out['first_s']:.3f} s from fit_on_df's call to the first step "
        f"against 11c's {ref['glue_first_s']:.3f} s (host clock, same run); "
        f"losses {[round(x, 4) for x in out['losses']]}; launches by the "
        f"client's counters {out['counts']}")
    log(f"[12a] the client's second fit, on a warm process: "
        f"{out['warm_ms']:.2f} ms/step ({out['warm_ms'] / ref['glue_ms']:.3f}x "
        f"11c's); {out['warm_first_s']:.3f} s to the first step against "
        f"11c's {ref['glue_first_s']:.3f} s; losses "
        f"{[round(x, 4) for x in out['warm_losses']]}")
    log(f"[12a] peak device memory: the client process "
        f"{out['peak_bytes'] / 2**30:.3f} GiB; this process "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"({held / 2**30:.3f} GiB held before); {SESSION_WORKERS} workers "
        f"alive after the disconnect, {len(refs)} client refs "
        f"({back.num_rows} rows) read back by this driver")
    return out


def phase_gang(torch, P, session):
    """12b: an SPMD gang of 2 ranks on the card scores 10c's frame from
    the session's object store, each rank its shard of the dataset's
    locality-aware plan, sent in ``per_rank_args``; each rank's logits
    held against this process's forward of the same rows, each rank's
    counter 12 launches a batch, the gloo all_reduce equal to the sums.
    Returns the ranks' results."""
    import numpy as np
    import pyarrow as pa

    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.spmd import create_spmd_job

    frame = rdf.from_arrow(pa.table(synthetic_glue(np, ETL_GLUE_ROWS,
                                                   GLUE_SEQ, 30522)),
                           num_partitions=ETL_PARTS)
    job = create_spmd_job("smoke-gang", world_size=GANG_WORLD, timeout=60)
    t0 = time.perf_counter()
    job.start()
    start_s = time.perf_counter() - t0
    try:
        ds = MLDataset.from_df(frame, num_shards=GANG_WORLD,
                               rank_nodes=job.rank_nodes())
        shards = [ds.shard_tables(r) for r in range(GANG_WORLD)]
        shard_bytes = [sum(t.nbytes for t in s) for s in shards]
        log(f"[12b] gang of {GANG_WORLD} ranks registered in {start_s:.3f} s "
            f"(start(), host clock; logs {job.log_paths}); rank nodes "
            f"{job.rank_nodes()}, block nodes {ds.block_nodes}, locality "
            f"{ds.locality()}; {ds.rows_per_shard} rows a rank, "
            f"{[round(b / 2**20, 2) for b in shard_bytes]} MiB of ids a rank "
            f"in per_rank_args")
        probe_counts = capture_gang_profile(torch, job, shards)
        t0 = time.perf_counter()
        out = job.run(gang_score, timeout=GANG_LIMIT_S, per_rank_args=[
            (shards[r], SERVE_SEED, GANG_BATCH) for r in range(GANG_WORLD)])
        run_s = time.perf_counter() - t0
    finally:
        job.stop()
    check([o["rank"] for o in out] == list(range(GANG_WORLD)),
          f"12b: results out of rank order {[o['rank'] for o in out]}")
    batches = -(-ds.rows_per_shard // GANG_BATCH)
    for o in out:
        check(o["counts"]["flash_fwd"] == 12 * batches,
              f"12b: rank {o['rank']} counted {o['counts']['flash_fwd']} "
              f"flash_fwd launches, want {12 * batches}")
    sums = [sum(o["correct"] for o in out), sum(o["rows"] for o in out)]
    check(all(o["all_reduced"] == sums for o in out),
          f"12b: all_reduce gave {[o['all_reduced'] for o in out]}, the "
          f"ranks' sums are {sums}")

    model = serve_classifier(SERVE_SEED, "cuda")
    errs, exact, spread = [], [], []
    with torch.inference_mode():
        for r, o in enumerate(out):
            table = pa.concat_tables(shards[r])
            ids = torch.from_numpy(np.stack(
                [table.column(f"t{i}").to_numpy() for i in range(GLUE_SEQ)],
                axis=1)).cuda()
            want = torch.cat([model(ids[lo:lo + GANG_BATCH])
                              for lo in range(0, len(ids), GANG_BATCH)])
            got = torch.from_numpy(o["logits"]).cuda()
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"12b: rank {r} logits {tuple(got.shape)}")
            errs.append((got - want.float()).abs().max().item())
            exact.append(torch.equal(got, want.float()))
            spread.append(round((got - got.mean(0)).abs().max().item(), 4))
        one_ms = time_ms(torch, lambda: model(ids[:GANG_BATCH]), iters=20)
    check(all(exact),
          f"12b: rank logits differ from the single-process forward by "
          f"{errs} (required: equal)")
    window = max(o["end"] for o in out) - min(o["start"] for o in out)
    rate = sums[1] / window
    base = RATES["glue_forward_seq_per_s"]
    log(f"[12b] {sums[1]} rows scored by {GANG_WORLD} ranks on "
        f"{sorted({o['device'] for o in out})} in a {window:.3f} s window "
        f"(host clock, first start to last end): {rate:.1f} sequences/s "
        f"against phase 2's {base:.1f} in one process at batch "
        f"{GLUE_BATCH} ({rate / base:.3f}x) and this process's "
        f"{GANG_BATCH / one_ms * 1e3:.1f} at batch {GANG_BATCH} (CUDA "
        f"events); each rank's own window "
        f"{[round(o['end'] - o['start'], 3) for o in out]} s; run() "
        f"{run_s:.1f} s with the ranks' imports and model builds")
    log(f"[12b] max |rank - single-process| logits {errs} (equal: "
        f"{exact}; max |logit - its column's mean| over each rank's rows "
        f"{spread}); flash_fwd "
        f"launches by rank {[o['counts']['flash_fwd'] for o in out]}; "
        f"all_reduce [correct, rows] {out[0]['all_reduced']} "
        f"(accuracy {sums[0] / sums[1]:.4f}, random weights); peak device "
        f"memory by rank "
        f"{[round(o['peak_bytes'] / 2**30, 3) for o in out]} GiB")
    del model
    torch.cuda.empty_cache()
    return out, probe_counts


def phase_second_drivers(torch, P, ref):
    """12: a fresh 4-worker session driven from a second driver process
    (12a) and, while that process runs, from an SPMD gang (12b); ``ref``
    holds 11c's numbers. Returns 12a's result and 12b's launches."""
    from raydp_tpu_torch.store import shm

    session = P.init(app_name="chip-smoke-12", num_workers=SESSION_WORKERS)
    namespace = session.cluster.namespace
    try:
        started = start_client(torch, session)
        try:
            ranks, probe_counts = phase_gang(torch, P, session)
        finally:
            client = phase_client(torch, P, session, ref, started)
    finally:
        P.stop()
    left = shm.list_segments(f"rdp-{namespace}-")
    check(not left, f"12: {len(left)} segments left after stop()")
    rank_launches = [o["counts"]["flash_fwd"] for o in ranks]
    return client, {"launches": sum(rank_launches),
                    "rank_launches": rank_launches,
                    "probe_counts": probe_counts}


# Phase 13: the window DLRM id pipeline on the session's workers (13a)
# and fit_spmd of 10c's classifier over a gang of 2 ranks (13b).
# 250,000 rows since phase 19 (500,000 before: phase 19's depth); 6.5M
# exploded values stay above the exchange's 64 MB coalesce size.
WINDOW_ROWS, WINDOW_DENSE, WINDOW_TABLES = 250_000, 13, 26
WINDOW_VOCAB, WINDOW_PARTS = 100_000, 8
# 13b ran 2,048 rows until phase 18 came, then 1,024 and 512 as phase 19
# came: 256 keeps the script inside its limit on a slow host's gloo (4
# steps a rank an epoch).
GANG_FIT_ROWS, GANG_FIT_BATCH, GANG_FIT_EPOCHS = 256, 32, 2
GANG_FIT_LIMIT_S = 900.0


def window_criteo_table(np, n, seed=13):
    """Criteo-shaped rows: ``WINDOW_DENSE`` gamma dense features
    ``I<i>``, ``WINDOW_TABLES`` categorical columns ``C<t>`` of
    Pareto-skewed (zipf-like) raw ids folded into at most
    ``WINDOW_VOCAB`` values, a logistic label of I0, I1 and C0's parity,
    and a row id ``rid``."""
    rng = np.random.default_rng(seed)
    cols = {"rid": np.arange(n, dtype=np.int64)}
    for i in range(WINDOW_DENSE):
        cols[f"I{i}"] = rng.gamma(1.5, 2.0, n).astype(np.float32)
    for t in range(WINDOW_TABLES):
        cols[f"C{t}"] = ((rng.pareto(1.2, n) * 17).astype(np.int64)
                         * (t + 1) + t) % WINDOW_VOCAB
    logit = (-1.2 + 0.35 * cols["I0"] - 0.2 * cols["I1"]
             + 0.3 * (cols["C0"] % 2))
    cols["label"] = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(
        np.float32)
    return cols


def window_ids(rdf, df, cat):
    """The reference notebook's ``assign_id_with_window``: every
    categorical value's id is its frequency rank within its column, 0
    for the most frequent (ties by the value), from ``posexplode`` ->
    ``groupBy("column_id", "data").count()`` -> ``row_number().over(
    Window.partitionBy("column_id").orderBy(desc("count"), "data")) - 1``.
    Returns the (column_id, data, count, id) frame."""
    melted = df.posexplode(cat, pos_name="column_id", value_name="data")
    counts = melted.groupBy("column_id", "data").count()
    w = rdf.Window.partitionBy("column_id").orderBy(rdf.desc("count"),
                                                    "data")
    return counts.withColumn("id", rdf.row_number().over(w) - 1)


def window_ids_numpy(np, values):
    """The same ranking of one column's values in numpy: (values sorted,
    their ids)."""
    vals, cnt = np.unique(values, return_counts=True)
    order = np.lexsort((vals, -cnt))
    ids = np.empty(len(vals), dtype=np.int64)
    ids[order] = np.arange(len(vals))
    return vals, ids


def window_first_rows(rdf, df, cat):
    """The ``row_number() == 1`` dedup idiom over the exploded values:
    every (column, value) pair once, with the id of its first row
    (``row_number().over(Window.partitionBy("column_id", "data")
    .orderBy("rid")) == 1``). The exploded frame, three int64 columns of
    ``WINDOW_ROWS * WINDOW_TABLES`` rows, is far above the exchange's
    coalesce size, so this window runs as a hash exchange on the workers
    and sorts each bucket there (the id pipeline's window gets a small
    frame of counts, gathered into one task)."""
    melted = df.posexplode(cat, pos_name="column_id", value_name="data",
                           keep=["rid"])
    w = rdf.Window.partitionBy("column_id", "data").orderBy("rid")
    return melted.filter(rdf.row_number().over(w) == 1)


def join_ids(rdf, df, ids, cat):
    """Each categorical column replaced by its id: one join a column
    against that column's slice of ``ids`` (the reference notebook's
    join back per column)."""
    for t, c in enumerate(cat):
        table = ids.filter(rdf.col("column_id") == t).select(
            rdf.col("data").alias(c), rdf.col("id").alias(f"{c}__id"))
        df = df.join(table, on=c).drop(c).withColumnRenamed(f"{c}__id", c)
    return df


def phase_window_dlrm(torch, P, session):
    """13a: the window id pipeline on the session's 4 workers over
    ``WINDOW_ROWS`` Criteo-shaped rows, held against numpy; its
    ``explain(analyze=True)``, ``profile()`` and the cluster's progress
    report; the ids joined back into the frame, which feeds
    ``PackedDLRM(criteo_dlrm())`` through ``fit_on_df`` on the stream
    path (phase 5's batch, steps and epochs)."""
    import re

    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.dataframe.executor import ClusterExecutor
    from raydp_tpu_torch.telemetry.progress import stage_store

    cat = [f"C{t}" for t in range(WINDOW_TABLES)]
    dense = [f"I{i}" for i in range(WINDOW_DENSE)]
    cols = window_criteo_table(np, WINDOW_ROWS)
    t0 = time.perf_counter()
    df = rdf.from_arrow(pa.table(cols), num_partitions=WINDOW_PARTS)
    check(isinstance(df._executor, ClusterExecutor),
          f"13a: the frame runs on {type(df._executor).__name__}")
    last0 = stage_store.last_id()
    ids = window_ids(rdf, df, cat).persist()
    plan = ids.explain(analyze=True, quiet=True)
    id_s = time.perf_counter() - t0
    prof = ids.profile()
    table = ids.to_arrow()
    n_ids = table.num_rows
    want_pairs = 0
    bad = []
    for t, c in enumerate(cat):
        vals, want = window_ids_numpy(np, cols[c])
        want_pairs += len(vals)
        mine = table.filter(pc.equal(table.column("column_id"), t))
        got_vals = mine.column("data").to_numpy()
        order = np.argsort(got_vals)
        if not (np.array_equal(got_vals[order], vals) and np.array_equal(
                mine.column("id").to_numpy()[order], want)):
            bad.append(c)
    check(not bad, f"13a: window ids differ from numpy's ranking in {bad}")
    check(n_ids == want_pairs,
          f"13a: {n_ids} (column, value) pairs, numpy has {want_pairs}")
    log("[13a] explain(analyze=True) of the id pipeline:\n" + plan)
    footer = re.search(r"== Exchanges == ran: (\d+), elided: (\d+), "
                       r"coalesced: (\d+)", plan)
    check(footer is not None, "13a: no exchange footer in the plan")
    ran, elided, coalesced = map(int, footer.groups())
    annotations = [n["annotation"] for n in ids._lineage]
    check(ran == sum(a.startswith("hash exchange") for a in annotations)
          and coalesced == sum(a.startswith("coalesced:")
                               for a in annotations)
          and elided == 0 and ran + coalesced >= 1,
          f"13a: footer ran {ran}, elided {elided}, coalesced {coalesced} "
          f"against the plan's annotations {annotations} (want them to "
          f"agree, the groupBy's rows co-located, nothing elided)")
    stage_lines = [ln for ln in plan.splitlines()
                   if re.match(r"\s+stage \d+", ln)]
    check(stage_lines and all("[cluster]" in ln and "workers=" in ln
                              for ln in stage_lines),
          f"13a: stages not all attributed to the cluster: {stage_lines}")
    stats = [s for node in prof["plan"] for s in node["stats"]]
    check(stats[0]["rows_in"] == WINDOW_ROWS
          and stats[-1]["rows_out"] == n_ids
          and all(s["rows_out"] == sum(r for r in s["part_rows"] if r > 0)
                  for s in stats),
          f"13a: profile() rows {[(s['op'], s['rows_in'], s['rows_out']) for s in stats]}"
          f" against the frame's {WINDOW_ROWS} rows and {n_ids} ids")
    report = session.cluster.progress_report()
    mine = [st for st in report["recent"] if st["stage_id"] > last0]
    check(not [st for st in report["active"] if st["stage_id"] > last0]
          and mine and all(st["done"] >= st["total"] for st in mine),
          f"13a: progress report not converged: {report['active']}")
    for s in ids.stage_stats:
        log(f"[13a] stage {s.op} [{s.executor}]: {s.wall_s:.3f} s wall "
            f"(dispatch {s.dispatch_s:.3f}, queue {s.queue_s:.3f}), rows "
            f"{s.rows_in} -> {s.rows_out}, skew {s.skew:.2f}, tasks by "
            f"worker {s.workers}")
    log(f"[13a] id pipeline: {WINDOW_ROWS} rows x {WINDOW_TABLES} columns "
        f"({WINDOW_ROWS * WINDOW_TABLES} exploded values) -> {n_ids} ids "
        f"in {id_s:.3f} s ({WINDOW_ROWS / id_s:.0f} input rows/s, host "
        f"clock, explain's run included); progress: "
        f"{report['stages_done']} stages done, {len(mine)} of this query, "
        f"none in flight")

    # The same window engine at the exploded size: a hash exchange on
    # (column_id, data) across the workers, each bucket sorted by rid.
    t0 = time.perf_counter()
    first = window_first_rows(rdf, df, cat).persist()
    first_plan = first.explain(analyze=True, quiet=True)
    dedup_s = time.perf_counter() - t0
    got = first.to_arrow()
    bad = []
    for t, c in enumerate(cat):
        vals, first_rid = np.unique(cols[c], return_index=True)
        mine = got.filter(pc.equal(got.column("column_id"), t))
        data = mine.column("data").to_numpy()
        order = np.argsort(data)
        if not (np.array_equal(data[order], vals) and np.array_equal(
                mine.column("rid").to_numpy()[order], first_rid)):
            bad.append(c)
    check(not bad and got.num_rows == n_ids,
          f"13a: first rows by the window differ from numpy's in {bad} "
          f"({got.num_rows} rows, {n_ids} pairs)")
    win_nodes = [n for n in first._lineage
                 if n["annotation"].startswith("hash exchange (window)")]
    win_stats = [st for node in win_nodes
                 for st in map(stage_store.get, node["stage_ids"])
                 if st is not None]
    check(len(win_nodes) == 1 and win_stats
          and len(win_stats[-1].workers) >= 2,
          f"13a: the dedup window's exchange did not run as a hash exchange "
          f"on 2 or more workers: {[n['annotation'] for n in first._lineage]}"
          f", {[(s.op, s.workers) for s in win_stats]}")
    log("[13a] explain(analyze=True) of the dedup window:\n" + first_plan)
    for s in first.stage_stats:
        log(f"[13a] dedup stage {s.op} [{s.executor}]: {s.wall_s:.3f} s "
            f"wall, rows {s.rows_in} -> {s.rows_out}, skew {s.skew:.2f}, "
            f"tasks by worker {s.workers}")
    log(f"[13a] dedup window over {WINDOW_ROWS * WINDOW_TABLES} exploded "
        f"values -> {got.num_rows} first rows in {dedup_s:.3f} s (host "
        f"clock, explain's run included), equal to numpy's")
    del first, got

    t0 = time.perf_counter()
    joined = join_ids(rdf, df, ids, cat).persist()
    n_joined = joined.count()
    join_s = time.perf_counter() - t0
    check(n_joined == WINDOW_ROWS,
          f"13a: {n_joined} rows after the joins, want {WINDOW_ROWS}")
    got = joined.select("rid", *cat).to_arrow()
    order = np.argsort(got.column("rid").to_numpy())
    bad = []
    for c in cat:
        vals, want = window_ids_numpy(np, cols[c])
        expect = want[np.searchsorted(vals, cols[c])]
        if not np.array_equal(got.column(c).to_numpy()[order], expect):
            bad.append(c)
    check(not bad, f"13a: joined ids differ from numpy's in {bad}")
    etl_s = id_s + join_s
    log(f"[13a] {WINDOW_TABLES} joins back in {join_s:.3f} s; the ETL "
        f"{etl_s:.3f} s in all: {WINDOW_ROWS / etl_s:.0f} rows/s (host "
        f"clock)")

    cfg = P.criteo_dlrm()
    est = P.Estimator(
        model=P.PackedDLRM(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(12)),
        optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=1e-2),
        loss="bce", metrics=["accuracy"], num_epochs=DLRM_EPOCHS,
        batch_size=DLRM_BATCH, feature_columns=dense + cat,
        label_column="label", seed=0, shuffle=False, epoch_mode="stream",
        device="cuda")
    _reset_counts()
    hist, first_s = fit_timed(est, lambda: est.fit_on_df(
        joined.limit(DLRM_BATCH * DLRM_STEPS)))
    counts = _counts()
    losses = [h["train_loss"] for h in hist]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"13a: train loss did not fall {losses}")
    check(counts == {k: 0 for k in KERNEL_SYMBOLS},
          f"13a: the DLRM fit launched flash kernels {counts}")
    log(f"[13a] PackedDLRM(criteo_dlrm()) fit_on_df of {DLRM_STEPS} "
        f"batches of {DLRM_BATCH} window-id rows (stream): losses "
        f"{[round(v, 4) for v in losses]}, "
        f"{hist[-1]['samples_per_sec']:.0f} samples/s in the last epoch "
        f"(host clock); {first_s:.3f} s from the call to the first step")
    del est
    torch.cuda.empty_cache()


def gang_fit_factory(checkpoint_dir, epochs=GANG_FIT_EPOCHS):
    """13b's estimator factory, run in each rank after it joined the
    gang (``fit_spmd`` ships it by value; it imports this file as the
    module ``chip_smoke`` for what it uses): 10c's bf16 flash classifier
    at bert_base width and depth, batch ``GANG_FIT_BATCH`` a rank, AdamW
    2e-5, the stream path, ``epochs`` epochs, a checkpoint each epoch
    when ``checkpoint_dir`` is set (15 sets none). Its callback adds the
    rank's flash launch counts and peak device memory to every epoch's
    metrics (the class is made in the rank: the closure carrier ships no
    class of this file)."""
    def make_estimator():
        import numpy as np
        import torch
        import torch.distributed as dist

        import chip_smoke as cs
        import raydp_tpu_torch as P

        class RankProbe(P.TrainingCallback):
            def on_epoch_end(self, epoch, metrics):
                metrics["launches"] = cs._counts()
                metrics["peak_bytes"] = torch.cuda.max_memory_allocated()

        cs._reset_counts()
        torch.cuda.reset_peak_memory_stats()
        cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                          max_len=cs.GLUE_SEQ)
        return P.Estimator(
            model=P.SequenceClassifier(
                cfg, device="cuda",
                generator=torch.Generator().manual_seed(9)),
            optimizer=lambda p: torch.optim.AdamW(p, lr=2e-5,
                                                  weight_decay=1e-4),
            loss="softmax_ce", num_epochs=epochs,
            batch_size=cs.GANG_FIT_BATCH,
            feature_columns=[f"t{i}" for i in range(cs.GLUE_SEQ)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, mesh=P.MeshSpec(dp=dist.get_world_size()),
            seed=0, epoch_mode="stream", checkpoint_dir=checkpoint_dir,
            callbacks=[RankProbe()], device="cuda")

    return make_estimator


def phase_gang_fit(torch, P, session):
    """13b: ``fit_spmd`` of 10c's classifier over a gang of 2 ranks on
    the card, each reading its plan's slices of the GLUE frame from the
    session's object store. Holds the ranks' histories and parameters
    equal, each rank's 12 launches a step of each kernel, a falling loss,
    and the gang's checkpoint restored into a single-process estimator.
    Returns each rank's launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import pyarrow as pa

    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.spmd.worker_main import collective_backend
    from raydp_tpu_torch.store.object_store import DEFAULT_NODE, ObjectRef

    frame = rdf.from_arrow(pa.table(synthetic_glue(np, GANG_FIT_ROWS,
                                                   GLUE_SEQ, 30522)),
                           num_partitions=ETL_PARTS)
    ds = MLDataset.from_df(frame, num_shards=GANG_WORLD,
                           rank_nodes=[DEFAULT_NODE] * GANG_WORLD)
    check(all(isinstance(b, ObjectRef) for b in ds.blocks),
          "13b: the GLUE frame's blocks are not in the object store")
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-13b-")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    try:
        called = time.time()
        t0 = time.perf_counter()
        out = P.fit_spmd(gang_fit_factory(ckpt), ds, world_size=GANG_WORLD,
                         timeout=GANG_FIT_LIMIT_S)
        fit_s = time.perf_counter() - t0
        check(all(isinstance(b, ObjectRef) for b in ds.blocks),
              "13b: the driver read the blocks (store mode ships plans)")
        ranks = out["per_rank_history"]
        steps = GANG_FIT_EPOCHS * ds.rows_per_shard // GANG_FIT_BATCH
        want = {k: 12 * steps for k in KERNEL_SYMBOLS}
        for r, hist in enumerate(ranks):
            check(hist[-1]["launches"] == want,
                  f"13b: rank {r} counted {hist[-1]['launches']}, want "
                  f"{want}")
        losses = [[h["train_loss"] for h in hist] for hist in ranks]
        check(all(np.allclose(lo, losses[0], rtol=1e-6, atol=0)
                  for lo in losses),
              f"13b: the ranks' losses differ: {losses}")
        check(all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0],
              f"13b: train loss did not fall {losses[0]}")
        check(len(set(out["per_rank_params_sha256"])) == 1,
              f"13b: the ranks' final parameters differ (digests "
              f"{out['per_rank_params_sha256']})")
        check(out["backend"] == collective_backend(GANG_WORLD, "cuda"),
              f"13b: backend {out['backend']}, the rule says "
              f"{collective_backend(GANG_WORLD, 'cuda')}")
        cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                          max_len=GLUE_SEQ)
        fresh = P.Estimator(model=P.SequenceClassifier(cfg, device="cuda"),
                            optimizer=lambda p: torch.optim.AdamW(
                                p, lr=2e-5, weight_decay=1e-4),
                            device="cuda")
        fresh.restore(ckpt, step=GANG_FIT_EPOCHS - 1)
        restored = fresh.get_model().state_dict()
        differ = [k for k, v in out["params"].items()
                  if not torch.equal(restored[k].float().cpu(),
                                     torch.from_numpy(v).float())]
        check(not differ, f"13b: the restored checkpoint differs from the "
                          f"gang's parameters in {differ[:5]}")
        del fresh, restored
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    last = [hist[-1] for hist in ranks]
    RATES["13b_step_ms"] = [h["step_ms"] for h in last]
    RATES["13b_epoch0_step_ms"] = [hist[0]["step_ms"] for hist in ranks]
    first_at = min(hist[0]["first_step_at"] for hist in ranks)
    samples = sum(h["samples"] for h in last)
    rate = samples / max(h["time_s"] for h in last)
    log(f"[13b] fit_spmd: {GANG_WORLD} ranks, backend {out['backend']} "
        f"(the rule for {GANG_WORLD} ranks on {torch.cuda.device_count()} "
        f"card(s)), {ds.rows_per_shard} rows a rank, batch "
        f"{GANG_FIT_BATCH} a rank ({GANG_FIT_BATCH * GANG_WORLD} global), "
        f"{steps} steps; start() {out['start_s']:.3f} s; first step "
        f"{first_at - called:.3f} s after the call; fit_spmd {fit_s:.1f} s "
        f"in all (host clock)")
    check_rank_phases("13b", last)
    for r, h in enumerate(last):
        log(f"[13b] rank {r}: {h['step_ms']:.2f} ms a step, "
            f"{h['allreduce_ms']:.2f} ms of it in the gradient exchange "
            f"({h['allreduce_ms'] / h['step_ms']:.3f} of the step; CUDA "
            f"events, last epoch's mean), peak device memory "
            f"{h['peak_bytes'] / 2**30:.3f} GiB, launches {h['launches']}")
    log(f"[13b] the gang's last epoch: {samples} samples in "
        f"{max(h['time_s'] for h in last):.3f} s -> {rate:.1f} samples/s "
        f"(host clock); losses {[round(v, 4) for v in losses[0]]} on every "
        f"rank; final parameters equal on both ranks (digest "
        f"{out['per_rank_params_sha256'][0][:16]}) and in the restored "
        f"checkpoint")
    return [hist[-1]["launches"] for hist in ranks]


def phase_window_and_gang(torch, P):
    """13: a fresh 4-worker session: the window id pipeline into a DLRM
    fit (13a), then fit_spmd over the gang (13b). Returns 13b's
    per-rank launch counts."""
    from raydp_tpu_torch.store import shm

    session = P.init(app_name="chip-smoke-13", num_workers=SESSION_WORKERS)
    namespace = session.cluster.namespace
    try:
        phase_window_dlrm(torch, P, session)
        rank_counts = phase_gang_fit(torch, P, session)
    finally:
        P.stop()
    left = shm.list_segments(f"rdp-{namespace}-")
    check(not left, f"13: {len(left)} segments left after stop()")
    return rank_counts


# Phase 14: fault tolerance of training on the card, over 10c's GLUE rows
# in a fresh session's object store: a rank killed at a checkpoint step
# (14a), a preemption drained by a gang of 2 (14b, and the driver's
# notice to a running gang), an elastic resume onto one rank (14c).
# 1,024 rows at batch 64 (14a) until phase 18 came: 512 at 32 keeps 14a's
# 32 steps and halves the gloo steps of 14b and 17a.
FT_ROWS, FT_SAVE_EVERY = 512, 8
# 14's and 17a's classifier: bert_base width, 2 layers since phase 19 (12
# before; phase 19's depth): flash launches count FT_LAYERS a step.
FT_LAYERS = 2
FT_BATCH, FT_EPOCHS = 32, 2  # 14a: 16 steps an epoch
FT_GANG_BATCH, FT_GANG_EPOCHS = 32, 1  # 14b, 14c: 8 steps a rank at world 2
FT_KILL_STEP, FT_PREEMPT_STEP = 8, 6
FT_KILL_PLAN = f"kill:rank=0,step={FT_KILL_STEP}"
FT_PREEMPT_PLAN = f"preempt:step={FT_PREEMPT_STEP},grace=0"
FT_GRACE_S = 30.0  # RAYDP_TPU_PREEMPT_GRACE_S's default
FT_LIMIT_S = 600.0
_DRAINED_RE = r"preempted at step (\d+) \(epoch \d+, batch \d+\); emergency " \
              r"checkpoint: \S+ \(drained in ([0-9.]+) s\)"


def ft_factory(checkpoint_dir, batch, epochs, save_every_steps=0):
    """14's estimator factory, run in a rank (``fit_spmd`` ships it by
    value) or in this process: 13b's bf16 flash classifier at bert_base
    width and ``FT_LAYERS`` layers, AdamW 2e-5, the stream path, dropout 0.1. Its
    callback adds to every epoch's metrics the process's flash launch
    counts and peak device memory, the wall-clock time its fit's first
    step finished (``probe_first_step_at``, after a synchronize), the
    per-rank batches the fit skipped on resume (``resume_skip``) and each
    checkpoint written so far with its seconds and bytes (``saves``)."""
    def make_estimator():
        import os

        import numpy as np
        import torch
        import torch.distributed as dist

        import chip_smoke as cs
        import raydp_tpu_torch as P

        saves, first = [], []

        class RankProbe(P.TrainingCallback):
            def on_epoch_end(self, epoch, metrics):
                metrics["launches"] = cs._counts()
                metrics["peak_bytes"] = torch.cuda.max_memory_allocated()
                metrics["probe_first_step_at"] = first[0] if first else None
                metrics["resume_skip"] = est.resume_skip
                metrics["saves"] = list(saves)

        cs._reset_counts()
        torch.cuda.reset_peak_memory_stats()
        world = dist.get_world_size() if dist.is_initialized() else 1
        cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                          max_len=cs.GLUE_SEQ, n_layers=cs.FT_LAYERS)
        est = P.Estimator(
            model=P.SequenceClassifier(
                cfg, device="cuda",
                generator=torch.Generator().manual_seed(9)),
            optimizer=lambda p: torch.optim.AdamW(p, lr=2e-5,
                                                  weight_decay=1e-4),
            loss="softmax_ce", num_epochs=epochs, batch_size=batch,
            feature_columns=[f"t{i}" for i in range(cs.GLUE_SEQ)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, mesh=P.MeshSpec(dp=world), seed=0,
            epoch_mode="stream", checkpoint_dir=checkpoint_dir,
            save_every_steps=save_every_steps, callbacks=[RankProbe()],
            device="cuda")
        step, save = est._train_step, est.save

        def probed_step(x, y):
            out = step(x, y)
            if not first:
                torch.cuda.synchronize()
                first.append(time.time())
            return out

        def timed_save(directory, step=None, data_position=None):
            t0 = time.perf_counter()
            path = save(directory, step=step, data_position=data_position)
            saves.append((os.path.basename(path), time.perf_counter() - t0,
                          os.path.getsize(path)))
            return path

        est._train_step = probed_step
        est.save = timed_save
        return est

    return make_estimator


def gang_train_until_preempted(ctx, tables, checkpoint_dir, marker):
    """14b's rank body for the driver's notice: join the gang, train
    ``ft_factory``'s classifier on the rank's tables for far more epochs
    than the phase waits (rank 0 creates ``marker`` once its first step
    is done), and end by draining the notice (``PreemptionError``)."""
    import torch

    import chip_smoke as cs
    from raydp_tpu_torch.data import MLDataset

    torch.cuda.set_device(ctx.device("cuda"))
    ctx.init_distributed(device="cuda")
    est = cs.ft_factory(checkpoint_dir, cs.FT_GANG_BATCH, 1000)()
    step = est._train_step

    def marked_step(x, y):
        out = step(x, y)
        if ctx.rank == 0 and not os.path.exists(marker):
            open(marker, "w").close()
        return out

    est._train_step = marked_step
    est.fit(MLDataset(list(tables), num_shards=1))


def _drains(failure):
    """(step, drain seconds) of every rank's ``PreemptionError`` in a
    supervisor's failure text."""
    import re

    return [(int(s), float(t))
            for s, t in re.findall(_DRAINED_RE, failure)]


def _params_equal(torch, got, want):
    """Names of the parameters that differ bit for bit."""
    return [k for k, w in want.items()
            if not torch.equal(torch.from_numpy(got[k]),
                               torch.from_numpy(w))]


def _recovery(out, tag):
    """Recovery seconds of a supervised fit's one failure: from the
    supervisor seeing it to the resumed run's first step (every rank's
    probe, the earliest), with the backoff slept in between."""
    (failure,) = out["failures"]
    first = min(hist[0]["probe_first_step_at"]
                for hist in out["per_rank_history"])
    check(first is not None, f"{tag}: the resumed run took no step")
    return first - failure["at"], failure["backoff_s"]


def phase_ft_kill(torch, P, ds1):
    """14a: rank 0 of a 1-rank ``fit_spmd`` killed right after
    ``step_mid_8.pt`` commits; the relaunch resumes there and must end
    with a clean in-process fit's parameters bit for bit. Returns the
    launch counts of the clean fit and of the resumed rank."""
    import shutil
    import tempfile

    steps = FT_EPOCHS * FT_ROWS // FT_BATCH
    torch.cuda.synchronize()
    clean_est = ft_factory(None, FT_BATCH, FT_EPOCHS)()
    clean_hist = clean_est.fit(ds1)
    torch.cuda.synchronize()
    clean_counts = clean_hist[-1]["launches"]
    want = {k: FT_LAYERS * steps for k in KERNEL_SYMBOLS}
    check(clean_counts == want, f"14a: the clean fit counted "
                                f"{clean_counts}, want {want}")
    clean = {k: (v.detach().float() if v.dtype == torch.bfloat16
                 else v.detach()).cpu().numpy()
             for k, v in clean_est.get_model().state_dict().items()}
    del clean_est
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-14a-")
    try:
        t0 = time.perf_counter()
        out = P.fit_spmd(ft_factory(ckpt, FT_BATCH, FT_EPOCHS,
                                    FT_SAVE_EVERY), ds1, world_size=1,
                         env={"RAYDP_TPU_FAULT_PLAN": FT_KILL_PLAN},
                         checkpoint_dir=ckpt, timeout=FT_LIMIT_S)
        fit_s = time.perf_counter() - t0
        mid = os.path.join(ckpt, f"step_mid_{FT_KILL_STEP}.pt")
        check(os.path.exists(mid), f"14a: no {os.path.basename(mid)}")
        mid_bytes = os.path.getsize(mid)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(out["restarts"] == 1, f"14a: {out['restarts']} restarts, want 1")
    (failure,) = out["failures"]
    check("exited with code 23" in failure["error"],
          f"14a: the failure is not the injected kill: "
          f"{failure['error'][:300]}")
    hist = out["history"]
    resumed_steps = sum(h["samples"] for h in hist) // FT_BATCH
    replayed = FT_KILL_STEP + resumed_steps - steps
    check(replayed == 0, f"14a: {replayed} steps replayed, want 0")
    check(hist[-1]["train_loss"] == clean_hist[-1]["train_loss"],
          f"14a: last epoch's loss {hist[-1]['train_loss']} != the clean "
          f"fit's {clean_hist[-1]['train_loss']}")
    differ = _params_equal(torch, out["params"], clean)
    check(not differ, f"14a: the resumed fit's parameters differ from the "
                      f"clean fit's in {len(differ)} tensors, e.g. "
                      f"{differ[:4]}")
    counts = hist[-1]["launches"]
    want = {k: FT_LAYERS * resumed_steps for k in KERNEL_SYMBOLS}
    check(counts == want, f"14a: the resumed rank counted {counts}, want "
                          f"{want}")
    recovery, backoff = _recovery(out, "14a")
    log(f"[14a] kill:rank=0,step={FT_KILL_STEP} under fit_spmd(world_size="
        f"1): {FT_ROWS} rows, batch {FT_BATCH}, {FT_EPOCHS} epochs ({steps} "
        f"steps), save_every_steps={FT_SAVE_EVERY}; restarts "
        f"{out['restarts']}, replayed steps {replayed}; recovery "
        f"{recovery:.3f} s from the supervisor seeing the rank's exit to "
        f"the resumed run's first step, {backoff:.3f} s of it the backoff "
        f"(host clock); fit_spmd {fit_s:.1f} s in all; final parameters "
        f"equal to the clean in-process fit's (torch.equal), last epoch's "
        f"loss {hist[-1]['train_loss']:.6f} on both; "
        f"{os.path.basename(mid)} {mid_bytes / 2**30:.3f} GiB")
    for name, secs, nbytes in hist[-1]["saves"]:
        log(f"[14a] the resumed rank wrote {name}: {nbytes / 2**30:.3f} GiB "
            f"in {secs:.3f} s ({nbytes / 2**30 / secs:.2f} GiB/s, host "
            f"clock)")
    log(f"[14a] peak device memory: rank {hist[-1]['peak_bytes'] / 2**30:.3f} "
        f"GiB, the clean fit {clean_hist[-1]['peak_bytes'] / 2**30:.3f} GiB")
    return clean_counts, counts


def phase_ft_preempt(torch, P, ds2):
    """14b: ``preempt:step=6,grace=0`` under a 2-rank ``fit_spmd``: both
    ranks drain after step 6 to ``step_emergency_6.pt``, the supervisor
    counts a preemption and a restart, and the resumed gang ends equal to
    a clean gang run; then ``SPMDJob.request_preemption()`` on a running
    gang. Returns (the clean gang's result, launch counts by tag, the
    copied checkpoint's path)."""
    import shutil
    import tempfile
    import threading

    from raydp_tpu_torch.spmd import create_spmd_job
    from raydp_tpu_torch.spmd.job import SPMDJobError
    from raydp_tpu_torch.utils.profiling import metrics

    steps = FT_GANG_EPOCHS * ds2.rows_per_shard // FT_GANG_BATCH
    counts = {}
    clean = P.fit_spmd(ft_factory(None, FT_GANG_BATCH, FT_GANG_EPOCHS), ds2,
                       world_size=GANG_WORLD, timeout=FT_LIMIT_S)
    check(clean["restarts"] == 0, "14b: the clean gang restarted")
    for r, hist in enumerate(clean["per_rank_history"]):
        counts[f"14b clean rank {r}"] = hist[-1]["launches"]
    before = metrics.snapshot().get("counters", {})
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-14b-")
    keep = tempfile.mkdtemp(prefix="chip-smoke-14c-")
    try:
        t0 = time.perf_counter()
        out = P.fit_spmd(ft_factory(ckpt, FT_GANG_BATCH, FT_GANG_EPOCHS),
                         ds2, world_size=GANG_WORLD,
                         env={"RAYDP_TPU_FAULT_PLAN": FT_PREEMPT_PLAN},
                         checkpoint_dir=ckpt, timeout=FT_LIMIT_S)
        fit_s = time.perf_counter() - t0
        emergency = os.path.join(ckpt, f"step_emergency_{FT_PREEMPT_STEP}.pt")
        check(os.path.exists(emergency), f"14b: no {emergency}")
        state = torch.load(emergency, map_location="cpu", weights_only=True)
        where = (state["data_world"], state["data_epoch"], state["data_batch"])
        check(where == (GANG_WORLD, 0, FT_PREEMPT_STEP),
              f"14b: the emergency checkpoint records (world, epoch, batch) "
              f"{where}")
        del state
        emergency_bytes = os.path.getsize(emergency)
        shutil.copy(emergency, keep)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    after = metrics.snapshot()["counters"]
    grew = {n: after.get(n, 0) - before.get(n, 0)
            for n in ("preemptions/total", "restarts/total")}
    check(out["restarts"] == 1 and grew == {"preemptions/total": 1,
                                            "restarts/total": 1},
          f"14b: restarts {out['restarts']}, counters grew by {grew}")
    (failure,) = out["failures"]
    drains = _drains(failure["error"])
    check(failure["preempted"] and [s for s, _ in drains]
          == [FT_PREEMPT_STEP] * GANG_WORLD,
          f"14b: the ranks drained at {drains}, want step "
          f"{FT_PREEMPT_STEP} on {GANG_WORLD} ranks: "
          f"{failure['error'][:400]}")
    check(len(set(out["per_rank_params_sha256"])) == 1,
          "14b: the resumed ranks' parameters differ")
    differ = _params_equal(torch, out["params"], clean["params"])
    check(not differ, f"14b: the resumed gang's parameters differ from the "
                      f"clean gang's in {len(differ)} tensors, e.g. "
                      f"{differ[:4]}")
    resumed = steps - FT_PREEMPT_STEP
    for r, hist in enumerate(out["per_rank_history"]):
        want = {k: FT_LAYERS * resumed for k in KERNEL_SYMBOLS}
        check(hist[-1]["launches"] == want,
              f"14b: resumed rank {r} counted {hist[-1]['launches']}, want "
              f"{want}")
        counts[f"14b resumed rank {r}"] = hist[-1]["launches"]
    recovery, backoff = _recovery(out, "14b")
    log(f"[14b] {FT_PREEMPT_PLAN} under fit_spmd(world_size={GANG_WORLD}): "
        f"{FT_ROWS} rows, batch {FT_GANG_BATCH} a rank, {steps} steps; both "
        f"ranks drained after step {FT_PREEMPT_STEP}, drain seconds "
        f"{[round(t, 3) for _, t in drains]} by rank (the notice at the "
        f"step boundary to the emergency checkpoint committed, host clock; "
        f"the grace is {FT_GRACE_S:.0f} s by default) for "
        f"{emergency_bytes / 2**30:.3f} GiB; recovery {recovery:.3f} s "
        f"from the supervisor seeing the drain to the resumed gang's first "
        f"step, {backoff:.3f} s of it the backoff; fit_spmd {fit_s:.1f} s; "
        f"counters grew by {grew}; the resumed ranks equal to each other "
        f"and to the clean gang (torch.equal)")
    for r, (c, o) in enumerate(zip(clean["per_rank_history"],
                                   out["per_rank_history"])):
        log(f"[14b] rank {r}: peak device memory {c[-1]['peak_bytes'] / 2**30:.3f} "
            f"GiB (clean), {o[-1]['peak_bytes'] / 2**30:.3f} GiB (resumed); "
            f"{c[-1]['step_ms']:.2f} ms a step (clean, CUDA events)")

    # The driver's notice to a running gang (the real notice path).
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-14b-notice-")
    marker = os.path.join(ckpt, "training")
    job = create_spmd_job("smoke-preempt", world_size=GANG_WORLD, timeout=60)
    outcome = {}

    def run():
        try:
            job.run(gang_train_until_preempted, timeout=FT_LIMIT_S,
                    per_rank_args=[(ds2.shard_tables(r), ckpt, marker)
                                   for r in range(GANG_WORLD)])
            outcome["error"] = "the gang finished without a notice"
        except SPMDJobError as exc:
            outcome["error"] = str(exc)

    try:
        job.start()
        runner = threading.Thread(target=run, daemon=True)
        runner.start()
        deadline = time.monotonic() + FT_LIMIT_S
        while not os.path.exists(marker) and runner.is_alive():
            check(time.monotonic() < deadline, "14b: the gang never trained")
            time.sleep(0.05)
        t0 = time.perf_counter()
        job.request_preemption()
        call_s = time.perf_counter() - t0
        runner.join(FT_LIMIT_S)
        check(not runner.is_alive(), "14b: the gang did not drain the notice")
        notice_drains = _drains(outcome["error"])
        files = sorted(n for n in os.listdir(ckpt) if n.endswith(".pt"))
    finally:
        job.stop()
        shutil.rmtree(ckpt, ignore_errors=True)
    check(len(notice_drains) == GANG_WORLD
          and len({s for s, _ in notice_drains}) == 1,
          f"14b: request_preemption drained {notice_drains}: "
          f"{outcome['error'][:400]}")
    check(files == [f"step_emergency_{notice_drains[0][0]}.pt"],
          f"14b: request_preemption left {files}")
    check(call_s < FT_GRACE_S, f"14b: request_preemption took {call_s:.1f} s")
    log(f"[14b] SPMDJob.request_preemption() on a running {GANG_WORLD}-rank "
        f"gang returned in {call_s * 1e3:.1f} ms; both ranks drained after "
        f"step {notice_drains[0][0]} in {[round(t, 3) for _, t in notice_drains]} "
        f"s into {files[0]}")
    return clean, counts, os.path.join(keep, os.path.basename(emergency))


def phase_ft_elastic(torch, P, ds2, emergency, clean_loss):
    """14c: 14b's ``step_emergency_6.pt`` alone in a fresh directory,
    resumed by ``fit_spmd(world_size=1, elastic=True)`` over the same
    2-shard dataset: the skip rescaled from 6 batches at world 2 to 12 at
    world 1, 4 steps of 32 rows trained. Returns the rank's counts."""
    import shutil

    import numpy as np

    ckpt = os.path.dirname(emergency)
    try:
        called = time.time()
        out = P.fit_spmd(ft_factory(None, FT_GANG_BATCH, FT_GANG_EPOCHS), ds2,
                         world_size=1, elastic=True, checkpoint_dir=ckpt,
                         timeout=FT_LIMIT_S)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(out["world_size"] == 1 and out["restarts"] == 0,
          f"14c: world {out['world_size']}, restarts {out['restarts']}")
    (h,) = out["history"]
    skip = FT_PREEMPT_STEP * GANG_WORLD
    steps = FT_ROWS // FT_GANG_BATCH - skip
    check(h["resume_skip"] == skip, f"14c: skipped {h['resume_skip']} "
                                    f"batches, want {skip}")
    check(h["samples"] == steps * FT_GANG_BATCH,
          f"14c: trained {h['samples']} rows, want {steps * FT_GANG_BATCH}")
    want = {k: FT_LAYERS * steps for k in KERNEL_SYMBOLS}
    check(h["launches"] == want, f"14c: counted {h['launches']}, want {want}")
    check(np.isfinite(h["train_loss"]), f"14c: loss {h['train_loss']}")
    log(f"[14c] fit_spmd(world_size=1, elastic=True) from "
        f"{os.path.basename(emergency)}: skip rescaled from "
        f"{FT_PREEMPT_STEP} batches at world {GANG_WORLD} to "
        f"{h['resume_skip']} at world 1, {steps} steps of {FT_GANG_BATCH} "
        f"rows ({h['samples']}); epoch loss {h['train_loss']:.4f} (the "
        f"resumed part; 14b's clean epoch {clean_loss:.4f}); "
        f"{h['probe_first_step_at'] - called:.3f} s from the call to the "
        f"first step (host clock); peak device memory "
        f"{h['peak_bytes'] / 2**30:.3f} GiB")
    return h["launches"]


def phase_fault_tolerance(torch, P):
    """14: a fresh 4-worker session holding 10c's GLUE rows; 14a, 14b
    and 14c over them (store mode), 18b over them, then 17a-b in the
    same session
    (its victim 14b's configuration, held against 14b's clean gang).
    Returns launch counts by tag and 17b's replica flash launches."""
    import numpy as np
    import pyarrow as pa

    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.store import shm
    from raydp_tpu_torch.store.object_store import DEFAULT_NODE, ObjectRef

    t0 = time.perf_counter()
    session = P.init(app_name="chip-smoke-14", num_workers=SESSION_WORKERS)
    namespace = session.cluster.namespace
    try:
        frame = rdf.from_arrow(pa.table(synthetic_glue(np, FT_ROWS, GLUE_SEQ,
                                                       30522)),
                               num_partitions=ETL_PARTS)
        ds1 = MLDataset.from_df(frame, num_shards=1)
        ds2 = MLDataset.from_df(frame, num_shards=GANG_WORLD,
                                rank_nodes=[DEFAULT_NODE] * GANG_WORLD)
        check(all(isinstance(b, ObjectRef) for b in ds2.blocks),
              "14: the GLUE frame's blocks are not in the object store")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the ranks share the card
        clean_counts, kill_counts = phase_ft_kill(torch, P, ds1)
        counts = {"14a clean fit": clean_counts,
                  "14a resumed rank 0": kill_counts}
        clean, preempt_counts, emergency = phase_ft_preempt(torch, P, ds2)
        counts.update(preempt_counts)
        counts["14c rank 0"] = phase_ft_elastic(
            torch, P, ds2, emergency, clean["history"][-1]["train_loss"])
        log(f"[14] fault tolerance: {time.perf_counter() - t0:.1f} s "
            f"(host clock)")
        t0 = time.perf_counter()
        counts.update(phase_compat_gang(torch, P, frame))
        log(f"[18b] {time.perf_counter() - t0:.1f} s (host clock)")
        t0 = time.perf_counter()
        cp_counts, replica_launches = phase_control_plane(
            torch, P, session, ds2, clean)
        counts.update(cp_counts)
    finally:
        P.stop()
    left = shm.list_segments(f"rdp-{namespace}-")
    check(not left, f"14: {len(left)} segments left after stop()")
    log(f"[17a-b] {time.perf_counter() - t0:.1f} s (host clock)")
    return counts, replica_launches


# Phase 15: the trace, accounting and health planes of telemetry over one
# run: a fresh session's ETL on its workers into a 2-rank fit_spmd of
# 13b's classifier, traced, billed and watched.
TELEMETRY_ROWS = 1024  # 16 steps a rank at batch 32
TELEMETRY_LIMIT_S = 600.0
# Each rank's shipped hbm/peak_bytes against its allocator peak.
BILLING_TOL = 0.10
# The fit's chip-seconds are its ranks' epoch seconds by construction
# (each epoch bills its own wall interval), so 15 holds them equal to
# the histories' and, on the driver's own clock, between this share of
# the world times the launch's run() and all of it: the rest of a run
# is its set-up (building bert_base, joining the group, reading the
# plan).
RUN_SHARE_MIN = 0.5
# Seconds the shards and the merged view are given to catch up: a worker
# beats every 2 s, a rank every 5 s.
TELEMETRY_WAIT_S = 30.0
# The step times of earlier runs of this script that 15 prints beside
# this run's (PERF.md's figures; H100 80GB HBM3, 700.00 W): 13b's ms a
# step, and 4b's on the stream and the scan path.
EARLIER_13B_STEP_MS = "531.9-532.3"
EARLIER_4B_STREAM_MS, EARLIER_4B_SCAN_MS = "28.3-30.0", "14.10-14.12"


def telemetry_stage(table):
    """15's narrow stage, run on the workers: the rows whose label is a
    class (all of 10c's)."""
    import pyarrow.compute as pc

    return table.filter(pc.greater_equal(table["label"], 0))


def _wait_for(predicate, timeout_s=TELEMETRY_WAIT_S, interval_s=0.5):
    deadline = time.monotonic() + timeout_s
    while True:
        value = predicate()
        if value or time.monotonic() >= deadline:
            return value
        time.sleep(interval_s)


def _http_status(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            return resp.status
    except urllib.error.HTTPError as err:
        return err.code


def _check_one_trace(records, ranks, workers):
    """15's trace holds: one root, every record in its trace, the
    driver (and the master it hosts), two or more ETL workers and both
    ranks present, 16 steps a rank, no rank span a root of its own.
    Returns the trace id and the rank processes' pids."""
    roots = [r for r in records if r["name"] == "cluster/job"]
    check(len(roots) == 1, f"15: {len(roots)} session roots in the shards")
    trace_id, driver = roots[0]["trace_id"], roots[0]["pid"]
    stray = sorted({r["name"] for r in records
                    if r.get("trace_id") != trace_id})
    check(not stray, f"15: records outside the session's trace: {stray}")
    check(any(r["pid"] == driver and r["name"].startswith("cluster/worker_")
              for r in records),
          "15: no span of the master (worker lifecycle) in the shards")
    task_workers = {r["attrs"].get("worker_id") for r in records
                    if r["name"] == "worker/task"}
    check(len(task_workers & set(workers)) >= 2,
          f"15: worker/task spans from {sorted(task_workers)} only")
    rank_pids = {r["attrs"]["rank"]: r["pid"] for r in records
                 if r["name"] == "spmd/func"}
    check(sorted(rank_pids) == list(range(GANG_WORLD)),
          f"15: spmd/func spans of ranks {sorted(rank_pids)}")
    for rank, pid in rank_pids.items():
        steps = sum(r["name"] == "train/step" and r["pid"] == pid
                    for r in records)
        check(steps == ranks, f"15: rank {rank} has {steps} train/step "
                              f"spans, want {ranks}")
        roots = [r["name"] for r in records
                 if r["pid"] == pid and r.get("parent_id") is None]
        check(not roots, f"15: rank {rank} started traces: {roots[:5]}")
    return trace_id, rank_pids


def phase_telemetry(torch, P):
    """15: one run traced, billed and watched (module docstring). Returns
    each rank's launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import pyarrow as pa

    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.store import shm
    from raydp_tpu_torch.store.object_store import DEFAULT_NODE, ObjectRef
    from raydp_tpu_torch.telemetry import (
        accounting,
        analyze,
        chrome_trace,
        export,
        flight_recorder,
        recorder,
        render_prometheus,
        serve_prometheus,
    )
    from raydp_tpu_torch.utils.profiling import metrics

    tdir = tempfile.mkdtemp(prefix="chip-smoke-15-telemetry-")
    pdir = tempfile.mkdtemp(prefix="chip-smoke-15-postmortem-")
    env = {export.TELEMETRY_DIR_ENV: tdir,
           flight_recorder.POSTMORTEM_DIR_ENV: pdir}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    # This process's span ring holds the earlier phases' spans (other
    # traces) and its default job is an earlier phase's ETL job: 15
    # starts from neither, so its shards hold one run and the fit is an
    # accounting root of its own.
    recorder.clear()
    accounting.set_process_job(None)
    t0, wall0 = time.perf_counter(), time.time()
    session = P.init(app_name="chip-smoke-15", num_workers=SESSION_WORKERS)
    namespace = session.cluster.namespace
    server = None
    try:
        cl = session.cluster
        workers = sorted(w.worker_id for w in cl.alive_workers())
        etl_job = accounting.mint_job("etl")
        with accounting.job_scope(etl_job):
            frame = rdf.from_arrow(
                pa.table(synthetic_glue(np, TELEMETRY_ROWS, GLUE_SEQ,
                                        30522)),
                num_partitions=ETL_PARTS).mapPartitions(telemetry_stage)
            labels = frame.groupBy("label").count().to_pandas()
            check(int(labels["count"].sum()) == TELEMETRY_ROWS,
                  f"15: the label counts sum to {labels['count'].sum()}")
            ds = MLDataset.from_df(frame, num_shards=GANG_WORLD,
                                   rank_nodes=[DEFAULT_NODE] * GANG_WORLD)
        check(all(isinstance(b, ObjectRef) for b in ds.blocks),
              "15: the frame's blocks are not in the object store")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the ranks share the card
        steps = ds.rows_per_shard // GANG_FIT_BATCH
        _reset_counts()
        out = P.fit_spmd(gang_fit_factory(None, epochs=1), ds,
                         world_size=GANG_WORLD, timeout=TELEMETRY_LIMIT_S)
        driver_counts = _counts()
        fit_id = out["job_id"]
        last = [hist[-1] for hist in out["per_rank_history"]]
        want = {k: 12 * steps for k in KERNEL_SYMBOLS}
        for r, h in enumerate(last):
            check(h["launches"] == want, f"15: rank {r} counted "
                                         f"{h['launches']}, want {want}")
        check(not any(driver_counts.values()),
              f"15: the driver launched kernels {driver_counts}")

        # One trace: the workers flush their rings on their beats.
        def flushed():
            recs = chrome_trace.load_span_records(tdir)
            ids = {r["attrs"].get("worker_id") for r in recs
                   if r["name"] == "worker/task"}
            return recs if len(ids & set(workers)) >= 2 else None

        report = cl.trace_report()  # flushes this process's ring first
        records = _wait_for(flushed) or chrome_trace.load_span_records(tdir)
        trace_id, rank_pids = _check_one_trace(records, steps, workers)
        wall1 = time.time()
        out_path = chrome_trace.write_chrome_trace(tdir)
        with open(out_path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        offsets = chrome_trace.clock_offsets(records)
        outside = [r["name"] for r in records
                   if not wall0 - 1.0
                   <= chrome_trace.aligned_interval(r, offsets)[0]
                   <= wall1 + 1.0]
        check(not outside, f"15: records outside the phase's wall window: "
                           f"{outside[:5]}")
        offset_spread = max(offsets.values()) - min(offsets.values())

        # analyze: the critical path, the skew table, data against compute.
        check(report is not None and report["critical_path"],
              "15: trace_report() gave no critical path")
        skew = report["step_skew"]["ranks"]
        check({k: v["steps"] for k, v in skew.items()
               if k.startswith("rank")}
              == {f"rank {r}": steps for r in range(GANG_WORLD)},
              f"15: the skew table {skew}")
        split = report["data_compute"]
        check(all(split.get(f"rank {r}", {}).get("compute_s", 0) > 0
                  and split[f"rank {r}"]["data_s"] > 0
                  for r in range(GANG_WORLD)),
              f"15: data-wait against compute {split}")
        cli = subprocess.run(
            [sys.executable, "-m", "raydp_tpu_torch.telemetry.analyze",
             tdir], cwd=ROOT, capture_output=True, text=True, timeout=120)
        check(cli.returncode == 0, f"15: the analyze CLI exited "
                                   f"{cli.returncode}: {cli.stderr[-500:]}")

        # Billing: the gang's and the session's ledgers, exactly the
        # ranks' epochs (shipping loses nothing), and inside the world
        # times the launch's run() on the driver's clock.
        wall_s = sum(h["time_s"] for h in last)
        run_world_s = GANG_WORLD * out["run_s"]
        session_usage = cl.usage_report()["jobs"]
        for where, usage in (("gang", out["usage"]["jobs"]),
                             ("session", session_usage)):
            chip = usage.get(fit_id, {}).get("usage", {}).get(
                "chip_seconds", 0.0)
            check(chip > 0 and chip == wall_s,
                  f"15: the {where}'s fit-spmd chip-seconds {chip!r}, the "
                  f"ranks' epochs {wall_s!r} s")
        check(RUN_SHARE_MIN * run_world_s <= wall_s <= run_world_s,
              f"15: the ranks' epochs {wall_s} s against {GANG_WORLD} x "
              f"run() {out['run_s']} s on the driver's clock")
        etl = session_usage.get(etl_job.job_id, {}).get("usage", {})
        check(etl.get("task_seconds", 0) > 0
              and etl.get("shuffle_bytes", 0) + etl.get("staged_bytes", 0)
              > 0, f"15: the etl job's usage {etl}")
        fit_usage = session_usage[fit_id]["usage"]

        # The exposition, the gauges, the debug endpoint.
        view = cl.metrics_snapshot()
        text = render_prometheus(view)
        for needle in ('name="worker/task"', 'name="train/step"',
                       f'raydp_job_chip_seconds_total{{job="{fit_id}"',
                       "raydp_hbm_bytes"):
            check(needle in text, f"15: {needle} not in the exposition")
        for r, h in enumerate(last):
            got = (out["metrics"]["workers"].get(f"rank-{r}", {})
                   .get("gauges", {}).get("hbm/peak_bytes", 0.0))
            check(abs(got - h["peak_bytes"]) <= BILLING_TOL
                  * h["peak_bytes"],
                  f"15: rank {r} shipped hbm/peak_bytes {got}, its peak "
                  f"{h['peak_bytes']}")
        health = cl.health_report()
        check(health["healthy"] and not health["stalled_workers"],
              f"15: health before the kill {health}")
        server = serve_prometheus(
            cl.prometheus_metrics, 0, host="127.0.0.1",
            health=cl.health_report,
            profile=lambda seconds: cl.capture_profile(seconds) or {},
            dashboard=cl.dashboard_report)
        base = f"http://127.0.0.1:{server.port}"
        codes = {p: _http_status(base + p) for p in ("/metrics", "/healthz")}
        check(codes == {"/metrics": 200, "/healthz": 200},
              f"15: the debug endpoint answered {codes}")
        check_cluster_observability(cl, base)
        check_rank_phases("15", last)

        # Events: the gang's lifecycle in order, under the fit's job.
        timeline = cl.events_report(job=fit_id)["events"]
        names = [e["name"] for e in timeline]
        check("gang/launch" in names and "gang/teardown" in names
              and names.index("gang/launch") < names.index("gang/teardown"),
              f"15: the fit's events {names}")
        check(all(e.get("job") == fit_id for e in timeline),
              "15: an event of the fit's timeline names another job")

        # Spans and drops a process, before the kill.
        by_pid = {}
        for r in records:
            by_pid[r["pid"]] = by_pid.get(r["pid"], 0) + 1
        labels_by_pid = chrome_trace.process_labels(records)
        dropped = {"driver": metrics.snapshot()["counters"].get(
            "spans/dropped", 0.0)}
        for wid, sec in view["workers"].items():
            dropped[wid] = sec.get("counters", {}).get("spans/dropped", 0.0)
        shard_bytes = {}
        for name in os.listdir(tdir):
            if not name.endswith(".jsonl"):
                continue  # trace.json: the merged output, not a shard
            kind = name.split("-", 1)[0].split(".", 1)[0]
            shard_bytes[kind] = (shard_bytes.get(kind, 0)
                                 + os.path.getsize(os.path.join(tdir, name)))

        # Health: SIGTERM a worker; its bundle, its respawn, the report.
        victim = workers[0]
        victim_pid = health["workers"][victim]["pid"]
        cl._procs[victim].terminate()
        bundles = _wait_for(lambda: [
            n for n in os.listdir(pdir)
            if n.startswith(f"postmortem-{victim_pid}-")
            and n.endswith(".json")])
        check(bool(bundles), f"15: no postmortem bundle of {victim}")
        bundle = flight_recorder.read_bundle(os.path.join(pdir, bundles[0]))
        check(bundle["reason"] == "SIGTERM"
              and bundle["component"] == "worker"
              and bundle["events"]
              and any("MainThread" in k for k in bundle["stacks"]),
              f"15: the bundle {bundle.get('reason')}, "
              f"{bundle.get('component')}, {len(bundle.get('events', []))} "
              f"events, stacks {list(bundle.get('stacks', {}))[:4]}")
        respawned = _wait_for(lambda: len(
            [w for w in cl.alive_workers() if w.worker_id != victim])
            == SESSION_WORKERS, timeout_s=RESPAWN_WAIT_S)
        check(respawned, f"15: {victim} was not respawned")
        after = cl.health_report()
        check(victim in after["dead_workers"],
              f"15: health_report() does not name {victim}: "
              f"{after['dead_workers']}")
    finally:
        if server is not None:
            server.close()
        P.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tdir, ignore_errors=True)
        shutil.rmtree(pdir, ignore_errors=True)
    left = shm.list_segments(f"rdp-{namespace}-")
    check(not left, f"15: {len(left)} segments left after stop()")
    phase_s = time.perf_counter() - t0
    log(f"[15] one trace {trace_id}: {len(records)} records from "
        f"{len(by_pid)} processes; clock offsets spread "
        f"{offset_spread:.6f} s; the Chrome trace {len(events)} events")
    for pid, n in sorted(by_pid.items()):
        log(f"[15] {labels_by_pid.get(pid, pid)} (pid {pid}): {n} spans "
            f"and events in the shards")
    log(f"[15] dropped spans by process (counters): {dropped}; shard "
        f"bytes by kind {shard_bytes}")
    log(f"[15] fit-spmd job {fit_id}: {fit_usage}; the ranks' epochs "
        f"{wall_s:.3f} s summed, {wall_s / run_world_s:.4f} of "
        f"{GANG_WORLD} x run() {out['run_s']:.3f} s; etl job: {etl}")
    log(f"[15] critical path {[s['name'] for s in report['critical_path']]}; "
        f"skew {report['step_skew'].get('skew_p50')}; data/compute "
        f"{ {k: v for k, v in split.items() if k.startswith('rank')} }")
    nan = [float("nan")] * GANG_WORLD
    for r, h in enumerate(last):
        # 15 runs one epoch, so its mean holds the first step; 13b's
        # epoch 0 does too, its last epoch does not.
        log(f"[15] rank {r}: {h['step_ms']:.2f} ms a step (CUDA events, "
            f"telemetry on, one epoch; 13b in this run: epoch 0 "
            f"{RATES.get('13b_epoch0_step_ms', nan)[r]:.2f}, last epoch "
            f"{RATES.get('13b_step_ms', nan)[r]:.2f}; earlier runs' 13b "
            f"{EARLIER_13B_STEP_MS}), peak {h['peak_bytes'] / 2**30:.3f} GiB, "
            f"launches {h['launches']}")
    log(f"[15] 4b with the planes on: stream "
        f"{RATES.get('4b_stream_ms', float('nan')):.3f} ms a step (earlier "
        f"runs {EARLIER_4B_STREAM_MS}), scan "
        f"{RATES.get('4b_scan_ms', float('nan')):.3f} (earlier runs "
        f"{EARLIER_4B_SCAN_MS}; CUDA events)")
    log(f"[15] telemetry phase {phase_s:.1f} s (host clock)")
    return [h["launches"] for h in last]


# Phase 16: the device plane. 16a 4b's stream fine-tune with the plane on
# (its step phases, MFU, a step's FLOPs, bound), and with it off; 16b a
# NaN in the loss tripping the sentinel; 16c trace captures across 12b's
# gang and 15's session, resource_report, /debug/profile and
# /debug/dashboard (run inside 12b and 15); 13b's and 15's ranks' split.
PLANE_STEPS = 20
PLANE_AB_RUNS = ("on", "off", "off", "on", "on", "off")
# 16a's FLOPs of a step, counted on the meta device, against the closed
# form.
FLOP_TOL = 0.05
# 16a: the plane's own host work a step, timed alone around one tiny
# kernel over this many steps a run, held under this share of 4b's eager
# step.
PLANE_COST_STEPS, PLANE_COST_SHARE = 2000, 0.01
# 16b: the sentinel checks every 4th step; the NaN enters the loss at 6.
NAN_STEP, NAN_STEPS, SENTINEL_EVERY = 6, 8, 4
# 16c: the gang's probe fit, then its scoring loop (in flight while the
# driver captures; large batches, so a 2 s trace of two ranks stays tens
# of thousands of kernel events, not hundreds of thousands), and the
# captures' windows.
PROBE_STEPS, PROBE_SCORE_S, PROBE_SCORE_BATCH = 8, 8.0, 256
GANG_CAPTURE_S, CLUSTER_CAPTURE_S = 2.0, 1.0
# 13b's and 15's ranks: the plane's collective share against the step
# clock's exchange share of the step.
COLLECTIVE_TOL = 0.05


def closed_form_step_flops(cfg, batch, seq, classes=2):
    """One train step of a ``SequenceClassifier`` (flash attention), the
    FLOPs the port's count gives it: each linear layer 2·T·in·out forward
    and twice that backward; the attention tiles 4·B·S²·d forward and
    14·B·S²·d backward (the dq and dk/dv kernels each recompute S and
    dP); the pooler and head on the first token."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    t = batch * seq
    linears = (n * 2 * t * (4 * d * d + 2 * d * f)
               + 2 * batch * (d * d + d * classes))
    return 3 * linears + n * 18 * batch * seq * seq * d


def _plane_env(on: bool):
    """Set ``RAYDP_TPU_DEVICE_PLANE`` for a fit; returns the old value."""
    old = os.environ.get("RAYDP_TPU_DEVICE_PLANE")
    os.environ["RAYDP_TPU_DEVICE_PLANE"] = "1" if on else "0"
    return old


def _restore_env(name, old):
    if old is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = old


def _plane_fit(torch, P, np, cfg, cols, on: bool, epochs: int):
    """4b's stream estimator over ``cols`` with the plane on or off;
    returns (estimator, history, launch counts)."""
    old = _plane_env(on)
    try:
        est = _glue_estimator(torch, P, np, cfg, "stream", epochs)
        _reset_counts()
        history = est.fit(P.MLDataset([cols], num_shards=1))
        torch.cuda.synchronize()
        return est, history, _counts()
    finally:
        _restore_env("RAYDP_TPU_DEVICE_PLANE", old)


def plane_step_cost_us(torch, dp):
    """The device plane's host work a stream step, in microseconds: the
    step clock's two CUDA events, its poll and fold, the accumulator's
    histogram sample and the sentinel's step checks, around one tiny
    kernel, against that kernel alone; fastest of 3 runs a side, in
    turns, ``PLANE_COST_STEPS`` steps a run."""
    from raydp_tpu_torch.train.estimator import _StepClock

    x = torch.zeros(1, device="cuda")

    def bare():
        for _ in range(PLANE_COST_STEPS):
            x.add_(1)

    def planed():
        clock = _StepClock(torch.device("cuda"))
        acc = dp.StepPhaseAccumulator("plane-cost")
        sentinel = dp.AnomalySentinel()
        for i in range(PLANE_COST_STEPS):
            sentinel.wants_check(i + 1)
            clock.begin()
            h0 = time.perf_counter()
            t0 = clock.mark()
            x.add_(1)
            clock.end((t0, None, None, clock.mark()), h0,
                      time.perf_counter(), 0.0)
            acc.step(1e-3)
            sentinel.observe_step(1e-3, i)
        torch.cuda.synchronize()
        clock.epoch_totals()

    runs = {bare: [], planed: []}
    for fn in (bare, planed, planed, bare, bare, planed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs[fn].append(time.perf_counter() - t)
    return (min(runs[planed]) - min(runs[bare])) / PLANE_COST_STEPS * 1e6


def phase_device_plane(torch, P):
    """16a and 16b (module docstring). Returns the launch counts of the
    fits."""
    import numpy as np

    from raydp_tpu_torch.telemetry import device_profiler as dp
    from raydp_tpu_torch.telemetry import flight_recorder
    from raydp_tpu_torch.train.losses import resolve_loss
    from raydp_tpu_torch.utils.profiling import metrics

    t0 = time.perf_counter()
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      dropout_rate=0.1, max_len=GLUE_SEQ)
    _, cols = glue_columns(np, GLUE_BATCH * PLANE_STEPS, GLUE_SEQ, 30522,
                           seed=5)
    total = {k: 0 for k in KERNEL_SYMBOLS}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # 16a: one epoch with the plane on.
    peaks = dp.device_peaks()
    check(peaks["flops_by_dtype"] is not None,
          f"16a: no peak row for {peaks['kind']!r}")
    metrics.reset()
    dp.clear_costs()
    est, history, counts = _plane_fit(torch, P, np, cfg, cols, True, 1)
    add(counts)
    h = history[0]
    ph = h.get("phases") or {}
    fracs = {k: ph.get(k) for k in ("input_wait_frac", "dispatch_frac",
                                    "compute_frac", "collective_frac")}
    cost = dp.get_cost("train_step") or {}
    closed = closed_form_step_flops(cfg, GLUE_BATCH, GLUE_SEQ)
    steps = ph.get("steps", 0)
    per_step = {k: ph.get(k, 0.0) / max(1, steps) * 1e3
                for k in ("compute_s", "device_s", "wall_s")}
    compute_ms, device_ms, wall_ms = (per_step["compute_s"],
                                      per_step["device_s"],
                                      per_step["wall_s"])
    paced_ms = device_ms - compute_ms - ph.get("collective_s", 0.0) / max(
        1, steps) * 1e3
    scan_ms = RATES.get("4b_scan_ms", float("nan"))
    eager_ms = RATES.get("4b_stream_ms", float("nan"))
    log(f"[16a] stream fit, 1 epoch of {steps} steps, plane on: phases "
        f"{ {k: ph.get(k) for k in ('input_wait_s', 'dispatch_s', 'compute_s', 'collective_s', 'device_s', 'wall_s')} }; "
        f"fractions {fracs} (sum {sum(v or 0 for v in fracs.values()):.4f}); "
        f"bound {h.get('bound')}; mfu {h.get('mfu')} against "
        f"{dp.peak_flops(cost.get('dtype'), peaks) or float('nan'):.3e} "
        f"FLOP/s ({cost.get('dtype')} on {peaks['kind']})")
    log(f"[16a] FLOPs of a step counted on the meta device "
        f"{cost.get('flops', 0):.6e} in {cost.get('count_s', 0):.3f} s "
        f"(host, once a process, after the epoch's loop), closed form "
        f"{closed:.6e} ({cost.get('flops', 0) / closed:.4f} of it); a "
        f"step's device span {device_ms:.3f} ms (CUDA events), of it "
        f"host-paced {paced_ms:.3f} ms and compute {compute_ms:.3f} ms, "
        f"against 4b's eager step {eager_ms:.3f} ms and graph replay "
        f"{scan_ms:.3f} ms (CUDA events), the loop wall {wall_ms:.3f} ms "
        f"a step; launches {counts}")
    check(ph and abs(sum(fracs.values()) - 1.0) <= 1e-3,
          f"16a: the fractions {fracs} do not sum to 1")
    check(h.get("mfu") is not None and 0.0 < h["mfu"] <= 1.0,
          f"16a: mfu {h.get('mfu')}")
    check(metrics.gauge_value("mfu") == h.get("mfu"),
          f"16a: the mfu gauge {metrics.gauge_value('mfu')}")
    check(abs(cost.get("flops", 0) / closed - 1.0) <= FLOP_TOL,
          f"16a: counted {cost.get('flops')} FLOPs, closed form {closed}")
    check(h.get("bound") in ("input-bound", "collective-bound",
                             "compute-bound", "host-bound"),
          f"16a: bound {h.get('bound')}")
    check(0.9 * scan_ms <= device_ms <= wall_ms
          and 0.0 <= compute_ms <= device_ms,
          f"16a: a step's device span {device_ms} ms outside 0.9 x the "
          f"graph replay's {scan_ms} ms and the loop's {wall_ms} ms, or "
          f"its compute {compute_ms} ms outside it")
    check(counts == {k: 12 * PLANE_STEPS for k in KERNEL_SYMBOLS},
          f"16a: launches {counts}")
    del est

    # Plane on against off, in turns: epoch 1 of 2 a step, and the whole
    # fit's wall, epoch 0 included (the step count is cached by now).
    ab = {"on": [], "off": []}
    walls = {"on": [], "off": []}
    for side in PLANE_AB_RUNS:
        t_fit = time.perf_counter()
        est, history, counts = _plane_fit(torch, P, np, cfg, cols,
                                          side == "on", 2)
        walls[side].append(time.perf_counter() - t_fit)
        add(counts)
        ab[side].append(history[1]["time_s"] / PLANE_STEPS * 1e3)
        del est
    torch.cuda.empty_cache()
    log(f"[16a] stream fit ms a step, epoch 1 (host clock), runs in order "
        f"{list(PLANE_AB_RUNS)}: plane on "
        f"{[round(v, 3) for v in ab['on']]}, off "
        f"{[round(v, 3) for v in ab['off']]}; fastest on/off "
        f"{min(ab['on']) / min(ab['off']):.4f}; the whole fit's wall, s: "
        f"on {[round(v, 4) for v in walls['on']]}, off "
        f"{[round(v, 4) for v in walls['off']]}")
    cost_us = plane_step_cost_us(torch, dp)
    log(f"[16a] the plane's host work a step, alone: {cost_us:.2f} us "
        f"({cost_us / 1e3 / eager_ms:.5f} of 4b's eager step, "
        f"{PLANE_COST_STEPS} steps a run, fastest of 3 a side)")
    check(cost_us < PLANE_COST_SHARE * eager_ms * 1e3,
          f"16a: the plane's host work {cost_us} us a step against 4b's "
          f"eager step {eager_ms} ms")

    # 16b: a NaN enters the loss at step NAN_STEP.
    import shutil
    import tempfile

    pdir = tempfile.mkdtemp(prefix="chip-smoke-16b-")
    base = resolve_loss("softmax_ce")
    calls = {"n": 0}

    def nan_at_step(logits, labels):
        calls["n"] += 1
        loss = base(logits, labels)
        return loss * float("nan") if calls["n"] == NAN_STEP else loss

    saved = {k: os.environ.get(k) for k in
             (flight_recorder.POSTMORTEM_DIR_ENV, "RAYDP_TPU_SENTINEL_EVERY")}
    os.environ[flight_recorder.POSTMORTEM_DIR_ENV] = pdir
    os.environ["RAYDP_TPU_SENTINEL_EVERY"] = str(SENTINEL_EVERY)
    try:
        metrics.reset()
        est = _glue_estimator(torch, P, np, cfg, "stream", 1)
        est._loss_fn = nan_at_step
        _, nan_cols = glue_columns(np, GLUE_BATCH * NAN_STEPS, GLUE_SEQ,
                                   30522, seed=5)
        _reset_counts()
        est.fit(P.MLDataset([nan_cols], num_shards=1))
        add(_counts())
        tripped = est._sentinel.tripped
        counters = metrics.snapshot()["counters"]
        bundle = flight_recorder.latest_bundle(pdir)
        text = "".join(open(os.path.join(pdir, n)).read()
                       for n in sorted(os.listdir(pdir)))
    finally:
        for k, v in saved.items():
            _restore_env(k, v)
    log(f"[16b] NaN in the loss at step {NAN_STEP} of {NAN_STEPS}, checks "
        f"every {SENTINEL_EVERY} steps: tripped {tripped}; counters "
        f"{ {k: v for k, v in counters.items() if k.startswith('anomalies/')} }; "
        f"bundle {bundle}")
    check(any(t["kind"] == "nan_loss" and t["step"] == NAN_STEPS - 1
              for t in tripped), f"16b: the sentinel tripped {tripped}")
    check(counters.get("anomalies/nan_loss", 0) >= 1,
          f"16b: anomalies/nan_loss {counters.get('anomalies/nan_loss')}")
    check("anomaly:nan_loss" in text, f"16b: no anomaly bundle in {pdir}")
    shutil.rmtree(pdir, ignore_errors=True)
    del est
    torch.cuda.empty_cache()
    log(f"[16] phases 16a-16b {time.perf_counter() - t0:.1f} s (host "
        f"clock)")
    return total


def gang_plane_probe(ctx, tables, seed, batch, marker_dir, score_s,
                     score_batch):
    """16c's rank body in 12b's gang: a short stream fit of the bf16
    flash classifier on the rank's first ``PROBE_STEPS`` batches with the
    device plane on (its epoch sets the rank's phase gauges and ``mfu``,
    which the Pings ship), then, after writing a marker, scoring the
    rank's shard in batches of ``score_batch`` in a loop for ``score_s``
    seconds: the run the driver's capture samples. Returns the rank's history, launch counts and the
    batches scored."""
    import numpy as np
    import pyarrow as pa
    import torch

    import chip_smoke as cs
    import raydp_tpu_torch as P

    device = f"cuda:{ctx.local_rank % torch.cuda.device_count()}"
    torch.cuda.set_device(device)
    table = pa.concat_tables(tables)
    cols = {f"t{i}": table.column(f"t{i}").to_numpy().astype(np.int32)
            for i in range(cs.GLUE_SEQ)}
    cols["label"] = table.column("label").to_numpy().astype(np.int32)
    rows = cs.PROBE_STEPS * batch
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      max_len=cs.GLUE_SEQ)
    cs._reset_counts()
    est = P.Estimator(
        model=P.SequenceClassifier(
            cfg, device=device, generator=torch.Generator().manual_seed(seed)),
        optimizer=lambda p: torch.optim.AdamW(p, lr=2e-5),
        loss="softmax_ce", num_epochs=1, batch_size=batch,
        feature_columns=[f"t{i}" for i in range(cs.GLUE_SEQ)],
        label_column="label", feature_dtype=np.int32, label_dtype=np.int32,
        seed=0, shuffle=False, epoch_mode="stream", device=device)
    history = est.fit(P.MLDataset([{k: v[:rows] for k, v in cols.items()}],
                                  num_shards=1))
    model = est.get_model().eval()
    ids = torch.from_numpy(np.stack([cols[f"t{i}"]
                                     for i in range(cs.GLUE_SEQ)],
                                    axis=1)).to(device)
    scored = 0
    with open(os.path.join(marker_dir, f"rank-{ctx.rank}"), "w"):
        pass
    start = time.time()
    with torch.inference_mode():
        while time.time() - start < score_s:
            for lo in range(0, len(ids), score_batch):
                model(ids[lo:lo + score_batch])
                scored += 1
            torch.cuda.synchronize()
    return {"rank": ctx.rank, "history": history, "counts": cs._counts(),
            "scored": scored}


def capture_gang_profile(torch, job, shards):
    """16c in 12b: the probe runs in the gang while the driver captures
    ``GANG_CAPTURE_S`` seconds of both ranks; holds one merged trace with
    both ranks' profiler processes, span records and flash_fwd kernels,
    and ``resource_report()``'s ``mfu`` and ``bound`` for each rank.
    Returns the probe's launch counts by rank."""
    import shutil
    import tempfile
    import threading

    markers = tempfile.mkdtemp(prefix="chip-smoke-16c-")
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-16c-trace-")
    result, error = {}, []

    def run():
        try:
            result["out"] = job.run(gang_plane_probe, timeout=GANG_LIMIT_S,
                                    per_rank_args=[
                (shards[r], SERVE_SEED, GLUE_BATCH, markers, PROBE_SCORE_S,
                 PROBE_SCORE_BATCH) for r in range(GANG_WORLD)])
        except Exception as exc:  # surfaced below, after the join
            error.append(exc)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        started = _wait_for(lambda: len(os.listdir(markers)) == GANG_WORLD
                            or bool(error), timeout_s=GANG_LIMIT_S,
                            interval_s=0.1)
        check(started and not error, f"16c: the probe did not reach its "
                                     f"scoring loop ({error})")
        t0 = time.perf_counter()
        merged = job.capture_profile(GANG_CAPTURE_S, out_dir=out_dir)
        capture_s = time.perf_counter() - t0
        thread.join(timeout=GANG_LIMIT_S)
        check(not error and "out" in result, f"16c: the probe failed "
                                             f"{error}")
        with open(merged["merged_trace"]) as f:
            events = json.load(f)["traceEvents"]
        by_rank = {}
        for r in range(GANG_WORLD):
            base = (r + 1) * 100000
            mine = [e for e in events
                    if base <= e.get("pid", -1) < base + 100000]
            by_rank[r] = {
                "events": len(mine),
                "flash_fwd": sum(KERNEL_SYMBOLS["flash_fwd"]
                                 in str(e.get("name")) for e in mine
                                 if e.get("ph") == "X"),
                "spans": sum(e.get("pid", 0) >= base + 50000
                             and e.get("ph") == "X" for e in mine),
                "names": sorted({e["args"]["name"] for e in mine
                                 if e.get("ph") == "M"
                                 and e.get("name") == "process_name"})}
        report = _wait_for(lambda: (lambda rr: rr if len(rr) == GANG_WORLD
                                    and all("mfu" in v and "bound" in v
                                            for v in rr.values())
                                    else None)(job.resource_report()["ranks"]))
        log(f"[16c] 12b's gang: {GANG_CAPTURE_S} s capture in "
            f"{capture_s:.2f} s beside the probe's scoring loop: ranks "
            f"{merged['ranks']}, errors {merged.get('errors')}; by rank "
            f"{by_rank}; merged {merged['merged_trace']}")
        log(f"[16c] resource_report: "
            f"{ {k: {f: v.get(f) for f in ('mfu', 'bound', 'phases', 'compiles', 'compile_seconds')} for k, v in (report or {}).items()} }")
        for o in result["out"]:
            ph = o["history"][0].get("phases", {})
            log(f"[16c] rank {o['rank']} probe fit: {ph.get('steps')} steps, "
                f"mfu {o['history'][0].get('mfu')}, bound "
                f"{o['history'][0].get('bound')}; then {o['scored']} "
                f"batches scored; launches {o['counts']}")
        check(merged["ranks"] == list(range(GANG_WORLD))
              and not merged.get("errors"),
              f"16c: the gang's capture ranks {merged['ranks']}, errors "
              f"{merged.get('errors')}")
        for r, seen in by_rank.items():
            check(seen["flash_fwd"] > 0 and seen["spans"] > 0,
                  f"16c: rank {r} in the merged trace: {seen}")
        check(report is not None and all(
            0.0 < v["mfu"] <= 1.0 for v in report.values()),
            f"16c: resource_report {report}")
        return [o["counts"] for o in result["out"]]
    finally:
        thread.join(timeout=GANG_LIMIT_S)
        shutil.rmtree(markers, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)


_CLIENT_DASHBOARD = """
import json, sys
import raydp_tpu_torch
s = raydp_tpu_torch.connect(sys.argv[1])
report = s.cluster.dashboard_report()
print("RESULT " + json.dumps({k: sorted(v) if isinstance(v, dict) else None
                              for k, v in report.items()}))
raydp_tpu_torch.stop()
"""


def check_cluster_observability(cl, base):
    """16c in 15: ``Cluster.capture_profile`` over the driver and the 4
    workers, ``/debug/profile`` and ``/debug/dashboard`` on ``base``,
    the dashboard from the session and from a ``connect()``ed client of
    one shape, and the SLO engine's sampled series."""
    import shutil
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip-smoke-16c-cluster-")
    try:
        t0 = time.perf_counter()
        merged = cl.capture_profile(CLUSTER_CAPTURE_S, out_dir=out_dir)
        capture_s = time.perf_counter() - t0
        codes = {p: _http_status(base + p) for p in
                 (f"/debug/profile?seconds={CLUSTER_CAPTURE_S / 2}",
                  "/debug/dashboard")}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    local = cl.dashboard_report()
    shape = {k: sorted(v) if isinstance(v, dict) else None
             for k, v in local.items()}
    client = subprocess.run(
        [sys.executable, "-c", _CLIENT_DASHBOARD, cl.master.address],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    line = next((ln for ln in client.stdout.splitlines()
                 if ln.startswith("RESULT ")), None)
    remote = json.loads(line[len("RESULT "):]) if line else None
    sampler = cl._ts_sampler
    series = sampler.store.names() if sampler is not None else []
    log(f"[16c] 15's session: capture_profile({CLUSTER_CAPTURE_S}) over "
        f"{len(merged['ranks'])} processes in {capture_s:.2f} s, errors "
        f"{merged.get('errors')}; routes {codes}; dashboard sections "
        f"{sorted(local)}; the client's {sorted(remote or {})}; SLO engine "
        f"{cl._slo_engine is not None}, {len(series)} sampled series")
    check(len(merged["ranks"]) == SESSION_WORKERS + 1
          and not merged.get("errors"),
          f"15/16c: the cluster capture covered {merged['ranks']} "
          f"({merged.get('errors')})")
    check(set(codes.values()) == {200}, f"15/16c: the routes answered "
                                        f"{codes}")
    check(client.returncode == 0 and remote == shape,
          f"15/16c: the client's dashboard {remote} against the "
          f"session's {shape} ({client.stderr[-500:]})")
    check(cl._slo_engine is not None and len(series) > 0,
          f"15/16c: the SLO engine {cl._slo_engine}, series {series[:5]}")


def check_rank_phases(tag, last):
    """13b's and 15's ranks: print each rank's phase split and hold the
    plane's ``collective_frac`` (a share of the loop's wall) within
    ``COLLECTIVE_TOL`` of the step clock's exchange share of the steps
    taken over the wall's part outside the loop's input wait (the
    steps' share of it): the wall is the steps' spans and the input wait,
    no time unaccounted. 15's one epoch waits 0.1-0.2 of its wall on the
    loader's first chunk; 13b's last epoch ~0.001."""
    for r, h in enumerate(last):
        ph = h.get("phases") or {}
        share = h["allreduce_ms"] / h["step_ms"]
        want = share * (1.0 - ph.get("input_wait_frac", 0.0))
        log(f"[{tag}] rank {r} phases (last epoch): input_wait "
            f"{ph.get('input_wait_frac')}, dispatch "
            f"{ph.get('dispatch_frac')}, compute {ph.get('compute_frac')}, "
            f"collective {ph.get('collective_frac')} against the step "
            f"clock's {share:.4f} of the steps, {want:.4f} of the wall "
            f"outside the input wait; bound {h.get('bound')}, mfu "
            f"{h.get('mfu')}")
        check(ph and abs(ph["collective_frac"] - want) <= COLLECTIVE_TOL,
              f"{tag}: rank {r} collective_frac {ph.get('collective_frac')} "
              f"against the exchange share {share} of the steps, {want} "
              f"of the wall")



# Phase 17: the control plane on the card. (a) In phase 14's session, a
# low-priority 2-rank fit_spmd of 14b's configuration is preempted by a
# high-priority serving group's arrival and resumes once the group stops;
# (b) open-loop load on the admitted group; (c) the autoscaler over a
# fresh session's torch-free workers.
CP_CAPACITY = 2
CP_VICTIM_PRIORITY, CP_ARRIVAL_PRIORITY = 0, 5
CP_ADMIT_TIMEOUT_S = 600.0
CP_REPLICAS, CP_MAX_QUEUE = 1, 1024
# 2 s and 1 s since phase 19 (4 s and 2 s before).
CP_POISSON_RPS, CP_POISSON_S = 200.0, 2.0  # 17b through GroupTarget
CP_HTTP_RPS, CP_HTTP_S = 25.0, 1.0  # 17b through HttpTarget
CP_CHECK_REQUESTS = 16  # replies held against the dense forward
CP_TIMEOUT_S = 2.0
# The knee's p99 SLO and shed threshold are KneeConfig's defaults (250
# ms, 0.05); the ramp starts higher and its steps are 1 s, so 17b stays
# near 40 s. One replica held the SLO at 3,795 requests/s (H100 80GB
# HBM3, 700.00 W), so the ramp goes past it.
CP_KNEE = dict(start_rps=32.0, max_rps=16384.0, step_factor=1.7,
               step_duration_s=1.0, slo_ms=250.0, shed_threshold=0.05,
               bisect_rounds=2, timeout_s=CP_TIMEOUT_S, seed=17)
# 17c, the reference's autoscale smoke: 1 worker to 3 and back.
AS_CONFIG = dict(min_workers=1, max_workers=3, interval_s=0.5,
                 up_cooldown_s=0.3, down_cooldown_s=0.6, idle_evals=2,
                 spawn_retries=3, backoff_s=0.2)
AS_SPAWN_PLAN = "spawn_fail:nth=1"
AS_TASKS, AS_ROUND, AS_TASK_S = 96, 8, 0.15
AS_LIMIT_S = 60.0


def marked_factory(checkpoint_dir, marker):
    """17a's victim: :func:`ft_factory` at 14b's settings (so its final
    parameters are comparable with 14b's clean gang), whose rank 0
    creates ``marker`` once its first step is done."""
    def make_estimator():
        import os

        import chip_smoke as cs

        est = cs.ft_factory(checkpoint_dir, cs.FT_GANG_BATCH,
                            cs.FT_GANG_EPOCHS)()
        step = est._train_step

        def marked_step(x, y):
            out = step(x, y)
            if not os.path.exists(marker):
                open(marker, "w").close()
            return out

        est._train_step = marked_step
        return est

    return make_estimator


def _event(records, name, job=None, **attrs):
    """The last event ``name`` (of ``job``, where given) whose attributes
    include ``attrs``."""
    hits = [r for r in records if r["name"] == name
            and (job is None or r.get("job") == job)
            and all((r.get("attrs") or {}).get(k) == v
                    for k, v in attrs.items())]
    return hits[-1] if hits else None


def phase_control_plane(torch, P, session, ds2, clean):
    """17a and 17b in phase 14's session over its 2-shard GLUE dataset;
    ``clean`` is 14b's clean gang's result (the same configuration).
    Returns launch counts by tag and the replica's flash launches."""
    import functools
    import importlib
    import shutil
    import tempfile
    import threading

    from raydp_tpu_torch import control
    from raydp_tpu_torch.telemetry import accounting as acct
    from raydp_tpu_torch.telemetry import events as events_mod

    smoke = importlib.import_module("chip_smoke")
    arb = control.configure(CP_CAPACITY, admit_timeout_s=CP_ADMIT_TIMEOUT_S)
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-17a-")
    marker = os.path.join(ckpt, "training")
    victim_job = acct.mint_job("victim", priority=CP_VICTIM_PRIORITY)
    arrival_job = acct.mint_job("serve", priority=CP_ARRIVAL_PRIORITY)
    victim = {}

    def run_victim():
        with acct.job_scope(victim_job):
            try:
                victim["out"] = P.fit_spmd(
                    marked_factory(ckpt, marker), ds2,
                    world_size=GANG_WORLD, checkpoint_dir=ckpt,
                    timeout=FT_LIMIT_S)
            except Exception as exc:  # read below, after the group
                victim["error"] = exc

    group = P.ReplicaGroup(
        replicas=CP_REPLICAS, device="cuda", mode="batch",
        model_fn=functools.partial(smoke.classify_batch, seed=SERVE_SEED),
        buckets=SERVE_BUCKETS, max_batch=SERVE_MAX_BATCH,
        slo_ms=SERVE_SLO_MS, max_queue=CP_MAX_QUEUE,
        dispatch_timeout_s=SERVE_REQUEST_S, label="smoke-17")
    runner = threading.Thread(target=run_victim, daemon=True)
    t0 = time.perf_counter()
    runner.start()
    try:
        deadline = time.monotonic() + FT_LIMIT_S
        while not os.path.exists(marker):
            check(runner.is_alive() and time.monotonic() < deadline,
                  f"17a: the victim gang never trained: "
                  f"{victim.get('error')!r}")
            time.sleep(0.05)
        check(arb.report()["in_use"] == GANG_WORLD,
              f"17a: the victim holds {arb.report()['in_use']} slots")
        arrived = time.time()
        with acct.job_scope(arrival_job):
            group.start()  # blocks until the gang has drained its slot
        admitted = time.time()
        try:
            _wait_up(group, "17a")
            up = time.time()
            while [w["job"] for w in arb.report()["queue"]] != [
                    victim_job.job_id]:
                check(runner.is_alive() and time.monotonic() < deadline,
                      f"17a: the drained victim is not queued: "
                      f"{arb.report()}; {victim.get('error')!r}")
                time.sleep(0.05)
            dash = session.cluster.dashboard_report()
            phase_load(torch, group)
            pongs = group.ping()
        finally:
            group.stop()
        released = time.time()
        runner.join(FT_LIMIT_S)
        check(not runner.is_alive(), "17a: the victim did not finish")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        control.reset_for_tests()
    check("error" not in victim, f"17a: the victim failed: "
                                 f"{victim.get('error')!r}")
    out = victim["out"]
    records = events_mod.local_events()
    preempt = _event(records, "sched/preempt", victim=victim_job.job_id,
                     reason="priority")
    admit = _event(records, "sched/admit", label="smoke-17")
    resume = _event(records, "sched/resume", label="fit-spmd")
    release = _event(records, "sched/release", job=arrival_job.job_id)
    check(None not in (preempt, admit, resume, release),
          f"17a: sched events missing: preempt, admit, resume, release "
          f"{[e is not None for e in (preempt, admit, resume, release)]}")
    episodes = [e for e in events_mod.mttr_report(records)
                .get(victim_job.job_id, {}).get("episodes", [])
                if e["start_kind"] == "sched/preempt"]
    check(len(episodes) == 1 and episodes[0]["end_kind"] == "sched/resume",
          f"17a: the victim's preempt -> resume episode: {episodes}")
    (episode,) = episodes
    (failure,) = out["failures"]
    drains = _drains(failure["error"])
    check(failure["preempted"] and len(drains) == GANG_WORLD
          and len({s for s, _ in drains}) == 1,
          f"17a: the ranks drained at {drains}: {failure['error'][:400]}")
    drained_step = drains[0][0]
    steps = FT_GANG_EPOCHS * ds2.rows_per_shard // FT_GANG_BATCH
    check(0 < drained_step < steps,
          f"17a: drained after step {drained_step} of {steps}")
    check(out["restarts"] == 1, f"17a: {out['restarts']} restarts")
    differ = _params_equal(torch, out["params"], clean["params"])
    check(not differ, f"17a: the resumed victim's parameters differ from "
                      f"14b's clean gang's in {len(differ)} tensors, e.g. "
                      f"{differ[:4]}")
    check(len(set(out["per_rank_params_sha256"])) == 1,
          "17a: the resumed ranks' parameters differ")
    counts = {}
    for r, hist in enumerate(out["per_rank_history"]):
        want = {k: FT_LAYERS * (steps - drained_step)
                for k in KERNEL_SYMBOLS}
        check(hist[-1]["launches"] == want,
              f"17a: resumed rank {r} counted {hist[-1]['launches']}, want "
              f"{want}")
        counts[f"17a resumed rank {r}"] = hist[-1]["launches"]
    first = min(h[0]["probe_first_step_at"] for h in out["per_rank_history"])
    rep = arb.report()
    check(rep["in_use"] == 0 and not rep["queue"],
          f"17a: the arbiter still holds {rep}")
    sched = dash["control"].get("scheduler")
    check(sched is not None and sched["enabled"]
          and sched["in_use"] == CP_REPLICAS and sched["queue_depth"] == 1,
          f"17a: the dashboard's scheduler section: {sched}")
    log(f"[17a] the arbiter at capacity {CP_CAPACITY}: a {GANG_WORLD}-rank "
        f"fit_spmd (priority {CP_VICTIM_PRIORITY}, {steps} steps a rank) "
        f"preempted by a {CP_REPLICAS}-replica ReplicaGroup (priority "
        f"{CP_ARRIVAL_PRIORITY}); arrival to sched/preempt "
        f"{preempt['start_wall'] - arrived:.3f} s; drain seconds "
        f"{[round(t, 3) for _, t in drains]} by rank (after step "
        f"{drained_step}); the arrival's admission wait "
        f"{admit['attrs']['wait_s']} s (start() returned after "
        f"{admitted - arrived:.3f} s, the replica up after "
        f"{up - arrived:.3f} s); the group's release to the victim's first "
        f"resumed step {first - release['start_wall']:.3f} s (sched/resume "
        f"after {resume['start_wall'] - release['start_wall']:.3f} s, wait "
        f"{resume['attrs']['wait_s']} s); episode sched/preempt -> "
        f"sched/resume {episode['repair_s']:.3f} s through "
        + ", ".join(s["kind"] for s in episode["steps"])
        + f"; the resumed gang equal to 14b's clean gang (torch.equal); "
        f"17a-b {time.perf_counter() - t0:.1f} s; group stop to the "
        f"victim's return {time.time() - released:.1f} s")
    log(f"[17a] dashboard_report()['control']['scheduler'] while the group "
        f"served: {json.dumps(sched, sort_keys=True)}")
    replica_launches = sum(p["launches"]["flash_fwd"] for p in pongs)
    check(replica_launches > 0, "17b: the replica launched no flash forward")
    log(f"[17b] Ping: " + "; ".join(
        f"replica {p['replica']} on {p['device']}, flash_fwd "
        f"{p['launches']['flash_fwd']}" for p in pongs))
    return counts, replica_launches


def phase_load(torch, group):
    """17b: open-loop load on the admitted group: a Poisson schedule
    through ``GroupTarget``, a short one through ``HttpTarget`` on a
    ``ServeFrontend``, then the knee finder; a few replies held against
    the driver's dense forward of the same weights first."""
    import importlib

    from raydp_tpu_torch.loadgen import (
        GroupTarget,
        HttpTarget,
        KneeConfig,
        find_knee,
        poisson_schedule,
        run_schedule,
    )
    from raydp_tpu_torch.serve import ServeFrontend

    smoke = importlib.import_module("chip_smoke")
    t0 = time.perf_counter()
    # The loadgen's payloads: ``size`` ids of 1, padded to the bucket.
    sizes = [8, 24, 96, 128] * (CP_CHECK_REQUESTS // 4)
    payloads = [[1] * n for n in sizes]
    got = torch.tensor([group.submit(p, timeout_s=SERVE_REQUEST_S)
                        .wait(timeout=SERVE_REQUEST_S) for p in payloads])
    dense = smoke.serve_classifier(SERVE_SEED, attention_impl="dense")
    with torch.inference_mode():
        want = torch.cat([dense(padded_ids(torch, [p], next(
            b for b in SERVE_BUCKETS if len(p) <= b), "cuda")).float().cpu()
            for p in payloads])
    check(torch.allclose(got, want, **LOGIT_TOL),
          f"17b: replies differ from the dense forward by "
          f"{(got - want).abs().max().item():.3e}")

    def show(tag, res):
        s = res.summary()
        log(f"[17b] {tag}: offered {s['offered_rps']} rps, achieved "
            f"{s['achieved_rps']} rps, {s['requests']} requests; p50 "
            f"{s['p50_s']} s, p99 {s['p99_s']} s; counts {s['counts']}; "
            f"phase fractions {s['phase_fractions']}")
        return s

    target = GroupTarget(group)
    pois = show("GroupTarget Poisson", run_schedule(
        target, poisson_schedule(CP_POISSON_RPS, CP_POISSON_S, seed=17),
        timeout_s=CP_TIMEOUT_S))
    check(pois["counts"]["ok"] == pois["requests"],
          f"17b: the Poisson run's outcomes {pois['counts']}")
    fe = ServeFrontend(group).start()
    try:
        http = show("HttpTarget Poisson", run_schedule(
            HttpTarget(f"http://127.0.0.1:{fe.port}"),
            poisson_schedule(CP_HTTP_RPS, CP_HTTP_S, seed=18),
            timeout_s=CP_TIMEOUT_S))
    finally:
        fe.close()
    check(http["counts"]["ok"] == http["requests"],
          f"17b: the HTTP run's outcomes {http['counts']}")
    knee = find_knee(target, KneeConfig(**CP_KNEE))
    curve = [(round(p.rps, 1), p.stage, round(p.achieved_rps, 1),
              p.p99_s, round(p.shed_rate, 4), p.breached)
             for p in knee.curve]
    check(knee.knee_rps > 0 and len(curve) >= 2,
          f"17b: no knee: {knee.summary()}")
    log(f"[17b] knee finder (p99 SLO {CP_KNEE['slo_ms']:.0f} ms, shed "
        f"threshold {CP_KNEE['shed_threshold']}, {CP_KNEE['step_duration_s']}"
        f" s steps from {CP_KNEE['start_rps']:.0f} rps, x"
        f"{CP_KNEE['step_factor']}): {json.dumps(knee.summary())}; curve "
        f"(rps, stage, achieved rps, p99 s, shed, breached): {curve}; "
        f"17b {time.perf_counter() - t0:.1f} s")


def _autoscale_task(ctx, i):
    time.sleep(AS_TASK_S)
    return i


def phase_autoscale(P):
    """17c: the reference's autoscale smoke on a fresh 1-worker session:
    a queued arbiter waiter grows the pool in one evaluation, a second
    grow passes ``spawn_fail:nth=1`` by backoff, and a 96-task ETL runs
    across a drain back to the minimum with no task lost and no flap.
    Host work only: the workers hold no torch."""
    import threading

    from raydp_tpu_torch import control, fault
    from raydp_tpu_torch.control import (
        Autoscaler,
        AutoscalerConfig,
        ClusterProvisioner,
    )
    from raydp_tpu_torch.telemetry import accounting as acct
    from raydp_tpu_torch.telemetry import events as events_mod
    from raydp_tpu_torch.utils.profiling import metrics

    before = metrics.snapshot().get("counters", {})
    os.environ[fault.FAULT_PLAN_ENV] = AS_SPAWN_PLAN
    fault.reset_for_tests()
    session = P.init(app_name="chip-smoke-17c", num_workers=1,
                     memory_per_worker="256MB")
    try:
        cluster = session.cluster
        sc = Autoscaler(ClusterProvisioner(cluster),
                        AutoscalerConfig(**AS_CONFIG))
        arb = control.configure(1, admit_timeout_s=120.0)
        holder = arb.acquire(acct.mint_job("holder"), slots=1,
                             preemptible=False)
        waiter = {}

        def wait_for_slot():
            waiter["lease"] = arb.acquire(acct.mint_job("starved"), slots=1,
                                          timeout=120.0, preemptible=False)

        wt = threading.Thread(target=wait_for_slot, daemon=True)
        wt.start()
        deadline = time.monotonic() + 10.0
        while arb.report()["queue_depth"] != 1:
            check(time.monotonic() < deadline,
                  f"17c: the waiter never queued: {arb.report()}")
            time.sleep(0.02)
        t0 = time.monotonic()
        first = sc.step()
        grow_s = time.monotonic() - t0
        check(first.verdict == "grow" and len(cluster.alive_workers()) == 2,
              f"17c: first evaluation {first}")
        time.sleep(AS_CONFIG["up_cooldown_s"] + 0.05)
        t0 = time.monotonic()
        second = sc.step()
        retry_s = time.monotonic() - t0
        check(second.verdict == "grow" and len(cluster.alive_workers()) == 3,
              f"17c: second evaluation {second}")
        failed = (metrics.snapshot()["counters"].get("autoscale/spawn_failed",
                                                     0)
                  - before.get("autoscale/spawn_failed", 0))
        check(failed == 1, f"17c: {failed} spawn failures, want 1")
        holder.release()
        wt.join(30.0)
        waiter["lease"].release()

        items = list(range(AS_TASKS))
        got = []

        def etl():
            # Rounds in turn keep the job in flight across the drains.
            for base in range(0, len(items), AS_ROUND):
                got.extend(cluster.map_tasks(
                    _autoscale_task, items[base:base + AS_ROUND],
                    timeout=120.0))

        t_etl = time.monotonic()
        et = threading.Thread(target=etl, daemon=True)
        et.start()
        time.sleep(0.3)  # tasks in flight on all three workers
        t0 = time.monotonic()
        deadline = t0 + AS_LIMIT_S
        while len(cluster.alive_workers()) > AS_CONFIG["min_workers"]:
            check(time.monotonic() < deadline,
                  f"17c: the pool did not drain: {cluster.alive_workers()}")
            sc.step()
            time.sleep(0.25)
        drain_s = time.monotonic() - t0
        et.join(180.0)
        etl_s = time.monotonic() - t_etl
        check(not et.is_alive(), "17c: the ETL did not finish")
        lost = len(items) - sum(a == b for a, b in zip(got, items))
        check(got == items, f"17c: {lost} tasks lost in the scale-down")
        acted = [d.verdict for d in sc.decisions
                 if d.verdict in ("grow", "shrink")]
        flaps = sum(1 for a, b in zip(acted, acted[1:])
                    if (a, b) == ("shrink", "grow"))
        check(flaps == 0 and acted == ["grow", "grow", "shrink", "shrink"],
              f"17c: decisions {acted}, {flaps} flap episodes")
        decided = [r for r in events_mod.local_events()
                   if r["name"] == "autoscale/decision"][-len(
                       [d for d in sc.decisions if d.verdict != "steady"]):]
        check([r["attrs"]["verdict"] for r in decided]
              == [d.verdict for d in sc.decisions if d.verdict != "steady"],
              "17c: the decisions are not on the event timeline")
    finally:
        P.stop()
        os.environ.pop(fault.FAULT_PLAN_ENV, None)
        fault.reset_for_tests()
        control.reset_for_tests()
    log(f"[17c] autoscaler {AS_CONFIG['min_workers']} -> "
        f"{AS_CONFIG['max_workers']} workers: a queued arbiter waiter grew "
        f"the pool in one evaluation ({grow_s:.3f} s, a worker spawned and "
        f"registered); the second grow through {AS_SPAWN_PLAN} "
        f"{retry_s:.3f} s (one failure, backoff {AS_CONFIG['backoff_s']} "
        f"s, then a spawn); drain back to {AS_CONFIG['min_workers']} worker "
        f"{drain_s:.3f} s under a {AS_TASKS}-task ETL ({etl_s:.3f} s, "
        f"{AS_TASKS / etl_s:.1f} tasks/s); tasks lost {lost}; flap "
        f"episodes {flaps}; decisions {acted} of "
        f"{[d.verdict for d in sc.decisions]}")
    return {"grow_s": grow_s, "retry_s": retry_s, "drain_s": drain_s,
            "lost": lost, "flaps": flaps}


# Phase 18: the torch compat estimator on the card. (a) A driver script
# run through the submit CLI in a process of its own: a world-1 fit from
# a frame of its own session, evaluate, predict, save and restore. (b) A
# store-fed 2-rank gang of gloo DDP ranks in phase 14's session.
COMPAT_ROWS, COMPAT_EVAL_ROWS, COMPAT_BATCH = 1024, 64, 32
COMPAT_GANG_BATCH, COMPAT_GANG_EPOCHS, COMPAT_GANG_EVAL_ROWS = 32, 1, 128
COMPAT_LR, COMPAT_LIMIT_S = 1e-4, 300.0
# bert_base width, 2 layers since phase 19 (12 before; phase 19's depth).
COMPAT_LAYERS = 2
COMPAT_CONF = {"chip.phase": "18a"}
COMPAT_DRIVER = """import sys

import chip_smoke

sys.exit(chip_smoke.compat_driver_main(sys.argv[1]))
"""


def compat_classifier(config):
    """18's model creator, run in the process that fits (the closure
    carrier ships it by value): 13b's bf16 flash classifier at bert_base
    width and ``COMPAT_LAYERS`` layers, dropout 0 (the estimator hands a model no dropout
    generator), from generator seed 9, built on the CPU; it is fed
    segment ids 0, so every parameter takes part in the loss (DDP over
    gloo refuses a parameter without a gradient). A forward hook writes,
    after each forward in eval mode, this process's flash launch counts
    and the training losses the criterion kept to
    ``<config["probe_dir"]>/rank-<rank>.json``."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import raydp_tpu_torch as P

    probe = config.setdefault("_probe", {"losses": []})
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      max_len=cs.GLUE_SEQ, dropout_rate=0.0,
                      n_layers=cs.COMPAT_LAYERS)

    class Segmented(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.clf = P.SequenceClassifier(
                cfg, device="cpu", generator=torch.Generator().manual_seed(9))

        def forward(self, ids):
            return self.clf(ids, torch.zeros_like(ids))

    def write_probe(module, args, out):
        if module.training:
            return
        rank = dist.get_rank() if dist.is_initialized() else 0
        losses = probe["losses"]
        record = {"rank": rank, "counts": cs._counts(),
                  "losses": (torch.stack(losses).float().tolist()
                             if losses else []),
                  "first_step_at": probe.get("first_step_at")}
        path = os.path.join(config["probe_dir"], f"rank-{rank}.json")
        with open(path, "w") as f:
            json.dump(record, f)

    model = Segmented()
    model.register_forward_hook(write_probe)
    return model


def compat_loss(config):
    """18's criterion creator: ``CrossEntropyLoss`` that keeps each
    training step's loss (on the device, no sync) for the probe, and the
    wall-clock time its first step's forward finished (one sync)."""
    import torch

    probe = config.setdefault("_probe", {"losses": []})
    losses = probe["losses"]

    class KeptCE(torch.nn.CrossEntropyLoss):
        def forward(self, out, target):
            loss = super().forward(out, target)
            if torch.is_grad_enabled():  # a train step, not an eval
                if not losses:  # the wall-clock time the first step ran
                    torch.cuda.synchronize()
                    probe["first_step_at"] = time.time()
                losses.append(loss.detach())
            return loss

    return KeptCE()


def compat_estimator(P, np, num_workers, batch, epochs, probe_dir):
    import torch

    return P.TorchEstimator(
        num_workers=num_workers, model=compat_classifier,
        optimizer=lambda m, c: torch.optim.AdamW(m.parameters(),
                                                 lr=COMPAT_LR),
        loss=compat_loss, feature_columns=[f"t{i}" for i in range(GLUE_SEQ)],
        feature_types=np.int64, label_column="label", label_type=np.int64,
        batch_size=batch, num_epochs=epochs, seed=0, probe_dir=probe_dir,
        device="cuda")


def compat_driver_main(probe_dir: str) -> int:
    """18a's driver, run by ``python -m raydp_tpu_torch.cli.submit`` in
    a process of its own: prints ``HANDOFF {json}`` (what ``init()``
    got from the CLI) and ``RESULT {json}`` (the fit's history, each
    stage's launch counts and host seconds, the kept losses, the eval
    numbers and the predict checks)."""
    import numpy as np
    import pyarrow as pa
    import torch

    import raydp_tpu_torch as P
    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.data import MLDataset

    t0 = time.perf_counter()
    session = P.init()
    init_s = time.perf_counter() - t0
    print("HANDOFF " + json.dumps({
        "app": session.config.app_name,
        "workers": session.config.num_workers,
        "alive": len(session.cluster.alive_workers()),
        "conf": session.config.extra}), flush=True)
    try:
        table = pa.table(synthetic_glue(np, COMPAT_ROWS + COMPAT_EVAL_ROWS,
                                        GLUE_SEQ, 30522))
        train = rdf.from_arrow(table.slice(0, COMPAT_ROWS),
                               num_partitions=ETL_PARTS)
        evl = rdf.from_arrow(table.slice(COMPAT_ROWS), num_partitions=1)
        ids = np.stack([table.column(f"t{i}").to_numpy()[COMPAT_ROWS:]
                        for i in range(GLUE_SEQ)], axis=1)
        est = compat_estimator(P, np, 1, COMPAT_BATCH, 1, probe_dir)
        counts, secs = {}, {}

        def stage(name, fn):
            _reset_counts()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
            counts[name] = _counts()
            return out

        called = time.time()
        history = stage("fit", lambda: est.fit_on_df(train, evl))
        first_step_s = est.config["_probe"]["first_step_at"] - called
        metrics = stage("evaluate", lambda: est.evaluate(
            MLDataset.from_df(evl, num_shards=1)))
        preds = stage("predict", lambda: est.predict(ids))
        path = est.save(os.path.join(probe_dir, "compat.pt"))
        restored = compat_estimator(P, np, 1, COMPAT_BATCH, 1, probe_dir)
        restored.restore(path)

        def restored_predict():
            got = restored.predict(ids)
            model = restored.get_model().eval()
            with torch.no_grad():
                own = model(torch.from_numpy(ids).cuda()).float().cpu()
            return got, own.numpy()

        got, own = stage("restored", restored_predict)
        losses = torch.stack(est.config["_probe"]["losses"]).float().tolist()
        print("RESULT " + json.dumps({
            "init_s": init_s, "first_step_s": first_step_s,
            "history": history, "secs": secs,
            "counts": counts, "losses": losses, "evaluate": metrics,
            "predict_shape": list(preds.shape),
            "predict_finite": bool(np.isfinite(preds).all()),
            "restored_equal": bool(np.array_equal(got, preds)),
            "own_forward_equal": bool(np.array_equal(got, own)),
            "restored_history": restored.history == history}), flush=True)
    finally:
        P.stop()
    return 0


def _prefixed(text, prefix):
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    check(len(lines) == 1, f"18a: the driver printed {len(lines)} "
          f"{prefix.strip()} lines")
    return json.loads(lines[0][len(prefix):])


def start_compat_cli():
    """18a's process: the submit CLI running :func:`compat_driver_main`,
    started here and left running (it holds its own session and card
    work, beside phases 19-20); :func:`phase_compat_cli` waits for it
    and checks it."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip-smoke-18a-")
    driver = os.path.join(tmp, "driver.py")
    with open(driver, "w") as f:
        f.write(COMPAT_DRIVER)
    args = ["--name", "chip-18a", "--num-workers", "2"]
    for k, v in COMPAT_CONF.items():
        args += ["--conf", f"{k}={v}"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAYDP_TPU_CONF_")
           and k not in ("RAYDP_TPU_APP_NAME", "RAYDP_TPU_NUM_WORKERS")}
    # Files, not pipes: nothing reads the process's output until it ends.
    with open(os.path.join(tmp, "out"), "w") as out, \
            open(os.path.join(tmp, "err"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "raydp_tpu_torch.cli.submit", *args,
             driver, tmp], cwd=ROOT, env=env, stdout=out, stderr=err)
    return proc, tmp, time.perf_counter()


def phase_compat_cli(torch, P, started):
    """18a: waits for the process :func:`start_compat_cli` started and
    checks what it printed; returns its launch counts over every stage."""
    import shutil

    import numpy as np

    proc, tmp, t0 = started
    try:
        try:
            proc.wait(timeout=COMPAT_LIMIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "out")) as f:
            stdout = f.read()
        with open(os.path.join(tmp, "err")) as f:
            stderr = f.read()
        check(proc.returncode == 0,
              f"18a: the CLI exited {proc.returncode}: {stderr[-3000:]}")
        handoff = _prefixed(stdout, "HANDOFF ")
        out = _prefixed(stdout, "RESULT ")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_handoff = {"app": "chip-18a", "workers": 2, "alive": 2,
                    "conf": COMPAT_CONF}
    check(handoff == want_handoff,
          f"18a: init() got {handoff}, the CLI handed {want_handoff}")
    steps = COMPAT_ROWS // COMPAT_BATCH
    fwd = {"flash_fwd": COMPAT_LAYERS}
    want = {"fit": {k: COMPAT_LAYERS * steps
                    + (COMPAT_LAYERS if k == "flash_fwd" else 0)
                    for k in KERNEL_SYMBOLS},
            "evaluate": {k: fwd.get(k, 0) for k in KERNEL_SYMBOLS},
            "predict": {k: fwd.get(k, 0) for k in KERNEL_SYMBOLS},
            "restored": {k: 2 * fwd.get(k, 0) for k in KERNEL_SYMBOLS}}
    check(out["counts"] == want,
          f"18a: launches by stage {out['counts']}, want {want}")
    losses = out["losses"]
    head, tail = np.mean(losses[:8]), np.mean(losses[-8:])
    check(len(losses) == steps and all(np.isfinite(losses)) and tail < head,
          f"18a: the step losses did not fall ({len(losses)} steps, first "
          f"8 mean {head:.4f}, last 8 {tail:.4f})")
    hist = out["history"]
    evals = [hist[-1]["eval_loss"], hist[-1]["eval_acc"],
             out["evaluate"]["eval_loss"], out["evaluate"]["eval_acc"]]
    check(len(hist) == 1 and all(np.isfinite(evals)),
          f"18a: history {hist}, evaluate {out['evaluate']}")
    check(out["predict_shape"] == [COMPAT_EVAL_ROWS, 2]
          and out["predict_finite"],
          f"18a: predictions {out['predict_shape']}, finite "
          f"{out['predict_finite']}")
    check(out["restored_equal"] and out["own_forward_equal"]
          and out["restored_history"],
          f"18a: restored predict equal {out['restored_equal']}, equal to "
          f"its model's forward {out['own_forward_equal']}, history "
          f"restored {out['restored_history']}")
    secs = out["secs"]
    log(f"[18a] submit CLI -> driver process: {wall:.1f} s of wall (host "
        f"clock, beside phases 19-20; the interpreter's start and imports "
        f"included), init() "
        f"{out['init_s']:.2f} s with handoff {handoff}; fit_on_df "
        f"{secs['fit']:.2f} s for {steps} steps and the eval, "
        f"{out['first_step_s']:.2f} s of it from the call to the first "
        f"step's forward (the frame's shards read, the CPU build of "
        f"bert_base, the upload), train_loss "
        f"{hist[0]['train_loss']:.4f} (steps' mean {head:.4f} over the first "
        f"8 -> {tail:.4f} over the last 8), eval_loss "
        f"{hist[0]['eval_loss']:.4f} eval_acc {hist[0]['eval_acc']:.4f}; "
        f"evaluate {secs['evaluate']:.2f} s {out['evaluate']}, predict "
        f"{secs['predict']:.2f} s, restored predict + forward "
        f"{secs['restored']:.2f} s (each builds the model on the CPU); "
        f"launches by stage {out['counts']}")
    total = {k: sum(c[k] for c in out["counts"].values())
             for k in KERNEL_SYMBOLS}
    return total


def phase_compat_gang(torch, P, frame):
    """18b: ``TorchEstimator(num_workers=2)`` in the live session of
    phase 14 on a dataset of its GLUE ``frame`` (a fresh one: phase 14's
    datasets hold the blocks their driver-side reads landed); returns
    each rank's launch counts by tag."""
    import shutil
    import tempfile

    import numpy as np
    import pyarrow as pa

    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.store.object_store import ObjectRef
    from raydp_tpu_torch.train import torch_estimator as te

    ds2 = MLDataset.from_df(frame, num_shards=GANG_WORLD)
    table = pa.table(synthetic_glue(np, FT_ROWS + COMPAT_GANG_EVAL_ROWS,
                                    GLUE_SEQ, 30522)).slice(FT_ROWS)
    evl = MLDataset.from_df(rdf.from_arrow(table, num_partitions=GANG_WORLD),
                            num_shards=GANG_WORLD)
    check(all(isinstance(b, ObjectRef) for b in ds2.blocks + evl.blocks),
          "18b: the rows are not in the object store")
    probe = tempfile.mkdtemp(prefix="chip-smoke-18b-")
    est = compat_estimator(P, np, GANG_WORLD, COMPAT_GANG_BATCH,
                           COMPAT_GANG_EPOCHS, probe)
    spec = est._store_feed_spec(ds2, evl, GANG_WORLD)
    check(spec is not None and all(p is not None
                                   for p in spec["eval_plans"]),
          "18b: no store feed with a gang-reduced eval")
    rows_range, read = te._rows_range, []

    def refused(*args, **kwargs):
        read.append(args[2:4])
        raise AssertionError("18b: the driver materialized rank rows")

    te._rows_range = refused
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    try:
        called = time.time()
        t0 = time.perf_counter()
        hist = est.fit(ds2, evl)
        fit_s = time.perf_counter() - t0
        ranks = []
        for r in range(GANG_WORLD):
            with open(os.path.join(probe, f"rank-{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        te._rows_range = rows_range
        shutil.rmtree(probe, ignore_errors=True)
    check(not read, f"18b: _rows_range was called for {read}")
    steps = COMPAT_GANG_EPOCHS * ds2.rows_per_shard // COMPAT_GANG_BATCH
    want = {k: COMPAT_LAYERS * steps + (COMPAT_LAYERS * COMPAT_GANG_EPOCHS
                                        if k == "flash_fwd" else 0)
            for k in KERNEL_SYMBOLS}
    for o in ranks:
        check(o["counts"] == want and len(o["losses"]) == steps,
              f"18b: rank {o['rank']} counted {o['counts']} over "
              f"{len(o['losses'])} steps, want {want} over {steps}")
    losses = [h["train_loss"] for h in hist]
    evals = [h[k] for h in hist for k in ("eval_loss", "eval_acc")]
    check(len(hist) == COMPAT_GANG_EPOCHS and all(np.isfinite(losses + evals)),
          f"18b: history {hist}")
    head = np.mean([o["losses"][:3] for o in ranks])
    tail = np.mean([o["losses"][-3:] for o in ranks])
    check(tail < head, f"18b: the ranks' step losses did not fall: first 3 "
          f"steps' mean {head:.4f}, last 3 {tail:.4f}")
    eval_pairs = [(h["eval_loss"], h["eval_acc"]) for h in hist]
    ends = [(o["losses"][0], o["losses"][-1]) for o in ranks]
    log(f"[18b] TorchEstimator(num_workers={GANG_WORLD}) store-fed in "
        f"phase 14's session: fit {fit_s:.1f} s (host clock: the gang's "
        f"start, the ranks' imports, CPU model builds and DDP setup "
        f"included; the call to each rank's first step's forward "
        f"{[round(o['first_step_at'] - called, 2) for o in ranks]} s) for "
        f"{steps} steps a rank at batch {COMPAT_GANG_BATCH} "
        f"and {COMPAT_GANG_EPOCHS} gang-reduced eval(s) of "
        f"{COMPAT_GANG_EVAL_ROWS} rows; train_loss by epoch "
        f"{[round(x, 4) for x in losses]} (the ranks' step losses' mean "
        f"{head:.4f} over the first 3 -> {tail:.4f} over the last 3), eval "
        f"{[(round(e, 4), round(a, 4)) for e, a in eval_pairs]}"
        f"; rank step losses first/last "
        f"{[(round(a, 4), round(b, 4)) for a, b in ends]}"
        f"; launches by rank {[o['counts'] for o in ranks]}; "
        f"_rows_range calls {len(read)}")
    return {f"18b rank {o['rank']}": o["counts"] for o in ranks}



# Phase 19: model parallelism over a gang on the one card. 19a: bert_base
# over MeshSpec(sp=2, tp=2), ring attention, one epoch of 512 of 10c's
# rows at batch 32 (16 steps; at 8 the Ulysses check's margin over the
# bf16 bound shrank on a CPU rehearsal); 19b, in the same gang: a PipelinedClassifier at
# bert_base width over MeshSpec(dp=2, pp=2) with the flash kernels, 3
# epochs of 4 steps a dp rank on 128 rows each.
MESH_ROWS, MESH_BATCH, MESH_CHECK_ROWS = 512, 32, 32
PIPE_ROWS, PIPE_EPOCHS, PIPE_CHECK_ROWS = 256, 3, 8
MESH_LIMIT_S = 900.0
# The ranks share the machine's cores with the driver.
MESH_ENV = {"OMP_NUM_THREADS": "2"}


def _recording_loss(record, name="softmax_ce", moe_layers=None,
                    kept=None):
    """The repo's loss ``name``, each step's value kept (a device tensor,
    read after the fit: no sync a step), and with ``moe_layers`` their
    kept slots of the step in ``kept``."""
    import torch

    from raydp_tpu_torch.train.losses import resolve_loss

    base = resolve_loss(name)

    def loss(preds, target):
        value = base(preds, target)
        record.append(value.detach())
        if moe_layers:
            kept.append(torch.stack([m.kept_slots for m in moe_layers]))
        return value

    return loss


def mesh_fit_factory(axes, checkpoint_dir, check_ids, pipe_cols, pipe_ids,
                     expert_cols, elastic_args):
    """19a's estimator factory, run in each rank: 10c's bf16 classifier
    at bert_base width and depth with ring attention, its initial
    parameters from generator seed 9 (the 1-rank reference's), cut by the
    estimator over ``MeshSpec(**axes)``; AdamW 2e-5, unshuffled, the
    stream path, a gathered checkpoint at the epoch's end. Its callback
    adds to the last epoch's metrics the rank's step losses, launch
    counts, peak memory, the collectives' calls, time and staged bytes
    (``parallel/collectives.py``), the shapes of block 0's four Megatron
    weights, and the ring's and Ulysses' logits of the trained model on
    ``check_ids``; then it runs 19b, 20 and 21a in the same gang
    (:func:`pipe_part`, :func:`expert_part`, :func:`elastic_part` of
    ``elastic_args``), so that phases 19, 20 and 21a start one gang."""
    def make_estimator():
        import dataclasses

        import numpy as np
        import torch

        import chip_smoke as cs
        import raydp_tpu_torch as P
        from raydp_tpu_torch.parallel import collectives as C

        steps = []

        class MeshProbe(P.TrainingCallback):
            est = None

            def on_train_end(self, history):
                model = self.est.get_model()
                blk = model.encoder.blocks[0]
                m = history[-1]
                m["launches"] = cs._counts()
                m["peak_bytes"] = torch.cuda.max_memory_allocated()
                m["collectives"] = C.stats()
                m["step_losses"] = [float(v) for v in steps]
                m["shapes"] = {n: list(t.shape) for n, t in (
                    ("qkv", blk.attn.qkv.weight), ("out", blk.attn.out.weight),
                    ("mlp_up", blk.mlp_up.weight),
                    ("mlp_down", blk.mlp_down.weight))}
                m["ring"] = self.est.predict(check_ids).tolist()
                for b in model.encoder.blocks:
                    b.attn.cfg = dataclasses.replace(
                        b.attn.cfg, attention_impl="ulysses")
                m["ulysses"] = self.est.predict(check_ids).tolist()
                C.set_timing(False)
                m["pipe"] = cs.pipe_part(pipe_cols, pipe_ids)
                m["expert"] = cs.expert_part(*expert_cols)
                m["elastic"] = cs.elastic_part(*elastic_args)

        cs._reset_counts()
        C.reset_stats()
        C.set_timing(True)
        torch.cuda.reset_peak_memory_stats()
        cfg = P.bert_base(attention_impl="ring", dtype=torch.bfloat16,
                          max_len=cs.GLUE_SEQ, dropout_rate=0.0)
        probe = MeshProbe()
        est = P.Estimator(
            model=P.SequenceClassifier(
                cfg, device="cuda", generator=torch.Generator().manual_seed(9)),
            optimizer=lambda p: torch.optim.AdamW(p, lr=2e-5,
                                                  weight_decay=1e-4),
            loss=cs._recording_loss(steps), num_epochs=1,
            batch_size=cs.MESH_BATCH,
            feature_columns=[f"t{i}" for i in range(cs.GLUE_SEQ)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, mesh=P.MeshSpec(**axes), seed=0,
            shuffle=False, epoch_mode="stream",
            checkpoint_dir=checkpoint_dir, callbacks=[probe], device="cuda")
        probe.est = est
        return est

    return make_estimator


def pipe_part(cols, check_ids):
    """19b, run in every rank of 19a's gang after its fit: a
    ``PipelinedClassifier`` at bert_base width (one block a stage: 2 in
    all) with the flash kernels, bf16, 4 microbatches, its parameters
    from generator seed 11, over ``MeshSpec(dp=2, pp=2)`` on the same 4
    ranks (a new mesh: new groups); AdamW 1e-4, batch 32 a dp rank, each
    dp rank fitting its half of ``cols``. First each rank runs the
    pipelined forward of the initial model on its dp half of
    ``check_ids``. Returns the forward's logits, the history, the
    rank's launch counts from before that forward to the fit's end, its
    peak memory (19a's estimator still held) and its stages' shapes."""
    import numpy as np
    import torch

    import raydp_tpu_torch as P
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.models import PipelinedClassifier

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    spec = P.MeshSpec(dp=2, pp=2)
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      max_len=GLUE_SEQ, dropout_rate=0.0, n_layers=2)
    est = P.Estimator(
        model=PipelinedClassifier(cfg, spec, n_microbatches=4, device="cuda",
                                  generator=torch.Generator().manual_seed(11)),
        optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4, weight_decay=1e-4),
        loss="softmax_ce", num_epochs=PIPE_EPOCHS, batch_size=MESH_BATCH,
        feature_columns=[f"t{i}" for i in range(GLUE_SEQ)],
        label_column="label", feature_dtype=np.int32, label_dtype=np.int32,
        mesh=spec, seed=0, shuffle=False, epoch_mode="stream",
        device="cuda")
    est.param_placements()  # builds the mesh: every rank calls it
    dp = est.mesh.coords["dp"]
    half = len(check_ids) // 2
    logits = est.predict(check_ids[dp * half:(dp + 1) * half])
    rows = len(cols["label"]) // 2
    shard = {k: v[dp * rows:(dp + 1) * rows] for k, v in cols.items()}
    history = est.fit(MLDataset([shard], 1))
    return {"check_logits": logits.tolist(), "history": history,
            "launches": _counts(),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "stage_shapes": [list(p.shape) for n, p in
                             est.get_model().named_parameters()
                             if n.startswith("stages.")][:2]}


# Phase 20, in 19's gang: criteo_dlrm over dp2·tp2 (phase 5's weights and
# rows, 8 steps at batch 1,024), and the MoE classifier at bert_base width
# cut to FT_LAYERS blocks over dp2·tp2 (4 steps at batch 32 x 128).
EXPERT_MESH = dict(dp=2, tp=2)
EXPERT_DLRM_STEPS, EXPERT_MOE_STEPS = 8, 4
# Kept slots of a layer and step (of 8,192) that the gang may differ by
# from the one-rank fit: in bf16, tp's split attention rounds the tokens
# otherwise and flips near-tie top choices (24 at most in a CPU rehearsal
# at tiny width; the float32 CPU tests hold the routing exactly). The
# gang's ranks agree exactly: they count the dp group's tokens.
KEPT_ATOL = 82


def _dp_half(cols, batch, dp):
    """Dp rank ``dp``'s rows of a fit over global batches of ``batch``:
    its half of each, in order (the one-rank reference's batches)."""
    import numpy as np

    n = len(cols["label"])
    idx = np.concatenate([np.arange(b + dp * batch // 2,
                                    b + (dp + 1) * batch // 2)
                          for b in range(0, n, batch)])
    return {k: v[idx] for k, v in cols.items()}


def expert_fit(kind, cols, mesh=None):
    """20's fit of ``kind`` (``"dlrm"`` or ``"moe"``): on ``mesh`` (a dict
    of axes) in a rank of 19's gang, each dp rank on its half of each
    global batch, or on this process alone. Returns its step losses, the
    MoE's kept slots a step and layer, the rank's launches, peak memory,
    table rows and bytes, the tp collectives' stats and the epoch's
    metrics."""
    import numpy as np
    import torch

    import raydp_tpu_torch as P
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.models import dlrm
    from raydp_tpu_torch.models.moe import MoELayer
    from raydp_tpu_torch.parallel import collectives as C

    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps, kept = [], []
    spec = P.MeshSpec(**mesh) if mesh else P.MeshSpec()
    if kind == "dlrm":
        cfg = P.criteo_dlrm()
        model = P.PackedDLRM(cfg, device="cuda",
                             generator=torch.Generator().manual_seed(12))
        names = [f"I{i}" for i in range(cfg.dense_features)] + [
            f"C{t}" for t in range(cfg.n_tables)]
        batch, layers = DLRM_BATCH, None
        kw = dict(loss=_recording_loss(steps, "bce"),
                  optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3,
                                                        weight_decay=1e-2),
                  logical_rules=dlrm.LOGICAL_RULES)
    else:
        cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                          dropout_rate=0.0, max_len=GLUE_SEQ,
                          n_layers=FT_LAYERS)
        model = P.MoEClassifier(cfg, P.MoEConfig(), 2, device="cuda",
                                generator=torch.Generator().manual_seed(13))
        names = [f"t{i}" for i in range(GLUE_SEQ)]
        batch = GLUE_BATCH
        layers = [m for m in model.modules() if isinstance(m, MoELayer)]
        kw = dict(loss=_recording_loss(steps, "softmax_ce", layers, kept),
                  optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4,
                                                        weight_decay=1e-2),
                  aux_losses=True, feature_dtype=np.int32,
                  label_dtype=np.int32)
    est = P.Estimator(
        model=model, num_epochs=1, batch_size=batch // spec.dp,
        feature_columns=names, label_column="label", mesh=spec, seed=0,
        shuffle=False, epoch_mode="stream", device="cuda", **kw)
    est.param_placements()  # builds the mesh: every rank calls it
    if mesh:
        cols = _dp_half(cols, batch, est.mesh.coords["dp"])
    C.reset_stats()
    C.set_timing(bool(mesh))
    t0 = time.perf_counter()
    history = est.fit(MLDataset([cols], 1))
    seconds = time.perf_counter() - t0
    C.set_timing(False)
    out = {"step_losses": [float(v) for v in steps],
           "kept": [[float(k) for k in step] for step in kept],
           "launches": _counts(), "peak_bytes":
           torch.cuda.max_memory_allocated(), "collectives": C.stats(),
           "metrics": {k: v for k, v in history[-1].items()
                       if isinstance(v, (int, float))},
           "seconds": seconds}
    if kind == "dlrm":
        tables = model.dlrm.emb
        out["table_rows"] = [int(t.table.shape[0]) for t in tables]
        out["table_bytes"] = sum(t.table.numel() * t.table.element_size()
                                 for t in tables)
        out["impl"] = tables[0].impl
    else:
        out["experts"] = [list(layers[0].w_up.shape)]
    del est, model
    torch.cuda.empty_cache()
    return out


def expert_part(dlrm_cols, moe_cols):
    """20, run in every rank of 19's gang after 19b: :func:`expert_fit` of
    the DLRM, then of the MoE classifier, over ``EXPERT_MESH``."""
    t0 = time.perf_counter()
    out = {"dlrm": expert_fit("dlrm", dlrm_cols, EXPERT_MESH),
           "moe": expert_fit("moe", moe_cols, EXPERT_MESH)}
    out["seconds"] = time.perf_counter() - t0
    return out


def check_expert(torch, P, ref, ranks):
    """20's checks and lines: each rank's fits (``ranks``, from the gang)
    against the one-rank fits (``ref``)."""
    import numpy as np

    cfg = P.criteo_dlrm()
    moe = P.MoEConfig()
    # Predicted before the first run: FT_LAYERS launches of each flash
    # kernel a step a rank (a rank runs its 6 heads in one launch), no
    # other forward; the DLRM runs none.
    want_moe = {k: FT_LAYERS * EXPERT_MOE_STEPS for k in KERNEL_SYMBOLS}
    no_flash = {k: 0 for k in KERNEL_SYMBOLS}
    rd, rm = ref["dlrm"], ref["moe"]
    # A rank records its dp half's mean loss: the halves' mean is the
    # global batch's (ranks 0-1 are dp 0, 2-3 dp 1).
    mean = {kind: np.mean([ranks[0][kind]["step_losses"],
                           ranks[2][kind]["step_losses"]], axis=0)
            for kind in ("dlrm", "moe")}
    check(len(rd["step_losses"]) == EXPERT_DLRM_STEPS
          and len(rm["step_losses"]) == EXPERT_MOE_STEPS,
          f"20: the one-rank fits ran {len(rd['step_losses'])} and "
          f"{len(rm['step_losses'])} steps")
    for r, m in enumerate(ranks):
        d, e = m["dlrm"], m["moe"]
        check(d["table_rows"] == [v // EXPERT_MESH["tp"]
                                  for v in cfg.vocab_sizes],
              f"20a: rank {r} holds {d['table_rows'][:3]}... table rows")
        check(d["step_losses"] == ranks[r ^ 1]["dlrm"]["step_losses"],
              f"20a: rank {r}'s step losses are not its tp peer's")
        check(d["launches"] == no_flash,
              f"20a: rank {r} launched flash kernels {d['launches']}")
        check(e["experts"][0][0] == moe.n_experts // EXPERT_MESH["dp"]
              and e["experts"][0][2] == moe.d_ff // EXPERT_MESH["tp"],
              f"20b: rank {r} holds w_up {e['experts'][0]}")
        check(e["kept"] == ranks[0]["moe"]["kept"],
              f"20b: rank {r}'s kept slots {e['kept']} are not rank 0's "
              f"{ranks[0]['moe']['kept']}")
        check(np.allclose(e["kept"], rm["kept"], rtol=0, atol=KEPT_ATOL),
              f"20b: rank {r}'s kept slots {e['kept']} are more than "
              f"{KEPT_ATOL} from the one-rank fit's {rm['kept']}")
        check(e["step_losses"] == ranks[r ^ 1]["moe"]["step_losses"],
              f"20b: rank {r}'s step losses are not its tp peer's")
        check(e["launches"] == want_moe,
              f"20b: rank {r} counted {e['launches']}, want {want_moe}")
    for kind, want in (("dlrm", rd), ("moe", rm)):
        check(np.allclose(mean[kind], want["step_losses"], **FIT_TOL),
              f"20: the gang's {kind} step losses {np.round(mean[kind], 4)} "
              f"(the dp halves' mean) are not the one-rank fit's "
              f"{np.round(want['step_losses'], 4)} (6e-2)")
    d0, e0 = ranks[0]["dlrm"], ranks[0]["moe"]
    tp_bytes = cfg.n_tables * (DLRM_BATCH // 2) * cfg.embed_dim * 4
    log(f"[20a] criteo_dlrm over MeshSpec(dp=2, tp=2) in 19's gang, "
        f"{EXPERT_DLRM_STEPS} steps at batch {DLRM_BATCH} ({DLRM_BATCH // 2} "
        f"a dp rank), lookups {d0['impl']} (the cut table's local-row "
        f"gather): step losses (the dp halves' mean) max diff from the "
        f"one-rank fit "
        f"{np.abs(mean['dlrm'] - rd['step_losses']).max():.4f}"
        f" (6e-2); the one-rank fit {rd['seconds']:.1f} s, its peak "
        f"{rd['peak_bytes'] / 2**30:.3f} GiB; the tp reduction of the "
        f"lookups {tp_bytes} bytes a step forward (26 f32 [512, 128] sums)")
    for r, m in enumerate(ranks):
        d = m["dlrm"]
        col = d["collectives"]
        log(f"[20a] rank {r}: table bytes {d['table_bytes']} "
            f"({d['table_rows'][0]} rows a table), peak "
            f"{d['peak_bytes'] / 2**30:.3f} GiB, {d['metrics']['step_ms']:.2f}"
            f" ms a step, {d['metrics']['allreduce_ms']:.2f} ms of it in the "
            f"dp gradient exchange (CUDA events); tp collectives "
            f"{col['calls'] / EXPERT_DLRM_STEPS:.0f} calls, "
            f"{col['collective_ms'] / EXPERT_DLRM_STEPS:.2f} ms and "
            f"{col['staged_bytes'] / EXPERT_DLRM_STEPS / 2**20:.2f} MiB staged"
            f" a step; fit {d['seconds']:.1f} s (host clock)")
    log(f"[20] in 19's gang: {max(m['seconds'] for m in ranks):.1f} s a "
        f"rank (host clock; the ranks' slowest), the one-rank references "
        f"{rd['seconds'] + rm['seconds']:.1f} s of fit")
    log(f"[20b] MoEClassifier (bert_base width, {FT_LAYERS} blocks, 8 "
        f"experts of d_ff 3072, top-2, capacity factor 1.25, flash) over "
        f"MeshSpec(dp=2, tp=2), {EXPERT_MOE_STEPS} steps at batch "
        f"{GLUE_BATCH} x {GLUE_SEQ}: kept slots a step and layer "
        f"{e0['kept']} on every rank, {rm['kept']} on one rank (of "
        f"{GLUE_BATCH * GLUE_SEQ * moe.top_k} a layer; capacity "
        f"{moe.capacity(GLUE_BATCH * GLUE_SEQ)}); step losses max diff from the one-rank fit "
        f"{np.abs(mean['moe'] - rm['step_losses']).max():.4f}"
        f"; launches a rank {e0['launches']} (predicted {want_moe}); the "
        f"one-rank fit {rm['seconds']:.1f} s, peak "
        f"{rm['peak_bytes'] / 2**30:.3f} GiB")
    for r, m in enumerate(ranks):
        e = m["moe"]
        col = e["collectives"]
        log(f"[20b] rank {r}: w_up {e['experts'][0]}, peak "
            f"{e['peak_bytes'] / 2**30:.3f} GiB, {e['metrics']['step_ms']:.2f}"
            f" ms a step, {e['metrics']['allreduce_ms']:.2f} ms in the "
            f"gradient exchange; collectives {col['calls'] / EXPERT_MOE_STEPS:.0f}"
            f" calls, {col['collective_ms'] / EXPERT_MOE_STEPS:.2f} ms and "
            f"{col['staged_bytes'] / EXPERT_MOE_STEPS / 2**20:.2f} MiB staged "
            f"a step; fit {e['seconds']:.1f} s")


def phase_mesh(torch, P, elastic_args):
    """19: model parallelism over one gang of 4 ranks on the one card
    (gloo: ranks share the card), each a mesh position. 19a
    ``fit_spmd(mesh=MeshSpec(sp=2, tp=2))`` of bert_base with ring
    attention against the same fit on one rank (dense attention, the same
    initial parameters and rows), the ranks' tp blocks, Ulysses against
    ring on the trained model, and the gathered checkpoint on one rank;
    19b, in the same ranks after 19a's fit, a dp2·pp2
    ``PipelinedClassifier`` with the flash kernels against its stages in
    sequence, its loss falling and its launch counts; then 20 and 21a
    (``elastic_args``: 21's rows and checkpoint directory) in the same
    ranks. Returns 19a's, 19b's and 20b's launch counts of each rank and
    20b's one-rank fit's, and each rank's 21a result."""
    import shutil
    import tempfile

    import numpy as np

    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.models import PipelinedClassifier

    full = synthetic_glue(np, ETL_GLUE_ROWS, GLUE_SEQ, 30522)
    cols = {k: v[:MESH_ROWS].astype(np.int32) for k, v in full.items()}
    feats = [f"t{i}" for i in range(GLUE_SEQ)]
    check_ids = np.stack([cols[c][:MESH_CHECK_ROWS] for c in feats], 1)
    pcols = {k: v[:PIPE_ROWS] for k, v in cols.items()}
    pids = check_ids[:PIPE_CHECK_ROWS]
    expert_cols = (
        criteo_columns(np, P.criteo_dlrm(), DLRM_BATCH * EXPERT_DLRM_STEPS,
                       seed=11),
        glue_columns(np, GLUE_BATCH * EXPERT_MOE_STEPS, GLUE_SEQ, 30522,
                     seed=5)[1])
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-19a-")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts = []
    try:
        # 19a's reference: the same fit on one rank, dense attention.
        ref_steps = []
        _reset_counts()
        cfg = P.bert_base(attention_impl="dense", dtype=torch.bfloat16,
                          max_len=GLUE_SEQ, dropout_rate=0.0)
        ref = P.Estimator(
            model=P.SequenceClassifier(
                cfg, device="cuda", generator=torch.Generator().manual_seed(9)),
            optimizer=lambda p: torch.optim.AdamW(p, lr=2e-5,
                                                  weight_decay=1e-4),
            loss=_recording_loss(ref_steps), num_epochs=1,
            batch_size=MESH_BATCH, feature_columns=feats,
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, seed=0, shuffle=False,
            epoch_mode="stream", device="cuda")
        t0 = time.perf_counter()
        ref.fit(MLDataset([cols], 1))
        ref_s = time.perf_counter() - t0
        ref_losses = [float(v) for v in ref_steps]
        del ref
        torch.cuda.empty_cache()
        # 20's references: the same fits on this process alone.
        t20 = time.perf_counter()
        expert_ref = {kind: expert_fit(kind, c) for kind, c in
                      zip(("dlrm", "moe"), expert_cols)}
        log(f"[20] the one-rank reference fits {time.perf_counter() - t20:.1f}"
            f" s (host clock)")

        called, t0 = time.time(), time.perf_counter()
        out = P.fit_spmd(mesh_fit_factory(dict(sp=2, tp=2), ckpt, check_ids,
                                          pcols, pids, expert_cols,
                                          elastic_args),
                         MLDataset([cols], 1), world_size=4,
                         mesh=P.MeshSpec(sp=2, tp=2), env=MESH_ENV,
                         timeout=MESH_LIMIT_S)
        fit_s = time.perf_counter() - t0
        last = [h[-1] for h in out["per_rank_history"]]
        steps = MESH_ROWS // MESH_BATCH
        for r, m in enumerate(last):
            got = m["step_losses"]
            check(len(got) == steps and len(ref_losses) == steps,
                  f"19a: rank {r} ran {len(got)} steps, the reference "
                  f"{len(ref_losses)}, want {steps}")
            check(np.allclose(got, ref_losses, **FIT_TOL),
                  f"19a: rank {r}'s step losses {np.round(got, 4)} are not "
                  f"the 1-rank fit's {np.round(ref_losses, 4)} (6e-2)")
            tp_half = {"qkv": [3 * 768 // 2, 768], "out": [768, 384],
                       "mlp_up": [3072 // 2, 768], "mlp_down": [768, 1536]}
            check(m["shapes"] == tp_half,
                  f"19a: rank {r} holds {m['shapes']}, want {tp_half}")
            ring, uly = np.asarray(m["ring"]), np.asarray(m["ulysses"])
            check(np.allclose(uly, ring, **TOL["bfloat16"]),
                  f"19a: rank {r}'s Ulysses logits differ from the ring's "
                  f"by {np.abs(uly - ring).max():.4f}")
            check(m["launches"] == {k: 0 for k in m["launches"]},
                  f"19a: ring attention launched flash kernels "
                  f"{m['launches']}")
        check(len(set(out["per_rank_params_sha256"])) == 1,
              "19a: the ranks' gathered parameters differ")
        one = P.Estimator(
            model=P.SequenceClassifier(P.bert_base(
                attention_impl="ring", dtype=torch.bfloat16,
                max_len=GLUE_SEQ, dropout_rate=0.0), device="cuda"),
            optimizer=lambda p: torch.optim.AdamW(p, lr=2e-5,
                                                  weight_decay=1e-4),
            batch_size=MESH_BATCH, feature_dtype=np.int32, device="cuda")
        one.restore(ckpt, step=0)
        restored = one.predict(check_ids)
        ring0 = np.asarray(last[0]["ring"])
        check(np.allclose(restored, ring0, **LOGIT_TOL),
              f"19a: the gathered checkpoint on one rank predicts "
              f"{np.abs(restored - ring0).max():.4f} away from the mesh")
        del one
        torch.cuda.empty_cache()
        log(f"[19a] fit_spmd over MeshSpec(sp=2, tp=2): 4 ranks, backend "
            f"{out['backend']}, {steps} steps at batch {MESH_BATCH} (dp=1: "
            f"every rank reads the same rows); start() {out['start_s']:.3f} "
            f"s, fit_spmd {fit_s:.1f} s in all (19b included), the first "
            f"step {min(m['first_step_at'] for m in last) - called:.1f} s "
            f"after the call, the 1-rank reference fit "
            f"{ref_s:.1f} s (host clock); step losses within 6e-2 of the "
            f"1-rank fit's (max diff "
            f"{np.abs(np.asarray(last[0]['step_losses']) - ref_losses).max():.4f});"
            f" Ulysses vs ring logits max diff "
            f"{np.abs(np.asarray(last[0]['ulysses']) - ring0).max():.4f}; "
            f"restored on one rank max diff "
            f"{np.abs(restored - ring0).max():.4f}")
        for r, m in enumerate(last):
            col = m["collectives"]
            log(f"[19a] rank {r}: {m['step_ms']:.2f} ms a step, "
                f"{m['allreduce_ms']:.2f} ms of it in the gradient exchange "
                f"(CUDA events, the epoch's mean); tp/sp collectives "
                f"{col['calls'] / steps:.0f} calls and "
                f"{col['collective_ms'] / steps:.2f} ms a step (CUDA events "
                f"around each, forward, backward and the two predicts "
                f"included), {col['staged_bytes'] / steps / 2**20:.2f} MiB "
                f"a step staged through the host; peak device memory "
                f"{m['peak_bytes'] / 2**30:.3f} GiB; block 0 holds "
                f"{m['shapes']}")
        counts += [m["launches"] for m in last]

        plast = [m["pipe"] for m in last]
        seq = PipelinedClassifier(
            P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                        max_len=GLUE_SEQ, dropout_rate=0.0, n_layers=2),
            P.MeshSpec(dp=2, pp=2), n_microbatches=4, device="cuda",
            generator=torch.Generator().manual_seed(11)).eval()
        with torch.no_grad():
            want = seq(torch.from_numpy(pids).cuda()).float().cpu().numpy()
        del seq
        psteps = PIPE_EPOCHS * (PIPE_ROWS // 2) // MESH_BATCH
        n_mb, blocks = 4, 1
        # Predicted before the run: 1 block a stage x 4 microbatches x 12
        # steps = 48 of each kernel, plus the check forward's 4 (one
        # microbatch a row pair) forward launches.
        want_counts = {k: blocks * n_mb * psteps for k in KERNEL_SYMBOLS}
        want_counts["flash_fwd"] += n_mb
        half = len(pids) // 2
        diffs = []
        for r, m in enumerate(plast):
            dp = r // 2
            got = np.asarray(m["check_logits"])
            diffs.append(np.abs(got - want[dp * half:(dp + 1) * half]).max())
            check(np.allclose(got, want[dp * half:(dp + 1) * half],
                              **LOGIT_TOL),
                  f"19b: rank {r}'s pipelined logits differ from the "
                  f"stages in sequence by {diffs[-1]:.4f}")
            check(m["launches"] == want_counts,
                  f"19b: rank {r} counted {m['launches']}, want "
                  f"{want_counts}")
            check(m["stage_shapes"][0][0] == 1,
                  f"19b: rank {r} holds {m['stage_shapes']} of the stages")
            losses = [h["train_loss"] for h in m["history"]]
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"19b: rank {r}'s pipelined loss did not fall: {losses}")
        losses = [h["train_loss"] for h in plast[0]["history"]]
        log(f"[19b] in 19a's gang: MeshSpec(dp=2, pp=2), a "
            f"PipelinedClassifier at bert_base width (2 blocks, one a "
            f"stage), flash, 4 microbatches, {psteps} steps a rank at batch "
            f"{MESH_BATCH}; losses {[round(v, 4) for v in losses]}; each "
            f"rank's launches {plast[0]['launches']} (predicted "
            f"{want_counts}); logits vs the stages in sequence max diff "
            + ", ".join(f"{d:.4f}" for d in diffs))
        for r, m in enumerate(plast):
            h = m["history"][-1]
            log(f"[19b] rank {r}: {h['step_ms']:.2f} ms a step, "
                f"{h['allreduce_ms']:.2f} ms in the gradient exchange "
                f"(CUDA events), peak {m['peak_bytes'] / 2**30:.3f} GiB "
                f"(19a's estimator still held)")
        counts += [m["launches"] for m in plast]
        check_expert(torch, P, expert_ref, [m["expert"] for m in last])
        counts += [m["expert"]["moe"]["launches"] for m in last]
        counts.append(expert_ref["moe"]["launches"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, [m["elastic"] for m in last]


# Phase 21: a mesh in an elastic fit. 21a in 19's gang after 20: 10c's
# bf16 flash classifier at bert_base width cut to FT_LAYERS blocks over
# MeshSpec(dp=2, tp=2), ELASTIC_K steps at batch 32 a dp rank, then a
# gathered checkpoint; 21b: fit_spmd(mesh=dp2·tp2, elastic=True) over
# the same rows (2 shards of ELASTIC_SHARD_STEPS batches) whose first
# launch registers 2 of 4 ranks, relaunched on MeshSpec(tp=2).
ELASTIC_BATCH, ELASTIC_K, ELASTIC_SHARD_STEPS = 32, 3, 6
ELASTIC_LIMIT_S = 600.0


def elastic_estimator(mesh, record, attention="flash", callbacks=()):
    """21's estimator: 10c's bf16 classifier at bert_base width cut to
    ``FT_LAYERS`` blocks, dropout 0, its initial parameters from
    generator seed 14, AdamW 2e-5, batch ``ELASTIC_BATCH`` a dp rank,
    the stream path, unshuffled, over ``mesh`` (None: one rank); each
    step's loss kept in ``record``."""
    import numpy as np
    import torch

    import raydp_tpu_torch as P

    cfg = P.bert_base(attention_impl=attention, dtype=torch.bfloat16,
                      max_len=GLUE_SEQ, dropout_rate=0.0,
                      n_layers=FT_LAYERS)
    return P.Estimator(
        model=P.SequenceClassifier(
            cfg, device="cuda", generator=torch.Generator().manual_seed(14)),
        optimizer=lambda p: torch.optim.AdamW(p, lr=2e-5, weight_decay=1e-4),
        loss=_recording_loss(record), num_epochs=1,
        batch_size=ELASTIC_BATCH,
        feature_columns=[f"t{i}" for i in range(GLUE_SEQ)],
        label_column="label", feature_dtype=np.int32, label_dtype=np.int32,
        mesh=mesh, seed=0, shuffle=False, epoch_mode="stream",
        callbacks=list(callbacks), device="cuda")


def elastic_blocks(cols):
    """21's rows as two blocks, block i the shard of dp index i."""
    half = len(cols["label"]) // 2
    return [{k: v[:half] for k, v in cols.items()},
            {k: v[half:] for k, v in cols.items()}]


def elastic_part(cols, ckpt):
    """21a, run in every rank of 19's gang after 20: ``ELASTIC_K`` steps
    of :func:`elastic_estimator` over ``MeshSpec(dp=2, tp=2)``, each dp
    rank on the first ``ELASTIC_K`` batches of its shard, then a gathered
    checkpoint ``step_mid_<K>.pt`` in ``ckpt`` at that data position
    (every rank enters the save). Returns the rank's step losses,
    launches, peak memory, step and exchange ms, tp collectives' stats,
    and the fit's and the save's seconds."""
    import torch

    import raydp_tpu_torch as P
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.parallel import collectives as C

    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    est = elastic_estimator(P.MeshSpec(**EXPERT_MESH), steps)
    est.param_placements()  # builds the mesh: every rank calls it
    block = elastic_blocks(cols)[est.mesh.coords["dp"]]
    rows = {k: v[:ELASTIC_K * ELASTIC_BATCH] for k, v in block.items()}
    C.reset_stats()
    C.set_timing(True)
    t0 = time.perf_counter()
    history = est.fit(MLDataset([rows], 1))
    fit_s = time.perf_counter() - t0
    C.set_timing(False)
    collectives = C.stats()  # the fit's, not the save's gathers
    t0 = time.perf_counter()
    path = est.save(ckpt, step=f"mid_{ELASTIC_K}",
                    data_position=(0, ELASTIC_K))
    out = {"step_losses": [float(v) for v in steps], "path": path,
           "launches": _counts(),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "step_ms": history[-1]["step_ms"],
           "allreduce_ms": history[-1]["allreduce_ms"],
           "collectives": collectives, "fit_s": fit_s,
           "save_s": time.perf_counter() - t0}
    del est
    torch.cuda.empty_cache()
    return out


def elastic_factory():
    """21b's estimator factory, run in each rank of the relaunch:
    :func:`elastic_estimator` over the mesh of the world it runs in (dp
    rows of tp 2, ``fit_spmd``'s contract for an elastic mesh). Its
    callback adds to the epoch's metrics the rank's step losses, launch
    counts, peak memory, tp collectives' stats and resume skip."""
    def make_estimator():
        import torch
        import torch.distributed as dist

        import chip_smoke as cs
        import raydp_tpu_torch as P
        from raydp_tpu_torch.parallel import collectives as C

        steps = []

        class ElasticProbe(P.TrainingCallback):
            est = None

            def on_train_end(self, history):
                m = history[-1]
                m["launches"] = cs._counts()
                m["peak_bytes"] = torch.cuda.max_memory_allocated()
                m["collectives"] = C.stats()
                m["step_losses"] = [float(v) for v in steps]
                m["resume_skip"] = self.est.resume_skip

        cs._reset_counts()
        C.reset_stats()
        C.set_timing(True)
        torch.cuda.reset_peak_memory_stats()
        probe = ElasticProbe()
        est = cs.elastic_estimator(
            P.MeshSpec(dp=dist.get_world_size() // 2, tp=2), steps,
            callbacks=[probe])
        probe.est = est
        return est

    return make_estimator


def _short_first_launch(registered):
    """``create_spmd_job`` for 21b: the first job's ``start`` reports only
    ``registered`` of its ranks up (no process starts); later jobs start
    as they are. Returns the wrapper and the worlds of the jobs made."""
    from raydp_tpu_torch import spmd
    from raydp_tpu_torch.spmd.job import SPMDJobError

    real, made = spmd.create_spmd_job, []

    def create(**kwargs):
        job = real(**kwargs)
        made.append(kwargs["world_size"])
        if len(made) == 1:
            def short_start():
                del job.start  # the relaunch starts for real
                job.last_registered = registered
                raise SPMDJobError(
                    f"job {job.job_name}: only {registered}/"
                    f"{kwargs['world_size']} ranks registered (stubbed)")
            job.start = short_start
        return job

    return create, made


def phase_mesh_elastic(torch, P, cols, ckpt, part_a):
    """21a's checks (``part_a``: the gang's ranks' results) and 21b: the
    elastic mesh fit from 21a's checkpoint, its first launch short of 2
    ranks, against the same resume on one rank with dense attention.
    Returns the relaunch's ranks' launch counts and the reference's."""
    import numpy as np

    from raydp_tpu_torch import spmd
    from raydp_tpu_torch.data import MLDataset

    want_a = {k: FT_LAYERS * ELASTIC_K for k in KERNEL_SYMBOLS}
    for r, m in enumerate(part_a):
        check(len(m["step_losses"]) == ELASTIC_K
              and np.all(np.isfinite(m["step_losses"])),
              f"21a: rank {r}'s step losses {m['step_losses']}")
        check(m["step_losses"] == part_a[r ^ 1]["step_losses"],
              f"21a: rank {r}'s step losses are not its tp peer's")
        check(m["launches"] == want_a,
              f"21a: rank {r} counted {m['launches']}, want {want_a}")
    path = part_a[0]["path"]
    check(os.path.isfile(path), f"21a: no gathered checkpoint at {path}")
    log(f"[21a] in 19's gang: {ELASTIC_K} steps over MeshSpec(dp=2, tp=2) "
        f"of the bf16 flash classifier at bert_base width, {FT_LAYERS} "
        f"blocks, batch {ELASTIC_BATCH} a dp rank; step losses "
        f"{[round(v, 4) for v in part_a[0]['step_losses']]}; the gathered "
        f"checkpoint {os.path.getsize(path) / 2**20:.1f} MiB in "
        f"{max(m['save_s'] for m in part_a):.2f} s (host clock); launches "
        f"a rank {part_a[0]['launches']} (predicted {want_a}); peak "
        + ", ".join(f"{m['peak_bytes'] / 2**30:.3f}" for m in part_a)
        + " GiB a rank (19a's estimator still held)")
    for r, m in enumerate(part_a):
        col = m["collectives"]
        log(f"[21a] rank {r}: {m['step_ms']:.2f} ms a step, "
            f"{m['allreduce_ms']:.2f} ms of it in the dp gradient exchange "
            f"(CUDA events); tp collectives {col['calls'] / ELASTIC_K:.0f} "
            f"calls, {col['collective_ms'] / ELASTIC_K:.2f} ms a step; fit "
            f"{m['fit_s']:.1f} s, save {m['save_s']:.2f} s (host clock)")

    blocks = elastic_blocks(cols)
    create, made = _short_first_launch(2)
    real = spmd.create_spmd_job
    spmd.create_spmd_job = create
    try:
        called, t0 = time.time(), time.perf_counter()
        out = P.fit_spmd(elastic_factory(), MLDataset(blocks, num_shards=2),
                         world_size=4, mesh=P.MeshSpec(**EXPERT_MESH),
                         elastic=True, checkpoint_dir=ckpt, env=MESH_ENV,
                         restart_backoff_s=0.5, timeout=ELASTIC_LIMIT_S)
        fit_s = time.perf_counter() - t0
    finally:
        spmd.create_spmd_job = real
    last = [h[-1] for h in out["per_rank_history"]]
    # Predicted before the first run: dp 2 ran ELASTIC_K of its
    # ELASTIC_SHARD_STEPS batches, so at dp 1 the skip is 2 * ELASTIC_K of
    # the 2 * ELASTIC_SHARD_STEPS batches, and each tp rank launches
    # FT_LAYERS of each kernel a step of the rest.
    skip = 2 * ELASTIC_K
    steps = 2 * ELASTIC_SHARD_STEPS - skip
    want_b = {k: FT_LAYERS * steps for k in KERNEL_SYMBOLS}
    check(made == [4, 2] and out["world_size"] == 2
          and out["restarts"] == 1,
          f"21b: jobs of {made} ranks, world {out['world_size']}, "
          f"{out['restarts']} restarts; want [4, 2], 2 and 1")
    check(len(set(out["per_rank_params_sha256"])) == 1,
          "21b: the tp ranks' gathered parameters differ")
    for r, m in enumerate(last):
        check(m["resume_skip"] == skip,
              f"21b: rank {r} skipped {m['resume_skip']}, want {skip}")
        check(m["samples"] == steps * ELASTIC_BATCH,
              f"21b: rank {r} trained {m['samples']} samples, want "
              f"{steps * ELASTIC_BATCH}")
        check(m["launches"] == want_b,
              f"21b: rank {r} counted {m['launches']}, want {want_b}")

    # The same resume on one rank: dense attention, the same checkpoint.
    ref_steps = []
    _reset_counts()
    ref = elastic_estimator(None, ref_steps, attention="dense")
    ref.fit(MLDataset(blocks, num_shards=1), resume_from=path)
    ref_launches = _counts()
    ref_losses = [float(v) for v in ref_steps]
    check(ref.resume_skip == skip and len(ref_losses) == steps,
          f"21b: the one-rank resume skipped {ref.resume_skip} and ran "
          f"{len(ref_losses)} steps")
    del ref
    torch.cuda.empty_cache()
    for r, m in enumerate(last):
        check(np.allclose(m["step_losses"], ref_losses, **FIT_TOL),
              f"21b: rank {r}'s resumed step losses "
              f"{np.round(m['step_losses'], 4)} are not the one-rank "
              f"resume's {np.round(ref_losses, 4)} (6e-2)")
    diff = np.abs(np.asarray(last[0]["step_losses"]) - ref_losses).max()
    log(f"[21b] fit_spmd(mesh=MeshSpec(dp=2, tp=2), elastic=True) from "
        f"21a's checkpoint: the first launch registered 2 of 4 ranks "
        f"(stubbed), the relaunch ran MeshSpec(tp=2) on 2 ranks, backend "
        f"{out['backend']}, the rows re-planned over dp 1, skip "
        f"{last[0]['resume_skip']} of {2 * ELASTIC_SHARD_STEPS} batches "
        f"(rescaled from {ELASTIC_K} at dp 2), {steps} steps; the first "
        f"resumed step {min(m['first_step_at'] for m in last) - called:.1f}"
        f" s after the call (host clock; start() {out['start_s']:.3f} s, "
        f"fit_spmd {fit_s:.1f} s in all); step losses "
        f"{[round(v, 4) for v in last[0]['step_losses']]}, max diff from "
        f"the one-rank dense resume {diff:.4f} (6e-2); launches a rank "
        f"{last[0]['launches']} (predicted {want_b})")
    for r, m in enumerate(last):
        col = m["collectives"]
        log(f"[21b] rank {r}: {m['step_ms']:.2f} ms a step, "
            f"{m['allreduce_ms']:.2f} ms of it in the gradient exchange "
            f"(CUDA events); tp collectives {col['calls'] / steps:.0f} "
            f"calls, {col['collective_ms'] / steps:.2f} ms and "
            f"{col['staged_bytes'] / steps / 2**20:.2f} MiB staged a step; "
            f"peak {m['peak_bytes'] / 2**30:.3f} GiB")
    return [m["launches"] for m in last], ref_launches


# 21c's command: ``python -m raydp_tpu_torch.analysis raydp_tpu_torch/``
# with JAX and the JAX package made unimportable first, as on a machine
# without them.
STATIC_CMD = ("import runpy, sys; sys.modules.update(jax=None, raydp_tpu=None);"
              " sys.argv = ['raydpcheck', 'raydp_tpu_torch/'];"
              " runpy.run_module('raydp_tpu_torch.analysis', run_name='__main__')")


def phase_static():
    """21c: the port's static checker over the port, in a process of
    its own that cannot import JAX: exit 0 and zero findings."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", STATIC_CMD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    check(proc.returncode == 0 and last.startswith("raydpcheck: 0 finding("),
          f"21c: raydpcheck exited {proc.returncode}: "
          f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    log(f"[21c] python -m raydp_tpu_torch.analysis raydp_tpu_torch/ with "
        f"jax and raydp_tpu unimportable: {last}; {seconds:.2f} s with the "
        f"process's start")


def main() -> int:
    bytecode_cache_on()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import raydp_tpu_torch as P
    except ImportError as e:
        print(f"chip_smoke: cannot import raydp_tpu_torch next to this "
              f"script ({e})", file=sys.stderr)
        return 3

    t0 = time.perf_counter()
    start_log_on()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}; "
        f"{gpu_line()}")

    fwd_entry, wgmma = phase_kernel(torch, P)
    entries = [fwd_entry] + phase_backward_kernels(torch, P)
    f32 = time_f32_kernels(torch, wgmma)
    log(f"[time] phase 1 done at {time.perf_counter() - t0:.1f} s")
    for e in entries:
        if e["name"] in f32:
            e["f32"] = f32[e["name"]]
    glue_launches = phase_glue(torch, P)
    log(f"[time] phase 2 done at {time.perf_counter() - t0:.1f} s")
    decode_launches = phase_decode(torch, P)
    log(f"[time] phase 3 done at {time.perf_counter() - t0:.1f} s")
    phase_grad_check(torch, P)
    fit_counts, scan_losses = phase_finetune(torch, P)
    log(f"[time] phase 4a-4b done at {time.perf_counter() - t0:.1f} s")
    plane_counts = phase_device_plane(torch, P)
    log(f"[time] phase 16a-16b done at {time.perf_counter() - t0:.1f} s")
    lm_counts = phase_causal_lm(torch, P)
    remat_counts = phase_remat(torch, P, scan_losses)
    log(f"[time] phase 4c-4d done at {time.perf_counter() - t0:.1f} s")
    phase_dlrm(torch, P)
    moe_counts = phase_moe(torch, P)
    log(f"[time] phase 5-6 done at {time.perf_counter() - t0:.1f} s")
    import numpy as np

    train, test = _split(np, taxi_columns(np, GBT_ROWS))
    phase_gbt(torch, P, train, test)
    phase_tf(torch, P, train, test)
    log(f"[time] phase 7-8 done at {time.perf_counter() - t0:.1f} s")
    _reset_counts()
    serve = phase_serve_batch(torch, P)
    serve_bf16_driver = _counts()["flash_fwd"]
    _reset_counts()
    decode_replica_launches = phase_serve_decode(torch, P)
    log(f"[time] phase 9 done at {time.perf_counter() - t0:.1f} s")
    start_report("9")
    serve_f32_driver = _counts()["flash_fwd"]
    etl_counts, etl_ref = phase_etl(torch, P)
    log(f"[time] phase 10 done at {time.perf_counter() - t0:.1f} s")
    session_counts, session_ref = phase_session(torch, P, etl_ref)
    log(f"[time] phase 11 done at {time.perf_counter() - t0:.1f} s")
    start_report("11")
    client, gang = phase_second_drivers(torch, P, session_ref)
    log(f"[time] phase 12 done at {time.perf_counter() - t0:.1f} s")
    start_report("12")
    gang_fit = phase_window_and_gang(torch, P)
    log(f"[time] phase 13 done at {time.perf_counter() - t0:.1f} s")
    start_report("13")
    t17 = time.perf_counter()
    ft_counts, cp_replica_launches = phase_fault_tolerance(torch, P)
    phase_autoscale(P)
    log(f"[time] phases 14, 18b and 17 done at "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"[17] 17c done; phases 14 and 17 {time.perf_counter() - t17:.1f} s")
    start_report("14-18b-17")
    telemetry_counts = phase_telemetry(torch, P)
    log(f"[time] phase 15 done at {time.perf_counter() - t0:.1f} s")
    start_report("15")
    # 18a's process runs beside phases 19-20: its own session, its own
    # fit on the card.
    cli = start_compat_cli()
    t19 = time.perf_counter()
    import shutil
    import tempfile

    ck21 = tempfile.mkdtemp(prefix="chip-smoke-21-")
    cols21 = glue_columns(np, 2 * ELASTIC_SHARD_STEPS * ELASTIC_BATCH,
                          GLUE_SEQ, 30522, seed=21)[1]
    mesh_counts, part_a = phase_mesh(torch, P, (cols21, ck21))
    log(f"[time] phases 19, 20 and 21a done at "
        f"{time.perf_counter() - t0:.1f} s ({time.perf_counter() - t19:.1f} s)")
    t21 = time.perf_counter()
    try:
        elastic_counts, elastic_ref = phase_mesh_elastic(torch, P, cols21,
                                                         ck21, part_a)
    finally:
        shutil.rmtree(ck21, ignore_errors=True)
    phase_static()
    log(f"[time] 21b-21c done at {time.perf_counter() - t0:.1f} s "
        f"({time.perf_counter() - t21:.1f} s)")
    cli_counts = phase_compat_cli(torch, P, cli)
    log(f"[time] 18a done at {time.perf_counter() - t0:.1f} s")
    start_report("18a-19-20-21")
    start_summary()
    serve_launches = (sum(serve["replica_launches"]) + serve_bf16_driver
                      + decode_replica_launches + serve_f32_driver
                      + cp_replica_launches)
    fits = {"fine-tune": fit_counts, "causal LM": lm_counts,
            "remat fine-tune": remat_counts, "MoE": moe_counts,
            "fine-tune from a DataFrame": etl_counts,
            "fine-tune from a cluster frame": session_counts,
            "fine-tune through connect()": client["counts"],
            "16a-16b plane fits": plane_counts}
    for r, counts in enumerate(gang["probe_counts"]):
        fits[f"16c 12b gang probe rank {r}"] = counts
    for r, counts in enumerate(gang_fit):
        fits[f"fit_spmd rank {r}"] = counts
    fits.update(ft_counts)
    for r, counts in enumerate(telemetry_counts):
        fits[f"15 fit_spmd rank {r}"] = counts
    fits["18a CLI driver"] = cli_counts
    for r, counts in enumerate(mesh_counts):
        tag = (f"19a rank {r}" if r < 4 else f"19b rank {r - 4}" if r < 8
               else f"20b rank {r - 8}" if r < 12 else "20b one-rank fit")
        fits[tag] = counts
    for r, m in enumerate(part_a):
        fits[f"21a rank {r}"] = m["launches"]
    for r, counts in enumerate(elastic_counts):
        fits[f"21b rank {r}"] = counts
    fits["21b one-rank resume"] = elastic_ref
    for e in entries:
        name = e["name"]
        e["launches"] = sum(c[name] for c in fits.values())
        if name == "flash_fwd":
            e["launches"] += (glue_launches + decode_launches
                              + serve_launches + gang["launches"])
        check(e["launches"] > 0, f"the main path launched no {name}")
    log(f"[main path] flash_fwd launches: GLUE forward {glue_launches}, "
        f"decode server and its reference {decode_launches} (the f32 "
        f"ones; no f32 backward runs on the main path); by fit: "
        + "; ".join(f"{tag} {c}" for tag, c in fits.items())
        + f"; serve plane {serve_launches}: batch replicas "
        f"{' + '.join(map(str, serve['replica_launches']))} (by Ping at "
        f"the end of the clean run and of the serve_kill run), the "
        f"driver's bf16 flash forward {serve_bf16_driver} (the in-process "
        f"rate), decode replica {decode_replica_launches}, the driver's "
        f"f32 reference_decode {serve_f32_driver}, 17b's replica "
        f"{cp_replica_launches} (by Ping); the SPMD gang's ranks "
        f"{' + '.join(map(str, gang['rank_launches']))} (each rank's own "
        f"counter, returned in its result)")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
