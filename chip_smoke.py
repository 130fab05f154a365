"""Chip smoke of the PyTorch/CUDA port: build, check, serve and train on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure (nothing is caught to let the run exit 0):

1. Environment: the card's name and power limit (nvidia-smi), then every
   kernel of the serving and training paths built from
   flexflow_tpu_torch/csrc/ by one nvcc per source (five sources), all
   started together, with the build time, and the registers and spills
   that ptxas reports for each kernel (the three bf16 tensor-core
   kernels, flash forward, dQ and dK/dV, among them).
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the GPT-2 medium paths give them, in bf16 and in f32 (TF32 is off for
   every float32 product here, so f32 is compared at 1e-4): the flash
   forward and the int8 dequant decode at the serving shapes (the decode
   through the page table, over a pool of 8 x 66 + 1 pages of 16 under a
   shuffled table, and through its gathered call; and at the speculative
   verify pass's 5 query rows, timed with its bound), the flash
   backward's dQ and dK/dV at the training shape (8, 1024, 16, 64) causal,
   the fused Adam over GPT-2 medium's real param set (f32 and bf16
   moments, weight decay 0 and 0.01), the fused cross-entropy forward and
   backward at (8192, 50304) (GPT-2 medium's vocab padded to 128, bf16 and
   f32), and the fused SGD with and without a momentum trace over the
   padded model's param set. Each kernel is timed with CUDA
   events (L2 flushed before every launch, the device held busy while the
   host enqueues it; see `Timer`) beside its plain version, one
   library call computing the same function (timed here only; the port
   never calls it) and its bound. Each optimizer kernel is timed in turns
   with its library call, with the card's clocks read before and after,
   and its row carries the median of the per-pair ratios
   (`library_ratio`). The rows of the flash forward, dQ and dK/dV also
   carry their achieved TFLOP/s, their share of the bound and their
   design, the dequant decode's its share of the bound, its design and
   the timer's floor for a call that small (one tiny kernel). The
   forward's lse is held to the plain lse at 1e-4, and its bf16 O element
   by element to a bound on the rounding of P (see
   `flash_bf16_o_bound`); bf16 dQ is held element by element to a bound
   on the rounding of dS (`_dq_bf16_bound` in the flash module). The
   flash forward, dQ and dK/dV are also held and timed without the mask
   at BERT-base's attention shape (8, 512, 12, 64), beside SDPA with
   is_causal=False (the `_noncausal` rows).
3. Serving: GPT-2 medium at full width and depth with random weights from
   the seed, bf16 compute, 8 slots, 16 requests of 32 new tokens, through
   `compile_serving` and `ContinuousBatchingScheduler`, once with the
   compute-dtype KV cache and once with the int8 cache. Every launch
   counter is set to 0 just before each run and read just after; a kernel
   of the path that was not launched fails the run. Each run's first
   prefill is repeated through the plain versions and compared.
4. Where the time goes: after each run, torch.profiler over two prefills
   and 16 decode steps of that engine (8 slots busy): host wall time per
   call, the device's busy time and idle share, the top kernels, and the
   host's `aten::index` calls (gathers); the int8 decode step fails if it
   gathers once a layer or more (on the host, or a gather kernel among the
   top kernels).
5. Training, through `FFModel.compile` and the `CompiledModel`:
   (a) gradient check: GPT-2 medium widths at 2 layers, one step through
       the kernels and one through the plain versions from the same
       params, in f32 and bf16: loss, every gradient, the updated params;
   (b) GPT-2 medium at full depth, b8, seq 1024, dropout 0, bf16, Adam
       1e-4: 2 warm-up and 10 timed steps on one batch, with step time,
       samples/s, tokens/s, MFU, peak memory and the loss at every step;
       the launch counters are set to 0 before the 12 steps and read after,
       and each step must have launched the flash forward, dQ and dK/dV
       once per layer, Adam once and nothing else; the optimizer's pointer
       table must be built in the first step and never again;
   (c) one `fit` epoch over 4 batches with `sync_every=0`, no table built;
   (d) torch.profiler over two train steps;
   (e) gradient check as (a), with the vocab padded to 128 (the fused
       cross-entropy kernels) and SGD with momentum (the fused SGD kernel);
       the update compared is -lr times the stored trace, and every
       updated param is held to the rounding bound of `sgd_param_excess`;
   (f) GPT-2 medium at full depth with the vocab padded to 128, b8, seq
       1024, bf16, SGD(0.01, momentum 0.9): 2 warm-up and 10 timed steps,
       reported and checked as (b); each step must launch the flash
       forward, dQ and dK/dV once per layer, each cross-entropy kernel and
       the SGD kernel once, and nothing else;
   (g) one `fit` epoch over 4 batches with `accum_steps=2`, SGD(0.01)
       without momentum, `sync_every=0`: 2 updates, 4 launches of each
       cross-entropy kernel and 2 of the trace-less SGD kernel, one table
       built;
   (h) torch.profiler over two steps of (f).
6. GPT-2 medium at its published dropout of 0.1, the vocab padded to 128,
   bf16, Adam(1e-4) (fused CE, fused Adam; the attention takes the einsum
   path under dropout, as the JAX lowering does):
   (a) 2 layers: every mask one step draws keeps within 5 sigma of the
       binomial around 0.9; the same (key, layer) draws the same mask
       twice; the next step's key another; remat "full" and "dots" on
       every layer of the same model give the loss of remat off exactly
       and its gradients within `REMAT_GRAD_TOL` (expected bitwise; the
       count of bitwise-equal gradients is printed);
   (b) full depth, 6 steps with remat off and 6 with `FFConfig(remat=
       True)` ("full" on every layer; 2 warm-up, `P6_TIMED_STEPS` timed),
       reported as 5b; each step launches each CE kernel and Adam once and
       no flash kernel;
   (c) full depth at dropout 0, 6 steps with remat off and 6 with remat
       "full": the flash forward launches 48 times a step (the forward
       and its recompute), dQ and dK/dV 24; the losses of the two runs
       agree within `RUN_LOSS_RTOL`;
   (d) `fit` at full width, `FIT_LAYERS` deep (the cut is printed),
       through `prefetch_to_device`: an uninterrupted epoch of 6 updates;
       the same fit with durable snapshots every 2 updates in a temporary
       directory, sent SIGTERM from a callback after update 3, which must
       raise `Preempted` with a committed snapshot of update 4; a freshly
       compiled model restored with resume="auto", whose params and
       moments must equal the snapshot bitwise and whose losses must
       agree with the uninterrupted run's; then an explicit async save
       (the snapshot ms on the caller thread, the write seconds after it
       returned, the bytes) and its restore seconds. The directory is
       removed at the end.

7. The strategy search (`FFModel.compile` with `search_budget`,
   search/, parallel/machine.py) on the H100 machine model, at GPT-2
   medium b8 s1024 bf16 (dropout 0, Adam(1e-4)):
   (a) `MachineSpec.detect()` on the card: chip, rates and the card's
       memory size (it must be "h100"), beside a timed pinned
       host-to-device copy (the measured `host_bw`);
   (b) the bf16 GEMM sweep that sets the preset's `mxu_flop_overhead`
       (the four projections) and `mxu_min_dim` (mlp_up at per-shard
       widths 4096/dm, dm 1..64), printed beside the preset; then
       `MeasuredCost` over every distinct op of the model at the
       single-device layout and at each candidate of the 8-way `model`
       axis: fwd and bwd ms, the analytic op time and their ratio; the
       flash forward, dQ and dK/dV counters must rise while attention is
       measured (a measurement that raises fails the phase);
   (c) four compiles that search and export: one 8-GPU NVSwitch node
       (`search_num_workers=8`) and two nodes over NDR
       (`search_num_nodes=2`), each priced analytic and measured on this
       card (`profiling`): compile seconds, DP expansions, the best cost
       beside the data-parallel strategy's and the Megatron template's on
       the same cost model, and the chosen candidates by kind; the best
       must not cost more than data parallel, and each measured compile
       must launch the flash kernels (counted from 0 around it). A fifth
       compile of the first must hit the strategy cache with 0 DP
       expansions and give the same strategy;
   (d) the 5b model compiled with the one-node strategy imported
       (`import_strategy_file`): 2 steps from the seed, with exact
       launches (one device applies none of the shardings);
   (e) the same model without the file: 5b's 12 steps, whose first 2
       losses must equal (d)'s bitwise; `predicted_step_time()` analytic
       and with 7b's measured costs beside the measured step ms, and
       `memory_stats()`' predictions beside `max_memory_allocated`, with
       their ratios (no threshold: the cost model's error on the card is
       the finding).

8. Speculative serving and SLO-aware admission, run right after phase 4
   on phase 3's prompts and weights, GPT-2 medium cut to
   `SERVE_CUT_LAYERS` (4) of its 24 layers at full width (phases 12 and
   13 serve the same cut model; the time limit's cut), against that
   model's own greedy streams (32 new tokens), served first as phase 3
   serves (`cut_serving`); "phase 3's" streams below are the cut model's,
   and the small draft is GPT-2 small's widths at the same depth:
   (a-d) four legs at K=4, {int8, compute-dtype KV} x {GPT-2 small as the
       draft, from seed + 1; the self-draft, GPT-2 medium carrying the
       target's params}. Each serves, measures the decode-verify gap
       (the largest |decode - verify| logit difference, teacher-forced on
       the plain and the speculative streams from fresh prefills, the
       verify pass taking K+1 of their tokens at a time), then holds its
       streams
       against phase 3's: a request may diverge only where a fresh prefill
       of its prompt and shared prefix puts the two candidate tokens'
       logits closer than twice the gap, and every such divergence is
       printed. Launches are exact (counted from 0 around the run): the
       flash forward once per target and draft layer an admission wave;
       with int8, the dequant decode K x L_draft times at 1 row and
       L_target times at K+1 rows a round.
       Both caches get every page back, `memory_stats()` predicts both
       caches' bytes exactly, the self-draft accepts at least 0.9 of its
       drafts, and each leg prints tokens/s, TTFT p50/p99, the time per
       committed token p50, rounds, host syncs and the acceptance rate;
       torch.profiler over 4 rounds of the int8 GPT-2 small leg gives the
       round's device busy time, idle share and launches;
   (gate) int8 at K=7 (8 query rows) serves one wave as a leg does, and
       K=8 raises at compile time;
   (e) the int8 engine without a draft serves the 16 prompts as an
       open-loop trace (exponential gaps of 40 ms, priorities 0/1/2) with
       `serve_queue_cap=4`, `prefill_chunk_tokens=2048` and SLO objectives,
       printing the sheds by reason and the SLO report;
   (f) the same engine serves 4 requests under a 2 ms decode watchdog,
       which evicts the longest-resident slot at every sync.
   In (e) and (f) every request ends exactly once and every page comes
   back.

9. The JAX bench's other training workloads, run after phase 7, each
   built by the port's builders at full width and trained in bf16 compute
   over f32 master weights through `FFModel.compile` and `train_step`,
   with cuDNN's autotuner on for the phase (`cudnn.benchmark`):
   (f, g) gradient checks as 5a's, one step through the kernels and one
       through the plain versions from the same params, in f32 and bf16:
       ResNet-50's widths at 2 blocks under SGD(0.025, momentum 0.9,
       weight decay 1e-4) (the fused SGD over a conv/BN param set; 5e's
       tolerances) and BERT-base's at 2 layers, dropout 0 (the flash
       kernels non-causal inside a model, and Adam), whose relu FFN
       takes the wider `GRAD_TOL_RELU`;
   (a) ResNet-50 (build_resnet50's defaults: b64, 3x224x224, 1000
       classes) under that SGD; then one `fit` epoch of 4 batches with
       the accuracy metric through the prefetching loader, and
       `evaluate`, which must read the running stats (moved from 0 and 1,
       finite; evaluating without them gives another loss);
   (b) ResNeXt-50 32x4d as bench.py builds it (b64, groups 32, width 128,
       no residual), Adam(1e-4);
   (c) BERT-base as bench.py builds it (b8, seq 512, vocab 30522, 12
       layers) at its blocks' dropout of 0.1, Adam(1e-4): the attention
       takes the einsum path, no flash launch;
   (d) the same at dropout 0: the flash forward, dQ and dK/dV once a
       layer a step, non-causal;
   (e) DLRM as bench.py builds it (b4096, 8 tables of 100,000 x 64,
       sum-pooled, MSE on f32 labels), Adam(1e-4), one dispatch a step.
   Each leg: 2 warm-up and 10 timed steps on one batch, reported as 5b
   with MFU by the port's count (3 x the registry's forward flops a step
   over 989 TFLOP/s), exact launches per step (the fused SGD or Adam
   once, and in (d) the flash kernels once a layer), every loss finite;
   then torch.profiler over one step (busy ms, idle share, launches, top
   kernels). The phase logs its wall time.

10. The K-step CUDA graph (`make_multi_step(K)`: K train steps captured
    once, one replay a dispatch), on the models phases 5 and 9 compiled
    and tuned, right after each: 5b and 5f (GPT-2 medium, Adam; padded
    vocab, SGD with momentum), 9a-9e; K is 4, DLRM's 20 (`graph_leg`):
    (a) from one snapshot, 2K eager steps twice and 2 dispatches on the
        same batches and keys: bitwise equal where the eager runs are,
        else within their difference (printed); on 9c (dropout 0.1) one
        batch group dispatched at i0 and at i0 + K gives two losses;
    (b) torch.profiler: one cudaGraphLaunch a dispatch, the port's
        kernels replayed with the counts of K eager steps. The launch
        counters count a kernel where the graph captures it (the
        warm-up step and the K captured steps), never at a replay: the
        profile is what shows the replayed kernels;
    (c) step ms eager against graph in turns, the graph's busy ms and
        idle share, capture seconds and the graph pool's bytes beside
        `max_memory_allocated`;
    (d) one fit epoch of 2K + 1 batches, steps_per_dispatch=K,
        sync_every=0, dispatch_ahead 2: step_stats as JAX counts them
        (3 dispatches, 2K fused steps, 0 host syncs, 1 barrier), no new
        capture;
    (e) on 9e, the same fit under the fault plan `fit/dispatch@3*1`:
        one retry, and the params of (d).
    A capture that fails raises: nothing falls back to eager steps.

11. Telemetry, run health and per-op attribution (telemetry.py,
    health.py, attribution.py), before phase 12, on GPT-2 medium as 5b
    trains it (b8, seq 1024, dropout 0, bf16 over f32 masters, Adam
    1e-4) at `P11_LAYERS` (6) of its 24 layers (the time limit's cut),
    compiled anew after the peak memory is reset;
    each fit is 2 epochs of a few batches:
    (a) eager and then steps_per_dispatch 4, each four times from one
        snapshot with everything off, on, on, off (on: telemetry and the
        sentinels): the same step_stats, the same launches (eager: a
        step's; K = 4: the capture's, each run capturing anew) and
        bitwise the same params; the step ms of each (the drift
        monitor's median after the first epoch) are printed; a graph
        dispatch profiled off and on (kernels, busy, idle); and the
        sentinels' own cost: a K = 4 graph captured off and one on,
        replayed in turns 10 times each, and 10 pairs of 2 eager steps;
    (b) each run's stream with telemetry on holds the events fit emits
        in JAX's counts (the CPU test holds them to JAX's): dispatches,
        prefetch waits, host syncs, barriers, epochs, goodput and
        watermarks, and a fit/drift event;
    (c) a fit under `profiling` and `profile_ops` (one step a dispatch:
        a replay's kernels carry no layer), then
        `op_attribution(source="trace")`: the attributed sum within
        SUM_TOLERANCE of the measured step, its coverage (the credited
        share of the trace's device time) printed, every attention
        layer credited with the flash forward, dQ and dK/dV kernels, the
        top rows and the top 3 by drift printed;
    (d) at FIT_LAYERS deep (each durable snapshot writes the params and
        moments), eager and K = 2, under `health/nonfinite@3` with the
        sentinels, `halt_on_nonfinite`, a snapshot every 2 updates and a
        host sync every update: NonFiniteError at the step the CPU test
        gives (3 eager, 4 at K = 2), naming the snapshot of step 2; a
        fresh model resumed from it trains with finite losses;
    (e) `health_report()`'s watermark (the allocator's peak, the graph
        pools included) against `memory_stats()`' predicted peak, with
        the warning as it falls, and `goodput_report()`'s buckets and
        residual (the buckets must account for 95% of the wall);
    (f) run with phase 3: its int8 leg again with telemetry on: one
        serve/request_admitted and one serve/request_done a request, one
        serve/decode_step span a decode step.

12. The rest of one-card serving, run last on phase 8's cut model, its
    weights (kept on the host from phase 8 on), prompts and greedy
    streams (GPT-2 medium's widths, 4 layers, 8 slots, page 16, 66 pages
    a slot), in a temporary directory removed at the end:
    (a) the tiered KV cache (`kv_host_pages` 396, three quarters of every
        slot's pages, so the device pool holds 132 data pages and
        scratch), with the bf16 cache and the int8 one: phase 3's 16
        prompts of 32 new tokens, whose streams must equal phase 3's
        bitwise, with at least 8 spills and 8 rejoins (each a hit or a
        stall), the int8 dequant decode launched once a layer on every
        decode step, every page back on its free list, `memory_stats()`
        at 133 device pages with the host bytes beside them, and host
        syncs (counted by torch's sync debug mode) equal to the
        materializations, the prefills and one a spill: refills and
        rejoins add none. Each leg prints the spills, refills, hits,
        stalls and bytes each way, the median spill and refill device ms
        (CUDA events) against a timed pinned host-to-device copy, and the
        decode step against the same engine untiered in the same call
        (also held to phase 3's streams) and phase 3's: the run's p50,
        and 4 profiled steps at 8 slots of 224-token prompts;
    (c) phase 3's int8 run with request tracing off, on, on, off (the on
        runs export the offered load through `serve_trace_out`): the
        streams are phase 3's, the materializations equal, every
        request's stages account for at least 0.95 of its wall, and the
        exported trace loads and replays to the same requests; the decode
        step p50 of each run is printed;
    (b) hot-swap on that engine: durable snapshots of GPT-2 medium by the
        port's checkpoint writer, A (phase 3's params) and B (A perturbed
        from the seed); the engine watches the root and takes A; B lands
        after the first admission wave of a run, which swaps exactly once
        and completes every request, those admitted after the swap
        equal to a fresh engine loaded with B; `rollback()` pins A
        (phase 3's streams, `poll_swap` then False), `unpin()` brings B
        back (B's streams); a snapshot of GPT-2 medium at 2 layers is
        rejected (`serve/swap_rejected`) while a run serves B's streams.
        The swap latency (placement and a device sync included) and the
        bytes placed are printed;
    (d) `health_report()` of the tiered engines (the `kv_tier` panel) and
        of the swapping one (the swap ledger, the SLO scoreboard, the
        watermark from the allocator's peak since that engine was made),
        and `op_attribution()` of its prefill and decode programs (each op
        measured in isolation, the decode attention over its cache's full
        context), printed.
    The phase logs its wall time and each part's.

13. The serving fleet and the capacity twin, run last on phase 8's cut
    model, weights, prompts and greedy streams: two int8 engines of GPT-2
    medium's widths at 4 layers (8 slots, page 16), each with half of
    every slot's pages on
    the host (264: the disaggregated handoff travels through the host
    tier of every replica), serving phase 3's 16 prompts of 32 new
    tokens; where arrivals are open loop they come at 50 requests/s by
    `tracefmt.poisson_records` timing from the seed. Every launch counter
    is set to 0 just before each run and read just after; each check is
    fatal:
    (a) a one-replica colocated `ServingFleet` against the plain
        scheduler on the same engine, every request at time 0 (no count
        then hangs on the clock): streams bitwise, the flash forward's
        and the dequant decode's launches equal, host syncs (torch's
        sync debug mode) equal;
    (b) two replicas colocated (`least_loaded`) and disaggregated (one
        prefill, one decode replica) on the open-loop trace: per request
        the streams of both equal each other and phase 3's int8 streams;
        disagg hands every request off exactly once (16 handoffs, 16
        imports) with `kv_handoff_bytes` the pages each request was
        admitted with x layers x the spec's page bytes; in both, the
        dequant decode launches 24 x the replicas' decode steps and the
        flash forward 24 x their prefills. Each handoff's export and
        import (host copies) ms and GB/s are printed beside phase 12's
        pinned host-to-device rate. The colocated run exports its trace
        (`serve_trace_out`);
    (c) the rolling swap: both replicas watch an empty root; a durable
        snapshot of phase 3's params (step 2, by phase 12's snapshot
        trainer) lands after the first prefill; replica 0 swaps, then
        replica 1, no request is dropped and every stream is phase 3's.
        Both engines carry a TTFT objective of 1 ms (every request
        breaks it; the first run sets no burn ceiling). A second run with
        `rollout_burn_max` 1 publishes step 3: replica 0 swaps and is
        rolled back, the rollout freezes, and replica 1 never swaps
        though it serves on after the rollback: the port's controller
        holds replica 1 until replica 0's burn has been judged (a bake
        the JAX controller lacks), and its count of held safe points is
        printed. The `serve/fleet_rollout` events come in the
        controller's order;
    (d) scaling, reported only: aggregate decode tokens/s, TTFT p50 and
        p99 at one and at two colocated replicas with the load per
        replica held equal (16 requests, 50 a second, each), and each
        one's device idle share from a profiled run of the same load;
    (e) the twin against live: (b)'s colocated trace replayed through
        `serving/twin.py` with costs from the live report
        (`TwinCosts.resolve`) and the window overhead calibrated from the
        live wall time: `validate(live, twin)` is printed; the twin must
        complete every request and its report carry the live report's
        keys (the error itself is a finding, not a gate).
    The phase logs its wall time and each part's.

14. The model zoo, run last: every model the JAX package builds that
    the earlier phases do not, built by the port's builders at their JAX
    defaults and trained in bf16 compute over f32 master weights, cuDNN's
    autotuner on; the optimizers those of tests/test_models.py where a
    test sets one (SGD 0.01), SGD(0.01, momentum 0.9, weight decay 5e-4)
    for AlexNet, Adam(1e-4) elsewhere:
    (a) gradient checks as 9f's (`grad_check`, f32 and bf16): MoE-MLP at
        its defaults under SGD(0.01) (#8; the update read as -lr g from
        the run's gradients), the branch ensemble at full width and one
        module under Adam (#7), AlexNet-CIFAR10 (b64) under the momentum
        SGD (#9), each at 5a's or 5e's tolerances;
    (b) AlexNet (b64, 224x224, 1000 classes, dropout 0.5), Inception-v3
        (b32, 299x299), the MLP (b64, 784, hidden 512 x 2), CANDLE Uno
        (b64, towers 4192 x 8, top 4192 x 4, MSE), XDL (b64, four
        1,000,000 x 64 tables), MoE-MLP (b64, 64 experts, top-2) and the
        branch ensemble (b1024, 4 modules of 4 branches): 2 warm-up and
        5 timed steps each (`train_leg`), the optimizer kernel exactly
        once a step, then one step profiled;
    (c) `fuse_fork_joins` before compile on Inception-v3 (JAX's pass fuses
        none of its regions: its concats join on the channel axis) and on
        the branch ensemble written in plain layers (4 regions): 2 steps
        from the unfused model's params against the unfused model's,
        expected bitwise, gated at `RUN_LOSS_RTOL`;
    (d) phase 10's `graph_leg` at K = 4 on MoE-MLP and the ensemble;
    (e) the ensemble searched for an H100 machine of data 8 x model 4,
        saved, imported on the card: 3 steps to the data-parallel
        compile's losses.
    The phase logs its wall time with the card's name and power limit.

15. The frontends, run last, each at full width in the port's default
    compute dtype (f32; TF32 off), cuDNN's autotuner on; every launch
    counter is set to 0 just before each leg's run and read just after,
    and each check is fatal:
    (a) BERT-base (vocab 30522, d 768, 12 layers, 12 heads, FFN 3072, an
        MLM head; b8, seq 512) written as a plain-PyTorch module
        (`P15Bert`: nn.Embedding for tokens and positions,
        nn.MultiheadAttention without masks, nn.LayerNorm, nn.Linear,
        nn.GELU) from the seed and moved to the card, imported by
        torch.fx: `PyTorchModel` -> `torch_to_ff` -> `compile(Adam,
        outputs=)` -> `import_weights` from the module on the card. The
        logits are held to the module's own forward (`P15_FWD_TOL`,
        relative to the largest logit); whether the fused cross-entropy
        gate admits the logits is printed (vocab 30522 is no multiple of
        128); then `train_leg` (2 warm-up and 6 timed steps, the flash
        forward, dQ and dK/dV once a layer and Adam once a step,
        non-causal; losses finite and falling); then `torch_to_file` ->
        `file_to_ff`: the same layer list and bitwise the same logits;
        then phase 9d's `build_bert` at the same dtype, timed the same
        way;
    (b) BASELINE #1 through the Keras API: `examples/keras/
        func_cifar10_alexnet.py`'s stack at 229 x 229 on
        `cifar10.load_data`'s synthetic data, `Model.compile(SGD(0.01))`
        -> `fit` for 2 epochs of 4 batches of 64 with EpochVerifyMetrics
        and VerifyMetrics (as in JAX: fit calls their `on_epoch_end`;
        `on_train_end` is called here, and a 101% target raises): the
        plain SGD kernel exactly once an update; then `train_leg` on the
        compiled model;
    (c) 12 pre-LN blocks at BERT-base's widths (b8, seq 512) in the ONNX
        op vocabulary of tests/test_onnx_frontend.py's block, written to
        a file by the port's own `onnx/proto.py` encoder and read back
        through `ONNXModel`: `apply` -> `compile(Adam, outputs=)` ->
        `import_weights`; the forward held to the same arithmetic in
        plain torch on the card (`P15_ONNX_TOL`); then `train_leg` under
        MSE (Adam once a step; losses falling);
    (d) `python -m flexflow_tpu_torch -b 64 --lr 0.05 -e 1 script.py
        --its-own-arg` in a subprocess: the script reads
        `get_launch_config()`, trains an MLP a fit epoch on the card
        under the compile's default optimizer and prints its argv, its
        config, its device and its launches (the plain SGD kernel 4
        times); it must exit 0 with all of them as given.
    Each step ms is printed beside phase 9d's and 14b's AlexNet leg; the
    phase logs its wall time with the card's name and power limit.

16. The rest of the one-card port, run last, each check fatal, every
    launch counter set to 0 just before each run and read just after:
    (a) config #5 (GPT-2 medium, b8, seq 1024, dropout 0, bf16, Adam)
        compiled with simulator_mode="taskgraph" and simulator_trace: the
        trace holds a fwd and a bwd task of every layer that is not a
        passthrough; the compiled step replayed with analytic and with
        measured op costs (MeasuredCost on the card) beside `train_leg`'s
        eager step and phase 10's K-step graph step; exposed
        communication 0 on one device; then the same model searched for
        2 nodes x 4 workers under "additive" and "taskgraph": each
        winner, its simulated makespan and hidden_frac, and whether the
        re-rank changed the pick;
    (c) on (a)'s model: a profile_ops fit into a telemetry dir (no
        native call in it, counted), span_dataset and refit; the 2 x 4 search under simulator_mode="learned" with that
        model (coverage above 0, hits, misses, candidates and finalists
        pruned, the model's path and fingerprint); learned against
        MeasuredCost op times (MAPE, the exact table and the ridge alone)
        and the predicted step (analytic, measured, learned, the learned
        replay) against the measured step; a fit with auto_refit=True
        writes a model whose new fingerprint makes the next learned
        compile a strategy-cache miss; 13e's replay priced with and
        without the learned rung, the rung refit from the twin's own
        residual rows (tokens/s against live, a finding);
    (b) MCMC on the 2 x 4 machine under both evaluators, each winner's
        simulated makespan beside Unity's; MCMC on the one-card machine,
        its strategy saved, imported and trained 2 steps;
    (d) the native batch_gather bitwise against numpy's index at GPT-2's
        b8 x 1024 int32 tokens and a 64 x 3 x 224 x 224 f32 image batch,
        timed against it; the native topological order of GPT-2
        medium's graph equal to the Python walk's, timed against it (the
        loader and the compile take the Python paths: these times are
        why);
    (e) a kernelspec installed into a temporary prefix from a
        reference-format config; a process with its environment parses
        the flags and fits an MLP on the card (the plain SGD kernel once
        an update); the port's quickstart notebook's one-device cells on
        the card, the loss falling; then its mesh cells as a kernel with
        `--mesh data=1,model=2` runs them: `run_over_mesh` starts two
        gloo ranks on the card, the searched strategy shards the weights,
        the loss falls, and the plain SGD kernel runs on each rank's
        leaves once an update;
    (f) the C API library built, examples/c/mlp_train.c compiled against
        it into build/flexflow_tpu_torch/ and run on the card: it prints
        C_API_OK, `forward_ok dims=2 (32, 4)` and a falling final_loss,
        the plain SGD kernel once an update (counted in the C program's
        process and written out at flexflow_finalize).
    The phase logs its wall time with the card's name and power limit.

17. Multi-GPU, first part, run last, each check fatal:
    (a) the process group started from torchrun's environment at world 1
        in this process (NCCL); config #5 compiled over {"data": 1}
        through the DeviceMesh and DTensor path beside the plain compile:
        a DTensor weight and the group live, the init bitwise equal, 3
        steps from the seed with the losses, the params and the launches
        (#1-#3 once a layer, #7 once a step) equal bitwise; eager step
        ms of both in turns, a profiled step of each (idle share, the
        port's kernels equal, the NCCL kernels seen); then phase 10's
        `graph_leg` on the mesh's model (the K-step CUDA graph captured
        over the process group) beside 5b's plain graph;
    (b) two spawned ranks on cuda:0 over gloo (NCCL refuses two ranks on
        one GPU): first which collectives gloo carries on CUDA tensors,
        c10d's in the ranks and the functional ones DTensor calls each
        in a pair of processes of its own (a crash kills only its pair),
        printed; then every leg they allow, config #5's widths at full
        depth, global batch 8, 2 Adam steps from the seed (`P17B_STEPS`,
        cut from 3 for phase 20's time): {"data": 2}
        with zero off, zero1 and zero2, and {"data": 1, "model": 2}
        under the Megatron template; each leg's losses within
        `P17_LOSS_RTOL` of (a)'s world-1 run, the params bitwise equal
        on both ranks, exact launches, and under ZeRO each rank's moment
        bytes half of world 1's; a leg gloo cannot carry is not started
        and is printed with why;
    (c) `python -m flexflow_tpu_torch --mesh data=1 -b 8 script.py` under
        torchrun's environment (one process): the launcher starts the
        group (NCCL), the script's MLP compiles over the mesh (DTensor
        weights) and fits 2 steps (the plain SGD kernel twice), exit 0.
    17b's pairs also probe c10d's point-to-point calls, its all-to-all
    with one nonzero split each way and the port's ring hop; its ranks
    then run 18c's legs.
18. Multi-GPU, second part, run last, each check fatal:
    (a) the ring's per-step functions (kernels/ring_attention.py) for
        P = 2 and 4 simulated ranks in one process, the hop a rotation of
        a list, at GPT-2 medium's heads, b1, seq 8192, bf16, causal:
        out, lse, dQ, dK and dV against #1-#3 over the whole sequence
        (`P18_OUT_RTOL`, `P18_GRAD_RTOL`, `LSE_TOL`) and at seq 1024
        against the ring's plain version (JAX's einsum chunk step); the
        launches of #1-#3, P(P+1)/2 each, counted and profiled (after a
        lead call); the ring timed against #1-#3 over the sequence, the
        plain ring and SDPA, beside its bound;
    (b) in 17a's group (NCCL, world 1), config #5 over {"model": 1} with
        every attention on the ring (`sequence_parallel_strategy`): its
        3 losses and its params bitwise 17a's plain compile's, #1-#3 and
        #7 counted as the plain path's (and the ring once a layer), a
        profiled step with no NCCL kernel;
    (c) in 17b's two gloo ranks on cuda:0, each leg the probe allows:
        `ring_attention`, the per-rank ring the main path calls, with
        real hops, at (a)'s shape and tolerances against #1-#3 over the
        whole sequence; the ring (config #5 over {"model": 2}, every
        attention on it, against 17a's world-1 run), expert
        parallelism (MoE-MLP over {"expert": 2}, each rank holding 32 of
        the 64 experts, SGD), the placed fork-join (the ensemble at its
        widths with 2 branches a module over {"model": 2}, stacked, each
        rank one branch, Adam): 3 steps against this process's world-1
        run (the losses within each leg's `P18_LOSS_RTOL`), the
        replicated params bitwise on both ranks, exact launches,
        each leg's step ms, idle share (rank 0) and bytes a rank; and the
        collective matmul at GPT-2 medium's MLP up-projection (x (8192,
        1024) @ w (1024, 4096), bf16): y and its gradients against f32
        products, timed against the all-gather and matmul it replaces. A
        leg whose collectives the probe found refused is not started and
        is printed with why.

19. Multi-GPU, third part: the pipeline (parallel/pipeline.py), run
    last, each check fatal, on gloo ranks sharing cuda:0 (NCCL refuses
    two ranks on one GPU), against this process's world-1 compile of
    config #5 at accum_steps=4 from the same weights:
    (d) config #5 compiled twice with the cut search on (S = 2, the H100
        preset) against one strategy cache: the cuts, the search's and
        the schedule's predicted step and bubble, the compile seconds;
        the second compile a cache hit with zero DP expansions;
    (a) config #5 over 2 stages of one rank, M = 4, under 1F1B and GPipe,
        3 updates each from the seed's weights: the schedules bitwise
        equal (losses and each stage's param digest), the losses within
        `P19_LOSS_RTOL` of world 1's, each stage about half the param
        and moment bytes, exact launches of #1-#3 and #7 on both ranks
        (and profiled after a lead call), ms an update, idle share, the
        measured bubble against `predicted_schedule()`'s;
    (b) the padded vocab under SGD over 2 stages, 1F1B, 2 updates: #5/#6
        in the last stage, #8 on both, losses against world 1's;
    (c) config #5's width at 8 layers over 4 stages on four ranks: 2
        updates, a snapshot, the next update; restored onto 2 stages on
        two ranks, that update within `P19_LOSS_RTOL`.

20. Serving over a mesh (serving/program.py `serving_optimize`, the
    engine, the heads-sharded KV pools and the lockstep scheduler), run
    last, GPT-2 medium at full width and depth, bf16, 8 slots, random
    weights from the seed, each check fatal:
    (a) world 1 with `search_budget=16` (one device searches nothing:
        both programs take the data-parallel strategy): phase 3's 16
        requests, bf16 and int8 KV, served bitwise phase 3's streams,
        with zero DP expansions;
    (b) two gloo ranks sharing cuda:0 over {"data": 1, "model": 2}
        (`P20_MESH`; on a one-axis mesh the search puts the slots on its
        only axis, data parallel, and shards no head), `search_budget=16`,
        int8 and bf16 KV: the searched prefill and decode layouts (the
        embeddings, the first block's attention and MLP, lm_head),
        `attn_head_degree`, `kv_shard_degree` and the KV bytes a rank
        against world 1's; each rank's prefill launches #1 on the heads
        of the prefill's layout (all 16 where its search replicates the
        attention) and its int8 decode #4 on its 8 of the 16 (the launch
        counters exact, a profile window after a lead call); world 1's
        tokens fed back
        (`P20_TF_STEPS` teacher-forced steps after the prefill), every
        last-position logit within `P20_LOGIT_TOL` of the largest of
        world 1's; `P20_REQUESTS` requests served in lockstep, the greedy
        tokens' agreement with world 1's, and tokens/s, TTFT and the
        decode step p50 as the host's cost of the mesh on one card (gloo's
        host copies carry the reductions: no parallel speed).

21. The serving fleet over a mesh (serving/fleet.py: two replicas, each
    SPMD over the same ranks, the card granted in rank 0's order), run
    last, in 20b's two gloo ranks sharing cuda:0 over `P20_MESH` after
    20b's legs (as 18c runs in 17b's): two int8
    engines a rank (`search_budget=16`, the heads sharded in two) on
    phase 13's cut model, weights and snapshots, 8 slots, pages of 16,
    `P13_HOST_PAGES` host pages, 8 of phase 3's prompts with 8 new tokens
    each, each check fatal:
    (a) a one-replica fleet bitwise the plain mesh scheduler on the same
        engine, #1 and #4 launched as often, exact;
    (b) two replicas, colocated and then disaggregated (one prefill, one
        decode), an open-loop trace at `P13_RATE` a replica: every stream
        (a)'s; disaggregated, each request handed off once and
        `kv_handoff_bytes` pages x layers x page bytes (each rank's host
        tier took its 8 heads' half); #4 4 x each replica's decode steps,
        #1 4 x its prefills; every rank's routes and handoffs rank 0's;
        rank 0 alone writes the trace; the host's cost a decode step and
        TTFT printed;
    (c) the rolling swap as 13c: replica 0 swaps, then replica 1, nothing
        dropped; with a burn ceiling replica 0 swaps, is rolled back and
        the rollout freezes; the swaps the same on both ranks;
    (d) the twin replays (b)'s colocated trace (rank 0's) with costs from
        the live report: every request completes, and its report carries
        the live report's keys.

22. The operator tools and the examples on the card (flexflow_tpu_torch/
    tools/, flexflow_tpu_torch/examples/), run last, each check fatal:
    (a) `python -m flexflow_tpu_torch.tools.trace_report` and `...monitor
        --once --prom-file` as subprocesses over the telemetry of 11a's
        first eager and K-step fits with telemetry on (the directories
        phase 11 keeps for this phase): both exit 0; the Chrome document
        passes `validate_chrome` and holds a fit/dispatch span a
        dispatch; the monitor's step count is the fit's dispatches; every
        sample line of the Prometheus file parses;
    (b) `profile_attribution.run` on the card (the GPT-2 twin, SGD, with
        fusion off: its head dim 16 is not the flash kernels', whose
        wrapper raises on it; the fused SGD kept on) and its contract
        (`verify`): the per-op times sum to the measured update, every
        row priced, the drift top-K's worst op the one furthest off, a
        non-empty corpus; #8 once an update, nothing else;
    (c) `calibrate` on the `mlp` and `gpt2_medium_block` rows (phase 16's
        MeasuredCost reused for the bf16 ops) and `measure_overlap` on one
        stream and on two: every column finite and positive, #1-#3 and #8
        launched;
    (d) the `transformer_lm` example through the launcher in a
        subprocess: exit 0, a finite FINAL loss, Adam (#7) and the fused
        cross-entropy (#5, #6: GPT-2 tiny's vocab 5120 is a multiple of
        128) once an update each; GPT-2 tiny trains at GPT2Config's
        default dropout 0.1, whose attention takes the einsum path, so
        #1-#3 stay at 0.
    In (b), (c) and (d) each kernel's first launch at each new signature
    (its tensors' shapes and dtypes) is also held against its plain
    version on the same inputs, at the tolerances of the kernel's own
    check (`ShadowKernels`): the CE kernels at GPT-2 tiny's logits, Adam
    on its leaves, the plain SGD on the twin's and the mlp's, #1-#3 at
    GPT-2 medium's block; a kernel launched but never so held fails.

The line before the last is `{"kernels": [...]}`, and the one before it
`{"ring_programs": [...]}` (the two ring programs, with the same keys);
the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from gc import collect as collect_garbage

import numpy as np
import torch
import torch.nn.functional as F

# the card's published peaks (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12   # outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# GPT-2 medium serving shapes (models/gpt2.py GPT2Config.medium)
SLOTS, SEQ, HEADS, HEAD_DIM, LAYERS = 8, 1024, 16, 64, 24
BATCH, LR, TRAIN_STEPS, WARMUP_STEPS = 8, 1e-4, 10, 2
# the padded-vocab SGD path: GPT2Config(vocab_pad_to=128) gives lm_head
# 50304 columns, which the fused cross-entropy gate admits; labels stay
# below GPT-2's true vocab of 50257
PAD_TO, PAD_VOCAB, GPT2_VOCAB, SGD_LR = 128, 50304, 50257, 0.01
PAGE, NEW_TOKENS, REQUESTS = 16, 32, 16
# phase 8: drafted tokens a round in the four legs, and in the gate leg
# (8 query rows: the dequant kernel's gate); 8e/8f's admission knobs
SPEC_K, SPEC_K_GATE = 4, 7
SLO_SPEC = "ttft_p99_ms=500,availability=0.99"
QUEUE_CAP, PREFILL_CHUNK, WATCHDOG_MS = 4, 2048, 2.0
# the design of the kernels redesigned for the tensor cores
TC_DESIGN = {
    "flash_attention_fwd": "mma.sync m16n8k16 bf16, 2 m-tiles a warp, "
                           "cp.async x2 (K, V), bf16 smem padded rows, "
                           "P in registers",
    "flash_attention_dq": "mma.sync m16n8k16 bf16, cp.async x2 (K, V), "
                          "bf16 smem padded rows, Q and dO fragments held, "
                          "dS in registers",
    "flash_attention_dkv": "mma.sync m16n8k16 bf16, cp.async x2 (Q, dO, "
                           "lse, delta), bf16 smem padded rows, P^T and "
                           "dS^T in registers"}
DEQUANT_DESIGN = ("split-K: grid (slot x head, 128-key chunk), 4 warps a "
                  "block each on its own 32-key tile, page table read in "
                  "the kernel, cp.async into per-warp buffers, f32 "
                  "softmax, int8 widened by byte permute, warps merged in "
                  "shared memory, chunks by the last block's atomic ticket")
CTX = -(-(SEQ + NEW_TOKENS) // PAGE) * PAGE        # 1056 cached positions
LSE_TOL = 1e-4   # the forward's lse: f32 sums of up to 1024 exponentials


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
class Timer:
    """Median milliseconds of one call, from CUDA events around each
    launch, with the L2 cache flushed before every launch (the serving
    path finds each layer's inputs cold). The device is held busy (a
    spin) while the host enqueues the call, so that the events time the
    device's work and not the host's: the spin lasts ~1 ms, or about twice
    the host's enqueue of the call in the warm-up where that is longer (the
    optimizer wrappers walk ~390 leaves in Python)."""

    HOLD_CYCLES = 2_000_000   # ~1 ms at the H100's clocks

    def __init__(self, reps: int = 20, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def hold_for(self, *fns) -> int:
        """Warm up each call; the spin, in cycles, that covers twice the
        median host enqueue of the slowest call."""
        enqueue_ms = 0.0
        for fn in fns:
            times = []
            for _ in range(self.warmup):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times.append(1e3 * (time.perf_counter() - t0))
            enqueue_ms = max(enqueue_ms, float(np.median(times)))
        torch.cuda.synchronize()
        return max(self.HOLD_CYCLES, int(2 * enqueue_ms * self.HOLD_CYCLES))

    def once(self, fn, hold: int) -> float:
        self.flush.zero_()
        torch.cuda._sleep(hold)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def __call__(self, fn) -> float:
        hold = self.hold_for(fn)
        return float(np.median([self.once(fn, hold)
                                for _ in range(self.reps)]))

    def alternate(self, kernel, library) -> dict:
        """The kernel and its library call timed in turns (kernel, library,
        kernel, ...), each with the same flush and spin: their medians and
        the median of the per-pair ratios kernel / library."""
        hold = self.hold_for(kernel, library)
        pairs = [(self.once(kernel, hold), self.once(library, hold))
                 for _ in range(self.reps)]
        k, lib = np.array(pairs).T
        return {"ms": float(np.median(k)), "library_ms": float(np.median(lib)),
                "library_ratio": float(np.median(k / lib)),
                "hold_cycles": hold}


def clocks() -> str:
    """The card's SM and memory clocks now (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tc_fields(name: str, flops: float, ms: float, bound_ms: float) -> dict:
    """What the rows of the redesigned kernels carry beside the others."""
    return {"tflops": flops / (ms * 1e-3) / 1e12, "bound_share": bound_ms / ms,
            "design": TC_DESIGN[name]}


def port_kernel_names() -> tuple:
    """The `__global__` functions of the port's CUDA sources: the names
    its kernels carry in a profile."""
    from flexflow_tpu_torch.kernels._build import CSRC_DIR

    return tuple(sorted({name for src in CSRC_DIR.glob("*.cu")
                         for name in re.findall(
                             r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\([^)]*\)\s+)?(\w+)\s*\(", src.read_text())}))


def flash_bf16_o_bound(q, k, v, causal: bool, scale: float):
    """The largest |O - plain O| allowed, element by element, for the bf16
    forward on (b, h, s, d) views. Both round each p_j to bf16 before P.V,
    but from exp(s - m) against other maxima (the kernel's running max,
    the plain version's final one), so each term p_j v_j / l carries its
    own rounding error in each: at most 2**-8 relative, with a standard
    deviation below 2**-7 / sqrt(12), so below 2**-7 / sqrt(6) in their
    difference. Allowed: ten standard deviations of that sum, 10 * 2**-7 /
    sqrt(6) * sqrt(sum_j (p_j v_j)**2) / l, capped at its worst case 2**-7
    * sum_j p_j |v_j| / l, plus 2 bf16 ulps of |O| for O's own rounding."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(s.shape[-2], s.shape[-1], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)                     # p_j / l
    vf = v.float()
    o = p @ vf
    rss = torch.sqrt((p * p) @ (vf * vf))
    noise = torch.minimum(10 * 2 ** -7 / 6 ** 0.5 * rss, 2 ** -7 * (p @ vf.abs()))
    _, e = torch.frexp(o.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return noise + 2 * torch.ldexp(torch.full_like(o, 2 ** -7), e - 1)


# ---------------------------------------------------------------- kernels
def row_name(name: str, causal: bool) -> str:
    """A flash row's name: the kernel's, `_noncausal` added without the
    mask (the launch counter stays the kernel's, `counter`)."""
    return name if causal else f"{name}_noncausal"


def check_flash(timer, gen, shape=(SLOTS, SEQ, HEADS, HEAD_DIM),
                causal=True):
    """The flash forward at `shape` (b, s, h, d), causal or not, against
    its plain version in f32 and bf16, timed beside SDPA."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    b, s, h, d = shape
    scale = d ** -0.5
    mask = "causal" if causal else "non-causal"
    errs, lse_errs = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(dt) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # (b, h, s, d)
        out, lse = fa._fwd(qt, kt, vt, causal, scale)
        torch.cuda.synchronize()
        ref, ref_lse = fa._fwd_plain(qt, kt, vt, causal, scale)
        errs[dt] = float((out.float() - ref.float()).abs().max())
        lse_errs[dt] = float((lse - ref_lse).abs().max())
        if not errs[dt] <= TOL[dt]:
            fail(f"flash {mask} {dt}: max err {errs[dt]} > {TOL[dt]}")
        if not lse_errs[dt] <= LSE_TOL:
            fail(f"flash {mask} {dt}: lse err {lse_errs[dt]} > {LSE_TOL}")
        log(f"flash_attention {tuple(q.shape)} {dt} {mask}: max abs err "
            f"{errs[dt]:.3e} (tolerance {TOL[dt]}), lse {lse_errs[dt]:.3e} "
            f"(tolerance {LSE_TOL})")
        if dt == torch.bfloat16:
            excess = float(((out.float() - ref.float()).abs()
                            / flash_bf16_o_bound(qt, kt, vt, causal, scale))
                           .max())
            if not excess <= 1.0:
                fail(f"flash {mask} bf16: O exceeds its element bound "
                     f"{excess}x")
            log(f"flash_attention {mask} bf16: O at most {excess:.3f} of "
                "its element-wise rounding bound")
    ms = timer(lambda: fa.flash_attention_qkv(q, k, v, causal=causal,
                                              scale=scale))
    plain_ms = timer(lambda: fa._fwd_plain(qt, kt, vt, causal, scale))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=scale))
    n = b * h * s * d
    flops = 4 * b * h * d * s * ((s + 1) / 2 if causal else s)
    bound_ms, bound_by = bound(4 * n * 2 + b * h * s * 4, flops, BF16_FLOPS)
    return {"name": row_name("flash_attention_fwd", causal),
            "counter": "flash_attention_fwd", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_attention.cu",
            "replaces": "flexflow_tpu/kernels/flash_attention.py:151",
            "shape": [b, s, h, d], "dtype": "bfloat16", "causal": causal,
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_f32": errs[torch.float32],
            "tolerance": TOL[torch.bfloat16], "o_bound_share": excess,
            "lse_err": lse_errs[torch.bfloat16],
            "lse_err_f32": lse_errs[torch.float32], "lse_tolerance": LSE_TOL,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention",
            **tc_fields("flash_attention_fwd", flops, ms, bound_ms)}


def check_dequant(timer, gen, seed):
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.serving.kv_cache import kv_quantize

    b, s, h, d, L = SLOTS, 1, HEADS, HEAD_DIM, CTX
    pages_per_slot = L // PAGE
    scale = d ** -0.5
    pool = (b * pages_per_slot + 1, PAGE, h, d)
    kq, ks = kv_quantize(torch.randn(pool, generator=gen, device="cuda"))
    vq, vs = kv_quantize(torch.randn(pool, generator=gen, device="cuda"))
    # a shuffled page table: every page but the scratch page 0 belongs to
    # one slot, in an order drawn from the seed
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(1, pool[0])).reshape(b, pages_per_slot)
    table = torch.from_numpy(ids.astype(np.int32)).cuda()
    # cached extents as the serving run meets them: prompt 32..992 plus
    # up to 32 decoded tokens
    pos_np = rng.integers(32, SEQ, size=b)
    pos = torch.from_numpy(pos_np.astype(np.int32)).cuda()
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        qh = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
        out = da.paged_dequant_decode_attention(qh, kq, ks, vq, vs, table,
                                                pos, scale)
        torch.cuda.synchronize()
        ref = da._paged_plain(qh, kq, ks, vq, vs, table, pos, scale)
        errs[dt] = float((out.float() - ref.float()).abs().max())
        # the gathered call: the same kernel with each context one page
        gathered = [t[table.long()].reshape(b, L, *t.shape[2:])
                    for t in (kq, ks, vq, vs)]
        g_out = da.dequant_decode_attention(qh, *gathered, pos, scale)
        torch.cuda.synchronize()
        g_err = float((g_out.float() - da._plain(qh, *gathered, pos, scale)
                       .float()).abs().max())
        if not max(errs[dt], g_err) <= TOL[dt]:
            fail(f"dequant {dt}: max err paged {errs[dt]} gathered {g_err} "
                 f"> {TOL[dt]}")
        log(f"paged_dequant_decode_attention q {tuple(qh.shape)} {dt} vs int8 "
            f"pool {pool} under a shuffled table of {pages_per_slot} pages a "
            f"slot: max abs err {errs[dt]:.3e}, gathered call {g_err:.3e} "
            f"(tolerance {TOL[dt]})")
    ptl = table.long()

    def timed(qh):
        """The kernel, its plain version and the library call on `qh`
        (s query rows, bf16), and the bound of this run's data."""
        s = qh.shape[1]
        ms = timer(lambda: da.paged_dequant_decode_attention(
            qh, kq, ks, vq, vs, table, pos, scale))
        plain_ms = timer(lambda: da._paged_plain(qh, kq, ks, vq, vs, table,
                                                 pos, scale))
        row = torch.arange(s, device="cuda")[:, None]
        keep = (torch.arange(L, device="cuda")[None, None, :]
                <= pos.long()[:, None, None] + row[None])[:, None]  # (b,1,s,L)

        def library():
            kf = (kq[ptl].reshape(b, L, h, d).float()
                  * ks[ptl].reshape(b, L, h)[..., None]).to(qh.dtype)
            vf = (vq[ptl].reshape(b, L, h, d).float()
                  * vs[ptl].reshape(b, L, h)[..., None]).to(qh.dtype)
            return F.scaled_dot_product_attention(
                qh.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2),
                attn_mask=keep, scale=scale)
        lib_ms = timer(library)
        # this run's data needs keys 0..pos+s-1 of each slot: int8 K and V
        # values plus their f32 scales, the page ids that address them,
        # the queries, the output and pos
        keys = np.minimum(pos_np + s, L)
        nbytes = (float(keys.sum()) * h * (2 * d + 2 * 4)
                  + 4 * float((-(-keys // PAGE)).sum())
                  + 2 * b * s * h * d * 2 + 4 * b)
        bound_ms, bound_by = bound(nbytes, 4 * float(keys.sum()) * h * s * d
                                   + 2 * float(keys.sum()) * h * d, F32_FLOPS)
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_share": bound_ms / ms}

    one_row = timed(qh)
    # the speculative verify pass: K+1 query rows at K=4
    qv = torch.randn((b, SPEC_K + 1, h, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    out = da.paged_dequant_decode_attention(qv, kq, ks, vq, vs, table, pos,
                                            scale)
    torch.cuda.synchronize()
    v_err = float((out.float() - da._paged_plain(qv, kq, ks, vq, vs, table,
                                                 pos, scale).float())
                  .abs().max())
    if not v_err <= TOL[torch.bfloat16]:
        fail(f"dequant bf16 at {SPEC_K + 1} rows: max err {v_err}")
    verify = {"shape": list(qv.shape), "max_abs_err": v_err, **timed(qv)}
    log(f"paged_dequant_decode_attention q {tuple(qv.shape)} bf16 (the "
        f"verify pass): max abs err {v_err:.3e}, {verify['ms']:.4f} ms, "
        f"bound {verify['bound_ms']:.4f} ms")
    # what this timer reads for one launch of a kernel with no work to
    # speak of: the floor under a call this small
    one = torch.empty(1, device="cuda")
    floor_ms = timer(lambda: one.zero_())
    ms, plain_ms, lib_ms = (one_row[k] for k in ("ms", "plain_ms",
                                                 "library_ms"))
    bound_ms, bound_by = one_row["bound_ms"], one_row["bound_by"]
    return {"name": "dequant_decode_attention", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/dequant_attention.cu",
            "replaces": "flexflow_tpu/kernels/dequant_attention.py:69",
            "shape": [b, s, h, d], "context": L, "page": PAGE,
            "pool_pages": pool[0], "dtype": "bfloat16",
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_f32": errs[torch.float32],
            "tolerance": TOL[torch.bfloat16], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": "page gather + dequantize + "
                       "scaled_dot_product_attention",
            "bound_share": bound_ms / ms, "launch_floor_ms": floor_ms,
            "design": DEQUANT_DESIGN, "verify_shape": verify}


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|): the backward's outputs sum
    up to 1024 products, so their scale grows with the sequence."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def check_flash_bwd(timer, gen, shape=(BATCH, SEQ, HEADS, HEAD_DIM),
                    causal=True):
    """dQ and dK/dV at `shape` (b, s, h, d; GPT-2 medium's training shape
    by default), causal or not, against their plain versions, with the
    saved lse and delta of the forward; bf16 dQ also element by element
    against `_dq_bf16_bound`."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    b, s, h, d = shape
    scale = d ** -0.5
    mask = "causal" if causal else "non-causal"
    errs = {"dq": {}, "dkv": {}}
    for dt in (torch.float32, torch.bfloat16):
        # (b, s, h, d) storage viewed as (b, h, s, d), as the lowering has it
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                       .to(dt).transpose(1, 2) for _ in range(4))
        o, lse = fa._fwd(q, k, v, causal, scale)
        delta = fa._delta(o, do).contiguous()
        args = (q, k, v, do, lse, delta, causal, scale)
        dq = fa._dq_cuda(*args)
        dk, dv = fa._dkv_cuda(*args)
        torch.cuda.synchronize()
        pairs = {"dq": [(dq, fa._dq_plain(*args))],
                 "dkv": list(zip((dk, dv), fa._dkv_plain(*args)))}
        for name, outs in pairs.items():
            abs_err = max(float((a.float() - r.float()).abs().max())
                          for a, r in outs)
            scaled = max(rel_err(a, r) for a, r in outs)
            errs[name][dt] = abs_err
            if not scaled <= TOL[dt]:
                fail(f"flash {name} {mask} {dt}: error {scaled} > {TOL[dt]}")
            log(f"flash_attention_{name} {(b, s, h, d)} {dt} {mask}: max abs "
                f"err {abs_err:.3e}, over max(1, max |plain|) {scaled:.3e} "
                f"(tolerance {TOL[dt]})")
        if dt == torch.bfloat16:
            want = pairs["dq"][0][1].float()
            dq_bound = fa._dq_bf16_bound(*args)
            dq_elem = {
                "dq_bound_share": float(((dq.float() - want).abs()
                                         / dq_bound).max()),
                "median_abs_plain": float(want.abs().median()),
                "median_element_bound": float(dq_bound.median())}
            del want, dq_bound
            if not dq_elem["dq_bound_share"] <= 1.0:
                fail(f"flash dq {mask} bf16: exceeds its element bound "
                     f"{dq_elem['dq_bound_share']}x")
            log(f"flash_attention_dq {mask} bf16: at most "
                f"{dq_elem['dq_bound_share']:.3f} of its element-wise "
                f"rounding bound; median bound "
                f"{dq_elem['median_element_bound']:.3e}, median |plain| "
                f"{dq_elem['median_abs_plain']:.3e}")
    ms = {"dq": timer(lambda: fa._dq_cuda(*args)),
          "dkv": timer(lambda: fa._dkv_cuda(*args))}
    plain_ms = {"dq": timer(lambda: fa._dq_plain(*args)),
                "dkv": timer(lambda: fa._dkv_plain(*args))}
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                         scale=scale)
    lib_ms = timer(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                               retain_graph=True))
    n = b * h * s * d
    pairs = b * h * s * ((s + 1) / 2 if causal else s)   # (q, k) pairs
    rows = []
    for name, n_out, matmuls, src_line in (("dq", 1, 3, 274),
                                           ("dkv", 2, 4, 284)):
        # reads q, k, v, dO (bf16) and lse, delta (f32); writes the outputs
        nbytes = 4 * n * 2 + 2 * b * h * s * 4 + n_out * n * 2
        flops = matmuls * 2 * pairs * d
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
        row = {
            "name": row_name(f"flash_attention_{name}", causal),
            "counter": f"flash_attention_{name}", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"flexflow_tpu/kernels/flash_attention.py:{src_line}",
            "shape": [b, s, h, d], "dtype": "bfloat16", "causal": causal,
            "max_abs_err": errs[name][torch.bfloat16],
            "max_abs_err_f32": errs[name][torch.float32],
            "tolerance": TOL[torch.bfloat16],
            "tolerance_of": "max abs err / max(1, max |plain|)", "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention backward (dQ, dK and "
                       "dV together)"}
        row.update(tc_fields(row["counter"], flops, ms[name], bound_ms))
        if name == "dq":
            row.update(dq_elem)
        rows.append(row)
    return rows


def medium_param_specs(vocab_pad_to: int = 0):
    """GPT-2 medium's weight specs, in the order the CompiledModel holds
    them."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.core.graph import topo_order
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2

    model = FFModel(FFConfig(batch_size=BATCH))
    gc = GPT2Config.medium()
    gc.dropout, gc.vocab_pad_to = 0.0, vocab_pad_to
    build_gpt2(model, gc, batch=BATCH)
    return [(l.name, w, spec) for l in topo_order(model.layers)
            for w, spec in sorted(l.weight_specs.items())]


def against_library(timer, name: str, kernel, library) -> dict:
    """`Timer.alternate` of an optimizer kernel and its library call, with
    the card's SM and memory clocks read just before and just after (the
    optimizer kernels' times move between runs more than the others')."""
    before = clocks()
    out = timer.alternate(kernel, library)
    out["clocks_sm_mem"] = [before, clocks()]
    log(f"{name}: {out['ms']:.4f} ms against the library's "
        f"{out['library_ms']:.4f} ms, timed in turns, median ratio "
        f"{out['library_ratio']:.3f}, spin {out['hold_cycles']} cycles; "
        f"clocks (SM, memory) before {before}, after "
        f"{out['clocks_sm_mem'][1]}")
    return out


def check_adam(timer, gen):
    """The one-launch Adam over GPT-2 medium's 406 M params against its
    plain version (f32 and bf16 moments, weight decay 0 and 0.01), from
    moments already warm (count 2 -> 3)."""
    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.kernels import fused_optim as fo

    specs = medium_param_specs()

    def leaves(scale, dtype=torch.float32, positive=False):
        out = []
        for _, _, spec in specs:
            t = torch.randn(spec.shape, generator=gen, device="cuda") * scale
            out.append((t.abs() if positive else t).to(dtype))
        return out

    params, grads = leaves(0.02), leaves(1e-3)
    n_params = sum(p.numel() for p in params)
    errs = {}
    for sd in ("float32", "bfloat16"):
        for wd in (0.0, 0.01):
            plan = fo.plan_for(AdamOptimizer(alpha=LR, weight_decay=wd,
                                             state_dtype=sd))
            md = plan["state_dtype"]
            mus, nus = leaves(1e-3, md), leaves(1e-6, md, positive=True)
            runs = []
            for fn in (fo._adam_cuda, fo._adam_plain):
                ps = [p.clone() for p in params]
                ms_, ns_ = [m.clone() for m in mus], [v.clone() for v in nus]
                fn(plan, grads, ms_, ns_, ps, fo.adam_scalars(plan, 3, "cuda"))
                runs.append((ps, ms_, ns_))
            torch.cuda.synchronize()
            (pk, mk, nk), (pp, mp, np_) = runs
            err = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
            # moments: max abs err over max |plain| per tensor; a stored
            # bf16 moment may sit one bf16 ulp (2**-8) away
            merr = max(float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp_min(1e-30))
                       for a, b in zip(mk + nk, mp + np_))
            mtol = 1e-6 if md == torch.float32 else 2 ** -7
            errs[(sd, wd)] = err
            if not (err <= 1e-6 and merr <= mtol):
                fail(f"fused Adam {sd} wd={wd}: param err {err}, moment "
                     f"relative err {merr}")
            log(f"fused_adam {n_params} params, {sd} moments, wd {wd}: max "
                f"abs param err {err:.3e} (tolerance 1e-6), moment err "
                f"{merr:.3e} (max abs / max |plain|, tolerance {mtol:.1e})")
            del runs, pk, mk, nk, pp, mp, np_
    # timed: f32 moments, wd 0 (the training path's configuration)
    plan = fo.plan_for(AdamOptimizer(alpha=LR))
    mus, nus = leaves(1e-3), leaves(1e-6, positive=True)
    sc = fo.adam_scalars(plan, 3, "cuda")
    plain_ms = timer(lambda: fo._adam_plain(plan, grads, mus, nus, params, sc))
    lib_params = [p.clone() for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    opt = torch.optim.Adam(lib_params, lr=LR, fused=True)
    times = against_library(
        timer, "fused_adam",
        lambda: fo._adam_cuda(plan, grads, mus, nus, params, sc), opt.step)
    bound_ms, bound_by = bound(28.0 * n_params, 15.0 * n_params, F32_FLOPS)
    # the update's device scalars (since PR 11): count += 1 and the f32
    # bias corrections 1 - b**count, which the kernel reads from the
    # device; their device time, and their values against numpy's f32
    # values (optimizers.bias_corrections) at every count to 10000
    from flexflow_tpu_torch.optimizers import (bias_corrections,
                                               device_bias_corrections)
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    bases = {}
    scalars_ms = timer(lambda: device_bias_corrections(
        0.9, 0.999, count.add_(1), bases))
    counts = torch.arange(1, 10001, dtype=torch.int32, device="cuda")
    dev_bc = (1 - torch.pow(torch.tensor([0.9, 0.999], device="cuda")[None],
                            counts.float()[:, None])).cpu().numpy()
    ref_bc = np.array([bias_corrections(0.9, 0.999, c)
                       for c in range(1, 10001)], dtype=np.float32)
    bc_ulps = np.abs(dev_bc.view(np.int32).astype(np.int64)
                     - ref_bc.view(np.int32).astype(np.int64))
    bc = {"counts": 10000, "mismatched_counts": int((bc_ulps > 0).any(1).sum()),
          "max_ulps": int(bc_ulps.max()), "scalars_ms": scalars_ms}
    log(f"fused_adam device scalars: {scalars_ms:.4f} ms a step; bias "
        f"corrections against numpy f32 at counts 1..10000: "
        f"{bc['mismatched_counts']} counts differ, at most {bc['max_ulps']} "
        "ulp")
    return {"name": "fused_adam", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/fused_optim.cu",
            "replaces": "flexflow_tpu/kernels/fused_optim.py:140",
            "params": n_params, "leaves": len(params),
            "moment_dtype": "float32", "weight_decay": 0.0,
            "max_abs_err": errs[("float32", 0.0)],
            "max_abs_err_by_config": {f"{k[0]} wd={k[1]}": v
                                      for k, v in errs.items()},
            "tolerance": 1e-6, **times, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "device_scalars": bc,
            "library": "torch.optim.Adam(fused=True).step"}


def ulp_err(got, want) -> float:
    """max over elements of |got - want| in ulps of got's dtype, the ulp
    taken at the larger of the two magnitudes."""
    eps = torch.finfo(got.dtype).eps                 # f32 2**-23, bf16 2**-7
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    _, e = torch.frexp(mag)                          # mag in [2**(e-1), 2**e)
    ulp = torch.ldexp(torch.full_like(mag, eps), e - 1)
    return float(((g - w).abs() / ulp).max())


# Fused cross-entropy tolerances. Forward: lse and the row losses (values
# near 11) are f32 sums of 50304 exponentials taken in another order than
# the plain version's: 1e-5 absolute. Backward, from the same lse, element
# by element in ulps of the logits' dtype: the kernel's expf and PyTorch's
# exp may differ in the last bit, which can move an f32 dx by up to 2 ulps
# (the product with g/N rounds again) and round a bf16 dx one ulp the
# other way.
CE_TOL = {"fwd": 1e-5, "bwd_ulps": {torch.float32: 2, torch.bfloat16: 1}}


def check_fused_ce(timer, gen):
    """Both cross-entropy kernels at the padded training shape (8192,
    50304), labels in [0, 50257), against their plain versions in f32 and
    bf16; timed in bf16 (the path's dtype)."""
    from flexflow_tpu_torch.kernels import fused_ce as fc

    n, v = BATCH * SEQ, PAD_VOCAB
    y = torch.randint(0, GPT2_VOCAB, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    g = torch.ones((), device="cuda")
    gs = g / n
    errs = {"fwd": {}, "bwd": {}, "bwd_ulps": {}}
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn((n, v), generator=gen, device="cuda") * 2.0).to(dt)
        loss, lse = fc._fwd_cuda(x, y)
        dx = fc._bwd_cuda(x, y, lse, g)
        torch.cuda.synchronize()
        rloss, rlse = fc._fwd_plain(x, y)
        errs["fwd"][dt] = max(float((loss - rloss).abs().max()),
                              float((lse - rlse).abs().max()))
        rdx = fc._bwd_plain(x, y, lse, gs)
        errs["bwd"][dt] = float((dx.float() - rdx.float()).abs().max())
        errs["bwd_ulps"][dt] = ulp_err(dx, rdx)
        log(f"fused_ce ({n}, {v}) {dt}: forward max abs err (loss, lse) "
            f"{errs['fwd'][dt]:.3e} (tolerance {CE_TOL['fwd']}), backward "
            f"max abs err {errs['bwd'][dt]:.3e}, {errs['bwd_ulps'][dt]:g} "
            f"ulps of {dt} element by element (tolerance "
            f"{CE_TOL['bwd_ulps'][dt]})")
        if not (errs["fwd"][dt] <= CE_TOL["fwd"]
                and errs["bwd_ulps"][dt] <= CE_TOL["bwd_ulps"][dt]):
            fail(f"fused cross-entropy {dt}: {errs}")
        del loss, lse, dx, rloss, rlse, rdx
        torch.cuda.empty_cache()
    # timed in bf16: x is the last dtype of the loop
    _, lse = fc._fwd_cuda(x, y)
    y64 = y.long()
    fwd = {"ms": timer(lambda: fc._fwd_cuda(x, y)),
           "plain_ms": timer(lambda: fc._fwd_plain(x, y)),
           "library_ms": timer(lambda: F.cross_entropy(x.float(), y64))}
    xs = x.detach().requires_grad_()
    out = F.cross_entropy(xs.float(), y64)
    bwd = {"ms": timer(lambda: fc._bwd_cuda(x, y, lse, g)),
           "plain_ms": timer(lambda: fc._bwd_plain(x, y, lse, gs)),
           "library_ms": timer(lambda: torch.autograd.grad(
               out, (xs,), retain_graph=True))}
    del xs, out
    nv = float(n) * v
    rows = []
    for name, times, nbytes, src_line, lib in (
            ("fused_ce_fwd", fwd, nv * 2 + 4 * n + 8 * n, 139,
             "torch.nn.functional.cross_entropy(x.float(), y) (the unfused "
             "path's loss)"),
            ("fused_ce_bwd", bwd, 2 * nv * 2 + 8 * n + 4, 184,
             "backward of cross_entropy(x.float(), y) to the bf16 logits")):
        # a max, a subtraction, an exp and an add (fwd) or a subtraction,
        # an exp and a product (bwd) per element, in f32
        bound_ms, bound_by = bound(nbytes, 4 * nv, F32_FLOPS)
        k = name[-3:]
        tol = ({"tolerance": CE_TOL["fwd"], "tolerance_of": "max abs err"}
               if k == "fwd" else
               {"max_ulp_err": errs["bwd_ulps"][torch.bfloat16],
                "max_ulp_err_f32": errs["bwd_ulps"][torch.float32],
                "tolerance": CE_TOL["bwd_ulps"][torch.bfloat16],
                "tolerance_f32": CE_TOL["bwd_ulps"][torch.float32],
                "tolerance_of": "max ulps of the dtype, element by element"})
        rows.append({
            "name": name, "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/fused_ce.cu",
            "replaces": f"flexflow_tpu/kernels/fused_ce.py:{src_line}",
            "shape": [n, v], "dtype": "bfloat16",
            "max_abs_err": errs[k][torch.bfloat16],
            "max_abs_err_f32": errs[k][torch.float32], **tol, **times,
            "bound_ms": bound_ms, "bound_by": bound_by, "library": lib})
    return rows


def check_sgd(timer, gen):
    """The one-launch SGD over the padded GPT-2 medium param set against
    its plain version (no momentum, momentum 0.9, momentum 0.9 with weight
    decay 0.01, nesterov): equal to 1e-6, bit for bit expected. Timed in
    the two configurations the training paths run: SGD(0.01, momentum 0.9)
    with a trace, SGD(0.01) without."""
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.kernels import fused_optim as fo

    specs = medium_param_specs(PAD_TO)

    def leaves(scale):
        return [torch.randn(spec.shape, generator=gen, device="cuda") * scale
                for _, _, spec in specs]

    params, grads = leaves(0.02), leaves(1e-3)
    n_params = sum(p.numel() for p in params)
    configs = {"sgd": dict(lr=SGD_LR),
               "momentum": dict(lr=SGD_LR, momentum=0.9),
               "momentum wd=0.01": dict(lr=SGD_LR, momentum=0.9,
                                        weight_decay=0.01),
               "nesterov": dict(lr=SGD_LR, momentum=0.9, nesterov=True)}
    errs = {}
    for cname, kw in configs.items():
        plan = fo.plan_for(SGDOptimizer(**kw))
        traces = leaves(1e-3) if plan["momentum"] else None
        runs = []
        for fn in (fo._sgd_cuda, fo._sgd_plain):
            ps = [p.clone() for p in params]
            ts = None if traces is None else [t.clone() for t in traces]
            fn(plan, grads, ts, ps)
            runs.append(ps + (ts or []))
        torch.cuda.synchronize()
        errs[cname] = max(float((a - b).abs().max())
                          for a, b in zip(*runs))
        log(f"fused_sgd {n_params} params, {cname}: max abs err (params and "
            f"trace) {errs[cname]:.3e} (tolerance 1e-6)")
        if not errs[cname] <= 1e-6:
            fail(f"fused SGD {cname}: max abs err {errs[cname]}")
        del runs, traces
    rows = []
    for name, cname, src_line, bytes_per, flops_per in (
            ("fused_sgd", "momentum", 180, 20.0, 4.0),
            ("fused_sgd_plain", "sgd", 169, 12.0, 2.0)):
        kw = configs[cname]
        plan = fo.plan_for(SGDOptimizer(**kw))
        traces = leaves(1e-3) if plan["momentum"] else None
        plain_ms = timer(lambda: fo._sgd_plain(plan, grads, traces, params))
        lib_params = [p.clone() for p in params]
        for p, g in zip(lib_params, grads):
            p.grad = g
        mom = kw.get("momentum", 0.0)
        try:
            opt = torch.optim.SGD(lib_params, lr=SGD_LR, momentum=mom,
                                  fused=True)
            opt.step()
            lib = "torch.optim.SGD(fused=True).step"
        except (TypeError, RuntimeError):
            opt = torch.optim.SGD(lib_params, lr=SGD_LR, momentum=mom,
                                  foreach=True)
            lib = "torch.optim.SGD(foreach=True).step"
        times = against_library(
            timer, name, lambda: fo._sgd_cuda(plan, grads, traces, params),
            opt.step)
        del opt, lib_params, traces
        # g, p (and the trace) read once, p (and the trace) written once
        bound_ms, bound_by = bound(bytes_per * n_params, flops_per * n_params,
                                   F32_FLOPS)
        rows.append({
            "name": name, "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/fused_optim.cu",
            "replaces": f"flexflow_tpu/kernels/fused_optim.py:{src_line}",
            "params": n_params, "leaves": len(params), "config": kw,
            "max_abs_err": max(v for c, v in errs.items()
                               if (c == "sgd") == (name == "fused_sgd_plain")),
            "max_abs_err_by_config": errs, "tolerance": 1e-6, **times,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library": lib})
    return rows


# ---------------------------------------------------------------- serving
class PlainKernels:
    """Swap each kernel wrapper's launch for its plain version, to run the
    same program through the plain versions on the card. Fails if a kernel
    was launched inside the block all the same (the swap missed it)."""

    def __enter__(self):
        from flexflow_tpu_torch.kernels import dequant_attention as da
        from flexflow_tpu_torch.kernels import flash_attention as fa
        from flexflow_tpu_torch.kernels import fused_ce as fc
        from flexflow_tpu_torch.kernels import fused_optim as fo
        self.counts = launch_counts()
        swaps = [(fa, "_fwd_cuda", fa._fwd_plain),
                 (da, "_cuda", da._paged_plain),
                 (fa, "_dq_cuda", fa._dq_plain),
                 (fa, "_dkv_cuda", fa._dkv_plain),
                 (fo, "_adam_cuda", fo._adam_plain),
                 (fc, "_fwd_cuda", fc._fwd_plain),
                 # the kernel divides the cotangent by N on the card
                 (fc, "_bwd_cuda", lambda x2, y2, lse, g: fc._bwd_plain(
                     x2, y2, lse, g / x2.shape[0])),
                 (fo, "_sgd_cuda", fo._sgd_plain)]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        if launch_counts() != self.counts:
            fail("a kernel launched inside the plain-version run")


def _signature(args) -> tuple:
    """A kernel call's shapes and dtypes: each tensor's, a list of
    tensors as its length and total size, the plain scalars as they
    are."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(("x".join(map(str, a.shape)) or "()") + " "
                       + str(a.dtype).replace("torch.", ""))
        elif isinstance(a, (list, tuple)) and a and \
                isinstance(a[0], torch.Tensor):
            out.append(f"{len(a)} leaves of {sum(t.numel() for t in a)} "
                       + str(a[0].dtype).replace("torch.", ""))
        elif a is None or isinstance(a, (bool, int, float, str)):
            out.append(a)
    return tuple(out)


def _max_abs(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def _shadow_flash_fwd(orig, q, k, v, causal, scale, out_dtype=None):
    from flexflow_tpu_torch.kernels import flash_attention as fa
    o, lse = orig(q, k, v, causal, scale, out_dtype)
    ro, rlse = fa._fwd_plain(q, k, v, causal, scale, out_dtype)
    return (o, lse), "flash_attention_fwd", [
        ("O over max(1, max |plain|)", rel_err(o, ro), TOL[q.dtype]),
        ("lse over max(1, max |plain|)", rel_err(lse, rlse), LSE_TOL)]


def _shadow_flash_dq(orig, *args, **kw):
    from flexflow_tpu_torch.kernels import flash_attention as fa
    dq = orig(*args, **kw)
    return dq, "flash_attention_dq", [
        ("dQ over max(1, max |plain|)",
         rel_err(dq, fa._dq_plain(*args, **kw)), TOL[args[0].dtype])]


def _shadow_flash_dkv(orig, *args, **kw):
    from flexflow_tpu_torch.kernels import flash_attention as fa
    dk, dv = orig(*args, **kw)
    rk, rv = fa._dkv_plain(*args, **kw)
    return (dk, dv), "flash_attention_dkv", [
        ("dK, dV over max(1, max |plain|)",
         max(rel_err(dk, rk), rel_err(dv, rv)), TOL[args[0].dtype])]


def _shadow_ce_fwd(orig, x2, y2):
    from flexflow_tpu_torch.kernels import fused_ce as fc
    loss, lse = orig(x2, y2)
    return (loss, lse), "fused_ce_fwd", [
        ("loss, lse max abs", _max_abs((loss, lse), fc._fwd_plain(x2, y2)),
         CE_TOL["fwd"])]


def _shadow_ce_bwd(orig, x2, y2, lse, g):
    from flexflow_tpu_torch.kernels import fused_ce as fc
    dx = orig(x2, y2, lse, g)
    # the kernel divides the cotangent by N on the card
    want = fc._bwd_plain(x2, y2, lse, g / x2.shape[0])
    return dx, "fused_ce_bwd", [("dX ulps, element by element",
                                 ulp_err(dx, want),
                                 CE_TOL["bwd_ulps"][x2.dtype])]


def _shadow_adam(orig, plan, gs, mus, nus, ps, sc):
    from flexflow_tpu_torch.kernels import fused_optim as fo
    want = [[t.clone() for t in ts] for ts in (mus, nus, ps)]
    fo._adam_plain(plan, gs, *want, sc)
    orig(plan, gs, mus, nus, ps, sc)
    # check_adam's tolerances: the moments as max abs err over max |plain|
    # per tensor, a stored bf16 moment one bf16 ulp (2**-8) away at most
    merr = max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))
               for a, b in zip(mus + nus, want[0] + want[1]))
    mtol = 1e-6 if plan["state_dtype"] == torch.float32 else 2 ** -7
    return None, "fused_adam", [("params max abs", _max_abs(ps, want[2]),
                                 1e-6), ("moments relative", merr, mtol)]


def _shadow_sgd(orig, plan, gs, traces, ps):
    from flexflow_tpu_torch.kernels import fused_optim as fo
    wt = None if traces is None else [t.clone() for t in traces]
    wp = [p.clone() for p in ps]
    fo._sgd_plain(plan, gs, wt, wp)
    orig(plan, gs, traces, ps)
    return None, ("fused_sgd_plain" if traces is None else "fused_sgd"), [
        ("params and trace max abs",
         _max_abs(ps + (traces or []), wp + (wt or [])), 1e-6)]


class ShadowKernels:
    """Inside the block, a kernel wrapper's first launch at each new
    signature (`_signature`: its tensors' shapes and dtypes) also runs the
    kernel's plain version on the same inputs (on copies of what the
    kernel writes in place) and holds the two at the tolerances of the
    kernel's own check: the kernels checked on the path's own data at the
    path's shapes. A launch inside a CUDA graph capture is not shadowed (a
    capture takes no sync). The path's counts stay its own: the plain
    versions count nothing. `report()` is JSON; `check_shadow` fails on
    it."""

    def __enter__(self):
        from flexflow_tpu_torch.kernels import flash_attention as fa
        from flexflow_tpu_torch.kernels import fused_ce as fc
        from flexflow_tpu_torch.kernels import fused_optim as fo
        self.seen, self.checked = set(), {}
        self.saved = []
        for mod, name, shadow in ((fa, "_fwd_cuda", _shadow_flash_fwd),
                                  (fa, "_dq_cuda", _shadow_flash_dq),
                                  (fa, "_dkv_cuda", _shadow_flash_dkv),
                                  (fc, "_fwd_cuda", _shadow_ce_fwd),
                                  (fc, "_bwd_cuda", _shadow_ce_bwd),
                                  (fo, "_adam_cuda", _shadow_adam),
                                  (fo, "_sgd_cuda", _shadow_sgd)):
            orig = getattr(mod, name)
            self.saved.append((mod, name, orig))
            setattr(mod, name, self._wrap(mod.__name__ + "." + name, orig,
                                          shadow))
        return self

    def _wrap(self, where, orig, shadow):
        def wrapped(*args, **kw):
            key = (where, _signature(args))
            if key in self.seen or torch.cuda.is_current_stream_capturing():
                return orig(*args, **kw)
            self.seen.add(key)
            with torch.no_grad():
                out, counter, errs = shadow(orig, *args, **kw)
            self.checked.setdefault(counter, []).append(
                {"signature": ", ".join(map(str, key[1])),
                 "errs": [[what, err, tol] for what, err, tol in errs]})
            return out
        return wrapped

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def report(self) -> dict:
        return {"checked": self.checked}


def check_shadow(report: dict, counts: dict, label: str) -> None:
    """Fails unless every kernel that `counts` shows launched was held
    against its plain version at least once (`ShadowKernels`) and every
    such check is within its tolerance; logs each check."""
    checked = report["checked"]
    for counter, checks in sorted(checked.items()):
        for c in checks:
            log(f"[{label}] {counter} at {c['signature']} against its plain "
                "version on the path's inputs: " + ", ".join(
                    f"{w} {e:.3e} (tolerance {t:.1e})"
                    for w, e, t in c["errs"]))
            if not all(e <= t for _, e, t in c["errs"]):
                fail(f"{label}: {counter} disagrees with its plain version "
                     f"on the path's inputs: {c}")
    unchecked = [n for n, c in counts.items() if c and n not in checked]
    if unchecked:
        fail(f"{label}: {unchecked} launched but never held against the "
             f"plain version (every launch inside a graph capture?)")


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by the kernel's name."""
    from flexflow_tpu_torch.kernels import launch_counts as counts
    return counts()


def zero_launch_counts() -> None:
    from flexflow_tpu_torch.kernels import collective_matmul as cmm
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_ce as fc
    from flexflow_tpu_torch.kernels import fused_optim as fo
    from flexflow_tpu_torch.kernels import ring_attention as ra
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    ra.launches = cmm.launches = 0
    da.launches = fo.launches = 0
    da.launches_by_rows.clear()
    fc.launches_fwd = fc.launches_bwd = 0
    fo.launches_sgd = fo.launches_sgd_plain = 0


def serve(engine, params, prompts, label: str):
    """One scheduler run over `prompts`, with every launch counter set to
    0 just before it; returns the summary (counts read just after) and
    the greedy streams (rid -> tokens)."""
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    first, finite = {}, []
    prefill, decode_step = engine.prefill, engine.decode_step

    def watched_prefill(p, inputs):
        logits, kv = prefill(p, inputs)
        first.setdefault("inputs", inputs)
        first.setdefault("logits", logits)
        finite.append(torch.isfinite(logits).all())
        return logits, kv

    def watched_decode(p, state, inputs):
        logits, ns = decode_step(p, state, inputs)
        finite.append(torch.isfinite(logits).all())
        return logits, ns

    engine.prefill, engine.decode_step = watched_prefill, watched_decode
    reqs = [Request(rid=i, prompt=prompt, max_new_tokens=NEW_TOKENS)
            for i, prompt in enumerate(prompts)]
    sched = ContinuousBatchingScheduler(engine, params, gpt2_prompt_inputs,
                                        gpt2_step_inputs)
    dev = engine.device
    sync(dev)
    zero_launch_counts()
    t0 = time.perf_counter()
    done = sched.run(reqs)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    engine.prefill, engine.decode_step = prefill, decode_step

    if len(done) != len(prompts) or sched.shed:
        fail(f"{label}: {len(done)} of {len(prompts)} requests completed")
    for r in done:
        if len(r.tokens) != NEW_TOKENS or not all(
                0 <= t < engine.model.layers[-1].params["out_dim"]
                for t in r.tokens):
            fail(f"{label}: request {r.rid} has {len(r.tokens)} tokens")
    if not bool(torch.stack(finite).all()):
        fail(f"{label}: non-finite logits")

    # the first prefill again, through the plain versions
    lengths = np.array([len(p) for p in prompts[:engine.slots]])
    rows = torch.arange(len(lengths), device=dev)
    last = torch.from_numpy(lengths - 1).to(dev)
    with PlainKernels(), torch.no_grad():
        plain, _ = prefill(params, first["inputs"])
    got = first["logits"][rows, last].float()
    want = plain[rows, last].float()
    err = float((got - want).abs().max())
    if not err <= TOL[torch.bfloat16]:
        fail(f"{label}: first prefill through the kernels vs plain: "
             f"max err {err} > {TOL[torch.bfloat16]}")
    ttft = np.array([r.ttft_s for r in done])
    tokens = sum(len(r.tokens) for r in done)
    return {"kv_cache_dtype": label, "requests": len(done),
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
            "ttft_p99_ms": 1e3 * float(np.percentile(ttft, 99)),
            "decode_step_p50_ms": 1e3 * float(np.median(sched.step_times)),
            "prefills": sched.prefills, "decode_steps": sched.decode_steps,
            "launches": counts, "first_prefill_max_err_vs_plain": err,
            "logit_abs_max": float(got.abs().max())}, \
        {r.rid: list(r.tokens) for r in done}


# idle seconds at each edge of a profile window, and between a lead call
# and the counted calls. The profiler keeps only the device records that
# fall inside its window on the host's clock, and the device's timestamps,
# as it converts them, can run ahead of that clock (phase 10's 9b graph
# read its first kernel 0.68 ms before its launch call).
PROFILE_EDGE_S = 0.1
# the host's launch calls, against which a kernel's start is read
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
# the host range around the counted calls
COUNTED_RANGE = "chip_smoke/counted"


class _Range:
    __slots__ = ("start", "end")

    def __init__(self, start: float, end: float):
        self.start, self.end = start, end

    def elapsed_us(self) -> float:
        return self.end - self.start


class _Record:
    """What `_device_profile` reads of a profiler record (the fields of a
    FunctionEvent: name, device type, user annotation, start and end in
    µs on the host's clock), and its correlation id: a kernel's is the id
    of the launch call that enqueued it (a graph's kernels carry their
    cudaGraphLaunch's)."""
    __slots__ = ("name", "device_type", "is_user_annotation", "time_range",
                 "correlation")

    def __init__(self, name, device_type, annotation, start, end,
                 correlation=0):
        self.name, self.device_type = name, device_type
        self.is_user_annotation, self.time_range = annotation, _Range(start,
                                                                     end)
        self.correlation = correlation


def _profile_records(prof) -> list:
    """The window's records from the profiler's raw kineto events, as
    `prof.events()` would give them (its utility ops left out, names
    demangled) without building its FunctionEvent tree, which takes ~70
    µs a record: tens of seconds for a window of a few host-bound steps."""
    from torch.autograd.profiler_util import _filter_name

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()  # µs from here keep float64's resolution
    names: dict = {}
    out = []
    for e in res.events():
        raw = e.name()
        if _filter_name(raw) or getattr(e, "is_hidden_event",
                                        lambda: False)():
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = (torch._C._demangle(raw) if len(raw) > 1
                                 else raw)
        out.append(_Record(name, e.device_type(), e.is_user_annotation(),
                           (e.start_ns() - t0) / 1e3,
                           (e.end_ns() - t0) / 1e3, e.correlation_id()))
    return out


def _device_profile(fn, reps: int, dev: torch.device, lead=None) -> dict:
    """Run `fn` `reps` times under torch.profiler: host wall time per call,
    the device's busy time (union of kernel intervals) and idle share, and
    the kernels that took the most device time; and the time from the
    first launch call to the first kernel's start, both as the profiler
    reads them (milliseconds where the profiler kept no record of the
    first kernels; negative where the device's converted clock runs ahead
    of the host's). Empty when the profiler records no kernel (then the
    device split is not measured).

    Late in a long process the profiler loses the records of the first
    milliseconds of device work after its window opens, whatever idle time
    precedes them (one layer's forward of a one-step GPT-2 or BERT window,
    five BERT layers of a replayed graph). Where the counts must be exact,
    pass `lead`: it runs once in the profiler's warm-up step (its schedule's
    `warmup`: the device tracing is already on and its records are
    dropped), so the counted window opens on a profiler that has been
    tracing, a device sync and PROFILE_EDGE_S before the counted calls.
    The window's kernels are read by correlation: a kernel counts when
    the runtime call that enqueued it (a cudaLaunchKernel, a copy, a
    cudaGraphLaunch, on the host's clock) started in the counted range,
    whatever time the device's converted clock gives the kernel (a window
    read by the kernels' own times once held none of 18a's ring forward
    kernels)."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    kw = {} if lead is None else {"schedule": schedule(
        wait=0, warmup=1, active=1, repeat=1)}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], **kw) as prof:
        sync(dev)
        if lead is not None:
            lead()
            sync(dev)
            prof.step()  # the warm-up step ends: the counted window opens
        time.sleep(PROFILE_EDGE_S)
        with record_function(COUNTED_RANGE):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync(dev)
            wall_us = 1e6 * (time.perf_counter() - t0)
        time.sleep(PROFILE_EDGE_S)
    cuda = torch.autograd.DeviceType.CUDA
    # the range's own device span (a user annotation) is no kernel
    records = [e for e in _profile_records(prof)
               if e.device_type != cuda or not (
                   e.name == COUNTED_RANGE or e.is_user_annotation)]
    first_us = min(e.time_range.start for e in records
                   if e.name == COUNTED_RANGE)
    host = [e for e in records
            if e.device_type != cuda and e.time_range.start >= first_us]
    # the CUDA API calls (launches, copies, sets) of the range: every
    # device record the range enqueued carries one's id
    launched = {e.correlation for e in host
                if e.name.startswith(("cuda", "cu"))}
    kern = [e for e in records if e.device_type == cuda
            and e.correlation in launched]
    events = host + kern
    launch_us = min((e.time_range.start for e in events
                     if e.name in LAUNCH_CALLS), default=None)
    # gathers `pool[table]` (and any other advanced-index read) on the host
    gathers = sum(e.name == "aten::index" for e in events)
    # CUDA graph replays (the runtime call, on the host)
    graph_launches = sum(e.name == "cudaGraphLaunch" for e in events)
    if not kern:
        return {"device": "not measured (the profiler saw no kernel)"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s = busy + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    port: dict = {}
    port_name = re.compile(r"\b(" + "|".join(port_kernel_names()) + r")[<(]")
    for n, (t, c) in by_name.items():
        m = port_name.search(n)
        if m:
            pt, pc = port.get(m.group(1), (0.0, 0))
            port[m.group(1)] = (pt + t, pc + c)
    return {"calls": reps, "wall_ms_per_call": wall_us / reps / 1e3,
            "launch_to_first_kernel_us": (None if launch_us is None
                                          else spans[0][0] - launch_us),
            "device_busy_ms_per_call": busy / reps / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_launches_per_call": len(kern) / reps,
            "aten_index_per_call": gathers / reps,
            "graph_launches_per_call": graph_launches / reps,
            "top_kernels": [{"name": n[:80], "ms_per_call": t / reps / 1e3,
                             "launches_per_call": c / reps}
                            for n, (t, c) in top],
            "port_kernels": {n: {"ms_per_call": t / reps / 1e3,
                                 "launches_per_call": c / reps}
                             for n, (t, c) in sorted(port.items())},
            # the collectives' kernels (phase 17's NCCL all-reduces)
            "nccl_kernels": {n[:80]: c / reps
                             for n, (t, c) in sorted(by_name.items())
                             if n.startswith("nccl")}}


def profile_engine(engine, params, prompts, profile_prefill: bool = True,
                   steps: int = NEW_TOKENS // 2) -> dict:
    """Where a prefill and a decode step spend their time: the first
    wave's prompts prefilled into every slot, then `steps` decode steps
    over all slots, each phase in its own profiled window (the prefill's
    only with `profile_prefill`)."""
    from flexflow_tpu_torch.serving import gpt2_prompt_inputs, gpt2_step_inputs

    kv, slots = engine.kv, engine.slots
    seq = int(engine.prefill_model.input_tensors[0].spec.shape[1])
    ids = np.zeros((slots, seq), np.int32)
    lengths = np.zeros((slots,), np.int32)
    for s, p in enumerate(prompts[:slots]):
        ids[s, :len(p)], lengths[s] = p, len(p)
        kv.admit(s, len(p), len(p) + NEW_TOKENS)
    kv.push()
    inputs = gpt2_prompt_inputs(ids, lengths)
    dev = engine.device
    out = ({"prefill": _device_profile(
        lambda: engine.prefill(params, inputs), 2, dev)}
        if profile_prefill else {})
    _, kv_state = engine.prefill(params, inputs)
    kv.commit_prefill(kv_state, np.arange(slots, dtype=np.int32), lengths)
    box = {"state": kv.state,
           "tok": torch.ones((slots, 1), dtype=torch.int32, device=dev)}

    def step():
        st = box["state"]
        logits, box["state"] = engine.decode_step(
            params, st, gpt2_step_inputs(box["tok"], st))
        box["tok"] = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    out["decode_step"] = _device_profile(step, steps, dev)
    kv.adopt(box["state"])
    kv.sync_after(steps)
    for s in range(slots):
        kv.evict(s)
    kv.push()
    return out


# ------------------------- phases 8, 12 and 13: the cut serving model
# Phases 8, 12 and 13 serve GPT-2 medium at its full width and this depth
# (phase 3 serves it at full depth), with the same checks: the time
# limit's cut. Their reference streams are the cut model's own.
SERVE_CUT_LAYERS = 4


def cut_serving(gc, params, prompts, seed: int) -> tuple:
    """GPT-2 medium at SERVE_CUT_LAYERS deep with phase 3's weights of
    those layers, and the greedy streams and runs of that model by KV
    dtype, served as phase 3 serves them: (config, params, streams,
    runs)."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import build_gpt2
    from flexflow_tpu_torch.serving import compile_serving

    t0 = time.perf_counter()
    gcc = dataclasses.replace(gc, layers=SERVE_CUT_LAYERS)
    streams, runs, cut = {}, {}, None
    for kv in ("auto", "int8"):
        model = FFModel(FFConfig(seed=seed, compute_dtype="bfloat16",
                                 max_batch_slots=SLOTS, kv_page_size=PAGE,
                                 max_decode_len=NEW_TOKENS,
                                 kv_cache_dtype=kv))
        build_gpt2(model, gcc, batch=SLOTS)
        engine = compile_serving(model)
        if cut is None:
            names = {l.name for l in model.layers if l.weight_specs}
            cut = {n: d for n, d in params.items() if n in names}
        engine.load_params(cut)
        serve(engine, cut, [p[:32] for p in prompts[:2]], f"{kv} warm-up")
        runs[kv], streams[kv] = serve(engine, cut, prompts, kv)
        log(f"[{kv} {SERVE_CUT_LAYERS} layers] "
            f"{runs[kv]['tokens_per_s']:.1f} tokens/s, decode step p50 "
            f"{runs[kv]['decode_step_p50_ms']:.2f} ms")
        del engine, model
        torch.cuda.empty_cache()
    log(f"[phases 8, 12, 13] GPT-2 medium cut to {SERVE_CUT_LAYERS} of "
        f"{gc.layers} layers at full width; its streams in "
        f"{time.perf_counter() - t0:.1f} s")
    return gcc, cut, streams, runs


# ------------------------------------------ phase 8: speculative serving
def verify_gap(engine, params, prompts, runs: list, k: int) -> float:
    """The largest |decode - verify| logit difference, teacher-forced on
    every stream in `runs` (dicts rid -> tokens: the plain run's and the
    speculative run's), independent of the speculative run's own state:
    for each wave of prompts, the plain decode program takes each
    stream's tokens one step at a time; then the positions roll back to
    the prompts and the verify program takes the same tokens K+1 at a
    time, each pass from where the last ended."""
    return max(_verify_gap(engine, params, prompts, run, k) for run in runs)


def _verify_gap(engine, params, prompts, run: dict, k: int) -> float:
    from flexflow_tpu_torch.serving import gpt2_prompt_inputs, gpt2_step_inputs

    kv, slots, dev = engine.kv, engine.slots, engine.device
    seq = int(engine.prefill_model.input_tensors[0].spec.shape[1])
    n = min(len(t) for t in run.values()) // (k + 1) * (k + 1)
    rids, gap = sorted(run), 0.0
    for lo in range(0, len(rids), slots):
        wave = rids[lo:lo + slots]
        ids = np.zeros((slots, seq), np.int32)
        lengths = np.zeros((slots,), np.int32)
        toks = np.zeros((slots, n), np.int32)
        for s, rid in enumerate(wave):
            p = prompts[rid]
            ids[s, :len(p)], lengths[s] = p, len(p)
            toks[s] = run[rid][:n]
            kv.admit(s, len(p), len(p) + n + 2)
        kv.push()
        with torch.no_grad():
            _, kv_state = engine.prefill(params,
                                         gpt2_prompt_inputs(ids, lengths))
        kv.commit_prefill(kv_state, np.arange(slots, dtype=np.int32), lengths)
        tok = torch.from_numpy(toks).to(dev)
        state, dec = kv.state, []
        for i in range(n):
            logits, state = engine.decode_step(
                params, state, gpt2_step_inputs(tok[:, i:i + 1], state))
            dec.append(logits[:, 0].float())
        kv.adopt(state)
        kv.push()                           # back to the prompt extent
        state, ver = kv.state, []
        for i in range(0, n, k + 1):
            logits, state = engine.verify_step(
                params, state, gpt2_step_inputs(tok[:, i:i + k + 1], state))
            ver.append(logits.float())
        kv.adopt(state)
        rows = torch.arange(len(wave), device=dev)
        gap = max(gap, float((torch.stack(dec, 1)[rows]
                              - torch.cat(ver, 1)[rows]).abs().max()))
        for s in range(slots):
            kv.evict(s)
        kv.push()
    return gap


def divergences(engine, params, prompts, base: dict, got: dict,
                gap: float) -> list:
    """Where speculative streams differ from the plain ones. At a request's
    first differing token, a fresh prefill of its prompt and the shared
    prefix gives the two candidate tokens' logits; the divergence is
    admitted if they are closer than 2 x `gap` (the verify program rounds
    its GEMMs at M = slots x (K+1), the decode program at M = slots, and
    a near tie can fall either way). Returns one record a diverging
    request, with "admitted"; a stream that differs in length is never
    admitted."""
    from flexflow_tpu_torch.serving import gpt2_prompt_inputs

    slots = engine.slots
    seq = int(engine.prefill_model.input_tensors[0].spec.shape[1])
    out = []
    for rid, want in sorted(base.items()):
        have = got[rid]
        if have == want:
            continue
        i = next((j for j, (a, b) in enumerate(zip(have, want)) if a != b),
                 None)
        if i is None:
            out.append({"rid": rid, "tokens": len(have),
                        "plain_tokens": len(want), "admitted": False})
            continue
        ctx = list(prompts[rid]) + want[:i]
        ids = np.zeros((slots, seq), np.int32)
        lengths = np.zeros((slots,), np.int32)
        ids[0, :len(ctx)], lengths[0] = ctx, len(ctx)
        with torch.no_grad():
            logits, _ = engine.prefill(params,
                                       gpt2_prompt_inputs(ids, lengths))
        row = logits[0, len(ctx) - 1].float()
        diff = abs(float(row[have[i]] - row[want[i]]))
        out.append({"rid": rid, "token": i, "spec": have[i],
                    "plain": want[i], "logit_diff": diff, "limit": 2 * gap,
                    "admitted": diff < 2 * gap})
    return out


def spec_engine(gc, cfg_kw: dict, params, draft: str, k: int, seed: int):
    """GPT-2 medium with a draft, compiled for K drafted tokens: "small" is
    GPT-2 small from `seed + 1`, "self" GPT-2 medium carrying the target's
    params."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.serving import compile_serving

    models = []
    # the small draft at the target's depth (phase 8 serves the cut model)
    small = dataclasses.replace(GPT2Config.small(), layers=gc.layers)
    for g in (gc, small if draft == "small" else gc):
        m = FFModel(FFConfig(**cfg_kw))
        build_gpt2(m, g, batch=SLOTS)
        models.append(m)
    engine = compile_serving(models[0], draft=models[1], spec_tokens=k)
    engine.load_params(params)
    if draft == "small":
        engine.draft.init(seed=seed + 1)
    else:
        engine.draft.load_params(params)
    return engine


def spec_serve(engine, prompts, label: str, **sched_kw):
    """One speculative scheduler run with every launch counter set to 0
    just before it; the counts (and the dequant decode's by query rows)
    read just after."""
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    sched = ContinuousBatchingScheduler(engine, engine.params,
                                        gpt2_prompt_inputs, gpt2_step_inputs,
                                        **sched_kw)
    sync(engine.device)
    zero_launch_counts()
    t0 = time.perf_counter()
    done = sched.run(reqs)
    sync(engine.device)
    wall = time.perf_counter() - t0
    counts, rows = launch_counts(), dict(da.launches_by_rows)
    if len(done) != len(prompts) or sched.shed or sched.failed:
        fail(f"{label}: {len(done)} of {len(prompts)} requests completed")
    return sched, done, wall, counts, rows


def check_spec_launches(sched, counts: dict, rows: dict, k: int,
                        l_target: int, l_draft: int, int8: bool,
                        label: str) -> dict:
    """Exact launches: each admission wave runs the flash forward once per
    target and draft layer; each int8 round runs the dequant decode K x
    L_draft times at 1 row (the draft steps) and L_target times at K+1
    rows (the verify pass); nothing else launches."""
    rounds = sched.stats["spec_rounds"]
    want = {name: 0 for name in counts}
    want["flash_attention_fwd"] = sched.prefills * (l_target + l_draft)
    want_rows = {}
    if int8:
        want_rows = {1: rounds * k * l_draft, k + 1: rounds * l_target}
        want["dequant_decode_attention"] = sum(want_rows.values())
    if counts != want or rows != want_rows:
        fail(f"{label}: launches {counts} by rows {rows}, want {want} by "
             f"rows {want_rows} ({sched.prefills} waves, {rounds} rounds)")
    return {"rounds": rounds, "waves": sched.prefills,
            "dequant_by_rows": {str(r): n for r, n in rows.items()}}


def check_pages_and_memory(engine, label: str) -> dict:
    """Every page back on both free lists; memory_stats() predicted equals
    actual for both caches."""
    pages_back(engine.kv, f"{label} target cache")
    pages_back(engine.draft.kv, f"{label} draft cache")
    mem = engine.memory_stats()
    for pre in ("", "draft_"):
        if mem[f"{pre}predicted_kv_cache_bytes"] != \
                mem[f"{pre}actual_kv_cache_bytes"]:
            fail(f"{label}: {pre}KV cache predicted "
                 f"{mem[pre + 'predicted_kv_cache_bytes']} != actual "
                 f"{mem[pre + 'actual_kv_cache_bytes']}")
    return mem


def spec_leg(gc, cfg_kw: dict, params, prompts, base: dict, draft: str,
             k: int, seed: int, label: str) -> tuple:
    """One speculative leg: the decode-verify gap, a warm-up, the counted
    run, its launches, pages, streams and metrics."""
    engine = spec_engine(gc, cfg_kw, params, draft, k, seed)
    int8 = engine.kv_quantized
    spec_serve(engine, [p[:32] for p in prompts[:2]], f"{label} warm-up")
    sched, done, wall, counts, rows = spec_serve(engine, prompts, label)
    l_draft = len(engine.draft.attn_layers)
    launches = check_spec_launches(sched, counts, rows, k, gc.layers, l_draft,
                                   int8, label)
    mem = check_pages_and_memory(engine, label)
    got = {r.rid: list(r.tokens) for r in done}
    # measured before the streams are compared
    gap = verify_gap(engine, params, prompts, [base, got], k)
    diverged = divergences(engine, params, prompts, base, got, gap)
    for d in diverged:
        if not d["admitted"]:
            fail(f"{label}: a divergence the rule does not admit: {d}")
        log(f"[{label}] admitted divergence: {d}")
    st = sched.stats
    accept = st["spec_accepted_tokens"] / st["spec_drafted_tokens"]
    ttft = np.array([r.ttft_s for r in done])
    tokens = sum(len(r.tokens) for r in done)
    out = {"leg": label, "draft": draft, "spec_tokens": k,
           "kv_cache_dtype": "int8" if int8 else "auto",
           "draft_layers": l_draft, "requests": len(done), "tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
           "ttft_p99_ms": 1e3 * float(np.percentile(ttft, 99)),
           "per_committed_token_p50_ms": 1e3 * float(np.median(
               sched.step_times)),
           "host_syncs": sched.materializations + sched.prefills,
           "round_syncs": sched.materializations,
           "accept_rate": accept, "accept_ema": sched._accept_ema,
           "decode_verify_gap": gap, "divergences": diverged,
           "streams_equal": len(got) - len(diverged),
           "overdecode_tokens": st["overdecode_tokens"],
           "launches": counts, **launches,
           "kv_cache_bytes": mem["actual_kv_cache_bytes"],
           "draft_kv_cache_bytes": mem["draft_actual_kv_cache_bytes"]}
    if out["round_syncs"] != launches["rounds"]:
        fail(f"{label}: {out['round_syncs']} round syncs for "
             f"{launches['rounds']} rounds")
    log(f"[{label}] {out['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms p99 {out['ttft_p99_ms']:.1f} ms, "
        f"per committed token p50 {out['per_committed_token_p50_ms']:.2f} "
        f"ms, {launches['rounds']} rounds, {out['host_syncs']} host syncs, "
        f"acceptance {accept:.3f}, decode-verify gap {gap:.4f}, "
        f"{len(diverged)} admitted divergences, launches {counts} "
        f"by rows {launches['dequant_by_rows']}")
    return out, engine


def profile_spec(engine, params, prompts, k: int) -> dict:
    """Where a speculative round spends its time: the first wave's prompts
    prefilled into every slot of both caches, then rounds over all slots
    under the profiler (the positions advance by the round's own K+1 and
    K: no acceptance is applied)."""
    from flexflow_tpu_torch.serving import gpt2_prompt_inputs, gpt2_step_inputs

    slots, dev = engine.slots, engine.device
    seq = int(engine.prefill_model.input_tensors[0].spec.shape[1])
    ids = np.zeros((slots, seq), np.int32)
    lengths = np.zeros((slots,), np.int32)
    rounds = 4
    for s, p in enumerate(prompts[:slots]):
        ids[s, :len(p)], lengths[s] = p, len(p)
        for kv in (engine.kv, engine.draft.kv):
            kv.admit(s, len(p), len(p) + (k + 1) * rounds)
    for e, prm in ((engine, params), (engine.draft, engine.draft.params)):
        e.kv.push()
        _, kv_state = e.prefill(prm, gpt2_prompt_inputs(ids, lengths))
        e.kv.commit_prefill(kv_state, np.arange(slots, dtype=np.int32),
                            lengths)
    box = {"t": engine.kv.state, "d": engine.draft.kv.state,
           "last": torch.ones((slots, 1), dtype=torch.int32, device=dev)}

    def one_round():
        t_pred, _, box["t"], box["d"] = engine.spec_round_step(
            params, engine.draft.params, box["t"], box["d"], box["last"],
            gpt2_step_inputs)
        box["last"] = t_pred[:, :1].contiguous()
    prof = _device_profile(one_round, rounds, dev)
    for kv, st in ((engine.kv, box["t"]), (engine.draft.kv, box["d"])):
        kv.adopt(st)
        for s in range(slots):
            kv.evict(s)
        kv.push()
    return prof


def slo_trace_leg(engine, prompts, seed: int) -> dict:
    """8e: the int8 engine without a draft serves the prompts as an
    open-loop trace (exponential gaps of 40 ms from the seed, priorities
    0/1/2) under a queue cap, chunked admission and SLO objectives."""
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    rng = np.random.default_rng(seed + 8)
    arrivals = np.cumsum(rng.exponential(0.040, size=len(prompts)))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS,
                    arrival_s=float(arrivals[i]), priority=i % 3)
            for i, p in enumerate(prompts)]
    sched = ContinuousBatchingScheduler(
        engine, engine.params, gpt2_prompt_inputs, gpt2_step_inputs,
        prefill_chunk_tokens=PREFILL_CHUNK)
    sync(engine.device)
    zero_launch_counts()
    done = sched.run(reqs)
    sync(engine.device)
    counts = launch_counts()
    ends_once(sched, len(prompts), "8e")
    pages_back(engine.kv, "8e")
    waves = sorted({r.admit_s for r in done})
    shed = {k[len("shed_"):]: v for k, v in sched.stats.items()
            if k.startswith("shed_")}
    out = {"requests": len(reqs), "completed": len(done),
           "shed_by_reason": shed, "failed": len(sched.failed),
           "waves": len(waves), "prefills": sched.prefills,
           "ttft_p99_ms": (1e3 * float(np.percentile(
               [r.ttft_s for r in done], 99)) if done else None),
           "slo": engine.slo.report(), "launches": counts}
    log(f"[8e] {len(done)} of {len(reqs)} done, shed by reason {shed}, "
        f"{out['waves']} admission waves, SLO report {out['slo']}")
    return out


def watchdog_leg(engine, prompts) -> dict:
    """8f: 4 requests under a decode watchdog of 2 ms, which every
    host-bound decode window exceeds: each sync evicts the slot with the
    most tokens (ties to the lowest slot) as "timeout"."""
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts[:4])]
    sched = ContinuousBatchingScheduler(
        engine, engine.params, gpt2_prompt_inputs, gpt2_step_inputs,
        decode_timeout_ms=WATCHDOG_MS)
    picks = []
    pick = sched._pick_wedged

    def watched(active):
        slot = pick(active)
        most = max(len(r.tokens) for r in active.values())
        if slot != min(s for s, r in active.items() if len(r.tokens) == most):
            fail(f"8f: the watchdog picked slot {slot} of "
                 f"{ {s: len(r.tokens) for s, r in active.items()} }")
        picks.append({"rid": active[slot].rid, "slot": slot,
                      "tokens": len(active[slot].tokens),
                      "active": len(active)})
        return slot
    sched._pick_wedged = watched
    sync(engine.device)
    zero_launch_counts()
    sched.run(reqs)
    sync(engine.device)
    counts = launch_counts()
    ends_once(sched, len(reqs), "8f")
    pages_back(engine.kv, "8f")
    if [r.rid for r in sched.failed] != [p["rid"] for p in picks] or \
            {r.outcome for r in sched.failed} != {"timeout"} or not picks:
        fail(f"8f: timeouts {[(r.rid, r.outcome) for r in sched.failed]}, "
             f"picks {picks}")
    out = {"evictions": picks, "decode_timeouts":
           sched.stats["decode_timeouts"], "completed": len(sched.completed),
           "timeouts": len(sched.failed), "launches": counts}
    log(f"[8f] watchdog {WATCHDOG_MS} ms: evicted {picks}, "
        f"{len(sched.completed)} completed")
    return out


def ends_once(sched, n: int, label: str) -> None:
    """Each request ended exactly once, as done, shed, failed or timeout."""
    ends = sorted(r.rid for r in sched.completed + sched.shed + sched.failed)
    outcomes = {r.outcome for r in sched.completed + sched.shed + sched.failed}
    if ends != list(range(n)) or not outcomes <= {"done", "shed", "failed",
                                                  "timeout"}:
        fail(f"{label}: requests ended {ends}, outcomes {outcomes}")


def pages_back(kv, label: str) -> None:
    if sorted(kv.free_pages) != list(range(1, kv.capacity_pages() + 1)):
        fail(f"{label}: {kv.capacity_pages() - len(kv.free_pages)} pages "
             "not returned")


def phase8(gc, params, prompts, streams: dict, seed: int) -> dict:
    """Speculative serving on phase 3's weights, prompts and streams (by
    KV dtype, rid -> tokens): four legs,
    {int8, compute-dtype KV} x {GPT-2 small draft, self-draft}, at K=4;
    a profile of the int8 GPT-2 small leg; the gate leg (K=7 serves one
    wave, K=8 raises at compile time); then the admission legs 8e, 8f."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import build_gpt2
    from flexflow_tpu_torch.serving import compile_serving

    out = {"legs": []}
    for kv in ("int8", "auto"):
        cfg_kw = dict(seed=seed, compute_dtype="bfloat16",
                      max_batch_slots=SLOTS, kv_page_size=PAGE,
                      max_decode_len=NEW_TOKENS, kv_cache_dtype=kv)
        for draft in ("small", "self"):
            label = f"8 spec {kv} {draft}"
            leg, engine = spec_leg(gc, cfg_kw, params, prompts, streams[kv],
                                   draft, SPEC_K, seed, label)
            if draft == "self" and leg["accept_rate"] < 0.9:
                fail(f"{label}: the self-draft accepts {leg['accept_rate']}")
            if kv == "int8" and draft == "small":
                prof = profile_spec(engine, params, prompts, SPEC_K)
                out["profile"] = prof
                if "wall_ms_per_call" in prof:
                    log(f"[{label}] round: {prof['wall_ms_per_call']:.2f} ms "
                        f"wall, device busy "
                        f"{prof['device_busy_ms_per_call']:.2f} ms, idle "
                        f"share {prof['device_idle_share']:.3f}, "
                        f"{prof['kernel_launches_per_call']:.0f} launches a "
                        "round, the port's kernels " + ", ".join(
                            f"{n} {v['ms_per_call']:.3f} ms "
                            f"x{v['launches_per_call']:.0f}"
                            for n, v in prof["port_kernels"].items()))
            out["legs"].append(leg)
            del engine
            collect_garbage()
            torch.cuda.empty_cache()
    # the gate: 8 query rows serve one wave, 9 are refused at compile time
    cfg_kw = dict(seed=seed, compute_dtype="bfloat16", max_batch_slots=SLOTS,
                  kv_page_size=PAGE, max_decode_len=NEW_TOKENS,
                  kv_cache_dtype="int8")
    wave = prompts[:SLOTS]
    gate, engine = spec_leg(gc, cfg_kw, params, wave,
                            {i: streams["int8"][i] for i in range(SLOTS)},
                            "small", SPEC_K_GATE, seed,
                            f"8 gate int8 K={SPEC_K_GATE}")
    out["gate"] = gate
    del engine
    try:
        spec_engine(gc, cfg_kw, params, "small", SPEC_K_GATE + 1, seed)
    except ValueError as e:
        if "MAX_QUERY_ROWS" not in str(e):
            fail(f"K={SPEC_K_GATE + 1} raised another error: {e}")
        out["gate"]["k_plus_one_refused"] = str(e)
        log(f"[8 gate] K={SPEC_K_GATE + 1} refused at compile time: {e}")
    else:
        fail(f"K={SPEC_K_GATE + 1} with an int8 cache compiled")
    collect_garbage()
    torch.cuda.empty_cache()
    # 8e/8f: the int8 engine without a draft, with SLO objectives
    model = FFModel(FFConfig(**cfg_kw, serve_slo=SLO_SPEC,
                             serve_queue_cap=QUEUE_CAP))
    build_gpt2(model, gc, batch=SLOTS)
    engine = compile_serving(model)
    engine.load_params(params)
    out["slo_trace"] = slo_trace_leg(engine, prompts, seed)
    out["watchdog"] = watchdog_leg(engine, prompts)
    del engine, model
    collect_garbage()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- training
def gpt2_train_model(seed: int, layers: int, compute_dtype: str,
                     optimizer=None, vocab_pad_to: int = 0,
                     dropout: float = 0.0, **cfg):
    """GPT-2 medium widths at `layers` deep with `dropout`, compiled for
    training with `optimizer` (Adam(1e-4) when None) and sparse CE, the
    lm_head padded to a multiple of `vocab_pad_to`, weights from the seed,
    `cfg` passed to FFConfig (remat=True, checkpoint knobs)."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2

    gc = GPT2Config.medium()
    gc.layers, gc.dropout, gc.vocab_pad_to = layers, dropout, vocab_pad_to
    model = FFModel(FFConfig(batch_size=BATCH, compute_dtype=compute_dtype,
                             seed=seed, **cfg))
    build_gpt2(model, gc, batch=BATCH)
    cm = model.compile(optimizer or AdamOptimizer(alpha=LR),
                       "sparse_categorical_crossentropy", [])
    cm.init(seed=seed)
    return gc, model, cm


def train_batch(seed: int, vocab: int, n: int = BATCH):
    """ids, positions and labels as bench.py draws them, on the card."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(n, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    labels = rng.integers(0, vocab, size=(n, SEQ)).astype(np.int32)
    return ids, pos, labels


def l2_rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# (a): loss relative difference, gradient relative L2, relative L2 of the
# step's update to the params. f32 (TF32 off) differs by summation order
# only; bf16 by a bf16 rounding that lands the other way where an f32 sum
# differs in its last bits, through 2 layers of backward. Adam's first step
# is -lr sign(g) (up to eps), so the update's relative L2 is about
# 2 sqrt(share of elements whose gradient sign differs): the gradients
# near 0, where the bf16 noise decides the sign; 0.3 allows 2%.
GRAD_TOL = {"float32": {"loss": 1e-5, "grad": 1e-4, "update": 1e-3},
            "bfloat16": {"loss": 1e-2, "grad": 5e-2, "update": 3e-1}}
# (e), SGD with momentum: the update compared is the one the optimizer
# applies, -lr t', read from the trace it stores, not p' - p (where the
# params' own ulp swamps updates of a few ulps, e.g. on LayerNorm gains
# near 1). From a zero trace t' = g exactly, so the update is held to the
# gradient's tolerance.
GRAD_TOL_SGD = {dt: dict(tol, update=tol["grad"])
                for dt, tol in GRAD_TOL.items()}
# (9g), BERT: its FFN is relu where GPT-2's is gelu. The flash forward's
# last bits (f32 ~4e-7 from the plain version's) move the relu units whose
# pre-activation lies that close to 0 to the other side, and their whole
# gradient rows change with them: a gradient's relative L2 then grows as
# the square root of the share of flipped units, not with the rounding
# (read on an H100 80GB HBM3 at 700 W: 6.3e-4 in f32, bf16 4.5e-2,
# where GPT-2 stays below 1e-4), and Adam's first step (~ -lr sign(g))
# turns each flipped gradient sign into 2 lr. Held at f32: gradient
# 2e-3, update 0.15 (a share of 0.6% of signs flipped); bf16: gradient
# 0.1, update 5a's 0.3.
GRAD_TOL_RELU = {"float32": {"loss": 1e-5, "grad": 2e-3, "update": 0.15},
                 "bfloat16": {"loss": 1e-2, "grad": 1e-1, "update": 3e-1}}


def sgd_param_excess(p_k, p_p, d_k, d_p) -> float:
    """Each updated param is p' = fl(p + d) from the same p, with d the
    applied update, so IEEE rounding gives |p'_k - p'_p| <= |d_k - d_p| +
    one ulp of the larger p'. Returns the largest excess over that bound
    (<= 0 when it holds), in float64."""
    big = torch.maximum(p_k.abs(), p_p.abs())
    ulp = (torch.nextafter(big, torch.full_like(big, float("inf")))
           - big).double()
    return float(((p_k.double() - p_p.double()).abs()
                  - (d_k.double() - d_p.double()).abs() - ulp).max())


def train_grad_check(seed: int, optimizer_fn=None, vocab_pad_to: int = 0,
                     tols=GRAD_TOL, tag: str = "train") -> dict:
    """`grad_check` at GPT-2 medium widths and 2 layers, with the optimizer
    `optimizer_fn()` (Adam(1e-4) when None). The key bias `bk` is left out
    of the gradient and update checks: its gradient is zero in exact
    arithmetic (the softmax cancels it), so both runs hold rounding noise
    there."""
    from flexflow_tpu_torch.models import GPT2Config

    gc = GPT2Config.medium()
    ids, pos, labels = train_batch(seed + 1, gc.vocab)
    inputs = [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]
    label = torch.from_numpy(labels).cuda()

    def make(dt):
        return gpt2_train_model(seed, 2, dt, optimizer_fn() if optimizer_fn
                                else None, vocab_pad_to)[2]
    return grad_check(make, inputs, label, tols, tag, "2 layers",
                      skip=("bk",))


def grad_check(make, inputs, label, tols, tag: str, depth: str,
               skip=()) -> dict:
    """One step through the kernels and one through the plain versions,
    from the same params and state, of the model `make(dtype)` compiles,
    in f32 and bf16: the loss, every gradient and every updated param.
    Weights named in `skip` are left out of the gradient and update
    checks. Under SGD with momentum the update is -lr t' from the stored
    trace, under SGD without it -lr (g + wd p) from the run's gradients,
    and in both every updated param is held to `sgd_param_excess`."""
    out = {}
    for dt in ("float32", "bfloat16"):
        cm = make(dt)
        sgd = type(cm.optimizer).__name__ == "SGDOptimizer"
        sgd_lr = cm.optimizer.lr if sgd else None
        wd = cm.optimizer.weight_decay if sgd else 0.0
        p0 = {l: {w: t.detach().clone() for w, t in ws.items()}
              for l, ws in cm.params.items()}
        loss_k, _, _, g_k = cm.value_and_grads(cm.params, cm.state, inputs,
                                               label)
        with PlainKernels():
            loss_p, _, _, g_p = cm.value_and_grads(cm.params, cm.state,
                                                   inputs, label)
        grad_err = max(l2_rel(g_k[l][w], g_p[l][w])
                       for l in g_k for w in g_k[l] if w not in skip)
        updated, after = [], []
        for plain in (False, True):
            cm.load_params(p0)
            if plain:
                with PlainKernels():
                    cm.train_step(cm.params, cm.opt_state, cm.state, inputs,
                                  label)
            else:
                cm.train_step(cm.params, cm.opt_state, cm.state, inputs, label)
            after.append({l: {w: t.detach() for w, t in ws.items()}
                          for l, ws in cm.params.items()})
            g = g_p if plain else g_k
            updated.append({l: {w: (
                -sgd_lr * cm.opt_state["trace"][l][w]
                if "trace" in cm.opt_state
                else -sgd_lr * (g[l][w].float() + wd * p0[l][w])
                if sgd else t - p0[l][w])
                for w, t in ws.items()}
                for l, ws in after[-1].items()})
        upd_err = max(l2_rel(updated[0][l][w], updated[1][l][w])
                      for l in p0 for w in p0[l] if w not in skip)
        loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        tol = tols[dt]
        out[dt] = {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
                   "loss_rel_err": loss_err, "grad_rel_l2_max": grad_err,
                   "update_rel_l2_max": upd_err,
                   "update_read_as": (
                       "-lr * trace" if "trace" in cm.opt_state
                       else "-lr * (g + wd * p)" if sgd else "p' - p"),
                   "tolerance": tol}
        ok = (loss_err <= tol["loss"] and grad_err <= tol["grad"]
              and upd_err <= tol["update"])
        excess = ""
        if sgd_lr is not None:
            out[dt]["param_excess_max"] = max(
                sgd_param_excess(after[0][l][w], after[1][l][w],
                                 updated[0][l][w], updated[1][l][w])
                for l in p0 for w in p0[l])
            ok = ok and out[dt]["param_excess_max"] <= 0.0
            excess = (f", params' worst excess over the rounding bound "
                      f"{out[dt]['param_excess_max']:.2e} (tolerance 0)")
        log(f"[{tag} {dt}, {depth}] loss {float(loss_k):.6f} vs plain "
            f"{float(loss_p):.6f} (rel {loss_err:.2e}), worst gradient rel L2 "
            f"{grad_err:.2e}, worst update ({out[dt]['update_read_as']}) rel "
            f"L2 {upd_err:.2e}{excess} (tolerances {tol})")
        if not ok:
            fail(f"{tag}: training step through the kernels vs plain ({dt}): "
                 f"{out[dt]}")
        del cm, g_k, g_p, updated, after, p0
        torch.cuda.empty_cache()
    return out


def train_full(seed: int, optimizer, vocab_pad_to: int, exact: dict,
               tag: str, dropout: float = 0.0,
               timed_steps: int = TRAIN_STEPS, **cfg) -> tuple:
    """GPT-2 medium at full depth: 2 warm-up and `timed_steps` (10) timed
    steps on one batch, the launch counters zeroed before them and read
    after.
    `exact` gives every kernel's launches per step (a kernel it does not
    name must not launch). The optimizer's pointer table must be built
    in the first step and never again. Step i draws its dropout from
    fold_in(key(seed + 17), i), the key `fit` gives it. Returns (summary,
    compiled model, device inputs, label)."""
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.kernels import fused_optim as fo

    gc, model, cm = gpt2_train_model(seed, LAYERS, "bfloat16", optimizer,
                                     vocab_pad_to, dropout, **cfg)
    ids, pos, labels = train_batch(seed, gc.vocab)
    inputs = [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]
    label = torch.from_numpy(labels).cuda()
    losses = []
    base = ff_random.key(seed + 17)

    def step():
        (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, inputs, label,
            ff_random.fold_in(base, len(losses)))
        losses.append(loss)

    torch.cuda.synchronize()
    # an earlier model is freed only by the collector (FFModel and its
    # CompiledModel refer to each other): collect it before the peak is
    # reset, so that the peak counts this model's memory alone
    collect_garbage()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    builds0 = fo.table_builds
    for _ in range(WARMUP_STEPS):
        step()
    torch.cuda.synchronize()
    builds = [fo.table_builds - builds0]
    windows = []
    for _ in range(timed_steps // 2):
        t0 = time.perf_counter()
        step()
        step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 2)
    counts = launch_counts()
    builds.append(fo.table_builds - builds0 - builds[0])
    steps = WARMUP_STEPS + timed_steps
    loss_vals = [float(x) for x in losses]
    step_s = float(np.median(windows))
    tokens = BATCH * SEQ
    summary = {
        "model": "gpt2-medium", "layers": LAYERS, "batch": BATCH, "seq": SEQ,
        "vocab_pad_to": vocab_pad_to, "dropout": dropout,
        "remat": sorted(set((cm.strategy.remat or {}).values())) or "off",
        "lm_head_columns": int(cm.params["lm_head"]["kernel"].shape[1]),
        "compute_dtype": "bfloat16",
        "optimizer": (f"{type(optimizer).__name__}({vars(optimizer)})"
                      if optimizer else f"Adam({LR})"),
        "params": sum(t.numel() for ws in cm.params.values()
                      for t in ws.values()), "steps": steps,
        "step_ms_median": 1e3 * step_s,
        "step_ms_windows": [1e3 * w for w in windows],
        "samples_per_s": BATCH / step_s, "tokens_per_s": tokens / step_s,
        "mfu": gc.flops_per_token() * tokens / step_s / BF16_FLOPS,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": loss_vals, "launches": counts,
        "table_builds_warmup_timed": builds}
    log(f"[{tag}] step {summary['step_ms_median']:.1f} ms "
        f"(windows {', '.join(f'{w:.1f}' for w in summary['step_ms_windows'])})"
        f", {summary['samples_per_s']:.2f} samples/s, "
        f"{summary['tokens_per_s']:.0f} tokens/s, MFU "
        f"{100 * summary['mfu']:.2f}%, peak "
        f"{summary['max_memory_allocated_gib']:.1f} GiB")
    log(f"[{tag}] losses {' '.join(f'{x:.4f}' for x in loss_vals)}")
    log(f"[{tag}] launches over {steps} steps: {counts}; optimizer table "
        f"builds in the warm-up and timed steps: {builds}")
    if not all(np.isfinite(loss_vals)):
        fail(f"non-finite training loss: {loss_vals}")
    if not loss_vals[-1] < loss_vals[0]:
        fail(f"training loss did not fall: {loss_vals}")
    want = {name: exact.get(name, 0) * steps for name in counts}
    if counts != want:
        fail(f"{tag}: launches over {steps} steps {counts}, expected {want}")
    if builds != [1, 0]:
        fail(f"{tag}: the optimizer's pointer table was built {builds} "
             f"times in the warm-up and timed steps, expected [1, 0]")
    return summary, cm, inputs, label


def train_fit(cm, vocab: int, seed: int) -> dict:
    """One fit epoch over 4 batches with the loss read only at its end."""
    from flexflow_tpu_torch.kernels import fused_optim as fo

    ids, pos, labels = train_batch(seed + 2, vocab, n=4 * BATCH)
    torch.cuda.synchronize()
    zero_launch_counts()
    builds0 = fo.table_builds
    t0 = time.perf_counter()
    hist = cm.fit([ids, pos], labels, epochs=1, verbose=False, sync_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    out = {"history": hist, "step_stats": dict(cm.step_stats),
           "wall_s": wall, "launches": counts,
           "table_builds": fo.table_builds - builds0}
    log(f"[train fit] loss {hist[0]['loss']:.4f}, "
        f"{hist[0]['samples_per_sec']:.2f} samples/s, step_stats "
        f"{cm.step_stats}, launches {counts}, optimizer table builds "
        f"{out['table_builds']}")
    if not np.isfinite(hist[0]["loss"]) or cm.step_stats != {
            "dispatches": 4, "host_syncs": 0, "barriers": 0,
            "fused_steps": 0} or out["table_builds"] != 0:
        fail(f"fit epoch: {out}")
    if min(counts[n] for n in ("flash_attention_fwd", "flash_attention_dq",
                               "flash_attention_dkv", "fused_adam")) <= 0:
        fail(f"fit did not launch every training kernel: {counts}")
    return out


def train_accum_fit(seed: int) -> dict:
    """(g): GPT-2 medium at full depth with the vocab padded to 128 and
    SGD(0.01) without momentum: one fit epoch over 4 batches with
    accum_steps=2 and the loss read only at its end, the launch counters
    zeroed just before it: 2 updates, each of 2 microbatches."""
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.kernels import fused_optim as fo

    _, _, cm = gpt2_train_model(seed, LAYERS, "bfloat16",
                                SGDOptimizer(lr=SGD_LR), PAD_TO)
    ids, pos, labels = train_batch(seed + 3, GPT2_VOCAB, n=4 * BATCH)
    torch.cuda.synchronize()
    zero_launch_counts()
    builds0 = fo.table_builds
    t0 = time.perf_counter()
    hist = cm.fit([ids, pos], labels, epochs=1, verbose=False, sync_every=0,
                  accum_steps=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = {name: 0 for name in counts}
    want.update({"flash_attention_fwd": 4 * LAYERS,
                 "flash_attention_dq": 4 * LAYERS,
                 "flash_attention_dkv": 4 * LAYERS,
                 "fused_ce_fwd": 4, "fused_ce_bwd": 4, "fused_sgd_plain": 2})
    out = {"history": hist, "step_stats": dict(cm.step_stats),
           "wall_s": wall, "launches": counts,
           "table_builds": fo.table_builds - builds0}
    log(f"[train accum fit] loss {hist[0]['loss']:.4f}, "
        f"{hist[0]['samples_per_sec']:.2f} samples/s, step_stats "
        f"{cm.step_stats}, launches {counts}, optimizer table builds "
        f"{out['table_builds']}")
    if not np.isfinite(hist[0]["loss"]) or cm.step_stats != {
            "dispatches": 2, "host_syncs": 0, "barriers": 0,
            "fused_steps": 0} or out["table_builds"] != 1:
        fail(f"accum_steps=2 fit epoch: {out}")
    if counts != want:
        fail(f"accum_steps=2 fit epoch: launches {counts}, expected {want}")
    return out


# ------------------------------------------------------ training, phase 6
DROPOUT = 0.1   # GPT-2's published dropout (GPT2Config's default)
# 6a/6c, remat against remat off on one model: the forward (and so the
# loss) is the same program, so the losses must be equal; the gradients
# are expected bitwise (the same kernels recompute the same values) and
# are held to a relative L2 of 1e-3, which a rounding of bf16 activations
# the other way would already exceed; what was read is printed.
REMAT_GRAD_TOL = 1e-3
# 6c and 6d: losses of two runs of the same steps (remat against remat
# off, resumed against uninterrupted), expected bitwise, held to 1e-3
# relative
RUN_LOSS_RTOL = 1e-3
FIT_LAYERS = 4   # 6d's depth: the fit is interrupted, resumed and rerun
# 6b's and 6c's timed steps after the 2 warm-up ones (5b's 10: the time
# limit's cut since phase 21, PERF.md section 4)
P6_TIMED_STEPS = 4


class MaskLog:
    """Wrap `LoweringCtx.dropout_mask` to keep every drawn mask's element
    count and kept count (device scalars; no sync), and the masks of the
    layers named in `keep_masks`."""

    def __init__(self, keep_masks=()):
        self.draws, self.masks, self.keep_masks = [], [], set(keep_masks)

    def __enter__(self):
        from flexflow_tpu_torch.ops.registry import LoweringCtx
        self.cls, self.real = LoweringCtx, LoweringCtx.dropout_mask
        log_ = self

        def logged(ctx, layer, shape, keep, device):
            m = log_.real(ctx, layer, shape, keep, device)
            log_.draws.append((layer.name, m.numel(), m.sum(), keep))
            if layer.name in log_.keep_masks:
                log_.masks.append((layer.name, ctx.rng, m))
            return m
        LoweringCtx.dropout_mask = logged
        return self

    def __exit__(self, *exc):
        self.cls.dropout_mask = self.real


def keep_rate_check(draws) -> dict:
    """Every mask's kept count against the binomial around keep: within
    5 sigma, or the run fails."""
    worst, rows = 0.0, []
    for name, n, kept, keep in draws:
        z = (float(kept) - n * keep) / (n * keep * (1 - keep)) ** 0.5
        worst = max(worst, abs(z))
        rows.append({"layer": name, "elements": n,
                     "keep_rate": float(kept) / n, "z": z})
    if not rows or worst > 5.0:
        fail(f"dropout keep rates off the binomial (worst |z| {worst:.2f}): "
             f"{rows[:8]}")
    return {"masks": len(rows), "worst_abs_z": worst,
            "keep_rates": sorted({round(r["keep_rate"], 5) for r in rows})}


def grads_against(ref, got) -> dict:
    """Loss equality and the gradients' relative L2 of two
    `value_and_grads` results of one model, and how many gradients are
    bitwise equal."""
    rel = {f"{l}.{w}": l2_rel(got[3][l][w], ref[3][l][w])
           for l in ref[3] for w in ref[3][l]}
    same = sum(torch.equal(got[3][l][w], ref[3][l][w])
               for l in ref[3] for w in ref[3][l])
    return {"loss": float(got[0]), "loss_ref": float(ref[0]),
            "loss_equal": float(got[0]) == float(ref[0]),
            "grads_bitwise_equal": f"{same}/{len(rel)}",
            "grad_rel_l2_max": max(rel.values())}


def dropout_remat_check(seed: int) -> dict:
    """6a: GPT-2 medium widths at 2 layers, b8, seq 1024, bf16, dropout
    0.1, vocab padded to 128. One step's masks: keep rates within 5 sigma;
    the same (key, layer) drawing the same mask twice; the next step's key
    another mask. Remat "full" and "dots" on every layer of the same model:
    the loss of remat off, the gradients within REMAT_GRAD_TOL."""
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.ops.registry import LoweringCtx

    gc, model, cm = gpt2_train_model(seed, 2, "bfloat16", None, PAD_TO,
                                     DROPOUT)
    ids, pos, labels = train_batch(seed + 4, GPT2_VOCAB)
    inputs = [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]
    label = torch.from_numpy(labels).cuda()
    base = ff_random.key(seed + 17)
    keys = [ff_random.fold_in(base, i) for i in range(2)]
    runs = {}
    with MaskLog(keep_masks=("embed_drop",)) as ml:
        runs["off"] = cm.value_and_grads(cm.params, cm.state, inputs, label,
                                         keys[0])
        n_one_step = len(ml.draws)
        cm.value_and_grads(cm.params, cm.state, inputs, label, keys[1])
    rates = keep_rate_check(ml.draws[:n_one_step])
    layer = model.get_layer_by_name("embed_drop")
    ctx = LoweringCtx(training=True, rng=keys[0])
    again = ctx.dropout_mask(layer, ml.masks[0][2].shape, 1 - DROPOUT,
                             cm.device)
    same_twice = bool(torch.equal(again, ml.masks[0][2]))
    steps_differ = not torch.equal(ml.masks[0][2], ml.masks[1][2])
    # the mask of the attention probs (b8, 16 heads, 1024 x 1024) drawn
    # from the host key and from its device copy: bitwise equal; and its
    # device time (CUDA events, median of 5)
    probs = (BATCH, 16, SEQ, SEQ)
    dkey = ff_random.device_key(keys[0], cm.device)
    host_dev_equal = bool(torch.equal(
        ff_random.bernoulli_mask(keys[0], probs, 1 - DROPOUT, cm.device),
        ff_random.bernoulli_mask(dkey, probs, 1 - DROPOUT, cm.device)))
    times = []
    for _ in range(5):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        ff_random.bernoulli_mask(dkey, probs, 1 - DROPOUT, cm.device)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    mask_ms = float(np.median(times))
    out = {"masks_one_step": rates, "same_key_same_mask": same_twice,
           "next_step_other_mask": steps_differ,
           "host_and_device_key_same_mask": host_dev_equal,
           "probs_mask_ms": mask_ms}
    log(f"[6a dropout] one step drew {rates['masks']} masks, worst |z| "
        f"{rates['worst_abs_z']:.2f} (limit 5), keep rates "
        f"{rates['keep_rates']}; same key twice equal: {same_twice}; "
        f"next step's mask differs: {steps_differ}; host and device key "
        f"draw the same mask: {host_dev_equal}; the probs' mask {probs} "
        f"takes {mask_ms:.3f} ms on the card")
    if not (same_twice and steps_differ and host_dev_equal):
        fail(f"6a dropout masks: {out}")
    for pol in ("full", "dots"):
        cm.forward_fn.remat = {l.name: pol for l in model.layers}
        got = cm.value_and_grads(cm.params, cm.state, inputs, label, keys[0])
        out[f"remat_{pol}"] = r = grads_against(runs["off"], got)
        log(f"[6a remat {pol}] loss {r['loss']:.6f} vs remat off "
            f"{r['loss_ref']:.6f} (equal: {r['loss_equal']}), gradients "
            f"bitwise equal {r['grads_bitwise_equal']}, worst relative L2 "
            f"{r['grad_rel_l2_max']:.2e} (tolerance {REMAT_GRAD_TOL})")
        if not (r["loss_equal"] and r["grad_rel_l2_max"] <= REMAT_GRAD_TOL):
            fail(f"6a remat {pol} against remat off: {r}")
        del got
    cm.forward_fn.remat = {}
    del cm, model, runs
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def compare_runs(a: dict, b: dict, what: str) -> dict:
    """Two train_full summaries of the same steps: their losses."""
    la, lb = np.array(a["losses"]), np.array(b["losses"])
    rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    out = {"losses_equal": bool(np.array_equal(la, lb)),
           "loss_rel_max": rel, "tolerance": RUN_LOSS_RTOL}
    log(f"[{what}] losses equal: {out['losses_equal']}, worst relative "
        f"difference {rel:.2e} (tolerance {RUN_LOSS_RTOL})")
    if rel > RUN_LOSS_RTOL:
        fail(f"{what}: losses {a['losses']} vs {b['losses']}")
    return out


def _tree_to_host(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) \
        else tree


def _trees_bitwise(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_bitwise(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(a, b.to(a.device)))
    return a == b


class StepLog:
    """fit callback: every update's loss; with `kill_at`, SIGTERM to this
    process after that many updates."""

    def __init__(self, kill_at: int = 0):
        self.losses, self.kill_at = [], kill_at

    def on_batch_end(self, it, logs):
        self.losses.append(logs["loss"])
        if len(self.losses) == self.kill_at:
            os.kill(os.getpid(), signal.SIGTERM)


def fit_model(seed: int, **cfg):
    """6d's model, as a relaunched process builds it: the layer guids
    (which the dropout keys fold in) numbered from the start again."""
    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.core.layer import Layer
    from flexflow_tpu_torch.core.tensor import Tensor

    Layer._next_guid[0], Tensor._next_guid[0] = 100, 1000
    return gpt2_train_model(seed, FIT_LAYERS, "bfloat16",
                            AdamOptimizer(alpha=LR), PAD_TO, DROPOUT, **cfg)


def fit_preempt_resume(seed: int) -> dict:
    """6d: `fit` at GPT-2 medium widths, FIT_LAYERS deep, dropout 0.1, the
    vocab padded to 128, Adam: an uninterrupted epoch of 6 updates; the
    same fit with durable snapshots every 2 updates, sent SIGTERM after
    update 3 (it drains, commits a final snapshot and raises Preempted); a
    freshly compiled model restored from it with resume="auto". The
    restored params and moments must equal the snapshot bitwise, and the
    resumed losses the uninterrupted run's. Then one explicit async save
    and restore of the same state, timed."""
    import shutil
    import tempfile

    from flexflow_tpu_torch.runtime import resilience as rz

    ids, pos, labels = train_batch(seed + 5, GPT2_VOCAB, n=6 * BATCH)
    x = [ids, pos]
    root = tempfile.mkdtemp(prefix="ff_ckpt_")
    out = {"layers": FIT_LAYERS, "cut": f"depth {LAYERS} -> {FIT_LAYERS}: "
           "three models are built and each snapshot is written to disk",
           "updates": 6}
    try:
        _, _, ref = fit_model(seed)
        ref_log = StepLog()
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        ref.fit(x, labels, epochs=1, verbose=False, callbacks=[ref_log])
        torch.cuda.synchronize()
        out["uninterrupted"] = {"losses": ref_log.losses,
                                "wall_s": time.perf_counter() - t0,
                                "launches": launch_counts()}
        want_launches = {n: 0 for n in out["uninterrupted"]["launches"]}
        want_launches.update(fused_ce_fwd=6, fused_ce_bwd=6, fused_adam=6)
        if out["uninterrupted"]["launches"] != want_launches or \
                not all(np.isfinite(ref_log.losses)):
            fail(f"6d uninterrupted fit: {out['uninterrupted']}, launches "
                 f"expected {want_launches}")
        ref_state = _tree_to_host({"p": ref.params, "o": ref.opt_state})
        del ref
        collect_garbage()
        torch.cuda.empty_cache()

        _, _, cm = fit_model(seed, checkpoint_dir=root,
                             checkpoint_every_steps=2, keep_checkpoints=2)
        kill = StepLog(kill_at=3)
        zero_launch_counts()
        try:
            cm.fit(x, labels, epochs=1, verbose=False, callbacks=[kill])
            fail("6d: the fit was sent SIGTERM and did not raise Preempted")
        except rz.Preempted as e:
            snap, code = e.checkpoint_path, e.code
        torch.cuda.synchronize()
        man = rz.load_manifest(snap)
        saved = _tree_to_host({"p": cm.params, "o": cm.opt_state})
        out["preempted"] = {"losses": kill.losses, "exit_code": code,
                            "snapshot": os.path.basename(snap),
                            "progress": {k: man["progress"][k] for k in
                                         ("epoch", "step_in_epoch")},
                            "committed": [os.path.basename(p) for _, p, _
                                          in rz.committed_snapshots(root)],
                            "launches": launch_counts()}
        log(f"[6d fit] SIGTERM after update 3: Preempted (code {code}), "
            f"snapshot {out['preempted']['snapshot']} at {out['preempted']['progress']}, "
            f"committed {out['preempted']['committed']}")
        # the signal lands in update 3's callback; update 4 drains
        if code != 0 or man is None or man["step"] != 4 or \
                kill.losses != ref_log.losses[:3] or \
                snap != rz.latest_checkpoint(root):
            fail(f"6d preemption: {out['preempted']}, manifest {man}")
        del cm
        collect_garbage()
        torch.cuda.empty_cache()

        _, _, cm2 = fit_model(seed, checkpoint_dir=root, keep_checkpoints=2)
        t0 = time.perf_counter()
        rz.restore_auto(cm2, "auto", root)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        restored = _tree_to_host({"p": cm2.params, "o": cm2.opt_state})
        out["restored_bitwise"] = _trees_bitwise(restored, saved)
        del restored
        res_log = StepLog()
        zero_launch_counts()
        hist = cm2.fit(x, labels, epochs=1, verbose=False, resume="auto",
                       callbacks=[res_log])
        cm2.wait_checkpoints()
        torch.cuda.synchronize()
        want = ref_log.losses[man["step"]:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(res_log.losses, want))
        out["resumed"] = {"losses": res_log.losses, "want": want,
                          "losses_equal": res_log.losses == want,
                          "loss_rel_max": rel, "tolerance": RUN_LOSS_RTOL,
                          "history_loss": hist[0]["loss"],
                          "launches": launch_counts()}
        final = _tree_to_host({"p": cm2.params, "o": cm2.opt_state})
        out["final_state_bitwise"] = _trees_bitwise(final, ref_state)
        del final, ref_state, saved
        log(f"[6d fit] restored params and moments bitwise equal to the "
            f"snapshot: {out['restored_bitwise']} ({out['restore_s']:.2f} s "
            f"restore); resumed losses {res_log.losses} vs uninterrupted "
            f"{want}: equal {out['resumed']['losses_equal']}, worst relative "
            f"{rel:.2e} (tolerance {RUN_LOSS_RTOL}); final state bitwise "
            f"equal to the uninterrupted run's: {out['final_state_bitwise']}")
        if not out["restored_bitwise"] or len(res_log.losses) != len(want) \
                or rel > RUN_LOSS_RTOL:
            fail(f"6d resume: {out}")
        for name in ("fused_ce_fwd", "fused_ce_bwd", "fused_adam"):
            if out["resumed"]["launches"][name] != len(want):
                fail(f"6d resumed fit launches: {out['resumed']['launches']}")

        # one explicit save of the state: the caller thread's snapshot,
        # the background write, the bytes, the restore
        path = os.path.join(root, "explicit")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cm2.save_checkpoint(path, block=False)
        snap_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        cm2.wait_checkpoints()
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(path) for f in fs)
        t0 = time.perf_counter()
        cm2.load_checkpoint(path)
        torch.cuda.synchronize()
        out["checkpoint"] = {"snapshot_ms_caller": snap_ms,
                             "write_s_after_return": write_s,
                             "bytes": nbytes,
                             "restore_s": time.perf_counter() - t0}
        log(f"[6d checkpoint] {nbytes / 2**30:.2f} GiB: snapshot on the "
            f"caller thread {snap_ms:.0f} ms, write after it returned "
            f"{write_s:.2f} s, restore {out['checkpoint']['restore_s']:.2f} s")
        del cm2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def profile_train(cm, inputs, label, tag: str, rng=None,
                  reps: int = 2) -> dict:
    """torch.profiler over `reps` train steps of `cm` on one batch (their
    dropout drawn from `rng`)."""
    def step():
        (cm.params, cm.opt_state, cm.state, _, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, inputs, label, rng)
    prof = _device_profile(step, reps, cm.device)
    if "wall_ms_per_call" in prof:
        log(f"[{tag}] step: {prof['wall_ms_per_call']:.2f} ms wall, device "
            f"busy {prof['device_busy_ms_per_call']:.2f} ms, idle share "
            f"{prof['device_idle_share']:.3f}, "
            f"{prof['kernel_launches_per_call']:.0f} kernel launches, first "
            f"launch to first kernel {prof['launch_to_first_kernel_us']} us")
        for k in prof["top_kernels"]:
            log(f"[{tag}]   {k['ms_per_call']:8.3f} ms "
                f"{k['launches_per_call']:5.0f}x  {k['name']}")
        log(f"[{tag}] the port's kernels: " + ", ".join(
            f"{n} {k['ms_per_call']:.3f} ms in {k['launches_per_call']:.0f}"
            for n, k in prof["port_kernels"].items()))
    return prof


# ------------------------------------------------------- phase 7: search
# the search's budget (expansions) in 7c; GPT-2 medium's 24 blocks are
# one segment shape, searched once and replayed
SEARCH_BUDGET = 16
# 7b: GPT-2 medium's four projection GEMMs at b8 x s1024 (M, K, N), and
# the per-shard widths 4096 / dm of mlp_up that set mxu_min_dim
PROJECTIONS = {"attn_qkv": (BATCH * SEQ, 1024, 1024),
               "attn_out": (BATCH * SEQ, 1024, 1024),
               "mlp_up": (BATCH * SEQ, 1024, 4096),
               "mlp_down": (BATCH * SEQ, 4096, 1024)}
SHARD_DEGREES = (1, 2, 4, 8, 16, 32, 64)
MIN_DIM_SHARE = 0.9


def gemm_sweep(timer, gen) -> dict:
    """7b: the bf16 GEMMs that set the H100 preset's mxu_flop_overhead
    (the dense peak over the median TFLOP/s of the four projections) and
    mxu_min_dim (the narrowest mlp_up shard width keeping 90% of the
    widest's TFLOP/s), timed by `Timer` (L2 flushed before each call)."""
    def tflops(m, k, n):
        a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn(k, n, generator=gen, device="cuda").to(torch.bfloat16)
        ms = timer(lambda: a @ b)
        return ms, 2.0 * m * k * n / (ms * 1e-3) / 1e12

    proj = {}
    for name, (m, k, n) in PROJECTIONS.items():
        ms, tf = tflops(m, k, n)
        proj[name] = {"mkn": [m, k, n], "ms": ms, "tflops": tf}
    median_tf = float(np.median([p["tflops"] for p in proj.values()]))
    m, k, n = PROJECTIONS["mlp_up"]
    widths = {}
    for dm in SHARD_DEGREES:
        ms, tf = tflops(m, k, n // dm)
        widths[n // dm] = {"degree": dm, "ms": ms, "tflops": tf}
    widest = widths[n]["tflops"]
    min_dim = min(w for w, r in widths.items()
                  if r["tflops"] >= MIN_DIM_SHARE * widest)
    out = {"projections": proj, "median_tflops": median_tf,
           "mxu_flop_overhead": BF16_FLOPS / (median_tf * 1e12),
           "mlp_up_widths": widths, "mxu_min_dim": min_dim}
    for name, p in proj.items():
        log(f"[7b gemm] {name} {p['mkn']}: {p['ms']:.4f} ms, "
            f"{p['tflops']:.1f} TFLOP/s")
    for w, r in sorted(widths.items(), reverse=True):
        log(f"[7b gemm] mlp_up width {w} (4096/{r['degree']}): "
            f"{r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s "
            f"({100 * r['tflops'] / widest:.1f}% of the widest)")
    log(f"[7b gemm] derived mxu_flop_overhead {out['mxu_flop_overhead']:.3f}"
        f" (989 / {median_tf:.1f}), mxu_min_dim {min_dim}")
    return out


def host_copy_rate(nbytes: int = 1 << 28, reps: int = 5) -> float:
    """7a: bytes/s of a pinned host-to-device copy of `nbytes`: the median
    of `reps` copies timed with CUDA events, after one warm-up copy."""
    src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        dst.copy_(src, non_blocking=True)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / 1e3)
    del src, dst
    return nbytes / float(np.median(times))


def search_model(seed: int, **cfg):
    """GPT-2 medium as phase 5b trains it (b8, seq 1024, dropout 0, bf16),
    built with `cfg` for FFConfig."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2

    gc = GPT2Config.medium()
    gc.dropout = 0.0
    model = FFModel(FFConfig(batch_size=BATCH, compute_dtype="bfloat16",
                             seed=seed, **cfg))
    build_gpt2(model, gc, batch=BATCH)
    return model


def measured_ops(seed: int, machine) -> tuple:
    """7b: MeasuredCost over the distinct ops of GPT-2 medium b8 s1024 at
    the single-device layout and at every candidate of the 8-way `model`
    axis (search_num_workers=8), fwd and bwd against the analytic op
    time. The flash counters must rise while attention is measured.
    Returns (rows, the single-device MeasuredCost)."""
    from flexflow_tpu_torch.compiler.compile import _search_machine
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.op_type import OperatorType
    from flexflow_tpu_torch.search import memo
    from flexflow_tpu_torch.search.candidates import layer_candidates
    from flexflow_tpu_torch.search.measure import MeasuredCost

    model = search_model(seed, search_num_workers=8)
    sm8 = _search_machine(model.config, machine)
    distinct = {}
    for layer in model.layers:
        key = (layer.params_key(), memo.freeze_weight_specs(layer.weight_specs))
        distinct.setdefault(key, layer)
    mc1 = MeasuredCost(machine, cache_dir="", device="cuda")
    mc8 = MeasuredCost(sm8, cache_dir="", device="cuda")
    rows = []
    for layer in distinct.values():
        attn = layer.op_type is OperatorType.MULTIHEAD_ATTENTION
        for mach, mc in ((machine, mc1), (sm8, mc8)):
            for cand in layer_candidates(layer, mach, {BATCH}):
                if cand.passthrough or (mach is sm8 and cand.name == "dp"):
                    continue
                c0 = (fa.launches, fa.launches_dq, fa.launches_dkv)
                fwd, bwd = mc.op_times(layer, cand)
                rose = [b - a for a, b in zip(
                    c0, (fa.launches, fa.launches_dq, fa.launches_dkv))]
                analytic = cand.op_time(layer, mach)
                measured = mc.op_time(layer, cand)
                row = {"op": layer.name, "candidate": cand.name,
                       "machine": dict(mach.mesh_axes), "fwd_ms": 1e3 * fwd,
                       "bwd_ms": 1e3 * bwd, "measured_ms": 1e3 * measured,
                       "analytic_ms": 1e3 * analytic,
                       "measured_over_analytic": measured / analytic}
                if attn:
                    row["flash_launches"] = rose
                    if min(rose) <= 0:
                        fail(f"7b: measuring {layer.name} {cand.name} "
                             f"launched flash fwd/dq/dkv {rose} times")
                rows.append(row)
                log(f"[7b op] {layer.name} {cand.name} on "
                    f"{row['machine']}: fwd {row['fwd_ms']:.4f} ms, bwd "
                    f"{row['bwd_ms']:.4f} ms, measured {row['measured_ms']:.4f}"
                    f" ms, analytic {row['analytic_ms']:.4f} ms, ratio "
                    f"{row['measured_over_analytic']:.3f}"
                    + (f", flash launches {rose}" if attn else ""))
    return rows, mc1


def searched_compile(seed: int, nodes: int, measured: bool, cache_dir: str,
                     export: str, tag: str) -> dict:
    """7c: one compile through FFModel.compile that searches a machine of
    `nodes` x 8 H100s (search_num_workers=8), costs analytic or measured
    on this card, exporting the strategy; the launch counters are set to
    0 just before and read just after. Beside the search's best cost:
    the data-parallel baseline's and the Megatron template's
    (parallel/templates.py) on the same cost model, and the chosen
    candidates tallied by kind."""
    from collections import Counter

    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.compiler.compile import _search_machine
    from flexflow_tpu_torch.parallel.default_strategy import \
        data_parallel_strategy
    from flexflow_tpu_torch.parallel.templates import megatron_strategy
    from flexflow_tpu_torch.search.candidates import compiled_candidate
    from flexflow_tpu_torch.search.dp import SEARCH_STATS
    from flexflow_tpu_torch.search.measure import MeasuredCost
    from flexflow_tpu_torch.search.optimize import strategy_cost

    model = search_model(seed, search_budget=SEARCH_BUDGET,
                         search_num_workers=8, search_num_nodes=nodes,
                         profiling=measured, strategy_cache_dir=cache_dir,
                         export_strategy_file=export)
    opt = AdamOptimizer(alpha=LR)
    torch.cuda.synchronize()
    zero_launch_counts()
    e0 = SEARCH_STATS["expansions"]
    t0 = time.perf_counter()
    cm = model.compile(opt, "sparse_categorical_crossentropy", [])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expansions = SEARCH_STATS["expansions"] - e0
    st = cm.strategy
    sm = _search_machine(model.config, cm.machine)
    cost_fn = (MeasuredCost(sm, cache_dir=cache_dir, device="cuda",
                            compute_dtype="bfloat16").op_time
               if measured else None)
    dp = strategy_cost(model, sm, data_parallel_strategy(model, sm),
                       cost_fn=cost_fn, optimizer=opt)
    meg = strategy_cost(model, sm, megatron_strategy(model, sm),
                        cost_fn=cost_fn, optimizer=opt)
    # the candidates the strategy takes on the search machine
    tally = Counter(compiled_candidate(l, st, sm, {BATCH}).name.split(":")[0]
                    for l in model.layers)
    info = cm.search_cache_info or {}
    out = {"machine": dict(sm.mesh_axes), "dcn_axes": list(sm.dcn_axes),
           "measured": measured, "compile_s": wall,
           "search_s": getattr(st, "_search_seconds", None),
           "expansions": expansions, "cache_event": info.get("event"),
           "best_cost_ms": 1e3 * st._predicted_cost,
           "data_parallel_cost_ms": 1e3 * dp.cost,
           "megatron_cost_ms": 1e3 * meg.cost,
           "unity_baseline_cost_ms": (1e3 * st._search_stats.baseline_cost
                                      if st._search_stats else None),
           "chosen": dict(sorted(tally.items())), "strategy": st.name,
           "launches": counts}
    log(f"[{tag}] {out['machine']} {'measured' if measured else 'analytic'}"
        f": compile {wall:.2f} s (search {out['search_s']}), "
        f"{expansions} DP expansions, cache {out['cache_event']}, best "
        f"{out['best_cost_ms']:.4f} ms, data parallel "
        f"{out['data_parallel_cost_ms']:.4f} ms, Megatron "
        f"{out['megatron_cost_ms']:.4f} ms, chosen {out['chosen']}, "
        f"launches {counts}")
    if not st._predicted_cost <= dp.cost:
        fail(f"{tag}: best {st._predicted_cost} > data parallel {dp.cost}")
    if measured and min(counts[n] for n in (
            "flash_attention_fwd", "flash_attention_dq",
            "flash_attention_dkv")) <= 0:
        fail(f"{tag}: the measured search launched no flash kernel: {counts}")
    del cm
    return out


def two_steps(seed: int, **cfg) -> tuple:
    """7d: GPT-2 medium as 5b compiles it with `cfg`, 2 steps from seed 0
    (the launch counters set to 0 just before, read just after)."""
    from flexflow_tpu_torch import random as ff_random

    gc, model, cm = gpt2_train_model(seed, LAYERS, "bfloat16", **cfg)
    ids, pos, labels = train_batch(seed, gc.vocab)
    inputs = [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]
    label = torch.from_numpy(labels).cuda()
    base = ff_random.key(seed + 17)
    torch.cuda.synchronize()
    zero_launch_counts()
    losses = []
    for i in range(2):
        (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, inputs, label,
            ff_random.fold_in(base, i))
        losses.append(loss)
    torch.cuda.synchronize()
    counts = launch_counts()
    return [float(x) for x in losses], counts, cm


def phase7(seed: int, timer, gen) -> dict:
    """Phase 7: the strategy search on the H100 machine model (see the
    module docstring)."""
    import tempfile

    from flexflow_tpu_torch.compiler.compile import resolve_machine
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.parallel.machine import CHIP_PRESETS, MachineSpec
    from flexflow_tpu_torch.parallel.sharding import Strategy

    out = {}
    # ---- 7a: the machine
    m = MachineSpec.detect()
    host_bw = host_copy_rate()
    out["machine"] = m.to_json()
    out["host_bw_measured"] = host_bw
    log(f"[7a] detect(): chip {m.chip}, mesh {m.mesh_axes}, flops "
        f"{m.flops:.4g}, hbm_bw {m.hbm_bw:.4g}, hbm_bytes {m.hbm_bytes:.6g}, "
        f"host_bw {m.host_bw:.6g} (preset), pinned H2D measured "
        f"{host_bw:.6g}, link {m.ici_bw}, overlap_frac {m.overlap_frac} "
        "(not measured)")
    if m.chip != "h100":
        fail(f"7a: detect() gave chip {m.chip!r}, expected 'h100'")
    machine = resolve_machine(FFConfig())
    # ---- 7b: GEMMs and measured op costs
    out["gemm"] = gemm_sweep(timer, gen)
    preset = CHIP_PRESETS["h100"]
    log(f"[7b] preset mxu_flop_overhead {preset.mxu_flop_overhead}, "
        f"mxu_min_dim {preset.mxu_min_dim}")
    out["ops"], mc1 = measured_ops(seed, machine)
    torch.cuda.empty_cache()
    # ---- 7c: searches, analytic and measured, 1 and 2 nodes; the cache
    with tempfile.TemporaryDirectory(prefix="ff_search_") as tmp:
        one_node = os.path.join(tmp, "one_node.json")
        out["searches"] = []
        for nodes in (1, 2):
            for measured in (False, True):
                path = one_node if (nodes, measured) == (1, False) else \
                    os.path.join(tmp, f"n{nodes}_{int(measured)}.json")
                out["searches"].append(searched_compile(
                    seed, nodes, measured, tmp, path,
                    f"7c {nodes} node(s)"))
        again = searched_compile(seed, 1, False, tmp,
                                 os.path.join(tmp, "again.json"),
                                 "7c cache")
        out["cache_hit"] = again
        if again["cache_event"] != "hit" or again["expansions"] != 0:
            fail(f"7c: the second compile was a cache "
                 f"{again['cache_event']} with {again['expansions']} "
                 "expansions, expected a hit with 0")
        if Strategy.load(os.path.join(tmp, "again.json")).to_json() != \
                Strategy.load(one_node).to_json():
            fail("7c: the cache hit's strategy differs from the search's")
        # ---- 7d: export -> import on the card
        collect_garbage()
        torch.cuda.empty_cache()
        with_file, counts, cm = two_steps(seed,
                                          import_strategy_file=one_node)
        out["import"] = {"strategy": cm.strategy.name, "losses": with_file,
                         "launches": counts,
                         "remat": cm.strategy.remat or {}}
    del cm
    want = {n: 0 for n in counts}
    want.update(flash_attention_fwd=2 * LAYERS, flash_attention_dq=2 * LAYERS,
                flash_attention_dkv=2 * LAYERS, fused_adam=2)
    log(f"[7d] imported {out['import']['strategy']}: losses {with_file}, "
        f"launches {counts}")
    if counts != want or not all(np.isfinite(with_file)):
        fail(f"7d: launches {counts} (expected {want}), losses {with_file}")
    # ---- 7e: the same model without the file: 5b's 12 steps, then the
    # prediction beside the measurement
    flash = {"flash_attention_fwd": LAYERS, "flash_attention_dq": LAYERS,
             "flash_attention_dkv": LAYERS}
    summary, cm, inputs, label = train_full(
        seed, None, 0, dict(flash, fused_adam=1), "7e no file")
    if summary["losses"][:2] != with_file:
        fail(f"7d: losses with the imported strategy {with_file} differ "
             f"from those without {summary['losses'][:2]}")
    mem = cm.memory_stats()
    pred = {"analytic_ms": 1e3 * cm.predicted_step_time(),
            "measured_ms": 1e3 * cm.predicted_step_time(cost_fn=mc1.op_time)}
    step = summary["step_ms_median"]
    out["prediction"] = {
        "step_ms": step, "step_ms_windows": summary["step_ms_windows"],
        "predicted_ms": pred,
        "analytic_over_step": pred["analytic_ms"] / step,
        "measured_over_step": pred["measured_ms"] / step,
        "memory": mem,
        "predicted_peak_over_allocated":
            mem["predicted_peak_bytes"] / mem["max_memory_allocated_bytes"],
        "predicted_weight_state_over_allocated":
            mem["predicted_weight_state_bytes"]
            / mem["max_memory_allocated_bytes"],
        "launches": summary["launches"], "losses": summary["losses"]}
    log(f"[7e] step {step:.2f} ms (windows "
        f"{', '.join(f'{w:.2f}' for w in summary['step_ms_windows'])}); "
        f"predicted_step_time analytic {pred['analytic_ms']:.2f} ms "
        f"(x{out['prediction']['analytic_over_step']:.3f}), measured costs "
        f"{pred['measured_ms']:.2f} ms "
        f"(x{out['prediction']['measured_over_step']:.3f})")
    log(f"[7e] memory_stats: predicted weight state "
        f"{mem['predicted_weight_state_bytes'] / 2**30:.2f} GiB, predicted "
        f"peak {mem['predicted_peak_bytes'] / 2**30:.2f} GiB, "
        f"max_memory_allocated {mem['max_memory_allocated_bytes'] / 2**30:.2f}"
        f" GiB (x{out['prediction']['predicted_peak_over_allocated']:.3f}); "
        f"params {mem['actual_param_bytes_per_device'] / 2**30:.2f} GiB, "
        f"moments {mem['actual_opt_state_bytes_per_device'] / 2**30:.2f} GiB")
    del cm, inputs, label
    collect_garbage()
    torch.cuda.empty_cache()
    return out


# ------------------------------------ phase 9: the bench's other workloads
# bench.py's sizes (`_bench_resnext`, `_bench_bert`, `_bench_dlrm`) and
# build_resnet50's defaults (BASELINE.md config #2), bf16 compute over f32
# master weights; ResNet-50 under SGD at Goyal et al.'s 0.1 x batch / 256
IMAGE_BATCH, IMAGE_HW, CLASSES = 64, 224, 1000
BERT_BATCH, BERT_SEQ, BERT_VOCAB, BERT_LAYERS = 8, 512, 30522, 12
DLRM_BATCH, DLRM_TABLES = 4096, (100_000,) * 8
RESNET_SGD = dict(lr=0.1 * IMAGE_BATCH / 256, momentum=0.9,
                  weight_decay=1e-4)
P9_FIT_BATCHES = 4


def resnet50_blocks(model, blocks: int):
    """ResNet-50's stem, its first `blocks` bottleneck blocks (stage 0,
    width 64) and its head: the gradient check's cut of build_resnet50."""
    from flexflow_tpu_torch.models import build_resnet_block

    x = model.create_tensor([IMAGE_BATCH, 3, IMAGE_HW, IMAGE_HW],
                            name="image")
    t = model.conv2d(x, 64, 7, 7, 2, 2, 3, 3, name="stem", use_bias=False)
    t = model.batch_norm(t, relu=True, name="stem_bn")
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1, name="stem_pool")
    for bi in range(blocks):
        t = build_resnet_block(model, t, 64, 1, f"s0b{bi}", project=bi == 0)
    t = model.mean(t, axes=[2, 3], name="gap")
    model.dense(t, CLASSES, name="fc")


def p9_batch(which: str, seed: int, n: int = 0):
    """Inputs and labels as bench.py draws them (numpy, on the host); `n`
    samples (default: one batch)."""
    rng = np.random.default_rng(seed)
    if which in ("resnet50", "resnext50"):
        n = n or IMAGE_BATCH
        x = rng.normal(size=(n, 3, IMAGE_HW, IMAGE_HW),
                       scale=0.5).astype(np.float32)
        return [x], rng.integers(0, CLASSES, size=(n,)).astype(np.int32)
    if which == "bert":
        ids = rng.integers(0, BERT_VOCAB, size=(BERT_BATCH, BERT_SEQ))
        pos = np.tile(np.arange(BERT_SEQ), (BERT_BATCH, 1))
        labels = rng.integers(0, BERT_VOCAB, size=(BERT_BATCH, BERT_SEQ))
        return ([ids.astype(np.int32), pos.astype(np.int32)],
                labels.astype(np.int32))
    dense = rng.normal(size=(DLRM_BATCH, 13)).astype(np.float32)
    sparse = [rng.integers(0, t, size=(DLRM_BATCH, 1)).astype(np.int32)
              for t in DLRM_TABLES]
    return ([dense] + sparse,
            rng.uniform(size=(DLRM_BATCH, 1)).astype(np.float32))


def p9_batches(which: str, seed: int, batches: int):
    """`batches` batches of `p9_batch` (seeds seed, seed + 1, ...), one
    after the other in one array per input."""
    parts = [p9_batch(which, seed + i) for i in range(batches)]
    xs = [np.concatenate([p[0][j] for p in parts])
          for j in range(len(parts[0][0]))]
    return xs, np.concatenate([p[1] for p in parts])


def p9_model(which: str, compute_dtype: str, seed: int, depth: int = 0,
             dropout: float = 0.0, metrics=()):
    """(compiled model, forward flops by the registry's count, batch) of
    `which` at full width, built by the port's builders; `depth` cuts
    ResNet-50 to that many blocks and BERT to that many layers."""
    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                    SGDOptimizer)
    from flexflow_tpu_torch import models
    from flexflow_tpu_torch.ops import get_op_def

    batch = {"bert": BERT_BATCH, "dlrm": DLRM_BATCH}.get(which, IMAGE_BATCH)
    model = FFModel(FFConfig(batch_size=batch, compute_dtype=compute_dtype,
                             seed=seed))
    opt, loss = AdamOptimizer(alpha=LR), "sparse_categorical_crossentropy"
    if which == "resnet50":
        if depth:
            resnet50_blocks(model, depth)
        else:
            models.build_resnet50(model, batch=batch, in_hw=IMAGE_HW,
                                  classes=CLASSES)
        opt = SGDOptimizer(**RESNET_SGD)
    elif which == "resnext50":
        # bench.py's build: groups 32, width 128, has_residual=False
        models.build_resnext50(model, batch=batch, in_hw=IMAGE_HW,
                               classes=CLASSES)
    elif which == "bert":
        models.build_bert(model, batch=batch, seq=BERT_SEQ, vocab=BERT_VOCAB,
                          layers=depth or BERT_LAYERS, dropout=dropout)
    else:
        models.build_dlrm(model, batch=batch, embedding_tables=DLRM_TABLES,
                          embedding_dim=64)
        loss = "mean_squared_error"
    cm = model.compile(opt, loss, list(metrics))
    cm.init(seed=seed)
    flops = sum(get_op_def(l.op_type).flop_count(l) for l in model.layers)
    return cm, flops, batch


def on_card(xs, y):
    return [torch.from_numpy(a).cuda() for a in xs], torch.from_numpy(y).cuda()


def p9_leg(tag: str, which: str, exact: dict, seed: int,
           dropout: float = 0.0, metrics=()) -> tuple:
    """One leg of phase 9: `train_leg` over 2 warm-up and 10 timed steps
    (5 windows of 2) of `which` at full width. Returns (summary, compiled
    model, device inputs, label)."""
    collect_garbage()
    torch.cuda.empty_cache()
    cm, flops, batch = p9_model(which, "bfloat16", seed, dropout=dropout,
                                metrics=metrics)
    inputs, label = on_card(*p9_batch(which, seed))
    summary = train_leg(tag, which, cm, flops, batch, inputs, label, exact,
                        seed, TRAIN_STEPS // 2, 2)
    summary["dropout"] = dropout
    return summary, cm, inputs, label


def train_leg(tag: str, which: str, cm, flops: float, batch: int, inputs,
              label, exact: dict, seed: int, windows_n: int,
              per_window: int, table_builds=(1, 0)) -> dict:
    """2 warm-up steps, then `windows_n` windows of `per_window` steps on
    one batch, each window ended by a device sync; the launch counters
    zeroed before the first step and read after the last (`exact` gives
    each kernel's launches per step; a kernel it does not name must not
    launch), the optimizer's table built in the first step only (or as
    `table_builds` gives for the warm-up and the timed steps: (0, 0) on a
    model that has trained before), every loss finite; then
    torch.profiler over one step. Step i draws its
    dropout from fold_in(key(seed + 17), i). MFU is 3 x the registry's
    forward flops a step over the card's bf16 peak."""
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.kernels import fused_optim as fo

    losses = []
    base = ff_random.key(seed + 17)

    def step():
        (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, inputs, label,
            ff_random.fold_in(base, len(losses)))
        losses.append(loss)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    builds0 = fo.table_builds
    t0 = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        step()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    builds = [fo.table_builds - builds0]
    windows = []
    for _ in range(windows_n):
        t0 = time.perf_counter()
        for _ in range(per_window):
            step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / per_window)
    counts = launch_counts()
    builds.append(fo.table_builds - builds0 - builds[0])
    steps = WARMUP_STEPS + windows_n * per_window
    loss_vals = [float(x) for x in losses]
    step_s = float(np.median(windows))
    summary = {
        "model": which, "batch": batch,
        "compute_dtype": cm.cfg.compute_dtype,
        "optimizer": type(cm.optimizer).__name__,
        "optimizer_args": {k: v for k, v in vars(cm.optimizer).items()
                           if isinstance(v, (int, float, str))},
        "loss": cm.loss_type.value, "layers": len(cm.model.layers),
        "params": sum(t.numel() for ws in cm.params.values()
                      for t in ws.values()),
        "forward_gflop": flops / 1e9, "steps": steps,
        "warmup_s": warmup_s, "step_ms_median": 1e3 * step_s,
        "step_ms_windows": [1e3 * w for w in windows],
        "samples_per_s": batch / step_s,
        "mfu_port_count": 3 * flops / step_s / BF16_FLOPS,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": loss_vals, "loss_fell": loss_vals[-1] < loss_vals[0],
        "launches": counts, "table_builds_warmup_timed": builds,
        "cudnn_benchmark": torch.backends.cudnn.benchmark}
    log(f"[{tag}] {which} b{batch}: step {summary['step_ms_median']:.2f} ms "
        f"(windows {', '.join(f'{w:.2f}' for w in summary['step_ms_windows'])}"
        f"; warm-up {warmup_s:.1f} s), {summary['samples_per_s']:.1f} "
        f"samples/s, MFU by the port's count (3 x the registry's forward "
        f"{flops / 1e9:.1f} GFLOP a step) {100 * summary['mfu_port_count']:.2f}"
        f"%, peak {summary['max_memory_allocated_gib']:.2f} GiB, "
        f"{summary['params']} params")
    log(f"[{tag}] losses {' '.join(f'{x:.4f}' for x in loss_vals)}")
    log(f"[{tag}] launches over {steps} steps: {counts}; optimizer table "
        f"builds in the warm-up and timed steps: {builds}")
    if not all(np.isfinite(loss_vals)):
        fail(f"{tag}: non-finite training loss: {loss_vals}")
    want = {name: exact.get(name, 0) * steps for name in counts}
    if counts != want:
        fail(f"{tag}: launches over {steps} steps {counts}, expected {want}")
    if builds != list(table_builds):
        fail(f"{tag}: the optimizer's pointer table was built {builds} "
             f"times in the warm-up and timed steps, expected "
             f"{list(table_builds)}")
    summary["profile"] = profile_train(cm, inputs, label, tag,
                                       rng=ff_random.key(seed), reps=1)
    return summary


def p9_fit_evaluate(cm, seed: int) -> dict:
    """(9a) one fit epoch of P9_FIT_BATCHES batches with the accuracy
    metric through the prefetching loader, the launch counters zeroed
    just before it; then `evaluate` over the same samples, which must
    read the running stats: they moved away from 0 and 1 and are finite,
    and evaluating without them gives another loss."""
    from flexflow_tpu_torch.kernels import fused_optim as fo

    xs, y = p9_batch("resnet50", seed + 2, n=P9_FIT_BATCHES * IMAGE_BATCH)
    torch.cuda.synchronize()
    zero_launch_counts()
    builds0 = fo.table_builds
    t0 = time.perf_counter()
    hist = cm.fit(xs, y, epochs=1, verbose=False, sync_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = {name: 0 for name in counts}
    want["fused_sgd"] = P9_FIT_BATCHES
    stats = dict(cm.state)
    means = [v for k, v in stats.items() if k.endswith("/mean")]
    vars_ = [v for k, v in stats.items() if k.endswith("/var")]
    moved = {
        "bn_layers": len(means),
        "finite": bool(all(torch.isfinite(v).all() for v in stats.values())),
        "mean_abs_max_min": min(float(v.abs().max()) for v in means),
        "var_minus_1_abs_max_min": min(float((v - 1).abs().max())
                                       for v in vars_)}
    t0 = time.perf_counter()
    ev = cm.evaluate(xs, y)
    eval_s = time.perf_counter() - t0
    cm.state = {}
    ev_without = cm.evaluate(xs, y)
    cm.state = stats
    out = {"history": hist, "step_stats": dict(cm.step_stats), "wall_s": wall,
           "launches": counts, "table_builds": fo.table_builds - builds0,
           "running_stats": moved, "evaluate": ev, "evaluate_s": eval_s,
           "evaluate_without_stats": ev_without}
    log(f"[9a fit] loss {hist[0]['loss']:.4f}, accuracy "
        f"{hist[0]['accuracy']:.4f}, {hist[0]['samples_per_sec']:.1f} "
        f"samples/s, step_stats {cm.step_stats}, launches {counts}, table "
        f"builds {out['table_builds']}")
    log(f"[9a evaluate] loss {ev['loss']:.4f}, accuracy {ev['accuracy']:.4f} "
        f"in {eval_s:.2f} s; without the running stats loss "
        f"{ev_without['loss']:.4f}; stats {moved}")
    if not np.isfinite(hist[0]["loss"]):
        fail(f"9a fit: non-finite loss {out}")
    if cm.step_stats != {"dispatches": P9_FIT_BATCHES, "host_syncs": 0,
                         "barriers": 0, "fused_steps": 0} \
            or out["table_builds"] != 0 or counts != want:
        fail(f"9a fit: {out}")
    if not (moved["finite"] and moved["bn_layers"] == 53
            and moved["mean_abs_max_min"] > 0
            and moved["var_minus_1_abs_max_min"] > 0):
        fail(f"9a: the running stats did not move or are not finite: {moved}")
    if ev_without["loss"] == ev["loss"]:
        fail("9a evaluate: the loss does not depend on the running stats")
    return out


def model_grad_check(which: str, seed: int, depth: int) -> dict:
    """(9f, 9g) `grad_check` of ResNet-50's widths at `depth` blocks (SGD
    with momentum and weight decay: #9 over a conv/BN param set; 5e's
    tolerances) or BERT-base's at `depth` layers, dropout 0 (#1-#3
    non-causal inside a model, and #7; `GRAD_TOL_RELU`), in f32 and bf16.
    The kernels of the model must have launched in the run through them."""
    xs, y = p9_batch(which, seed + 1)
    inputs, label = on_card(xs, y)
    zero_launch_counts()
    out = grad_check(lambda dt: p9_model(which, dt, seed, depth=depth)[0],
                     inputs, label,
                     GRAD_TOL_SGD if which == "resnet50" else GRAD_TOL_RELU,
                     f"9 grad check {which}", f"{depth} "
                     f"{'blocks' if which == 'resnet50' else 'layers'}",
                     skip=("bk",))
    counts = launch_counts()
    names = (("fused_sgd",) if which == "resnet50" else
             ("flash_attention_fwd", "flash_attention_dq",
              "flash_attention_dkv", "fused_adam"))
    if min(counts[n] for n in names) <= 0:
        fail(f"9 grad check {which}: kernels not launched: {counts}")
    out["launches"] = counts
    return out


def phase9(seed: int) -> dict:
    """The JAX bench's other training workloads on the card, each at full
    width through FFModel.compile -> train_step (and fit for ResNet-50),
    with cuDNN's autotuner on (`cudnn.benchmark`: the warm-up steps take
    its search); the gradient checks of two cut models first."""
    t0 = time.perf_counter()
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    out = {"grad_check": {"resnet50": model_grad_check("resnet50", seed, 2),
                          "bert": model_grad_check("bert", seed, 2)},
           "graph": {}}
    flash = {"flash_attention_fwd": BERT_LAYERS,
             "flash_attention_dq": BERT_LAYERS,
             "flash_attention_dkv": BERT_LAYERS}
    legs = [("9a", "resnet50", {"fused_sgd": 1}, 0.0, ("accuracy",)),
            ("9b", "resnext50", {"fused_adam": 1}, 0.0, ()),
            ("9c", "bert", {"fused_adam": 1}, 0.1, ()),
            ("9d", "bert", dict(flash, fused_adam=1), 0.0, ()),
            ("9e", "dlrm", {"fused_adam": 1}, 0.0, ())]
    for tag, which, exact, dropout, metrics in legs:
        out[tag], cm, inputs, label = p9_leg(tag, which, exact, seed,
                                             dropout, metrics)
        if tag == "9a":
            out["9a_fit"] = p9_fit_evaluate(cm, seed)
        # phase 10 on this model: the K-step CUDA graph
        out["graph"][tag] = graph_leg(
            tag, cm, lambda n, s_, w=which: p9_batches(w, s_, n),
            DLRM_GRAPH_K if which == "dlrm" else GRAPH_K, seed,
            dropout_check=dropout > 0, fault=which == "dlrm")
        del cm, inputs, label
    collect_garbage()
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = bench
    out["wall_s"] = time.perf_counter() - t0
    log(f"[phase 9] {out['wall_s']:.1f} s")
    return out


# ------------------------------------------- phase 10: the K-step CUDA graph
GRAPH_K, DLRM_GRAPH_K = 4, 20
GRAPH_FAULT = "fit/dispatch@3*1"


def _tree_copy(tree):
    return {k: _tree_copy(v) if isinstance(v, dict) else
            (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


@torch.no_grad()
def _tree_copy_into(live, saved) -> None:
    for k, v in saved.items():
        if isinstance(v, dict):
            _tree_copy_into(live[k], v)
        else:
            live[k].copy_(v)


def _snapshot(cm):
    return (_tree_copy(cm.params), _tree_copy(cm.opt_state),
            _tree_copy(cm.state), cm._iteration)


def _restore(cm, snap) -> None:
    """The snapshot copied into the live tensors (the captured graph's
    buffers stay), the state as new tensors (a dispatch copies them in)."""
    params, opt_state, state, it = snap
    _tree_copy_into(cm.params, params)
    _tree_copy_into(cm.opt_state, opt_state)
    cm.state = _tree_copy(state)
    cm._iteration = it


def _loc(t):
    """A DTensor's block on this process (phase 17); a tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _tree_diff(a, b) -> float:
    """max |a - b| over the float leaves of two param trees (each rank's
    blocks over a mesh)."""
    return max(float((_loc(a[l][w]).detach().float()
                      - _loc(b[l][w]).detach().float()).abs().max())
               for l in a for w in a[l])


def graph_leg(tag: str, cm, host_data, k: int, seed: int,
              dropout_check: bool = False, fault: bool = False) -> dict:
    """Phase 10 for one compiled model (`cm`, already stepped and tuned by
    its phase): `make_multi_step(k)` as one CUDA graph of k train steps.
    (a) from one snapshot, 2k eager steps twice and 2 graph dispatches on
    the same batches and keys (fold_in(base, i0 + i)): bitwise equal where
    the two eager runs are, else within their difference; with dropout,
    the same batch dispatched at i0 and at i0 + k gives two losses (other
    masks). The launch counters are zeroed before the graph's first call
    and read after its two dispatches: a kernel launch counts where it is
    captured (the warm-up step and the k captured ones), never at a
    replay. (b) torch.profiler: one cudaGraphLaunch per dispatch, the
    port's kernels replayed with the counts of k eager steps (each window
    counts two dispatches, or k eager steps, after an uncounted lead of
    the same; see `_device_profile`). (c) step ms
    eager against graph, the graph's busy ms and idle share, capture
    seconds, the graph pool's bytes beside max_memory_allocated. (d) one
    fit epoch of 2k + 1 batches with steps_per_dispatch=k, sync_every=0
    and dispatch_ahead 2: 3 dispatches (2 replays, 1 single step), 2k
    fused steps, 0 host syncs, 1 barrier, no new capture. (e) with
    `fault`, the same fit under the plan `GRAPH_FAULT`: one retry, and
    the params of (d)."""
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.compiler import graph_steps
    from flexflow_tpu_torch.kernels import fused_optim as fo
    from flexflow_tpu_torch.runtime import faults

    t_leg = time.perf_counter()
    base = ff_random.key(seed + 17)
    xs_h, y_h = host_data(2 * k, seed + 31)
    xs = [torch.from_numpy(a.reshape(2, k, -1, *a.shape[1:])).cuda()
          for a in xs_h]
    y = torch.from_numpy(y_h.reshape(2, k, -1, *y_h.shape[1:])).cuda()
    torch.cuda.synchronize()
    snap = _snapshot(cm)
    it0 = snap[3]

    def eager_steps(d):
        losses = []
        for i in range(k):
            (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
                cm.params, cm.opt_state, cm.state, [x[d, i] for x in xs],
                y[d, i], ff_random.fold_in(base, it0 + d * k + i))
            losses.append(loss)
        s_ = losses[0]
        for l_ in losses[1:]:
            s_ = s_ + l_
        return s_ / k

    def dispatch(d, i0=None):
        (cm.params, cm.opt_state, cm.state, loss, _) = multi(
            cm.params, cm.opt_state, cm.state, [x[d] for x in xs], y[d],
            base, it0 + d * k if i0 is None else i0)
        return loss

    # (a)
    eager = []
    for _ in range(2):
        _restore(cm, snap)
        means = [float(eager_steps(d)) for d in range(2)]
        eager.append((means, _tree_copy(cm.params)))
    run_to_run = _tree_diff(eager[0][1], eager[1][1])
    eager_bitwise = run_to_run == 0 and eager[0][0] == eager[1][0]
    _restore(cm, snap)
    torch.cuda.synchronize()
    caps0 = graph_steps.captures
    zero_launch_counts()
    builds0 = fo.table_builds
    multi = cm._get_multi(k)
    graph_means = [float(dispatch(d)) for d in range(2)]
    torch.cuda.synchronize()
    counts = launch_counts()
    graph_diff = _tree_diff(cm.params, eager[0][1])
    out = {"k": k, "eager_means": eager[0][0], "eager_means_again":
           eager[1][0], "graph_means": graph_means,
           "eager_run_to_run_max_abs": run_to_run,
           "eager_bitwise_reproducible": eager_bitwise,
           "graph_vs_eager_max_abs": graph_diff,
           "graph_bitwise_equal": graph_diff == 0
           and graph_means == eager[0][0],
           "captures": graph_steps.captures - caps0,
           "capture_s": multi.capture_s, "graph_pool_bytes": multi.pool_bytes,
           "launches": counts, "table_builds": fo.table_builds - builds0}
    del eager
    log(f"[10 {tag}] K={k}: eager means {out['eager_means']} (again "
        f"{out['eager_means_again']}, run to run max |dp| {run_to_run:.3e})"
        f", graph {graph_means}, graph vs eager max |dp| {graph_diff:.3e}, "
        f"bitwise {out['graph_bitwise_equal']}; capture {multi.capture_s:.2f}"
        f" s, pool {multi.pool_bytes / 2**20:.0f} MiB; launches counted at "
        f"the capture {counts}")
    if out["captures"] != 1 or out["table_builds"]:
        fail(f"10 {tag}: {out['captures']} captures, {out['table_builds']} "
             "optimizer table builds (expected 1 and 0)")
    if eager_bitwise and not out["graph_bitwise_equal"]:
        fail(f"10 {tag}: eager steps are bitwise reproducible but the graph "
             f"differs: {out}")
    if not eager_bitwise and graph_diff > run_to_run:
        fail(f"10 {tag}: graph vs eager {graph_diff} beyond the eager "
             f"run-to-run difference {run_to_run}")
    if not all(np.isfinite(graph_means)):
        fail(f"10 {tag}: non-finite graph loss {graph_means}")
    if dropout_check:
        _restore(cm, snap)
        a = float(dispatch(0))
        _restore(cm, snap)
        b = float(dispatch(0, it0 + k))
        out["same_batch_i0_vs_i0_plus_k"] = [a, b]
        log(f"[10 {tag}] one batch group at i0 and at i0 + {k}: mean loss "
            f"{a:.6f} and {b:.6f} (other dropout masks)")
        if a == b:
            fail(f"10 {tag}: two dispatches drew the same masks")
    # (b)
    prof_g = _device_profile(lambda: dispatch(0), 2, cm.device,
                             lead=lambda: dispatch(0))
    prof_e = _device_profile(lambda: eager_steps(0), 1, cm.device,
                             lead=lambda: eager_steps(0))
    out["profile_graph"], out["profile_eager_k_steps"] = prof_g, prof_e
    if "wall_ms_per_call" in prof_g and "wall_ms_per_call" in prof_e:
        pg = {n: v["launches_per_call"]
              for n, v in prof_g["port_kernels"].items()}
        pe = {n: v["launches_per_call"]
              for n, v in prof_e["port_kernels"].items()}
        log(f"[10 {tag}] profile: {prof_g['graph_launches_per_call']:.0f} "
            f"cudaGraphLaunch a dispatch, {prof_g['kernel_launches_per_call']:.0f}"
            f" kernels replayed (eager {k} steps: "
            f"{prof_e['kernel_launches_per_call']:.0f}), the port's kernels "
            f"{pg} (eager {pe}); graph busy "
            f"{prof_g['device_busy_ms_per_call'] / k:.2f} ms a step, idle "
            f"{prof_g['device_idle_share']:.3f} (eager busy "
            f"{prof_e['device_busy_ms_per_call'] / k:.2f} ms, idle "
            f"{prof_e['device_idle_share']:.3f}); first launch to first "
            f"kernel {prof_g['launch_to_first_kernel_us']} us (eager "
            f"{prof_e['launch_to_first_kernel_us']} us)")
        if prof_g["graph_launches_per_call"] != 1 or pg != pe or not pg:
            fail(f"10 {tag}: graph launches "
                 f"{prof_g['graph_launches_per_call']} a dispatch, replayed "
                 f"port kernels {pg} against eager {pe}")
    else:
        fail(f"10 {tag}: the profiler saw no kernel")
    # (c)
    torch.cuda.synchronize()
    collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    timed = {}
    for name, fn in (("eager", eager_steps), ("graph", dispatch),
                     ("graph_again", dispatch), ("eager_again", eager_steps)):
        t0 = time.perf_counter()
        for d in range(2):
            fn(d)
        torch.cuda.synchronize()
        timed[name] = 1e3 * (time.perf_counter() - t0) / (2 * k)
    out["step_ms"] = timed
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[10 {tag}] step ms (eager, graph, graph, eager): "
        + ", ".join(f"{v:.3f}" for v in timed.values())
        + f"; max_memory_allocated {out['max_memory_allocated_gib']:.2f} GiB, "
        f"graph pool {multi.pool_bytes / 2**30:.2f} GiB")
    # (d)
    fx, fy = host_data(2 * k + 1, seed + 37)
    ahead = cm.cfg.dispatch_ahead
    cm.cfg.dispatch_ahead = 2

    def fit_once():
        _restore(cm, snap)
        zero_launch_counts()
        caps = graph_steps.captures
        t0 = time.perf_counter()
        hist = cm.fit(fx, fy, epochs=1, verbose=False, sync_every=0,
                      steps_per_dispatch=k)
        torch.cuda.synchronize()
        return {"history": hist, "step_stats": dict(cm.step_stats),
                "wall_s": time.perf_counter() - t0,
                "launches": launch_counts(),
                "captures": graph_steps.captures - caps}

    try:
        out["fit"] = fit = fit_once()
        fit_params = _tree_copy(cm.params)
        want = {"dispatches": 3, "host_syncs": 0, "barriers": 1,
                "fused_steps": 2 * k}
        log(f"[10 {tag} fit] {2 * k + 1} batches: step_stats "
            f"{fit['step_stats']} (JAX counts {want}), loss "
            f"{fit['history'][0]['loss']:.4f}, "
            f"{fit['history'][0]['samples_per_sec']:.1f} samples/s")
        if fit["step_stats"] != want or fit["captures"] or \
                not np.isfinite(fit["history"][0]["loss"]):
            fail(f"10 {tag} fit: {fit}")
        # (e)
        if fault:
            faults.configure(GRAPH_FAULT)
            try:
                out["fit_fault"] = ff = fit_once()
                ff["fired"] = faults.fired()
            finally:
                faults.clear()
            ff["params_vs_clean_max_abs"] = d_ = _tree_diff(cm.params,
                                                            fit_params)
            log(f"[10 {tag} fault] plan {GRAPH_FAULT}: fired {ff['fired']}, "
                f"step_stats {ff['step_stats']}, params against the fit "
                f"without the plan max |dp| {d_:.3e}")
            if ff["fired"] != {"fit/dispatch": 1} or \
                    ff["step_stats"] != want or \
                    d_ > (0.0 if eager_bitwise else run_to_run):
                fail(f"10 {tag} fault: {ff}")
    finally:
        cm.cfg.dispatch_ahead = ahead
    out["wall_s"] = time.perf_counter() - t_leg
    return out


# ------------------------------- phase 11: telemetry, run health, attribution
P11_BATCHES, P11_EPOCHS, P11_SYNC = 8, 2, 2
# 11d: (K, fault plan, the step NonFiniteError names, its checkpoint's
# step), the cases tests/test_torch_port_health.py holds against JAX
HALT_CASES = ((1, "health/nonfinite@3", 3, 2),
              (2, "health/nonfinite@3", 4, 2))
ATTN_KERNELS = ("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                "flash_dkv_tc_kernel")


def _fit_events(tdir: str) -> dict:
    """(name, cat) -> count of the fit/*, health/* and op/* events of a
    telemetry directory."""
    from collections import Counter

    from flexflow_tpu_torch import telemetry as tel

    tel.flush()
    return dict(Counter(f"{e['name']}|{e.get('cat')}"
                        for e in tel.read_events(tdir)
                        if e["name"].startswith(("fit/", "health/", "op/"))))


def _expected_fit_events(stats: dict, epochs: int) -> dict:
    """What fit emits (JAX's counts, which the CPU test holds the port
    to): a dispatch span per dispatch, a prefetch wait per dispatch and
    one more an epoch (the loader's end), a host sync per sync and one at
    each epoch's end, a barrier per barrier, an epoch span, a goodput and
    a watermark event an epoch, and the drift event."""
    want = {"fit/dispatch|fit": stats["dispatches"],
            "fit/prefetch_wait|fit": stats["dispatches"] + epochs,
            "fit/host_sync|fit": stats["host_syncs"] + epochs,
            "fit/epoch|fit": epochs, "health/goodput|health": epochs,
            "health/hbm|health": epochs, "fit/drift|drift": 1}
    if stats["barriers"]:
        want["fit/barrier_sync|fit"] = stats["barriers"]
    return want


def p11_run(cm, snap, data, k: int, on: bool, tdir: str) -> dict:
    """One fit of 11a from the snapshot: P11_EPOCHS epochs of
    P11_BATCHES batches, a host sync every P11_SYNC updates, K = k, with
    telemetry and the sentinels both on or both off; the launch counters
    zeroed just before it (a graph's run captures anew, so each counts
    one capture: the warm-up step and the K captured steps)."""
    from flexflow_tpu_torch import telemetry as tel

    _restore(cm, snap)
    cm._multi_cache.clear()
    cm.cfg.health_sentinels = on
    if on:
        tel.configure(tdir)
    else:
        tel.shutdown()
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        hist = cm.fit(*data, epochs=P11_EPOCHS, verbose=False,
                      sync_every=P11_SYNC, steps_per_dispatch=k)
        torch.cuda.synchronize()
    finally:
        tel.shutdown()
    out = {"k": k, "on": on, "wall_s": time.perf_counter() - t0,
           "history": hist, "step_stats": dict(cm.step_stats),
           "launches": launch_counts(),
           "step_ms": 1e3 * cm.drift_stats()["measured_step_time_s"],
           "events": _fit_events(tdir) if on else {}}
    return out


def p11_telemetry(cm, gc, seed: int, tdir_root: str) -> dict:
    """11a and 11b: eager and K = 4, each with everything off and on, in
    turns (off, on, on, off): the same step_stats, launches and bitwise
    params; the stream of each run with telemetry on holds the events
    fit emits, in JAX's counts, and a drift event with the predicted and
    measured step."""
    ids, pos, labels = train_batch(seed + 41, gc.vocab,
                                   n=P11_BATCHES * BATCH)
    data = ([ids, pos], labels)
    snap = _snapshot(cm)
    out = {}
    for k in (1, GRAPH_K):
        runs, ref = [], None
        for i, on in enumerate((False, True, True, False)):
            tdir = os.path.join(tdir_root, f"k{k}-{i}")
            r = p11_run(cm, snap, data, k, on, tdir)
            params = _tree_copy(cm.params)
            if ref is None:
                ref = (r, params)
            else:
                r["params_bitwise_equal"] = _trees_bitwise(params, ref[1])
                if r["step_stats"] != ref[0]["step_stats"] or \
                        r["launches"] != ref[0]["launches"] or \
                        not r["params_bitwise_equal"]:
                    fail(f"11a K={k} run {i} ({'on' if on else 'off'}): "
                         f"step_stats {r['step_stats']} launches "
                         f"{r['launches']} bitwise "
                         f"{r['params_bitwise_equal']}, against the first "
                         f"off run's {ref[0]['step_stats']} "
                         f"{ref[0]['launches']}")
            del params
            if not all(np.isfinite(h["loss"]) for h in r["history"]):
                fail(f"11a K={k}: non-finite loss {r['history']}")
            if min(r["launches"][n] for n in (
                    "flash_attention_fwd", "flash_attention_dq",
                    "flash_attention_dkv", "fused_adam")) <= 0:
                fail(f"11a K={k}: a training kernel did not launch "
                     f"{r['launches']}")
            if on:
                want = _expected_fit_events(r["step_stats"], P11_EPOCHS)
                got = {n: c for n, c in r["events"].items() if n in want}
                if got != want:
                    fail(f"11b K={k}: events {r['events']}, expected {want}")
            runs.append(r)
        del ref
        steps = P11_EPOCHS * P11_BATCHES
        per_step = {n: v / (steps if k == 1 else GRAPH_K + 1)
                    for n, v in runs[0]["launches"].items() if v}
        log(f"[11a K={k}] step ms (off, on, on, off): "
            + ", ".join(f"{r['step_ms']:.2f}" for r in runs)
            + f"; step_stats {runs[0]['step_stats']}; launches a step "
            f"{per_step} ({'eager' if k == 1 else 'at the capture'}); "
            f"params bitwise equal across the four: True")
        log(f"[11b K={k}] events of the runs with telemetry on: "
            f"{runs[1]['events']}")
        out[f"k{k}"] = runs
    _restore(cm, snap)
    cm._multi_cache.clear()
    cm.cfg.health_sentinels = True
    return out


def p11_graph_kernels(cm, gc, seed: int) -> dict:
    """11a, with everything off the K-step graph must be the one it was
    without this layer: one dispatch of K = 4 captured with the sentinels
    off and one with them on, each profiled over 2 replays: the kernels a
    dispatch, busy ms and idle share."""
    from flexflow_tpu_torch import random as ff_random

    ids, pos, labels = train_batch(seed + 45, gc.vocab, n=GRAPH_K * BATCH)
    xs = [torch.from_numpy(a.reshape(GRAPH_K, BATCH, -1)).cuda()
          for a in (ids, pos)]
    y = torch.from_numpy(labels.reshape(GRAPH_K, BATCH, -1)).cuda()
    base = ff_random.key(seed + 17)
    snap = _snapshot(cm)
    out = {}
    for on in (False, True):
        _restore(cm, snap)
        cm._multi_cache.clear()
        cm._steps_key = (cm._accum_steps, on)
        cm.cfg.health_sentinels = on
        multi = cm._get_multi(GRAPH_K)

        def dispatch():
            (cm.params, cm.opt_state, cm.state, _, mv) = multi(
                cm.params, cm.opt_state, cm.state, xs, y, base, 0)
            return mv

        mv = dispatch()
        prof = _device_profile(dispatch, 2, cm.device, lead=dispatch)
        if "kernel_launches_per_call" not in prof:
            fail(f"11a: the profiler saw no kernel of the graph: {prof}")
        out["on" if on else "off"] = {
            k: prof[k] for k in ("kernel_launches_per_call",
                                 "graph_launches_per_call",
                                 "launch_to_first_kernel_us",
                                 "device_busy_ms_per_call",
                                 "device_idle_share", "port_kernels",
                                 "top_kernels")}
        out["on" if on else "off"]["metric_keys"] = sorted(mv)
    _restore(cm, snap)
    cm._multi_cache.clear()
    cm.cfg.health_sentinels = True
    off, on = out["off"], out["on"]
    log(f"[11a graph] a dispatch of K={GRAPH_K}, everything off: "
        f"{off['kernel_launches_per_call']:.0f} kernels, busy "
        f"{off['device_busy_ms_per_call'] / GRAPH_K:.2f} ms a step, idle "
        f"{off['device_idle_share']:.3f}; sentinels on: "
        f"{on['kernel_launches_per_call']:.0f} kernels, busy "
        f"{on['device_busy_ms_per_call'] / GRAPH_K:.2f} ms a step, idle "
        f"{on['device_idle_share']:.3f}; metrics {on['metric_keys']}; top "
        f"kernels on: " + ", ".join(f"{t['name'][:48]} {t['ms_per_call']:.3f}"
                                   f" ms x{t['launches_per_call']:.0f}"
                                   for t in on["top_kernels"][:6]))
    launches = {k: {n: v["launches_per_call"]
                    for n, v in out[k]["port_kernels"].items()}
                for k in out}
    if off["metric_keys"] or not on["metric_keys"] or \
            launches["off"] != launches["on"] or not launches["off"] or \
            off["graph_launches_per_call"] != 1 or \
            not off["kernel_launches_per_call"] < \
            on["kernel_launches_per_call"]:
        fail(f"11a graph: off {off}, on {on}")
    return out


P11_PAIRS = 10


def p11_sentinel_pairs(cm, gc, seed: int) -> dict:
    """11a, the sentinels' own cost, in turns: two K = 4 graphs of the
    same model, one captured with the sentinels off and one with them on,
    replayed alternately (off, on, on, off, ...) P11_PAIRS times each,
    each replay timed by the host clock between two device syncs; then
    the same for pairs of 2 eager train steps. Reports the medians, the
    median of the per-pair differences and the off runs' interquartile
    spread, and how many pairs the sentinels lost."""
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.compiler.graph_steps import GraphedSteps

    ids, pos, labels = train_batch(seed + 49, gc.vocab, n=GRAPH_K * BATCH)
    xs = [torch.from_numpy(a.reshape(GRAPH_K, BATCH, -1)).cuda()
          for a in (ids, pos)]
    y = torch.from_numpy(labels.reshape(GRAPH_K, BATCH, -1)).cuda()
    base = ff_random.key(seed + 17)
    snap = _snapshot(cm)
    graphs = {}

    def graph_call(on):
        if on not in graphs:
            # each graph captures the program of its own setting
            cm.cfg.health_sentinels = on
            graphs[on] = GraphedSteps(cm, GRAPH_K)
        (cm.params, cm.opt_state, cm.state, _, _) = graphs[on](
            cm.params, cm.opt_state, cm.state, xs, y, base, 0)

    def eager_call(on):
        cm.cfg.health_sentinels = on
        for i in range(2):
            (cm.params, cm.opt_state, cm.state, _, _) = cm.train_step(
                cm.params, cm.opt_state, cm.state, [xs[0][i], xs[1][i]],
                y[i], ff_random.fold_in(base, i))

    def timed(fn, on):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(on)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {}
    for name, fn, steps in (("eager", eager_call, 2),
                            ("graph", graph_call, GRAPH_K)):
        fn(False)
        fn(True)   # captures and warm-up
        runs = {False: [], True: []}
        for i in range(P11_PAIRS):
            order = (False, True) if i % 2 == 0 else (True, False)
            for on in order:
                runs[on].append(1e3 * timed(fn, on) / steps)
        diffs = [b - a for a, b in zip(runs[False], runs[True])]
        q1, q3 = np.percentile(runs[False], [25, 75])
        out[name] = {"off_ms": runs[False], "on_ms": runs[True],
                     "off_median": float(np.median(runs[False])),
                     "on_median": float(np.median(runs[True])),
                     "diff_median": float(np.median(diffs)),
                     "off_iqr": float(q3 - q1),
                     "pairs_on_slower": sum(d > 0 for d in diffs)}
        r = out[name]
        log(f"[11a pairs {name}] ms a step, {P11_PAIRS} pairs in turns: "
            f"sentinels off median {r['off_median']:.3f}, on "
            f"{r['on_median']:.3f}, per-pair difference median "
            f"{r['diff_median']:+.3f} (off runs' IQR {r['off_iqr']:.3f}); "
            f"on slower in {r['pairs_on_slower']} of {P11_PAIRS}")
    del graphs
    _restore(cm, snap)
    cm._multi_cache.clear()
    cm.cfg.health_sentinels = True
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def p11_attribution(cm, gc, seed: int, pdir: str, tdir: str) -> dict:
    """11c: a fit under profiling and profile_ops (telemetry on, so the
    fit-end attribution runs and emits op/attr), then
    op_attribution(source="trace"): within SUM_TOLERANCE of the measured
    step, its coverage, the attention layers credited with the flash
    forward, dQ and dK/dV kernels, the top 3 by drift."""
    from flexflow_tpu_torch import attribution
    from flexflow_tpu_torch import telemetry as tel

    ids, pos, labels = train_batch(seed + 43, gc.vocab, n=2 * BATCH)
    cm.cfg.profiling, cm.cfg.profile_ops, cm.cfg.profile_dir = True, True, pdir
    cm.forward_fn.layer_ranges = True
    tel.configure(tdir)
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        cm.fit([ids, pos], labels, epochs=2, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = launch_counts()
        t1 = time.perf_counter()
        rep = cm.op_attribution(source="trace", print_table=False)
        report_s = time.perf_counter() - t1
    finally:
        tel.shutdown()
        cm.cfg.profiling = cm.cfg.profile_ops = False
        cm.forward_fn.layer_ranges = False
    events = _fit_events(tdir)
    step = rep["step_time_s"]
    att = rep["attributed_total_s"]
    kernels = rep["trace"]["kernels"]
    attn = [l.name for l in cm.model.layers if l.name.endswith("_attn")]
    missing = {a: [k for k in ATTN_KERNELS
                   if not any(k in n for n in kernels.get(a, {}))]
               for a in attn}
    missing = {a: m for a, m in missing.items() if m}
    flash_ms = sum(us for a in attn for n, us in kernels.get(a, {}).items()
                   if "flash" in n) / 1e3
    out = {"fit_s": fit_s, "report_s": report_s, "source": rep["source"],
           "coverage": rep["coverage"], "step_ms": 1e3 * step,
           "attributed_ms": 1e3 * att,
           "device_ms": rep["trace"]["device_us"] / 1e3,
           "credited_ms": rep["trace"]["credited_us"] / 1e3,
           "attention_flash_ms": flash_ms,
           "trace_file_mb": os.path.getsize(rep["trace"]["file"]) / 2**20,
           "top_drift": rep["top_drift"], "launches": launches,
           "events": events,
           "rows": [{k: r[k] for k in ("layer", "op", "predicted_s",
                                       "attributed_s", "roofline_s",
                                       "bound", "mfu")}
                    for r in rep["rows"][:8]]}
    log(f"[11c] profiled fit {fit_s:.1f} s (trace "
        f"{out['trace_file_mb']:.1f} MiB), report {report_s:.1f} s; source "
        f"{rep['source']}, coverage {rep['coverage']:.4f} (credited "
        f"{out['credited_ms']:.2f} of {out['device_ms']:.2f} device ms), "
        f"attributed {out['attributed_ms']:.3f} ms against the measured "
        f"step {out['step_ms']:.3f} ms; the attention layers' flash kernels "
        f"{flash_ms:.2f} ms")
    for line in attribution.format_report(rep, top=8):
        log(f"[11c] {line}")
    # the device time of the two layers credited most, by kernel, over the
    # profiled window's steps
    steps = 2 * 2
    out["top_layer_kernels"] = {}
    for r in rep["rows"][:2]:
        ks = sorted(kernels.get(r["layer"], {}).items(), key=lambda kv: -kv[1])
        out["top_layer_kernels"][r["layer"]] = [
            (n[:60], us / steps / 1e3) for n, us in ks[:4]]
        log(f"[11c] {r['layer']}: device ms a step by kernel: " + ", ".join(
            f"{n[:60]} {ms:.3f}" for n, ms in out["top_layer_kernels"][
                r["layer"]]))
    if rep["source"] != "trace" or abs(att - step) / step > \
            attribution.SUM_TOLERANCE or missing or \
            not rep["coverage"] or rep["coverage"] > 1.0:
        fail(f"11c: source {rep['source']}, attributed {att} against step "
             f"{step}, coverage {rep['coverage']}, attention layers missing "
             f"kernels {missing}")
    if not events.get("op/attr|op") or not events.get("op/drift_topk|op"):
        fail(f"11c: the fit-end attribution emitted {events}")
    return out


def p11_halt(seed: int, root: str) -> dict:
    """11d: GPT-2 medium widths FIT_LAYERS deep (6d's cut: each durable
    snapshot writes the params and moments), b8 s1024, dropout 0, bf16,
    Adam, with health_sentinels and halt_on_nonfinite, a snapshot every 2
    updates and a host sync every update, under `health/nonfinite@s`,
    eager and K = 2: NonFiniteError at the CPU test's step, naming the
    last durable checkpoint (its step the CPU test's); a fresh model
    resumed from it trains with finite losses."""
    import shutil

    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.core.layer import Layer
    from flexflow_tpu_torch.core.tensor import Tensor
    from flexflow_tpu_torch.health import NonFiniteError
    from flexflow_tpu_torch.runtime import faults
    from flexflow_tpu_torch.runtime import resilience as rz

    ids, pos, labels = train_batch(seed + 47, GPT2_VOCAB, n=6 * BATCH)
    out = []
    for k, plan, halt, ckpt in HALT_CASES:
        croot = os.path.join(root, f"k{k}")
        Layer._next_guid[0], Tensor._next_guid[0] = 100, 1000
        _, _, cm = gpt2_train_model(seed, FIT_LAYERS, "bfloat16",
                                    AdamOptimizer(alpha=LR),
                                    halt_on_nonfinite=True)
        faults.configure(plan)
        zero_launch_counts()
        t0 = time.perf_counter()
        err = None
        try:
            cm.fit([ids, pos], labels, epochs=1, verbose=False,
                   sync_every=1, steps_per_dispatch=k, checkpoint_dir=croot,
                   checkpoint_every_steps=2)
        except NonFiniteError as e:
            err = e
        finally:
            faults.clear()
        halt_s = time.perf_counter() - t0
        launches = launch_counts()
        if err is None:
            fail(f"11d K={k}: {plan} did not halt the fit")
        man = rz.load_manifest(err.checkpoint) if err.checkpoint else None
        rec = {"k": k, "plan": plan, "step": err.step,
               "checkpoint": os.path.basename(err.checkpoint or ""),
               "checkpoint_step": man["step"] if man else None,
               "halt_s": halt_s, "launches": launches,
               "health": cm.health_report()["sentinels"]}
        del cm
        collect_garbage()
        torch.cuda.empty_cache()
        Layer._next_guid[0], Tensor._next_guid[0] = 100, 1000
        _, _, cm2 = gpt2_train_model(seed, FIT_LAYERS, "bfloat16",
                                     AdamOptimizer(alpha=LR))
        t0 = time.perf_counter()
        hist = cm2.fit([ids, pos], labels, epochs=1, verbose=False,
                       steps_per_dispatch=k, checkpoint_dir=croot,
                       resume=err.checkpoint)
        cm2.wait_checkpoints()
        torch.cuda.synchronize()
        rec["resumed_loss"] = hist[0]["loss"]
        rec["resume_s"] = time.perf_counter() - t0
        rec["resumed_iteration"] = cm2._iteration
        del cm2
        collect_garbage()
        torch.cuda.empty_cache()
        shutil.rmtree(croot, ignore_errors=True)
        log(f"[11d K={k}] {plan}: NonFiniteError at step {rec['step']} "
            f"naming {rec['checkpoint']} (step {rec['checkpoint_step']}); "
            f"sentinels {rec['health']}; halted in {halt_s:.1f} s; resumed "
            f"to iteration {rec['resumed_iteration']}, loss "
            f"{rec['resumed_loss']:.4f} in {rec['resume_s']:.1f} s")
        if (rec["step"], rec["checkpoint_step"]) != (halt, ckpt) or \
                not np.isfinite(rec["resumed_loss"]) or \
                rec["resumed_iteration"] != 6:
            fail(f"11d K={k}: {rec}, expected step {halt} and checkpoint "
                 f"step {ckpt}")
        if min(launches[n] for n in ("flash_attention_fwd", "fused_adam")) \
                <= 0:
            fail(f"11d K={k}: a training kernel did not launch {launches}")
        out.append(rec)
    return out


def p11_reports(cm) -> dict:
    """11e: health_report()'s watermark against memory_stats()'
    prediction (the warning as it falls) and goodput_report()'s buckets
    and residual (the buckets must tile the fit's wall)."""
    from flexflow_tpu_torch import health

    hr = cm.health_report()
    gp = cm.goodput_report()
    mem = cm.memory_stats()
    wm = hr["watermarks"]
    for line in health.format_health(hr["sentinels"], wm) + \
            health.format_goodput(gp):
        log(f"[11e] {line}")
    log(f"[11e] watermark peak {wm['peak_bytes'] / 2**30:.2f} GiB over "
        f"{wm['samples']} samples (allocated_bytes.all.peak: every tensor, "
        f"the CUDA graph pools included) against {wm['predicted']} "
        f"{mem['predicted_peak_bytes'] / 2**30:.2f} GiB: ratio "
        f"{wm['ratio']:.2f}, warn {wm['warn']} (threshold "
        f"{wm['warn_ratio']}); weight state predicted "
        f"{mem['predicted_weight_state_bytes'] / 2**30:.2f} GiB; goodput "
        f"{gp['goodput']:.4f}, residual {gp['residual_s']:.4f} s of "
        f"{gp['wall_s']:.3f} s")
    if not wm["samples"] or not wm["peak_bytes"] or \
            gp.get("accounted_frac", 0) < 0.95:
        fail(f"11e: watermarks {wm}, goodput {gp}")
    return {"health": hr, "goodput": gp, "memory_stats": mem}


def p11_serving(engine, params, prompts, tdir: str) -> dict:
    """11f: phase 3's int8 leg again with telemetry on: one
    serve/request_admitted and one serve/request_done a request, one
    serve/decode_step span a decode step."""
    from collections import Counter

    from flexflow_tpu_torch import telemetry as tel

    tel.configure(tdir)
    try:
        run, _ = serve(engine, params, prompts, "int8 telemetry")
        tel.flush()
        evs = tel.read_events(tdir)
    finally:
        tel.shutdown()
    c = Counter(e["name"] for e in evs)
    out = {"events": {n: c[n] for n in sorted(c)},
           "decode_steps": run["decode_steps"],
           "tokens_per_s": run["tokens_per_s"],
           "decode_step_p50_ms": run["decode_step_p50_ms"],
           "launches": run["launches"]}
    log(f"[11f] int8 serving with telemetry on: {run['tokens_per_s']:.1f} "
        f"tokens/s, decode step p50 {run['decode_step_p50_ms']:.2f} ms; "
        f"events {out['events']}")
    if c["serve/request_admitted"] != len(prompts) or \
            c["serve/request_done"] != len(prompts) or \
            c["serve/decode_step"] != run["decode_steps"]:
        fail(f"11f: events {out['events']} for {len(prompts)} requests and "
             f"{run['decode_steps']} decode steps")
    return out


# phase 11's depth (11d's is FIT_LAYERS): GPT-2 medium's widths, as 5b
# trains it, cut for the time limit (its checks are the same at any depth)
P11_LAYERS = 6


def phase11(seed: int, keep_tel: str = "") -> dict:
    """Phase 11 on GPT-2 medium as 5b trains it at P11_LAYERS deep (11d at
    FIT_LAYERS), in a temporary directory removed at the end; 11a's
    telemetry moves to `keep_tel` first when one is given (phase 22
    reads it)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ff_p11_")
    try:
        collect_garbage()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gc, _, cm = gpt2_train_model(seed, P11_LAYERS, "bfloat16")
        out = {"telemetry": p11_telemetry(cm, gc, seed,
                                          os.path.join(root, "tel"))}
        out["graph_kernels"] = p11_graph_kernels(cm, gc, seed)
        out["attribution"] = p11_attribution(
            cm, gc, seed, os.path.join(root, "prof"),
            os.path.join(root, "tel-attr"))
        # the reports before the pairs: two graph pools at once would
        # raise the peak the watermark reads past what the fits hold
        out["reports"] = p11_reports(cm)
        out["sentinel_pairs"] = p11_sentinel_pairs(cm, gc, seed)
        del cm
        collect_garbage()
        torch.cuda.empty_cache()
        out["halt"] = p11_halt(seed, os.path.join(root, "ckpt"))
        if keep_tel:
            shutil.move(os.path.join(root, "tel"), keep_tel)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase 11] {out['wall_s']:.1f} s")
    return out


# ------------------------------- phase 12: tiered KV, hot-swap, tracing
# 12a's host tier: three quarters of every slot's pages, so the device pool
# keeps a quarter (8 x 66 - 396 = 132 data pages + scratch)
P12_PAGES_PER_SLOT = -(-(SEQ + NEW_TOKENS) // PAGE)
P12_HOST_PAGES = 3 * SLOTS * P12_PAGES_PER_SLOT // 4
# 12a's decode profile: prompts cut so all 8 slots fit the tiered pool
# (8 x 16 pages of 16), over a few decode steps
P12_PROFILE_PROMPT = 16 * PAGE - NEW_TOKENS
P12_PROFILE_STEPS = 4
P12_MIN_TIER_MOVES = 8
# 12b's mismatched snapshot: GPT-2 medium at another depth
P12_OTHER_DEPTH = 2
SYNC_WARNING = "called a synchronizing CUDA operation"


def p12_engine(gc, params, kv: str, seed: int, **cfg_kw):
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import build_gpt2
    from flexflow_tpu_torch.serving import compile_serving

    model = FFModel(FFConfig(seed=seed, compute_dtype="bfloat16",
                             max_batch_slots=SLOTS, kv_page_size=PAGE,
                             max_decode_len=NEW_TOKENS, kv_cache_dtype=kv,
                             **cfg_kw))
    build_gpt2(model, gc, batch=SLOTS)
    engine = compile_serving(model)
    engine.load_params(params)
    return engine


def p12_serve(engine, prompts, label: str, count_syncs: bool = False,
              **sched_kw) -> dict:
    """One scheduler run over `prompts` with the launch counters set to 0
    just before it and read just after; with `count_syncs`, the host syncs
    it made, counted by torch's sync debug mode (each synchronizing CUDA
    call warns once). Fails unless every request completes with
    NEW_TOKENS tokens."""
    import warnings

    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    sched = ContinuousBatchingScheduler(engine, engine.params,
                                        gpt2_prompt_inputs, gpt2_step_inputs,
                                        **sched_kw)
    dev = engine.device
    sync(dev)
    zero_launch_counts()
    syncs = None
    t0 = time.perf_counter()
    if count_syncs:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                done = sched.run(reqs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    else:
        done = sched.run(reqs)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if len(done) != len(prompts) or sched.shed or sched.failed:
        fail(f"{label}: {len(done)} of {len(prompts)} requests completed")
    if any(len(r.tokens) != NEW_TOKENS for r in done):
        fail(f"{label}: a request ended short of {NEW_TOKENS} tokens")
    return {"sched": sched, "streams": {r.rid: list(r.tokens) for r in done},
            "wall_s": wall, "launches": counts, "host_syncs": syncs,
            "decode_steps": sched.decode_steps, "prefills": sched.prefills,
            "materializations": sched.materializations,
            "decode_step_p50_ms": 1e3 * float(np.median(sched.step_times)),
            "tokens_per_s": sum(len(r.tokens) for r in done) / wall}


def _summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("sched", "streams")}


def _transfer_ms(kv) -> dict:
    """Median device ms and GB/s of the tier's spills and refills (CUDA
    events recorded around each)."""
    out = {}
    for direction, rows in kv.transfer_times().items():
        if rows:
            ms = float(np.median([m for _, m in rows]))
            rate = float(np.median([b / (m * 1e-3) for b, m in rows if m > 0]))
            out[direction] = {"count": len(rows), "median_ms": ms,
                              "median_bytes": float(np.median(
                                  [b for b, _ in rows])),
                              "median_GBps": rate / 1e9}
    return out


def p12_tier(gc, params, prompts, streams: dict, seed: int,
             host_bw: float, phase3: dict) -> dict:
    """12a: the tiered cache at 132 device data pages, int8 and bf16;
    `phase3` holds phase 3's runs by KV dtype."""
    out = {}
    for kv in ("auto", "int8"):
        t_leg = time.perf_counter()
        label = f"12a {kv} tiered"
        eng = p12_engine(gc, params, kv, seed, kv_host_pages=P12_HOST_PAGES)
        ms = eng.memory_stats()
        if ms["kv_pool_pages"] != SLOTS * P12_PAGES_PER_SLOT - \
                P12_HOST_PAGES + 1 or \
                ms["actual_kv_cache_bytes"] != ms["predicted_kv_cache_bytes"] \
                or ms["actual_kv_host_bytes"] != ms["predicted_kv_host_bytes"]:
            fail(f"{label}: memory_stats {ms}")
        run = p12_serve(eng, prompts, label, count_syncs=True)
        sched, kvc = run["sched"], eng.kv
        ts = kvc.tier_stats()
        joins = ts["kv_prefetch_hits"] + ts["kv_prefetch_stalls"]
        if run["streams"] != streams[kv]:
            diff = [r for r in run["streams"]
                    if run["streams"][r] != streams[kv][r]]
            fail(f"{label}: streams differ from phase 3's in requests {diff}")
        if ts["kv_spills"] < P12_MIN_TIER_MOVES or \
                joins < P12_MIN_TIER_MOVES or joins != ts["kv_refills"]:
            fail(f"{label}: tier stats {ts}")
        deq = run["launches"]["dequant_decode_attention"]
        if kv == "int8" and deq != gc.layers * sched.decode_steps:
            fail(f"{label}: {deq} dequant launches for "
                 f"{sched.decode_steps} decode steps")
        if kv == "auto" and deq:
            fail(f"{label}: the bf16 cache launched the dequant kernel")
        if len(kvc.free_pages) != kvc.spec.pool_pages - 1 or \
                len(kvc.free_host_pages) != P12_HOST_PAGES or sched.parked:
            fail(f"{label}: pages not back: {len(kvc.free_pages)} device, "
                 f"{len(kvc.free_host_pages)} host free")
        want_syncs = sched.materializations + sched.prefills + kvc.host_syncs
        if run["host_syncs"] != want_syncs:
            fail(f"{label}: {run['host_syncs']} host syncs, want "
                 f"{sched.materializations} materializations + "
                 f"{sched.prefills} prefills + {kvc.host_syncs} spills")
        leg = {"run": _summary(run), "tier": ts, "memory": ms,
               "transfers": _transfer_ms(kvc), "host_bw_GBps": host_bw / 1e9,
               "health": eng.health_report()}
        short = [p[:P12_PROFILE_PROMPT] for p in prompts]
        leg["profile_tiered"] = profile_engine(eng, params, short, False,
                                               P12_PROFILE_STEPS)
        del eng, sched, run
        collect_garbage()
        torch.cuda.empty_cache()
        flat = p12_engine(gc, params, kv, seed)
        base = p12_serve(flat, prompts, f"12a {kv} untiered")
        if base["streams"] != streams[kv]:
            fail(f"12a {kv} untiered: streams differ from phase 3's")
        leg["untiered"] = _summary(base)
        leg["profile_untiered"] = profile_engine(flat, params, short, False,
                                                 P12_PROFILE_STEPS)
        del flat, base
        collect_garbage()
        torch.cuda.empty_cache()
        nan = {"median_ms": float("nan"), "median_GBps": float("nan")}
        tr = {d: leg["transfers"].get(d, nan) for d in ("spill", "prefetch")}
        pt, pu = leg["profile_tiered"]["decode_step"], \
            leg["profile_untiered"]["decode_step"]
        log(f"[{label}] pool {ms['kv_pool_pages']} pages "
            f"({ms['actual_kv_cache_bytes'] / 2**20:.1f} MiB), host "
            f"{ms['actual_kv_host_bytes'] / 2**20:.1f} MiB; spills "
            f"{ts['kv_spills']} ({ts['kv_spilled_bytes'] / 2**20:.1f} MiB), "
            f"refills {ts['kv_refills']} "
            f"({ts['kv_refilled_bytes'] / 2**20:.1f} MiB), hits "
            f"{ts['kv_prefetch_hits']}, stalls "
            f"{ts['kv_prefetch_stalls']}; host syncs "
            f"{leg['run']['host_syncs']} = "
            f"{leg['run']['materializations']} + "
            f"{leg['run']['prefills']} + {ts['kv_spills']}")
        log(f"[{label}] spill {tr['spill']['median_ms']:.3f} ms "
            f"({tr['spill']['median_GBps']:.2f} GB/s), refill "
            f"{tr['prefetch']['median_ms']:.3f} ms "
            f"({tr['prefetch']['median_GBps']:.2f} GB/s) a slot, pinned "
            f"host_bw {host_bw / 1e9:.2f} GB/s; decode step p50 "
            f"{leg['run']['decode_step_p50_ms']:.2f} ms tiered, "
            f"{leg['untiered']['decode_step_p50_ms']:.2f} untiered; "
            f"{leg['run']['decode_steps']} against "
            f"{leg['untiered']['decode_steps']} steps, "
            f"{leg['run']['tokens_per_s']:.1f} against "
            f"{leg['untiered']['tokens_per_s']:.1f} tokens/s; profiled step "
            f"(8 slots of {P12_PROFILE_PROMPT}-token prompts) wall "
            f"{pt.get('wall_ms_per_call', float('nan')):.2f} / "
            f"{pu.get('wall_ms_per_call', float('nan')):.2f} ms, busy "
            f"{pt.get('device_busy_ms_per_call', float('nan')):.3f} / "
            f"{pu.get('device_busy_ms_per_call', float('nan')):.3f} ms")
        b3 = phase3.get(kv, {})
        b3p = b3.get("profile", {}).get("decode_step", {})
        leg["phase3"] = {"decode_step_p50_ms": b3.get("decode_step_p50_ms"),
                         "profile_decode_step": b3p}
        leg["wall_s"] = time.perf_counter() - t_leg
        log(f"[{label}] phase 3's run: decode step p50 "
            f"{b3.get('decode_step_p50_ms', float('nan')):.2f} ms, profiled "
            f"step (full prompts) wall "
            f"{b3p.get('wall_ms_per_call', float('nan')):.2f} ms, busy "
            f"{b3p.get('device_busy_ms_per_call', float('nan')):.3f} ms; "
            f"leg {leg['wall_s']:.1f} s")
        out[kv] = leg
    return out


def p12_snapshot(cm, root: str, step: int, params=None) -> str:
    from flexflow_tpu_torch.runtime.resilience import save_durable

    if params is not None:
        cm.load_params(params)
    cm._iteration = step
    return save_durable(cm, root, block=True)


def p12_trace(engine, prompts, streams: dict, tdir: str) -> dict:
    """12c: phase 3's int8 run with tracing off, on, on, off (the on runs
    export the offered load)."""
    from flexflow_tpu_torch.serving import tracefmt

    runs, path = [], os.path.join(tdir, "trace.jsonl")
    for i, on in enumerate((False, True, True, False)):
        engine.cfg.serve_trace_out = path if on else ""
        run = p12_serve(engine, prompts,
                        f"12c tracing {'on' if on else 'off'}", reqtrace=on)
        if run["streams"] != streams["int8"]:
            fail(f"12c run {i}: streams differ from phase 3's int8 streams")
        if on:
            fracs = [tr["accounted_frac"] for tr in run["sched"].tracer.ring]
            if len(fracs) != len(prompts) or min(fracs) < 0.95:
                fail(f"12c: stage accounting {min(fracs)} over "
                     f"{len(fracs)} traces")
            run["min_accounted_frac"] = min(fracs)
            trace = tracefmt.load_trace(path)
            back = tracefmt.records_to_requests(trace.records)
            got = [(r.rid, r.prompt, r.max_new_tokens, r.arrival_s,
                    r.priority, r.deadline_s) for r in back]
            want = [(i, p, NEW_TOKENS, 0.0, 1, None)
                    for i, p in enumerate(prompts)]
            if got != want or trace.skipped:
                fail("12c: the exported trace does not replay to the "
                     "same requests")
            run["stages"] = sorted({s["stage"] for tr in
                                    run["sched"].tracer.ring
                                    for s in tr["stages"]})
        else:
            if run["sched"].tracer is not None:
                fail("12c: tracing off still holds a tracer")
        runs.append(run)
    engine.cfg.serve_trace_out = ""
    if len({r["materializations"] for r in runs}) != 1:
        fail(f"12c: materializations {[r['materializations'] for r in runs]}")
    out = {"runs": [_summary(r) for r in runs],
           "stages": runs[1]["stages"],
           "min_accounted_frac": min(r["min_accounted_frac"]
                                     for r in runs if "stages" in r)}
    log("[12c] tracing off/on/on/off: decode step p50 " + ", ".join(
        f"{r['decode_step_p50_ms']:.2f}" for r in runs) + " ms, tokens/s " +
        ", ".join(f"{r['tokens_per_s']:.1f}" for r in runs) +
        f"; materializations {runs[0]['materializations']} each; stages "
        f"{out['stages']}; min accounted {out['min_accounted_frac']:.4f}")
    return out


def p12_swap(engine, gc, params, prompts, streams: dict, seed: int,
             root: str) -> dict:
    """12b: two durable snapshots (A: phase 3's params, B: A perturbed from
    the seed), a mid-run swap to B, rollback to A and its pin, unpin, and
    a snapshot of another depth rejected while serving goes on."""
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch import telemetry as tel

    live, stage = os.path.join(root, "live"), os.path.join(root, "stage")
    _, _, cm = gpt2_train_model(seed, gc.layers, "bfloat16",
                                SGDOptimizer(lr=SGD_LR))
    gen = torch.Generator().manual_seed(seed + 12)
    a = {n: {w: t.float() for w, t in d.items()} for n, d in params.items()}
    b = {n: {w: t + 0.02 * t.abs().mean() * torch.randn(
        t.shape, generator=gen).to(t.device) for w, t in d.items()}
        for n, d in a.items()}
    t0 = time.perf_counter()
    p12_snapshot(cm, live, 1, a)
    staged_b = p12_snapshot(cm, stage, 2, b)
    del cm
    collect_garbage()
    torch.cuda.empty_cache()
    write_s = time.perf_counter() - t0
    engine.watch(live, poll_interval_s=0.0)
    if not engine.poll_swap(force=True) or engine.active_version != 1:
        fail("12b: the engine did not take snapshot A")
    # B lands in the watched root after the first admission wave
    moved, swap_at = {}, {}
    prefill, poll = engine.prefill, engine.poll_swap

    def prefill_then_publish(p, inputs):
        out = prefill(p, inputs)
        if not moved:
            os.replace(staged_b,
                       os.path.join(live, os.path.basename(staged_b)))
            moved["done"] = True
        return out

    def timed_poll(force=False):
        swapped = poll(force)
        if swapped:
            swap_at.setdefault("t", time.perf_counter())
        return swapped
    engine.prefill, engine.poll_swap = prefill_then_publish, timed_poll
    try:
        mid = p12_serve(engine, prompts, "12b mid-run swap")
    finally:
        engine.prefill, engine.poll_swap = prefill, poll
    sched = mid["sched"]
    if sched.stats["swaps"] != 1 or engine.active_version != 2 or \
            "t" not in swap_at:
        fail(f"12b: swaps {sched.stats['swaps']}, version "
             f"{engine.active_version}")
    t_swap = swap_at["t"] - sched._t0
    after = sorted(r.rid for r in sched.completed if r.admit_s > t_swap)
    fresh = p12_engine(gc, b, "int8", seed)
    b_run = p12_serve(fresh, prompts, "12b fresh engine on B")
    del fresh
    collect_garbage()
    torch.cuda.empty_cache()
    if not after or any(mid["streams"][r] != b_run["streams"][r]
                        for r in after):
        fail(f"12b: requests admitted after the swap {after} differ from "
             "a fresh engine on B")
    lat_ms, nbytes = 1e3 * engine.swap_stats.latencies_s[-1], \
        engine.swap_bytes
    # rollback to A, pinned
    if engine.rollback() != 1:
        fail("12b: rollback did not re-pin A")
    ra = p12_serve(engine, prompts, "12b rolled back to A")
    if ra["streams"] != streams["int8"] or engine.poll_swap(force=True):
        fail("12b: rollback streams are not A's, or the pin let a swap in")
    engine.unpin()
    if not engine.poll_swap(force=True) or engine.active_version != 2:
        fail("12b: unpin did not bring B back")
    rb = p12_serve(engine, prompts, "12b unpinned to B")
    if rb["streams"] != b_run["streams"]:
        fail("12b: after unpin the streams are not B's")
    # another depth: rejected while serving goes on
    _, _, small = gpt2_train_model(seed, P12_OTHER_DEPTH, "bfloat16",
                                   SGDOptimizer(lr=SGD_LR))
    p12_snapshot(small, live, 3)
    del small
    tdir = os.path.join(root, "tel")
    tel.configure(tdir)
    try:
        rej = p12_serve(engine, prompts, "12b mismatched snapshot")
        tel.flush()
        evs = tel.read_events(tdir)
    finally:
        tel.shutdown()
    rejected = [e for e in evs if e["name"] == "serve/swap_rejected"]
    if len(rejected) != 1 or engine.active_version != 2 or \
            rej["streams"] != b_run["streams"] or \
            engine.swap_stats.rejected != 1:
        fail(f"12b: the other depth's snapshot: {len(rejected)} rejections, "
             f"version {engine.active_version}")
    engine._watch_root = None
    out = {"snapshot_write_s": write_s, "swap_latency_ms": lat_ms,
           "swap_bytes": nbytes, "after_swap_rids": after,
           "mid_run": _summary(mid), "rejection": rejected[0]["args"],
           "swap_stats": engine.swap_stats.report(),
           "health": engine.health_report()}
    log(f"[12b] snapshots A and B written in {write_s:.1f} s; one mid-run "
        f"swap to B in {lat_ms:.1f} ms ({nbytes / 2**20:.1f} MiB placed), "
        f"{len(after)} requests admitted after it equal a fresh engine on "
        f"B; rollback to A pinned, unpin to B; the {P12_OTHER_DEPTH}-layer "
        f"snapshot "
        f"rejected: {rejected[0]['args'].get('error', '')[:120]!r}")
    return out


def p12_reports(tier: dict, swap: dict, engine, trace: dict) -> dict:
    """12d: health reports (the KV tier's and the swap panels) and the
    serving op attribution of prefill and decode."""
    med = trace["runs"][0]["decode_step_p50_ms"] / 1e3
    att = engine.op_attribution(step_time_s=med)
    out = {"kv_tier": {kv: leg["health"]["serving"]["kv_tier"]
                       for kv, leg in tier.items()},
           "swap": swap["health"]["serving"],
           "watermarks": swap["health"]["watermarks"]}
    from flexflow_tpu_torch.attribution import format_report
    for kv, panel in out["kv_tier"].items():
        log(f"[12d] kv_tier ({kv}): {panel}")
    log(f"[12d] swap panel: " + json.dumps(
        {k: v for k, v in out["swap"].items() if k not in ("slo",)},
        default=str))
    log(f"[12d] watermark: {out['watermarks']}")
    for tag, rep in att.items():
        log(f"[12d] {tag}: {len(rep['rows'])} ops, measured "
            f"{1e3 * rep['measured_total_s']:.3f} ms")
        for line in format_report(rep, top=6):
            log(f"  {line}")
        out[tag] = {"rows": [{k: r[k] for k in ("layer", "op", "predicted_s",
                                                "measured_s", "attributed_s",
                                                "bound")}
                             for r in rep["rows"][:12]],
                    "measured_total_s": rep["measured_total_s"],
                    "coverage": rep["coverage"]}
    return out


def phase12(gc, params, prompts, streams: dict, seed: int,
            base: dict) -> dict:
    """Phase 12 on phase 3's weights, prompts and greedy streams (`base`:
    phase 3's runs by KV dtype), in a temporary directory removed at the
    end."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ff_p12_")
    walls = {}
    try:
        host_bw = host_copy_rate()
        out = {"tier": p12_tier(gc, params, prompts, streams, seed, host_bw,
                                base)}
        walls["12a"] = time.perf_counter() - t_phase
        collect_garbage()
        torch.cuda.empty_cache()
        # the engine's watermark reads the allocator's peak from here
        torch.cuda.reset_peak_memory_stats()
        engine = p12_engine(gc, params, "int8", seed)
        t0 = time.perf_counter()
        out["trace"] = p12_trace(engine, prompts, streams, root)
        walls["12c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["swap"] = p12_swap(engine, gc, params, prompts, streams, seed,
                               root)
        walls["12b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["reports"] = p12_reports(out["tier"], out["swap"], engine,
                                     out["trace"])
        walls["12d"] = time.perf_counter() - t0
        del engine
    finally:
        shutil.rmtree(root, ignore_errors=True)
    collect_garbage()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    log(f"[phase 12] {out['wall_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return out


# --------------------------------- phase 13: the fleet and the twin
# half of every slot's pages on the host: whatever a prefill replica
# admitted onto its device pool fits its host tier when it hands it off,
# and the device pools keep half (264 data pages + scratch)
P13_HOST_PAGES = SLOTS * P12_PAGES_PER_SLOT // 2
P13_RATE = 50.0             # open-loop arrivals a second, a replica
P13_SLO = "ttft_p99_ms=1"   # (c)'s objective: every request breaks it
P13_BURN_MAX = 1.0


def p13_arrivals(seed: int, n: int = 0, rate: float = P13_RATE):
    """Open-loop arrival offsets (REQUESTS of them unless `n`):
    `tracefmt.poisson_records` timing."""
    from flexflow_tpu_torch.serving import tracefmt

    recs = tracefmt.poisson_records(np.random.default_rng(seed),
                                    n or REQUESTS, rate, 2, 1, NEW_TOKENS)
    return [r.arrival_ts for r in recs]


def p13_requests(prompts, arrivals):
    """Phase 3's prompts (cycled) arriving at `arrivals`, rid = index."""
    from flexflow_tpu_torch.serving import Request

    return [Request(rid=i, prompt=prompts[i % len(prompts)],
                    max_new_tokens=NEW_TOKENS, arrival_s=float(a))
            for i, a in enumerate(arrivals)]


def p13_fleet(engines, **kw):
    from flexflow_tpu_torch.serving import (ServingFleet, gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    return ServingFleet(engines, gpt2_prompt_inputs, gpt2_step_inputs, **kw)


def _idle_profile(fn, dev: torch.device) -> dict:
    """One call of `fn` under torch.profiler recording the card's activity
    only: the wall time, the device's busy time (the union of its kernel
    intervals) and its idle share, read from the raw kineto events (a
    whole serving run holds ~10^5 kernels). The profiler may drop events:
    the busy time is a floor."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_ns = 1e9 * (time.perf_counter() - t0)
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"device": "not measured (the profiler saw no kernel)"}
    busy, (cur_s, cur_e) = 0, spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy, cur_s = busy + cur_e - cur_s, a
        cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    return {"wall_ms": wall_ns / 1e6, "device_busy_ms": busy / 1e6,
            "device_idle_share": 1.0 - busy / wall_ns,
            "kernels": len(spans)}


def p13_serve(runner, reqs, label: str, count_syncs: bool = False,
              profile: bool = False, new_tokens: int = NEW_TOKENS,
              **serve_kw) -> dict:
    """One run of `runner` (a `ServingFleet`, or a plain scheduler) over
    `reqs`, with every launch counter set to 0 just before it and read
    just after; `count_syncs` counts the host syncs (torch's sync debug
    mode), `profile` runs it under torch.profiler for the device's busy
    time and idle share. Fails unless every request completes with
    `new_tokens` tokens."""
    import warnings

    fleet = hasattr(runner, "replicas")
    dev = torch.device("cuda")
    box = {}

    def call():
        box["done"] = (runner.serve(reqs, **serve_kw) if fleet
                       else runner.run(reqs))
    sync(dev)
    zero_launch_counts()
    syncs, prof = None, None
    t0 = time.perf_counter()
    if count_syncs:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    elif profile:
        prof = _idle_profile(call, dev)
    else:
        call()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    done = box["done"]
    scheds = [h.sched for h in runner.replicas] if fleet else [runner]
    if len(done) != len(reqs) or runner.shed or runner.failed:
        fail(f"{label}: {len(done)} of {len(reqs)} requests completed, "
             f"{len(runner.shed)} shed, {len(runner.failed)} failed")
    if any(len(r.tokens) != new_tokens for r in done):
        fail(f"{label}: a request ended short of {new_tokens} tokens")
    ttft = np.array([r.ttft_s for r in done])
    tokens = sum(len(r.tokens) for r in done)
    steps = [t for s in scheds for t in s.step_times]
    out = {"runner": runner, "streams": {r.rid: list(r.tokens)
                                         for r in done},
           "requests": len(done), "wall_s": wall, "launches": counts,
           "host_syncs": syncs, "tokens_per_s": tokens / wall,
           "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
           "ttft_p99_ms": 1e3 * float(np.percentile(ttft, 99)),
           "decode_step_p50_ms": (1e3 * float(np.median(steps)) if steps
                                  else None),
           "decode_steps": sum(s.decode_steps for s in scheds),
           "prefills": sum(s.prefills for s in scheds),
           "materializations": sum(s.materializations for s in scheds)}
    if prof is not None:
        out["profile"] = prof
    return out


def _p13_summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("runner", "streams")}


def p13_exact_launches(run: dict, label: str, layers: int) -> None:
    """The dequant decode once a layer every decode step, the flash
    forward once a layer every prefill, summed over the replicas."""
    got = run["launches"]
    deq, fla = got["dequant_decode_attention"], got["flash_attention_fwd"]
    if deq != layers * run["decode_steps"] or \
            fla != layers * run["prefills"]:
        fail(f"{label}: {deq} dequant launches for {run['decode_steps']} "
             f"decode steps, {fla} flash launches for {run['prefills']} "
             "prefills")


def p13_same_streams(got: dict, want: dict, label: str) -> None:
    bad = sorted(r for r in want if got.get(r) != want[r])
    if len(got) != len(want) or bad:
        fail(f"{label}: streams differ from phase 3's int8 streams in "
             f"requests {bad}")


def p13_identity(engine, prompts, want: dict) -> dict:
    """13a: one colocated replica against the plain scheduler."""
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    at0 = [0.0] * len(prompts)
    plain = p13_serve(ContinuousBatchingScheduler(
        engine, engine.params, gpt2_prompt_inputs, gpt2_step_inputs),
        p13_requests(prompts, at0), "13a plain", count_syncs=True)
    one = p13_serve(p13_fleet([engine]), p13_requests(prompts, at0),
                    "13a one replica", count_syncs=True)
    p13_same_streams(plain["streams"], want, "13a plain")
    if one["streams"] != plain["streams"]:
        fail("13a: the one-replica fleet's streams differ from the plain "
             "scheduler's")
    for k in ("flash_attention_fwd", "dequant_decode_attention"):
        if one["launches"][k] != plain["launches"][k]:
            fail(f"13a: {k} launched {one['launches'][k]} times in the "
                 f"fleet, {plain['launches'][k]} in the plain scheduler")
    if one["host_syncs"] != plain["host_syncs"]:
        fail(f"13a: {one['host_syncs']} host syncs in the fleet, "
             f"{plain['host_syncs']} in the plain scheduler")
    if one["runner"].replicas[0].thread is not None:
        fail("13a: the one-replica fleet started a thread")
    out = {"plain": _p13_summary(plain), "one_replica": _p13_summary(one)}
    log(f"[13a] one replica = plain scheduler: streams bitwise, launches "
        f"{one['launches']['flash_attention_fwd']} flash / "
        f"{one['launches']['dequant_decode_attention']} dequant, host "
        f"syncs {one['host_syncs']} each; {one['tokens_per_s']:.1f} "
        f"against {plain['tokens_per_s']:.1f} tokens/s")
    return out


def _payload_bytes(payload) -> int:
    return sum(int(t.numel() * t.element_size())
               for d in payload["layers"].values() for t in d.values())


def p13_topologies(engines, prompts, arrivals, want: dict, host_bw: float,
                   trace_path: str) -> dict:
    """13b: colocated (least_loaded) against disagg (1 + 1)."""
    reckoned = sum(engines[0].kv.pages_needed(len(p) + NEW_TOKENS + 4)
                   for p in prompts)
    spec = engines[0].kv.spec
    engines[0].cfg.serve_trace_out = trace_path
    try:
        colo = p13_serve(p13_fleet(engines, topology="colocated",
                                   router="least_loaded"),
                         p13_requests(prompts, arrivals), "13b colocated")
    finally:
        engines[0].cfg.serve_trace_out = ""
    times = {"export": [], "import": []}

    def timed(kind, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            dt = time.perf_counter() - t0
            times[kind].append((_payload_bytes(out if kind == "export"
                                               else a[1]), dt))
            return out
        return call
    before = [dict(e.kv.tier_counters) for e in engines]
    for e in engines:
        e.kv.export_parked = timed("export", e.kv.export_parked)
        e.kv.import_parked = timed("import", e.kv.import_parked)
    try:
        dis = p13_serve(p13_fleet(engines, topology="disagg"),
                        p13_requests(prompts, arrivals), "13b disagg")
    finally:
        for e in engines:
            del e.kv.export_parked, e.kv.import_parked
    p13_same_streams(colo["streams"], want, "13b colocated")
    p13_same_streams(dis["streams"], want, "13b disagg")
    fleet = dis["runner"]
    imports = [e.kv.tier_counters["kv_handoffs"] - b["kv_handoffs"]
               for e, b in zip(engines, before)]
    moved = [e.kv.tier_counters["kv_handoff_bytes"] - b["kv_handoff_bytes"]
             for e, b in zip(engines, before)]
    want_bytes = reckoned * spec.layers * spec.page_bytes()
    if fleet.stats["handoffs"] != REQUESTS or imports != [0, REQUESTS] or \
            len(times["export"]) != REQUESTS:
        fail(f"13b disagg: {fleet.stats['handoffs']} handoffs, imports "
             f"{imports}, {len(times['export'])} exports")
    if moved != [0, want_bytes]:
        fail(f"13b disagg: kv_handoff_bytes {moved}, want {want_bytes} "
             f"({reckoned} pages x {spec.layers} layers x "
             f"{spec.page_bytes()} B)")
    if colo["runner"].stats["handoffs"]:
        fail("13b colocated: a request was handed off")
    for run, label in ((colo, "13b colocated"), (dis, "13b disagg")):
        p13_exact_launches(run, label, len(engines[0].attn_layers))
    rows = {}
    for kind, xs in times.items():
        ms = [1e3 * dt for _, dt in xs]
        rate = [b / dt / 1e9 for b, dt in xs if dt > 0]
        rows[kind] = {"count": len(xs), "ms": ms,
                      "bytes": [b for b, _ in xs],
                      "median_ms": float(np.median(ms)),
                      "median_GBps": float(np.median(rate))}
        log(f"[13b] {kind} (host copies) a handoff, ms: " + ", ".join(
            f"{m:.2f}" for m in ms) + f"; median {rows[kind]['median_ms']:.3f}"
            f" ms, {rows[kind]['median_GBps']:.2f} GB/s against the pinned "
            f"host-to-device copy's {host_bw / 1e9:.2f} GB/s")
    out = {"colocated": _p13_summary(colo), "disagg": _p13_summary(dis),
           "handoff_bytes": want_bytes, "handoff_pages": reckoned,
           "handoffs": rows, "colocated_report": colo["runner"].report(),
           "per_replica": {"colocated": colo["runner"].stats["per_replica"],
                           "disagg": fleet.stats["per_replica"]}}
    for tag in ("colocated", "disagg"):
        r = out[tag]
        log(f"[13b] {tag}: streams = phase 3's; {r['tokens_per_s']:.1f} "
            f"tokens/s, TTFT p50 {r['ttft_p50_ms']:.1f} p99 "
            f"{r['ttft_p99_ms']:.1f} ms, {r['prefills']} prefills, "
            f"{r['decode_steps']} decode steps, launches exact; per "
            "replica " + ", ".join(
                f"{p['role']}: {p['completed']} done, {p['handoffs']} "
                "handed off" for p in out["per_replica"][tag]))
    log(f"[13b] disagg: {REQUESTS} handoffs, {want_bytes / 2**20:.1f} MiB "
        f"({reckoned} pages) through the host tiers")
    return out, colo["runner"]


def p13_rolling(engines, gc, params, prompts, arrivals, want: dict,
                seed: int, root: str) -> dict:
    """13c: the rolling swap, then the burn-triggered rollback."""
    import threading

    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch import telemetry as tel
    from flexflow_tpu_torch.health import SLOTracker, parse_slo

    stage, live = os.path.join(root, "stage"), os.path.join(root, "live")
    os.makedirs(live)
    _, _, cm = gpt2_train_model(seed, gc.layers, "bfloat16",
                                SGDOptimizer(lr=SGD_LR))
    a = {n: {w: t.float() for w, t in d.items()} for n, d in params.items()}
    t0 = time.perf_counter()
    staged = {step: p12_snapshot(cm, stage, step, a) for step in (2, 3)}
    del cm, a
    collect_garbage()
    torch.cuda.empty_cache()
    write_s = time.perf_counter() - t0
    for e in engines:
        e.slo = SLOTracker(parse_slo(P13_SLO))
    runs = {}
    for step, burn in ((2, 0.0), (3, P13_BURN_MAX)):
        label = f"13c {'rollback' if burn else 'rolling swap'}"
        fleet = p13_fleet(engines, rollout_burn_max=burn)
        prefill, published = engines[0].prefill, threading.Event()

        def publish(p, inputs, prefill=prefill, published=published,
                    step=step):
            out = prefill(p, inputs)
            if not published.is_set():
                os.replace(staged[step], os.path.join(
                    live, os.path.basename(staged[step])))
                published.set()
            return out
        engines[0].prefill = publish
        seen = {}
        if burn:
            # the controller bakes replica 0's swap until its burn is
            # judged and then freezes the rollout: note how far replica 1
            # had got at the rollback, to show it served on, refused
            rollback0 = engines[0].rollback

            def judged(*a, rollback0=rollback0, fleet=fleet, **kw):
                out = rollback0(*a, **kw)
                seen["mats1"] = fleet.replicas[1].sched.materializations
                return out
            engines[0].rollback = judged
        tdir = os.path.join(root, f"tel{step}")
        tel.configure(tdir)
        try:
            run = p13_serve(fleet, p13_requests(prompts, arrivals), label,
                            watch_root=live, poll_interval_s=0.0)
            tel.flush()
            events = [(e["args"]["replica"], e["args"]["action"],
                       e["args"]["version"]) for e in tel.read_events(tdir)
                      if e["name"] == "serve/fleet_rollout"]
        finally:
            tel.shutdown()
            for e in engines:
                for name in ("prefill", "rollback"):
                    e.__dict__.pop(name, None)
        p13_same_streams(run["streams"], want, label)
        rolling = fleet.rolling
        if burn:
            want_events = [(0, "swap", 3), (0, "rollback", 2)]
            if rolling.swaps != [(0, 3)] or \
                    rolling.rollbacks != [(0, 2)] or not rolling.halted or \
                    events != want_events or engines[1].active_version != 2:
                fail(f"{label}: swaps {rolling.swaps}, rollbacks "
                     f"{rolling.rollbacks}, halted {rolling.halted}, events "
                     f"{events}")
            if fleet.replicas[1].sched.materializations <= \
                    seen.get("mats1", 1 << 30):
                fail(f"{label}: replica 1 served nothing after the "
                     "rollback (the freeze was not tried)")
            run["replica1_windows_after_rollback"] = \
                fleet.replicas[1].sched.materializations - seen["mats1"]
            run["bake_waits"] = rolling.bake_waits
        else:
            want_events = [(0, "swap", 2), (1, "swap", 2)]
            if rolling.swaps != [(0, 2), (1, 2)] or rolling.rollbacks or \
                    rolling.halted or events != want_events or \
                    [h.sched.stats["swaps"] for h in fleet.replicas] != \
                    [1, 1]:
                fail(f"{label}: swaps {rolling.swaps}, rollbacks "
                     f"{rolling.rollbacks}, events {events}")
        run["events"] = events
        runs[label] = run
        log(f"[{label}] events {events}; {run['requests']} of "
            f"{REQUESTS} completed, none dropped, streams = phase 3's; "
            f"{run['tokens_per_s']:.1f} tokens/s"
            + (f"; replica 1 was held {run['bake_waits']} times by the "
               "bake, then ran "
               f"{run['replica1_windows_after_rollback']} windows after the "
               "rollback, refused by the freeze" if burn else ""))
    for e in engines:
        e._watch_root = None
        e.unpin()
        e.slo = SLOTracker(parse_slo(""))
    out = {k: _p13_summary(v) for k, v in runs.items()}
    # the published snapshots, for phase 21's rolling swap
    out["snapshots"] = {step: os.path.join(live, os.path.basename(path))
                        for step, path in staged.items()}
    out["snapshot_write_s"] = write_s
    out["swap_latency_ms"] = [1e3 * x for e in engines
                              for x in e.swap_stats.latencies_s]
    log(f"[13c] snapshots written in {write_s:.1f} s; swap latencies "
        + ", ".join(f"{m:.1f}" for m in out["swap_latency_ms"]) + " ms")
    return out


def p13_scaling(engines, prompts, want: dict, seed: int) -> dict:
    """13d: one and two colocated replicas at equal load a replica."""
    out = {}
    for n in (1, 2):
        arrivals = p13_arrivals(seed + 20 + n, n * REQUESTS, n * P13_RATE)
        leg = {}
        for profile in (False, True):
            tag = f"13d {n} replica{'s' if n > 1 else ''}" + \
                (" profiled" if profile else "")
            run = p13_serve(p13_fleet(engines[:n]),
                            p13_requests(prompts, arrivals), tag,
                            profile=profile)
            got = {r: s for r, s in run["streams"].items()}
            if any(got[r] != want[r % REQUESTS] for r in got):
                fail(f"{tag}: streams differ from phase 3's")
            p13_exact_launches(run, tag, len(engines[0].attn_layers))
            leg["profiled" if profile else "run"] = _p13_summary(run)
        out[n] = leg
        r, p = leg["run"], leg["profiled"].get("profile", {})
        log(f"[13d] {n} replica(s), {n * REQUESTS} requests at "
            f"{n * P13_RATE:.0f}/s: {r['tokens_per_s']:.1f} tokens/s, TTFT "
            f"p50 {r['ttft_p50_ms']:.1f} p99 {r['ttft_p99_ms']:.1f} ms, "
            f"{r['decode_steps']} decode steps; profiled run: idle share "
            f"{p.get('device_idle_share', float('nan')):.3f}, busy "
            f"{p.get('device_busy_ms', float('nan')):.1f} of "
            f"{p.get('wall_ms', float('nan')):.1f} ms, "
            f"{p.get('kernels', 0)} kernels")
    out["scale2_x"] = out[2]["run"]["tokens_per_s"] / \
        out[1]["run"]["tokens_per_s"]
    log(f"[13d] two replicas give {out['scale2_x']:.3f}x the tokens/s of one")
    return out


def p13_twin(engine, live_fleet, trace_path: str, n: int = REQUESTS,
             label: str = "13e") -> dict:
    """13e: (b)'s colocated trace (`n` requests) through the twin, against
    the live run."""
    from flexflow_tpu_torch.serving import tracefmt, twin

    trace = tracefmt.load_trace(trace_path)
    if len(trace) != n or trace.skipped:
        fail(f"{label}: the exported trace holds {len(trace)} records")
    live_rep = live_fleet.report()
    spec = twin.TwinSpec.from_engine(engine, replicas=len(
        live_fleet.replicas), dispatch_ahead=4)
    costs = twin.TwinCosts.resolve(spec.kv_spec(), cfg=engine.cfg,
                                   machine=engine.machine,
                                   live_report=live_rep, slots=spec.slots)
    costs.window_overhead_s = twin.calibrate_window_overhead(
        trace.records, spec, costs, live_rep["stats"]["wall_s"])
    res = twin.simulate(trace.records, spec, costs)
    rep = res.report()
    if label == "13e":
        # kept for 16c, which prices the same replay with the learned rung
        _TWIN_REPLAY.update(records=trace.records, spec=spec, live=live_rep,
                            costs=costs, machine=engine.machine,
                            cfg=engine.cfg)
    if res.stats["completed"] != n or res.stats["shed"]:
        fail(f"{label}: the twin completed {res.stats['completed']} of {n}")
    missing = sorted(set(live_rep) - set(rep))
    if missing:
        fail(f"{label}: the twin's report lacks the live report's "
             f"{missing}")

    def metrics(r):
        h = r["hists"]
        return {"tokens_per_s": r["stats"]["tokens_per_s"],
                "wall_s": r["stats"]["wall_s"],
                "ttft_p50_s": h["ttft"]["p50"], "ttft_p99_s": h["ttft"]["p99"],
                "per_token_p50_s": h["per_token"]["p50"],
                "queue_wait_p50_s": h["queue_wait"]["p50"]}
    val = twin.validate(metrics(live_rep), metrics(rep))
    log(f"[{label}] twin ({costs.source}: decode step "
        f"{1e3 * costs.decode_step_s:.2f} ms, prefill "
        f"{1e3 * costs.prefill_base_s:.2f} ms, window overhead "
        f"{1e3 * costs.window_overhead_s:.2f} ms) against live: " + ", ".join(
            f"{k} {m['live']:.4g} / {m['twin']:.4g} ({100 * m['rel_err']:.1f}%)"
            for k, m in val["metrics"].items())
        + f"; worst {100 * val['max_rel_err']:.1f}%")
    return {"costs": dataclasses.asdict(costs), "validate": val,
            "twin_stats": res.stats, "spec": dataclasses.asdict(spec)}


def phase13(gc, params, prompts, streams: dict, seed: int,
            host_bw: float, keep: str = "") -> dict:
    """Phase 13 on phase 3's weights, prompts and int8 streams, in a
    temporary directory removed at the end; 13c's snapshots are moved into
    `keep` first (phase 21 publishes them again), their paths in
    `out["snapshots"]`."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ff_p13_")
    walls, out = {}, {}
    want = streams["int8"]
    try:
        engines = [p12_engine(gc, params, "int8", seed,
                              kv_host_pages=P13_HOST_PAGES)
                   for _ in range(2)]
        walls["engines"] = time.perf_counter() - t_phase
        arrivals = p13_arrivals(seed + 13)
        t0 = time.perf_counter()
        out["13a"] = p13_identity(engines[0], prompts, want)
        walls["13a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        trace_path = os.path.join(root, "fleet_trace.jsonl")
        out["13b"], colo_fleet = p13_topologies(
            engines, prompts, arrivals, want, host_bw, trace_path)
        walls["13b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["13e"] = p13_twin(engines[0], colo_fleet, trace_path)
        walls["13e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["13c"] = p13_rolling(engines, gc, params, prompts, arrivals,
                                 want, seed, root)
        walls["13c"] = time.perf_counter() - t0
        snaps = out["13c"].pop("snapshots")
        if keep:
            out["snapshots"] = {}
            for step, path in snaps.items():
                out["snapshots"][step] = os.path.join(
                    keep, os.path.basename(path))
                os.replace(path, out["snapshots"][step])
        t0 = time.perf_counter()
        out["13d"] = p13_scaling(engines, prompts, want, seed)
        walls["13d"] = time.perf_counter() - t0
        del engines, colo_fleet
    finally:
        shutil.rmtree(root, ignore_errors=True)
    collect_garbage()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    log(f"[phase 13] {out['wall_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return out


# ------------------------------------------- phase 14: the model zoo
# each builder's JAX defaults (the batch they build with), bf16 compute
# over f32 master weights; the optimizers of tests/test_models.py where a
# test sets one (SGD 0.01), AlexNet's SGD with momentum 0.9 and weight
# decay 5e-4, Adam(1e-4) elsewhere
P14_MODELS = ("alexnet", "inception_v3", "mlp", "candle_uno", "xdl",
              "moe_mlp", "branchy")
P14_TIMED, P14_GRAPH_K = 5, 4
ZOO_SGD = dict(lr=0.01, momentum=0.9, weight_decay=5e-4)
# the optimizer kernel each model's step launches once
ZOO_KERNEL = {"alexnet": "fused_sgd", "alexnet_cifar10": "fused_sgd",
              "mlp": "fused_sgd_plain", "moe_mlp": "fused_sgd_plain",
              "inception_v3": "fused_adam", "candle_uno": "fused_adam",
              "xdl": "fused_adam", "branchy": "fused_adam",
              "branchy_1": "fused_adam", "branchy_plain": "fused_adam"}


def branchy_plain(model, batch: int = 1024, width: int = 512,
                  hidden: int = 8192, modules: int = 4):
    """(14c) the branch ensemble written out in plain layers, two
    branches (relu, gelu) a module joined by an add: the graph
    `fuse_fork_joins` rewrites into `modules` fork-joins."""
    x = model.create_tensor([batch, width], name="x")
    t = model.dense(x, width, activation="relu", name="trunk")
    for j in range(modules):
        ys = [model.dense(model.dense(t, hidden, activation=act,
                                      name=f"m{j}_{act}_mid"),
                          width, name=f"m{j}_{act}_out")
              for act in ("relu", "gelu")]
        t = model.add(ys[0], ys[1], name=f"m{j}_join")
        t = model.dense(t, width, activation="relu", name=f"proj{j}")
    model.dense(t, 10, name="head")


def zoo_build(which: str, model) -> None:
    from flexflow_tpu_torch import models
    from flexflow_tpu_torch.models.alexnet import build_alexnet_cifar10
    from flexflow_tpu_torch.models.branchy import build_branchy

    if which == "alexnet":
        models.build_alexnet(model)             # b64, 3x224x224, 1000
    elif which == "alexnet_cifar10":
        build_alexnet_cifar10(model, batch=64)
    elif which == "inception_v3":
        models.build_inception_v3(model)        # b32, 3x299x299, 1000
    elif which == "mlp":
        models.build_mlp(model, 64, 784)        # hidden (512, 512), 10
    elif which == "candle_uno":
        models.build_candle_uno(model)          # towers 4192 x 8, top x 4
    elif which == "xdl":
        models.build_xdl(model)                 # four 1,000,000 x 64
    elif which == "moe_mlp":
        models.build_moe_mlp(model)             # 64 experts, top-2
    elif which == "branchy":
        build_branchy(model)                    # b1024, 4 modules x 4
    elif which == "branchy_1":
        build_branchy(model, modules=1)
    else:
        branchy_plain(model)


def zoo_model(which: str, compute_dtype: str, seed: int, fuse: bool = False,
              guids=None, **cfg) -> tuple:
    """(compiled model, forward flops by the registry's count, batch,
    fork-join regions fused) of `which` built by the port's builders;
    `fuse` applies `fuse_fork_joins` before the compile; `guids` (layer,
    tensor) starts the guid counters there, so two builds draw the same
    dropout masks."""
    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                    SGDOptimizer)
    from flexflow_tpu_torch.compiler.passes import fuse_fork_joins
    from flexflow_tpu_torch.core.layer import Layer
    from flexflow_tpu_torch.core.tensor import Tensor
    from flexflow_tpu_torch.ops import get_op_def

    if guids is not None:
        Layer._next_guid[0], Tensor._next_guid[0] = guids
    model = FFModel(FFConfig(compute_dtype=compute_dtype, seed=seed, **cfg))
    zoo_build(which, model)
    model.config.batch_size = model.input_tensors[0].shape[0]
    fused = fuse_fork_joins(model) if fuse else 0
    kernel = ZOO_KERNEL[which]
    opt = (SGDOptimizer(**ZOO_SGD) if kernel == "fused_sgd"
           else SGDOptimizer(lr=0.01) if kernel == "fused_sgd_plain"
           else AdamOptimizer(alpha=LR))
    loss = ("mean_squared_error" if which == "candle_uno"
            else "sparse_categorical_crossentropy")
    cm = model.compile(opt, loss, [])
    cm.init(seed=seed)
    flops = sum(get_op_def(l.op_type).flop_count(l) for l in model.layers)
    return cm, flops, model.input_tensors[0].shape[0], fused


def zoo_batches(model, seed: int, n: int = 1) -> tuple:
    """`n` batches for `model`'s inputs, one after the other (numpy, on
    the host): ids below the table size of the embedding reading them,
    floats N(0, 0.25), labels as its loss takes them."""
    rng = np.random.default_rng(seed)
    xs = []
    for t in model.input_tensors:
        shape = (n * t.shape[0],) + tuple(t.shape[1:])
        if t.dtype.value == "int32":
            hi = next(l.params["num_entries"] for l in model.layers
                      if t in l.inputs)
            xs.append(rng.integers(0, hi, size=shape).astype(np.int32))
        else:
            xs.append(rng.normal(size=shape, scale=0.5).astype(np.float32))
    out = model.layers[-1].outputs[0].spec.shape
    rows = n * out[0]
    if model.compiled.loss_type.value == "mean_squared_error":
        y = rng.normal(size=(rows,) + tuple(out[1:])).astype(np.float32)
    else:
        y = rng.integers(0, out[-1], size=(rows,)).astype(np.int32)
    return xs, y


def p14_grad_check(which: str, seed: int, tols) -> dict:
    """(14a) `grad_check` of `which`: one step through the kernels and one
    through the plain versions from the same params, f32 and bf16. The
    model's optimizer kernel must have launched."""
    probe = zoo_model(which, "float32", seed)[0]
    inputs, label = on_card(*zoo_batches(probe.model, seed + 1))
    del probe
    collect_garbage()
    torch.cuda.empty_cache()
    zero_launch_counts()
    out = grad_check(lambda dt: zoo_model(which, dt, seed)[0], inputs, label,
                     tols, f"14a grad check {which}", "full width")
    counts = launch_counts()
    if counts[ZOO_KERNEL[which]] <= 0:
        fail(f"14a grad check {which}: {ZOO_KERNEL[which]} not launched: "
             f"{counts}")
    out["launches"] = counts
    return out


def _steps_losses(cm, inputs, label, seed: int, n: int) -> list:
    from flexflow_tpu_torch import random as ff_random

    base, losses = ff_random.key(seed + 17), []
    for i in range(n):
        (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, inputs, label,
            ff_random.fold_in(base, i))
        losses.append(float(loss))
    return losses


def p14_fusion(seed: int) -> dict:
    """(14c) `fuse_fork_joins` before compile: Inception-v3 (its concat
    joins ride the channel axis, so JAX's pass fuses none of its regions)
    and the branch ensemble in plain layers (4 regions). Both models of a
    pair are built from the same guids (Inception's dropout masks fold
    them in); the fused one takes the unfused one's params and state; 2
    steps of each on one batch: the losses, expected bitwise, gated at
    RUN_LOSS_RTOL."""
    from flexflow_tpu_torch.compiler.passes import find_fork_join_regions
    from flexflow_tpu_torch.core.layer import Layer
    from flexflow_tpu_torch.core.tensor import Tensor

    out = {}
    start = Layer._next_guid[0], Tensor._next_guid[0]
    for which in ("inception_v3", "branchy_plain"):
        ref = zoo_model(which, "bfloat16", seed, guids=start)[0]
        regions = len(find_fork_join_regions(ref.model))
        p0, s0 = _tree_copy(ref.params), _tree_copy(ref.state)
        cm, _, _, fused = zoo_model(which, "bfloat16", seed, fuse=True,
                                    guids=start)
        params = {}
        for layer in cm.model.layers:
            if layer.branches:
                for bi, (bls, _bx, _o) in enumerate(layer.branches):
                    for bl in bls:
                        for w in bl.weight_specs:
                            params.setdefault(layer.name, {})[
                                f"b{bi}.{bl.name}.{w}"] = p0[bl.name][w]
            elif layer.weight_specs:
                params[layer.name] = p0[layer.name]
        cm.load_params(params)
        cm.state = _tree_copy(s0)
        inputs, label = on_card(*zoo_batches(ref.model, seed + 5))
        ref.load_params(p0)
        ref.state = s0
        zero_launch_counts()
        unfused = _steps_losses(ref, inputs, label, seed, 2)
        fused_l = _steps_losses(cm, inputs, label, seed, 2)
        counts = launch_counts()
        diff = max(abs(a - b) / abs(b) for a, b in zip(fused_l, unfused))
        out[which] = {"regions_found": regions, "regions_fused": fused,
                      "losses_unfused": unfused, "losses_fused": fused_l,
                      "max_rel_diff": diff,
                      "bitwise": fused_l == unfused, "launches": counts}
        log(f"[14c] {which}: {regions} fork-join regions found, {fused} "
            f"fused; losses unfused {unfused}, fused {fused_l}, largest "
            f"relative difference {diff:.3e} (bitwise {fused_l == unfused};"
            f" gate {RUN_LOSS_RTOL})")
        if diff > RUN_LOSS_RTOL or not all(np.isfinite(fused_l)):
            fail(f"14c {which}: fused against unfused {out[which]}")
        if counts != {n: 4 if n == ZOO_KERNEL[which] else 0 for n in counts}:
            fail(f"14c {which}: launches {counts}")
        del cm, ref, p0, s0
        collect_garbage()
        torch.cuda.empty_cache()
    if out["branchy_plain"]["regions_fused"] != 4 or \
            out["inception_v3"]["regions_fused"] != 0:
        fail(f"14c: fused regions {out}")
    return out


def p14_strategy(seed: int, tmpdir: str) -> dict:
    """(14e) the branch ensemble searched (graph_optimize) for an H100
    machine of data 8 x model 4 and saved as `export_strategy_file`
    saves a strategy; imported on the one card (`import_strategy_file`)
    it trains 3 steps to the data-parallel compile's losses from the same
    params (one device applies neither placement)."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models.branchy import build_branchy
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    from flexflow_tpu_torch.search.optimize import graph_optimize

    machine = MachineSpec(mesh_axes={"data": 8, "model": 4}, chip="h100")
    model = FFModel(FFConfig(batch_size=1024, search_budget=SEARCH_BUDGET,
                             strategy_cache=False))
    build_branchy(model)
    t0 = time.perf_counter()
    strategy = graph_optimize(model, machine,
                              optimizer=AdamOptimizer(alpha=LR))
    search_s = time.perf_counter() - t0
    path = os.path.join(tmpdir, "branchy_strategy.json")
    strategy.save(path)
    placed = {k: v.attrs for k, v in strategy.op_shardings.items() if v.attrs}
    imported = zoo_model("branchy", "bfloat16", seed,
                         import_strategy_file=path)[0]
    inputs, label = on_card(*zoo_batches(imported.model, seed + 7))
    zero_launch_counts()
    li = _steps_losses(imported, inputs, label, seed, 3)
    counts = launch_counts()
    del imported
    collect_garbage()
    torch.cuda.empty_cache()
    plain = zoo_model("branchy", "bfloat16", seed)[0]
    lp = _steps_losses(plain, inputs, label, seed, 3)
    del plain
    collect_garbage()
    torch.cuda.empty_cache()
    diff = max(abs(a - b) / abs(b) for a, b in zip(li, lp))
    out = {"machine": dict(machine.mesh_axes), "search_s": search_s,
           "strategy": strategy.name, "placed": placed,
           "predicted_step_s": getattr(strategy, "_predicted_cost", None),
           "losses_imported": li, "losses_data_parallel": lp,
           "max_rel_diff": diff, "bitwise": li == lp, "launches": counts}
    log(f"[14e] search on {out['machine']} in {search_s:.2f} s: "
        f"{strategy.name}, placed {placed}, predicted step "
        f"{1e3 * (out['predicted_step_s'] or 0):.3f} ms; imported on one card"
        f": losses {li} against data parallel {lp} (bitwise {li == lp})")
    if not placed or diff > RUN_LOSS_RTOL or not all(np.isfinite(li)):
        fail(f"14e: {out}")
    if counts != {n: 3 if n == "fused_adam" else 0 for n in counts}:
        fail(f"14e: launches {counts}")
    return out


def phase14(seed: int) -> dict:
    """The model zoo on the card: (a) gradient checks, (b) every model at
    its builder's defaults, (c) the fork-join pass, (d) the K-step graph on
    MoE-MLP and the branch ensemble, (e) a searched strategy imported.
    cuDNN's autotuner is on for the phase."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    out = {"grad_check": {}, "legs": {}, "graph": {}}
    for which, tols in (("moe_mlp", GRAD_TOL_SGD), ("branchy_1", GRAD_TOL),
                        ("alexnet_cifar10", GRAD_TOL_SGD)):
        out["grad_check"][which] = p14_grad_check(which, seed, tols)
    out["grad_check_s"] = time.perf_counter() - t0
    card = card_line()
    for which in P14_MODELS:
        collect_garbage()
        torch.cuda.empty_cache()
        cm, flops, batch, _ = zoo_model(which, "bfloat16", seed)
        inputs, label = on_card(*zoo_batches(cm.model, seed))
        out["legs"][which] = train_leg(
            f"14b {which}", which, cm, flops, batch, inputs, label,
            {ZOO_KERNEL[which]: 1}, seed, P14_TIMED, 1)
        leg, prof = out["legs"][which], out["legs"][which]["profile"]
        log(f"[14b {which}] {card}: step {leg['step_ms_median']:.2f} ms, "
            f"{leg['samples_per_s']:.1f} samples/s, MFU "
            f"{100 * leg['mfu_port_count']:.2f}%, peak "
            f"{leg['max_memory_allocated_gib']:.2f} GiB, "
            f"{ZOO_KERNEL[which]} once a step, busy "
            f"{prof.get('device_busy_ms_per_call', float('nan')):.2f} ms, "
            f"idle {prof.get('device_idle_share', float('nan')):.3f}")
        if which in ("moe_mlp", "branchy"):
            out["graph"][which] = graph_leg(
                f"14d {which}", cm,
                lambda n, s_, m=cm.model: zoo_batches(m, s_, n),
                P14_GRAPH_K, seed)
        del cm, inputs, label
    out["legs_s"] = time.perf_counter() - t0 - out["grad_check_s"]
    out["fusion"] = p14_fusion(seed)
    tmpdir = tempfile.mkdtemp(prefix="ff_p14_")
    try:
        out["strategy"] = p14_strategy(seed, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    collect_garbage()
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = bench
    out["wall_s"] = time.perf_counter() - t0
    log(f"[phase 14] {out['wall_s']:.1f} s (grad checks "
        f"{out['grad_check_s']:.1f} s, legs and graphs {out['legs_s']:.1f} s)"
        f" on {card_line()}")
    return out


# ------------------------------------------------ phase 15: the frontends
# BERT-base's widths (phase 9d's constants), as a plain-PyTorch module
BERT_D, BERT_HEADS, BERT_FFN = 768, 12, 3072
# 15a: the port's logits against the module's own forward, f32 on both
# sides (TF32 off): the largest |difference| over the largest |logit|
P15_FWD_TOL = 1e-3
# 15c: the imported encoder's forward against the same arithmetic in plain
# torch (the same f32 ops, another grouping of some): the same measure
P15_ONNX_TOL = 1e-4
P15_WINDOWS, P15_PER_WINDOW = 3, 2       # 2 warm-up + 6 timed steps a leg
P15_KERAS_BATCH, P15_KERAS_BATCHES = 64, 4
P15_LAUNCH_ARGS = ("-b", "64", "--lr", "0.05", "-e", "1")

# the script 15d launches: it reads the launcher's config, trains an MLP
# for its epochs at its batch size under the compile's default optimizer
# (SGD at --lr) on the default device, and prints what it got
P15_SCRIPT = r'''
import json, sys
import numpy as np
import torch
import flexflow_tpu_torch as ff
from chip_smoke import launch_counts, zero_launch_counts

cfg = ff.get_launch_config()
m = ff.FFModel(cfg)
x = m.create_tensor([cfg.batch_size, 784], name="x")
m.dense(m.dense(x, 512, activation="relu", name="h"), 10, name="out")
cm = m.compile(None, "sparse_categorical_crossentropy", ["accuracy"])
rng = np.random.default_rng(0)
xs = rng.normal(size=(4 * cfg.batch_size, 784)).astype(np.float32)
ys = rng.integers(0, 10, size=(4 * cfg.batch_size,)).astype(np.int32)
cm.init(seed=0)


def sync():
    if cm.device.type == "cuda":
        torch.cuda.synchronize()


sync()
zero_launch_counts()
hist = cm.fit(xs, ys, verbose=False, sync_every=0)
sync()
print("P15D " + json.dumps({
    "argv": sys.argv[1:], "batch_size": cfg.batch_size,
    "learning_rate": cfg.learning_rate, "epochs": cfg.epochs,
    "optimizer_lr": cm.optimizer.lr, "device": str(cm.device),
    "losses": [h["loss"] for h in hist], "launches": launch_counts()}))
'''


class P15Block(torch.nn.Module):
    """A post-LN encoder block of plain PyTorch modules: attention without
    masks, residual, LayerNorm, the GELU FFN, residual, LayerNorm."""

    def __init__(self, d, heads, ffn):
        super().__init__()
        nn = torch.nn
        self.attn = nn.MultiheadAttention(d, heads, batch_first=True)
        self.ln1 = nn.LayerNorm(d)
        self.up = nn.Linear(d, ffn)
        # the tanh form, the one both packages' gelu op computes (an
        # nn.GELU() of the erf form imports as that op too)
        self.act = nn.GELU(approximate="tanh")
        self.down = nn.Linear(ffn, d)
        self.ln2 = nn.LayerNorm(d)

    def forward(self, h):
        a, _ = self.attn(h, h, h, need_weights=False)
        h = self.ln1(h + a)
        return self.ln2(h + self.down(self.act(self.up(h))))


class P15Bert(torch.nn.Module):
    """BERT-base as a plain-PyTorch module: token and position embeddings
    (positions a second int input), LayerNorm, `layers` blocks and an MLM
    head (dense, GELU, LayerNorm, the vocab projection)."""

    def __init__(self, vocab=BERT_VOCAB, d=BERT_D, heads=BERT_HEADS,
                 ffn=BERT_FFN, layers=BERT_LAYERS, max_pos=BERT_SEQ):
        super().__init__()
        nn = torch.nn
        self.tok = nn.Embedding(vocab, d)
        self.pos = nn.Embedding(max_pos, d)
        self.ln = nn.LayerNorm(d)
        self.blocks = nn.ModuleList(P15Block(d, heads, ffn)
                                    for _ in range(layers))
        self.mlm_dense = nn.Linear(d, d)
        self.mlm_act = nn.GELU(approximate="tanh")
        self.mlm_ln = nn.LayerNorm(d)
        self.mlm_out = nn.Linear(d, vocab)

    def forward(self, ids, pos):
        h = self.ln(self.tok(ids) + self.pos(pos))
        for blk in self.blocks:
            h = blk(h)
        return self.mlm_out(self.mlm_ln(self.mlm_act(self.mlm_dense(h))))


def _layer_list(model) -> list:
    return [(l.name, l.op_type.value, repr(sorted(l.params.items())),
             [tuple(t.shape) for t in l.outputs]) for l in model.layers]


def _fwd_err(got, want) -> dict:
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return {"max_abs_err": err, "max_abs_ref": scale,
            "rel_err": err / scale, "finite": bool(torch.isfinite(got).all())}


def _flops(model) -> float:
    from flexflow_tpu_torch.ops import get_op_def
    return sum(get_op_def(l.op_type).flop_count(l) for l in model.layers)


def p15_fx_bert(seed: int, tmpdir: str) -> dict:
    """(15a) BERT-base as a plain-PyTorch module on the card, imported by
    torch.fx: PyTorchModel -> torch_to_ff -> compile(Adam, outputs=) ->
    import_weights from the module; the logits against the module's own
    forward; Adam steps (`train_leg`: the flash kernels once a layer a
    step, non-causal, Adam once); a .ff round trip to the same layer list
    and bitwise the same logits; then phase 9d's build_bert at the same
    dtype, timed the same way."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.kernels import fused_ce
    from flexflow_tpu_torch.torch import PyTorchModel, file_to_ff

    collect_garbage()
    torch.cuda.empty_cache()
    torch.manual_seed(seed)
    module = P15Bert().cuda().eval()

    def graph():
        model = FFModel(FFConfig(batch_size=BERT_BATCH, seed=seed))
        return model, [model.create_tensor([BERT_BATCH, BERT_SEQ], "int32",
                                           name=n)
                       for n in ("input_ids", "position_ids")]

    t0 = time.perf_counter()
    pm = PyTorchModel(module)
    n_records = len(pm.torch_to_string())
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, ins = graph()
    outs = pm.torch_to_ff(model, ins)
    import_s = time.perf_counter() - t0
    cm = model.compile(AdamOptimizer(alpha=LR),
                       "sparse_categorical_crossentropy", [],
                       outputs=outs[:1])
    cm.init(seed=seed)
    t0 = time.perf_counter()
    pm.import_weights(cm)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    inputs, label = on_card(*p9_batch("bert", seed))
    with torch.no_grad():
        want = module(*(x.long() for x in inputs))
    got = cm.forward(*inputs)
    fwd = _fwd_err(got, want)
    fused_ce_admits = fused_ce.use_fused_ce(cm.loss_type, got,
                                            cm.fused_loss_mode,
                                            cm.cfg.enable_fusion)
    del want, got
    out = {"layers": len(model.layers), "fx_records": n_records,
           "trace_s": trace_s, "import_s": import_s,
           "import_weights_s": weights_s, "forward": fwd,
           "forward_tol": P15_FWD_TOL, "compute_dtype": cm.cfg.compute_dtype,
           "fused_ce_admits": bool(fused_ce_admits),
           "module_on": str(next(module.parameters()).device)}
    log(f"[15a] torch.fx BERT-base ({n_records} fx nodes traced in "
        f"{trace_s:.2f} s, {out['layers']} layers emitted in {import_s:.2f} "
        f"s, weights copied on the card in {weights_s:.3f} s): logits vs the module's forward max |err| "
        f"{fwd['max_abs_err']:.3e} of max |logit| {fwd['max_abs_ref']:.3f} "
        f"(rel {fwd['rel_err']:.3e}, tolerance {P15_FWD_TOL:g}); "
        f"use_fused_ce admits the {tuple(inputs[0].shape) + (BERT_VOCAB,)} "
        f"logits: {out['fused_ce_admits']}")
    if not fwd["finite"] or fwd["rel_err"] > P15_FWD_TOL:
        fail(f"15a: the imported BERT's logits disagree with the module: "
             f"{fwd}")
    del module
    flash = {"flash_attention_fwd": BERT_LAYERS,
             "flash_attention_dq": BERT_LAYERS,
             "flash_attention_dkv": BERT_LAYERS}
    exact = dict(flash, fused_adam=1)
    if fused_ce_admits:
        exact.update(fused_ce_fwd=1, fused_ce_bwd=1)
    out["steps"] = train_leg("15a fx bert", "bert_fx", cm, _flops(model),
                             BERT_BATCH, inputs, label, exact, seed,
                             P15_WINDOWS, P15_PER_WINDOW)
    if not out["steps"]["loss_fell"]:
        fail(f"15a: the loss did not fall: {out['steps']['losses']}")
    # the .ff round trip: the same layer list, bitwise the same logits
    path = os.path.join(tmpdir, "bert.ff")
    pm.torch_to_file(path)
    model2, ins2 = graph()
    outs2 = file_to_ff(path, model2, ins2)
    cm2 = model2.compile(AdamOptimizer(alpha=LR),
                         "sparse_categorical_crossentropy", [],
                         outputs=outs2[:1])
    cm2.load_params(cm.params)
    same_layers = _layer_list(model2) == _layer_list(model)
    bitwise = bool(torch.equal(cm2.forward(*inputs), cm.forward(*inputs)))
    out["file_round_trip"] = {"bytes": os.path.getsize(path),
                              "same_layers": same_layers,
                              "logits_bitwise": bitwise}
    log(f"[15a] .ff round trip ({out['file_round_trip']['bytes']} bytes): "
        f"same layer list {same_layers}, logits bitwise {bitwise}")
    if not (same_layers and bitwise):
        fail(f"15a: the .ff round trip differs: {out['file_round_trip']}")
    del cm, cm2, model, model2
    collect_garbage()
    torch.cuda.empty_cache()
    # phase 9d's model (build_bert, dropout 0) at this leg's dtype
    cmb, flops_b, _ = p9_model("bert", out["compute_dtype"], seed)
    out["build_bert_steps"] = train_leg(
        "15a build_bert", "bert", cmb, flops_b, BERT_BATCH, inputs, label,
        dict(flash, fused_adam=1), seed, P15_WINDOWS, P15_PER_WINDOW)
    del cmb, inputs, label
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def keras_alexnet(num_classes: int = 10):
    """examples/keras/func_cifar10_alexnet.py's stack through the port's
    Keras API: 5 conv, 3 pool, 2 fc-4096 and the softmax head at
    229 x 229."""
    from flexflow_tpu_torch.keras.layers import (Activation, Conv2D, Dense,
                                                 Flatten, Input,
                                                 MaxPooling2D)
    from flexflow_tpu_torch.keras.models import Model

    inp = Input(shape=(3, 229, 229), dtype="float32")
    x = Conv2D(filters=64, kernel_size=(11, 11), strides=(4, 4),
               padding=(2, 2), activation="relu")(inp)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2), padding="valid")(x)
    x = Conv2D(filters=192, kernel_size=(5, 5), strides=(1, 1),
               padding=(2, 2), activation="relu")(x)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2), padding="valid")(x)
    for filters in (384, 256, 256):
        x = Conv2D(filters=filters, kernel_size=(3, 3), strides=(1, 1),
                   padding=(1, 1), activation="relu")(x)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2), padding="valid")(x)
    x = Flatten()(x)
    x = Dense(4096, activation="relu")(x)
    x = Dense(4096, activation="relu")(x)
    x = Dense(num_classes)(x)
    return Model(inp, Activation("softmax")(x))


def upsample_nearest(x: np.ndarray, size: int) -> np.ndarray:
    """(N, C, h, w) -> (N, C, size, size) float32, nearest neighbour (the
    example's upsample)."""
    _, _, h, w = x.shape
    ih = (np.arange(size) * h // size).astype(np.int32)
    iw = (np.arange(size) * w // size).astype(np.int32)
    return x[:, :, ih[:, None], iw[None, :]].astype(np.float32)


def p15_keras_alexnet(seed: int) -> dict:
    """(15b) BASELINE #1 through the Keras API: `cifar10.load_data`'s
    synthetic data upsampled to 229, `Model.compile(SGD(0.01))` -> `fit`
    for 2 epochs of P15_KERAS_BATCHES batches with EpochVerifyMetrics and
    VerifyMetrics; the plain SGD kernel exactly once an update; then the
    compiled model's step by `train_leg`."""
    import warnings

    import flexflow_tpu_torch.keras.optimizers as kopt
    from flexflow_tpu_torch.keras.callbacks import (EpochVerifyMetrics,
                                                    VerifyMetrics)
    from flexflow_tpu_torch.keras.datasets import cifar10

    collect_garbage()
    torch.cuda.empty_cache()
    n = P15_KERAS_BATCH * P15_KERAS_BATCHES
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (x, y), _ = cifar10.load_data(n)
    x = upsample_nearest(x, 229) / 255.0
    y = y.astype(np.int32).reshape(-1)
    model = keras_alexnet()
    model.compile(optimizer=kopt.SGD(learning_rate=0.01),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy", "sparse_categorical_crossentropy"])
    cbs = [EpochVerifyMetrics(0.0), VerifyMetrics(0.0)]
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    hist = model.fit(x, y, batch_size=P15_KERAS_BATCH, epochs=2,
                     callbacks=cbs, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    cm = model.ffmodel.compiled
    losses = [h["loss"] for h in hist]
    # the callbacks as in JAX: the epoch one saw the target, the verify
    # one holds the last epoch's accuracy and passes at train end; a
    # verify over 100% accuracy raises there
    cbs[1].on_train_end()
    strict = VerifyMetrics(1.01)
    strict.on_epoch_end(1, hist[-1])
    try:
        strict.on_train_end()
        strict_raised = False
    except AssertionError:
        strict_raised = True
    out = {"samples": n, "synthetic": any("synthetic" in str(w.message)
                                          for w in caught),
           "layers": len(model.ffmodel.layers), "history": hist,
           "fit_wall_s": wall, "launches": counts,
           "device": str(cm.device), "compute_dtype": cm.cfg.compute_dtype,
           "epoch_verify_reached": cbs[0].reached,
           "verify_last": cbs[1].last, "strict_verify_raised": strict_raised,
           "fit_step_ms_epoch2": 1e3 * P15_KERAS_BATCH
           / hist[-1]["samples_per_sec"]}
    log(f"[15b] Keras AlexNet/CIFAR-10 on {out['device']}: "
        f"{out['layers']} layers, fit 2 epochs x {P15_KERAS_BATCHES} batches "
        f"of {P15_KERAS_BATCH} in {wall:.1f} s, losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}, accuracy "
        f"{hist[-1]['accuracy']:.4f}, epoch 2 {out['fit_step_ms_epoch2']:.2f}"
        f" ms a step, launches {counts}; EpochVerifyMetrics reached "
        f"{cbs[0].reached}, VerifyMetrics last {cbs[1].last}, a 101% "
        f"VerifyMetrics raised {strict_raised}")
    want = {k: 0 for k in counts}
    want["fused_sgd_plain"] = 2 * P15_KERAS_BATCHES
    if counts != want:
        fail(f"15b: fit launches {counts}, expected {want}")
    if not (all(np.isfinite(losses)) and out["synthetic"]
            and cbs[0].reached and cbs[1].last == hist[-1]["accuracy"]
            and strict_raised and out["device"].startswith("cuda")):
        fail(f"15b: {out}")
    inputs, label = on_card([x[:P15_KERAS_BATCH]], y[:P15_KERAS_BATCH])
    out["steps"] = train_leg("15b keras alexnet", "alexnet_keras", cm,
                             _flops(model.ffmodel), P15_KERAS_BATCH, inputs,
                             label, {"fused_sgd_plain": 1}, seed,
                             P15_WINDOWS, P15_PER_WINDOW, table_builds=(0, 0))
    del model, cm, inputs, label
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def onnx_encoder(rng, layers: int = BERT_LAYERS, b: int = BERT_BATCH,
                 s: int = BERT_SEQ, d: int = BERT_D, h: int = BERT_HEADS):
    """`layers` pre-LN encoder blocks at BERT-base's widths, op by op in
    the ONNX vocabulary of tests/test_onnx_frontend.py's transformer block
    (LayerNormalization, MatMul, Add, Split, Reshape, Transpose, Mul,
    Softmax, Erf), as {field: value} dicts for `proto.encode`. Returns
    (model dict, {name: weight array}, the plain-torch forward)."""
    from flexflow_tpu_torch.onnx import proto

    dh, f = d // h, 4 * d

    def tensor(name, arr):
        arr = np.ascontiguousarray(arr)
        dt = {np.dtype(np.float32): proto.DT_FLOAT,
              np.dtype(np.int64): proto.DT_INT64}[arr.dtype]
        return {1: [int(n) for n in arr.shape], 2: dt, 8: name,
                9: arr.tobytes()}

    def vi(name, shape):
        return {1: name, 2: {1: {1: proto.DT_FLOAT,
                                 2: {1: [{1: int(n)} for n in shape]}}}}

    def attr(name, val):
        if isinstance(val, int):
            return {1: name, 20: 2, 3: val}
        return {1: name, 20: 7, 8: [int(v) for v in val]}

    def node(op, ins, outs, name, **attrs):
        return {4: op, 1: list(ins), 2: list(outs), 3: name,
                5: [attr(k, v) for k, v in attrs.items()]}

    w, nodes, x = {}, [], "x"
    for i in range(layers):
        p = f"l{i}_"
        for k, shape in (("Wqkv", (d, 3 * d)), ("Bqkv", (3 * d,)),
                         ("Wo", (d, d)), ("Bo", (d,)), ("W1", (d, f)),
                         ("B1", (f,)), ("W2", (f, d)), ("B2", (d,))):
            w[p + k] = rng.normal(size=shape, scale=0.02).astype(np.float32)
        for k in ("g1", "g2"):
            w[p + k] = (1 + rng.normal(size=(d,), scale=0.1)
                        ).astype(np.float32)
        for k in ("be1", "be2"):
            w[p + k] = rng.normal(size=(d,), scale=0.1).astype(np.float32)
        n = lambda v: p + v  # noqa: E731
        nodes += [
            node("LayerNormalization", [x, n("g1"), n("be1")], [n("ln1")],
                 n("ln1")),
            node("MatMul", [n("ln1"), n("Wqkv")], [n("qkv0")], n("qkv")),
            node("Add", [n("qkv0"), n("Bqkv")], [n("qkv1")], n("qkv_b")),
            node("Split", [n("qkv1")], [n("q"), n("k"), n("v")], n("split"),
                 axis=2, split=[d, d, d]),
            node("Reshape", [n("q"), "hshape"], [n("q4")], n("q4")),
            node("Transpose", [n("q4")], [n("qh")], n("qh"),
                 perm=[0, 2, 1, 3]),
            node("Reshape", [n("k"), "hshape"], [n("k4")], n("k4")),
            node("Transpose", [n("k4")], [n("kh")], n("kh"),
                 perm=[0, 2, 3, 1]),
            node("Reshape", [n("v"), "hshape"], [n("v4")], n("v4")),
            node("Transpose", [n("v4")], [n("vh")], n("vh"),
                 perm=[0, 2, 1, 3]),
            node("MatMul", [n("qh"), n("kh")], [n("logits")], n("logits")),
            node("Mul", [n("logits"), "scale"], [n("scaled")], n("scale")),
            node("Softmax", [n("scaled")], [n("probs")], n("probs"),
                 axis=-1),
            node("MatMul", [n("probs"), n("vh")], [n("ctx")], n("ctx")),
            node("Transpose", [n("ctx")], [n("ctxT")], n("ctxT"),
                 perm=[0, 2, 1, 3]),
            node("Reshape", [n("ctxT"), "dshape"], [n("ctx2")], n("ctx2")),
            node("MatMul", [n("ctx2"), n("Wo")], [n("proj0")], n("proj")),
            node("Add", [n("proj0"), n("Bo")], [n("proj1")], n("proj_b")),
            node("Add", [n("proj1"), x], [n("res1")], n("res1")),
            node("LayerNormalization", [n("res1"), n("g2"), n("be2")],
                 [n("ln2")], n("ln2")),
            node("MatMul", [n("ln2"), n("W1")], [n("up0")], n("up")),
            node("Add", [n("up0"), n("B1")], [n("up1")], n("up_b")),
            node("Mul", [n("up1"), "inv_sqrt2"], [n("g_in")], n("g_in")),
            node("Erf", [n("g_in")], [n("g_erf")], n("g_erf")),
            node("Add", [n("g_erf"), "one"], [n("g_1p")], n("g_1p")),
            node("Mul", [n("up1"), n("g_1p")], [n("g_m")], n("g_m")),
            node("Mul", [n("g_m"), "half"], [n("gelu")], n("g_half")),
            node("MatMul", [n("gelu"), n("W2")], [n("down0")], n("down")),
            node("Add", [n("down0"), n("B2")], [n("down1")], n("down_b")),
            node("Add", [n("down1"), n("res1")], [n("y")], n("res2"))]
        x = n("y")
    scale = np.float32(1.0 / np.sqrt(dh))
    consts = {"hshape": np.asarray([b, s, h, dh], np.int64),
              "dshape": np.asarray([b, s, d], np.int64),
              "scale": np.asarray([scale], np.float32),
              "inv_sqrt2": np.asarray([1.0 / np.sqrt(2.0)], np.float32),
              "one": np.asarray([1.0], np.float32),
              "half": np.asarray([0.5], np.float32)}
    graph = {2: "encoder", 1: nodes,
             5: [tensor(k, v) for k, v in {**w, **consts}.items()],
             11: [vi("x", (b, s, d))], 12: [vi(x, (b, s, d))]}
    model = {1: 8, 2: "chip_smoke", 7: graph, 8: [{1: "", 2: 17}]}

    def plain(xt, t):
        """The same arithmetic in plain torch, block by block."""
        for i in range(layers):
            g = {k: t[f"l{i}_{k}"] for k in ("Wqkv", "Bqkv", "Wo", "Bo",
                                              "W1", "B1", "W2", "B2", "g1",
                                              "be1", "g2", "be2")}
            ln1 = F.layer_norm(xt, (d,), g["g1"], g["be1"])
            q, k, v = (ln1 @ g["Wqkv"] + g["Bqkv"]).split(d, dim=2)
            qh, kh, vh = (z.reshape(b, s, h, dh).permute(0, 2, 1, 3)
                          for z in (q, k, v))
            probs = torch.softmax(qh @ kh.transpose(-1, -2) * float(scale),
                                  -1)
            ctx = (probs @ vh).permute(0, 2, 1, 3).reshape(b, s, d)
            res1 = ctx @ g["Wo"] + g["Bo"] + xt
            ln2 = F.layer_norm(res1, (d,), g["g2"], g["be2"])
            xt = (F.gelu(ln2 @ g["W1"] + g["B1"]) @ g["W2"] + g["B2"]
                  + res1)
        return xt
    return model, w, plain


def p15_onnx_encoder(seed: int, tmpdir: str) -> dict:
    """(15c) 12 pre-LN blocks at BERT-base's widths written to ONNX bytes
    by the port's own encoder, read back through ONNXModel: apply ->
    compile(Adam, outputs=) -> import_weights; the forward against the same
    arithmetic in plain torch on the card; Adam steps (`train_leg`: Adam
    once a step; the attention here is MatMul/Softmax ops, no flash)."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.onnx import ONNXModel, proto

    collect_garbage()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    graph, w, plain = onnx_encoder(rng)
    path = os.path.join(tmpdir, "encoder.onnx")
    with open(path, "wb") as fh:
        fh.write(proto.encode(graph))
    del graph
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    om = ONNXModel(path)
    model = FFModel(FFConfig(batch_size=BERT_BATCH, seed=seed))
    (y,) = om.apply(model)
    import_s = time.perf_counter() - t0
    cm = model.compile(AdamOptimizer(alpha=LR), "mean_squared_error", [],
                       outputs=[y])
    cm.init(seed=seed)
    om.import_weights(cm)
    x = torch.from_numpy(rng.normal(size=(BERT_BATCH, BERT_SEQ, BERT_D))
                         .astype(np.float32)).cuda()
    target = torch.from_numpy(rng.normal(size=(BERT_BATCH, BERT_SEQ, BERT_D))
                              .astype(np.float32)).cuda()
    got = cm.forward(x)
    with torch.no_grad():
        want = plain(x, {k: torch.from_numpy(v).cuda() for k, v in w.items()})
    fwd = _fwd_err(got, want)
    ops = sorted({n.op_type for n in om.graph.node})
    out = {"file_bytes": os.path.getsize(path), "encode_s": encode_s,
           "import_s": import_s, "onnx_nodes": len(om.graph.node),
           "onnx_ops": ops, "layers": len(model.layers), "forward": fwd,
           "forward_tol": P15_ONNX_TOL,
           "compute_dtype": cm.cfg.compute_dtype}
    del got, want, om, w
    log(f"[15c] ONNX encoder ({out['onnx_nodes']} nodes of {ops}, "
        f"{out['file_bytes'] / 2**20:.0f} MiB written by the port's encoder "
        f"in {encode_s:.1f} s, read back and applied in {import_s:.1f} s to "
        f"{out['layers']} layers): forward vs plain torch max |err| "
        f"{fwd['max_abs_err']:.3e} of max |y| {fwd['max_abs_ref']:.3f} "
        f"(rel {fwd['rel_err']:.3e}, tolerance {P15_ONNX_TOL:g})")
    if not fwd["finite"] or fwd["rel_err"] > P15_ONNX_TOL:
        fail(f"15c: the imported encoder disagrees with plain torch: {fwd}")
    out["steps"] = train_leg("15c onnx encoder", "onnx_encoder", cm,
                             _flops(model), BERT_BATCH, [x], target,
                             {"fused_adam": 1}, seed, P15_WINDOWS,
                             P15_PER_WINDOW)
    if not out["steps"]["loss_fell"]:
        fail(f"15c: the loss did not fall: {out['steps']['losses']}")
    del cm, model, x, target
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def p15_launcher(tmpdir: str) -> dict:
    """(15d) `python -m flexflow_tpu_torch -b 64 --lr 0.05 -e 1 script.py
    --its-own-arg` in a subprocess on the card: the flags reach
    `get_launch_config()`, the script's own argv reaches it, the compile's
    default device is the card and its default optimizer SGD at --lr (the
    plain SGD kernel once an update), and the run exits 0."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmpdir, "launched.py")
    with open(script, "w") as fh:
        fh.write(P15_SCRIPT)
    env = {k: v for k, v in os.environ.items()
           if k not in ("FLEXFLOW_PLATFORM", "FF_LAUNCH_ARGS")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "flexflow_tpu_torch", *P15_LAUNCH_ARGS,
           script, "--its-own-arg"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=tmpdir, env=env, capture_output=True,
                         text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = [l for l in run.stdout.splitlines() if l.startswith("P15D ")]
    if run.returncode != 0 or not lines:
        fail(f"15d: the launcher exited {run.returncode}: "
             f"{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    got = json.loads(lines[-1][len("P15D "):])
    got.update(returncode=run.returncode, wall_s=wall,
               command=" ".join(["python", "-m", "flexflow_tpu_torch",
                                 *P15_LAUNCH_ARGS, "launched.py",
                                 "--its-own-arg"]))
    log(f"[15d] `{got['command']}` exited 0 in {wall:.1f} s: argv "
        f"{got['argv']}, batch {got['batch_size']}, lr "
        f"{got['learning_rate']}, epochs {got['epochs']}, device "
        f"{got['device']}, losses {got['losses']}, launches {got['launches']}")
    want = {k: 0 for k in got["launches"]}
    want["fused_sgd_plain"] = 4
    if not (got["argv"] == ["--its-own-arg"] and got["batch_size"] == 64
            and got["learning_rate"] == got["optimizer_lr"] == 0.05
            and got["epochs"] == 1 and got["device"].startswith("cuda")
            and all(np.isfinite(got["losses"]))
            and got["launches"] == want):
        fail(f"15d: {got}")
    return got


def phase15(seed: int, bert_9d: dict, alexnet_14b: dict) -> dict:
    """The frontends on the card, each at full width in the port's default
    compute dtype: 15a torch.fx BERT-base, 15b Keras AlexNet/CIFAR-10,
    15c an ONNX encoder at BERT-base's widths, 15d the launcher. cuDNN's
    autotuner is on for the phase. Each step ms is printed beside the
    phase 9d or 14b leg timed earlier in this run."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    tmpdir = tempfile.mkdtemp(prefix="ff_p15_")
    out = {}
    try:
        out["15a"] = p15_fx_bert(seed, tmpdir)
        out["15b"] = p15_keras_alexnet(seed)
        out["15c"] = p15_onnx_encoder(seed, tmpdir)
        out["15d"] = p15_launcher(tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
        torch.backends.cudnn.benchmark = bench
    card = card_line()
    a, b = out["15a"], out["15b"]
    log(f"[phase 15] {card}: 15a torch.fx BERT-base "
        f"({a['compute_dtype']}) {a['steps']['step_ms_median']:.2f} ms a "
        f"step, build_bert at {a['compute_dtype']} "
        f"{a['build_bert_steps']['step_ms_median']:.2f} ms, 9d build_bert "
        f"(bfloat16) {bert_9d['step_ms_median']:.2f} ms; 15b Keras AlexNet "
        f"({b['compute_dtype']}, 229 x 229, 10 classes) "
        f"{b['steps']['step_ms_median']:.2f} ms a step, 14b AlexNet "
        f"(bfloat16, 224 x 224, 1000 classes) "
        f"{alexnet_14b['step_ms_median']:.2f} ms; 15c ONNX encoder "
        f"{out['15c']['steps']['step_ms_median']:.2f} ms a step")
    out["beside"] = {"9d_build_bert_step_ms": bert_9d["step_ms_median"],
                     "14b_alexnet_step_ms": alexnet_14b["step_ms_median"]}
    out["wall_s"] = time.perf_counter() - t0
    log(f"[phase 15] {out['wall_s']:.1f} s on {card}")
    return out


# ------------------- phase 16: the search's remainder and the host runtime
# 16b's MCMC budgets (proposals) on the 2 x 4 search machine, additive and
# task-graph evaluated; 16d's dataset rows a gather draws from
P16_MCMC_BUDGET, P16_MCMC_TG_BUDGET, P16_GATHER_REPS = 200, 30, 20
P16_IMAGES = 128
# 13e's twin replay (trace records, spec, live report, costs, machine,
# config), kept for 16c's learned rung
_TWIN_REPLAY: dict = {}


def _p16_choices(model, st, machine):
    from flexflow_tpu_torch.search.candidates import compiled_candidate
    return {l.name: compiled_candidate(l, st, machine, {BATCH})
            for l in model.layers}


def _p16_sim(model, st, machine, cost_fn=None) -> dict:
    from flexflow_tpu_torch.search.simulator import simulate_strategy
    rep = simulate_strategy(model, _p16_choices(model, st, machine), machine,
                            cost_fn=cost_fn)
    return {"makespan_ms": 1e3 * rep.makespan,
            "exposed_comm_ms": 1e3 * rep.exposed_comm,
            "total_comm_ms": 1e3 * rep.total_comm,
            "hidden_frac": rep.hidden_frac, "tasks": len(rep.tasks)}


def p16_taskgraph(seed: int, tmpdir: str, graph_5b: dict, mc) -> tuple:
    """16a: config #5 compiled with simulator_mode="taskgraph" and
    simulator_trace on the one-card machine, its step simulated with
    analytic and measured op costs beside train_leg's eager step and
    phase 10's K-step graph step; then the 2 x 4 searches, additive and
    task-graph. Returns (summary, compiled model, inputs, label)."""
    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.compiler.compile import _search_machine
    from flexflow_tpu_torch.search.optimize import graph_optimize

    trace = os.path.join(tmpdir, "sim_trace.json")
    gc, model, cm = gpt2_train_model(seed, LAYERS, "bfloat16",
                                     simulator_mode="taskgraph",
                                     simulator_trace=trace)
    events = json.load(open(trace))["traceEvents"]
    names = {e["name"] for e in events if e.get("ph") == "X"}
    compute = [l.name for l in model.layers
               if not cm._candidate_for(l).passthrough]
    missing = [n for n in compute
               if f"{n}:fwd" not in names or f"{n}:bwd" not in names]
    if missing or not compute:
        fail(f"16a: the simulator trace lacks fwd/bwd tasks of {missing}")
    analytic = cm.export_sim_trace(os.path.join(tmpdir, "analytic.json"))
    measured = cm.export_sim_trace(os.path.join(tmpdir, "measured.json"),
                                   cost_fn=mc.op_time)
    for what, rep in (("analytic", analytic), ("measured", measured)):
        if rep.total_comm != 0.0 or rep.exposed_comm > 1e-9 * rep.makespan:
            fail(f"16a: {what} replay on one device: comm "
                 f"{rep.total_comm} s, exposed {rep.exposed_comm} s")
    ids, pos, labels = train_batch(seed, gc.vocab)
    inputs = [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]
    label = torch.from_numpy(labels).cuda()
    flash = {"flash_attention_fwd": LAYERS, "flash_attention_dq": LAYERS,
             "flash_attention_dkv": LAYERS}
    leg = train_leg("16a", "gpt2-medium", cm,
                    gc.flops_per_token() * BATCH * SEQ / 3, BATCH, inputs,
                    label, dict(flash, fused_adam=1), seed, 2, 2)
    out = {"trace_events": len(events), "compute_layers": len(compute),
           "sim_analytic_ms": 1e3 * analytic.makespan,
           "sim_measured_ms": 1e3 * measured.makespan,
           "exposed_comm_ms": 1e3 * measured.exposed_comm,
           "eager_step_ms": leg["step_ms_median"],
           "graph_step_ms_phase10": graph_5b["step_ms"]["graph"],
           "eager_step_ms_phase10": graph_5b["step_ms"]["eager"],
           "leg": leg, "launches": leg["launches"]}
    log(f"[16a] simulated step: analytic {out['sim_analytic_ms']:.2f} ms, "
        f"measured op costs {out['sim_measured_ms']:.2f} ms; measured step "
        f"eager {out['eager_step_ms']:.2f} ms, phase 10's K-step graph "
        f"{out['graph_step_ms_phase10']:.2f} ms (eager there "
        f"{out['eager_step_ms_phase10']:.2f}); exposed comm "
        f"{out['exposed_comm_ms']} ms; trace {len(events)} events, fwd and "
        f"bwd of all {len(compute)} compute layers")
    # the 2 x 4 searches, additive and task-graph
    sm = None
    out["search"] = {}
    for mode in ("additive", "taskgraph"):
        sm_model = search_model(seed, search_budget=SEARCH_BUDGET,
                                search_num_nodes=2, search_num_workers=4,
                                simulator_mode=mode, strategy_cache=False)
        sm = _search_machine(sm_model.config, cm.machine)
        t0 = time.perf_counter()
        st = graph_optimize(sm_model, sm, optimizer=AdamOptimizer(alpha=LR))
        wall = time.perf_counter() - t0
        sim = _p16_sim(sm_model, st, sm)
        out["search"][mode] = {"strategy": st.name, "search_s": wall,
                               "predicted_ms": 1e3 * st._predicted_cost,
                               "sim": sim, "json": st.to_json()}
        log(f"[16a] {mode} search of {sm.mesh_axes}: {st.name} in "
            f"{wall:.2f} s; simulated makespan {sim['makespan_ms']:.3f} ms, "
            f"hidden_frac {sim['hidden_frac']:.3f}")
    s = out["search"]
    out["rerank_changed_pick"] = s["additive"]["json"] != s["taskgraph"]["json"]
    for r in s.values():
        del r["json"]
    log(f"[16a] the task-graph re-rank changed the pick: "
        f"{out['rerank_changed_pick']}")
    out["search_machine"] = sm.to_json()
    return out, cm, inputs, label, sm, model


def p16_mcmc(seed: int, tmpdir: str, sm, unity_ms: float, machine) -> dict:
    """16b: MCMC on the 2 x 4 machine, both evaluators, each winner's
    simulated makespan beside Unity's; then MCMC on the one-card machine,
    its strategy saved, imported and trained 2 steps."""
    from flexflow_tpu_torch.search.mcmc import mcmc_optimize

    out = {}
    model = search_model(seed)
    for ev, budget in (("additive", P16_MCMC_BUDGET),
                       ("taskgraph", P16_MCMC_TG_BUDGET)):
        t0 = time.perf_counter()
        st, stats = mcmc_optimize(model, sm, budget=budget, seed=seed,
                                  evaluator=ev)
        wall = time.perf_counter() - t0
        sim = _p16_sim(model, st, sm)
        out[ev] = {"budget": budget, "wall_s": wall,
                   "stats": dataclasses.asdict(stats), "sim": sim}
        log(f"[16b] MCMC {ev} ({budget} proposals, {wall:.2f} s): "
            f"{stats.accepted} accepted, {stats.improved} improved, cost "
            f"{1e3 * stats.init_cost:.3f} -> {1e3 * stats.best_cost:.3f} ms; "
            f"simulated makespan {sim['makespan_ms']:.3f} ms against "
            f"Unity's {unity_ms:.3f} ms")
        if not stats.best_cost <= stats.init_cost:
            fail(f"16b: MCMC {ev} ended above its start: {stats}")
    st, stats = mcmc_optimize(model, machine, budget=50, seed=seed)
    path = os.path.join(tmpdir, "mcmc_one_card.json")
    st.save(path)
    collect_garbage()
    torch.cuda.empty_cache()
    losses, counts, cm = two_steps(seed, import_strategy_file=path)
    want = {n: 0 for n in counts}
    want.update(flash_attention_fwd=2 * LAYERS, flash_attention_dq=2 * LAYERS,
                flash_attention_dkv=2 * LAYERS, fused_adam=2)
    out["one_card"] = {"strategy": cm.strategy.name, "losses": losses,
                       "launches": counts}
    log(f"[16b] one-card MCMC strategy {st.name} imported: losses {losses}, "
        f"launches {counts}")
    if counts != want or not all(np.isfinite(losses)):
        fail(f"16b: launches {counts} (expected {want}), losses {losses}")
    del cm
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def _p16_fit(cm, seed: int, vocab: int) -> dict:
    from flexflow_tpu_torch import native
    ids, pos, labels = train_batch(seed, vocab, n=2 * BATCH)
    torch.cuda.synchronize()
    zero_launch_counts()
    n0 = native.gathers + native.topo_orders
    t0 = time.perf_counter()
    hist = cm.fit([ids, pos], labels, epochs=1, verbose=False, sync_every=0)
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0, "loss": hist[0]["loss"],
            "launches": launch_counts(),
            "native_calls": native.gathers + native.topo_orders - n0}


def p16_learned(seed: int, tmpdir: str, cm, mc, sm, step_ms: float) -> dict:
    """16c: a profile_ops fit of config #5 into a telemetry dir, the corpus
    and the refit; the learned search of 2 x 4; learned against measured
    op times; a refit by auto_refit and the next compile's cache miss; the
    twin with and without the learned rung."""
    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch import telemetry as tel
    from flexflow_tpu_torch.search import learned_cost as lc
    from flexflow_tpu_torch.search import memo
    from flexflow_tpu_torch.search.candidates import layer_candidates
    from flexflow_tpu_torch.search.dp import SEARCH_STATS
    from flexflow_tpu_torch.tools import refit_cost_model, span_dataset

    out = {}
    tdir = os.path.join(tmpdir, "telemetry")
    mp = os.path.join(tmpdir, "cost_model.json")
    cache = os.path.join(tmpdir, "strategy_cache")
    cm.cfg.profile_ops, cm.cfg.telemetry_dir = True, tdir
    tel.configure(tdir)
    try:
        out["profiled_fit"] = fit1 = _p16_fit(cm, seed + 3, GPT2_VOCAB)
        tel.flush()
        rows = span_dataset.build(tdir, out_path=os.path.join(
            tdir, "op_corpus.jsonl"), quiet=True)
        info = refit_cost_model.refit(tdir, model_path=mp)
        if info is None or not rows:
            fail(f"16c: the profiled fit gave {len(rows)} corpus rows, "
                 f"refit {info}")
        model = lc.LearnedCostModel.load(mp)
        out["corpus_rows"], out["refit"] = len(rows), info
        log(f"[16c] profiled fit {fit1['wall_s']:.1f} s, loss "
            f"{fit1['loss']:.4f}, launches {fit1['launches']}, native "
            f"calls {fit1['native_calls']}; corpus {len(rows)} rows; "
            f"refit {info['rows']} rows, kinds {info['kinds']}, model "
            f"{info['path']} [{info['fingerprint']}]")
        if fit1["native_calls"] != 0:
            fail(f"16c: the fit made {fit1['native_calls']} native calls")
        if min(fit1["launches"][n] for n in (
                "flash_attention_fwd", "flash_attention_dq",
                "flash_attention_dkv", "fused_adam")) <= 0:
            fail(f"16c: the profiled fit launched {fit1['launches']}")

        def learned_search(tag):
            e0 = dict(SEARCH_STATS)
            m = search_model(seed, search_budget=SEARCH_BUDGET,
                             search_num_nodes=2, search_num_workers=4,
                             simulator_mode="learned", cost_model_path=mp,
                             strategy_cache_dir=cache)
            c = m.compile(AdamOptimizer(alpha=LR),
                          "sparse_categorical_crossentropy", [])
            st, lrn = c.strategy, c.strategy._learned
            r = {"strategy": st.name, "event": c.search_cache_info["event"],
                 "coverage": lrn.coverage(), "hits": lrn.hits,
                 "misses": lrn.misses,
                 "fingerprint": lrn.model.fingerprint,
                 "predicted_ms": 1e3 * st._predicted_cost,
                 **{k: SEARCH_STATS[k] - e0.get(k, 0) for k in
                    ("calls", "expansions", "cands_pruned",
                     "finalists_pruned")}}
            log(f"[16c] {tag}: learned search of {sm.mesh_axes} "
                f"({r['event']}): {st.name}; coverage {r['coverage']}, "
                f"hits {r['hits']}, misses {r['misses']}, candidates "
                f"pruned {r['cands_pruned']}, finalists pruned "
                f"{r['finalists_pruned']}, {r['expansions']} expansions; "
                f"model {mp} [{r['fingerprint']}]")
            del c
            return r
        out["search"] = s1 = learned_search("16c")
        if not (s1["coverage"] or 0) > 0 or s1["event"] != "store":
            fail(f"16c: the learned tier was not live: {s1}")
        # learned against measured op times on the one-card machine
        machine = cm.machine
        distinct = {}
        for layer in cm.model.layers:
            key = (layer.params_key(),
                   memo.freeze_weight_specs(layer.weight_specs))
            distinct.setdefault(key, layer)
        learned = lc.LearnedCost(model, machine)
        ridge = lc.LearnedCost(lc.LearnedCostModel(model.kinds, {},
                                                   model.meta), machine)
        pairs, ridge_pairs, per_op = [], [], []
        for layer in distinct.values():
            cand = layer_candidates(layer, machine, {BATCH})[0]
            if cand.passthrough:
                continue
            meas = mc.op_time(layer, cand)
            got, hit = learned._predict(layer, cand)
            rg, rhit = ridge._predict(layer, cand)
            pairs.append((got, meas))
            if rhit:
                ridge_pairs.append((rg, meas))
            per_op.append({"op": layer.name, "kind": layer.op_type.value,
                           "measured_ms": 1e3 * meas,
                           "learned_ms": 1e3 * got, "learned_hit": hit,
                           "ridge_ms": 1e3 * rg if rhit else None,
                           "analytic_ms": 1e3 * cand.op_time(layer,
                                                             machine)})
        out["ops"] = per_op
        out["mape"] = lc.mape(pairs)
        out["mape_ridge_only"] = lc.mape(ridge_pairs)
        pred = {"analytic_ms": 1e3 * cm.predicted_step_time(),
                "measured_ms": 1e3 * cm.predicted_step_time(
                    cost_fn=mc.op_time),
                "learned_ms": 1e3 * cm.predicted_step_time(
                    cost_fn=learned.op_time),
                "learned_sim_ms": 1e3 * cm.export_sim_trace(
                    os.path.join(tmpdir, "learned.json"),
                    cost_fn=learned.op_time).makespan}
        out["prediction"] = {**pred, "step_ms": step_ms, **{
            k.replace("_ms", "_over_step"): v / step_ms
            for k, v in pred.items()}}
        log(f"[16c] learned against measured op times over {len(pairs)} "
            f"distinct ops: MAPE {out['mape']:.4f} (the exact table), ridge "
            f"alone {out['mape_ridge_only']} over {len(ridge_pairs)}; "
            f"predicted step against the measured {step_ms:.2f} ms: "
            + ", ".join(f"{k} {v:.2f} ms (x{v / step_ms:.3f})"
                        for k, v in pred.items()))
        for r in per_op:
            log(f"[16c op] {r['op']} ({r['kind']}): measured "
                f"{r['measured_ms']:.4f} ms, learned {r['learned_ms']:.4f} "
                f"ms ({'exact' if r['learned_hit'] else 'analytic'}), ridge "
                f"{r['ridge_ms']}, analytic {r['analytic_ms']:.4f} ms")
        # auto_refit: the next fit refits the model at its end
        cm.cfg.auto_refit, cm.cfg.cost_model_path = True, mp
        out["auto_refit_fit"] = fit2 = _p16_fit(cm, seed + 4, GPT2_VOCAB)
        fit2["refit_info"] = cm.refit_info
        log(f"[16c] auto_refit fit {fit2['wall_s']:.1f} s, launches "
            f"{fit2['launches']}, refit {cm.refit_info}")
        if cm.refit_info is None or not os.path.exists(mp):
            fail("16c: auto_refit wrote no model")
        out["search_after_refit"] = s2 = learned_search("16c after refit")
        if s2["fingerprint"] == s1["fingerprint"] or s2["event"] != "store" \
                or s2["expansions"] <= 0:
            fail(f"16c: after the refit: {s2} (before: {s1})")
    finally:
        cm.cfg.profile_ops = cm.cfg.auto_refit = False
        cm.cfg.telemetry_dir = cm.cfg.cost_model_path = ""
        tel.shutdown()
    out["twin"] = p16_twin_rung(tmpdir)
    return out


def p16_twin_rung(tmpdir: str) -> dict:
    """16c: 13e's replay priced again with the learned rung, the model
    refit from the twin's own residual rows against the live run (a
    finding, not a gate)."""
    from flexflow_tpu_torch import telemetry as tel
    from flexflow_tpu_torch.serving import twin
    from flexflow_tpu_torch.tools import refit_cost_model

    records, spec, live_rep, costs0, machine, cfg = (
        _TWIN_REPLAY[k] for k in ("records", "spec", "live", "costs",
                                  "machine", "cfg"))
    tdir = os.path.join(tmpdir, "twin_telemetry")
    mp = os.path.join(tmpdir, "twin_model.json")
    tel.configure(tdir)
    try:
        n = twin.emit_residual_rows(live_rep, costs0, spec.kv_spec(),
                                    spec.slots, machine)
        tel.flush()
    finally:
        tel.shutdown()
    info = refit_cost_model.refit(tdir, model_path=mp)
    costs = twin.TwinCosts.resolve(
        spec.kv_spec(), cfg=dataclasses.replace(cfg, cost_model_path=mp),
        machine=machine, live_report=live_rep, slots=spec.slots)
    costs.window_overhead_s = costs0.window_overhead_s
    live = live_rep["stats"]["tokens_per_s"]
    out = {"rows_emitted": n, "refit": info, "source": costs.source,
           "live_tokens_per_s": live}
    for tag, c in (("without", costs0), ("with", costs)):
        res = twin.simulate(records, spec, c)
        tps = res.report()["stats"]["tokens_per_s"]
        out[f"{tag}_learned"] = {"tokens_per_s": tps,
                                 "rel_err": (tps - live) / live,
                                 "decode_step_ms": 1e3 * c.decode_step_s,
                                 "prefill_ms": 1e3 * c.prefill_base_s}
    log(f"[16c twin] {n} residual rows, refit {info and info['kinds']}, "
        f"rung {costs.source}: twin tokens/s against live {live:.1f}: "
        f"without the learned rung {out['without_learned']['tokens_per_s']:.1f}"
        f" ({100 * out['without_learned']['rel_err']:+.1f}%), with it "
        f"{out['with_learned']['tokens_per_s']:.1f} "
        f"({100 * out['with_learned']['rel_err']:+.1f}%)")
    if costs.source != "learned":
        fail(f"16c: the twin's learned rung did not price: {costs.source}")
    return out


def p16_native(model) -> dict:
    """16d: batch_gather bitwise against numpy's index at the GPT-2 batch
    and an image batch, timed against it; the native order of GPT-2
    medium's graph against the Python walk."""
    from flexflow_tpu_torch import native
    from flexflow_tpu_torch.core import graph

    rng = np.random.default_rng(16)
    out = {"library": str(native.library_path())}
    cases = {"gpt2_tokens_b8x1024_int32": (
        rng.integers(0, GPT2_VOCAB, size=(8 * BATCH, SEQ)).astype(np.int32),
        BATCH),
             "images_64x3x224x224_f32": (
        rng.standard_normal((P16_IMAGES, 3, IMAGE_HW, IMAGE_HW),
                            dtype=np.float32), IMAGE_BATCH)}
    for name, (data, n) in cases.items():
        idx = rng.permutation(data.shape[0])[:n]
        got = native.batch_gather(data, idx)
        if got.tobytes() != data[idx].tobytes():
            fail(f"16d: batch_gather differs from numpy's index at {name}")
        times = {}
        for how, fn in (("native", lambda: native.batch_gather(data, idx)),
                        ("numpy", lambda: data[idx])):
            ts = []
            for _ in range(P16_GATHER_REPS):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            times[how] = 1e3 * float(np.median(ts))
        out[name] = {"bytes": int(got.nbytes), "native_ms": times["native"],
                     "numpy_ms": times["numpy"]}
        log(f"[16d] {name}: bitwise numpy's index; {got.nbytes} bytes, "
            f"native {times['native']:.4f} ms, numpy {times['numpy']:.4f} ms "
            f"(median of {P16_GATHER_REPS}, host clock)")
    layers = list(model.layers)
    t0 = native.topo_orders
    order = [l.name for l in native.topo_order(layers)]
    if native.topo_orders != t0 + 1 or order != [
            l.name for l in graph.topo_order(layers)]:
        fail("16d: the native order of GPT-2 medium's graph differs from "
             "the Python walk's (or was not taken)")
    times = {}
    for how, fn in (("native", lambda: native.topo_order(layers)),
                    ("python", lambda: graph.topo_order(layers))):
        ts = []
        for _ in range(P16_GATHER_REPS):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        times[how] = 1e3 * float(np.median(ts))
    out["topo"] = {"layers": len(order), "native_ms": times["native"],
                   "python_ms": times["python"]}
    log(f"[16d] native topological order of GPT-2 medium's {len(order)} "
        f"layers equals the Python walk's; native {times['native']:.4f} ms, "
        f"Python {times['python']:.4f} ms (median of {P16_GATHER_REPS}, "
        "host clock)")
    return out


def p16_jupyter(tmpdir: str) -> dict:
    """16e: a kernelspec installed into a temporary prefix from a
    reference-format config; a process with its environment parses the
    flags and fits an MLP on the card; the port's quickstart cells run on
    the card."""
    from flexflow_tpu_torch.jupyter import notebook_cells
    from flexflow_tpu_torch.jupyter.install import install

    cfg = os.path.join(tmpdir, "flexflow_jupyter.json")
    with open(cfg, "w") as f:
        json.dump({"name": "FlexFlow torch (H100)",
                   "batch_size": {"cmd": "-b", "value": 64},
                   "epochs": {"cmd": "-e", "value": 2},
                   "budget": {"cmd": "--budget", "value": 0},
                   "platform": {"value": "gpu"},
                   "fbmem": {"cmd": "-ll:fsize", "value": 4096}}, f)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kdir = install(config=cfg, prefix=os.path.join(tmpdir, "jupyter"),
                       mute=True)
    spec = json.load(open(os.path.join(kdir, "kernel.json")))
    script = (
        "import json, numpy as np\n"
        "from flexflow_tpu_torch import FFConfig, FFModel\n"
        "from flexflow_tpu_torch.kernels import launch_counts\n"
        "cfg = FFConfig.parse_args()\n"
        "m = FFModel(cfg)\n"
        "x = m.create_tensor([cfg.batch_size, 784], name='x')\n"
        "m.dense(m.dense(x, 512, activation='relu'), 10)\n"
        "cm = m.compile(None, 'sparse_categorical_crossentropy', [])\n"
        "rng = np.random.default_rng(0)\n"
        "h = cm.fit(rng.standard_normal((256, 784), dtype=np.float32), "
        "rng.integers(0, 10, 256).astype(np.int32), verbose=False)\n"
        "print(json.dumps({'batch_size': cfg.batch_size, 'epochs': len(h), "
        "'device': str(cm.device), 'loss': [r['loss'] for r in h], "
        "'launches': launch_counts()}))\n")
    env = {**os.environ, **spec["env"],
           "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"16e: the kernel-environment process failed:\n"
             f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["wall_s"] = time.perf_counter() - t0
    res["ff_launch_args"] = spec["env"]["FF_LAUNCH_ARGS"]
    log(f"[16e] kernelspec {kdir}: FF_LAUNCH_ARGS "
        f"{res['ff_launch_args']!r}, FLEXFLOW_PLATFORM "
        f"{spec['env'].get('FLEXFLOW_PLATFORM')}; the process read batch "
        f"{res['batch_size']}, {res['epochs']} epochs, ran on "
        f"{res['device']}, losses {res['loss']}, launches {res['launches']} "
        f"({res['wall_s']:.1f} s)")
    if (res["batch_size"], res["epochs"]) != (64, 2) or not res[
            "device"].startswith("cuda") or res["launches"][
            "fused_sgd_plain"] != 2 * 256 // 64:
        fail(f"16e: the kernel environment gave {res}")
    out = {"kernel_env": res}
    argv = sys.argv
    sys.argv = ["kernel"]
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        ns = {}
        for src in notebook_cells(tag="one-device"):
            exec(compile(src, "<quickstart-cell>", "exec"), ns)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    hist = ns["history"]
    out["quickstart"] = {"device": str(ns["cm"].device),
                         "loss": [h["loss"] for h in hist],
                         "accuracy": hist[-1]["accuracy"],
                         "wall_s": time.perf_counter() - t0,
                         "launches": launch_counts()}
    log(f"[16e] quickstart on {ns['cm'].device}: losses "
        f"{out['quickstart']['loss']}, accuracy {hist[-1]['accuracy']:.3f}, "
        f"launches {out['quickstart']['launches']}")
    if ns["cm"].device.type != "cuda" or not hist[-1]["loss"] < hist[0][
            "loss"] or out["quickstart"]["launches"]["fused_sgd_plain"] <= 0:
        fail(f"16e: the quickstart gave {out['quickstart']}")
    del ns
    out["quickstart_mesh"] = p16_quickstart_mesh()
    return out


# 16e's mesh cells: the kernel's mesh, two gloo ranks sharing the card
P16_MESH_ARGS = "--mesh data=1,model=2"


def p16_counted(cfg, ref, *args):
    """A rank of 16e's mesh cells: the cell's function, then every rank's
    launch counts (gathered to all)."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.jupyter import _function
    from flexflow_tpu_torch.kernels import launch_counts

    out = _function(ref)(cfg, *args)
    torch.cuda.synchronize()
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, launch_counts())
    out["launches_by_rank"] = counts
    return out


def p16_quickstart_mesh() -> dict:
    """16e's mesh cells as a kernel with `P16_MESH_ARGS` runs them: the
    notebook's `run_over_mesh` starts two gloo ranks on the card (NCCL
    refuses two ranks on one card); each rank's launches are read by
    `p16_counted` around the cell's function."""
    import linecache

    from flexflow_tpu_torch import jupyter as jup
    from flexflow_tpu_torch.jupyter import notebook_cells

    real = jup.run_over_mesh

    def counted(fn, cfg, *args, **kw):
        return real(p16_counted, cfg, jup._function_ref(fn), *args, **kw)
    saved = {k: os.environ.get(k) for k in ("FF_LAUNCH_ARGS",
                                            "FLEXFLOW_PLATFORM")}
    argv = sys.argv
    os.environ.update(FF_LAUNCH_ARGS=P16_MESH_ARGS, FLEXFLOW_PLATFORM="gpu")
    sys.argv, jup.run_over_mesh = ["kernel"], counted
    t0 = time.perf_counter()
    try:
        ns = {}
        for i, src in enumerate(notebook_cells(tag="mesh")):
            # as IPython runs a cell: its source kept for inspect, which
            # reads back the function the cell hands run_over_mesh
            name = f"<quickstart-mesh-cell-{i}>"
            linecache.cache[name] = (len(src), None, src.splitlines(True),
                                     name)
            exec(compile(src, name, "exec"), ns)
    finally:
        sys.argv, jup.run_over_mesh = argv, real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    mesh, steps = ns["mesh"], 3 * 1024 // 64
    views = {w: [(d.size, d.degree, list(d.axes)) for d in dims]
             for w, dims in mesh["views"].items()}
    res = {"mesh": dict(ns["mcfg"].mesh_shape),
           "strategy": mesh["strategy"], "device": mesh["device"],
           "views": views, "loss": [h["loss"] for h in mesh["history"]],
           "accuracy": mesh["history"][-1]["accuracy"],
           "ops": {n: mesh["strategy_json"]["ops"][n]
                   for n in ("up", "down", "head")},
           "launches_by_rank": mesh["launches_by_rank"],
           "wall_s": time.perf_counter() - t0}
    log(f"[16e] quickstart's mesh cells over {res['mesh']} ({P16_MESH_ARGS!r}"
        f", two gloo ranks on {res['device']}): {res['strategy']}; up's "
        f"views {views}; losses {res['loss']}, accuracy "
        f"{res['accuracy']:.3f}; #8 (fused_sgd_plain) a rank "
        f"{[c['fused_sgd_plain'] for c in res['launches_by_rank']]} "
        f"({res['wall_s']:.1f} s)")
    sharded = any(d[1] > 1 for dims in views.values() for d in dims)
    if not res["device"].startswith("cuda") or not sharded or \
            not res["loss"][-1] < res["loss"][0] or \
            [c["fused_sgd_plain"] for c in res["launches_by_rank"]] != \
            [steps] * 2:
        fail(f"16e: the quickstart's mesh cells gave {res}")
    return res


def p16_capi(tmpdir: str) -> dict:
    """16f: the C API library built, examples/c/mlp_train.c compiled
    against it into build/flexflow_tpu_torch/, run on the card."""
    from flexflow_tpu_torch.capi import LAUNCH_COUNTS_ENV, build

    t0 = time.perf_counter()
    lib = build.build_lib()
    exe = build.build_example()
    built = time.perf_counter() - t0
    counts_path = os.path.join(tmpdir, "capi_counts.json")
    t0 = time.perf_counter()
    text = build.run_example(None, batch=32,
                             extra_env={LAUNCH_COUNTS_ENV: counts_path})
    wall = time.perf_counter() - t0
    counts = json.load(open(counts_path))
    m = re.search(r"epoch0_loss=([\d.]+) final_loss=([\d.]+)", text)
    out = {"library": str(lib), "example": str(exe), "build_s": built,
           "run_s": wall, "stdout": text, "launches": counts,
           "losses": [float(m.group(1)), float(m.group(2))] if m else None}
    log(f"[16f] C API {lib} and {exe} built in {built:.1f} s; the example "
        f"ran in {wall:.1f} s on the card: "
        + " | ".join(text.strip().splitlines()) + f"; launches {counts}")
    want = {n: 0 for n in counts}
    want["fused_sgd_plain"] = 5 * 256 // 32
    if ("C_API_OK" not in text or "forward_ok dims=2 (32, 4)" not in text
            or m is None or not out["losses"][1] < out["losses"][0]
            or counts != want):
        fail(f"16f: the C example gave {out} (launches expected {want})")
    return out


def phase16(seed: int, graph_5b: dict) -> dict:
    """Phase 16: the task-graph simulator, MCMC, the learned tier and its
    refit loop on config #5, then the native core, the Jupyter kernel and
    the C API, in a temporary directory removed at the end."""
    import shutil
    import tempfile

    from flexflow_tpu_torch.compiler.compile import resolve_machine
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.search.measure import MeasuredCost

    t_phase = time.perf_counter()
    tmpdir = tempfile.mkdtemp(prefix="ff_p16_")
    out, walls = {}, {}
    try:
        machine = resolve_machine(FFConfig())
        mc = MeasuredCost(machine, cache_dir="", device="cuda",
                          compute_dtype="bfloat16")
        t0 = time.perf_counter()
        out["16a"], cm, inputs, label, sm, model = p16_taskgraph(
            seed, tmpdir, graph_5b, mc)
        walls["16a"] = time.perf_counter() - t0
        del inputs, label
        t0 = time.perf_counter()
        out["16c"] = p16_learned(seed, tmpdir, cm, mc, sm,
                                 out["16a"]["eager_step_ms"])
        walls["16c"] = time.perf_counter() - t0
        del cm
        collect_garbage()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["16b"] = p16_mcmc(seed, tmpdir, sm, out["16a"]["search"][
            "additive"]["sim"]["makespan_ms"], machine)
        walls["16b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["16d"] = p16_native(model)
        walls["16d"] = time.perf_counter() - t0
        del model
        t0 = time.perf_counter()
        out["16e"] = p16_jupyter(tmpdir)
        walls["16e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["16f"] = p16_capi(tmpdir)
        walls["16f"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    collect_garbage()
    torch.cuda.empty_cache()
    card = card_line()
    out["wall_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    out["measured_cost"] = mc  # phase 22's calibrate reuses its cache
    log(f"[phase 16] {out['wall_s']:.1f} s on {card} ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return out


# ---------------------------------- phase 17: multi-GPU, first part
# 17b's ranks against 17a's world-1 run: the same weights and global batch
# in bf16 compute, each rank's rows and the gradients' all-reduce in
# another order (a relative tolerance on each of the 3 losses)
P17_STEPS = 3
# 17b's legs take 2 steps of 17a's 3 (the losses held to world 1's first
# two): the time limit's cut for phase 20
P17B_STEPS = 2
P17_LOSS_RTOL = 5e-3
P17_TIMEOUT_S = 600
P17_MESH = {"data": 1}
# the collectives 17b probes on CUDA tensors over gloo: c10d's (the
# port's own calls: the grad norm's all-reduce, ZeRO's all-gather, the
# expert all-to-alls, the placed fork-join's joins; point to point, and
# the all-to-all with one nonzero split each way that the rings' hop is)
# and the functional ones DTensor's redistributions call. The functional
# ones, the point-to-point ones and the port's hop (`ring_shift`) run
# each in a pair of processes of its own, since a crash or a hang takes
# only that pair
P17_C10D = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
            "reduce_scatter_tensor", "all_to_all_single", "isend/irecv",
            "batch_isend_irecv", "all_to_all_single uneven")
P17_FUNCTIONAL = ("all_reduce", "reduce_scatter_tensor",
                  "all_gather_into_tensor")
P17_PAIRED = (tuple(f"functional {w}" for w in P17_FUNCTIONAL)
              + tuple(f"c10d {w}" for w in P17_C10D[6:]) + ("port ring_shift",))
P17_PAIR_DEADLINE_S = 120
# 17b's legs: (mesh, zero_sharding, Megatron tensor parallelism over
# "model", the collectives gloo must carry for it): the gradients'
# pending sums all-reduced (and the loss's; the grad norm's by c10d);
# under ZeRO reduce-scattered to the moments and the params all-gathered
# by c10d; under tensor parallelism DTensor gathers the activations too
_DP = ("functional all_reduce", "c10d all_reduce")
_ZERO = _DP + ("functional reduce_scatter_tensor",
               "c10d all_gather_into_tensor")
P17_LEGS = {"data2 zero off": ({"data": 2}, "off", False, _DP),
            "data2 zero1": ({"data": 2}, "zero1", False, _ZERO),
            "data2 zero2": ({"data": 2}, "zero2", False, _ZERO),
            "model2 megatron": ({"data": 1, "model": 2}, "off", True,
                                _ZERO + ("functional all_gather_into_tensor",))}
# 17c's script: the launcher's config, a 2-step fit of an MLP on the card
# over the mesh the command line names
P17_SCRIPT = r'''
import json
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
import flexflow_tpu_torch as ff
from chip_smoke import launch_counts, zero_launch_counts

cfg = ff.get_launch_config()
m = ff.FFModel(cfg)
x = m.create_tensor([cfg.batch_size, 784], name="x")
m.dense(m.dense(x, 512, activation="relu", name="h"), 10, name="out")
cm = m.compile(None, "sparse_categorical_crossentropy", [])
rng = np.random.default_rng(0)
xs = rng.normal(size=(2 * cfg.batch_size, 784)).astype(np.float32)
ys = rng.integers(0, 10, size=(2 * cfg.batch_size,)).astype(np.int32)
cm.init(seed=0)
zero_launch_counts()
hist = cm.fit(xs, ys, verbose=False)
torch.cuda.synchronize()
print("P17C " + json.dumps({
    "world": dist.get_world_size(), "backend": str(dist.get_backend()),
    "mesh": dict(zip(cm.mesh.mesh_dim_names, cm.mesh.mesh.shape)),
    "dtensor": isinstance(cm.params["h"]["kernel"], DTensor),
    "device": str(cm.device), "updates": cm._iteration,
    "loss": hist[-1]["loss"], "launches": launch_counts()}), flush=True)
'''


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def p17_steps(cm, seed: int, vocab: int, n: int = P17_STEPS) -> list:
    """n train steps on 5b's batch (the full arrays: over a mesh each rank
    takes its rows), the losses read after the last."""
    ids, pos, labels = train_batch(seed, vocab)
    losses = []
    for _ in range(n):
        (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, [ids, pos], labels)
        losses.append(loss)
    return [float(x) for x in losses]


def p17_digest(cm) -> list:
    """Two int64 sums of each f32 param's bits, taken on the card, over
    the full params as this rank holds them (a replicated weight its own
    copy, a sharded one gathered): the plain sum and the sum weighted by
    position, so ranks whose bits differ anywhere read other sums."""
    out = []
    for l in sorted(cm.params):
        for w in sorted(cm.params[l]):
            t = cm.params[l][w].detach()
            t = t.full_tensor() if hasattr(t, "full_tensor") else t
            b = t.contiguous().view(torch.int32).flatten().long()
            at = torch.arange(1, b.numel() + 1, device=b.device)
            out.append((int(b.sum()), int((b * at).sum())))
    return out


def p17_graph(cm, gc, seed: int) -> dict:
    """17a's K-step CUDA graph over the mesh (phase 10's leg, lean: the
    mesh's eager step is host bound): from one snapshot, K eager steps
    and one dispatch of K, bitwise equal; a profiled dispatch (one
    cudaGraphLaunch, the port's kernels K steps' worth, the NCCL kernels);
    eager against graph in turns; one fit epoch of 2K + 1 batches at K
    (the loader's rows, step_stats as JAX counts them, no new capture)."""
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.compiler import graph_steps

    k, base = GRAPH_K, ff_random.key(seed + 17)
    ids, pos, labels = train_batch(seed + 31, gc.vocab, k * BATCH)
    xs = [torch.from_numpy(a.reshape(k, BATCH, -1)).cuda() for a in (ids, pos)]
    y = torch.from_numpy(labels.reshape(k, BATCH, -1)).cuda()
    snap = _snapshot(cm)
    it0 = snap[3]

    def eager():
        losses = []
        for i in range(k):
            (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
                cm.params, cm.opt_state, cm.state, [x[i] for x in xs], y[i],
                ff_random.fold_in(base, it0 + i))
            losses.append(loss)
        return sum(losses[1:], losses[0]) / k

    def dispatch():
        (cm.params, cm.opt_state, cm.state, loss, _) = multi(
            cm.params, cm.opt_state, cm.state, xs, y, base, it0)
        return loss

    want = float(eager())
    eager_params = _tree_copy(cm.params)
    _restore(cm, snap)
    caps0 = graph_steps.captures
    zero_launch_counts()
    multi = cm._get_multi(k)
    got = float(dispatch())
    torch.cuda.synchronize()
    out = {"k": k, "eager_mean": want, "graph_mean": got,
           "launches": launch_counts(),
           "graph_vs_eager_max_abs": _tree_diff(cm.params, eager_params),
           "captures": graph_steps.captures - caps0,
           "capture_s": multi.capture_s, "graph_pool_bytes": multi.pool_bytes}
    del eager_params
    prof = _device_profile(dispatch, 1, cm.device, lead=dispatch)
    out["profile_graph"] = prof
    timed = {}
    for name, fn in (("eager", eager), ("graph", dispatch),
                     ("graph_again", dispatch), ("eager_again", eager)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        timed[name] = 1e3 * (time.perf_counter() - t0) / k
    out["step_ms"] = timed
    ids2, pos2, labels2 = train_batch(seed + 37, gc.vocab, (2 * k + 1) * BATCH)
    _restore(cm, snap)
    zero_launch_counts()
    caps0 = graph_steps.captures
    ahead, cm.cfg.dispatch_ahead = cm.cfg.dispatch_ahead, 2
    try:
        hist = cm.fit([ids2, pos2], labels2, epochs=1, verbose=False,
                      sync_every=0, steps_per_dispatch=k)
    finally:
        cm.cfg.dispatch_ahead = ahead
    torch.cuda.synchronize()
    out["fit"] = {"step_stats": dict(cm.step_stats), "launches":
                  launch_counts(), "captures": graph_steps.captures - caps0,
                  "loss": hist[0]["loss"]}
    pk = {n: v["launches_per_call"] for n, v in
          prof.get("port_kernels", {}).items()}
    log(f"[17a graph] K={k}: eager mean {want}, graph {got}, params max "
        f"|dp| {out['graph_vs_eager_max_abs']:.3e}; capture "
        f"{multi.capture_s:.2f} s, pool {multi.pool_bytes / 2**20:.0f} MiB; "
        f"profile: {prof.get('graph_launches_per_call')} cudaGraphLaunch, "
        f"the port's kernels {pk}, NCCL kernels "
        f"{prof.get('nccl_kernels')}, idle "
        f"{prof.get('device_idle_share', float('nan')):.3f}; step ms "
        f"(eager, graph, graph, eager) {timed}; fit {out['fit']}")
    per_step = {"flash_fwd_tc_kernel": LAYERS, "flash_dq_tc_kernel": LAYERS,
                "flash_dkv_tc_kernel": LAYERS, "adam_kernel": 1}
    stats = {"dispatches": 3, "host_syncs": 0, "barriers": 1,
             "fused_steps": 2 * k}
    if got != want or out["graph_vs_eager_max_abs"] != 0 or \
            out["captures"] != 1 or \
            prof.get("graph_launches_per_call") != 1 or \
            pk != {n: k * c for n, c in per_step.items()} or \
            out["fit"]["step_stats"] != stats or out["fit"]["captures"] or \
            not np.isfinite(out["fit"]["loss"]):
        fail(f"17a graph: {out}")
    return out


def p17_world1(seed: int, graph_5b: dict) -> dict:
    """17a: the process group started from torchrun's environment at world
    1 (NCCL), config #5 compiled over {"data": 1} through the DeviceMesh
    and DTensor path against the plain compile, in this process."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from flexflow_tpu_torch.runtime.distributed import (backend_name,
                                                        init_distributed)

    t0 = time.perf_counter()
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    init_distributed()
    if backend_name() != "nccl":
        fail(f"17a: backend {backend_name()}, expected nccl on the card")
    gc, _, plain = gpt2_train_model(seed, LAYERS, "bfloat16")
    _, _, mesh = gpt2_train_model(seed, LAYERS, "bfloat16",
                                  mesh_shape=P17_MESH)
    wte = mesh.params["wte"]["kernel"]
    if not (dist.is_initialized() and mesh.mesh is not None
            and isinstance(wte, DTensor) and plain.mesh is None):
        fail(f"17a: the mesh path is not live (group "
             f"{dist.is_initialized()}, mesh {mesh.mesh}, wte "
             f"{type(wte).__name__})")
    same_init = all(torch.equal(_loc(mesh.params[l][w]), plain.params[l][w])
                    for l in plain.params for w in plain.params[l])
    out = {"backend": backend_name(), "mesh": P17_MESH,
           "wte_placements": str(wte.placements),
           "init_bitwise_equal": same_init}
    runs = {}
    for tag, cm in (("plain", plain), ("mesh", mesh)):
        zero_launch_counts()
        runs[tag] = {"losses": p17_steps(cm, seed, gc.vocab),
                     "launches": launch_counts()}
    out["runs"] = runs
    # 18b holds its ring at world 1 to these params
    out["plain_digest"] = p17_digest(plain)
    lp, lm = runs["plain"]["losses"], runs["mesh"]["losses"]
    out["losses_bitwise_equal"] = lp == lm
    out["params_bitwise_equal"] = _tree_diff(mesh.params, plain.params) == 0
    log(f"[17a] world 1 over {P17_MESH} ({backend_name()}), wte "
        f"{wte.placements}: init bitwise {same_init}; losses plain {lp}, "
        f"mesh {lm}: bitwise {lp == lm}; params after {P17_STEPS} steps "
        f"bitwise {out['params_bitwise_equal']}; launches plain "
        f"{runs['plain']['launches']}, mesh {runs['mesh']['launches']}")
    want = {n: 0 for n in runs["mesh"]["launches"]}
    want.update(flash_attention_fwd=LAYERS * P17_STEPS,
                flash_attention_dq=LAYERS * P17_STEPS,
                flash_attention_dkv=LAYERS * P17_STEPS,
                fused_adam=P17_STEPS)
    if not same_init or lp != lm or not out["params_bitwise_equal"] or \
            runs["mesh"]["launches"] != want or \
            runs["plain"]["launches"] != want:
        fail(f"17a: the mesh path at world 1 differs from the plain "
             f"compile: {out}")
    # the host's cost: eager steps in turns, then a profiled step of each
    ids, pos, labels = train_batch(seed, gc.vocab)
    dev_in = [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]
    dev_lab = torch.from_numpy(labels).cuda()

    def stepper(cm):
        def step():
            (cm.params, cm.opt_state, cm.state, _, _) = cm.train_step(
                cm.params, cm.opt_state, cm.state, dev_in, dev_lab)
        return step

    steps = {"plain": stepper(plain), "mesh": stepper(mesh)}
    times = {"plain": [], "mesh": []}
    for _ in range(2):
        for tag, fn in steps.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            fn()
            torch.cuda.synchronize()
            times[tag].append(1e3 * (time.perf_counter() - t1) / 2)
    out["eager_step_ms"] = {t: float(np.median(v)) for t, v in times.items()}
    out["eager_step_ms_pairs"] = times
    profs = {t: _device_profile(fn, 1, plain.device, lead=fn)
             for t, fn in steps.items()}
    out["profiles"] = profs
    for tag, prof in profs.items():
        if "wall_ms_per_call" not in prof:
            fail(f"17a {tag}: the profiler saw no kernel")
    pk = {t: {n: v["launches_per_call"]
              for n, v in prof["port_kernels"].items()}
          for t, prof in profs.items()}
    log(f"[17a] eager step ms plain {out['eager_step_ms']['plain']:.2f}, "
        f"mesh {out['eager_step_ms']['mesh']:.2f} (pairs {times}); idle "
        f"share plain {profs['plain']['device_idle_share']:.3f}, mesh "
        f"{profs['mesh']['device_idle_share']:.3f}; launches a step plain "
        f"{profs['plain']['kernel_launches_per_call']:.0f}, mesh "
        f"{profs['mesh']['kernel_launches_per_call']:.0f}; the port's "
        f"kernels plain {pk['plain']}, mesh {pk['mesh']}; NCCL kernels "
        f"{profs['mesh']['nccl_kernels']}")
    if pk["plain"] != pk["mesh"] or not pk["mesh"]:
        fail(f"17a: profiled port kernels differ: {pk}")
    del steps, plain
    collect_garbage()
    torch.cuda.empty_cache()
    out["graph"] = p17_graph(mesh, gc, seed)
    out["graph_5b_step_ms"] = graph_5b["step_ms"]
    log(f"[17a] K={GRAPH_K} graph over the mesh {out['graph']['step_ms']}; "
        f"5b's plain graph (phase 10, this run) {graph_5b['step_ms']}")
    out["memory"] = mesh.memory_stats()
    out["moment_bytes"] = out["memory"]["actual_opt_state_bytes_per_device"]
    out["wall_s"] = time.perf_counter() - t0
    del mesh
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def p17_probe(dev) -> dict:
    """Which c10d collectives the started group carries on CUDA tensors,
    each checked for its value: "carried", or the error it raised."""
    import torch.distributed as dist

    r, w = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(r + 1), device=dev)
    tot = float(w * (w + 1) / 2)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == tot).all())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return bool((y == 1).all())

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(ys, x)
        return all(bool((y == i + 1).all()) for i, y in enumerate(ys))

    def all_gather_into_tensor():
        y = torch.empty(4 * w, device=dev)
        dist.all_gather_into_tensor(y, x)
        return bool((y.view(w, 4)[:, 0].cpu()
                     == torch.arange(1, w + 1).float()).all())

    def reduce_scatter_tensor():
        y = torch.empty(4 // w, device=dev)
        dist.reduce_scatter_tensor(y, x)
        return bool((y == tot).all())

    def all_to_all_single():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return bool(y.numel() == 4)

    out = {}
    for fn in (all_reduce, broadcast, all_gather, all_gather_into_tensor,
               reduce_scatter_tensor, all_to_all_single):
        try:
            ok = fn()
            torch.cuda.synchronize(dev)
            out[f"c10d {fn.__name__}"] = "carried" if ok else "wrong values"
        except Exception as e:  # the probe's finding: what gloo refuses
            out[f"c10d {fn.__name__}"] = f"{type(e).__name__}: {str(e)[:160]}"
    return out


def p17_pair_rank(rank: int, port: int, which: str, out_q) -> None:
    """One rank of a probe pair: `which` (P17_PAIRED) on CUDA tensors over
    gloo, checked for its value: DTensor's functional collectives
    (torch.distributed._functional_collectives), c10d's point-to-point
    calls and uneven all-to-all, and the port's ring hop."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    from flexflow_tpu_torch.runtime.distributed import (init_distributed,
                                                        ring_shift)

    init_distributed(f"localhost:{port}", 2, rank, local_device_ids=[0],
                     backend="gloo")
    x = torch.full((4,), float(rank + 1), device="cuda")
    g, peer = dist.group.WORLD, 1 - rank
    try:
        if which == "functional all_reduce":
            ok = bool((fc.wait_tensor(fc.all_reduce(x, "sum", g)) == 3).all())
        elif which == "functional reduce_scatter_tensor":
            y = fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0, g))
            ok = y.numel() == 2 and bool((y == 3).all())
        elif which == "functional all_gather_into_tensor":
            y = fc.wait_tensor(fc.all_gather_tensor(x, 0, g))
            ok = bool((y[:4] == 1).all() and (y[4:] == 2).all())
        elif which == "c10d isend/irecv":
            y = torch.empty_like(x)
            for req in (dist.isend(x, peer), dist.irecv(y, peer)):
                req.wait()
            ok = bool((y == peer + 1).all())
        elif which == "c10d batch_isend_irecv":
            y = torch.empty_like(x)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, peer),
                    dist.P2POp(dist.irecv, y, peer)]):
                req.wait()
            ok = bool((y == peer + 1).all())
        elif which == "c10d all_to_all_single uneven":
            y = torch.empty_like(x)
            splits = [0, 4] if rank == 0 else [4, 0]
            dist.all_to_all_single(y, x, splits, splits)
            ok = bool((y == peer + 1).all())
        else:  # the port's hop: a bf16 and an f32 tensor, packed
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("ring",))
            a = torch.full((3, 8), float(rank + 1), device="cuda",
                           dtype=torch.bfloat16)
            ra, rx = ring_shift([a, x], mesh, "ring").wait()
            ok = bool((ra == peer + 1).all() and (rx == peer + 1).all())
        torch.cuda.synchronize()
        out_q.put((rank, which, "carried" if ok else "wrong values"))
    except Exception as e:  # the probe's finding: what gloo refuses
        out_q.put((rank, which, f"{type(e).__name__}: {str(e)[:160]}"))
    dist.destroy_process_group()


def p17_probe_pairs() -> dict:
    """P17_PAIRED, a pair of processes each, all pairs at once: "carried",
    "wrong values", the error, or how the pair ended."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    pairs = {w: [ctx.Process(target=p17_pair_rank,
                             args=(r, port, w, q)) for r in range(2)]
             for w, port in zip(P17_PAIRED,
                                [_free_port() for _ in P17_PAIRED])}
    for procs in pairs.values():
        for p in procs:
            p.start()
    got: dict = {}
    deadline = time.perf_counter() + P17_PAIR_DEADLINE_S
    try:
        while sum(len(v) for v in got.values()) < 2 * len(pairs):
            if all(not p.is_alive() for ps in pairs.values() for p in ps) \
                    and q.empty():
                break
            try:
                r, w, val = q.get(timeout=1.0)
            except queue_mod.Empty:
                if time.perf_counter() > deadline:
                    break
                continue
            got.setdefault(w, {})[r] = val
    finally:
        for procs in pairs.values():
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(5)
    out = {}
    for w, procs in pairs.items():
        vals = set(got.get(w, {}).values())
        out[w] = (
            vals.pop() if len(vals) == 1 and len(got[w]) == 2 else
            f"the pair ended with exit codes {[p.exitcode for p in procs]} "
            f"and results {got.get(w)}")
    return out


def p17_rank(rank: int, port: int, seed: int, carried, out_q) -> None:
    """17b's rank: a gloo group of two on cuda:0, the probe, then every
    leg the probe allows: config #5's widths at full depth, global batch
    8, P17B_STEPS Adam steps from the seed's weights; then 18c's legs
    (`p18_rank`). Each part prints as it ends (the parent's watchdog
    names the last)."""
    import traceback

    def say(msg):
        print(f"[17b rank {rank}] {msg}", flush=True)

    try:
        from flexflow_tpu_torch.kernels import fused_optim as fo
        from flexflow_tpu_torch.runtime.distributed import init_distributed

        init_distributed(f"localhost:{port}", 2, rank, local_device_ids=[0],
                         backend="gloo")
        dev = torch.device("cuda", 0)
        probe = dict(carried, **p17_probe(dev))
        say(f"probe {probe}")
        legs, skipped = {}, {}
        for name, (mesh, zero, megatron, needs) in P17_LEGS.items():
            missing = [c for c in needs if probe.get(c) != "carried"]
            if missing:
                skipped[name] = f"gloo does not carry {missing} on CUDA"
                continue
            t0 = time.perf_counter()
            gc, model, cm = gpt2_train_model(seed, LAYERS, "bfloat16",
                                             mesh_shape=mesh,
                                             zero_sharding=zero)
            if megatron:
                from flexflow_tpu_torch.parallel.templates import \
                    megatron_strategy

                cm.strategy = megatron_strategy(model, cm.machine)
                cm._build_steps()
                cm.init(seed=seed)
            say(f"{name}: compiled in {time.perf_counter() - t0:.1f} s")
            zero_launch_counts()
            builds0 = fo.table_builds
            t1 = time.perf_counter()
            losses = p17_steps(cm, seed, gc.vocab, P17B_STEPS)
            torch.cuda.synchronize()
            say(f"{name}: {P17B_STEPS} steps in "
                f"{time.perf_counter() - t1:.1f} s, losses {losses}")
            mem = cm.memory_stats()
            legs[name] = {"mesh": mesh, "zero": cm._zero, "losses": losses,
                          "strategy": cm.strategy.name,
                          "launches": launch_counts(),
                          "table_builds": fo.table_builds - builds0,
                          "params_digest": p17_digest(cm),
                          "moment_bytes":
                              mem["actual_opt_state_bytes_per_device"],
                          "param_bytes":
                              mem["actual_param_bytes_per_device"],
                          "wall_s": time.perf_counter() - t0}
            del cm, model
            collect_garbage()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        p18 = p18_rank(rank, seed, probe, dev)
        p18["wall_s"] = time.perf_counter() - t0
        out_q.put((rank, "ok", {"probe": probe, "legs": legs,
                                "skipped": skipped, "p18": p18}))
    except Exception:  # the parent fails the phase with it
        out_q.put((rank, "error", traceback.format_exc()))


def p17_two_ranks(seed: int, world1: dict) -> dict:
    """17b: two spawned ranks on the one card over gloo (NCCL refuses two
    ranks on one GPU); every process is joined or killed before this
    returns."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    functional = p17_probe_pairs()
    log(f"[17b] functional collectives, point to point and the port's "
        f"hop on CUDA tensors over gloo, a pair each: {functional} "
        f"({time.perf_counter() - t0:.1f} s)")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=p17_rank,
                         args=(r, port, seed, functional, q))
             for r in range(2)]
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < 2:
            try:
                r, kind, val = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in res and not p.is_alive()]
                if dead and q.empty():
                    fail(f"17b: ranks {dead} ended with exit codes "
                         f"{[procs[i].exitcode for i in dead]} and no result")
                if time.perf_counter() - t0 > P17_TIMEOUT_S:
                    fail(f"17b: ranks {sorted({0, 1} - set(res))} did not "
                         f"finish in {P17_TIMEOUT_S} s")
                continue
            if kind != "ok":
                fail(f"17b rank {r}:\n{val}")
            res[r] = val
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(5)
    a, b = res[0], res[1]
    out = {"probe": a["probe"], "skipped": a["skipped"], "legs": {},
           "wall_s": time.perf_counter() - t0,
           "p18": {0: a.pop("p18"), 1: b.pop("p18")}}
    out["p18_wall_s"] = out["p18"][0]["wall_s"]
    log(f"[17b] gloo on CUDA tensors, two ranks on cuda:0: {a['probe']}")
    for name, why in a["skipped"].items():
        log(f"[17b] leg {name} not started: {why}")
    ref = world1["runs"]["mesh"]["losses"]
    for name, leg in a["legs"].items():
        other = b["legs"][name]
        rel = max(abs(x - y) / abs(y) for x, y in zip(leg["losses"], ref))
        half = leg["zero"] != "off"
        digest = leg.pop("params_digest")
        row = dict(leg, rel_err_vs_world1=rel,
                   ranks_bitwise_equal=digest == other["params_digest"]
                   and leg["losses"] == other["losses"],
                   moment_bytes_world1=world1["moment_bytes"],
                   launches_rank1=other["launches"])
        out["legs"][name] = row
        log(f"[17b {name}] losses {leg['losses']} (world 1 {ref}, max rel "
            f"{rel:.2e}); ranks bitwise {row['ranks_bitwise_equal']}; moment "
            f"bytes a rank {leg['moment_bytes']} (world 1 "
            f"{world1['moment_bytes']}); launches {leg['launches']}; "
            f"{leg['wall_s']:.1f} s")
        want = {n: 0 for n in leg["launches"]}
        want.update(flash_attention_fwd=LAYERS * P17B_STEPS,
                    flash_attention_dq=LAYERS * P17B_STEPS,
                    flash_attention_dkv=LAYERS * P17B_STEPS,
                    fused_adam=P17B_STEPS)
        if len(leg["losses"]) != P17B_STEPS or rel > P17_LOSS_RTOL or \
                not row["ranks_bitwise_equal"] or \
                leg["launches"] != want or other["launches"] != want or \
                (half and 2 * leg["moment_bytes"] != world1["moment_bytes"]):
            fail(f"17b {name}: {row}")
    if "data2 zero off" not in out["legs"]:
        fail(f"17b: gloo carries no all-reduce on CUDA: {a['probe']}")

    return out


def p17_launcher(tmpdir: str) -> dict:
    """17c: `python -m flexflow_tpu_torch --mesh data=1 -b 8 script.py`
    under torchrun's environment (one process): the launcher starts the
    group, the script's compile runs over the mesh, 2 steps, exit 0."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmpdir, "launched17.py")
    with open(script, "w") as fh:
        fh.write(P17_SCRIPT)
    env = {k: v for k, v in os.environ.items()
           if k not in ("FLEXFLOW_PLATFORM", "FF_LAUNCH_ARGS")}
    env.update(PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    cmd = [sys.executable, "-m", "flexflow_tpu_torch", "--mesh", "data=1",
           "-b", "8", script]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=tmpdir, env=env, capture_output=True,
                         text=True, timeout=300)
    lines = [l for l in run.stdout.splitlines() if l.startswith("P17C ")]
    if run.returncode != 0 or not lines:
        fail(f"17c: the launcher exited {run.returncode}: "
             f"{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    got = json.loads(lines[-1][len("P17C "):])
    got.update(returncode=run.returncode, wall_s=time.perf_counter() - t0)
    log(f"[17c] torchrun env, `python -m flexflow_tpu_torch --mesh data=1 "
        f"-b 8 launched17.py` exited 0 in {got['wall_s']:.1f} s: {got}")
    want = {k: 0 for k in got["launches"]}
    want["fused_sgd_plain"] = 2
    if not (got["world"] == 1 and got["backend"] == "nccl"
            and got["mesh"] == {"data": 1} and got["dtensor"]
            and got["updates"] == 2 and got["device"].startswith("cuda")
            and np.isfinite(got["loss"]) and got["launches"] == want):
        fail(f"17c: {got}")
    return got


def phase17(seed: int, graph_5b: dict) -> dict:
    """Phase 17: 17a world 1 over NCCL in this process, 17b two ranks on
    the card over gloo, 17c the launcher under torchrun's environment."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    out, walls = {}, {}
    t0 = time.perf_counter()
    out["17a"] = p17_world1(seed, graph_5b)
    walls["17a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["17b"] = p17_two_ranks(seed, out["17a"])
    walls["17b"] = time.perf_counter() - t0
    tmpdir = tempfile.mkdtemp(prefix="ff_p17_")
    try:
        t0 = time.perf_counter()
        out["17c"] = p17_launcher(tmpdir)
        walls["17c"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    log(f"[phase 17] {out['wall_s']:.1f} s on {card_line()} ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return out


# ---------------------------------- phase 18: multi-GPU, second part
# 18a: the ring's per-step functions for P simulated ranks in one process
# at GPT-2 medium's heads, b1, seq 8192, bf16, causal, against #1-#3 over
# the whole sequence; and at seq 1024 against the ring's plain version.
# Tolerances, on the largest |error| over the largest |reference|. The
# ring keeps its accumulators in f32 and rounds once, as JAX's: #1 writes
# each chunk's o, #2/#3 each step's gradients, in f32. Out: one half-ulp,
# 2**-9 (readings on an H100 80GB HBM3 at 700 W: 1.55e-4 and 3.09e-4 at
# P = 2 and 4 against #1-#3, 1.09e-3 against the plain ring; before the
# repair the limit was 2**-8). The gradients against #1-#3 over the
# sequence: one rounding, 2**-8 (readings dQ 3.6e-4, dK 2.5e-3, dV 1.5e-3
# at P = 2 and 4); against the plain ring at seq 1024, whose dS and P are
# rounded to bf16 from f32 values formed in another order, 7e-3 (reading
# dK 6.29e-3 at P = 2, 3.14e-3 at P = 4). Both replace (P + 2) half-ulps
# (7.8e-3 at P = 2, 1.17e-2 at P = 4), which counted the P + 1 roundings
# of the ring before the repair (dV 6.0e-3 at P = 2). lse is f32
# (LSE_TOL). The collective matmul keeps its own limits (`P18_CMM_RTOL`):
# y is one bf16 rounding on each side, one ulp apart at most
P18_SEQ, P18_PLAIN_SEQ, P18_PS = 8192, 1024, (2, 4)
P18_OUT_RTOL = 2 ** -9
P18_GRAD_RTOL = {"whole": 2 ** -8, "plain": 7e-3}
P18_CMM_RTOL = {"y": 2 ** -8, "grads": 2 ** -7}
P18_MESH_W1, P18_AXIS = {"model": 1}, "model"
# 18c's legs on two gloo ranks sharing cuda:0: (mesh, what the probe must
# find carried on CUDA tensors for it). ring_check is 18a's check on the
# per-rank ring the main path calls, with real hops
P18_LEGS = {
    "ring_check": ({"model": 2}, ("port ring_shift",)),
    "ring": ({"model": 2}, ("port ring_shift", "functional all_reduce")),
    "expert_parallel": ({"expert": 2}, (
        "c10d all_to_all_single", "c10d all_gather_into_tensor",
        "functional all_reduce")),
    "fork_join": ({"model": 2}, (
        "c10d all_reduce", "c10d all_gather_into_tensor",
        "c10d reduce_scatter_tensor", "functional all_reduce")),
    "collective_matmul": ({"model": 2}, ("port ring_shift",))}
# the collective matmul at GPT-2 medium's MLP up-projection over b8 x seq
# 1024 tokens: x (8192, 1024) @ w (1024, 4096), bf16
P18_CMM = (BATCH * SEQ, 1024, 4096)
P18_BRANCHES = 2   # the ensemble cut to one branch a rank
# 18c's limits on max |loss - world 1's| / |world 1's| over the 3 steps,
# each leg's own: its reading on an H100 80GB HBM3 at 700 W (the same in
# two runs: the ring 1.53e-5, EP 1.04e-7, the ensemble 4.28e-5) with
# 2-10x room
P18_LOSS_RTOL = {"ring": 1e-4, "expert_parallel": 1e-6, "fork_join": 1e-4}


def p18_errs(got: dict, ref: dict) -> dict:
    """max |got - ref| / max |ref| of each tensor."""
    return {n: float((got[n].detach().float() - ref[n].float()).abs().max()
                     / ref[n].float().abs().max().clamp_min(1e-30))
            for n in ref}


def p18_lockstep(seed: int, timer) -> dict:
    """18a: the ring in lockstep on the card (module docstring)."""
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import ring_attention as ra

    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    scale = 1.0 / math.sqrt(HEAD_DIM)

    def inputs(s):
        return [torch.randn((1, HEADS, s, HEAD_DIM), generator=gen,
                            device="cuda", dtype=torch.bfloat16)
                for _ in range(4)]

    def ring(p, q, k, v, do):
        qs, ks, vs, dos = (t.chunk(p, dim=2) for t in (q, k, v, do))
        outs, lses = ra.ring_lockstep_fwd(qs, ks, vs, True, scale)
        dq, dk, dv = ra.ring_lockstep_bwd(qs, ks, vs, outs, lses, dos, True,
                                          scale)
        return {"out": torch.cat(outs, 2), "lse": torch.cat(lses, 2),
                "dq": torch.cat(dq, 2), "dk": torch.cat(dk, 2),
                "dv": torch.cat(dv, 2)}

    def whole(q, k, v, do):
        o, lse = fa._fwd(q, k, v, True, scale)
        dq, dk, dv = fa._bwd(q, k, v, o, lse, do, True, scale)
        return {"out": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}

    def plain(p, q, k, v, do):
        o, lse = ra.ring_plain_fwd(q, k, v, p, True, scale)
        dq, dk, dv = ra.ring_plain_bwd(q, k, v, o, lse, do, p, True, scale)
        return {"out": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}

    def check(tag, which, got, ref):
        lse = float((got["lse"] - ref["lse"]).abs().max())
        errs = p18_errs({n: got[n] for n in ("out", "dq", "dk", "dv")},
                        {n: ref[n] for n in ("out", "dq", "dk", "dv")})
        errs["lse_max_abs"] = lse
        errs["out_max_abs"] = float((got["out"].float()
                                     - ref["out"].float()).abs().max())
        gtol = P18_GRAD_RTOL[which]
        bad = (errs["out"] > P18_OUT_RTOL or lse > LSE_TOL or
               max(errs[n] for n in ("dq", "dk", "dv")) > gtol)
        log(f"[18a] {tag}: errors over the largest |reference| {errs} "
            f"(tolerances out {P18_OUT_RTOL}, grads {gtol}, "
            f"lse {LSE_TOL} abs)")
        if bad:
            fail(f"18a {tag}: the ring disagrees: {errs}")
        return errs

    out = {"shape": [1, HEADS, P18_SEQ, HEAD_DIM], "dtype": "bfloat16",
           "causal": True, "by_p": {}}
    x = inputs(P18_SEQ)
    ref = whole(*x)
    names = ("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
             "flash_dkv_tc_kernel")
    for p in P18_PS:
        zero_launch_counts()
        got = ring(p, *x)
        torch.cuda.synchronize()
        counts = launch_counts()
        row = {"errors_vs_whole": check(f"P={p} vs #1-#3 over seq "
                                        f"{P18_SEQ}", "whole", got, ref)}
        del got
        prof = _device_profile(lambda: ring(p, *x), 1, dev,
                               lead=lambda: ring(p, *x))
        pk = {n: v["launches_per_call"]
              for n, v in prof.get("port_kernels", {}).items()}
        want = p * (p + 1) // 2
        row.update(launches=counts, profiled=pk,
                   ms=timer(lambda: ring(p, *x)))
        log(f"[18a] P={p}: {row['ms']:.4f} ms a ring (forward and "
            f"backward); launches {counts}, profiled {pk}")
        if [counts[c] for c in ("flash_attention_fwd", "flash_attention_dq",
                                "flash_attention_dkv")] != [want] * 3 or \
                [pk.get(n) for n in names] != [want] * 3:
            fail(f"18a P={p}: expected {want} launches of each of #1-#3: "
                 f"{counts}, profiled {pk}")
        out["by_p"][p] = row
    out["whole_ms"] = timer(lambda: whole(*x))
    # the plain version at seq 8192 (P = 2) and SDPA over the sequence
    slow = Timer(reps=5, warmup=1)
    out["plain_ms"] = slow(lambda: plain(2, *x))
    qg, kg, vg = (t.detach().requires_grad_() for t in x[:3])

    def sdpa():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                           scale=scale)
        torch.autograd.grad(o, (qg, kg, vg), x[3])
    out["library_ms"] = timer(sdpa)
    b, h, s, d = out["shape"]
    # causal attention's forward and backward: 2·b·h·s²·d a product over
    # half the (s, s) block; the forward's S and PV, the backward's S
    # once, dP, dV, dQ and dK. #2 and #3 each recompute S: the second
    # recompute is the kernels' choice, not the function's work
    flops = 7.0 * b * h * s * s * d
    nbytes = 8 * b * h * s * d * 2 + 2 * b * h * s * 4
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
    del x, ref, qg, kg, vg
    torch.cuda.empty_cache()
    # the plain version at seq 1024
    x = inputs(P18_PLAIN_SEQ)
    out["vs_plain"] = {p: check(f"P={p} vs the plain ring at seq "
                                f"{P18_PLAIN_SEQ}", "plain", ring(p, *x),
                                plain(p, *x)) for p in P18_PS}
    out["wall_s"] = time.perf_counter() - t0
    log(f"[18a] whole sequence (#1-#3) {out['whole_ms']:.4f} ms, ring "
        + ", ".join(f"P={p} {r['ms']:.4f} ms" for p, r in out["by_p"].items())
        + f", the plain ring (P=2) {out['plain_ms']:.2f} ms, SDPA "
        f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}); {out['wall_s']:.1f} s")
    del x
    torch.cuda.empty_cache()
    return out


def p18_world1(seed: int, world1: dict) -> dict:
    """18b: config #5 over {"model": 1} in 17a's NCCL group with every
    attention on the ring, against 17a's plain compile (its losses and
    params after the same 3 steps), bitwise."""
    from flexflow_tpu_torch.parallel.templates import \
        sequence_parallel_strategy

    t0 = time.perf_counter()
    gc, model, cm = gpt2_train_model(seed, LAYERS, "bfloat16",
                                     mesh_shape=P18_MESH_W1)
    cm.strategy = sequence_parallel_strategy(model, cm.machine, P18_AXIS)
    cm._build_steps()
    cm.init(seed=seed)
    zero_launch_counts()
    losses = p17_steps(cm, seed, gc.vocab)
    launches = launch_counts()
    digest = p17_digest(cm)
    plain = world1["runs"]["plain"]["losses"]
    out = {"mesh": P18_MESH_W1, "losses": losses, "plain_losses": plain,
           "losses_bitwise_equal": losses == plain,
           "params_bitwise_equal": digest == world1["plain_digest"],
           "launches": launches,
           "attrs": cm.strategy.sharding_for("h0_attn").attrs}
    want = {n: 0 for n in launches}
    want.update(flash_attention_fwd=LAYERS * P17_STEPS,
                flash_attention_dq=LAYERS * P17_STEPS,
                flash_attention_dkv=LAYERS * P17_STEPS,
                fused_adam=P17_STEPS, ring_attention=LAYERS * P17_STEPS)
    ids, pos, labels = train_batch(seed, gc.vocab)
    dev_in = [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]
    dev_lab = torch.from_numpy(labels).cuda()

    def step():
        (cm.params, cm.opt_state, cm.state, _, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, dev_in, dev_lab)
    prof = _device_profile(step, 1, cm.device, lead=step)
    out["profile"] = {k: prof.get(k) for k in (
        "wall_ms_per_call", "device_busy_ms_per_call", "device_idle_share",
        "kernel_launches_per_call", "nccl_kernels")}
    pk = {n: v["launches_per_call"]
          for n, v in prof.get("port_kernels", {}).items()}
    out["profiled_port_kernels"] = pk
    mem = cm.memory_stats()
    out["bytes_a_rank"] = (mem["actual_param_bytes_per_device"]
                           + mem["actual_opt_state_bytes_per_device"])
    out["wall_s"] = time.perf_counter() - t0
    log(f"[18b] config #5 over {P18_MESH_W1} (NCCL), every attention "
        f"{out['attrs']}: losses {losses} (17a plain {plain}): bitwise "
        f"{out['losses_bitwise_equal']}, params bitwise "
        f"{out['params_bitwise_equal']}; launches {launches}; a profiled "
        f"step {out['profile']}, the port's kernels {pk}; "
        f"{out['wall_s']:.1f} s")
    per_step = {"flash_fwd_tc_kernel": LAYERS, "flash_dq_tc_kernel": LAYERS,
                "flash_dkv_tc_kernel": LAYERS, "adam_kernel": 1}
    if not (out["losses_bitwise_equal"] and out["params_bitwise_equal"]) or \
            launches != want or pk != per_step or prof.get("nccl_kernels"):
        fail(f"18b: the ring at world 1 differs from the plain compile: "
             f"{out}")
    del cm, model
    collect_garbage()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- 18c, in 17b's ranks
def p18_digest(cm) -> dict:
    """p17_digest's sums over this rank's blocks, by weight, of the
    replicated weights (every rank holds them whole) and of the sharded
    ones apart: no collective (gloo's functional all-gather crashes on
    CUDA tensors)."""
    out = {"replicated": [], "sharded": []}
    for l in sorted(cm.params):
        for w in sorted(cm.params[l]):
            t = cm.params[l][w]
            b = t.to_local().detach().contiguous().view(
                torch.int32).flatten().long()
            at = torch.arange(1, b.numel() + 1, device=b.device)
            kind = ("replicated" if all(p.is_replicate()
                                        for p in t.placements)
                    else "sharded")
            out[kind].append((f"{l}.{w}", int(b.sum()), int((b * at).sum())))
    return out


def p18_train(cm, xs, y, n: int = P17_STEPS) -> list:
    losses = []
    for _ in range(n):
        (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, xs, y)
        losses.append(loss)
    return [float(v) for v in losses]


def p18_zoo(which: str, seed: int, mesh=None):
    """MoE-MLP as phase 14 builds it (64 experts, top-2, b64, hidden 64,
    SGD) or the branch ensemble at its widths with P18_BRANCHES branches
    a module (Adam), bf16 compute, weights from the seed; over `mesh`
    with the experts over "expert" (`ep:expert`) or every fork-join
    placed on "model" (`inter:model`, stacked); and its batch."""
    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                    SGDOptimizer)
    from flexflow_tpu_torch.models.branchy import build_branchy
    from flexflow_tpu_torch.parallel import templates as T

    cfg = dict(compute_dtype="bfloat16", seed=seed)
    if mesh:
        cfg["mesh_shape"] = mesh
    model = FFModel(FFConfig(**cfg))
    if which == "moe_mlp":
        zoo_build("moe_mlp", model)
    else:
        build_branchy(model, k=P18_BRANCHES)
    model.config.batch_size = model.input_tensors[0].shape[0]
    cm = model.compile(SGDOptimizer(lr=0.01) if which == "moe_mlp"
                       else AdamOptimizer(alpha=LR),
                       "sparse_categorical_crossentropy", [])
    if mesh:
        if which == "moe_mlp":
            T.apply_expert_parallel(cm.strategy, [
                l for l in model.layers
                if l.op_type.value in ("group_by", "experts")], "expert")
        else:
            for l in model.layers:
                if l.op_type.value == "fork_join":
                    T.apply_branch_placement(cm.strategy, l, "model")
        cm._build_steps()
    cm.init(seed=seed)
    xs, y = zoo_batches(model, seed)
    return cm, xs, y


def p18_rank_leg(name: str, rank: int, seed: int, dev) -> dict:
    """One 18c training leg on this rank: P17_STEPS steps from the seed,
    each timed (rank 0 profiles the last), the launches, the bytes this
    rank holds, the digests."""
    from flexflow_tpu_torch.kernels import collective_matmul as cmm
    from flexflow_tpu_torch.parallel.templates import \
        sequence_parallel_strategy

    mesh = P18_LEGS[name][0]
    t0 = time.perf_counter()
    if name == "ring":
        gc, model, cm = gpt2_train_model(seed, LAYERS, "bfloat16",
                                         mesh_shape=mesh)
        cm.strategy = sequence_parallel_strategy(model, cm.machine, P18_AXIS)
        cm._build_steps()
        cm.init(seed=seed)
        ids, pos, labels = train_batch(seed, gc.vocab)
        xs, y = [ids, pos], labels
    else:
        cm, xs, y = p18_zoo("moe_mlp" if name == "expert_parallel"
                            else "branchy", seed, mesh)
    compile_s = time.perf_counter() - t0
    dev_xs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in xs]
    dev_y = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
    losses, step_ms = [], []

    def step():
        sync(dev)
        t1 = time.perf_counter()
        (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, dev_xs, dev_y)
        sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t1))
        losses.append(loss)
    # P17_STEPS steps from the seed: the first alone, the last two (rank
    # 0) a profiled step after an uncounted lead step
    zero_launch_counts()
    step()
    out = {"mesh": mesh, "compile_s": compile_s}
    if rank == 0:
        prof = _device_profile(step, 1, dev, lead=step)
        out["idle_share"] = prof.get("device_idle_share")
        out["profiled_port_kernels"] = {
            n: v["launches_per_call"]
            for n, v in prof.get("port_kernels", {}).items()}
    else:
        step()
        step()
    out.update(losses=[float(v) for v in losses], step_ms=step_ms,
               launches=launch_counts(), digest=p18_digest(cm))
    if len(losses) != P17_STEPS or cmm.launches:
        fail(f"18c {name}: {len(losses)} steps, {cmm.launches} collective "
             f"matmuls")
    mem = cm.memory_stats()
    out["bytes_a_rank"] = (mem["actual_param_bytes_per_device"]
                           + mem["actual_opt_state_bytes_per_device"])
    if name == "expert_parallel":
        ek = next(l for l in cm.params if "experts" in l)
        out["expert_kernel_local"] = list(
            cm.params[ek]["kernel"].to_local().shape)
    if name == "fork_join":
        out["stacked_local"] = {w: list(t.to_local().shape)
                                for w, t in cm.params["fj0"].items()}
    out["wall_s"] = time.perf_counter() - t0
    del cm
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def p18_rank_cmm(rank: int, seed: int, dev) -> dict:
    """The collective matmul on this rank at P18_CMM: y and the gradients
    of sum_r sum(y_r * g_r) against f32 products of the same bf16 inputs
    (every rank draws the full x, w and g from the seed), and the times
    of the ring, of the all-gather and matmul it replaces, and of the
    matmul alone (the library call), forward only."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from flexflow_tpu_torch.kernels import collective_matmul as cmm

    t0 = time.perf_counter()
    m, k, n = P18_CMM
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=(P18_AXIS,))
    gen = torch.Generator(device="cuda").manual_seed(seed + 181)
    x = torch.randn((m, k), generator=gen, device=dev, dtype=torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev)
         / math.sqrt(k)).to(torch.bfloat16)
    g = torch.randn((m, n), generator=gen, device=dev, dtype=torch.bfloat16)
    rows = slice(rank * m // 2, (rank + 1) * m // 2)
    cols = slice(rank * n // 2, (rank + 1) * n // 2)
    xl = x[rows].clone().requires_grad_()
    wl = w[:, cols].clone().requires_grad_()
    cmm.launches = 0
    y = cmm.collective_matmul(xl, wl, mesh, P18_AXIS)
    dx, dw = torch.autograd.grad(y, (xl, wl), g[:, cols])
    sync(dev)
    out = {"shape": [m, k, n], "launches": cmm.launches}
    xf, wf, gf = x.float(), w.float(), g.float()
    want = {"y": xf @ wf[:, cols], "dx": (gf @ wf.t())[rows],
            "dw": xf.t() @ gf[:, cols]}
    out["errors"] = p18_errs({"y": y, "dx": dx, "dw": dw}, want)
    out["y_max_abs_err"] = float((y.detach().float()
                                  - want["y"]).abs().max())
    del want, xf, wf, gf

    def ring():
        cmm.collective_matmul(xl.detach(), wl.detach(), mesh, P18_AXIS)

    def gather_then_matmul():
        full = torch.empty((m, k), device=dev, dtype=x.dtype)
        dist.all_gather_into_tensor(full, xl.detach().contiguous())
        return full @ wl.detach()

    def matmul():
        return x @ wl.detach()

    times = {}
    for tag, fn in (("ring", ring), ("plain", gather_then_matmul),
                    ("library", matmul)):
        fn()
        ts = []
        for _ in range(5):
            sync(dev)
            t1 = time.perf_counter()
            fn()
            sync(dev)
            ts.append(1e3 * (time.perf_counter() - t1))
        times[tag] = float(np.median(ts))
    out["ms"] = times
    out["wall_s"] = time.perf_counter() - t0
    return out


def p18_rank_ring_check(rank: int, seed: int, dev) -> dict:
    """The per-rank ring the main path calls (`ring_attention` on
    DTensors sharded over the sequence: `RingAttention`, `ring_fwd_local`
    and `ring_bwd_local` with real hops) at 18a's shape on this rank's
    half of the sequence, against #1-#3 over the whole sequence (every
    rank draws the full q, k, v and dO from the seed): the largest
    |error| on this rank's rows, and the largest |reference| over the
    whole sequence."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import ring_attention as ra

    t0 = time.perf_counter()
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=(P18_AXIS,))
    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    scale = 1.0 / math.sqrt(HEAD_DIM)
    q, k, v, do = [torch.randn((1, HEADS, P18_SEQ, HEAD_DIM), generator=gen,
                               device=dev, dtype=torch.bfloat16)
                   for _ in range(4)]
    o, lse = fa._fwd(q, k, v, True, scale)
    ref = dict(zip(("out", "dq", "dk", "dv"),
                   (o, *fa._bwd(q, k, v, o, lse, do, True, scale))))
    s_loc = P18_SEQ // 2
    rows = slice(rank * s_loc, (rank + 1) * s_loc)
    leaves = [t[:, :, rows].contiguous().requires_grad_() for t in (q, k, v)]
    dts = [DTensor.from_local(t, mesh, [Shard(2)], run_check=False)
           for t in leaves]
    out = ra.ring_attention(*dts, mesh, P18_AXIS, causal=True, scale=scale)
    ol = out.to_local()
    dq, dk, dv = torch.autograd.grad(ol, leaves,
                                     do[:, :, rows].contiguous())
    sync(dev)
    got = {"out": ol, "dq": dq, "dk": dk, "dv": dv}
    return {"max_abs_err": {n: float((g.detach().float()
                                      - ref[n][:, :, rows].float())
                                     .abs().max()) for n, g in got.items()},
            "max_abs_ref": {n: float(r.float().abs().max())
                            for n, r in ref.items()},
            "placements": [(type(p).__name__, getattr(p, "dim", None))
                           for p in out.placements],
            "wall_s": time.perf_counter() - t0}


def p18_rank(rank: int, seed: int, probe: dict, dev) -> dict:
    """18c's legs in 17b's ranks, each started only where the probe found
    every collective it needs carried."""
    legs, skipped = {}, {}
    for name, (mesh, needs) in P18_LEGS.items():
        missing = [c for c in needs if probe.get(c) != "carried"]
        if missing:
            skipped[name] = f"gloo does not carry {missing} on CUDA"
            continue
        print(f"[18c rank {rank}] {name} over {mesh}", flush=True)
        legs[name] = (p18_rank_cmm(rank, seed, dev)
                      if name == "collective_matmul" else
                      p18_rank_ring_check(rank, seed, dev)
                      if name == "ring_check"
                      else p18_rank_leg(name, rank, seed, dev))
    return {"legs": legs, "skipped": skipped}


def p18_reference(name: str, seed: int) -> dict:
    """18c's world-1 run of an ensemble or MoE leg, in this process."""
    cm, xs, y = p18_zoo("moe_mlp" if name == "expert_parallel"
                        else "branchy", seed)
    zero_launch_counts()
    out = {"losses": p18_train(cm, xs, y), "launches": launch_counts()}
    del cm
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def p18_two_ranks(seed: int, p17: dict) -> dict:
    """18c: the legs 17b's ranks ran, held to world 1 and each other."""
    res = p17["17b"]["p18"]
    a, b = res[0], res[1]
    out = {"skipped": a["skipped"], "legs": {}}
    for name, why in a["skipped"].items():
        log(f"[18c] leg {name} not started: {why}")
    ring_ref = p17["17a"]["runs"]["mesh"]["losses"]
    zero = {n: 0 for n in launch_counts()}
    for name, leg in a["legs"].items():
        other = b["legs"][name]
        if name == "ring_check":
            errs = {n: max(leg["max_abs_err"][n], other["max_abs_err"][n])
                    / leg["max_abs_ref"][n] for n in leg["max_abs_err"]}
            row = dict(leg, max_abs_err_rank1=other["max_abs_err"],
                       errors_vs_whole=errs)
            out["legs"][name] = row
            log(f"[18c ring_check] ring_attention over {P18_LEGS[name][0]} "
                f"at (1, {HEADS}, {P18_SEQ}, {HEAD_DIM}) bf16 causal against "
                f"#1-#3 over the sequence: errors over the largest "
                f"|reference| {errs} (tolerances out {P18_OUT_RTOL}, grads "
                f"{P18_GRAD_RTOL['whole']}); {leg['wall_s']:.1f} s")
            if errs["out"] > P18_OUT_RTOL or max(
                    errs[n] for n in ("dq", "dk", "dv")) > \
                    P18_GRAD_RTOL["whole"] \
                    or not leg["placements"] == other["placements"] == [
                        ("Shard", 2)]:
                fail(f"18c ring_check: the per-rank ring disagrees: {row}")
            continue
        if name == "collective_matmul":
            errs = {r: leg["errors"] if r == 0 else other["errors"]
                    for r in (0, 1)}
            worst = max(max(e.values()) for e in errs.values())
            row = dict(leg, errors_rank1=other["errors"],
                       ms_rank1=other["ms"], max_rel_err=worst,
                       launches_rank1=other["launches"],
                       y_max_abs_err_rank1=other["y_max_abs_err"])
            out["legs"][name] = row
            log(f"[18c collective_matmul] x {P18_CMM[:2]} @ w "
                f"{P18_CMM[1:]} bf16 over gloo: errors over the largest "
                f"|reference| {errs} (tolerance {P18_CMM_RTOL['y']} y, "
                f"{P18_CMM_RTOL['grads']} grads); ms (ring, all-gather + "
                f"matmul, "
                f"matmul) rank 0 {leg['ms']}, rank 1 {other['ms']}; "
                f"{leg['wall_s']:.1f} s")
            if leg["launches"] != 1 or other["launches"] != 1 or \
                    errs[0]["y"] > P18_CMM_RTOL["y"] or errs[1]["y"] > \
                    P18_CMM_RTOL["y"] or worst > P18_CMM_RTOL["grads"]:
                fail(f"18c collective_matmul: {row}")
            continue
        ref = (ring_ref if name == "ring"
               else p18_reference(name, seed)["losses"])
        rel = max(abs(x - y) / abs(y) for x, y in zip(leg["losses"], ref))
        da, db = leg.pop("digest"), other.pop("digest")
        row = dict(leg, world1_losses=ref, rel_err_vs_world1=rel,
                   replicated_bitwise=da["replicated"] == db["replicated"]
                   and leg["losses"] == other["losses"],
                   launches_rank1=other["launches"],
                   step_ms_rank1=other["step_ms"])
        want = [dict(zero), dict(zero)]
        for r in (0, 1):
            if name == "ring":
                # causal: rank r's q chunk sees r + 1 chunks a layer
                chunks = LAYERS * P17_STEPS * (r + 1)
                want[r].update(flash_attention_fwd=chunks,
                               flash_attention_dq=chunks,
                               flash_attention_dkv=chunks,
                               fused_adam=P17_STEPS,
                               ring_attention=LAYERS * P17_STEPS)
            elif name == "expert_parallel":
                want[r].update(fused_sgd_plain=P17_STEPS)
            else:
                want[r].update(fused_adam=P17_STEPS)
        out["legs"][name] = row
        log(f"[18c {name}] over {leg['mesh']}: losses {leg['losses']} "
            f"(world 1 {ref}, max rel {rel:.2e}, limit "
            f"{P18_LOSS_RTOL[name]}); replicated params bitwise "
            f"on both ranks {row['replicated_bitwise']}; launches "
            f"{leg['launches']}; step ms {leg['step_ms']}, idle share "
            f"{leg.get('idle_share')}, bytes a rank {leg['bytes_a_rank']}; "
            f"compile {leg['compile_s']:.1f} s, {leg['wall_s']:.1f} s")
        row["loss_rtol"] = P18_LOSS_RTOL[name]
        if rel > P18_LOSS_RTOL[name] or not row["replicated_bitwise"] or \
                leg["launches"] != want[0] or other["launches"] != want[1]:
            fail(f"18c {name}: {row}")
    if "expert_parallel" in out["legs"] and \
            out["legs"]["expert_parallel"]["expert_kernel_local"][0] != 32:
        fail(f"18c: each rank should hold 32 of 64 experts: {out}")
    return out


def phase18(seed: int, timer, p17: dict) -> dict:
    """Phase 18: 18a the ring in lockstep, 18b world 1 over NCCL, 18c the
    legs 17b's ranks ran (two ranks on the card over gloo)."""
    t_phase = time.perf_counter()
    out, walls = {}, {}
    for key, fn in (("18a", lambda: p18_lockstep(seed, timer)),
                    ("18b", lambda: p18_world1(seed, p17["17a"])),
                    ("18c", lambda: p18_two_ranks(seed, p17))):
        t0 = time.perf_counter()
        out[key] = fn()
        walls[key] = time.perf_counter() - t0
    walls["18c_in_17b"] = p17["17b"].get("p18_wall_s")
    out["wall_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    log(f"[phase 18] {out['wall_s']:.1f} s on {card_line()} ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()
                    if v is not None) + ")")
    return out


# ------------------------------- phase 19: multi-GPU, third part: pipeline
# config #5 (GPT-2 medium: b8, seq 1024, d 1024, 16 heads, 24 layers,
# vocab 50257, dropout 0, bf16 over f32 master weights) over S = 2 stages
# of one rank, M = 4 microbatches of 8 an update, on gloo ranks sharing
# cuda:0 (NCCL refuses two ranks on one GPU), against the world-1 compile
# at accum_steps=4 in this process from the same weights. 19c cuts the
# depth to 8 layers (four ranks each holding a stage of config #5's width
# on one card, and the checkpoint written in the call's time)
P19_STAGES, P19_MICRO = 2, 4
P19_UPDATES, P19_SGD_UPDATES = 3, 2
P19_DEEP_LAYERS, P19_DEEP_STAGES = 8, 4
P19_TIMEOUT_S = 600
# max |pipelined loss - world 1's| / |world 1's| over the updates, and
# 19c's restored update against the saving run's: each microbatch's
# forward and its recompute are the same kernels on the same inputs and
# the gradients sum in the same order, and the readings on an H100 80GB
# HBM3 at 700 W were 0 (19a, 19b and 19c bitwise); 1e-6 allows one f32
# rounding of a loss
P19_LOSS_RTOL = 1e-6


def p19_chunks(seed: int, vocab: int, updates: int) -> list:
    """`updates` groups of M batches of config #5's shape (ids, positions,
    labels as bench.py draws them), one group an update."""
    rng = np.random.default_rng(seed + 19)
    n = P19_MICRO * BATCH
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    return [([rng.integers(0, vocab, size=(n, SEQ)).astype(np.int32), pos],
             rng.integers(0, vocab, size=(n, SEQ)).astype(np.int32))
            for _ in range(updates)]


def p19_fit(cm, chunks, ms=None) -> list:
    """One fit of one update on each group: the update's loss each (the
    pipelined model's history is every rank's); with a list `ms`, each
    fit's milliseconds, the card synced after it."""
    out = []
    for x, y in chunks:
        t0 = time.perf_counter()
        out.append(float(cm.fit(x, y, epochs=1, verbose=False)[0]["loss"]))
        if ms is not None:
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    return out


def p19_pipelined(seed: int, layers: int, stages: int, sched: str = "1f1b",
                  optimizer=None, vocab_pad_to: int = 0, **cfg):
    """config #5's widths at `layers` deep over `stages` stages, compiled
    pipelined (M = 4) on this rank, its weights from the seed."""
    return gpt2_train_model(seed, layers, "bfloat16", optimizer=optimizer,
                            vocab_pad_to=vocab_pad_to,
                            pipeline_stages=stages, pipeline_schedule=sched,
                            accum_steps=P19_MICRO, **cfg)


def p19_expect(pm, updates: int, opt: str) -> dict:
    """The launches a rank's stage makes in `updates` updates: #1 twice a
    microbatch in a non-last stage (F and the recompute in B), once in the
    last (B is its forward); #2/#3 once; the optimizer once an update; the
    fused CE (a padded vocab) once a microbatch in the last stage."""
    from flexflow_tpu_torch.ops.op_type import OperatorType

    n_attn = sum(1 for l in pm.stage_layers[pm.stage]
                 if l.op_type is OperatorType.MULTIHEAD_ATTENTION)
    k = updates * P19_MICRO
    want = {n: 0 for n in launch_counts()}
    want.update(flash_attention_fwd=(1 if pm.last else 2) * n_attn * k,
                flash_attention_dq=n_attn * k,
                flash_attention_dkv=n_attn * k)
    want[opt] = updates
    if opt == "fused_sgd_plain" and pm.last:
        want.update(fused_ce_fwd=k, fused_ce_bwd=k)
    return want


def p19_cut_search(seed: int, cache_dir: str) -> dict:
    """19d: config #5 compiled twice with the cut search on at S = 2 on the
    card's H100 preset, against one strategy cache: the first compile's
    cuts, predicted bubble and step and seconds; the second's cache event
    and its DP expansions (zero)."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.search.dp import SEARCH_STATS, reset_search_stats

    def once():
        model = FFModel(FFConfig(batch_size=BATCH, compute_dtype="bfloat16",
                                 seed=seed, pipeline_stages=P19_STAGES,
                                 accum_steps=P19_MICRO, search_budget=8,
                                 strategy_cache_dir=cache_dir))
        build_gpt2(model, GPT2Config.medium(), batch=BATCH)
        t0 = time.perf_counter()
        pm = model.compile(AdamOptimizer(alpha=LR),
                           "sparse_categorical_crossentropy", [])
        return pm, time.perf_counter() - t0

    reset_search_stats()
    pm, secs = once()
    cold = dict(SEARCH_STATS)
    r = getattr(pm.strategy, "_pipeline_search", None)
    pred = pm.predicted_schedule()
    reset_search_stats()
    pm2, secs2 = once()
    return {"cuts": list(pm.cuts), "machine": dict(pm.machine.mesh_axes),
            "chip": pm.machine.chip,
            "stage_machine": dict(pm.stage_machine.mesh_axes),
            "search_cost_s": r.cost if r else None,
            "search_bubble": r.bubble if r else None,
            "predicted_makespan_s": pred["makespan_s"],
            "predicted_bubble": pred["bubble"],
            "compile_s": secs, "cold_expansions": cold.get("expansions", 0),
            "warm_event": (pm2.search_cache_info or {}).get("event"),
            "warm_expansions": SEARCH_STATS.get("expansions", 0),
            "warm_calls": SEARCH_STATS.get("calls", 0),
            "warm_compile_s": secs2,
            "warm_cuts": list(pm2.cuts)}


def p19_rank(rank: int, port: int, seed: int, cache_dir: str, ckdir: str,
             out_q) -> None:
    """19d, 19a, 19b and 19c's restore on one of two gloo ranks on cuda:0
    (module docstring); each part prints as it ends."""
    import tempfile
    import traceback

    def say(msg):
        print(f"[19 rank {rank}] {msg}", flush=True)

    try:
        from flexflow_tpu_torch import SGDOptimizer
        from flexflow_tpu_torch import telemetry as tel
        from flexflow_tpu_torch.runtime.distributed import init_distributed

        init_distributed(f"localhost:{port}", 2, rank, local_device_ids=[0],
                         backend="gloo")
        dev = torch.device("cuda", 0)
        out = {"19d": p19_cut_search(seed, cache_dir)}
        say(f"19d {out['19d']}")
        chunks = p19_chunks(seed, GPT2_VOCAB, P19_UPDATES + 3)
        legs = {}
        for sched in ("1f1b", "gpipe"):
            t0 = time.perf_counter()
            gc, model, pm = p19_pipelined(seed, LAYERS, P19_STAGES, sched)
            t_init = time.perf_counter() - t0
            zero_launch_counts()
            ms = []
            losses = p19_fit(pm, chunks[:P19_UPDATES], ms)
            leg = {"losses": losses, "launches": launch_counts(),
                   "want": p19_expect(pm, P19_UPDATES, "fused_adam"),
                   "digest": p17_digest(pm.stage_cm), "stage": pm.stage,
                   "cuts": list(pm.cuts), "mem": pm.memory_stats(),
                   "compile_init_s": t_init,
                   "init_draw_s": pm.step_stats.get("init_draw_s"),
                   "update_ms": ms,
                   "update_ms_in_fit": float(np.median(ms[1:]))}
            if sched == "1f1b":
                one = [chunks[P19_UPDATES]]
                prof = _device_profile(lambda: p19_fit(pm, one), 1, dev,
                                       lead=lambda: p19_fit(pm, one))
                leg["profile"] = {k: prof.get(k) for k in (
                    "wall_ms_per_call", "device_busy_ms_per_call",
                    "device_idle_share")}
                leg["profiled_port_kernels"] = {
                    n: v["launches_per_call"]
                    for n, v in prof.get("port_kernels", {}).items()}
                tdir = tempfile.mkdtemp(prefix="ff_p19_tel_")
                tel.configure(tdir)
                try:
                    p19_fit(pm, [chunks[P19_UPDATES + 2]])
                finally:
                    tel.shutdown()
                leg["measured_bubble"] = pm.step_stats.get("measured_bubble")
                leg["predicted"] = pm.predicted_schedule()
            legs[sched] = leg
            say(f"19a {sched}: losses {losses}, {leg['update_ms_in_fit']:.1f} "
                f"ms an update in fit, launches {leg['launches']}")
            del pm, model
            collect_garbage()
            torch.cuda.empty_cache()
        out["19a"] = legs
        gc, model, pm = p19_pipelined(seed, LAYERS, P19_STAGES,
                                      optimizer=SGDOptimizer(lr=SGD_LR),
                                      vocab_pad_to=PAD_TO)
        zero_launch_counts()
        t1 = time.perf_counter()
        sgd = p19_chunks(seed + 1, GPT2_VOCAB, P19_SGD_UPDATES)
        losses = p19_fit(pm, sgd)
        sync(dev)
        out["19b"] = {"losses": losses, "launches": launch_counts(),
                      "want": p19_expect(pm, P19_SGD_UPDATES,
                                         "fused_sgd_plain"),
                      "stage": pm.stage,
                      "wall_s": time.perf_counter() - t1}
        say(f"19b: losses {losses}, launches {out['19b']['launches']}")
        del pm, model
        collect_garbage()
        torch.cuda.empty_cache()
        out["19c"] = p19_deep(seed, 2, ckdir)
        out_q.put((rank, "ok", out))
    except Exception:  # the parent fails the phase with it
        out_q.put((rank, "error", traceback.format_exc()))


def p19_deep(seed: int, stages: int, ckdir: str) -> dict:
    """19c on this rank: at S = 4, config #5's width at 8 layers, 2
    updates, a snapshot, 1 more update; at S = 2, the snapshot restored
    and that update taken."""
    chunks = p19_chunks(seed + 2, GPT2_VOCAB, 3)
    two = ([np.concatenate([a, b]) for a, b in
            zip(chunks[0][0], chunks[1][0])],
           np.concatenate([chunks[0][1], chunks[1][1]]))
    gc, model, pm = p19_pipelined(seed, P19_DEEP_LAYERS, stages)
    out = {"stage": pm.stage, "cuts": list(pm.cuts)}
    t0 = time.perf_counter()
    if stages == P19_DEEP_STAGES:
        out["losses"] = [float(pm.fit(*two, epochs=1,
                                      verbose=False)[0]["loss"])]
        t1 = time.perf_counter()
        pm.save_checkpoint(ckdir)
        out["save_s"] = time.perf_counter() - t1
        out["saved_iteration"] = pm._iteration
    else:
        t1 = time.perf_counter()
        pm.load_checkpoint(ckdir)
        out["restore_s"] = time.perf_counter() - t1
        out["restored_iteration"] = pm._iteration
    out["next"] = p19_fit(pm, chunks[2:])[0]
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    del pm, model
    collect_garbage()
    torch.cuda.empty_cache()
    return out


def p19_deep_rank(rank: int, port: int, seed: int, ckdir: str,
                  out_q) -> None:
    """19c's first half on one of four gloo ranks on cuda:0."""
    import traceback

    try:
        from flexflow_tpu_torch.runtime.distributed import init_distributed

        init_distributed(f"localhost:{port}", P19_DEEP_STAGES, rank,
                         local_device_ids=[0], backend="gloo")
        out_q.put((rank, "ok", p19_deep(seed, P19_DEEP_STAGES, ckdir)))
    except Exception:  # the parent fails the phase with it
        out_q.put((rank, "error", traceback.format_exc()))


def p19_spawn(target, world: int, args, tag: str) -> dict:
    """`world` spawned ranks running target(rank, *args, out_q): their
    results by rank; every process is joined or killed before this
    returns."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, *args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < world:
            try:
                r, kind, val = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in res and not p.is_alive()]
                if dead and q.empty():
                    fail(f"{tag}: ranks {dead} ended with exit codes "
                         f"{[procs[i].exitcode for i in dead]} and no result")
                if time.perf_counter() - t0 > P19_TIMEOUT_S:
                    fail(f"{tag}: ranks {sorted(set(range(world)) - set(res))}"
                         f" did not finish in {P19_TIMEOUT_S} s")
                continue
            if kind != "ok":
                fail(f"{tag} rank {r}:\n{val}")
            res[r] = val
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(5)
    return res


def p19_world1(seed: int) -> dict:
    """The world-1 twins in this process: config #5 at accum_steps=4 under
    Adam (19a's), and with the padded vocab under SGD (19b's), from the
    seed's weights, one fit an update on the ranks' groups."""
    from flexflow_tpu_torch import SGDOptimizer

    out = {}
    for tag, opt, pad, updates, dseed in (
            ("19a", None, 0, P19_UPDATES, seed),
            ("19b", SGDOptimizer(lr=SGD_LR), PAD_TO, P19_SGD_UPDATES,
             seed + 1)):
        gc, model, cm = gpt2_train_model(seed, LAYERS, "bfloat16",
                                         optimizer=opt, vocab_pad_to=pad,
                                         accum_steps=P19_MICRO)
        zero_launch_counts()
        ms = []
        losses = p19_fit(cm, p19_chunks(dseed, GPT2_VOCAB, updates), ms)
        mem = cm.memory_stats()
        out[tag] = {"losses": losses, "launches": launch_counts(),
                    "param_bytes": mem["actual_param_bytes_per_device"],
                    "opt_bytes": mem["actual_opt_state_bytes_per_device"],
                    "update_ms": ms,
                    "update_ms_in_fit": float(np.median(ms[1:]))}
        del cm, model
        collect_garbage()
        torch.cuda.empty_cache()
    return out


def p19_rel(got, ref) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, ref))


def phase19(seed: int) -> dict:
    """Phase 19: the pipeline (module docstring): 19d and 19a-19b in two
    ranks, 19c in four then two, against this process's world-1 twins."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    card = card_line()
    walls = {}
    t0 = time.perf_counter()
    w1 = p19_world1(seed)
    walls["world1"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="ff_p19_")
    try:
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        deep4 = p19_spawn(p19_deep_rank, P19_DEEP_STAGES,
                          (_free_port(), seed, ck), "19c S=4")
        walls["19c_s4"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = p19_spawn(p19_rank, 2, (_free_port(), seed,
                                      os.path.join(tmp, "cache"), ck), "19")
        walls["19dab_19c_s2"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    deep2 = {r: res[r]["19c"] for r in (0, 1)}
    out = {"card": card, "world1": w1}
    # 19d: the cut search and the warm cache
    d = res[0]["19d"]
    out["19d"] = d
    log(f"[19d] config #5 at S = {P19_STAGES}, M = {P19_MICRO} on "
        f"{d['machine']} ({d['chip']} preset), stage machine "
        f"{d['stage_machine']}: cuts {d['cuts']}, search's step "
        f"{d['search_cost_s']} s and bubble {d['search_bubble']}, the "
        f"compile's predicted makespan {d['predicted_makespan_s']} s and "
        f"bubble {d['predicted_bubble']}; {d['compile_s']:.2f} s to compile "
        f"({d['cold_expansions']} DP expansions); again: "
        f"{d['warm_event']}, {d['warm_expansions']} expansions, "
        f"{d['warm_compile_s']:.2f} s; {card}")
    if not (d["warm_event"] == "hit" and d["warm_expansions"] == 0
            and d["warm_calls"] == 0 and d["warm_cuts"] == d["cuts"]
            and d["cold_expansions"] > 0 and res[1]["19d"]["cuts"] ==
            d["cuts"]):
        fail(f"19d: {d}")
    # 19a: the schedules, the twin, bytes a rank, launches
    a = {s: {r: res[r]["19a"][s] for r in (0, 1)} for s in ("1f1b", "gpipe")}
    ref = w1["19a"]["losses"]
    fb, gp = a["1f1b"], a["gpipe"]
    bitwise = (fb[0]["losses"] == gp[0]["losses"] == fb[1]["losses"]
               and all(fb[r]["digest"] == gp[r]["digest"] for r in (0, 1)))
    rel = p19_rel(fb[0]["losses"], ref)
    mem = fb[0]["mem"]
    pb, ob = mem["per_stage_param_bytes"], mem["per_stage_opt_bytes"]
    shares = [x / sum(pb) for x in pb] + [x / sum(ob) for x in ob]
    lead = fb[0]
    row = {"losses_1f1b": fb[0]["losses"], "losses_gpipe": gp[0]["losses"],
           "losses_world1": ref, "rel_err_vs_world1": rel,
           "bitwise_1f1b_gpipe": bitwise, "cuts": lead["cuts"],
           "per_stage_param_bytes": pb, "per_stage_opt_bytes": ob,
           "world1_param_bytes": w1["19a"]["param_bytes"],
           "world1_opt_bytes": w1["19a"]["opt_bytes"],
           "update_ms_in_fit": {r: fb[r]["update_ms_in_fit"] for r in (0, 1)},
           "world1_update_ms_in_fit": w1["19a"]["update_ms_in_fit"],
           "profile_rank0": lead["profile"],
           "profile_rank1": fb[1]["profile"],
           "profiled_port_kernels": {r: fb[r]["profiled_port_kernels"]
                                     for r in (0, 1)},
           "measured_bubble": lead["measured_bubble"],
           "predicted": lead["predicted"],
           "launches": {f"{s}_rank{r}": a[s][r]["launches"]
                        for s in a for r in (0, 1)},
           "init_draw_s": lead["init_draw_s"],
           "compile_init_s": lead["compile_init_s"]}
    out["19a"] = row
    log(f"[19a] config #5 over {P19_STAGES} stages (cuts {lead['cuts']}) on "
        f"two gloo ranks sharing cuda:0, M = {P19_MICRO}: 1F1B losses "
        f"{fb[0]['losses']}, GPipe {gp[0]['losses']}, bitwise "
        f"{bitwise}; world 1 at accum_steps={P19_MICRO} {ref} (max rel "
        f"{rel:.3e}, limit {P19_LOSS_RTOL}); ms an update in fit "
        f"{row['update_ms_in_fit']} (world 1 "
        f"{w1['19a']['update_ms_in_fit']:.1f}); profiled update rank 0 "
        f"{lead['profile']}, rank 1 {fb[1]['profile']}; measured bubble "
        f"{lead['measured_bubble']} against predicted "
        f"{lead['predicted']['bubble']} (closed form "
        f"{lead['predicted']['bubble_closed_form']}); param bytes a stage "
        f"{pb}, moment bytes {ob} (world 1 {w1['19a']['param_bytes']}, "
        f"{w1['19a']['opt_bytes']}); init draw {lead['init_draw_s']:.2f} s; "
        f"{card}")
    bad = [f"{s} rank {r}" for s in a for r in (0, 1)
           if a[s][r]["launches"] != a[s][r]["want"]]
    for r in (0, 1):
        pk = fb[r]["profiled_port_kernels"]
        want = fb[r]["want"]
        per = {"flash_fwd_tc_kernel": want["flash_attention_fwd"],
               "flash_dq_tc_kernel": want["flash_attention_dq"],
               "flash_dkv_tc_kernel": want["flash_attention_dkv"],
               "adam_kernel": want["fused_adam"]}
        per = {n: v / P19_UPDATES for n, v in per.items()}
        if {n: pk.get(n) for n in per} != per:
            bad.append(f"profiled rank {r}: {pk} vs {per}")
    if not bitwise or rel > P19_LOSS_RTOL or bad or \
            not all(0.3 <= x <= 0.7 for x in shares) or \
            abs(sum(pb) - w1["19a"]["param_bytes"]) > 0.01 * sum(pb):
        fail(f"19a: {row} {bad}")
    # 19b: the fused CE in the last stage, plain SGD on both
    b = {r: res[r]["19b"] for r in (0, 1)}
    rel_b = p19_rel(b[0]["losses"], w1["19b"]["losses"])
    out["19b"] = {"losses": b[0]["losses"],
                  "losses_world1": w1["19b"]["losses"], "rel": rel_b,
                  "launches": {f"rank{r}": b[r]["launches"]
                               for r in (0, 1)},
                  "wall_s": b[0]["wall_s"]}
    log(f"[19b] the padded vocab under SGD over {P19_STAGES} stages, 1F1B: "
        f"losses {b[0]['losses']} (world 1 {w1['19b']['losses']}, max rel "
        f"{rel_b:.3e}); launches rank 0 {b[0]['launches']}, rank 1 "
        f"{b[1]['launches']}; {card}")
    if rel_b > P19_LOSS_RTOL or b[0]["losses"] != b[1]["losses"] or any(
            b[r]["launches"] != b[r]["want"] for r in (0, 1)):
        fail(f"19b: {out['19b']} want {[b[r]['want'] for r in (0, 1)]}")
    # 19c: S = 4 saved, restored onto S = 2
    ref_next = deep4[0]["next"]
    got_next = deep2[0]["next"]
    rel_c = abs(got_next - ref_next) / abs(ref_next)
    out["19c"] = {"layers": P19_DEEP_LAYERS,
                  "cuts_s4": deep4[0]["cuts"], "cuts_s2": deep2[0]["cuts"],
                  "losses_s4": deep4[0]["losses"], "next_s4": ref_next,
                  "next_s2_restored": got_next, "rel": rel_c,
                  "saved_iteration": deep4[0]["saved_iteration"],
                  "restored_iteration": deep2[0]["restored_iteration"],
                  "save_s": deep4[0]["save_s"],
                  "restore_s": deep2[0]["restore_s"],
                  "wall_s": {"s4": deep4[0]["wall_s"],
                             "s2": deep2[0]["wall_s"]}}
    log(f"[19c] config #5's width at {P19_DEEP_LAYERS} layers over "
        f"{P19_DEEP_STAGES} stages (cuts {deep4[0]['cuts']}): 2 updates "
        f"{deep4[0]['losses']}, a snapshot ({deep4[0]['save_s']:.1f} s), the "
        f"next update {ref_next}; restored onto 2 stages (cuts "
        f"{deep2[0]['cuts']}, {deep2[0]['restore_s']:.1f} s): that update "
        f"{got_next} (rel {rel_c:.3e}, limit {P19_LOSS_RTOL}); {card}")
    if rel_c > P19_LOSS_RTOL or deep2[0]["restored_iteration"] != \
            deep4[0]["saved_iteration"] or \
            any(o["next"] != ref_next for o in deep4.values()) or \
            any(o["next"] != got_next for o in deep2.values()):
        fail(f"19c: {out['19c']}")
    out["walls_s"] = walls
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase 19] {out['wall_s']:.1f} s on {card} ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return out


def ring_program_rows(p18: dict, card: str) -> list:
    """The `ring_programs` line: the two shard_map programs of the JAX
    package, ported as rings on the kernels above."""
    a = p18["18a"]
    legs = p18["18c"]["legs"]
    ring_launches = p18["18b"]["launches"]["ring_attention"]
    if "ring" in legs:
        ring_launches += (legs["ring"]["launches"]["ring_attention"]
                          + legs["ring"]["launches_rank1"]["ring_attention"])
    rows = [{"name": "ring_attention", "route": "cuda",
             "source": "flexflow_tpu_torch/kernels/ring_attention.py",
             "replaces": "flexflow_tpu/kernels/ring_attention.py:151",
             "launches": ring_launches,
             "max_abs_err": max(r["errors_vs_whole"]["out_max_abs"]
                                for r in a["by_p"].values()),
             "ms": a["by_p"][2]["ms"], "plain_ms": a["plain_ms"],
             "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
             "library_ms": a["library_ms"],
             "whole_sequence_ms": a["whole_ms"],
             "ms_by_p": {p: r["ms"] for p, r in a["by_p"].items()},
             "err_note": "max |out - #1 over the sequence|, P = 2 and 4",
             "card": card}]
    if "ring_check" in legs:
        rows[0]["errors_two_ranks"] = legs["ring_check"]["errors_vs_whole"]
    if "collective_matmul" in legs:
        c = legs["collective_matmul"]
        m, k, n = P18_CMM
        per_rank = (m * k + k * n // 2 + m * n // 2) * 2
        b_ms, b_by = bound(per_rank, 2.0 * m * k * n / 2, BF16_FLOPS)
        rows.append({
            "name": "collective_matmul", "route": "cuda",
            "source": "flexflow_tpu_torch/kernels/collective_matmul.py",
            "replaces": "flexflow_tpu/kernels/collective_matmul.py:77",
            "launches": c["launches"] + c["launches_rank1"],
            "max_abs_err": max(c["y_max_abs_err"],
                               c["y_max_abs_err_rank1"]),
            "ms": c["ms"]["ring"], "plain_ms": c["ms"]["plain"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": c["ms"]["library"],
            "err_note": "max |y - f32 x @ w| on either rank",
            "card": card})
    return rows


# ------------------------------------------------ phase 20: serving over a mesh
# 20b's mesh: a unit batch axis beside the model axis, so the serving
# searches may shard the heads (on a one-axis mesh the slots take its
# only axis); its requests and new tokens (one wave of the 8 slots: the
# time limit's cut of phase 3's 16 x 32; 4 new tokens since phase 21 ran
# in its ranks, 8 before), and the teacher-forced steps
P20_MESH = {"data": 1, "model": 2}
P20_REQUESTS, P20_NEW_TOKENS, P20_TF_STEPS = 8, 4, 4
P20_BUDGET = 16
# each last-position logit of 20b against world 1's, as a share of the
# largest |logit| of world 1's call: bf16 both sides, and each layer's two
# row-parallel products round their halves to bf16 before the sum (one
# rounding world 1 does not take), 48 of them over 24 layers
P20_LOGIT_TOL = 2.0 ** -5
P20_TIMEOUT_S = 420


def p20_engine(seed: int, kv: str, mesh=None, cache_dir: str = ""):
    """GPT-2 medium's serving engine as phase 3 builds it, with
    `search_budget=P20_BUDGET`, over `mesh` when one is given."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.serving import compile_serving

    cfg = FFConfig(seed=seed, compute_dtype="bfloat16",
                   max_batch_slots=SLOTS, kv_page_size=PAGE,
                   max_decode_len=NEW_TOKENS, kv_cache_dtype=kv,
                   search_budget=P20_BUDGET, mesh_shape=dict(mesh or {}),
                   strategy_cache_dir=cache_dir,
                   strategy_cache=bool(cache_dir))
    model = FFModel(cfg)
    build_gpt2(model, GPT2Config.medium(), batch=SLOTS)
    return compile_serving(model)


def p20_teacher(engine, params, prompts, feed=None,
                steps: int = P20_TF_STEPS):
    """The first wave's prompts prefilled into every slot, then `steps`
    decode steps: the last-position logits of each call (f32, on the
    host) and the tokens fed, world 1's greedy ones when `feed` is None
    (steps x slots), else `feed`'s. The cache is left empty."""
    from flexflow_tpu_torch.serving import gpt2_prompt_inputs, gpt2_step_inputs

    kv, slots, dev = engine.kv, engine.slots, engine.device
    ids = np.zeros((slots, SEQ), np.int32)
    lengths = np.zeros((slots,), np.int32)
    for s, p in enumerate(prompts[:slots]):
        ids[s, :len(p)], lengths[s] = p, len(p)
        kv.admit(s, len(p), len(p) + NEW_TOKENS)
    kv.push()
    rows = torch.arange(slots, device=dev)
    with torch.no_grad():
        logits, kv_state = engine.prefill(params,
                                          gpt2_prompt_inputs(ids, lengths))
        kv.commit_prefill(kv_state, np.arange(slots, dtype=np.int32),
                          lengths)
        out = [logits[rows, torch.from_numpy(lengths - 1).to(dev)]
               .float().cpu()]
        state, fed = kv.state, []
        for t in range(steps):
            tok = out[-1].argmax(-1) if feed is None else feed[t]
            fed.append(tok.to(torch.int32))
            logits, state = engine.decode_step(
                params, state, gpt2_step_inputs(
                    tok.to(torch.int32).to(dev)[:, None], state))
            out.append(logits[:, -1].float().cpu())
    kv.adopt(state)
    kv.sync_after(steps)
    for s in range(slots):
        kv.evict(s)
    kv.push()
    return torch.stack(out), torch.stack(fed)


def p20_serve(engine, params, prompts) -> tuple:
    """`P20_REQUESTS` requests of `P20_NEW_TOKENS` through the scheduler,
    every launch counter 0 just before: (summary, streams)."""
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    reqs = [Request(rid=i, prompt=p, max_new_tokens=P20_NEW_TOKENS)
            for i, p in enumerate(prompts[:P20_REQUESTS])]
    sched = ContinuousBatchingScheduler(engine, params, gpt2_prompt_inputs,
                                        gpt2_step_inputs)
    sync(engine.device)
    zero_launch_counts()
    t0 = time.perf_counter()
    done = sched.run(reqs)
    sync(engine.device)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if len(done) != len(reqs) or sched.shed or sched.failed:
        fail(f"20: {len(done)} of {len(reqs)} requests completed")
    tokens = sum(len(r.tokens) for r in done)
    ttft = np.array([r.ttft_s for r in done])
    return ({"requests": len(done), "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
             "decode_step_p50_ms": 1e3 * float(np.median(sched.step_times)),
             "prefills": sched.prefills, "decode_steps": sched.decode_steps,
             "launches": counts},
            {r.rid: list(r.tokens) for r in done})


def _p20_layouts(engine) -> dict:
    """The searched layouts phase 20 prints: each program's weight dims
    of the embeddings, the first block's attention and MLP, lm_head."""
    names = ("wte", "h0_attn", "h0_mlp_up", "h0_mlp_down", "lm_head")
    out = {}
    for tag, st in (("prefill", engine.prefill_strategy),
                    ("decode", engine.decode_strategy)):
        out[tag] = {n: {w: d for w, d in st.sharding_for(n).weights.items()
                        if w in ("kernel", "wq", "wo")} for n in names}
    return out


def p20_rank(rank: int, port: int, seed: int, refs_path: str,
             cache_dir: str, out_q) -> None:
    """20b's rank: a gloo group of two on cuda:0; for int8 and bf16 KV the
    searched engine over P20_MESH, its layouts and bytes, the
    teacher-forced logits against world 1's, the profiled launches, and
    the served requests."""
    import traceback

    def say(msg):
        print(f"[20b rank {rank}] {msg}", flush=True)

    try:
        from flexflow_tpu_torch.kernels import flash_attention as fa
        from flexflow_tpu_torch.ops import attention_ops as ao
        from flexflow_tpu_torch.runtime.distributed import init_distributed
        from flexflow_tpu_torch.serving.program import attn_head_degree

        init_distributed(f"localhost:{port}", 2, rank, local_device_ids=[0],
                         backend="gloo")
        dev = torch.device("cuda", 0)
        refs = torch.load(refs_path, weights_only=False)
        prompts = refs["prompts"]
        legs = {}
        for kv in ("int8", "auto"):
            t0 = time.perf_counter()
            engine = p20_engine(seed, kv, P20_MESH, cache_dir)
            params = engine.init(seed=seed)
            sync(dev)
            t_compile = time.perf_counter() - t0
            mem = engine.memory_stats()
            leg = {"layouts": _p20_layouts(engine),
                   "attn_head_degree": attn_head_degree(
                       engine.decode_strategy, engine.attn_layers,
                       engine.machine),
                   "prefill_head_degree": attn_head_degree(
                       engine.prefill_strategy, engine.attn_layers,
                       engine.machine),
                   "kv_shard_degree": engine.kv_shard_degree,
                   "local_heads": engine.kv.local_heads,
                   "kv_bytes_per_rank": mem["actual_kv_cache_bytes_per_device"],
                   "param_bytes_per_rank":
                       mem["actual_param_bytes_per_device"],
                   "predicted_kv_bytes": mem["predicted_kv_cache_bytes"],
                   "compile_s": t_compile}
            say(f"[{kv}] compiled in {t_compile:.1f} s: head degree "
                f"{leg['attn_head_degree']}, kv_shard_degree "
                f"{leg['kv_shard_degree']}, KV {leg['kv_bytes_per_rank']} B "
                f"a rank")
            # the heads each kernel call sees (the rank's block: #1 takes
            # (b, h, s, d), #4 (b, s, h, d)), and its launches, over the
            # teacher-forced calls
            seen = {"flash": set(), "dequant": set()}
            flash0, deq0 = fa.flash_attention, \
                ao.paged_dequant_decode_attention

            def flash_rec(q, *a, **k):
                seen["flash"].add(int(q.shape[1]))
                return flash0(q, *a, **k)

            def deq_rec(qh, *a, **k):
                seen["dequant"].add(int(qh.shape[2]))
                return deq0(qh, *a, **k)
            fa.flash_attention, ao.paged_dequant_decode_attention = \
                flash_rec, deq_rec
            zero_launch_counts()
            try:
                got, _ = p20_teacher(engine, params, prompts,
                                     feed=refs[kv]["fed"])
            finally:
                fa.flash_attention, ao.paged_dequant_decode_attention = \
                    flash0, deq0
            sync(dev)
            leg["teacher_launches"] = launch_counts()
            leg["heads_seen"] = {k: sorted(v) for k, v in seen.items()}
            want = refs[kv]["logits"]
            scale = want.abs().amax(dim=-1).amax(dim=-1)      # per call
            err = (got - want).abs().amax(dim=-1).amax(dim=-1) / scale
            leg["logit_err_share"] = [float(e) for e in err]
            leg["logit_abs_max"] = [float(x) for x in scale]
            leg["argmax_agree"] = float(
                (got.argmax(-1) == want.argmax(-1)).float().mean())
            say(f"[{kv}] teacher-forced logits, error as a share of the "
                f"largest: max {max(leg['logit_err_share']):.3e}; heads "
                f"a kernel call {leg['heads_seen']}; launches "
                f"{leg['teacher_launches']}")
            if kv == "int8":
                # the profile: one counted prefill, then one counted decode
                # step, each window after a lead call
                from flexflow_tpu_torch.serving import (gpt2_prompt_inputs,
                                                        gpt2_step_inputs)

                kvc = engine.kv
                ids = np.zeros((SLOTS, SEQ), np.int32)
                lengths = np.zeros((SLOTS,), np.int32)
                for s, p in enumerate(prompts[:SLOTS]):
                    ids[s, :len(p)], lengths[s] = p, len(p)
                    kvc.admit(s, len(p), len(p) + NEW_TOKENS)
                kvc.push()
                inputs = gpt2_prompt_inputs(ids, lengths)

                def pre():
                    with torch.no_grad():
                        engine.prefill(params, inputs)
                prof = {"prefill": _device_profile(pre, 1, dev, lead=pre)}
                with torch.no_grad():
                    _, kv_state = engine.prefill(params, inputs)
                kvc.commit_prefill(kv_state, np.arange(SLOTS, dtype=np.int32),
                                   lengths)
                box = {"state": kvc.state,
                       "tok": torch.ones((SLOTS, 1), dtype=torch.int32,
                                         device=dev)}

                def step():
                    st = box["state"]
                    with torch.no_grad():
                        logits, box["state"] = engine.decode_step(
                            params, st, gpt2_step_inputs(box["tok"], st))
                    box["tok"] = logits[:, -1].argmax(-1).to(
                        torch.int32)[:, None]
                prof["decode_step"] = _device_profile(step, 1, dev,
                                                      lead=step)
                kvc.adopt(box["state"])
                kvc.sync_after(2)
                for s in range(SLOTS):
                    kvc.evict(s)
                kvc.push()
                leg["profile"] = {k: {
                    "wall_ms_per_call": v.get("wall_ms_per_call"),
                    "device_busy_ms_per_call":
                        v.get("device_busy_ms_per_call"),
                    "device_idle_share": v.get("device_idle_share"),
                    "port_kernels": v.get("port_kernels")}
                    for k, v in prof.items()}
            run, streams = p20_serve(engine, params, prompts)
            leg["serve"], leg["streams"] = run, streams
            say(f"[{kv}] served: {run['tokens_per_s']:.1f} tokens/s, TTFT "
                f"p50 {run['ttft_p50_ms']:.1f} ms, decode step p50 "
                f"{run['decode_step_p50_ms']:.2f} ms, launches "
                f"{run['launches']}")
            legs[kv] = leg
            del engine, params
            collect_garbage()
            torch.cuda.empty_cache()
        if "p21" in refs:
            # phase 21 in these ranks, as 18c runs in 17b's
            legs["21"] = p21_legs(rank, seed, refs["p21"],
                                  os.path.dirname(refs_path))
        out_q.put((rank, "ok", legs))
    except BaseException:  # fail()'s exit too: the parent fails the phase
        out_q.put((rank, "error", traceback.format_exc()))
        raise


def phase20(seed: int, prompts, streams: dict, p21: dict = None) -> dict:
    """20a and 20b (the module docstring); with `p21` (`p21_inputs`),
    20b's ranks go on to phase 21's legs, whose results come back in
    `out["21"]`."""
    import queue as queue_mod
    import tempfile

    import torch.multiprocessing as mp

    from flexflow_tpu_torch.search import dp

    t0 = time.perf_counter()
    card = card_line()
    out = {"card": card, "20a": {}, "20b": {}}
    refs = {"prompts": prompts}
    if p21 is not None:
        refs["p21"] = p21
    for kv in ("auto", "int8"):
        e0 = dp.SEARCH_STATS.get("expansions", 0)
        engine = p20_engine(seed, kv)
        params = engine.init(seed=seed)
        run, got = serve(engine, params, prompts, f"20a {kv}")
        names = {engine.prefill_strategy.name, engine.decode_strategy.name}
        leg = dict(run, strategies=sorted(names),
                   expansions=dp.SEARCH_STATS.get("expansions", 0) - e0,
                   bitwise_phase3=got == streams[kv],
                   kv_bytes=engine.memory_stats()[
                       "actual_kv_cache_bytes_per_device"])
        out["20a"][kv] = leg
        log(f"[20a {kv}] world 1, search_budget={P20_BUDGET}: strategies "
            f"{leg['strategies']}, {leg['expansions']} DP expansions, "
            f"streams bitwise phase 3's: {leg['bitwise_phase3']}; "
            f"{run['tokens_per_s']:.1f} tokens/s; {card}")
        if not leg["bitwise_phase3"] or leg["expansions"]:
            fail(f"20a {kv}: {leg}")
        # world 1's references for 20b: teacher-forced logits, the tokens
        # fed, the served streams and the host's times
        logits, fed = p20_teacher(engine, params, prompts)
        w1, w1_streams = p20_serve(engine, params, prompts)
        refs[kv] = {"logits": logits, "fed": fed, "streams": w1_streams,
                    "serve": w1, "kv_bytes": leg["kv_bytes"]}
        del engine, params
        collect_garbage()
        torch.cuda.empty_cache()
    t_a = time.perf_counter() - t0

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ff_p20_") as tdir:
        refs_path = os.path.join(tdir, "refs.pt")
        torch.save(refs, refs_path)
        cache_dir = os.path.join(tdir, "strategy")
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        port = _free_port()
        procs = [ctx.Process(target=p20_rank,
                             args=(r, port, seed, refs_path, cache_dir, q))
                 for r in range(2)]
        for p in procs:
            p.start()
        res = {}
        try:
            while len(res) < 2:
                try:
                    r, kind, val = q.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if i not in res and not p.is_alive()]
                    if dead and q.empty():
                        fail(f"20b: ranks {dead} ended with exit codes "
                             f"{[procs[i].exitcode for i in dead]} and no "
                             "result")
                    if time.perf_counter() - t1 > P20_TIMEOUT_S:
                        fail(f"20b: ranks {sorted({0, 1} - set(res))} did "
                             f"not finish in {P20_TIMEOUT_S} s")
                    continue
                if kind != "ok":
                    fail(f"20b rank {r}:\n{val}")
                res[r] = val
        finally:
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join(5)
    t_b = time.perf_counter() - t1
    if p21 is not None:
        out["21"] = {r: res[r].pop("21") for r in res}
        t_b -= out["21"][0]["wall_s"]
    for kv in ("int8", "auto"):
        a, b = res[0][kv], res[1][kv]
        ref = refs[kv]
        streams_b = a.pop("streams")
        agree = [sum(x == y for x, y in zip(streams_b[i], ref["streams"][i]))
                 / len(ref["streams"][i]) for i in sorted(ref["streams"])]
        prefix = [next((j for j, (x, y) in enumerate(
            zip(streams_b[i], ref["streams"][i])) if x != y),
            len(ref["streams"][i])) for i in sorted(ref["streams"])]
        leg = dict(a, greedy_agreement=float(np.mean(agree)),
                   common_prefix=prefix,
                   ranks_same_streams=streams_b == b.pop("streams"),
                   kv_bytes_world1=ref["kv_bytes"],
                   serve_world1=ref["serve"],
                   launches_rank1=b["serve"]["launches"],
                   teacher_launches_rank1=b["teacher_launches"],
                   logit_err_share_rank1=b["logit_err_share"])
        out["20b"][kv] = leg
        dec = leg["layouts"]["decode"]
        log(f"[20b {kv}] {card}: decode layouts {dec}; prefill layouts "
            f"{leg['layouts']['prefill']}")
        log(f"[20b {kv}] attn_head_degree {leg['attn_head_degree']} "
            f"(prefill {leg['prefill_head_degree']}), heads a kernel call "
            f"{leg['heads_seen']}, "
            f"kv_shard_degree {leg['kv_shard_degree']}, KV bytes a rank "
            f"{leg['kv_bytes_per_rank']} against world 1's "
            f"{ref['kv_bytes']}; logits within "
            f"{max(leg['logit_err_share']):.3e} (rank 1 "
            f"{max(leg['logit_err_share_rank1']):.3e}) of the largest, "
            f"limit {P20_LOGIT_TOL:.3e}; argmax agreement "
            f"{leg['argmax_agree']:.3f}; greedy agreement "
            f"{leg['greedy_agreement']:.3f}, common prefixes {prefix}")
        log(f"[20b {kv}] the host's cost of the mesh on one card ({card}): "
            f"{leg['serve']['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{leg['serve']['ttft_p50_ms']:.1f} ms, decode step p50 "
            f"{leg['serve']['decode_step_p50_ms']:.2f} ms; world 1 "
            f"{ref['serve']['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{ref['serve']['ttft_p50_ms']:.1f} ms, decode step p50 "
            f"{ref['serve']['decode_step_p50_ms']:.2f} ms")
        if "profile" in leg:
            log(f"[20b {kv}] profiled (rank 0, after a lead call): " + "; ".join(
                f"{k}: {v['wall_ms_per_call']:.2f} ms wall, busy "
                f"{v['device_busy_ms_per_call']:.2f} ms, idle "
                f"{v['device_idle_share']:.3f}, port kernels "
                f"{v['port_kernels']}" for k, v in leg["profile"].items()))
        half = HEADS // 2
        want_tf = {n: 0 for n in leg["teacher_launches"]}
        want_tf["flash_attention_fwd"] = LAYERS
        want_srv = {n: 0 for n in leg["serve"]["launches"]}
        want_srv["flash_attention_fwd"] = LAYERS * leg["serve"]["prefills"]
        if kv == "int8":
            want_tf["dequant_decode_attention"] = LAYERS * P20_TF_STEPS
            want_srv["dequant_decode_attention"] = \
                LAYERS * leg["serve"]["decode_steps"]
        bad = []
        if leg["attn_head_degree"] != 2 or leg["kv_shard_degree"] != 2 or \
                leg["local_heads"] != half:
            bad.append("the decode search did not shard the heads in two")
        if 2 * leg["kv_bytes_per_rank"] != ref["kv_bytes"]:
            bad.append("KV bytes a rank are not half of world 1's")
        # #1 runs the rank's heads of the prefill layout (every head where
        # the prefill search replicates the attention), #4 the cache's
        if leg["heads_seen"]["flash"] != [
                HEADS // leg["prefill_head_degree"]] or (
                kv == "int8" and leg["heads_seen"]["dequant"] != [half]):
            bad.append(f"kernel calls saw heads {leg['heads_seen']}")
        if leg["teacher_launches"] != want_tf or \
                leg["teacher_launches_rank1"] != want_tf:
            bad.append(f"teacher-forced launches, want {want_tf}")
        if leg["serve"]["launches"] != want_srv or \
                leg["launches_rank1"] != want_srv:
            bad.append(f"served launches, want {want_srv}")
        if kv == "int8":
            pk = leg["profile"]
            if pk["prefill"]["port_kernels"].get("flash_fwd_tc_kernel", {}) \
                    .get("launches_per_call") != LAYERS or \
                    pk["decode_step"]["port_kernels"].get(
                        "paged_dequant_decode_kernel", {}).get(
                        "launches_per_call") != LAYERS:
                bad.append(f"profiled kernels {pk}")
        if max(leg["logit_err_share"] + leg["logit_err_share_rank1"]) > \
                P20_LOGIT_TOL:
            bad.append("logits past P20_LOGIT_TOL")
        if not leg["ranks_same_streams"]:
            bad.append("the two ranks served different tokens")
        if bad:
            fail(f"20b {kv}: {bad}")
    out["20a_s"], out["20b_s"] = t_a, t_b
    out["wall_s"] = time.perf_counter() - t0
    log(f"[phase 20] {out['wall_s']:.1f} s on {card} (20a {t_a:.1f} s, "
        f"20b {t_b:.1f} s)")
    return out

# --------------------------------------- phase 21: the fleet over a mesh
# two gloo ranks share cuda:0 over P20_MESH, two int8 engines a rank with
# search_budget=P20_BUDGET on phase 13's cut model (SERVE_CUT_LAYERS at
# full width), weights and prompts, P13_HOST_PAGES host pages each; 8 of
# the prompts with 8 new tokens each (20b's cut), arriving at P13_RATE a
# replica
P21_REQUESTS, P21_NEW_TOKENS = 8, 8


def p21_requests(prompts, arrivals):
    from flexflow_tpu_torch.serving import Request

    return [Request(rid=i, prompt=prompts[i], max_new_tokens=P21_NEW_TOKENS,
                    arrival_s=float(a)) for i, a in enumerate(arrivals)]


def p21_legs(rank: int, seed: int, inp: dict, root: str) -> dict:
    """21 on one of 20b's ranks (the module docstring): (a)-(d) on two
    engines over P20_MESH, every check fatal; the logs, launches and host
    times go back to the parent, which holds the ranks against each other.
    `inp` holds phase 13's cut model, weights, prompts and snapshots."""
    import shutil
    import threading

    from flexflow_tpu_torch.health import SLOTracker, parse_slo
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    t_legs = time.perf_counter()
    gc, params, prompts = inp["gc"], inp["params"], inp["prompts"]
    t0 = time.perf_counter()
    engines = [p12_engine(gc, params, "int8", seed,
                          kv_host_pages=P13_HOST_PAGES,
                          mesh_shape=dict(P20_MESH),
                          search_budget=P20_BUDGET,
                          strategy_cache_dir=os.path.join(root, "st"))
               for _ in range(2)]
    sync(engines[0].device)
    out = {"compile_s": time.perf_counter() - t0,
           "kv_shard_degree": engines[0].kv_shard_degree,
           "layouts": [e.kv.head_layout() for e in engines]}
    layers = len(engines[0].attn_layers)
    at0 = [0.0] * P21_REQUESTS
    # (a) one replica against the plain mesh scheduler
    plain = p13_serve(ContinuousBatchingScheduler(
        engines[0], engines[0].params, gpt2_prompt_inputs,
        gpt2_step_inputs), p21_requests(prompts, at0), "21a plain",
        new_tokens=P21_NEW_TOKENS)
    one = p13_serve(p13_fleet([engines[0]]), p21_requests(prompts, at0),
                    "21a one replica", new_tokens=P21_NEW_TOKENS)
    want = plain["streams"]
    if one["streams"] != want:
        fail("21a: the one-replica fleet's streams differ from the plain "
             "mesh scheduler's")
    for k in ("flash_attention_fwd", "dequant_decode_attention"):
        if one["launches"][k] != plain["launches"][k]:
            fail(f"21a: {k} launched {one['launches'][k]} times in the "
                 f"fleet, {plain['launches'][k]} in the plain scheduler")
    if one["runner"].replicas[0].thread is not None:
        fail("21a: the one-replica fleet started a thread")
    p13_exact_launches(plain, "21a plain", layers)
    out["21a"] = {"plain": _p13_summary(plain),
                  "one_replica": _p13_summary(one)}
    # (b) two replicas, colocated then disaggregated, open loop
    arrivals = p13_arrivals(seed + 21, P21_REQUESTS, 2 * P13_RATE)
    trace_path = os.path.join(root, f"fleet_trace_rank{rank}.jsonl")
    engines[0].cfg.serve_trace_out = trace_path
    try:
        colo = p13_serve(p13_fleet(engines, topology="colocated",
                                   router="least_loaded"),
                         p21_requests(prompts, arrivals),
                         "21b colocated", new_tokens=P21_NEW_TOKENS)
    finally:
        engines[0].cfg.serve_trace_out = ""
    before = [dict(e.kv.tier_counters) for e in engines]
    rank_before = [e.kv.handoff_bytes_rank for e in engines]
    dis = p13_serve(p13_fleet(engines, topology="disagg"),
                    p21_requests(prompts, arrivals), "21b disagg",
                    new_tokens=P21_NEW_TOKENS)
    spec = engines[0].kv.spec
    reckoned = sum(engines[0].kv.pages_needed(
        len(p) + P21_NEW_TOKENS + 4) for p in prompts[:P21_REQUESTS])
    want_bytes = reckoned * spec.layers * spec.page_bytes()
    imports = [e.kv.tier_counters["kv_handoffs"] - b["kv_handoffs"]
               for e, b in zip(engines, before)]
    moved = [e.kv.tier_counters["kv_handoff_bytes"] - b["kv_handoff_bytes"]
             for e, b in zip(engines, before)]
    moved_rank = [e.kv.handoff_bytes_rank - b
                  for e, b in zip(engines, rank_before)]
    for run, label in ((colo, "21b colocated"), (dis, "21b disagg")):
        if run["streams"] != want:
            fail(f"{label}: streams differ from (a)'s")
        p13_exact_launches(run, label, layers)
    fleet = dis["runner"]
    if fleet.stats["handoffs"] != P21_REQUESTS or \
            imports != [0, P21_REQUESTS] or \
            sorted(fleet.decisions["handoffs"]) != \
            list(range(P21_REQUESTS)):
        fail(f"21b disagg: {fleet.stats['handoffs']} handoffs, imports "
             f"{imports}, routes {fleet.decisions['handoffs']}")
    if moved != [0, want_bytes] or \
            moved_rank != [0, want_bytes // out["kv_shard_degree"]]:
        fail(f"21b disagg: kv_handoff_bytes {moved} (this rank's "
             f"{moved_rank}), want {want_bytes} ({reckoned} pages x "
             f"{spec.layers} layers x {spec.page_bytes()} B)")
    if colo["runner"].stats["handoffs"]:
        fail("21b colocated: a request was handed off")
    out["21b"] = {"colocated": _p13_summary(colo),
                  "disagg": _p13_summary(dis),
                  "handoff_bytes": want_bytes,
                  "handoff_bytes_rank": moved_rank[1],
                  "handoff_pages": reckoned,
                  "orders": {"colocated": colo["runner"].report()[
                      "stats"]["order"],
                      "disagg": fleet.report()["stats"]["order"]},
                  "wrote_trace": os.path.exists(trace_path)}
    # (d) rank 0 wrote the trace: the twin replays it
    if rank == 0:
        out["21d"] = p13_twin(engines[0], colo["runner"], trace_path,
                              n=P21_REQUESTS, label="21d")
    # (c) the rolling swap, then the rollback and the freeze
    live = os.path.join(root, "live")
    if rank == 0:
        os.makedirs(live)
    staged = inp["snapshots"]
    for e in engines:
        e.slo = SLOTracker(parse_slo(P13_SLO))
    runs = {}
    for step, burn in ((2, 0.0), (3, P13_BURN_MAX)):
        label = f"21c {'rollback' if burn else 'rolling swap'}"
        fleet = p13_fleet(engines, rollout_burn_max=burn)
        prefill, published = engines[0].prefill, threading.Event()

        def publish(p, inputs, prefill=prefill, published=published,
                    step=step):
            res = prefill(p, inputs)
            if not published.is_set():
                if rank == 0:
                    os.replace(staged[step], os.path.join(
                        live, os.path.basename(staged[step])))
                published.set()
            return res
        engines[0].prefill = publish
        seen = {}
        if burn:
            rollback0 = engines[0].rollback

            def judged(*a, rollback0=rollback0, fleet=fleet, **kw):
                res = rollback0(*a, **kw)
                seen["mats1"] = fleet.replicas[1].sched.materializations
                return res
            engines[0].rollback = judged
        try:
            run = p13_serve(fleet, p21_requests(prompts, arrivals), label,
                            new_tokens=P21_NEW_TOKENS, watch_root=live,
                            poll_interval_s=0.0)
        finally:
            for e in engines:
                for name in ("prefill", "rollback"):
                    e.__dict__.pop(name, None)
        if run["streams"] != want:
            fail(f"{label}: streams differ from (a)'s")
        rolling = fleet.rolling
        if burn:
            if rolling.swaps != [(0, 3)] or \
                    rolling.rollbacks != [(0, 2)] or \
                    not rolling.halted or \
                    engines[1].active_version != 2:
                fail(f"{label}: swaps {rolling.swaps}, rollbacks "
                     f"{rolling.rollbacks}, halted {rolling.halted}")
            if fleet.replicas[1].sched.materializations <= \
                    seen.get("mats1", 1 << 30):
                fail(f"{label}: replica 1 served nothing after the "
                     "rollback")
            run["bake_waits"] = rolling.bake_waits
        elif rolling.swaps != [(0, 2), (1, 2)] or rolling.rollbacks or \
                rolling.halted:
            fail(f"{label}: swaps {rolling.swaps}, rollbacks "
                 f"{rolling.rollbacks}")
        run["order"] = fleet.report()["stats"]["order"]
        runs[label] = _p13_summary(run)
    out["21c"] = runs
    out["swap_latency_ms"] = [1e3 * x for e in engines
                              for x in e.swap_stats.latencies_s]
    del engines
    collect_garbage()
    torch.cuda.empty_cache()
    if rank == 0:
        shutil.rmtree(live, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_legs
    print(f"[21 rank {rank}] (a)-(d) passed in {out['wall_s']:.1f} s; "
          f"compile {out['compile_s']:.1f} s", flush=True)
    return out


def p21_inputs(gc, params, prompts, snapshots: dict) -> dict:
    """What 21's legs take into 20b's ranks: phase 13's cut model, its
    weights on the host, the prompts and 13c's snapshots."""
    return {"gc": gc, "prompts": prompts[:P21_REQUESTS],
            "params": {n: {w: t.cpu() for w, t in d.items()}
                       for n, d in params.items()},
            "snapshots": snapshots}


def phase21(res: dict) -> dict:
    """21 (the module docstring): the two ranks' results (run in 20b's
    ranks, after its legs) held against each other and reported."""
    card = card_line()
    a, b = res[0], res[1]
    bad = []
    if a["21b"]["orders"] != b["21b"]["orders"]:
        bad.append("21b: rank 1's routes and handoffs differ from rank 0's")
    for label in a["21c"]:
        if a["21c"][label]["order"] != b["21c"][label]["order"]:
            bad.append(f"{label}: rank 1's swaps or routes differ from "
                       "rank 0's")
    if (a["21b"]["wrote_trace"], b["21b"]["wrote_trace"]) != (True, False):
        bad.append("21b: the trace was not written by rank 0 alone")
    if a["kv_shard_degree"] != 2 or a["layouts"][0] != a["layouts"][1]:
        bad.append(f"21: kv_shard_degree {a['kv_shard_degree']}, layouts "
                   f"{a['layouts']}")
    if bad:
        fail(f"21: {bad}")
    out = {"card": card, "ranks": res, "wall_s": a["wall_s"]}
    for tag in ("colocated", "disagg"):
        r0, r1 = a["21b"][tag], b["21b"][tag]
        log(f"[21b {tag}] {card}: streams = (a)'s on both ranks; rank 0 "
            f"{r0['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{r0['ttft_p50_ms']:.1f} ms, decode step p50 "
            f"{r0['decode_step_p50_ms']:.2f} ms (the host's cost: gloo's "
            f"host copies); rank 1 TTFT p50 {r1['ttft_p50_ms']:.1f} ms; "
            f"{r0['prefills']} prefills, {r0['decode_steps']} decode steps, "
            f"launches {r0['launches']}")
    log(f"[21b] {P21_REQUESTS} handoffs, {a['21b']['handoff_bytes']} B "
        f"({a['21b']['handoff_pages']} pages; each rank's host tier "
        f"{a['21b']['handoff_bytes_rank']} B, its 8 heads); every rank's "
        f"routes and handoffs rank 0's: {a['21b']['orders']}")
    for label, run in a["21c"].items():
        log(f"[{label}] {card}: order {run['order']['swaps']} swaps, "
            f"{run['order']['rollbacks']} rollbacks, the same on both ranks; "
            f"{run['requests']} of {P21_REQUESTS} completed, streams = (a)'s"
            + (f"; replica 1 held {run['bake_waits']} times by the bake"
               if "bake_waits" in run else ""))
    log(f"[21a] {card}: plain mesh scheduler TTFT p50 "
        f"{a['21a']['plain']['ttft_p50_ms']:.1f} ms, decode step p50 "
        f"{a['21a']['plain']['decode_step_p50_ms']:.2f} ms; the one-replica "
        f"fleet bitwise it, launches equal")
    log(f"[phase 21] {out['wall_s']:.1f} s on {card} (in 20b's ranks; "
        f"compile {a['compile_s']:.1f} s a rank)")
    return out



# ------------------------------- phase 22: the operator tools on the card
P22_TIMEOUT_S = 300
P22_EXAMPLE = os.path.join("flexflow_tpu_torch", "examples", "native",
                           "transformer_lm.py")
P22_EXAMPLE_ARGS = ("-b", "8", "-e", "1")
P22_CALIBRATE = ("mlp", "gpt2_medium_block")
# the launcher's main in a subprocess, the kernels' counters around it
P22_RUNNER = r"""
import json, sys
from chip_smoke import ShadowKernels, launch_counts, zero_launch_counts
from flexflow_tpu_torch.__main__ import main

zero_launch_counts()
with ShadowKernels() as shadow:
    rc = main(sys.argv[1:])
print("P22D " + json.dumps({"rc": rc, "launches": launch_counts(),
                            "shadow": shadow.report()}))
"""


# what phase 17a leaves in this process's environment for its world-1 group:
# a subprocess that found it would rendezvous as torchrun's rank
P22_DROP_ENV = ("FLEXFLOW_PLATFORM", "FF_LAUNCH_ARGS", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


def _p22_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in P22_DROP_ENV}
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _prom_samples(text: str) -> dict:
    """The sample lines of a Prometheus text export, each parsed; fails on
    a line that does not parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("# "):
            continue
        m = re.fullmatch(r"([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?) (\S+)",
                         line)
        if m is None or not math.isfinite(float(m.group(2))):
            fail(f"22a: a Prometheus line does not parse: {line!r}")
        out[m.group(1)] = float(m.group(2))
    return out


def p22_start(tel_root: str, tmpdir: str) -> dict:
    """22(a) and 22(d) started together: the two tools over each kept
    telemetry directory and the example through the launcher, each a
    subprocess (the tools use no device)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for k in (1, GRAPH_K):
        src = os.path.join(tel_root, f"k{k}-1")
        cmds = {"trace_report": ["flexflow_tpu_torch.tools.trace_report",
                                 src, "--out",
                                 os.path.join(tmpdir, f"k{k}.trace.json")],
                "monitor": ["flexflow_tpu_torch.tools.monitor", src,
                            "--once", "--prom-file",
                            os.path.join(tmpdir, f"k{k}.prom")]}
        for tool, args in cmds.items():
            procs[f"k{k} {tool}"] = [sys.executable, "-m", *args]
    procs["example"] = [sys.executable, "-c", P22_RUNNER,
                        *P22_EXAMPLE_ARGS, os.path.join(repo, P22_EXAMPLE)]
    t0 = time.perf_counter()
    return {"t0": t0, "procs": {
        tag: (cmd, subprocess.Popen(cmd, cwd=tmpdir, env=_p22_env(),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
        for tag, cmd in procs.items()}}


def p22_finish(started: dict, tmpdir: str, p11_runs: dict) -> dict:
    """Wait for 22(a)'s and 22(d)'s subprocesses and check them."""
    from flexflow_tpu_torch.tools.trace_report import validate_chrome

    outs = {}
    for tag, (cmd, proc) in started["procs"].items():
        try:
            out, err = proc.communicate(timeout=P22_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"22: `{' '.join(cmd[1:])}` ran past {P22_TIMEOUT_S} s")
        if proc.returncode != 0:
            fail(f"22: `{' '.join(cmd[1:])}` exited {proc.returncode}:\n"
                 f"{out[-2000:]}\n{err[-3000:]}")
        outs[tag] = out
    res = {"wall_s": time.perf_counter() - started["t0"], "tools": {}}
    for k in (1, GRAPH_K):
        dispatches = p11_runs[f"k{k}"][1]["step_stats"]["dispatches"]
        with open(os.path.join(tmpdir, f"k{k}.trace.json")) as fh:
            doc = json.load(fh)
        problems = validate_chrome(doc)
        spans = sum(e.get("ph") == "X" and e.get("name") == "fit/dispatch"
                    for e in doc["traceEvents"])
        steps = re.search(r"^steps .*\(n=(\d+)\)$",
                          outs[f"k{k} monitor"], re.M)
        with open(os.path.join(tmpdir, f"k{k}.prom")) as fh:
            prom = _prom_samples(fh.read())
        got = {"dispatches": dispatches, "chrome_events":
               len(doc["traceEvents"]), "chrome_problems": problems,
               "chrome_dispatch_spans": spans,
               "monitor_steps": int(steps.group(1)) if steps else None,
               "prom_samples": len(prom),
               "prom_step_time_s": prom.get("flexflow_step_time_seconds"),
               "prom_goodput": prom.get("flexflow_goodput_ratio")}
        log(f"[22a K={k}] trace_report: {got['chrome_events']} Chrome "
            f"events, {spans} fit/dispatch spans, problems {problems}; "
            f"monitor: {got['monitor_steps']} steps, "
            f"{got['prom_samples']} Prometheus samples (step "
            f"{got['prom_step_time_s']} s, goodput {got['prom_goodput']});"
            f" the fit's dispatches {dispatches}")
        if problems or spans != dispatches or \
                got["monitor_steps"] != dispatches or \
                got["prom_step_time_s"] is None or \
                got["prom_goodput"] is None:
            fail(f"22a K={k}: {got}")
        res["tools"][f"k{k}"] = got
    lines = [l for l in outs["example"].splitlines()
             if l.startswith(("P22D ", "FINAL "))]
    ex = json.loads([l for l in lines if l.startswith("P22D ")][-1][5:])
    final = [l for l in lines if l.startswith("FINAL ")]
    loss = float(final[-1].split("loss=")[1]) if final else float("nan")
    ex.update(loss=loss, command="python -m flexflow_tpu_torch "
              + " ".join(P22_EXAMPLE_ARGS) + " " + P22_EXAMPLE)
    batch, epochs = int(P22_EXAMPLE_ARGS[1]), int(P22_EXAMPLE_ARGS[3])
    updates = 4 * epochs  # the example trains on 4 batches an epoch
    # Adam and the fused cross-entropy (GPT-2 tiny's vocab 5120 is a
    # multiple of 128) once an update each
    want = {n: 0 for n in ex["launches"]}
    want.update(fused_adam=updates, fused_ce_fwd=updates,
                fused_ce_bwd=updates)
    log(f"[22d] `{ex['command']}` exited 0: FINAL loss {loss}, launches "
        f"{ex['launches']} (batch {batch}; expected Adam and each CE "
        f"kernel {updates}, the attention on the einsum path at dropout "
        f"0.1)")
    if ex["rc"] != 0 or not math.isfinite(loss) or ex["launches"] != want:
        fail(f"22d: {ex}, expected launches {want}")
    check_shadow(ex["shadow"], ex["launches"], "22d")
    res["example"] = ex
    return res


def p22_attribution() -> dict:
    """22(b): profile_attribution's run on the card and its contract."""
    from flexflow_tpu_torch.tools import profile_attribution

    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    with ShadowKernels() as shadow:
        res = profile_attribution.run(device="cuda", verbose=False)
    torch.cuda.synchronize()
    res["launches"] = launch_counts()
    res["shadow"] = shadow.report()
    res["wall_s"] = time.perf_counter() - t0
    try:
        profile_attribution.verify(res)
    except AssertionError as e:
        fail(f"22b: the attribution contract fails on the card: {e}")
    updates = res["epochs"] * 8  # 64 samples at batch 8 an epoch
    want = {n: 0 for n in res["launches"]}
    want["fused_sgd_plain"] = updates
    log(f"[22b] {res['model']} on {res['device']}: {res['rows']} op rows "
        f"({res['source']}), attributed/step "
        f"{res['attributed_over_step']:.4f} (tolerance "
        f"{res['sum_tolerance']}), step {1e3 * res['step_time_s']:.3f} ms, "
        f"worst mispriced {res['worst_mispriced_op']} (explains "
        f"{res['top_drift_explained']:.3f}), {res['corpus_rows']} corpus "
        f"rows, launches {res['launches']}, {res['wall_s']:.1f} s")
    if res["launches"] != want:
        fail(f"22b: launches {res['launches']}, expected {want}")
    check_shadow(res["shadow"], res["launches"], "22b")
    return res


def p22_calibrate(mc16) -> dict:
    """22(c): calibrate's rows of P22_CALIBRATE on the card (phase 16's
    MeasuredCost for the bf16 ops) and the overlap probe."""
    from flexflow_tpu_torch.tools import calibrate

    collect_garbage()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    with ShadowKernels() as shadow:
        rows, machine = calibrate.calibrate(
            P22_CALIBRATE, device="cuda", measured_costs={"bfloat16": mc16})
    torch.cuda.synchronize()
    counts = launch_counts()
    overlap = calibrate.measure_overlap("cuda")
    out = {"machine": machine.chip, "rows": rows, "launches": counts,
           "shadow": shadow.report(), "overlap": overlap,
           "wall_s": time.perf_counter() - t0}
    for r in rows:
        log(f"[22c] {r['workload']} ({r['compute_dtype']}): analytic "
            f"{r['analytic_ms']:.4f}, simulated {r['simulated_ms']:.4f}, "
            f"measured {r['measured_ms']:.4f}, step {r['step_ms']:.4f} ms "
            f"(windows {[round(w, 4) for w in r['step_windows_ms']]}, "
            f"spread {r['spread']:.3f}, reliable {r['reliable']}); over "
            f"the step {r['analytic_over_step']:.3f} / "
            f"{r['simulated_over_step']:.3f} / "
            f"{r['measured_over_step']:.3f}")
        nums = [r[k] for k in ("analytic_ms", "simulated_ms", "measured_ms",
                               "step_ms", "last_loss")]
        if not all(math.isfinite(x) and x > 0 for x in nums):
            fail(f"22c: {r['workload']}: {r}")
    log(f"[22c] overlap probe: {overlap}; launches {counts}; "
        f"{out['wall_s']:.1f} s on machine {machine.chip}")
    times = [overlap[k] for k in ("t_mm_ms", "t_mem_ms",
                                  "t_both_same_stream_ms",
                                  "t_both_two_streams_ms")]
    if machine.chip != "h100" or not all(
            t is not None and math.isfinite(t) and t > 0 for t in times):
        fail(f"22c: machine {machine.chip}, overlap {overlap}")
    if min(counts[n] for n in ("flash_attention_fwd", "flash_attention_dq",
                               "flash_attention_dkv", "fused_sgd_plain")) \
            <= 0 or any(counts[n] for n in counts if n not in (
                "flash_attention_fwd", "flash_attention_dq",
                "flash_attention_dkv", "fused_sgd_plain")):
        fail(f"22c: launches {counts}")
    check_shadow(out["shadow"], counts, "22c")
    return out


def phase22(tel_root: str, p11_runs: dict, mc16) -> dict:
    """Phase 22 (module docstring), in a temporary directory removed at
    the end."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmpdir = tempfile.mkdtemp(prefix="ff_p22_")
    try:
        started = p22_start(tel_root, tmpdir)
        out = p22_finish(started, tmpdir, p11_runs)
        out["attribution"] = p22_attribution()
        out["calibrate"] = p22_calibrate(mc16)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    collect_garbage()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase 22] {out['wall_s']:.1f} s on {card_line()} (22a and 22d "
        f"{out['wall_s'] - out['attribution']['wall_s'] - out['calibrate']['wall_s']:.1f} s, "
        f"22b {out['attribution']['wall_s']:.1f} s, 22c "
        f"{out['calibrate']['wall_s']:.1f} s)")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on the GPU")

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.kernels._build import build_all, build_log
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.serving import compile_serving

    # TF32 off: float32 products run in full float32 in every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off (torch.backends.cuda.matmul and cudnn)")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build
    kernels = ("flash_attention", "flash_attention_bwd", "dequant_attention",
               "fused_optim", "fused_ce")
    t0 = time.perf_counter()
    paths = build_all(kernels)
    log(f"built {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    # ptxas -v: each entry function's name, then its spills and registers
    for name in kernels:
        for line in build_log(name).splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                log(f"  {name}: {line.strip()[:160]}")

    # ---- 2. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer()
    rows = [check_flash(timer, gen), *check_flash_bwd(timer, gen),
            check_dequant(timer, gen, args.seed), check_adam(timer, gen)]
    torch.cuda.empty_cache()
    # BERT-base's attention (phase 9d): (8, 512, 12, 64), no mask
    bert_attn = (BERT_BATCH, BERT_SEQ, 12, HEAD_DIM)
    rows += [check_flash(timer, gen, bert_attn, causal=False),
             *check_flash_bwd(timer, gen, bert_attn, causal=False)]
    torch.cuda.empty_cache()
    rows += [*check_fused_ce(timer, gen), *check_sgd(timer, gen)]
    torch.cuda.empty_cache()
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        if r.get("counter") in TC_DESIGN:
            log(f"{r['name']}: {r['tflops']:.1f} TFLOP/s, "
                f"{100 * r['bound_share']:.1f}% of its bound "
                f"({r['design']})")
        elif "design" in r:
            log(f"{r['name']}: {100 * r['bound_share']:.1f}% of its bound "
                f"({r['design']})")

    # ---- 3. serve GPT-2 medium, compute-dtype KV then int8 KV
    gc = GPT2Config.medium()
    rng = np.random.default_rng(args.seed)
    prompts = [[int(t) for t in rng.integers(0, gc.vocab, size=n)]
               for n in rng.integers(32, 993, size=REQUESTS)]
    warm = [p[:32] for p in prompts[:2]]
    runs, streams, params = [], {}, None
    for kv in ("auto", "int8"):
        cfg = FFConfig(seed=args.seed, compute_dtype="bfloat16",
                       max_batch_slots=SLOTS, kv_page_size=PAGE,
                       max_decode_len=NEW_TOKENS, kv_cache_dtype=kv)
        model = FFModel(cfg)
        build_gpt2(model, gc, batch=SLOTS)
        t0 = time.perf_counter()
        engine = compile_serving(model)
        params = (engine.init(seed=args.seed) if params is None
                  else engine.load_params(params))
        torch.cuda.synchronize()
        log(f"[{kv}] engine on {engine.device}, params "
            f"{engine.memory_stats()['actual_param_bytes'] / 2**20:.0f} MiB, "
            f"KV cache {engine.memory_stats()['actual_kv_cache_bytes'] / 2**20:.0f}"
            f" MiB, set up in {time.perf_counter() - t0:.1f} s")
        serve(engine, params, warm, f"{kv} warm-up")
        run, streams[kv] = serve(engine, params, prompts, kv)
        log(f"[{kv}] {run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{run['ttft_p50_ms']:.1f} ms p99 {run['ttft_p99_ms']:.1f} ms, "
            f"decode step p50 {run['decode_step_p50_ms']:.2f} ms, "
            f"launches {run['launches']}")
        run["profile"] = profile_engine(engine, params, prompts)
        if kv == "int8":
            # 11f: the same leg with telemetry on
            import tempfile

            with tempfile.TemporaryDirectory(prefix="ff_p11f_") as tdir:
                serve_telemetry = p11_serving(engine, params, prompts, tdir)
        for phase, prof in run["profile"].items():
            if "wall_ms_per_call" in prof:
                log(f"[{kv}] {phase}: {prof['wall_ms_per_call']:.2f} ms wall, "
                    f"device busy {prof['device_busy_ms_per_call']:.2f} ms, "
                    f"idle share {prof['device_idle_share']:.3f}, "
                    f"{prof['kernel_launches_per_call']:.0f} kernel launches"
                    f", {prof['aten_index_per_call']:.0f} aten::index"
                    f", the port's kernels " + ", ".join(
                        f"{n} {k['ms_per_call']:.3f} ms"
                        for n, k in prof["port_kernels"].items()))
        runs.append(run)
        del engine
        torch.cuda.empty_cache()

    flash_runs = [r["launches"]["flash_attention_fwd"] for r in runs]
    deq_runs = [r["launches"]["dequant_decode_attention"] for r in runs]
    if min(flash_runs) <= 0:
        fail(f"flash kernel not launched on the serving path: {flash_runs}")
    if deq_runs[1] <= 0 or deq_runs[0] != 0:
        fail(f"dequant kernel launches per run (auto, int8): {deq_runs}")
    # the int8 decode step reads the pages through the table in the
    # kernel: no per-layer gather, on the host (aten::index; one a step is
    # left, the page ids of the cache writes) or among the top kernels
    step = runs[1]["profile"]["decode_step"]
    gathers = [k for k in step.get("top_kernels", [])
               if "gather" in k["name"] and k["launches_per_call"] >= LAYERS]
    if step.get("aten_index_per_call", 0) >= LAYERS or gathers:
        fail(f"int8 decode step gathers: {step.get('aten_index_per_call')} "
             f"aten::index a step, top kernels {gathers}")

    # ---- 8. speculative serving and SLO-aware admission, on phase 3's
    # weights (cut to SERVE_CUT_LAYERS), prompts and that model's streams
    t8 = time.perf_counter()
    gcc, params, cut_streams, cut_runs = cut_serving(gc, params, prompts,
                                                     args.seed)
    spec = phase8(gcc, params, prompts, cut_streams, args.seed)
    log(f"[phase 8] {time.perf_counter() - t8:.1f} s at "
        f"{SERVE_CUT_LAYERS} layers")
    # phase 12 runs last on these weights: a host copy until then
    params_host = {n: {w: t.cpu() for w, t in d.items()}
                   for n, d in params.items()}
    del params
    torch.cuda.empty_cache()

    # ---- 5. train GPT-2 medium
    flash = {"flash_attention_fwd": LAYERS, "flash_attention_dq": LAYERS,
             "flash_attention_dkv": LAYERS}
    train = {"grad_check": train_grad_check(args.seed)}
    train["full_depth"], cm, inputs, label = train_full(
        args.seed, None, 0, dict(flash, fused_adam=1), "train full depth")
    train["fit"] = train_fit(cm, gc.vocab, args.seed)
    train["profile"] = profile_train(cm, inputs, label, "train")

    def gpt2_data(vocab):
        def make(n, seed):
            ids, pos, labels = train_batch(seed, vocab, n * BATCH)
            return [ids, pos], labels
        return make

    # ---- 10 (5b): the K-step CUDA graph on this model
    graph = {"5b": graph_leg("5b", cm, gpt2_data(gc.vocab), GRAPH_K,
                             args.seed)}
    del cm, inputs, label
    torch.cuda.empty_cache()

    # ---- 5e-5h. GPT-2 medium with the vocab padded to 128, under SGD
    from flexflow_tpu_torch import SGDOptimizer

    def momentum_sgd():
        return SGDOptimizer(lr=SGD_LR, momentum=0.9)
    tag = "train sgd padded"
    sgd = {"grad_check": train_grad_check(args.seed, momentum_sgd, PAD_TO,
                                          GRAD_TOL_SGD, tag)}
    sgd["full_depth"], cm, inputs, label = train_full(
        args.seed, momentum_sgd(), PAD_TO,
        dict(flash, fused_ce_fwd=1, fused_ce_bwd=1, fused_sgd=1),
        f"{tag} full depth")
    sgd["profile"] = profile_train(cm, inputs, label, tag)
    graph["5f"] = graph_leg("5f", cm, gpt2_data(GPT2_VOCAB), GRAPH_K,
                            args.seed)
    del cm, inputs, label
    torch.cuda.empty_cache()
    sgd["accum_fit"] = train_accum_fit(args.seed)

    # ---- 6. GPT-2 medium at its published dropout of 0.1, the vocab
    # padded to 128, Adam: masks and remat (6a), full depth with remat off
    # and "full" (6b: the einsum attention, no flash), remat "full" at
    # dropout 0 (6c: flash twice a layer), fit with preemption and resume
    # (6d)
    from flexflow_tpu_torch import random as ff_random

    ce_adam = dict(fused_ce_fwd=1, fused_ce_bwd=1, fused_adam=1)
    drop = {"masks_remat": dropout_remat_check(args.seed)}
    profiles = {}
    for remat in (False, True):
        tag = f"6b dropout remat {'full' if remat else 'off'}"
        drop[tag], cm, inputs, label = train_full(
            args.seed, None, PAD_TO, ce_adam, tag, DROPOUT,
            timed_steps=P6_TIMED_STEPS, remat=remat)
        profiles[tag] = profile_train(cm, inputs, label, tag,
                                      rng=ff_random.key(args.seed))
        del cm, inputs, label
        torch.cuda.empty_cache()
    for remat in (False, True):
        tag = f"6c dropout 0 remat {'full' if remat else 'off'}"
        exact = dict(ce_adam, flash_attention_fwd=(2 if remat else 1) * LAYERS,
                     flash_attention_dq=LAYERS, flash_attention_dkv=LAYERS)
        drop[tag], cm, inputs, label = train_full(
            args.seed, None, PAD_TO, exact, tag, 0.0,
            timed_steps=P6_TIMED_STEPS, remat=remat)
        profiles[tag] = profile_train(cm, inputs, label, tag)
        del cm, inputs, label
        torch.cuda.empty_cache()
    drop["profiles"] = profiles
    drop["6c remat vs off"] = compare_runs(drop["6c dropout 0 remat full"],
                                           drop["6c dropout 0 remat off"],
                                           "6c remat full vs off")
    drop["fit"] = fit_preempt_resume(args.seed)

    # ---- 7. the strategy search on the H100 machine model
    search = phase7(args.seed, timer, gen)

    # ---- 9. ResNet-50, ResNeXt-50, BERT-base and DLRM (with phase 10's
    # graph legs on each)
    bench = phase9(args.seed)
    graph.update(bench.pop("graph"))
    log("[phase 10] " + ", ".join(
        f"{t}: eager {g['step_ms']['eager']:.2f} / graph "
        f"{g['step_ms']['graph']:.2f} ms a step, idle "
        f"{g['profile_eager_k_steps']['device_idle_share']:.3f} -> "
        f"{g['profile_graph']['device_idle_share']:.3f}"
        for t, g in graph.items()))

    # ---- 11. telemetry, run health and per-op attribution (11f ran with
    # phase 3's int8 leg); 11a's telemetry is kept for phase 22
    import atexit
    import shutil
    import tempfile

    keep11 = tempfile.mkdtemp(prefix="ff_p11_tel_")
    atexit.register(shutil.rmtree, keep11, True)
    health11 = phase11(args.seed, keep_tel=os.path.join(keep11, "tel"))
    health11["serving"] = serve_telemetry

    # ---- 12. the tiered KV cache, hot-swap and rollback, request tracing,
    # the engine's reports, on phase 3's weights, prompts and streams
    collect_garbage()
    torch.cuda.empty_cache()
    params = {n: {w: t.to("cuda") for w, t in d.items()}
              for n, d in params_host.items()}
    serving12 = phase12(gcc, params, prompts, cut_streams, args.seed,
                        cut_runs)
    # ---- 13. the serving fleet (identity, colocated against disagg, the
    # rolling swap and its rollback, scaling) and the capacity twin
    keep13 = tempfile.mkdtemp(prefix="ff_p13_snapshots_")
    serving13 = phase13(gcc, params, prompts, cut_streams, args.seed,
                        serving12["tier"]["int8"]["host_bw_GBps"] * 1e9,
                        keep=keep13)
    del params
    torch.cuda.empty_cache()
    # ---- 14. the model zoo: gradient checks, every remaining model at its
    # builder's defaults, the fork-join pass, the K-step graph, a searched
    # strategy imported
    zoo = phase14(args.seed)
    # ---- 15. the frontends: torch.fx BERT-base, Keras AlexNet/CIFAR-10,
    # an ONNX encoder at BERT-base's widths, the launcher
    fronts = phase15(args.seed, bench["9d"], zoo["legs"]["alexnet"])
    # ---- 16. the task-graph simulator, MCMC, the learned cost model and
    # its refit loop on config #5; the native core, Jupyter, the C API
    p16 = phase16(args.seed, graph["5b"])
    mc16 = p16.pop("measured_cost")
    # ---- 17. multi-GPU, first part: config #5 over a world-1 NCCL mesh
    # against the plain compile, two ranks on the card over gloo (zero
    # off, zero1, zero2, a model axis, as far as gloo carries), the
    # launcher under torchrun's environment
    p17 = phase17(args.seed, graph["5b"])
    # ---- 18. multi-GPU, second part: the ring in lockstep against #1-#3
    # over the whole sequence, config #5 on the ring at world 1 against
    # the plain compile, and the legs 17b's ranks ran (the ring, expert
    # parallelism, the placed fork-join, the collective matmul) against
    # world 1
    p18 = phase18(args.seed, timer, p17)
    # ---- 19. multi-GPU, third part: config #5 pipelined over two gloo
    # ranks on the card (1F1B and GPipe against world 1, the fused CE in
    # the last stage), an S = 4 snapshot restored onto S = 2, the cut
    # search and its warm cache
    p19 = phase19(args.seed)
    # ---- 20. serving over a mesh: world 1 with the serving search asked
    # for (none runs on one device) bitwise phase 3; two gloo ranks on the
    # card, the searched programs and the heads-sharded pools, against
    # world 1
    # ---- 21. the fleet over a mesh in 20b's ranks, after its legs: two
    # replicas each SPMD over both ranks, on phase 13's cut model, weights
    # and snapshots (one replica against the plain mesh scheduler,
    # colocated and disaggregated, the rolling swap and its rollback, the
    # twin)
    try:
        p20 = phase20(args.seed, prompts, streams, p21_inputs(
            gcc, params_host, prompts, serving13.pop("snapshots")))
    finally:
        shutil.rmtree(keep13, ignore_errors=True)
    del params_host
    p21 = phase21(p20.pop("21"))
    # ---- 22. the operator tools and the examples on the card: the trace
    # report and the monitor over 11a's telemetry, the attribution run,
    # calibrate's rows and the overlap probe, the transformer_lm example
    # through the launcher
    p22 = phase22(os.path.join(keep11, "tel"), health11["telemetry"], mc16)
    del mc16

    # launches on the main paths: both serving runs, the 12 Adam training
    # steps and the Adam fit epoch, the 12 padded-vocab SGD steps and the
    # accum_steps=2 fit epoch, each counted from 0 just before it ran
    paths = {f"serve_{r['kv_cache_dtype']}": r["launches"] for r in runs}
    paths["train_steps"] = train["full_depth"]["launches"]
    paths["train_fit"] = train["fit"]["launches"]
    paths["train_sgd_padded_steps"] = sgd["full_depth"]["launches"]
    paths["train_accum_fit"] = sgd["accum_fit"]["launches"]
    paths["train_dropout_steps"] = drop["6b dropout remat off"]["launches"]
    paths["train_dropout_remat_steps"] = \
        drop["6b dropout remat full"]["launches"]
    paths["train_padded_adam_steps"] = drop["6c dropout 0 remat off"]["launches"]
    paths["train_remat_steps"] = drop["6c dropout 0 remat full"]["launches"]
    for run in ("uninterrupted", "preempted", "resumed"):
        paths[f"train_dropout_fit_{run}"] = drop["fit"][run]["launches"]
    for r in search["searches"]:
        if r["measured"]:
            paths[f"search_measured_{r['machine']['data']}_node"] = \
                r["launches"]
    paths["train_searched_strategy_steps"] = search["import"]["launches"]
    paths["train_unsearched_steps"] = search["prediction"]["launches"]
    for leg in spec["legs"] + [spec["gate"]]:
        paths[leg["leg"].replace(" ", "_").replace("=", "")] = leg["launches"]
    paths["serve_slo_trace"] = spec["slo_trace"]["launches"]
    paths["serve_watchdog"] = spec["watchdog"]["launches"]
    # phase 9's paths; the flash kernels run there without the mask (BERT),
    # everywhere else with it (GPT-2): the non-causal rows count phase 9's
    # launches, the causal rows the others'
    paths9 = {"train_resnet50_steps": bench["9a"]["launches"],
              "train_resnet50_fit": bench["9a_fit"]["launches"],
              "train_resnext50_steps": bench["9b"]["launches"],
              "train_bert_dropout_steps": bench["9c"]["launches"],
              "train_bert_steps": bench["9d"]["launches"],
              "train_dlrm_steps": bench["9e"]["launches"]}
    # phase 10: each graph's capture (its launches count there) and its
    # fit epoch; GPT-2's legs mask the flash kernels, phase 9's do not
    for t, g in graph.items():
        into = paths if t in ("5b", "5f") else paths9
        into[f"graph_{t}_capture"] = g["launches"]
        into[f"graph_{t}_fit"] = g["fit"]["launches"]
    # phase 11's fits (GPT-2, the flash kernels masked) and 11f's serving
    for kk, runs in health11["telemetry"].items():
        for i, r in enumerate(runs):
            paths[f"p11a_{kk}_run{i}"] = r["launches"]
    paths["p11c_profiled_fit"] = health11["attribution"]["launches"]
    for r in health11["halt"]:
        paths[f"p11d_halt_k{r['k']}"] = r["launches"]
    paths["p11f_serve_int8_telemetry"] = serve_telemetry["launches"]
    for kv, leg in serving12["tier"].items():
        paths[f"p12a_serve_{kv}_tiered"] = leg["run"]["launches"]
        paths[f"p12a_serve_{kv}_untiered"] = leg["untiered"]["launches"]
    for i, r in enumerate(serving12["trace"]["runs"]):
        paths[f"p12c_serve_int8_run{i}"] = r["launches"]
    paths["p12b_serve_int8_mid_run_swap"] = \
        serving12["swap"]["mid_run"]["launches"]
    for part in ("13a", "13b", "13c"):
        for leg, run in serving13[part].items():
            if isinstance(run, dict) and "launches" in run:
                paths[f"p{part}_{leg.replace(' ', '_')}"] = run["launches"]
    for n in (1, 2):
        for kind, run in serving13["13d"][n].items():
            paths[f"p13d_{n}_replicas_{kind}"] = run["launches"]
    # phase 14's legs, graphs (captures and fits), fusion and import: no
    # attention, the optimizer kernels only
    for which, leg in zoo["legs"].items():
        paths9[f"p14b_{which}_steps"] = leg["launches"]
    for which, g in zoo["graph"].items():
        paths9[f"p14d_{which}_capture"] = g["launches"]
        paths9[f"p14d_{which}_fit"] = g["fit"]["launches"]
    for which, f in zoo["fusion"].items():
        paths9[f"p14c_{which}_fused_and_unfused"] = f["launches"]
    paths9["p14e_imported_strategy_steps"] = zoo["strategy"]["launches"]
    # phase 15's legs: the flash kernels non-causal (15a), the optimizers
    paths9["p15a_fx_bert_steps"] = fronts["15a"]["steps"]["launches"]
    paths9["p15a_build_bert_steps"] = \
        fronts["15a"]["build_bert_steps"]["launches"]
    paths9["p15b_keras_fit"] = fronts["15b"]["launches"]
    paths9["p15b_keras_steps"] = fronts["15b"]["steps"]["launches"]
    paths9["p15c_onnx_steps"] = fronts["15c"]["steps"]["launches"]
    paths9["p15d_launcher_fit"] = fronts["15d"]["launches"]
    # phase 16's: GPT-2 medium (the flash kernels masked) in 16a-16c; the
    # plain SGD of 16e's MLPs and 16f's C program
    paths["p16a_taskgraph_steps"] = p16["16a"]["launches"]
    paths["p16b_mcmc_imported_steps"] = p16["16b"]["one_card"]["launches"]
    paths["p16c_profiled_fit"] = p16["16c"]["profiled_fit"]["launches"]
    paths["p16c_auto_refit_fit"] = p16["16c"]["auto_refit_fit"]["launches"]
    paths9["p16e_kernel_env_fit"] = p16["16e"]["kernel_env"]["launches"]
    paths9["p16e_quickstart_fit"] = p16["16e"]["quickstart"]["launches"]
    paths9["p16f_capi_fit"] = p16["16f"]["launches"]
    # phase 17's: config #5 over the mesh (the flash kernels masked); 17c's
    # MLP the plain SGD
    paths["p17a_mesh_steps"] = p17["17a"]["runs"]["mesh"]["launches"]
    paths["p17a_plain_steps"] = p17["17a"]["runs"]["plain"]["launches"]
    paths["p17a_graph_capture"] = p17["17a"]["graph"]["launches"]
    paths["p17a_graph_fit"] = p17["17a"]["graph"]["fit"]["launches"]
    for name, leg in p17["17b"]["legs"].items():
        tag = name.replace(" ", "_")
        paths[f"p17b_{tag}_rank0"] = leg["launches"]
        paths[f"p17b_{tag}_rank1"] = leg["launches_rank1"]
    paths9["p17c_launcher_fit"] = p17["17c"]["launches"]
    # phase 18's: config #5 on the ring (the flash kernels masked, #7);
    # MoE-MLP (#8) and the ensemble (#7) on two ranks
    paths["p18b_ring_world1_steps"] = p18["18b"]["launches"]
    for name, leg in p18["18c"]["legs"].items():
        if name not in ("collective_matmul", "ring_check"):
            into = paths if name == "ring" else paths9
            into[f"p18c_{name}_rank0"] = leg["launches"]
            into[f"p18c_{name}_rank1"] = leg["launches_rank1"]
    # phase 19's: config #5 pipelined (the flash kernels masked, #7; the
    # padded vocab's #5, #6 and #8) on each rank, and the world-1 twins
    for k, v in p19["19a"]["launches"].items():
        paths[f"p19a_{k}"] = v
    for k, v in p19["19b"]["launches"].items():
        paths[f"p19b_{k}"] = v
    for k in ("19a", "19b"):
        paths[f"p{k}_world1_twin"] = p19["world1"][k]["launches"]
    # phase 20's: GPT-2 medium served (#1 causal, #4 int8) at world 1 and
    # on each of 20b's ranks
    for kv, leg in p20["20a"].items():
        paths[f"p20a_serve_{kv}"] = leg["launches"]
    for kv, leg in p20["20b"].items():
        paths[f"p20b_{kv}_teacher_rank0"] = leg["teacher_launches"]
        paths[f"p20b_{kv}_teacher_rank1"] = leg["teacher_launches_rank1"]
        paths[f"p20b_{kv}_serve_rank0"] = leg["serve"]["launches"]
        paths[f"p20b_{kv}_serve_rank1"] = leg["launches_rank1"]
    # phase 21's: #1 (causal) and #4 on each rank's heads, every run
    for rank, rr in p21["ranks"].items():
        for part in ("21a", "21b"):
            for leg, run in rr[part].items():
                if isinstance(run, dict) and "launches" in run:
                    paths[f"p{part}_{leg}_rank{rank}"] = run["launches"]
        for leg, run in rr["21c"].items():
            paths[f"p{leg.replace(' ', '_')}_rank{rank}"] = run["launches"]
    # 16e's mesh cells: #8 on each rank's leaves
    for rank, c in enumerate(p16["16e"]["quickstart_mesh"][
            "launches_by_rank"]):
        paths9[f"p16e_quickstart_mesh_rank{rank}"] = c
    # phase 22's: the attribution twin (#8), calibrate's rows (#1-#3 on
    # GPT-2 medium's block, #8), the example (#5-#7)
    paths["p22b_profile_attribution"] = p22["attribution"]["launches"]
    paths["p22c_calibrate"] = p22["calibrate"]["launches"]
    paths["p22d_transformer_lm_example"] = p22["example"]["launches"]
    for r in rows:
        causal = r.get("causal")
        counted = (paths if causal else paths9 if causal is False
                   else {**paths, **paths9})
        key = r.get("counter", r["name"])
        r["launches"] = sum(c[key] for c in counted.values())
        r["launches_by_path"] = {p: c[key] for p, c in counted.items()}
        if r["name"] == "dequant_decode_attention":
            r["launches_by_rows_by_path"] = {
                leg["leg"]: leg["dequant_by_rows"]
                for leg in spec["legs"] + [spec["gate"]]
                if leg["kv_cache_dtype"] == "int8"}
        r["card"] = card
    log(json.dumps({"serve": runs}))
    log(json.dumps({"train": train}))
    log(json.dumps({"train_sgd_padded": sgd}))
    log(json.dumps({"train_dropout": drop}))
    log(json.dumps({"search": search}))
    log(json.dumps({"spec": spec}))
    log(json.dumps({"bench_workloads": bench}))
    log(json.dumps({"graph": graph}))
    log(json.dumps({"health": health11}, default=str))
    log(json.dumps({"serving12": serving12}, default=str))
    log(json.dumps({"serving13": serving13}, default=str))
    log(json.dumps({"zoo": zoo}, default=str))
    log(json.dumps({"frontends": fronts}, default=str))
    log(json.dumps({"phase16": p16}, default=str))
    log(json.dumps({"phase17": p17}, default=str))
    log(json.dumps({"phase18": p18}, default=str))
    log(json.dumps({"phase19": p19}, default=str))
    log(json.dumps({"phase20": p20}, default=str))
    log(json.dumps({"phase21": p21}, default=str))
    log(json.dumps({"phase22": p22}, default=str))
    log(json.dumps({"ring_programs": ring_program_rows(p18, card)}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
