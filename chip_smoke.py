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
   (b) full depth, 12 steps with remat off and 12 with `FFConfig(remat=
       True)` ("full" on every layer), reported as 5b; each step launches
       each CE kernel and Adam once and no flash kernel;
   (c) full depth at dropout 0, 12 steps with remat off and 12 with remat
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
   on phase 3's weights, prompts and greedy streams (32 new tokens):
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
    trains it (full depth, b8, seq 1024, dropout 0, bf16 over f32
    masters, Adam 1e-4), compiled anew after the peak memory is reset;
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

12. The rest of one-card serving, run last on phase 3's weights (kept
    on the host from phase 8 on), prompts and greedy streams (GPT-2
    medium, 8 slots, page 16, 66 pages a slot), in a temporary directory
    removed at the end:
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

13. The serving fleet and the capacity twin, run last on phase 3's
    weights, prompts and greedy streams: two int8 engines of GPT-2
    medium (8 slots, page 16), each with half of every slot's pages on
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

The line before the last is `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by the kernel's name."""
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_ce as fc
    from flexflow_tpu_torch.kernels import fused_optim as fo
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_dq": fa.launches_dq,
            "flash_attention_dkv": fa.launches_dkv,
            "dequant_decode_attention": da.launches,
            "fused_adam": fo.launches,
            "fused_ce_fwd": fc.launches_fwd,
            "fused_ce_bwd": fc.launches_bwd,
            "fused_sgd": fo.launches_sgd,
            "fused_sgd_plain": fo.launches_sgd_plain}


def zero_launch_counts() -> None:
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_ce as fc
    from flexflow_tpu_torch.kernels import fused_optim as fo
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
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


def _device_profile(fn, reps: int, dev: torch.device) -> dict:
    """Run `fn` `reps` times under torch.profiler: host wall time per call,
    the device's busy time (union of kernel intervals) and idle share, and
    the kernels that took the most device time. Empty when the profiler
    records no kernel (then the device split is not measured)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(dev)
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.events()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
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
                             for n, (t, c) in sorted(port.items())}}


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
    for g in (gc, GPT2Config.small() if draft == "small" else gc):
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
    launches = check_spec_launches(sched, counts, rows, k, LAYERS, l_draft,
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
               tag: str, dropout: float = 0.0, **cfg) -> tuple:
    """GPT-2 medium at full depth: 2 warm-up and 10 timed steps on one
    batch, the launch counters zeroed before the 12 steps and read after.
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
    for _ in range(TRAIN_STEPS // 2):
        t0 = time.perf_counter()
        step()
        step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 2)
    counts = launch_counts()
    builds.append(fo.table_builds - builds0 - builds[0])
    steps = WARMUP_STEPS + TRAIN_STEPS
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
            f"{prof['kernel_launches_per_call']:.0f} kernel launches")
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
              per_window: int) -> dict:
    """2 warm-up steps, then `windows_n` windows of `per_window` steps on
    one batch, each window ended by a device sync; the launch counters
    zeroed before the first step and read after the last (`exact` gives
    each kernel's launches per step; a kernel it does not name must not
    launch), the optimizer's table built in the first step only, every
    loss finite; then torch.profiler over one step. Step i draws its
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
        "compute_dtype": "bfloat16", "optimizer": type(cm.optimizer).__name__,
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
    if builds != [1, 0]:
        fail(f"{tag}: the optimizer's pointer table was built {builds} "
             f"times in the warm-up and timed steps, expected [1, 0]")
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


def _tree_diff(a, b) -> float:
    """max |a - b| over the float leaves of two param trees."""
    return max(float((a[l][w].detach().float() - b[l][w].detach().float())
                     .abs().max()) for l in a for w in a[l])


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
    port's kernels replayed with the counts of k eager steps. (c) step ms
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
    prof_g = _device_profile(lambda: dispatch(0), 2, cm.device)
    prof_e = _device_profile(lambda: eager_steps(0), 1, cm.device)
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
            f"{prof_e['device_idle_share']:.3f})")
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
        prof = _device_profile(dispatch, 2, cm.device)
        if "kernel_launches_per_call" not in prof:
            fail(f"11a: the profiler saw no kernel of the graph: {prof}")
        out["on" if on else "off"] = {
            k: prof[k] for k in ("kernel_launches_per_call",
                                 "graph_launches_per_call",
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


def phase11(seed: int) -> dict:
    """Phase 11 on GPT-2 medium as 5b trains it (full depth; 11d at
    FIT_LAYERS), in a temporary directory removed at the end."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ff_p11_")
    try:
        collect_garbage()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gc, _, cm = gpt2_train_model(seed, LAYERS, "bfloat16")
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
        if kv == "int8" and deq != LAYERS * sched.decode_steps:
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
    _, _, cm = gpt2_train_model(seed, LAYERS, "bfloat16",
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
              profile: bool = False, **serve_kw) -> dict:
    """One run of `runner` (a `ServingFleet`, or a plain scheduler) over
    `reqs`, with every launch counter set to 0 just before it and read
    just after; `count_syncs` counts the host syncs (torch's sync debug
    mode), `profile` runs it under torch.profiler for the device's busy
    time and idle share. Fails unless every request completes with
    NEW_TOKENS tokens."""
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
    if any(len(r.tokens) != NEW_TOKENS for r in done):
        fail(f"{label}: a request ended short of {NEW_TOKENS} tokens")
    ttft = np.array([r.ttft_s for r in done])
    tokens = sum(len(r.tokens) for r in done)
    out = {"runner": runner, "streams": {r.rid: list(r.tokens)
                                         for r in done},
           "requests": len(done), "wall_s": wall, "launches": counts,
           "host_syncs": syncs, "tokens_per_s": tokens / wall,
           "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
           "ttft_p99_ms": 1e3 * float(np.percentile(ttft, 99)),
           "decode_steps": sum(s.decode_steps for s in scheds),
           "prefills": sum(s.prefills for s in scheds),
           "materializations": sum(s.materializations for s in scheds)}
    if prof is not None:
        out["profile"] = prof
    return out


def _p13_summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("runner", "streams")}


def p13_exact_launches(run: dict, label: str) -> None:
    """The dequant decode once a layer every decode step, the flash
    forward once a layer every prefill, summed over the replicas."""
    got = run["launches"]
    deq, fla = got["dequant_decode_attention"], got["flash_attention_fwd"]
    if deq != LAYERS * run["decode_steps"] or \
            fla != LAYERS * run["prefills"]:
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
        p13_exact_launches(run, label)
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
    _, _, cm = gpt2_train_model(seed, LAYERS, "bfloat16",
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
            p13_exact_launches(run, tag)
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


def p13_twin(engine, live_fleet, trace_path: str) -> dict:
    """13e: (b)'s colocated trace through the twin, against the live run."""
    from flexflow_tpu_torch.serving import tracefmt, twin

    trace = tracefmt.load_trace(trace_path)
    if len(trace) != REQUESTS or trace.skipped:
        fail(f"13e: the exported trace holds {len(trace)} records")
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
    if res.stats["completed"] != REQUESTS or res.stats["shed"]:
        fail(f"13e: the twin completed {res.stats['completed']} of "
             f"{REQUESTS}")
    missing = sorted(set(live_rep) - set(rep))
    if missing:
        fail(f"13e: the twin's report lacks the live report's {missing}")

    def metrics(r):
        h = r["hists"]
        return {"tokens_per_s": r["stats"]["tokens_per_s"],
                "wall_s": r["stats"]["wall_s"],
                "ttft_p50_s": h["ttft"]["p50"], "ttft_p99_s": h["ttft"]["p99"],
                "per_token_p50_s": h["per_token"]["p50"],
                "queue_wait_p50_s": h["queue_wait"]["p50"]}
    val = twin.validate(metrics(live_rep), metrics(rep))
    log(f"[13e] twin ({costs.source}: decode step "
        f"{1e3 * costs.decode_step_s:.2f} ms, prefill "
        f"{1e3 * costs.prefill_base_s:.2f} ms, window overhead "
        f"{1e3 * costs.window_overhead_s:.2f} ms) against live: " + ", ".join(
            f"{k} {m['live']:.4g} / {m['twin']:.4g} ({100 * m['rel_err']:.1f}%)"
            for k, m in val["metrics"].items())
        + f"; worst {100 * val['max_rel_err']:.1f}%")
    return {"costs": dataclasses.asdict(costs), "validate": val,
            "twin_stats": res.stats, "spec": dataclasses.asdict(spec)}


def phase13(gc, params, prompts, streams: dict, seed: int,
            host_bw: float) -> dict:
    """Phase 13 on phase 3's weights, prompts and int8 streams, in a
    temporary directory removed at the end."""
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
    # weights, prompts and streams
    spec = phase8(gc, params, prompts, streams, args.seed)
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
            args.seed, None, PAD_TO, ce_adam, tag, DROPOUT, remat=remat)
        profiles[tag] = profile_train(cm, inputs, label, tag,
                                      rng=ff_random.key(args.seed))
        del cm, inputs, label
        torch.cuda.empty_cache()
    for remat in (False, True):
        tag = f"6c dropout 0 remat {'full' if remat else 'off'}"
        exact = dict(ce_adam, flash_attention_fwd=(2 if remat else 1) * LAYERS,
                     flash_attention_dq=LAYERS, flash_attention_dkv=LAYERS)
        drop[tag], cm, inputs, label = train_full(
            args.seed, None, PAD_TO, exact, tag, 0.0, remat=remat)
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
    # phase 3's int8 leg)
    health11 = phase11(args.seed)
    health11["serving"] = serve_telemetry

    # ---- 12. the tiered KV cache, hot-swap and rollback, request tracing,
    # the engine's reports, on phase 3's weights, prompts and streams
    collect_garbage()
    torch.cuda.empty_cache()
    params = {n: {w: t.to("cuda") for w, t in d.items()}
              for n, d in params_host.items()}
    serving12 = phase12(gc, params, prompts, streams, args.seed,
                        {r["kv_cache_dtype"]: r for r in runs})
    # ---- 13. the serving fleet (identity, colocated against disagg, the
    # rolling swap and its rollback, scaling) and the capacity twin
    serving13 = phase13(gc, params, prompts, streams, args.seed,
                        serving12["tier"]["int8"]["host_bw_GBps"] * 1e9)
    del params, params_host
    torch.cuda.empty_cache()
    # ---- 14. the model zoo: gradient checks, every remaining model at its
    # builder's defaults, the fork-join pass, the K-step graph, a searched
    # strategy imported
    zoo = phase14(args.seed)

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
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
