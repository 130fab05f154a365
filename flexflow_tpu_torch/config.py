"""Run configuration (counterpart: flexflow_tpu/config.py).

Only the fields the ported slices read are here; their names, defaults
and command-line flags match the JAX package's `FFConfig`, so a command
line that configures one package configures the other the same way.

The parser knows every option string of the JAX parser, with the same
choices. A flag whose feature is not ported yet (`_UNPORTED`) parses, and
`parse_args` raises `NotImplementedError` naming its ROADMAP Queue 1 item
when the command line sets it; flags that neither package knows are
ignored, as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class FFConfig:
    epochs: int = 1
    batch_size: int = 64
    # the compile's default optimizer is SGD(lr=learning_rate), as in JAX;
    # weight_decay and iterations are carried for the frontends
    learning_rate: float = 0.01
    weight_decay: float = 1e-4
    iterations: int = 0  # 0 = derive from dataset size
    seq_length: int = 0
    seed: int = 0
    # the strategy search (search/; --budget, --alpha, ...): compile
    # searches when search_budget > 0 and the search machine has more than
    # one device. search_num_nodes / search_num_workers describe a machine
    # larger than the real one (nodes on a "data" axis across the network,
    # workers on a "model" axis inside a node), meant to be paired with
    # --export; machine_model_file describes the machine outright.
    search_budget: int = 0
    search_alpha: float = 1.05
    only_data_parallel: bool = False
    enable_parameter_parallel: bool = True
    enable_attribute_parallel: bool = True
    base_optimize_threshold: int = 10
    search_num_nodes: int = 0
    search_num_workers: int = 0
    memory_search: bool = False
    substitution_json: str = ""
    # persistent strategy cache (search/strategy_cache.py): a warm compile
    # of an unchanged (graph, machine, knobs, calibration) skips the search.
    # dir "" -> $FF_STRATEGY_CACHE_DIR or ~/.cache/flexflow_tpu_torch/strategy
    strategy_cache: bool = True
    strategy_cache_dir: str = ""
    # "additive" (the only one ported; "taskgraph" and "learned" raise)
    simulator_mode: str = "additive"
    machine_model_file: str = ""
    # --profiling: the search prices ops by timing them on the device
    # (search/measure.py), and fit runs under torch.profiler, writing a
    # Chrome trace of the whole fit under profile_dir ("" = ./ff_profile)
    # with each layer's lowering in a record_function range of its name
    profiling: bool = False
    profile_dir: str = ""
    # per-op attribution (attribution.py): at fit end, join each layer's
    # measured time (the --profiling trace, else MeasuredCost's isolated
    # times) with the cost model's predicted time and its roofline, and
    # emit op/attr telemetry events
    profile_ops: bool = False
    # the span/counter stream (telemetry.py): "" = off; telemetry_max_mb
    # caps each JSONL segment (0 = unbounded)
    telemetry_dir: str = ""
    telemetry_max_mb: float = 512.0
    # numerics sentinels (health.py): the grad norm and a non-finite flag
    # folded into the step's deferred metrics and read at fit's existing
    # syncs; halt_on_nonfinite raises NonFiniteError naming the last
    # durable checkpoint
    health_sentinels: bool = True
    halt_on_nonfinite: bool = False
    # pipeline parallelism is not ported: > 1 raises at compile
    pipeline_stages: int = 1
    # --fusion: False keeps the hand-written attention kernels off (the
    # plain PyTorch attention runs instead)
    enable_fusion: bool = True
    compute_dtype: str = "float32"  # "bfloat16" enables the mixed policy
    # serving knobs (compile_serving reads them when no explicit arg is given)
    max_decode_len: int = 0
    kv_page_size: int = 16
    max_batch_slots: int = 8
    #   kv_cache_dtype — paged-KV storage dtype: "auto" follows
    #                    compute_dtype, "bf16" forces bf16 pools, "int8"
    #                    stores int8 pools with per-(entry, head) f32 scales
    kv_cache_dtype: str = "auto"
    # speculative decoding and SLO-aware admission (serving/engine.py,
    # serving/scheduler.py):
    #   serve_draft_model       - a JSON file of GPT2Config overrides for
    #                             the draft model ("" = no speculation;
    #                             callers may pass draft= instead)
    #   serve_spec_tokens       - tokens the draft proposes per slot per
    #                             round before one verify pass (0 = off)
    #   serve_ttft_budget_ms    - shed a waiter whose wait plus the EMA
    #                             prefill time exceeds this (0 = no budget)
    #   serve_queue_cap         - waiting requests before the least urgent
    #                             one is shed (0 = unbounded)
    #   serve_decode_timeout_ms - decode watchdog: a window slower than this
    #                             per step evicts the longest-resident slot
    #                             (0 = off)
    #   serve_slo               - SLO objectives, e.g. "ttft_p99_ms=25,
    #                             availability=0.999" (health.parse_slo)
    #   serve_max_context       - prompt + decode budget ceiling; arrivals
    #                             over it shed as over_max_context (0 = none)
    serve_draft_model: str = ""
    serve_spec_tokens: int = 0
    serve_ttft_budget_ms: float = 0.0
    serve_queue_cap: int = 0
    serve_decode_timeout_ms: float = 0.0
    serve_slo: str = ""
    serve_max_context: int = 0
    # the rest of one-card serving (serving/{kv_cache,engine,scheduler,
    # reqtrace,tracefmt}.py):
    #   serve_watch_dir   - durable-checkpoint root the engine polls for
    #                       newer committed snapshots to hot-swap ("" = off)
    #   serve_reqtrace    - per-request stage tracing (serve/req/* spans,
    #                       streaming histograms); on by default, it reads
    #                       only timestamps the loop already took
    #   kv_host_pages     - host-memory pages of the KV cache's cold tier;
    #                       > 0 shrinks the device pool by as many (floored
    #                       at one slot's worth) and lets the scheduler
    #                       park slots on the host (0 = untiered)
    #   kv_prefetch_ahead - decode steps a parked slot's refill is issued
    #                       before its rejoin; less lead counts a stall
    #   serve_trace_out   - write the offered load as a tracefmt JSONL
    #                       trace at the end of a run ("" = off)
    serve_watch_dir: str = ""
    serve_reqtrace: bool = True
    kv_host_pages: int = 0
    kv_prefetch_ahead: int = 2
    serve_trace_out: str = ""
    # the serving fleet (serving/fleet.py) and the capacity twin
    # (serving/twin.py, tools/twin.py):
    #   serve_replicas         - in-process engine replicas behind the
    #                            router (1 = the plain scheduler's path)
    #   serve_fleet_topology   - "colocated" (every replica prefills and
    #                            decodes) or "disagg" (prefill replicas
    #                            hand committed K/V to the decode replicas
    #                            through the host tier; kv_host_pages > 0
    #                            on every replica)
    #   serve_prefill_replicas - the prefill pool under disagg, clamped to
    #                            [1, replicas - 1]
    #   serve_router           - "least_loaded" or "round_robin"
    #   serve_rollout_burn_max - the rolling swap's ceiling: a swapped
    #                            replica whose SLO worst burn rate crosses
    #                            it rolls back and the rollout freezes
    #                            (0 = no rollback monitor)
    #   twin_trace             - the trace the twin's command line replays
    #   twin_replicas          - replicas the twin simulates (0 = follow
    #                            serve_replicas)
    #   twin_out               - the twin's report JSON ("" = stdout)
    serve_replicas: int = 1
    serve_fleet_topology: str = "colocated"
    serve_prefill_replicas: int = 1
    serve_router: str = "least_loaded"
    serve_rollout_burn_max: float = 0.0
    twin_trace: str = ""
    twin_replicas: int = 0
    twin_out: str = ""
    # training loop (compiler/compile.py): fit reads the loss to the host
    # every sync_every updates (0 = at epoch end only); accum_steps N > 1
    # makes every update one over N microbatches (fit(accum_steps=)
    # overrides it per call); steps_per_dispatch K > 1 runs K updates as
    # one dispatch (make_multi_step: one CUDA graph of K steps on the
    # card), forced to 1 under per-batch callbacks; dispatch_ahead is the
    # number of dispatches after which fit waits for the device (a
    # barrier, no host read) when no sync falls there
    sync_every: int = 0
    accum_steps: int = 1
    steps_per_dispatch: int = 1
    dispatch_ahead: int = 32
    # fused kernels of the train step: "auto" takes the kernel where the
    # gate admits the shape and fusion is on, "on" forces it (raising where
    # it does not qualify), "off" never fuses.
    #   fused_loss      - fused sparse cross-entropy (kernels/fused_ce.py)
    #   fused_optimizer - fused optimizer update (kernels/fused_optim.py)
    fused_loss: str = "auto"
    fused_optimizer: str = "auto"
    # strategy files (parallel/sharding.py; --import / --export): a file
    # written by either package; one device applies its shardings as a
    # one-device mesh does, and its remat map reaches the lowering
    import_strategy_file: str = ""
    export_strategy_file: str = ""
    # rematerialization: --remat is the deprecated uniform alias (every
    # layer "full"); --remat-search makes the search choose a policy per
    # layer from --remat-policies (on a one-device machine nothing is
    # searched and no layer is rematerialized, as in JAX). The two flags
    # contradict each other (see _check_remat_knobs).
    remat: bool = False
    remat_search: bool = False
    remat_policies: str = "none,dots,full"
    # --compgraph: compile writes FFModel.dot() (the layer graph with each
    # op's sharding) to this path ("" = off); --include-costs-dot-graph
    # adds each op's predicted time
    export_dot: str = ""
    include_costs_dot_graph: bool = False
    # checkpoints (runtime/checkpoint.py, runtime/resilience.py):
    #   async_checkpoint — snapshot to host on the caller thread, write on
    #     a background thread
    #   checkpoint_dir — root of the durable `ckpt-<step>` snapshots ("" =
    #     off); checkpoint_every_steps / checkpoint_every_secs — periodic
    #     snapshots inside fit (both 0 = only the end-of-fit and
    #     preemption snapshots)
    #   resume — "" (fresh start), "auto" (the newest committed snapshot
    #     under checkpoint_dir) or a path
    #   keep_checkpoints — committed snapshots kept (<= 0 keeps all)
    async_checkpoint: bool = True
    checkpoint_dir: str = ""
    checkpoint_every_steps: int = 0
    checkpoint_every_secs: float = 0.0
    resume: str = ""
    keep_checkpoints: int = 3
    # transient-fault retries (runtime/resilience.RetryPolicy.from_config):
    # total attempts and the first backoff, around loader transfers,
    # checkpoint writes, fit dispatches and the serving dispatches
    retry_attempts: int = 3
    retry_base_delay: float = 0.05
    # deterministic fault injection (runtime/faults.py grammar, e.g.
    # "dataloader/transfer@3*2,checkpoint/write@1!"); also FF_FAULT_PLAN.
    # compile arms it.
    fault_plan: str = ""

    REMAT_POLICY_NAMES = ("none", "dots", "full")

    def __post_init__(self):
        self._check_remat_knobs()
        if self.serve_slo:
            # fail at config build, not mid-serve
            from flexflow_tpu_torch.health import parse_slo
            parse_slo(self.serve_slo)

    def _check_remat_knobs(self):
        """--remat (uniform "full") and --remat-search (per-layer policies)
        contradict each other: fail instead of letting one win."""
        if self.remat and self.remat_search:
            raise ValueError(
                "--remat (deprecated: uniform 'full' remat) contradicts "
                "--remat-search (per-layer searched remat); drop --remat "
                "— the search's candidate set already includes 'full'")
        bad = [pol for pol in self.remat_policy_list()
               if pol not in self.REMAT_POLICY_NAMES]
        if bad:
            raise ValueError(
                f"unknown remat policies {bad!r} in "
                f"remat_policies={self.remat_policies!r} "
                f"(choose from {', '.join(self.REMAT_POLICY_NAMES)})")

    def remat_policy_list(self) -> Tuple[str, ...]:
        """The per-layer policy candidates ("none" always among them)."""
        pols = tuple(s.strip() for s in self.remat_policies.split(",")
                     if s.strip())
        if "none" not in pols:
            pols = ("none",) + pols
        return pols

    @staticmethod
    def build_parser() -> argparse.ArgumentParser:
        """Every option string of the JAX package's parser, with its
        choices. The unported ones (`_UNPORTED`) have no default: they
        appear in the parsed namespace only when the command line sets
        them, and `parse_args` then raises."""
        p = argparse.ArgumentParser("flexflow_tpu_torch", allow_abbrev=False)
        U = argparse.SUPPRESS
        p.add_argument("-e", "--epochs", type=int, default=1)
        p.add_argument("-b", "--batch-size", type=int, default=64)
        p.add_argument("--lr", "--learning-rate", dest="lr", type=float,
                       default=0.01)
        p.add_argument("--wd", "--weight-decay", dest="wd", type=float,
                       default=1e-4)
        p.add_argument("--iterations", type=int, default=0)
        p.add_argument("--seq-length", type=int, default=0)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--mesh", type=str, default=U)
        p.add_argument("--nodes", type=int, default=U)
        p.add_argument("-ll:tpu", "--workers-per-node", dest="workers",
                       type=int, default=U)
        p.add_argument("--budget", "--search-budget", dest="budget", type=int,
                       default=0)
        p.add_argument("--alpha", "--search-alpha", dest="alpha", type=float,
                       default=1.05)
        p.add_argument("--only-data-parallel", action="store_true")
        p.add_argument("--enable-parameter-parallel",
                       action=argparse.BooleanOptionalAction, default=True)
        p.add_argument("--enable-attribute-parallel",
                       action=argparse.BooleanOptionalAction, default=True)
        p.add_argument("--base-optimize-threshold", type=int, default=10)
        p.add_argument("--search-num-nodes", type=int, default=0)
        p.add_argument("--search-num-workers", type=int, default=0)
        p.add_argument("--import", dest="import_file", type=str, default="")
        p.add_argument("--export", dest="export_file", type=str, default="")
        p.add_argument("--memory-search", action="store_true")
        p.add_argument("--substitution-json", type=str, default="")
        p.add_argument("--strategy-cache", action=argparse.BooleanOptionalAction,
                       default=True)
        p.add_argument("--strategy-cache-dir", type=str, default="")
        p.add_argument("--simulator-mode", type=str, default="additive",
                       choices=("additive", "learned", "taskgraph"))
        p.add_argument("--simulator-segment-size", type=int, default=U)
        p.add_argument("--simulator-topk", type=int, default=U)
        p.add_argument("--cost-model-path", type=str, default=U)
        p.add_argument("--auto-refit", action="store_true", default=U)
        p.add_argument("--simulator-trace", type=str, default=U)
        p.add_argument("--machine-model-file", type=str, default="")
        p.add_argument("--sync-every", type=int, default=0)
        p.add_argument("--steps-per-dispatch", type=int, default=1)
        p.add_argument("--dispatch-ahead", type=int, default=32)
        p.add_argument("--async-checkpoint",
                       action=argparse.BooleanOptionalAction, default=True)
        p.add_argument("--checkpoint-dir", type=str, default="")
        p.add_argument("--checkpoint-every-steps", type=int, default=0)
        p.add_argument("--checkpoint-every-secs", type=float, default=0.0)
        p.add_argument("--resume", type=str, default="")
        p.add_argument("--keep-checkpoints", type=int, default=3)
        p.add_argument("--retry-attempts", type=int, default=3)
        p.add_argument("--retry-base-delay", type=float, default=0.05)
        p.add_argument("--fault-plan", type=str, default="")
        p.add_argument("--zero-sharding", type=str, default=U,
                       choices=("off", "zero1", "zero2"))
        p.add_argument("--accum-steps", type=int, default=1)
        p.add_argument("--pipeline-stages", type=int, default=1)
        p.add_argument("--pipeline-schedule", type=str, default=U,
                       choices=("gpipe", "1f1b"))
        p.add_argument("--fusion", dest="fusion", action="store_true",
                       default=True)
        p.add_argument("--no-fusion", dest="fusion", action="store_false")
        p.add_argument("--profiling", action="store_true")
        p.add_argument("--profile-dir", type=str, default="")
        p.add_argument("--profile-ops", action="store_true")
        p.add_argument("--telemetry-dir", type=str, default="")
        p.add_argument("--telemetry-max-mb", type=float, default=512.0)
        p.add_argument("--health-sentinels",
                       action=argparse.BooleanOptionalAction, default=True)
        p.add_argument("--halt-on-nonfinite", action="store_true")
        p.add_argument("--compute-dtype", type=str, default="float32")
        p.add_argument("--remat", action="store_true")
        p.add_argument("--remat-search", action="store_true")
        p.add_argument("--remat-policies", type=str, default="none,dots,full")
        p.add_argument("--fused-loss", type=str, default="auto",
                       choices=("auto", "on", "off"))
        p.add_argument("--fused-optimizer", type=str, default="auto",
                       choices=("auto", "on", "off"))
        p.add_argument("--compgraph", dest="export_dot", type=str, default="")
        p.add_argument("--include-costs-dot-graph", action="store_true")
        p.add_argument("--serve", action="store_true", default=U)
        p.add_argument("--max-decode-len", type=int, default=0)
        p.add_argument("--kv-page-size", type=int, default=16)
        p.add_argument("--max-batch-slots", type=int, default=8)
        p.add_argument("--serve-objective", type=str, default=U,
                       choices=("latency", "throughput"))
        p.add_argument("--serve-watch-dir", type=str, default="")
        p.add_argument("--serve-ttft-budget-ms", type=float, default=0.0)
        p.add_argument("--serve-queue-cap", type=int, default=0)
        p.add_argument("--serve-decode-timeout-ms", type=float, default=0.0)
        p.add_argument("--serve-draft-model", type=str, default="")
        p.add_argument("--serve-spec-tokens", type=int, default=0)
        p.add_argument("--kv-cache-dtype", type=str, default="auto",
                       choices=("auto", "bf16", "int8"))
        p.add_argument("--serve-slo", type=str, default="",
                       help='SLO objectives, e.g. "ttft_p99_ms=25,'
                            'per_token_p99_ms=10,availability=0.999"')
        p.add_argument("--serve-reqtrace",
                       action=argparse.BooleanOptionalAction, default=True)
        p.add_argument("--kv-host-pages", type=int, default=0)
        p.add_argument("--kv-prefetch-ahead", type=int, default=2)
        p.add_argument("--serve-max-context", type=int, default=0)
        p.add_argument("--serve-replicas", type=int, default=1)
        p.add_argument("--serve-fleet-topology", type=str,
                       default="colocated", choices=("colocated", "disagg"))
        p.add_argument("--serve-prefill-replicas", type=int, default=1)
        p.add_argument("--serve-router", type=str, default="least_loaded",
                       choices=("least_loaded", "round_robin"))
        p.add_argument("--serve-rollout-burn-max", type=float, default=0.0)
        p.add_argument("--serve-trace-out", type=str, default="",
                       help="export the served load as a replayable "
                            "tracefmt JSONL trace at serve end")
        p.add_argument("--twin-trace", type=str, default="",
                       help="trace file the capacity twin replays")
        p.add_argument("--twin-replicas", type=int, default=0,
                       help="replica count the twin simulates "
                            "(0 = --serve-replicas)")
        p.add_argument("--twin-out", type=str, default="",
                       help="twin report JSON path ('' = stdout)")
        return p

    @staticmethod
    def parse_args(argv: Optional[List[str]] = None) -> "FFConfig":
        args, _unknown = FFConfig.build_parser().parse_known_args(argv)
        given = sorted(d for d in _UNPORTED if hasattr(args, d))
        if given:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(
                    f"{_UNPORTED[d][0]} (ROADMAP Queue 1 item "
                    f"{_UNPORTED[d][1]})" for d in given))
        return FFConfig(
            epochs=args.epochs,
            batch_size=args.batch_size,
            learning_rate=args.lr,
            weight_decay=args.wd,
            iterations=args.iterations,
            seq_length=args.seq_length,
            seed=args.seed,
            search_budget=args.budget,
            search_alpha=args.alpha,
            only_data_parallel=args.only_data_parallel,
            enable_parameter_parallel=args.enable_parameter_parallel,
            enable_attribute_parallel=args.enable_attribute_parallel,
            base_optimize_threshold=args.base_optimize_threshold,
            search_num_nodes=args.search_num_nodes,
            search_num_workers=args.search_num_workers,
            memory_search=args.memory_search,
            substitution_json=args.substitution_json,
            strategy_cache=args.strategy_cache,
            strategy_cache_dir=args.strategy_cache_dir,
            simulator_mode=args.simulator_mode,
            machine_model_file=args.machine_model_file,
            profiling=args.profiling,
            profile_dir=args.profile_dir,
            profile_ops=args.profile_ops,
            telemetry_dir=args.telemetry_dir,
            telemetry_max_mb=args.telemetry_max_mb,
            health_sentinels=args.health_sentinels,
            halt_on_nonfinite=args.halt_on_nonfinite,
            pipeline_stages=args.pipeline_stages,
            enable_fusion=args.fusion,
            compute_dtype=args.compute_dtype,
            max_decode_len=args.max_decode_len,
            kv_page_size=args.kv_page_size,
            max_batch_slots=args.max_batch_slots,
            kv_cache_dtype=args.kv_cache_dtype,
            serve_draft_model=args.serve_draft_model,
            serve_spec_tokens=args.serve_spec_tokens,
            serve_ttft_budget_ms=args.serve_ttft_budget_ms,
            serve_queue_cap=args.serve_queue_cap,
            serve_decode_timeout_ms=args.serve_decode_timeout_ms,
            serve_slo=args.serve_slo,
            serve_max_context=args.serve_max_context,
            serve_watch_dir=args.serve_watch_dir,
            serve_reqtrace=args.serve_reqtrace,
            kv_host_pages=args.kv_host_pages,
            kv_prefetch_ahead=args.kv_prefetch_ahead,
            serve_trace_out=args.serve_trace_out,
            serve_replicas=args.serve_replicas,
            serve_fleet_topology=args.serve_fleet_topology,
            serve_prefill_replicas=args.serve_prefill_replicas,
            serve_router=args.serve_router,
            serve_rollout_burn_max=args.serve_rollout_burn_max,
            twin_trace=args.twin_trace,
            twin_replicas=args.twin_replicas,
            twin_out=args.twin_out,
            sync_every=args.sync_every,
            accum_steps=args.accum_steps,
            steps_per_dispatch=args.steps_per_dispatch,
            dispatch_ahead=args.dispatch_ahead,
            fused_loss=args.fused_loss,
            fused_optimizer=args.fused_optimizer,
            import_strategy_file=args.import_file,
            export_strategy_file=args.export_file,
            remat=args.remat,
            remat_search=args.remat_search,
            remat_policies=args.remat_policies,
            export_dot=args.export_dot,
            include_costs_dot_graph=args.include_costs_dot_graph,
            async_checkpoint=args.async_checkpoint,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every_steps=args.checkpoint_every_steps,
            checkpoint_every_secs=args.checkpoint_every_secs,
            resume=args.resume,
            keep_checkpoints=args.keep_checkpoints,
            retry_attempts=args.retry_attempts,
            retry_base_delay=args.retry_base_delay,
            fault_plan=args.fault_plan,
        )


# The JAX parser's flags whose features the port has not yet: argparse
# dest -> (flag, ROADMAP Queue 1 item that ports it)
_UNPORTED = {
    "mesh": ("--mesh", 9), "nodes": ("--nodes", 9),
    "workers": ("--workers-per-node", 9),
    "zero_sharding": ("--zero-sharding", 9),
    "pipeline_schedule": ("--pipeline-schedule", 9),
    "serve_objective": ("--serve-objective", 9),
    "simulator_segment_size": ("--simulator-segment-size", 8),
    "simulator_topk": ("--simulator-topk", 8),
    "cost_model_path": ("--cost-model-path", 8),
    "auto_refit": ("--auto-refit", 8),
    "simulator_trace": ("--simulator-trace", 8),
    "serve": ("--serve", 7),
}
