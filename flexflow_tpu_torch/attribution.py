"""Per-op performance attribution: where does the step go? (counterpart:
flexflow_tpu/attribution.py, the same report and events.)

For every (graph layer, compiled placement) the report lines up

  * the PREDICTED cost: the search's per-op cost stamped on the strategy
    (`Strategy._predicted_op_costs`, restored from the strategy cache),
    else the candidate's analytic op time;
  * the MEASURED time: primary path, the Chrome trace that `torch.profiler`
    writes under `--profiling` (compiler/compile.py), each CUDA kernel
    credited to a layer as `measured_from_trace` describes; fallback path,
    each layer's lowering timed alone at the placement's shard shapes
    (search/measure.MeasuredCost), rescaled so that the attributed times
    sum to the REAL measured step time;
  * the ROOFLINE bound (search/cost_model.op_roofline): the device-floor
    time, the leg that binds (compute or HBM bandwidth) and the MFU
    ceiling,

with per-op MFU and the per-op drift top-K ("these 3 ops explain 87% of
the step-time misprediction"). Each row is featurized as the JAX package
featurizes it (op kind, shapes, dtype, layout, sharding, machine), and
with telemetry on the rows go out as `op/attr` events that
tools/span_dataset.py reads into its corpus.

Entry points: `CompiledModel.op_attribution()` and `profile_report()`, and
`--profile-ops` (attribution at fit end).
"""

from __future__ import annotations

import bisect
import glob
import gzip
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.search import cost_model as cmod
from flexflow_tpu_torch.search import memo

# telemetry event names (cat "op"): one op/attr per attributed row, one
# op/drift_topk per report, read by tools/span_dataset.py and
# tools/trace_report.py
OP_EVENT = "op/attr"
DRIFT_EVENT = "op/drift_topk"

# acceptance tolerance: attributed per-op times must sum to the measured
# step time within this fraction
SUM_TOLERANCE = 0.15

# the device's work in a torch.profiler trace (a record_function range's
# mirror on the device timeline, "gpu_user_annotation", is not work)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_BACKWARD_PREFIX = "autograd::engine::evaluate_function: "


# ------------------------------------------------------------ featurization
def op_features(layer, cand, machine) -> Dict[str, Any]:
    """The learned-cost-model featurization of one placed op: opcode,
    shapes, dtype, params, layout and sharding, and the machine's
    fingerprint. JSON-serializable; `feature_key` hashes the identity
    subset (the layer NAME is instance identity, not a feature: two GPT-2
    blocks' identical matmuls dedup to one corpus row)."""
    out0 = layer.outputs[0].spec if layer.outputs else None
    return {
        "op": layer.op_type.value,
        "in_shapes": [list(t.spec.shape) for t in layer.inputs],
        "out_shapes": [list(t.spec.shape) for t in layer.outputs],
        "weight_shapes": {w: list(s.shape)
                          for w, s in sorted(layer.weight_specs.items())},
        "dtype": out0.dtype.value if out0 is not None else "",
        "params": repr(layer.params_key()),
        "layout": cand.name,
        "sharding": {
            "out": [list(map(_ax_str, d)) for d in cand.out_dims],
            "weights": {w: list(map(_ax_str, d))
                        for w, d in sorted(cand.weight_dims.items())},
        },
        "machine": memo.machine_fingerprint(machine),
    }


def _ax_str(d) -> str:
    if d is None:
        return ""
    return d if isinstance(d, str) else "+".join(d)


def feature_key(features: Dict[str, Any]) -> str:
    """Stable dedup key of a feature row: sha1 over the canonical JSON of
    the identity fields (sorted keys, no floats), so corpus rows from
    different runs and machines merge."""
    ident = {k: features.get(k) for k in
             ("op", "in_shapes", "out_shapes", "weight_shapes", "dtype",
              "params", "layout", "sharding", "machine")}
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------- torch.profiler trace
def _latest_trace(profile_dir: str) -> Optional[str]:
    if not profile_dir or not os.path.isdir(profile_dir):
        return None
    paths = sorted(
        glob.glob(os.path.join(profile_dir, "**", "*.trace.json"),
                  recursive=True)
        + glob.glob(os.path.join(profile_dir, "**", "*.trace.json.gz"),
                    recursive=True),
        key=lambda p: os.path.getmtime(p))
    return paths[-1] if paths else None


class _Intervals:
    """CPU-side [ts, ts + dur] ranges of one thread, for the question
    "which of them hold this instant?"."""

    def __init__(self, items):
        items = sorted(items, key=lambda it: it[0])
        self.starts = [it[0] for it in items]
        self.items = items
        self.longest = max((it[1] - it[0] for it in items), default=0.0)

    def holding(self, ts: float) -> list:
        out = []
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0 and self.starts[i] >= ts - self.longest:
            if self.items[i][1] >= ts:
                out.append(self.items[i])
            i -= 1
        return out


def _arg(ev, key):
    args = ev.get("args")
    return args.get(key) if isinstance(args, dict) else None


def trace_attribution(profile_dir: str, layer_names: Sequence[str]
                      ) -> Optional[Dict[str, Any]]:
    """Credit the device work of the newest torch.profiler Chrome trace
    under `profile_dir` to graph layers. The lowering runs each layer
    (its casts included) in a `record_function` range named exactly after
    the layer (compiler/lowering.py, under --profiling); a name matches
    whole, so "up" never absorbs "update". A kernel (or memcpy/memset)
    links through its `correlation` to the runtime call that launched it,
    on a CPU thread at a time:

      * forward: the call lies in a layer's range on its thread; the
        layer is credited;
      * backward: autograd runs the node outside any range, inside an
        `autograd::engine::evaluate_function: <Node>` op that carries the
        node's `Sequence number` and `Fwd thread id`; the forward op that
        created that node carries the same pair (of the forward ops
        recording that pair, the last one created the node); the node's
        kernels go to the layer whose range holds that op, or to none
        (the loss's nodes). `torch.autograd.Function`s (the flash
        backward) link the same way.

    A kernel reached by neither (the loss, the optimizer, the input
    copies, a CUDA graph's replay: its kernels carry only the
    cudaGraphLaunch's correlation) is left uncredited; nothing is guessed.

    Returns {"layers": {layer: us}, "kernels": {layer: {kernel: us}},
    "device_us": all device work in the trace, "credited_us", "file"}, or
    None when no parseable trace exists."""
    path = _latest_trace(profile_dir)
    if path is None:
        return None
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        return None
    names = set(layer_names)
    ranges: Dict[Any, list] = {}      # (pid, tid) -> [(t0, t1, layer)]
    backward: Dict[Any, list] = {}    # (pid, tid) -> [(t0, t1, key)]
    fwd_ops: List[tuple] = []         # (pid, tid, ts, key)
    launches: Dict[Any, tuple] = {}   # correlation -> (pid, tid, ts)
    device: List[dict] = []
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0) or 0.0)
        where = (ev.get("pid"), ev.get("tid"))
        if cat in _DEVICE_CATS:
            if dur > 0:
                device.append(ev)
            continue
        name = str(ev.get("name", ""))
        corr = _arg(ev, "correlation")
        if corr is not None:
            launches[corr] = (where, ts)
        if cat == "user_annotation" and name in names:
            ranges.setdefault(where, []).append((ts, ts + dur, name))
            continue
        seq = _arg(ev, "Sequence number")
        if cat != "cpu_op" or seq is None:
            continue
        key = (ev.get("pid"), _arg(ev, "Fwd thread id"), int(seq))
        if name.startswith(_BACKWARD_PREFIX):
            backward.setdefault(where, []).append((ts, ts + dur, key))
        else:
            fwd_ops.append((where, ts, key))
    layer_at = {w: _Intervals(r) for w, r in ranges.items()}
    bwd_at = {w: _Intervals(r) for w, r in backward.items()}
    # an op inside an evaluate_function is backward work (the node's own
    # record carries the node's pair too), not the op that made the node
    fwd_ops = [(where, ts, key) for where, ts, key in fwd_ops
               if where not in bwd_at or not bwd_at[where].holding(ts)]

    def layer_of(where, ts):
        iv = layer_at.get(where)
        held = iv.holding(ts) if iv is not None else []
        # the innermost range: the latest start
        return max(held)[2] if held else None

    # node key -> the last forward op recording it (the one that made
    # the node), in a layer's range or not (the loss's ops lie outside
    # every range); each op also under its key without the thread id,
    # for a trace whose forward ops do not record it
    last: Dict[Any, tuple] = {}
    for where, ts, key in fwd_ops:
        for k in (key, (key[0], None, key[2])):
            if k not in last or ts >= last[k][0]:
                last[k] = (ts, where)
    node_layer = {k: layer_of(where, ts) for k, (ts, where) in last.items()}
    totals: Dict[str, float] = {}
    kernels: Dict[str, Dict[str, float]] = {}
    device_us = credited = 0.0
    for ev in device:
        dur = float(ev["dur"])
        device_us += dur
        launch = launches.get(_arg(ev, "correlation"))
        if launch is None:
            continue
        where, ts = launch
        layer = layer_of(where, ts)
        if layer is None:
            iv = bwd_at.get(where)
            # the outermost evaluate_function holding the launch: the node
            # autograd was running
            for t0, _t1, key in sorted(iv.holding(ts) if iv else []):
                if key not in node_layer:
                    key = (key[0], None, key[2])
                if key in node_layer:
                    layer = node_layer[key]
                    break
        if layer is None:
            continue
        credited += dur
        totals[layer] = totals.get(layer, 0.0) + dur
        kn = kernels.setdefault(layer, {})
        kname = str(ev.get("name", ""))
        kn[kname] = kn.get(kname, 0.0) + dur
    return {"layers": totals, "kernels": kernels, "device_us": device_us,
            "credited_us": credited, "file": path}


def measured_from_trace(profile_dir: str, layer_names: Sequence[str]
                        ) -> Optional[Dict[str, float]]:
    """layer -> total device microseconds across the newest trace under
    `profile_dir` (see `trace_attribution`), or None when no parseable
    trace exists or nothing in it was credited (the caller falls back to
    MeasuredCost). Totals are only meaningful as FRACTIONS of the step:
    the caller normalizes against the measured step time."""
    att = trace_attribution(profile_dir, layer_names)
    return (att["layers"] or None) if att is not None else None


# ------------------------------------------------------------- the report
def build_report(items: List[Dict[str, Any]],
                 step_time_s: Optional[float] = None,
                 mult: int = 1,
                 profile_dir: Optional[str] = None,
                 source: str = "auto",
                 measure_repeats: int = 3,
                 measure_warmup: int = 1,
                 emit: Optional[bool] = None,
                 inference: bool = False,
                 tag: Optional[str] = None,
                 device=None,
                 compute_dtype: str = "float32",
                 state_fn=None) -> Dict[str, Any]:
    """Assemble the attribution report (JAX's arguments and keys).

    items: one dict per placed op, {"layer", "cand", "machine",
    "predicted_s" (per fwd+bwd pass; None -> analytic), "stage"}.
    mult: passes per optimizer update (accum_steps), so every column is
    per UPDATE. step_time_s: the REAL measured per-update wall time (the
    drift monitor's); measured per-op times are rescaled so attributed
    times sum to it. source: "auto" (the trace when one can be read,
    else measure; `source` in the report says which ran), "trace"
    (raises without a measured step time or a readable trace),
    "measure". inference: forward only (serving), priced on the
    roofline's forward leg. tag: the op/attr events' "source". device and
    compute_dtype: where and in what dtype MeasuredCost times the ops
    (the compile's); with `inference` it times the forward only.
    state_fn(layer): the lowering state a measured op reads (the serving
    engine's synthetic paged cache for a decode attention). `coverage`:
    on the trace path the share of the trace's device time credited to a
    layer; on the measure path the isolated times' sum over the step
    (JAX's).
    """
    from flexflow_tpu_torch.search.measure import MeasuredCost

    if emit is None:
        emit = tel.enabled()
    att = None
    if source in ("auto", "trace"):
        # trace totals are WHOLE-RUN device-time sums: only their
        # proportions carry over, so the trace path needs a measured step
        # time to normalize against
        if step_time_s:
            att = trace_attribution(profile_dir or "",
                                    [it["layer"].name for it in items])
            if att is not None and not att["layers"]:
                att = None
        if source == "trace":
            if not step_time_s:
                raise ValueError("source='trace' needs a measured step "
                                 "time (run fit() first)")
            if att is None:
                raise ValueError(f"no parseable profiler trace crediting a "
                                 f"layer under {profile_dir!r} (run with "
                                 "--profiling)")
    used_source = "trace" if att is not None else "measure"

    mcs: Dict[str, MeasuredCost] = {}  # one per machine fingerprint

    def mc_for(machine):
        fp = memo.machine_fingerprint(machine)
        if fp not in mcs:
            mcs[fp] = MeasuredCost(machine, repeats=measure_repeats,
                                   warmup=measure_warmup, cache_dir="",
                                   device=device,
                                   compute_dtype=compute_dtype,
                                   forward_only=inference,
                                   state_fn=state_fn)
        return mcs[fp]

    rows: List[Dict[str, Any]] = []
    for it in items:
        layer, cand, machine = it["layer"], it["cand"], it["machine"]
        roof = cmod.op_roofline(layer, cand, machine)
        if inference:
            # the forward leg only: op_roofline prices fwd+bwd (3x flops,
            # 2x bytes)
            roof = dict(roof)
            t_flop = roof["t_flop_s"] / 3.0
            t_mem = roof["t_mem_s"] / 2.0
            roof["roofline_s"] = max(t_flop, t_mem)
            roof["device_flops"] = roof["device_flops"] / 3.0
            roof["hbm_bytes"] = roof["hbm_bytes"] / 2.0
            roof["bound"] = "bandwidth" if t_mem > t_flop else "compute"
            roof["mfu_ceiling"] = (
                roof["device_flops"] / (roof["roofline_s"] * machine.flops)
                if roof["roofline_s"] > 0 else 0.0)
        if att is not None:
            # whole-run device us; normalized to per-update seconds below
            measured = att["layers"].get(layer.name, 0.0) * 1e-6
        elif inference:
            measured = mc_for(machine).op_time_fwd(layer, cand) * mult
        else:
            measured = mc_for(machine).op_time(layer, cand) * mult
        predicted = it.get("predicted_s")
        if predicted is None:
            predicted = cand.op_time(layer, machine)
        feats = op_features(layer, cand, machine)
        rows.append({
            "stage": it.get("stage"),
            "layer": layer.name,
            "op": layer.op_type.value,
            "candidate": cand.name,
            "predicted_s": float(predicted) * mult,
            "measured_s": float(measured),
            "roofline_s": roof["roofline_s"] * mult,
            "bound": roof["bound"],
            "mfu_ceiling": roof["mfu_ceiling"],
            "flops": roof["flops"],
            "device_flops": roof["device_flops"] * mult,
            "hbm_bytes": roof["hbm_bytes"],
            "machine_flops": machine.flops,
            "key": feature_key(feats),
            "features": feats,
        })

    if used_source == "trace":
        # per-update measured time = the op's share of the profiled
        # stream x the real step time
        raw = sum(r["measured_s"] for r in rows)
        if raw > 0:
            f = float(step_time_s) / raw
            for r in rows:
                r["measured_s"] *= f
    total_meas = sum(r["measured_s"] for r in rows)
    scale = 1.0
    if step_time_s and total_meas > 0:
        scale = float(step_time_s) / total_meas
    for r in rows:
        r["attributed_s"] = r["measured_s"] * scale
        denom = (r["attributed_s"] if step_time_s else r["measured_s"])
        r["mfu"] = (r["device_flops"] / (denom * r["machine_flops"])
                    if denom > 0 else 0.0)
    rows.sort(key=lambda r: -r["attributed_s"])
    if att is not None:
        coverage = (att["credited_us"] / att["device_us"]
                    if att["device_us"] > 0 else None)
    else:
        coverage = (total_meas / step_time_s) if step_time_s else None
    report = {
        "rows": rows,
        "step_time_s": float(step_time_s) if step_time_s else None,
        "measured_total_s": total_meas,
        "attributed_total_s": sum(r["attributed_s"] for r in rows),
        "coverage": coverage,
        "scale": scale,
        "mult": mult,
        "source": used_source,
    }
    if att is not None:
        report["trace"] = {k: att[k] for k in ("file", "device_us",
                                               "credited_us", "kernels")}
    report["top_drift"] = drift_top_k(rows)
    if emit:
        for r in rows:
            args = {k: r[k] for k in
                    ("layer", "op", "candidate", "predicted_s",
                     "measured_s", "attributed_s", "roofline_s", "bound",
                     "mfu", "mfu_ceiling", "key")}
            if r["stage"] is not None:
                args["stage"] = r["stage"]
            args["source"] = tag or used_source
            args["features"] = r["features"]
            tel.event(OP_EVENT, cat="op", **args)
        td = report["top_drift"]
        if td["rows"]:
            tel.event(DRIFT_EVENT, cat="op",
                      worst=td["rows"][0]["layer"],
                      explained=td["explained"],
                      rows=[{"layer": x["layer"], "err_s": x["err_s"],
                             "share": x["share"]} for x in td["rows"]])
    return report


def drift_top_k(rows: Sequence[Dict[str, Any]], k: int = 3
                ) -> Dict[str, Any]:
    """Which ops explain the step-time misprediction? err = attributed -
    predicted per op; the top-k by |err| with their share of the total
    absolute error, and `explained`, the cumulative share."""
    errs = []
    for r in rows:
        meas = r.get("attributed_s", r.get("measured_s", 0.0))
        errs.append((abs(meas - r["predicted_s"]),
                     meas - r["predicted_s"], r))
    total = sum(a for a, _e, _r in errs)
    errs.sort(key=lambda x: -x[0])
    out = []
    cum = 0.0
    for a, e, r in errs[:max(0, k)]:
        share = a / total if total > 0 else 0.0
        cum += share
        out.append({"layer": r["layer"], "op": r["op"],
                    "predicted_s": r["predicted_s"],
                    "measured_s": r.get("attributed_s",
                                        r.get("measured_s", 0.0)),
                    "err_s": e, "share": share})
    return {"rows": out, "explained": cum,
            "total_abs_err_s": total, "k": min(k, len(errs))}


# ------------------------------------------------------------- rendering
def format_report(report: Dict[str, Any], top: int = 0) -> List[str]:
    """The [ops] table and the [drift] top-K lines."""
    rows = report["rows"][:top] if top else report["rows"]
    has_stage = any(r["stage"] is not None for r in rows)
    lines = []
    head = ("st " if has_stage else "") + \
        f"{'layer':24} {'op':14} {'pred':>9} {'attr':>9} {'roof':>9} " \
        f"{'mfu':>5} {'bound':>9} {'%':>5}"
    lines.append(head)
    total = report["attributed_total_s"] or 1.0
    for r in rows:
        st = f"{r['stage']:2d} " if has_stage else ""
        lines.append(
            f"{st}{r['layer'][:24]:24} {r['op'][:14]:14} "
            f"{r['predicted_s'] * 1e6:8.1f}u {r['attributed_s'] * 1e6:8.1f}u "
            f"{r['roofline_s'] * 1e6:8.1f}u {r['mfu']:5.2f} "
            f"{r['bound']:>9} {100 * r['attributed_s'] / total:4.1f}%")
    st_ = report.get("step_time_s")
    cov = report.get("coverage")
    lines.append(
        f"[ops] source={report['source']} "
        f"attributed_total={report['attributed_total_s'] * 1e3:.3f}ms"
        + (f" step={st_ * 1e3:.3f}ms" if st_
           else " (no measured step time; run fit() first)")
        + (f" coverage={cov:.2f}" if cov is not None else ""))
    td = report["top_drift"]
    if td["rows"]:
        worst = ", ".join(f"{x['layer']} ({x['err_s'] * 1e6:+.1f}us)"
                          for x in td["rows"])
        lines.append(f"[drift] top-{td['k']} mispriced ops explain "
                     f"{100 * td['explained']:.0f}% of the per-op "
                     f"misprediction: {worst}")
    return lines
