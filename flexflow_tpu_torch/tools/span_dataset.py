"""Compile a telemetry dir into the learned cost model's training corpus
(counterpart: tools/span_dataset.py).

Every profiled fit (`profile_ops` with `telemetry_dir`) emits one `op/attr`
event per placed op, featurized as "A Learned Performance Model for TPUs"
(arXiv 2008.01040) featurizes ops: op kind, shapes, dtype, layout,
sharding, the machine's fingerprint, and the measured, predicted and
roofline times. This tool folds a telemetry dir (or one .jsonl file) into
a deduplicated JSON-Lines corpus: one row per feature key
(flexflow_tpu_torch.attribution.feature_key: identical ops across runs,
layers and processes merge), with measured-time statistics. Re-running
over a growing telemetry dir merges by key, so every profiled fit grows
the corpus that search/learned_cost.py trains on.

Usage:
    python -m flexflow_tpu_torch.tools.span_dataset <telemetry-dir-or-file>
        [--out corpus.jsonl] [--merge existing.jsonl]
    python -m flexflow_tpu_torch.tools.span_dataset --stats <corpus-or-dir>
    python -m flexflow_tpu_torch.tools.span_dataset --check [--device cpu]

Row schema (one JSON object per line):
  {"schema_version": int, "key": str,
   "features": {...2008.01040 featurization...},
   "machine": str, "n": int, "measured_s": {"mean", "p50", "min", "max"},
   "attributed_s_mean": float, "predicted_s": float, "roofline_s": float,
   "mfu_mean": float, "bound": str, "sources": [..]}

`--stats` prints corpus health (rows, machines, op-kind histogram,
measured-time spread) before a refit (tools/refit_cost_model.py in this
package) trusts the corpus. `--check` runs a profiled fit of a small MLP
on the card (or on `--device cpu`) and checks its corpus.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Any, Dict, List, Optional

# row schema version: 1 = rows without the field (they read as 1), 2 adds
# the explicit "schema_version" field
SCHEMA_VERSION = 2


def collect_rows(path: str) -> List[Dict[str, Any]]:
    """op/attr events from a telemetry stream, grouped by feature key."""
    from flexflow_tpu_torch.attribution import OP_EVENT, feature_key
    from flexflow_tpu_torch.telemetry import read_events

    groups: Dict[str, Dict[str, Any]] = {}
    for ev in read_events(path):
        if ev.get("name") != OP_EVENT:
            continue
        args = ev.get("args") or {}
        feats = args.get("features")
        if not isinstance(feats, dict):
            continue
        key = args.get("key") or feature_key(feats)
        g = groups.setdefault(key, {
            "key": key, "features": feats,
            "machine": feats.get("machine", ""),
            "measured": [], "attributed": [], "mfu": [],
            "predicted_s": None, "roofline_s": None, "bound": None,
            "sources": set(),
        })
        if args.get("measured_s") is not None:
            g["measured"].append(float(args["measured_s"]))
        if args.get("attributed_s") is not None:
            g["attributed"].append(float(args["attributed_s"]))
        if args.get("mfu") is not None:
            g["mfu"].append(float(args["mfu"]))
        # predicted/roofline are deterministic per feature key — last wins
        if args.get("predicted_s") is not None:
            g["predicted_s"] = float(args["predicted_s"])
        if args.get("roofline_s") is not None:
            g["roofline_s"] = float(args["roofline_s"])
        if args.get("bound"):
            g["bound"] = args["bound"]
        if args.get("source"):
            g["sources"].add(str(args["source"]))
    rows = []
    for key in sorted(groups):
        g = groups[key]
        ms = sorted(g["measured"])
        rows.append({
            "schema_version": SCHEMA_VERSION,
            "key": key,
            "features": g["features"],
            "machine": g["machine"],
            "n": len(ms),
            "measured_s": {
                "mean": sum(ms) / len(ms) if ms else None,
                "p50": statistics.median(ms) if ms else None,
                "min": ms[0] if ms else None,
                "max": ms[-1] if ms else None,
            },
            "attributed_s_mean": (sum(g["attributed"]) / len(g["attributed"])
                                  if g["attributed"] else None),
            "mfu_mean": (sum(g["mfu"]) / len(g["mfu"]) if g["mfu"]
                         else None),
            "predicted_s": g["predicted_s"],
            "roofline_s": g["roofline_s"],
            "bound": g["bound"],
            "sources": sorted(g["sources"]),
        })
    return rows


def merge_rows(base: List[Dict[str, Any]], new: List[Dict[str, Any]]
               ) -> List[Dict[str, Any]]:
    """Fold freshly collected rows into an existing corpus: same key ->
    measurement counts/statistics pool (weighted mean, conservative
    min/max; p50 takes the larger sample's), new keys append."""
    by_key = {r["key"]: dict(r) for r in base}
    for r in new:
        old = by_key.get(r["key"])
        if old is None:
            by_key[r["key"]] = r
            continue
        n0, n1 = int(old.get("n") or 0), int(r.get("n") or 0)
        m0, m1 = old.get("measured_s") or {}, r.get("measured_s") or {}
        if n0 + n1 > 0 and (m0.get("mean") is not None
                            or m1.get("mean") is not None):
            mean0 = m0.get("mean") or 0.0
            mean1 = m1.get("mean") or 0.0
            merged = {
                "mean": (mean0 * n0 + mean1 * n1) / max(1, n0 + n1),
                "p50": (m0 if n0 >= n1 else m1).get("p50"),
                "min": min(x for x in (m0.get("min"), m1.get("min"))
                           if x is not None),
                "max": max(x for x in (m0.get("max"), m1.get("max"))
                           if x is not None),
            }
            old["measured_s"] = merged
        old["n"] = n0 + n1
        # a merged row is as new as its newest contributor (absent = v1)
        old["schema_version"] = max(int(old.get("schema_version") or 1),
                                    int(r.get("schema_version") or 1))
        for k in ("predicted_s", "roofline_s", "bound", "attributed_s_mean",
                  "mfu_mean"):
            if r.get(k) is not None:
                old[k] = r[k]
        old["sources"] = sorted(set(old.get("sources") or [])
                                | set(r.get("sources") or []))
        by_key[r["key"]] = old
    return [by_key[k] for k in sorted(by_key)]


def write_jsonl(rows: List[Dict[str, Any]], out_path: str) -> None:
    tmp = out_path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        for r in rows:
            f.write(json.dumps(r, sort_keys=True, separators=(",", ":"))
                    + "\n")
    os.replace(tmp, out_path)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    rows = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                if isinstance(r, dict) and r.get("key"):
                    rows.append(r)
    except OSError:
        pass
    return rows


def build(path: str, out_path: Optional[str] = None,
          merge: Optional[str] = None, quiet: bool = False
          ) -> List[Dict[str, Any]]:
    rows = collect_rows(path)
    if merge:
        rows = merge_rows(read_jsonl(merge), rows)
    if out_path:
        write_jsonl(rows, out_path)
    if not quiet:
        n_meas = sum(r["n"] for r in rows)
        print(f"{len(rows)} corpus rows ({n_meas} measurements) from {path}"
              + (f" -> {out_path}" if out_path else ""))
    return rows


# -------------------------------------------------------------------- stats
def stats_summary(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Corpus health facts: is this corpus worth refitting a model from?"""
    kinds: Dict[str, int] = {}
    machines: Dict[str, int] = {}
    versions: Dict[int, int] = {}
    means = []
    n_meas = 0
    for r in rows:
        op = str((r.get("features") or {}).get("op"))
        kinds[op] = kinds.get(op, 0) + 1
        mfp = str(r.get("machine") or "")
        machines[mfp] = machines.get(mfp, 0) + 1
        v = int(r.get("schema_version") or 1)
        versions[v] = versions.get(v, 0) + 1
        n_meas += int(r.get("n") or 0)
        m = (r.get("measured_s") or {}).get("mean")
        if m is not None and m > 0:
            means.append(float(m))
    means.sort()
    spread = None
    if means:
        spread = {
            "min_s": means[0],
            "p50_s": statistics.median(means),
            "max_s": means[-1],
            "mean_s": sum(means) / len(means),
        }
    return {
        "rows": len(rows),
        "measured_rows": len(means),
        "measurements": n_meas,
        "machines": sorted(machines),
        "schema_versions": {str(k): v for k, v in sorted(versions.items())},
        "op_kinds": dict(sorted(kinds.items(),
                                key=lambda kv: (-kv[1], kv[0]))),
        "measured_spread": spread,
    }


def format_stats(s: Dict[str, Any]) -> str:
    lines = [
        f"rows: {s['rows']} ({s['measured_rows']} with measurements, "
        f"{s['measurements']} raw samples)",
        f"machines: {len(s['machines'])}"
        + (f" [{', '.join(m[:16] for m in s['machines'])}]"
           if s["machines"] else ""),
        "schema versions: " + ", ".join(
            f"v{k}: {v}" for k, v in s["schema_versions"].items()),
        "op kinds:",
    ]
    for op, n in s["op_kinds"].items():
        lines.append(f"  {op:<24} {n}")
    sp = s.get("measured_spread")
    if sp:
        lines.append(
            f"measured mean spread: {sp['min_s'] * 1e6:.2f}us .. "
            f"p50 {sp['p50_s'] * 1e6:.2f}us .. {sp['max_s'] * 1e6:.2f}us")
    else:
        lines.append("measured mean spread: (no measured rows)")
    return "\n".join(lines)


# --------------------------------------------------------------- check mode
def profiled_fit(tdir: str, device: str = "cuda") -> None:
    """A profiled 2-epoch fit of a small MLP writing op/attr rows under
    `tdir` (the smoke of both tools)."""
    import numpy as np

    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer

    cfg = FFConfig(batch_size=16, only_data_parallel=True,
                   telemetry_dir=tdir, profile_ops=True)
    m = FFModel(cfg)
    x = m.create_tensor([16, 8], name="x")
    m.dense(m.dense(x, 16, activation="relu", name="fc1"), 4, name="fc2")
    cm = m.compile(SGDOptimizer(lr=0.01),
                   loss_type="sparse_categorical_crossentropy", metrics=[],
                   device=device)
    cm.init(seed=0)
    rng = np.random.default_rng(0)
    xv = rng.normal(size=(64, 8)).astype(np.float32)
    yv = rng.integers(0, 4, size=(64,)).astype(np.int32)
    cm.fit(xv, yv, epochs=2, verbose=False)


def _check(device: str = "cuda") -> int:
    """Profiled small fit -> a non-empty featurized corpus whose rows
    round-trip with stable feature keys (write -> read -> feature_key of
    the features == key), and whose merge is idempotent by key."""
    import tempfile

    from flexflow_tpu_torch import telemetry
    from flexflow_tpu_torch.attribution import feature_key

    with tempfile.TemporaryDirectory() as td:
        tdir = os.path.join(td, "telemetry")
        profiled_fit(tdir, device)
        telemetry.flush()
        out = os.path.join(td, "corpus.jsonl")
        rows = build(tdir, out_path=out, quiet=True)
        telemetry.shutdown()

        assert rows, "profiled fit produced an empty corpus"
        assert all(r["n"] >= 1 and r["measured_s"]["mean"] is not None
                   for r in rows), rows
        back = read_jsonl(out)
        assert len(back) == len(rows), (len(back), len(rows))
        for r in back:
            assert feature_key(r["features"]) == r["key"], \
                f"unstable feature key for {r['features'].get('op')}"
            assert r.get("predicted_s") is not None
            assert r.get("roofline_s") is not None
            assert r.get("schema_version") == SCHEMA_VERSION, r
        s = stats_summary(back)
        assert s["rows"] == len(back) and s["measured_rows"] > 0, s
        assert s["op_kinds"] and s["measured_spread"] is not None, s
        assert format_stats(s)
        # folding the same telemetry in again grows counts, not keys
        merged = build(tdir, out_path=None, merge=out, quiet=True)
        assert len(merged) == len(rows), (len(merged), len(rows))
        assert all(mr["n"] == 2 * r["n"] for mr, r in
                   zip(merged, sorted(rows, key=lambda x: x["key"])))
    print("span_dataset --check OK")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        "flexflow_tpu_torch.tools.span_dataset", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", nargs="?", default=None,
                    help="telemetry dir or one telemetry-*.jsonl file")
    ap.add_argument("--out", default=None,
                    help="corpus JSONL path (default <dir>/op_corpus.jsonl)")
    ap.add_argument("--merge", default=None,
                    help="existing corpus to fold the new rows into")
    ap.add_argument("--stats", action="store_true",
                    help="print corpus health (rows, machines, op-kind "
                         "histogram, measured-time spread) and exit")
    ap.add_argument("--check", action="store_true",
                    help="smoke: profiled fit -> corpus -> validate")
    ap.add_argument("--device", default="cuda",
                    help="device of --check's fit (default: the card)")
    args = ap.parse_args(argv)
    if args.check:
        return _check(args.device)
    if not args.path:
        ap.error("path required (or --check)")
    if args.stats:
        rows = (read_jsonl(args.path) if os.path.isfile(args.path)
                and args.path.endswith(".jsonl") else None)
        if not rows:
            rows = collect_rows(args.path)
        print(format_stats(stats_summary(rows)))
        return 0
    out = args.out
    if out is None:
        base = args.path if os.path.isdir(args.path) \
            else os.path.dirname(args.path) or "."
        out = os.path.join(base, "op_corpus.jsonl")
    build(args.path, out_path=out, merge=args.merge)
    return 0


if __name__ == "__main__":
    sys.exit(main())
