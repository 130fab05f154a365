"""Learned per-op cost model: self-calibrating prices for the search
(counterpart: flexflow_tpu/search/learned_cost.py).

"A Learned Performance Model for TPUs" (arXiv 2008.01040) showed that a
small learned model over (opcode, shapes, dtype, layout) features beats
the analytic roofline at pricing ops. The inputs exist in the port:
profiled fits (`profile_ops` with `telemetry_dir`) emit one featurized
`op/attr` event per placed op (attribution.py), `tools/span_dataset.py` in this package
folds them into a per-feature-key corpus, and `simulator_mode` selects the
pricing tier.

numpy only: per-op-kind ridge regression in log space over a small
numeric featurization of the feature dict, fronted by an exact-key table
(a corpus row whose feature key matches the queried op is a measurement:
its pooled mean is returned). The model serializes to JSON with a content
fingerprint; the strategy cache keys on it
(strategy_cache.learned_fingerprint), so a refit invalidates every
strategy the stale model priced.

Three mounts, all gated on `simulator_mode="learned"` and a model file
that resolves (with either absent, the search is the additive one):

1. the pricing tier (search/optimize.py): `LearnedCost.op_time` has the
   `cost_fn(layer, cand) -> total seconds` contract of
   MeasuredCost.op_time; an op whose kind the model never saw is priced
   by the analytic `cand.op_time` and counts as a coverage miss (the
   `search/learned_cost` event and the strategy-cache meta carry the
   coverage);
2. the learned pruner (search/dp.py, search/unity.py): per layer,
   candidates whose learned time exceeds the layer's best by
   DP_PRUNE_RATIO are dropped before expansion (the memory-leanest
   candidate and all passthroughs stay); per segment, layout finalists
   whose learned score exceeds the best by FINALIST_MARGIN skip the
   event-driven re-rank;
3. the refit loop (flexflow_tpu_torch/tools/refit_cost_model.py):
   `auto_refit()` below is the fit-end hook of `auto_refit=True`.

The model file defaults to `~/.cache/flexflow_tpu_torch/cost_model.json`,
beside the port's strategy cache and never the JAX package's: a model fit
on another machine's rows must not price a search on this one. The
serving rungs (serving/twin.py, serving/kv_cache.py) read a model only
when the config asks for the learned tier (`named_model_path`).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# model file schema (bump when the payload layout changes incompatibly)
MODEL_SCHEMA_VERSION = 1

# per-layer candidate pruning: drop candidates whose learned op time exceeds
# ratio x the layer's best learned time (None disables). Generous on
# purpose: per-op
# times ignore the resharding edge costs the DP prices, so a tight ratio
# could prune a candidate that wins on cheaper edges.
DP_PRUNE_RATIO: Optional[float] = 2.0

# finalist pruning before the event-driven re-rank: drop finalists whose
# learned strategy score exceeds (1 + margin) x the best finalist's.
FINALIST_MARGIN: Optional[float] = 0.25

# ridge regularization (standardized features, log-space target)
RIDGE_L2 = 1e-2

# a kind needs this many corpus rows before it gets a fitted submodel
# (fewer rows are still served by the exact-key table)
MIN_ROWS_PER_KIND = 3


# ------------------------------------------------------------ featurization
def _dtype_bytes(dtype: str) -> float:
    for width, nbytes in (("64", 8.0), ("32", 4.0), ("16", 2.0), ("8", 1.0)):
        if width in dtype:
            return nbytes
    return 4.0


def _elements(shapes) -> List[float]:
    out = []
    for s in shapes or []:
        n = 1.0
        for d in s or []:
            n *= max(1.0, float(d))
        out.append(n)
    return out


def feature_vector(features: Dict[str, Any],
                   predicted_s: Optional[float] = None,
                   roofline_s: Optional[float] = None) -> List[float]:
    """Numeric vector from one 2008.01040 feature dict (attribution.
    op_features / a corpus row's "features"). The analytic predicted and
    roofline times ride along as features — the ridge then learns a
    RESIDUAL CORRECTION on top of the analytic model rather than raw
    physics from scratch, which is what makes tiny corpora workable."""
    ins = _elements(features.get("in_shapes"))
    outs = _elements(features.get("out_shapes"))
    ws = _elements(list((features.get("weight_shapes") or {}).values()))
    sh = features.get("sharding") or {}
    out_ax = sum(1 for d in (sh.get("out") or []) for a in (d or []) if a)
    w_ax = sum(1 for d in (sh.get("weights") or {}).values()
               for a in (d or []) if a)
    return [
        math.log1p(sum(ins)),
        math.log1p(max(ins) if ins else 0.0),
        math.log1p(sum(outs)),
        math.log1p(sum(ws)),
        float(len(ins)),
        float(out_ax),
        float(w_ax),
        _dtype_bytes(str(features.get("dtype") or "")),
        math.log1p(max(0.0, float(predicted_s or 0.0)) * 1e9),
        math.log1p(max(0.0, float(roofline_s or 0.0)) * 1e9),
    ]


N_FEATURES = 10


# ------------------------------------------------------------------- model
class LearnedCostModel:
    """Per-op-kind ridge over feature_vector + an exact-key measurement
    table. JSON-serializable; `fingerprint` is a content hash of the
    payload, so identical training data reproduces an identical
    fingerprint and any refit that changes a coefficient changes it."""

    def __init__(self, kinds: Dict[str, Dict[str, Any]],
                 exact: Dict[str, float], meta: Dict[str, Any]):
        self.kinds = kinds
        self.exact = exact
        self.meta = meta

    # ------------------------------------------------------------- predict
    def predict_features(self, features: Dict[str, Any],
                         predicted_s: Optional[float] = None,
                         roofline_s: Optional[float] = None,
                         key: Optional[str] = None) -> Optional[float]:
        """Predicted total seconds for one featurized op, or None when the
        op kind is out-of-distribution (caller falls back to analytic)."""
        if key is None:
            from flexflow_tpu_torch.attribution import feature_key

            key = feature_key(features)
        hit = self.exact.get(key)
        if hit is not None:
            return float(hit)
        k = self.kinds.get(str(features.get("op")))
        if k is None:
            return None
        x = np.asarray(feature_vector(features, predicted_s, roofline_s))
        mean = np.asarray(k["mean"])
        std = np.asarray(k["std"])
        z = (x - mean) / std
        log_t = float(np.dot(z, np.asarray(k["coef"])) + k["intercept"])
        return float(min(max(math.exp(min(log_t, 40.0)), 1e-12), 1e6))

    def predict_row(self, row: Dict[str, Any]) -> Optional[float]:
        """Prediction for one span_dataset corpus row (bench MAPE path)."""
        return self.predict_features(row.get("features") or {},
                                     predicted_s=row.get("predicted_s"),
                                     roofline_s=row.get("roofline_s"),
                                     key=row.get("key"))

    # ----------------------------------------------------------------- io
    def to_json(self) -> Dict[str, Any]:
        payload = {
            "schema_version": MODEL_SCHEMA_VERSION,
            "kinds": self.kinds,
            "exact": self.exact,
            "meta": self.meta,
        }
        payload["fingerprint"] = _payload_fingerprint(payload)
        return payload

    @property
    def fingerprint(self) -> str:
        return _payload_fingerprint({
            "schema_version": MODEL_SCHEMA_VERSION,
            "kinds": self.kinds, "exact": self.exact, "meta": self.meta})

    @classmethod
    def from_json(cls, payload: Dict[str, Any]) -> "LearnedCostModel":
        if payload.get("schema_version") != MODEL_SCHEMA_VERSION:
            raise ValueError(
                f"cost model schema {payload.get('schema_version')!r} != "
                f"{MODEL_SCHEMA_VERSION} (refit: python -m "
                "flexflow_tpu_torch.tools.refit_cost_model)")
        return cls(dict(payload.get("kinds") or {}),
                   {str(k): float(v)
                    for k, v in (payload.get("exact") or {}).items()},
                   dict(payload.get("meta") or {}))

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return self.fingerprint

    @classmethod
    def load(cls, path: str) -> "LearnedCostModel":
        with open(path) as f:
            return cls.from_json(json.load(f))


def _payload_fingerprint(payload: Dict[str, Any]) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ------------------------------------------------------------------- train
def train(rows: Sequence[Dict[str, Any]], l2: float = RIDGE_L2,
          min_rows: int = MIN_ROWS_PER_KIND) -> LearnedCostModel:
    """Fit the model from span_dataset corpus rows. Rows without a positive
    measured mean are skipped; op kinds with < min_rows measured rows get
    no submodel (their exact keys still serve, unseen keys are OOD)."""
    usable = []
    for r in rows:
        m = (r.get("measured_s") or {}).get("mean")
        if m is not None and m > 0 and isinstance(r.get("features"), dict):
            usable.append((r, float(m)))
    by_kind: Dict[str, List[Tuple[Dict[str, Any], float]]] = {}
    exact: Dict[str, float] = {}
    machines = set()
    for r, m in usable:
        kind = str((r.get("features") or {}).get("op"))
        by_kind.setdefault(kind, []).append((r, m))
        if r.get("key"):
            exact[str(r["key"])] = m
        mfp = r.get("machine")
        if mfp:
            machines.add(str(mfp))
    kinds: Dict[str, Dict[str, Any]] = {}
    for kind in sorted(by_kind):
        group = by_kind[kind]
        if len(group) < max(2, min_rows):
            continue
        X = np.asarray([feature_vector(r.get("features") or {},
                                       r.get("predicted_s"),
                                       r.get("roofline_s"))
                        for r, _m in group])
        y = np.log(np.asarray([m for _r, m in group]))
        mean = X.mean(axis=0)
        std = X.std(axis=0)
        std[std < 1e-9] = 1.0
        Z = (X - mean) / std
        # closed-form ridge; the intercept is the target mean (unpenalized
        # because Z is centered)
        y0 = float(y.mean())
        A = Z.T @ Z + l2 * len(group) * np.eye(Z.shape[1])
        coef = np.linalg.solve(A, Z.T @ (y - y0))
        kinds[kind] = {
            "coef": [round(float(c), 12) for c in coef],
            "mean": [round(float(c), 12) for c in mean],
            "std": [round(float(c), 12) for c in std],
            "intercept": round(y0, 12),
            "rows": len(group),
        }
    return LearnedCostModel(kinds, exact, {
        "rows": len(usable),
        "kinds_fitted": sorted(kinds),
        "machines": sorted(machines),
        "l2": l2,
    })


def mape(pairs: Sequence[Tuple[float, float]]) -> Optional[float]:
    """Mean absolute percentage error over (predicted, measured) pairs."""
    errs = [abs(p - m) / m for p, m in pairs if m > 0 and p is not None]
    return (sum(errs) / len(errs)) if errs else None


# --------------------------------------------------------- runtime adapter
class LearnedCost:
    """The search-time cost function: same `op_time(layer, cand) -> total
    seconds` contract as MeasuredCost.op_time (the total includes the
    candidate's inherent collectives + grad sync, because the corpus's
    measured targets do), with a per-op analytic fallback when the model
    has never seen the op kind. Tracks coverage: hits = learned-priced
    ops, misses = analytic fallbacks. A miss is only an op the model
    cannot price (`predict_features` returns None); any other error in
    featurizing or pricing an op is raised, where the JAX package counts
    it as a miss."""

    def __init__(self, model: LearnedCostModel, machine,
                 path: Optional[str] = None):
        self.model = model
        self.machine = machine
        self.path = path
        self.hits = 0
        self.misses = 0
        self.prune_ratio = DP_PRUNE_RATIO
        self.finalist_margin = FINALIST_MARGIN
        self._memo: Dict[Tuple, Tuple[float, bool]] = {}

    def _predict(self, layer, cand) -> Tuple[float, bool]:
        key = (layer.params_key(),
               tuple(tuple(map(str, d)) for d in cand.out_dims),
               tuple(sorted((w, tuple(map(str, d)))
                            for w, d in cand.weight_dims.items())))
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        from flexflow_tpu_torch import attribution
        from flexflow_tpu_torch.search import cost_model as cm

        analytic = cand.op_time(layer, self.machine)
        feats = attribution.op_features(layer, cand, self.machine)
        roof = cm.op_roofline(layer, cand, self.machine)["roofline_s"]
        t = self.model.predict_features(feats, predicted_s=analytic,
                                        roofline_s=roof)
        out = (analytic, False) if t is None else (float(t), True)
        self._memo[key] = out
        return out

    def op_time(self, layer, cand) -> float:
        t, learned = self._predict(layer, cand)
        if learned:
            self.hits += 1
        else:
            self.misses += 1
        return t

    def coverage(self) -> Optional[float]:
        n = self.hits + self.misses
        return (self.hits / n) if n else None

    # ----------------------------------------------------------- pruning
    def prune_candidates(self, layer, cands) -> Tuple[list, int]:
        """Learned per-layer DP pruning: drop candidates whose learned time
        exceeds prune_ratio x the layer's best. Passthroughs and the
        memory-leanest candidate always survive (a memory-capped search
        must keep its escape hatch even when it is slow)."""
        if self.prune_ratio is None or len(cands) <= 2:
            return cands, 0
        timed = []
        for c in cands:
            if not c.passthrough:
                timed.append((self._predict(layer, c)[0], c))
        if len(timed) <= 1:
            return cands, 0
        best = min(t for t, _c in timed)
        lean = min(timed, key=lambda tc: tc[1].weight_mem_bytes(
            layer, self.machine, None))[1]
        cut = best * self.prune_ratio
        by_id = {id(c): t for t, c in timed}
        keep = [c for c in cands
                if c.passthrough or c is lean or by_id[id(c)] <= cut]
        return keep, len(cands) - len(keep)

    def score_result(self, g, result) -> float:
        """Learned total of one SearchResult's per-op choices (the finalist
        pruning score — edge resharding is layout-shared across finalists
        of the same segment, so per-op sums rank them fairly)."""
        from flexflow_tpu_torch.core.graph import topo_order

        total = 0.0
        for layer in topo_order(g.layers):
            cand = result.choices.get(layer.name)
            if cand is None or cand.passthrough:
                continue
            total += self._predict(layer, cand)[0]
        return total

    def prune_finalists(self, g, finalists) -> Tuple[list, int]:
        """Drop layout finalists whose learned score exceeds the best by
        finalist_margin before the expensive event-replay re-rank."""
        if self.finalist_margin is None or not isinstance(finalists, list) \
                or len(finalists) <= 1:
            return finalists, 0
        scored = [(self.score_result(g, r), r) for r in finalists]
        best = min(s for s, _r in scored)
        keep = [r for s, r in scored if s <= best * (1.0 + self.finalist_margin)]
        if not keep:  # defensive: best always qualifies, but never rerank []
            keep = [min(scored, key=lambda sr: sr[0])[1]]
        return keep, len(finalists) - len(keep)


# ------------------------------------------------------------- resolution
def resolve_model_path(cfg) -> str:
    """cost_model_path > $FF_COST_MODEL_PATH >
    ~/.cache/flexflow_tpu_torch/cost_model.json (beside the strategy
    cache, so one `rm -r` clears both tiers)."""
    return os.path.expanduser(
        getattr(cfg, "cost_model_path", "") or
        os.environ.get("FF_COST_MODEL_PATH", "") or
        os.path.join("~", ".cache", "flexflow_tpu_torch", "cost_model.json"))


def named_model_path(cfg) -> Optional[str]:
    """The model path for the serving rungs (the twin's prices, the KV
    tier's transfer time): resolved as `resolve_model_path` does when
    `cfg` asks for the learned tier (a `cost_model_path`, or
    `simulator_mode="learned"`), else None, so a model that an earlier
    refit left at the default path never prices a run that did not ask
    for one."""
    if cfg is None:
        return None
    if (getattr(cfg, "cost_model_path", "")
            or getattr(cfg, "simulator_mode", "additive") == "learned"):
        return resolve_model_path(cfg)
    return None


def load_for_config(cfg, machine) -> Optional[LearnedCost]:
    """The learned tier's gate: a LearnedCost only when
    `simulator_mode="learned"` and a readable model file resolves;
    otherwise None, and the search runs as without it."""
    if getattr(cfg, "simulator_mode", "additive") != "learned":
        return None
    path = resolve_model_path(cfg)
    try:
        model = LearnedCostModel.load(path)
    except (OSError, ValueError):
        return None
    return LearnedCost(model, machine, path=path)


# -------------------------------------------------------------- auto-refit
def auto_refit(cfg) -> Optional[Dict[str, Any]]:
    """The fit-end self-calibration hook (`auto_refit=True`): fold the
    run's telemetry dir through span_dataset into a refreshed model at the
    resolved model path. Returns the refit info dict, or None when the
    loop cannot run (no telemetry dir, or no corpus rows)."""
    tdir = getattr(cfg, "telemetry_dir", "")
    if not tdir or not getattr(cfg, "auto_refit", False):
        return None
    from flexflow_tpu_torch import telemetry as tel
    from flexflow_tpu_torch.tools import refit_cost_model

    tel.flush()
    return refit_cost_model.refit(
        tdir, model_path=resolve_model_path(cfg),
        corpus_path=os.path.join(tdir, "op_corpus.jsonl"), quiet=True)
