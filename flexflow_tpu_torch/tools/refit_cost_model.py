"""Refit the learned cost model from a telemetry dir
(counterpart: tools/refit_cost_model.py).

One command closes the loop the `[drift]` report opens: fold a run's
telemetry through span_dataset into the per-op corpus, retrain
search/learned_cost.py's per-op-kind ridge on it, and write the model
(atomic replace) to the resolved model path. The strategy cache keys on
the model file's content hash (strategy_cache.learned_fingerprint), so a
refit invalidates every strategy the stale model priced. `auto_refit=True`
makes fit call `refit()` at its end (search/learned_cost.auto_refit).

Usage:
    python -m flexflow_tpu_torch.tools.refit_cost_model <telemetry-dir>
        [--out model.json] [--corpus corpus.jsonl]
    python -m flexflow_tpu_torch.tools.refit_cost_model --check [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Optional

from flexflow_tpu_torch.tools import span_dataset


def default_model_path() -> str:
    from flexflow_tpu_torch.search.learned_cost import resolve_model_path

    class _Cfg:  # resolve with no CLI override: env var or ~/.cache default
        cost_model_path = ""

    return resolve_model_path(_Cfg())


def refit(telemetry_path: str, model_path: Optional[str] = None,
          corpus_path: Optional[str] = None, quiet: bool = True
          ) -> Optional[Dict[str, Any]]:
    """telemetry dir -> (merged) corpus -> trained model file.

    Returns {"rows", "kinds", "fingerprint", "path", "corpus"} on success,
    None when the telemetry yields no usable corpus rows (nothing is
    written — an empty refit must not clobber a working model)."""
    from flexflow_tpu_torch.search import learned_cost as lc

    rows: List[Dict[str, Any]] = span_dataset.collect_rows(telemetry_path)
    if corpus_path:
        rows = span_dataset.merge_rows(
            span_dataset.read_jsonl(corpus_path), rows)
    usable = [r for r in rows
              if (r.get("measured_s") or {}).get("mean")]
    if not usable:
        if not quiet:
            print(f"no measured corpus rows under {telemetry_path}; "
                  "model left unchanged")
        return None
    if corpus_path:
        span_dataset.write_jsonl(rows, corpus_path)
    model = lc.train(rows)
    path = model_path or default_model_path()
    fp = model.save(path)
    info = {
        "rows": len(usable),
        "kinds": list(model.meta.get("kinds_fitted") or []),
        "fingerprint": fp,
        "path": path,
        "corpus": corpus_path,
    }
    if not quiet:
        print(f"refit: {info['rows']} rows -> {len(info['kinds'])} op-kind "
              f"submodels, model {fp} -> {path}")
    return info


# --------------------------------------------------------------- check mode
def _check(device: str = "cuda") -> int:
    """Profiled small fit -> refit -> a loadable model whose fingerprint is
    the one refit reports and that prices a corpus row; a second refit
    folds the same telemetry into the corpus again."""
    import tempfile

    from flexflow_tpu_torch import telemetry
    from flexflow_tpu_torch.search import learned_cost as lc

    with tempfile.TemporaryDirectory() as td:
        tdir = os.path.join(td, "telemetry")
        span_dataset.profiled_fit(tdir, device)
        telemetry.flush()
        mpath = os.path.join(td, "model.json")
        cpath = os.path.join(td, "corpus.jsonl")
        info = refit(tdir, model_path=mpath, corpus_path=cpath)
        telemetry.shutdown()
        assert info is not None and info["rows"] > 0, info
        model = lc.LearnedCostModel.load(mpath)
        assert model.fingerprint == info["fingerprint"]
        row = span_dataset.read_jsonl(cpath)[0]
        t = model.predict_row(row)
        assert t is not None and t > 0, (row["key"], t)
        info2 = refit(tdir, model_path=mpath, corpus_path=cpath)
        assert info2 is not None
    print("refit_cost_model --check OK")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        "flexflow_tpu_torch.tools.refit_cost_model", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", nargs="?", default=None,
                    help="telemetry dir or one telemetry-*.jsonl file")
    ap.add_argument("--out", default=None,
                    help="model JSON path (default: $FF_COST_MODEL_PATH or "
                         "~/.cache/flexflow_tpu_torch/cost_model.json)")
    ap.add_argument("--corpus", default=None,
                    help="corpus JSONL to fold through and keep updated "
                         "(default <dir>/op_corpus.jsonl)")
    ap.add_argument("--check", action="store_true",
                    help="smoke: profiled fit -> refit -> validate")
    ap.add_argument("--device", default="cuda",
                    help="device of --check's fit (default: the card)")
    args = ap.parse_args(argv)
    if args.check:
        return _check(args.device)
    if not args.path:
        ap.error("path required (or --check)")
    corpus = args.corpus
    if corpus is None:
        base = args.path if os.path.isdir(args.path) \
            else os.path.dirname(args.path) or "."
        corpus = os.path.join(base, "op_corpus.jsonl")
    info = refit(args.path, model_path=args.out, corpus_path=corpus,
                 quiet=False)
    return 0 if info is not None else 1


if __name__ == "__main__":
    sys.exit(main())
