"""Checkpoints, durable snapshots, preemption, resume and the prefetching
loader of the PyTorch port, on the CPU: the counterparts of
tests/test_checkpoint.py and the non-pipeline cases of
tests/test_resilience.py, with the JAX package's loader and fingerprint as
the reference where the two must agree.

The model is GPT-2 at tiny widths with dropout 0.1 (the fit's key then
decides the masks, so an exact resume also shows that the key follows the
iteration), built each time as a relaunched process builds it. On the
CPU every run is deterministic, so the checks are bitwise. Every wait has
a timeout of its own.
"""

import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.runtime import checkpoint as jck
from flexflow_tpu.runtime.dataloader import \
    SingleDataLoader as JSingleDataLoader
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.convert import params_to_numpy
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.runtime import checkpoint as ck
from flexflow_tpu_torch.runtime import resilience as rz
from flexflow_tpu_torch.runtime.dataloader import (SingleDataLoader,
                                                   prefetch_to_device)

B, SEQ, VOCAB = 2, 16, 64
WAIT_S = 20.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gpt2_kw(d_model=32):
    return dict(vocab=VOCAB, seq=SEQ, d_model=d_model, heads=2, layers=1,
                dropout=0.1)


def _build(opt=None, d_model=32, seed=5, **cfg):
    """The model as a relaunched process builds it: the dropout masks
    follow the layer guids, so they are numbered from the start again (as
    tests/test_remat_search.py does for the JAX package)."""
    Layer._next_guid[0] = 100
    Tensor._next_guid[0] = 1000
    m = FFModel(FFConfig(batch_size=B, seed=seed, **cfg))
    build_gpt2(m, GPT2Config(**_gpt2_kw(d_model)), batch=B)
    cm = m.compile(opt or AdamOptimizer(alpha=1e-2),
                   "sparse_categorical_crossentropy", ["accuracy"],
                   device="cpu")
    cm.init(seed=0)
    return cm


def _data(n=12):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, size=(n, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    return [ids, pos], rng.integers(0, VOCAB, size=(n, SEQ)).astype(np.int32)


class _Losses:
    """Every update's loss; with `kill_at`, SIGTERM to this process after
    that many updates (the drain then runs from the fit loop)."""

    def __init__(self, kill_at=0):
        self.losses = []
        self.kill_at = kill_at

    def on_batch_end(self, it, logs):
        self.losses.append(logs["loss"])
        if len(self.losses) == self.kill_at:
            os.kill(os.getpid(), signal.SIGTERM)


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return t.detach().numpy().copy() if isinstance(t, torch.Tensor) else t


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ------------------------------------------------------ plain checkpoints
def test_roundtrip_and_exact_resume(tmp_path):
    """A fresh model restored from a checkpoint holds the saved params,
    moments and iteration bitwise, and its next epoch is the original's."""
    x, y = _data()
    cm1 = _build()
    cm1.fit(x, y, epochs=1, verbose=False)
    path = str(tmp_path / "ck")
    cm1.save_checkpoint(path, block=True)
    saved = _np_tree({"p": cm1.params, "o": cm1.opt_state})
    h_ref = cm1.fit(x, y, epochs=1, verbose=False)
    cm2 = _build()
    cm2.init(seed=123)
    cm2.load_checkpoint(path)
    assert cm2._iteration == 6
    _assert_trees_equal(_np_tree({"p": cm2.params, "o": cm2.opt_state}),
                        saved)
    h_res = cm2.fit(x, y, epochs=1, verbose=False)
    assert h_res[0]["loss"] == h_ref[0]["loss"]
    _assert_trees_equal(params_to_numpy(cm2.params),
                        params_to_numpy(cm1.params))


def test_async_save_is_a_snapshot_of_the_call(tmp_path):
    """An async save returns once the host snapshot is taken: the steps
    that follow update params and moments in place, and the checkpoint
    still holds the state of the call."""
    x, y = _data()
    cm = _build()
    cm.fit(x, y, epochs=1, verbose=False)
    saved = _np_tree({"p": cm.params, "o": cm.opt_state})
    path = cm.save_checkpoint(str(tmp_path / "ck_async"), block=False)
    for ws in cm.params.values():        # overwrite in place at once
        for t in ws.values():
            with torch.no_grad():
                t.add_(1.0)
    cm.fit(x, y, epochs=1, verbose=False)
    cm.wait_checkpoints()
    cm2 = _build()
    cm2.load_checkpoint(path)
    assert cm2._iteration == 6
    _assert_trees_equal(_np_tree({"p": cm2.params, "o": cm2.opt_state}),
                        saved)


def test_async_save_drains_at_interpreter_exit(tmp_path):
    """A save issued just before the interpreter exits still lands."""
    code = f"""
import numpy as np
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
m = FFModel(FFConfig(batch_size=2))
build_gpt2(m, GPT2Config(vocab=64, seq=16, d_model=32, heads=2, layers=1), batch=2)
cm = m.compile(SGDOptimizer(lr=0.01), device="cpu")
cm.init(seed=0)
cm.save_checkpoint({str(tmp_path / "ck")!r})  # async; exit at once
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (tmp_path / "ck" / "meta.json").exists(), r.stderr[-3000:]
    assert (tmp_path / "ck" / "tree" / "state.pt").exists()


def test_mismatch_lists_the_layers(tmp_path):
    path = str(tmp_path / "ck")
    _build().save_checkpoint(path, block=True)
    with pytest.raises(ck.CheckpointMismatchError) as ei:
        _build(d_model=48).load_checkpoint(path)
    msg = str(ei.value)
    assert "weight schema" in msg and "h0_attn" in msg and "lm_head" in msg
    with pytest.raises(ck.CheckpointMismatchError) as ei:
        _build(opt=SGDOptimizer(lr=0.01)).load_checkpoint(path)
    assert "optimizer class" in str(ei.value)
    ok = _build()
    ok.load_checkpoint(path)
    assert ok._iteration == 0


def test_fingerprint_equals_the_jax_packages():
    jm = JFFModel(JFFConfig(batch_size=B, mesh_shape={"data": 1},
                            only_data_parallel=True, log_level="warning"))
    jbuild_gpt2(jm, JGPT2Config(**_gpt2_kw()), batch=B)
    jcm = jm.compile(JAdamOptimizer(), "sparse_categorical_crossentropy", [])
    assert ck.model_fingerprint(_build(opt=AdamOptimizer())) == \
        jck.model_fingerprint(jcm)


def test_wait_pending_is_bounded_and_failures_are_reported(tmp_path, capsys):
    h = ck._AsyncSave(str(tmp_path / "wedged"))
    with ck._PENDING_LOCK:
        ck._PENDING[h.path] = h
    release = threading.Event()
    h.start(lambda: release.wait(WAIT_S))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        ck.wait_pending(timeout=0.2)
    assert time.monotonic() - t0 < 5.0
    release.set()
    h.result(timeout=WAIT_S)
    for i in range(2):
        h = ck._AsyncSave(str(tmp_path / f"boom{i}"))
        with ck._PENDING_LOCK:
            ck._PENDING[h.path] = h
        h.start(lambda: (_ for _ in ()).throw(OSError("disk gone")))
    deadline = time.monotonic() + WAIT_S
    while len(ck.failed_writes()) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    ck._wait_pending_at_exit()  # reports, raises nothing
    out = capsys.readouterr().out
    assert "FAILED" in out and "disk gone" in out
    with ck._PENDING_LOCK:
        ck._FAILED.clear()
        ck._PENDING.clear()


# ------------------------------------------------------ durable snapshots
def test_discovery_skips_uncommitted_snapshots(tmp_path):
    root = str(tmp_path / "ck")
    x, y = _data()
    cm = _build()
    cm.fit(x, y, epochs=1, verbose=False)
    p1 = rz.save_durable(cm, root, {"epoch": 1}, block=True)
    cm.fit(x, y, epochs=1, verbose=False)
    p2 = rz.save_durable(cm, root, {"epoch": 2}, block=True)
    assert os.path.basename(p1) == "ckpt-0000000006"
    assert [s for s, _, _ in rz.committed_snapshots(root)] == [6, 12]
    os.makedirs(os.path.join(root, ".tmp-0000000018-dead"))
    fake = os.path.join(root, "ckpt-0000000099")
    os.makedirs(fake)
    with open(os.path.join(fake, rz.MANIFEST), "w") as f:
        f.write("{ torn json")
    assert rz.latest_checkpoint(root) == p2
    rz.clean_stale_tmp(root)
    assert not [n for n in os.listdir(root) if n.startswith(".tmp-")]
    bad = os.path.join(root, "ckpt-0000000777")
    os.makedirs(os.path.join(bad, "tree"))
    open(os.path.join(bad, "meta.json"), "w").write("{}")
    with open(os.path.join(bad, rz.MANIFEST), "w") as f:
        f.write('{"committed": true, "step": "7a"}')
    assert rz.load_manifest(bad) is None
    assert rz.latest_checkpoint(root) == p2
    cm.cfg.keep_checkpoints = 1
    rz.save_durable(cm, root, {}, block=True, keep=1)
    assert [s for s, _, _ in rz.committed_snapshots(root)] == [12]


def test_corrupt_newest_snapshot_falls_back(tmp_path):
    root = str(tmp_path / "ck")
    x, y = _data()
    cm = _build()
    cm.fit(x, y, epochs=1, verbose=False)
    rz.save_durable(cm, root, {"epoch": 1, "step_in_epoch": 0,
                               "history": []}, block=True)
    good = _np_tree(cm.params)
    cm.fit(x, y, epochs=1, verbose=False)
    newest = rz.save_durable(cm, root, {"epoch": 2, "step_in_epoch": 0,
                                        "history": []}, block=True)
    shutil.rmtree(os.path.join(newest, "tree"))
    os.makedirs(os.path.join(newest, "tree"))
    cm2 = _build()
    prog = rz.restore_auto(cm2, "auto", root)
    assert prog is not None and prog["epoch"] == 1
    assert cm2._iteration == 6
    _assert_trees_equal(_np_tree(cm2.params), good)
    assert rz.latest_checkpoint(root) == newest


def test_empty_root_starts_fresh(tmp_path):
    cm = _build()
    assert rz.restore_auto(cm, "auto", str(tmp_path / "nothing")) is None
    with pytest.raises(FileNotFoundError):
        rz.restore_auto(cm, str(tmp_path / "nope"), "")


def test_sigterm_drain_and_resume_reproduce_the_run(tmp_path):
    """SIGTERM after update 3 of an epoch of 6: the fit drains, commits a
    final snapshot and raises Preempted (exit code 0). A fresh model with
    resume="auto" finishes the two epochs: its losses after the snapshot,
    its history and its final params and moments equal the uninterrupted
    run's bitwise."""
    x, y = _data()
    ref_cb = _Losses()
    ref = _build()
    ref_hist = ref.fit(x, y, epochs=2, verbose=False, callbacks=[ref_cb])
    root = str(tmp_path / "ck")
    cm = _build(checkpoint_dir=root)
    kill = _Losses(kill_at=3)
    with pytest.raises(rz.Preempted) as ei:
        cm.fit(x, y, epochs=2, verbose=False, callbacks=[kill])
    assert ei.value.code == 0
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL or \
        not isinstance(signal.getsignal(signal.SIGTERM), rz.PreemptionGuard)
    assert ei.value.checkpoint_path == rz.latest_checkpoint(root)
    man = rz.load_manifest(ei.value.checkpoint_path)
    done = man["step"]
    assert man["progress"]["epoch"] == 0
    assert 0 < man["progress"]["step_in_epoch"] < 6
    assert kill.losses == ref_cb.losses[:len(kill.losses)]
    cm2 = _build(checkpoint_dir=root)
    cb2 = _Losses()
    hist = cm2.fit(x, y, epochs=2, verbose=False, resume="auto",
                   callbacks=[cb2])
    assert cb2.losses == ref_cb.losses[done:]
    assert [h["loss"] for h in hist] == [h["loss"] for h in ref_hist]
    _assert_trees_equal(_np_tree({"p": cm2.params, "o": cm2.opt_state}),
                        _np_tree({"p": ref.params, "o": ref.opt_state}))


def test_periodic_snapshots_and_resume_after_a_finished_fit(tmp_path):
    """checkpoint_every_steps=4 commits snapshots inside the fit (async),
    the end-of-fit snapshot records every epoch done, and a relaunch with
    resume="auto" returns the stored history without training."""
    root = str(tmp_path / "ck")
    x, y = _data()
    cm = _build(checkpoint_dir=root, checkpoint_every_steps=4,
                keep_checkpoints=0)
    h1 = cm.fit(x, y, epochs=2, verbose=False)
    cm.wait_checkpoints()
    assert [s for s, _, _ in rz.committed_snapshots(root)] == [4, 8, 12]
    cm2 = _build(checkpoint_dir=root)
    h2 = cm2.fit(x, y, epochs=2, verbose=False, resume="auto")
    assert [h["loss"] for h in h2] == [h["loss"] for h in h1]
    assert cm2._iteration == 12 and cm2.step_stats["dispatches"] == 0
    _assert_trees_equal(params_to_numpy(cm2.params),
                        params_to_numpy(cm.params))


def test_resume_rejects_another_seed_batch_or_accum(tmp_path):
    root = str(tmp_path / "ck")
    x, y = _data()
    cm = _build()
    cm.fit(x, y, epochs=1, verbose=False)
    rz.save_durable(cm, root, {"epoch": 1}, block=True)
    with pytest.raises(ValueError, match="seed"):
        rz.restore_auto(_build(seed=6), "auto", root)
    for kw, what in ((dict(batch_size=4), "batch_size"),
                     (dict(accum_steps=2), "accum_steps")):
        with pytest.raises(ValueError, match=what):
            rz.restore_auto(_build(), "auto", root, expected_config=dict(
                rz.effective_config(cm), **kw))


def test_guard_defers_one_signal_and_yields_to_a_second():
    g = rz.PreemptionGuard().install()
    try:
        signal.raise_signal(signal.SIGINT)
        assert g.requested and g.signum == signal.SIGINT
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)
        assert not g._installed
    finally:
        g.uninstall()
    cm = _build()
    res = rz.FitResilience.build(cm, resume="auto", checkpoint_dir="")
    prev = signal.getsignal(signal.SIGTERM)
    res.install_guard()      # no root: signals keep their handlers
    assert signal.getsignal(signal.SIGTERM) is prev
    assert rz.FitResilience.build(cm) is None


# ------------------------------------------------------------ the loader
def test_loader_cursor_matches_jax():
    """`epoch(skip_batches)` and `advance_epochs` draw the JAX loader's
    batches: the same permutations, the skipped batches left out."""
    x, y = _data(22)
    j = JSingleDataLoader(x, y, 4, shuffle=True, seed=9)
    p = SingleDataLoader(x, y, 4, shuffle=True, seed=9)
    j.advance_epochs(2)
    p.advance_epochs(2)
    for skip in (0, 2, 5):
        jb, pb = list(j.epoch(skip_batches=skip)), list(p.epoch(skip_batches=skip))
        assert len(jb) == len(pb) == 5 - skip
        for (jx, jy), (px, py) in zip(jb, pb):
            np.testing.assert_array_equal(py, jy)
            for a, b in zip(px, jx):
                np.testing.assert_array_equal(a, b)
    ref = SingleDataLoader(x, y, 4, shuffle=True, seed=9)
    for _ in range(5):
        list(ref.epoch())
    assert [b[1].tolist() for b in ref.epoch()] == \
        [b[1].tolist() for b in p.epoch()]


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "ff-prefetch" and t.is_alive()]


def _wait_no_prefetch_thread():
    deadline = time.monotonic() + WAIT_S
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return _prefetch_threads()


def test_prefetch_keeps_order_and_values():
    x, y = _data(20)
    loader = SingleDataLoader(x, y, 4, shuffle=True, seed=1)
    want = list(SingleDataLoader(x, y, 4, shuffle=True, seed=1).epoch())
    got = list(prefetch_to_device(loader.epoch(), "cpu", depth=2))
    assert len(got) == len(want) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gy, torch.Tensor) and gy.device.type == "cpu"
        np.testing.assert_array_equal(gy.numpy(), wy)
        for a, b in zip(gx, wx):
            np.testing.assert_array_equal(a.numpy(), b)
    assert _wait_no_prefetch_thread() == []


def test_prefetch_forwards_a_worker_exception_after_the_queued_batches():
    def batches():
        for i in range(2):
            yield [np.full((2, 3), i)], np.full((2,), i)
        raise RuntimeError("loader broke")

    got = []
    with pytest.raises(RuntimeError, match="loader broke"):
        for _, dy in prefetch_to_device(batches(), "cpu", depth=4):
            got.append(int(dy[0]))
    assert got == [0, 1]
    assert _wait_no_prefetch_thread() == []


def test_prefetch_thread_stops_after_an_early_break():
    def endless():
        i = 0
        while True:
            yield [np.full((2, 3), i)], np.full((2,), i)
            i += 1

    gen = prefetch_to_device(endless(), "cpu", depth=2)
    for _, dy in gen:
        if int(dy[0]) == 3:
            break
    gen.close()
    assert _wait_no_prefetch_thread() == []
