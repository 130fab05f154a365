"""Ring attention (sequence parallelism) on the port, against the JAX
package on the CPU: kernels/ring_attention.py over gloo ranks, its
per-step functions in lockstep, its plain version, and GPT-2 tiny trained
with every attention on the ring.

- the ring at world 2 and 4 (ranks spawned on gloo, one "model" axis)
  against JAX's `ring_attention` on its CPU mesh of the same axis size,
  causal and not: the output and the gradients of q, k and v and over
  {"data": 2, "model": 2}, the batch placed by `batch_axes` as JAX's;
- the lockstep functions (`ring_lockstep_fwd`/`_bwd`, what the card's check
  runs) and the plain version (`ring_plain_fwd`/`_bwd`) at P = 2 and 4,
  and the plain chunk step against JAX's `_chunk_attn`/`_masked_probs`;
- the residuals the ring saves: q, k, v, out and lse, linear in the
  sequence, no (s_loc, s_loc) block (JAX's
  `test_ring_bwd_residuals_linear_in_seq`);
- GPT-2 tiny (2 layers, seq 128) over {"data": 2, "model": 2} under
  `sequence_parallel_strategy` (every attention `seq_parallel`) trained
  2 Adam steps, against JAX's run of the same strategy file;
- at world 1 over {"model": 1} the same model is bitwise the plain
  compile (a ring of one is flash);
- the search on the H100 preset puts attention on the ring at 16k
  tokens and not at 512, as JAX's does on its TPU preset.
f32 throughout. Tolerances: 2e-5 on outputs and 1e-4 on gradients
(JAX's own test's), 1e-5 relative on losses.
"""

import functools

import numpy as np
import pytest
import torch

import _torch_port_ranks as ranks
import flexflow_tpu_torch as F
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.kernels import ring_attention as R

MOD = __name__
OUT_TOL, GRAD_TOL, LOSS_RTOL = 2e-5, 1e-4, 1e-5
SHAPE = (2, 2, 64, 16)  # b, h, s, d


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    ranks.close_all()


def _qkv(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_ring(seed, world, causal):
    """JAX's ring over a "model" axis of `world` devices on `_qkv(seed)`:
    (out, dq, dk, dv) for the cotangent, jitted."""
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.kernels.ring_attention import ring_attention
    from flexflow_tpu.parallel.machine import MachineSpec, build_mesh

    mesh = build_mesh(MachineSpec(mesh_axes={"model": world}))

    @jax.jit
    def run(q, k, v, do):
        out, pull = jax.vjp(lambda *a: ring_attention(
            *a, mesh, "model", causal=causal), q, k, v)
        return (out, *pull(do))

    return [np.asarray(t) for t in run(*(jnp.asarray(a)
                                         for a in _qkv(seed)))]


# ------------------------------------------------------------- rank code
def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def rank_ring(arrs, causal):
    """The ring on this rank's sequence shard: the full output and
    gradients, gathered."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from flexflow_tpu_torch.runtime.distributed import global_batch_from_full

    mesh = _mesh({"model": dist.get_world_size()})
    q, k, v, do = (global_batch_from_full(torch.from_numpy(a), mesh,
                                          [Shard(2)]) for a in arrs)
    for t in (q, k, v):
        t.requires_grad_()
    out = R.ring_attention(q, k, v, mesh, "model", causal=causal)
    assert out.placements == (Shard(2),)
    out.backward(do)
    return [t.full_tensor().detach().numpy()
            for t in (out, q.grad, k.grad, v.grad)]


def rank_ring_batch_axes(arrs, batch_axes):
    """The ring over {"data": 2, "model": 2} on q/k/v with the batch on
    "data" and the sequence on "model", run with `batch_axes`: the
    output's placements and its full value."""
    from torch.distributed.tensor import Shard

    from flexflow_tpu_torch.runtime.distributed import global_batch_from_full

    mesh = _mesh({"data": 2, "model": 2})
    q, k, v = (global_batch_from_full(torch.from_numpy(a), mesh,
                                      [Shard(0), Shard(2)])
               for a in arrs[:3])
    out = R.ring_attention(q, k, v, mesh, "model", causal=True,
                           batch_axes=batch_axes)
    return ([(type(p).__name__, getattr(p, "dim", None))
             for p in out.placements], out.full_tensor().numpy())


def rank_residuals(seqs):
    """Bytes and shapes the ring saves for its backward at each seq."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from flexflow_tpu_torch.runtime.distributed import global_batch_from_full

    mesh = _mesh({"model": dist.get_world_size()})
    out = {}
    for s in seqs:
        saved = []

        def pack(t):
            saved.append((tuple(t.shape), t.numel() * t.element_size()))
            return t

        arrs = _qkv(2, (2, 2, s, 16))[:3]
        q, k, v = (global_batch_from_full(torch.from_numpy(a), mesh,
                                          [Shard(2)]).requires_grad_()
                   for a in arrs)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            R.ring_attention(q, k, v, mesh, "model", causal=True)
        out[s] = saved
    return out


def _gpt2(pkg, cfg):
    import importlib

    models = importlib.import_module(pkg.__name__ + ".models")
    m = pkg.FFModel(cfg)
    gc = models.GPT2Config.tiny(128)
    gc.dropout = 0.0
    models.build_gpt2(m, gc, batch=4)
    return m


def _gpt2_data():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 5120, size=(8, 128)).astype(np.int32)
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), (8, 128)).copy()
    return [ids, pos], rng.integers(0, 5120, size=(8, 128)).astype(np.int32)


def _sp_strategy(mesh):
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    from flexflow_tpu_torch.parallel.templates import \
        sequence_parallel_strategy

    m = _gpt2(F, F.FFConfig(batch_size=4, mesh_shape=dict(mesh)))
    return sequence_parallel_strategy(m, MachineSpec(mesh_axes=dict(mesh)))


def rank_gpt2_fit(mesh, params):
    m = _gpt2(F, F.FFConfig(batch_size=4, mesh_shape=dict(mesh),
                            only_data_parallel=True, seed=7))
    cm = m.compile(F.AdamOptimizer(alpha=1e-3),
                   "sparse_categorical_crossentropy", [], device="cpu")
    cm.strategy = _sp_strategy(mesh)
    cm._build_steps()
    cm.load_params(params_from_jax(params))
    x, y = _gpt2_data()
    hist = cm.fit(x, y, epochs=1, verbose=False)
    qh = cm.params["h0_attn"]["wq"]
    return {"loss": hist[0]["loss"], "steps": cm._iteration,
            "wq_local": tuple(qh.to_local().shape)}


def rank_world1_bitwise():
    """GPT-2 tiny over {"model": 1} with every attention on the ring
    against the plain compile, from the same weights: 2 steps."""
    x, y = _gpt2_data()
    runs = {}
    for tag, mesh in (("plain", {}), ("ring", {"model": 1})):
        m = _gpt2(F, F.FFConfig(batch_size=4, mesh_shape=mesh, seed=7,
                                only_data_parallel=True))
        cm = m.compile(F.AdamOptimizer(alpha=1e-3),
                       "sparse_categorical_crossentropy", [], device="cpu")
        if mesh:
            cm.strategy = _sp_strategy(mesh)
            cm._build_steps()
        cm.init(seed=3)
        losses = []
        for i in range(2):
            b = slice(4 * i, 4 * i + 4)
            (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
                cm.params, cm.opt_state, cm.state, [a[b] for a in x], y[b])
            losses.append(float(loss))
        runs[tag] = (cm, losses)
    (pc, pl), (rc, rl) = runs["plain"], runs["ring"]
    same = all(torch.equal(rc.params[l][w].to_local(), pc.params[l][w])
               for l in pc.params for w in pc.params[l])
    return {"plain": pl, "ring": rl, "params_bitwise": same,
            "mesh": rc.mesh is not None,
            "attr": rc.strategy.sharding_for("h0_attn").attrs}


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_jax(world):
    """The ring over world ranks: the output and dq, dk, dv equal JAX's
    ring on the same axis size, causal and not, on every rank."""
    arrs = _qkv(0)
    for causal in (False, True):
        want = _jax_ring(0, world, causal)
        outs = ranks.shared(world, MOD).run("rank_ring", arrs, causal)
        for got in outs:
            for g, w, tol, what in zip(got, want, (OUT_TOL,) + (GRAD_TOL,) * 3,
                                       ("out", "dq", "dk", "dv")):
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                           err_msg=f"{what} causal={causal}")


def test_ring_places_the_batch_on_batch_axes_as_jax():
    """`batch_axes` places the batch as JAX's specs do: over
    {"data": 2, "model": 2}, ("data",) keeps q's batch shard on "data" and
    () replicates it there; the sequence stays on "model" and the output
    equals JAX's ring either way."""
    arrs = _qkv(0)
    want = _jax_ring(0, 2, True)[0]
    for batch_axes, placed in ((("data",), ("Shard", 0)),
                               ((), ("Replicate", None))):
        outs = ranks.shared(4, MOD).run("rank_ring_batch_axes", arrs,
                                        batch_axes)
        for pls, out in outs:
            assert pls == [placed, ("Shard", 2)], (batch_axes, pls)
            np.testing.assert_allclose(out, want, rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("p", [2, 4])
def test_lockstep_and_plain_ring_match_jax(p):
    """The per-step functions for P simulated ranks in one process (the
    hop a list rotation) and the plain version (JAX's einsum chunk step)
    equal JAX's ring, forward and backward, causal and not."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(0))
    scale = 1.0 / np.sqrt(q.shape[-1])
    chunks = [t.chunk(p, dim=2) for t in (q, k, v, do)]
    for causal in (False, True):
        want = _jax_ring(0, p, causal)
        outs, lses = R.ring_lockstep_fwd(*chunks[:3], causal, scale)
        grads = R.ring_lockstep_bwd(*chunks[:3], outs, lses, chunks[3],
                                    causal, scale)
        lock = [torch.cat(outs, 2)] + [torch.cat(g, 2) for g in grads]
        out, lse = R.ring_plain_fwd(q, k, v, p, causal, scale)
        plain = [out, *R.ring_plain_bwd(q, k, v, out, lse, do, p, causal,
                                        scale)]
        np.testing.assert_allclose(torch.cat(lses, 2).numpy(), lse.numpy(),
                                   rtol=1e-5, atol=1e-5)
        for got in (lock, plain):
            for g, w, tol in zip(got, want, (OUT_TOL,) + (GRAD_TOL,) * 3):
                np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)


def test_plain_chunk_step_matches_jax():
    """`chunk_attn_plain` and `masked_probs_plain` against JAX's
    `_chunk_attn` and `_masked_probs` with global offsets: a chunk behind
    the diagonal, on it, and one wholly masked (future)."""
    import jax.numpy as jnp

    from flexflow_tpu.kernels.ring_attention import _chunk_attn, _masked_probs

    q, k, v, _ = _qkv(3, (2, 2, 32, 16))
    scale = 0.25
    for row0, col0 in ((32, 0), (32, 32), (0, 32)):
        want = _chunk_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           row0, col0, scale, True)
        got = R.chunk_attn_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), row0, col0, scale, True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)
        lse = np.asarray(want[1] + jnp.log(jnp.maximum(want[2], 1e-30)))
        wp = _masked_probs(jnp.asarray(q), jnp.asarray(k), jnp.asarray(lse),
                           row0, col0, scale, True)
        gp = R.masked_probs_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.tensor(lse), row0, col0, scale, True)
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-5,
                                   atol=1e-6)


def test_ring_residuals_linear_in_seq():
    """What the ring saves for its backward at world 2: no (s_loc, s_loc)
    block, bytes linear in s (doubling s at most 2.5x), and at most 1.5x
    the O(s d) accounting (q, k, v, out and lse of the rank's shard)."""
    got = ranks.shared(2, MOD).run("rank_residuals", [256, 512])[0]
    b, h, d = 2, 2, 16
    for s, saved in got.items():
        s_loc = s // 2
        for shape, _ in saved:
            assert not (len(shape) >= 2 and shape[-1] >= s_loc
                        and shape[-2] >= s_loc), (shape, s_loc)
    b256, b512 = (sum(n for _, n in got[s]) for s in (256, 512))
    assert b512 <= 2.5 * b256, (b256, b512)
    expect = 4 * b * h * 256 * d * 4 + b * h * 256 * 4
    assert b512 <= 1.5 * expect, (b512, expect)


def test_gpt2_tiny_sequence_parallel_matches_jax():
    """GPT-2 tiny over {"data": 2, "model": 2}, every attention on the
    ring (`sequence_parallel_strategy`, imported by JAX as a strategy
    file): 2 Adam steps give JAX's loss on every rank; each rank holds
    the attention weights whole (replicated)."""
    import jax

    import flexflow_tpu as J
    from flexflow_tpu.parallel.sharding import Strategy as JStrategy

    mesh = {"data": 2, "model": 2}
    jm = _gpt2(J, J.FFConfig(batch_size=4, mesh_shape=mesh,
                             only_data_parallel=True, seed=7))
    jcm = jm.compile(J.AdamOptimizer(alpha=1e-3),
                     "sparse_categorical_crossentropy", [])
    jcm.strategy = JStrategy.from_json(_sp_strategy(mesh).to_json())
    jcm._build_steps()
    jcm.init(seed=3)
    params = jax.device_get(jcm.params)
    x, y = _gpt2_data()
    want = jcm.fit(x, y, epochs=1, verbose=False)[0]["loss"]
    outs = ranks.shared(4, MOD).run("rank_gpt2_fit", mesh, params)
    for o in outs:
        np.testing.assert_allclose(o["loss"], want, rtol=LOSS_RTOL)
        assert o["steps"] == 2 and o["wq_local"] == (256, 256)
    assert len({o["loss"] for o in outs}) == 1


def test_world1_ring_is_bitwise_the_plain_compile():
    """At world 1 over {"model": 1}, a ring of one: the losses and the
    params after 2 steps equal the plain compile's bit for bit."""
    (got,) = ranks.shared(1, MOD).run("rank_world1_bitwise")
    assert got["mesh"] and got["attr"] == {"seq_parallel": "model"}
    assert got["ring"] == got["plain"], got
    assert got["params_bitwise"]


def test_search_places_attention_on_the_ring_as_jax_does():
    """JAX's `test_search_selects_ring_past_vmem_budget` on the port's
    H100 machine: at 16384 tokens (2 heads over a model axis of 4) the
    search picks `sp_ring:model` and at 512 it does not, as JAX's does on
    its TPU preset. The port prices on purpose without JAX's VMEM gate
    (its flash kernels have no cap on the sequence): the ring wins at 16k
    by dividing the attention over the axis, not by a penalty on flash."""
    import flexflow_tpu as J
    from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
    from flexflow_tpu.search.dp import search_graph as jsearch
    from flexflow_tpu_torch.kernels.flash_attention import flash_supported
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    from flexflow_tpu_torch.search.dp import search_graph

    axes = {"data": 2, "model": 4}

    def mha(pkg, b, s):
        m = pkg.FFModel(pkg.FFConfig(batch_size=b, mesh_shape=dict(axes)))
        x = m.create_tensor([b, s, 128], name="x")
        m.multihead_attention(x, x, x, 128, 2, dropout=0.0, causal=True,
                              name="attn")
        return m

    assert flash_supported(16384, 16384, 64, torch.float32, causal=True)
    for (b, s), want in (((2, 16384), True), ((8, 512), False)):
        got = search_graph(mha(F, b, s), MachineSpec(mesh_axes=axes,
                                                     chip="h100"))
        jgot = jsearch(mha(J, b, s), JMachineSpec(mesh_axes=axes,
                                                  chip="v5p"))
        for name in (got.choices["attn"].name, jgot.choices["attn"].name):
            assert name.startswith("sp_ring") == want, (s, name)
