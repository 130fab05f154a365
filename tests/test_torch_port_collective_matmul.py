"""The collective matmul on the port (kernels/collective_matmul.py),
against `jnp.dot` on the same numpy inputs: JAX's own test's reference
(tests/test_collective_matmul.py:28-66), since JAX's `collective_matmul`
raises on the installed jax.

Ranks spawned on gloo at world 2 ({"model": 2}) and 4 ({"data": 2,
"model": 2}, the ring on either axis): y = x @ w with x's rows walking
the ring, its layout (columns on the ring axis), and the gradients of
sum(y²) through the written-out backward (dW a second walk, dX a reduce
ring). The gate and its errors (JAX's `test_supported_precheck_and_
errors`). f32; tolerances JAX's test's: 1e-5 forward, 2e-4 gradients.
"""

import numpy as np
import pytest
import torch

import _torch_port_ranks as ranks
from flexflow_tpu_torch.kernels.collective_matmul import (
    collective_matmul, collective_matmul_supported)

MOD = __name__
FWD_TOL, GRAD_TOL = 1e-5, 2e-4
MESHES = {2: {"model": 2}, 4: {"data": 2, "model": 2}}


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    ranks.close_all()


def _xw(m=64, k=32, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


# ------------------------------------------------------------- rank code
def rank_matmul(shape, axis, x, w):
    from torch.distributed.tensor import Replicate, Shard

    from flexflow_tpu_torch.runtime.distributed import global_batch_from_full

    mesh = _mesh(shape)
    rep = [Replicate()] * mesh.ndim
    xd = global_batch_from_full(torch.from_numpy(x), mesh, rep)
    wd = global_batch_from_full(torch.from_numpy(w), mesh, rep)
    xd.requires_grad_()
    wd.requires_grad_()
    y = collective_matmul(xd, wd, mesh, axis)
    (y * y).sum().backward()
    j = list(mesh.mesh_dim_names).index(axis)
    return {"y": y.full_tensor().detach().numpy(),
            "dx": xd.grad.full_tensor().numpy(),
            "dw": wd.grad.full_tensor().numpy(),
            "col_shard": y.placements[j] == Shard(1)
            and all(p == Replicate() for i, p in enumerate(y.placements)
                    if i != j),
            "local": tuple(y.to_local().shape)}


def rank_gate():
    mesh = _mesh(MESHES[4])
    x, w = (torch.from_numpy(a) for a in _xw())
    ok = {"model": collective_matmul_supported(mesh, "model", 64, 64),
          "m": collective_matmul_supported(mesh, "model", 63, 64),
          "n": collective_matmul_supported(mesh, "model", 64, 65),
          "axis": collective_matmul_supported(mesh, "pipe", 64, 64),
          "none": collective_matmul_supported(None, "model", 64, 64)}
    raised = []
    for args in ((x, w, mesh, "pipe"), (x[:, :16], w, mesh, "model")):
        try:
            collective_matmul(*args)
        except ValueError as e:
            raised.append(str(e))
    return ok, raised


# ------------------------------------------------------------------ tests
def _reference(x, w):
    import jax
    import jax.numpy as jnp

    def f(x_, w_):
        return jnp.sum(jnp.dot(x_, w_, preferred_element_type=jnp.float32)
                       ** 2)

    y = jnp.dot(jnp.asarray(x), jnp.asarray(w),
                preferred_element_type=jnp.float32)
    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(y), np.asarray(gx), np.asarray(gw)


@pytest.mark.parametrize("world,axis", [(2, "model"), (4, "model"),
                                        (4, "data")])
def test_ring_matches_jnp_dot(world, axis):
    """Forward and gradients against jnp.dot on every rank; y keeps all
    its rows and this rank's columns (JAX's layout contract)."""
    x, w = _xw(seed=world)
    y, gx, gw = _reference(x, w)
    outs = ranks.shared(world, MOD).run("rank_matmul", MESHES[world], axis,
                                        x, w)
    p = MESHES[world][axis]
    for o in outs:
        np.testing.assert_allclose(o["y"], y, rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(o["dx"], gx, rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(o["dw"], gw, rtol=GRAD_TOL, atol=GRAD_TOL)
        assert o["col_shard"] and o["local"] == (64, 64 // p)


def test_supported_precheck_and_errors():
    """JAX's gate: the axis on the mesh with more than one rank dividing
    m and n; an axis the mesh lacks and a k mismatch raise ValueError."""
    ok, raised = ranks.shared(4, MOD).run("rank_gate")[0]
    assert ok == {"model": True, "m": False, "n": False, "axis": False,
                  "none": False}
    assert len(raised) == 2
    assert "can't ring" in raised[0] and "bad shapes" in raised[1]
    assert not collective_matmul_supported(None, "model", 64, 64)
