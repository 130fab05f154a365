"""Multi-head attention (counterpart: flexflow_tpu/ops/attention_ops.py).

Two lowerings, as in the JAX package:

- the plain/prefill path (`kv_out` exposes the per-head K/V of the prompt
  for the paged cache): the hand-written flash kernel
  (kernels/flash_attention.py) when fusion is on, the einsum path when it
  is off; over a mesh, where the strategy sets `seq_parallel` (held to
  JAX's guard at compile), the ring (kernels/ring_attention.py) on the
  flash kernels, with q/k/v/out sharded over the sequence on that axis;
- the paged decode path (serving): the step's K/V are scattered into the
  cache pools (the write indices computed once a step, shared by the
  layers), then attention runs over each slot's pages. An int8 cache runs
  the hand-written dequant kernel (kernels/dequant_attention.py) when
  fusion is on, which reads the pages through the page table itself; the
  einsum paths (the compute-dtype cache, `--no-fusion`) gather each slot's
  pages first, as the JAX lowering does.

Serving over a mesh (serving/engine.py): the paged cache holds each
rank's block of the heads as plain local tensors (serving/kv_cache.py),
and the engine tells the forward its layout (`ctx.cache[KV_HEADS_KEY]`,
the placements of a `[slots, S, heads, d]` block). The projections' K/V
(and, decoding, Q) are redistributed to that layout and run on the
rank's heads (`_cache_heads`): the prefill hands them to the cache as
they are, the decode writes them into its pools and runs the dequant
kernel (int8) or the einsum (compute dtype) on them, and its output,
this rank's heads of the embed dim, enters the output projection as the
DTensor of that layout, whose product DTensor reduces as the strategy
pins it (a pending sum where wo is sharded by rows).

Unlike the JAX lowering, nothing here falls back to einsum: with fusion on
(or `impl="flash"`) the kernel wrapper is the one gate, and on a CUDA
tensor it launches its kernel or raises (a shape it does not cover, a
build or launch error). `enable_fusion=False` (`--no-fusion`) or
`impl="xla"` selects the einsum paths. In training the flash path is
differentiable through the backward kernels. Attention-prob dropout in
training takes the einsum path, as in JAX (the kernel has no dropout): the
mask, drawn from the layer's key, is applied to the probs in their
dtype, and `impl="flash"` with dropout raises. The projections and the compute-dtype
decode einsum are plain `torch.matmul`/`torch.einsum`, as the JAX package
leaves them to XLA. The cache pools are updated in place (the JAX lowering
returns new pools); the updated pools are also returned in `new_state`.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.kernels.dequant_attention import \
    paged_dequant_decode_attention
from flexflow_tpu_torch.kernels.flash_attention import flash_attention_qkv
from flexflow_tpu_torch.kernels.ring_attention import ring_attention_qkv
from flexflow_tpu_torch.ops.dense_ops import weight_matmul
from flexflow_tpu_torch.ops.norm_ops import apply_dropout
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import LoweringCtx, register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer

# ctx.cache key of the paged cache's heads placements over a mesh
KV_HEADS_KEY = "serve/kv_heads"


def _mha_infer(layer: "Layer"):
    q, k, v = [t.spec for t in layer.inputs[:3]]
    p = layer.params
    embed = p["embed_dim"]
    heads = p["num_heads"]
    if embed % heads:
        raise ValueError("num_heads must divide embed_dim")
    if p.get("kdim") and p["kdim"] != k.shape[-1]:
        raise ValueError(f"kdim={p['kdim']} != key feature dim {k.shape[-1]}")
    if p.get("vdim") and p["vdim"] != v.shape[-1]:
        raise ValueError(f"vdim={p['vdim']} != value feature dim {v.shape[-1]}")
    layer.weight_specs = {
        "wq": TensorSpec((q.shape[-1], embed), q.dtype),
        "wk": TensorSpec((k.shape[-1], embed), q.dtype),
        "wv": TensorSpec((v.shape[-1], embed), q.dtype),
        "wo": TensorSpec((embed, embed), q.dtype),
    }
    if p.get("bias", True):
        layer.weight_specs.update({
            "bq": TensorSpec((embed,), q.dtype),
            "bk": TensorSpec((embed,), q.dtype),
            "bv": TensorSpec((embed,), q.dtype),
            "bo": TensorSpec((embed,), q.dtype),
        })
    if p.get("add_bias_kv", False):
        layer.weight_specs["bias_k"] = TensorSpec((embed,), q.dtype)
        layer.weight_specs["bias_v"] = TensorSpec((embed,), q.dtype)
    return [q.with_shape(q.shape[:-1] + (embed,))]


def _split_heads(x, heads):
    b, s, e = x.shape
    return x.reshape(b, s, heads, e // heads)


def _proj(weights, x, w, b):
    y = weight_matmul(x, weights[w].to(x.dtype))
    if b in weights:
        y = y + weights[b].to(x.dtype)
    return y


def _kv_heads_pl(ctx: LoweringCtx, mesh) -> list:
    """The placements of the paged cache's heads over `mesh` (the
    engine's `KV_HEADS_KEY`; every head when it set none)."""
    from torch.distributed.tensor import Replicate

    return ctx.cache.get(KV_HEADS_KEY) or [Replicate()] * mesh.ndim


def _cache_heads(ctx: LoweringCtx, x, heads: int):
    """A projection (b, s, embed) as the heads the paged cache holds: the
    (b, s, h, d) split of a plain tensor; over a mesh this rank's block of
    a DTensor in the cache's layout (`KV_HEADS_KEY`, every head when the
    engine set none; moved by c10d, `relayout`: serving runs no
    autograd), a plain (b, s, h / degree, d) tensor."""
    from torch.distributed.tensor import DTensor

    from flexflow_tpu_torch.runtime.distributed import relayout

    if not isinstance(x, DTensor):
        return _split_heads(x, heads)
    loc = relayout(x, _kv_heads_pl(ctx, x.device_mesh)).to_local()
    return loc.reshape(loc.shape[0], loc.shape[1], -1, x.shape[-1] // heads)


def _out_proj(weights, out, b, s, embed):
    if out.ndim == 4:
        out = out.reshape(b, s, embed)
    y = weight_matmul(out, weights["wo"].to(out.dtype))
    if "bo" in weights:
        y = y + weights["bo"].to(out.dtype)
    return y


def _decode_index(ctx: LoweringCtx, pt, pos, page: int, s: int):
    """Where the step's tokens go in the cache: their positions t (slots,
    s), page ids and offsets (positions past the slot's pages go to the
    scratch page 0), and the page table as int64 for the gathers. Every
    layer of a step computes the same, so the first computes it and the
    others read it from `ctx.memo`."""
    key = ("serve/decode_index", page, s)
    if key not in ctx.memo:
        ptl = pt.long()
        t = pos.long()[:, None] + torch.arange(s, device=pos.device)[None, :]
        pg = t // page
        rows = torch.arange(pt.shape[0], device=pos.device)[:, None]
        pageix = torch.where(pg < pt.shape[1],
                             ptl[rows, pg.clamp(max=pt.shape[1] - 1)],
                             torch.zeros_like(pg))
        ctx.memo[key] = (t, pageix, t % page, ptl)
    return ctx.memo[key]


def _mha_decode_lower(layer: "Layer", inputs, weights, ctx: LoweringCtx):
    """Decode step(s) against the paged KV cache. Inputs are
    [slots, s, embed]; the cache is in ctx.state[layer.name] ({"k", "v"}
    pools [pages, page, h, d], plus "k_scale"/"v_scale" for int8), with
    ctx.state["serve/page_table"] [slots, pages_per_slot] and
    ctx.state["serve/pos"] [slots]. Token i's K/V go to page (pos+i)//page
    at offset (pos+i)%page; positions past the slot's pages go to the
    scratch page 0. Query i attends cached positions <= pos+i."""
    from flexflow_tpu_torch.serving.kv_cache import (PAGE_TABLE_KEY, POS_KEY,
                                                     kv_quantize)

    q = inputs[0]
    p = layer.params
    heads = p["num_heads"]
    embed = p["embed_dim"]
    hd = embed // heads
    dt = q.dtype
    # over a mesh: this rank's heads, as plain tensors (the docstring)
    qh = _cache_heads(ctx, _proj(weights, inputs[0], "wq", "bq"), heads)
    kh = _cache_heads(ctx, _proj(weights, inputs[1], "wk", "bk"), heads)
    vh = _cache_heads(ctx, _proj(weights, inputs[2], "wv", "bv"), heads)
    heads = qh.shape[2]

    cache = ctx.state[layer.name]
    k_pool, v_pool = cache["k"], cache["v"]
    quantized = "k_scale" in cache
    pt = ctx.state[PAGE_TABLE_KEY]
    pos = ctx.state[POS_KEY]
    b, s = q.shape[0], q.shape[1]
    t, pageix, off, ptl = _decode_index(ctx, pt, pos, k_pool.shape[1], s)
    if quantized:
        qk, ksc = kv_quantize(kh)
        qv, vsc = kv_quantize(vh)
        k_pool[pageix, off] = qk
        v_pool[pageix, off] = qv
        cache["k_scale"][pageix, off] = ksc
        cache["v_scale"][pageix, off] = vsc
    else:
        k_pool[pageix, off] = kh.to(k_pool.dtype)
        v_pool[pageix, off] = vh.to(v_pool.dtype)
    ctx.new_state[layer.name] = cache

    scale = 1.0 / math.sqrt(hd)
    if quantized and ctx.enable_fusion:
        # the kernel reads each slot's pages through the table itself
        out = paged_dequant_decode_attention(
            qh, k_pool, cache["k_scale"], v_pool, cache["v_scale"], pt, pos,
            scale=scale)
        return [_out_proj(weights, _heads_out(ctx, q, out), b, s, embed)]
    # gather each slot's pages: [slots, L, h, (d)]
    if quantized:
        K = (k_pool[ptl].reshape(b, -1, heads, hd).float()
             * cache["k_scale"][ptl].reshape(b, -1, heads)[..., None]).to(dt)
        V = (v_pool[ptl].reshape(b, -1, heads, hd).float()
             * cache["v_scale"][ptl].reshape(b, -1, heads)[..., None]).to(dt)
    else:
        K = k_pool[ptl].reshape(b, -1, heads, hd).to(dt)
        V = v_pool[ptl].reshape(b, -1, heads, hd).to(dt)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, K) * scale
    keep = (torch.arange(K.shape[1], device=q.device)[None, None, None, :]
            <= t[:, None, :, None])
    logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, V)
    return [_out_proj(weights, _heads_out(ctx, q, out), b, s, embed)]


def _heads_out(ctx: LoweringCtx, q, out):
    """The decode attention's output (b, s, h, d) for the output
    projection: as it is off a mesh; over one this rank's heads of the
    embed dim, as the DTensor (b, s, embed) of the cache's layout."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return out
    b, s = out.shape[:2]
    return DTensor.from_local(out.reshape(b, s, -1), q.device_mesh,
                              _kv_heads_pl(ctx, q.device_mesh),
                              run_check=False)


def _jax_flash_gate(sk: int) -> bool:
    """Whether the JAX lowering's flash gate admits a key length: it
    needs a block of (1024, 512, 256, 128) to divide it, else it takes the
    einsum path. Only the key positions add_bias_kv / add_zero_attn append
    consult it here, so those layers take the path JAX takes."""
    return any(sk % b == 0 for b in (1024, 512, 256, 128))


def _ring_axis(layer: "Layer", ctx: LoweringCtx):
    """The mesh axis the strategy runs this attention's ring on (the
    sp_ring candidate's {"seq_parallel": axis}), None off a mesh or
    without one. The compile held it to JAX's guard
    (`attention_ops.py:228-238`); what the ring cannot run raises there."""
    sh = ctx.mesh_sharding(layer)
    return None if sh is None else sh.attrs.get("seq_parallel")


def _batch_axes(x) -> list:
    """The mesh dims a DTensor shards its dim 0 over, by name."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return []
    return [n for n, p in zip(x.device_mesh.mesh_dim_names, x.placements)
            if isinstance(p, Shard) and p.dim == 0]


def _mha_lower(layer: "Layer", inputs, weights, ctx: LoweringCtx):
    p = layer.params
    extras = "bias_k" in weights or p.get("add_zero_attn", False)
    if extras and (p.get("decode", False) or p.get("kv_out", False)):
        raise NotImplementedError(
            "KV-cache decode/prefill does not support add_bias_kv/"
            "add_zero_attn (extra key positions would enter the cache)")
    if p.get("decode", False):
        return _mha_decode_lower(layer, inputs, weights, ctx)
    q, k, v = inputs[:3]
    heads = p["num_heads"]
    embed = p["embed_dim"]
    kp = _proj(weights, k, "wk", "bk")
    vp = _proj(weights, v, "wv", "bv")
    if p.get("kv_out", False):
        # serving prefill: the per-head K/V of the prompt, for the cache
        # (over a mesh this rank's heads of them)
        ctx.new_state[layer.name] = {"k": _cache_heads(ctx, kp, heads),
                                     "v": _cache_heads(ctx, vp, heads)}
    b_ = k.shape[0]
    if "bias_k" in weights:  # add_bias_kv: one learned key/value position
        kp = torch.cat([kp, weights["bias_k"].to(kp.dtype).expand(
            b_, 1, embed)], dim=1)
        vp = torch.cat([vp, weights["bias_v"].to(vp.dtype).expand(
            b_, 1, embed)], dim=1)
    if p.get("add_zero_attn", False):
        kp = torch.cat([kp, kp.new_zeros(b_, 1, embed)], dim=1)
        vp = torch.cat([vp, vp.new_zeros(b_, 1, embed)], dim=1)
    kh = _split_heads(kp, heads)
    vh = _split_heads(vp, heads)
    qh = _split_heads(_proj(weights, q, "wq", "bq"), heads)

    impl = p.get("impl", "auto")
    # the flash kernel has no probs-dropout path: dropout in training takes
    # the einsum path (or fails under impl="flash")
    needs_dropout = ctx.training and p.get("dropout", 0.0) > 0.0
    if impl == "flash" and needs_dropout:
        raise NotImplementedError("impl='flash' does not support attention-prob "
                                  "dropout; use dropout=0.0 or impl='xla'")
    causal = p.get("causal", False)
    scale = 1.0 / math.sqrt(embed // heads)
    b, sq = q.shape[0], q.shape[1]
    sk = kh.shape[1]
    # the extra key positions: JAX's flash gate decides (it refuses a
    # causal band over sq != sk and a key length its blocks do not divide)
    flash_ok = not extras or (_jax_flash_gate(sk) and _jax_flash_gate(sq)
                              and not (causal and sq != sk))
    ring = _ring_axis(layer, ctx)
    if ring is not None:
        # the batch stays on the axes the strategy put it on
        out = ring_attention_qkv(qh, kh, vh, ctx.mesh, ring, causal=causal,
                                 scale=scale, batch_axes=_batch_axes(qh))
    elif not needs_dropout and flash_ok and (
            impl == "flash" or (impl == "auto" and ctx.enable_fusion)):
        out = flash_attention_qkv(qh, kh, vh, causal=causal, scale=scale)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
        if causal:
            # the band over the original key positions; those appended
            # by add_bias_kv / add_zero_attn (at the end) stay attendable
            sk_orig = k.shape[1]
            mask = torch.ones(sq, sk_orig, dtype=torch.bool,
                              device=q.device).tril(diagonal=sk_orig - sq)
            if sk > sk_orig:
                mask = torch.cat([mask, mask.new_ones(sq, sk - sk_orig)],
                                 dim=1)
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits, dim=-1)
        if needs_dropout:
            probs = apply_dropout(probs, layer, ctx, p["dropout"])
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    return [_out_proj(weights, out, b, sq, embed)]


def _mha_flops(layer: "Layer"):
    q, k = layer.inputs[0].spec, layer.inputs[1].spec
    b, sq, e = q.shape
    sk = k.shape[1]
    proj = 2.0 * b * (3 * sq + sq) * e * e  # q,k,v,o projections (sq ~ sk)
    attn = 2.0 * b * sq * sk * e * 2  # qk^T and att@v
    return proj + attn


register_op(OperatorType.MULTIHEAD_ATTENTION, _mha_infer, _mha_lower,
            _mha_flops)


def _sdpa_infer(layer: "Layer"):
    """Scaled-dot-product attention without projections (torch's
    F.scaled_dot_product_attention signature): q (..., sq, d), k (..., sk,
    d), v (..., sk, dv) -> (..., sq, dv); an optional 4th input is an
    additive float mask or a boolean keep-mask, broadcastable to (..., sq,
    sk)."""
    q, k, v = [t.spec for t in layer.inputs[:3]]
    if q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q/k depth mismatch {q.shape} vs {k.shape}")
    return [q.with_shape(q.shape[:-1] + (v.shape[-1],))]


def _sdpa_lower(layer: "Layer", inputs, weights, ctx: LoweringCtx):
    """matmul, softmax, matmul, masked as JAX masks: a masked logit is the
    dtype's finfo.min (a fully masked row averages V uniformly, where
    torch's SDPA gives NaN), the causal band is top-left aligned (tril
    diagonal 0) and the dropout mask comes from the layer's key."""
    q, k, v = inputs[:3]
    mask = inputs[3] if len(inputs) > 3 else None
    p = layer.params
    scale = p.get("scale")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    neg = torch.finfo(logits.dtype).min
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, neg)
        else:
            logits = logits + mask.to(logits.dtype)
    if p.get("is_causal", False):
        sq, sk = logits.shape[-2], logits.shape[-1]
        band = torch.ones(sq, sk, dtype=torch.bool,
                          device=logits.device).tril()
        logits = logits.masked_fill(~band, neg)
    probs = torch.softmax(logits, dim=-1)
    if ctx.training and p.get("dropout_p", 0.0) > 0.0:
        probs = apply_dropout(probs, layer, ctx, p["dropout_p"])
    return [torch.matmul(probs, v)]


def _sdpa_flops(layer: "Layer"):
    q, k = layer.inputs[0].spec, layer.inputs[1].spec
    batch = 1
    for d in q.shape[:-2]:
        batch *= d
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    return 2.0 * batch * sq * sk * d * 2


register_op(OperatorType.SDPA, _sdpa_infer, _sdpa_lower, _sdpa_flops)
