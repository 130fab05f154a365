"""Multi-head attention (counterpart: flexflow_tpu/ops/attention_ops.py).

Two lowerings, as in the JAX package:

- the plain/prefill path (`kv_out` exposes the per-head K/V of the prompt
  for the paged cache): the hand-written flash kernel
  (kernels/flash_attention.py) when fusion is on, the einsum path when it
  is off;
- the paged decode path (serving): the step's K/V are scattered into the
  cache pools (the write indices computed once a step, shared by the
  layers), then attention runs over each slot's pages. An int8 cache runs
  the hand-written dequant kernel (kernels/dequant_attention.py) when
  fusion is on, which reads the pages through the page table itself; the
  einsum paths (the compute-dtype cache, `--no-fusion`) gather each slot's
  pages first, as the JAX lowering does.

Unlike the JAX lowering, nothing here falls back to einsum: with fusion on
the kernel wrapper is the one gate, and on a CUDA tensor it launches its
kernel or raises (a shape it does not cover, a build or launch error). Only
`enable_fusion=False` (`--no-fusion`) selects the einsum paths. In training
the flash path is differentiable through the backward kernels;
attention-prob dropout is not ported, so a training step with dropout > 0
raises rather than dropping nothing. The projections and the compute-dtype
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
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import LoweringCtx, register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


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
    if p.get("add_bias_kv", False) or p.get("add_zero_attn", False):
        raise NotImplementedError(
            "add_bias_kv/add_zero_attn are not ported yet")
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
    return [q.with_shape(q.shape[:-1] + (embed,))]


def _split_heads(x, heads):
    b, s, e = x.shape
    return x.reshape(b, s, heads, e // heads)


def _proj(weights, x, w, b):
    y = x @ weights[w].to(x.dtype)
    if b in weights:
        y = y + weights[b].to(x.dtype)
    return y


def _out_proj(weights, out, b, s, embed):
    y = out.reshape(b, s, embed) @ weights["wo"].to(out.dtype)
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
    qh = _split_heads(_proj(weights, inputs[0], "wq", "bq"), heads)
    kh = _split_heads(_proj(weights, inputs[1], "wk", "bk"), heads)
    vh = _split_heads(_proj(weights, inputs[2], "wv", "bv"), heads)

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
        return [_out_proj(weights, out, b, s, embed)]
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
    return [_out_proj(weights, out, b, s, embed)]


def _mha_lower(layer: "Layer", inputs, weights, ctx: LoweringCtx):
    p = layer.params
    if p.get("decode", False):
        return _mha_decode_lower(layer, inputs, weights, ctx)
    q, k, v = inputs[:3]
    heads = p["num_heads"]
    embed = p["embed_dim"]
    kp = _proj(weights, k, "wk", "bk")
    vp = _proj(weights, v, "wv", "bv")
    kh = _split_heads(kp, heads)
    vh = _split_heads(vp, heads)
    if p.get("kv_out", False):
        # serving prefill: the per-head K/V of the prompt, for the cache
        ctx.new_state[layer.name] = {"k": kh, "v": vh}
    qh = _split_heads(_proj(weights, q, "wq", "bq"), heads)

    if ctx.training and p.get("dropout", 0.0) > 0.0:
        raise NotImplementedError(
            f"{layer.name}: attention-prob dropout (rate {p['dropout']}) in "
            "training is not ported yet; build the model with dropout 0")
    causal = p.get("causal", False)
    scale = 1.0 / math.sqrt(embed // heads)
    b, sq = q.shape[0], q.shape[1]
    sk = kh.shape[1]
    if ctx.enable_fusion:
        out = flash_attention_qkv(qh, kh, vh, causal=causal, scale=scale)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
        if causal:
            mask = torch.ones(sq, sk, dtype=torch.bool,
                              device=q.device).tril(diagonal=sk - sq)
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    return [_out_proj(weights, out, b, sq, embed)]


register_op(OperatorType.MULTIHEAD_ATTENTION, _mha_infer, _mha_lower)
