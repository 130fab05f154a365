"""torch.fx frontend (counterpart: flexflow_tpu/torch/model.py): import a
PyTorch nn.Module into an FFModel graph.

`PyTorchModel` traces a module with torch.fx (or HF transformers' fx for
HF models) and reduces the graph to JSON records, one per fx node: the
`.ff` file format, the same as the JAX package's, so a file written by
either package replays in the other. The importer walks the records with
dispatch tables over fx node targets and folds expressions of concrete
values (shapes from .size(), buffers, traced literals) at import time
instead of emitting graph ops. `file_to_ff` replays a file without
tracing anything.

`import_weights` copies the module's parameters into a compiled model as
tensors, on the compiled model's device and in its dtype, with no host
round trip, so a module that lives on the GPU imports from there; batch
norm's running stats go into the compiled model's `state`.
"""

from __future__ import annotations

import json
import math
import operator
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from flexflow_tpu_torch.core.tensor import Tensor

# ---------------------------------------------------------------------------
# module specs: a call_module fx node is reduced at trace time to a plain
# dict {"cls": ..., **config} so that live import and file replay share one
# handler per module class and file replay needs no torch.
# ---------------------------------------------------------------------------


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def module_to_spec(module) -> Dict[str, Any]:
    import torch.nn as nn

    m = module
    if isinstance(m, nn.Linear):
        return {"cls": "Linear", "out_features": m.out_features,
                "bias": m.bias is not None}
    try:
        from transformers.pytorch_utils import Conv1D as HFConv1D
    except Exception:
        HFConv1D = ()
    if HFConv1D and isinstance(m, HFConv1D):
        return {"cls": "HFConv1D", "out_features": m.nf, "bias": True}
    if isinstance(m, nn.Conv2d):
        if _pair(m.dilation) != (1, 1):
            raise NotImplementedError("dilated conv")
        return {"cls": "Conv2d", "out_channels": m.out_channels,
                "kernel_size": _pair(m.kernel_size), "stride": _pair(m.stride),
                "padding": _pair(m.padding), "groups": m.groups,
                "bias": m.bias is not None}
    if isinstance(m, nn.MaxPool2d):
        if m.ceil_mode or _pair(m.dilation) != (1, 1) or m.return_indices:
            raise NotImplementedError(
                "MaxPool2d ceil_mode/dilation/return_indices import unsupported "
                "(would silently change output shapes/values)")
        return {"cls": "Pool2d", "pool_type": "max",
                "kernel_size": _pair(m.kernel_size),
                "stride": _pair(m.stride or m.kernel_size),
                "padding": _pair(m.padding)}
    if isinstance(m, nn.AvgPool2d):
        if m.ceil_mode:
            raise NotImplementedError("AvgPool2d ceil_mode import unsupported")
        return {"cls": "Pool2d", "pool_type": "avg",
                "kernel_size": _pair(m.kernel_size),
                "stride": _pair(m.stride or m.kernel_size),
                "padding": _pair(m.padding)}
    if isinstance(m, nn.AdaptiveAvgPool2d):
        return {"cls": "AdaptiveAvgPool2d", "output_size": _pair(m.output_size)}
    if isinstance(m, nn.BatchNorm2d):
        return {"cls": "BatchNorm2d", "eps": m.eps,
                "momentum": 1.0 - (m.momentum or 0.1)}
    if isinstance(m, nn.LayerNorm):
        return {"cls": "LayerNorm", "eps": m.eps,
                "n_axes": len(m.normalized_shape),
                "affine": m.elementwise_affine}
    if isinstance(m, nn.Embedding):
        return {"cls": "Embedding", "num_embeddings": m.num_embeddings,
                "embedding_dim": m.embedding_dim}
    if isinstance(m, nn.Dropout):
        return {"cls": "Dropout", "p": m.p}
    if isinstance(m, nn.Softmax):
        return {"cls": "Softmax", "dim": m.dim if m.dim is not None else -1}
    if isinstance(m, nn.LogSoftmax):
        return {"cls": "LogSoftmax", "dim": m.dim if m.dim is not None else -1}
    if isinstance(m, nn.Flatten):
        return {"cls": "Flatten", "start_dim": m.start_dim, "end_dim": m.end_dim}
    if isinstance(m, nn.MultiheadAttention):
        return {"cls": "MultiheadAttention", "embed_dim": m.embed_dim,
                "num_heads": m.num_heads, "dropout": m.dropout,
                "bias": m.in_proj_bias is not None,
                "add_bias_kv": m.bias_k is not None,
                "add_zero_attn": m.add_zero_attn,
                "batch_first": m.batch_first}
    for cls, tag in ((nn.ReLU, "ReLU"), (nn.GELU, "GELU"), (nn.SiLU, "SiLU"),
                     (nn.Sigmoid, "Sigmoid"), (nn.Tanh, "Tanh"), (nn.ELU, "ELU"),
                     (nn.Identity, "Identity")):
        if isinstance(m, cls):
            return {"cls": tag}
    raise NotImplementedError(f"no FFModel mapping for module {type(m).__name__}")


def _flatten_dims(ff, x, start, end, name):
    nd = x.ndim
    start %= nd
    end %= nd
    if start == end:
        return x
    shape = (list(x.shape[:start])
             + [int(np.prod(x.shape[start:end + 1]))]
             + list(x.shape[end + 1:]))
    return ff.reshape(x, shape, name=name)


def _h_linear(im, spec, args, name):
    return im.ff.dense(im.as_tensor(args[0]), spec["out_features"],
                       use_bias=spec["bias"], name=name)


def _h_conv2d(im, spec, args, name):
    kh, kw = spec["kernel_size"]
    sh, sw = spec["stride"]
    ph, pw = spec["padding"]
    return im.ff.conv2d(im.as_tensor(args[0]), spec["out_channels"], kh, kw,
                        sh, sw, ph, pw, groups=spec["groups"],
                        use_bias=spec["bias"], name=name)


def _h_pool2d(im, spec, args, name):
    kh, kw = spec["kernel_size"]
    sh, sw = spec["stride"]
    ph, pw = spec["padding"]
    return im.ff.pool2d(im.as_tensor(args[0]), kh, kw, sh, sw, ph, pw,
                        pool_type=spec["pool_type"], name=name)


def _h_adaptive_pool(im, spec, args, name):
    x = im.as_tensor(args[0])
    oh, ow = spec["output_size"]
    h, w = x.shape[2], x.shape[3]
    if h % oh or w % ow:
        raise NotImplementedError(f"adaptive pool {h}x{w} -> {oh}x{ow}")
    return im.ff.pool2d(x, h // oh, w // ow, h // oh, w // ow, 0, 0,
                        pool_type="avg", name=name)


MODULE_HANDLERS: Dict[str, Callable] = {
    "Linear": _h_linear,
    "HFConv1D": _h_linear,  # GPT-2's Conv1D == Linear with (in,out) weight
    "Conv2d": _h_conv2d,
    "Pool2d": _h_pool2d,
    "AdaptiveAvgPool2d": _h_adaptive_pool,
    "BatchNorm2d": lambda im, s, a, name: im.ff.batch_norm(
        im.as_tensor(a[0]), relu=False, momentum=s["momentum"], eps=s["eps"], name=name),
    "LayerNorm": lambda im, s, a, name: im.ff.layer_norm(
        im.as_tensor(a[0]), axes=list(range(-s["n_axes"], 0)),
        elementwise_affine=s["affine"], eps=s["eps"], name=name),
    "Embedding": lambda im, s, a, name: im.ff.embedding(
        im.as_tensor(a[0]), s["num_embeddings"], s["embedding_dim"], name=name),
    "Dropout": lambda im, s, a, name: im.ff.dropout(
        im.as_tensor(a[0]), rate=s["p"], name=name),
    "Softmax": lambda im, s, a, name: im.ff.softmax(
        im.as_tensor(a[0]), axis=s["dim"], name=name),
    "LogSoftmax": lambda im, s, a, name: im.ff.log_softmax(
        im.as_tensor(a[0]), axis=s["dim"], name=name),
    "Flatten": lambda im, s, a, name: _flatten_dims(
        im.ff, im.as_tensor(a[0]), s["start_dim"], s["end_dim"], name),
    "ReLU": lambda im, s, a, name: im.ff.relu(im.as_tensor(a[0]), name=name),
    "GELU": lambda im, s, a, name: im.ff.gelu(im.as_tensor(a[0]), name=name),
    "SiLU": lambda im, s, a, name: im.ff.silu(im.as_tensor(a[0]), name=name),
    "Sigmoid": lambda im, s, a, name: im.ff.sigmoid(im.as_tensor(a[0]), name=name),
    "Tanh": lambda im, s, a, name: im.ff.tanh(im.as_tensor(a[0]), name=name),
    "ELU": lambda im, s, a, name: im.ff.elu(im.as_tensor(a[0]), name=name),
    "Identity": lambda im, s, a, name: im.as_tensor(a[0]),
}


def _h_mha(im, spec, args, kwargs, name):
    # forward(q, k, v, key_padding_mask=None, need_weights=True,
    #         attn_mask=None, average_attn_weights=True, is_causal=False)
    def arg(pos, kw, default=None):
        if len(args) > pos:
            return args[pos]
        return kwargs.get(kw, default)

    # masks would be silently dropped (unmasked attention with wrong
    # numerics) — fail loudly instead, like dilated conv / strided slices
    if arg(3, "key_padding_mask") is not None or arg(5, "attn_mask") is not None:
        raise NotImplementedError(
            "MultiheadAttention attn_mask/key_padding_mask import unsupported; "
            "use is_causal=True or drop the mask")
    is_causal = bool(arg(7, "is_causal", False))
    q, k, v = (im.as_tensor(a) for a in args[:3])
    if not spec["batch_first"]:
        # our MHA is batch-first; transpose in and out
        q = im.ff.transpose(q, (1, 0, 2), name=f"{name}_qT")
        k = im.ff.transpose(k, (1, 0, 2), name=f"{name}_kT")
        v = im.ff.transpose(v, (1, 0, 2), name=f"{name}_vT")
    out = im.ff.multihead_attention(
        q, k, v, spec["embed_dim"], spec["num_heads"], dropout=spec["dropout"],
        bias=spec["bias"], add_bias_kv=spec["add_bias_kv"],
        add_zero_attn=spec["add_zero_attn"], causal=is_causal, name=name)
    if not spec["batch_first"]:
        out = im.ff.transpose(out, (1, 0, 2), name=f"{name}_oT")
    # torch returns (attn_output, attn_weights); weights path unsupported
    return (out, None)


MODULE_HANDLERS["MultiheadAttention"] = _h_mha  # takes kwargs (special-cased)

# ---------------------------------------------------------------------------
# function / method handlers. Values are Tensor or concrete (int/float/tuple/
# np.ndarray). Concrete-only expressions fold eagerly.
# ---------------------------------------------------------------------------


def _is_t(v) -> bool:
    return isinstance(v, Tensor)


def _np(v):
    # avoid importing torch on the replay path (file_to_ff runs torch-less)
    if type(v).__module__.startswith("torch"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class _Finfo:
    def __init__(self, dtype=None):
        npdt = np.float32
        if dtype is not None:
            s = str(dtype).replace("torch.", "")
            npdt = {"float16": np.float16, "half": np.float16,
                    "float64": np.float64}.get(s, np.float32)
        self.min = float(np.finfo(npdt).min)
        self.max = float(np.finfo(npdt).max)
        self.eps = float(np.finfo(npdt).eps)


def _as_torch_dtype(v):
    """Accept torch.dtype, flexflow DataType, or string."""
    import torch as _torch

    from flexflow_tpu_torch.dtype import DataType as _DT

    if isinstance(v, _torch.dtype):
        return v
    if isinstance(v, _DT):
        return getattr(_torch, _DTYPE_ALIAS.get(v.value, v.value))
    if isinstance(v, str):
        return getattr(_torch, _DTYPE_ALIAS.get(v, v))
    return v


def _binary(im, op_t, op_s, fold, a, b, name):
    """Dispatch tensor/tensor, tensor/scalar, scalar-only binary ops."""
    if _is_t(a) and _is_t(b):
        return op_t(a, b, name=name)
    if _is_t(a) and isinstance(b, (int, float)):
        return op_s(im, a, float(b), False, name)
    if _is_t(b) and isinstance(a, (int, float)):
        return op_s(im, b, float(a), True, name)
    if _is_t(a) or _is_t(b):
        # tensor op ndarray constant: materialize the constant
        ta = a if _is_t(a) else im.ff.constant(_np(a), name=f"{name}_c")
        tb = b if _is_t(b) else im.ff.constant(_np(b), name=f"{name}_c")
        return op_t(ta, tb, name=name)
    return fold(a, b)


def _scalar_add(im, x, s, rev, name):
    return im.ff.scalar_add(x, s, name=name)


def _scalar_sub(im, x, s, rev, name):
    if rev:  # s - x
        neg = im.ff.scalar_multiply(x, -1.0, name=f"{name}_neg")
        return im.ff.scalar_add(neg, s, name=name)
    return im.ff.scalar_sub(x, s, name=name)


def _scalar_mul(im, x, s, rev, name):
    return im.ff.scalar_multiply(x, s, name=name)


def _scalar_div(im, x, s, rev, name):
    if rev:  # s / x
        inv = im.ff.pow(x, -1.0, name=f"{name}_inv")
        return im.ff.scalar_multiply(inv, s, name=name)
    return im.ff.scalar_true_divide(x, s, name=name)


def _h_add(im, args, kwargs, name):
    return _binary(im, im.ff.add, _scalar_add, operator.add, args[0], args[1], name)


def _h_sub(im, args, kwargs, name):
    return _binary(im, im.ff.subtract, _scalar_sub, operator.sub, args[0], args[1], name)


def _h_mul(im, args, kwargs, name):
    return _binary(im, im.ff.multiply, _scalar_mul, operator.mul, args[0], args[1], name)


def _h_div(im, args, kwargs, name):
    return _binary(im, im.ff.divide, _scalar_div, operator.truediv, args[0], args[1], name)


def _h_eq(im, args, kwargs, name):
    a, b = args[0], args[1]
    if not (_is_t(a) or _is_t(b)):
        return a == b
    ta = a if _is_t(a) else im.ff.constant(_np(a), name=f"{name}_c")
    tb = b if _is_t(b) else im.ff.constant(_np(b), name=f"{name}_c")
    return im.ff._binary(im.ff_optype.EW_EQUAL, ta, tb, name=name)


def _h_getitem(im, args, kwargs, name):
    obj, idx = args[0], args[1]
    if not _is_t(obj):
        if isinstance(obj, np.ndarray):
            return obj[idx if not isinstance(idx, list) else tuple(idx)]
        return obj[idx]
    # tensor indexing: ints / slices / None (unsqueeze) / Ellipsis
    # (tuples arrive as lists after serialization)
    if isinstance(idx, list):
        idx = tuple(idx)
    if not isinstance(idx, tuple):
        idx = (idx,)
    if Ellipsis in idx:
        pos = idx.index(Ellipsis)
        n_explicit = sum(1 for i in idx if i is not Ellipsis and i is not None)
        fill = obj.ndim - n_explicit
        idx = idx[:pos] + (slice(None),) * fill + idx[pos + 1:]
    starts, limits, squeeze_dims, unsqueeze_positions = [], [], [], []
    d = 0
    out_pos = 0
    for it in idx:
        if it is None:
            unsqueeze_positions.append(out_pos)
            out_pos += 1
            continue
        if isinstance(it, int):
            lo = it % obj.shape[d]
            starts.append(lo)
            limits.append(lo + 1)
            squeeze_dims.append(d)
            d += 1
            continue
        if isinstance(it, slice):
            lo, hi, step = it.indices(obj.shape[d])
            if step != 1:
                raise NotImplementedError("strided tensor slice")
            starts.append(lo)
            limits.append(hi)
            d += 1
            out_pos += 1
            continue
        raise NotImplementedError(f"tensor getitem index {it!r}")
    while d < obj.ndim:
        starts.append(0)
        limits.append(obj.shape[d])
        d += 1
        out_pos += 1
    x = obj
    if any(lo != 0 for lo in starts) or any(
            hi != s for hi, s in zip(limits, obj.shape)):
        x = im.ff.slice_tensor(x, starts, limits, name=f"{name}_sl")
    final = [d2 for d2 in range(obj.ndim) if d2 not in squeeze_dims]
    shape = [x.shape[d2] for d2 in final]
    for p in unsqueeze_positions:
        shape.insert(p, 1)
    if tuple(shape) != x.shape:
        x = im.ff.reshape(x, shape, name=f"{name}_rs")
    return x


def _h_matmul(im, args, kwargs, name):
    a, b = im.as_tensor(args[0]), im.as_tensor(args[1])
    return im.ff.batch_matmul(a, b, name=name)


def _h_cat(im, args, kwargs, name):
    tensors = [im.as_tensor(t) for t in args[0]]
    axis = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    return im.ff.concat(tensors, axis=axis, name=name)


def _h_split(im, args, kwargs, name):
    x = im.as_tensor(args[0])
    size = args[1]
    axis = args[2] if len(args) > 2 else kwargs.get("dim", 0)
    if isinstance(size, int):
        d = x.shape[axis % x.ndim]
        n = (d + size - 1) // size
        sizes = [size] * (n - 1) + [d - size * (n - 1)]
    else:
        sizes = list(size)
    return tuple(im.ff.split(x, sizes, axis=axis, name=name))


def _h_chunk(im, args, kwargs, name):
    x = im.as_tensor(args[0])
    n = args[1]
    axis = args[2] if len(args) > 2 else kwargs.get("dim", 0)
    d = x.shape[axis % x.ndim]
    if d % n == 0:
        return tuple(im.ff.split(x, n, axis=axis, name=name))
    # torch.chunk semantics for non-divisible dims: ceil-div chunk size,
    # smaller final chunk, possibly fewer than n chunks
    size = -(-d // n)
    sizes = []
    rem = d
    while rem > 0:
        sizes.append(min(size, rem))
        rem -= size
    return tuple(im.ff.split(x, sizes, axis=axis, name=name))


def _h_flatten(im, args, kwargs, name):
    x = im.as_tensor(args[0])
    start = args[1] if len(args) > 1 else kwargs.get("start_dim", 0)
    end = args[2] if len(args) > 2 else kwargs.get("end_dim", -1)
    return _flatten_dims(im.ff, x, start, end, name)


def _h_transpose(im, args, kwargs, name):
    x, d0, d1 = args[0], args[1], args[2]
    if not _is_t(x):
        return np.swapaxes(_np(x), d0, d1)
    perm = list(range(x.ndim))
    perm[d0 % x.ndim], perm[d1 % x.ndim] = perm[d1 % x.ndim], perm[d0 % x.ndim]
    return im.ff.transpose(x, perm, name=name)


def _h_permute(im, args, kwargs, name):
    x = im.as_tensor(args[0])
    perm = args[1] if len(args) == 2 and isinstance(args[1], (list, tuple)) \
        else args[1:]
    return im.ff.transpose(x, tuple(perm), name=name)


def _h_reshape(im, args, kwargs, name):
    x = args[0]
    shape = args[1] if len(args) == 2 and isinstance(args[1], (list, tuple)) \
        else args[1:]
    shape = tuple(int(s) for s in shape)
    if not _is_t(x):
        return _np(x).reshape(shape)
    return im.ff.reshape(x, shape, name=name)


def _h_unsqueeze(im, args, kwargs, name):
    x, dim = args[0], args[1]
    if not _is_t(x):
        return np.expand_dims(_np(x), dim)
    shape = list(x.shape)
    shape.insert(dim % (x.ndim + 1), 1)
    return im.ff.reshape(x, shape, name=name)


def _h_squeeze(im, args, kwargs, name):
    x = args[0]
    dim = args[1] if len(args) > 1 else kwargs.get("dim")
    if not _is_t(x):
        return np.squeeze(_np(x), dim)
    shape = [s for i, s in enumerate(x.shape)
             if not (s == 1 and (dim is None or i == dim % x.ndim))]
    return im.ff.reshape(x, shape, name=name)


def _h_mean(im, args, kwargs, name):
    x = im.as_tensor(args[0])
    dim = args[1] if len(args) > 1 else kwargs.get("dim")
    keep = kwargs.get("keepdim", args[2] if len(args) > 2 else False)
    axes = [dim] if isinstance(dim, int) else list(dim if dim is not None
                                                   else range(x.ndim))
    return im.ff.reduce_mean(x, axes, keepdims=keep, name=name)


def _h_pow(im, args, kwargs, name):
    x, e = args[0], args[1]
    if not _is_t(x):
        return _np(x) ** e
    return im.ff.pow(x, float(e), name=name)


def _h_softmax_f(im, args, kwargs, name):
    x = im.as_tensor(args[0])
    dim = kwargs.get("dim", args[1] if len(args) > 1 else -1)
    return im.ff.softmax(x, axis=dim if dim is not None else -1, name=name)


def _h_dropout_f(im, args, kwargs, name):
    x = im.as_tensor(args[0])
    p = kwargs.get("p", args[1] if len(args) > 1 else 0.5)
    return im.ff.dropout(x, rate=p, name=name)


def _h_sdpa(im, args, kwargs, name):
    q, k, v = (im.as_tensor(a) for a in args[:3])
    mask = kwargs.get("attn_mask", args[3] if len(args) > 3 else None)
    if mask is not None and not _is_t(mask):
        mask = im.ff.constant(_np(mask), name=f"{name}_mask")
    return im.ff.scaled_dot_product_attention(
        q, k, v, attn_mask=mask,
        dropout_p=kwargs.get("dropout_p", 0.0),
        is_causal=kwargs.get("is_causal", False),
        scale=kwargs.get("scale"), name=name)


def _h_where(im, args, kwargs, name):
    """torch.where(cond, a, b): a true SELECT (a blend would let NaN/inf in
    the unselected branch poison the result)."""
    cond = im.as_tensor(args[0])
    a, b = im.as_tensor(args[1]), im.as_tensor(args[2])
    return im.ff.where(cond, a, b, name=name)


def _h_masked_fill(im, args, kwargs, name):
    x, mask, value = args[0], args[1], args[2]
    x = im.as_tensor(x)
    mask = mask if _is_t(mask) else im.ff.constant(_np(mask), name=f"{name}_m")
    return im.ff.masked_fill(x, mask, float(value), name=name)


def _h_expand(im, args, kwargs, name):
    x = args[0]
    sizes = args[1] if len(args) == 2 and isinstance(args[1], (list, tuple)) \
        else args[1:]
    sizes = tuple(int(s) for s in sizes)
    if not _is_t(x):
        v = _np(x)
        shape = [v.shape[i - (len(sizes) - v.ndim)] if s == -1 else s
                 for i, s in enumerate(sizes)]
        return np.broadcast_to(v, shape)
    return im.ff.expand(x, sizes, name=name)


class _DTypeName(str):
    """Marker for dtype names decoded from a .ff file's "$dtype" records —
    distinguishes them from ordinary string args without importing torch."""


def _h_to(im, args, kwargs, name):
    from flexflow_tpu_torch.dtype import DataType as _DT

    x = args[0]
    target = kwargs.get("dtype", args[1] if len(args) > 1 else None)
    dt = None
    if isinstance(target, _DTypeName):
        dt = str(target)
    elif isinstance(target, _DT):
        dt = target.value
    elif target is not None and type(target).__module__.startswith("torch"):
        dt = str(target).replace("torch.", "")
    if dt is None:
        return x  # device / copy moves are no-ops
    if not _is_t(x):
        return _np(x).astype(_TORCH_NP.get(dt, dt))
    return im.ff.cast(x, _DTYPE_ALIAS.get(dt, dt), name=name)


_TORCH_NP = {"float32": np.float32, "float64": np.float32, "float16": np.float16,
             "bfloat16": np.float32, "int64": np.int64, "int32": np.int32,
             "bool": np.bool_, "long": np.int64}
_DTYPE_ALIAS = {"float64": "float32", "long": "int64", "half": "float16"}


def _h_cast_to(dtype):
    def h(im, args, kwargs, name):
        x = args[0]
        if not _is_t(x):
            return _np(x).astype(_TORCH_NP[dtype])
        return im.ff.cast(x, _DTYPE_ALIAS.get(dtype, dtype), name=name)
    return h


def _h_new_tensor(ctor):
    def h(im, args, kwargs, name):
        import torch as _torch

        kwargs = {k: v for k, v in kwargs.items()
                  if k not in ("device", "requires_grad", "pin_memory", "layout")}
        if "dtype" in kwargs:
            kwargs["dtype"] = _as_torch_dtype(kwargs["dtype"])
        return _np(getattr(_torch, ctor)(*args, **kwargs))
    return h


def _unary_h(attr):
    def h(im, args, kwargs, name):
        x = args[0]
        if not _is_t(x):
            return getattr(np, attr if attr != "rsqrt" else "sqrt")(_np(x)) \
                if attr != "rsqrt" else 1.0 / np.sqrt(_np(x))
        return getattr(im.ff, attr)(x, name=name)
    return h


def build_function_handlers() -> Dict[Any, Callable]:
    import torch as _torch
    import torch.nn.functional as F

    h: Dict[Any, Callable] = {
        operator.add: _h_add, _torch.add: _h_add,
        operator.sub: _h_sub, _torch.sub: _h_sub,
        operator.mul: _h_mul, _torch.mul: _h_mul,
        operator.truediv: _h_div, _torch.div: _h_div,
        operator.floordiv: lambda im, a, k, n: a[0] // a[1],
        operator.pow: _h_pow, _torch.pow: _h_pow,
        operator.eq: _h_eq, operator.getitem: _h_getitem,
        operator.neg: lambda im, a, k, n: (
            -a[0] if not _is_t(a[0])
            else im.ff.scalar_multiply(a[0], -1.0, name=n)),
        getattr: lambda im, a, k, n: getattr(a[0], a[1]),
        _torch.matmul: _h_matmul, _torch.bmm: _h_matmul,
        _torch.cat: _h_cat, _torch.split: _h_split, _torch.chunk: _h_chunk,
        _torch.flatten: _h_flatten, _torch.transpose: _h_transpose,
        _torch.permute: _h_permute, _torch.reshape: _h_reshape,
        _torch.unsqueeze: _h_unsqueeze, _torch.squeeze: _h_squeeze,
        _torch.mean: _h_mean, _torch.rsqrt: _unary_h("rsqrt"),
        _torch.tanh: _unary_h("tanh"), _torch.sigmoid: _unary_h("sigmoid"),
        _torch.exp: _unary_h("exp"), _torch.sqrt: _unary_h("sqrt"),
        _torch.relu: _unary_h("relu"),
        _torch.softmax: _h_softmax_f,
        _torch.where: lambda im, a, k, n: im.ff.masked_fill(
            im.as_tensor(a[2]), im.as_tensor(a[0]), float(a[1]))
            if isinstance(a[1], (int, float)) else _h_where(im, a, k, n),
        _torch.finfo: lambda im, a, k, n: _Finfo(*a),
        _torch.tensor: _h_new_tensor("tensor"),
        _torch.ones: _h_new_tensor("ones"), _torch.zeros: _h_new_tensor("zeros"),
        _torch.full: _h_new_tensor("full"), _torch.arange: _h_new_tensor("arange"),
        F.relu: _unary_h("relu"), F.gelu: lambda im, a, k, n: im.ff.gelu(
            im.as_tensor(a[0]), name=n),
        F.silu: _unary_h("silu"), F.sigmoid: _unary_h("sigmoid"),
        F.tanh: _unary_h("tanh"), F.elu: _unary_h("elu"),
        F.softmax: _h_softmax_f, F.log_softmax: lambda im, a, k, n:
            im.ff.log_softmax(im.as_tensor(a[0]),
                              axis=k.get("dim", a[1] if len(a) > 1 else -1), name=n),
        F.dropout: _h_dropout_f,
        F.scaled_dot_product_attention: _h_sdpa,
        math.sqrt: lambda im, a, k, n: math.sqrt(a[0]),
    }
    try:
        h[_torch._C._nn.scaled_dot_product_attention] = _h_sdpa
    except AttributeError:
        pass
    return h


METHOD_HANDLERS: Dict[str, Callable] = {
    "add": _h_add, "sub": _h_sub, "mul": _h_mul, "div": _h_div,
    "pow": _h_pow, "eq": _h_eq, "matmul": _h_matmul, "bmm": _h_matmul,
    "view": _h_reshape, "reshape": _h_reshape, "permute": _h_permute,
    "transpose": _h_transpose, "flatten": _h_flatten,
    "unsqueeze": _h_unsqueeze, "squeeze": _h_squeeze, "expand": _h_expand,
    "split": _h_split, "chunk": _h_chunk, "mean": _h_mean,
    "softmax": _h_softmax_f, "masked_fill": _h_masked_fill,
    "masked_fill_": _h_masked_fill, "to": _h_to,
    "float": _h_cast_to("float32"), "long": _h_cast_to("int64"),
    "int": _h_cast_to("int32"), "bool": _h_cast_to("bool"),
    "half": _h_cast_to("float16"), "rsqrt": _unary_h("rsqrt"),
    "tanh": _unary_h("tanh"), "sigmoid": _unary_h("sigmoid"),
    "exp": _unary_h("exp"), "sqrt": _unary_h("sqrt"),
    "contiguous": lambda im, a, k, n: a[0],
    "clone": lambda im, a, k, n: a[0],
    "detach": lambda im, a, k, n: a[0],
    "type_as": lambda im, a, k, n: a[0],
    "size": lambda im, a, k, n: (tuple(a[0].shape) if len(a) == 1
                                 else a[0].shape[a[1]]),
    "dim": lambda im, a, k, n: a[0].ndim,
    "numel": lambda im, a, k, n: int(np.prod(a[0].shape)),
    "t": lambda im, a, k, n: _h_transpose(im, (a[0], 0, 1), {}, n),
    "expand_as": lambda im, a, k, n: _h_expand(
        im, (a[0], tuple(a[1].shape)), {}, n),
}


# ---------------------------------------------------------------------------
# the importer
# ---------------------------------------------------------------------------


class _Importer:
    """Walks a serialized node list, emitting FFModel ops."""

    def __init__(self, ffmodel, input_tensors: List[Tensor], verbose=False):
        from flexflow_tpu_torch.ops.op_type import OperatorType

        self.ff = ffmodel
        self.ff_optype = OperatorType
        self.inputs = list(input_tensors)
        self.env: Dict[str, Any] = {}
        self.outputs: List[Tensor] = []
        self.verbose = verbose
        self.layer_to_module: Dict[str, str] = {}  # ff layer name -> module path
        self._input_idx = 0
        self._fn_handlers = None

    def as_tensor(self, v) -> Tensor:
        if _is_t(v):
            return v
        return self.ff.constant(_np(v))

    def resolve(self, a):
        if isinstance(a, dict) and "$ref" in a:
            return self.env[a["$ref"]]
        if isinstance(a, dict) and "$nd" in a:
            return np.asarray(a["$nd"], dtype=a["$dt"])
        if isinstance(a, list):
            return [self.resolve(x) for x in a]
        if isinstance(a, tuple):
            return tuple(self.resolve(x) for x in a)
        if isinstance(a, dict) and "$slice" in a:
            lo, hi, st = (self.resolve(x) for x in a["$slice"])
            as_int = lambda v: int(v) if v is not None else None  # noqa: E731
            return slice(as_int(lo), as_int(hi), as_int(st))
        if isinstance(a, dict) and "$ellipsis" in a:
            return Ellipsis
        if isinstance(a, dict) and "$dtype" in a:
            # dtype-name marker string: keeps .ff replay torch-free
            # (_h_to recognizes _DTypeName unambiguously)
            return _DTypeName(a["$dtype"])
        if isinstance(a, dict) and "$dict" in a:
            return {k: self.resolve(v) for k, v in a["$dict"].items()}
        return a

    def run_node(self, rec: Dict[str, Any]):
        op, name = rec["op"], rec["name"]
        args = self.resolve(rec.get("args", []))
        kwargs = {k: self.resolve(v) for k, v in rec.get("kwargs", {}).items()}
        if self.verbose:
            print(json.dumps({k: v for k, v in rec.items() if k != "args"}))
        if op == "placeholder":
            if self._input_idx >= len(self.inputs):
                if rec.get("has_default"):
                    self.env[name] = self.resolve(rec["default"])
                    return
                raise ValueError(f"not enough input tensors for {name}")
            self.env[name] = self.inputs[self._input_idx]
            self._input_idx += 1
            return
        if op == "get_attr":
            self.env[name] = np.asarray(rec["value"], dtype=rec["vdtype"])
            return
        if op == "call_module":
            spec = rec["module"]
            handler = MODULE_HANDLERS[spec["cls"]]
            if spec["cls"] == "MultiheadAttention":
                out = handler(self, spec, args, kwargs, name)
            else:
                out = handler(self, spec, args, name)
            if _is_t(out) or (isinstance(out, tuple) and any(_is_t(o) for o in out)):
                self.layer_to_module[name] = rec["target"]
            self.env[name] = out
            return
        if op == "call_function":
            if self._fn_handlers is None:
                self._fn_handlers = build_function_handlers()
            target = _decode_callable(rec["target"])
            if target not in self._fn_handlers:
                raise NotImplementedError(f"call_function {rec['target']}")
            self.env[name] = self._fn_handlers[target](self, args, kwargs, name)
            return
        if op == "call_method":
            meth = rec["target"]
            if meth not in METHOD_HANDLERS:
                raise NotImplementedError(f"call_method {meth}")
            self.env[name] = METHOD_HANDLERS[meth](self, args, kwargs, name)
            return
        if op == "output":
            self._collect_outputs(args[0])
            return
        raise NotImplementedError(f"fx op {op}")

    def _collect_outputs(self, v):
        if _is_t(v):
            self.outputs.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                self._collect_outputs(x)
        elif isinstance(v, dict):
            for x in v.values():
                self._collect_outputs(x)


# -------------------------------------------------------------- serialization


def _encode_callable(fn) -> str:
    import importlib

    # normalize to a public module path (torch.relu's __qualname__ is a
    # private class attr that does not round-trip)
    name = getattr(fn, "__name__", None)
    if name:
        for modname in ("operator", "torch", "torch.nn.functional", "math",
                        "builtins"):
            try:
                mod = importlib.import_module(modname)
            except ImportError:
                continue
            if getattr(mod, name, None) is fn:
                return f"{modname}:{name}"
    mod = getattr(fn, "__module__", None) or "builtins"
    qual = getattr(fn, "__qualname__", None) or name or str(fn)
    return f"{mod}:{qual}"


_CALLABLE_CACHE: Dict[str, Any] = {}


def _decode_callable(s: str):
    if s in _CALLABLE_CACHE:
        return _CALLABLE_CACHE[s]
    import importlib

    mod, qual = s.split(":", 1)
    if mod == "_operator":
        mod = "operator"
    try:
        obj = importlib.import_module(mod)
    except ImportError:
        obj = importlib.import_module("builtins")
    for part in qual.split("."):
        obj = getattr(obj, part)
    _CALLABLE_CACHE[s] = obj
    return obj


def _encode_arg(a, node_names):
    import torch as _torch
    import torch.fx as fx

    if isinstance(a, fx.Node):
        return {"$ref": a.name}
    if isinstance(a, (list, tuple)):
        return [_encode_arg(x, node_names) for x in a]
    if isinstance(a, slice):
        return {"$slice": [_encode_arg(a.start, node_names),
                           _encode_arg(a.stop, node_names),
                           _encode_arg(a.step, node_names)]}
    if a is Ellipsis:
        return {"$ellipsis": True}
    if isinstance(a, _torch.dtype):
        return {"$dtype": str(a).replace("torch.", "")}
    if isinstance(a, _torch.Tensor):
        v = a.detach().cpu().numpy()
        return {"$nd": v.tolist(), "$dt": str(v.dtype)}
    if isinstance(a, (int, float, bool, str)) or a is None:
        return a
    if isinstance(a, dict):
        return {"$dict": {str(k): _encode_arg(v, node_names)
                          for k, v in a.items()}}
    raise NotImplementedError(f"cannot serialize arg {a!r}")


class PyTorchModel:
    """FlexFlow's PyTorchModel (python/flexflow/torch/model.py): trace a
    torch module with torch.fx (or HF transformers.utils.fx for HF models)
    and emit the graph onto an FFModel."""

    def __init__(self, model, is_hf_model: bool = False,
                 input_names: Optional[List[str]] = None,
                 batch_size: int = 1, seq_length: Optional[int] = None):
        self.model = model
        self.is_hf_model = is_hf_model
        self.input_names = input_names
        self.batch_size = batch_size
        self.seq_length = seq_length
        self._records: Optional[List[Dict[str, Any]]] = None

    # ------------------------------------------------------------- tracing
    def _trace_model(self):
        import torch.fx as fx

        if self.is_hf_model:
            try:
                from transformers.utils import fx as hf_fx
            except ImportError as e:
                raise ImportError("is_hf_model=True traces with the "
                                  "transformers package, which is not "
                                  "installed") from e

            kw = {"input_names": self.input_names}
            traced = hf_fx.symbolic_trace(self.model, **kw)
        else:
            traced = fx.symbolic_trace(self.model)
        return traced

    def _to_records(self) -> List[Dict[str, Any]]:
        """Reduce the fx graph to torch-free JSON records (the IR)."""
        if self._records is not None:
            return self._records
        traced = self._trace_model()
        name_to_module = dict(self.model.named_modules())
        recs = []
        for node in traced.graph.nodes:
            rec: Dict[str, Any] = {"op": node.op, "name": node.name}
            if node.op == "placeholder":
                rec["target"] = str(node.target)
                if node.args:  # default value (optional input)
                    rec["has_default"] = True
                    rec["default"] = _encode_arg(node.args[0], None)
            elif node.op == "get_attr":
                obj = self.model
                for part in str(node.target).split("."):
                    obj = getattr(obj, part)
                v = obj.detach().cpu().numpy()
                rec.update(target=str(node.target), value=v.tolist(),
                           vdtype=str(v.dtype))
            elif node.op == "call_module":
                module = name_to_module[str(node.target)]
                rec.update(target=str(node.target),
                           module=module_to_spec(module),
                           args=_encode_arg(list(node.args), None),
                           kwargs={k: _encode_arg(v, None)
                                   for k, v in node.kwargs.items()})
            elif node.op == "call_function":
                rec.update(target=_encode_callable(node.target),
                           args=_encode_arg(list(node.args), None),
                           kwargs={k: _encode_arg(v, None)
                                   for k, v in node.kwargs.items()})
            elif node.op == "call_method":
                rec.update(target=str(node.target),
                           args=_encode_arg(list(node.args), None),
                           kwargs={k: _encode_arg(v, None)
                                   for k, v in node.kwargs.items()})
            elif node.op == "output":
                rec["args"] = _encode_arg(list(node.args), None)
            recs.append(rec)
        self._records = recs
        return recs

    # ------------------------------------------------------------- emission
    def torch_to_ff(self, ffmodel, input_tensors: List[Tensor],
                    verbose: bool = False) -> List[Tensor]:
        im = _Importer(ffmodel, input_tensors, verbose=verbose)
        for rec in self._to_records():
            im.run_node(rec)
        self.layer_to_module = im.layer_to_module
        return im.outputs

    # --------------------------------------------------------- .ff file flow
    def torch_to_string(self) -> List[str]:
        return [json.dumps(rec) for rec in self._to_records()]

    def torch_to_file(self, filename: str) -> None:
        with open(filename, "w") as f:
            for line in self.torch_to_string():
                f.write(line + "\n")

    @staticmethod
    def file_to_ff(filename: str, ffmodel, input_tensors: List[Tensor],
                   verbose: bool = False) -> List[Tensor]:
        im = _Importer(ffmodel, input_tensors, verbose=verbose)
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if line:
                    im.run_node(json.loads(line))
        return im.outputs

    # ------------------------------------------------------- weight transfer
    def import_weights(self, compiled) -> None:
        """Copy the module's weights into a CompiledModel, so that the
        imported graph computes what the module does. Each is copied as a
        tensor to the compiled model's device and dtype (`set_weight`),
        never through the host; batch norm's running mean and variance go
        into `compiled.state` as f32 tensors on that device."""
        import torch as _torch
        import torch.nn as nn

        try:
            from transformers.pytorch_utils import Conv1D as HFConv1D
        except Exception:
            HFConv1D = ()
        name_to_module = dict(self.model.named_modules())
        for lname, target in self.layer_to_module.items():
            m = name_to_module[target]
            if lname not in compiled.params:
                continue  # weight-free layers (dropout, softmax, ...)

            def put(wname, t):
                compiled.set_weight(lname, wname, t.detach())

            if isinstance(m, nn.Linear):
                put("kernel", m.weight.T)
                if m.bias is not None:
                    put("bias", m.bias)
            elif HFConv1D and isinstance(m, HFConv1D):
                put("kernel", m.weight)
                put("bias", m.bias)
            elif isinstance(m, nn.Conv2d):
                put("kernel", m.weight)
                if m.bias is not None:
                    put("bias", m.bias)
            elif isinstance(m, nn.Embedding):
                put("kernel", m.weight)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                if m.weight is not None:
                    put("gamma", m.weight)
                    put("beta", m.bias if m.bias is not None
                        else _torch.zeros_like(m.weight))
                if isinstance(m, nn.BatchNorm2d):
                    for key, t in (("mean", m.running_mean),
                                   ("var", m.running_var)):
                        compiled.state[f"{lname}/{key}"] = t.detach().to(
                            compiled.device, _torch.float32).clone()
            elif isinstance(m, nn.MultiheadAttention):
                e = m.embed_dim
                if m.in_proj_weight is not None:
                    w = m.in_proj_weight
                    parts = {"wq": w[:e].T, "wk": w[e:2 * e].T,
                             "wv": w[2 * e:].T}
                else:
                    parts = {"wq": m.q_proj_weight.T,
                             "wk": m.k_proj_weight.T,
                             "wv": m.v_proj_weight.T}
                for k, v in parts.items():
                    put(k, v)
                put("wo", m.out_proj.weight.T)
                if m.in_proj_bias is not None:
                    b = m.in_proj_bias
                    put("bq", b[:e])
                    put("bk", b[e:2 * e])
                    put("bv", b[2 * e:])
                    put("bo", m.out_proj.bias)


def torch_to_flexflow(model, filename: str, **kw) -> None:
    """Trace `model` and write the serialized graph to `filename`
    (FlexFlow's fx.torch_to_flexflow flow)."""
    PyTorchModel(model, **kw).torch_to_file(filename)


file_to_ff = PyTorchModel.file_to_ff
