"""Keras-compatible layer classes (counterpart: flexflow_tpu/keras/layers.py).

Layers are symbolic records: calling one on a KTensor adds an edge to a
lazy graph, and the whole graph is emitted onto an FFModel in one pass at
the first fit, evaluate or predict (`to_ff`), where the op library infers
the shapes.
"""

from __future__ import annotations

import itertools
from typing import Any, List, Optional, Sequence, Tuple

_uid = itertools.count()


class KTensor:
    """Symbolic tensor: either a graph input (shape sans batch) or the output
    of a layer call."""

    def __init__(self, shape: Tuple[int, ...], dtype: str = "float32",
                 layer: Optional["Layer"] = None, idx: int = 0,
                 inputs: Optional[List["KTensor"]] = None, name: str = ""):
        self.shape = tuple(shape)  # WITHOUT the batch dim for inputs
        self.dtype = dtype
        self.layer = layer
        self.idx = idx
        self.inputs = inputs or []
        self.name = name or f"kt_{next(_uid)}"

    def __repr__(self):
        return f"KTensor({self.name}, {self.shape})"


def Input(shape: Sequence[int], dtype: str = "float32", name: str = "") -> KTensor:
    """Reference: python/flexflow/keras/layers/input_layer.py."""
    return KTensor(tuple(shape), dtype=dtype, name=name or f"input_{next(_uid)}")


class Layer:
    def __init__(self, name: Optional[str] = None, input_shape=None, **kw):
        cls = type(self).__name__.lower()
        self.name = name or f"{cls}_{next(_uid)}"
        # Sequential reads the first layer's declared input shape
        self._declared_input_shape = tuple(input_shape) if input_shape else None

    def __call__(self, inputs):
        ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        outs = [KTensor((), layer=self, idx=i, inputs=ins,
                        name=f"{self.name}:{i}")
                for i in range(self.num_outputs)]
        return outs[0] if self.num_outputs == 1 else outs

    num_outputs = 1

    def to_ff(self, ff, ins):
        """Emit onto the FFModel; returns list of flexflow Tensors."""
        raise NotImplementedError


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_padding(padding, kernel):
    if isinstance(padding, (tuple, list)):
        return _pair(padding)
    if padding == "valid":
        return (0, 0)
    if padding == "same":
        kh, kw = kernel
        if kh % 2 == 0 or kw % 2 == 0:
            raise NotImplementedError("'same' padding needs odd kernel sizes")
        return ((kh - 1) // 2, (kw - 1) // 2)
    raise ValueError(f"padding {padding!r}")


def _apply_regularizers(ff, out_tensor, kernel_reg, bias_reg):
    """Register this layer's L1/L2 penalties on the built FFModel (they
    become differentiated loss terms, see keras/regularizers.py)."""
    from flexflow_tpu_torch.keras import regularizers as kreg

    lname = out_tensor.owner.name
    for wname, reg in (("kernel", kernel_reg), ("bias", bias_reg)):
        reg = kreg.get(reg)
        if reg is None:
            continue
        for mode, coeff in reg.terms():
            ff.add_weight_regularizer(lname, wname, mode, coeff)


class Dense(Layer):
    def __init__(self, units, activation=None, use_bias=True,
                 kernel_initializer=None, bias_initializer=None,
                 kernel_regularizer=None, bias_regularizer=None, **kw):
        super().__init__(**kw)
        self.units = int(units)
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.kernel_regularizer = kernel_regularizer
        self.bias_regularizer = bias_regularizer

    def to_ff(self, ff, ins):
        out = ff.dense(ins[0], self.units, activation=self.activation,
                       use_bias=self.use_bias, name=self.name)
        _apply_regularizers(ff, out, self.kernel_regularizer,
                            self.bias_regularizer if self.use_bias else None)
        return [out]


class Conv2D(Layer):
    def __init__(self, filters, kernel_size, strides=(1, 1), padding="valid",
                 activation=None, groups=1, use_bias=True,
                 kernel_initializer=None, bias_initializer=None,
                 kernel_regularizer=None, bias_regularizer=None, **kw):
        super().__init__(**kw)
        self.filters = int(filters)
        self.kernel = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = _conv_padding(padding, self.kernel)
        self.activation = activation
        self.groups = groups
        self.use_bias = use_bias
        self.kernel_regularizer = kernel_regularizer
        self.bias_regularizer = bias_regularizer

    def to_ff(self, ff, ins):
        kh, kw = self.kernel
        sh, sw = self.strides
        ph, pw = self.padding
        out = ff.conv2d(ins[0], self.filters, kh, kw, sh, sw, ph, pw,
                        activation=self.activation, groups=self.groups,
                        use_bias=self.use_bias, name=self.name)
        _apply_regularizers(ff, out, self.kernel_regularizer,
                            self.bias_regularizer if self.use_bias else None)
        return [out]


class _Pool2D(Layer):
    pool_type = "max"

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid", **kw):
        super().__init__(**kw)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool_size
        self.padding = _conv_padding(padding, self.pool_size)

    def to_ff(self, ff, ins):
        kh, kw = self.pool_size
        sh, sw = self.strides
        ph, pw = self.padding
        return [ff.pool2d(ins[0], kh, kw, sh, sw, ph, pw,
                          pool_type=self.pool_type, name=self.name)]


class MaxPooling2D(_Pool2D):
    pool_type = "max"


class AveragePooling2D(_Pool2D):
    pool_type = "avg"


class Flatten(Layer):
    def __init__(self, data_format=None, **kw):
        super().__init__(**kw)

    def to_ff(self, ff, ins):
        return [ff.flat(ins[0], name=self.name)]


class Activation(Layer):
    def __init__(self, activation, **kw):
        super().__init__(**kw)
        self.activation = activation

    def to_ff(self, ff, ins):
        a = self.activation
        if a == "softmax":
            return [ff.softmax(ins[0], name=self.name)]
        return [getattr(ff, a)(ins[0], name=self.name)]


class Dropout(Layer):
    def __init__(self, rate, noise_shape=None, seed=0, **kw):
        super().__init__(**kw)
        self.rate = rate
        self.seed = seed

    def to_ff(self, ff, ins):
        return [ff.dropout(ins[0], rate=self.rate, seed=self.seed, name=self.name)]


class Embedding(Layer):
    def __init__(self, input_dim, output_dim, input_length=None, **kw):
        super().__init__(**kw)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)

    def to_ff(self, ff, ins):
        return [ff.embedding(ins[0], self.input_dim, self.output_dim,
                             name=self.name)]


class Reshape(Layer):
    def __init__(self, target_shape, **kw):
        super().__init__(**kw)
        self.target_shape = tuple(target_shape)

    def to_ff(self, ff, ins):
        batch = ins[0].shape[0]
        return [ff.reshape(ins[0], (batch,) + self.target_shape, name=self.name)]


class Permute(Layer):
    def __init__(self, dims, **kw):
        super().__init__(**kw)
        self.dims = tuple(dims)  # keras: 1-based, excludes batch

    def to_ff(self, ff, ins):
        perm = (0,) + tuple(d for d in self.dims)
        return [ff.transpose(ins[0], perm, name=self.name)]


class BatchNormalization(Layer):
    def __init__(self, axis=1, momentum=0.99, epsilon=1e-3, **kw):
        super().__init__(**kw)
        if axis not in (1, -3):
            raise NotImplementedError("BatchNormalization supports channel axis 1 (NCHW)")
        self.momentum = momentum
        self.epsilon = epsilon

    def to_ff(self, ff, ins):
        return [ff.batch_norm(ins[0], relu=False, momentum=self.momentum,
                              eps=self.epsilon, name=self.name)]


class LayerNormalization(Layer):
    def __init__(self, axis=-1, epsilon=1e-3, **kw):
        super().__init__(**kw)
        self.axis = axis if isinstance(axis, (list, tuple)) else [axis]
        self.epsilon = epsilon

    def to_ff(self, ff, ins):
        return [ff.layer_norm(ins[0], axes=list(self.axis), eps=self.epsilon,
                              name=self.name)]


class _Merge(Layer):
    op = "add"

    def to_ff(self, ff, ins):
        out = ins[0]
        for other in ins[1:]:
            out = getattr(ff, self.op)(out, other, name=f"{self.name}")
        return [out]


class Add(_Merge):
    op = "add"


class Subtract(_Merge):
    op = "subtract"


class Multiply(_Merge):
    op = "multiply"


class Maximum(_Merge):
    op = "max"


class Minimum(_Merge):
    op = "min"


class Concatenate(Layer):
    def __init__(self, axis=-1, **kw):
        super().__init__(**kw)
        self.axis = axis

    def to_ff(self, ff, ins):
        return [ff.concat(ins, axis=self.axis, name=self.name)]


class MultiHeadAttention(Layer):
    """Functional-API attention (an extension over FlexFlow's layer set:
    FlexFlow exposes attention only through the native API)."""

    def __init__(self, num_heads, key_dim, dropout=0.0, use_bias=True, **kw):
        super().__init__(**kw)
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.dropout = dropout
        self.use_bias = use_bias

    def __call__(self, query, value, key=None):
        ins = [query, value, key if key is not None else value]
        return KTensor((), layer=self, idx=0, inputs=ins, name=f"{self.name}:0")

    def to_ff(self, ff, ins):
        embed = self.num_heads * self.key_dim
        return [ff.multihead_attention(ins[0], ins[2], ins[1], embed,
                                       self.num_heads, dropout=self.dropout,
                                       bias=self.use_bias, name=self.name)]


# functional-style merge helpers (FlexFlow's merge.py exports both forms)
def concatenate(tensors, axis=-1, name=None):
    return Concatenate(axis=axis, name=name)(tensors)


def add(tensors, name=None):
    return Add(name=name)(tensors)


def subtract(tensors, name=None):
    return Subtract(name=name)(tensors)


def multiply(tensors, name=None):
    return Multiply(name=name)(tensors)


def maximum(tensors, name=None):
    return Maximum(name=name)(tensors)


def minimum(tensors, name=None):
    return Minimum(name=name)(tensors)
