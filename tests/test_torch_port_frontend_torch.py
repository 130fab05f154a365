"""The torch.fx frontend of the port (flexflow_tpu_torch/torch/) against
the JAX package's (flexflow_tpu/torch/) on the CPU, on the small CNN of
tests/test_torch_frontend.py and a 2-layer BERT-style module (token and
position embeddings, nn.MultiheadAttention(batch_first=True) without
masks, nn.LayerNorm, nn.Linear, nn.GELU, an MLM head; width 32):

- `torch_to_string()` gives the same lines in both packages, and a `.ff`
  file written by either replays in the other to the same layer list;
- after `import_weights` the port's forward matches the module's own
  (f32; 1e-5 on the CNN; 5e-4 on the BERT-style module, whose nn.GELU is
  the erf form while both packages' gelu op is the tanh form, as the JAX
  importer has it) and the JAX package's (1e-5 relative);
- `import_weights` copies tensors, never through `.numpy()`, and puts
  batch norm's running stats into `state` as tensors;
- the HF path raises when `transformers` is missing, and matches JAX on
  HF's BERT of width 32 where it is installed.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn as nn

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.torch import PyTorchModel as JPyTorchModel
from flexflow_tpu.torch import file_to_ff as jfile_to_ff
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.torch import (PyTorchModel, file_to_ff,
                                      torch_to_flexflow)

B, S, D, H, FFN, VOCAB = 4, 16, 32, 4, 64, 128


class SmallCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(3, 8, 3, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.p = nn.MaxPool2d(2, 2)
        self.fl = nn.Flatten()
        self.fc1 = nn.Linear(8 * 8 * 8, 32)
        self.fc2 = nn.Linear(32, 10)

    def forward(self, x):
        x = self.p(torch.relu(self.bn(self.c1(x))))
        x = self.fl(x)
        return self.fc2(torch.relu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, d, heads, ffn):
        super().__init__()
        self.attn = nn.MultiheadAttention(d, heads, batch_first=True)
        self.ln1 = nn.LayerNorm(d)
        self.up = nn.Linear(d, ffn)
        self.act = nn.GELU()
        self.down = nn.Linear(ffn, d)
        self.ln2 = nn.LayerNorm(d)

    def forward(self, h):
        a, _ = self.attn(h, h, h, need_weights=False)
        h = self.ln1(h + a)
        return self.ln2(h + self.down(self.act(self.up(h))))


class BertStyle(nn.Module):
    def __init__(self, vocab=VOCAB, d=D, heads=H, ffn=FFN, layers=2,
                 max_pos=S):
        super().__init__()
        self.tok = nn.Embedding(vocab, d)
        self.pos = nn.Embedding(max_pos, d)
        self.ln = nn.LayerNorm(d)
        self.blocks = nn.ModuleList(Block(d, heads, ffn)
                                    for _ in range(layers))
        self.mlm_dense = nn.Linear(d, d)
        self.mlm_act = nn.GELU()
        self.mlm_ln = nn.LayerNorm(d)
        self.mlm_out = nn.Linear(d, vocab)

    def forward(self, ids, pos):
        h = self.ln(self.tok(ids) + self.pos(pos))
        for blk in self.blocks:
            h = blk(h)
        return self.mlm_out(self.mlm_ln(self.mlm_act(self.mlm_dense(h))))


def _module(which):
    torch.manual_seed(0)
    m = SmallCNN() if which == "cnn" else BertStyle()
    if which == "cnn":
        with torch.no_grad():
            m.bn.running_mean.uniform_(-0.5, 0.5)
            m.bn.running_var.uniform_(0.5, 2.0)
    return m.eval()


def _inputs(which):
    rng = np.random.default_rng(1)
    if which == "cnn":
        return [rng.normal(size=(B, 3, 16, 16)).astype(np.float32)]
    return [rng.integers(0, VOCAB, size=(B, S)).astype(np.int32),
            np.tile(np.arange(S, dtype=np.int32), (B, 1))]


def _graph_inputs(ff, which):
    if which == "cnn":
        return [ff.create_tensor([B, 3, 16, 16], name="x")]
    return [ff.create_tensor([B, S], "int32", name="ids"),
            ff.create_tensor([B, S], "int32", name="pos")]


def _layers(ff):
    return [(l.name, l.op_type.value, [tuple(t.shape) for t in l.outputs])
            for l in ff.layers]


def _port(which, pm=None, path=None):
    ff = FFModel(FFConfig(batch_size=B))
    ins = _graph_inputs(ff, which)
    outs = file_to_ff(path, ff, ins) if path else pm.torch_to_ff(ff, ins)
    cm = ff.compile(SGDOptimizer(), "sparse_categorical_crossentropy", [],
                    outputs=outs[:1], device="cpu")
    cm.init(seed=0)
    return ff, cm


def _jax(which, pm=None, path=None):
    ff = JFFModel(JFFConfig(batch_size=B, mesh_shape={"data": 1},
                            log_level="warning"))
    ins = _graph_inputs(ff, which)
    outs = jfile_to_ff(path, ff, ins) if path else pm.torch_to_ff(ff, ins)
    cm = ff.compile(JSGDOptimizer(), "sparse_categorical_crossentropy", [],
                    outputs=outs[:1])
    cm.init(seed=0)
    return ff, cm


@pytest.mark.parametrize("which", ["cnn", "bert"])
def test_to_string_lines_equal_jax(which):
    m = _module(which)
    got = PyTorchModel(m).torch_to_string()
    assert got == JPyTorchModel(m).torch_to_string()
    assert [json.loads(x)["op"] for x in got][0] == "placeholder"


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("which", ["cnn", "bert"])
def test_ff_file_replays_in_the_other_package(tmp_path, which, writer):
    m = _module(which)
    path = str(tmp_path / "net.ff")
    if writer == "jax":
        JPyTorchModel(m).torch_to_file(path)
    else:
        torch_to_flexflow(m, path)
    pff, _ = _port(which, path=path)
    jff, _ = _jax(which, path=path)
    assert _layers(pff) == _layers(jff)
    ops = [l[1] for l in _layers(pff)]
    if which == "bert":
        assert ops[:5] == ["embedding", "embedding", "add", "layer_norm",
                           "multihead_attention"]


@pytest.mark.parametrize("which", ["cnn", "bert"])
def test_forward_matches_module_and_jax(which):
    m = _module(which)
    ppm, jpm = PyTorchModel(m), JPyTorchModel(m)
    pff, pcm = _port(which, ppm)
    jff, jcm = _jax(which, jpm)
    ppm.import_weights(pcm)
    jpm.import_weights(jcm)
    xs = _inputs(which)
    got = pcm.forward(*xs).numpy()
    want = np.asarray(jcm.forward(*xs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        ref = m(*[torch.from_numpy(x).long() if x.dtype == np.int32
                  else torch.from_numpy(x) for x in xs]).numpy()
    tol = 1e-5 if which == "cnn" else 5e-4
    assert np.abs(got - ref).max() < tol


def test_import_weights_copies_tensors_not_through_numpy(monkeypatch):
    """A module on any device imports: no parameter goes through
    `.numpy()`; batch norm's running stats land in `state` as f32
    tensors equal to the module's."""
    m = _module("cnn")
    pm = PyTorchModel(m)
    _, cm = _port("cnn", pm)

    def no_numpy(self, *a, **k):
        raise AssertionError("import_weights went through .numpy()")
    monkeypatch.setattr(torch.Tensor, "numpy", no_numpy)
    pm.import_weights(cm)
    monkeypatch.undo()
    bn = next(n for n, t in pm.layer_to_module.items() if t == "bn")
    for key, t in (("mean", m.bn.running_mean), ("var", m.bn.running_var)):
        got = cm.state[f"{bn}/{key}"]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert torch.equal(got, t)
    fc1 = next(n for n, t in pm.layer_to_module.items() if t == "fc1")
    assert torch.equal(cm.params[fc1]["kernel"], m.fc1.weight.T)
    assert cm.params[fc1]["kernel"].requires_grad


def test_hf_path_raises_without_transformers(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "transformers.utils", None)
    pm = PyTorchModel(_module("cnn"), is_hf_model=True, input_names=["x"])
    ff = FFModel(FFConfig(batch_size=B))
    with pytest.raises(ImportError, match="transformers"):
        pm.torch_to_ff(ff, _graph_inputs(ff, "cnn"))


def test_hf_bert_matches_jax():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    bert = transformers.BertForMaskedLM(cfg).eval()
    names = ["input_ids", "attention_mask"]
    outs = {}
    for pkg, (mcls, ccls, pcls, kw) in {
            "port": (FFModel, FFConfig, PyTorchModel, {"device": "cpu"}),
            "jax": (JFFModel, JFFConfig, JPyTorchModel, {})}.items():
        extra = {} if pkg == "port" else {"mesh_shape": {"data": 1}}
        ff = mcls(ccls(batch_size=4, **extra))
        ins = [ff.create_tensor([4, 16], "int32", name=n) for n in names]
        pm = pcls(bert, is_hf_model=True, input_names=names)
        o = pm.torch_to_ff(ff, ins)
        cm = ff.compile(None, "sparse_categorical_crossentropy", [],
                        outputs=o[:1], **kw)
        cm.init(seed=0)
        pm.import_weights(cm)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, 128, size=(4, 16)).astype(np.int32)
        mask = np.ones((4, 16), np.int32)
        mask[:, 12:] = 0
        outs[pkg] = np.asarray(cm.forward(ids, mask))
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-5,
                               atol=1e-5)
