"""CANDLE Uno, drug-response regression (counterpart:
flexflow_tpu/models/candle_uno.py; an OSDI'22 Unity benchmark).

One input a feature (`INPUT_FEATURES`, widths by feature type in
`FEATURE_SHAPES`); each input wider than 1 runs its own tower of relu
dense layers (the dose inputs skip it); the towers are concatenated and
fed to a top MLP ending in one regression output."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from flexflow_tpu_torch.core.model import FFModel

# reference defaults (candle_uno.cc CandleConfig)
FEATURE_SHAPES: Dict[str, int] = {
    "dose": 1,
    "cell.rnaseq": 942,
    "drug.descriptors": 5270,
    "drug.fingerprints": 2048,
}
INPUT_FEATURES: Dict[str, str] = {
    "dose1": "dose",
    "dose2": "dose",
    "cell.rnaseq": "cell.rnaseq",
    "drug1.descriptors": "drug.descriptors",
    "drug1.fingerprints": "drug.fingerprints",
    "drug2.descriptors": "drug.descriptors",
    "drug2.fingerprints": "drug.fingerprints",
}


def build_candle_uno(model: FFModel, batch: int = 64,
                     dense_layers: Sequence[int] = (4192,) * 4,
                     dense_feature_layers: Sequence[int] = (4192,) * 8,
                     feature_shapes: Dict[str, int] = None,
                     input_features: Dict[str, str] = None) -> Tuple[List, object]:
    feature_shapes = feature_shapes or FEATURE_SHAPES
    input_features = input_features or INPUT_FEATURES
    inputs = []
    towers: List = []
    for name, ftype in input_features.items():
        safe = name.replace(".", "_")
        x = model.create_tensor([batch, feature_shapes[ftype]],
                                name=f"in_{safe}")
        inputs.append(x)
        t = x
        if feature_shapes[ftype] > 1:  # dose skips the feature tower (ref)
            for li, h in enumerate(dense_feature_layers):
                t = model.dense(t, h, activation="relu",
                                name=f"tower_{safe}_{li}")
        towers.append(t)
    t = model.concat(towers, axis=-1, name="concat_features")
    for li, h in enumerate(dense_layers):
        t = model.dense(t, h, activation="relu", name=f"top_{li}")
    out = model.dense(t, 1, name="uno_out")
    return inputs, out
