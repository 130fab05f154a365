"""A minimal ONNX protobuf reader and writer, with no onnx package
(counterpart: flexflow_tpu/onnx/proto.py, the port's own copy).

ONNX files are protobuf. This module decodes the subset of messages the
importer needs straight from the wire format (varint, 32-bit, 64-bit and
length-delimited records), driven by schema tables transcribed from the
public field numbering of onnx/onnx.proto, and encodes `{field: value}`
dicts back into wire bytes (the tests and the GPU smoke write their
graphs with it).

Decoded messages are plain `Msg` namespace objects: scalar fields appear
once, repeated fields are lists, and missing fields take the schema's
defaults.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple


class Msg:
    """Decoded protobuf message: attribute access, dict-backed."""

    def __init__(self, fields: Dict[str, Any]):
        self.__dict__.update(fields)

    def __repr__(self):
        return f"Msg({self.__dict__})"


# kinds: "varint" (int), "svarint", "f32", "f64", "bytes", "str",
# ("msg", SCHEMA). Prefix "rep_" = repeated (numeric repeats accept both
# packed and unpacked encodings).
TENSOR_SHAPE_DIM = {1: ("dim_value", "varint"), 2: ("dim_param", "str")}
TENSOR_SHAPE = {1: ("dim", ("rep_msg", TENSOR_SHAPE_DIM))}
TENSOR_TYPE = {1: ("elem_type", "varint"), 2: ("shape", ("msg", TENSOR_SHAPE))}
TYPE_PROTO = {1: ("tensor_type", ("msg", TENSOR_TYPE))}
VALUE_INFO = {1: ("name", "str"), 2: ("type", ("msg", TYPE_PROTO))}
TENSOR_PROTO = {
    1: ("dims", "rep_varint"),
    2: ("data_type", "varint"),
    4: ("float_data", "rep_f32"),
    5: ("int32_data", "rep_varint"),
    6: ("string_data", "rep_bytes"),
    7: ("int64_data", "rep_varint"),
    8: ("name", "str"),
    9: ("raw_data", "bytes"),
    10: ("double_data", "rep_f64"),
    11: ("uint64_data", "rep_varint"),
}
ATTRIBUTE_PROTO = {
    1: ("name", "str"),
    2: ("f", "f32"),
    3: ("i", "varint"),
    4: ("s", "bytes"),
    5: ("t", ("msg", TENSOR_PROTO)),
    7: ("floats", "rep_f32"),
    8: ("ints", "rep_varint"),
    9: ("strings", "rep_bytes"),
    10: ("tensors", ("rep_msg", TENSOR_PROTO)),
    20: ("type", "varint"),
}
NODE_PROTO = {
    1: ("input", "rep_str"),
    2: ("output", "rep_str"),
    3: ("name", "str"),
    4: ("op_type", "str"),
    5: ("attribute", ("rep_msg", ATTRIBUTE_PROTO)),
    7: ("domain", "str"),
}
GRAPH_PROTO = {
    1: ("node", ("rep_msg", NODE_PROTO)),
    2: ("name", "str"),
    5: ("initializer", ("rep_msg", TENSOR_PROTO)),
    11: ("input", ("rep_msg", VALUE_INFO)),
    12: ("output", ("rep_msg", VALUE_INFO)),
    13: ("value_info", ("rep_msg", VALUE_INFO)),
}
OPERATOR_SET_ID = {1: ("domain", "str"), 2: ("version", "varint")}
MODEL_PROTO = {
    1: ("ir_version", "varint"),
    2: ("producer_name", "str"),
    7: ("graph", ("msg", GRAPH_PROTO)),
    8: ("opset_import", ("rep_msg", OPERATOR_SET_ID)),
}

# ONNX TensorProto.DataType values (public enum)
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64 = 1, 2, 3, 6, 7
DT_BOOL, DT_FLOAT16, DT_DOUBLE, DT_BFLOAT16 = 9, 10, 11, 16


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def decode(buf: bytes, schema: Dict[int, Tuple[str, Any]]) -> Msg:
    fields: Dict[str, Any] = {}
    for fno, (name, kind) in schema.items():
        if (isinstance(kind, str) and kind.startswith("rep_")) or (
                isinstance(kind, tuple) and kind[0] == "rep_msg"):
            fields[name] = []
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        ent = schema.get(fno)
        if wt == 0:
            v, pos = _read_varint(buf, pos)
            if ent:
                _store(fields, ent, _signed64(v))
        elif wt == 5:
            raw = buf[pos:pos + 4]
            pos += 4
            if ent:
                _store(fields, ent, struct.unpack("<f", raw)[0]
                       if "f32" in str(ent[1]) else struct.unpack("<I", raw)[0])
        elif wt == 1:
            raw = buf[pos:pos + 8]
            pos += 8
            if ent:
                _store(fields, ent, struct.unpack("<d", raw)[0]
                       if "f64" in str(ent[1]) else struct.unpack("<Q", raw)[0])
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            raw = buf[pos:pos + ln]
            pos += ln
            if ent:
                _store_delimited(fields, ent, raw)
        else:
            raise ValueError(f"unsupported wire type {wt}")
    # defaults for absent fields
    for fno, (name, kind) in schema.items():
        if name not in fields:
            fields[name] = None if isinstance(kind, tuple) else \
                ("" if kind == "str" else (b"" if kind == "bytes" else 0))
    return Msg(fields)


def _store(fields, ent, v):
    name, kind = ent
    if isinstance(kind, str) and kind.startswith("rep_"):
        fields.setdefault(name, []).append(v)
    else:
        fields[name] = v


def _store_delimited(fields, ent, raw: bytes):
    name, kind = ent
    if isinstance(kind, tuple):
        tag, schema = kind
        m = decode(raw, schema)
        if tag == "rep_msg":
            fields.setdefault(name, []).append(m)
        else:
            fields[name] = m
        return
    if kind == "str":
        fields[name] = raw.decode("utf-8")
    elif kind == "bytes":
        fields[name] = raw
    elif kind == "rep_str":
        fields.setdefault(name, []).append(raw.decode("utf-8"))
    elif kind == "rep_bytes":
        fields.setdefault(name, []).append(raw)
    elif kind == "rep_varint":  # packed
        out = fields.setdefault(name, [])
        p = 0
        while p < len(raw):
            v, p = _read_varint(raw, p)
            out.append(_signed64(v))
    elif kind == "rep_f32":
        fields.setdefault(name, []).extend(
            struct.unpack(f"<{len(raw) // 4}f", raw))
    elif kind == "rep_f64":
        fields.setdefault(name, []).extend(
            struct.unpack(f"<{len(raw) // 8}d", raw))
    else:
        raise ValueError(f"delimited payload for scalar kind {kind}")


def load_model(path: str) -> Msg:
    with open(path, "rb") as f:
        return decode(f.read(), MODEL_PROTO)


# ------------------------------------------------------------------ writer
# (enough of the wire format to build valid models)
def _w_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _w_tag(fno: int, wt: int) -> bytes:
    return _w_varint((fno << 3) | wt)


def _w_len(fno: int, payload: bytes) -> bytes:
    return _w_tag(fno, 2) + _w_varint(len(payload)) + payload


def encode(msg: Dict[int, Any]) -> bytes:
    """Encode {field_no: value} where value is int (varint), float (f32),
    str/bytes, dict (submessage), or a list of those (repeated)."""
    out = bytearray()
    for fno, val in msg.items():
        vals = val if isinstance(val, list) else [val]
        for v in vals:
            if isinstance(v, bool):
                out += _w_tag(fno, 0) + _w_varint(int(v))
            elif isinstance(v, int):
                out += _w_tag(fno, 0) + _w_varint(v)
            elif isinstance(v, float):
                out += _w_tag(fno, 5) + struct.pack("<f", v)
            elif isinstance(v, str):
                out += _w_len(fno, v.encode("utf-8"))
            elif isinstance(v, bytes):
                out += _w_len(fno, v)
            elif isinstance(v, dict):
                out += _w_len(fno, encode(v))
            else:
                raise TypeError(f"cannot encode {type(v)} in field {fno}")
    return bytes(out)
