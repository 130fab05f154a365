"""GraphXfer: the graph-substitution engine's rules and matcher
(counterpart: flexflow_tpu/search/substitution.py).

Reference analog: `GraphXfer`/`OpX` (include/flexflow/substitution.h:85-247)
with `can_match` (src/runtime/substitution.cc:235), backtracking
`find_matches` (:510), and the built-in parallelization rule generators
`generate_all_pcg_xfers` (:1726-1868). A rule = a source pattern (OpX graph)
plus an `apply` that produces a rewritten PCG: pinning sharding candidates on
matched compute nodes and inserting/removing explicit parallel-op nodes.

JSON-loaded algebraic rules (reference substitution_loader.h:143-180, rules
file substitutions/graph_subst_3_v2.json) are read by
`load_substitution_json`, which maps the rule schema's op vocabulary
(OP_PARTITION/OP_COMBINE/OP_REPLICATE/OP_REDUCE + compute ops) onto this
engine; rules using unsupported ops or degrees absent from the mesh are
skipped and counted. A rule whose rewritten graph needs an op this package
does not lower (relu, concat, split) does not apply.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.search.candidates import layer_candidates
from flexflow_tpu_torch.search.pcg import PCG

# An OpX input: ("ext", k) = pattern-external value #k; ("op", i, port) =
# output `port` of pattern op #i.
InSpec = Tuple


@dataclasses.dataclass
class OpX:
    """One node of a source pattern (reference OpX, substitution.h:85)."""

    types: Optional[Set[OperatorType]]          # None = wildcard
    inputs: List[InSpec] = dataclasses.field(default_factory=list)
    pred: Optional[Callable[[Layer], bool]] = None

    def can_match(self, layer: Layer) -> bool:
        if self.types is not None and layer.op_type not in self.types:
            return False
        if self.inputs and len(layer.inputs) < len(self.inputs):
            return False
        return self.pred is None or self.pred(layer)


@dataclasses.dataclass
class GraphXfer:
    """source pattern -> rewrite. `apply(pcg, match)` returns a NEW pcg (the
    input is never mutated) or None when the rewrite is inapplicable."""

    name: str
    src: List[OpX]
    apply: Callable[[PCG, List[Layer]], Optional[PCG]]


def find_matches(src: Sequence[OpX], pcg: PCG, limit: int = 64) -> List[List[Layer]]:
    """Backtracking subgraph match (reference find_matches,
    substitution.cc:510). Returns lists of layers, one per pattern op."""
    layers = pcg.layers
    matches: List[List[Layer]] = []

    def edges_ok(oi: int, layer: Layer, bound: List[Layer], ext: Dict[int, int]) -> bool:
        for ii, spec in enumerate(src[oi].inputs):
            t = layer.inputs[ii]
            if spec[0] == "op":
                _, si, port = spec
                if t.owner is not bound[si] or t.owner_idx != port:
                    return False
            else:  # ("ext", k): same external tensor everywhere it appears
                k = spec[1]
                if k in ext:
                    if ext[k] != t.guid:
                        return False
                else:
                    ext[k] = t.guid
        return True

    def extend(oi: int, bound: List[Layer], ext: Dict[int, int]):
        if len(matches) >= limit:
            return
        if oi == len(src):
            matches.append(list(bound))
            return
        for layer in layers:
            if layer in bound or not src[oi].can_match(layer):
                continue
            ext2 = dict(ext)
            if not edges_ok(oi, layer, bound, ext2):
                continue
            bound.append(layer)
            extend(oi + 1, bound, ext2)
            bound.pop()

    extend(0, [], {})
    return matches


# --------------------------------------------------------------- helpers
def _cand_names(layer: Layer, machine: MachineSpec, batch_sizes) -> Set[str]:
    return {c.name for c in layer_candidates(layer, machine, batch_sizes)}


def _batch_sizes(pcg: PCG):
    return {t.shape[0] for t in pcg.input_tensors if t.ndim > 0}


def _pin(pcg: PCG, machine: MachineSpec, layer_name: str, cand: str) -> bool:
    """Pin `layer_name` to candidate `cand` if that candidate exists."""
    layer = pcg.layer_by_name(layer_name)
    if cand not in _cand_names(layer, machine, _batch_sizes(pcg)):
        return False
    pcg.pins[layer_name] = cand
    return True


# ------------------------------------------------- built-in rule generators
def generate_pcg_xfers(machine: MachineSpec, enable_parameter: bool = True,
                       enable_attribute: bool = True) -> List[GraphXfer]:
    """The built-in parallelization rules, one set per model mesh axis
    (reference generate_all_pcg_xfers, substitution.cc:1726-1868 — there per
    divisor degree; here per mesh axis). The list and its order are the JAX
    package's, so a rule index (UnityStats.best_path) means the same rule
    in both; the conv and MoE rules match no layer this package builds.
    enable_parameter gates the TP rules, enable_attribute the conv partition
    (reference --enable-parameter-parallel / --enable-attribute-parallel)."""
    from flexflow_tpu_torch.search.candidates import _model_axes

    xfers: List[GraphXfer] = []
    for ax in _model_axes(machine):
        if enable_parameter:
            xfers += [
                _xfer_megatron_pair(machine, ax),
                _xfer_attention_heads(machine, ax),
                _xfer_linear_combine(machine, ax),
                _xfer_embedding_row(machine, ax),
                _xfer_moe_ep(machine, ax),
            ]
        if enable_attribute:
            xfers.append(_xfer_conv_oc(machine, ax))
    xfers += _elimination_xfers()
    return xfers


def _xfer_megatron_pair(machine: MachineSpec, ax: str) -> GraphXfer:
    """linear -> linear  ⇒  replicate → linear(col-shard) → linear(row-shard)
    → reduction. Reference: create_replicate_linear_combine +
    create_partition_linear_reduce composed (substitution.cc:1755-1761)."""

    src = [
        OpX({OperatorType.LINEAR}, [("ext", 0)]),
        OpX({OperatorType.LINEAR}, [("op", 0, 0)]),
    ]

    def apply(pcg: PCG, match: List[Layer]) -> Optional[PCG]:
        up, down = match
        ng = pcg.clone()
        if not (_pin(ng, machine, up.name, f"tp_col:{ax}")
                and _pin(ng, machine, down.name, f"tp_row:{ax}")):
            return None
        n_up, n_down = ng.layer_by_name(up.name), ng.layer_by_name(down.name)
        # explicit parallel-op nodes: the input is replicated over ax, the
        # partial sums after the row-sharded matmul are reduced over ax
        ng.insert_after(n_up.inputs[0], OperatorType.REPLICATE,
                        {"axis": ax}, name=f"{up.name}_replicate")
        ng.insert_after(n_down.outputs[0], OperatorType.REDUCTION,
                        {"axis": ax}, name=f"{down.name}_reduce")
        return ng

    return GraphXfer(f"megatron_linear_pair:{ax}", src, apply)


def _xfer_attention_heads(machine: MachineSpec, ax: str) -> GraphXfer:
    """Head-parallel attention + reduce of the out-projection partials.
    Reference: create_partition_attention_combine /
    create_replicate_attention_reduce (substitution.cc:1763-1770)."""

    src = [OpX({OperatorType.MULTIHEAD_ATTENTION})]

    def apply(pcg: PCG, match: List[Layer]) -> Optional[PCG]:
        (mha,) = match
        ng = pcg.clone()
        if not _pin(ng, machine, mha.name, f"tp_heads:{ax}"):
            return None
        n = ng.layer_by_name(mha.name)
        ng.insert_after(n.outputs[0], OperatorType.REDUCTION,
                        {"axis": ax}, name=f"{mha.name}_reduce")
        return ng

    return GraphXfer(f"partition_attention:{ax}", src, apply)


def _xfer_linear_combine(machine: MachineSpec, ax: str) -> GraphXfer:
    """Single linear column-sharded, output gathered back (reference
    create_partition_linear_combine, substitution.cc:1750)."""

    src = [OpX({OperatorType.LINEAR})]

    def apply(pcg: PCG, match: List[Layer]) -> Optional[PCG]:
        (lin,) = match
        ng = pcg.clone()
        if not _pin(ng, machine, lin.name, f"tp_col:{ax}"):
            return None
        n = ng.layer_by_name(lin.name)
        ng.insert_after(n.outputs[0], OperatorType.COMBINE,
                        {"dim": n.outputs[0].spec.ndim - 1, "axis": ax},
                        name=f"{lin.name}_combine")
        return ng

    return GraphXfer(f"partition_linear_combine:{ax}", src, apply)


def _xfer_embedding_row(machine: MachineSpec, ax: str) -> GraphXfer:
    """Embedding table partitioned over entries (DLRM attribute parallel,
    reference embedding partition xfers)."""

    src = [OpX({OperatorType.EMBEDDING})]

    def apply(pcg: PCG, match: List[Layer]) -> Optional[PCG]:
        (emb,) = match
        ng = pcg.clone()
        if not _pin(ng, machine, emb.name, f"row:{ax}"):
            return None
        n = ng.layer_by_name(emb.name)
        ng.insert_after(n.outputs[0], OperatorType.REDUCTION,
                        {"axis": ax}, name=f"{emb.name}_reduce")
        return ng

    return GraphXfer(f"partition_embedding_row:{ax}", src, apply)


def _xfer_conv_oc(machine: MachineSpec, ax: str) -> GraphXfer:
    """Conv2d output-channel partition + combine (reference
    create_mapping_xfers<Conv2D>, substitution.cc:1794-1798)."""

    src = [OpX({OperatorType.CONV2D})]

    def apply(pcg: PCG, match: List[Layer]) -> Optional[PCG]:
        (conv,) = match
        ng = pcg.clone()
        if not _pin(ng, machine, conv.name, f"tp_oc:{ax}"):
            return None
        n = ng.layer_by_name(conv.name)
        ng.insert_after(n.outputs[0], OperatorType.COMBINE,
                        {"dim": 1, "axis": ax}, name=f"{conv.name}_combine")
        return ng

    return GraphXfer(f"partition_conv_oc:{ax}", src, apply)


def _xfer_moe_ep(machine: MachineSpec, ax: str) -> GraphXfer:
    """Expert parallelism: group_by dispatch + experts sharded over the
    expert dim (reference P9; experts as separately-placed ops)."""

    src = [
        OpX({OperatorType.GROUP_BY}),
        OpX({OperatorType.EXPERTS}, [("op", 0, 0)]),
    ]

    def apply(pcg: PCG, match: List[Layer]) -> Optional[PCG]:
        gb, ex = match
        ng = pcg.clone()
        if not (_pin(ng, machine, gb.name, f"ep:{ax}")
                and _pin(ng, machine, ex.name, f"ep:{ax}")):
            return None
        return ng

    return GraphXfer(f"expert_parallel:{ax}", src, apply)


def _elimination_xfers() -> List[GraphXfer]:
    """Redundant parallel-op elimination (the algebra the JSON rules encode,
    e.g. partition∘combine = id; reference simplification passes
    src/runtime/graph.cc:293-360)."""

    def _pair(t1, t2, name, same_key):
        src = [OpX({t1}), OpX({t2}, [("op", 0, 0)])]

        def apply(pcg: PCG, match: List[Layer]) -> Optional[PCG]:
            a, b = match
            if not same_key(a, b):
                return None
            ng = pcg.clone()
            na, nb = ng.layer_by_name(a.name), ng.layer_by_name(b.name)
            ng.remove_identity(nb)
            ng.remove_identity(na)
            return ng

        return GraphXfer(name, src, apply)

    same_dim_axis = lambda a, b: (a.params.get("dim") == b.params.get("dim")
                                  and a.params.get("axis") == b.params.get("axis"))
    same_axis = lambda a, b: a.params.get("axis") == b.params.get("axis")
    return [
        _pair(OperatorType.REPARTITION, OperatorType.COMBINE,
              "eliminate_partition_combine", same_dim_axis),
        _pair(OperatorType.COMBINE, OperatorType.REPARTITION,
              "eliminate_combine_partition", same_dim_axis),
        _pair(OperatorType.REPLICATE, OperatorType.REDUCTION,
              "eliminate_replicate_reduce", same_axis),
    ]


# ------------------------------------------------------------- JSON loader
_JSON_PARALLEL = {
    "OP_PARTITION": OperatorType.REPARTITION,
    "OP_COMBINE": OperatorType.COMBINE,
    "OP_REPLICATE": OperatorType.REPLICATE,
    "OP_REDUCE": OperatorType.REDUCTION,
}
_JSON_COMPUTE = {
    "OP_LINEAR": OperatorType.LINEAR,
    "OP_RELU": OperatorType.RELU,
    "OP_EW_ADD": OperatorType.EW_ADD,
    "OP_EW_MUL": OperatorType.EW_MUL,
    "OP_CONCAT": OperatorType.CONCAT,
    "OP_SPLIT": OperatorType.SPLIT,
}


def _params_of(op_json: dict) -> Dict[str, int]:
    return {p["key"]: p["value"] for p in op_json.get("para", [])}


def load_substitution_json(path: str, machine: MachineSpec) -> Tuple[List[GraphXfer], Dict]:
    """Load reference-format substitution rules (--substitution-json flag,
    reference substitution_loader.h:143; rule schema of
    substitutions/graph_subst_3_v2.json).

    Supported rules rewrite chains of parallel ops (the schema's
    PARTITION/COMBINE/REPLICATE/REDUCE with PM_PARALLEL_DIM/DEGREE params)
    around the compute vocabulary above. PM_PARALLEL_DIM uses the
    reference's reversed (Legion) dim order; it is converted at apply time
    (dim -> ndim-1-dim). PM_PARALLEL_DEGREE==2 is the schema's placeholder
    degree (reference substitution.cc:1487 asserts value==2, then
    instantiates the rule once per runtime parallel degree); it is treated
    as a wildcard instantiated once per model mesh axis. Literal degrees
    other than 2 map to the mesh axis of equal size; rules whose degree
    matches no axis are skipped. Returns (xfers, report) where report counts
    loaded/skipped RULES ("loaded") and emitted xfers ("instantiated")."""
    from flexflow_tpu_torch.search.candidates import _model_axes

    with open(path) as f:
        doc = json.load(f)
    rules = doc["rule"] if isinstance(doc, dict) else doc
    deg_to_axis = {}
    for a, n in machine.mesh_axes.items():
        deg_to_axis.setdefault(n, a)
    wildcard_axes = _model_axes(machine) or \
        ([deg_to_axis[2]] if 2 in deg_to_axis else [])
    xfers: List[GraphXfer] = []
    skipped = {"unsupported_op": 0, "degree_unmatched": 0, "shape": 0}
    loaded_rules = 0
    for rule in rules:
        got_any = False
        last_err = None
        # per-axis instantiation only matters when the rule actually uses the
        # placeholder degree 2; literal-degree rules compile once
        has_deg2 = any(p.get("PM_PARALLEL_DEGREE") == 2
                       for side in ("srcOp", "dstOp") for op in rule[side]
                       for p in [_params_of(op)])
        axes = (wildcard_axes or [None]) if has_deg2 else [None]
        for ax in axes:
            x = _compile_json_rule(rule, deg_to_axis, wildcard_axis=ax)
            if isinstance(x, str):
                last_err = x
            else:
                xfers.append(x)
                got_any = True
        if got_any:
            loaded_rules += 1
        else:
            skipped[last_err or "degree_unmatched"] += 1
    return xfers, {"loaded": loaded_rules, **skipped,
                   "instantiated": len(xfers), "total": len(rules)}


def _compile_json_rule(rule: dict, deg_to_axis: Dict[int, str],
                       wildcard_axis: Optional[str] = None):
    name = rule.get("name", "json_rule")
    if wildcard_axis is not None:
        name = f"{name}:{wildcard_axis}"

    def conv(op_json):
        t = op_json["type"]
        p = _params_of(op_json)
        if t in _JSON_PARALLEL:
            deg = p.get("PM_PARALLEL_DEGREE")
            # degree 2 is the schema placeholder: bind to the wildcard axis
            if deg == 2 and wildcard_axis is not None:
                return (_JSON_PARALLEL[t], p, wildcard_axis)
            if deg not in deg_to_axis:
                return "degree_unmatched"
            return (_JSON_PARALLEL[t], p, deg_to_axis[deg])
        if t in _JSON_COMPUTE:
            return (_JSON_COMPUTE[t], p, None)
        return "unsupported_op"

    src_ops, dst_ops = [], []
    for js, out in ((rule["srcOp"], src_ops), (rule["dstOp"], dst_ops)):
        for op_json in js:
            c = conv(op_json)
            if isinstance(c, str):
                return c
            ins = []
            for t in op_json.get("input", []):
                if t["opId"] < 0:
                    ins.append(("ext", -t["opId"] * 10 + t["tsId"]))
                else:
                    ins.append(("op", t["opId"], t["tsId"]))
            out.append((c[0], c[1], c[2], ins))

    # Dst compute ops take params/identity from the corresponding src op of
    # the same type (k-th dst occurrence of a type ↔ k-th src occurrence);
    # their output shapes are re-derived via the op registry's shape
    # inference at apply time. A dst compute op with no same-type src
    # counterpart is synthesized from its JSON params alone — possible for
    # the weightless vocabulary (relu/add/mul/concat/split); a weighted op
    # (linear) without a counterpart has no weights to inherit — reject.
    _DERIVABLE = {OperatorType.RELU, OperatorType.EW_ADD, OperatorType.EW_MUL,
                  OperatorType.CONCAT, OperatorType.SPLIT}
    src_by_type: Dict[OperatorType, List[int]] = {}
    for i, (t, _p, _ax, _ins) in enumerate(src_ops):
        if _ax is None:
            src_by_type.setdefault(t, []).append(i)
    dst_src_of: Dict[int, Optional[int]] = {}
    seen_of_type: Dict[OperatorType, int] = {}
    for i, (t, _p, _ax, _ins) in enumerate(dst_ops):
        if _ax is None:  # compute op
            k = seen_of_type.get(t, 0)
            seen_of_type[t] = k + 1
            cands = src_by_type.get(t, [])
            if k < len(cands):
                dst_src_of[i] = cands[k]
            elif t in _DERIVABLE:
                dst_src_of[i] = None
            else:
                return "unsupported_op"

    mapped = [(m["srcOpId"], m["srcTsId"], m["dstOpId"], m["dstTsId"])
              for m in rule.get("mappedOutput", [])]

    def match_params(expect: Dict[str, int]):
        def pred(layer: Layer) -> bool:
            p = layer.params
            nd = layer.inputs[0].spec.ndim if layer.inputs else 0
            if "PM_PARALLEL_DIM" in expect:
                want = nd - 1 - expect["PM_PARALLEL_DIM"]  # Legion dim order
                if layer.op_type in (OperatorType.REPARTITION, OperatorType.COMBINE) \
                        and p.get("dim") != want:
                    return False
            return True
        return pred

    src_pattern = [OpX({t} if t else None, ins, pred=match_params(p))
                   for (t, p, _ax, ins) in src_ops]

    def apply(pcg: PCG, match: List[Layer]) -> Optional[PCG]:
        # interior outputs must not escape the pattern (they are replaced)
        matched = set(id(l) for l in match)
        for i, l in enumerate(match):
            for o in l.outputs:
                cons = pcg.consumers(o)
                interior = any(id(cl) in matched for cl, _ in cons)
                exterior = any(id(cl) not in matched for cl, _ in cons)
                is_mapped = any(si == i for si, _, _, _ in mapped)
                if interior and exterior and not is_mapped:
                    return None
        ng = pcg.clone()
        nmatch = [ng.layer_by_name(l.name) for l in match]
        # bind pattern-external inputs from the matched source ops
        ext: Dict[int, "object"] = {}
        for (t, p, _ax, ins), l in zip(src_ops, nmatch):
            for spec, tin in zip(ins, l.inputs):
                if spec[0] == "ext":
                    ext[spec[1]] = tin
        # instantiate dst ops
        new_nodes: List[Layer] = []
        for di, (t, p, ax, ins) in enumerate(dst_ops):
            inputs = []
            for spec in ins:
                if spec[0] == "ext":
                    if spec[1] not in ext:
                        return None
                    inputs.append(ext[spec[1]])
                else:
                    inputs.append(new_nodes[spec[1]].outputs[spec[2]])
            if t in (OperatorType.REPARTITION, OperatorType.COMBINE):
                nd = inputs[0].spec.ndim
                params = {"dim": nd - 1 - p["PM_PARALLEL_DIM"], "axis": ax}
                node = Layer(t, params, inputs)
                node.add_output(inputs[0].spec, 0)  # layout op: shape unchanged
            elif t in (OperatorType.REPLICATE, OperatorType.REDUCTION):
                node = Layer(t, {"axis": ax}, inputs)
                node.add_output(inputs[0].spec, 0)
            else:
                # compute op: inherit params + name (= model identity) from
                # the corresponding matched src op when one exists, else
                # synthesize params from the JSON para; re-run registry shape
                # inference so shape-changing ops (linear/concat/split) get
                # true output specs
                src_j = dst_src_of.get(di)
                if src_j is not None:
                    src_l = nmatch[src_j]
                    params = dict(src_l.params)
                    # PM_ACTI=0 means the rule strips a fused activation out
                    # into an explicit node (e.g. taso_rule_169)
                    if t is OperatorType.LINEAR and p.get("PM_ACTI") == 0:
                        params["activation"] = None
                    node = Layer(t, params, inputs, name=src_l.name)
                elif t is OperatorType.CONCAT:
                    nd = p.get("PM_NUMDIM", inputs[0].spec.ndim)
                    node = Layer(t, {"axis": nd - 1 - p.get("PM_AXIS", 0)}, inputs)
                elif t is OperatorType.SPLIT:
                    nd = inputs[0].spec.ndim
                    axis = nd - 1 - p.get("PM_AXIS", 0)
                    n_out = p.get("PM_NUM_OUTPUTS", 2)
                    dim = inputs[0].spec.shape[axis]
                    if n_out <= 0 or dim % n_out:
                        return None
                    node = Layer(t, {"axis": axis,
                                     "sizes": [dim // n_out] * n_out}, inputs)
                else:  # relu / ew_add / ew_mul
                    node = Layer(t, {}, inputs)
                try:
                    from flexflow_tpu_torch.ops.registry import get_op_def

                    ospecs = get_op_def(t).infer(node)
                except Exception:
                    return None
                for oi, ospec in enumerate(ospecs):
                    node.add_output(ospec, oi)
            new_nodes.append(node)
        # rewire mapped outputs, remove matched src ops; a mapped output must
        # exist and keep the logical shape its consumers were built against
        for si, sp, di, dp in mapped:
            src_t = nmatch[si].outputs[sp]
            if dp >= len(new_nodes[di].outputs):
                return None
            if new_nodes[di].outputs[dp].spec.shape != src_t.spec.shape:
                return None
            for cl, ii in ng.consumers(src_t):
                if cl not in nmatch:
                    cl.inputs[ii] = new_nodes[di].outputs[dp]
        for l in reversed(nmatch):
            if l in ng.layers:
                ng.layers.remove(l)
                ng.pins.pop(l.name, None)
        insert_at = min((ng.layers.index(t.owner) + 1 for t in ext.values()
                         if t.owner is not None and t.owner in ng.layers),
                        default=0)
        for node in new_nodes:
            ng.layers.insert(insert_at, node)
            insert_at += 1
        # sanity: the rewritten graph must still be a DAG over known tensors
        try:
            from flexflow_tpu_torch.core.graph import topo_order

            topo_order(ng.layers)
        except ValueError:
            return None
        return ng

    return GraphXfer(name, src_pattern, apply)
