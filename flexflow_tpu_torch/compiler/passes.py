"""Graph passes over the frontend layer graph (counterpart:
flexflow_tpu/compiler/passes.py).

`fuse_fork_joins` rewrites fork-join regions the user did not mark into
FORK_JOIN composites (ops/fork_join.py): a fork tensor whose independent
consumer chains reconverge at one join op. After it, the search's
`inter:{axis}` candidates can place the branches on disjoint devices like
any hand-built fork_join's.

The pass is conservative: a region is fused only when every branch is a
linear chain of single-input, single-output layers from the fork tensor
to the join (no edge in or out), the join is an add or a last-dim concat
taking exactly the branch ends, and the branches meet the FORK_JOIN
contract (batch kept, shapes agreeing); any other region is skipped.
Regions are fused one at a time, detected anew after each, so cascaded
regions (one region's join feeding another's fork) fuse against the
current graph.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import get_op_def


def _consumer_index(layers) -> Dict[int, List[Tuple[Layer, int]]]:
    idx: Dict[int, List[Tuple[Layer, int]]] = {}
    for l in layers:
        for i, t in enumerate(l.inputs):
            idx.setdefault(t.guid, []).append((l, i))
    return idx


def find_fork_join_regions(model) -> List[dict]:
    """Fork tensors whose every consumer chain reconverges at one join op."""
    regions = []
    layers = model.layers
    cons_of = _consumer_index(layers)
    tensors = list(model.input_tensors) + \
        [o for l in layers for o in l.outputs]
    for t in tensors:
        cons = cons_of.get(t.guid, [])
        if len(cons) < 2:
            continue
        starts = [c for c, _ in cons]
        if any(len(s.inputs) != 1 for s in starts):
            continue
        # each start must begin a clean single-consumer chain; all chains
        # must terminate at the same multi-input join op
        joins = set()
        chains = []
        ok = True
        for s in starts:
            chain = [s]
            cur = s
            term = None
            while True:
                if len(cur.outputs) != 1:
                    ok = False
                    break
                cc = cons_of.get(cur.outputs[0].guid, [])
                if len(cc) != 1:
                    ok = False
                    break
                nxt, _ = cc[0]
                if len(nxt.inputs) > 1:
                    term = nxt
                    break
                chain.append(nxt)
                cur = nxt
            if not ok or term is None:
                ok = False
                break
            joins.add(id(term))
            chains.append((chain, term))
        if not ok or len(joins) != 1:
            continue
        join = chains[0][1]
        if len(join.inputs) != len(chains):
            continue  # the join takes inputs from outside the region
        if join.op_type is OperatorType.EW_ADD:
            jkind = "add"
        elif join.op_type is OperatorType.CONCAT and \
                join.params.get("axis") in (-1, join.inputs[0].spec.ndim - 1):
            jkind = "concat"
        else:
            continue
        regions.append({"fork": t, "join": join, "jkind": jkind,
                        "chains": [c for c, _ in chains]})
    return regions


def _try_fuse(model, region) -> bool:
    fork, join = region["fork"], region["join"]
    chains: List[List[Layer]] = region["chains"]
    # order branches by the join's input order so numerics (concat) hold
    order = []
    for tin in join.inputs:
        for ci, chain in enumerate(chains):
            if chain[-1].outputs[0].guid == tin.guid:
                order.append(ci)
    if sorted(order) != list(range(len(chains))):
        return False
    chains = [chains[i] for i in order]

    subs = []
    for chain in chains:
        bx = Tensor(fork.spec, name=f"_fj_in_{fork.guid}")
        prev = bx
        blayers = []
        for j, l in enumerate(chain):
            # positional rename for auto-generated names: weight keys must
            # not embed process-global guids (matches FFModel.fork_join)
            name = l.name
            if name == f"{l.op_type.value}_{l.guid}":
                name = f"{l.op_type.value}{j}"
            nl = Layer(l.op_type, l.params, [prev], name=name)
            nl.weight_specs = dict(l.weight_specs)
            nl.branches = l.branches  # a nested hand-built fork_join
            for i, o in enumerate(l.outputs):
                nl.add_output(o.spec, i)
            prev = nl.outputs[0]
            blayers.append(nl)
        subs.append((blayers, bx, prev))

    fj = Layer(OperatorType.FORK_JOIN,
               {"join": region["jkind"], "n_branches": len(chains)},
               [fork], name=f"fj_{join.name}")
    fj.branches = subs
    try:
        specs = get_op_def(OperatorType.FORK_JOIN).infer(fj)
    except (ValueError, KeyError):
        return False  # contract violation (e.g. batch-changing branch): skip
    for i, spec in enumerate(specs):
        fj.add_output(spec, idx=i)

    # splice: remove the branch layers + join, rewire join consumers
    removed = {id(l) for chain in chains for l in chain} | {id(join)}
    cons_of = _consumer_index(model.layers)
    for cl, ii in cons_of.get(join.outputs[0].guid, []):
        if id(cl) not in removed:
            cl.inputs[ii] = fj.outputs[0]
    insert_at = min(i for i, l in enumerate(model.layers) if id(l) in removed)
    model.layers = [l for l in model.layers if id(l) not in removed]
    model.layers.insert(insert_at, fj)
    # initializer overrides follow the weights under "b{i}.{layer}.{w}"
    over = model._initializer_overrides
    for bi, (blayers, _bx, _o) in enumerate(subs):
        for nl, old in zip(blayers, chains[bi]):
            for (ln, wn), init in list(over.items()):
                if ln == old.name:
                    over[(fj.name, f"b{bi}.{nl.name}.{wn}")] = over.pop((ln, wn))
    return True


def fuse_fork_joins(model) -> int:
    """Rewrite detected fork-join regions into FORK_JOIN composites (in
    place, one at a time with re-detection in between — cascaded regions
    fuse against the current graph). Returns the number fused. Run BEFORE
    compile(); branch weights move under the composite's
    "b{i}.{sublayer}.{w}" names."""
    fused = 0
    skipped_ids = set()
    while True:
        progress = False
        for region in find_fork_join_regions(model):
            key = (region["fork"].guid, id(region["join"]))
            if key in skipped_ids:
                continue
            if _try_fuse(model, region):
                fused += 1
                progress = True
                break  # graph changed: re-detect from scratch
            skipped_ids.add(key)
        if not progress:
            return fused
