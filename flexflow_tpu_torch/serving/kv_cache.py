"""Paged KV cache for the decode program (counterpart: flexflow_tpu/serving/kv_cache.py).

Layout (per attention layer): one K pool and one V pool of shape
`[pool_pages, page_size, heads, head_dim]`, where `pool_pages =
slots * pages_per_slot + 1` — page 0 is a reserved SCRATCH page that
inactive slots, unallocated page-table entries and right padding write
into, so every step is a fixed-shape scatter/gather. An int8 cache stores
int8 pools plus per-(page entry, head) f32 scales.

Paging: a per-slot page table `[slots, pages_per_slot]` of page ids maps
position t to `table[slot, t // page_size]` at offset `t % page_size`.
Pages come from a host free list on admission and return on eviction; the
device copy of the table, positions and active flags is refreshed by
`push()` at scheduler sync points. Freed pages keep stale K/V but are
never attended: the position mask only exposes what the current occupant
wrote. The pools are updated in place (the JAX package returns new ones).

The pools + table + per-slot position/active vectors travel through the
decode program as lowering state: `state[layer_name] = {"k", "v"}`,
`state["serve/page_table"]`, `state["serve/pos"]`, `state["serve/active"]`.

Over a mesh (the engine over a process group) the pools' heads dim is
sharded over the axis the decode strategy put on the attention heads
(`heads_axis`: the wq output dim's axis, JAX `kv_cache.py:135-175`), when
every axis of it is on the mesh and its degree divides the heads; else
every rank holds every head. Each rank allocates only its `heads /
degree` heads of every pool and scale tensor, as PLAIN local tensors
(not DTensors: the cache writes are index-puts, which DTensor does not
shard right on the card's torch), and `head_placements` says which block
it holds (Shard(2) of a `[slots, S, heads, d]` tensor on those axes). The
page accounting is host-side and the same on every rank (the ranks make
the same calls in the same order); a spill, refill, export or import
moves this rank's heads only, while the byte counters count every head,
as JAX's do.

Host cold tier (`kv_host_pages` > 0): causal decode reads a slot's whole
committed extent every step, so the tier works at SLOT granularity, as in
the JAX package. `spill` parks an active slot: its pages' K/V are
gathered on the device and copied into pinned host buffers (one wait for
the copy a spill, taken at the scheduler's sync point), the device pages
go back to the free list, and the slot turns inactive with its position
kept. `prefetch` refills a parked slot: on the card the host-to-device
copies and the in-place pool writes run on a side stream that first waits
for the main stream (the pages it fills were freed by work queued there),
and `join` makes the main stream wait for the copy's event, so neither
adds a host sync. `join` reactivates the slot and counts the rejoin as a
prefetch hit (issued >= prefetch-ahead decode steps before) or a stall.
Host pages have their own free list, so admission capacity spans both
tiers.

Replica handoff (the fleet's disaggregated topology): a prefill replica
spills a committed slot, `export_parked` copies its host rows (values and
int8 scales of every layer) and position into a payload of plain CPU
tensors, and the decode replica's `import_parked` writes them into its
own host tier: the slot lands PARKED, so the ordinary rotation (refill on
the side stream, then `join`) carries it to the device, bitwise the spill
path. The import writes host pages on the host; a host page whose
earlier refill may still be reading it on the card is waited for first.
Over a mesh each rank hands its own heads through its own host tier and
nothing crosses ranks; the payload names its block (`head_layout`), and
an import into a cache holding another block raises.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.device import to_device_async

PAGE_TABLE_KEY = "serve/page_table"
POS_KEY = "serve/pos"
ACTIVE_KEY = "serve/active"


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Paged KV-cache geometry (copied from
    flexflow_tpu/search/cost_model.py)."""

    layers: int          # attention layers holding a cache
    heads: int
    head_dim: int
    slots: int           # concurrent decode slots (max_batch_slots)
    pages_per_slot: int
    page_size: int       # token positions per page
    itemsize: int = 4
    # bytes of the per-(page entry, head) scale stored next to each row of
    # int8 values — 0 for unquantized caches, 4 (one f32) for int8
    scale_itemsize: int = 0
    # tiered cache: a host cold tier of `host_pages` pages per pool beside
    # a device pool of `device_pages` data pages (0 = every slot's worth,
    # the untiered geometry). With a host tier the device pool may be
    # smaller than slots * pages_per_slot: parked slots' pages live on the
    # host and the scheduler rotates a hot subset through device memory.
    host_pages: int = 0
    device_pages: int = 0

    @property
    def padded_len(self) -> int:
        """Max cached positions per sequence (page-rounded)."""
        return self.pages_per_slot * self.page_size

    @property
    def pool_pages(self) -> int:
        """Pages in one DEVICE pool: the data pages (device_pages under a
        host tier, else every slot's worth) plus scratch."""
        return (self.device_pages or self.slots * self.pages_per_slot) + 1

    def page_bytes(self) -> int:
        """K + V bytes of ONE page of ONE layer, scales included."""
        return (2 * self.page_size * self.heads
                * (self.head_dim * self.itemsize + self.scale_itemsize))

    def layer_bytes(self) -> int:
        return self.pool_pages * self.page_bytes()

    def total_bytes(self) -> int:
        return self.layers * self.layer_bytes()

    def per_device_bytes(self, model_degree: int = 1) -> int:
        """Resident bytes per device with the heads dim sharded
        `model_degree` ways (1 = the one device the port runs on)."""
        return self.total_bytes() // max(1, model_degree)

    def step_read_bytes(self, model_degree: int = 1) -> int:
        """Device-memory bytes ONE decode step adds per device: the whole
        resident K/V pool streams through the attention, on top of the
        weights."""
        return self.per_device_bytes(model_degree)

    def slot_bytes(self) -> int:
        """Worst-case K/V bytes of ONE slot across all layers: what a full
        spill or refill of a parked slot moves over the host link."""
        return self.layers * self.pages_per_slot * self.page_bytes()

    def host_bytes(self) -> int:
        """Cold-tier bytes (all layers; 0 without a host tier)."""
        return self.layers * self.host_pages * self.page_bytes()

    def fingerprint(self) -> tuple:
        return (self.layers, self.heads, self.head_dim, self.slots,
                self.pages_per_slot, self.page_size, self.itemsize,
                self.scale_itemsize, self.host_pages, self.device_pages)


def kv_quantize(x: torch.Tensor):
    """Symmetric per-(position, head) int8 quantization over head_dim:
    `scale = max|x| / 127`, values rounded half-to-even into [-127, 127].
    Returns (int8 values, f32 scales one rank lower). The scale floor keeps
    all-zero rows exactly representable as zeros."""
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of kv_quantize: f32 values from int8 + per-row scales."""
    return q.float() * scale[..., None]


class KVPoolExhausted(Exception):
    """`admit` could not allocate the requested pages: backpressure, not a
    fault — the scheduler keeps the request queued."""

    def __init__(self, slot: int, need: int, have: int):
        super().__init__(f"KV pool exhausted admitting slot {slot}: need "
                         f"{need} pages, {have} free")
        self.slot = slot
        self.need = need
        self.have = have


def _runs(ids: List[int]):
    """(start id, index into `ids`, length) of each run of consecutive ids,
    so that a host-tier copy moves whole contiguous slices."""
    out = []
    for i, x in enumerate(ids):
        if out and x == out[-1][0] + out[-1][2]:
            out[-1][2] += 1
        else:
            out.append([x, i, 1])
    return out


class PagedKVCache:
    """Device-resident paged KV pools + host-side page accounting (and, with
    `spec.host_pages`, the host cold tier)."""

    def __init__(self, spec: KVCacheSpec, attn_layers: List[str], *, device,
                 dtype: torch.dtype = torch.float32, quantized: bool = False,
                 machine=None, mesh=None, heads_axis=None):
        # `device` has no default: the engine passes the one it resolved
        self.spec = spec
        self.machine = machine  # host_bw for the transfer rows' pricing
        self.attn_layers = list(attn_layers)
        self.quantized = bool(quantized)
        self.device = torch.device(device)
        self.mesh = mesh
        # the heads layout over the mesh (the module docstring): the axis,
        # its degree and the placements of this rank's block
        self.heads_axis = None
        self.degree = 1
        self.head_placements = None
        if mesh is not None:
            from torch.distributed.tensor import Replicate

            from flexflow_tpu_torch.parallel.sharding import placements

            self.head_placements = [Replicate()] * mesh.ndim
            axes = (() if heads_axis is None else (heads_axis,)
                    if isinstance(heads_axis, str) else tuple(heads_axis))
            names = list(mesh.mesh_dim_names)
            if axes and all(a in names for a in axes):
                deg = math.prod(mesh.size(names.index(a)) for a in axes)
                pl = placements([None, None, heads_axis], mesh)
                if pl is not None and spec.heads % deg == 0:
                    self.heads_axis, self.degree = heads_axis, deg
                    self.head_placements = pl
        self.local_heads = spec.heads // self.degree
        shape = (spec.pool_pages, spec.page_size, self.local_heads,
                 spec.head_dim)
        pool_dtype = torch.int8 if self.quantized else dtype

        def layer_state():
            st = {"k": torch.zeros(shape, dtype=pool_dtype, device=self.device),
                  "v": torch.zeros(shape, dtype=pool_dtype, device=self.device)}
            if self.quantized:
                st["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                            device=self.device)
                st["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                            device=self.device)
            return st

        self.state: Dict = {n: layer_state() for n in self.attn_layers}
        # host mirrors (authoritative at scheduler sync points)
        self._table = np.zeros((spec.slots, spec.pages_per_slot), np.int32)
        self._pos = np.zeros((spec.slots,), np.int32)
        self._active = np.zeros((spec.slots,), np.int32)
        self.free_pages: List[int] = list(range(1, spec.pool_pages))
        self._slot_pages: Dict[int, List[int]] = {}
        # host cold tier: per layer and leaf a buffer shaped like the pool
        # with host_pages rows, pinned when the pools are on the card
        self.host_pages = int(spec.host_pages)
        pin = self.device.type == "cuda"
        self._host: Dict[str, Dict[str, torch.Tensor]] = {
            n: {key: torch.zeros((self.host_pages,) + tuple(leaf.shape[1:]),
                                 dtype=leaf.dtype, pin_memory=pin)
                for key, leaf in self.state[n].items()}
            for n in self.attn_layers} if self.host_pages else {}
        self.free_host_pages: List[int] = list(range(self.host_pages))
        self._cold: Dict[int, List[int]] = {}   # parked slot -> host pages
        self._inflight: Dict[int, int] = {}     # slot -> prefetch issue step
        self._ready: Dict[int, torch.cuda.Event] = {}  # slot -> refill done
        # host page -> the event ending the last refill that read it: an
        # import writes host pages on the host, after that copy has run
        self._host_reads: Dict[int, torch.cuda.Event] = {}
        self._copy_stream = None
        # card only: (direction, bytes, start event, end event) of the last
        # transfers, for `transfer_times`
        self._timed: "collections.deque" = collections.deque(maxlen=512)
        self.host_syncs = 0  # spills that waited for their copy to land
        # the handoff bytes this rank's host tier took in (its heads): the
        # tier counters count every head, JAX's global figure
        self.handoff_bytes_rank = 0
        self.tier_counters: Dict[str, int] = {
            "kv_spills": 0, "kv_refills": 0, "kv_prefetch_hits": 0,
            "kv_prefetch_stalls": 0, "kv_spilled_bytes": 0,
            "kv_refilled_bytes": 0, "kv_handoffs": 0, "kv_handoff_bytes": 0}
        self._push_tables()

    # ------------------------------------------------------------ host ops
    def _put(self, arr, dtype=np.int32) -> torch.Tensor:
        return to_device_async(np.asarray(arr, dtype), self.device)

    def _push_tables(self) -> None:
        self.state[PAGE_TABLE_KEY] = self._put(self._table)
        self.state[POS_KEY] = self._put(self._pos)
        self.state[ACTIVE_KEY] = self._put(self._active)

    def free_slots(self) -> List[int]:
        # a parked slot is inactive on the device but occupied: its K/V
        # lives in the host tier under the same slot id
        return [i for i in range(self.spec.slots)
                if not self._active[i] and i not in self._cold]

    def pages_needed(self, total_tokens: int) -> int:
        cap = min(int(total_tokens), self.spec.padded_len)
        return -(-cap // self.spec.page_size)

    def can_admit(self, total_tokens: int) -> bool:
        return len(self.free_pages) >= self.pages_needed(total_tokens)

    def capacity_pages(self) -> int:
        """Data pages across BOTH tiers: what `prompt_too_long` and
        admission shedding compare against."""
        return (self.spec.pool_pages - 1) + self.host_pages

    def total_free_pages(self) -> int:
        return len(self.free_pages) + len(self.free_host_pages)

    def admit(self, slot: int, prompt_len: int, total_tokens: int) -> bool:
        """Assign pages for a sequence of up to `total_tokens` positions; the
        slot's position starts at `prompt_len` (where the first decode step
        writes). Raises `KVPoolExhausted` when the free list is short."""
        if self._active[slot] or slot in self._cold:
            raise ValueError(f"slot {slot} is occupied")
        need = self.pages_needed(total_tokens)
        if len(self.free_pages) < need:
            raise KVPoolExhausted(slot, need, len(self.free_pages))
        pages = [self.free_pages.pop() for _ in range(need)]
        self._slot_pages[slot] = pages
        row = np.zeros(self.spec.pages_per_slot, np.int32)
        row[:need] = pages
        self._table[slot] = row
        self._pos[slot] = prompt_len
        self._active[slot] = 1
        return True

    def evict(self, slot: int) -> None:
        """Return the slot's pages to the free list(s). A parked slot's
        pages live in the host tier and go back to the host free list; a
        refill still in flight is waited for on the device first, so the
        pages it writes are free only once it has run."""
        self._wait_refill(slot)
        self.free_pages.extend(self._slot_pages.pop(slot, []))
        self.free_host_pages.extend(self._cold.pop(slot, []))
        self._inflight.pop(slot, None)
        self._table[slot] = 0
        self._pos[slot] = 0
        self._active[slot] = 0

    def sync_after(self, decode_steps: int,
                   advances: Optional[np.ndarray] = None) -> None:
        """Host mirror of the device-side position increments. `advances`
        (per-slot committed step counts) masks finished slots: a request
        that hit EOS mid-window advances only to its finish position."""
        if advances is not None:
            self._pos += np.asarray(advances, np.int32) * self._active
        else:
            self._pos += self._active * int(decode_steps)

    def push(self) -> None:
        """Publish the host mirrors to the device state."""
        self._push_tables()

    # ------------------------------------------------------- host tier ops
    def parked_slots(self) -> List[int]:
        """Slots whose K/V sits in the host tier with no refill in flight:
        the scheduler's rotation candidates."""
        return [s for s in self._cold if s not in self._inflight]

    def can_spill(self, slot: int) -> bool:
        return bool(self.host_pages) and bool(self._active[slot]) and \
            len(self.free_host_pages) >= len(self._slot_pages.get(slot, []))

    def _transfer_row(self, direction: str, pages: int,
                      measured_s: float) -> None:
        """One `op/attr` telemetry row for a tier transfer, shaped like the
        per-op attribution rows (kind `kv_transfer`; predicted_s is the
        host link's roofline at the machine's `host_bw`)."""
        if not tel.enabled():
            return
        from flexflow_tpu_torch.attribution import OP_EVENT, feature_key
        from flexflow_tpu_torch.search import memo
        moved = self.spec.layers * pages * self.spec.page_bytes()
        host_bw = getattr(self.machine, "host_bw", 0.0) or 16e9
        predicted = moved / host_bw
        page_shape = [pages, self.spec.page_size, self.spec.heads,
                      self.spec.head_dim]
        features = {
            "op": "kv_transfer", "in_shapes": [page_shape],
            "out_shapes": [page_shape], "weight_shapes": [],
            "dtype": "int8" if self.quantized else "float32",
            "params": 0, "layout": direction,
            "sharding": {"out": [], "weights": []},
            "machine": (memo.machine_fingerprint(self.machine)
                        if self.machine is not None else ()),
        }
        tel.event(OP_EVENT, cat="op", layer=f"kv_cache/{direction}",
                  op="kv_transfer", candidate=direction,
                  predicted_s=predicted, measured_s=measured_s,
                  attributed_s=measured_s, roofline_s=predicted,
                  bound="host_bw", mfu=0.0, mfu_ceiling=0.0,
                  key=feature_key(features), features=features,
                  source="serve", bytes=moved)

    def _event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def spill(self, slot: int, decode_step: int) -> None:
        """Park an active slot: gather its pages of every layer's pools on
        the device and copy them into the host buffers, return the device
        pages, and deactivate the slot keeping its position. On the card
        the copies are non-blocking into pinned memory and the spill waits
        once for them (`host_syncs`), so no host row is read or reused
        before its copy has landed. The caller pushes the tables."""
        if not self.can_spill(slot):
            raise ValueError(f"cannot spill slot {slot}")
        pages = self._slot_pages.pop(slot)
        host_ids = sorted(self.free_host_pages.pop() for _ in pages)
        runs = _runs(host_ids)
        cuda = self.device.type == "cuda"
        moved = self.spec.layers * len(pages) * self.spec.page_bytes()
        t0 = time.perf_counter()
        with tel.span("serve/kv_spill", cat="serve", slot=int(slot),
                      pages=len(pages)):
            start = self._event() if cuda else None
            idx = self._put(pages, np.int64)
            for n in self.attn_layers:
                for key, leaf in self.state[n].items():
                    rows = leaf.index_select(0, idx)
                    buf = self._host[n][key]
                    for a, i, ln in runs:
                        buf[a:a + ln].copy_(rows[i:i + ln], non_blocking=cuda)
            if cuda:
                end = self._event()
                torch.cuda.current_stream(self.device).synchronize()
                self.host_syncs += 1
                self._timed.append(("spill", moved, start, end))
        self.free_pages.extend(pages)
        self._cold[slot] = host_ids
        self._table[slot] = 0
        self._active[slot] = 0
        self.tier_counters["kv_spills"] += 1
        self.tier_counters["kv_spilled_bytes"] += moved
        self._transfer_row("spill", len(pages), time.perf_counter() - t0)

    def _refill(self, pages: List[int], host_ids: List[int]):
        """Write the host rows `host_ids` into device pages `pages` of every
        pool, in place. On the card: on a side stream that first waits for
        the main stream; returns the event the main stream waits on."""
        runs = _runs(host_ids)
        n = len(pages)
        cuda = self.device.type == "cuda"
        stream = None
        if cuda:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            start = self._event(stream) if cuda else None
            idx = self._put(pages, np.int64)
            for name in self.attn_layers:
                for key, leaf in self.state[name].items():
                    buf = self._host[name][key]
                    stage = torch.empty((n,) + tuple(leaf.shape[1:]),
                                        dtype=leaf.dtype, device=self.device)
                    for a, i, ln in runs:
                        stage[i:i + ln].copy_(buf[a:a + ln], non_blocking=cuda)
                    leaf.index_copy_(0, idx, stage)
            if not cuda:
                return None
            end = self._event(stream)
        self._timed.append(
            ("prefetch", self.spec.layers * n * self.spec.page_bytes(),
             start, end))
        return end

    def _wait_refill(self, slot: int) -> None:
        ev = self._ready.pop(slot, None)
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

    def prefetch(self, slot: int, decode_step: int) -> bool:
        """Issue the host-to-device refill of a parked slot: allocate device
        pages, start the copies (nothing waits for them here: on the card
        they run on the side stream, and the decode step after `join` is
        ordered behind them), and restore the slot's table row. The slot
        stays INACTIVE until `join`. Returns False (nothing done) when the
        device free list cannot cover it."""
        host_ids = self._cold.get(slot)
        if host_ids is None or slot in self._inflight:
            raise ValueError(f"slot {slot} is not parked")
        need = len(host_ids)
        if len(self.free_pages) < need:
            return False
        pages = [self.free_pages.pop() for _ in range(need)]
        t0 = time.perf_counter()
        with tel.span("serve/kv_prefetch", cat="serve", slot=int(slot),
                      pages=need, step=int(decode_step)):
            ev = self._refill(pages, host_ids)
        if ev is not None:
            self._ready[slot] = ev
            self._host_reads.update((h, ev) for h in host_ids)
        row = np.zeros(self.spec.pages_per_slot, np.int32)
        row[:need] = pages
        self._table[slot] = row
        self._slot_pages[slot] = pages
        self._inflight[slot] = int(decode_step)
        moved = self.spec.layers * need * self.spec.page_bytes()
        self.tier_counters["kv_refills"] += 1
        self.tier_counters["kv_refilled_bytes"] += moved
        self._transfer_row("prefetch", need, time.perf_counter() - t0)
        return True

    def join(self, slot: int, decode_step: int, prefetch_ahead: int) -> bool:
        """Reactivate a slot whose refill `prefetch` issued; the main
        stream waits on the refill's event (no host sync). Returns True
        when the rejoin STALLED: the refill was issued fewer than
        `prefetch_ahead` decode steps ago. Stalls are counted."""
        issued = self._inflight.pop(slot, None)
        if issued is None:
            raise ValueError(f"slot {slot} has no prefetch in flight")
        self._wait_refill(slot)
        self.free_host_pages.extend(self._cold.pop(slot))
        self._active[slot] = 1
        stalled = (int(decode_step) - issued) < max(1, int(prefetch_ahead))
        if stalled:
            self.tier_counters["kv_prefetch_stalls"] += 1
        else:
            self.tier_counters["kv_prefetch_hits"] += 1
        return stalled

    # ------------------------------------------------------ replica handoff
    def head_layout(self) -> tuple:
        """Which heads this rank's pools hold: (degree, local heads, the
        placements of the block). A handoff moves a rank's own block
        through its own host tier, so both sides must hold the same."""
        pl = self.head_placements
        return (self.degree, self.local_heads,
                None if pl is None else tuple(str(p) for p in pl))

    def export_parked(self, slot: int) -> Dict:
        """A PARKED slot's host-tier rows (every layer's values and, int8,
        scales, in the slot's page order) and its committed position, for
        another replica's `import_parked`. The rows are copies (indexing a
        pinned buffer gives pageable memory); the spill's one wait has
        already let its copies land. The caller evicts afterwards."""
        host_ids = self._cold.get(slot)
        if host_ids is None:
            raise ValueError(f"slot {slot} is not parked (spill it first)")
        idx = torch.tensor(host_ids, dtype=torch.long)
        return {"pos": int(self._pos[slot]), "pages": len(host_ids),
                "heads": self.head_layout(),
                "layers": {n: {key: buf.index_select(0, idx)
                               for key, buf in self._host[n].items()}
                           for n in self.attn_layers}}

    def can_import(self, payload: Dict) -> bool:
        return bool(self.host_pages) and \
            len(self.free_host_pages) >= int(payload["pages"])

    def import_parked(self, slot: int, payload: Dict) -> None:
        """Adopt a handed-off slot into this cache's host tier: it lands
        PARKED with its position kept, and the rotation refills and rejoins
        it. Counts `kv_handoffs` and `kv_handoff_bytes` (every head, JAX's
        count; `handoff_bytes_rank` this rank's heads) and writes a
        `kv_transfer` row (direction "handoff"). Raises `KVPoolExhausted`
        when the host free list is short (backpressure), and `ValueError`
        when the payload holds another block of heads than this cache."""
        if self._active[slot] or slot in self._cold:
            raise ValueError(f"slot {slot} is occupied")
        theirs = payload.get("heads", self.head_layout())
        if theirs != self.head_layout():
            raise ValueError(
                f"handoff across head layouts: the payload holds (degree, "
                f"local heads, placements) {theirs}, this cache "
                f"{self.head_layout()}")
        need = int(payload["pages"])
        if not self.can_import(payload):
            raise KVPoolExhausted(slot, need, len(self.free_host_pages))
        t0 = time.perf_counter()
        host_ids = sorted(self.free_host_pages.pop() for _ in range(need))
        for h in host_ids:
            ev = self._host_reads.pop(h, None)
            if ev is not None:
                ev.synchronize()  # a refill on the card still reads it
        idx = torch.tensor(host_ids, dtype=torch.long)
        for n in self.attn_layers:
            for key, rows in payload["layers"][n].items():
                self._host[n][key].index_copy_(0, idx, rows)
        self._cold[slot] = host_ids
        self._pos[slot] = int(payload["pos"])
        self._table[slot] = 0
        self._active[slot] = 0
        moved = self.spec.layers * need * self.spec.page_bytes()
        self.tier_counters["kv_handoffs"] += 1
        self.tier_counters["kv_handoff_bytes"] += moved
        self.handoff_bytes_rank += moved // self.degree
        self._transfer_row("handoff", need, time.perf_counter() - t0)

    def tier_stats(self) -> Dict[str, int]:
        """Counters + occupancy snapshot for telemetry and reports."""
        hot = (self.spec.pool_pages - 1) - len(self.free_pages)
        cold = self.host_pages - len(self.free_host_pages)
        out = dict(self.tier_counters)
        out.update(kv_hot_pages=hot, kv_cold_pages=cold,
                   kv_parked_slots=len(self._cold),
                   kv_host_pages_total=self.host_pages)
        return out

    def host_bytes(self) -> int:
        """Cold-tier buffer bytes allocated on the host."""
        return sum(int(buf.numel() * buf.element_size())
                   for layer in self._host.values() for buf in layer.values())

    def transfer_times(self) -> Dict[str, List[tuple]]:
        """On the card: (bytes, device ms) of the last transfers by
        direction ("spill", "prefetch"), from the events recorded around
        each (waits for them). Empty on the CPU."""
        out: Dict[str, List[tuple]] = {"spill": [], "prefetch": []}
        for direction, nbytes, start, end in self._timed:
            end.synchronize()
            out[direction].append((nbytes, start.elapsed_time(end)))
        return out

    # ---------------------------------------------------------- device ops
    def commit_prefill(self, kv_state, slot_ids, lengths) -> None:
        """Scatter the prefill program's per-head K/V (`[Bp, S, h, d]` per
        layer; over a mesh this rank's heads, as the prefill lowering
        leaves them for the cache) into the pools of the slots in
        `slot_ids`. Positions past lengths[r] (right padding) and past the
        slot's pages go to the scratch page."""
        pt = self.state[PAGE_TABLE_KEY].long()
        slot_ids = self._put(slot_ids, np.int64)
        lengths = self._put(lengths, np.int64)
        pages = pt[slot_ids]                                  # [Bp, pps]
        for name in self.attn_layers:
            kh, vh = kv_state[name]["k"], kv_state[name]["v"]
            st = self.state[name]
            page = st["k"].shape[1]
            t = torch.arange(kh.shape[1], device=self.device)
            pg = t // page
            in_range = pg < pages.shape[1]
            pageix = torch.where(in_range[None, :],
                                 pages[:, pg.clamp(max=pages.shape[1] - 1)],
                                 torch.zeros_like(pages[:, :1]))
            valid = t[None, :] < lengths[:, None]
            pageix = torch.where(valid, pageix, torch.zeros_like(pageix))
            off = (t % page)[None, :].expand_as(pageix)
            if self.quantized:
                qk, ks = kv_quantize(kh)
                qv, vs = kv_quantize(vh)
                st["k"][pageix, off] = qk
                st["v"][pageix, off] = qv
                st["k_scale"][pageix, off] = ks
                st["v_scale"][pageix, off] = vs
            else:
                st["k"][pageix, off] = kh.to(st["k"].dtype)
                st["v"][pageix, off] = vh.to(st["v"].dtype)

    def adopt(self, new_state) -> None:
        """Take ownership of the state returned by a decode step."""
        self.state = new_state

    def device_bytes(self) -> int:
        """Pool bytes (values and, for int8, scales) held on the device:
        over a mesh this rank's heads, the bytes a device holds."""
        return sum(int(leaf.numel() * leaf.element_size())
                   for n in self.attn_layers for leaf in self.state[n].values())


# -------------------------------------------------- prefetch-ahead autotune
def learned_kv_transfer_seconds(cfg, spec: KVCacheSpec,
                                quantized: bool = False, machine=None,
                                pages: Optional[int] = None
                                ) -> Optional[float]:
    """Learned seconds for one slot-sized host<->device refill, or None
    when no learned model resolves a `kv_transfer` prediction (`cfg` asks
    for no learned model, the file is missing, or the model never saw the
    kind). The features are those `PagedKVCache._transfer_row` writes for
    a prefetch, so a model refit from the cache's own serving telemetry
    prices this query."""
    import os

    from flexflow_tpu_torch.search import memo
    from flexflow_tpu_torch.search.learned_cost import (LearnedCostModel,
                                                        named_model_path)

    path = named_model_path(cfg)
    if path is None or not os.path.isfile(path):
        return None
    model = LearnedCostModel.load(path)
    n_pages = int(pages if pages is not None else spec.pages_per_slot)
    moved = spec.layers * n_pages * spec.page_bytes()
    host_bw = getattr(machine, "host_bw", 0.0) or 16e9
    predicted = moved / host_bw
    page_shape = [n_pages, spec.page_size, spec.heads, spec.head_dim]
    features = {
        "op": "kv_transfer", "in_shapes": [page_shape],
        "out_shapes": [page_shape], "weight_shapes": [],
        "dtype": "int8" if quantized else "float32",
        "params": 0, "layout": "prefetch",
        "sharding": {"out": [], "weights": []},
        "machine": (memo.machine_fingerprint(machine)
                    if machine is not None else ()),
    }
    return model.predict_features(features, predicted_s=predicted,
                                  roofline_s=predicted)


def derive_prefetch_ahead(transfer_s: Optional[float],
                          decode_step_s: Optional[float],
                          fallback: int) -> int:
    """The rotation lead (decode steps) that hides one slot refill behind
    decode compute: ceil(transfer time / decode step time), clamped to
    [1, 64]. Falls back to the `kv_prefetch_ahead` value when either side
    of the ratio is unavailable."""
    if not transfer_s or not decode_step_s or decode_step_s <= 0:
        return max(1, int(fallback))
    return max(1, min(64, -(-int(transfer_s * 1e9)
                            // max(1, int(decode_step_s * 1e9)))))
