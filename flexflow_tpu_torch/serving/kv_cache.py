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
The host tier of the JAX package is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

PAGE_TABLE_KEY = "serve/page_table"
POS_KEY = "serve/pos"
ACTIVE_KEY = "serve/active"


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Paged KV-cache geometry (copied from flexflow_tpu/search/cost_model.py,
    without the host tier)."""

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

    @property
    def padded_len(self) -> int:
        """Max cached positions per sequence (page-rounded)."""
        return self.pages_per_slot * self.page_size

    @property
    def pool_pages(self) -> int:
        """Pages in one pool: every slot's worth plus scratch."""
        return self.slots * self.pages_per_slot + 1

    def page_bytes(self) -> int:
        """K + V bytes of ONE page of ONE layer, scales included."""
        return (2 * self.page_size * self.heads
                * (self.head_dim * self.itemsize + self.scale_itemsize))

    def layer_bytes(self) -> int:
        return self.pool_pages * self.page_bytes()

    def total_bytes(self) -> int:
        return self.layers * self.layer_bytes()


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


class PagedKVCache:
    """Device-resident paged KV pools + host-side page accounting."""

    def __init__(self, spec: KVCacheSpec, attn_layers: List[str], *, device,
                 dtype: torch.dtype = torch.float32, quantized: bool = False):
        # `device` has no default: the engine passes the one it resolved
        self.spec = spec
        self.attn_layers = list(attn_layers)
        self.quantized = bool(quantized)
        self.device = torch.device(device)
        shape = (spec.pool_pages, spec.page_size, spec.heads, spec.head_dim)
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
        self._push_tables()

    # ------------------------------------------------------------ host ops
    def _put(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, np.int32)).to(self.device)

    def _push_tables(self) -> None:
        self.state[PAGE_TABLE_KEY] = self._put(self._table)
        self.state[POS_KEY] = self._put(self._pos)
        self.state[ACTIVE_KEY] = self._put(self._active)

    def free_slots(self) -> List[int]:
        return [i for i in range(self.spec.slots) if not self._active[i]]

    def pages_needed(self, total_tokens: int) -> int:
        cap = min(int(total_tokens), self.spec.padded_len)
        return -(-cap // self.spec.page_size)

    def can_admit(self, total_tokens: int) -> bool:
        return len(self.free_pages) >= self.pages_needed(total_tokens)

    def capacity_pages(self) -> int:
        return self.spec.pool_pages - 1

    def admit(self, slot: int, prompt_len: int, total_tokens: int) -> bool:
        """Assign pages for a sequence of up to `total_tokens` positions; the
        slot's position starts at `prompt_len` (where the first decode step
        writes). Raises `KVPoolExhausted` when the free list is short."""
        if self._active[slot]:
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
        """Return the slot's pages to the free list."""
        self.free_pages.extend(self._slot_pages.pop(slot, []))
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

    # ---------------------------------------------------------- device ops
    def commit_prefill(self, kv_state, slot_ids, lengths) -> None:
        """Scatter the prefill program's per-head K/V (`[Bp, S, h, d]` per
        layer) into the pools of the slots in `slot_ids`. Positions past
        lengths[r] (right padding) and past the slot's pages go to the
        scratch page."""
        pt = self.state[PAGE_TABLE_KEY].long()
        slot_ids = torch.as_tensor(np.asarray(slot_ids), device=self.device).long()
        lengths = torch.as_tensor(np.asarray(lengths), device=self.device).long()
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
        """Pool bytes (values and, for int8, scales) held on the device."""
        return sum(int(leaf.numel() * leaf.element_size())
                   for n in self.attn_layers for leaf in self.state[n].values())
