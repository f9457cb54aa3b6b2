"""KV-cache pools for continuous batching: slotted and paged.

The port of ``repro/serve/kv_cache.py``.  ``SlotKVCache`` is the
slot-span pool: one cache of ``n_slots`` rows of ``max_len`` positions and
a host-side free list over slot indices; every slot reserves ``max_len``
positions whether it needs them or not.  ``PagedKVCache`` replaces the
span per slot with fixed-size *pages*: each cache leaf becomes a pool of
``n_pages`` pages of ``page_size`` positions, and every slot holds a page
*table*, the list a paged decode gathers (``api.decode_step_paged``).
Pages are allocated as generation crosses page boundaries, so KV memory is
bound by live tokens (rounded up to a page), not by the longest request.

Both pools stack the layers, each leaf of ``api.cache_keys(cfg)`` (L, N,
...): GQA's ``{"k", "v"}``, each (L, N, Hkv, T, dh), or MLA's compressed
``{"c_kv", "k_rope"}``, each (L, N, T, c); a recurrent config's slotted
pool stacks each leaf over the layers of its kind (``"mlstm.c"``,
``"rec.conv"``, ``"attn.k"``, ...) at the reference's initial values, and
a slot's admission overwrites its every leaf; all on the pool's device
(``device="cuda"`` unless the caller passes ``"cpu"``), created and
written under ``torch.inference_mode()``.  Freeing a slot or a
page is host-side bookkeeping: stale device state is never read again (the
attention mask ``kv_len = pos + 1`` hides it, and the paged writes drop
the sentinel page id).  The free lists are LIFO over descending stacks, as
in the reference, so the lowest free slot or page comes first.

With ``kv_quant="int8"`` the paged leaves are stored int8 with one fp32
absmax scale a page (over every layer, as the reference's stacked leaf
gives), dequantized in the decode's gather.  A dense MLA model's pages of
``{"c_kv", "k_rope"}`` have one scale a key, as its reference tree stacks
all L layers in ``blocks``; the ``mla_moe`` tree stacks its dense and its
MoE layers apart, so each page has one scale a stack there:
``"dense_blocks.c_kv"``, ``"moe_blocks.c_kv"``, ... (``api.scale_stacks``),
while the port's pool still stacks all L layers in one tensor.

The encoder-decoder's pools (``src_len``: its memory's frames) hold the
cross-attention's K and V, ``{"cross.k", "cross.v"}`` (L, N, Hkv,
src_len, dh), beside the decoder's self K and V.  Their size does not grow
with ``max_len``, so a paged pool keeps them slot-resident, (L, n_slots,
...) beside its pages, at the model's dtype under ``kv_quant`` too, as the
reference keeps them (``api.resident_keys``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchCfg
from repro_torch.core.dispatch import check_device
from repro_torch.models import api
from repro_torch.models.blocks import RECURRENT, cache_len, dtype_of


def _zeros(cfg: ArchCfg, n: int, length: int, dtype, device, *,
           src_len: int = 0, keys=None) -> dict:
    return {key: torch.zeros(api.kv_shape(cfg, n, length, key, src_len),
                             dtype=dtype, device=device)
            for key in keys or api.cache_keys(cfg)}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class SlotKVCache:
    """Fixed-capacity slot pool with a free-list allocator.

    Attributes
    ----------
    leaves:      ``{"k", "v"}``, each (L, n_slots, Hkv, T, dh), T =
                 ``max_len``, or a windowed config's ring of ``min(max_len,
                 window)`` positions; MLA's ``{"c_kv", "k_rope"}``, each
                 (L, n_slots, T, c); a recurrent config's stacked by layer
                 kind, ``"<kind>.<leaf>"`` (L of that kind, n_slots, ...)
                 (``api.cache_keys``), fp32 states (but RG-LRU's ``conv``)
                 and the local attention layers' rings; the
                 encoder-decoder's ``{"k", "v"}`` and ``{"cross.k",
                 "cross.v"}`` (L, n_slots, Hkv, src_len, dh).
    cache:       the model's per-layer views of them (``api.layer_views``),
                 what ``api.decode_step_slots`` takes.
    lengths:     (n_slots,) int32, valid kv length per slot (prompt +
                 generated); 0 for free slots.
    positions:   (n_slots,) int32, absolute position the slot's pending
                 token will be written at on the next decode step.
    alloc_count / free_count: lifetime counters (leak check: after a
                 drain ``alloc_count == free_count`` and
                 ``n_free == n_slots``).
    """

    def __init__(self, cfg: ArchCfg, n_slots: int, max_len: int, *,
                 src_len: int = 0, device="cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.device = check_device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.src_len = src_len
        with torch.inference_mode():
            if cfg.block in RECURRENT:     # the states' initial values
                self.leaves = api.stack_layers(api.init_cache(
                    cfg, n_slots, max_len, device=self.device), cfg)
            else:
                self.leaves = _zeros(cfg, n_slots, cache_len(cfg, max_len),
                                     dtype_of(cfg), self.device,
                                     src_len=src_len)
        self.cache = api.layer_views(self.leaves, cfg)
        self.lengths = np.zeros(n_slots, np.int32)
        self.positions = np.zeros(n_slots, np.int32)
        self.alloc_count = 0
        self.free_count = 0
        # LIFO over a descending stack => lowest free slot allocated first
        # (deterministic placement for tests and reproducible runs).
        self._free = list(range(n_slots - 1, -1, -1))

    # ---------------- allocator ----------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.n_slots

    def alloc(self) -> int | None:
        """Pop a free slot index, or None when the pool is full."""
        if not self._free:
            return None
        self.alloc_count += 1
        return self._free.pop()

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if slot in self._free:
            raise ValueError(f"double free of slot {slot}")
        self.free_count += 1
        self.lengths[slot] = 0
        self.positions[slot] = 0
        self._free.append(slot)

    # ---------------- device state ----------------

    def request_cache(self):
        """A new batch-1 cache (a prefill's target): zeros, a recurrent
        layer's state at the reference's initial values.  New on every
        call: the port's prefill writes in place, so a chunked prefill's
        staging view and a one-shot admission in the same step must not
        share one, every prefill starts from zeros past its prompt, and a
        recurrent prefill from the initial state, whatever the slot held
        before."""
        with torch.inference_mode():
            return api.init_cache(self.cfg, 1, self.max_len, self.src_len,
                                  device=self.device)

    def insert(self, slot: int, request_cache) -> None:
        """Copy a prefilled batch-1 cache into ``slot``'s row: every leaf,
        a recurrent state whole."""
        with torch.inference_mode():
            one = api.stack_layers(request_cache, self.cfg)
            for key, leaf in self.leaves.items():
                leaf[:, slot] = one[key][:, 0]

    def kv_bytes(self) -> int:
        """Device bytes held by the pool (for capacity-per-GB reporting)."""
        return _nbytes(self.leaves.values())


class PagedKVCache:
    """Paged KV pool: page-pool leaves + per-slot page tables.

    Layout
    ------
    data:        ``{"k", "v"}``, each (L, n_pages, Hkv, page_size, dh),
                 int8 with ``kv_quant``, else the model's dtype; MLA's
                 ``{"c_kv", "k_rope"}``, each (L, n_pages, page_size, c);
                 the encoder-decoder's slot-resident ``{"cross.k",
                 "cross.v"}`` beside them, each (L, n_slots, Hkv,
                 src_len, dh) of the model's dtype.
    page_tables: (n_slots, pages_per_slot) int32.  Row ``s`` lists slot
                 ``s``'s pages in position order; entries past the
                 allocation hold the sentinel ``n_pages`` (clipped on
                 gather, dropped on every write).
    scales:      with ``kv_quant``, (n_pages,) fp32 per-page scales of
                 the paged leaves, keyed as ``api.scale_stacks`` says
                 (``{"k", "v"}``; MLA's by stack and key), else None;
                 ``view_dtype`` is the dtype the pages are dequantized to.
    lengths / positions: as in :class:`SlotKVCache`.

    The allocator is host-side and O(1) per op: a slot free list plus a
    page free list, with lifetime counters for leak checks
    (``page_alloc_count == page_free_count`` after a drain).
    """

    def __init__(self, cfg: ArchCfg, n_slots: int, max_len: int, *,
                 page_size: int, n_pages: int | None = None,
                 src_len: int = 0, kv_quant: str | None = None,
                 device="cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if not api.supports_paging(cfg):
            raise ValueError(
                f"paging is not supported for block={cfg.block!r} "
                f"(window={cfg.window}, n_patches={cfg.n_patches})")
        if kv_quant is not None and kv_quant != "int8":
            raise ValueError(
                f"kv_quant={kv_quant!r}: only 'int8' page storage is "
                "supported")
        self.device = check_device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.page_size = page_size
        self.pages_per_slot = -(-max_len // page_size)
        self.max_len = self.pages_per_slot * page_size   # page-aligned view
        self.src_len = src_len
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * self.pages_per_slot)
        if self.n_pages < self.pages_per_slot:
            raise ValueError(
                f"n_pages={self.n_pages} cannot hold even one full slot "
                f"({self.pages_per_slot} pages)")
        self.kv_quant = kv_quant
        self.view_dtype = dtype_of(cfg)
        resident = api.resident_keys(cfg)
        paged = tuple(k for k in api.cache_keys(cfg) if k not in resident)
        with torch.inference_mode():
            self.data = _zeros(cfg, self.n_pages, page_size,
                               torch.int8 if kv_quant else self.view_dtype,
                               self.device, keys=paged)
            if resident:
                self.data.update(_zeros(cfg, n_slots, page_size,
                                        self.view_dtype, self.device,
                                        src_len=src_len, keys=resident))
            self.scales = ({skey: torch.zeros(self.n_pages,
                                              dtype=torch.float32,
                                              device=self.device)
                            for key in paged
                            for skey, _, _ in api.scale_stacks(cfg, key)}
                           if kv_quant else None)

        self.lengths = np.zeros(n_slots, np.int32)
        self.positions = np.zeros(n_slots, np.int32)
        # sentinel n_pages: clipped on gather, dropped on every write
        self.page_tables = np.full((n_slots, self.pages_per_slot),
                                   self.n_pages, np.int32)
        self.pages_used = np.zeros(n_slots, np.int32)
        self.alloc_count = 0
        self.free_count = 0
        self.page_alloc_count = 0
        self.page_free_count = 0
        self._free = list(range(n_slots - 1, -1, -1))
        self._free_pages = list(range(self.n_pages - 1, -1, -1))

    # ---------------- allocator ----------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.n_slots

    @property
    def page_occupancy(self) -> float:
        return 1.0 - len(self._free_pages) / self.n_pages

    @property
    def fragmentation(self) -> float:
        """Allocated-but-dead fraction: 1 - live tokens / paged capacity.

        Internal fragmentation only (partially filled trailing pages):
        fixed-size pages cannot fragment externally.
        """
        cap = int(self.pages_used.sum()) * self.page_size
        if cap == 0:
            return 0.0
        return 1.0 - float(self.lengths.sum()) / cap

    def alloc(self) -> int | None:
        """Pop a free slot index, or None when the pool is full."""
        if not self._free:
            return None
        self.alloc_count += 1
        return self._free.pop()

    def alloc_pages(self, slot: int, n: int) -> bool:
        """Append ``n`` pages to ``slot``'s table; all-or-nothing."""
        if n <= 0:
            return True
        used = int(self.pages_used[slot])
        if used + n > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {used}+{n} pages exceeds pages_per_slot="
                f"{self.pages_per_slot}")
        if len(self._free_pages) < n:
            return False
        for i in range(n):
            self.page_tables[slot, used + i] = self._free_pages.pop()
        self.pages_used[slot] = used + n
        self.page_alloc_count += n
        return True

    def ensure(self, slot: int, pos: int) -> bool:
        """Make sure the page containing position ``pos`` is allocated."""
        need = pos // self.page_size + 1
        return self.alloc_pages(slot, need - int(self.pages_used[slot]))

    def free(self, slot: int) -> None:
        """Release a slot and every page it holds."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if slot in self._free:
            raise ValueError(f"double free of slot {slot}")
        used = int(self.pages_used[slot])
        for i in range(used):
            self._free_pages.append(int(self.page_tables[slot, i]))
        self.page_free_count += used
        self.page_tables[slot, :] = self.n_pages
        self.pages_used[slot] = 0
        self.free_count += 1
        self.lengths[slot] = 0
        self.positions[slot] = 0
        self._free.append(slot)

    # ---------------- device state ----------------

    def request_cache(self):
        """A new zeroed batch-1 cache view (a prefill's target), length
        ``pages_per_slot * page_size``; new on every call, as
        :meth:`SlotKVCache.request_cache` says why."""
        with torch.inference_mode():
            return api.init_cache(self.cfg, 1, self.max_len, self.src_len,
                                  device=self.device)

    def insert(self, slot: int, request_cache, n_valid: int) -> bool:
        """Allocate pages for ``n_valid`` positions and write a prefilled
        batch-1 view into them (the view's pages past the allocation are
        dropped, as the reference's sentinel ids are), and its
        slot-resident leaves into ``slot``'s row.  False (nothing changed)
        when the page pool cannot cover the request yet: retryable next
        step."""
        need = -(-n_valid // self.page_size) - int(self.pages_used[slot])
        if not self.alloc_pages(slot, need):
            return False
        table = self.page_tables[slot].astype(np.int64)
        live = np.nonzero(table < self.n_pages)[0]
        src = torch.as_tensor(live, device=self.device)
        dst = torch.as_tensor(table[live], device=self.device)
        with torch.inference_mode():
            one = api.stack_layers(request_cache)
            for key in self.data:
                if key in api.resident_keys(self.cfg):
                    self.data[key][:, slot] = one[key][:, 0]
                    continue
                pages = api.view_to_pages(one[key][:, 0],
                                          self.page_size)[:, src]
                if self.scales is not None:
                    pages, sc = api._quant_pages(
                        pages, api.scale_stacks(self.cfg, key))
                    for skey, page_scales in sc.items():
                        self.scales[skey][dst] = page_scales
                self.data[key][:, dst] = pages
        return True

    def kv_bytes(self) -> int:
        """Device bytes held by the pool (pages + scales)."""
        return _nbytes([*self.data.values(),
                        *(self.scales or {}).values()])
