"""Block-paged KV-cache pool with hash-based prefix sharing (host side).

The dense engine kept one ``(slots, max_len)`` KV row per stage — admission
was bounded by *worst-case* residency and identical prompt prefixes (system
prompts, few-shot headers) were recomputed and stored once per request.
This module replaces the row bookkeeping with fixed-size **pages**:

* a page pool of ``num_pages`` physical pages of ``page_tokens`` tokens each
  (device arrays live in the stage executor; this class owns the *logical*
  state: the page table, refcounts, hashes, free list, LRU),
* a per-slot int32 **page table** ``[slots, pages_per_slot]`` mapping logical
  page index → physical page id (``-1`` = unmapped; the device side clamps
  unmapped/invalid writes to a reserved trash page),
* **prefix sharing**: page-aligned prompt prefixes are chain-hashed; a full
  page whose hash is registered is reused by reference (refcount++) and its
  prefill chunks are skipped entirely,
* **copy-on-write**: a partially matched page (the prefix diverges mid-page,
  or the last reusable token lands mid-page) is copied into a fresh page at
  admission — the only moment a paged slot ever writes inside a shared
  page — so steady-state decode never touches a page it does not own,
* **LRU eviction**: a registered page whose refcount drops to zero parks in
  an LRU ring instead of the free list (a future identical prefix can still
  hit it); allocation under pressure evicts the oldest unreferenced page.

Invariants (property-tested in ``tests/test_paged_kv.py``):
  * a physical page is referenced by table entries exactly ``refcount`` times,
  * no page is both free and mapped, and no referenced page is ever evicted,
  * ``free + lru + in_use`` always partitions the pool.

The device-side layout contract (see ``models/layers.py`` and
``kernels/flash_attention``): pools are ``[num_pages + 1, page_tokens, KV,
head_dim]`` per layer — index ``num_pages`` is the reserved TRASH page that
absorbs masked writes — and the flat token index of logical position ``t``
of slot ``b`` is ``table[b, t // P] * P + t % P``.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["KVPool", "StrictKVPool", "pages_needed"]


def pages_needed(tokens: int, page_tokens: int) -> int:
    """Pages required to hold ``tokens`` cache entries (≥ 0)."""
    if tokens <= 0:
        return 0
    return -(-int(tokens) // int(page_tokens))


def _chain_hash(prev: Optional[bytes], tokens: Sequence[int]) -> bytes:
    """Chain hash of one page given the previous page's hash: identical
    prefixes — not merely identical pages — map to the same key."""
    h = hashlib.sha256()
    h.update(prev or b"root")
    h.update(np.asarray(tokens, dtype=np.int64).tobytes())
    return h.digest()


class KVPool:
    """Logical state of a block-paged KV cache for ``slots`` serving slots.

    Args:
        slots: serving-slot count (page-table rows).
        max_len: per-slot logical capacity in tokens.
        page_tokens: tokens per page (``P``); ``max_len`` is rounded up to a
            page multiple internally.
        num_pages: physical pool size; default ``slots × pages_per_slot``
            (capacity-equivalent to the dense cache — sharing then frees
            headroom instead of being required for feasibility).
        prefix_sharing: enable the hash registry / LRU reuse path; off, every
            allocation is private and the pool degrades to plain paging.
    """

    def __init__(
        self,
        slots: int,
        max_len: int,
        page_tokens: int,
        *,
        num_pages: Optional[int] = None,
        prefix_sharing: bool = True,
    ):
        if page_tokens <= 0:
            raise ValueError(f"page_tokens must be positive, got {page_tokens}")
        if slots <= 0:
            raise ValueError(f"slots must be positive, got {slots}")
        self.slots = int(slots)
        self.page_tokens = int(page_tokens)
        self.pages_per_slot = pages_needed(max_len, page_tokens)
        self.max_len = self.pages_per_slot * self.page_tokens
        self.num_pages = (
            int(num_pages)
            if num_pages is not None
            else self.slots * self.pages_per_slot
        )
        if self.num_pages < self.pages_per_slot:
            raise ValueError(
                f"pool of {self.num_pages} pages cannot hold even one "
                f"{self.pages_per_slot}-page slot"
            )
        self.prefix_sharing = bool(prefix_sharing)

        self.table = np.full(
            (self.slots, self.pages_per_slot), -1, dtype=np.int32
        )
        self.refcount = np.zeros(self.num_pages, dtype=np.int32)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        # chain_hash -> page id (registered, immutable, full prompt pages)
        self._registry: Dict[bytes, int] = {}
        self._page_hash: Dict[int, bytes] = {}      # inverse of _registry
        # page id -> token contents (host copy, for partial-page matching)
        self._page_tokens_map: Dict[int, List[int]] = {}
        # refcount-0 registered pages, oldest first (eviction order)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # counters for accounting / tests
        self.stats_alloc = 0
        self.stats_reused_pages = 0
        self.stats_evicted = 0
        self.stats_cow_copies = 0

    # ------------------------------------------------------------- queries
    def pages_in_use(self) -> int:
        """Physical pages referenced by at least one slot (shared pages
        count ONCE — the quantity Eq. 5's page term charges)."""
        return int(np.count_nonzero(self.refcount > 0))

    def free_pages(self) -> int:
        return len(self._free)

    def evictable_pages(self) -> int:
        return len(self._lru)

    def available_pages(self) -> int:
        """Pages an allocation could obtain: free now, plus LRU-evictable."""
        return len(self._free) + len(self._lru)

    def table_array(self) -> np.ndarray:
        """The page table, trash-clamped for the device side: unmapped
        entries point at the reserved trash page ``num_pages``."""
        return np.where(self.table >= 0, self.table, self.num_pages).astype(
            np.int32
        )

    def check_invariants(self) -> None:
        """Raise AssertionError when the pool's bookkeeping is inconsistent
        (test hook; cheap enough to call per-step in property tests)."""
        counts = np.zeros(self.num_pages, dtype=np.int64)
        for pid in self.table[self.table >= 0]:
            counts[pid] += 1
        assert np.array_equal(counts, self.refcount), (
            "refcounts disagree with table references"
        )
        free = set(self._free)
        lru = set(self._lru)
        mapped = set(int(p) for p in self.table[self.table >= 0])
        assert not (free & mapped), "free page still mapped"
        assert not (lru & mapped), "LRU page still mapped"
        assert not (free & lru), "page both free and LRU"
        assert len(free) + len(lru) + len(mapped) == self.num_pages, (
            "free/LRU/in-use do not partition the pool"
        )
        for h, pid in self._registry.items():
            assert self._page_hash.get(pid) == h, "registry/page_hash skew"

    # ------------------------------------------------------- alloc helpers
    def _evict_one(self) -> int:
        """Reclaim the LRU-oldest unreferenced registered page."""
        pid, _ = self._lru.popitem(last=False)
        h = self._page_hash.pop(pid, None)
        if h is not None:
            self._registry.pop(h, None)
        self._page_tokens_map.pop(pid, None)
        self.stats_evicted += 1
        return pid

    def _take_page(self) -> int:
        if self._free:
            pid = self._free.pop()
        elif self._lru:
            pid = self._evict_one()
        else:
            raise RuntimeError("page pool exhausted (admission bug)")
        self.refcount[pid] = 1
        self.stats_alloc += 1
        return pid

    def _release_page(self, pid: int) -> None:
        """Refcount drops to zero: registered pages park in the LRU ring
        (a later identical prefix can still reuse them), private pages
        return straight to the free list."""
        if pid in self._page_hash:
            self._lru[pid] = None
            self._lru.move_to_end(pid)
        else:
            self._page_tokens_map.pop(pid, None)
            self._free.append(pid)

    # ------------------------------------------------------------ matching
    def lookup_prefix(self, tokens: Sequence[int]) -> int:
        """Longest reusable prefix (token count) of ``tokens`` without
        touching any state — the admission-time estimate."""
        if not self.prefix_sharing:
            return 0
        P = self.page_tokens
        matched = 0
        prev: Optional[bytes] = None
        for i in range(len(tokens) // P):
            h = _chain_hash(prev, tokens[i * P : (i + 1) * P])
            if h not in self._registry:
                break
            prev = h
            matched += P
        # partial match inside the next registered page (token-by-token):
        # the genuine copy-on-write trigger — the sharer's first write lands
        # inside that shared page, so alloc copies it at admission
        if matched < len(tokens):
            tail = tokens[matched:]
            best = 0
            for pid, toks in self._page_tokens_map.items():
                if pid not in self._page_hash:
                    continue
                if self._parent_hash(pid) != (prev or b"root"):
                    continue
                m = 0
                for a, b in zip(tail, toks):
                    if a != b:
                        break
                    m += 1
                best = max(best, m)
            matched += min(best, P)
        return matched

    def _parent_hash(self, pid: int) -> bytes:
        return self._page_parent.get(pid, b"root")

    # parent-chain map is lazily created (older pickles/tests without it)
    @property
    def _page_parent(self) -> Dict[int, bytes]:
        if not hasattr(self, "_page_parent_map"):
            self._page_parent_map: Dict[int, bytes] = {}
        return self._page_parent_map

    def can_admit(self, tokens: Sequence[int], total_len: int) -> bool:
        """Would :meth:`alloc_sequence` succeed for a sequence whose cache
        will grow to ``total_len`` tokens?  (Reused full pages cost nothing;
        everything else — including the COW copy — needs a page.)"""
        total_len = min(int(total_len), self.max_len)
        reuse = min(self.lookup_prefix(tokens), max(len(tokens) - 1, 0))
        full_reused = reuse // self.page_tokens
        need = pages_needed(total_len, self.page_tokens) - full_reused
        return need <= self.available_pages()

    # ---------------------------------------------------------- lifecycle
    def alloc_sequence(
        self, slot: int, tokens: Sequence[int], total_len: int
    ) -> Tuple[int, List[Tuple[int, int]]]:
        """Map ``slot`` for a sequence of prompt ``tokens`` growing to
        ``total_len`` cache entries.  Returns ``(reused_tokens, copies)``:

        * ``reused_tokens`` — prompt tokens whose KV is already resident
          (shared prefix pages; the engine skips their prefill chunks), and
        * ``copies`` — ``(src_page, dst_page)`` device-side page copies the
          caller must apply (the admission-time COW of a partially matched
          page).

        At most ``len(tokens) - 1`` tokens are ever reused: the engine must
        still run the LAST prompt token to obtain next-token logits, and a
        partially reused page is copied so that recompute never writes into
        a shared page.
        """
        if np.any(self.table[slot] >= 0):
            raise RuntimeError(f"slot {slot} still mapped; free_slot first")
        total_len = min(int(total_len), self.max_len)
        P = self.page_tokens
        reuse = min(self.lookup_prefix(tokens), max(len(tokens) - 1, 0))
        n_total = pages_needed(max(total_len, len(tokens)), P)
        n_full_reused = reuse // P

        copies: List[Tuple[int, int]] = []
        prev: Optional[bytes] = None
        try:
            # 1) shared full pages: reference, never copy
            for i in range(n_full_reused):
                h = _chain_hash(prev, tokens[i * P : (i + 1) * P])
                pid = self._registry[h]
                if self.refcount[pid] == 0:
                    self._lru.pop(pid, None)
                self.refcount[pid] += 1
                self.table[slot, i] = pid
                self.stats_reused_pages += 1
                prev = h
            # 2) partially matched page: COW at admission — the only write
            # into shared territory this slot will ever make happens at
            # token `reuse`, inside this page
            i = n_full_reused
            if reuse > n_full_reused * P:
                src = self._match_child(prev, tokens[i * P :])
                dst = self._take_page()
                copies.append((int(src), int(dst)))
                self._page_tokens_map[dst] = list(
                    self._page_tokens_map.get(src, [])
                )[: reuse - i * P]
                self.table[slot, i] = dst
                self.stats_cow_copies += 1
                i += 1
            # 3) private pages for the rest of the sequence's growth
            while i < n_total:
                self.table[slot, i] = self._take_page()
                i += 1
        except RuntimeError:
            # roll back a partial mapping so the pool stays consistent and
            # the caller can queue the request instead
            self.free_slot(slot)
            raise
        return int(reuse), copies

    def _match_child(self, prev: Optional[bytes], tail: Sequence[int]) -> int:
        """The registered page under parent-hash ``prev`` sharing the longest
        token prefix with ``tail`` (the COW source)."""
        best, best_m = -1, -1
        for pid, toks in self._page_tokens_map.items():
            if pid not in self._page_hash:
                continue
            if self._parent_hash(pid) != (prev or b"root"):
                continue
            m = 0
            for a, b in zip(tail, toks):
                if a != b:
                    break
                m += 1
            if m > best_m:
                best, best_m = pid, m
        if best < 0:
            raise RuntimeError("partial prefix match lost its source page")
        return best

    def commit_prefix(self, slot: int, prompt_tokens: Sequence[int]) -> None:
        """Register ``slot``'s full prompt pages in the hash registry (called
        at prefill completion, when their KV is resident): later requests
        with the same page-aligned prefix reuse them by reference."""
        if not self.prefix_sharing:
            return
        P = self.page_tokens
        prev: Optional[bytes] = None
        for i in range(len(prompt_tokens) // P):
            pid = int(self.table[slot, i])
            if pid < 0:
                break
            page_toks = list(prompt_tokens[i * P : (i + 1) * P])
            h = _chain_hash(prev, page_toks)
            if h not in self._registry and pid not in self._page_hash:
                self._registry[h] = pid
                self._page_hash[pid] = h
                self._page_parent[pid] = prev or b"root"
                self._page_tokens_map[pid] = page_toks
            prev = h

    def free_slot(self, slot: int) -> None:
        """Drop every page reference of ``slot`` (request retired / rolled
        back); refcount-0 pages go to the LRU ring (registered) or the free
        list (private)."""
        for i in range(self.pages_per_slot):
            pid = int(self.table[slot, i])
            if pid < 0:
                continue
            self.table[slot, i] = -1
            self.refcount[pid] -= 1
            assert self.refcount[pid] >= 0, f"refcount underflow on page {pid}"
            if self.refcount[pid] == 0:
                self._release_page(pid)

    def stats(self) -> Dict[str, int]:
        return {
            "pages_in_use": self.pages_in_use(),
            "free_pages": self.free_pages(),
            "evictable_pages": self.evictable_pages(),
            "alloc": self.stats_alloc,
            "reused_pages": self.stats_reused_pages,
            "cow_copies": self.stats_cow_copies,
            "evicted": self.stats_evicted,
            "registered": len(self._registry),
        }


# --------------------------------------------------------------------------
# the port's pool: the class above stays a verbatim copy of the reference's;
# the two admission faults it carries are repaired here
# --------------------------------------------------------------------------


class StrictKVPool(KVPool):
    """:class:`KVPool` whose :meth:`can_admit` is exact, and whose
    copy-on-write never evicts its own source while another page can be had.

    * ``KVPool.can_admit`` counts every LRU page as obtainable, including
      the refcount-0 prefix pages the admission itself takes off the LRU
      ring to reuse, and bills ``total_len`` pages where
      :meth:`alloc_sequence` maps ``max(total_len, len(tokens))``.  It can
      then admit what ``alloc_sequence`` cannot map ("page pool exhausted").
      Here every page the admission takes — the COW copy and the private
      pages — is billed against the free pages plus the LRU pages it does
      not reuse, which is exactly what ``alloc_sequence`` can obtain.
    * In the COW branch, ``_take_page`` evicts the LRU-oldest page, which
      can be the page ``_match_child`` just picked as the copy's source.
      Here the source moves to the LRU's young end for the admission, so it
      is evicted only when no other page is obtainable; the slot then owns
      the source page itself, whose rows below the reused length already
      hold the matched prefix, and the copy pair is an identity.
    """

    _cow_source: Optional[int] = None

    def can_admit(self, tokens: Sequence[int], total_len: int) -> bool:
        total_len = min(int(total_len), self.max_len)
        P = self.page_tokens
        reuse = min(self.lookup_prefix(tokens), max(len(tokens) - 1, 0))
        n_full = reuse // P
        need = pages_needed(max(total_len, len(tokens)), P) - n_full
        # refcount-0 pages this admission reuses leave the LRU ring as
        # references, not as takes: they are not obtainable for the rest
        held = 0
        prev: Optional[bytes] = None
        for i in range(n_full):
            prev = _chain_hash(prev, tokens[i * P : (i + 1) * P])
            if self.refcount[self._registry[prev]] == 0:
                held += 1
        return need <= self.available_pages() - held

    def alloc_sequence(
        self, slot: int, tokens: Sequence[int], total_len: int
    ) -> Tuple[int, List[Tuple[int, int]]]:
        try:
            return super().alloc_sequence(slot, tokens, total_len)
        finally:
            self._cow_source = None

    def _match_child(self, prev: Optional[bytes], tail: Sequence[int]) -> int:
        src = super()._match_child(prev, tail)
        self._cow_source = src
        return src

    def _take_page(self) -> int:
        src = self._cow_source
        if src is not None and src in self._lru:
            self._lru.move_to_end(src)
        return super()._take_page()
