"""Paged KV-cache manager: fixed-size device pages + per-sequence block
tables (counterpart: `paddle_tpu/serving/kv_cache.py`).

The device side is two tensors per decoder layer —
``k_pages``/``v_pages`` of shape [num_pages, page_size, kv_heads,
head_dim] — updated IN PLACE by the serving step (serving/model.py
`index_put_`s only the valid rows). The JAX package rebuilt the page
arrays functionally each step and donated them back; here a step writes
its new K/V rows into the resident tensors and nothing is reallocated.

The host side (this module, copied from the JAX package) is pure
bookkeeping: a free list, one block table per live sequence, and an
occupancy gauge. Allocation is worst-case at admission —
``ceil((prompt + max_new) / page_size)`` pages reserved up front — so a
running request can never strand mid-decode on an empty pool; the trade
is admission-time backpressure (`alloc` returns None and the scheduler
keeps the request queued) instead of mid-flight eviction. `free`
(request finished or cancelled) releases every reference immediately.

Prefix cache (``FLAGS_tpu_serving_prefix_cache``): pages are
refcounted and content-indexed. The index maps
``(parent_key, token_tuple) -> page`` — a hash CHAIN at page
granularity, so a page's identity covers its whole prefix, not just
its own tokens. `alloc(..., prompt=...)` walks the chain: fully
matched pages are SHARED (refcount bumped, zero new pages — admission
is prefix-aware), and a partially matched boundary page is
copy-on-write: the reader gets a fresh page plus a pending device copy
(`take_pending_copies`), because its first divergent write lands in
the very next dispatch. int8 pools copy the per-slot scale arrays
alongside the values — the copy walks the whole per-layer tuple.
Refcount-0 pages that are still indexed park in a CACHED tier (LRU);
admission pressure evicts them (leaves before ancestors — evicting an
ancestor cascades, since the chain below it becomes unreachable).
``FLAGS_tpu_serving_cached_pages`` bounds the parked tier (pages, or
"64mb"-style byte budgets; 0 = the whole free pool is eligible).
Sharing is pure block-table indirection: the attention kernel is
untouched.

``check_invariants()`` is the structural audit (page conservation,
refcounts vs block tables, index bijection, COW targets).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["KVCacheConfig", "PagedKVCache"]

#: page value dtypes the pool understands -> bytes per stored element.
#: "int8" pages additionally carry TWO per-slot fp32 abs-max scales
#: (one for K, one for V) in separate [num_pages, page_size] arrays —
#: the quantization grain is one written token row per kv page slot.
_ELEM_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


@dataclass(frozen=True)
class KVCacheConfig:
    """Shape of the paged pool. ``pages_per_seq`` bounds one sequence's
    block table (max context = pages_per_seq * page_size) and is the
    static gather width of every attention call — fixed per engine, so
    per-row attention math is identical no matter how the batch was
    packed.

    ``dtype`` is the stored page value dtype. "int8" switches the pool
    to quantized pages: per-layer device state grows per-slot fp32
    scale arrays, the model quantizes K/V on write (abs-max over the
    token row) and attention dequantizes through the same block table.
    Admission math is unchanged — pages are pages — but one page costs
    `page_bytes` HBM, so a FIXED byte budget holds ~2x the pages (and
    resident batch) of bfloat16, ~4x of float32 (`pages_for_budget`).
    """

    num_pages: int
    page_size: int
    pages_per_seq: int
    num_layers: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "float32"

    def __post_init__(self):
        if self.num_pages < 1 or self.page_size < 1:
            raise ValueError("need num_pages >= 1 and page_size >= 1")
        if self.pages_per_seq < 1:
            raise ValueError("pages_per_seq must be >= 1")
        if self.dtype not in _ELEM_BYTES:
            raise ValueError(
                "kv page dtype must be one of %s, got %r"
                % (sorted(_ELEM_BYTES), self.dtype))

    @property
    def max_context(self) -> int:
        return self.pages_per_seq * self.page_size

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def elem_bytes(self) -> int:
        return _ELEM_BYTES[self.dtype]

    @property
    def page_bytes(self) -> int:
        """HBM bytes ONE page costs across all layers: K + V values
        plus, when int8, the two per-slot fp32 scale arrays."""
        per_slot = 2 * self.num_kv_heads * self.head_dim * \
            self.elem_bytes
        if self.quantized:
            per_slot += 2 * 4  # k/v per-slot fp32 abs-max scales
        return self.num_layers * self.page_size * per_slot

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the pool's `num_pages` pages (the scratch page
        beside them is not counted)."""
        return self.num_pages * self.page_bytes

    @property
    def scratch_page(self) -> int:
        """The index of the scratch page: one page past the pool, in the
        page tensors but never handed out and named by no block table.
        The serving step writes its inactive rows there, so it writes a
        fixed number of rows (see `serving/model.py`)."""
        return self.num_pages

    @property
    def resident_batch(self) -> int:
        """How many max-context sequences the pool can hold at once —
        the effective resident batch at worst-case admission."""
        return self.num_pages // self.pages_per_seq

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    def pages_for_budget(self, budget_bytes: int) -> int:
        """Pages a fixed HBM byte budget covers at THIS dtype — the
        admission-doubling arithmetic: under one budget an int8 pool
        admits ~2x the bfloat16 resident batch."""
        return int(budget_bytes) // self.page_bytes


#: byte-suffix multipliers for FLAGS_tpu_serving_cached_pages string
#: values ("64mb", "2gb", ...)
_BYTE_SUFFIXES = (("gb", 1 << 30), ("mb", 1 << 20), ("kb", 1 << 10),
                  ("b", 1))


def _parse_cached_budget(value, page_bytes: int) -> Optional[int]:
    """FLAGS_tpu_serving_cached_pages -> parked-tier page budget.
    0/None/"" = unbounded (the whole free pool is eligible). A plain
    integer counts PAGES; a string with a b/kb/mb/gb suffix is a BYTE
    budget, floored to whole pages at this pool's
    page_bytes — so one flag value means the same HBM spend across
    dtypes (an int8 pool parks ~4x the float32 pages)."""
    if value is None:
        return None
    if isinstance(value, str):
        text = value.strip().lower()
        if not text:
            return None
        for suffix, mult in _BYTE_SUFFIXES:
            if text.endswith(suffix):
                num = text[:-len(suffix)].strip()
                try:
                    budget_bytes = float(num) * mult
                except ValueError:
                    raise ValueError(
                        "bad cached-pages budget %r (want pages or "
                        "<n><b|kb|mb|gb>)" % (value,))
                return max(0, int(budget_bytes) // int(page_bytes))
        try:
            value = int(text)
        except ValueError:
            raise ValueError(
                "bad cached-pages budget %r (want pages or "
                "<n><b|kb|mb|gb>)" % (value,))
    pages = int(value)
    if pages < 0:
        raise ValueError("cached-pages budget must be >= 0, got %d"
                         % pages)
    return None if pages == 0 else pages


@dataclass
class _SeqAlloc:
    pages: List[int]
    reserved: int  # worst-case pages reserved at admission
    cached_tokens: int = 0  # prompt tokens covered by the prefix cache
    table: List[int] = field(default_factory=list)


class PagedKVCache:
    """Host-side page accounting for one engine. Not thread-safe by
    itself — the Engine serializes scheduler mutations under its own
    lock."""

    def __init__(self, config: KVCacheConfig,
                 prefix_cache: Optional[bool] = None,
                 cached_pages=None):
        if prefix_cache is None:
            from ..utils.flags import get_flag

            prefix_cache = bool(get_flag(
                "FLAGS_tpu_serving_prefix_cache", True))
        if cached_pages is None:
            from ..utils.flags import get_flag

            cached_pages = get_flag("FLAGS_tpu_serving_cached_pages", 0)
        self.config = config
        self.prefix_cache = bool(prefix_cache)
        self.cached_pages_budget = _parse_cached_budget(
            cached_pages, config.page_bytes)
        self._free: List[int] = list(range(config.num_pages))
        self._ref: List[int] = [0] * config.num_pages
        self._seqs: Dict[int, _SeqAlloc] = {}
        # prefix index: (parent_key, token_tuple) -> page. Keys chain
        # through FULL pages (a page's key embeds its whole prefix);
        # sub-page tails register as leaf entries with < page_size
        # tokens. One key per page and one page per key.
        self._index: Dict[tuple, int] = {}
        self._page_key: Dict[int, tuple] = {}
        self._children: Dict[tuple, List[int]] = {}
        # refcount-0 pages still worth matching, LRU order (front =
        # evict first); free() parks leaves before their ancestors
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._pending_copies: List[Tuple[int, int]] = []
        self._peak_in_use = 0
        self._prefix_hit_tokens = 0
        self._cow_copies = 0
        self._evictions = 0
        self._budget_evictions = 0

    # -- pool state --------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        """PHYSICAL pages referenced by at least one live sequence —
        a page shared by N block tables counts once, and parked
        (cached-tier) pages do not count at all."""
        return self.config.num_pages - len(self._free) - \
            len(self._cached)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_cached(self) -> int:
        """Refcount-0 pages parked in the prefix cache (reclaimable
        under admission pressure)."""
        return len(self._cached)

    @property
    def occupancy(self) -> float:
        return self.pages_in_use / float(self.config.num_pages)

    @property
    def peak_pages_in_use(self) -> int:
        return self._peak_in_use

    @property
    def prefix_hit_tokens(self) -> int:
        """Cumulative prompt tokens admissions covered from the cache
        (tokens that will never be prefilled)."""
        return self._prefix_hit_tokens

    @property
    def cow_copies(self) -> int:
        return self._cow_copies

    @property
    def evictions(self) -> int:
        return self._evictions

    @property
    def budget_evictions(self) -> int:
        """Parked pages evicted by the cached_pages budget alone (a
        subset of `evictions`; admission-pressure evictions are the
        rest)."""
        return self._budget_evictions

    def can_admit(self, total_tokens: int, prompt=None) -> bool:
        """Would `alloc` for a request of `total_tokens` worst-case
        tokens succeed right now? Prefix-aware: a cached prefix costs
        zero new pages, and the parked tier is reclaimable."""
        matched, shared, cow_src = self._match_prefix(prompt)
        need = self.config.pages_for(total_tokens) - len(shared)
        keep = set(shared)
        if cow_src is not None:
            keep.add(cow_src)
        evictable = sum(1 for p in self._cached if p not in keep)
        return need <= len(self._free) + evictable

    # -- prefix index ------------------------------------------------------
    def _match_prefix(self, prompt):
        """Longest indexed prefix of `prompt`: (matched_tokens,
        fully-shared pages in context order, copy-on-write source page
        or None). Matching is capped at len(prompt) - 1 — the final
        prompt position must be recomputed so the final prefill chunk
        has logits to emit the first token from."""
        if not self.prefix_cache or prompt is None:
            return 0, [], None
        toks = [int(t) for t in prompt]
        P = len(toks)
        if P < 2:
            return 0, [], None
        ps = self.config.page_size
        full: List[int] = []
        key = None
        pos = 0
        while pos + ps <= P:
            k = (key, tuple(toks[pos:pos + ps]))
            page = self._index.get(k)
            if page is None:
                break
            full.append(page)
            key = k
            pos += ps
        partial = None  # (page, tokens)
        if pos < P:
            for t in range(min(P - pos, ps - 1), 0, -1):
                page = self._index.get((key, tuple(toks[pos:pos + t])))
                if page is not None:
                    partial = (page, t)
                    break
        matched = min(pos + (partial[1] if partial else 0), P - 1)
        shared = [pg for i, pg in enumerate(full)
                  if (i + 1) * ps <= matched]
        cow_src = None
        if matched > len(shared) * ps:
            # the page covering [len(shared)*ps, matched): either the
            # full page the P-1 cap landed inside, or the partial leaf
            cow_src = full[len(shared)] if len(shared) < len(full) \
                else partial[0]
        return matched, shared, cow_src

    def _drop_index(self, page: int) -> None:
        """Remove a page's index entry. The chain below it becomes
        unreachable (descendant keys embed this key), so cascade:
        descendants lose their entries too, and any of them idling in
        the cached tier go straight back to the free list."""
        key = self._page_key.pop(page, None)
        if key is None:
            return
        self._index.pop(key, None)
        for child in self._children.pop(key, []):
            self._drop_index(child)
            if child in self._cached:
                del self._cached[child]
                self._free.append(child)

    def register_prefix(self, seq_id: int, prompt) -> int:
        """Index a fully prefilled prompt's pages for future sharing:
        full pages chain, a sub-page tail registers as a leaf. Content
        that is already indexed (including pages this sequence itself
        shares) is left to the existing owner. Returns the number of
        pages newly indexed."""
        alloc = self._seqs.get(seq_id)
        if not self.prefix_cache or alloc is None:
            return 0
        ps = self.config.page_size
        toks = [int(t) for t in prompt]
        P = len(toks)
        key = None
        registered = 0
        for i in range(self.config.pages_for(P)):
            pos = i * ps
            t = min(ps, P - pos)
            k = (key, tuple(toks[pos:pos + t]))
            page = alloc.pages[i]
            if k not in self._index and page not in self._page_key:
                self._index[k] = page
                self._page_key[page] = k
                self._children.setdefault(key, []).append(page)
                registered += 1
            if t < ps:
                break  # sub-page tails are leaves: no chain below
            key = k
        return registered

    def seq_cached_tokens(self, seq_id: int) -> int:
        """Prompt tokens of `seq_id` covered by the prefix cache at
        admission (prefill starts after them)."""
        alloc = self._seqs.get(seq_id)
        return alloc.cached_tokens if alloc else 0

    def take_pending_copies(self) -> List[Tuple[int, int]]:
        """Drain the (src_page, dst_page) copy-on-write list. The
        engine MUST apply these to the device pool before its next
        dispatch — source content is only guaranteed until the next
        write step. int8 pools copy the per-slot scales alongside."""
        out, self._pending_copies = self._pending_copies, []
        return out

    # -- per-sequence lifecycle -------------------------------------------
    def alloc(self, seq_id: int, total_tokens: int,
              prompt=None) -> Optional[List[int]]:
        """Reserve pages for a sequence whose context will never exceed
        `total_tokens` (prompt + max_new). Returns the page list (the
        block table prefix, in order) or None when the pool cannot
        cover it — the admission-backpressure signal.

        With `prompt` and the prefix cache on, admission is
        prefix-aware: fully matched pages are shared instead of
        allocated, a partially matched boundary page is queued as a
        copy-on-write (`take_pending_copies`), and parked refcount-0
        pages are evicted LRU-first to make room before giving up."""
        if seq_id in self._seqs:
            raise ValueError("seq %r already allocated" % (seq_id,))
        if total_tokens > self.config.max_context:
            raise ValueError(
                "request needs %d tokens > max_context %d "
                "(pages_per_seq * page_size)"
                % (total_tokens, self.config.max_context))
        matched, shared, cow_src = self._match_prefix(prompt)
        n_new = self.config.pages_for(total_tokens) - len(shared)
        keep = set(shared)
        if cow_src is not None:
            keep.add(cow_src)
        evictable = sum(1 for p in self._cached if p not in keep)
        if n_new > len(self._free) + evictable:
            return None
        for p in shared:
            self._ref[p] += 1
            self._cached.pop(p, None)
        if cow_src is not None and cow_src in self._cached:
            self._cached.move_to_end(cow_src)  # hot: evict last
        while len(self._free) < n_new:
            victim = next(p for p in self._cached if p not in keep)
            del self._cached[victim]
            self._free.append(victim)
            self._drop_index(victim)
            self._evictions += 1
        new_pages = [self._free.pop() for _ in range(n_new)]
        for p in new_pages:
            self._ref[p] = 1
        pages = shared + new_pages
        if cow_src is not None:
            # boundary page: reader copies, then overwrites from its
            # divergence point — the owner's page is never touched
            self._pending_copies.append((cow_src, new_pages[0]))
            self._cow_copies += 1
        self._seqs[seq_id] = _SeqAlloc(
            pages=pages, reserved=self.config.pages_for(total_tokens),
            cached_tokens=matched)
        self._prefix_hit_tokens += matched
        self._peak_in_use = max(self._peak_in_use, self.pages_in_use)
        return list(pages)

    def free(self, seq_id: int) -> int:
        """Drop a sequence's references (request finished, cancelled or
        preempted — eviction of the reference is immediate). Pages
        whose refcount hits 0 return to the free list, unless they are
        prefix-indexed: those park in the cached tier, leaves ahead of
        their ancestors in eviction order. Returns the number of
        references released; unknown ids are a no-op (retire and
        cancel may race benignly)."""
        alloc = self._seqs.pop(seq_id, None)
        if alloc is None:
            return 0
        for p in reversed(alloc.pages):  # leaves park LRU-first
            self._ref[p] -= 1
            if self._ref[p] > 0:
                continue
            if p in self._page_key:
                self._cached[p] = None
            else:
                self._free.append(p)
        self._enforce_cached_budget()
        return len(alloc.pages)

    def _enforce_cached_budget(self) -> None:
        """Shrink the parked tier to `cached_pages_budget` pages,
        evicting from the LRU front — free() parks a sequence's leaves
        before its ancestors, so leaves go first and `_drop_index`'s
        descendant cascade stays small."""
        budget = self.cached_pages_budget
        if budget is None:
            return
        while len(self._cached) > budget:
            victim = next(iter(self._cached))
            del self._cached[victim]
            self._free.append(victim)
            self._drop_index(victim)
            self._evictions += 1
            self._budget_evictions += 1

    def block_table(self, seq_id: int) -> List[int]:
        """The sequence's page ids in context order, padded by the
        caller to pages_per_seq (pad entries must be valid page
        indices — the engine uses 0)."""
        return list(self._seqs[seq_id].pages)

    def live_seqs(self) -> List[int]:
        return list(self._seqs)

    # -- invariants --------------------------------------------------------
    def check_invariants(self) -> List[str]:
        """Structural page-conservation audit; returns violation
        strings (empty = healthy). The serving tests and the
        analysis/proto_models kv_pages model call this after every
        mutation, so the scattered implicit assertions live in ONE
        place:

        - partition: free + cached + referenced == num_pages, with no
          page in two tiers and no duplicates inside a tier
        - refcounts: referenced pages carry ref == #block tables
          holding them; free/cached pages carry ref == 0; never
          negative
        - index: _index and _page_key are inverse bijections; an
          indexed page is never on the free list; every cached page is
          indexed (else it could never be matched again)
        - pending COW copies target freshly allocated (ref == 1,
          unindexed) destination pages
        """
        out: List[str] = []
        n = self.config.num_pages
        free, cached = list(self._free), list(self._cached)
        refed = [p for p in range(n) if self._ref[p] > 0]
        if len(set(free)) != len(free):
            out.append("free list has duplicate pages")
        for name, tier in (("free", set(free)), ("cached", set(cached)),
                           ("referenced", set(refed))):
            bad = [p for p in tier if not 0 <= p < n]
            if bad:
                out.append("%s tier holds out-of-range pages %s"
                           % (name, bad))
        for a, b, pages in (("free", "cached",
                             set(free) & set(cached)),
                            ("free", "referenced",
                             set(free) & set(refed)),
                            ("cached", "referenced",
                             set(cached) & set(refed))):
            if pages:
                out.append("pages %s are both %s and %s"
                           % (sorted(pages), a, b))
        if len(free) + len(cached) + len(refed) != n \
                and not out:  # overlap/dup already reported above
            out.append(
                "page conservation broken: free=%d + cached=%d + "
                "referenced=%d != total=%d"
                % (len(free), len(cached), len(refed), n))
        neg = [p for p in range(n) if self._ref[p] < 0]
        if neg:
            out.append("negative refcounts on pages %s" % (neg,))
        holds: Dict[int, int] = {}
        for alloc in self._seqs.values():
            for p in alloc.pages:
                holds[p] = holds.get(p, 0) + 1
        for p in range(n):
            if self._ref[p] != holds.get(p, 0):
                out.append(
                    "page %d refcount %d != %d block-table references"
                    % (p, self._ref[p], holds.get(p, 0)))
        for key, page in self._index.items():
            if self._page_key.get(page) != key:
                out.append("index entry %r -> page %d not mirrored in "
                           "_page_key" % (key, page))
        for page, key in self._page_key.items():
            if self._index.get(key) != page:
                out.append("_page_key entry page %d -> %r not mirrored "
                           "in _index" % (page, key))
            if page in set(free):
                out.append("indexed page %d is on the free list" % page)
        for p in cached:
            if p not in self._page_key:
                out.append("cached page %d is not prefix-indexed "
                           "(unmatchable, leaks the page)" % p)
        for src, dst in self._pending_copies:
            # dst ref 0 is benign (freed before the engine drained the
            # copy list); writing a SHARED or indexed page never is
            if self._ref[dst] > 1 or dst in self._page_key:
                out.append(
                    "pending COW copy %d->%d targets a shared or "
                    "indexed destination" % (src, dst))
        return out

    # -- device state ------------------------------------------------------
    def init_device_state(self, device):
        """Fresh zeroed page tensors on `device`, holding the pool's
        pages and, last, the scratch page (`KVCacheConfig.scratch_page`).
        Float dtypes: a list of (k_pages, v_pages) per layer, each
        [num_pages + 1, page_size, kv_heads, head_dim]. int8: 4-tuples
        (k_pages, v_pages, k_scale, v_scale) with int8 value tensors and
        [num_pages + 1, page_size] fp32 per-slot scales (identity 1.0
        until a row is written). The serving step updates these tensors in
        place."""
        import torch

        c = self.config
        n = c.scratch_page + 1
        shape = (n, c.page_size, c.num_kv_heads, c.head_dim)
        if c.quantized:
            sshape = (n, c.page_size)
            return [(torch.zeros(shape, dtype=torch.int8, device=device),
                     torch.zeros(shape, dtype=torch.int8, device=device),
                     torch.ones(sshape, dtype=torch.float32, device=device),
                     torch.ones(sshape, dtype=torch.float32, device=device))
                    for _ in range(c.num_layers)]
        dtype = getattr(torch, c.dtype)
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in range(c.num_layers)]
