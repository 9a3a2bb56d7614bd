"""Paged KV cache: refcounted block pool, prefix index and page tables.

Twin of ``distributedtensorflow_tpu/serve/kv_cache.py``.  K/V live in a
pool of fixed-size blocks shared by every slot; each slot's page-table
row names the blocks that hold its sequence, and the allocator grants a
request's whole worst-case footprint at admission, all or nothing, so
nothing runs out of memory mid-flight.

**Prefix caching**: every FULL token-aligned block of a completed prompt
is registered under a chained content hash (``h_i = hash((h_{i-1},
block_i_tokens))``, so a block's hash commits to the whole prefix up to
it).  Admission looks up the longest indexed chain for a new prompt and
maps those blocks into its page table at ``refcount + 1``; prefill then
runs only the uncached tail.  The match is capped at ``(prompt_len - 1)
// block_size`` blocks, so at least one prompt token always runs through
prefill (its logits seed the first sample).  Each matched entry's tokens
are compared, so a hash collision is a miss, never another prompt's K/V.

Block states (:class:`BlockAllocator`): **free**; **active** (refcount
>= 1, mapped by that many page tables; > 1 is shared and never written
in place); **cached** (refcount 0 but indexed: the K/V stay warm in an
LRU that ``alloc`` evicts from only under pressure; a mapped block is
never evicted).  ``release`` therefore decrements instead of freeing.

**Copy-on-write**: :meth:`PagedKVCache.ensure_writable` guards an
in-place write: a shared target block is copied into a fresh block (one
indexed ``copy_`` over all layers of both pools) and the writer's table
re-pointed; a registered but exclusive target is unregistered.  In the
engine's steady state neither fires.  One deliberate exception: a
prefill chunk that straddles the cached-prefix boundary re-writes the
tail of the shared prefix with bitwise-identical K/V (same tokens, same
positions, same program), which keeps the chunk grid anchored at 0.

The pools are torch tensors on the device, shape ``(num_layers,
num_blocks + 1, block_size, kv_heads, head_dim)``, written in place by
the serving programs (``serve.model``).  The extra block at index
``num_blocks`` is the scratch block: inactive slots' writes land there
and unallocated page-table entries point at it.  Page tables, lengths
and the prefix index stay in numpy and dicts on the host.  Only the
engine thread touches a ``PagedKVCache``, so there are no locks.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..device import resolve_device


class OutOfBlocksError(RuntimeError):
    """Raised on ``free``/refcount/table misuse; ``alloc`` returns None
    instead."""


class BlockAllocator:
    """Refcounted allocator over ``num_blocks`` uniform physical blocks.

    ``alloc(n)`` is all-or-nothing and may evict LRU *cached* (refcount
    0, registered) blocks to satisfy the grant, calling ``on_evict`` for
    each; a mapped block is never evicted.  ``free``/:meth:`decref`
    reject double frees and foreign ids loudly."""

    def __init__(self, num_blocks: int, on_evict=None):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))  # pop() -> block 0
        self._ref: dict[int, int] = {}
        #: refcount-0 registered blocks, insertion order = LRU order
        self._cached: collections.OrderedDict[int, None] = \
            collections.OrderedDict()
        self._registered: set[int] = set()
        self._on_evict = on_evict
        self.evictions = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks with refcount >= 1 (mapped by some page table)."""
        return len(self._ref)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks kept warm for the prefix index (evictable)."""
        return len(self._cached)

    @property
    def allocatable_blocks(self) -> int:
        """Blocks ``alloc`` could grant right now (free + evictable)."""
        return len(self._free) + len(self._cached)

    @property
    def total_refs(self) -> int:
        """Sum of refcounts (> used_blocks means prefix sharing is live)."""
        return sum(self._ref.values())

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def is_registered(self, block: int) -> bool:
        return block in self._registered

    def alloc(self, n: int) -> list[int] | None:
        """``n`` block ids at refcount 1, or None when fewer than ``n``
        are grantable (never a partial grant).  Evicts LRU cached blocks
        only as needed."""
        if n < 0:
            raise ValueError(f"alloc({n}) is negative")
        if n > self.allocatable_blocks:
            return None
        while len(self._free) < n:
            self._evict_lru()
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        return blocks

    def incref(self, block: int) -> None:
        """Map a block into one more page table; a cached block leaves the
        eviction LRU."""
        if block in self._ref:
            self._ref[block] += 1
        elif block in self._cached:
            del self._cached[block]
            self._ref[block] = 1
        else:
            raise OutOfBlocksError(
                f"incref({block}): block is neither active nor cached")

    def decref(self, block: int) -> None:
        """Drop one reference.  At refcount 0 a registered block parks in
        the cached LRU; an unregistered one returns to the free list."""
        if block not in self._ref:
            raise OutOfBlocksError(
                f"decref({block}): block is not allocated (double free or "
                "foreign id)")
        self._ref[block] -= 1
        if self._ref[block]:
            return
        del self._ref[block]
        if block in self._registered:
            self._cached[block] = None  # the MRU end of the LRU
        else:
            self._free.append(block)

    def free(self, blocks: list[int]) -> None:
        """Drop one reference per block (the release path)."""
        for b in blocks:
            self.decref(b)

    def register(self, block: int) -> None:
        """Mark an active block as indexed prefix content: at refcount 0
        it becomes cached instead of free."""
        if block not in self._ref:
            raise OutOfBlocksError(f"register({block}): block is not active")
        self._registered.add(block)

    def unregister(self, block: int) -> None:
        """Forget a block's indexed status; a cached block becomes free."""
        self._registered.discard(block)
        if block in self._cached:
            del self._cached[block]
            self._free.append(block)

    def _evict_lru(self) -> None:
        block, _ = self._cached.popitem(last=False)
        self._registered.discard(block)
        self.evictions += 1
        if self._on_evict is not None:
            self._on_evict(block)
        self._free.append(block)


@dataclasses.dataclass
class SlotPages:
    """One slot's page-table bookkeeping (host side)."""

    blocks: list[int]          # physical block ids, logical order
    capacity_tokens: int       # blocks * block_size
    used_tokens: int = 0       # K/V positions actually written so far
    prefix_tokens: int = 0     # tokens mapped from the prefix cache at admit


class PagedKVCache:
    """Block-pool KV storage for ``max_slots`` concurrent sequences.

    The serving programs write ``k_pool``/``v_pool`` in place; host state
    (page tables, lengths, the prefix index) advances on the engine
    thread in step with them."""

    def __init__(self, *, num_layers: int, kv_heads: int, head_dim: int,
                 max_slots: int, num_blocks: int, block_size: int,
                 max_context: int, dtype=torch.float32, device=None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_context % block_size:
            raise ValueError(
                f"max_context={max_context} must be a multiple of "
                f"block_size={block_size}")
        device = resolve_device(device)
        self.block_size = block_size
        self.max_slots = max_slots
        self.max_context = max_context
        self.blocks_per_slot = max_context // block_size
        self.scratch_block = num_blocks
        self.allocator = BlockAllocator(num_blocks, on_evict=self._on_evict)
        shape = (num_layers, num_blocks + 1, block_size, kv_heads, head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=device)
        self.block_tables = np.full(
            (max_slots, self.blocks_per_slot), self.scratch_block, np.int32)
        #: bumped on every page-table change, so the engine re-sends the
        #: tables to the device only when they changed
        self.tables_version = 0
        self.seq_lens = np.zeros((max_slots,), np.int32)
        self.pages: list[SlotPages | None] = [None] * max_slots
        # chained hash -> (block, the block's token tuple), and the reverse
        self._hash_to_block: dict[int, tuple[int, tuple[int, ...]]] = {}
        self._block_hash: dict[int, int] = {}
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_cached_tokens = 0
        self.cow_copies = 0

    def _on_evict(self, block: int) -> None:
        h = self._block_hash.pop(block, None)
        if h is not None:
            self._hash_to_block.pop(h, None)

    # -- prefix index --------------------------------------------------------

    def _chained_hashes(self, tokens):
        """(chained hash, block token tuple) per FULL block of
        ``tokens``."""
        h = 0
        bs = self.block_size
        for i in range(len(tokens) // bs):
            tok = tuple(tokens[i * bs:(i + 1) * bs])
            h = hash((h, tok))
            yield h, tok

    def lookup_prefix(self, tokens) -> list[int]:
        """Longest indexed chain of full blocks matching ``tokens``,
        capped so at least one prompt token remains for prefill; every
        matched entry's tokens are compared.  No state changes."""
        limit = (len(tokens) - 1) // self.block_size
        blocks: list[int] = []
        for i, (h, tok) in enumerate(self._chained_hashes(tokens)):
            if i >= limit:
                break
            entry = self._hash_to_block.get(h)
            if entry is None or entry[1] != tok:
                break
            blocks.append(entry[0])
        return blocks

    def register_prefix(self, slot: int, tokens) -> int:
        """Index every FULL block of a slot's prefilled prompt; a hash
        already indexed keeps its entry (first writer wins).  Returns the
        number of newly indexed blocks."""
        pages = self.pages[slot]
        if pages is None:
            raise OutOfBlocksError(f"slot {slot} has no pages")
        added = 0
        for i, (h, tok) in enumerate(self._chained_hashes(tokens)):
            b = pages.blocks[i]
            if h in self._hash_to_block:
                continue
            self._hash_to_block[h] = (b, tok)
            self._block_hash[b] = h
            self.allocator.register(b)
            added += 1
        return added

    # -- admission / eviction ------------------------------------------------

    def blocks_for(self, tokens: int) -> int:
        """Physical blocks needed to hold ``tokens`` K/V positions."""
        return -(-tokens // self.block_size)

    def admit(self, slot: int, tokens: int, prompt=None) -> SlotPages | None:
        """Reserve a slot's worst-case footprint (``tokens`` positions).
        With ``prompt``, the longest indexed prefix is mapped at
        refcount + 1 and only the rest is allocated.  None under pool
        pressure (the prefix mappings rolled back).  The slot must be
        empty."""
        if self.pages[slot] is not None:
            raise OutOfBlocksError(f"slot {slot} is already occupied")
        if tokens > self.max_context:
            raise ValueError(
                f"{tokens} tokens exceed max_context={self.max_context}")
        prefix_blocks: list[int] = []
        if prompt is not None:
            prefix_blocks = self.lookup_prefix(prompt)
        n = self.blocks_for(tokens)
        for b in prefix_blocks:
            self.allocator.incref(b)  # pinned: alloc's eviction can't touch
        fresh = self.allocator.alloc(n - len(prefix_blocks))
        if fresh is None:
            for b in prefix_blocks:
                self.allocator.decref(b)
            return None
        # counted on success only: a head retried under pressure every
        # iteration must not inflate the denominator
        prefix_tokens = len(prefix_blocks) * self.block_size
        if prompt is not None:
            self.prefix_lookups += 1
        if prefix_blocks:
            self.prefix_hits += 1
            self.prefix_cached_tokens += prefix_tokens
        blocks = prefix_blocks + fresh
        pages = SlotPages(blocks, n * self.block_size,
                          used_tokens=prefix_tokens,
                          prefix_tokens=prefix_tokens)
        self.pages[slot] = pages
        self.block_tables[slot, :] = self.scratch_block
        self.block_tables[slot, :len(blocks)] = blocks
        self.tables_version += 1
        self.seq_lens[slot] = prefix_tokens
        return pages

    def release(self, slot: int) -> None:
        """Drop the slot's block references: registered blocks park in
        the cached LRU, the rest return to the pool."""
        pages = self.pages[slot]
        if pages is None:
            return
        self.allocator.free(pages.blocks)
        self.pages[slot] = None
        self.block_tables[slot, :] = self.scratch_block
        self.tables_version += 1
        self.seq_lens[slot] = 0

    @torch.no_grad()
    def _copy_block(self, src: int, dst: int) -> None:
        """The copy-on-write copy: block ``src`` to ``dst`` in every layer
        of both pools, one indexed ``copy_`` each."""
        self.k_pool[:, dst].copy_(self.k_pool[:, src])
        self.v_pool[:, dst].copy_(self.v_pool[:, src])

    def ensure_writable(self, slot: int, pos: int) -> str | None:
        """Copy-on-write guard for an in-place write at ``pos``: ``"cow"``
        when a shared target was copied into a fresh exclusive block,
        ``"unregistered"`` when an exclusive indexed target left the
        index, None when the write was safe.  Raises when a copy is
        needed and no block is grantable."""
        pages = self.pages[slot]
        if pages is None:
            raise OutOfBlocksError(f"slot {slot} has no pages")
        li = pos // self.block_size
        if li >= len(pages.blocks):
            raise OutOfBlocksError(
                f"slot {slot}: write at {pos} exceeds reserved capacity "
                f"{pages.capacity_tokens}")
        b = pages.blocks[li]
        if self.allocator.refcount(b) > 1:
            fresh = self.allocator.alloc(1)
            if fresh is None:
                raise OutOfBlocksError(
                    f"slot {slot}: copy-on-write at position {pos} needs a "
                    "block but the pool is exhausted")
            dst = fresh[0]
            self._copy_block(b, dst)
            self.allocator.decref(b)
            pages.blocks[li] = dst
            self.block_tables[slot, li] = dst
            self.tables_version += 1
            self.cow_copies += 1
            return "cow"
        if self.allocator.is_registered(b):
            self._on_evict(b)  # drop the index entry
            self.allocator.unregister(b)
            return "unregistered"
        return None

    def ensure_writable_range(self, slot: int, start: int, end: int) -> int:
        """:meth:`ensure_writable` over every block ``[start, end)``
        touches; returns how many needed a copy or an unregister."""
        if end <= start:
            return 0
        fixed = 0
        bs = self.block_size
        for li in range(start // bs, (end - 1) // bs + 1):
            if self.ensure_writable(slot, li * bs) is not None:
                fixed += 1
        return fixed

    def rollback(self, slot: int, tokens: int) -> None:
        """Retreat a slot's resident-token count to ``tokens`` (discarded
        speculative drafts).  Never into the mapped prefix, never across a
        shared block, and no block is freed (the admission reservation
        stands)."""
        pages = self.pages[slot]
        if pages is None:
            raise OutOfBlocksError(f"slot {slot} has no pages")
        if tokens > pages.used_tokens:
            raise OutOfBlocksError(
                f"slot {slot}: rollback target {tokens} exceeds resident "
                f"{pages.used_tokens} (rollback only retreats)")
        if tokens < pages.prefix_tokens:
            raise OutOfBlocksError(
                f"slot {slot}: rollback to {tokens} would retreat into the "
                f"mapped shared prefix ({pages.prefix_tokens} tokens)")
        if tokens == pages.used_tokens:
            return
        bs = self.block_size
        for li in range(tokens // bs,
                        min((pages.used_tokens - 1) // bs + 1,
                            len(pages.blocks))):
            if self.allocator.refcount(pages.blocks[li]) > 1:
                raise OutOfBlocksError(
                    f"slot {slot}: rollback window covers shared block "
                    f"{pages.blocks[li]} (refcount "
                    f"{self.allocator.refcount(pages.blocks[li])})")
        pages.used_tokens = tokens
        self.seq_lens[slot] = tokens

    def note_written(self, slot: int, tokens: int) -> None:
        """Advance a slot's resident-token count after a program wrote
        K/V; bounded by the reservation so a scheduler bug trips here."""
        pages = self.pages[slot]
        if pages is None:
            raise OutOfBlocksError(f"slot {slot} has no pages")
        if tokens > pages.capacity_tokens:
            raise OutOfBlocksError(
                f"slot {slot}: {tokens} tokens exceed reserved capacity "
                f"{pages.capacity_tokens}")
        pages.used_tokens = tokens
        self.seq_lens[slot] = tokens

    # -- introspection -------------------------------------------------------

    def billed_blocks(self, slot: int) -> float:
        """Refcount-weighted block footprint of one slot: each mapped
        block charged at ``1/refcount``, so the slots' sum never exceeds
        the mapped-block count."""
        pages = self.pages[slot]
        if pages is None:
            return 0.0
        alloc = self.allocator
        return sum(1.0 / alloc.refcount(b) for b in pages.blocks)

    def stats(self) -> dict:
        """Pool occupancy, internal fragmentation, and the prefix cache's
        occupancy and hit rate."""
        used = [p for p in self.pages if p is not None]
        allocated_tokens = sum(p.capacity_tokens for p in used)
        used_tokens = sum(p.used_tokens for p in used)
        alloc = self.allocator
        return {
            "block_size": self.block_size,
            "blocks_total": alloc.num_blocks,
            "blocks_free": alloc.free_blocks,
            "blocks_used": alloc.used_blocks,
            "blocks_cached": alloc.cached_blocks,
            "block_refs": alloc.total_refs,
            "slots_occupied": len(used),
            "allocated_tokens": allocated_tokens,
            "resident_tokens": used_tokens,
            # 0 = every allocated token holds real K/V; 1 = all waste
            "fragmentation": (1.0 - used_tokens / allocated_tokens
                              if allocated_tokens else 0.0),
            "prefix_blocks_indexed": len(self._hash_to_block),
            "prefix_occupancy": len(self._hash_to_block) / alloc.num_blocks,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_lookups
                                if self.prefix_lookups else 0.0),
            "prefix_cached_tokens": self.prefix_cached_tokens,
            "prefix_evictions": alloc.evictions,
            "cow_copies": self.cow_copies,
        }
