"""Paged KV cache: block allocator and page tables.

Twin of ``distributedtensorflow_tpu/serve/kv_cache.py`` without the
prefix index (the engine's ``prefix_cache`` option, not ported yet).
K/V live in a pool of fixed-size blocks shared by every slot; each
slot's page-table row names the blocks that hold its sequence, and the
allocator grants a request's whole worst-case footprint at admission,
all or nothing, so nothing runs out of memory mid-flight.

The pools are torch tensors on the device, shape ``(num_layers,
num_blocks + 1, block_size, kv_heads, head_dim)``.  The extra block at
index ``num_blocks`` is the scratch block: inactive slots' writes land
there and unallocated page-table entries point at it.  Page tables and
sequence lengths stay in numpy on the host.  Only the engine thread
touches a ``PagedKVCache``, so there are no locks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


class OutOfBlocksError(RuntimeError):
    """Raised on ``free``/table misuse; ``alloc`` returns None instead."""


class BlockAllocator:
    """Allocator over ``num_blocks`` uniform physical blocks.

    ``alloc(n)`` is all-or-nothing; ``free`` rejects double frees and
    foreign ids loudly (two slots owning one block is silent cache
    corruption)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))  # pop() -> block 0
        self._used: set[int] = set()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> list[int] | None:
        """``n`` block ids, or None when fewer than ``n`` are free (never
        a partial grant)."""
        if n < 0:
            raise ValueError(f"alloc({n}) is negative")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._used.update(blocks)
        return blocks

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b not in self._used:
                raise OutOfBlocksError(
                    f"free({b}): block is not allocated (double free or "
                    "foreign id)")
            self._used.remove(b)
            self._free.append(b)


@dataclasses.dataclass
class SlotPages:
    """One slot's page-table bookkeeping (host side)."""

    blocks: list[int]          # physical block ids, logical order
    capacity_tokens: int       # blocks * block_size
    used_tokens: int = 0       # K/V positions actually written so far


class PagedKVCache:
    """Block-pool KV storage for ``max_slots`` concurrent sequences.

    The serving programs (``serve.model``) write ``k_pool``/``v_pool``
    in place; host state (page tables, lengths) advances on the engine
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
        self.max_context = max_context
        self.blocks_per_slot = max_context // block_size
        self.scratch_block = num_blocks
        self.allocator = BlockAllocator(num_blocks)
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

    def blocks_for(self, tokens: int) -> int:
        """Physical blocks needed to hold ``tokens`` K/V positions."""
        return -(-tokens // self.block_size)

    def admit(self, slot: int, tokens: int) -> SlotPages | None:
        """Reserve a slot's worst-case footprint (``tokens`` positions);
        None under pool pressure.  The slot must be empty."""
        if self.pages[slot] is not None:
            raise OutOfBlocksError(f"slot {slot} is already occupied")
        if tokens > self.max_context:
            raise ValueError(
                f"{tokens} tokens exceed max_context={self.max_context}")
        n = self.blocks_for(tokens)
        blocks = self.allocator.alloc(n)
        if blocks is None:
            return None
        pages = SlotPages(blocks, n * self.block_size)
        self.pages[slot] = pages
        self.block_tables[slot, :] = self.scratch_block
        self.block_tables[slot, :n] = blocks
        self.tables_version += 1
        self.seq_lens[slot] = 0
        return pages

    def release(self, slot: int) -> None:
        """Return the slot's blocks to the pool (eviction path)."""
        pages = self.pages[slot]
        if pages is None:
            return
        self.allocator.free(pages.blocks)
        self.pages[slot] = None
        self.block_tables[slot, :] = self.scratch_block
        self.tables_version += 1
        self.seq_lens[slot] = 0

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

    def stats(self) -> dict:
        """Pool occupancy and internal fragmentation."""
        used = [p for p in self.pages if p is not None]
        allocated = sum(p.capacity_tokens for p in used)
        resident = sum(p.used_tokens for p in used)
        return {
            "block_size": self.block_size,
            "blocks_total": self.allocator.num_blocks,
            "blocks_free": self.allocator.free_blocks,
            "blocks_used": self.allocator.used_blocks,
            "slots_occupied": len(used),
            "allocated_tokens": allocated,
            "resident_tokens": resident,
            # 0 = every allocated token holds real K/V; 1 = all waste
            "fragmentation": 1.0 - resident / allocated if allocated else 0.0,
        }
