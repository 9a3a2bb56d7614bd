"""The port's paged KV cache beyond full provisioning, against JAX's.

The same operations (admit with and without a prompt, prefix lookup and
registration, copy-on-write, rollback, release, eviction under pressure)
run on ``distributedtensorflow_tpu.serve.kv_cache.PagedKVCache`` and the
port's twin.  After every operation the two hold equal page tables,
lengths, refcounts, free lists, LRU orders, ``stats()`` and
``billed_blocks``; after a copy-on-write their pools are equal exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.serve.kv_cache import (
    OutOfBlocksError as JaxOutOfBlocksError,
)
from distributedtensorflow_tpu.serve.kv_cache import (
    PagedKVCache as JaxPagedKVCache,
)
from distributedtensorflow_tpu_torch.serve import (
    BlockAllocator,
    OutOfBlocksError,
    PagedKVCache,
)

_GEOM = dict(num_layers=2, kv_heads=2, head_dim=4, max_slots=3,
             block_size=4, max_context=16)


def _pair(num_blocks):
    """(JAX cache, port cache) of one geometry, both pools filled with
    the same distinct values."""
    jkv = JaxPagedKVCache(num_blocks=num_blocks, dtype=jnp.float32, **_GEOM)
    tkv = PagedKVCache(num_blocks=num_blocks, device="cpu", **_GEOM)
    shape = tkv.k_pool.shape
    k = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jkv.k_pool, jkv.v_pool = jnp.asarray(k), jnp.asarray(-k)
    tkv.k_pool.copy_(torch.from_numpy(k))
    tkv.v_pool.copy_(torch.from_numpy(-k))
    return jkv, tkv


def _state(kv):
    a = kv.allocator
    return {
        "tables": kv.block_tables.tolist(),
        "seq_lens": kv.seq_lens.tolist(),
        "pages": [None if p is None else dataclasses.asdict(p)
                  for p in kv.pages],
        "refs": dict(a._ref),
        "free": list(a._free),
        "lru": list(a._cached),
        "registered": sorted(a._registered),
        "evictions": a.evictions,
        "stats": kv.stats(),
        "billed": [kv.billed_blocks(s) for s in range(kv.max_slots)],
        "index": sorted(kv._hash_to_block.values()),
    }


def _same_pools(jkv, tkv):
    np.testing.assert_array_equal(np.asarray(jkv.k_pool), tkv.k_pool.numpy())
    np.testing.assert_array_equal(np.asarray(jkv.v_pool), tkv.v_pool.numpy())


def _both(jkv, tkv, op, *args, **kw):
    """Apply ``op`` to both caches; the results (or the error classes)
    and the states after must agree."""
    outs = []
    for kv, err in ((jkv, JaxOutOfBlocksError), (tkv, OutOfBlocksError)):
        try:
            out = getattr(kv, op)(*args, **kw)
            outs.append(("ok", dataclasses.asdict(out)
                         if dataclasses.is_dataclass(out) else out))
        except err as e:
            outs.append(("raised", str(e)))
    assert outs[0] == outs[1], (op, args, outs)
    assert _state(jkv) == _state(tkv), (op, args)
    return outs[1]


_HEADER = [7, 3, 9, 1, 4, 4, 8, 2]  # two full blocks of 4


def test_prefix_cow_rollback_and_eviction_sequence():
    """A scripted sequence through every path: a prefix registered by one
    slot and mapped by two more, copy-on-write of a shared block (pools
    equal after it), rollback within and its guards, release into the
    LRU, eviction under pressure that never touches a mapped block."""
    jkv, tkv = _pair(num_blocks=10)
    a = _HEADER + [5, 6]
    _both(jkv, tkv, "admit", 0, 12, prompt=a)
    _both(jkv, tkv, "note_written", 0, 10)
    _both(jkv, tkv, "register_prefix", 0, a)
    assert tkv.lookup_prefix(a + [1]) == jkv.lookup_prefix(a + [1]) \
        == tkv.pages[0].blocks[:2]
    _both(jkv, tkv, "admit", 1, 16, prompt=_HEADER + [1, 1, 1])
    _both(jkv, tkv, "admit", 2, 8, prompt=_HEADER[:4] + [0, 0])
    assert tkv.pages[1].prefix_tokens == 8 and tkv.pages[2].prefix_tokens == 4
    assert tkv.allocator.refcount(tkv.pages[0].blocks[0]) == 3
    # a write into the shared block: one copy over all layers of both pools
    _both(jkv, tkv, "ensure_writable", 1, 5)
    assert tkv.cow_copies == 1
    _same_pools(jkv, tkv)
    _both(jkv, tkv, "ensure_writable_range", 2, 2, 6)
    _same_pools(jkv, tkv)
    # an exclusive registered block leaves the index on a write
    _both(jkv, tkv, "ensure_writable", 0, 5)
    _both(jkv, tkv, "note_written", 1, 14)
    _both(jkv, tkv, "rollback", 1, 12)
    _both(jkv, tkv, "rollback", 1, 13)        # only retreats: raises
    _both(jkv, tkv, "rollback", 2, 0)         # into the prefix: raises
    _both(jkv, tkv, "ensure_writable", 2, 16)  # past the reservation
    for slot in (0, 1, 2):
        _both(jkv, tkv, "release", slot)
    assert tkv.allocator.cached_blocks > 0
    # a mapped cached block survives the pressure that evicts the others
    _both(jkv, tkv, "admit", 0, 8, prompt=_HEADER[:4] + [2])
    mapped = tkv.pages[0].blocks[0]
    _both(jkv, tkv, "admit", 1, 16)
    _both(jkv, tkv, "admit", 2, 16)           # pressure: None
    assert tkv.allocator.refcount(mapped) == 1
    assert tkv.allocator.evictions == jkv.allocator.evictions
    for slot in (0, 1, 2):
        _both(jkv, tkv, "release", slot)
    alloc = tkv.allocator
    assert alloc.used_blocks == 0 and alloc.total_refs == 0
    assert alloc.allocatable_blocks == alloc.num_blocks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operation_sequences_match_jax(seed):
    """300 seeded random operations over a pool oversubscribed 2:1 and
    prompts that share block-aligned headers: states equal after each,
    pools equal at the end, no mapped block ever evicted, and every block
    allocatable again once the slots are released."""
    rng = np.random.default_rng(seed)
    jkv, tkv = _pair(num_blocks=6)
    headers = [list(rng.integers(0, 4, 8)) for _ in range(2)]
    for _ in range(300):
        slot = int(rng.integers(0, 3))
        pages = tkv.pages[slot]
        op = rng.choice(["admit", "release", "write", "cow", "rollback"])
        if pages is None or op == "admit":
            if pages is not None:
                continue
            prompt = [int(t) for t in headers[rng.integers(0, 2)]][
                :int(rng.integers(1, 9))] + [int(t) for t in rng.integers(
                    0, 4, int(rng.integers(1, 6)))]
            footprint = int(rng.integers(len(prompt), 17))
            mapped_before = {b for p in tkv.pages if p is not None
                             for b in p.blocks}
            got = _both(jkv, tkv, "admit", slot, footprint,
                        prompt=prompt if rng.random() < 0.8 else None)
            # eviction only ever takes refcount-0 blocks
            assert all(tkv.allocator.refcount(b) >= 1 for b in mapped_before)
            if got[0] == "ok" and got[1] is not None and rng.random() < 0.7:
                n = min(len(prompt), tkv.pages[slot].capacity_tokens)
                _both(jkv, tkv, "note_written", slot,
                      max(n, tkv.pages[slot].used_tokens))
                _both(jkv, tkv, "register_prefix", slot, prompt[:n])
        elif op == "release":
            _both(jkv, tkv, "release", slot)
        elif op == "write":
            _both(jkv, tkv, "note_written", slot,
                  int(rng.integers(pages.used_tokens,
                                   pages.capacity_tokens + 1)))
        elif op == "cow":
            start = int(rng.integers(0, pages.capacity_tokens))
            _both(jkv, tkv, "ensure_writable_range", slot, start,
                  int(rng.integers(start, pages.capacity_tokens + 1)))
        else:
            _both(jkv, tkv, "rollback", slot,
                  int(rng.integers(0, pages.used_tokens + 1)))
    _same_pools(jkv, tkv)
    for slot in range(3):
        _both(jkv, tkv, "release", slot)
    alloc = tkv.allocator
    assert alloc.used_blocks == 0
    assert alloc.allocatable_blocks == alloc.num_blocks


def test_allocator_refcounts_and_lru():
    """incref/decref, register/unregister and LRU eviction with the
    callback, as the JAX allocator's contract says."""
    evicted = []
    a = BlockAllocator(4, on_evict=evicted.append)
    blocks = a.alloc(4)
    a.incref(blocks[0])
    assert a.total_refs == 5 and a.used_blocks == 4
    for b in blocks[:3]:
        a.register(b)
    a.free(blocks)
    assert a.refcount(blocks[0]) == 1 and a.cached_blocks == 2
    a.decref(blocks[0])
    assert list(a._cached) == [blocks[1], blocks[2], blocks[0]]
    assert a.free_blocks == 1 and a.allocatable_blocks == 4
    a.unregister(blocks[2])              # a cached block becomes free
    assert a.free_blocks == 2 and a.cached_blocks == 2
    got = a.alloc(3)                     # evicts the LRU cached block only
    assert evicted == [blocks[1]] and a.evictions == 1
    assert blocks[0] not in got and a.cached_blocks == 1
    with pytest.raises(OutOfBlocksError, match="neither active nor cached"):
        a.incref(99)
    with pytest.raises(OutOfBlocksError, match="not active"):
        a.register(blocks[0])
