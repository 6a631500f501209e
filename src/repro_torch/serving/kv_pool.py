"""Slot-based paged KV-cache pool with refcounted prefix sharing (the JAX
package's ``serving/kv_pool.py``, numpy only, kept as the port's own copy).

The pool manages two resources: *slots* (the batch row a request binds to
for its lifetime) and *blocks* (fixed ``block_size``-token KV pages drawn
from one global free list).  Admission reserves a request's full footprint
in blocks, so the pool can be provisioned for total tokens-in-flight rather
than ``n_slots x max_seq`` worst case (``total_blocks`` < dense is the paged
sharing the vLLM line of work exploits; the ledger also yields the
utilization / fragmentation accounting the batcher and metrics report).

Under the *paged* KV layout (``models.transformer.init_slot_cache_paged``)
the block ledger is physical: each layer's K/V lives in one
``(total_blocks + 1) x n_kv_heads x block_size x head_dim`` arena, and a
request's lease order IS its block table — block ``j`` of the lease holds
tokens ``[j * block_size, (j + 1) * block_size)``.  :meth:`block_table`
exports that mapping as the padded int32 row the decode step gathers
through.  Under the legacy *dense* layout
(``models.transformer.init_slot_cache``) the same ledger is accounting
only, over physically ``max_seq``-long slot rows.

Prefix sharing (``prefix_sharing=True``) adds a *prefix index*: a
hash-chain over token-id block prefixes.  When a request's prompt fills a
physical block (all ``block_size`` KV entries written, block fully inside
the prompt), the block is *published* under a chain key
``h_j = H(h_{j-1}, tokens_j)``.  A later request whose prompt walks the
same chain maps its matching prefix onto those already-written pages
(refcount incremented, no fresh block, no prefill for those tokens) and
only allocates fresh blocks for the divergent remainder.  Because decode
only ever writes the page holding the *current* position, fully-shared
blocks are read-only by construction; the one write hazard is a partial
tail match (shared length not a multiple of ``block_size``), which is
resolved by copy-on-write: :meth:`alloc` maps the tail onto a fresh block
and records a pending page copy that the engine executes at bind, before
the first divergent write.  Published block content is immutable (positions
only move forward), so sharing is bit-exact: same tokens at same positions
under the same params produce the same KV.

Collision handling: chain keys come from an injectable ``prefix_hash``
(useful for testing); the index buckets entries per key and every lookup
re-verifies parent key and the full token tuple, so a hash collision can
only cause a missed share, never a false one.

Invariants (property-tested in tests/test_torch_serving.py):
  * every allocated block has refcount >= 1 and refcount equals the number
    of leases holding it (plus pending COW sources);
    free + distinct-allocated == total_blocks;
  * without sharing, a block belongs to at most one request;
  * a slot belongs to at most one request; double alloc/free raises;
  * published blocks are full and never written again (the writer's
    position is already past them);
  * blocks are interchangeable — fragmentation never blocks an admit whose
    fresh-block count fits the free list.

Note on :meth:`utilization` under sharing: written tokens are counted per
lease while physical blocks are counted once, so utilization may exceed
1.0 — that surplus IS the dedup win.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def default_prefix_hash(parent: Optional[int],
                        tokens: Tuple[int, ...]) -> int:
    """Chain-hash one block of token ids onto its parent key."""
    return hash((parent,) + tokens)


@dataclasses.dataclass
class PrefixEntry:
    """One published block in the prefix index."""
    key: int                            # chain hash at this depth
    parent: Optional[int]               # parent chain key (None at depth 0)
    tokens: Tuple[int, ...]             # the block's token ids (full block)
    block: int                          # physical block id


@dataclasses.dataclass
class SlotLease:
    rid: int
    slot: int
    blocks: List[int]                   # logical order IS the block table
    reserved_tokens: int                # footprint reserved at admission
    written_tokens: int = 0             # KV entries present (incl. shared)
    prompt: Optional[Tuple[int, ...]] = None    # token ids (for publication)
    shared_tokens: int = 0              # prefix mapped onto shared pages
    n_published: int = 0                # full prompt blocks in the index
    chain_keys: List[int] = dataclasses.field(default_factory=list)


class KVPool:
    """Slot + block allocator backing the paged KV cache.

    One pool per :class:`~repro_torch.serving.engine_loop.SlotEngine`.  The
    batcher asks :meth:`can_admit` / :meth:`alloc` at admission, the
    engine reads :meth:`block_table` at bind and calls :meth:`note_write`
    per decode burst; :meth:`free` returns everything on completion.
    """

    def __init__(self, n_slots: int, max_seq: int, *, block_size: int = 16,
                 total_blocks: Optional[int] = None,
                 prefix_sharing: bool = False,
                 prefix_hash: Callable[[Optional[int], Tuple[int, ...]],
                                       int] = default_prefix_hash):
        if n_slots <= 0 or max_seq <= 0 or block_size <= 0:
            raise ValueError("n_slots, max_seq, block_size must be positive")
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.block_size = block_size
        self.blocks_per_slot = math.ceil(max_seq / block_size)
        dense = n_slots * self.blocks_per_slot
        self.total_blocks = dense if total_blocks is None else total_blocks
        self.prefix_sharing = prefix_sharing
        self._hash = prefix_hash
        self._free_slots = list(range(n_slots - 1, -1, -1))
        self._free_blocks = list(range(self.total_blocks - 1, -1, -1))
        self._leases: Dict[int, SlotLease] = {}
        self._block_refs: Dict[int, int] = {}
        # prefix index: chain key -> bucket of verified-on-lookup entries
        # (collisions and duplicate publications share a bucket), plus a
        # reverse map so a freed block's entry can be evicted in O(bucket).
        self._prefix_index: Dict[int, List[PrefixEntry]] = {}
        self._block_entry: Dict[int, PrefixEntry] = {}
        # pending copy-on-write page copies [(src_block, dst_block)] the
        # engine must execute at bind, before the slot's first write.  The
        # source holds an extra ref until consume_cow/free drops it.
        self._pending_cow: Dict[int, List[Tuple[int, int]]] = {}
        # cumulative prefix-sharing counters (stats())
        self.prefix_hits = 0
        self.tokens_prefill_skipped = 0
        self.cow_copies = 0
        self.peak_slots_in_use = 0
        self.peak_blocks_in_use = 0
        # lease-event observer: called as on_event(kind, rid, n_blocks) with
        # kind in {"alloc", "free"}.  The serving loops install a tracer
        # callback here so KV block leases appear as per-request trace
        # instants; None (default) costs one attribute check per event.
        self.on_event = None

    # ---- capacity queries ------------------------------------------------
    def blocks_needed(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.block_size)

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    @property
    def free_block_count(self) -> int:
        return len(self._free_blocks)

    @property
    def allocated_block_count(self) -> int:
        return self.total_blocks - len(self._free_blocks)

    def shared_prefix_tokens(self, prompt: Sequence[int]) -> int:
        """Tokens of ``prompt`` the index can serve from shared pages.

        Capped at ``len(prompt) - 1``: the engine must feed at least the
        last prompt token to produce the first sample."""
        if not self.prefix_sharing or prompt is None or len(prompt) == 0:
            return 0
        matched, _, _ = self._match_prefix(prompt)
        return min(matched, len(prompt) - 1)

    def fresh_blocks_needed(self, n_tokens: int,
                            prompt: Optional[Sequence[int]] = None) -> int:
        """Blocks an admit would draw from the free list (shared full
        blocks excluded; a COW'd tail still costs a fresh block)."""
        shared = self.shared_prefix_tokens(prompt) if prompt is not None \
            else 0
        return self.blocks_needed(n_tokens) - shared // self.block_size

    def can_admit(self, n_tokens: int,
                  prompt: Optional[Sequence[int]] = None) -> bool:
        if n_tokens > self.max_seq:
            return False                # would overflow the slot row
        return (bool(self._free_slots)
                and (self.fresh_blocks_needed(n_tokens, prompt)
                     <= len(self._free_blocks)))

    # ---- prefix index ----------------------------------------------------
    def _find_entry(self, key: int, parent: Optional[int],
                    tokens: Tuple[int, ...]) -> Optional[PrefixEntry]:
        """Bucket scan with full verification — collisions become misses."""
        for e in self._prefix_index.get(key, ()):
            if e.parent == parent and e.tokens == tokens:
                return e
        return None

    def _match_prefix(self, prompt: Sequence[int]
                      ) -> Tuple[int, List[int], List[int]]:
        """Longest indexed prefix of ``prompt``: (matched_tokens, blocks,
        chain_keys_of_full_matches).

        Walks the hash chain block by block; where the full-block walk
        ends (divergence mid-block, or the prompt's own tail), the sibling
        entries under the same parent are scanned for the longest
        token-level common prefix — that entry becomes a shared *tail*
        block (the COW source), so sharing is token-granular even though
        the index is block-granular."""
        bs = self.block_size
        plen = len(prompt)
        blocks: List[int] = []
        keys: List[int] = []
        parent: Optional[int] = None
        j = 0
        while (j + 1) * bs <= plen:
            tokens = tuple(int(t) for t in prompt[j * bs:(j + 1) * bs])
            key = self._hash(parent, tokens)
            entry = self._find_entry(key, parent, tokens)
            if entry is None:
                break
            blocks.append(entry.block)
            keys.append(key)
            parent = key
            j += 1
        # partial tail: buckets cannot serve sub-block lookups (the chain
        # key hashes the full block), so scan this depth's siblings
        seg = tuple(int(t) for t in prompt[j * bs:min(plen, (j + 1) * bs)])
        if seg:
            best, best_d = None, 0
            for bucket in self._prefix_index.values():
                for e in bucket:
                    if e.parent != parent:
                        continue
                    d = 0
                    for a, b in zip(e.tokens, seg):
                        if a != b:
                            break
                        d += 1
                    if d > best_d:
                        best, best_d = e, d
            if best is not None:
                blocks.append(best.block)
                return j * bs + best_d, blocks, keys
        return j * bs, blocks, keys

    def _publish(self, lease: SlotLease) -> None:
        """Insert newly-full prompt blocks into the prefix index.

        A block is publishable once every one of its ``block_size``
        positions lies inside the prompt AND has been written — after that
        the writer's position is past it, so the content is frozen."""
        if not self.prefix_sharing or lease.prompt is None:
            return
        bs = self.block_size
        pub_limit = min(lease.written_tokens, len(lease.prompt)) // bs
        while lease.n_published < pub_limit:
            j = lease.n_published
            tokens = lease.prompt[j * bs:(j + 1) * bs]
            parent = lease.chain_keys[j - 1] if j else None
            key = self._hash(parent, tokens)
            if len(lease.chain_keys) <= j:
                lease.chain_keys.append(key)
            block = lease.blocks[j]
            if block not in self._block_entry:
                entry = PrefixEntry(key=key, parent=parent, tokens=tokens,
                                    block=block)
                self._prefix_index.setdefault(key, []).append(entry)
                self._block_entry[block] = entry
            lease.n_published += 1

    def _deref(self, block: int) -> None:
        self._block_refs[block] -= 1
        if self._block_refs[block] == 0:
            del self._block_refs[block]
            entry = self._block_entry.pop(block, None)
            if entry is not None:
                bucket = self._prefix_index[entry.key]
                bucket.remove(entry)
                if not bucket:
                    del self._prefix_index[entry.key]
            self._free_blocks.append(block)

    # ---- alloc / free ----------------------------------------------------
    def alloc(self, rid: int, n_tokens: int,
              prompt: Optional[Sequence[int]] = None) -> int:
        """Reserve a slot + the blocks for the request's full footprint.

        With ``prefix_sharing`` and a ``prompt``, the longest indexed
        prefix is mapped onto shared pages (refcount++), only the
        remainder draws fresh blocks, and ``lease.shared_tokens`` /
        ``written_tokens`` start past the shared KV.  A partial-tail match
        schedules a COW page copy (see :meth:`consume_cow`).  Returns the
        slot index."""
        if rid in self._leases:
            raise ValueError(f"request {rid} already holds a slot")
        use_sharing = self.prefix_sharing and prompt is not None \
            and len(prompt) > 0
        shared = 0
        mblocks: List[int] = []
        keys: List[int] = []
        if use_sharing:
            matched, mblocks, keys = self._match_prefix(prompt)
            shared = min(matched, len(prompt) - 1)
        if not self.can_admit(n_tokens, prompt if use_sharing else None):
            raise ValueError(f"pool cannot admit {n_tokens} tokens "
                             f"(free slots={self.free_slot_count}, "
                             f"free blocks={self.free_block_count})")
        bs = self.block_size
        shared_full = shared // bs
        fresh_needed = self.blocks_needed(n_tokens) - shared_full
        slot = self._free_slots.pop()
        fresh = [self._free_blocks.pop() for _ in range(fresh_needed)]
        blocks = mblocks[:shared_full] + fresh
        for b in mblocks[:shared_full]:
            self._block_refs[b] += 1
        for b in fresh:
            self._block_refs[b] = 1
        lease = SlotLease(
            rid=rid, slot=slot, blocks=blocks, reserved_tokens=n_tokens,
            written_tokens=shared,
            prompt=tuple(int(t) for t in prompt) if use_sharing else None,
            shared_tokens=shared, n_published=shared_full,
            chain_keys=keys[:shared_full])
        self._leases[rid] = lease
        if shared % bs:
            # partial tail: COW the shared source page into fresh[0]
            # before the first divergent write (position `shared`).  The
            # source keeps an extra ref until the copy is consumed.
            src = mblocks[shared_full]
            self._block_refs[src] += 1
            self._pending_cow.setdefault(rid, []).append((src, fresh[0]))
            self.cow_copies += 1
        if shared:
            self.prefix_hits += 1
            self.tokens_prefill_skipped += shared
        self.peak_slots_in_use = max(self.peak_slots_in_use,
                                     self.n_slots - self.free_slot_count)
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.allocated_block_count)
        if self.on_event is not None:
            self.on_event("alloc", rid, len(blocks))
        return slot

    def consume_cow(self, rid: int) -> List[Tuple[int, int]]:
        """Drain the request's pending COW page copies [(src, dst)].

        The caller (``SlotEngine.bind``) must materialize the
        copies before any subsequent ``alloc`` — dropping the source's
        extra ref here may return it to the free list."""
        ops = self._pending_cow.pop(rid, [])
        for src, _ in ops:
            self._deref(src)
        return ops

    def note_write(self, rid: int, n_tokens: int = 1) -> None:
        """Record KV entries written for `rid` (utilization accounting;
        publishes newly-full prompt blocks to the prefix index)."""
        lease = self._leases[rid]
        lease.written_tokens += n_tokens
        if lease.written_tokens > lease.reserved_tokens:
            raise ValueError(f"request {rid} wrote past its reservation "
                             f"({lease.written_tokens} > "
                             f"{lease.reserved_tokens})")
        self._publish(lease)

    def free(self, rid: int) -> int:
        """Release the request's slot + block refs.  A block returns to the
        free list (and leaves the prefix index) only at refcount zero.
        Returns the slot index."""
        lease = self._leases.pop(rid, None)
        if lease is None:
            raise ValueError(f"request {rid} holds no slot (double free?)")
        for src, _ in self._pending_cow.pop(rid, []):
            self._deref(src)            # unconsumed COW: drop the src ref
        for b in lease.blocks:
            self._deref(b)
        self._free_slots.append(lease.slot)
        if self.on_event is not None:
            self.on_event("free", rid, len(lease.blocks))
        return lease.slot

    def lease(self, rid: int) -> SlotLease:
        return self._leases[rid]

    def shared_tokens(self, rid: int) -> int:
        """Prefix tokens request `rid` serves from shared pages (0 when
        sharing is off or nothing matched)."""
        return self._leases[rid].shared_tokens

    def block_table(self, rid: int, pad_to: Optional[int] = None
                    ) -> np.ndarray:
        """The request's physical block ids in logical order (block ``j``
        holds tokens ``[j * block_size, (j + 1) * block_size)``), padded
        with 0 to ``pad_to`` entries — the row the paged decode step's
        gather indexes with.  Padding entries are never dereferenced for a
        valid position (the per-slot position mask hides them)."""
        blocks = self._leases[rid].blocks
        n = len(blocks) if pad_to is None else pad_to
        if len(blocks) > n:
            raise ValueError(f"request {rid} holds {len(blocks)} blocks, "
                             f"pad_to={pad_to} is smaller")
        row = np.zeros((n,), np.int32)
        row[:len(blocks)] = blocks
        return row

    # ---- accounting ------------------------------------------------------
    @property
    def written_tokens(self) -> int:
        """KV entries visible across all live leases (shared KV counts once
        per lease — the per-request view, not the physical one)."""
        return sum(l.written_tokens for l in self._leases.values())

    def utilization(self) -> float:
        """Written tokens / capacity of allocated blocks.  Without sharing
        this is <= 1 (1 - internal fragmentation + unreached reservation);
        with sharing it may exceed 1 — the dedup factor."""
        alloc_tokens = self.allocated_block_count * self.block_size
        if alloc_tokens == 0:
            return 0.0
        return self.written_tokens / alloc_tokens

    def occupancy(self) -> float:
        """Allocated blocks / total blocks (pool pressure for admission)."""
        return self.allocated_block_count / self.total_blocks

    def stats(self) -> Dict[str, float]:
        out = {
            "slots_in_use": self.n_slots - self.free_slot_count,
            "blocks_in_use": self.allocated_block_count,
            "total_blocks": self.total_blocks,
            "occupancy": self.occupancy(),
            "utilization": self.utilization(),
            "peak_slots_in_use": self.peak_slots_in_use,
            "peak_blocks_in_use": self.peak_blocks_in_use,
        }
        if self.prefix_sharing:
            out.update({
                "prefix_hits": self.prefix_hits,
                "tokens_prefill_skipped": self.tokens_prefill_skipped,
                "cow_copies": self.cow_copies,
                "shared_tokens_in_use": sum(
                    l.shared_tokens for l in self._leases.values()),
            })
        return out
