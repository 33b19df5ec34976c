"""Block-paged KV pool with cross-request prefix sharing (paper §9).

After `src/repro/launch/kv_pool.py`. The cheapest prefill is the one that
never dispatches: chat-shaped traffic (shared system prompts, few-shot
templates, multi-turn) re-computes identical prefixes from token 0 on every
admission. The pool turns the per-lane monolithic cache slab into a shared,
block-paged pool, so a resident prefix is reused instead of re-prefilled:

  * **block arena** — `n_blocks` rows per paged cache leaf, each holding
    `block_size` consecutive positions of one sequence's KV state
    (`(n_blocks, stack, block_size, ...)` per leaf), on the caches' device.
  * **prefix trie on token-block hashes** — block k of a prompt is keyed by
    `sha256(parent_key || tokens[k*bs:(k+1)*bs])` (int32 token bytes), so a
    key names the whole prefix up to its block; the keys equal the
    reference's.
  * **per-lane page tables**, **refcounts + copy-on-write**, **LRU or
    cost-aware eviction** of refcount-0 blocks, and **anchors** (a snapshot
    of every non-paged leaf at a chain's end, so a lane resumes exactly
    there) — the reference's host-side machine, copied step for step.

The host half is the reference's Python unchanged. The device half works on
torch tensors in place: `insert_blocks` writes arena rows by index (the
block ids of one insert are distinct, so no write order matters),
`assemble_prefix` gathers a chain's rows into a batch-1 prefill-shaped tree,
and a copy-on-write divergence copies one row to another.

The serving loop never reads the arena directly: a prefix hit gathers the
blocks into the lane's monolithic cache (`assemble_prefix`) and decode goes
through `decode_attention`, as in the reference. The decode-side read path
for an arena-resident lane is
`kernels/flash/decode_attention.paged_decode_attention`, which reads a
layer's slice `arena[:, l]` in place.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, map_with_path

# Cache leaves with a KV time axis, merged/paged by name: the single axis on
# which a prefill cache may be shorter than the decode buffer. Everything
# else (recurrent state, conv tails) must match exactly or fail loud.
TIME_MERGE_LEAVES = frozenset({"k", "v", "pos", "c_kv", "k_rope"})

#: time axis of stacked serving cache leaves: (stack, batch, time, ...)
_TIME_AXIS = 2


def _leaf_name(loc: str) -> str:
    return loc.rsplit("/", 1)[-1]


@dataclasses.dataclass
class _Block:
    """One resident block: a trie node plus its arena row."""

    key: str                      # chain hash (identifies the whole prefix)
    parent: str | None
    bid: int                      # arena row
    tokens: np.ndarray            # this block's own tokens (audit/debug)
    lane_refs: int = 0            # owners whose page table includes this key
    children: int = 0             # resident child nodes
    anchored: bool = False        # a prefill ended exactly at this boundary
    anchor: dict | None = None    # non-paged leaf snapshot at the boundary
    depth: int = 1                # chain length in blocks, this one included

    @property
    def refcount(self) -> int:
        return self.lane_refs + self.children


class PagedKVPool:
    """Fixed-size block arena + prefix trie + per-lane page tables.

    The metadata layer (match/acquire/release/fork/write/insert and the
    refcount/LRU bookkeeping) runs host-side and is payload-agnostic: the
    reference's and this one take the same steps on the same ops
    (`tests/test_torch_kv_pool.py` holds them together). `bind` attaches
    the device arenas for a concrete cache tree; `insert_blocks` and
    `assemble_prefix` then run inside the scheduler's admission programs,
    so pool traffic is dispatched — and floor-charged — through the
    ExecutionStream like everything else.
    """

    def __init__(self, n_blocks: int, block_size: int, *,
                 evict_cost_fn=None) -> None:
        if n_blocks < 1:
            raise ValueError(f"pool needs n_blocks >= 1, got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"pool needs block_size >= 1, got {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # Costmodel-aware eviction: `evict_cost_fn(n_tokens) -> float` is
        # the modeled cost of re-prefilling a `n_tokens`-deep prefix (the
        # scheduler wires its §9 floor+work estimate in). When set, the
        # eviction victim is the refcount-0 block whose chain is cheapest
        # to rebuild, not merely the least-recently-used; only leaves of
        # the resident trie are ever refcount-0, so this preferentially
        # keeps the deep (expensive) chains hot. None keeps plain LRU.
        self.evict_cost_fn = evict_cost_fn
        self._free: list[int] = list(range(n_blocks - 1, -1, -1))
        self._nodes: dict[str, _Block] = {}
        self._lru: OrderedDict[str, None] = OrderedDict()
        self._tables: dict[Any, list[str]] = {}
        self.stats: dict[str, int] = {
            "hits": 0, "misses": 0, "hit_tokens": 0, "inserted_blocks": 0,
            "evictions": 0, "cow_copies": 0,
        }
        # device side (None until bind)
        self.arenas: dict[str, torch.Tensor] | None = None
        self._paged_paths: set[str] = set()
        self._anchor_paths: set[str] = set()
        self._leaf_paths: list[str] = []

    # -- chain hashing ------------------------------------------------------
    def _key(self, parent: str | None, block_tokens: np.ndarray) -> str:
        h = hashlib.sha256()
        h.update(b"root" if parent is None else parent.encode())
        h.update(np.asarray(block_tokens, np.int32).tobytes())
        return h.hexdigest()

    def _blocks_of(self, tokens) -> list[np.ndarray]:
        t = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        return [t[i * bs:(i + 1) * bs] for i in range(t.size // bs)]

    # -- refcounts / LRU ----------------------------------------------------
    def _ref(self, key: str) -> None:
        node = self._nodes[key]
        node.lane_refs += 1
        self._lru.pop(key, None)

    def _unref(self, key: str) -> bool:
        """Drop one lane reference; True when the block became free
        (refcount 0, parked on the LRU list but still resident)."""
        node = self._nodes[key]
        if node.lane_refs <= 0:
            raise AssertionError(f"block {key[:8]}: unref below zero")
        node.lane_refs -= 1
        if node.refcount == 0:
            self._lru[key] = None
            return True
        return False

    def _evict_victim(self) -> _Block | None:
        """The refcount-0 block the next allocation evicts: the LRU-oldest
        by default, or — with `evict_cost_fn` set — the one whose chain's
        re-prefill cost (`cost_fn(depth * block_size)`) is cheapest, LRU
        order breaking ties. Stale LRU entries are pruned either way."""
        best: _Block | None = None
        best_cost = 0.0
        for key in list(self._lru):
            node = self._nodes.get(key)
            if node is None or node.refcount:
                self._lru.pop(key, None)    # stale entry
                continue
            if self.evict_cost_fn is None:
                return node                 # oldest valid = plain LRU
            cost = float(self.evict_cost_fn(node.depth * self.block_size))
            if best is None or cost < best_cost:
                best, best_cost = node, cost
        return best

    def _alloc_bid(self) -> int | None:
        """A free arena row, evicting a refcount-0 block if needed (see
        `_evict_victim` for the policy). None when every block is
        referenced (pool full, caller skips)."""
        if self._free:
            return self._free.pop()
        victim = self._evict_victim()
        if victim is None:
            return None
        self._lru.pop(victim.key, None)
        self._evict(victim)
        return self._free.pop()

    def _evict(self, node: _Block) -> None:
        del self._nodes[node.key]
        self._free.append(node.bid)
        self.stats["evictions"] += 1
        if node.parent is not None:
            parent = self._nodes.get(node.parent)
            if parent is not None:
                parent.children -= 1
                if parent.refcount == 0:
                    self._lru[parent.key] = None

    # -- trie matching ------------------------------------------------------
    def match(self, tokens) -> list[str]:
        """Chain keys of the longest resident whole-block prefix."""
        keys: list[str] = []
        parent = None
        for blk in self._blocks_of(tokens):
            key = self._key(parent, blk)
            if key not in self._nodes:
                break
            keys.append(key)
            parent = key
        return keys

    def anchored_match(self, tokens, *, limit: int | None = None) -> list[str]:
        """Longest resident chain that ends at an *anchored* boundary,
        covering at most `limit` tokens — the prefix a lane can actually
        resume from (the anchor carries the non-paged state at M)."""
        keys = self.match(tokens)
        if limit is not None:
            keys = keys[: max(limit, 0) // self.block_size]
        while keys and not self._nodes[keys[-1]].anchored:
            keys.pop()
        return keys

    # -- page tables --------------------------------------------------------
    def acquire(self, owner, keys: list[str]) -> int:
        """Reference a matched chain as `owner`'s page table. Returns the
        token length covered."""
        if owner in self._tables:
            raise ValueError(f"pool owner {owner!r} already holds a table")
        for key in keys:
            if key not in self._nodes:
                raise KeyError(f"block {key[:8]} not resident")
        for key in keys:
            self._ref(key)
        self._tables[owner] = list(keys)
        return len(keys) * self.block_size

    def release(self, owner) -> list[str]:
        """Drop `owner`'s page table. Returns exactly the keys that became
        free (refcount 0) — the blocks the lane exclusively owned."""
        keys = self._tables.pop(owner, [])
        return [k for k in keys if self._unref(k)]

    def fork(self, owner, new_owner) -> None:
        """Share `owner`'s page table with `new_owner` (both reference every
        block; divergence later goes through `write`'s copy-on-write)."""
        if new_owner in self._tables:
            raise ValueError(f"pool owner {new_owner!r} already holds a table")
        keys = list(self._tables[owner])
        for key in keys:
            self._ref(key)
        self._tables[new_owner] = keys

    def write(self, owner, idx: int, block_tokens) -> str | None:
        """Diverge `owner`'s chain at block `idx` with new content: the
        copy-on-write point. A block shared with anyone else (other lane
        refs, or resident children) is never mutated or aliased — the new
        content lands on a fresh arena row under its own chain key, and the
        owner's stale suffix is released. Returns the new key, or None when
        the pool is full."""
        table = self._tables[owner]
        if not 0 <= idx < len(table):
            raise IndexError(f"owner {owner!r} has {len(table)} blocks, "
                             f"cannot write block {idx}")
        block_tokens = np.asarray(block_tokens, np.int32).reshape(-1)
        if block_tokens.size != self.block_size:
            raise ValueError(f"write wants exactly one block "
                             f"({self.block_size} tokens), "
                             f"got {block_tokens.size}")
        old = self._nodes[table[idx]]
        parent = table[idx - 1] if idx else None
        new_key = self._key(parent, block_tokens)
        if new_key == old.key:
            # content-identical write: the chain already says this
            for key in table[idx + 1:]:
                self._unref(key)
            self._tables[owner] = table[: idx + 1]
            return new_key
        old_bid = old.bid
        shared = old.lane_refs > 1 or old.children > 0
        for key in table[idx:]:
            self._unref(key)
        node = self._nodes.get(new_key)
        if node is None:
            bid = self._alloc_bid()
            if bid is None:
                self._tables[owner] = table[:idx]
                return None
            if shared and bid == old_bid:
                raise AssertionError(
                    f"copy-on-write aliased shared block {old.key[:8]}")
            node = _Block(key=new_key, parent=parent, bid=bid,
                          tokens=block_tokens.copy(),
                          depth=(self._nodes[parent].depth + 1
                                 if parent is not None else 1))
            self._nodes[new_key] = node
            if parent is not None:
                pnode = self._nodes[parent]
                pnode.children += 1
                self._lru.pop(parent, None)
            self.stats["cow_copies"] += 1
            if self.arenas is not None:
                # divergence copies the old row's payload to the new row, in
                # place; the caller overwrites the diverged positions after
                for ar in self.arenas.values():
                    ar[bid] = ar[old_bid]
        self._ref(node.key)
        self._tables[owner] = table[:idx] + [node.key]
        return node.key

    # -- insertion (the cold path) ------------------------------------------
    def reserve(self, tokens) -> tuple[list[str], list[int], int]:
        """Metadata insert for a prompt prefix: walk/extend the chain for
        every whole block of `tokens`, allocating arena rows for the blocks
        not already resident. Returns (chain keys, new bids, first new block
        index). Stops early when the pool is full — a partial chain is still
        shareable, it just cannot anchor."""
        keys: list[str] = []
        new_bids: list[int] = []
        first_new = -1
        parent = None
        for i, blk in enumerate(self._blocks_of(tokens)):
            key = self._key(parent, blk)
            node = self._nodes.get(key)
            if node is None:
                # take the parent's child reference BEFORE allocating: the
                # allocation may evict, and the chain built so far (fresh
                # refcount-0 blocks included) must not be eviction fodder
                if parent is not None:
                    pnode = self._nodes[parent]
                    pnode.children += 1
                    self._lru.pop(parent, None)
                bid = self._alloc_bid()
                if bid is None:
                    if parent is not None:
                        pnode.children -= 1
                        if pnode.refcount == 0:
                            self._lru[pnode.key] = None
                    break
                node = _Block(key=key, parent=parent, bid=bid,
                              tokens=blk.copy(), depth=i + 1)
                self._nodes[key] = node
                self._lru[key] = None      # refcount 0: resident, evictable
                self.stats["inserted_blocks"] += 1
                new_bids.append(bid)
                if first_new < 0:
                    first_new = i
            keys.append(key)
            parent = key
        return keys, new_bids, first_new

    def set_anchor(self, key: str, anchor: dict | None) -> None:
        """Mark `key`'s boundary as resumable, attaching the non-paged leaf
        snapshot taken at exactly that prefix length."""
        node = self._nodes[key]
        node.anchored = True
        node.anchor = anchor

    def anchor_of(self, key: str) -> dict | None:
        return self._nodes[key].anchor

    def bids_of(self, keys: list[str]) -> list[int]:
        return [self._nodes[k].bid for k in keys]

    # -- introspection (tests / audit) --------------------------------------
    def refcount(self, key: str) -> int:
        return self._nodes[key].refcount

    def resident(self) -> set[str]:
        return set(self._nodes)

    def free_blocks(self) -> int:
        return len(self._free)

    def table(self, owner) -> list[str]:
        return list(self._tables.get(owner, []))

    def owners(self) -> set:
        return set(self._tables)

    def audit(self) -> None:
        """Check every structural invariant; raises AssertionError with the
        first violation. The hypothesis suite calls this after every op."""
        lane_refs: dict[str, int] = {}
        for owner, keys in self._tables.items():
            parent = None
            for key in keys:
                node = self._nodes.get(key)
                assert node is not None, \
                    f"owner {owner!r} references evicted block {key[:8]}"
                assert node.parent == parent, \
                    f"owner {owner!r} table breaks the chain at {key[:8]}"
                lane_refs[key] = lane_refs.get(key, 0) + 1
                parent = key
        children: dict[str, int] = {}
        for node in self._nodes.values():
            if node.parent is not None:
                assert node.parent in self._nodes, \
                    f"block {node.key[:8]} orphaned (parent evicted)"
                children[node.parent] = children.get(node.parent, 0) + 1
        for node in self._nodes.values():
            assert node.lane_refs == lane_refs.get(node.key, 0), \
                (f"block {node.key[:8]}: lane_refs {node.lane_refs} != live "
                 f"page-table references {lane_refs.get(node.key, 0)}")
            assert node.children == children.get(node.key, 0), \
                (f"block {node.key[:8]}: children {node.children} != "
                 f"resident child count {children.get(node.key, 0)}")
        bids = [n.bid for n in self._nodes.values()]
        assert len(bids) == len(set(bids)), "two resident blocks share a row"
        assert not set(bids) & set(self._free), \
            "a resident block's row is on the free list"
        assert len(bids) + len(self._free) == self.n_blocks, \
            "arena rows leaked"
        for key in self._lru:
            node = self._nodes.get(key)
            assert node is None or node.refcount == 0, \
                f"referenced block {key[:8]} is on the eviction list"
        for node in self._nodes.values():
            if node.refcount == 0:
                assert node.key in self._lru, \
                    f"free block {node.key[:8]} missing from the LRU list"
        for node in self._nodes.values():
            want = 1 if node.parent is None \
                else self._nodes[node.parent].depth + 1
            assert node.depth == want, \
                (f"block {node.key[:8]}: depth {node.depth} != chain "
                 f"length {want}")

    # -- device arenas ------------------------------------------------------
    def bind(self, dec_caches, *, max_len: int) -> None:
        """Attach arenas for a concrete decode-cache tree, on its leaves'
        devices. A leaf pages iff it is a named KV-time leaf whose time
        extent equals `max_len`; ring-buffer window leaves (extent < max_len)
        and every recurrent/conv leaf ride the anchor instead."""
        if self.arenas is not None:
            return
        arenas: dict[str, torch.Tensor] = {}
        anchor_paths: set[str] = set()
        paths: list[str] = []
        for loc, leaf in leaves_with_path(dec_caches):
            paths.append(loc)
            if (_leaf_name(loc) in TIME_MERGE_LEAVES
                    and leaf.ndim > _TIME_AXIS
                    and leaf.shape[_TIME_AXIS] == max_len):
                row_shape = ((self.n_blocks, leaf.shape[0], self.block_size)
                             + tuple(leaf.shape[_TIME_AXIS + 1:]))
                arenas[loc] = torch.zeros(row_shape, dtype=leaf.dtype, device=leaf.device)
            else:
                anchor_paths.add(loc)
        self.arenas = arenas
        self._paged_paths = set(arenas)
        self._anchor_paths = anchor_paths
        self._leaf_paths = paths

    def validate_prefill(self, pf_caches, n_tokens: int, *,
                         staging: bool = False) -> None:
        """Loud-failure gate before arena writes: every paged leaf of a
        prefill cache must be batch-1, rank-matched and exactly `n_tokens`
        long on the time axis (at least `n_tokens` for a decode-shaped
        `staging` cache); any mismatch raises with the tree path rather than
        silently caching truncated state."""
        seen = []
        for loc, leaf in leaves_with_path(pf_caches):
            seen.append(loc)
            if loc not in self._paged_paths:
                continue
            arena = self.arenas[loc]
            # same rank: the arena drops the batch axis but adds the block
            # axis ((n_blocks, stack, bs, ...) vs (stack, 1, T, ...))
            if leaf.ndim != arena.ndim:
                raise ValueError(
                    f"cache leaf {loc!r}: prefill rank {leaf.ndim} "
                    f"{tuple(leaf.shape)} cannot page into arena rank "
                    f"{arena.ndim} {tuple(arena.shape)}")
            if leaf.shape[1] != 1:
                raise ValueError(
                    f"cache leaf {loc!r}: pool insert wants a batch-1 "
                    f"prefill cache, got batch {leaf.shape[1]}")
            extent = leaf.shape[_TIME_AXIS]
            if (extent < n_tokens) if staging else (extent != n_tokens):
                raise ValueError(
                    f"cache leaf {loc!r}: prefill time extent "
                    f"{extent} {'<' if staging else '!='} inserted prefix "
                    f"{n_tokens}; off-axis state would be dropped")
            if leaf.shape[_TIME_AXIS + 1:] != arena.shape[_TIME_AXIS + 1:]:
                raise ValueError(
                    f"cache leaf {loc!r}: prefill tail {tuple(leaf.shape)} does "
                    f"not match arena row {tuple(arena.shape)}")
        if set(seen) != set(self._leaf_paths):
            missing = set(self._leaf_paths) ^ set(seen)
            raise ValueError(
                f"prefill cache structure diverges from the bound decode "
                f"cache at {sorted(missing)}")

    def anchor_leaves(self, pf_caches) -> dict[str, torch.Tensor]:
        """Snapshot every non-paged leaf of a prefill cache (recurrent
        state, conv tails, ring-window KV): the anchor payload, copied, so
        no later in-place write reaches it."""
        return {loc: leaf.clone() for loc, leaf in leaves_with_path(pf_caches)
                if loc in self._anchor_paths}

    # -- bodies of the scheduler's pool dispatches ---------------------------
    def insert_blocks(self, arenas, pf_caches, bids: torch.Tensor, start: int):
        """Write blocks [start, start+len(bids)) of a prefill cache into the
        arena rows `bids`, in place. Returns `arenas`."""
        bs = self.block_size
        m = bids.shape[0]
        for loc, leaf in leaves_with_path(pf_caches):
            if loc not in self._paged_paths:
                continue
            row = leaf[:, 0]                                  # (stack, T, ...)
            sl = row[:, start * bs:(start + m) * bs]
            sl = sl.reshape((row.shape[0], m, bs) + tuple(row.shape[2:]))
            arena = arenas[loc]
            arena[bids] = sl.movedim(1, 0).to(arena.dtype)    # (m, stack, bs, ...)
        return arenas

    def assemble_prefix(self, dec_caches, arenas, bids: torch.Tensor, anchor):
        """Gather `bids` through the page table into a batch-1 prefill-like
        tree (paged leaves from the arena, the rest from the anchor) with the
        decode cache's structure, ready for `scheduler.admit_into_slot`: the
        prefix-hit admission body."""
        bs = self.block_size
        m = bids.shape[0]

        def leaf(loc, _dec):
            if loc in self._paged_paths:
                g = torch.index_select(arenas[loc], 0, bids)  # (m, stack, bs, ...)
                g = g.movedim(0, 1)                           # (stack, m, bs, ...)
                g = g.reshape((g.shape[0], m * bs) + tuple(g.shape[3:]))
                return g[:, None]                             # (stack, 1, M, ...)
            if loc not in anchor:
                raise ValueError(
                    f"cache leaf {loc!r}: prefix anchor is missing the "
                    f"non-paged leaf; lane state would be dropped")
            return anchor[loc]
        return map_with_path(leaf, dec_caches)
