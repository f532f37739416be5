"""Radix prefix cache: share identical prompt prefixes across joins.

Ported from ``repro.serving.prefixcache``.  RAG prompts repeat prefixes:
the same retrieved chunks come back, in the same order, for recurring
queries.  This module keeps the KV pages of recently prefilled prompts in
a radix tree keyed by token content, so a joining request maps the
longest cached prefix straight into its block table
(``PagePool.admit(shared=...)``, one reference per page) and prefills
only the novel suffix.

Structure
    One :class:`RadixNode` per KV **page**: full nodes carry exactly
    ``page_size`` tokens; a *tail* node (fewer tokens, always a leaf)
    caches a prompt's final partial page.  ``match`` walks exact
    full-page edges and ends with a longest-common-prefix match against
    the divergence node, so a partially matched page is shared too: the
    joiner copies it (copy-on-write) before its suffix prefill overwrites
    the divergent half.

Ownership
    The cache holds **one reference** on every cached device page.  Live
    slots mapping a page hold further references, and ``match`` *pins*
    every node it returns (+1), so an eviction pass between the match and
    the join that maps it can never free a matched page: eviction only
    touches pages whose count is exactly 1 (held by the cache alone).

Eviction
    LRU over unpinned nodes, through the swap tier: a victim page
    *demotes* to the :class:`~repro_torch.serving.kvpool.HostPagePool`
    (a whole-page copy to the host, the device page freed) and the next
    ``match`` that walks through the node revives it onto a fresh device
    page.  Only when the host tier is full does a leaf subtree drop.

The cache owns bookkeeping only: the pool tensors stay with the
generator and the methods that move page data (revival, demotion) update
them in place.  Those copies go through ``HostPagePool.store``/``load``
and are queued on the current stream; the staging buffer each returns is
dropped at once, which is safe because the caching allocator hands a
freed block only to work queued after the copy on the same stream.

Token-identity contract: prefix-hit joins give the tokens of uncached
prefill, including copy-on-write divergence and preempt/resume of slots
holding shared pages (``tests/test_torch_prefix.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class PrefixCacheStats:
    hits: int = 0              # joins that matched a non-empty prefix
    misses: int = 0
    hit_tokens: int = 0        # prompt tokens served from cached pages
    inserted_pages: int = 0
    demoted_pages: int = 0     # device -> host (swap tier)
    revived_pages: int = 0     # host -> device on a later hit
    dropped_pages: int = 0     # evicted for real (host tier full)


class RadixNode:
    """One cached KV page: ``key`` tokens, a device page id or a parked
    host residency, an LRU timestamp, and the child edges keyed by their
    token tuples."""
    __slots__ = ("key", "page", "on_host", "children", "parent",
                 "last_used")

    def __init__(self, key: Tuple[int, ...],
                 parent: Optional["RadixNode"]):
        self.key = key
        self.page: Optional[int] = None
        self.on_host = False
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.parent = parent
        self.last_used = 0

    def __repr__(self) -> str:       # debugging aid only
        where = "host" if self.on_host else f"page={self.page}"
        return f"RadixNode(len={len(self.key)}, {where})"


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PrefixCache:
    """Radix tree of cached prompt-prefix KV pages (one node per page).

    ``kv`` is the generator's :class:`~repro_torch.serving.kvpool.PagedKVCache`
    and ``pools`` its pooled cache dict, updated in place.
    """

    def __init__(self, page_size: int,
                 device_page_budget: Optional[int] = None):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        # None: bounded only by the pool; ``retarget`` sets it
        self.budget = device_page_budget
        self.root = RadixNode((), None)
        self.stats = PrefixCacheStats()
        self._clock = 0

    # ------------------------------------------------------------ queries
    def _nodes(self) -> List[RadixNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    @property
    def device_pages(self) -> int:
        """Cached pages resident in the device pool."""
        return sum(1 for n in self._nodes() if n.page is not None)

    @property
    def host_pages(self) -> int:
        return sum(1 for n in self._nodes() if n.on_host)

    def evictable_pages(self, kv) -> int:
        """Device pages ``reclaim`` could free now (refcount 1)."""
        return len(self._evictable(kv))

    # -------------------------------------------------------------- match
    def match(self, toks: Sequence[int], kv, pools
              ) -> Tuple[List[RadixNode], int]:
        """Longest cached prefix of ``toks``: ``(nodes, matched)``.

        ``nodes`` is the page chain in logical order (exact full-page
        matches, then at most one partially matched node), each
        **pinned** (refcount+1 on its device page) and on the device:
        host-parked nodes on the path are revived (a fresh page and a copy
        from the host) as the walk reaches them; a revival the pool cannot
        fund ends the match early.  The caller owns the pins: full-page
        shares transfer them to the joiner's block table through
        ``admit(shared=...)``, the partial node is copied, then unpinned.
        """
        self._clock += 1
        toks = [int(t) for t in np.asarray(toks).tolist()]
        nodes: List[RadixNode] = []
        matched = 0
        node = self.root
        while matched < len(toks):
            rem = toks[matched:]
            child = None
            if len(rem) >= self.page_size:
                child = node.children.get(tuple(rem[:self.page_size]))
            take = self.page_size
            if child is None:
                # divergence: share the child with the longest common
                # prefix (a partial page, copied by the joiner)
                best, best_lcp = None, 0
                for key, c in node.children.items():
                    n = _lcp(key, rem)
                    if n > best_lcp:
                        best, best_lcp = c, n
                if best is None:
                    break
                child, take = best, best_lcp
            if not self._pin(child, kv, pools):
                break
            child.last_used = self._clock
            nodes.append(child)
            matched += take
            if take < self.page_size:
                break                       # a partial match ends the chain
            node = child
        return nodes, matched

    def _pin(self, node: RadixNode, kv, pools) -> bool:
        """Make ``node`` device-resident and add one reference."""
        if node.on_host:
            got = kv.pool.grab(1)
            if got is None:                 # no spares: demote the coldest
                got = kv.pool.grab(1) if self.reclaim(1, kv, pools) else None
            if got is None:
                return False
            kv.host.load(pools, node, got)
            kv.host.release(node)
            node.page, node.on_host = got[0], False
            self.stats.revived_pages += 1
        kv.pool.incref(node.page)
        return True

    def unpin(self, nodes: Sequence[RadixNode], kv) -> None:
        """Drop match-time pins that did not transfer to a block table."""
        for n in nodes:
            kv.pool.decref(n.page)

    # ------------------------------------------------------------- insert
    def insert(self, toks: Sequence[int], pages: Sequence[int], kv,
               pools) -> None:
        """Register a fully prefilled prompt's pages.

        ``pages`` is the slot's block-table run covering the prompt.
        Missing nodes share the slot's pages (refcount+1: the cache's
        hold); blocks already cached are left alone.  The final partial
        page is shared too: the donor's first decode step past the shared
        boundary detaches it by copy-on-write
        (``ContinuousGenerator._cow_barrier``), leaving the cache's copy
        as it was.  Ends by enforcing the device budget.
        """
        self._clock += 1
        toks = [int(t) for t in np.asarray(toks).tolist()]
        node = self.root
        for b, page in enumerate(pages):
            seg = tuple(toks[b * self.page_size:(b + 1) * self.page_size])
            if not seg:
                break
            child = node.children.get(seg)
            if child is None:
                child = RadixNode(seg, node)
                child.page = page
                kv.pool.incref(page)
                node.children[seg] = child
                self.stats.inserted_pages += 1
            child.last_used = self._clock
            if len(seg) < self.page_size:
                break                        # tail nodes are leaves
            node = child
        self.enforce(kv, pools)

    # ----------------------------------------------------------- eviction
    def _evictable(self, kv) -> List[RadixNode]:
        """Device-resident nodes only the cache references (LRU order)."""
        out = [n for n in self._nodes()
               if n.page is not None and kv.pool.refcount(n.page) == 1]
        out.sort(key=lambda n: n.last_used)
        return out

    def _subtree(self, node: RadixNode) -> List[RadixNode]:
        out, stack = [], [node]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def _drop(self, node: RadixNode, kv) -> int:
        """Drop ``node``'s whole subtree (device and host references)."""
        freed = 0
        for n in self._subtree(node):
            if n.page is not None:
                kv.pool.decref(n.page)
                freed += 1
            elif n.on_host:
                kv.host.release(n)
            n.children.clear()
            self.stats.dropped_pages += 1
        node.parent.children.pop(node.key, None)
        node.parent = None
        return freed

    def _demote_or_drop(self, node: RadixNode, kv, pools) -> int:
        """Free one device page: park it on the host when the swap tier
        has room (children stay, the chain revives on the next hit), else
        drop a leaf subtree."""
        if kv.host.acquire(node, 1, reserve=0) is not None:
            kv.host.store(pools, node, [node.page])
            kv.pool.decref(node.page)
            node.page, node.on_host = None, True
            self.stats.demoted_pages += 1
            return 1
        # host tier full: only a fully unpinned subtree may drop
        if any(n.page is not None and kv.pool.refcount(n.page) > 1
               for n in self._subtree(node)):
            return 0
        return self._drop(node, kv)

    def reclaim(self, n_pages: int, kv, pools) -> int:
        """Free at least ``n_pages`` device pages by LRU demotion (a drop
        only when the host tier is full); returns the pages freed.
        Pinned or mapped pages (refcount > 1) are never touched, so a join
        that just matched a node cannot race its eviction."""
        freed = 0
        while freed < n_pages:
            cands = self._evictable(kv)
            if not cands:
                break
            got = 0
            for victim in cands:
                got = self._demote_or_drop(victim, kv, pools)
                if got:
                    break
            if not got:
                break
            freed += got
        return freed

    def drop_page(self, page: int, kv) -> bool:
        """Un-cache the node holding ``page`` (no demotion): the
        copy-on-write fallback when no spare page can fund a copy.
        Dropping the cache's reference makes the page private again, so
        the write may go ahead in place."""
        for n in self._nodes():
            if n.page == page:
                self._drop(n, kv)
                return True
        return False

    def enforce(self, kv, pools) -> None:
        """Demote LRU pages until the device footprint fits the budget."""
        if self.budget is not None:
            over = self.device_pages - self.budget
            if over > 0:
                self.reclaim(over, kv, pools)

    def clear(self, kv, pools) -> None:
        """Drop every cached page (device references and host pages)."""
        for child in list(self.root.children.values()):
            self._drop(child, kv)
