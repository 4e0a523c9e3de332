"""Radix prefix cache over token-id prefixes, at page granularity (a
copy of the JAX package's ``serving/prefix_cache.py``, host-side Python
over the port's ``PagePool``).

When many requests share a prompt prefix (the dominant serving pattern
at scale: a fixed system prompt + per-user suffix), the KV state for
the shared tokens is identical across requests — recomputing it per
request wastes exactly the prefill FLOPs the paper's prefill cluster
exists to provide.  This module caches those KV pages across requests:

  * the tree is a radix trie whose edges are **whole pages** of token
    ids (``page_size`` tokens per node) — only full pages are shared,
    because a partially filled page would later be written by its first
    owner (pages are immutable once shared; the pool's copy-on-write
    ``fork`` covers the one legal write into a shared page, the decode
    ring-buffer wrap);
  * each node holds one physical page id in the :class:`PagePool` and
    the tree itself owns one reference to it, so a cached page survives
    its originating request and is reclaimed only by ``evict``;
  * ``lookup(prompt)`` walks the trie and *pins* (retains) every
    matched page before returning, so a concurrent eviction can never
    free a page the caller is about to link into a block table;
  * eviction is LRU over **leaf** nodes whose page is referenced by the
    tree alone — interior nodes are kept while any descendant lives,
    and pages pinned by in-flight requests are never evicted.

The cache never matches a whole prompt: at least the final token is
always left to recompute so admission has fresh ``last_logits`` to
sample the first generated token from (capped at
``(len(prompt) - 1) // page_size`` matched pages).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.pages import PagePool


class _Node:
    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.key = key                       # the page's token ids
        self.page = page                     # physical page id in the pool
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    """Page-granular radix tree mapping token-id prefixes to shared,
    refcounted page chains in a :class:`PagePool`."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _Node((), -1, None)      # sentinel, holds no page
        self._clock = 0
        self._n_nodes = 0
        # stats
        self.hits = 0            # lookups that matched >= 1 page
        self.misses = 0          # lookups that matched nothing
        self.hit_tokens = 0      # total tokens served from cache
        self.evictions = 0       # pages evicted (== nodes removed)
        self.inserts = 0         # pages newly registered

    def __len__(self) -> int:
        return self._n_nodes

    def _chunks(self, tokens: Sequence[int], n_pages: int):
        ps = self.page_size
        for i in range(n_pages):
            yield tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    # ---------------------------------------------------------------- lookup
    def lookup(self, prompt: Sequence[int], *,
               pin: bool = True) -> Tuple[int, List[int]]:
        """Longest cached page-chain prefix of ``prompt``.

        Returns ``(n_tokens_matched, pages)`` where ``pages`` are the
        physical page ids covering the matched tokens, in order.  With
        ``pin=True`` (default) every returned page has been retained in
        the pool; the caller owns those references (release them on
        retire, or immediately if the match goes unused).  The match is
        capped so at least the prompt's final token is recomputed.
        """
        self._clock += 1
        max_pages = max(0, (len(prompt) - 1) // self.page_size)
        node, pages = self.root, []
        for key in self._chunks(prompt, max_pages):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._clock
            pages.append(child.page)
            node = child
        if pages:
            self.hits += 1
            self.hit_tokens += len(pages) * self.page_size
            if pin:
                for p in pages:
                    self.pool.retain(p)
        else:
            self.misses += 1
        return len(pages) * self.page_size, pages

    # ---------------------------------------------------------------- insert
    def insert(self, prompt: Sequence[int], pages: Sequence[int]) -> int:
        """Register a prompt's page chain.  ``pages`` covers the prompt
        from token 0 (shared prefix pages from a prior ``lookup`` plus
        the request's freshly written pages); only the leading
        **full** pages (``len(prompt) // page_size``) are inserted.
        Each page newly adopted by the tree gains one tree-owned
        reference.  Returns the number of pages newly inserted."""
        n_full = len(prompt) // self.page_size
        n_full = min(n_full, len(pages))
        node, fresh = self.root, 0
        for i, key in enumerate(self._chunks(prompt, n_full)):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, pages[i], node)
                node.children[key] = child
                self.pool.retain(pages[i])
                self._n_nodes += 1
                fresh += 1
            child.last_used = self._clock
            node = child
        self.inserts += fresh
        return fresh

    # ---------------------------------------------------------------- evict
    def _evictable_leaves(self) -> List[_Node]:
        out = []

        def walk(n: _Node):
            for c in n.children.values():
                walk(c)
            if n is not self.root and not n.children \
                    and self.pool.refcount[n.page] == 1:
                out.append(n)   # tree holds the only reference

        walk(self.root)
        return out

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages, LRU-first, leaves-first.

        Only leaf nodes whose page is referenced by nothing but the
        tree are candidates (pinned / in-use pages are untouchable);
        freeing a leaf may expose its parent as the next candidate, so
        eviction cascades up cold chains.  Returns pages freed."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for leaf in leaves:
                if freed >= n_pages:
                    break
                del leaf.parent.children[leaf.key]
                self.pool.release(leaf.page)
                self._n_nodes -= 1
                self.evictions += 1
                freed += 1
        return freed

    # ---------------------------------------------------------------- metrics
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "hit_tokens": self.hit_tokens,
            "evictions": self.evictions,
            "inserts": self.inserts,
            "nodes": self._n_nodes,
        }
