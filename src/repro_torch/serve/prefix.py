"""Page-granular radix prefix tree: admit-by-reference for shared prompts
(the port's own copy of ``repro/serve/prefix.py``: plain Python, so the
port and the reference decide identically).

Chat templates and few-shot headers give live traffic long COMMON token
prefixes; re-prefilling them per request is pure waste. This tree maps
full-page token runs (tuples of ``page_size`` prompt tokens) to resident
KV pages: a node per page, children keyed by the NEXT page's tokens —
a radix tree at page granularity. A new request walks its prompt down
the tree, takes a reference on every matched node, points its page
table at the shared pages, and resumes chunked prefill at the shared
boundary through the existing ``prefill_chunk(..., offset, nvalid)``
contract (``repro_torch.serve.engine`` aligns the resume offset as the
flash chunk body needs).

WHY SHARING IS BITWISE-SAFE: a prompt position's cache bits do not
depend on which chunk computed it (the scan body runs every position
through the same batch-1 decode step; the flash body gives the same
bits for the same chunk-aligned offsets, and the engine aligns resume
offsets to them). A donor's page therefore holds EXACTLY the bits the
new request's private prefill would have produced, and the
shared-vs-private tests compare them bitwise.

OWNERSHIP AND LIFECYCLE: a page referenced by a node is TREE-owned
(the engine's allocator no longer tracks it); ``refs`` counts live
requests currently reading through the node (donor included until it
finishes). Nodes at refs == 0 are retained as cache and reclaimed by
``evict`` under pool pressure — deterministically, leaf-first, oldest
insertion stamp first — after which the engine zero-resets the pages
and returns them to the free list. Copy-on-write at the first divergent
page: a request that shares only part of a page gets a fresh page, a
device-side copy of the donor's, and private ownership of it; donor
pages are NEVER written by beneficiaries (the engine's prefill writes
back only the pages from the resume offset on).

Everything here is plain deterministic Python — matching, refcounts and
eviction run at admission/finish on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class PrefixNode:
    """One resident full-page prompt run.

    key     the page's ``page_size`` prompt tokens
    page    the pool page holding its KV bits (tree-owned)
    refs    live requests currently reading through this node
    stamp   insertion counter — the deterministic eviction order
    """

    key: Tuple[int, ...]
    page: int
    refs: int = 0
    stamp: int = 0
    parent: Optional["PrefixNode"] = None
    children: Dict[Tuple[int, ...], "PrefixNode"] = dataclasses.field(
        default_factory=dict)


class RadixPrefixTree:
    """Refcounted page-granular prefix index over live prompt tokens."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = PrefixNode(key=(), page=-1)   # sentinel, never evicted
        self._stamp = 0

    # ------------------------------------------------------------- matching
    def _page_keys(self, prompt: Sequence[int],
                   n_pages: int) -> List[Tuple[int, ...]]:
        ps = self.page_size
        return [tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
                for i in range(n_pages)]

    def match(self, prompt: Sequence[int]) -> List[PrefixNode]:
        """Deepest resident full-page path along ``prompt`` (no refs
        taken — the engine acquires after it settles alignment caps)."""
        path: List[PrefixNode] = []
        node = self.root
        for key in self._page_keys(prompt, len(prompt) // self.page_size):
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def partial_child(self, path: List[PrefixNode], prompt: Sequence[int],
                      ) -> Tuple[Optional[PrefixNode], int]:
        """(donor child, overlap tokens) for copy-on-write at the first
        divergent page: among the children one level past the full-page
        match, the one sharing the LONGEST strict prefix of the next
        page's tokens (ties broken by lowest stamp — deterministic).
        Returns (None, 0) when no child shares even one token."""
        node = path[-1] if path else self.root
        start = len(path) * self.page_size
        nxt = [int(t) for t in prompt[start:start + self.page_size]]
        best: Optional[PrefixNode] = None
        best_t = 0
        for child in sorted(node.children.values(), key=lambda c: c.stamp):
            t = 0
            for a, b in zip(child.key, nxt):
                if a != b:
                    break
                t += 1
            if t > best_t:
                best, best_t = child, t
        return best, best_t

    # ------------------------------------------------------------ refcounts
    def acquire(self, path: Sequence[PrefixNode]) -> None:
        for node in path:
            node.refs += 1

    def release(self, path: Sequence[PrefixNode]) -> None:
        for node in path:
            if node.refs < 1:
                raise RuntimeError(
                    f"prefix refcount underflow on page {node.page}")
            node.refs -= 1

    # ------------------------------------------------------------ insertion
    def insert(self, prompt: Sequence[int], n_pages: int,
               pages: Sequence[int]) -> Tuple[List[int], List[int]]:
        """Register a finished request's first ``n_pages`` prompt pages.

        ``pages[j]`` is the request's pool page for logical page ``j``.
        Walks existing nodes (their pages already hold the identical
        bits — the bitwise contract — so first-insert wins); creates
        nodes for the novel suffix, ADOPTING the request's pages into
        tree ownership. Returns ``(adopted, duplicates)``: pages now
        tree-owned vs pages made redundant by a concurrent identical
        insert (the caller frees those).
        """
        adopted: List[int] = []
        duplicates: List[int] = []
        node = self.root
        for j, key in enumerate(self._page_keys(prompt, n_pages)):
            child = node.children.get(key)
            if child is None:
                self._stamp += 1
                child = PrefixNode(key=key, page=int(pages[j]),
                                   stamp=self._stamp, parent=node)
                node.children[key] = child
                adopted.append(int(pages[j]))
            elif child.page != int(pages[j]):
                duplicates.append(int(pages[j]))
            node = child
        return adopted, duplicates

    # ------------------------------------------------------------- eviction
    def evict(self, need: int) -> List[int]:
        """Reclaim up to ``need`` pages from refs-0 LEAF nodes, oldest
        stamp first (evicting a leaf may expose its parent — the walk
        repeats until satisfied or nothing is evictable). The engine
        zero-resets the returned pages before reuse."""
        freed: List[int] = []
        while len(freed) < need:
            leaves = [n for n in self._iter_nodes()
                      if not n.children and n.refs == 0]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: (n.stamp, n.page))
            del victim.parent.children[victim.key]
            freed.append(victim.page)
        return freed

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    # ------------------------------------------------------------ accounting
    @property
    def total_pages(self) -> int:
        """Pages the tree owns (shared live + retained cache)."""
        return sum(1 for _ in self._iter_nodes())

    @property
    def cached_pages(self) -> int:
        """Tree pages no live request references (evictable cache)."""
        return sum(1 for n in self._iter_nodes() if n.refs == 0)

    @property
    def referenced_pages(self) -> int:
        """Tree pages at least one live request reads through."""
        return sum(1 for n in self._iter_nodes() if n.refs > 0)

    def pages(self) -> List[int]:
        """Every tree-owned page id (tests / teardown)."""
        return [n.page for n in self._iter_nodes()]
