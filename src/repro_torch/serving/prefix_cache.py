"""Radix index of prompt prefixes over the paged arena (prefix sharing).

When requests share a prompt head (a system prompt, few-shot examples),
the pages that hold its K/V are the same for every request and need to
live in the arena once.  The paged decode kernel reads a slot's K/V
through its page-table row in any arena order, so two rows that name one
physical page read it as two private copies would.  This module keeps the
bookkeeping that makes such aliasing safe and findable:

  * a radix tree keyed on whole-page token blocks: an edge holds the
    ``page_size`` token ids whose K/V one arena page stores, so a prompt's
    longest cached prefix is found block by block in O(prompt /
    page_size) exact-match steps;
  * partly filled leaves: a prompt whose length is not a page multiple
    indexes its last page with a fill count.  A later prompt that leaves
    it mid-page takes the longest common run of that page as a
    copy-on-write source: the scheduler copies the gathered K/V into a
    fresh page, never aliases it, since the new owner goes on writing
    into it;
  * LRU eviction: every indexed node holds one allocator reference
    (``PageAllocator.share``), so cached pages outlive their slot.  A page
    whose only reader is the index (refcount 1) can be reclaimed;
    :meth:`PrefixCache.evict` frees such pages leaves first, least
    recently matched first, and skips pages a slot still reads.

The index holds no device state: it maps token chains to arena page ids.
The scheduler takes and drops the allocator references and writes the
page-table rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class _Node:
    """One radix edge: ``page_size`` (or fewer, for a partial leaf) token
    ids and the arena page that holds their K/V.  ``fill < page_size``
    marks a partial leaf, which has no children: a chain cannot go on
    past a part-filled page."""

    __slots__ = ("tokens", "page", "fill", "children", "parent", "stamp")

    def __init__(self, tokens, page, fill, parent):
        self.tokens = tokens            # tuple of ``fill`` token ids
        self.page = page                # arena page id (the index's ref)
        self.fill = fill                # valid tokens in the page
        self.children = {}              # token tuple -> _Node (full pages)
        self.parent = parent
        self.stamp = 0                  # LRU clock at the last match/insert


@dataclass
class PrefixMatch:
    """The longest cached prefix of one prompt.

    ``pages``: the arena pages of the whole-page matches, in chain order,
    to adopt by reference (the caller shares them).  ``partial``: an
    optional ``(page, n_tokens)`` copy-on-write source, whose first
    ``n_tokens`` match the prompt after the whole pages; the caller
    gathers it and never aliases it.  The match is clipped to
    ``len(prompt) - 1`` tokens, so that one token at least is prefilled
    (admission needs the last token's logits)."""
    pages: list[int] = field(default_factory=list)
    partial: tuple[int, int] | None = None

    def matched_tokens(self, page_size: int) -> int:
        return len(self.pages) * page_size + (
            self.partial[1] if self.partial else 0)

    def trim(self, page_size: int, n_tokens: int) -> "PrefixMatch":
        """The same match cut to its first ``n_tokens`` tokens (the
        scheduler cuts it when the tail bucket cannot sit after the whole
        match).  A whole page cut mid-page becomes the partial
        copy-on-write source."""
        have = self.matched_tokens(page_size)
        n = max(0, min(int(n_tokens), have))
        n_full = n // page_size
        rem = n - n_full * page_size
        chain = list(self.pages) + (
            [self.partial[0]] if self.partial else [])
        out = PrefixMatch(pages=chain[:n_full])
        if rem:
            out.partial = (chain[n_full], rem)
        return out


class PrefixCache:
    """The radix index and its eviction over one ``PageAllocator``."""

    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self.root = _Node((), None, 0, None)
        self._clock = 0
        self.n_pages = 0                # pages the index holds

    # -- lookup ----------------------------------------------------------------
    def _tick(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    def match(self, prompt) -> PrefixMatch:
        """The longest cached prefix of ``prompt`` (:class:`PrefixMatch`).
        Takes no allocator reference: the scheduler shares the pages it
        adopts at once, before anything can evict them."""
        ps = self.page_size
        limit = len(prompt) - 1          # one token at least prefills
        out = PrefixMatch()
        node, i = self.root, 0
        while True:
            remaining = limit - i
            if remaining >= ps:
                child = node.children.get(tuple(prompt[i:i + ps]))
                if child is not None and child.fill == ps:
                    out.pages.append(child.page)
                    self._tick(child)
                    node, i = child, i + ps
                    continue
            # no whole-page step: the child sharing the longest run of
            # leading tokens (fewer than a page) is a copy-on-write source
            best, best_r = None, 0
            want = tuple(prompt[i:i + min(remaining, ps)])
            for child in node.children.values():
                r = 0
                for a, b in zip(child.tokens, want):
                    if a != b:
                        break
                    r += 1
                if r > best_r:
                    best, best_r = child, r
            if best is not None and best_r > 0:
                out.partial = (best.page, best_r)
                self._tick(best)
            return out

    # -- insertion -------------------------------------------------------------
    def insert(self, prompt, page_ids) -> int:
        """Index ``prompt``'s pages: ``page_ids[j]`` holds the K/V of
        tokens ``[j * ps, (j + 1) * ps)`` (the last page may be partial).
        A chain already indexed is LRU-bumped, not referenced again: that
        dedup keeps one physical page a distinct block.  Each newly
        indexed page takes one allocator reference (``share``).  Returns
        how many did."""
        ps = self.page_size
        node, i, taken = self.root, 0, 0
        plen = len(prompt)
        for page in page_ids:
            fill = min(ps, plen - i)
            if fill <= 0:
                break
            toks = tuple(prompt[i:i + fill])
            if fill == ps:
                child = node.children.get(toks)
                if child is not None and child.fill == ps:
                    self._tick(child)
                    node, i = child, i + ps
                    continue
            elif any(c.fill >= fill and c.tokens[:fill] == toks
                     for c in node.children.values()):
                break                    # a sibling already covers them
            child = _Node(toks, int(page), fill, node)
            self.allocator.share([int(page)])
            node.children[toks] = child
            self._tick(child)
            self.n_pages += 1
            taken += 1
            if fill < ps:
                break                    # a partial page ends the chain
            node, i = child, i + ps
        return taken

    # -- eviction --------------------------------------------------------------
    def _evictable(self, node: _Node) -> bool:
        return (not node.children
                and self.allocator.refcount(node.page) == 1)

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` cached pages, least recently matched
        leaves first (a node whose subtree has gone becomes a leaf, so a
        cold chain unwinds from its tip to the root).  Pages a slot still
        reads (refcount > 1) are pinned and skipped.  Returns the pages
        freed."""
        freed = 0
        while freed < n_pages:
            victim = None
            stack = [self.root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node is self.root or not self._evictable(node):
                    continue
                if victim is None or node.stamp < victim.stamp:
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.tokens]
            self.allocator.free([victim.page])
            self.n_pages -= 1
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every reference the index holds (pages that live slots
        share stay alive through the slots' own).  Returns the pages whose
        last reference this was."""
        freed = 0
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            before = self.allocator.free_pages
            self.allocator.free([node.page])
            freed += self.allocator.free_pages - before
        self.root.children.clear()
        self.n_pages = 0
        return freed
