"""Host-side page-table bookkeeping for the paged KV cache (a copy of
``repro.serving.paged``, which imports nothing of JAX but lives in the
JAX package, so the port keeps its own).

The device holds one flat page pool per attention run, leaves shaped
``(layers, n_pages, page_size, n_kv, head_dim)``, and an
``(n_slots, max_chain)`` page table of page ids.  Everything that DECIDES
which page holds what lives here, on the host, in plain Python:

  * ``PageAllocator``: free list, per-page refcounts and the prefix-hash
    registry that makes copy-on-write prefix sharing possible.  Pages are
    the unit of both allocation (admission takes ``ceil(needed /
    page_size)`` pages instead of a max-context row) and sharing (two
    requests whose token prefixes agree through a page boundary point
    their chains at the SAME page and bump its refcount).
  * ``plan_chain``: the admission-time geometry: how many positions a
    request can ever write (prompt + budget + speculative overshoot),
    whether its ring wraps (wrap => every page is mutable => nothing may
    be shared), how many leading pages are immutable and therefore
    shareable / registrable.

Page id 0 is the reserved NULL page: evicted and never-allocated chain
entries point at it, inactive slots scatter their dead per-step writes
into it, and its contents are only ever read through masked (exactly
zeroed) attention scores.  The allocator never hands it out.

The copy-on-write protocol (who may write which page) is enforced by
construction, not by runtime checks: a page is registered for sharing
only when no future write can touch it (fully inside the prompt of a
non-wrapping request), so a shared page is immutable for its whole
refcounted life.  ``fork`` (admitting a request onto an existing chain
prefix) is therefore a pure refcount bump; the "write" half of
copy-on-write happens when the divergent suffix lands in freshly
allocated private pages.
"""
from __future__ import annotations

import dataclasses


def pages_for(n_positions: int, page_size: int) -> int:
    """Pages needed to hold ``n_positions`` cache rows."""
    return -(-n_positions // page_size)


@dataclasses.dataclass(frozen=True)
class PagePlan:
    """Admission-time page geometry for one request."""

    n_positions: int     # 1 + the deepest position the request can write
    chain_len: int       # pages to map (<= max_chain)
    wrap: bool           # ring wraps => every page mutable, share nothing
    share_cap: int       # leading pages admission MAY reuse from the hash
    register_cap: int    # leading pages immutable enough to publish


def plan_chain(prompt_len: int, n_new: int, context: int, page_size: int,
               draft_len: int = 1) -> PagePlan:
    """Geometry of one request's page chain.

    Deepest written position: prefill writes ``[0, prompt_len)``; decode
    steps run while tokens are still owed, so the last step starts at
    position ``prompt_len + n_new - 2`` and (speculatively) writes up to
    ``draft_len - 1`` rows beyond it.  ``share_cap`` stops one page short
    of the prompt end even when the prompt is page-aligned: the suffix
    prefill must recompute at least the final prompt position, because
    the first sampled token needs its logits and pages cache K/V only.
    """
    if n_new > 1:
        n_positions = prompt_len + n_new + draft_len - 2
    else:
        n_positions = prompt_len
    wrap = n_positions > context
    if wrap:
        return PagePlan(context, pages_for(context, page_size), True, 0, 0)
    return PagePlan(
        n_positions=n_positions,
        chain_len=pages_for(n_positions, page_size),
        wrap=False,
        share_cap=(prompt_len - 1) // page_size,
        register_cap=prompt_len // page_size,
    )


def prefix_key(tokens, n_tokens: int) -> tuple:
    """Hash key for the page whose rows cover ``[0, n_tokens)``: K/V at
    position p depends (causally) on the whole token prefix through p,
    so the page's content is a pure function of ``tokens[:n_tokens]``."""
    return tuple(int(t) for t in tokens[:n_tokens])


class PageAllocator:
    """Free list + refcounts + prefix-hash registry over ``n_pages`` ids.

    Page 0 is reserved (the null page).  ``alloc`` hands out private pages
    at refcount 1; ``fork_prefix``/``incref`` add sharers; ``decref``
    returns a page to the free list when its last reference drops and
    retracts its hash registration so future lookups can never resurrect
    a recycled id.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(
                f"need >= 2 pages (1 reserved null page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO free list: recycled pages are re-used hot
        self._free: list[int] = list(range(n_pages - 1, 0, -1))
        self._refs: dict[int, int] = {}
        self._hash: dict[tuple, int] = {}       # prefix key -> page id
        self._keys_of: dict[int, set] = {}      # page id -> its keys
        self.peak_used = 0

    # -- introspection ------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        """Distinct pages currently live (null page excluded)."""
        return (self.n_pages - 1) - len(self._free)

    def refcount(self, pid: int) -> int:
        return self._refs.get(pid, 0)

    # -- allocation ---------------------------------------------------------

    def alloc(self) -> int | None:
        """One private page at refcount 1, or None when exhausted."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._refs[pid] = 1
        self.peak_used = max(self.peak_used, self.n_used)
        return pid

    def incref(self, pid: int) -> None:
        if self._refs.get(pid, 0) < 1:
            raise ValueError(f"incref of dead page {pid}")
        self._refs[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; True when this freed the page."""
        refs = self._refs.get(pid, 0)
        if refs < 1:
            raise ValueError(f"double free of page {pid}")
        if refs > 1:
            self._refs[pid] = refs - 1
            return False
        del self._refs[pid]
        for key in self._keys_of.pop(pid, ()):
            del self._hash[key]
        self._free.append(pid)
        return True

    def release(self, chain) -> None:
        """Decref every page of an evicted request's chain."""
        for pid in chain:
            self.decref(pid)

    # -- copy-on-write prefix sharing ---------------------------------------

    def register_prefix(self, key: tuple, pid: int) -> None:
        """Publish an immutable, fully-written page for sharing.  First
        writer wins: an identical prefix admitted concurrently keeps its
        private copy rather than re-pointing history."""
        if self._refs.get(pid, 0) < 1:
            raise ValueError(f"register of dead page {pid}")
        if key not in self._hash:
            self._hash[key] = pid
            self._keys_of.setdefault(pid, set()).add(key)

    def lookup_prefix(self, key: tuple) -> int | None:
        return self._hash.get(key)

    def fork_prefix(self, chain) -> list[int]:
        """COW fork: share every page of ``chain`` (refcount bump, no
        copy).  The caller owns the returned references and must
        ``release`` them on eviction.  Shared pages are immutable by the
        registration protocol, so the fork can never be mutated through
        either chain — the divergent tail goes into ``alloc``-ed private
        pages instead."""
        for pid in chain:
            self.incref(pid)
        return list(chain)
