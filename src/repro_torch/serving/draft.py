"""Draft sources for speculative decoding (port of
``repro.serving.draft``: pure host Python, a copy of its own).

Speculative decoding is the paper's runahead premise applied to the token
walk: a cheap draft source proposes the next ``draft_len - 1`` tokens,
one verify forward scores the whole run, and acceptance is the sign
check: the serial chain advances by however many drafts survive, plus
the one token the model was going to emit anyway.

A draft source runs on the host between scheduler steps (it sees token
ids only, never device state).  The default is n-gram self-drafting
("prompt lookup"): find the most recent earlier occurrence of the
trailing n-gram in the request's own history (prompt + emitted tokens)
and propose what followed it; without one it repeats the last token.
"""
from __future__ import annotations

from typing import Protocol, Sequence


class DraftSource(Protocol):
    """Callable proposing ``n`` draft tokens after ``history``.

    A source may declare ``device_capable = True``: its proposal is a pure
    function of the current token alone, the one piece of per-slot state
    a fused horizon carries on the card, so the scheduler can re-derive
    its drafts inside the horizon's graph.  Fused speculative serving
    (``step_horizon > 1`` with ``draft_len > 1``) needs such a source.
    """

    def __call__(self, history: Sequence[int], n: int) -> list[int]:
        """Return exactly ``n`` proposed next tokens (a wrong guess costs
        only a rejected verify row)."""
        ...


class RepeatLastDrafter:
    """Propose the current token ``n`` times, ``NGramDrafter``'s fallback
    as the whole policy.  It reads only the current token, so it is
    ``device_capable``: a fused horizon drafts it on the card as
    ``token[:, None]`` repeated, and per-step serving with this drafter is
    the reference fused speculative serving is held to."""

    device_capable = True

    def __call__(self, history: Sequence[int], n: int) -> list[int]:
        if n <= 0:
            return []
        last = history[-1] if len(history) else 0
        return [int(last)] * n


class NGramDrafter:
    """Suffix-match self-drafting over the request's own token history.

    Tries the longest trailing n-gram first (``max_ngram`` down to
    ``min_ngram``); on a hit, proposes the tokens that followed its most
    recent earlier occurrence.  A short continuation is extended by
    repeating its last token, so the proposal always has full length.
    """

    device_capable = False    # drafts read the whole host-side history

    def __init__(self, *, min_ngram: int = 1, max_ngram: int = 4):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})")
        self.min_ngram = min_ngram
        self.max_ngram = max_ngram

    def __call__(self, history: Sequence[int], n: int) -> list[int]:
        if n <= 0:
            return []
        h = list(history)
        if not h:
            return [0] * n
        out: list[int] | None = None
        for g in range(min(self.max_ngram, len(h) - 1), self.min_ngram - 1,
                       -1):
            tail = h[-g:]
            first = tail[0]
            # most recent earlier occurrence of the trailing g-gram (the
            # first-token test only skips slices that cannot match)
            for start in range(len(h) - g - 1, -1, -1):
                if h[start] == first and h[start:start + g] == tail:
                    out = h[start + g:start + g + n]
                    break
            if out:
                break
        if out is None:
            out = []
        while len(out) < n:                 # repeat-last fallback / pad
            out.append(out[-1] if out else h[-1])
        return out[:n]
