"""Self-speculative drafting: deterministic prompt-lookup (n-gram) proposal
(the port's copy of ``repro.serve.spec``, which it may not import).

The drafter is a PURE FUNCTION of the request's token history — no second
model, no state, no randomness — as a traffic workload is a pure function
of its ``TrafficConfig``. That purity is what makes speculation compose
with recompute-resume for free: a preempted request resumes with its
history, and the drafter re-derives bit-for-bit the same proposals it
would have made uninterrupted.

Prompt lookup (PLD-style): take the longest recent suffix of the history
(between ``min_match`` and ``max_match`` tokens), find its most recent
earlier occurrence, and propose the tokens that followed it. On
repetitive text — code, templated prose, a greedy decode that has fallen
into a cycle — the continuation usually repeats too, and the batched
verify step accepts the whole window; on non-repetitive text the drafter
proposes nothing (or its proposals are rejected) and decoding degrades to
exactly the sequential path.

Acceptance is decided by the verify dispatch, not here: the scheduler
keeps the longest prefix where draft == model output (argmax in greedy
mode; the per-request position-folded sample otherwise), which is
provably bitwise-identical to step-by-step decode — a draft token is only
ever kept when it IS the token sequential decode would have produced.
"""

from __future__ import annotations

__all__ = ["draft_tokens"]


def draft_tokens(history, k: int, *, min_match: int = 2,
                 max_match: int = 8) -> list[int]:
    """Propose up to ``k`` continuation tokens for ``history`` by n-gram
    lookup.

    Scans suffix lengths from ``min(max_match, len-1)`` down to
    ``min_match``; for the first suffix with an earlier occurrence,
    returns (a copy of) the up-to-``k`` tokens that followed its MOST
    RECENT earlier occurrence. Ties on suffix length break toward the
    longer match, then the later occurrence — both deterministic — so
    the proposal is a pure function of ``history`` alone. Returns ``[]``
    when the history is too short or nothing matches."""
    if k <= 0:
        return []
    hist = [int(t) for t in history]
    n = len(hist)
    for m in range(min(int(max_match), n - 1), max(int(min_match), 1) - 1, -1):
        suffix = hist[n - m:]
        # most recent earlier occurrence; i == n - m is the suffix itself
        for i in range(n - m - 1, -1, -1):
            if hist[i:i + m] == suffix:
                cont = hist[i + m : i + m + k]
                if cont:
                    return cont
                break  # suffix ends flush against itself: shorter m next
    return []
