"""Draft proposers: where speculative tokens come from.

The serving driver asks a proposer for up to ``k`` draft tokens per
request per round; the engine's verify step then scores pending + drafts
in one forward pass and accepts the matching prefix. A proposer is pure
host-side policy — it never touches the device — so a bad guess costs
only the wasted verify slots, never correctness (acceptance is exact
match against the engine's own sampled targets).

``NgramProposer`` is the model-free prompt-lookup drafter (PLD /
"assisted generation without a draft model"): find the longest recent
n-gram suffix of the history elsewhere in the history and propose what
followed it there. Strong exactly where serving workloads repeat —
extractive answers over a long prompt, code editing, retry-heavy chat —
and free everywhere else.
"""

from typing import List, Protocol, Sequence, runtime_checkable


@runtime_checkable
class DraftProposer(Protocol):
    """Protocol for draft sources (n-gram lookup today; a small-model
    drafter later — anything that can turn a token history into guesses)."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` guesses for the tokens FOLLOWING ``history`` (which
        already includes the pending not-yet-verified token). May return
        fewer than ``k`` — including none — when it has no basis to guess."""
        ...


class NgramProposer:
    """Prompt-lookup drafting: match the last ``n``-gram of the history
    (``max_ngram`` down to ``min_ngram``) against earlier occurrences and
    propose the continuation of the MOST RECENT match. Longer n-grams are
    tried first — a longer matched context is a stronger prediction."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need max_ngram >= min_ngram >= 1, got "
                f"max_ngram={max_ngram} min_ngram={min_ngram}"
            )
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        hist = [int(t) for t in history]
        n_hist = len(hist)
        if k < 1 or n_hist < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_hist - 1), self.min_ngram - 1, -1):
            suffix = hist[n_hist - n:]
            # scan right-to-left: the most recent prior occurrence wins
            # (recency tracks the current generation mode best)
            for start in range(n_hist - n - 1, -1, -1):
                if hist[start:start + n] == suffix:
                    cont = hist[start + n : start + n + k]
                    if cont:
                        return cont
        return []
