"""Epoch windows for standing queries (the Wukong+S window layer).

Wukong+S (SOSP'17) evaluates continuous queries over a bounded suffix of the
stream; expired data is retired and its contribution to standing results is
retracted. Here windows are *epoch-counted*: every ingest commit is one epoch
(ingest.py stamps them), and a :class:`WindowSpec` selects which epochs are
live.

Semantics (one rule covers both classic shapes):

- the window *closes* at every epoch divisible by ``slide``; an arriving
  epoch ``e`` first retires everything no longer reachable from the current
  window: with ``c = ((e - 1) // slide) * slide`` the last close before
  ``e``, all epochs ``<= c - (size - slide)`` retire.
- ``slide=1`` (default) is a **sliding** window: the live set is always the
  last ``size`` epochs.
- ``slide == size`` is a **tumbling** window: the previous window's contents
  retire in whole-window bulk as soon as the next window opens, so a
  mid-window epoch is never evaluated against an already-reported window.

Retraction strategy: delta evaluation is monotone (append-only), so expiry
needs its own machinery. The window keeps the raw triples of each live
epoch plus a per-result :class:`SupportIndex`; on retirement the standing
query retracts *incrementally* (continuous.py ``_retire_incremental``):

1. **Overdelete candidates** — delta evaluation seeded from the RETIRED
   triples over the pre-retirement window store finds exactly the result
   rows with at least one derivation touching retired data; every other
   row keeps all its derivations and is untouched (the DRed overdelete
   step, scoped to windows).
2. **Support fast path** — rows whose support includes the static base
   (derived at registration from ``base_triples`` alone, which never
   retire) skip verification entirely; the per-epoch evidence counts
   bound the candidate set from below (an evidence-exhausted row is
   always a candidate).
3. **Re-derive** — the surviving candidates are re-verified by seeding
   the full BGP with their projected bindings over the rebuilt survivor
   store; rows with no remaining derivation emit retraction deltas.

Retraction work is therefore proportional to the rows actually touching
retired epochs, not to the full standing result (the old behavior — a
from-scratch re-run + diff per close — survives only as the fallback when
a retirement step fails).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SupportIndex:
    """Per-result support bookkeeping for one windowed standing query.

    ``base`` holds rows derivable from the static ``base_triples`` alone
    (recorded at registration; base triples never retire, so these rows
    never retract and skip re-verification). ``by_epoch`` records, per
    live epoch, the rows that epoch's delta evaluation derived — its
    memory is bounded by the window size. ``counts`` is the live evidence
    count per row (how many live-epoch deltas derived it, the "support"
    the retirement step consumes).
    """

    base: set = field(default_factory=set)
    by_epoch: dict = field(default_factory=dict)  # epoch -> set(rows)
    counts: dict = field(default_factory=dict)  # row -> live evidence

    def note_base(self, rows) -> None:
        self.base |= set(rows)

    def note_epoch(self, epoch: int, rows) -> None:
        rows = set(rows)
        self.by_epoch[int(epoch)] = rows
        for r in rows:
            self.counts[r] = self.counts.get(r, 0) + 1

    def retire(self, epochs) -> set:
        """Drop retired epochs' evidence; returns the rows whose live
        evidence is now exhausted (excluding base-supported rows) — a
        LOWER bound on the retraction candidates: a row with surviving
        evidence may still be dead (its surviving-epoch derivation can
        use retired triples), which is why the overdelete evaluation, not
        this set, drives candidate selection."""
        dead = set()
        for e in epochs:
            for r in self.by_epoch.pop(int(e), ()):
                c = self.counts.get(r, 0) - 1
                if c <= 0:
                    self.counts.pop(r, None)
                    if r not in self.base:
                        dead.add(r)
                else:
                    self.counts[r] = c
        return {r for r in dead if self.counts.get(r, 0) == 0}

    def support_of(self, row) -> int:
        """Live evidence count (+1 if base-supported) — telemetry."""
        return self.counts.get(row, 0) + (1 if row in self.base else 0)

    def reset(self) -> None:
        """Forget per-epoch evidence (full-refresh fallback); the base
        set stays — base triples never retire, so it can't go stale."""
        self.by_epoch.clear()
        self.counts.clear()


@dataclass(frozen=True)
class WindowSpec:
    """size: how many epochs stay live; slide: how often the window closes."""

    size: int
    slide: int = 1

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"window size must be >= 1, got {self.size}")
        if self.slide < 1 or self.slide > self.size:
            raise ValueError(
                f"window slide must be in [1, size], got {self.slide}")

    @classmethod
    def tumbling(cls, size: int) -> "WindowSpec":
        return cls(size=size, slide=size)


@dataclass
class EpochWindow:
    """Live-epoch bookkeeping for one windowed standing query."""

    spec: WindowSpec
    # (epoch, triples) in epoch order — raw batches kept for rebuilds
    live: list = field(default_factory=list)

    def add(self, epoch: int, triples: np.ndarray) -> list:
        """Admit one epoch; returns the list of (epoch, triples) entries
        retired by this advance (non-empty only on the first epoch after a
        close — once per ``slide``, the amortized rebuild cadence)."""
        self.live.append((int(epoch), triples))
        last_close = (epoch - 1) // self.spec.slide * self.spec.slide
        cutoff = last_close - (self.spec.size - self.spec.slide)
        retired = [ent for ent in self.live if ent[0] <= cutoff]
        if retired:
            self.live = [ent for ent in self.live if ent[0] > cutoff]
        return retired

    def live_epochs(self) -> list[int]:
        return [e for e, _ in self.live]

    def live_triples(self) -> np.ndarray:
        """All live triples as one [N,3] array (rebuild input)."""
        if not self.live:
            return np.empty((0, 3), dtype=np.int64)
        return np.concatenate([t for _, t in self.live])
