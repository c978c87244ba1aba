"""Card placement: the counterpart of the JAX package's
``topology/placement.py`` (``PlacementState``) over ``LinkTopology``.

The bookkeeping (allocated, unhealthy, available, the RLock) is the JAX
``PlacementState``'s, copied unchanged. The policy is the reference's:
of every set of n cards the pool holds, the one with the best average
pair score (``LinkTopology.set_score``, the reference's getAverageScore
behind findBestDevice, topology.go:114-205), ties broken by more NVLink
pairs inside the set, then by the smaller sorted ids. A node holds at most
8 or 16 cards, so the search is exhaustive (C(16, 8) is 12870 sets, scored
at once with numpy); a pool with more sets than ``EXHAUSTIVE_MAX`` is
grown greedily by score instead, the analog of the JAX ``_grow``. One card
is picked corner-first, as in JAX: the card with the fewest available
NVLink neighbours, then the smallest id.

The TPU search over boxes of the ICI torus (``_best_box`` and its packed
bitmask kernel) has no counterpart: NVIDIA cards form no torus, and their
links are scored pair by pair. So the node's capacity view
(``capacity_stats``, the twin of the JAX ``fragmentation_stats``) has no
box volumes either: for each request size it asks ``select`` itself
whether the size fits and what average pair score it would reach, so a
gauge can never disagree with a placement.
"""

from __future__ import annotations

import functools
import itertools
import math
import threading
from typing import Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .links import LinkTopology

# The most candidate sets the exhaustive search scores in one call: every
# n of a 16-card node fits (C(16, 8) = 12870).
EXHAUSTIVE_MAX = 20000

# Set by force_scalar: consumers that batch over nodes with numpy (the
# scheduler extender's column plane) then take their per-node path.
_FORCE_SCALAR = False


def force_scalar(on: bool) -> None:
    """Force the per-node (scalar) paths process-wide, as the JAX
    ``force_scalar`` does: the parity oracles and an operator's rollback."""
    global _FORCE_SCALAR
    _FORCE_SCALAR = bool(on)


def numpy_or_none():
    """numpy, or None while ``force_scalar`` is on: the one gate of the
    consumers that batch over nodes (the extender's index column plane)."""
    return None if _FORCE_SCALAR else np


@functools.lru_cache(maxsize=64)
def _combinations(m: int, k: int) -> np.ndarray:
    """Every k-subset of range(m) as the rows of one array, in
    lexicographic order (read-only: it is shared between calls)."""
    out = np.array(list(itertools.combinations(range(m), k)), dtype=np.int64).reshape(-1, k)
    out.flags.writeable = False
    return out


class GpuPlacementState:
    """Allocation bookkeeping plus the best-score selection policy.

    Thread-safe: Allocate (gRPC thread), a free path and the health
    watcher all touch this state.
    """

    def __init__(self, topology: LinkTopology):
        self.topology = topology
        self._lock = threading.RLock()
        self._allocated: Set[str] = set()
        self._unhealthy: Set[str] = set()
        # The pair table as matrices over the topology's order, zero on the
        # diagonal, for the exhaustive search: the topology is read once
        # and never changes.
        ids = topology.ids
        self._pos = {i: k for k, i in enumerate(ids)}
        self._score = np.array([[topology.score_pair(a, b) if a != b else 0 for b in ids]
                                for a in ids], dtype=np.float64)
        self._linked = np.array([[float(b in topology.neighbors(a)) for b in ids]
                                 for a in ids], dtype=np.float64)

    # -- state (the JAX PlacementState's) ----------------------------------

    @property
    def allocated(self) -> Set[str]:
        with self._lock:
            return set(self._allocated)

    @property
    def unhealthy(self) -> Set[str]:
        with self._lock:
            return set(self._unhealthy)

    def available(self) -> List[str]:
        with self._lock:
            return [
                i
                for i in self.topology.ids
                if i not in self._allocated and i not in self._unhealthy
            ]

    def allocate(self, ids: Iterable[str]) -> None:
        """Mark cards allocated (UpdatePodDevice(adds, nil) analog)."""
        with self._lock:
            for i in ids:
                if i in self.topology.by_id:
                    self._allocated.add(i)

    def free(self, ids: Iterable[str]) -> None:
        """Mark cards free (UpdatePodDevice(nil, dels) analog). Unknown ids
        are ignored, matching the reference's tolerant free path
        (topology.go:270-285)."""
        with self._lock:
            for i in ids:
                self._allocated.discard(i)

    def set_health(self, chip_id: str, healthy: bool) -> bool:
        """Returns True if the health state changed."""
        with self._lock:
            if healthy:
                if chip_id in self._unhealthy:
                    self._unhealthy.discard(chip_id)
                    return True
                return False
            if chip_id not in self._unhealthy:
                self._unhealthy.add(chip_id)
                return True
            return False

    def reset(
        self,
        allocated: Optional[Iterable[str]] = None,
        unhealthy: Optional[Iterable[str]] = None,
    ) -> None:
        """Replace state wholesale (a checkpoint rebuild at startup)."""
        with self._lock:
            self._allocated = set(allocated or ())
            self._unhealthy = set(unhealthy or ())

    # -- policy ------------------------------------------------------------

    def select(
        self,
        n: int,
        available: Optional[Sequence[str]] = None,
        must_include: Sequence[str] = (),
    ) -> List[str]:
        """Choose n cards. ``available`` restricts the candidate pool (the
        kubelet passes one for GetPreferredAllocation); default is this
        state's own availability. Returns [] when n cards can't be found
        (the caller falls back to the kubelet's pick, as the reference
        does, server.go:191-193)."""
        with self._lock:
            pool = list(available) if available is not None else self.available()
            # The kubelet's pool reflects its view, which lags ours by one
            # ListAndWatch round trip: drop the cards this state holds as
            # unhealthy or allocated.
            pool = [
                p
                for p in pool
                if p in self.topology.by_id
                and p not in self._unhealthy
                and p not in self._allocated
            ]
            must = [m for m in must_include if m in self.topology.by_id]
            if not all(m in pool for m in must):
                pool = list(dict.fromkeys(list(pool) + must))
            if n <= 0 or len(pool) < n or len(must) > n:
                return []
            if n == 1:
                return [must[0]] if must else [self._select_one(pool)]
            return self._select_n(n, pool, must)

    def _select_one(self, pool: List[str]) -> str:
        pool_set = set(pool)
        # Fewest available NVLink neighbours first (corner-first); ties by
        # id for determinism.
        return min(
            pool,
            key=lambda c: (
                sum(1 for nb in self.topology.neighbors(c) if nb in pool_set),
                c,
            ),
        )

    def _select_n(self, n: int, pool: List[str], must: List[str]) -> List[str]:
        must = list(dict.fromkeys(must))
        rest = sorted(p for p in pool if p not in must)
        if len(must) == n:
            return sorted(must)
        if math.comb(len(rest), n - len(must)) <= EXHAUSTIVE_MAX:
            return self._best_set(n, must, rest)
        return self._grow(n, must, rest)

    def _best_set(self, n: int, must: List[str], rest: List[str]) -> List[str]:
        """The best-scoring n-set holding ``must``, over every one."""
        ids = must + rest
        idx = np.array([self._pos[i] for i in ids], dtype=np.int64)
        score = self._score[np.ix_(idx, idx)]
        links = self._linked[np.ix_(idx, idx)]
        combos = _combinations(len(rest), n - len(must)) + len(must)
        sets = np.concatenate(
            [np.broadcast_to(np.arange(len(must)), (len(combos), len(must))), combos], axis=1)
        # Every set has n(n-1)/2 pairs, so the pair-score sum orders the
        # sets as the average does. With x a set's 0/1 row, x·S·x counts
        # each pair twice, exactly: the sums are small integers.
        x = np.zeros((len(sets), len(ids)))
        np.put_along_axis(x, sets, 1.0, axis=1)
        total = np.einsum("ij,ij->i", x @ score, x)
        nvlinks = np.einsum("ij,ij->i", x @ links, x)
        best = total == total.max()
        best &= nvlinks == nvlinks[best].max()
        if not must:
            # ``rest`` is sorted and the rows come in lexicographic order,
            # so the first tied row holds the smallest sorted ids.
            return [ids[k] for k in sets[np.argmax(best)]]
        return min(sorted(ids[k] for k in row) for row in sets[best])

    def _grow(self, n: int, must: List[str], rest: List[str]) -> List[str]:
        """Greedy growth by score: seed with ``must`` (or the card scoring
        highest to the whole pool), then add the card that scores highest
        to the set so far, ties by NVLinks into the set, then by id."""
        topo = self.topology
        current = list(must)
        left = list(rest)
        if not current:
            seed = min(left, key=lambda c: (-sum(topo.score_pair(c, o) for o in left if o != c), c))
            current.append(seed)
            left.remove(seed)
        while len(current) < n:
            nxt = min(left, key=lambda c: (
                -sum(topo.score_pair(c, o) for o in current),
                -sum(1 for nb in topo.neighbors(c) if nb in current),
                c,
            ))
            current.append(nxt)
            left.remove(nxt)
        return sorted(current)


def capacity_stats(state: GpuPlacementState, free_ids: Iterable[str]) -> dict:
    """The node's capacity over its healthy-and-free cards ``free_ids``, by
    ``state``'s own search. Returns ``{"free", "placeable", "best_score"}``:
    ``placeable`` maps every request size from 1 to the node's card count
    to whether ``select`` places it now, and ``best_score`` each size from
    2 to ``free`` to the average pair score of the set ``select`` picks
    (a single card has no pair; a size past ``free`` has no set)."""
    free = [i for i in free_ids if i in state.topology.by_id]
    picks = {n: state.select(n, available=free) for n in range(1, len(free) + 1)}
    return {
        "free": len(free),
        "placeable": {n: bool(picks.get(n)) for n in range(1, len(state.topology.chips) + 1)},
        "best_score": {n: state.topology.set_score(ids)
                       for n, ids in picks.items() if n >= 2 and ids},
    }


def placeable_sizes(topology: LinkTopology, free_ids: Iterable[str]) -> Tuple[int, ...]:
    """The sorted request sizes ``select`` places now over the free cards
    ``free_ids``, for every size from 1 to the card count (``capacity_stats``'
    ``placeable``): the twin of the JAX ``placeable_sizes``, the per-node term
    the extender's topology index stores on every entry and persists in its
    snapshot. The one entry point, so no consumer derives the tuple another
    way."""
    stats = capacity_stats(GpuPlacementState(topology), free_ids)
    return tuple(n for n, ok in sorted(stats["placeable"].items()) if ok)
