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
links are scored pair by pair.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import Iterable, List, Optional, Sequence, Set

import numpy as np

from .links import LinkTopology

# The most candidate sets the exhaustive search scores in one call: every
# n of a 16-card node fits (C(16, 8) = 12870).
EXHAUSTIVE_MAX = 20000


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
        topo = self.topology
        ids = must + rest
        score = np.array([[topo.score_pair(a, b) for b in ids] for a in ids], dtype=np.int64)
        links = np.array([[int(b in topo.neighbors(a)) for b in ids] for a in ids],
                         dtype=np.int64)
        combos = np.array(list(itertools.combinations(range(len(must), len(ids)),
                                                      n - len(must))), dtype=np.int64)
        sets = np.concatenate(
            [np.broadcast_to(np.arange(len(must)), (len(combos), len(must))), combos], axis=1)
        # Every set has n(n-1)/2 pairs, so the pair-score sum orders the
        # sets as the average does, in exact integers.
        i, j = np.triu_indices(n, 1)
        total = score[sets[:, i], sets[:, j]].sum(axis=1)
        nvlinks = links[sets[:, i], sets[:, j]].sum(axis=1)
        best = total == total.max()
        best &= nvlinks == nvlinks[best].max()
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
