"""Incremental topology index: the scheduler extender's per-candidate view,
the twin of the JAX package's ``extender/index.py`` over the
``nvidia.com/gpu-topology`` annotation.

The index moves every O(nodes) piece of work off the RPC: it stores the
*parsed* ``NodeTopology`` of each node plus the derived numbers /filter
reads (card count, available count, the placeable sizes), and rebuilds an
entry only when its node's annotation string changes (a watch event or a
relist diff). A steady cluster costs no parse per RPC and no rebuild per
relist.

Consumers: ``TopologyExtender.filter_names``/``prioritize_names`` answer
name-only scheduler RPCs from entries alone (capacity-infeasible candidates
are rejected on integer counts before any placement runs), and the column
plane answers the common /filter shape in one numpy pass. Gang admission
takes its capacity view from ``topologies()`` and marks its waiting gangs
dirty through ``on_change``, called after an entry really changed.

A GPU node has no multi-host slice: every entry's ``slice_key`` is None and
``slice_members`` is empty; the fields stay so that the derived record and
the snapshot keep the JAX shape.

Entries are immutable once installed (replaced whole on change), and the
parsed ``NodeTopology`` inside is read-only by contract: a consumer that
needs to change ``available`` (a reservation shield) takes a clone through
``clone_topology`` or ``shielded``. Reads take no lock; mutations
serialize on one.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

from .. import telemetry
from ..topology import placement
from ..topology.placement import placeable_sizes
from ..topology.schema import NodeTopology, parse_topology_cached
from ..utils import metrics, profiling
from ..utils.logging import get_logger

log = get_logger(__name__)

SliceKey = Tuple[str, ...]

# Bump when the derived-entry shape changes: a persisted snapshot of another
# version is ignored whole (a full parse is always right, a stale derived
# record never is).
INDEX_SNAPSHOT_VERSION = 1


def annotation_hash(raw: str) -> str:
    """Content address of one annotation string: the key the persisted
    snapshot and the derived-entry memo use. A cryptographic digest, since a
    collision would install another node's derived state as this node's."""
    return hashlib.blake2b(raw.encode(), digest_size=16).hexdigest()


# Content-addressed derived-entry memo: annotation hash -> the derived
# numbers an IndexEntry carries beyond its parsed topology, shared process
# wide by rebuilds, watch events and snapshot restores, so a flip-flopping
# annotation never derives twice. Bounded LRU of plain dicts, treated as
# immutable.
_DERIVED_MEMO_MAX = 8192
_DERIVED_MEMO: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
_DERIVED_LOCK = threading.Lock()


def _derived_lookup(h: str) -> Optional[dict]:
    with _DERIVED_LOCK:
        rec = _DERIVED_MEMO.get(h)
        if rec is not None:
            _DERIVED_MEMO.move_to_end(h)
        return rec


def _derived_store(h: str, rec: dict) -> None:
    with _DERIVED_LOCK:
        _DERIVED_MEMO[h] = rec
        _DERIVED_MEMO.move_to_end(h)
        while len(_DERIVED_MEMO) > _DERIVED_MEMO_MAX:
            _DERIVED_MEMO.popitem(last=False)


def clear_derived_memo() -> None:
    """Flush the memo (cold-cost measurements; tests)."""
    with _DERIVED_LOCK:
        _DERIVED_MEMO.clear()


def clone_topology(t: NodeTopology) -> NodeTopology:
    """A clone with a private ``available`` list, sharing the cards and the
    memoized ``LinkTopology``: the shape a mutating consumer needs."""
    c = dataclasses.replace(t, available=list(t.available))
    c.__dict__["_topology"] = t.__dict__.get("_topology")
    return c


def shielded(t: NodeTopology, held: int) -> NodeTopology:
    """A clone with ``held`` cards truncated off its availability (the count
    semantics of ``ReservationTable.apply``) that leaves the shared index
    entry untouched."""
    c = dataclasses.replace(t, available=t.available[: max(0, len(t.available) - held)])
    c.__dict__["_topology"] = t.__dict__.get("_topology")
    return c


@dataclasses.dataclass(frozen=True)
class IndexEntry:
    """One node's parsed, pre-derived topology state."""

    name: str
    raw: str  # the annotation string: the invalidation key
    topo: Optional[NodeTopology]  # None: a malformed annotation
    avail: int = 0  # len(topo.available)
    chip_count: int = 0
    hostname: str = ""
    slice_key: Optional[SliceKey] = None  # always None: no multi-host slice
    # The request sizes ``select`` places now over the published
    # availability (topology/placement.placeable_sizes), the node's term of
    # the cluster aggregate tpu_extender_placeable_nodes.
    placeable: Tuple[int, ...] = ()
    # True for a snapshot-restored entry whose parse is deferred: the derived
    # fields are live (hash-validated against the node's annotation), ``topo``
    # is None until ensure_parsed materializes it on first demand or in the
    # warm pool. Integer-count consumers read a deferred entry as it is.
    deferred: bool = False

    def derived_record(self) -> dict:
        """The persistable, memoizable derived state (everything but the
        parsed topology), keyed outside by the annotation hash."""
        if self.topo is None and not self.deferred:
            return {"bad": True}
        return {
            "avail": self.avail,
            "chips": self.chip_count,
            "host": self.hostname,
            "slice": list(self.slice_key) if self.slice_key else None,
            "placeable": list(self.placeable),
        }


class ColumnPlane:
    """Columnar mirror of the index for the vectorized /filter
    (``TopologyExtender._filter_names_fast``): per-row int32/bool arrays
    scored in one numpy pass. Immutable once built, replaced whole, so reads
    take no lock. ``rows`` covers non-deferred entries only; a candidate
    outside it sends the RPC down the per-entry path. ``key`` is the
    invalidation stamp (the index's ``_mutations``)."""

    __slots__ = ("rows", "host_row", "avail", "chip_count", "has_topo", "no_topo",
                 "size", "key")

    def __init__(self, np, entries, no_topo: Set[str], key: tuple):
        names: List[str] = []
        avail: List[int] = []
        chips: List[int] = []
        topod: List[bool] = []
        self.host_row: Dict[str, int] = {}
        for name, e in entries:
            if e.hostname:
                self.host_row[e.hostname] = len(names)
            names.append(name)
            avail.append(e.avail)
            chips.append(e.chip_count)
            topod.append(e.topo is not None)
        self.rows: Dict[str, int] = {name: i for i, name in enumerate(names)}
        self.avail = np.asarray(avail, dtype=np.int32)
        self.chip_count = np.asarray(chips, dtype=np.int32)
        self.has_topo = np.asarray(topod, dtype=bool)
        self.no_topo = frozenset(no_topo)
        self.size = len(names)
        self.key = key


class TopologyIndex:
    """name -> IndexEntry, maintained incrementally per node."""

    def __init__(self, on_change: Optional[Callable[[str, Tuple[SliceKey, ...]], None]] = None,
                 track_placeable: bool = True):
        # Called after an entry really changed, with the node's name and
        # every slice key involved, old and new (always none on GPU nodes):
        # gang admission's dirty marking hangs off it.
        self.on_change = on_change
        # Nodes with a published annotation; values are immutable and
        # replaced whole, so .get() needs no lock.
        self._entries: Dict[str, IndexEntry] = {}
        # Nodes known to exist without an annotation: the negative entries
        # that spare a mixed cluster's plain nodes a fetch per RPC.
        self._no_topo: Set[str] = set()
        # Contended acquires (a watch rebuild racing an RPC's on-demand
        # materialization) land in tpu_lock_wait_seconds{lock=
        # "topology_index"}.
        self._lock = profiling.TimedLock("topology_index", metrics.EXT_LOCK_WAIT)
        # Cluster capacity aggregate: size -> nodes whose entry places that
        # size, kept incrementally as entries change. ``track_placeable=False``
        # keeps none of it: the scale bench's control arm
        # (scale_bench.telemetry_overhead).
        self.track_placeable = track_placeable
        self._placeable_counts: Dict[int, int] = {}
        # Installed entries whose parse is deferred: the warm pool's queue.
        self._deferred: Set[str] = set()
        # Bumped by restore/update/remove that changed what a snapshot would
        # hold; the snapshot writer skips a write when it has not moved.
        self.generation = 0
        # The column plane, rebuilt lazily when ``_mutations`` (bumped on
        # every entry or negative-entry change) has moved.
        self._plane: Optional[ColumnPlane] = None
        self._mutations = 0
        # /debug/telemetry's cluster panel reads the latest-constructed
        # index of this process (one per extender).
        telemetry.CLUSTER_PROVIDER = self.placeable_snapshot

    # -- capacity aggregate ------------------------------------------------

    def _placeable_for(self, topo: NodeTopology) -> Tuple[int, ...]:
        if not self.track_placeable:
            return ()
        try:
            return placeable_sizes(topo.to_topology(), topo.available)
        except Exception:  # noqa: BLE001 - an odd annotation costs its own term only
            log.exception("placeable-size derivation failed")
            return ()

    def _adjust_placeable_locked(self, old: Optional[IndexEntry],
                                 new: Optional[IndexEntry]) -> Set[int]:
        changed: Set[int] = set()
        for n in old.placeable if old is not None else ():
            self._placeable_counts[n] = self._placeable_counts.get(n, 0) - 1
            changed.add(n)
        for n in new.placeable if new is not None else ():
            self._placeable_counts[n] = self._placeable_counts.get(n, 0) + 1
            changed.add(n)
        return changed

    def _publish_placeable_locked(self, sizes: Set[int]) -> None:
        """The count read, the zero-count pop and the gauge write are one
        step under the lock, so a concurrent update cannot drop a size that
        is placeable."""
        for n in sizes:
            count = self._placeable_counts.get(n, 0)
            if count > 0:
                metrics.EXT_PLACEABLE_NODES.set(count, size=str(n))
            else:
                self._placeable_counts.pop(n, None)
                metrics.EXT_PLACEABLE_NODES.remove(size=str(n))

    def placeable_snapshot(self) -> dict:
        """size -> nodes that place that size now (the /debug/telemetry
        cluster panel)."""
        with self._lock:
            return {
                "placeable_nodes": {str(n): c for n, c in sorted(self._placeable_counts.items())
                                    if c > 0},
                "nodes_with_topology": len(self._entries),
            }

    # -- mutation ----------------------------------------------------------

    def update(self, name: str, raw: Optional[str], h: Optional[str] = None) -> str:
        """Install or refresh one node, keyed by its annotation string.

        Returns "noop" (the string is unchanged: no work), "add", "update" or
        "clear" (the annotation was removed). A malformed annotation installs
        a topology-less entry, negative-cached like a missing one and still
        keyed. ``h`` is a precomputed ``annotation_hash(raw)``."""
        old = self._entries.get(name)
        if raw is None:
            with self._lock:
                prev = self._entries.pop(name, None)
                if prev is None and name in self._no_topo:
                    return "noop"
                self._no_topo.add(name)
                self._deferred.discard(name)
                self._mutations += 1
                if prev is not None:
                    # Negative nodes are not persisted: only an entry's
                    # departure changes what the snapshot would hold.
                    self.generation += 1
                self._publish_placeable_locked(self._adjust_placeable_locked(prev, None))
            if prev is None:
                return "add"
            self._changed(name, prev, None)
            return "clear"
        if old is not None and old.raw == raw:
            return "noop"
        entry = self._build_entry(name, raw, h=h)
        with self._lock:
            # Re-read under the lock: relist, watch and RPC-path fetch
            # threads all land here.
            prev = self._entries.get(name)
            self._no_topo.discard(name)
            self._entries[name] = entry
            self._deferred.discard(name)
            self.generation += 1
            self._mutations += 1
            self._publish_placeable_locked(self._adjust_placeable_locked(prev, entry))
        metrics.INDEX_REBUILDS.inc()
        self._changed(name, prev, entry)
        return "add" if prev is None else "update"

    def _build_entry(self, name: str, raw: str, h: Optional[str] = None) -> IndexEntry:
        """Parse and derive one entry. The derived half rides the
        content-addressed memo, the parse the schema's string-keyed LRU."""
        h = h or annotation_hash(raw)
        rec = _derived_lookup(h)
        if rec is not None and rec.get("bad"):
            # A known-malformed string: skip even the parse attempt.
            metrics.PARSE_AVOIDED.inc(reason="derived_memo")
            return IndexEntry(name=name, raw=raw, topo=None)
        try:
            topo: Optional[NodeTopology] = parse_topology_cached(raw)
        except ValueError as e:
            log.warning("bad topology annotation on %s: %s", name, e)
            topo = None
        if topo is None:
            _derived_store(h, {"bad": True})
            return IndexEntry(name=name, raw=raw, topo=None)
        if rec is not None and (not self.track_placeable or "placeable" in rec):
            metrics.PARSE_AVOIDED.inc(reason="derived_memo")
            return self._entry_from_record(name, raw, topo, rec)
        entry = IndexEntry(
            name=name,
            raw=raw,
            topo=topo,
            avail=len(topo.available),
            chip_count=topo.chip_count,
            hostname=topo.hostname,
            placeable=self._placeable_for(topo),
        )
        if self.track_placeable:
            # Only a tracking index publishes to the shared memo: a record
            # without the placeable term, trusted by a tracking index of the
            # same process, would poison its aggregate.
            _derived_store(h, entry.derived_record())
        return entry

    def _entry_from_record(self, name: str, raw: str, topo: Optional[NodeTopology],
                           rec: dict, deferred: bool = False) -> IndexEntry:
        return IndexEntry(
            name=name,
            raw=raw,
            topo=topo,
            avail=int(rec.get("avail", 0)),
            chip_count=int(rec.get("chips", 0)),
            hostname=str(rec.get("host", "")),
            slice_key=tuple(rec["slice"]) if rec.get("slice") else None,
            placeable=(tuple(int(n) for n in rec.get("placeable", ()))
                       if self.track_placeable else ()),
            deferred=deferred,
        )

    def remove(self, name: str) -> str:
        """Forget a deleted node. Returns "delete" or "noop"."""
        with self._lock:
            prev = self._entries.pop(name, None)
            was_known = prev is not None or name in self._no_topo
            self._no_topo.discard(name)
            self._deferred.discard(name)
            self._mutations += 1
            if prev is not None:
                self.generation += 1
            self._publish_placeable_locked(self._adjust_placeable_locked(prev, None))
        if prev is not None:
            self._changed(name, prev, None)
        return "delete" if was_known else "noop"

    def _changed(self, name: str, old: Optional[IndexEntry], new: Optional[IndexEntry]) -> None:
        if self.on_change is None:
            return
        keys = tuple({k for k in (old.slice_key if old else None,
                                  new.slice_key if new else None) if k is not None})
        try:
            self.on_change(name, keys)
        except Exception:  # noqa: BLE001 - a consumer's bug must not poison
            # the index's upkeep (the full sweep still runs)
            log.exception("topology index on_change hook failed")

    # -- snapshot restore and deferred materialization ---------------------

    def restore(self, name: str, raw: str, rec: dict, h: Optional[str] = None) -> bool:
        """Install one snapshot-restored entry without parsing. The caller
        has checked that ``annotation_hash(raw)`` equals the hash ``rec`` was
        persisted under (and passes it as ``h``). Returns False when a live
        entry already exists (a live observation wins over the snapshot)."""
        if rec.get("bad"):
            entry = IndexEntry(name=name, raw=raw, topo=None)
        else:
            entry = self._entry_from_record(name, raw, None, rec, deferred=True)
        with self._lock:
            if name in self._entries:
                return False
            self._no_topo.discard(name)
            self._entries[name] = entry
            self._mutations += 1
            if entry.deferred:
                self._deferred.add(name)
            # No generation bump: a restore installs what the snapshot
            # already holds, so a pure-restore start skips its rewrite.
            self._publish_placeable_locked(self._adjust_placeable_locked(None, entry))
        if self.track_placeable or rec.get("bad"):
            _derived_store(h or annotation_hash(raw), dict(rec))
        return True

    def ensure_parsed(self, name: str) -> Optional[IndexEntry]:
        """Materialize a deferred entry's topology (idempotent, from any
        thread). Returns the current entry. The derived fields are kept from
        the restored entry: they were hash-validated."""
        e = self._entries.get(name)
        if e is None or not e.deferred:
            return e
        try:
            topo: Optional[NodeTopology] = parse_topology_cached(e.raw)
        except ValueError as err:
            log.warning("snapshot-restored annotation on %s no longer parses (%s); "
                        "degrading to a no-topology entry", name, err)
            topo = None
        if topo is None:
            new = IndexEntry(name=name, raw=e.raw, topo=None)
        else:
            new = dataclasses.replace(e, topo=topo, deferred=False)
        with self._lock:
            cur = self._entries.get(name)
            if cur is not e:
                return cur  # a concurrent update or remove is newer truth
            self._entries[name] = new
            self._deferred.discard(name)
            self._mutations += 1
            if new.placeable != e.placeable:
                self._publish_placeable_locked(self._adjust_placeable_locked(e, new))
        if topo is None:
            # The derived state did change: the snapshot must be rewritten,
            # and the change surfaces like a rebuild.
            with self._lock:
                self.generation += 1
            self._changed(name, e, new)
        return new

    def claim_deferred(self) -> Optional[str]:
        """Pop one deferred node name for a warm worker (None: the warm is
        complete)."""
        with self._lock:
            try:
                return self._deferred.pop()
            except KeyError:
                return None

    def warm_progress(self) -> Dict[str, int]:
        """{"parsed", "total"} over installed entries: the /readyz warm
        progress."""
        with self._lock:
            total = len(self._entries)
            pending = sum(1 for e in self._entries.values() if e.deferred)
        return {"parsed": total - pending, "total": total}

    def warm_remaining(self) -> int:
        """Materialize every deferred entry on this thread; returns how many."""
        n = 0
        while True:
            name = self.claim_deferred()
            if name is None:
                return n
            self.ensure_parsed(name)
            n += 1

    def snapshot_data(self) -> dict:
        """The persistable index document: every installed entry's derived
        record, with its annotation hash. Negative nodes are not persisted."""
        nodes: Dict[str, dict] = {}
        for e in self.entries():
            rec = e.derived_record()
            rec["h"] = annotation_hash(e.raw)
            nodes[e.name] = rec
        return {"v": INDEX_SNAPSHOT_VERSION, "nodes": nodes}

    # -- queries -----------------------------------------------------------

    def column_plane(self) -> Optional[ColumnPlane]:
        """The current columnar mirror, rebuilt when stale. None when
        ``placement.force_scalar`` is on."""
        np = placement.numpy_or_none()
        if np is None:
            return None
        with self._lock:
            key = (self._mutations,)
            plane = self._plane
            if plane is not None and plane.key == key:
                return plane
            entries = [(name, e) for name, e in self._entries.items() if not e.deferred]
            plane = ColumnPlane(np, entries, self._no_topo, key)
            self._plane = plane
            return plane

    def get(self, name: str) -> Optional[IndexEntry]:
        return self._entries.get(name)

    def known(self, name: str) -> bool:
        """True when a relist, watch or fetch saw the node, with or without
        an annotation."""
        return name in self._entries or name in self._no_topo

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "with_topology": len(self._entries),
                "without_topology": len(self._no_topo),
                "slices": 0,
            }

    def slice_members(self, key: SliceKey) -> Set[str]:
        """Always empty: a GPU node belongs to no multi-host slice."""
        return set()

    def entries(self) -> List[IndexEntry]:
        """Every installed entry (immutable values: safe to walk without a
        lock)."""
        return list(self._entries.values())

    def topologies(self) -> List[NodeTopology]:
        """Per-call clones of every indexed topology: gang admission's
        capacity view. Deferred entries are materialized here."""
        out: List[NodeTopology] = []
        for e in list(self._entries.values()):
            if e.deferred:
                e = self.ensure_parsed(e.name) or e
            if e.topo is not None:
                out.append(clone_topology(e.topo))
        return out
