"""GPU-topology-aware scheduler extender: the twin of the JAX package's
``extender/server.py`` over the ``nvidia.com/gpu-topology`` annotation the
port's node daemon publishes.

The reference publishes its node topology for an external scheduler and
leaves the registration a TODO (server.go:298-300, main.go:20); this module
is that half: a kube-scheduler extender webhook that filters and
prioritizes nodes for ``nvidia.com/gpu`` pods.

Protocol (k8s.io/kube-scheduler/extender/v1, JSON over HTTP):

  POST /filter      ExtenderArgs{Pod, Nodes|NodeNames} -> ExtenderFilterResult
  POST /prioritize  ExtenderArgs{Pod, Nodes|NodeNames} -> HostPriorityList

The GPU gang model: a GPU pod asks for at most one node's cards, and a job
over several nodes is a gang of per-node pods. A GPU node has no
multi-host slice (the daemon does not publish the fabric between nodes), so
a request larger than a node's card count walks the JAX multi-host chain
with its slice steps gone: every node answers ``not_chip_multiple``,
``host_not_whole_free`` or ``no_slice_peers``, and scores 0.

The score simulates the node daemon's own placement on each candidate's
published availability: ``GpuPlacementState.select`` picks the best-scoring
set (the reference's average pair score), the base is that score scaled to
8 (0 for one card, which has no pair), and a node the request fills
exactly gets a packing bonus of 2, keeping whole nodes free for bigger
jobs.
"""

from __future__ import annotations

import collections
import heapq
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional, Tuple

from ..api import constants
from ..topology import placement
from ..topology.links import SCORE_MAX
from ..topology.placement import GpuPlacementState
from ..topology.schema import NodeTopology, parse_topology_cached
from ..utils import metrics, profiling, statestore, tracing
from ..utils.decisions import LEDGER
from ..utils.flightrecorder import RECORDER
from ..utils.httpserver import BackgroundHTTPServer
from ..utils.logging import get_logger
from ..utils.podresources import gpu_request
from ..utils.resilience import Backoff
from .gang import pod_gang
from .index import INDEX_SNAPSHOT_VERSION, IndexEntry, TopologyIndex, annotation_hash, shielded
from .reservations import DEFAULT_TABLE, ReservationTable

log = get_logger(__name__)

MAX_SCORE = 10

NO_TOPOLOGY_MSG = f"no GPU topology published ({constants.TOPOLOGY_ANNOTATION})"
ZERO_CARDS_MSG = "node reports 0 GPUs"


def ledger_pod_keys(pod: Optional[dict]) -> Tuple[str, str]:
    """(pod key, gang key) for decision-ledger records, both
    ``namespace/name``; the gang is "" for a pod without gang labels."""
    meta = (pod or {}).get("metadata") or {}
    podkey = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
    info = pod_gang(pod or {})
    gang = f"{info[0]}/{info[1]}" if info else ""
    return podkey, gang


def _capacity_reason(avail: int, local: int, held: int) -> Optional[Tuple[str, str]]:
    """The single-node capacity verdict shared by ``_reject_reason`` and the
    vectorized /filter, so their messages stay byte-identical."""
    if avail >= local:
        return None
    note = f" ({held} reserved for a released gang)" if held else ""
    return ("insufficient_chips", f"{avail} chips available, {local} needed{note}")


class TopologyExtender:
    """The filtering and scoring logic (the HTTP wrapper is below)."""

    def __init__(
        self,
        resource_name: str = constants.RESOURCE_NAME,
        reservations: Optional[ReservationTable] = None,
        node_cache: Optional["NodeAnnotationCache"] = None,
    ):
        self.resource_name = resource_name
        # Supplies annotations for name-only (nodeCacheCapable) requests.
        self.node_cache = node_cache
        # Shared with gang admission in this process: cards a released gang
        # reserved are invisible to every other pod's filter and score until
        # that gang schedules.
        self.reservations = DEFAULT_TABLE if reservations is None else reservations
        # Single-node score memo. A node's score is a pure function of
        # (annotation string, requested cards, cards withheld by
        # reservations).
        self._score_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._score_cache_max = 16384
        self._score_lock = threading.Lock()

    def _shield(self, parsed, pod: dict) -> Dict[str, int]:
        """Subtract other gangs' reservations from each parsed candidate's
        availability, in place (the NodeTopology objects are this request's
        clones). A pod is never blocked by its own gang's hold. Returns
        hostname -> cards withheld."""
        info = pod_gang(pod)
        own = (info[0], info[1]) if info else None
        return self.reservations.apply([t for _, t in parsed if t is not None], exclude=own)

    # -- tracing -----------------------------------------------------------
    #
    # With tracing on, /filter joins the pod's carried trace or opens a fresh
    # one, and /prioritize joins whatever /filter opened through RECENT, so
    # both RPCs of one scheduling cycle land in one trace. Off: one bool
    # check.

    def _span_for(self, name: str, pod: dict, candidates: int):
        key = tracing.pod_key(pod)
        parent = tracing.extract(pod) or tracing.RECENT.recall(key)
        return (tracing.span(name, parent=parent, service="extender", pod=key,
                             candidates=candidates), key)

    # -- node topology parsing ---------------------------------------------

    def _parsed(self, node: dict) -> Tuple[Optional[str], Optional[NodeTopology]]:
        """(raw annotation, parsed topology): the raw string is the key of
        the score memo."""
        ann = (node.get("metadata") or {}).get("annotations") or {}
        raw = ann.get(constants.TOPOLOGY_ANNOTATION)
        if not raw:
            return None, None
        try:
            return raw, parse_topology_cached(raw)
        except ValueError as e:
            log.warning("bad topology annotation on %s: %s",
                        (node.get("metadata") or {}).get("name"), e)
            return raw, None

    def _topology_of(self, node: dict) -> Optional[NodeTopology]:
        return self._parsed(node)[1]

    def materialize(self, node_names: List[str]) -> List[dict]:
        """Node names (nodeCacheCapable mode) -> minimal node dicts through
        the annotation cache; a name the cache cannot resolve becomes a bare
        node that /filter fails with the no-topology reason."""
        if self.node_cache is None:
            raise RuntimeError(
                "received node names but no node cache is configured: "
                "run with --node-cache (API access) or set "
                "nodeCacheCapable: false in the scheduler policy"
            )
        return [self.node_cache.node_object(name) or {"metadata": {"name": name}}
                for name in node_names]

    # -- filter ------------------------------------------------------------

    def filter(self, pod: dict, nodes: List[dict]) -> Tuple[List[dict], Dict[str, str]]:
        if not tracing.enabled():
            return self._filter_impl(pod, nodes)
        cm, key = self._span_for("extender.filter", pod, len(nodes))
        with cm as sp:
            passing, failed = self._filter_impl(pod, nodes)
            sp.set(passing=len(passing), failed=len(failed))
            tracing.RECENT.remember(key, sp.context)
            return passing, failed

    def _filter_impl(self, pod: dict, nodes: List[dict]) -> Tuple[List[dict], Dict[str, str]]:
        """(passing nodes, failed {name: reason})."""
        n = gpu_request(pod, self.resource_name)
        if n <= 0:
            return nodes, {}
        parsed = [(node, self._topology_of(node)) for node in nodes]
        withheld = self._shield(parsed, pod)
        led = LEDGER.enabled  # one read per RPC, not per node
        rejects: List[Tuple[str, str, str]] = []
        passing, failed = [], {}
        for node, topo in parsed:
            name = (node.get("metadata") or {}).get("name", "")
            if topo is None:
                failed[name] = NO_TOPOLOGY_MSG
                if led:
                    rejects.append((name, "no_topology", NO_TOPOLOGY_MSG))
                continue
            rej = self._reject_reason(n, topo, len(topo.available),
                                      withheld.get(topo.hostname, 0))
            if rej is not None:
                failed[name] = rej[1]
                if led:
                    rejects.append((name, rej[0], rej[1]))
                continue
            passing.append(node)
        if led:
            self._ledger_filter(pod, n, len(passing), rejects, "object")
        return passing, failed

    def _multi_host_reason(self, n: int, topo: NodeTopology) -> Tuple[str, str]:
        """(token, message) for a request larger than the node's card count.
        The JAX chain without its slice steps: a GPU node has no multi-host
        slice, so a node that passes the first two checks has no peers. The
        tokens are the decision ledger's bounded labels."""
        if n % topo.chip_count != 0:
            return ("not_chip_multiple",
                    f"multi-node request of {n} not a multiple of node size {topo.chip_count}")
        if len(topo.available) < topo.chip_count:
            return ("host_not_whole_free", "a request over several nodes needs the full node free")
        return ("no_slice_peers",
                "node has no multi-node NVLink domain; a job over several nodes "
                "is a gang of per-node pods")

    def _reject_reason(self, n: int, topo: NodeTopology, avail: int,
                       held: int) -> Optional[Tuple[str, str]]:
        """(reason token, message) when a topology-publishing node cannot
        serve an n-card request, else None: the one reason builder of the
        object and the indexed name-only paths. ``avail`` is the node's
        reservation-shielded free count, ``held`` the cards reservations
        withheld."""
        local = min(n, topo.chip_count)
        if local <= 0:
            return ("zero_chips", ZERO_CARDS_MSG)
        if n > topo.chip_count:
            code, reason = self._multi_host_reason(n, topo)
            note = f" ({held} reserved for a released gang)" if held else ""
            return (code, reason + note)
        return _capacity_reason(avail, local, held)

    # -- decision-ledger recording -----------------------------------------
    #
    # Gated on LEDGER.enabled (one read per RPC): each rejected candidate is
    # one ``filter_reject`` record (capped per RPC), plus a per-RPC
    # ``filter`` summary; each /prioritize records its top five with the
    # winner's score terms.

    _MAX_REJECT_RECORDS = 64

    def _ledger_filter(self, pod: dict, n: int, passing: int,
                       rejects: List[Tuple[str, str, str]], path: str) -> None:
        podkey, gang = ledger_pod_keys(pod)
        for name, code, msg in rejects[: self._MAX_REJECT_RECORDS]:
            LEDGER.record("filter_reject", code, msg, pod=podkey, gang=gang, node=name,
                          chips=n, path=path)
        truncated = max(0, len(rejects) - self._MAX_REJECT_RECORDS)
        extra = {"rejects_truncated": truncated} if truncated else {}
        LEDGER.record(
            "filter",
            "ok" if passing else "all_rejected",
            f"{passing}/{passing + len(rejects)} candidates passed for a {n}-chip request",
            pod=podkey, gang=gang, chips=n, path=path, **extra,
        )

    def _ledger_prioritize(self, pod: dict, n: int, out: List[dict], terms_for,
                           path: str) -> None:
        """``terms_for(host)`` resolves the winner's score terms lazily: only
        the top node pays the recompute, and only with the ledger on."""
        podkey, gang = ledger_pod_keys(pod)
        top = heapq.nlargest(5, out, key=lambda h: h["score"])
        attrs = {
            "candidates": len(out),
            "path": path,
            "top": " ".join(f"{h['host']}={h['score']}" for h in top),
        }
        if top and n > 0:
            terms = terms_for(top[0]["host"])
            if terms:
                attrs["best"] = top[0]["host"]
                for k, v in terms.items():
                    attrs[f"best_{k}"] = v
        LEDGER.record("prioritize", "scored",
                      f"scored {len(out)} candidates for a {n}-chip request",
                      pod=podkey, gang=gang, **attrs)

    # -- prioritize --------------------------------------------------------

    def score_node(self, n: int, topo: NodeTopology) -> int:
        return self.score_terms(n, topo)["score"]

    def score_terms(self, n: int, topo: NodeTopology) -> dict:
        """The score and its terms, which the decision ledger's prioritize
        records carry: ``term_set_score`` (the chosen set's average pair
        score), ``term_nvlink_pairs`` (its NVLink-joined pairs),
        ``term_base`` and ``term_packing``. Runs on score-memo misses and
        ledger lookups only."""
        if n > topo.chip_count > 0:
            # No multi-node NVLink domain: a request over several nodes
            # scores 0 everywhere.
            return {"score": 0, "term_gang": 0}
        local = min(n, topo.chip_count)
        if local <= 0 or len(topo.available) < local:
            return {"score": 0}
        topology = topo.to_topology()
        state = GpuPlacementState(topology)
        state.reset(allocated=set(topology.ids) - set(topo.available))
        sel = state.select(local)
        if len(sel) < local:
            return {"score": 0}
        set_score = topology.set_score(sel) if local >= 2 else 0.0
        base = round((MAX_SCORE - 2) * set_score / SCORE_MAX) if local >= 2 else 0
        packing_bonus = 2 if len(topo.available) == local else 0
        return {
            "score": min(base + packing_bonus, MAX_SCORE),
            "term_set_score": round(set_score, 3),
            "term_nvlink_pairs": topology.internal_links(sel),
            "term_base": base,
            "term_packing": packing_bonus,
        }

    def _memo_score(self, key: tuple, n: int, topo_of) -> int:
        """The score memo keyed on (annotation string, n, cards withheld);
        ``topo_of()`` gives the (shielded) topology on a miss."""
        with self._score_lock:
            score = self._score_cache.get(key)
            if score is not None:
                self._score_cache.move_to_end(key)
                return score
        score = self.score_node(n, topo_of())
        with self._score_lock:
            self._score_cache[key] = score
            while len(self._score_cache) > self._score_cache_max:
                self._score_cache.popitem(last=False)
        return score

    def prioritize(self, pod: dict, nodes: List[dict]) -> List[dict]:
        if not tracing.enabled():
            return self._prioritize_impl(pod, nodes)
        cm, key = self._span_for("extender.prioritize", pod, len(nodes))
        with cm as sp:
            out = self._prioritize_impl(pod, nodes)
            tracing.RECENT.remember(key, sp.context)
            return out

    def _prioritize_impl(self, pod: dict, nodes: List[dict]) -> List[dict]:
        n = gpu_request(pod, self.resource_name)
        parsed3 = ([(node, *self._parsed(node)) for node in nodes] if n > 0
                   else [(node, None, None) for node in nodes])
        # Score on shielded availability too (reservations).
        withheld = self._shield([(node, topo) for node, _, topo in parsed3], pod)
        out = []
        for node, raw, topo in parsed3:
            name = (node.get("metadata") or {}).get("name", "")
            if n <= 0 or topo is None:
                out.append({"host": name, "score": 0})
                continue
            if n > topo.chip_count > 0:
                score = self.score_node(n, topo)
            else:
                score = self._memo_score((raw, n, withheld.get(topo.hostname, 0)), n,
                                         lambda t=topo: t)
            out.append({"host": name, "score": score})
        if LEDGER.enabled:
            by_name = {(node.get("metadata") or {}).get("name", ""): topo
                       for node, _, topo in parsed3}

            def terms_for(host: str):
                topo = by_name.get(host)
                return self.score_terms(n, topo) if topo else None

            self._ledger_prioritize(pod, n, out, terms_for, "object")
        return out

    # -- indexed name-only path --------------------------------------------
    #
    # With ``nodeCacheCapable: true`` the scheduler sends node names; these
    # paths answer from the node cache's topology index: a dict get and
    # integer arithmetic per candidate, no JSON parse, no placement for an
    # infeasible node. Both return None when the index cannot serve (no
    # cache, or no relist has succeeded); the caller then falls back to
    # materialize() and the object path.

    def _index_entries(self, names: List[str]) -> Optional[List[Tuple[str, Optional[IndexEntry]]]]:
        cache = self.node_cache
        if cache is None or not cache.synced:
            return None
        idx = cache.index
        out = []
        parsed_on_demand = 0
        for name in names:
            e = idx.get(name)
            if e is None and not idx.known(name):
                # A node the last relist never saw (it just joined): one
                # cache fetch, which also installs its index entry.
                cache.node_object(name)
                e = idx.get(name)
            if e is not None and e.deferred:
                # A snapshot-restored entry racing the warm pool: this RPC
                # needs its topology now.
                e = idx.ensure_parsed(name)
                parsed_on_demand += 1
            out.append((name, e))
        served = len(names) - parsed_on_demand
        if served > 0:
            # Only candidates answered from the index count as avoided.
            metrics.PARSE_AVOIDED.inc(served, reason="indexed_rpc")
        return out

    def _held_for(self, pod: dict) -> Dict[str, int]:
        """host -> cards other gangs' reservations withhold from this pod:
        the count form of _shield, with no topology mutated."""
        info = pod_gang(pod)
        own = (info[0], info[1]) if info else None
        return self.reservations.held_by_host(exclude=own)

    def filter_names(self, pod: dict, names: List[str]) -> Optional[Tuple[List[str], Dict[str, str]]]:
        if not tracing.enabled():
            return self._filter_names_impl(pod, names)
        cm, key = self._span_for("extender.filter", pod, len(names))
        with cm as sp:
            out = self._filter_names_impl(pod, names)
            if out is not None:
                sp.set(passing=len(out[0]), failed=len(out[1]), path="indexed")
            tracing.RECENT.remember(key, sp.context)
            return out

    def _filter_names_fast(self, pod: dict, names: List[str]) -> Optional[Tuple[List[str], Dict[str, str]]]:
        """Vectorized /filter over the index's column plane: every
        candidate's capacity verdict in one numpy pass. Serves only the
        common shape, a request no larger than each candidate's card count
        over known, non-deferred candidates, and returns None for anything
        else; the per-entry path below owns the rare shapes. Its messages
        come from the same ``_capacity_reason``."""
        np = placement.numpy_or_none()
        cache = self.node_cache
        if np is None or cache is None or not cache.synced or not names:
            return None
        plane = cache.index.column_plane()
        if plane is None or not plane.rows:
            return None
        n = gpu_request(pod, self.resource_name)
        if n <= 0:
            return list(names), {}
        rows = plane.rows
        no_topo = plane.no_topo
        idxs: List[int] = []
        for nm in names:
            r = rows.get(nm)
            if r is None:
                if nm in no_topo:
                    r = -1  # a known annotation-less node
                else:
                    return None  # unknown or deferred: the per-entry path
            idxs.append(r)
        ri = np.asarray(idxs, dtype=np.int32)
        known = ri >= 0
        rc = np.maximum(ri, 0)
        chips = np.where(known, plane.chip_count[rc], 0)
        if bool(((chips > 0) & (chips < n)).any()):
            return None  # a request over several nodes: the per-entry path
        has_topo = plane.has_topo[rc] & known
        avail = np.where(known, plane.avail[rc], 0)
        held = self._held_for(pod)
        if held:
            gsh = np.zeros(plane.size, dtype=np.int32)
            for host, c in held.items():
                row = plane.host_row.get(host)
                if row is not None:
                    gsh[row] = c
            shield = np.where(known, gsh[rc], 0)
            avail = np.maximum(avail - shield, 0)
        else:
            shield = None
        local = np.minimum(n, chips)
        ok = has_topo & (local > 0) & (avail >= local)
        led = LEDGER.enabled
        passing: List[str] = []
        failed: Dict[str, str] = {}
        rejects: List[Tuple[str, str, str]] = []
        if bool(ok.all()):
            passing = list(names)
        else:
            okl, htl, chipl, availl = ok.tolist(), has_topo.tolist(), chips.tolist(), avail.tolist()
            heldl = shield.tolist() if shield is not None else None
            for i, nm in enumerate(names):
                if okl[i]:
                    passing.append(nm)
                    continue
                if not htl[i]:
                    code, msg = "no_topology", NO_TOPOLOGY_MSG
                elif min(n, chipl[i]) <= 0:
                    code, msg = "zero_chips", ZERO_CARDS_MSG
                else:
                    code, msg = _capacity_reason(availl[i], min(n, chipl[i]),
                                                 heldl[i] if heldl is not None else 0)
                failed[nm] = msg
                if led:
                    rejects.append((nm, code, msg))
        if led:
            self._ledger_filter(pod, n, len(passing), rejects, "indexed")
        metrics.PARSE_AVOIDED.inc(len(names), reason="indexed_rpc")
        return passing, failed

    def _filter_names_impl(self, pod: dict, names: List[str]) -> Optional[Tuple[List[str], Dict[str, str]]]:
        """Indexed /filter: (passing names, failed) or None when the index
        cannot serve. The column plane answers the common shape; this
        per-entry loop is the fallback and the parity reference."""
        fast = self._filter_names_fast(pod, names)
        if fast is not None:
            return fast
        entries = self._index_entries(names)
        if entries is None:
            return None
        n = gpu_request(pod, self.resource_name)
        if n <= 0:
            return list(names), {}
        held = self._held_for(pod)
        led = LEDGER.enabled
        rejects: List[Tuple[str, str, str]] = []
        passing: List[str] = []
        failed: Dict[str, str] = {}
        for name, e in entries:
            if e is None or e.topo is None:
                failed[name] = NO_TOPOLOGY_MSG
                if led:
                    rejects.append((name, "no_topology", NO_TOPOLOGY_MSG))
                continue
            h = held.get(e.hostname, 0)
            # Only the multi-node check reads the topology beyond the card
            # count, so the shield clone stays on that rare path.
            topo = shielded(e.topo, h) if h and n > e.chip_count else e.topo
            rej = self._reject_reason(n, topo, max(0, e.avail - h), h)
            if rej is not None:
                failed[name] = rej[1]
                if led:
                    rejects.append((name, rej[0], rej[1]))
                continue
            passing.append(name)
        if led:
            self._ledger_filter(pod, n, len(passing), rejects, "indexed")
        return passing, failed

    def prioritize_names(self, pod: dict, names: List[str]) -> Optional[List[dict]]:
        if not tracing.enabled():
            return self._prioritize_names_impl(pod, names)
        cm, key = self._span_for("extender.prioritize", pod, len(names))
        with cm as sp:
            out = self._prioritize_names_impl(pod, names)
            if out is not None:
                sp.set(path="indexed")
            tracing.RECENT.remember(key, sp.context)
            return out

    def _prioritize_names_impl(self, pod: dict, names: List[str]) -> Optional[List[dict]]:
        """Indexed /prioritize: the HostPriorityList, or None when the index
        cannot serve. Single-node scores ride the object path's memo; an
        infeasible candidate scores 0 without a placement."""
        entries = self._index_entries(names)
        if entries is None:
            return None
        n = gpu_request(pod, self.resource_name)
        if n <= 0:
            return [{"host": name, "score": 0} for name in names]
        held = self._held_for(pod)
        out = []
        for name, e in entries:
            if e is None or e.topo is None:
                out.append({"host": name, "score": 0})
                continue
            h = held.get(e.hostname, 0)
            if n > e.chip_count > 0:
                score = self.score_node(n, shielded(e.topo, h) if h else e.topo)
            elif max(0, e.avail - h) < min(n, e.chip_count):
                score = 0  # infeasible: never reaches a placement
            else:
                score = self._memo_score((e.raw, n, h), n,
                                         lambda t=e.topo, h=h: shielded(t, h) if h else t)
            out.append({"host": name, "score": score})
        if LEDGER.enabled:
            by_name = dict(entries)

            def terms_for(host: str):
                e = by_name.get(host)
                if e is None or e.topo is None:
                    return None
                h = held.get(e.hostname, 0)
                return self.score_terms(n, shielded(e.topo, h) if h else e.topo)

            self._ledger_prioritize(pod, n, out, terms_for, "indexed")
        return out


def _get_ci(d: dict, key: str):
    """Case-tolerant key get: the kube-scheduler marshals ExtenderArgs with
    lowercase JSON tags, hand-written clients often send Go field casing.
    Accept both."""
    if key in d:
        return d[key]
    for k, v in d.items():
        if k.lower() == key.lower():
            return v
    return None


class NodeAnnotationCache:
    """Node name -> topology annotation, for ``nodeCacheCapable: true``.

    With ``nodeCacheCapable: false`` the kube-scheduler serializes full node
    objects into every /filter and /prioritize call. With it true the
    scheduler sends names, and this cache supplies the annotations from a
    relist plus (``watch=True``) a node watch, with a single-node fetch for
    a name the last relist has not seen.

    The cache owns the incremental ``TopologyIndex``: every observation
    (relist diff, watch event, fetch) is applied to it keyed by the node's
    annotation string, so an unchanged annotation costs nothing. With the
    watch on, the relist becomes a level-triggered backstop
    (``watch_backstop_s``).

    With ``snapshot_dir`` set the cache persists the index's derived state
    (``<dir>/index.snapshot.json``, the statestore snapshot envelope, each
    node keyed by its annotation hash) after relists and on stop, and loads
    it before the first relist: a node whose annotation hash is unchanged
    installs without a parse (deferred to the warm pool or first demand).
    ``event_coalesce_s`` > 0 batches watch events through an applier tick,
    the latest event per node winning."""

    def __init__(
        self,
        client,
        interval_s: float = 5.0,
        watch: bool = False,
        watch_backstop_s: float = 300.0,
        snapshot_dir: str = "",
        warm_workers: int = 2,
        event_coalesce_s: float = 0.0,
    ):
        self.client = client
        self.interval_s = interval_s
        self.watch = watch
        self.watch_backstop_s = max(watch_backstop_s, interval_s)
        # "" = persistence off. The file is the one the JAX StateStore
        # compacts to, so either plane reads the other's.
        self._snapshot_path = (os.path.join(snapshot_dir, "index.snapshot.json")
                               if snapshot_dir else None)
        # Hash-keyed derived records from the snapshot, consumed (then
        # dropped) by the first successful relist.
        self._snap_pending: Optional[Dict[str, dict]] = None
        self._snap_written_gen = -1
        self.warm_workers = max(0, int(warm_workers))
        self._warm_threads: List[threading.Thread] = []
        self.event_coalesce_s = max(0.0, float(event_coalesce_s))
        self._pending_events: "collections.OrderedDict[str, tuple]" = collections.OrderedDict()
        self._event_lock = threading.Lock()
        self._event_wake = threading.Event()
        self._applier_thread: Optional[threading.Thread] = None
        self._warm_t0 = 0.0
        # name -> annotation string, or None for a relisted node without
        # one: the negative entries spare a mixed cluster a fetch per RPC.
        self._raw: Dict[str, Optional[str]] = {}
        self.index = TopologyIndex()
        self._resource_version = ""
        # Set once a relist has succeeded. Until then an unknown name reads
        # as no-topology without a fetch: a 1,000-name request against a
        # down API server must not fan out into 1,000 blocking GETs.
        self._synced = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._hb = None
        # Optional utils/resilience.DegradedMode, attached by the entry
        # point: every successful sync marks it fresh.
        self.degraded = None

    @property
    def synced(self) -> bool:
        return self._synced

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "NodeAnnotationCache":
        # The snapshot before the first relist, which consumes it.
        self.load_snapshot()
        try:
            self.refresh()
        except Exception as e:  # noqa: BLE001 - an API server blip at start
            # must not crash-loop the extender; the relist loop recovers.
            metrics.NODE_CACHE_RELIST_ERRORS.inc()
            log.warning("initial node-cache relist failed: %s", e)
        self.start_warm()
        self._thread = threading.Thread(
            target=profiling.supervised("node_cache_relist", self._loop),
            name="node-annotation-cache", daemon=True)
        self._thread.start()
        if self.watch and self.event_coalesce_s > 0:
            self._applier_thread = threading.Thread(
                target=profiling.supervised("node_event_applier", self._applier_loop),
                name="node-event-applier", daemon=True)
            self._applier_thread.start()
        return self

    def stop(self) -> None:
        # The freshest snapshot for the successor.
        self.write_snapshot()
        self._stop.set()
        self._event_wake.set()
        if self.watch:
            # Unblock a thread sitting in the watch stream's read.
            interrupt = getattr(self.client, "interrupt_watches", None)
            if interrupt is not None:
                try:
                    interrupt()
                except Exception:  # noqa: BLE001 - best-effort unblock
                    pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._applier_thread is not None:
            self._applier_thread.join(timeout=5)
            self._applier_thread = None
        for t in self._warm_threads:
            t.join(timeout=5)
        self._warm_threads = []

    # -- cold-start snapshot -----------------------------------------------

    def load_snapshot(self) -> int:
        """Read the persisted snapshot into the pending map the first relist
        validates against. Returns how many node records were loaded (0: no
        usable snapshot, missing, corrupt or of another version, each of
        which degrades to the full parse)."""
        path = self._snapshot_path
        if path is None:
            return 0
        try:
            # A leftover tmp file is a write that died before its rename:
            # the real snapshot, if any, is the authoritative one.
            if os.path.exists(path + ".tmp"):
                os.remove(path + ".tmp")
            doc, _seq, status = statestore.read_snapshot_file(path)
        except Exception as e:  # noqa: BLE001 - a broken store never blocks startup
            metrics.INDEX_SNAPSHOT_LOADS.inc(outcome="error")
            log.warning("index snapshot load failed: %s", e)
            return 0
        if doc is None:
            metrics.INDEX_SNAPSHOT_LOADS.inc(
                outcome="empty" if status in (statestore.EMPTY, statestore.CLEAN) else "corrupt")
            return 0
        if doc.get("v") != INDEX_SNAPSHOT_VERSION:
            metrics.INDEX_SNAPSHOT_LOADS.inc(outcome="version_mismatch")
            log.info("index snapshot is schema v%s (want v%s); ignoring it",
                     doc.get("v"), INDEX_SNAPSHOT_VERSION)
            return 0
        nodes = doc.get("nodes") or {}
        self._snap_pending = {str(name): rec for name, rec in nodes.items()
                              if isinstance(rec, dict) and rec.get("h")}
        # The disk matches what the restores will install: a pure-restore
        # first relist skips its rewrite.
        self._snap_written_gen = self.index.generation
        metrics.INDEX_SNAPSHOT_LOADS.inc(outcome="ok")
        return len(self._snap_pending)

    def write_snapshot(self) -> bool:
        """Persist the index's derived state (after a relist and on stop).
        Skipped when persistence is off, no relist has succeeded, or nothing
        changed since the last write. Never raises."""
        if self._snapshot_path is None or not self._synced:
            return False
        gen = self.index.generation
        if gen == self._snap_written_gen:
            return False
        try:
            statestore.write_snapshot_file(
                self._snapshot_path, statestore.snapshot_doc(self.index.snapshot_data()))
        except Exception as e:  # noqa: BLE001 - persistence is an optimization
            metrics.INDEX_SNAPSHOT_WRITES.inc(outcome="error")
            log.warning("index snapshot write failed: %s", e)
            return False
        self._snap_written_gen = gen
        metrics.INDEX_SNAPSHOT_WRITES.inc(outcome="ok")
        return True

    # -- warm pool ---------------------------------------------------------

    def start_warm(self) -> None:
        """Start the workers that parse deferred (snapshot-restored) entries
        in the background. Idempotent, and called again after every
        successful relist, so a snapshot restored by a later relist (the
        first one failed) still gets its pool. A no-op when nothing is
        deferred or workers are running."""
        if self.warm_workers <= 0:
            return
        self._warm_threads = [t for t in self._warm_threads if t.is_alive()]
        if self._warm_threads:
            return
        wp = self.index.warm_progress()
        if wp["parsed"] >= wp["total"]:
            return
        self._warm_t0 = time.monotonic()
        for i in range(self.warm_workers):
            loop_name = f"index_warm_{i}"
            t = threading.Thread(
                target=profiling.supervised(loop_name, lambda n=loop_name: self._warm_loop(n)),
                name=f"index-warm-{i}", daemon=True)
            t.start()
            self._warm_threads.append(t)

    def _warm_loop(self, loop_name: str = "index_warm") -> None:
        hb = profiling.HEARTBEATS.register(loop_name, interval_s=1.0)
        while not self._stop.is_set():
            hb.beat()
            name = self.index.claim_deferred()
            if name is None:
                break
            try:
                self.index.ensure_parsed(name)
            except Exception:  # noqa: BLE001 - one bad entry must not stop the pool
                log.exception("index warm failed for %s", name)
        metrics.INDEX_WARM_SECONDS.set(round(time.monotonic() - self._warm_t0, 6))

    # -- watch-event coalescing --------------------------------------------

    def offer_event(self, etype: str, node: dict) -> None:
        """Queue one watch event for the coalescing applier (the latest event
        per node wins); applied inline when coalescing is off or the applier
        is not running."""
        if self.event_coalesce_s <= 0 or self._applier_thread is None:
            self.apply_event(etype, node)
            return
        name = (node.get("metadata") or {}).get("name", "")
        if not name or etype == "BOOKMARK":
            return
        with self._event_lock:
            if name in self._pending_events:
                metrics.INDEX_EVENTS.inc(source="watch", kind="coalesced")
            self._pending_events[name] = (etype, node)
        self._event_wake.set()

    def flush_events(self) -> int:
        """Apply the latest buffered event per node. Returns how many nodes
        were applied."""
        with self._event_lock:
            batch = self._pending_events
            self._pending_events = collections.OrderedDict()
        for etype, node in batch.values():
            self.apply_event(etype, node)
        return len(batch)

    def _applier_loop(self) -> None:
        hb = profiling.HEARTBEATS.register("node_event_applier", interval_s=1.0)
        while not self._stop.is_set():
            # A bounded wait, so the heartbeat tells idle from wedged.
            woke = self._event_wake.wait(timeout=1.0)
            hb.beat()
            if self._stop.is_set():
                break
            if not woke:
                continue
            self._event_wake.clear()
            self._stop.wait(self.event_coalesce_s)  # let the burst gather
            self.flush_events()
        self.flush_events()

    def _loop(self) -> None:
        # An escalating relist delay while the API server is down (the
        # cache serves its last-known entries meanwhile).
        backoff = Backoff(base=self.interval_s, max_delay=max(60.0, self.interval_s))
        self._hb = profiling.HEARTBEATS.register(
            "node_cache_relist", interval_s=self.interval_s,
            max_silence_s=(self.watch_backstop_s + 180.0 if self.watch
                           else profiling.default_max_silence(self.interval_s)))
        wait = self.interval_s
        while not self._stop.wait(wait):
            self._hb.beat()
            try:
                self.refresh()
                backoff.reset()
                wait = self.interval_s
                self.start_warm()
                if self.watch:
                    # Consume watch events until the stream goes stale, errs
                    # or the backstop comes due; a healthy expiry relists at
                    # once, a broken watch waits the normal cadence first.
                    healthy = self._watch_until_stale()
                    wait = 0.0 if healthy else self.interval_s
            except Exception as e:  # noqa: BLE001 - keep serving stale
                metrics.NODE_CACHE_RELIST_ERRORS.inc()
                # Floored at the healthy cadence.
                wait = max(self.interval_s, backoff.next_delay())
                log.warning("node cache relist failed (next in %.1fs): %s", wait, e)

    def refresh(self) -> None:
        listing = self.client.list_nodes()
        items = listing.get("items", [])
        self._resource_version = (
            (listing.get("metadata") or {}).get("resourceVersion", "") or self._resource_version)
        fresh: Dict[str, Optional[str]] = {}
        for node in items:
            meta = node.get("metadata") or {}
            ann = meta.get("annotations") or {}
            fresh[meta.get("name", "")] = ann.get(constants.TOPOLOGY_ANNOTATION)
        with self._lock:
            removed = [n for n in self._raw if n not in fresh]
            self._raw = fresh
            raws = set(fresh.values())
            with_topo = sum(1 for r in fresh.values() if r)
            total = len(fresh)
            self._synced = True
        # Entries are keyed by the annotation string, so a steady relist
        # applies no-ops. On the first relist after a cold start a node
        # whose annotation hash matches its snapshot record is restored
        # (derived state installed, parse deferred).
        pending = self._snap_pending
        restored = stale = 0
        for name, raw in fresh.items():
            rec = pending.pop(name, None) if pending else None
            h = None
            if rec is not None and raw:
                h = annotation_hash(raw)
                if (self.index.get(name) is None and rec.get("h") == h
                        and self.index.restore(name, raw, rec, h=h)):
                    restored += 1
                    continue
            if rec is not None:
                stale += 1  # the annotation changed while the extender was down
            kind = self.index.update(name, raw, h=h)
            metrics.INDEX_EVENTS.inc(source="relist", kind=kind)
        for name in removed:
            metrics.INDEX_EVENTS.inc(source="relist", kind=self.index.remove(name))
        if pending is not None:
            if restored:
                metrics.INDEX_SNAPSHOT_ENTRIES.inc(restored, source="restored")
                metrics.INDEX_EVENTS.inc(restored, source="relist", kind="restore")
                metrics.PARSE_AVOIDED.inc(restored, reason="snapshot_restore")
            if stale:
                metrics.INDEX_SNAPSHOT_ENTRIES.inc(stale, source="stale")
            if pending:
                metrics.INDEX_SNAPSHOT_ENTRIES.inc(len(pending), source="vanished")
            self._snap_pending = None
            RECORDER.record(
                "index_snapshot",
                f"index snapshot reconciled against the first relist: {restored} restored, "
                f"{stale} re-parsed, {len(pending)} vanished",
                restored=restored, stale=stale, vanished=len(pending),
            )
        metrics.NODE_CACHE_NODES.set(with_topo, state="with_topology")
        metrics.NODE_CACHE_NODES.set(total - with_topo, state="without_topology")
        metrics.INDEX_SLICES.set(self.index.stats()["slices"])
        metrics.NODE_CACHE_SYNCED.set(1)
        if self.degraded is not None:
            self.degraded.mark_fresh()
        # Pre-warm the parse LRU for every current annotation on this
        # thread, so the object path's cold parse never lands on an RPC;
        # deferred (snapshot-restored) annotations are the warm pool's.
        deferred_raws = {e.raw for e in self.index.entries() if e.deferred}
        for raw in raws:
            if raw and raw not in deferred_raws:
                try:
                    parse_topology_cached(raw)
                except ValueError:
                    pass  # malformed stays the publisher's problem
        self.write_snapshot()

    # -- watch -------------------------------------------------------------

    def apply_event(self, etype: str, node: dict) -> str:
        """Apply one node watch event to the raw map and the index. Returns
        the index event kind; a MODIFIED event that left the annotation
        alone is a no-op."""
        meta = node.get("metadata") or {}
        name = meta.get("name", "")
        if not name or etype == "BOOKMARK":
            return "noop"
        if etype == "DELETED":
            with self._lock:
                self._raw.pop(name, None)
            kind = self.index.remove(name)
        else:  # ADDED / MODIFIED
            raw = (meta.get("annotations") or {}).get(constants.TOPOLOGY_ANNOTATION)
            with self._lock:
                self._raw[name] = raw
            kind = self.index.update(name, raw)
            if kind == "noop" and raw:
                metrics.PARSE_AVOIDED.inc(reason="unchanged_annotation")
        metrics.INDEX_EVENTS.inc(source="watch", kind=kind)
        return kind

    def _watch_until_stale(self) -> bool:
        """Stream node events into the index until the watch breaks or the
        relist backstop comes due. A dropped stream resumes from the
        bookmarked resourceVersion; only a 410 or three drops in a row that
        delivered nothing fall back to the caller's relist. Returns True
        when the exit was the healthy backstop expiry."""
        from ..kube.client import KubeError
        from ..utils.resilience import TRACKER

        deadline = time.monotonic() + self.watch_backstop_s
        rv = self._resource_version
        hb = self._hb
        barren_drops = 0
        while not self._stop.is_set() and time.monotonic() < deadline:
            if hb is not None:
                hb.beat()  # one beat per stream window
            window = min(60.0, max(1.0, deadline - time.monotonic()))
            progressed = False
            try:
                for etype, obj in self.client.watch_nodes(resource_version=rv,
                                                          timeout_seconds=int(window)):
                    if self._stop.is_set():
                        return False
                    rv = (obj.get("metadata") or {}).get("resourceVersion", "") or rv
                    progressed = True
                    barren_drops = 0
                    self.offer_event(etype, obj)
                    if self.degraded is not None and etype != "ERROR":
                        self.degraded.mark_fresh()
                    if time.monotonic() >= deadline:
                        break
            except KubeError as e:
                if e.status_code == 410:
                    TRACKER.record_watch("relist")
                    metrics.EXT_KUBE_WATCH_STREAMS.inc(outcome="relist")
                    log.debug("node watch 410, relisting: %s", e)
                    self._resource_version = rv
                    return False
                log.debug("node watch window errored: %s", e)
                return False
            except Exception as e:  # noqa: BLE001 - drops, resets, truncation
                if not progressed:
                    barren_drops += 1
                    if barren_drops >= 3:
                        log.debug("node watch dropped %d times without progress, "
                                  "relisting: %s", barren_drops, e)
                        return False
                TRACKER.record_watch("resumed")
                metrics.EXT_KUBE_WATCH_STREAMS.inc(outcome="resumed")
                log.debug("node watch dropped, resuming from rv=%s: %s", rv, e)
                if self._stop.wait(0.05 * max(1, barren_drops)):
                    return False
                continue
        self._resource_version = rv
        return True

    # -- lookup ------------------------------------------------------------

    def node_object(self, name: str) -> Optional[dict]:
        """A minimal node dict carrying the cached annotation, or None when
        the node publishes no topology. Only a name the last successful
        relist never saw costs an API fetch."""
        with self._lock:
            known = name in self._raw
            raw = self._raw.get(name)
            synced = self._synced
        if not known and synced:
            raw = self._fetch(name)
        if raw is None:
            return None
        return {"metadata": {"name": name,
                             "annotations": {constants.TOPOLOGY_ANNOTATION: raw}}}

    def _fetch(self, name: str) -> Optional[str]:
        try:
            node = self.client.get_node(name)
            raw = ((node.get("metadata") or {}).get("annotations") or {}).get(
                constants.TOPOLOGY_ANNOTATION)
        except Exception:  # noqa: BLE001 - absent or unreachable: no topology,
            # cached until the next relist.
            raw = None
        with self._lock:
            self._raw[name] = raw
        metrics.INDEX_EVENTS.inc(source="fetch", kind=self.index.update(name, raw))
        return raw


class ReadyStatus:
    """The startup phase behind /readyz and /debug/readyz: ``replaying``
    (the admission journal's replay, once admission is wired), ``warming``
    and ``ready``, with the index's warm progress (``parsed/total``), so a
    stuck warm is told from a slow one."""

    def __init__(self, ready_event: threading.Event, journal_configured: bool = False,
                 warm_progress=None, degraded=None):
        self._ready = ready_event
        self._replay_done = not journal_configured
        # () -> {"parsed": int, "total": int}, or None without a cache.
        self.warm_progress = warm_progress
        # Optional DegradedMode: its state and staleness ride the body.
        self.degraded = degraded
        self._t0 = time.monotonic()
        self.time_to_ready_s: Optional[float] = None

    def mark_replayed(self) -> None:
        self._replay_done = True

    def mark_ready(self) -> None:
        if self.time_to_ready_s is None:
            self.time_to_ready_s = round(time.monotonic() - self._t0, 3)
            metrics.TIME_TO_READY.set(self.time_to_ready_s)
        self._ready.set()

    def phase(self) -> str:
        if self._ready.is_set():
            return "ready"
        return "replaying" if not self._replay_done else "warming"

    def snapshot(self) -> dict:
        """The /readyz (and /debug/readyz) JSON body."""
        phase = self.phase()
        out: dict = {"ok": phase == "ready", "phase": phase}
        for key, provider in (("warm", self.warm_progress),
                              ("resilience", self.degraded.snapshot if self.degraded else None)):
            if provider is not None:
                try:
                    out[key] = provider()
                except Exception:  # noqa: BLE001 - advisory: never breaks the probe
                    pass
        if self.time_to_ready_s is not None:
            out["time_to_ready_s"] = self.time_to_ready_s
        if phase == "replaying":
            out["reason"] = "admission state rehydrating"
        elif phase == "warming":
            out["reason"] = "topology index warming"
        return out


_VERBS = ("filter", "prioritize", "preemption", "drain")


class ExtenderHTTPServer(BackgroundHTTPServer):
    """The HTTP wrapper speaking the scheduler-extender JSON protocol, with
    the protocol's lowercase JSON tags ('nodes', 'nodenames', 'failedNodes',
    'error'; HostPriority 'host'/'score').

    /preemption and /drain answer as the JAX server does when no preemption
    or rescue plane is wired (404); those planes come with later slices."""

    def __init__(self, extender: Optional[TopologyExtender] = None, host: str = "0.0.0.0",
                 port: int = 0, ready_check=None, ready_status=None, degraded=None):
        super().__init__(host, port)
        # Optional DegradedMode: while active, /filter and /prioritize serve
        # from the last-known-good index; past the staleness cap (paused)
        # they answer 503 and the scheduler retries.
        self.degraded = degraded
        self.extender = extender or TopologyExtender()
        # Readiness gate (() -> bool, None = always ready): /filter and
        # /prioritize answer 503 until it holds; /readyz serves the same
        # answer, /healthz stays pure liveness.
        self.ready_check = ready_check
        # Optional () -> dict (ReadyStatus.snapshot): the /readyz body.
        self.ready_status = ready_status

    def handler_class(self):
        ext = self.extender
        server = self

        def ready() -> bool:
            check = server.ready_check
            if check is None:
                return True
            try:
                return bool(check())
            except Exception:  # noqa: BLE001 - a broken check reads as not ready
                return False

        def count(verb: str, outcome: str) -> None:
            # A bounded verb label: an arbitrary POST path mints no labelset.
            metrics.EXTENDER_REQUESTS.inc(verb=verb if verb in _VERBS else "other",
                                          outcome=outcome)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _read_args(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length) or b"{}")

            def _send(self, obj, code=200):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _ready_payload(self) -> dict:
                status = server.ready_status
                if status is None:
                    return {}
                try:
                    return status()
                except Exception:  # noqa: BLE001 - advisory detail
                    return {}

            def do_POST(self):
                if not ready():
                    # 503, not an empty 200 (which would read as "no node
                    # fits" and fail the pod's cycle): the scheduler retries.
                    detail = self._ready_payload()
                    self._send({
                        "error": detail.get("reason", "admission state rehydrating"),
                        **{k: v for k, v in detail.items() if k in ("phase", "warm", "shard")},
                    }, 503)
                    count(self.path.strip("/"), "not_ready")
                    return
                dm = server.degraded
                if dm is not None and dm.paused:
                    self._send({
                        "error": ("degraded serving paused: last-known-good cluster state "
                                  f"is {dm.staleness_s():.0f}s old (cap "
                                  f"{dm.staleness_cap_s:.0f}s) — apiserver unreachable"),
                        "resilience": dm.snapshot(),
                    }, 503)
                    count(self.path.strip("/"), "degraded_paused")
                    return
                try:
                    args = self._read_args()
                except json.JSONDecodeError:
                    self._send({"error": "bad JSON"}, 400)
                    return
                pod = _get_ci(args, "pod") or {}
                nodes = _get_ci(args, "nodes") or {}
                items = _get_ci(nodes, "items") or []
                names = _get_ci(args, "nodenames")
                names_mode = bool(names) and not items
                verb = self.path.strip("/")
                t0 = time.perf_counter()
                try:
                    fast_filter = fast_scores = None
                    if names_mode:
                        # nodeCacheCapable: the index answers; when it
                        # cannot (no cache, never synced) materialize() and
                        # the object path degrade safely.
                        if self.path == "/filter":
                            fast_filter = ext.filter_names(pod, list(names))
                        elif self.path == "/prioritize":
                            fast_scores = ext.prioritize_names(pod, list(names))
                        if fast_filter is None and fast_scores is None:
                            items = ext.materialize(list(names))
                    if self.path == "/filter":
                        if fast_filter is not None:
                            passing_names, failed = fast_filter
                        else:
                            passing, failed = ext.filter(pod, items)
                            passing_names = [(n.get("metadata") or {}).get("name", "")
                                             for n in passing]
                        if names_mode:
                            self._send({"nodes": None, "nodenames": passing_names,
                                        "failedNodes": failed, "error": ""})
                        else:
                            self._send({"nodes": {"items": passing}, "nodenames": None,
                                        "failedNodes": failed, "error": ""})
                    elif self.path == "/prioritize":
                        self._send(fast_scores if fast_scores is not None
                                   else ext.prioritize(pod, items))
                    elif self.path == "/preemption":
                        self._send({"error": "preemption not enabled"}, 404)
                        return
                    elif self.path == "/drain":
                        self._send({"error": "drain not enabled"}, 404)
                        return
                    else:
                        self._send({"error": f"unknown path {self.path}"}, 404)
                        return
                    metrics.EXTENDER_REQUESTS.inc(verb=verb, outcome="ok")
                    dt = time.perf_counter() - t0
                    metrics.EXT_REQUEST_LATENCY.observe(dt, verb=verb)
                    profiling.CAPTURE.observe(verb, dt)
                except Exception as e:  # annotations are external input: one bad
                    # one costs an error payload, not the scheduler's call.
                    log.exception("extender %s failed", self.path)
                    self._send({"error": f"{type(e).__name__}: {e}"}, 500)
                    metrics.EXTENDER_REQUESTS.inc(verb=verb, outcome="error")

            def do_GET(self):
                if self.path == "/healthz":
                    self._send({"ok": True})
                elif self.path == "/readyz":
                    ok = ready()
                    payload = {"ok": ok}
                    detail = self._ready_payload()
                    if detail:
                        payload.update(detail)
                        payload["ok"] = ok
                    elif not ok:
                        payload["reason"] = "admission state rehydrating"
                    self._send(payload, 200 if ok else 503)
                elif self.path == "/reservations":
                    # "holder" is the admitter's lease identity, "" until
                    # the leader lease is wired (as with the JAX fence off).
                    self._send({"holder": "", "holds": ext.reservations.snapshot()})
                elif self.path == "/metrics":
                    data, ctype = metrics.render_scrape(metrics.EXTENDER_REGISTRY,
                                                        self.headers.get("Accept", ""))
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/debug" or self.path.startswith("/debug/"):
                    payload = metrics.debug_payload(self.path)
                    if payload is None:
                        self._send({"error": "not found"}, 404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                else:
                    self._send({"error": "not found"}, 404)

        return Handler
