"""Explain CLI: "why is my pod pending?" answered from the decision
ledger, joined with the traces.

It reads the two artifacts of the port's decision plane:

* the **decision ledger**: ``GET /debug/decisions`` on the daemon's metrics
  port or the extender's port (the ``utils/decisions.py`` snapshot), or
  files (``--decisions`` once per daemon merges the extender's and a node
  daemon's views);
* a **trace export**: ``GET /debug/traces`` (OTLP-JSON), rendered beneath
  the decision chain by ``tools/trace.py``'s tree renderer.

Its selectors:

* ``--pod X``: the whole decision chain of one allocation: the pod's own
  filter/prioritize records, its gang's admission records, and every
  record sharing a trace id with them (the plugin's Allocate substitution
  joins here once the controller adopts it), in time order.
* ``--gang Z``: the gang's admission history: waiting-state changes with
  their capacity shortfalls, the admission, the release.
* ``--node Y``: why the node was rejected: its filter_reject records
  grouped by reason.
* ``--evicted Z``: why the gang was preempted: its ``preempt_victim``
  records (evictor, rank, tier and the duty-cycle/checkpoint-age cost facts
  frozen at decision time) joined with the evictor's ``preemption`` rounds.
* ``--migrated Z``: why defragmentation moved the gang: its
  ``defrag_victim`` records (the stranded requestor it moved for, target
  host, the same cost facts) joined with the requestor's ``defrag`` rounds.
* ``--rescued Z``: what a hardware failure did to the gang, in both roles:
  its own ``rescue`` story (degraded, then executed or pending) and, where
  it was collateral, its ``rescue_victim`` records joined with the
  degraded requestor's ``rescue`` rounds.

The last three read the records the extender's preemption, defragmentation
and rescue planes write; the renderers are pure, and the self-test drives
them too.

    python -m k8s_device_plugin_tpu_torch.tools.explain --pod my-pod \\
        --url http://extender:12346
    python -m k8s_device_plugin_tpu_torch.tools.explain --gang my-gang \\
        --decisions decisions.json --traces traces.json
    python -m k8s_device_plugin_tpu_torch.tools.explain --self-test

``--self-test`` builds a capacity-starved allocation journey through the
port's ledger and span collector and renders it, so the snapshot and
export shapes and this renderer cannot drift apart unseen.

The verbs, flags, exit codes and output are the JAX package's
``tools/explain.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Set, Tuple

from .trace import _flatten_otlp, render_trace_tree


def _name_match(value: str, arg: str) -> bool:
    """Record keys are ``namespace/name``; operators rarely type the
    namespace — accept both."""
    return bool(value) and (value == arg or value.endswith("/" + arg))


def _ts(rec: dict) -> str:
    t = rec.get("ts", 0)
    return time.strftime("%H:%M:%S", time.localtime(t)) + (
        f".{int((t % 1) * 1000):03d}"
    )


def _subject(rec: dict) -> str:
    parts = []
    if rec.get("node"):
        parts.append(f"node {rec['node']}")
    if rec.get("pod"):
        parts.append(f"pod {rec['pod']}")
    if rec.get("gang"):
        parts.append(f"gang {rec['gang']}")
    return ", ".join(parts)


def _record_line(rec: dict) -> str:
    attrs = " ".join(
        f"{k}={v}" for k, v in sorted((rec.get("attrs") or {}).items())
    )
    trace = f" trace={rec['trace_id'][:16]}" if rec.get("trace_id") else ""
    subject = _subject(rec)
    return (
        f"  {_ts(rec)}  {rec.get('kind', '?'):<22} "
        f"[{rec.get('reason', '')}] {rec.get('message', '')}"
        + (f"  ({subject})" if subject else "")
        + (f"  [{attrs}]" if attrs else "")
        + trace
    )


def chain_for_pod(
    records: List[dict], pod: str
) -> Tuple[List[dict], Set[str]]:
    """The pod's decision chain: its own records, its gang's records,
    and every record sharing a trace with either (that is how the
    plugin daemon's Allocate-substitution record — which carries no pod
    identity — joins after controller adoption)."""
    direct = [r for r in records if _name_match(r.get("pod", ""), pod)]
    gangs = {r["gang"] for r in direct if r.get("gang")}
    traces = {r["trace_id"] for r in direct if r.get("trace_id")}
    grown = True
    while grown:  # gang records widen the trace set (gang.admit root)
        grown = False
        for r in records:
            if r.get("gang") in gangs and r.get("trace_id"):
                if r["trace_id"] not in traces:
                    traces.add(r["trace_id"])
                    grown = True
    out = [
        r
        for r in records
        if _name_match(r.get("pod", ""), pod)
        or (r.get("gang") in gangs and not r.get("pod"))
        or (r.get("trace_id") and r["trace_id"] in traces)
    ]
    return sorted(out, key=lambda r: r.get("ts", 0)), traces


def render_pod(records: List[dict], spans: List[dict],
               pod: str) -> List[str]:
    chain, traces = chain_for_pod(records, pod)
    if not chain:
        return [f"(no decision records for pod {pod!r})"]
    out = [
        f"decision chain for pod {pod} "
        f"({len(chain)} records, {len(traces)} trace(s)):",
        "",
    ]
    out += [_record_line(r) for r in chain]
    for tid in sorted(traces):
        members = [s for s in spans if s["trace_id"] == tid]
        if members:
            out.append("")
            out += render_trace_tree(members, trace_id=tid)
    return out


def render_gang(records: List[dict], spans: List[dict],
                gang: str) -> List[str]:
    chain = sorted(
        (r for r in records if _name_match(r.get("gang", ""), gang)),
        key=lambda r: r.get("ts", 0),
    )
    if not chain:
        return [f"(no decision records for gang {gang!r})"]
    waits = [r for r in chain if r.get("kind") == "gang_waiting"]
    admits = [r for r in chain if r.get("kind") == "gang_admitted"]
    head = f"gang {gang}: {len(waits)} waiting-state change(s)"
    if admits:
        waited = (admits[-1].get("attrs") or {}).get("waited_s")
        head += ", admitted" + (
            f" after {waited}s" if waited else ""
        )
    out = [head, ""]
    out += [_record_line(r) for r in chain]
    traces = {r["trace_id"] for r in chain if r.get("trace_id")}
    for tid in sorted(traces):
        members = [s for s in spans if s["trace_id"] == tid]
        if members:
            out.append("")
            out += render_trace_tree(members, trace_id=tid)
    return out


def render_evicted(records: List[dict], spans: List[dict],
                   gang: str) -> List[str]:
    """'Why was I evicted': the victim gang's preempt_victim records
    (cost ranking at decision time) merged with the evictor's
    preemption-round records, chronological, traces beneath."""
    mine = sorted(
        (
            r for r in records
            if r.get("kind") == "preempt_victim"
            and _name_match(r.get("gang", ""), gang)
        ),
        key=lambda r: r.get("ts", 0),
    )
    if not mine:
        return [f"(no preemption records for gang {gang!r})"]
    evictors = {
        (r.get("attrs") or {}).get("evictor", "")
        for r in mine
        if (r.get("attrs") or {}).get("evictor")
    }
    rounds = [
        r for r in records
        if r.get("kind") == "preemption" and r.get("gang") in evictors
    ]
    last = mine[-1]
    attrs = last.get("attrs") or {}
    head = (
        f"gang {gang}: evicted by {attrs.get('evictor', '?')} "
        f"(victim tier {attrs.get('victim_tier', '?')}, rank "
        f"{attrs.get('rank', '?')}"
    )
    # The ledger stringifies attrs ("" = unknown), but file inputs may
    # carry raw numbers — 0.0 (the idle, just-checkpointed canonical
    # cheapest victim) is a COST FACT, not an absent one.
    if attrs.get("duty_cycle") not in ("", None):
        head += f", duty {attrs['duty_cycle']}%"
    if attrs.get("checkpoint_age_s") not in ("", None):
        head += f", last checkpoint {attrs['checkpoint_age_s']}s ago"
    head += ")"
    chain = sorted(mine + rounds, key=lambda r: r.get("ts", 0))
    out = [head, ""]
    out += [_record_line(r) for r in chain]
    traces = {r["trace_id"] for r in chain if r.get("trace_id")}
    for tid in sorted(traces):
        members = [s for s in spans if s["trace_id"] == tid]
        if members:
            out.append("")
            out += render_trace_tree(members, trace_id=tid)
    return out


def render_migrated(records: List[dict], spans: List[dict],
                    gang: str) -> List[str]:
    """'Why was I migrated': the victim gang's defrag_victim records
    (cost ranking at decision time, the stranded requestor it moved
    FOR) merged with the requestor's defrag-round records,
    chronological, traces beneath."""
    mine = sorted(
        (
            r for r in records
            if r.get("kind") == "defrag_victim"
            and _name_match(r.get("gang", ""), gang)
        ),
        key=lambda r: r.get("ts", 0),
    )
    if not mine:
        return [f"(no defragmentation records for gang {gang!r})"]
    requestors = {
        (r.get("attrs") or {}).get("requestor", "")
        for r in mine
        if (r.get("attrs") or {}).get("requestor")
    }
    rounds = [
        r for r in records
        if r.get("kind") == "defrag" and r.get("gang") in requestors
    ]
    last = mine[-1]
    attrs = last.get("attrs") or {}
    head = (
        f"gang {gang}: migrated off {attrs.get('target_host', '?')} "
        f"for {attrs.get('requestor', '?')} (victim tier "
        f"{attrs.get('victim_tier', '?')}, rank {attrs.get('rank', '?')}"
    )
    # Same convention as render_evicted: "" = unknown, but 0.0 is a
    # cost FACT (the idle, just-checkpointed canonical cheapest
    # victim), not an absent one.
    if attrs.get("duty_cycle") not in ("", None):
        head += f", duty {attrs['duty_cycle']}%"
    if attrs.get("checkpoint_age_s") not in ("", None):
        head += f", last checkpoint {attrs['checkpoint_age_s']}s ago"
    head += ")"
    chain = sorted(mine + rounds, key=lambda r: r.get("ts", 0))
    out = [head, ""]
    out += [_record_line(r) for r in chain]
    traces = {r["trace_id"] for r in chain if r.get("trace_id")}
    for tid in sorted(traces):
        members = [s for s in spans if s["trace_id"] == tid]
        if members:
            out.append("")
            out += render_trace_tree(members, trace_id=tid)
    return out


def render_rescued(records: List[dict], spans: List[dict],
                   gang: str) -> List[str]:
    """'What did the hardware failure do to me': both roles in one
    view — the gang's own rescue story (``rescue`` records:
    degraded → executed / pending) AND, if it was collateral, its
    ``rescue_victim`` selection records joined with the degraded
    requestor's round records. Chronological, traces beneath."""
    own = [
        r for r in records
        if r.get("kind") == "rescue"
        and _name_match(r.get("gang", ""), gang)
    ]
    victim = [
        r for r in records
        if r.get("kind") == "rescue_victim"
        and _name_match(r.get("gang", ""), gang)
    ]
    if not own and not victim:
        return [f"(no rescue records for gang {gang!r})"]
    requestors = {
        (r.get("attrs") or {}).get("requestor", "")
        for r in victim
        if (r.get("attrs") or {}).get("requestor")
    }
    rounds = [
        r for r in records
        if r.get("kind") == "rescue" and r.get("gang") in requestors
    ]
    if victim:
        attrs = (sorted(victim, key=lambda r: r.get("ts", 0))[-1]
                 .get("attrs") or {})
        head = (
            f"gang {gang}: evicted for the hardware rescue of "
            f"{attrs.get('requestor', '?')} (victim tier "
            f"{attrs.get('victim_tier', '?')}, rank "
            f"{attrs.get('rank', '?')})"
        )
    else:
        last = sorted(own, key=lambda r: r.get("ts", 0))[-1]
        attrs = last.get("attrs") or {}
        reason = last.get("reason", "?")
        if reason == "executed":
            head = (
                f"gang {gang}: rescued off "
                f"{attrs.get('hosts', '?')} onto "
                f"{attrs.get('consumed', '?')}"
            )
            if attrs.get("latency_s") not in ("", None):
                head += f" ({attrs['latency_s']}s after detection)"
        elif reason == "pending":
            head = (
                f"gang {gang}: degraded but parked RESCUE_PENDING "
                f"({attrs.get('cause', '?')}) — no healthy "
                f"relocation target yet"
            )
        else:
            head = f"gang {gang}: rescue in progress ({reason})"
    chain = sorted(own + victim + rounds, key=lambda r: r.get("ts", 0))
    out = [head, ""]
    out += [_record_line(r) for r in chain]
    traces = {r["trace_id"] for r in chain if r.get("trace_id")}
    for tid in sorted(traces):
        members = [s for s in spans if s["trace_id"] == tid]
        if members:
            out.append("")
            out += render_trace_tree(members, trace_id=tid)
    return out


def render_node(records: List[dict], node: str) -> List[str]:
    mine = sorted(
        (r for r in records if r.get("node") == node),
        key=lambda r: r.get("ts", 0),
    )
    if not mine:
        return [f"(no decision records for node {node!r})"]
    by_reason: Dict[str, int] = {}
    for r in mine:
        by_reason[r.get("reason", "?")] = (
            by_reason.get(r.get("reason", "?"), 0) + 1
        )
    out = [
        f"node {node}: {len(mine)} decision record(s) — "
        + ", ".join(
            f"{reason}×{n}" for reason, n in sorted(by_reason.items())
        ),
        "",
    ]
    out += [_record_line(r) for r in mine]
    return out


def _load(path: str) -> dict:
    if path == "-":
        return json.load(sys.stdin)
    with open(path) as f:
        return json.load(f)


def _fetch(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


def gather(
    url: str,
    decision_files: List[str],
    traces_file: str,
) -> Tuple[List[dict], List[dict]]:
    """(ledger records, flat spans) from a live daemon URL and/or
    files. Multiple decision sources merge (extender + node daemons
    each keep their own ledger)."""
    records: List[dict] = []
    spans: List[dict] = []
    if url:
        base = url.rstrip("/")
        records += _fetch(f"{base}/debug/decisions").get("records", [])
        try:
            spans += _flatten_otlp(_fetch(f"{base}/debug/traces"))
        except Exception:  # noqa: BLE001 — traces are enrichment; the
            pass  # decision chain must render without them
    for path in decision_files:
        doc = _load(path)
        records += doc.get("records", []) if isinstance(doc, dict) else doc
    if traces_file:
        spans += _flatten_otlp(_load(traces_file))
    return records, spans


def _self_test() -> Tuple[List[dict], List[dict]]:
    """The canonical capacity-starved journey through the port's ledger
    and collector (decisions.py record/snapshot, tracing.py span/export),
    so this smoke breaks if either shape and this renderer drift apart."""
    from ..utils import decisions, tracing

    led = decisions.DecisionLedger()
    led.enabled = True  # enabled without enable(): no metrics family bound
    collector = tracing.SpanCollector()
    saved = tracing.COLLECTOR
    tracing.COLLECTOR = collector
    was_enabled = tracing.enabled()
    try:
        tracing.enable(service="extender")
        with tracing.span("gang.admit", service="extender",
                          gang="demo") as root:
            ctx = root.context
            led.record(
                "gang_waiting", "capacity",
                "insufficient GPU capacity for [2, 2]: blocking demand "
                "2: best host has 0 free card(s), short 2",
                gang="default/demo",
            )
            led.record(
                "gang_admitted", "admitted",
                "whole gang fits; gates removed for 2 pod(s)",
                gang="default/demo", waited_s=14.2,
            )
        with tracing.span("extender.filter", parent=ctx,
                          service="extender"):
            led.record(
                "filter_reject", "insufficient_chips",
                "0 chips available, 2 needed",
                pod="default/demo-w0", gang="default/demo",
                node="node-b",
            )
            led.record(
                "filter", "ok", "1/2 candidates passed",
                pod="default/demo-w0", gang="default/demo",
            )
        with tracing.span("plugin.Allocate", parent=ctx,
                          service="plugin"):
            led.record(
                "allocate_substitution", "substituted",
                "kubelet requested ['c2', 'c3'], topology chose "
                "['c0', 'c1']",
                requested="c2,c3", assigned="c0,c1",
            )
        # The preemption chain (the JAX extender/preemption.py kinds): a
        # batch victim selected and evicted for the demo gang, which the
        # --evicted view renders.
        led.record(
            "preempt_victim", "selected",
            "victim 1/1 for default/demo: priority -10, restart "
            "cost 12.0",
            gang="default/batch", evictor="default/demo",
            rank=1, victim_tier="batch", victim_priority=-10,
            chips=4, duty_cycle=2.0, checkpoint_age_s=8.5,
        )
        led.record(
            "preemption", "executed",
            "evicted 1 lower-priority gang(s) (default/batch) "
            "freeing 4 chip(s) for [4]",
            gang="default/demo", tier="high", victims="default/batch",
            victim_count=1, freed_chips=4,
        )
        # The defragmentation chain (the JAX extender/defrag.py kinds): a
        # batch victim migrated off a host to free a contiguous box for the
        # stranded demo gang, which the --migrated view renders.
        led.record(
            "defrag_victim", "migrated",
            "victim 1/1 migrated off node-a for default/demo: "
            "priority -10, restart cost 12.0",
            gang="default/batch", requestor="default/demo",
            rank=1, victim_tier="batch", victim_priority=-10,
            chips=2, target_host="node-a",
            duty_cycle=2.0, checkpoint_age_s=8.5,
        )
        led.record(
            "defrag", "executed",
            "migrated 1 gang(s) (default/batch) off node-a, freeing "
            "a size-4 box (placeable [1, 2] -> [1, 2, 4]) for [4]",
            gang="default/demo", size=4, target_host="node-a",
            victims="default/batch", victim_count=1, freed_chips=2,
            total_restart_cost=12.0,
        )
        # The rescue chain (the JAX extender/rescue.py kinds): the demo
        # gang degraded by a card failure, a batch victim evicted to make
        # room, the evacuation executed, which the --rescued view renders
        # for both roles.
        led.record(
            "rescue", "degraded",
            "running gang default/demo is on degraded capacity: "
            "node-a (chip_failed); rescue after 1 consecutive "
            "tick(s)",
            gang="default/demo", hosts=["node-a"], tier="high",
        )
        led.record(
            "rescue_victim", "evicted",
            "victim 1/1 evicted for the hardware rescue of "
            "default/demo: priority -10, restart cost 12.0",
            gang="default/batch", requestor="default/demo",
            rank=1, victim_tier="batch", victim_priority=-10,
            chips=4,
        )
        led.record(
            "rescue", "executed",
            "evacuated gang default/demo off ['node-a'] "
            "(node-a:chip_failed) and fenced {'node-b': 4} for its "
            "re-admission; evicted default/batch to make room",
            gang="default/demo", hosts=["node-a"],
            consumed={"node-b": 4}, victims="default/batch",
            victim_count=1, tier="high", latency_s=0.5,
        )
        return (
            led.snapshot()["records"],
            _flatten_otlp(collector.otlp_json()),
        )
    finally:
        tracing.COLLECTOR = saved
        if not was_enabled:
            tracing.disable()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu-explain",
        description="Answer 'why is my pod pending?' from the "
        "scheduling decision ledger, correlated with traces.",
    )
    p.add_argument("--pod", default="", help="pod name or namespace/name")
    p.add_argument("--gang", default="",
                   help="gang name or namespace/name")
    p.add_argument("--node", default="", help="node name")
    p.add_argument(
        "--evicted", default="",
        help="victim gang name or namespace/name: why was this gang "
        "preempted (victim selection + the evictor's round records)",
    )
    p.add_argument(
        "--migrated", default="",
        help="victim gang name or namespace/name: why was this gang "
        "migrated by defragmentation (victim selection + the "
        "stranded requestor's round records)",
    )
    p.add_argument(
        "--rescued", default="",
        help="gang name or namespace/name: what a hardware failure "
        "did to this gang — its own rescue story, or its selection "
        "as a rescue victim plus the degraded requestor's rounds",
    )
    p.add_argument(
        "--url", default="",
        help="daemon base URL; fetches /debug/decisions and "
        "/debug/traces from it",
    )
    p.add_argument(
        "--decisions", action="append", default=[],
        help="decision-ledger JSON file ('-' for stdin); repeatable "
        "to merge several daemons' ledgers",
    )
    p.add_argument(
        "--traces", default="",
        help="OTLP-JSON trace export file to correlate",
    )
    p.add_argument(
        "--self-test", action="store_true",
        help="render a synthetic in-process decision chain (CI smoke)",
    )
    a = p.parse_args(argv)
    if a.self_test:
        records, spans = _self_test()
        lines = render_pod(records, spans, "demo-w0")
        print("\n".join(lines))
        text = "\n".join(lines)
        needed = (
            "gang_waiting", "gang_admitted", "filter_reject",
            "allocate_substitution", "plugin.Allocate", "gang.admit",
            "insufficient_chips",
        )
        missing = [n for n in needed if n not in text]
        if missing or "decision chain" not in text:
            print(f"self-test failed: missing {missing}",
                  file=sys.stderr)
            return 1
        # The evicted view over the same synthetic ledger: the
        # victim's cost facts and the evictor's round must render.
        ev_lines = render_evicted(records, spans, "batch")
        ev_text = "\n".join(ev_lines)
        ev_needed = (
            "evicted by default/demo", "preempt_victim", "preemption",
            "duty 2.0%",
        )
        ev_missing = [n for n in ev_needed if n not in ev_text]
        if ev_missing:
            print(f"self-test failed: evicted view missing "
                  f"{ev_missing}", file=sys.stderr)
            return 1
        # The migrated view over the same synthetic ledger: the
        # victim's cost facts, its target host, and the stranded
        # requestor's round must render.
        mg_lines = render_migrated(records, spans, "batch")
        mg_text = "\n".join(mg_lines)
        mg_needed = (
            "migrated off node-a for default/demo", "defrag_victim",
            "defrag", "duty 2.0%", "size-4 box",
        )
        mg_missing = [n for n in mg_needed if n not in mg_text]
        if mg_missing:
            print(f"self-test failed: migrated view missing "
                  f"{mg_missing}", file=sys.stderr)
            return 1
        # The rescued view, both roles over the same synthetic
        # ledger: the rescued gang's evacuation story and the
        # victim's selection for it must both render.
        rs_text = "\n".join(render_rescued(records, spans, "demo"))
        rv_text = "\n".join(render_rescued(records, spans, "batch"))
        rs_needed = ("rescued off", "node-b", "0.5s after detection",
                     "degraded")
        rv_needed = ("evicted for the hardware rescue of "
                     "default/demo", "rescue_victim", "rank 1")
        rs_missing = [n for n in rs_needed if n not in rs_text]
        rs_missing += [n for n in rv_needed if n not in rv_text]
        if rs_missing:
            print(f"self-test failed: rescued view missing "
                  f"{rs_missing}", file=sys.stderr)
            return 1
        return 0
    if not (a.pod or a.gang or a.node or a.evicted or a.migrated
            or a.rescued):
        p.error("one of --pod / --gang / --node / --evicted / "
                "--migrated / --rescued is required (or --self-test)")
    if not (a.url or a.decisions):
        p.error("a source is required: --url and/or --decisions")
    try:
        records, spans = gather(a.url, a.decisions, a.traces)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if a.pod:
        lines = render_pod(records, spans, a.pod)
    elif a.gang:
        lines = render_gang(records, spans, a.gang)
    elif a.evicted:
        lines = render_evicted(records, spans, a.evicted)
    elif a.migrated:
        lines = render_migrated(records, spans, a.migrated)
    elif a.rescued:
        lines = render_rescued(records, spans, a.rescued)
    else:
        lines = render_node(records, a.node)
    print("\n".join(lines))
    return 0 if not lines[0].startswith("(no ") else 1


if __name__ == "__main__":
    sys.exit(main())
