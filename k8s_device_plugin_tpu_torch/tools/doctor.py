"""tpu-doctor: drift triage, a one-command support bundle, a dead daemon's
postmortem and a fleet table, over the port's node daemon and extender.

When state planes disagree (a stale annotation, a leaked reservation, a
gauge diverging from the placement's truth: the consistency auditor's
findings, ``audit.py``) the operator needs a readable verdict and one
artifact holding every observability surface at once.

Usage::

    # Live audit findings from any daemon's /debug/audit:
    python -m k8s_device_plugin_tpu_torch.tools.doctor check \\
        --url http://node:2112 --url http://extender:12346
    python -m k8s_device_plugin_tpu_torch.tools.doctor check audit.json

    # /metrics and every /debug/* surface (and journal or black-box
    # metadata) from both daemons into one timestamped tar.gz:
    python -m k8s_device_plugin_tpu_torch.tools.doctor bundle \\
        --url http://node:2112 --url http://extender:12346 \\
        [--journal-dir /var/lib/nvidia-extender] [-o bundle.tar.gz]

    # A dead daemon's final minutes from its --blackbox-dir:
    python -m k8s_device_plugin_tpu_torch.tools.doctor postmortem <dir>

    # Every extender (by its lease) and node daemon (by its node's
    # InternalIP) in one health table:
    python -m k8s_device_plugin_tpu_torch.tools.doctor fleet --kubeconfig <file>

    # Evacuate every resident gang off a node through the extender's
    # rescue plane (cordon, maintenance taint, journaled rounds), polling
    # until it is clear; --uncordon reverses it:
    python -m k8s_device_plugin_tpu_torch.tools.doctor drain <node> \\
        --url http://extender:12346 [--uncordon] [--no-wait]

    python -m k8s_device_plugin_tpu_torch.tools.doctor --self-test

``check`` exits 0 on a clean audit, 1 when findings are open, 2 when a
source is unreachable or the auditor reported sweep errors. ``bundle`` is
best-effort per endpoint: an unreachable surface becomes an error entry in
``manifest.json``, never a failed bundle. ``postmortem`` exits 0 after a
clean stop, 1 after a death mid-flight, 2 when nothing can be read.
``fleet`` exits 0 when every endpoint is healthy, 1 on findings, degraded
mode or build skew, 2 when an endpoint is unreachable.

``drain`` exits 0 once drained (or uncordoned), 1 when the poll times out,
2 when the extender refuses or is unreachable; an extender without the
rescue plane answers the verb 404, and the message names the plane.

``--self-test`` drives the port's pipeline in-process: a drifted engine,
``/debug/audit`` over a live ``MetricsServer``, this renderer, a bundle tar
and its manifest.

The verbs, flags, exit codes and output are the JAX package's
``tools/doctor.py``; ``fleet`` finds the port's extender by its own lease
name (``extender/leader.LEASE_NAME``).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tarfile
import time
from typing import Dict, List, Optional, Tuple

# Severity sort order for the findings table (most urgent first).
_SEV_ORDER = {"critical": 0, "warning": 1}


def _fetch(url: str, path: str, timeout: float = 10.0) -> bytes:
    import urllib.request

    with urllib.request.urlopen(
        url.rstrip("/") + path, timeout=timeout
    ) as resp:
        return resp.read()


def _post_drain(url: str, node: str, action: str, timeout: float = 30.0) -> dict:
    """One POST of the drain verb: the coordinator's status, or
    ``{"error": ...}`` when the extender refuses (the verb's own error body,
    and for a 404 the plane that is missing)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url.rstrip("/") + "/drain",
        data=json.dumps({"node": node, "action": action}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            message = json.loads(e.read() or b"{}").get("error") or str(e)
        except ValueError:
            message = str(e)
        if e.code == 404:
            message += (" (the extender's hardware-failure rescue plane is not active: it "
                        "runs with --gang-admission and without --no-rescue)")
        return {"error": message}


def drain(url: str, node: str, uncordon: bool = False, wait: bool = True,
          poll_s: float = 5.0, timeout_s: float = 1800.0, clock=time.time,
          sleep=time.sleep) -> int:
    """The drain verb: ask the extender's rescue plane to cordon and taint
    the node and evacuate every resident gang (journaled two-phase rounds,
    the path of a card failure), then poll until no resident gang pod and no
    reserved card remain; the drain-complete annotation is the "safe to
    power off" signal. Idempotent: running it again resumes the poll;
    ``uncordon`` reverses everything. Exit 0 drained or uncordoned, 1 timed
    out, 2 the extender refused or is unreachable."""
    action = "uncordon" if uncordon else "drain"
    try:
        st = _post_drain(url, node, action)
    except (OSError, ValueError) as e:
        print(f"tpu-doctor drain: {e}", file=sys.stderr)
        return 2
    if st.get("error"):
        print(f"tpu-doctor drain: {st['error']}", file=sys.stderr)
        return 2
    if uncordon:
        print(f"node {node} uncordoned: placement may use it again")
        return 0
    deadline = clock() + timeout_s
    while True:
        if st.get("error"):
            print(f"tpu-doctor drain: {st['error']}", file=sys.stderr)
            return 2
        residents = st.get("resident_gangs") or []
        print(f"node {node}: draining={st.get('draining')} resident_gangs={len(residents)} "
              f"held_chips={st.get('held_chips', 0)}"
              + (f" [{', '.join(residents)}]" if residents else ""))
        if st.get("done"):
            print(f"node {node} drained: zero resident gang pods, zero reserved chips — safe "
                  f"for maintenance (annotation stamped; `tpu-doctor drain --uncordon {node}` "
                  f"to return it)")
            return 0
        if not wait:
            return 1
        if clock() >= deadline:
            print(f"tpu-doctor drain: node {node} still has {len(residents)} resident gang(s) / "
                  f"{st.get('held_chips', 0)} held chip(s) after {timeout_s:.0f}s — gangs may "
                  f"be parked RESCUE_PENDING (no healthy capacity to move them to); see "
                  f"/debug/rescue", file=sys.stderr)
            return 1
        sleep(poll_s)
        try:
            st = _post_drain(url, node, "status")
        except (OSError, ValueError) as e:
            print(f"tpu-doctor drain: {e}", file=sys.stderr)
            return 2


def _load_audit(source: str) -> dict:
    """One source -> its /debug/audit payload. ``source`` is a base URL
    (http...) or a file path or '-' for stdin (offline: a bundle's
    audit.json)."""
    if source.startswith("http://") or source.startswith("https://"):
        return json.loads(_fetch(source, "/debug/audit"))
    if source == "-":
        return json.loads(sys.stdin.read())
    with open(source) as f:
        return json.loads(f.read())


def render_check(payload: dict, source: str = "") -> str:
    """The `tpu-doctor check` view of one /debug/audit payload."""
    build = payload.get("build") or {}
    component = build.get("component") or payload.get("service") or "?"
    head = f"== {source or component} =="
    ident = (
        f"{component} v{build.get('version', '?')} "
        f"(py{build.get('python', '?')})"
    )
    out = [head, ident]
    if not payload.get("enabled"):
        out.append(
            "auditor: DISABLED (--audit-interval-s 0) — no drift "
            "detection on this daemon"
        )
        return "\n".join(out)
    age = ""
    if payload.get("last_sweep_ts"):
        age = f", last sweep {time.time() - payload['last_sweep_ts']:.0f}s ago"
    out.append(
        f"auditor: {payload.get('sweeps', 0)} sweep(s), "
        f"{len(payload.get('invariants', []))} invariant(s), "
        f"interval {payload.get('interval_s', '?')}s{age} "
        f"({payload.get('last_duration_ms', 0)}ms)"
    )
    errors = payload.get("errors") or {}
    for name, err in sorted(errors.items()):
        out.append(f"  SWEEP ERROR {name}: {err}")
    findings = sorted(
        payload.get("findings") or [],
        key=lambda f: (
            _SEV_ORDER.get(f.get("severity", ""), 9),
            f.get("invariant", ""),
        ),
    )
    if not findings:
        out.append("  no findings — state planes agree")
        return "\n".join(out)
    header = f"  {'SEVERITY':<9} {'INVARIANT':<28} SUBJECT"
    out.append(header)
    out.append("  " + "-" * (len(header) + 20))
    for f in findings:
        subject = " ".join(
            f"{k}={f[k]}"
            for k in ("pod", "gang", "node", "chip")
            if f.get(k)
        ) or "-"
        out.append(
            f"  {f.get('severity', '?'):<9} "
            f"{f.get('invariant', '?'):<28} {subject}"
        )
        out.append(f"            {f.get('message', '')}")
    return "\n".join(out)


def check(sources: List[str]) -> int:
    """Render every source; exit code is the worst outcome."""
    rc = 0
    for source in sources:
        try:
            payload = _load_audit(source)
        except (OSError, ValueError) as e:
            print(f"== {source} ==\n  UNREACHABLE: {e}")
            rc = max(rc, 2)
            continue
        print(render_check(payload, source))
        if payload.get("errors"):
            rc = max(rc, 2)
        elif payload.get("findings"):
            rc = max(rc, 1)
    return rc


# -- bundle ------------------------------------------------------------------

# What the bundle pulls from each daemon beyond /metrics: every debug
# surface the servers register (metrics.DEBUG_ENDPOINTS), so a new surface
# is bundled without a change here.
def _bundle_paths() -> Dict[str, str]:
    from ..utils.metrics import DEBUG_ENDPOINTS

    paths = {"/metrics": "metrics.txt", "/debug": "debug-index.json"}
    for endpoint in DEBUG_ENDPOINTS:
        paths[endpoint] = endpoint.rsplit("/", 1)[-1] + ".json"
    return paths


def _journal_metadata(journal_dir: str, name: str = "admission") -> dict:
    """The metadata of a statestore journal and snapshot pair (sizes, seq,
    load status, record count) through the side-effect-free reader: never
    the raw records (gang names stay out of the bundle unless the audit
    payload names them), and never load()'s tail-healing truncate against
    a file another process owns. ``name`` picks the store: the admission
    journal by default, the extender's index snapshot with
    ``name="index"``."""
    from ..utils import statestore

    # The paths come from StateStore itself (its construction opens
    # nothing), so a renamed store cannot turn this section "empty".
    store = statestore.StateStore(journal_dir, name=name)
    meta: dict = {"dir": journal_dir, "files": {}}
    for path in (
        store.journal_path, store.snapshot_path, store._tmp_path,
    ):
        try:
            st = os.stat(path)
            meta["files"][os.path.basename(path)] = {
                "size_bytes": st.st_size,
                "mtime": round(st.st_mtime, 3),
            }
        except OSError:
            continue
    loaded = statestore.read_state(
        store.journal_path, store.snapshot_path
    )
    meta.update({
        "status": loaded.status,
        "records_past_snapshot": len(loaded.records),
        "dropped_lines": loaded.dropped,
        "seq": loaded.seq,
        "has_snapshot": loaded.snapshot is not None,
    })
    return meta


def _blackbox_metadata(bb_dir: str) -> dict:
    """Per-segment metadata of a black-box directory (names, sizes, read
    statuses; never record bodies: those enter the bundle only as the one
    newest segment file, which a postmortem reads first)."""
    from ..utils import blackbox

    meta: dict = {"dir": bb_dir, "segments": []}
    for seg in blackbox.list_segments(bb_dir):
        recs, status, dropped = blackbox.read_segment(seg["path"])
        meta["segments"].append({
            "name": seg["name"],
            "service": seg["service"],
            "pid": seg["pid"],
            "size_bytes": seg["size_bytes"],
            "mtime": seg["mtime"],
            "status": status,
            "records": len(recs),
            "dropped_lines": dropped,
        })
    return meta


def _source_dirname(url: str) -> str:
    return (
        url.split("://", 1)[-1].rstrip("/").replace("/", "_")
        .replace(":", "_")
    )


def bundle(
    urls: List[str],
    out_path: str = "",
    journal_dir: str = "",
    blackbox_dir: str = "",
    index_snapshot_dir: str = "",
    now: Optional[float] = None,
) -> Tuple[str, dict]:
    """Collect every surface into one tar.gz; returns (path, manifest).
    Best-effort per file: a failure lands in the manifest."""
    from ..utils.metrics import build_info

    ts = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(now))
    out_path = out_path or f"tpu-doctor-{ts}.tar.gz"
    manifest: dict = {
        "created_utc": ts,
        "tool": build_info(),
        "sources": [],
    }
    paths = _bundle_paths()
    with tarfile.open(out_path, "w:gz") as tar:
        def add(name: str, data: bytes) -> None:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = int(now or time.time())
            tar.addfile(info, io.BytesIO(data))

        for url in urls:
            dirname = _source_dirname(url)
            entry: dict = {"url": url, "files": {}}
            for endpoint, fname in sorted(paths.items()):
                try:
                    data = _fetch(url, endpoint)
                except (OSError, ValueError) as e:
                    entry["files"][fname] = f"error: {e}"
                    continue
                add(f"{dirname}/{fname}", data)
                entry["files"][fname] = "ok"
                if fname == "audit.json":
                    # The daemon's build identity and configuration in the
                    # manifest, so triage can start from the manifest.
                    try:
                        audit_payload = json.loads(data)
                        entry["build"] = audit_payload.get("build")
                        entry["config"] = audit_payload.get("config")
                    except ValueError:
                        pass
            manifest["sources"].append(entry)
        if journal_dir:
            try:
                manifest["journal"] = _journal_metadata(journal_dir)
            except Exception as e:  # noqa: BLE001 - best-effort, as every member
                manifest["journal"] = {"error": f"{e}"}
        if index_snapshot_dir:
            try:
                manifest["index_snapshot"] = _journal_metadata(
                    index_snapshot_dir, name="index"
                )
            except Exception as e:  # noqa: BLE001 - best-effort
                manifest["index_snapshot"] = {"error": f"{e}"}
        if blackbox_dir:
            # Metadata of every segment, and the newest segment itself: it
            # holds the final minutes a postmortem reads first, and one
            # bounded segment keeps the bundle's size predictable.
            try:
                manifest["blackbox"] = _blackbox_metadata(blackbox_dir)
                segments = manifest["blackbox"]["segments"]
                if segments:
                    newest = segments[-1]["name"]
                    with open(
                        os.path.join(blackbox_dir, newest), "rb"
                    ) as f:
                        add(f"blackbox/{newest}", f.read())
                    manifest["blackbox"]["bundled_segment"] = newest
            except Exception as e:  # noqa: BLE001 - best-effort
                manifest["blackbox"] = {"error": f"{e}"}
        add(
            "manifest.json",
            json.dumps(manifest, indent=1, sort_keys=True).encode(),
        )
    return out_path, manifest


# -- postmortem ----------------------------------------------------------------

def _fmt_ts(ts: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(ts)) + (
        f".{int(round((ts % 1) * 1000)):03d}"
    )


def _rec_trace(rec: dict) -> str:
    return (rec.get("data") or {}).get("trace_id", "")


def _timeline_line(rec: dict) -> str:
    """One black-box record -> one line of the merged timeline."""
    ts = rec.get("ts") or 0
    kind = rec.get("kind", "?")
    d = rec.get("data") or {}
    stamp = _fmt_ts(ts)
    tid = d.get("trace_id", "")
    tmark = f" trace={tid}" if tid else ""
    if kind == "flight":
        return (
            f"{stamp} flight   {d.get('kind', '?'):<24} "
            f"{d.get('message', '')}{tmark}"
        )
    if kind == "decision":
        subject = " ".join(
            f"{k}={d[k]}" for k in ("pod", "gang", "node") if d.get(k)
        )
        return (
            f"{stamp} ledger   {d.get('kind', '?')}/"
            f"{d.get('reason', '?')} {subject} "
            f"{d.get('message', '')}{tmark}"
        )
    if kind == "span":
        dur_ms = round(
            (d.get("end_ns", 0) - d.get("start_ns", 0)) / 1e6, 2
        )
        err = f" ERROR {d['error']}" if d.get("error") else ""
        return (
            f"{stamp} span     {d.get('name', '?'):<24} "
            f"{dur_ms}ms{err}{tmark}"
        )
    if kind == "heartbeats":
        beats = d.get("beats") or []
        dead = [b["name"] for b in beats if b.get("dead")]
        worst = max((b.get("age_s", 0) for b in beats), default=0)
        return (
            f"{stamp} beats    {len(beats)} loop(s), max age "
            f"{worst}s" + (f", DEAD: {', '.join(dead)}" if dead else "")
        )
    if kind == "metrics":
        return (
            f"{stamp} metrics  snapshot "
            f"({len(d.get('families') or {})} families)"
        )
    if kind == "meta":
        build = d.get("build") or {}
        return (
            f"{stamp} meta     segment {d.get('segment')} opened by "
            f"{d.get('service')}[{d.get('pid')}] "
            f"v{build.get('version', '?')}"
        )
    if kind == "stop":
        return f"{stamp} stop     clean shutdown marker"
    return f"{stamp} {kind}"


def build_postmortem(
    bb_dir: str, minutes: float = 10.0, service: str = ""
) -> dict:
    """A dead daemon's final ``minutes`` from its black box (the
    ``utils/blackbox.py`` segments): one merged timeline of flight events,
    ledger decisions, spans, heartbeat ages and metric deltas, trace ids
    joined. The exit code: 0 when the stream ends in a clean ``stop``
    marker (an ordinary shutdown), 1 when it does not (the daemon died
    mid-flight; a torn tail is read up to the damage and reported), 2 when
    nothing is readable (no directory, no segment, no intact record)."""
    from ..utils import blackbox, statestore

    records, meta = blackbox.read_dir(bb_dir, service=service)
    if not meta["segments"]:
        return {
            "dir": bb_dir,
            "error": f"no black-box segments under {bb_dir!r}",
            "exit_code": 2,
        }
    if not records:
        return {
            "dir": bb_dir,
            "error": "no intact records in any segment",
            "segments": meta["segments"],
            "exit_code": 2,
        }
    records.sort(key=lambda r: (r.get("ts") or 0, r.get("seq") or 0))
    end_ts = records[-1].get("ts") or 0
    start_ts = end_ts - minutes * 60.0
    window = [r for r in records if (r.get("ts") or 0) >= start_ts]
    clean_stop = records[-1].get("kind") == "stop"
    metas = [r["data"] for r in records if r.get("kind") == "meta"]
    decisions = [r for r in window if r.get("kind") == "decision"]
    last_decision = dict(decisions[-1]["data"]) if decisions else None
    hb_recs = [r for r in window if r.get("kind") == "heartbeats"]
    heartbeats = (
        hb_recs[-1]["data"].get("beats") or [] if hb_recs else []
    )
    met_recs = [r for r in window if r.get("kind") == "metrics"]
    metric_deltas: Dict[str, float] = {}
    if len(met_recs) >= 2:
        first = met_recs[0]["data"].get("families") or {}
        last = met_recs[-1]["data"].get("families") or {}
        for name, v in sorted(last.items()):
            delta = round(v - first.get(name, 0.0), 6)
            if delta:
                metric_deltas[name] = delta
    trace_id = (last_decision or {}).get("trace_id", "")
    trace_records = (
        [r for r in window if _rec_trace(r) == trace_id]
        if trace_id else []
    )
    return {
        "dir": bb_dir,
        "identity": metas[-1] if metas else {},
        "segments": meta["segments"],
        "torn": any(
            s["status"] != statestore.CLEAN for s in meta["segments"]
        ),
        "window": {
            "minutes": minutes,
            "start_ts": round(start_ts, 3),
            "end_ts": round(end_ts, 3),
            "records": len(window),
            "records_total": len(records),
        },
        "clean_stop": clean_stop,
        "last_decision": last_decision,
        "trace_id": trace_id,
        "trace_records": [_timeline_line(r) for r in trace_records],
        "heartbeats": heartbeats,
        "metric_deltas": metric_deltas,
        "timeline": [_timeline_line(r) for r in window],
        "exit_code": 0 if clean_stop else 1,
    }


def render_postmortem(report: dict, max_timeline: int = 200) -> str:
    """The `tpu-doctor postmortem` incident view of one report."""
    if report.get("error"):
        return f"POSTMORTEM UNAVAILABLE: {report['error']}"
    ident = report.get("identity") or {}
    build = ident.get("build") or {}
    w = report["window"]
    out = [
        f"== postmortem: {report['dir']} ==",
        f"{ident.get('service', '?')}[{ident.get('pid', '?')}] "
        f"v{build.get('version', '?')} — final {w['minutes']}min "
        f"window ({w['records']}/{w['records_total']} records, "
        f"{_fmt_ts(w['start_ts'])} .. {_fmt_ts(w['end_ts'])})",
    ]
    verdict = (
        "clean shutdown (stop marker present)"
        if report["clean_stop"]
        else "DIED MID-FLIGHT: no clean-stop marker"
        + (" — torn tail read up to the damage"
           if report["torn"] else "")
    )
    out.append(f"verdict: {verdict}")
    out.append("segments:")
    for s in report["segments"]:
        out.append(
            f"  {s['name']}: {s['records']} record(s), "
            f"{s['size_bytes']}B, status={s['status']}"
        )
    if report.get("last_decision"):
        d = report["last_decision"]
        subject = " ".join(
            f"{k}={d[k]}" for k in ("pod", "gang", "node") if d.get(k)
        )
        out.append(
            f"last decision: {d.get('kind')}/{d.get('reason')} "
            f"{subject} — {d.get('message', '')}"
        )
        if report.get("trace_id"):
            out.append(
                f"  trace {report['trace_id']} "
                f"({len(report['trace_records'])} joined record(s)):"
            )
            out.extend(
                f"    {line}" for line in report["trace_records"]
            )
    else:
        out.append("last decision: none in window")
    if report.get("heartbeats"):
        out.append("heartbeats at last snapshot:")
        for b in sorted(
            report["heartbeats"],
            key=lambda x: -(x.get("age_s") or 0),
        ):
            flag = " DEAD" if b.get("dead") else ""
            out.append(
                f"  {b.get('name', '?'):<24} age "
                f"{b.get('age_s', '?')}s{flag}"
            )
    if report.get("metric_deltas"):
        out.append("metric deltas across window (non-zero):")
        for name, delta in report["metric_deltas"].items():
            out.append(f"  {name:<44} {delta:+g}")
    timeline = report["timeline"]
    shown = timeline[-max_timeline:]
    out.append(
        f"timeline ({len(shown)} of {len(timeline)} in window, "
        "newest last):"
    )
    out.extend(f"  {line}" for line in shown)
    return "\n".join(out)


def postmortem(
    bb_dir: str, minutes: float = 10.0, service: str = ""
) -> int:
    report = build_postmortem(bb_dir, minutes=minutes, service=service)
    print(render_postmortem(report))
    return report["exit_code"]


# -- fleet ---------------------------------------------------------------------

def discover_fleet(
    kubeconfig: str = "",
    lease_namespace: str = "kube-system",
    extender_port: int = 12346,
    plugin_port: int = 2112,
) -> List[dict]:
    """Every extender and node-daemon endpoint, from the control plane
    itself: an extender holds a lease whose name starts with
    ``extender/leader.LEASE_NAME`` (``spec.holderIdentity`` is its HOSTNAME,
    else ``<host>-<pid>``; a trailing ``-<digits>`` is stripped, as the JAX
    tool does), and a node daemon runs on each node (the node's InternalIP
    on the metrics port). Raises on an unreachable API server: the
    discovery failing is the answer then."""
    import re as _re

    from ..extender.leader import LEASE_NAME
    from ..kube.client import KubeClient

    client = KubeClient.from_env(kubeconfig)
    endpoints: List[dict] = []
    seen = set()
    leases = client.list_leases(namespace=lease_namespace) or {}
    for item in leases.get("items") or []:
        name = (item.get("metadata") or {}).get("name") or ""
        if not name.startswith(LEASE_NAME):
            continue
        holder = (item.get("spec") or {}).get("holderIdentity") or ""
        host = _re.sub(r"-\d+$", "", holder)  # the -<pid> tail stripped
        if not host:
            continue
        url = f"http://{host}:{extender_port}"
        if url in seen:
            continue
        seen.add(url)
        endpoints.append({
            "role": "extender", "url": url,
            "lease": name, "holder": holder,
        })
    nodes = client.list_nodes() or {}
    for item in nodes.get("items") or []:
        nodename = (item.get("metadata") or {}).get("name") or ""
        addrs = (item.get("status") or {}).get("addresses") or []
        ip = next(
            (a.get("address") for a in addrs
             if a.get("type") == "InternalIP" and a.get("address")),
            "",
        )
        if not ip:
            continue
        url = f"http://{ip}:{plugin_port}"
        if url in seen:
            continue
        seen.add(url)
        endpoints.append({
            "role": "plugin", "url": url, "node": nodename,
        })
    return endpoints


def _fleet_row(endpoint: dict) -> dict:
    """One endpoint's health row: /debug/audit (build identity and
    findings), /debug/readyz (phase), /debug/resilience (degraded mode).
    Best-effort per surface; an unreachable endpoint is the row."""
    row = dict(endpoint)
    try:
        audit = json.loads(_fetch(endpoint["url"], "/debug/audit"))
    except (OSError, ValueError) as e:
        row["unreachable"] = f"{e}"
        return row
    build = audit.get("build") or {}
    row["component"] = build.get("component", "?")
    row["version"] = build.get("version", "?")
    row["findings"] = len(audit.get("findings") or [])
    row["sweep_errors"] = len(audit.get("errors") or {})
    try:
        readyz = json.loads(_fetch(endpoint["url"], "/debug/readyz"))
        row["phase"] = (
            readyz.get("phase", "?")
            if readyz.get("configured", True) else "n/a"
        )
    except (OSError, ValueError):
        row["phase"] = "?"
    try:
        res = json.loads(_fetch(endpoint["url"], "/debug/resilience"))
        row["degraded"] = any(
            d.get("active") for d in res.get("degraded") or []
        )
        row["breaker_open"] = bool(res.get("breaker_open"))
    except (OSError, ValueError):
        row["degraded"] = None
        row["breaker_open"] = None
    return row


def render_fleet(rows: List[dict]) -> Tuple[str, int]:
    """The `tpu-doctor fleet` table + its exit code: 0 all healthy,
    1 findings / degraded mode / build skew anywhere, 2 any endpoint
    unreachable."""
    rc = 0
    header = (
        f"{'ROLE':<9} {'ENDPOINT':<28} {'BUILD':<14} {'PHASE':<10} "
        f"{'DEGRADED':<9} {'FINDINGS':<8} SOURCE"
    )
    out = [header, "-" * len(header)]
    versions = set()
    for row in sorted(
        rows, key=lambda r: (r.get("role", ""), r.get("url", ""))
    ):
        source = row.get("lease") or row.get("node") or "--url"
        if row.get("unreachable"):
            rc = max(rc, 2)
            out.append(
                f"{row.get('role', '?'):<9} {row.get('url', ''):<28} "
                f"UNREACHABLE: {row['unreachable']} ({source})"
            )
            continue
        build = f"{row.get('component')}/{row.get('version')}"
        versions.add(build)
        degraded = row.get("degraded")
        deg = (
            "yes" if degraded
            else ("no" if degraded is not None else "?")
        )
        if row.get("breaker_open"):
            deg += "+open"
        bad = (
            row.get("findings")
            or row.get("sweep_errors")
            or degraded
            or row.get("breaker_open")
        )
        if bad:
            rc = max(rc, 1)
        out.append(
            f"{row.get('role', '?'):<9} {row.get('url', ''):<28} "
            f"{build:<14} {row.get('phase', '?'):<10} {deg:<9} "
            f"{row.get('findings', 0):<8} {source}"
        )
    per_role_versions: Dict[str, set] = {}
    for row in rows:
        if not row.get("unreachable"):
            per_role_versions.setdefault(
                row.get("component", "?"), set()
            ).add(row.get("version", "?"))
    skewed = {
        comp: sorted(vs)
        for comp, vs in per_role_versions.items() if len(vs) > 1
    }
    if skewed:
        rc = max(rc, 1)
        for comp, vs in sorted(skewed.items()):
            out.append(
                f"BUILD SKEW: {comp} running {len(vs)} versions: "
                f"{', '.join(vs)}"
            )
    out.append(
        f"{len(rows)} endpoint(s): "
        f"{sum(1 for r in rows if r.get('unreachable'))} unreachable, "
        f"{sum(1 for r in rows if r.get('findings'))} with findings"
    )
    return "\n".join(out), rc


def fleet(
    urls: List[str],
    kubeconfig: str = "",
    lease_namespace: str = "kube-system",
    extender_port: int = 12346,
    plugin_port: int = 2112,
    discover: bool = True,
) -> int:
    endpoints = [{"role": "?", "url": u} for u in urls]
    if discover:
        try:
            endpoints.extend(discover_fleet(
                kubeconfig=kubeconfig,
                lease_namespace=lease_namespace,
                extender_port=extender_port,
                plugin_port=plugin_port,
            ))
        except Exception as e:  # noqa: BLE001 - an API server that is down is
            # an answer (exit 2), not a traceback
            print(f"fleet discovery failed: {e}", file=sys.stderr)
            if not urls:
                return 2
    if not endpoints:
        print("fleet: no endpoints discovered and no --url given")
        return 2
    rows = [_fleet_row(e) for e in endpoints]
    text, rc = render_fleet(rows)
    print(text)
    return rc


# -- self-test ---------------------------------------------------------------

def _self_test() -> str:
    """A drifted engine -> a live /debug/audit -> the renderer -> a bundle
    tar -> its manifest. Raises on any drift in the chain."""
    import shutil
    import tempfile

    from .. import audit
    from ..utils import metrics

    metrics.set_build_info("plugin")
    drift = {"on": True}

    def leaky() -> List[audit.Finding]:
        if not drift["on"]:
            return []
        return [audit.Finding.make(
            "orphaned_chip", audit.CRITICAL,
            "cards ['GPU-x'] held by pod ml/ghost, which the API server "
            "no longer knows",
            pod="ml/ghost", node="self-test-node", chips="GPU-x",
        )]

    engine = audit.AuditEngine(
        service="plugin",
        invariants=[
            audit.Invariant(
                "orphaned_chip", ("podresources", "apiserver"),
                "self-test drifted invariant", leaky,
            ),
            audit.Invariant(
                "gauge_vs_state", ("metrics", "placement"),
                "self-test clean invariant", lambda: [],
            ),
        ],
        interval_s=60,
        config={"audit_interval_s": 60},
    )
    saved = audit.ENGINE
    audit.install_engine(engine)
    srv = metrics.MetricsServer(host="127.0.0.1")
    url = srv.start()
    tmp = tempfile.mkdtemp(prefix="tpu-doctor-selftest-")
    try:
        engine.sweep_once()
        payload = _load_audit(url)
        assert payload["enabled"] and payload["findings"], payload
        table = render_check(payload, url)
        assert "orphaned_chip" in table and "ml/ghost" in table, table
        assert "critical" in table
        assert check([url]) == 1  # findings: exit 1
        # The repair: a clean render and exit 0.
        drift["on"] = False
        engine.sweep_once()
        assert "no findings" in render_check(_load_audit(url))
        assert check([url]) == 0
        # The findings gauge followed the drift's lifecycle.
        assert not [labels for labels, _ in metrics.AUDIT_FINDINGS.series()
                    if labels.get("invariant") == "orphaned_chip"]
        # The bundle: every surface collected, the manifest names the build.
        out, manifest = bundle(
            [url], out_path=os.path.join(tmp, "b.tar.gz")
        )
        with tarfile.open(out) as tar:
            names = set(tar.getnames())
        want = {"manifest.json"} | {
            f"{_source_dirname(url)}/{f}"
            for f in _bundle_paths().values()
        }
        missing = want - names
        assert not missing, missing
        src = manifest["sources"][0]
        assert src["files"]["audit.json"] == "ok"
        assert src["build"]["component"] == "plugin", src
        # The black box and the index snapshot in the bundle: metadata in
        # the manifest, the newest segment in the tar.
        from ..utils import blackbox as bb_mod
        from ..utils import statestore

        bb_dir = os.path.join(tmp, "bb")
        bb = bb_mod.BlackBoxRecorder()
        assert bb.start(
            bb_dir, "plugin",
            drain_interval_s=0.02, fsync_interval_s=0.0,
        )
        bb.put("flight", {"kind": "probe", "message": "bundle me"})
        bb.stop()
        idx_dir = os.path.join(tmp, "idx")
        store = statestore.StateStore(idx_dir, name="index")
        store.append({"op": "probe"})
        store.close()
        out2, manifest2 = bundle(
            [url], out_path=os.path.join(tmp, "b2.tar.gz"),
            blackbox_dir=bb_dir, index_snapshot_dir=idx_dir,
        )
        segs = manifest2["blackbox"]["segments"]
        assert segs and segs[-1]["status"] == "clean", manifest2
        assert manifest2["blackbox"]["bundled_segment"] == (
            segs[-1]["name"]
        )
        assert manifest2["index_snapshot"]["files"], manifest2
        with tarfile.open(out2) as tar:
            names2 = set(tar.getnames())
        assert f"blackbox/{segs[-1]['name']}" in names2, names2
        return table
    finally:
        srv.stop()
        audit.install_engine(saved)
        metrics.AUDIT_FINDINGS.remove_matching(invariant="orphaned_chip")
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu-doctor",
        description="consistency-audit triage + support bundle "
        "(audit.py /debug/audit)",
    )
    p.add_argument(
        "--self-test", action="store_true",
        help="drive a synthetic drifted engine through /debug/audit, "
        "the renderer, and a bundle (CI smoke; exits non-zero on "
        "drift)",
    )
    sub = p.add_subparsers(dest="cmd")
    pc = sub.add_parser(
        "check", help="render live findings from /debug/audit"
    )
    pc.add_argument(
        "sources", nargs="*",
        help="audit.json files or '-' (offline input)",
    )
    pc.add_argument(
        "--url", action="append", default=[],
        help="daemon base URL (repeatable: plugin :2112 and extender "
        ":12346)",
    )
    pb = sub.add_parser(
        "bundle",
        help="collect /metrics + every /debug/* surface into one "
        "timestamped tar.gz",
    )
    pb.add_argument(
        "--url", action="append", default=[],
        help="daemon base URL (repeatable)",
    )
    pb.add_argument(
        "-o", "--output", default="",
        help="output path (default tpu-doctor-<utc>.tar.gz)",
    )
    pb.add_argument(
        "--journal-dir", default="",
        help="include admission-journal METADATA (sizes, seq, load "
        "status — never raw records) from this directory",
    )
    pb.add_argument(
        "--blackbox-dir", default="",
        help="include black-box segment METADATA (names, sizes, read "
        "statuses) plus the newest segment file from this directory",
    )
    pb.add_argument(
        "--index-snapshot-dir", default="",
        help="include topology-index snapshot METADATA (sizes, seq, "
        "load status) from this directory",
    )
    pp = sub.add_parser(
        "postmortem",
        help="reconstruct a dead daemon's final minutes from its "
        "black-box directory (exit 0 clean stop, 1 died mid-flight, "
        "2 nothing readable)",
    )
    pp.add_argument(
        "dir", help="the daemon's --blackbox-dir directory"
    )
    pp.add_argument(
        "--minutes", type=float, default=10.0,
        help="window before the last record to reconstruct "
        "(default 10)",
    )
    pp.add_argument(
        "--service", default="",
        help="only read segments written by this service "
        "(plugin/extender; default: all)",
    )
    pd = sub.add_parser(
        "drain",
        help="evacuate every resident gang off a node via the "
        "extender's rescue plane (cordon + maintenance taint, "
        "journaled two-phase evacuations), poll until zero resident "
        "pods and zero reserved chips, then report it safe for "
        "maintenance; --uncordon reverses",
    )
    pd.add_argument("node", help="node name to drain")
    pd.add_argument(
        "--url", required=True,
        help="extender base URL, e.g. http://extender:12346",
    )
    pd.add_argument(
        "--uncordon", action="store_true",
        help="reverse a drain: remove the cordon, taint, and "
        "drain-complete annotation",
    )
    pd.add_argument(
        "--no-wait", action="store_true",
        help="start (or check) the drain and exit without polling",
    )
    pd.add_argument(
        "--poll-s", type=float, default=5.0,
        help="seconds between status polls (default 5)",
    )
    pd.add_argument(
        "--timeout-s", type=float, default=1800.0,
        help="give up polling after this many seconds (default 1800)",
    )
    pf = sub.add_parser(
        "fleet",
        help="discover every extender shard (Leases) + plugin (node "
        "list) and aggregate /debug/audit, readiness, degraded state, "
        "and build skew into one table (exit 0 healthy, 1 findings/"
        "degraded/skew, 2 unreachable)",
    )
    pf.add_argument(
        "--url", action="append", default=[],
        help="extra endpoint base URL (repeatable; added to "
        "discovery)",
    )
    pf.add_argument(
        "--kubeconfig", default="",
        help="kubeconfig for discovery (default: in-cluster / "
        "$KUBECONFIG)",
    )
    pf.add_argument(
        "--lease-namespace", default="kube-system",
        help="namespace of the extender shard Leases",
    )
    pf.add_argument(
        "--extender-port", type=int, default=12346,
        help="extender HTTP port for discovered shard holders",
    )
    pf.add_argument(
        "--plugin-port", type=int, default=2112,
        help="plugin metrics port for discovered nodes",
    )
    pf.add_argument(
        "--no-discover", action="store_true",
        help="skip apiserver discovery; probe only --url endpoints",
    )
    a = p.parse_args(argv)
    if a.self_test:
        print(_self_test())
        print("tpu-doctor self-test: OK")
        return 0
    if a.cmd == "check":
        sources = list(a.url) + list(a.sources)
        if not sources:
            pc.error("at least one --url or audit.json file is required")
        return check(sources)
    if a.cmd == "drain":
        return drain(a.url, a.node, uncordon=a.uncordon, wait=not a.no_wait,
                     poll_s=a.poll_s, timeout_s=a.timeout_s)
    if a.cmd == "postmortem":
        return postmortem(
            a.dir, minutes=a.minutes, service=a.service
        )
    if a.cmd == "fleet":
        return fleet(
            list(a.url),
            kubeconfig=a.kubeconfig,
            lease_namespace=a.lease_namespace,
            extender_port=a.extender_port,
            plugin_port=a.plugin_port,
            discover=not a.no_discover,
        )
    if a.cmd == "bundle":
        if not a.url:
            pb.error("at least one --url is required")
        try:
            out, manifest = bundle(
                a.url, out_path=a.output, journal_dir=a.journal_dir,
                blackbox_dir=a.blackbox_dir,
                index_snapshot_dir=a.index_snapshot_dir,
            )
        except OSError as e:
            print(f"tpu-doctor: {e}", file=sys.stderr)
            return 2
        collected = sum(
            1
            for s in manifest["sources"]
            for v in s["files"].values()
            if v == "ok"
        )
        failed = sum(
            1
            for s in manifest["sources"]
            for v in s["files"].values()
            if v != "ok"
        )
        print(
            f"wrote {out}: {collected} file(s) from "
            f"{len(manifest['sources'])} daemon(s)"
            + (f", {failed} surface(s) unreachable" if failed else "")
        )
        return 0
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
