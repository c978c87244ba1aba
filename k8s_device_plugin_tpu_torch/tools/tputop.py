"""tputop: the live per-card, per-pod telemetry table of a metrics scrape.

One command answers "which pod is cooking which card" from the node
daemon's Prometheus endpoint, with no SSH and no ``kubectl exec``. It reads
the ``tpu_chip_*`` and ``tpu_node_*`` families the port's telemetry
sampler exports (``telemetry.py``; the port keeps the JAX family names)
and renders:

* a node header: free cards, the best set score the placement would reach
  for each request size (``tpu_node_best_set_score{size}``), and which
  request sizes place now;
* one row per card: holder (namespace/pod, container, gang), duty cycle,
  device memory used (and its share of the card's total where known),
  temperature, power, and the NVLinks' state (up/down counts and
  accumulated errors; ``tpu_chip_ici_link_up`` carries a card's NVLinks);
* a defragmentation footer (stranded sizes, eviction budget left,
  plan/migration/abort tallies) when the scrape holds the extender's
  ``tpu_extender_stranded_demand``/``tpu_extender_defrag_*`` families (cat
  the extender's /metrics after the node daemon's, or point ``--url`` at
  the extender). The port's extender exports them (``extender/defrag.py``);
  the parsing is the JAX tool's.

Usage::

    python -m k8s_device_plugin_tpu_torch.tools.tputop --url http://node:2112
    curl -s node:2112/metrics | python -m k8s_device_plugin_tpu_torch.tools.tputop -
    python -m k8s_device_plugin_tpu_torch.tools.tputop scrape.txt
    python -m k8s_device_plugin_tpu_torch.tools.tputop --url ... --watch 5
    python -m k8s_device_plugin_tpu_torch.tools.tputop --self-test

``--self-test`` drives the port's pipeline end to end in-process: a backend
defined here answers ``chip_telemetry`` (and ``pair_link``) over a few fixed
cards as ``NvmlInfo`` does, the sampler joins a synthetic pod and gang, the
registry renders its text, and this parser renders the table.

The verbs, flags, exit codes and output are the JAX package's
``tools/tputop.py`` but two: the node header shows ``best_set_score=``
where the JAX tool shows ``largest_box=`` and ``fragmentation=``, and the
link column is headed ``NVLINK`` instead of ``ICI``.
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, List, Optional, Tuple

GIB = 1024**3

# One sample line of the Prometheus text exposition.
_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+\S+)?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

CHIP_PREFIX = "tpu_chip_"
NODE_PREFIX = "tpu_node_"
# The JAX extender's defragmentation families, kept by the parser so a
# scrape that includes such an extender's /metrics grows the footer.
DEFRAG_FAMILIES = frozenset({
    "tpu_extender_stranded_demand",
    "tpu_extender_defrag_plans_total",
    "tpu_extender_defrag_migrations_total",
    "tpu_extender_defrag_aborted_total",
    "tpu_extender_defrag_budget_remaining",
})


def parse_metrics(text: str) -> Dict[str, List[Tuple[dict, float]]]:
    """family name -> [(labels, value)] for every tpu_chip_*/tpu_node_*
    sample of a text-exposition scrape. An unparsable line or another
    family is skipped, not fatal: the scrape carries dozens of others."""
    out: Dict[str, List[Tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, raw_labels, raw_value = m.groups()
        if not (name.startswith(CHIP_PREFIX) or name.startswith(NODE_PREFIX)
                or name in DEFRAG_FAMILIES):
            continue
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = dict(_LABEL_RE.findall(raw_labels or ""))
        out.setdefault(name, []).append((labels, value))
    return out


def _fmt_bytes(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v >= GIB:
        return f"{v / GIB:.1f}Gi"
    return f"{v / 1024**2:.0f}Mi"


def _chip_rows(families: Dict[str, List[Tuple[dict, float]]]) -> List[dict]:
    """Fold the per-card families into one row dict per card."""
    rows: Dict[str, dict] = {}

    def row(labels: dict) -> dict:
        chip = labels.get("chip", "?")
        r = rows.setdefault(chip, {
            "chip": chip, "pod": "", "namespace": "", "container": "", "gang": "",
            "duty": None, "hbm": None, "hbm_ratio": None, "temp": None, "power": None,
            "links_up": 0, "links_down": 0, "link_errors": 0,
        })
        for k in ("pod", "namespace", "container", "gang"):
            if labels.get(k):
                r[k] = labels[k]
        return r

    scalar = {
        "tpu_chip_duty_cycle": "duty",
        "tpu_chip_hbm_used_bytes": "hbm",
        "tpu_chip_hbm_used_ratio": "hbm_ratio",
        "tpu_chip_temperature_celsius": "temp",
        "tpu_chip_power_watts": "power",
    }
    for fam, field in scalar.items():
        for labels, value in families.get(fam, ()):
            if "chip" not in labels:
                continue  # the empty family's "fam 0" placeholder
            row(labels)[field] = value
    for labels, value in families.get("tpu_chip_ici_link_up", ()):
        if "chip" not in labels:
            continue
        r = row(labels)
        r["links_up" if value else "links_down"] += 1
    for labels, value in families.get("tpu_chip_ici_link_errors_total", ()):
        if "chip" not in labels:
            continue
        row(labels)["link_errors"] += int(value)
    return [rows[c] for c in sorted(rows)]


def _node_line(families: Dict[str, List[Tuple[dict, float]]]) -> str:
    free = next((value for labels, value in families.get("tpu_node_free_chips", ())
                 if not labels), None)
    scores = sorted((int(labels["size"]), value)
                    for labels, value in families.get("tpu_node_best_set_score", ())
                    if labels.get("size", "").isdigit())
    placeable = sorted(int(labels["size"])
                       for labels, value in families.get("tpu_node_box_placeable", ())
                       if value and labels.get("size", "").isdigit())
    parts = []
    if free is not None:
        parts.append(f"free={free:.0f}")
    if scores:
        parts.append("best_set_score=" + ",".join(f"{n}:{v:.2f}" for n, v in scores))
    if placeable:
        parts.append("placeable=" + ",".join(str(n) for n in placeable))
    return "node: " + (" ".join(parts) if parts else "no capacity gauges")


def _defrag_footer(families: Dict[str, List[Tuple[dict, float]]]) -> Optional[str]:
    """The stranded-demand/defragmentation footer, present only when the
    scrape carries a labelled sample of a defrag family (it includes an
    extender's /metrics): sizes stranded now, eviction budget left, and the
    plan/migration/abort tallies."""
    # Only labelled samples are real: an empty family renders an unlabelled
    # "<fam> 0" placeholder, and a footer built from those would read
    # "budget 0/h" (gate closed) on an extender that runs no defrag.
    if not any(labels for f in DEFRAG_FAMILIES for labels, _ in families.get(f, ())):
        return None

    def tally(fam: str, label: str) -> List[str]:
        # Summed across the other labels (a sharded extender exports one
        # series per shard), the unlabelled placeholder skipped.
        agg: Dict[str, float] = {}
        for labels, value in families.get(fam, ()):
            if label not in labels or not value:
                continue
            agg[labels[label]] = agg.get(labels[label], 0) + value
        return [f"{k}×{v:.0f}" for k, v in sorted(agg.items())]

    parts = []
    stranded = tally("tpu_extender_stranded_demand", "size")
    parts.append("stranded " + (" ".join(f"size={s}" for s in stranded) if stranded else "none"))
    budget = [(labels, v)
              for labels, v in families.get("tpu_extender_defrag_budget_remaining", ())
              if "shard" in labels]  # the empty family's placeholder skipped
    if budget:
        # Summed across shards ("" is the unsharded singleton).
        parts.append(f"budget {sum(v for _, v in budget):.0f} eviction(s) left/h")
    plans = tally("tpu_extender_defrag_plans_total", "outcome")
    if plans:
        parts.append("plans " + " ".join(plans))
    migrated = tally("tpu_extender_defrag_migrations_total", "victim_tier")
    if migrated:
        parts.append("migrated " + " ".join(migrated))
    aborted = tally("tpu_extender_defrag_aborted_total", "reason")
    if aborted:
        parts.append("aborted " + " ".join(aborted))
    return "defrag: " + " | ".join(parts)


def render(text: str) -> str:
    """The table of one scrape; ValueError when the scrape has no
    tpu_chip_*/tpu_node_* sample at all (the wrong endpoint)."""
    families = parse_metrics(text)
    if not families:
        raise ValueError(
            "no tpu_chip_*/tpu_node_* samples in the input — is this "
            "the device-plugin daemon's /metrics (and is "
            "--telemetry-interval-s set)?"
        )
    rows = _chip_rows(families)
    out = [_node_line(families)]
    header = (
        f"{'CHIP':<22} {'POD':<28} {'CONTAINER':<12} {'GANG':<14} "
        f"{'DUTY%':>6} {'HBM':>14} {'TEMP':>7} {'PWR':>7} {'NVLINK':>12}"
    )
    out.append(header)
    out.append("-" * len(header))
    for r in rows:
        pod = f"{r['namespace']}/{r['pod']}" if r["pod"] else "-"
        hbm = _fmt_bytes(r["hbm"])
        if r["hbm_ratio"] is not None:
            hbm += f" ({r['hbm_ratio'] * 100:.0f}%)"
        links = "-"
        if r["links_up"] or r["links_down"]:
            links = f"{r['links_up']}up/{r['links_down']}dn"
            if r["link_errors"]:
                links += f" e{r['link_errors']}"
        out.append(
            f"{r['chip']:<22} {pod:<28} "
            f"{r['container'] or '-':<12} {r['gang'] or '-':<14} "
            f"{('%.0f' % r['duty']) if r['duty'] is not None else '-':>6} "
            f"{hbm:>14} "
            f"{('%.1fC' % r['temp']) if r['temp'] is not None else '-':>7} "
            f"{('%.0fW' % r['power']) if r['power'] is not None else '-':>7} "
            f"{links:>12}"
        )
    if not rows:
        out.append("(no per-chip series — sampler off or no chips)")
    footer = _defrag_footer(families)
    if footer is not None:
        out.append(footer)
    return "\n".join(out)


def _fetch(url: str) -> str:
    import urllib.request

    target = url.rstrip("/")
    if not target.endswith("/metrics"):
        target += "/metrics"
    with urllib.request.urlopen(target, timeout=10) as resp:
        return resp.read().decode(errors="replace")


class _SelfTestBackend:
    """Answers the two calls the sampler and ``LinkTopology`` make of
    ``NvmlInfo`` over four fixed cards: ``chip_telemetry(root, index)`` the
    way ``TelemetrySampler.poll_once`` calls it, and ``pair_link(a, b)``
    with NVLinks joining 0-1, 0-2, 1-3 and 2-3 (two each) and nothing
    between the others."""

    LINKED = {(0, 1), (0, 2), (1, 3), (2, 3)}

    def chip_telemetry(self, sysfs_pci_dir: str, index: int):
        from ..discovery.chips import ChipTelemetry, IciLinkTelemetry

        return ChipTelemetry(
            index=index, duty_cycle_pct=40.0 + index, hbm_used_bytes=20 * GIB, temp_c=61.5,
            power_w=312.0,
            links=(IciLinkTelemetry(link=0, up=True, errors=2),
                   IciLinkTelemetry(link=1, up=index != 3, errors=0)))

    def pair_link(self, a: int, b: int):
        return (2 if (min(a, b), max(a, b)) in self.LINKED else 0), None


def _self_test() -> str:
    """The backend above -> the sampler -> the registry's text -> this
    parser. Returns the rendered table; AssertionError on any drift. Every
    series it wrote is removed and the node gauges are put back."""
    from .. import telemetry
    from ..discovery.chips import GpuChip
    from ..topology.links import LinkTopology
    from ..topology.placement import GpuPlacementState
    from ..utils import metrics

    chips = [GpuChip(index=i, uuid=f"GPU-tputop-selftest-{i}", name="NVIDIA H100 80GB HBM3",
                     dev_path=f"/dev/nvidia{i}", pci_addr="", numa_node=0, chip_type="h100",
                     hbm_bytes=80 * GIB) for i in range(4)]
    ids = [c.device_id_str for c in chips]
    node_families = (metrics.NODE_FREE_CHIPS, metrics.NODE_BOX_PLACEABLE,
                     metrics.NODE_BEST_SET_SCORE)
    saved = [fam.series() for fam in node_families]
    saved_stats = telemetry.NODE_STATS
    try:
        backend = _SelfTestBackend()
        holder = {ids[0]: {"pod": "train-w0", "namespace": "ml", "container": "main",
                           "gang": "train"}}
        sampler = telemetry.TelemetrySampler(backend, "", chips, attribution=lambda: holder)
        sampler.poll_once()
        telemetry.update_node_gauges(GpuPlacementState(LinkTopology(chips, backend)), ids[1:])
        table = render(metrics.REGISTRY.render())
        assert "ml/train-w0" in table, table
        assert "train" in table and "main" in table
        assert "40" in table and "61.5C" in table and "312W" in table
        assert "20.0Gi (25%)" in table, table
        assert "2up/0dn" in table and "1up/1dn" in table, table
        assert "e2" not in table  # first sight is the baseline: no errors
        assert "free=3" in table and "best_set_score=2:5.00,3:3.33" in table, table
        assert "placeable=1,2,3" in table, table
        # A plugin-only scrape carries no defrag footer.
        assert "defrag:" not in table, table
        # The footer over a merged scrape: the node daemon's text, then an
        # extender's defrag families (the JAX extender's names, which the
        # port's extender exports too).
        merged = render(metrics.REGISTRY.render() + "\n" + "\n".join((
            "# TYPE tpu_extender_stranded_demand gauge",
            'tpu_extender_stranded_demand{shard="",size="4"} 1',
            "# TYPE tpu_extender_defrag_budget_remaining gauge",
            'tpu_extender_defrag_budget_remaining{shard=""} 10',
            'tpu_extender_defrag_plans_total{outcome="executed"} 1',
            'tpu_extender_defrag_migrations_total{victim_tier="batch"} 1',
            'tpu_extender_defrag_aborted_total{reason="eviction_blocked"} 1',
        )))
        footer = merged.splitlines()[-1]
        assert footer == ("defrag: stranded size=4×1 | budget 10 eviction(s) left/h | "
                          "plans executed×1 | migrated batch×1 | aborted eviction_blocked×1"), \
            footer
        return table
    finally:
        for fam in telemetry.CHIP_FAMILIES:
            for cid in ids:
                fam.remove_matching(chip=cid)
        for fam, series in zip(node_families, saved):
            fam.remove_matching()
            for labels, value in series:
                fam.set(value, **labels)
        telemetry.NODE_STATS = saved_stats


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tputop",
        description="per-chip/per-pod telemetry table from a device-plugin /metrics scrape",
    )
    p.add_argument("path", nargs="?", help="scrape file, or '-' for stdin (alternative to --url)")
    p.add_argument("--url", help="daemon metrics endpoint, e.g. http://node:2112 "
                   "(/metrics is appended when missing)")
    p.add_argument("--watch", type=float, default=0,
                   help="re-fetch and re-render every N seconds (with --url)")
    p.add_argument("--self-test", action="store_true",
                   help="drive a fixed backend through the sampler and this renderer "
                   "(CI smoke; exits non-zero on drift)")
    a = p.parse_args(argv)
    if a.self_test:
        print(_self_test())
        print("tputop self-test: OK")
        return 0
    try:
        if a.url and a.watch > 0:
            import time as _time

            while True:
                print("\x1b[2J\x1b[H" + render(_fetch(a.url)), flush=True)
                _time.sleep(a.watch)
        if a.url:
            text = _fetch(a.url)
        elif a.path == "-":
            text = sys.stdin.read()
        elif a.path:
            with open(a.path) as f:
                text = f.read()
        else:
            p.error("a scrape source is required: --url, a file, or '-'")
        print(render(text))
        return 0
    except KeyboardInterrupt:
        return 130
    except (OSError, ValueError) as e:
        print(f"tputop: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
