"""Debug CLI: print the node's card tree, the counterpart of the JAX
package's ``tools/topo.py``.

The reference's ``printDeviceTree`` debug output (main.go:70-72,
topology.go:100-112): what the daemon discovers and how it scores a
placement, from a live NVML scan or from a published
``nvidia.com/gpu-topology`` annotation. Each card is shown by its NVML
index, UUID, minor, NUMA node and bus, then every pair's link class (as
``nvidia-smi topo -m`` prints it) and score; ``--select N`` shows the N
cards the placement policy picks now; ``--cdi-dir`` adds the DRA claims
prepared on the node, read from their CDI specs.

    python -m k8s_device_plugin_tpu_torch.tools.topo
    python -m k8s_device_plugin_tpu_torch.tools.topo --from-json topo.json --select 2
    python -m k8s_device_plugin_tpu_torch.tools.topo --cdi-dir /var/run/cdi
"""

from __future__ import annotations

import argparse
import json
import sys

from ..discovery.scanner import DEFAULT_DEV, DEFAULT_SYSFS_PCI, get_backend
from ..topology.links import LinkTopology
from ..topology.placement import GpuPlacementState
from ..topology.schema import NodeTopology, minor_of


def render_topology(topology: LinkTopology, available=None) -> str:
    chips = sorted(topology.chips, key=lambda c: c.index)
    avail = set(available) if available is not None else set(topology.ids)
    first = chips[0] if chips else None
    lines = [f"cards: {len(chips)}  {first.name if first else '-'} "
             f"({first.chip_type if first else '-'})"]
    for c in chips:
        mark = " " if c.device_id_str in avail else "*"
        neigh = ", ".join(f"gpu{topology.by_id[n].index}"
                          for n in topology.neighbors(c.device_id_str))
        lines.append(f" {mark}gpu{c.index} {c.device_id_str} minor={minor_of(c.dev_path)} "
                     f"numa={c.numa_node} pci={c.pci_addr or '-'} "
                     f"hbm={c.hbm_bytes / 2 ** 30:.1f}GiB nvlink-peers=[{neigh}]")
    lines.append("  (* = allocated/unhealthy)")
    if len(chips) > 1:
        lines.append("links (class/score):")
        lines.append("        " + "".join(f"{'gpu%d' % c.index:>9}" for c in chips))
        for a in chips:
            cells = []
            for b in chips:
                cls = topology.link_class(a.device_id_str, b.device_id_str)
                if a is not b:
                    cls += f"/{topology.score_pair(a.device_id_str, b.device_id_str)}"
                cells.append(f"{cls:>9}")
            lines.append(f"  {'gpu%d' % a.index:<6}" + "".join(cells))
    return "\n".join(lines)


def _read_claims(cdi_dir: str, topology: LinkTopology) -> list:
    """The DRA claims prepared on the node, from a CDI spec dir, as dicts
    for both the text and the JSON output."""
    from ..dra.cdi import CdiRegistry, spec_chip_ids, spec_claim_ref

    reg = CdiRegistry(cdi_dir)
    out = []
    for uid in reg.list_claim_uids():
        spec = reg.read_claim_spec(uid)
        ref = spec_claim_ref(spec)
        ids = spec_chip_ids(spec)
        out.append({
            "uid": uid,
            "namespace": ref[0] if ref else "",
            "name": ref[1] if ref else "",
            "chip_ids": ids,
            "chip_indexes": [topology.by_id[i].index for i in ids if i in topology.by_id],
            "cdi_id": reg.claim_device_id(uid),
        })
    return out


def render_claims(claims: list, cdi_dir: str) -> str:
    lines = [f"DRA: {len(claims)} prepared claim(s) in {cdi_dir}"]
    for c in claims:
        label = f"{c['namespace']}/{c['name']}" if c.get("name") else c["uid"]
        lines.append(f"  claim {label}: cards {c['chip_indexes'] or c['chip_ids']}  "
                     f"cdi={c['cdi_id']}")
    return "\n".join(lines)


def render_select(topology: LinkTopology, n: int, available=None) -> str:
    state = GpuPlacementState(topology)
    if available is not None:
        state.reset(allocated=set(topology.ids) - set(available))
    picked = state.select(n)
    indexes = sorted(topology.by_id[i].index for i in picked) if picked else "none"
    return (f"select({n}) -> {indexes}  "
            f"nvlink-pairs={topology.internal_links(picked) if picked else 0}  "
            f"avg-score={topology.set_score(picked) if picked else 0:.1f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nvidia-topo")
    p.add_argument("--sysfs", default=DEFAULT_SYSFS_PCI,
                   help="sysfs PCI devices dir, where each card's NUMA node is read")
    p.add_argument("--dev", default=DEFAULT_DEV)
    p.add_argument("--from-json", default="",
                   help="render a published node-topology JSON instead")
    p.add_argument("--select", type=int, default=0, metavar="N",
                   help="also show which N cards the placement policy picks")
    p.add_argument("--json", action="store_true",
                   help="emit the NodeTopology JSON instead of text")
    p.add_argument("--cdi-dir", default="",
                   help="also render the prepared DRA claims from this CDI spec dir "
                   "(e.g. /var/run/cdi)")
    a = p.parse_args(argv)

    available = None
    extra = []
    if a.from_json:
        with open(a.from_json) as f:
            topo = NodeTopology.from_json(f.read())
        topology = topo.to_topology()
        available = topo.available
        if topo.host:
            h = topo.host
            extra.append(f"host: {h.get('cpu_count', 0)} cpus / {h.get('cpu_sockets', 0)} "
                         f"sockets, {h.get('mem_total_bytes', 0) // (1 << 30)} GiB — "
                         f"{h.get('cpu_model', '')}")
    else:
        backend = get_backend()
        try:
            chips = backend.scan(a.sysfs, a.dev)
            if not chips:
                print("no NVIDIA cards found (no NVML, or a node without cards)",
                      file=sys.stderr)
                return 1
            topology = LinkTopology(chips, backend)
        finally:
            backend.close()

    claims = _read_claims(a.cdi_dir, topology) if a.cdi_dir else None

    if a.json:
        topo_json = json.loads(NodeTopology.from_topology(topology, available=available).to_json())
        # --cdi-dir composes into the JSON too, so a script never loses the
        # claims silently.
        print(json.dumps(topo_json if claims is None
                         else {"topology": topo_json, "dra_claims": claims}))
        return 0

    print(render_topology(topology, available))
    for line in extra:
        print(line)
    if claims is not None:
        print()
        print(render_claims(claims, a.cdi_dir))
    if a.select:
        print()
        print(render_select(topology, a.select, available))
    return 0


if __name__ == "__main__":
    sys.exit(main())
