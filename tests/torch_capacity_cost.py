"""Times the port plugin's ``Allocate`` and free path on fake-NVML nodes,
on the CPU, and the capacity gauges' search where a read runs it
(``telemetry.refresh_node_gauges``, on a tree that has it). One card is
allocated on an idle node, then freed, ``--reps`` times; then the gauges
of the idle node are marked changed and read, ``--reps`` times (in a loop
of their own: the read's arrays would leave the next RPC's caches cold).
The medians are printed as one JSON line a node.

Nodes: an 8-card HGX H100 node (``hgx_node``: every pair over NVSwitch,
so every set of a size ties on score) and a 16-card node whose every pair
has a direct NVLink (``grid_node``), the most sets a node can hold.

    python -m tests.torch_capacity_cost [--reps 200] [--root DIR]

``--root DIR`` imports the port from another checkout (a parent commit)
so that both trees are timed by the same script on the same host. The
fake library is built with ``cc`` into a temporary directory.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import tempfile
import time

from tests import torch_fake_nvml as fk


def node(fake, sysfs, cards: int) -> None:
    if cards == 8:
        fk.hgx_node(fake, sysfs, 8, numa=(0, 0, 0, 0, 1, 1, 1, 1))
    else:
        fk.grid_node(fake, sysfs, cards, list(itertools.combinations(range(cards), 2)),
                     nvlinks=1)


def time_node(fake, work: str, cards: int, reps: int) -> dict:
    from k8s_device_plugin_tpu_torch.api import deviceplugin_pb2 as pb
    from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
    from k8s_device_plugin_tpu_torch.server.plugin import GpuDevicePlugin, PluginConfig
    from k8s_device_plugin_tpu_torch.topology.links import LinkTopology

    fake.reset()
    sysfs, dev = os.path.join(work, f"sys{cards}"), os.path.join(work, "dev")
    node(fake, sysfs, cards)
    with NvmlInfo(fake.path) as info:
        topo = LinkTopology(info.scan(sysfs, dev), info)
    plugin = GpuDevicePlugin(topo, config=PluginConfig(device_plugin_dir=work))
    card = topo.ids[0]
    try:
        from k8s_device_plugin_tpu_torch.telemetry import refresh_node_gauges as refresh
    except ImportError:  # a tree from before the gauges were read lazily
        refresh = None
    allocate, free, read = [], [], []
    for _ in range(reps):
        req = pb.AllocateRequest()
        req.container_requests.add().devicesIDs.append(card)
        t0 = time.perf_counter()
        resp = plugin.Allocate(req, None)
        t1 = time.perf_counter()
        plugin.free_devices(plugin.state.allocated)
        t2 = time.perf_counter()
        assert len(resp.container_responses) == 1 and not plugin.state.allocated
        allocate.append((t1 - t0) * 1e3)
        free.append((t2 - t1) * 1e3)
    for _ in range(reps if refresh is not None else 0):
        plugin._availability_changed()
        t0 = time.perf_counter()
        assert refresh()["free"] == cards
        read.append((time.perf_counter() - t0) * 1e3)
    return {"cards": cards, "reps": reps,
            "allocate_ms_median": statistics.median(allocate),
            "free_ms_median": statistics.median(free),
            "gauge_read_ms_median": statistics.median(read) if read else None}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--root", default=None,
                        help="import the port from this checkout instead")
    args = parser.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    with tempfile.TemporaryDirectory(prefix="capacity_cost_") as work:
        fake = fk.FakeNvml(fk.build(work))
        for cards in (8, 16):
            row = time_node(fake, work, cards, args.reps)
            row["port"] = args.root or "."
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
