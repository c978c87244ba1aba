"""tpu-simreport: scheduling-quality scorecards from trace replay.

Thin alias: ``python -m k8s_device_plugin_tpu_torch.tools.simreport``. The
implementation (trace loading, the deterministic replay through the real
admission, preemption, defragmentation and rescue stack, the golden
baseline's deltas and the /debug/simreport fetcher) lives in
``extender/simulator.py`` beside the stack it exercises.
"""

from ..extender.simulator import main

if __name__ == "__main__":
    import sys

    sys.exit(main())
