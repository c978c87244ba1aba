"""tpu-defrag: the defragmentation what-if CLI, an alias.

The implementation lives with the plane it renders (``extender/defrag.py``:
the engine, the /debug/defrag surface and the renderers share one module,
so they cannot drift apart); this alias gives it the address of the rest of
the operator's tools (tputop, explain, doctor, flame).

    python -m k8s_device_plugin_tpu_torch.tools.defrag status --url http://extender:12346
    python -m k8s_device_plugin_tpu_torch.tools.defrag plan --url http://extender:12346
    python -m k8s_device_plugin_tpu_torch.tools.defrag --self-test
"""

from ..extender.defrag import main

if __name__ == "__main__":
    import sys

    sys.exit(main())
