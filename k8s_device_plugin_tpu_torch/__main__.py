"""Entry point of the node daemon: python -m k8s_device_plugin_tpu_torch [flags]."""

import sys

from .supervisor.main import main

if __name__ == "__main__":
    sys.exit(main())
