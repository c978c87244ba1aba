"""The kubelet-facing device-plugin server (``plugin.py``)."""
