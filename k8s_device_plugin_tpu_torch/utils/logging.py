"""The module-logger constructor of the JAX package's ``utils/logging.py``,
copied for the node layers of the port (discovery, health, topology). The
rest of that module (the JSON-lines bootstrap, the trace filter) comes with
the plugin server."""

from __future__ import annotations

import logging


def get_logger(name: str) -> logging.Logger:
    """The module-logger constructor every package module uses (in
    place of bare ``logging.getLogger``)."""
    return logging.getLogger(name)
