"""One module a model family, named by a configuration's ``family`` key:
its sizes, weights, analytic FLOPs, the program's model at those sizes and
the family's plain reference."""

import importlib


def load(config: dict):
    """The module ``families/<family>.py`` of ``config``."""
    return importlib.import_module(f"gpubench.families.{config['family']}")
