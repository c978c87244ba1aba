"""The node daemon's constants (``constants.py``)."""
