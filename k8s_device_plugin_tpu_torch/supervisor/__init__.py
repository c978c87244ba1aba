"""The node daemon's process supervisor (``main.py``) and its fs and
signal watchers (``watchers.py``)."""
