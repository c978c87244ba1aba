"""The node's card health watcher (``watcher.py``)."""
