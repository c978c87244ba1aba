"""How the node's cards are linked (``links.py``)."""
