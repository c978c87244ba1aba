"""How the node's cards are linked (``links.py``) and which of them a
request gets (``placement.py``)."""
