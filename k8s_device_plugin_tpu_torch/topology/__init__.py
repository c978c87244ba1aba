"""How the node's cards are linked (``links.py``), which of them a request
gets (``placement.py``), and the node annotation that tells a scheduler
both (``schema.py``)."""
