"""The node's cards as the daemon sees them: the NVML shim (``nvml.py``),
the card model (``chips.py``) and the scanner (``scanner.py``)."""
