"""The DRA (resource.k8s.io) plane: the node's ResourceSlice
(``slices.py``), the per-claim CDI specs (``cdi.py``) and the kubelet's
DRAPlugin service (``driver.py``)."""
