"""The node daemon's Kubernetes side: the REST client (``client.py``) and the
kubelet's two records of which devices each pod holds, the PodResources API
(``podresources.py``) and the device manager's checkpoint file
(``checkpoint.py``)."""
