"""The node daemon's kube plane: the pod controller (``controller.py``) and
the wiring that publishes the node's cards and health to the API server
and starts the controller on a running plugin (``wiring.py``)."""
