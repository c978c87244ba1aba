"""The kubelet-facing API of the node daemon: the device-plugin v1beta1 and
plugin-registration messages and the kubelet's PodResources messages
(``deviceplugin_pb2.py``, ``pluginregistration_pb2.py``,
``podresources_pb2.py``, copies of the JAX package's), their gRPC
service wiring (``grpc_defs.py``) and the daemon's constants
(``constants.py``)."""
