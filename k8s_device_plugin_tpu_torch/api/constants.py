"""Device-plugin protocol constants: the names of the JAX package's
``api/constants.py`` that the port's node daemon reads, with NVIDIA values
where the two differ. The extender-only names come with its plane; the DRA
plane's live in ``dra/``."""

# Protocol version spoken over the Registration/DevicePlugin services.
VERSION = "v1beta1"

# Directory the kubelet serves its registration socket from and watches for
# plugin sockets. Mounted into the DaemonSet pod via hostPath.
DEVICE_PLUGIN_PATH = "/var/lib/kubelet/device-plugins/"

# The kubelet's own registration socket (relative to DEVICE_PLUGIN_PATH).
KUBELET_SOCKET_NAME = "kubelet.sock"

# Kubelet device-manager checkpoint file (read-only to us); the reference
# reads it at controller.go:184-197.
KUBELET_CHECKPOINT = DEVICE_PLUGIN_PATH + "kubelet_internal_checkpoint"

# Kubelet PodResources API socket (podresources/v1, GA in k8s 1.28), which
# the controller prefers over the checkpoint file above.
POD_RESOURCES_PATH = "/var/lib/kubelet/pod-resources/"
POD_RESOURCES_SOCKET = POD_RESOURCES_PATH + "kubelet.sock"

# This plugin's socket (relative to DEVICE_PLUGIN_PATH): the name NVIDIA's
# own device plugin serves under (the reference's was nvidia-topo.sock,
# server.go:31, for its nvidia.com/gpu-topo resource).
PLUGIN_SOCKET_NAME = "nvidia-gpu.sock"

# Extended resource advertised to the kubelet: the name NVIDIA's plugin
# and every GPU pod spec use. The reference advertised "nvidia.com/gpu-topo"
# (server.go:30); --resource-name sets it.
RESOURCE_NAME = "nvidia.com/gpu"

# Device health states (kubelet contract).
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

# Pod annotation carrying the real card assignment (the cards' UUIDs), as
# the JAX plugin's "google.com/tpu-devices" does; the reference used
# "nvidia.com/gpu-topo" for it (server.go:199).
POD_DEVICES_ANNOTATION = "nvidia.com/gpu-devices"

# Node annotation carrying the node's cards and their links
# (topology/schema.py), read by a scheduler extender: the JAX plugin's
# "google.com/tpu-topology"; the reference used "nvidia.com/gpu-topo" for it
# (server.go:296).
TOPOLOGY_ANNOTATION = "nvidia.com/gpu-topology"

# Node labels of NVIDIA GPU Feature Discovery, which scheduling already
# selects on: the card's product name and the node's card count (the JAX
# plugin labels "google.com/tpu-topology" and "google.com/tpu-accelerator").
PRODUCT_LABEL = "nvidia.com/gpu.product"
COUNT_LABEL = "nvidia.com/gpu.count"

# The scheduler extender's pod vocabulary, which the controller reads: the
# allocation trace carrier, the gang admitter's release stamp and the gang
# label. The extender is the JAX package's, so these are its keys.
TRACE_ANNOTATION = "tpu.google.com/trace-context"
ADMIT_TS_ANNOTATION = "tpu.google.com/admitted-at"
GANG_NAME_LABEL = "tpu.google.com/gang-name"

# The container env the NVIDIA container runtime reads to inject the
# allocated cards, the NVIDIA driver's libraries and the node-level
# device nodes (the reference's server.go:196-198).
NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"

# The NVIDIA driver's node-level control device, which every CUDA process
# opens beside its cards' /dev/nvidia<minor>.
NVIDIACTL = "nvidiactl"

# Understood as the reference's DP_DISABLE_HEALTHCHECKS: a comma-separated
# list of check classes to disable. Classes: "all", "events" (the XID
# event wait; "xids", the reference's spelling, is an alias), "interval"
# (periodic sweeps). See health/watcher.py.
ENV_DISABLE_HEALTHCHECKS = "DP_DISABLE_HEALTHCHECKS"

# Override of the app-level fault-reason skip list (the reference's XID
# 31/43/45 skip). Comma-separated reason tokens; see health/watcher.py
# DEFAULT_APP_FAULT_REASONS for the default.
ENV_APP_FAULT_REASONS = "DP_APP_FAULT_REASONS"
