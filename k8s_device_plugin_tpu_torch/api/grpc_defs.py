"""Hand-written gRPC service wiring for the device-plugin v1beta1 API: the
part of the JAX package's ``api/grpc_defs.py`` that the device-plugin
server and the pod controller use (the DevicePlugin, Registration,
plugin-watcher and kubelet PodResources services and their client stubs).
The DRA service comes with its plane.

grpcio ships the runtime but not protoc's gRPC code generator, so the
service descriptors that ``protoc --grpc_python_out`` would emit are
written here against grpc's generic-handler and multicallable APIs. The
message classes come from ``deviceplugin_pb2``, ``pluginregistration_pb2``
and ``podresources_pb2``.

Wire-compatible with the kubelet: the method paths are
"/v1beta1.Registration/Register" and "/v1beta1.DevicePlugin/<Method>", as
in the reference's vendored stubs (deviceplugin/v1beta1/api.pb.go).
"""

from __future__ import annotations

import grpc

from . import deviceplugin_pb2 as pb
from . import pluginregistration_pb2 as regpb
from . import podresources_pb2 as prpb

REGISTRATION_SERVICE = "v1beta1.Registration"
DEVICE_PLUGIN_SERVICE = "v1beta1.DevicePlugin"


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------

class RegistrationServicer:
    """Base class for the kubelet-side Registration service.

    Only a fake kubelet (tests) implements this; the real kubelet serves it.
    """

    def Register(self, request: pb.RegisterRequest, context) -> pb.Empty:
        raise NotImplementedError


class DevicePluginServicer:
    """Base class for the plugin-side DevicePlugin service."""

    def GetDevicePluginOptions(self, request: pb.Empty, context) -> pb.DevicePluginOptions:
        raise NotImplementedError

    def ListAndWatch(self, request: pb.Empty, context):
        raise NotImplementedError  # yields pb.ListAndWatchResponse

    def GetPreferredAllocation(
        self, request: pb.PreferredAllocationRequest, context
    ) -> pb.PreferredAllocationResponse:
        raise NotImplementedError

    def Allocate(self, request: pb.AllocateRequest, context) -> pb.AllocateResponse:
        raise NotImplementedError

    def PreStartContainer(
        self, request: pb.PreStartContainerRequest, context
    ) -> pb.PreStartContainerResponse:
        raise NotImplementedError


def add_registration_servicer(servicer: RegistrationServicer, server: grpc.Server) -> None:
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(REGISTRATION_SERVICE, handlers),)
    )


def add_device_plugin_servicer(servicer: DevicePluginServicer, server: grpc.Server) -> None:
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=pb.PreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=pb.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=pb.PreStartContainerResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(DEVICE_PLUGIN_SERVICE, handlers),)
    )


# ---------------------------------------------------------------------------
# Plugin-watcher registration (pluginregistration/v1) — the kubelet dials
# the PLUGIN for this one, so the plugin serves it and the (fake) kubelet
# consumes the stub.
# ---------------------------------------------------------------------------

WATCHER_REGISTRATION_SERVICE = "pluginregistration.Registration"


class WatcherRegistrationServicer:
    """Base class for the plugin-side watcher Registration service."""

    def GetInfo(self, request: regpb.InfoRequest, context) -> regpb.PluginInfo:
        raise NotImplementedError

    def NotifyRegistrationStatus(
        self, request: regpb.RegistrationStatus, context
    ) -> regpb.RegistrationStatusResponse:
        raise NotImplementedError


def add_watcher_registration_servicer(
    servicer: WatcherRegistrationServicer, server: grpc.Server
) -> None:
    handlers = {
        "GetInfo": grpc.unary_unary_rpc_method_handler(
            servicer.GetInfo,
            request_deserializer=regpb.InfoRequest.FromString,
            response_serializer=regpb.PluginInfo.SerializeToString,
        ),
        "NotifyRegistrationStatus": grpc.unary_unary_rpc_method_handler(
            servicer.NotifyRegistrationStatus,
            request_deserializer=regpb.RegistrationStatus.FromString,
            response_serializer=(
                regpb.RegistrationStatusResponse.SerializeToString
            ),
        ),
    }
    server.add_generic_rpc_handlers(
        (
            grpc.method_handlers_generic_handler(
                WATCHER_REGISTRATION_SERVICE, handlers
            ),
        )
    )


class WatcherRegistrationStub:
    """Client for the plugin's watcher Registration service (kubelet →
    plugin; used by the fake kubelet watcher in tests)."""

    def __init__(self, channel: grpc.Channel):
        self.GetInfo = channel.unary_unary(
            f"/{WATCHER_REGISTRATION_SERVICE}/GetInfo",
            request_serializer=regpb.InfoRequest.SerializeToString,
            response_deserializer=regpb.PluginInfo.FromString,
        )
        self.NotifyRegistrationStatus = channel.unary_unary(
            f"/{WATCHER_REGISTRATION_SERVICE}/NotifyRegistrationStatus",
            request_serializer=regpb.RegistrationStatus.SerializeToString,
            response_deserializer=(
                regpb.RegistrationStatusResponse.FromString
            ),
        )


# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------

class RegistrationStub:
    """Client for the kubelet's Registration service (plugin → kubelet)."""

    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            f"/{REGISTRATION_SERVICE}/Register",
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString,
        )


class DevicePluginStub:
    """Client for the plugin's DevicePlugin service (kubelet/tests → plugin)."""

    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{DEVICE_PLUGIN_SERVICE}/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/GetPreferredAllocation",
            request_serializer=pb.PreferredAllocationRequest.SerializeToString,
            response_deserializer=pb.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString,
        )


# ---------------------------------------------------------------------------
# Kubelet PodResources API (podresources/v1): the kubelet serves this on
# /var/lib/kubelet/pod-resources/kubelet.sock and the controller reads it
# through the stub. The servicer is for a stand-in kubelet.
# ---------------------------------------------------------------------------

POD_RESOURCES_SERVICE = "v1.PodResourcesLister"


class PodResourcesListerServicer:
    """Base class for the kubelet-side PodResourcesLister service."""

    def List(self, request: prpb.ListPodResourcesRequest, context) -> prpb.ListPodResourcesResponse:
        raise NotImplementedError

    def GetAllocatableResources(
        self, request: prpb.AllocatableResourcesRequest, context
    ) -> prpb.AllocatableResourcesResponse:
        raise NotImplementedError

    def Get(self, request: prpb.GetPodResourcesRequest, context) -> prpb.GetPodResourcesResponse:
        raise NotImplementedError


def add_pod_resources_servicer(servicer: PodResourcesListerServicer, server: grpc.Server) -> None:
    handlers = {
        "List": grpc.unary_unary_rpc_method_handler(
            servicer.List,
            request_deserializer=prpb.ListPodResourcesRequest.FromString,
            response_serializer=prpb.ListPodResourcesResponse.SerializeToString,
        ),
        "GetAllocatableResources": grpc.unary_unary_rpc_method_handler(
            servicer.GetAllocatableResources,
            request_deserializer=prpb.AllocatableResourcesRequest.FromString,
            response_serializer=prpb.AllocatableResourcesResponse.SerializeToString,
        ),
        "Get": grpc.unary_unary_rpc_method_handler(
            servicer.Get,
            request_deserializer=prpb.GetPodResourcesRequest.FromString,
            response_serializer=prpb.GetPodResourcesResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(POD_RESOURCES_SERVICE, handlers),)
    )


class PodResourcesListerStub:
    """Client for the kubelet's PodResourcesLister service."""

    def __init__(self, channel: grpc.Channel):
        self.List = channel.unary_unary(
            f"/{POD_RESOURCES_SERVICE}/List",
            request_serializer=prpb.ListPodResourcesRequest.SerializeToString,
            response_deserializer=prpb.ListPodResourcesResponse.FromString,
        )
        self.GetAllocatableResources = channel.unary_unary(
            f"/{POD_RESOURCES_SERVICE}/GetAllocatableResources",
            request_serializer=prpb.AllocatableResourcesRequest.SerializeToString,
            response_deserializer=prpb.AllocatableResourcesResponse.FromString,
        )
        self.Get = channel.unary_unary(
            f"/{POD_RESOURCES_SERVICE}/Get",
            request_serializer=prpb.GetPodResourcesRequest.SerializeToString,
            response_deserializer=prpb.GetPodResourcesResponse.FromString,
        )
