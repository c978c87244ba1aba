# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: podresources.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12podresources.proto\x12\x02v1\"\x1d\n\x1b\x41llocatableResourcesRequest\"{\n\x1c\x41llocatableResourcesResponse\x12%\n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32\x14.v1.ContainerDevices\x12\x0f\n\x07\x63pu_ids\x18\x02 \x03(\x03\x12#\n\x06memory\x18\x03 \x03(\x0b\x32\x13.v1.ContainerMemory\"\x19\n\x17ListPodResourcesRequest\"C\n\x18ListPodResourcesResponse\x12\'\n\rpod_resources\x18\x01 \x03(\x0b\x32\x10.v1.PodResources\"[\n\x0cPodResources\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12*\n\ncontainers\x18\x03 \x03(\x0b\x32\x16.v1.ContainerResources\"\xaf\x01\n\x12\x43ontainerResources\x12\x0c\n\x04name\x18\x01 \x01(\t\x12%\n\x07\x64\x65vices\x18\x02 \x03(\x0b\x32\x14.v1.ContainerDevices\x12\x0f\n\x07\x63pu_ids\x18\x03 \x03(\x03\x12#\n\x06memory\x18\x04 \x03(\x0b\x32\x13.v1.ContainerMemory\x12.\n\x11\x64ynamic_resources\x18\x05 \x03(\x0b\x32\x13.v1.DynamicResource\"X\n\x0f\x43ontainerMemory\x12\x13\n\x0bmemory_type\x18\x01 \x01(\t\x12\x0c\n\x04size\x18\x02 \x01(\x04\x12\"\n\x08topology\x18\x03 \x01(\x0b\x32\x10.v1.TopologyInfo\"a\n\x10\x43ontainerDevices\x12\x15\n\rresource_name\x18\x01 \x01(\t\x12\x12\n\ndevice_ids\x18\x02 \x03(\t\x12\"\n\x08topology\x18\x03 \x01(\x0b\x32\x10.v1.TopologyInfo\"+\n\x0cTopologyInfo\x12\x1b\n\x05nodes\x18\x01 \x03(\x0b\x32\x0c.v1.NUMANode\"\x16\n\x08NUMANode\x12\n\n\x02ID\x18\x01 \x01(\x03\"~\n\x0f\x44ynamicResource\x12\x12\n\nclass_name\x18\x01 \x01(\t\x12\x12\n\nclaim_name\x18\x02 \x01(\t\x12\x17\n\x0f\x63laim_namespace\x18\x03 \x01(\t\x12*\n\x0f\x63laim_resources\x18\x04 \x03(\x0b\x32\x11.v1.ClaimResource\"3\n\rClaimResource\x12\"\n\x0b\x63\x64i_devices\x18\x01 \x03(\x0b\x32\r.v1.CDIDevice\"\x19\n\tCDIDevice\x12\x0c\n\x04name\x18\x01 \x01(\t\"A\n\x16GetPodResourcesRequest\x12\x10\n\x08pod_name\x18\x01 \x01(\t\x12\x15\n\rpod_namespace\x18\x02 \x01(\t\"B\n\x17GetPodResourcesResponse\x12\'\n\rpod_resources\x18\x01 \x01(\x0b\x32\x10.v1.PodResources2\xfb\x01\n\x12PodResourcesLister\x12\x43\n\x04List\x12\x1b.v1.ListPodResourcesRequest\x1a\x1c.v1.ListPodResourcesResponse\"\x00\x12^\n\x17GetAllocatableResources\x12\x1f.v1.AllocatableResourcesRequest\x1a .v1.AllocatableResourcesResponse\"\x00\x12@\n\x03Get\x12\x1a.v1.GetPodResourcesRequest\x1a\x1b.v1.GetPodResourcesResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'podresources_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ALLOCATABLERESOURCESREQUEST._serialized_start=26
  _ALLOCATABLERESOURCESREQUEST._serialized_end=55
  _ALLOCATABLERESOURCESRESPONSE._serialized_start=57
  _ALLOCATABLERESOURCESRESPONSE._serialized_end=180
  _LISTPODRESOURCESREQUEST._serialized_start=182
  _LISTPODRESOURCESREQUEST._serialized_end=207
  _LISTPODRESOURCESRESPONSE._serialized_start=209
  _LISTPODRESOURCESRESPONSE._serialized_end=276
  _PODRESOURCES._serialized_start=278
  _PODRESOURCES._serialized_end=369
  _CONTAINERRESOURCES._serialized_start=372
  _CONTAINERRESOURCES._serialized_end=547
  _CONTAINERMEMORY._serialized_start=549
  _CONTAINERMEMORY._serialized_end=637
  _CONTAINERDEVICES._serialized_start=639
  _CONTAINERDEVICES._serialized_end=736
  _TOPOLOGYINFO._serialized_start=738
  _TOPOLOGYINFO._serialized_end=781
  _NUMANODE._serialized_start=783
  _NUMANODE._serialized_end=805
  _DYNAMICRESOURCE._serialized_start=807
  _DYNAMICRESOURCE._serialized_end=933
  _CLAIMRESOURCE._serialized_start=935
  _CLAIMRESOURCE._serialized_end=986
  _CDIDEVICE._serialized_start=988
  _CDIDEVICE._serialized_end=1013
  _GETPODRESOURCESREQUEST._serialized_start=1015
  _GETPODRESOURCESREQUEST._serialized_end=1080
  _GETPODRESOURCESRESPONSE._serialized_start=1082
  _GETPODRESOURCESRESPONSE._serialized_end=1148
  _PODRESOURCESLISTER._serialized_start=1151
  _PODRESOURCESLISTER._serialized_end=1402
# @@protoc_insertion_point(module_scope)
