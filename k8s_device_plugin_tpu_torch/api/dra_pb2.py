# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dra.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tdra.proto\x12\x03\x64ra\"9\n\x1bNodePrepareResourcesRequest\x12\x1a\n\x06\x63laims\x18\x01 \x03(\x0b\x32\n.dra.Claim\"\xae\x01\n\x1cNodePrepareResourcesResponse\x12=\n\x06\x63laims\x18\x01 \x03(\x0b\x32-.dra.NodePrepareResourcesResponse.ClaimsEntry\x1aO\n\x0b\x43laimsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12/\n\x05value\x18\x02 \x01(\x0b\x32 .dra.NodePrepareResourceResponse:\x02\x38\x01\"J\n\x1bNodePrepareResourceResponse\x12\x1c\n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32\x0b.dra.Device\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"_\n\x06\x44\x65vice\x12\x15\n\rrequest_names\x18\x01 \x03(\t\x12\x11\n\tpool_name\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65vice_name\x18\x03 \x01(\t\x12\x16\n\x0e\x63\x64i_device_ids\x18\x04 \x03(\t\";\n\x1dNodeUnprepareResourcesRequest\x12\x1a\n\x06\x63laims\x18\x01 \x03(\x0b\x32\n.dra.Claim\"\xb4\x01\n\x1eNodeUnprepareResourcesResponse\x12?\n\x06\x63laims\x18\x01 \x03(\x0b\x32/.dra.NodeUnprepareResourcesResponse.ClaimsEntry\x1aQ\n\x0b\x43laimsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x31\n\x05value\x18\x02 \x01(\x0b\x32\".dra.NodeUnprepareResourceResponse:\x02\x38\x01\".\n\x1dNodeUnprepareResourceResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"5\n\x05\x43laim\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x0b\n\x03uid\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t2\xcf\x01\n\tDRAPlugin\x12]\n\x14NodePrepareResources\x12 .dra.NodePrepareResourcesRequest\x1a!.dra.NodePrepareResourcesResponse\"\x00\x12\x63\n\x16NodeUnprepareResources\x12\".dra.NodeUnprepareResourcesRequest\x1a#.dra.NodeUnprepareResourcesResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dra_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._options = None
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_options = b'8\001'
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._options = None
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_options = b'8\001'
  _NODEPREPARERESOURCESREQUEST._serialized_start=18
  _NODEPREPARERESOURCESREQUEST._serialized_end=75
  _NODEPREPARERESOURCESRESPONSE._serialized_start=78
  _NODEPREPARERESOURCESRESPONSE._serialized_end=252
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_start=173
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_end=252
  _NODEPREPARERESOURCERESPONSE._serialized_start=254
  _NODEPREPARERESOURCERESPONSE._serialized_end=328
  _DEVICE._serialized_start=330
  _DEVICE._serialized_end=425
  _NODEUNPREPARERESOURCESREQUEST._serialized_start=427
  _NODEUNPREPARERESOURCESREQUEST._serialized_end=486
  _NODEUNPREPARERESOURCESRESPONSE._serialized_start=489
  _NODEUNPREPARERESOURCESRESPONSE._serialized_end=669
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_start=588
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_end=669
  _NODEUNPREPARERESOURCERESPONSE._serialized_start=671
  _NODEUNPREPARERESOURCERESPONSE._serialized_end=717
  _CLAIM._serialized_start=719
  _CLAIM._serialized_end=772
  _DRAPLUGIN._serialized_start=775
  _DRAPLUGIN._serialized_end=982
# @@protoc_insertion_point(module_scope)
