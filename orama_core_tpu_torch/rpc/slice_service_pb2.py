# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: slice_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13slice_service.proto\x12\x0borama_slice\"N\n\x0cSliceRequest\x12\x0e\n\x06method\x18\x01 \x01(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0c\n\x04\x61uth\x18\x03 \x01(\t\x12\x0c\n\x04json\x18\x04 \x01(\x0c\",\n\rSliceResponse\x12\x0c\n\x04json\x18\x01 \x01(\x0c\x12\r\n\x05\x65rror\x18\x02 \x01(\t2M\n\x0cSliceService\x12=\n\x04\x43\x61ll\x12\x19.orama_slice.SliceRequest\x1a\x1a.orama_slice.SliceResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'slice_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SLICEREQUEST._serialized_start=36
  _SLICEREQUEST._serialized_end=114
  _SLICERESPONSE._serialized_start=116
  _SLICERESPONSE._serialized_end=160
  _SLICESERVICE._serialized_start=162
  _SLICESERVICE._serialized_end=239
# @@protoc_insertion_point(module_scope)
