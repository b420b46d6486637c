"""Sharded serving over a device mesh, and the multi-slice router.

Port of ``orama_core_tpu/parallel/``: ``mesh`` (the mesh of devices and
the per-shard tensors), ``sharded_engine`` (the engine's mesh programs as
plain functions over per-shard tensors), ``sharded_search`` (the
standalone sharded steps), ``multislice`` (scatter-gather over whole
engines) and ``slice_grpc`` (its gRPC transport; needs ``grpcio`` and
``protobuf`` and is imported only by whoever asks for it).
"""
