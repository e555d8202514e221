from .sharded import DeviceMesh, ShardedContext, make_device_mesh

__all__ = ["DeviceMesh", "ShardedContext", "make_device_mesh"]
