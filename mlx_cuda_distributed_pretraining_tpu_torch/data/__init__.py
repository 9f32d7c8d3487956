"""Training data: the in-memory, streaming and token-shard loaders, packing
and the device prefetcher."""

from .device_prefetch import DevicePrefetcher
from .memory import DataManager
from .packing import pack_documents, pad_documents
from .streaming import DiskSpaceManager, StreamingDataManager, build_data_manager

__all__ = [
    "pack_documents",
    "pad_documents",
    "DataManager",
    "DevicePrefetcher",
    "DiskSpaceManager",
    "StreamingDataManager",
    "build_data_manager",
]
