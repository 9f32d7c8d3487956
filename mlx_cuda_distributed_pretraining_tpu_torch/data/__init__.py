"""Training data: JSONL loading, packing and batching."""

from .memory import DataManager
from .packing import pack_documents, pad_documents

__all__ = ["DataManager", "pack_documents", "pad_documents"]
