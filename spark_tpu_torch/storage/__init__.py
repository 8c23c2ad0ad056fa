"""Device-resident columnar storage (the port of ``spark_tpu/storage``).

Materialized device ``Batch``es live in a byte-accounted ``MemoryStore``
keyed by plan or scan identity; storage and execution share one device
byte budget (``spark.tpu.scheduler.hbmBudgetBytes``) through the
``UnifiedMemoryManager``: an execution grant may evict unpinned storage
entries down to ``spark.tpu.storage.minBytes``, and storage never evicts
a running grant (reference: InMemoryRelation.scala,
UnifiedMemoryManager.scala:56). ``LruDict`` is the bounded LRU mapping.
"""

from spark_tpu_torch.storage.lru import LruDict
from spark_tpu_torch.storage.store import (MemoryStore, StoreEntry,
                                           batch_nbytes, pin_scope)
from spark_tpu_torch.storage.unified import UnifiedMemoryManager

__all__ = [
    "LruDict",
    "MemoryStore",
    "StoreEntry",
    "UnifiedMemoryManager",
    "batch_nbytes",
    "pin_scope",
]
