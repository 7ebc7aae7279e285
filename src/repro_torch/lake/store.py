"""Content-addressed de-identified result store with LRU bounds (DESIGN.md §6).

The lake is the layer that turns "fast per study" into "fast under repeated
multi-user traffic": workers write finished per-instance results here, and the
cohort planner / cache-aware pipeline read them back instead of recomputing.

The store itself is deliberately dumb: opaque bytes in, opaque bytes out,
keyed by the content-addressed keys minted in ``repro_torch.lake.fingerprint``. The
``LakeBackend`` interface is persistence-shaped (put/get/delete/size of raw
bytes) so a cloud bucket or disk tier can replace ``InMemoryBackend`` without
touching eviction or metrics, which live in :class:`ResultLake`.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

from repro_torch.audit.ledger import NULL_LEDGER
from repro_torch.audit.records import LAKE_EVICT, LAKE_HIT, LAKE_WRITE
from repro_torch.obs.metrics import MetricsRegistry, StatsShim


class LakeBackend:
    """Minimal persistence interface: opaque bytes keyed by string."""

    def put_bytes(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get_bytes(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def nbytes(self, key: str) -> int:
        raise NotImplementedError


class InMemoryBackend(LakeBackend):
    def __init__(self) -> None:
        self._blobs: Dict[str, bytes] = {}

    def put_bytes(self, key: str, data: bytes) -> None:
        self._blobs[key] = data

    def get_bytes(self, key: str) -> Optional[bytes]:
        return self._blobs.get(key)

    def delete(self, key: str) -> None:
        self._blobs.pop(key, None)

    def nbytes(self, key: str) -> int:
        b = self._blobs.get(key)
        return 0 if b is None else len(b)


class LakeStats(StatsShim):
    """Lake counters; attribute surface unchanged, values are real metrics
    (``repro_lake_*``) aggregated by whichever registry owns them."""

    _SUBSYSTEM = "lake"
    _FIELDS = (
        "hits",
        "misses",
        "puts",
        "evictions",
        "bytes_in",       # bytes written into the lake
        "bytes_out",      # bytes served from the lake
        "evicted_bytes",
        "oversize_rejects",  # single blobs larger than the whole budget
    )

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class ResultLake:
    """Size-bounded LRU cache over a :class:`LakeBackend`.

    ``max_bytes`` bounds the *stored payload* bytes; eviction is
    least-recently-used where both reads and writes refresh recency. The LRU
    index is kept here (not in the backend) so a persistent backend can stay a
    plain key/value store.
    """

    def __init__(
        self,
        max_bytes: int = 256 * 1024 * 1024,
        backend: Optional[LakeBackend] = None,
        registry: Optional[MetricsRegistry] = None,
        ledger=None,
    ) -> None:
        self.max_bytes = max_bytes
        self.backend = backend or InMemoryBackend()
        self.stats = LakeStats(registry)
        self.ledger = ledger if ledger is not None else NULL_LEDGER
        self._lru: "OrderedDict[str, int]" = OrderedDict()  # key -> nbytes
        self._stored_bytes = 0

    # ----------------------------------------------------------------- reads
    def get(self, key: str) -> Optional[bytes]:
        if key not in self._lru:
            self.stats.misses += 1
            return None
        data = self.backend.get_bytes(key)
        if data is None:  # backend lost the blob (e.g. external pruning)
            self._drop(key, reason="lost")
            self.stats.misses += 1
            return None
        self._lru.move_to_end(key)
        self.stats.hits += 1
        self.stats.bytes_out += len(data)
        # every byte served out of the lake is a disclosure: account for it
        self.ledger.append(LAKE_HIT, lake_key=key, nbytes=len(data))
        return data

    def contains(self, key: str) -> bool:
        """Presence probe: no hit/miss accounting, no recency refresh."""
        return key in self._lru

    # ---------------------------------------------------------------- writes
    def put(self, key: str, data: bytes) -> bool:
        """Store a result; returns False when the blob alone exceeds the
        budget (storing it would immediately evict everything else)."""
        if len(data) > self.max_bytes:
            self.stats.oversize_rejects += 1
            return False
        if key in self._lru:
            self._stored_bytes -= self._lru[key]
        self.backend.put_bytes(key, data)
        self._lru[key] = len(data)
        self._lru.move_to_end(key)
        self._stored_bytes += len(data)
        self.stats.puts += 1
        self.stats.bytes_in += len(data)
        self.ledger.append(LAKE_WRITE, lake_key=key, nbytes=len(data))
        while self._stored_bytes > self.max_bytes:
            self._evict_one()
        return True

    def delete(self, key: str) -> None:
        self._drop(key, reason="invalidate")

    # -------------------------------------------------------------- internals
    def _drop(self, key: str, reason: str = "invalidate") -> None:
        if key in self._lru:
            nbytes = self._lru.pop(key)
            self._stored_bytes -= nbytes
            self.backend.delete(key)
            self.ledger.append(LAKE_EVICT, lake_key=key, nbytes=nbytes, reason=reason)

    def _evict_one(self) -> None:
        key, nbytes = self._lru.popitem(last=False)
        self._stored_bytes -= nbytes
        self.backend.delete(key)
        self.stats.evictions += 1
        self.stats.evicted_bytes += nbytes
        self.ledger.append(LAKE_EVICT, lake_key=key, nbytes=nbytes, reason="lru")

    # ------------------------------------------------------------------ misc
    def stored_bytes(self) -> int:
        return self._stored_bytes

    def keys(self) -> List[str]:
        return list(self._lru)

    def __len__(self) -> int:
        return len(self._lru)
