"""Object storage stand-in (paper: "encrypted and distributed cloud object
storage service").

Two layers:

* :class:`ObjectStore` — a key/value blob store with byte accounting and
  optional at-rest obfuscation. The obfuscation is a keyed XOR keystream —
  explicitly NOT real cryptography (offline container, no AES available);
  it exists so tests can assert the at-rest representation differs from the
  plaintext and that reads require the key, i.e. the *interface* of an
  encrypted store is honored end to end.
* :class:`StudyStore` — typed façade holding identified studies (the data
  lake) or de-identified outputs (the researcher bucket), with egress
  accounting used by the Table-1 cost model.
"""
from __future__ import annotations

import hashlib
import io
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclass(frozen=True)
class StudyChange:
    """One entry in a :class:`StudyStore`'s change sequence: a monotonically
    numbered record of a study-level mutation (``put`` or ``delete``). This is
    the surface downstream consumers (catalog delta ingest, change pooler
    conformance checks) diff against instead of rescanning the lake."""

    seq: int
    op: str              # "put" | "delete"
    accession: str
    etag: Optional[str]  # at-rest content etag after the op (None for delete)


def _keystream(key: bytes, n: int) -> bytes:
    out = io.BytesIO()
    counter = 0
    while out.tell() < n:
        out.write(hashlib.sha256(key + counter.to_bytes(8, "big")).digest())
        counter += 1
    return out.getvalue()[:n]


class ObjectStore:
    def __init__(self, name: str, key: Optional[bytes] = None) -> None:
        self.name = name
        self._key = key
        self._blobs: Dict[str, bytes] = {}
        self._etags: Dict[str, str] = {}
        self.bytes_written = 0
        self.bytes_read = 0

    def put(self, path: str, data: bytes) -> None:
        if self._key is not None:
            data = bytes(a ^ b for a, b in zip(data, _keystream(self._key, len(data))))
        # content etag recorded at write time so readers (e.g. the cohort
        # planner) can version objects without fetching them. Hashed over the
        # *at-rest* bytes: a plaintext digest beside an encrypted blob would
        # leak content equality (known-plaintext confirmation without the key)
        self._etags[path] = hashlib.sha256(data).hexdigest()
        self._blobs[path] = data
        self.bytes_written += len(data)

    def get(self, path: str) -> bytes:
        data = self._blobs[path]
        self.bytes_read += len(data)
        if self._key is not None:
            data = bytes(a ^ b for a, b in zip(data, _keystream(self._key, len(data))))
        return data

    def raw(self, path: str) -> bytes:
        """At-rest bytes (for tests asserting encryption actually applied)."""
        return self._blobs[path]

    def exists(self, path: str) -> bool:
        return path in self._blobs

    def etag(self, path: str) -> Optional[str]:
        """At-rest content digest recorded at put time (no blob read)."""
        return self._etags.get(path)

    def nbytes(self, path: str) -> Optional[int]:
        """Stored size without a read (no decrypt, no egress accounting)."""
        b = self._blobs.get(path)
        return None if b is None else len(b)

    def list(self, prefix: str = "") -> List[str]:
        return sorted(p for p in self._blobs if p.startswith(prefix))

    def delete(self, path: str) -> None:
        self._blobs.pop(path, None)
        self._etags.pop(path, None)

    def total_bytes(self) -> int:
        return sum(len(b) for b in self._blobs.values())


class StudyStore:
    """Typed store: pickles study/dataset objects through an ObjectStore."""

    def __init__(self, name: str, key: Optional[bytes] = None) -> None:
        self.store = ObjectStore(name, key)
        self.catalog = None  # optional metadata index (repro_torch.catalog)
        self._change_seq = 0
        self._change_log: List[StudyChange] = []

    def _record_change(self, op: str, accession: str, etag: Optional[str]) -> None:
        self._change_seq += 1
        self._change_log.append(StudyChange(self._change_seq, op, accession, etag))

    def change_seq(self) -> int:
        """Monotonic sequence number of the latest study-level mutation."""
        return self._change_seq

    def changes(self, after: int = 0) -> List[StudyChange]:
        """Study-level mutations with ``seq > after``, oldest first."""
        return [c for c in self._change_log if c.seq > after]

    def attach_catalog(self, catalog) -> None:
        """Route every ``put_study`` through the metadata catalog so the
        index stays in lockstep with the lake. Studies already stored are
        backfilled immediately (one read each — metadata indexing is the one
        consumer allowed to read the lake besides the workers)."""
        self.catalog = catalog
        for accession in self.accessions():
            catalog.ingest_study(
                accession, self.get_study(accession), etag=self.study_etag(accession)
            )

    def put_study(self, accession: str, study: Any) -> int:
        blob = pickle.dumps(study, protocol=pickle.HIGHEST_PROTOCOL)
        self.store.put(f"studies/{accession}", blob)
        if self.catalog is not None:
            # re-puts (re-acquisition) tombstone the old rows in the catalog,
            # keyed by the fresh at-rest etag recorded by the put above
            self.catalog.ingest_study(accession, study, etag=self.study_etag(accession))
        self._record_change("put", accession, self.study_etag(accession))
        return len(blob)

    def delete_study(self, accession: str) -> bool:
        """Remove a study from the lake (source deletion propagated by the
        change feed). Tombstones the catalog rows and appends a delete entry
        to the change sequence; returns False when the accession was absent."""
        if not self.has_study(accession):
            return False
        self.store.delete(f"studies/{accession}")
        if self.catalog is not None:
            self.catalog.remove_study(accession)
        self._record_change("delete", accession, None)
        return True

    def get_study(self, accession: str) -> Any:
        return pickle.loads(self.store.get(f"studies/{accession}"))

    def has_study(self, accession: str) -> bool:
        return self.store.exists(f"studies/{accession}")

    def study_etag(self, accession: str) -> Optional[str]:
        return self.store.etag(f"studies/{accession}")

    def study_nbytes(self, accession: str) -> Optional[int]:
        """Stored blob size — the metadata-only backlog estimate used at
        admission (the worker is the one that actually reads the study)."""
        return self.store.nbytes(f"studies/{accession}")

    def put_output(self, request_id: str, sop_uid: str, dataset: Any) -> int:
        blob = pickle.dumps(dataset, protocol=pickle.HIGHEST_PROTOCOL)
        self.store.put(f"out/{request_id}/{sop_uid}", blob)
        return len(blob)

    def outputs(self, request_id: str) -> Iterator[Any]:
        for path in self.store.list(f"out/{request_id}/"):
            yield pickle.loads(self.store.get(path))

    def put_manifest(self, request_id: str, manifest_json: str) -> None:
        self.store.put(f"manifests/{request_id}.json", manifest_json.encode())

    def accessions(self) -> List[str]:
        return [p.split("/", 1)[1] for p in self.store.list("studies/")]
