"""StudyCatalog: the queryable metadata index over the imaging lake.

The paper's workflow is query-then-de-identify: researchers select cohorts
by metadata criteria and only the matching slice is de-identified on demand.
This facade owns the columnar blocks (``columns.py``), compiles and runs
predicates (``query.py``), and turns a match mask into a
:class:`CohortSelection` — accessions, instance counts, byte totals, and a
snapshot digest that pins exactly which catalog state answered the query
(replay determinism: same digest, same cohort, same warm-replay identity).

Ingest is incremental: ``StudyStore.attach_catalog`` routes every
``put_study`` here, and re-ingesting an accession (new source bytes, new
etag) tombstones its old rows and appends the new ones — queries never see
two versions of a study at once.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.catalog.columns import (
    COLUMNS,
    DICT_COLUMNS,
    Block,
    Dictionary,
    rows_from_study,
    seal_block,
)
from repro_torch.catalog.query import (
    Predicate,
    compile_query,
    describe,
    eval_oracle,
    eval_vectorized,
    zone_may_match,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("catalog")


@dataclass
class CatalogStats:
    rows: int = 0
    tombstoned: int = 0
    deletes: int = 0      # accessions removed via remove_study (feed deletes)
    queries: int = 0
    blocks_scanned: int = 0
    blocks_pruned: int = 0
    rows_scanned: int = 0


@dataclass(frozen=True)
class CohortSelection:
    """One query's answer, frozen at serve time.

    ``accessions`` are sorted lexicographically (deterministic, and
    first-occurrence row order would shift under re-ingest tombstoning).
    ``digest`` is sha256(catalog snapshot digest | canonical query) — two
    selections with the same digest are guaranteed to be the same cohort, so
    the digest rides the cohort ticket into the warm-replay identity.
    """

    query: str
    accessions: Tuple[str, ...]
    instance_counts: Dict[str, int]
    total_instances: int
    total_bytes: int
    digest: str
    blocks_scanned: int = 0
    blocks_pruned: int = 0


class StudyCatalog:
    def __init__(self, block_rows: int = 512, tracer=None, device: DeviceLike = None) -> None:
        from repro_torch.obs.trace import NULL_TRACER

        self.block_rows = block_rows
        # where mode="auto" evaluates (default cuda:0; "cpu" runs the plain
        # PyTorch versions); mode="oracle" is the numpy scan on the host
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.dicts: Dict[str, Dictionary] = {c: Dictionary() for c in DICT_COLUMNS}
        self._blocks: List[Block] = []
        # open (unsealed) block buffers
        self._open: Dict[str, List[int]] = {c: [] for c in COLUMNS}
        self._open_acc: List[int] = []
        self._open_valid: List[bool] = []
        # accession interning is exact-string (not CS-normalized): accession
        # ids must round-trip byte-identically into broker keys
        self._acc_values: List[str] = []
        self._acc_codes: Dict[str, int] = {}
        self._etags: Dict[str, Optional[str]] = {}  # insertion-ordered
        self._digest = hashlib.sha256()
        self._generation = 0
        # (generation, acc concat, nbytes concat): selection grouping needs
        # these for every row, but they only change on ingest — without the
        # cache every query would pay O(total rows) even when pruning
        # skipped every block
        self._concat_cache: Optional[Tuple[int, np.ndarray, np.ndarray]] = None
        self.stats = CatalogStats()

    # --------------------------------------------------------------- ingest
    def ingest_study(self, accession: str, study, etag: Optional[str] = None) -> int:
        """Index one study's instances; replaces any prior rows for the
        accession (re-acquisition safety). Returns rows ingested."""
        return self.ingest_rows(accession, rows_from_study(study), etag=etag)

    def ingest_rows(
        self, accession: str, rows: Sequence[dict], etag: Optional[str] = None
    ) -> int:
        if accession in self._acc_codes:
            self._tombstone(accession)
        code = self._acc_codes.get(accession)
        if code is None:
            code = len(self._acc_values)
            self._acc_codes[accession] = code
            self._acc_values.append(accession)
        for row in rows:
            # missing columns default to ""/0 (schema growth: row dicts built
            # before a column existed stay ingestable; matches_row mirrors
            # the same defaults, so oracle and vectorized paths agree)
            for col in COLUMNS:
                if col in DICT_COLUMNS:
                    self._open[col].append(self.dicts[col].encode(row.get(col, "")))
                else:
                    self._open[col].append(int(row.get(col, 0)))
            self._open_acc.append(code)
            self._open_valid.append(True)
            if len(self._open_acc) >= self.block_rows:
                self._seal_open()
        self._etags[accession] = etag
        self.stats.rows += len(rows)
        self._generation += 1
        self._digest.update(
            f"{self._generation}|{accession}|{etag or ''}|{len(rows)}".encode()
        )
        return len(rows)

    def remove_study(self, accession: str) -> int:
        """Delta delete: tombstone an accession's live rows and drop it from
        the etag inventory — no rebuild, work ∝ the accession's rows. Returns
        the number of rows tombstoned (0 for unknown accessions)."""
        if accession not in self._acc_codes:
            return 0
        before = self.stats.tombstoned
        self._tombstone(accession)
        self._etags.pop(accession, None)
        self.stats.deletes += 1
        self._generation += 1
        self._digest.update(f"{self._generation}|{accession}|<deleted>|0".encode())
        return self.stats.tombstoned - before

    def _seal_open(self) -> None:
        self._blocks.append(seal_block(self._open, self._open_acc, self._open_valid))
        self._open = {c: [] for c in COLUMNS}
        self._open_acc = []
        self._open_valid = []

    def _tombstone(self, accession: str) -> None:
        code = self._acc_codes[accession]
        killed = 0
        for block in self._blocks:
            hit = block.acc == code
            killed += int((hit & block.valid).sum())
            block.valid[hit] = False
        for i, c in enumerate(self._open_acc):
            if c == code and self._open_valid[i]:
                self._open_valid[i] = False
                killed += 1
        self.stats.tombstoned += killed

    # ------------------------------------------------------------ inventory
    def accessions(self) -> List[str]:
        return list(self._etags)

    def accession_etags(self) -> Dict[str, Optional[str]]:
        """accession -> source etag at last ingest, insertion-ordered. The
        fleet sim snapshots this at query-serve time so the consistency
        checker replays against exactly the indexed versions."""
        return dict(self._etags)

    def snapshot_digest(self) -> str:
        """Digest of the full ingest history (accession, etag, row count per
        generation) — the catalog-state half of every selection digest."""
        return self._digest.copy().hexdigest()

    def n_rows(self) -> int:
        return sum(b.n for b in self._blocks) + len(self._open_acc)

    def _all_blocks(self) -> List[Block]:
        blocks = list(self._blocks)
        if self._open_acc:
            blocks.append(
                Block(
                    cols={c: np.asarray(v, np.int32) for c, v in self._open.items()},
                    acc=np.asarray(self._open_acc, np.int32),
                    valid=np.asarray(self._open_valid, bool),
                    zmaps=None,  # unsealed: no zone maps, always scanned
                )
            )
        return blocks

    # --------------------------------------------------------------- queries
    def match_mask(
        self, pred: Predicate, mode: str = "auto", prune: bool = True
    ) -> Tuple[np.ndarray, int, int]:
        """Evaluate a predicate over every row. Returns (mask over all rows
        in ingest order, blocks_scanned, blocks_pruned); tombstoned rows are
        always False. ``mode``: "auto" = vectorized torch + bitmap kernel
        path on the catalog's device, "oracle" = numpy reference scan."""
        compiled = compile_query(pred, self.dicts)
        blocks = self._all_blocks()
        total = sum(b.n for b in blocks)
        mask = np.zeros(total, bool)
        scanned: List[Tuple[int, Block]] = []
        pruned = 0
        offset = 0
        for b in blocks:
            skip = b.zmaps is not None and (
                not b.valid.any()
                or not zone_may_match(compiled.tree, compiled.leaves, b.zmaps)
            )
            if prune and skip:
                pruned += 1
            else:
                scanned.append((offset, b))
            offset += b.n
        if scanned:
            arrays = {
                c: np.concatenate([b.cols[c] for _, b in scanned]) for c in compiled.cols
            }
            valid = np.concatenate([b.valid for _, b in scanned])
            evaluate = (
                eval_oracle if mode == "oracle"
                else functools.partial(eval_vectorized, device=self.device)
            )
            seg = evaluate(compiled, arrays, valid)
            pos = 0
            for off, b in scanned:
                mask[off : off + b.n] = seg[pos : pos + b.n]
                pos += b.n
        self.stats.queries += 1
        self.stats.blocks_scanned += len(scanned)
        self.stats.blocks_pruned += pruned
        self.stats.rows_scanned += sum(b.n for _, b in scanned)
        return mask, len(scanned), pruned

    def _row_identity(self) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenated (acc codes, nbytes) over all rows, cached per ingest
        generation (tombstoning bumps the generation too, but identity
        columns never change value — only ``valid`` does)."""
        if self._concat_cache is None or self._concat_cache[0] != self._generation:
            blocks = self._all_blocks()
            if blocks:
                acc = np.concatenate([b.acc for b in blocks])
                nbytes = np.concatenate([b.cols["nbytes"] for b in blocks])
            else:
                acc = np.zeros(0, np.int32)
                nbytes = np.zeros(0, np.int32)
            self._concat_cache = (self._generation, acc, nbytes)
        return self._concat_cache[1], self._concat_cache[2]

    def select(
        self, pred: Predicate, mode: str = "auto", prune: bool = True
    ) -> CohortSelection:
        """Resolve a predicate to the matching cohort."""
        with self.tracer.span("catalog.select", mode=mode) as _scan_span:
            mask, n_scanned, n_pruned = self.match_mask(pred, mode=mode, prune=prune)
            _scan_span.set(
                blocks_scanned=n_scanned,
                blocks_pruned=n_pruned,
                matched=int(mask.sum()),
            )
        acc, nbytes = self._row_identity()
        hit_acc = acc[mask]
        counts: Dict[str, int] = {}
        for code, n in zip(*np.unique(hit_acc, return_counts=True)):
            counts[self._acc_values[int(code)]] = int(n)
        ordered = tuple(sorted(counts))
        qs = describe(pred)
        digest = hashlib.sha256(
            f"{self.snapshot_digest()}|{qs}".encode()
        ).hexdigest()
        return CohortSelection(
            query=qs,
            accessions=ordered,
            instance_counts={a: counts[a] for a in ordered},
            total_instances=int(mask.sum()),
            total_bytes=int(nbytes[mask].sum()),
            digest=digest,
            blocks_scanned=n_scanned,
            blocks_pruned=n_pruned,
        )
