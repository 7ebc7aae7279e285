"""Columnar DICOM metadata catalog + vectorized cohort query engine
(DESIGN.md §8): dictionary-encoded column blocks with zone maps, a typed
predicate AST compiled to a torch + bitmap-kernel evaluation, and the
``StudyCatalog`` facade turning queries into :class:`CohortSelection`\\ s the
cohort planner can admit.
"""
from repro_torch.catalog.catalog import CatalogStats, CohortSelection, StudyCatalog
from repro_torch.catalog.columns import (
    COLUMN_KINDS,
    COLUMNS,
    Dictionary,
    ZoneMap,
    row_from_dataset,
    rows_from_study,
)
from repro_torch.catalog.query import (
    And,
    Contains,
    Eq,
    In,
    Not,
    Or,
    Predicate,
    Range,
    compile_query,
    describe,
    matches_row,
)

__all__ = [
    "And",
    "CatalogStats",
    "CohortSelection",
    "COLUMN_KINDS",
    "COLUMNS",
    "Contains",
    "Dictionary",
    "Eq",
    "In",
    "Not",
    "Or",
    "Predicate",
    "Range",
    "StudyCatalog",
    "ZoneMap",
    "compile_query",
    "describe",
    "matches_row",
    "row_from_dataset",
    "rows_from_study",
]
