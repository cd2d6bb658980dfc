"""SQL-style query engine (reference layer: pq-vector src/df_vector/)."""

from .access import CandidateCursor, FileEntry, ParquetAccessPlan, ScanFile
from .exec import VectorTopKExec
from .index_exec import INDEX_PATH_COL, INDEX_ROW_ID_COL, VectorIndexScanExec
from .object_store import LocalStore, ObjectStore
from .options import VectorTopKOptions
from .physical import (
    ExecutionPlan,
    FilterExec,
    GlobalLimitExec,
    LocalLimitExec,
    ParquetScanExec,
    ProjectionExec,
    SortExec,
    SortExpr,
    SortPreservingMergeExec,
    TaskContext,
    display_tree,
    tree_render,
)
from .rule import VectorTopKPhysicalOptimizerRule
from .session import DataFrame, Session
from .sql import parse_sql

__all__ = [
    "CandidateCursor",
    "DataFrame",
    "ExecutionPlan",
    "FileEntry",
    "FilterExec",
    "GlobalLimitExec",
    "INDEX_PATH_COL",
    "INDEX_ROW_ID_COL",
    "LocalLimitExec",
    "LocalStore",
    "ObjectStore",
    "ParquetAccessPlan",
    "ParquetScanExec",
    "ProjectionExec",
    "ScanFile",
    "Session",
    "SortExec",
    "SortExpr",
    "SortPreservingMergeExec",
    "TaskContext",
    "VectorIndexScanExec",
    "VectorTopKExec",
    "VectorTopKOptions",
    "VectorTopKPhysicalOptimizerRule",
    "display_tree",
    "parse_sql",
    "tree_render",
]
