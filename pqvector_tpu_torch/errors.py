"""Error hierarchy for pqvector-tpu.

The reference crate surfaces every failure as ``Result<_, Box<dyn Error>>`` with a
descriptive message (e.g. pq-vector src/ivf/mod.rs:25, src/ivf/parquet.rs:549).
We mirror that with a small exception hierarchy so callers can catch broadly
(``PqVectorError``) or narrowly.
"""

from __future__ import annotations


class PqVectorError(Exception):
    """Base class for all pqvector-tpu errors."""


class ValidationError(PqVectorError):
    """Invalid user input: empty column names, zero dims, bad k/nprobe."""


class FormatError(PqVectorError):
    """Malformed on-disk artifacts: truncated index payloads, bad magic,
    unsupported footers (cf. pq-vector src/ivf/parquet.rs:155-169,556-558)."""


class PlanError(PqVectorError):
    """Query planning failures (cf. DataFusionError::Plan usages in
    pq-vector src/df_vector/exec.rs:89,214)."""


class ExecutionError(PqVectorError):
    """Query execution failures (cf. DataFusionError::Execution usages in
    pq-vector src/df_vector/index_exec.rs:102-158)."""
