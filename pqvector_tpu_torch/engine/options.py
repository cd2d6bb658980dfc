"""Query-time options (component #12 in SURVEY.md §2,
pq-vector src/df_vector/options.rs:4-19)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VectorTopKOptions:
    """Options for the VectorTopK rewrite.

    ``nprobe`` — clusters probed per file (default 5, options.rs:13-16).
    ``max_candidates`` — cap on candidate rows fetched across files, budgeted
    round-robin (options.rs:17-18, exec.rs:219-239).
    ``use_device`` — extension: route candidate re-scoring through the
    session's device when candidate counts are large (the reference is
    host-only).
    """

    nprobe: int = 5
    max_candidates: int | None = None
    use_device: bool = True
