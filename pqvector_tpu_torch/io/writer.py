"""Rewrite-mode Parquet writer with source property preservation. A copy of
``pqvector_tpu/io/writer.py``.

Counterpart of ``write_parquet_with_index`` + ``collect_column_write_options``
(component #9 in SURVEY.md §2, pq-vector src/ivf/parquet.rs:316-534):

* clone per-column compression / dictionary / encoding / statistics settings
  from the source file (parquet.rs:417-522, incl. the majority-encoding
  heuristic over page encoding stats),
* force the embedding column to index-friendly layout: tiny data pages
  (~one vector per page via a ``dim * 4``-byte page-size limit, matching the
  reference's global ``set_data_page_size_limit(vector_size)`` at
  parquet.rs:324-326), dictionary off, chunk-level stats only
  (parquet.rs:342-344),
* then the index payload is appended via the same in-place footer machinery
  used for ``build_inplace`` (one audited byte-surgery path instead of two).

Divergences from the reference, by necessity of the pyarrow writer API:
``data_page_size`` and ``write_batch_size`` are file-global (the reference's
page limits are global too); per-page header statistics cannot be toggled
per column (pyarrow only writes page stats into the optional page index).
"""

from __future__ import annotations

import dataclasses
import os

import pyarrow as pa
import pyarrow.parquet as pq

from ..errors import FormatError, ValidationError
from ..index.ivf import IvfIndex
from ..types import EmbeddingColumn
from .embed import append_index_inplace

_LEVEL_ENCODINGS = {"RLE", "BIT_PACKED"}
_DICT_ENCODINGS = {"RLE_DICTIONARY", "PLAIN_DICTIONARY"}


@dataclasses.dataclass
class ColumnWriteOptions:
    """Mirror of ColumnWriteOptions (parquet.rs:409-415)."""

    path: str
    compression: str
    dictionary_enabled: bool
    encoding: str | None
    statistics_enabled: str  # "page" | "chunk" | "none"


def _column_uses_dictionary(col) -> bool:
    # parquet.rs:475-477
    if col.dictionary_page_offset is not None:
        return True
    return any(e in _DICT_ENCODINGS for e in col.encodings)


def _column_statistics_level(col) -> str:
    # parquet.rs:479-487
    if getattr(col, "has_column_index", False):
        return "page"
    if col.statistics is not None:
        return "chunk"
    return "none"


def _data_page_encoding(col) -> str | None:
    """Pick the dominant non-level, non-dictionary data-page encoding.

    pyarrow does not expose per-page encoding stats, so this is the
    fallback branch of the reference heuristic (parquet.rs:506-521): first
    non-level/non-dict encoding in the chunk's encoding list, else PLAIN.
    """
    encodings = list(col.encodings)
    for e in encodings:
        if e not in _LEVEL_ENCODINGS and e not in _DICT_ENCODINGS:
            return e
    if "PLAIN" in encodings:
        return "PLAIN"
    return None


def collect_column_write_options(
    source: str | os.PathLike,
) -> list[ColumnWriteOptions]:
    """Per-leaf-column write options from the source file's first row group,
    verified consistent across row groups (parquet.rs:417-464)."""
    md = pq.ParquetFile(source).metadata
    if md.num_row_groups == 0:
        return []
    first = md.row_group(0)
    options = []
    for j in range(first.num_columns):
        col = first.column(j)
        options.append(
            ColumnWriteOptions(
                path=col.path_in_schema,
                compression=col.compression,
                dictionary_enabled=_column_uses_dictionary(col),
                encoding=_data_page_encoding(col),
                statistics_enabled=_column_statistics_level(col),
            )
        )
    for rg_idx in range(1, md.num_row_groups):
        rg = md.row_group(rg_idx)
        if rg.num_columns != first.num_columns:
            raise ValidationError(
                f"Row group {rg_idx} column count mismatch: expected "
                f"{first.num_columns}, found {rg.num_columns}"
            )
        for j in range(rg.num_columns):
            col = rg.column(j)
            current = ColumnWriteOptions(
                path=col.path_in_schema,
                compression=col.compression,
                dictionary_enabled=_column_uses_dictionary(col),
                encoding=_data_page_encoding(col),
                statistics_enabled=_column_statistics_level(col),
            )
            if current != options[j]:
                raise ValidationError(
                    f"Column settings for leaf column {j} differ between row groups"
                )
    return options


def embedding_leaf_path(
    columns: list[ColumnWriteOptions], column: EmbeddingColumn
) -> str:
    """Leaf path whose root matches the embedding column
    (parquet.rs:379-407)."""
    name = str(column)
    matches = [opt.path for opt in columns if opt.path.split(".")[0] == name]
    if len(matches) == 1:
        return matches[0]
    if not matches:
        raise ValidationError(
            f"Embedding column '{name}' not found in parquet schema"
        )
    raise ValidationError(
        f"Embedding column '{name}' maps to multiple parquet leaf columns"
    )


def _max_row_group_rows(source: str | os.PathLike) -> int:
    md = pq.ParquetFile(source).metadata
    if md.num_row_groups == 0:
        return 1 << 20
    return max(md.row_group(i).num_rows for i in range(md.num_row_groups))


_PYARROW_CODECS = {
    "UNCOMPRESSED": "none",
    "SNAPPY": "snappy",
    "GZIP": "gzip",
    "BROTLI": "brotli",
    "LZ4": "lz4",
    "LZ4_RAW": "lz4",
    "ZSTD": "zstd",
}


def write_parquet_with_index(
    source: str | os.PathLike,
    output: str | os.PathLike,
    table: pa.Table,
    index: IvfIndex,
    embedding_column: EmbeddingColumn,
    row_group_size: int | None = None,
    metric: str = "l2",
    split_merge: bool = True,
) -> None:
    """Rewrite ``table`` to ``output`` with preserved column properties and
    the tuned embedding-column layout, then embed the index.

    Default path (``split_merge``): the embedding column and the remaining
    columns are written as separate pyarrow files — so pyarrow's file-global
    page-size/batch knobs apply ONLY to the embedding column, exactly the
    reference's per-column override (parquet.rs:324-345) — and merged
    byte-for-byte (io/merge.py). Falls back to the single-file writer (page
    size file-global) on any merge-path error.
    """
    if split_merge and table.num_columns > 1:
        try:
            _write_split_merge(
                source, output, table, index, embedding_column,
                row_group_size, metric,
            )
            return
        except (FormatError, ValidationError, pa.ArrowException, OSError):
            pass  # fall back to the single-file writer below
    _write_single(
        source, output, table, index, embedding_column, row_group_size, metric
    )


def _write_split_merge(
    source, output, table, index, embedding_column, row_group_size, metric
) -> None:
    import tempfile

    from .merge import merge_parquet_files

    vector_size = index.dim * 4
    options = collect_column_write_options(source)
    emb_path = embedding_leaf_path(options, embedding_column)
    emb_name = str(embedding_column)
    if emb_name not in table.column_names:
        raise ValidationError(f"Table has no column '{emb_name}'")
    if row_group_size is None:
        row_group_size = _max_row_group_rows(source)

    names = table.column_names
    emb_idx = names.index(emb_name)
    groups: list[tuple[str, list[str]]] = []
    before = names[:emb_idx]
    after = names[emb_idx + 1 :]
    if before:
        groups.append(("rest0", before))
    groups.append(("emb", [emb_name]))
    if after:
        groups.append(("rest1", after))

    opt_by_root = {opt.path.split(".")[0]: opt for opt in options}
    tmpdir = tempfile.mkdtemp(prefix="pqv_merge_")
    parts: list[str] = []
    try:
        for tag, cols in groups:
            part_path = os.path.join(tmpdir, f"{tag}.parquet")
            sub = table.select(cols)
            if tag == "emb":
                kwargs: dict = dict(
                    compression={
                        opt.path: _PYARROW_CODECS.get(opt.compression, "snappy")
                        for opt in options
                        if opt.path == emb_path
                    },
                    use_dictionary=False,
                    write_statistics=True,  # chunk stats (parquet.rs:342)
                    write_page_index=True,  # offset index: page-exact reads
                    data_page_size=vector_size,
                    write_batch_size=max(index.dim, 64),
                    store_schema=False,
                )
            else:
                col_opts = [
                    opt
                    for opt in options
                    if opt.path.split(".")[0] in cols
                ]
                kwargs = dict(
                    compression={
                        opt.path: _PYARROW_CODECS.get(opt.compression, "snappy")
                        for opt in col_opts
                    },
                    use_dictionary=[
                        opt.path for opt in col_opts if opt.dictionary_enabled
                    ],
                    write_statistics=[
                        opt.path
                        for opt in col_opts
                        if opt.statistics_enabled != "none"
                    ],
                    write_page_index=any(
                        opt.statistics_enabled == "page" for opt in col_opts
                    ),
                    store_schema=False,
                )
                enc = {
                    opt.path: opt.encoding
                    for opt in col_opts
                    if opt.encoding not in (None, "PLAIN")
                    and not opt.dictionary_enabled
                }
                if enc:
                    kwargs["column_encoding"] = enc
            try:
                with pq.ParquetWriter(part_path, sub.schema, **kwargs) as w:
                    w.write_table(sub, row_group_size=row_group_size)
            except (pa.ArrowException, OSError):
                kwargs.pop("column_encoding", None)
                with pq.ParquetWriter(part_path, sub.schema, **kwargs) as w:
                    w.write_table(sub, row_group_size=row_group_size)
            parts.append(part_path)
        merge_parquet_files(parts, output)
    finally:
        for p in parts:
            try:
                os.unlink(p)
            except OSError:
                pass
        try:
            os.rmdir(tmpdir)
        except OSError:
            pass

    append_index_inplace(output, index, embedding_column, metric=metric)


def _write_single(
    source, output, table, index, embedding_column, row_group_size, metric
) -> None:
    vector_size = index.dim * 4
    options = collect_column_write_options(source)
    emb_path = embedding_leaf_path(options, embedding_column)

    compression = {opt.path: _PYARROW_CODECS.get(opt.compression, "snappy") for opt in options}
    use_dictionary = [
        opt.path for opt in options if opt.dictionary_enabled and opt.path != emb_path
    ]
    write_statistics = [
        opt.path for opt in options if opt.statistics_enabled != "none"
    ]
    # Always write the page index: parquet-rs (the reference writer) always
    # emits the offset index, and our page-level selective reader
    # (io/pages.py) needs it to fetch candidate rows without touching whole
    # row groups.
    write_page_index = True
    column_encoding = {
        opt.path: opt.encoding
        for opt in options
        if opt.encoding is not None and not opt.dictionary_enabled
    }
    # pyarrow only honors column_encoding when dictionary is globally
    # controllable; skip encodings that equal the default PLAIN to minimize
    # writer-property conflicts.
    column_encoding = {
        path: enc for path, enc in column_encoding.items() if enc != "PLAIN"
    }

    writer_kwargs: dict = dict(
        compression=compression,
        use_dictionary=use_dictionary,
        write_statistics=write_statistics,
        write_page_index=write_page_index,
        data_page_size=vector_size,
        write_batch_size=max(index.dim, 64),
    )
    if column_encoding:
        writer_kwargs["column_encoding"] = column_encoding

    if row_group_size is None:
        row_group_size = _max_row_group_rows(source)

    def _write(kwargs: dict) -> None:
        with pq.ParquetWriter(output, table.schema, **kwargs) as writer:
            writer.write_table(table, row_group_size=row_group_size)

    try:
        _write(writer_kwargs)
    except (pa.ArrowException, OSError):
        # Encoding/dictionary combinations unsupported by this pyarrow build:
        # retry without explicit encodings (compression/stats still preserved).
        writer_kwargs.pop("column_encoding", None)
        _write(writer_kwargs)

    append_index_inplace(output, index, embedding_column, metric=metric)
