"""Streaming ingest: chunk sources and the two-pass construct.

Counterpart of ``lightgbm_tpu/data/``. ``Dataset(chunked_source | path,
params={"ingest_chunk_rows": N})`` constructs training data without
the dense float matrix ever existing: :mod:`.sources` defines the
re-iterable :class:`RowChunkSource` protocol and its adapters (numpy
array, generator factory, ``Sequence``, CSV/TSV, Arrow/parquet when
pyarrow is installed); :mod:`.ingest` runs the two passes — sample ->
BinMappers -> chunk by chunk binned on the device into the
preallocated device matrix. (``INGEST_FAULT_ITERATION`` is where
the distributed fault kind ``rank_kill@-1`` fires.)
"""

from .ingest import IngestResult, dataset_digest, ingest_dataset
from .sources import (DEFAULT_CHUNK_ROWS, ArrayChunkSource,
                      ArrowChunkSource, CSVChunkSource,
                      GeneratorChunkSource, RowChunk, RowChunkSource,
                      SequenceChunkSource, coerce_chunk_source)

__all__ = [
    "RowChunk", "RowChunkSource", "ArrayChunkSource",
    "GeneratorChunkSource", "SequenceChunkSource", "CSVChunkSource",
    "ArrowChunkSource", "coerce_chunk_source", "DEFAULT_CHUNK_ROWS",
    "ingest_dataset", "IngestResult", "dataset_digest",
]
