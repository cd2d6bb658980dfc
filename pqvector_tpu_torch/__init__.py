"""pqvector-tpu on PyTorch: IVF vector search over Parquet files on a GPU.

A port of the JAX package ``pqvector_tpu`` to PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (sm_90a). It builds an IVF index into a Parquet
file (``IndexBuilder``), serves exact and IVF top-k from device-resident
embeddings (``DeviceIvfSearcher``), and has the reference's two front doors:
the standalone ``TopkBuilder`` and the SQL engine (``engine.Session``, whose
``ORDER BY array_distance(col, [q]) LIMIT k`` rewrite reads only candidate
rows). ``python -m pqvector_tpu_torch`` is its command line. It imports
neither JAX nor the JAX package. Its kernels compile at first CUDA use and
are cached on disk across processes (``utils/cache.py``).

fp32 selection scores must be IEEE fp32: TF32 keeps about three decimal
digits, which reorders near neighbours on clustered data, so importing the
package turns it off for matmuls and cuDNN.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .utils.cache import enable_compilation_cache as _enable_cache  # noqa: E402

_enable_cache()

from .builder import IndexBuilder  # noqa: E402
from .errors import (  # noqa: E402
    ExecutionError,
    FormatError,
    PlanError,
    PqVectorError,
    ValidationError,
)
from .index import IvfBuildConfig, IvfIndex, build_ivf_index  # noqa: E402
from .io.embed import has_pq_vector_index  # noqa: E402
from .query import DeviceIvfSearcher, SearchResult, TopkBuilder  # noqa: E402
from .types import ClusterCount, EmbeddingColumn, EmbeddingDim, Embeddings  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ClusterCount",
    "DeviceIvfSearcher",
    "EmbeddingColumn",
    "EmbeddingDim",
    "Embeddings",
    "ExecutionError",
    "FormatError",
    "IndexBuilder",
    "IvfBuildConfig",
    "IvfIndex",
    "PlanError",
    "PqVectorError",
    "SearchResult",
    "TopkBuilder",
    "ValidationError",
    "build_ivf_index",
    "has_pq_vector_index",
    "__version__",
]
