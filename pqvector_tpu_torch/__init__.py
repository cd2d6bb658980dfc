"""pqvector-tpu on PyTorch: IVF vector search over Parquet files on a GPU.

A port of the JAX package ``pqvector_tpu`` to PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (sm_90a). This slice builds an IVF index into a
Parquet file (``IndexBuilder``) and serves exact and IVF top-k from
device-resident embeddings (``DeviceIvfSearcher``). It imports neither JAX
nor the JAX package.

fp32 selection scores must be IEEE fp32: TF32 keeps about three decimal
digits, which reorders near neighbours on clustered data, so importing the
package turns it off for matmuls and cuDNN.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

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
from .query import DeviceIvfSearcher  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DeviceIvfSearcher",
    "ExecutionError",
    "FormatError",
    "IndexBuilder",
    "IvfBuildConfig",
    "IvfIndex",
    "PlanError",
    "PqVectorError",
    "ValidationError",
    "build_ivf_index",
    "has_pq_vector_index",
    "__version__",
]
