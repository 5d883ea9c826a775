"""nxsearch_tpu_torch: the nxsearch engine on PyTorch and CUDA.

A port of nxsearch_tpu (JAX/Pallas on a TPU) to PyTorch on an NVIDIA
H100: the same index files, query language, scores and result order.
Host machinery (journals, text pipeline, query parser, planner) is
carried over from the reference package; device work runs in torch,
and the reference's Pallas kernels become hand-written CUDA kernels
(csrc/, ops/kernels.py).  Imports torch, never jax.  Entry points:
Nxs / Index, parallel_ingest (ingest.py), the REST service
(``python -m nxsearch_tpu_torch.service``) and the benchmark CLI
(``python -m nxsearch_tpu_torch.benchmark``).
"""

from .errors import ErrorCode, NxsError
from .ingest import parallel_ingest
from .nxs import Index, Nxs
from .params import Params
from .resp import Response

__all__ = ["Nxs", "Index", "Params", "Response", "NxsError", "ErrorCode",
           "parallel_ingest"]
__version__ = "0.1.0"
