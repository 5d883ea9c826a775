"""Hand-written CUDA kernels: build, load and launch, with plain twins.

Each kernel is CUDA C++ under ``csrc/``, compiled at first use by
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry
point, and bound with ``ctypes`` (no PyTorch headers: a build takes
seconds).  Libraries land in ``nxsearch_tpu_torch/_build/``, named by
a hash of their source, so an edited source rebuilds and a stale one
is never loaded.

Every wrapper takes its plain PyTorch twin only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises -- it never
falls back.  ``launches`` on each kernel object counts the wrapper's
kernel launches (never the twin's runs), so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
            "cannot be built on this machine")
    return path


class CudaKernel:
    """One kernel source with one C entry point, built on first use."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC_DIR, self.source)

    def library_path(self) -> str:
        with open(self.source_path, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")

    def build(self) -> str:
        """Compile the source unless a library of this hash exists;
        returns the library path.  Concurrent builds each write a
        private temp file and publish it with an atomic rename."""
        lib = self.library_path()
        if os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source_path]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {self.source}:"
                f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        return lib

    def function(self):
        """The bound C entry point (builds and loads on first call)."""
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    fn = getattr(ctypes.CDLL(self.build()), self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point on the current CUDA stream; raise if the
        launch was refused."""
        stream = torch.cuda.current_stream().cuda_stream
        rc = self.function()(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA launch failed with error {rc}")
        with self._lock:
            self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int

# csrc/myers.cu: replaces nxsearch_tpu/ops/pallas/fuzzy.py
# _myers_kernel_batch (forward bit-parallel Myers, batched queries).
MYERS = CudaKernel("myers.cu", "nxs_myers_distances",
                   [_P, _P, _P, _P, _P, _I, _I, _P])

MAX_BYTES = 32   # term / query row width of the Myers layout


def myers_distances_ref(vocab_bytes: torch.Tensor,  # uint8[W, 32]
                        vocab_len: torch.Tensor,    # int32[W]
                        q_bytes: torch.Tensor,      # uint8[M, 32]
                        q_len: torch.Tensor,        # int32[M]
                        ) -> torch.Tensor:
    """int32[M, W]: exact byte Levenshtein distances (plain torch).

    The twin of nxsearch_tpu/ops/levenshtein.py:myers_distances,
    batched over M queries.  u32 lane arithmetic runs in int64 and is
    masked back to 32 bits after every operation that can leave them.
    Terms with vocab_len == 0 return len(q); rows with q_len == 0
    return the term length -- both as the reference computes them.
    """
    dev = vocab_bytes.device
    n_q = q_bytes.shape[0]
    n_t = vocab_bytes.shape[0]
    full = 0xFFFFFFFF
    pos = torch.arange(MAX_BYTES, device=dev, dtype=torch.int64)
    q_valid = pos[None, :] < q_len.to(torch.int64)[:, None]       # [M, 32]
    hits = ((q_bytes.to(torch.int64)[:, :, None]
             == torch.arange(256, device=dev)[None, None, :])
            & q_valid[:, :, None])                                 # [M,32,256]
    peq = (hits.to(torch.int64) << pos[None, :, None]).sum(dim=1)  # [M, 256]

    m = q_len.to(torch.int64)[:, None]
    mask_m = torch.where(m >= 32, torch.full_like(m, full),
                         (1 << m.clamp(max=31)) - 1)
    high_bit = 1 << ((m - 1) & full).clamp(max=31)
    pv = mask_m.expand(n_q, n_t).clone()
    mv = torch.zeros((n_q, n_t), dtype=torch.int64, device=dev)
    score = q_len.to(torch.int32)[:, None].expand(n_q, n_t).clone()
    vb = vocab_bytes.to(torch.int64)
    vl = vocab_len.to(torch.int64)
    for j in range(vocab_bytes.shape[1]):
        active = (j < vl)[None, :]
        eq = peq[:, vb[:, j]]                                      # [M, W]
        xv = eq | mv
        xh = ((((eq & pv) + pv) & full) ^ pv) | eq
        ph = mv | (~(xh | pv) & full)
        mh = pv & xh
        inc = ((ph & high_bit) != 0).to(torch.int32)
        dec = ((mh & high_bit) != 0).to(torch.int32)
        score = score + torch.where(active, inc - dec, 0)
        ph = ((ph << 1) | 1) & full
        mh = (mh << 1) & full
        pv = torch.where(active, (mh | (~(xv | ph) & full)) & mask_m, pv)
        mv = torch.where(active, (ph & xv) & mask_m, mv)
    return score


def myers_distances(vocab_bytes: torch.Tensor, vocab_len: torch.Tensor,
                    q_bytes: torch.Tensor, q_len: torch.Tensor
                    ) -> torch.Tensor:
    """int32[M, W] Myers distances: the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors; any other device raises."""
    dev = vocab_bytes.device
    if dev.type == "cpu":
        return myers_distances_ref(vocab_bytes, vocab_len, q_bytes, q_len)
    if dev.type != "cuda":
        raise RuntimeError(f"myers_distances: no kernel for device {dev}")
    n_t, n_q = vocab_bytes.shape[0], q_bytes.shape[0]
    for name, t, dtype, shape in (
            ("vocab_bytes", vocab_bytes, torch.uint8, (n_t, MAX_BYTES)),
            ("vocab_len", vocab_len, torch.int32, (n_t,)),
            ("q_bytes", q_bytes, torch.uint8, (n_q, MAX_BYTES)),
            ("q_len", q_len, torch.int32, (n_q,))):
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"myers_distances: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if vocab_bytes.data_ptr() % 16:
        raise ValueError("myers_distances: vocab rows must be 16-byte "
                         "aligned")
    out = torch.empty((n_q, n_t), dtype=torch.int32, device=dev)
    if n_t and n_q:
        with torch.cuda.device(dev):
            MYERS.launch(vocab_bytes.data_ptr(), vocab_len.data_ptr(),
                         q_bytes.data_ptr(), q_len.data_ptr(),
                         out.data_ptr(), n_t, n_q)
    return out
