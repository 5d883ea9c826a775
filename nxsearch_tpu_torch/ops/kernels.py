"""Hand-written CUDA kernels: build, load and launch, with plain twins.

Each kernel is CUDA C++ under ``csrc/``, compiled at first use by
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry
point, and bound with ``ctypes`` (no PyTorch headers: a build takes
seconds).  Libraries land in ``nxsearch_tpu_torch/_build/``, named by
a hash of their source and of the headers under ``csrc/``, so an
edited source or header rebuilds and a stale library is never loaded.

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
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        headers = sorted(f for f in os.listdir(CSRC_DIR)
                         if f.endswith(".cuh"))
        for name in [self.source, *headers]:
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
        digest = h.hexdigest()[:16]
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

    def launch(self, device: torch.device, *args) -> None:
        """Call the entry point on ``device`` -- the device of the
        tensors whose pointers ``args`` carry -- under its device guard
        and on its current stream; raise if the launch was refused.
        The caller's thread may have any current device (a service
        request thread's is cuda:0)."""
        fn = self.function()
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA launch failed with error {rc}")
        with self._lock:
            self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int

# csrc/myers.cu: replaces nxsearch_tpu/ops/pallas/fuzzy.py
# _myers_kernel_batch (forward bit-parallel Myers, batched queries) and,
# with its single-query kernel, _myers_kernel.
MYERS = CudaKernel("myers.cu", "nxs_myers_distances",
                   [_P, _P, _P, _P, _P, _I, _I, _P])
MYERS_ONE = CudaKernel("myers.cu", "nxs_myers_distances_one",
                       [_P, _P, _P, _P, _P, _I, _P])
# csrc/myers_rev.cu: replaces nxsearch_tpu/ops/pallas/fuzzy.py
# _myers_rev_kernel_batch (transposed Myers: the term is the pattern).
MYERS_REV = CudaKernel("myers_rev.cu", "nxs_myers_rev_distances",
                       [_P, _P, _P, _P, _P, _I, _I, _P])

MAX_BYTES = 32   # term / query row width of the Myers layout
# csrc/myers_rev.cu's kChunk and kSigma: the transposed kernel groups
# its queries REV_CHUNK at a time into groups whose alphabets' union
# holds at most REV_SIGMA bytes (the rows of its char table).
REV_CHUNK = 32
REV_SIGMA = 32
_FULL = 0xFFFFFFFF


def _masks(length: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, high_bit) of a pattern length, as int64 holding u32: all
    ones at length >= 32, and the high bit clamps the u32-wrapped
    length - 1 to 31, so length 0 reads bit 31 (the reference's
    arithmetic, pallas/fuzzy.py:72-76 and :210-217)."""
    n = length.to(torch.int64)
    mask = torch.where(n >= 32, torch.full_like(n, _FULL),
                       (1 << n.clamp(max=31)) - 1)
    return mask, 1 << ((n - 1) & _FULL).clamp(max=31)


def _myers_step(eq, pv, mv, score, active, mask, high_bit):
    """One Myers step on u32 lanes held in int64 (masked back to 32
    bits after every operation that can leave them); lanes where
    ``active`` is false keep their state and score."""
    xv = eq | mv
    xh = ((((eq & pv) + pv) & _FULL) ^ pv) | eq
    ph = mv | (~(xh | pv) & _FULL)
    mh = pv & xh
    inc = ((ph & high_bit) != 0).to(torch.int32)
    dec = ((mh & high_bit) != 0).to(torch.int32)
    score = score + torch.where(active, inc - dec, 0)
    ph = ((ph << 1) | 1) & _FULL
    mh = (mh << 1) & _FULL
    pv = torch.where(active, (mh | (~(xv | ph) & _FULL)) & mask, pv)
    mv = torch.where(active, (ph & xv) & mask, mv)
    return pv, mv, score


def _peq(q_bytes: torch.Tensor, q_len: torch.Tensor) -> torch.Tensor:
    """int64[M, 256]: bit i of entry (q, c) is set where q[i] == c and
    i < len(q) -- each query's classic Peq table."""
    dev = q_bytes.device
    pos = torch.arange(MAX_BYTES, device=dev, dtype=torch.int64)
    q_valid = pos[None, :] < q_len.to(torch.int64)[:, None]       # [M, 32]
    hits = ((q_bytes.to(torch.int64)[:, :, None]
             == torch.arange(256, device=dev)[None, None, :])
            & q_valid[:, :, None])                                 # [M,32,256]
    return (hits.to(torch.int64) << pos[None, :, None]).sum(dim=1)


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
    n_q, n_t = q_bytes.shape[0], vocab_bytes.shape[0]
    peq = _peq(q_bytes, q_len)                                     # [M, 256]
    mask_m, high_bit = (x[:, None] for x in _masks(q_len))
    pv = mask_m.expand(n_q, n_t).clone()
    mv = torch.zeros((n_q, n_t), dtype=torch.int64, device=peq.device)
    score = q_len.to(torch.int32)[:, None].expand(n_q, n_t).clone()
    vb = vocab_bytes.to(torch.int64)
    vl = vocab_len.to(torch.int64)
    for j in range(vocab_bytes.shape[1]):
        pv, mv, score = _myers_step(peq[:, vb[:, j]], pv, mv, score,
                                    (j < vl)[None, :], mask_m, high_bit)
    return score


def myers_distances_one_ref(vocab_bytes: torch.Tensor,  # uint8[T, 32]
                            vocab_len: torch.Tensor,    # int32[T]
                            q_bytes: torch.Tensor,      # uint8[32]
                            q_len) -> torch.Tensor:
    """int32[T]: distances of ONE query to every term (plain torch).

    The port of nxsearch_tpu/ops/levenshtein.py:myers_distances (one
    query, one [T] sweep over term positions) and the twin of the
    single-query kernel (csrc/myers.cu, myers_one_kernel).  The
    jnp function builds Peq with a [T, L, 32] compare; here the query's
    256-entry table is built once and indexed by each term byte, which
    gives the same bits."""
    dev = vocab_bytes.device
    ql = torch.as_tensor(q_len, dtype=torch.int32, device=dev).reshape(1)
    peq = _peq(q_bytes.reshape(1, MAX_BYTES), ql)[0]               # [256]
    mask_m, high_bit = _masks(ql)
    n_t = vocab_bytes.shape[0]
    pv = mask_m.expand(n_t).clone()
    mv = torch.zeros(n_t, dtype=torch.int64, device=dev)
    score = ql.expand(n_t).clone()
    vb = vocab_bytes.to(torch.int64)
    vl = vocab_len.to(torch.int64)
    for j in range(vocab_bytes.shape[1]):
        pv, mv, score = _myers_step(peq[vb[:, j]], pv, mv, score, j < vl,
                                    mask_m, high_bit)
    return score


def rev_query_groups_ref(q_bytes: torch.Tensor,   # uint8[M, 32]
                         q_len: torch.Tensor,     # int32[M]
                         ) -> tuple[torch.Tensor, list, torch.Tensor]:
    """The transposed kernel's query grouping (plain torch; the mirror
    of csrc/myers_rev.cu's staging).

    A query's alphabet is the set of bytes its steps read (positions
    i < min(max(q_len, 0), 32)).  Queries are taken REV_CHUNK at a time
    and in order; each chunk opens a group, and a query joins the open
    group unless the union of their alphabets would exceed REV_SIGMA
    bytes, when it opens the next one.  Returns (group int64[M], each
    query's group, numbered across chunks; alphabets, per group the
    ascending int64 tensor of its bytes; rank int64[M, 32], each read
    byte's index in its group's alphabet, -1 where no step reads)."""
    dev = q_bytes.device
    n_q = q_bytes.shape[0]
    pos = torch.arange(MAX_BYTES, device=dev)
    read = pos[None, :] < q_len.to(torch.int64).clamp(0, MAX_BYTES)[:, None]
    qb = q_bytes.to(torch.int64)
    row = torch.arange(n_q, device=dev)[:, None].expand(n_q, MAX_BYTES)
    present = torch.zeros((n_q, 256), dtype=torch.bool, device=dev)
    present[row[read], qb[read]] = True
    sets = present.cpu()
    group, alphabets = [], []
    for c0 in range(0, n_q, REV_CHUNK):
        union = torch.zeros(256, dtype=torch.bool)
        for q in range(c0, min(c0 + REV_CHUNK, n_q)):
            merged = union | sets[q]
            if int(merged.sum()) > REV_SIGMA:
                alphabets.append(union.nonzero()[:, 0].to(dev))
                merged = sets[q]
            union = merged
            group.append(len(alphabets))
        alphabets.append(union.nonzero()[:, 0].to(dev))
    lut = torch.full((max(len(alphabets), 1), 256), -1, dtype=torch.int64,
                     device=dev)
    for g, alphabet in enumerate(alphabets):
        lut[g, alphabet] = torch.arange(len(alphabet), device=dev)
    group_t = torch.tensor(group, dtype=torch.int64, device=dev)
    rank = torch.where(read, lut[group_t[:, None], qb], -1)
    return group_t, alphabets, rank


def myers_rev_distances_ref(vocab_bytes: torch.Tensor,  # uint8[W, 32]
                            vocab_len: torch.Tensor,    # int32[W]
                            q_bytes: torch.Tensor,      # uint8[M, 32]
                            q_len: torch.Tensor,        # int32[M]
                            ) -> torch.Tensor:
    """int32[M, W]: the same distances by transposed Myers (plain torch).

    The twin of csrc/myers_rev.cu, following the arithmetic of
    nxsearch_tpu/ops/pallas/fuzzy.py:_myers_rev_kernel_batch: the term
    is the pattern and the query the text.  The char table (bit j of
    entry (c, t) set where term_t[j] == c and j < n_t) is built once
    over all 256 byte values and serves every query; each query
    position i < q_len reads row q[i] and runs one step on per-lane
    masks, the score starting at the term length.  (The kernel holds
    only the rows of a query group's bytes, rev_query_groups_ref; the
    rows it leaves out are never read, so the distances are the same.)
    Unlike the TPU kernel, bits at j >= n_t are never set (the kernel
    does the same); they cannot reach the score, so the two agree on
    every live lane."""
    dev = vocab_bytes.device
    n_q, n_t = q_bytes.shape[0], vocab_bytes.shape[0]
    pos = torch.arange(MAX_BYTES, device=dev, dtype=torch.int64)
    live = pos[None, :] < vocab_len.to(torch.int64)[:, None]       # [W, 32]
    lane = torch.arange(n_t, device=dev)[:, None].expand(n_t, MAX_BYTES)
    table = torch.zeros((256, n_t), dtype=torch.int64, device=dev)
    # Distinct powers of two per (c, t): the accumulated sum is the OR.
    table.index_put_((vocab_bytes.to(torch.int64)[live], lane[live]),
                     (1 << pos).expand(n_t, MAX_BYTES)[live],
                     accumulate=True)
    mask_n, high_bit = (x[None, :] for x in _masks(vocab_len))
    pv = mask_n.expand(n_q, n_t).clone()
    mv = torch.zeros((n_q, n_t), dtype=torch.int64, device=dev)
    score = vocab_len.to(torch.int32)[None, :].expand(n_q, n_t).clone()
    qb = q_bytes.to(torch.int64)
    ql = q_len.to(torch.int64)
    for i in range(MAX_BYTES):
        pv, mv, score = _myers_step(table[qb[:, i]], pv, mv, score,
                                    (i < ql)[:, None], mask_n, high_bit)
    return score


def _check_myers_args(fn: str, vocab_bytes, vocab_len, q_bytes, q_len):
    """Device, type, shape, contiguity and 16-byte row alignment of a
    Myers kernel's inputs; raises ValueError."""
    dev = vocab_bytes.device
    n_t, n_q = vocab_bytes.shape[0], q_bytes.shape[0]
    for name, t, dtype, shape in (
            ("vocab_bytes", vocab_bytes, torch.uint8, (n_t, MAX_BYTES)),
            ("vocab_len", vocab_len, torch.int32, (n_t,)),
            ("q_bytes", q_bytes, torch.uint8, (n_q, MAX_BYTES)),
            ("q_len", q_len, torch.int32, (n_q,))):
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if vocab_bytes.data_ptr() % 16:
        raise ValueError(f"{fn}: vocab rows must be 16-byte aligned")


def myers_distances(vocab_bytes: torch.Tensor, vocab_len: torch.Tensor,
                    q_bytes: torch.Tensor, q_len: torch.Tensor
                    ) -> torch.Tensor:
    """int32[M, W] Myers distances: the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors; any other device raises.  M == 1
    takes the single-query kernel (MYERS_ONE) and its twin
    myers_distances_one_ref: a choice by shape, on both devices."""
    dev = vocab_bytes.device
    n_t, n_q = vocab_bytes.shape[0], q_bytes.shape[0]
    if dev.type == "cpu":
        if n_q == 1:
            return myers_distances_one_ref(vocab_bytes, vocab_len,
                                           q_bytes[0], q_len)[None, :]
        return myers_distances_ref(vocab_bytes, vocab_len, q_bytes, q_len)
    if dev.type != "cuda":
        raise RuntimeError(f"myers_distances: no kernel for device {dev}")
    _check_myers_args("myers_distances", vocab_bytes, vocab_len, q_bytes,
                      q_len)
    out = torch.empty((n_q, n_t), dtype=torch.int32, device=dev)
    if n_t and n_q:
        ptrs = (vocab_bytes.data_ptr(), vocab_len.data_ptr(),
                q_bytes.data_ptr(), q_len.data_ptr(), out.data_ptr(), n_t)
        if n_q == 1:
            MYERS_ONE.launch(dev, *ptrs)
        else:
            MYERS.launch(dev, *ptrs, n_q)
    return out


def myers_rev_distances(vocab_bytes: torch.Tensor, vocab_len: torch.Tensor,
                        q_bytes: torch.Tensor, q_len: torch.Tensor
                        ) -> torch.Tensor:
    """int32[M, W] distances by transposed Myers: the CUDA kernel
    (csrc/myers_rev.cu) for CUDA tensors, the plain twin for CPU
    tensors; any other device raises.  Inputs as myers_distances."""
    dev = vocab_bytes.device
    if dev.type == "cpu":
        return myers_rev_distances_ref(vocab_bytes, vocab_len, q_bytes,
                                       q_len)
    if dev.type != "cuda":
        raise RuntimeError(
            f"myers_rev_distances: no kernel for device {dev}")
    _check_myers_args("myers_rev_distances", vocab_bytes, vocab_len,
                      q_bytes, q_len)
    n_t, n_q = vocab_bytes.shape[0], q_bytes.shape[0]
    out = torch.empty((n_q, n_t), dtype=torch.int32, device=dev)
    if n_t and n_q:
        MYERS_REV.launch(dev, vocab_bytes.data_ptr(), vocab_len.data_ptr(),
                         q_bytes.data_ptr(), q_len.data_ptr(),
                         out.data_ptr(), n_t, n_q)
    return out


# csrc/segsum.cu: replaces nxsearch_tpu/ops/pallas/segsum.py _make_kernel
# (block-dense per-slot scores and presence bits).
SEGSUM = CudaKernel("segsum.cu", "nxs_segsum_blockdense",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])

BLOCK_SLOTS = 1024      # slots per kernel block (R of the reference)
MAX_KERNEL_TERMS = 8    # wider queries run the kernel per 8-term group
SEGSUM_MAX_TERMS = 512  # one row's bounds pairs fit a tile (segsum.cu)


def blockdense_scores_ref(postings_slot: torch.Tensor,  # int32[P]
                          postings_ltf: torch.Tensor,   # f32[P]
                          doc_len: torch.Tensor,        # f32[S]
                          alive_f: torch.Tensor,        # f32[S] 0/1
                          bounds: torch.Tensor,         # int32[N, Q, G+1]
                          coef: torch.Tensor,           # f32[N, Q, 4]
                          *, algo: int, use_mask: bool
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores f32[N, S], bits int32[N, S] holding u32 words): the
    plain twin of the segsum kernel.

    Term by term, every posting of the term's range that lies in the
    block its bounds row assigns it to is added at its slot; one
    posting per (term, slot) makes each term's accumulate a plain add,
    so the per-slot summation order is the kernel's and the
    reference's.  Bounds rows must be non-decreasing (csr_block_bounds
    rows and the all-zero row are)."""
    dev = postings_slot.device
    n_batch, n_terms, n_edges = bounds.shape
    n_slots = doc_len.shape[0]
    acc = torch.zeros((n_batch, n_slots), dtype=torch.float32, device=dev)
    bits = torch.zeros((n_batch, n_slots), dtype=torch.int32, device=dev)
    b = bounds.to(torch.int64)
    for q in range(n_terms):
        lo, hi = b[:, q, 0], b[:, q, -1]
        cnt = (hi - lo).clamp(min=0)
        total = int(cnt.sum())
        if total == 0:
            continue
        row = torch.repeat_interleave(
            torch.arange(n_batch, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        j = lo[row] + torch.arange(total, device=dev) - first[row]
        slot = postings_slot[j].to(torch.int64)
        blk = (slot // BLOCK_SLOTS).clamp(0, n_edges - 2)
        ok = ((slot >= 0) & (slot < n_slots)
              & (b[row, q, blk] <= j) & (j < b[row, q, blk + 1]))
        row, slot, ltf = row[ok], slot[ok], postings_ltf[j[ok]]
        idf = coef[row, q, 0]
        if algo == 0:       # BM25
            c = (ltf * idf) / ((ltf + coef[row, q, 1])
                               + coef[row, q, 2] * doc_len[slot])
        else:               # TF-IDF
            c = ltf * idf
        acc.index_put_((row, slot), c, accumulate=True)
        if use_mask:
            # u32 bit min(q, 31) as an int32 word (bit 31 is the sign).
            bit = 1 << min(q, 31)
            bits[row, slot] = bits[row, slot] | (
                bit - (1 << 32) if bit >= 1 << 31 else bit)
    return acc * alive_f[None, :], bits


def blockdense_scores(postings_slot: torch.Tensor, postings_ltf: torch.Tensor,
                      doc_len: torch.Tensor, alive_f: torch.Tensor,
                      bounds: torch.Tensor, coef: torch.Tensor,
                      *, algo: int, use_mask: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot scores f32[N, S] and presence bits int32[N, S] (u32
    words) of N queries' term groups: the segsum kernel for CUDA
    tensors, the plain twin for CPU tensors; any other device raises.
    Inputs as blockdense_scores_ref; S is a multiple of BLOCK_SLOTS,
    at most SEGSUM_MAX_TERMS terms, doc_len, alive_f and coef 16-byte
    aligned."""
    dev = postings_slot.device
    if dev.type == "cpu":
        return blockdense_scores_ref(postings_slot, postings_ltf, doc_len,
                                     alive_f, bounds, coef, algo=algo,
                                     use_mask=use_mask)
    if dev.type != "cuda":
        raise RuntimeError(f"blockdense_scores: no kernel for device {dev}")
    n_post, n_slots = postings_slot.shape[0], doc_len.shape[0]
    n_batch, n_terms = bounds.shape[0], bounds.shape[1]
    if n_slots % BLOCK_SLOTS:
        raise ValueError(f"blockdense_scores: {n_slots} slots is not a "
                         f"multiple of {BLOCK_SLOTS}")
    n_blocks = n_slots // BLOCK_SLOTS
    for name, t, dtype, shape in (
            ("postings_slot", postings_slot, torch.int32, (n_post,)),
            ("postings_ltf", postings_ltf, torch.float32, (n_post,)),
            ("doc_len", doc_len, torch.float32, (n_slots,)),
            ("alive_f", alive_f, torch.float32, (n_slots,)),
            ("bounds", bounds, torch.int32, (n_batch, n_terms, n_blocks + 1)),
            ("coef", coef, torch.float32, (n_batch, n_terms, 4))):
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"blockdense_scores: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if n_terms > SEGSUM_MAX_TERMS:
        raise ValueError(f"blockdense_scores: {n_terms} terms; a launch "
                         f"takes at most {SEGSUM_MAX_TERMS}")
    for name, t in (("doc_len", doc_len), ("alive_f", alive_f),
                    ("coef", coef)):
        if t.data_ptr() % 16:
            raise ValueError(f"blockdense_scores: {name} must be 16-byte "
                             "aligned")
    scores = torch.empty((n_batch, n_slots), dtype=torch.float32, device=dev)
    bits = torch.empty((n_batch, n_slots), dtype=torch.int32, device=dev)
    if n_batch:
        SEGSUM.launch(dev, postings_slot.data_ptr(), postings_ltf.data_ptr(),
                      doc_len.data_ptr(), alive_f.data_ptr(),
                      bounds.data_ptr(), coef.data_ptr(),
                      scores.data_ptr(), bits.data_ptr(), n_batch,
                      n_terms, n_blocks, int(algo), int(use_mask))
    return scores, bits
