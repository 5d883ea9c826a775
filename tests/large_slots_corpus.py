"""A real index of just over 2**24 documents, for the port's tests of
snapshots of 2**24 device slots and more (``test_torch_large_slots.py``
on the CPU, ``test_torch_cuda.py`` on the card).  It imports neither
jax nor nxsearch_tpu.

Documents go in through ``HostIndex.add_bulk_arrays`` in 2**21-document
calls (the native tokenizer's array form, without the text):

- filler: document ``i + 1`` at host slot ``i`` holds one token,
  ``f{i % FILLER_TERMS}`` (length 1), or ``f0`` from host slot 2**24
  on, so ``f0`` has the largest df (4159) and documents in device
  slots past 2**24;
- ``TAIL`` documents at host slots spread over the index, each of
  length 4: ``tail`` (tf 1 or 2), its unique ``u{k}`` (tf 2 or 1) and
  ``p{k // 2}`` (tf 1).  Device slots ascend by document length
  (stable), so they take the last ``TAIL`` device slots, 2**24 + 40 on,
  in host order: odd and even slots past 2**24, and each ``p{m}`` pairs
  an even slot with the odd one above it, which f32 rounds onto it;
- ``LOW`` documents of length 1 holding ``low{j}``, below 2**24.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

N_DOCS = (1 << 24) + 64
FILLER_TERMS = 4096
BATCH = 1 << 21
TAIL = 24
TAIL_HOST = [12_345 + k * 699_001 for k in range(TAIL)]
LOW_HOST = [3, 1 << 22, (1 << 24) - 30]


# Queries of the corpus's terms: tail documents (odd and even slots
# past 2**24), low ones, pairs f32 would merge, and filler (4096 ties).
QUERIES = (["tail", "low0", "low1", "low2", "low0 tail", "u5 p7 low2",
            "f17", "f17 u3"]
           + [f"u{k}" for k in range(TAIL)]
           + [f"p{m}" for m in range(TAIL // 2)])
# 39 unique terms and a NOT: the dense executor.
WIDE = (" ".join([f"u{k}" for k in range(TAIL)]
                 + [f"p{m}" for m in range(TAIL // 2)]
                 + ["low0", "low1", "f9"]) + " AND NOT p3")


def special_docs() -> dict:
    """host slot -> [(term, count), ...] of the non-filler documents."""
    out = {}
    for k, h in enumerate(TAIL_HOST):
        t = 1 + k % 2
        out[h] = [("tail", t), (f"u{k}", 3 - t), (f"p{k // 2}", 1)]
    for j, h in enumerate(LOW_HOST):
        out[h] = [(f"low{j}", 1)]
    return out


def add_corpus(host) -> None:
    """Add the corpus to an empty HostIndex."""
    special = special_docs()
    assert len(special) == TAIL + len(LOW_HOST)
    filler = [f"f{r}" for r in range(FILLER_TERMS)]
    for lo in range(0, N_DOCS, BATCH):
        hi = min(lo + BATCH, N_DOCS)
        n = hi - lo
        mine = sorted(h for h in special if lo <= h < hi)
        table = filler + sorted({term for h in mine for term, _ in special[h]})
        tix = {v: i for i, v in enumerate(table)}
        n_pairs = np.ones(n, dtype=np.int64)
        for h in mine:
            n_pairs[h - lo] = len(special[h])
        doc_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(n_pairs, out=doc_ptr[1:])
        pairs = np.empty((int(doc_ptr[-1]), 2), dtype=np.uint32)
        first = doc_ptr[:-1]
        host_slot = np.arange(lo, hi)
        pairs[first, 0] = np.where(host_slot >= 1 << 24, 0,
                                   host_slot % FILLER_TERMS)
        pairs[first, 1] = 1
        seen = np.ones(n, dtype=np.uint32)
        for h in mine:
            at = int(doc_ptr[h - lo])
            for j, (term, count) in enumerate(special[h]):
                pairs[at + j] = (tix[term], count)
            seen[h - lo] = sum(c for _, c in special[h])
        host.add_bulk_arrays(np.arange(lo + 1, hi + 1, dtype=np.int64),
                             table, pairs, doc_ptr, seen)


def device_slot_of(dev, doc_id: int) -> int:
    """The device slot of a document of the base snapshot."""
    host_slot = dev.host.doc_lookup(doc_id)
    return int(np.nonzero(dev.slot_perm == host_slot)[0][0])


# -- executor level ---------------------------------------------------------

PLAIN_SLOTS = (1 << 24) + 1024        # padded slots of the stand-in


def plain_columns(slots) -> dict:
    """The snapshot columns of a stand-in with one posting per term, in
    slot ``slots[i]`` for term i (ltf log 2, every document of length
    1, every slot alive), as numpy arrays: ``slot``, ``ltf``, ``dl``,
    ``alive`` (uint32 bitmap)."""
    n = len(slots)
    return {"slot": np.asarray(slots, dtype=np.int32),
            "ltf": np.full(n, np.log(2.0), dtype=np.float32),
            "dl": np.ones(PLAIN_SLOTS, dtype=np.float32),
            "alive": np.full(PLAIN_SLOTS // 32, 0xFFFFFFFF, dtype=np.uint32)}


def plain_dev(slots):
    """A stand-in snapshot of PLAIN_SLOTS slots for
    ``search._dispatch_plain`` (see plain_columns)."""
    cols = plain_columns(slots)
    return SimpleNamespace(
        n_slots=PLAIN_SLOTS, device=torch.device("cpu"),
        postings_slot=torch.from_numpy(cols["slot"]),
        postings_ltf=torch.from_numpy(cols["ltf"]),
        doc_len=torch.from_numpy(cols["dl"]),
        alive_mask=torch.from_numpy(cols["alive"].view(np.int32)),
        adl_dev=torch.tensor(1.0))


def plain_plan(term: int, use_dense: bool):
    """A one-term candidate (or dense) plan of term ``term``."""
    return SimpleNamespace(
        q_start=np.asarray([term, 0], dtype=np.int32),
        q_len=np.asarray([1, 0], dtype=np.int32),
        q_idf=np.asarray([1.0, 0.0], dtype=np.float32),
        prog_ops=np.zeros(16, dtype=np.int32),
        prog_args=np.zeros(16, dtype=np.int32),
        budget=1024, use_mask=False, depth=4, use_dense=use_dense)
