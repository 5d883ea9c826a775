"""Multi-device parallelism: the doc-sharded index and mesh search."""

from __future__ import annotations

import tempfile
from typing import Optional, Sequence

import torch

from .sharded import ShardedDeviceIndex, make_mesh

__all__ = ["ShardedDeviceIndex", "make_mesh", "dryrun_multichip"]


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> None:
    """A full sharded search step over a mesh of ``n_devices`` on five
    tiny documents: pure-OR and masked queries under both ranking
    algorithms, a batch, and a removal followed by a re-search (the
    alive bitmap flips with no rebuild).  ``devices`` defaults to the
    CPU repeated ``n_devices`` times (the twin of
    ``__graft_entry__.dryrun_multichip``, which needs a subprocess to
    pin JAX's backend; torch has no backend state to scrub)."""
    from ..nxs import Nxs
    from ..params import Params

    if devices is None:
        devices = [torch.device("cpu")] * n_devices
    mesh = make_mesh(devices)[:n_devices]
    assert len(mesh) == n_devices, (
        f"need {n_devices} devices, have {len(mesh)}")

    with tempfile.TemporaryDirectory() as basedir:
        nxs = Nxs(basedir, mesh=mesh)
        try:
            idx = nxs.index_create("dryrun")
            docs = [
                (1, "the quick brown fox jumped over the lazy dog"),
                (2, "once upon a time there were three little foxes"),
                (3, "dogs and cats living together in harmony"),
                (4, "a dog chasing a cat chasing a mouse"),
                (5, "pack my box with five dozen liquor jugs"),
            ]
            for doc_id, text in docs:
                idx.add(doc_id, text)

            r1 = idx.search("fox dog")
            r2 = idx.search("dog AND NOT cat",
                            Params().set_str("algo", "TF-IDF"))
            assert {d for d, _ in r1} == {1, 2, 3, 4}, r1.tojson()
            assert {d for d, _ in r2} == {1}, r2.tojson()
            rs = idx.search_many(["fox", "dog AND cat", "liquor jugs"])
            assert {d for d, _ in rs[0]} == {1, 2}, rs[0].tojson()
            assert {d for d, _ in rs[1]} == {3, 4}, rs[1].tojson()
            assert {d for d, _ in rs[2]} == {5}, rs[2].tojson()
            pack = idx.dev.postings_pack
            idx.remove(2)
            assert {d for d, _ in idx.search("fox")} == {1}
            assert idx.dev.postings_pack is pack
        finally:
            nxs.close()
