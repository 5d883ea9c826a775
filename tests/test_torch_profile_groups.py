"""NXS_PROFILE_GROUPS: one trace line per dispatch group, in dispatch
order, with the group's key, row count and device time (on the CPU the
host clock between launches, which run in place)."""

import logging
import re

import numpy as np
import torch

import bench
from nxsearch_tpu_torch import Nxs, Params
from nxsearch_tpu_torch import search as psearch

LINE = re.compile(r"group (.+) n=(\d+) device (\d+\.\d\d) ms \((\d+) us/q\)")


def _queries():
    words = np.array([f"w{i:05d}" for i in range(6000)])
    probs = 1.0 / (np.arange(6000, dtype=np.float64) + 10.0)
    probs /= probs.sum()
    return bench.make_mixed_queries(256, words, probs,
                                    np.random.default_rng(43))


def test_profile_groups_logs_each_group(tmp_path, monkeypatch, caplog):
    # Small tensors: one intra-op thread runs them faster, and keeps
    # doing so when the suite's workers share the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    nxs = Nxs(str(tmp_path), device="cpu")
    try:
        idx = nxs.index_create("t")
        idx.add_many(bench.zipf_range(0, 2000, 6000, 20))
        sp = Params().set_uint("limit", 10)
        queries = _queries()
        idx.search_many(queries[:8], sp)           # builds the snapshot
        groups = []
        submit = psearch._submit_plans

        def recorded(*a, **kw):
            st = submit(*a, **kw)
            groups.append(st.profile)
            return st

        monkeypatch.setattr(psearch, "_submit_plans", recorded)
        caplog.set_level(logging.INFO, logger="nxsearch_tpu")
        idx.search_many(queries, sp)               # the flag is off
        assert groups == [None]
        assert not [r for r in caplog.records if LINE.match(r.getMessage())]

        monkeypatch.setenv("NXS_PROFILE_GROUPS", "1")
        groups.clear()
        want = idx.search_many(queries, Params().set_uint("limit", 10))
        lines = [LINE.match(r.getMessage()) for r in caplog.records
                 if r.name == "nxsearch_tpu.trace"]
        lines = [m for m in lines if m]
        (keys, marks), = groups
        assert len(keys) > 2 and len(marks) == len(keys) + 1
        assert [(m.group(1), int(m.group(2))) for m in lines] == \
            [(str(key), n) for key, n in keys]
        assert all(float(m.group(3)) >= 0.0 for m in lines)
        assert 0 < sum(n for _k, n in keys) <= len(queries)
        monkeypatch.delenv("NXS_PROFILE_GROUPS")
        again = idx.search_many(queries, sp)
        assert [r.results for r in again] == [r.results for r in want]
    finally:
        nxs.close()
        torch.set_num_threads(threads)
