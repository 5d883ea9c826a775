"""The readers of the impact-prefix CUDA graphs' share
(perfbench/metrics/prefix_graph.share.requests and .stream): over a
made-up run, over a run of an engine that has no ``prefix.graph_*``
counter, in a cell that sends otherwise, and in tiny traced cells on the
CPU whose prefix groups go through the graph cache with a stand-in for
the capture (on the CPU the engine counts no graph group)."""

import time

import pytest
import torch

from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.ops import graphs
from perfbench import run as run_mod
from perfbench.conftest import make_tiny_root

NEW = {"requests": "prefix_graph.share.requests",
       "pipelined": "prefix_graph.share.stream"}
CELLS = {"requests": "trec_covid.or_requests",
         "pipelined": "msmarco.or_top10"}


def reader(name):
    return run_mod.load_reader(name, run_mod.ROOT)


def synthetic(send, exec_stats):
    return run_mod.Run(send=send, spans=None, t0=10.0, t1=20.0, units=2,
                       exec_stats=exec_stats)


COUNTERS = {"prefix": 900, "sliced": 30, "prefix.graph_replay": 45,
            "prefix.graph_capture": 3, "prefix.graph_eager": 2, "gc.us": 9}


@pytest.mark.parametrize("send", sorted(NEW))
def test_readings_of_a_made_up_run(send):
    assert reader(NEW[send])(synthetic(send, COUNTERS)) == \
        pytest.approx(45 / 50)
    eager = {"prefix.graph_eager": 4}
    assert reader(NEW[send])(synthetic(send, eager)) == 0.0


@pytest.mark.parametrize("send", sorted(NEW))
def test_the_parent_reads_nothing(send):
    """An engine without the graph counters (or a run on the CPU): None,
    and nothing raises."""
    assert reader(NEW[send])(synthetic(send, {"prefix": 900})) is None
    assert reader(NEW[send])(synthetic(send, {})) is None


@pytest.mark.parametrize("send", sorted(NEW))
def test_each_reader_keeps_to_its_send(send):
    other = "pipelined" if send == "requests" else "requests"
    assert reader(NEW[send])(synthetic(other, COUNTERS)) is None


class _StandIn:
    """A captured chain that runs the chain eagerly at each replay."""

    def __init__(self, device, n, fn, pool):
        self.fn, self.pool = fn, None

    def replay(self, host_in):
        return self.fn(torch.from_numpy(host_in.copy()))


@pytest.mark.parametrize("send", sorted(NEW))
def test_tiny_traced_cell_reads_the_share(tmp_path, monkeypatch, send):
    monkeypatch.setattr(graphs, "CapturedChain", _StandIn)
    monkeypatch.setattr(psearch, "_prefix_graphs",
                        lambda dev, r: None if r else dev.prefix_graphs)
    root = make_tiny_root(str(tmp_path))
    out = run_mod.run_cell(CELLS[send], 2**31 + 2020, 1, True,
                           torch.device("cpu"), root=root,
                           t_start=time.perf_counter(), log=lambda m: None)
    assert out["correct"], out["checks"]
    m = out["metrics"][NEW[send]]
    assert m["unit"] == "1"
    # The share grows with the window's requests; a loaded host may send
    # only one in the second, whose groups all capture.
    assert 0.0 <= m["value"] <= 1.0
    other = NEW["pipelined" if send == "requests" else "requests"]
    assert other not in out["metrics"]
