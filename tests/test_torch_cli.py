"""The port's benchmark / operations CLI (nxsearch_tpu_torch/benchmark.py)
against the reference's (nxsearch_tpu/benchmark.py), on the CPU.

Both run the same steps on their own basedirs over a directory of
three files: add the directory, search (BM25 and TF-IDF, with a
limit), remove a document, search again, remove it again (an error).
Exit codes and standard error are equal; standard output is equal once
the timing lines (``<op>: N ms``) are dropped, the results' JSON up to
the score tolerance of the reference's tests (1e-4).
"""

import json
import re

import pytest
import torch

from nxsearch_tpu import benchmark as jbench
from nxsearch_tpu_torch import benchmark as pbench

TOL = 1e-4
TIMING = re.compile(r"^[a-z-]+: \d+ ms$")

FILES = {"a.txt": "The quick brown fox jumped over the lazy dog",
         "b.txt": "Dogs and cats living together, dogs everywhere",
         "c.txt": "A fox and a dog and a cat"}

STEPS = [["-a"], ["-s", "dog fox"], ["-s", "dog", "--algo", "TF-IDF"],
         ["-s", "cat OR fox", "--limit", "2"], ["-s", "dgo"],
         ["-r", "-d", "2"], ["-s", "dog AND NOT fox"], ["-r", "-d", "2"]]


def _run(main, capsys, argv):
    rc = main(argv)
    out, err = capsys.readouterr()
    lines = [line for line in out.splitlines() if not TIMING.match(line)]
    return rc, lines, err


def _same_json(ref, got):
    want, have = json.loads(ref), json.loads(got)
    assert have["count"] == want["count"]
    assert [r["doc_id"] for r in have["results"]] == \
        [r["doc_id"] for r in want["results"]]
    for a, b in zip(have["results"], want["results"]):
        assert abs(a["score"] - b["score"]) <= TOL


def test_cli_matches_reference(tmp_path, capsys):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for name, text in FILES.items():
        (corpus / name).write_text(text)
    n_json = 0
    for step in STEPS:
        extra = ["-p", str(corpus)] if step == ["-a"] else []
        argv = ["-i", "cli", *step, *extra]
        want = _run(jbench.main, capsys,
                    argv + ["--basedir", str(tmp_path / "ref")])
        got = _run(pbench.main, capsys,
                   argv + ["--basedir", str(tmp_path / "port"),
                           "--device", "cpu"])
        assert got[0] == want[0], step
        assert got[2] == want[2], step
        assert len(got[1]) == len(want[1]), step
        for a, b in zip(want[1], got[1]):
            if a.startswith("{"):
                _same_json(a, b)
                n_json += 1
            else:
                assert a == b, step
    assert n_json == 5


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbench.main(["-i", "cli", "-s", "x", "--basedir", str(tmp_path)])
