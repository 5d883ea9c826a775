"""Port hygiene: the carried-over host modules stay byte-identical to
the reference (the planner AST-identical), the port never imports jax,
its kernel wrappers never fall back to a plain twin for a non-CPU
tensor, and the files that predate the port stay as they were."""

import ast
import functools
import os
import re
import subprocess
import sys

import pytest
import torch

from nxsearch_tpu_torch.ops import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "nxsearch_tpu")
PORT = os.path.join(ROOT, "nxsearch_tpu_torch")

# Host modules the port carries as byte-for-byte copies (their imports
# are relative; the reference package cannot be imported without jax).
VERBATIM = (
    ["errors.py", "params.py", "resp.py",
     "index/__init__.py", "index/storage.py", "index/hostindex.py",
     "utils/__init__.py", "utils/log.py", "utils/rwlock.py",
     "utils/validate.py", "utils/malloc.py",
     "service/storage.py", "service/openapi.py"]
    + [f"text/{f}" for f in sorted(os.listdir(os.path.join(REF, "text")))
       if f.endswith(".py")]
    + [f"query/{f}" for f in sorted(os.listdir(os.path.join(REF, "query")))
       if f.endswith(".py")])


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_copy_is_byte_identical(rel):
    with open(os.path.join(REF, rel), "rb") as a, \
            open(os.path.join(PORT, rel), "rb") as b:
        assert a.read() == b.read(), rel


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_import_in_port():
    assert os.path.join(PORT, "parallel", "sharded.py") in set(
        _port_sources())
    pattern = re.compile(r"^\s*(import jax|from jax|import nxsearch_tpu\b"
                         r"|from nxsearch_tpu\b(?!_torch))", re.M)
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders


def test_port_answers_a_search_without_jax(tmp_path):
    """A process in which jax cannot be imported imports the port and
    answers a 3-doc search (and a fuzzy one) on the CPU."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, {ROOT!r})
from nxsearch_tpu_torch import Nxs
nxs = Nxs({str(tmp_path)!r}, device="cpu")
idx = nxs.index_create("t")
idx.add(1, "The quick brown fox jumped over the lazy dog")
idx.add(2, "Dogs and cats living together")
idx.add(3, "A fox and a dog")
print([d for d, _ in idx.search("fox").results])
print([d for d, _ in idx.search_many(["cats", "foxx"])[1].results])
assert not any(m == "jax" or m.startswith(("jax.", "nxsearch_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
nxs.close()
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[0] == "[3, 1]"
    assert lines[1] == "[3, 1]"


def test_entry_modules_import_without_jax():
    """The service, the CLI, parallel ingest and the mesh import in a
    process in which jax cannot be imported, and import no jax; the mesh
    runs its dryrun on two CPU shards there."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, {ROOT!r})
import nxsearch_tpu_torch.benchmark
import nxsearch_tpu_torch.ingest
import nxsearch_tpu_torch.parallel
import nxsearch_tpu_torch.service
from nxsearch_tpu_torch import parallel_ingest
from nxsearch_tpu_torch.parallel import dryrun_multichip
from nxsearch_tpu_torch.service import SearchService, main
dryrun_multichip(2)
assert not any(m == "jax" or m.startswith(("jax.", "nxsearch_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout == "ok\n"


class _OnCard:
    """A CPU tensor that reports a CUDA device: what a wrapper reads of
    its inputs (device, dtype, shape, contiguity, pointer)."""

    def __init__(self, t, device):
        self.t, self.device = t, device

    def __getattr__(self, name):
        return getattr(self.t, name)


def test_wrappers_launch_on_the_tensors_device(monkeypatch):
    """Each wrapper hands its kernel the device of the tensors it was
    given (not the thread's current device), once per call."""
    card = torch.device("cuda", 1)
    seen = []
    monkeypatch.setattr(kernels.CudaKernel, "launch",
                        lambda self, device, *args: seen.append(
                            (self.symbol, device)))
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        real_empty(*a, **kw))

    def on_card(*ts):
        return [_OnCard(t.contiguous(), card) for t in ts]

    vb = torch.zeros((8, kernels.MAX_BYTES), dtype=torch.uint8)
    vl = torch.ones(8, dtype=torch.int32)
    for n_q in (1, 3):
        qb = torch.zeros((n_q, kernels.MAX_BYTES), dtype=torch.uint8)
        ql = torch.ones(n_q, dtype=torch.int32)
        kernels.myers_distances(*on_card(vb, vl, qb, ql))
        kernels.myers_rev_distances(*on_card(vb, vl, qb, ql))
    n_slots = kernels.BLOCK_SLOTS
    kernels.blockdense_scores(*on_card(
        torch.zeros(16, dtype=torch.int32), torch.zeros(16),
        torch.ones(n_slots), torch.ones(n_slots),
        torch.zeros((2, 3, 2), dtype=torch.int32), torch.zeros((2, 3, 4))),
        algo=0, use_mask=True)
    assert seen == [("nxs_myers_distances_one", card),
                    ("nxs_myers_rev_distances", card),
                    ("nxs_myers_distances", card),
                    ("nxs_myers_rev_distances", card),
                    ("nxs_segsum_blockdense", card)]


def test_wrapper_raises_for_non_cpu_tensors():
    """No silent fallback: a tensor that is not on the CPU launches
    the kernel or raises."""
    t = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    n = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        kernels.myers_distances(t, n, t, n)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    kernel = kernels.CudaKernel("myers.cu", "nxs_myers_distances", [])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.function()
    assert kernel.launches == 0


def test_default_device_is_cuda_and_never_falls_back(monkeypatch, tmp_path):
    from nxsearch_tpu_torch import Nxs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Nxs(str(tmp_path))
    assert Nxs(str(tmp_path), device="cpu").device.type == "cpu"


# Planner functions the port carries unchanged (comments and
# docstrings aside), so both packages build field-for-field equal plans.
PLANNER = ["get_search_params", "_bucket", "_slice_tier", "_head_tier",
           "_window_t0", "_t_ladder", "_tier_cols", "_choose_T",
           "_prefix_mode", "_row_pad", "_qs_pad", "_is_pure_or",
           "_Plan", "_build_plan_prefix", "_build_plan", "_pow2ceil",
           "_build_plans", "_plans_prefix", "_eval_program_np",
           "_delta_results", "_use_sliced", "_sharded_sliced",
           "_kernel_crows",
           "_to_response", "_ladder",
           "_coalesce_sliced_groups", "_coalesce_prefix_groups",
           "submit_query_batch", "_to_responses_group", "search",
           "_prepare_many", "search_many"]


@functools.lru_cache(maxsize=None)
def _defs(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            for n in ast.walk(node):
                body = getattr(n, "body", None)
                if (isinstance(body, list) and body
                        and isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)
                        and isinstance(body[0].value.value, str)):
                    n.body = body[1:] or [ast.Pass()]
            out[node.name] = ast.dump(node)
    return out


@pytest.mark.parametrize("name", PLANNER)
def test_planner_is_the_reference_planner(name):
    ref = _defs(os.path.join(REF, "search.py"))
    port = _defs(os.path.join(PORT, "search.py"))
    assert port[name] == ref[name], name


# Files that predate the port: the JAX package and what beside it the
# port must not touch.
PREDATING = ["nxsearch_tpu", "bench.py", "tools", "__graft_entry__.py",
             "tests/test_sharded.py", "tests/conftest.py"]


def test_files_that_predate_the_port_are_unchanged():
    """Against the commit before the port began (the parent of the
    commit that added nxsearch_tpu_torch/__init__.py) no file of
    PREDATING is modified, deleted or renamed -- the port adds files of
    its own under tools/ -- except that tests/conftest.py only gains
    the registration of the ``cuda`` marker."""
    def git(*args):
        return subprocess.run(["git", *args], cwd=ROOT, capture_output=True,
                              text=True, timeout=60)

    first = git("log", "--diff-filter=A", "--format=%H", "--",
                "nxsearch_tpu_torch/__init__.py")
    if first.returncode or not first.stdout.split():
        pytest.skip("not a git checkout with the port's history")
    base = first.stdout.split()[-1] + "~1"
    names = git("diff", "--name-only", "--diff-filter=DMRT", base, "--",
                *PREDATING)
    assert names.returncode == 0, names.stderr
    assert set(names.stdout.split()) <= {"tests/conftest.py"}
    diff = git("diff", "-U0", base, "--", "tests/conftest.py").stdout
    body = [line for line in diff.splitlines()
            if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    assert all(line.startswith("+") for line in body), body
    assert "".join(body) in ("", '+    config.addinivalue_line(+        '
                                 '"markers", "cuda: needs a CUDA card; skips '
                                 'where none is present")')
