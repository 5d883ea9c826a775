"""Benchmark / operations CLI (reference: src/utils/benchmark.c).

Port of nxsearch_tpu/benchmark.py, with ``--device`` (default
``cuda``, which raises where no card is present; ``cpu`` runs on the
CPU).

Same surface as the reference's ``nxsearch_test`` binary: open-or-
create an index, add a file or every regular file in a directory
(doc_id = sequence order), remove a document, or run a search -- each
phase timed in wall-clock milliseconds, printed as ``<op>: N ms``
(benchmark.c:44-70).

    python -m nxsearch_tpu_torch.benchmark -i myindex -a -p corpus_dir/
    python -m nxsearch_tpu_torch.benchmark -i myindex -s "some query"
    python -m nxsearch_tpu_torch.benchmark -i myindex -r -d 7

NXS_BASEDIR selects the base directory, as in the reference library.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from contextlib import contextmanager

from . import Nxs, NxsError, Params


@contextmanager
def timed(operation: str):
    t0 = time.perf_counter()
    yield
    print(f"{operation}: {int((time.perf_counter() - t0) * 1000)} ms")


def _iter_docs(path: str):
    if os.path.isdir(path):
        doc_id = 1
        for name in sorted(os.listdir(path)):
            fpath = os.path.join(path, name)
            if os.path.isfile(fpath):
                print(f"Indexing {doc_id} -- {name}")
                with open(fpath, "r", encoding="utf-8",
                          errors="replace") as f:
                    yield doc_id, f.read()
                doc_id += 1
    else:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            yield 1, f.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="nxsearch-tpu benchmark/operations CLI")
    ap.add_argument("-i", "--index", required=True, help="index name")
    ap.add_argument("-a", "--add", action="store_true",
                    help="index the file/directory given with --path")
    ap.add_argument("-p", "--path", help="file or directory to index")
    ap.add_argument("-d", "--doc-id", type=int, default=0,
                    help="document ID (for --remove / single-file add)")
    ap.add_argument("-r", "--remove", action="store_true",
                    help="remove the document given with --doc-id")
    ap.add_argument("-s", "--search", metavar="QUERY",
                    help="run a search query")
    ap.add_argument("--algo", help="ranking algorithm override")
    ap.add_argument("--limit", type=int, help="results limit")
    ap.add_argument("--basedir",
                    default=os.environ.get("NXS_BASEDIR"),
                    help="base directory (default: $NXS_BASEDIR)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: cuda)")
    args = ap.parse_args(argv)
    if not args.basedir:
        ap.error("--basedir or NXS_BASEDIR is required")

    nxs = Nxs(args.basedir, device=args.device)
    try:
        try:
            with timed("index-load"):
                idx = nxs.index_open(args.index)
        except NxsError:
            with timed("index-create"):
                idx = nxs.index_create(args.index)

        if args.add:
            if not args.path:
                ap.error("--add requires --path")
            docs = list(_iter_docs(args.path))
            if args.doc_id and len(docs) == 1:
                docs = [(args.doc_id, docs[0][1])]
            with timed("indexing"):
                idx.add_many(docs)

        if args.remove:
            if not args.doc_id:
                ap.error("--remove requires --doc-id")
            with timed("remove"):
                idx.remove(args.doc_id)

        if args.search:
            params = Params()
            if args.algo:
                params.set_str("algo", args.algo)
            if args.limit:
                params.set_uint("limit", args.limit)
            with timed("search"):
                resp = idx.search(args.search, params)
            print(resp.tojson())

        with timed("index-close"):
            nxs.index_close(idx)
    except NxsError as e:
        print(f"error: {e.msg} (code {int(e.code)})", file=sys.stderr)
        return 1
    finally:
        nxs.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
