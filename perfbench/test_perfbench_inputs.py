"""The benchmark's inputs: seeded, repeatable, and indexed by the engine
exactly as the plain reference reads them."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import corpus as corpus_mod
from perfbench import traffic as traffic_mod

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2**31 + 977


def config(name, tiny_root):
    with open(os.path.join(tiny_root, "perfbench", "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def traffic(name, tiny_root):
    return traffic_mod.load(name, os.path.join(tiny_root, "perfbench"))


@pytest.mark.parametrize("cfg_name", ["msmarco_passage", "trec_covid"])
def test_corpus_repeats_from_seed(tiny_root, cfg_name):
    cfg = config(cfg_name, tiny_root)
    a = corpus_mod.make_corpus(cfg, SEED, torch.device("cpu"))
    b = corpus_mod.make_corpus(cfg, SEED, torch.device("cpu"))
    c = corpus_mod.make_corpus(cfg, SEED + 1, torch.device("cpu"))
    for f in ("words", "doc_len", "doc_ptr", "pair_rank", "pair_count"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert a.pair_rank.tobytes() != c.pair_rank.tobytes()
    assert a.words.tobytes() != c.words.tobytes()
    assert a.n_docs == cfg["documents"]
    assert abs(a.doc_len.mean() - cfg["mean_doc_words"]) < 1.0


@pytest.mark.parametrize("mix", ["or_top10", "mixed_top10", "or_requests"])
def test_traffic_repeats_from_seed(tiny_root, mix):
    cfg = config("msmarco_passage", tiny_root)
    strings = corpus_mod.word_strings(corpus_mod.make_words(
        cfg["vocabulary"], SEED))
    tp = traffic(mix, tiny_root)
    a = traffic_mod.make_traffic(mix, tp, cfg, strings, SEED, 20)
    b = traffic_mod.make_traffic(mix, tp, cfg, strings, SEED, 20)
    assert a.batches == b.batches
    assert a.ranks.tobytes() == b.ranks.tobytes()
    assert a.typo_text == b.typo_text
    typos = list(a.typo_text.values())
    assert len(set(typos)) == len(typos)
    assert not set(typos) & set(strings)
    if tp["typo_share"]:
        assert typos


@pytest.mark.parametrize("mix", ["or_top10", "mixed_top10", "or_requests"])
def test_traffic_batches_do_not_depend_on_how_many_are_drawn(tiny_root,
                                                             mix):
    """Batch b comes from its own seed: drawing more batches ahead
    changes none that were drawn."""
    cfg = config("msmarco_passage", tiny_root)
    strings = corpus_mod.word_strings(corpus_mod.make_words(
        cfg["vocabulary"], SEED))
    tp = traffic(mix, tiny_root)
    few = traffic_mod.make_traffic(mix, tp, cfg, strings, SEED, 3)
    many = traffic_mod.make_traffic(mix, tp, cfg, strings, SEED, 9)
    assert many.batches[:3] == few.batches
    assert many.batch(11) is many.batches[11]
    assert len(many) == 12 * tp["batch"]


def test_query_lengths_follow_the_configuration():
    with open(os.path.join(HERE, "configs", "msmarco_passage.json")) as f:
        cfg = json.load(f)
    strings = corpus_mod.word_strings(corpus_mod.make_words(50000, SEED))
    tp = traffic_mod.load("or_top10", HERE)
    tr = traffic_mod.make_traffic("or_top10", tp, cfg, strings, SEED, 8)
    assert abs(tr.k.mean() - 5.96) < 0.1
    for i in range(0, len(tr), 97):
        q = tr.query(i)
        assert len(set(q.ranks)) == len(q.ranks)
        assert q.text.split() == [strings[r] for r in q.ranks]


def test_words_pass_default_filters(tmp_path):
    """Every word of a full-size vocabulary, and every typo of a mixed
    pool, leaves the engine's default pipeline as it came."""
    from nxsearch_tpu_torch import Nxs

    with open(os.path.join(HERE, "configs", "trec_covid.json")) as f:
        cfg = json.load(f)
    rows = corpus_mod.make_words(cfg["vocabulary"], SEED)
    strings = corpus_mod.word_strings(rows)
    lens = corpus_mod.word_lengths(rows)
    assert lens.min() >= 3 and lens.max() <= 16
    assert 7.5 < lens.mean() < 8.5
    tp = traffic_mod.load("mixed_top10", HERE)
    tr = traffic_mod.make_traffic("mixed_top10", tp, cfg, strings, SEED, 4)
    typos = list(tr.typo_text.values())
    assert typos
    nxs = Nxs(str(tmp_path), device="cpu")
    try:
        pipe = nxs.index_create("t").pipeline
        values = strings + typos
        if getattr(pipe, "prime", None) is not None:
            pipe.prime(values)
        changed = [v for v in values if pipe.run(v) != v]
    finally:
        nxs.close()
    assert changed == []


def test_words_pass_the_python_filters(tmp_path):
    """The same on the pipeline's Python path (non-ASCII documents and
    hosts without the native library take it)."""
    from nxsearch_tpu_torch import Nxs

    strings = corpus_mod.word_strings(corpus_mod.make_words(20000, SEED))
    nxs = Nxs(str(tmp_path), device="cpu")
    try:
        pipe = nxs.index_create("t").pipeline
        changed = [v for v in strings if pipe._run_uncached(v) != v] \
            if pipe.native is None else None
        if changed is None:
            native, pipe.native = pipe.native, None
            try:
                changed = [v for v in strings if pipe._run_uncached(v) != v]
            finally:
                pipe.native = native
    finally:
        nxs.close()
    assert changed == []


def test_reference_follows_the_engine_on_a_typo_of_a_named_term(tmp_path):
    """A typo that resolves to a term the query names again: the engine
    scores both tokens, and so does the reference; the boolean forms
    with it as well."""
    from nxsearch_tpu_torch import Nxs, Params

    from perfbench.reference import Reference, compare
    from perfbench.traffic import Query

    cfg = {"documents": 3000, "mean_doc_words": 40.0, "vocabulary": 6000,
           "zipf_offset": 10, "word_len_min": 5, "word_len_max": 12,
           "word_len_mean": 8.0}
    c = corpus_mod.make_corpus(cfg, SEED, torch.device("cpu"))
    nxs = Nxs(str(tmp_path), device="cpu")
    try:
        idx = nxs.index_create("t")
        docs = []
        for d in range(c.n_docs):
            lo, hi = c.doc_ptr[d], c.doc_ptr[d + 1]
            words = []
            for r, n in zip(c.pair_rank[lo:hi], c.pair_count[lo:hi]):
                words += [c.strings[r]] * int(n)
            docs.append((d + 1, " ".join(words)))
        idx.add_many(docs)
        ref = Reference(c, torch.device("cpu"))
        head = c.strings[0]
        typo = head[1] + head[0] + head[2:]
        assert ref.resolve(typo) == 0
        sp = Params().set_uint("limit", 10)
        cases = [  # text, ranks of its words, form, index of the typo
            (f"{head} {typo} {c.strings[7]}", [0, 0, 7], "or", 1),
            (f"{c.strings[3]} AND {head} {typo}", [3, 0, 0], "and", 2),
            (f"{c.strings[5]} {typo} AND NOT {head}", [5, 0, 0], "andnot",
             1),
        ]
        for text, ranks, form, at in cases:
            q = Query(text, ranks, form, typo=at, typo_text=typo)
            got = idx.search_many([text], sp)[0].results
            want, acc = ref.answer(q, 10)
            misses, gap = compare(got, want, acc, 1e-4)
            assert misses == 0 and gap <= 1e-4, (text, got, want)
    finally:
        nxs.close()
