"""One general query generator, driven by a traffic file's parameters.

A traffic file (``perfbench/traffic/<name>.json``) says how queries are
sent (``send``: ``pipelined`` batches through ``Index.search_pipelined``
or ``requests`` through ``Index.search_many``), how many go together,
the result limit, and the shares of boolean forms and typos.  Query
lengths come from the configuration (its query statistics).  Every
query is also kept in a structured form that the plain reference
evaluates, so the reference never parses the engine's query language.

Query terms are drawn from the corpus distribution raised to the power
``query_power`` (``bench.make_queries``' damping), distinct within a
query.  Forms, as ``bench.make_mixed_queries`` makes them:

- ``or``: ``t0 t1 ... tk``;
- ``and``: ``t0 AND t1 t2 ... tk``, which the engine reads as
  ``(t0 AND t1) OR t2 OR ... OR tk`` (AND binds tighter than the
  implicit OR);
- ``andnot``: ``t0 ... tk-1 AND NOT tk``, read as
  ``t0 OR ... OR (tk-1 AND NOT tk)``.

A typo swaps two neighbouring letters of the first term longer than 3
letters, never the last letter, and is new within the run: the engine
memoizes resolutions, so a repeat would measure a dictionary hit.

``send`` is one of ``SENDS``; any other value is refused when the file
is loaded, since a new way of sending needs new code in ``run.py``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from .corpus import derive, zipf_probs

FORMS = ("or", "and", "andnot")


@dataclass
class Query:
    text: str
    ranks: list          # term ranks in query order (a typo's: its word)
    form: str            # one of FORMS
    typo: int = -1       # index into ranks of the misspelled term
    typo_text: str = ""


SENDS = ("pipelined", "requests")


class Traffic:
    """The cell's queries, batch after batch, without end: texts for the
    engine, and the structure the reference reads (``query(i)``).

    Batch ``b`` is drawn from its own seed, ``derive(seed, "traffic",
    name, b)``, in order, so it is the same however many batches a run
    draws ahead; a window that outruns what set-up drew draws on, and
    never sends a batch twice.  The set of typos already sent lives for
    the whole run, so every typo is new to the engine."""

    def __init__(self, name: str, params: dict, cfg: dict, strings: list,
                 seed: int):
        self.name, self.params, self.cfg = name, params, cfg
        self.strings, self.seed = strings, seed
        self.bsz = int(params["batch"])
        qp = zipf_probs(len(strings), cfg["zipf_offset"]) ** params[
            "query_power"]
        self.qp_cdf = np.cumsum(qp / qp.sum())
        self.used: set = set()
        self.batches: list = []          # texts, a list a batch
        self._k: list = []
        self._ranks: list = []
        self._form: list = []
        self._typo: list = []
        self.typo_text: dict = {}        # query index -> its typo

    def __len__(self) -> int:
        return len(self.batches) * self.bsz

    def draw_to(self, n_batches: int) -> None:
        while len(self.batches) < n_batches:
            self._draw()

    def batch(self, b: int) -> list:
        self.draw_to(b + 1)
        return self.batches[b]

    def typos_of(self, b: int) -> np.ndarray:
        """Per query of batch ``b``: the index of its misspelled term,
        or -1."""
        return self._typo[b]

    @property
    def k(self) -> np.ndarray:
        return np.concatenate(self._k)

    @property
    def ranks(self) -> np.ndarray:
        return np.concatenate(self._ranks)

    @property
    def typo(self) -> np.ndarray:
        return np.concatenate(self._typo)

    def query(self, i: int) -> Query:
        b, j = divmod(i, self.bsz)
        t = int(self._typo[b][j])
        return Query(self.batches[b][j],
                     self._ranks[b][j, : self._k[b][j]].tolist(),
                     FORMS[self._form[b][j]], t, self.typo_text.get(i, ""))

    def _draw(self) -> None:
        b = len(self.batches)
        p, n = self.params, self.bsz
        rng = np.random.default_rng(derive(self.seed, "traffic", self.name,
                                           b))
        k, ranks = _draw_terms(n, self.cfg["query_terms"], self.qp_cdf, rng)
        form_r = rng.random(n)
        typo_r = rng.random(n)
        swap_r = rng.random(n)
        a_share = float(p.get("and_share", 0.0))
        n_share = float(p.get("and_not_share", 0.0))
        typo_share = float(p.get("typo_share", 0.0))
        form = np.zeros(n, dtype=np.int8)
        form[(k >= 2) & (form_r < a_share + n_share)] = 2
        form[(k >= 2) & (form_r < a_share)] = 1
        typo = np.full(n, -1, dtype=np.int8)
        rows = ranks.tolist()
        ks = k.tolist()
        texts = []
        for i in range(n):
            toks = [self.strings[r] for r in rows[i][: ks[i]]]
            if typo_r[i] < typo_share:
                j = _typo(toks, float(swap_r[i]), self.used)
                if j >= 0:
                    typo[i] = j
                    self.typo_text[b * n + i] = toks[j]
            f = form[i]
            if f == 1:
                texts.append(f"{toks[0]} AND {' '.join(toks[1:])}")
            elif f == 2:
                texts.append(f"{' '.join(toks[:-1])} AND NOT {toks[-1]}")
            else:
                texts.append(" ".join(toks))
        self.batches.append(texts)
        self._k.append(k)
        self._ranks.append(ranks)
        self._form.append(form)
        self._typo.append(typo)


def load(name: str, root: str) -> dict:
    """The traffic file's parameters; a ``send`` that the harness does
    not know is refused (a new way of sending is new harness code)."""
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        tp = json.load(f)
    if tp.get("send") not in SENDS:
        raise ValueError(f"traffic {name!r}: send {tp.get('send')!r} is "
                         f"none of {SENDS}")
    return tp


def _draw_terms(n: int, qcfg: dict, qp_cdf: np.ndarray,
                rng: np.random.Generator):
    """Query lengths k and [n, max] ranks, distinct within each row's
    first k (the rest of a row is -1 - position)."""
    k = np.clip(int(qcfg["plus"]) + rng.poisson(qcfg["poisson"], n),
                qcfg["min"], qcfg["max"])
    kmax = int(qcfg["max"])
    pos = np.arange(kmax)
    used = pos < k[:, None]
    ranks = np.broadcast_to(-1 - pos, (n, kmax)).copy()
    rows = np.arange(n)
    while len(rows):
        u = used[rows]
        draw = np.searchsorted(qp_cdf, rng.random(int(u.sum())),
                               side="right")
        sub = ranks[rows]
        sub[u] = np.minimum(draw, len(qp_cdf) - 1)
        ranks[rows] = sub
        s = np.sort(sub, axis=1)
        rows = rows[(np.diff(s, axis=1) == 0).any(axis=1)]
    return k, ranks


def make_traffic(name: str, params: dict, cfg: dict, strings: list,
                 seed: int, n_batches: int) -> Traffic:
    """The seed's traffic with its first ``n_batches`` batches drawn."""
    tr = Traffic(name, params, cfg, strings, seed)
    tr.draw_to(n_batches)
    return tr


def _typo(toks: list, r: float, used: set) -> int:
    """Misspell the first term longer than 3 letters with a swap of
    letters p-1 and p, p in [1, len - 2], new within the run; the
    query keeps its words where no such swap is left.  Returns the
    index of the misspelled term, or -1."""
    for j, t in enumerate(toks):
        if len(t) <= 3:
            continue
        n_pos = len(t) - 2
        for step in range(n_pos):
            p = 1 + (int(r * n_pos) + step) % n_pos
            typo = t[:p - 1] + t[p] + t[p - 1] + t[p + 1:]
            if typo not in used:
                used.add(typo)
                toks[j] = typo
                return j
    return -1
