"""The plain reference of a cross-window stream cell: CSPARQL windows, the
SDS+ closure by full recomputation, the windows' queries, their join and
RSTREAM, cycle by cycle, from the stream the seed generates.

- Windows (``s2r.rs:179-271``): a window of RANGE ``w`` and STEP ``k``
  opens every ``k`` ticks and reports when it closes: the window closing
  at ``c`` (a multiple of ``k``) holds the events of ``[max(0, c - w),
  c)``, each triple once with its newest timestamp.  A window reports
  at the first event at or after its close; the reference takes streams
  that carry an event at every close, so each window reports at its
  closing tick (:meth:`Cycles.answer` raises otherwise), and a cycle runs
  when every window has reported.
- SDS+ (``cross_window_sds.rs``): a window fact's predicate is the window
  IRI followed by its local name; the fact is alive at the cycle's time
  ``now`` (the newest event time the windows hold) while event time + RANGE
  > ``now``, and its expiry is that sum.  The rules run to their fixpoint:
  a derived fact's expiry is the min over its premises and the max over
  its derivations.  This is a full recomputation a cycle, not the
  incremental maintenance under test.  (The cell has no static graph,
  whose facts would never expire.)
- The query: each ``WINDOW <iri> { ... }`` block's patterns over the facts
  routed back to that window (the longest window IRI that prefixes the
  predicate, stripped), the blocks' solutions joined on their shared
  variables in the order the query names the windows.  RSTREAM emits the
  whole joined relation each cycle: every variable of every block, as
  the engine emits its joined bindings, a plain literal by its lexical
  form.

Patterns take variables as subject and object and a constant predicate,
as the cell's rule and query do.  Terms are the generator's ids
(``stream_gen.CityStream.columns``), predicates the reference's own codes;
every step is a NumPy sort, search or gather over columns.  Works from the
configuration, the query text and the generator; imports nothing of the
program."""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.stream_gen import CityStream

Pattern = Tuple[str, str, str]

_WINDOW = re.compile(
    r"FROM\s+NAMED\s+WINDOW\s+<([^>]*)>\s+ON\s+<([^>]*)>\s*"
    r"\[\s*RANGE\s+(\d+)\s+STEP\s+(\d+)\s*\]", re.I)
_BLOCK = re.compile(r"\bWINDOW\s+<([^>]*)>\s*\{([^}]*)\}", re.I)
_PREFIX = re.compile(r"@prefix\s+(\w*):\s*<([^>]*)>\s*\.", re.I)
_RULE = re.compile(r"\{([^}]*)\}\s*=>\s*\{([^}]*)\}")


def _term(tok: str, prefixes: Dict[str, str]) -> str:
    if tok.startswith("<") and tok.endswith(">"):
        return tok[1:-1]
    pre, sep, local = tok.partition(":")
    if sep and not tok.startswith(("?", '"')) and pre in prefixes:
        return prefixes[pre] + local
    return tok


def _patterns(body: str, prefixes: Dict[str, str]) -> List[Pattern]:
    out = []
    for part in body.split(" ."):
        toks = part.replace("\n", " ").split()
        if not toks:
            continue
        if len(toks) != 3 or toks[1].startswith("?") or not (
                toks[0].startswith("?") and toks[2].startswith("?")):
            raise ValueError(f"the reference takes ?s <p> ?o patterns, not {part.strip()!r}")
        out.append(tuple(_term(t, prefixes) for t in toks))
    return out


def parse_query(text: str):
    """``(windows, blocks)``: each window ``(iri, stream, range, step)`` in
    the query's order, and each block's triple patterns by window IRI."""
    windows = [(iri, stream, int(w), int(k)) for iri, stream, w, k in _WINDOW.findall(text)]
    blocks = {iri: _patterns(body, {}) for iri, body in _BLOCK.findall(text)}
    return windows, blocks


def parse_rules(n3: str) -> List[Tuple[List[Pattern], List[Pattern]]]:
    """``[(premises, conclusions)]`` with every prefixed name expanded."""
    prefixes = dict(_PREFIX.findall(n3))
    return [(_patterns(body, prefixes), _patterns(head, prefixes))
            for body, head in _RULE.findall(n3)]


def display(term: str) -> str:
    """A term as a result row shows it: a plain literal by its lexical
    form, anything else as it is."""
    if len(term) >= 2 and term[0] == '"' and term[-1] == '"':
        return term[1:-1]
    return term


# ------------------------------------------------------------- columns


class Facts:
    """Facts as int64 columns ``s, p, o, exp``."""

    KEYS = ("s", "p", "o", "exp")

    def __init__(self, s=(), p=(), o=(), exp=()):
        self.s, self.p, self.o, self.exp = (np.asarray(c, dtype=np.int64) for c in (s, p, o, exp))

    def where(self, mask) -> "Facts":
        return Facts(*(getattr(self, k)[mask] for k in self.KEYS))

    @staticmethod
    def union_max(parts: List["Facts"]) -> "Facts":
        """The union of ``parts``, each fact once with its latest expiry,
        sorted by (s, p, o)."""
        s, p, o, e = (np.concatenate([getattr(f, k) for f in parts]) for k in Facts.KEYS)
        order = np.lexsort((-e, o, p, s))
        s, p, o, e = s[order], p[order], o[order], e[order]
        head = np.ones(len(s), dtype=bool)
        head[1:] = (s[1:] != s[:-1]) | (p[1:] != p[:-1]) | (o[1:] != o[:-1])
        return Facts(s[head], p[head], o[head], e[head])

    def same(self, other: "Facts") -> bool:
        return all(np.array_equal(getattr(self, k), getattr(other, k)) for k in self.KEYS)


def _dense(left: List[np.ndarray], right: List[np.ndarray]):
    """One int64 key a row for the tuples of ``left`` and ``right`` alike."""
    if len(left) == 1:
        return left[0], right[0]
    both = np.stack([np.concatenate([a, b]) for a, b in zip(left, right)])
    rank = np.unique(both, axis=1, return_inverse=True)[1].reshape(-1)
    return rank[:len(left[0])], rank[len(left[0]):]


def _equi_join(left: List[np.ndarray], right: List[np.ndarray], n_left: int, n_right: int):
    """Row pairs ``(li, ri)`` whose keys are equal (with no keys, every
    pair of rows)."""
    if not left:
        return np.repeat(np.arange(n_left), n_right), np.tile(np.arange(n_right), n_left)
    lk, rk = _dense(left, right)
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    lo = np.searchsorted(rs, lk, "left")
    cnt = np.searchsorted(rs, lk, "right") - lo
    li = np.repeat(np.arange(len(lk)), cnt)
    starts = np.cumsum(cnt) - cnt
    ri = order[np.repeat(lo - starts, cnt) + np.arange(int(cnt.sum()))]
    return li, ri


def join_tables(left, right):
    """Natural join of two binding tables ``(columns by variable, expiry)``;
    a pair's expiry is the min of its two."""
    (lt, le), (rt, re_) = left, right
    shared = [v for v in lt if v in rt]
    li, ri = _equi_join([lt[v] for v in shared], [rt[v] for v in shared], len(le), len(re_))
    table = {v: c[li] for v, c in lt.items()}
    table.update({v: c[ri] for v, c in rt.items() if v not in table})
    return table, np.minimum(le[li], re_[ri])


def match(patterns: List[Pattern], facts: Facts, code: Dict[str, int]):
    """Every binding of ``patterns`` over ``facts`` (predicates by their
    ``code``), with the min expiry of the facts it used."""
    out = None
    for s, p, o in patterns:
        f = facts.where(facts.p == code.get(p, -1))
        if s == o:
            f = f.where(f.s == f.o)
        part = ({s: f.s, o: f.o}, f.exp)
        out = part if out is None else join_tables(out, part)
    return out


def closure(facts: Facts, rules, code: Dict[str, int]) -> Facts:
    """The rules' fixpoint over ``facts`` (unique, sorted), expiries the
    min over premises and the max over derivations."""
    while True:
        parts = [facts]
        for premises, heads in rules:
            table, exp = match(premises, facts, code)
            for s, p, o in heads:
                k = code.setdefault(p, len(code))
                parts.append(Facts(table[s], np.full(len(exp), k), table[o], exp))
        grown = Facts.union_max(parts)
        if grown.same(facts):
            return facts
        facts = grown


# ------------------------------------------------------------- cycles


class Cycles:
    """The answers of a cross-window cell, cycle by cycle.

    ``config`` names the generator's parameters and the rules, ``query``
    is the REGISTER query; ``lose_every`` drops every ``lose_every``-th
    event of the stream, counted from the first tick's first event in push
    order (the control).  ``stream`` replaces the generator's stream: any
    object with its ``columns``, ``count`` and ``term``."""

    def __init__(self, config: dict, query: str, seed: int, lose_every: Optional[int] = None,
                 stream=None):
        self.stream = stream if stream is not None else CityStream(config, seed)
        self.windows, self.blocks = parse_query(query)
        self.rules = parse_rules(config["cross_window_rules"])
        self.lose_every = lose_every
        steps = {k for _, _, _, k in self.windows}
        if len(steps) != 1:
            raise ValueError("the reference runs windows of one STEP")
        self.step = steps.pop()
        self._ticks: Dict[int, dict] = {}
        self._starts = [0, 0]  # [t]: the stream's events before tick t

    def closes(self, last_tick: int) -> List[int]:
        """The cycle times up to ``last_tick``: every close of the windows."""
        return list(range(self.step, last_tick + 1, self.step))

    def _columns(self, tick: int) -> dict:
        """``tick``'s events by stream, less the lost ones."""
        got = self._ticks.get(tick)
        if got is None:
            got = self.stream.columns(tick)
            if self.lose_every:
                while len(self._starts) <= tick:
                    t = len(self._starts) - 1
                    self._starts.append(self._starts[t] + self.stream.count(t))
                first, k = self._starts[tick], self.lose_every
                for iri, (s, p, o) in got.items():
                    keep = (first + np.arange(len(s))) % k != k - 1
                    got[iri] = (s[keep], p, o[keep])
                    first += len(s)
            self._ticks[tick] = got
        return got

    def content(self, close: int, iri: str) -> Tuple[Facts, str]:
        """The content of window ``iri`` at ``close``, each triple once with
        its newest timestamp as ``exp``, and its stream's predicate."""
        stream, width = next((st, w) for i, st, w, _ in self.windows if i == iri)
        s, o, ts, names = [], [], [], set()
        for tick in range(max(1, close - width), close):
            cs, name, co = self._columns(tick)[stream]
            s.append(cs), o.append(co), ts.append(np.full(len(cs), tick))
            names.add(name)
        if len(names) > 1:
            raise ValueError("the reference takes one predicate a stream")
        n = sum(map(len, s))
        c = Facts.union_max([Facts(np.concatenate(s or [[]]), np.zeros(n),
                                   np.concatenate(o or [[]]), np.concatenate(ts or [[]]))])
        return c, names.pop() if names else ""

    def facts(self, close: int) -> Tuple[Facts, Dict[str, int], int]:
        """The SDS+ facts alive at the cycle closing at ``close``, after the
        rules: ``(facts, code of each annotated predicate, now)``."""
        contents = [(iri, width, *self.content(close, iri)) for iri, _, width, _ in self.windows]
        now = max((int(c.exp.max()) for _, _, c, _ in contents if len(c.exp)), default=0)
        code: Dict[str, int] = {}
        parts = [Facts()]
        for iri, width, c, name in contents:
            c = c.where(c.exp + width > now)
            k = code.setdefault(iri + name, len(code))
            parts.append(Facts(c.s, np.full(len(c.s), k), c.o, c.exp + width))
        facts = closure(Facts.union_max(parts), self.rules, code)
        return facts.where(facts.exp > now), code, now

    def answer(self, close: int) -> Counter:
        """The RSTREAM rows of the cycle at ``close``, as a bag."""
        ticks = self.stream.columns(close)  # the events as sent, before any loss
        quiet = [st for _, st, _, _ in self.windows if not len(ticks[st][0])]
        if quiet:
            raise ValueError(f"no event at the close {close} on {quiet}: the window "
                             "would report later, which the reference does not model")
        facts, code, _ = self.facts(close)
        iris = sorted((w[0] for w in self.windows), key=len, reverse=True)
        joined = None
        for iri, _, _, _ in self.windows:
            # the predicates routed to this window, by local name
            local = {name[len(iri):]: k for name, k in code.items()
                     if next((w for w in iris if name.startswith(w)), None) == iri}
            got = match(self.blocks.get(iri, []), facts, local)
            joined = got if joined is None else join_tables(joined, got)
        # the next cycle reads no tick older than its widest window
        oldest = close + self.step - max(w for _, _, w, _ in self.windows)
        for tick in [t for t in self._ticks if t < oldest]:
            del self._ticks[tick]
        if joined is None:
            return Counter()
        table = joined[0]
        names = sorted(table)
        cols = [[display(self.stream.term(i)) for i in table[v].tolist()] for v in names]
        return Counter(zip(*[[(v[1:], x) for x in col] for v, col in zip(names, cols)]))
