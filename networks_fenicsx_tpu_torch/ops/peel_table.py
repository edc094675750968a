"""The peel rounds of a cyclic bifurcation graph packed for K9, checked once.

The host half of K9's launches (:mod:`..kernels.peel`, ``csrc/peel.cu``):
:func:`pack_peel_table` packs a tree plan's rounds (each round's eliminated
nodes, their parents and pair ids, its sorted unique parents and the fold
summing its terms into them) and the cycle core into one int32 table,
:func:`check_peel_table` refuses a table the kernels could not run safely,
and :func:`peel_table` does both and uploads it.  A :class:`PeelTable`
is made once per executor (:func:`..tree.device_tree_plan`).

Layout (words): a header of :data:`HEAD_WORDS`; a row of
:data:`ROUND_WORDS` a round; the forward and back launch lists (rows of
:data:`ENTRY_WORDS`); then the index arrays.  A round's row holds its
sizes ``n`` and ``U``, its offset in the saved ``(w, d, r)`` stream, the
offsets of ``elim``, ``parents``, ``pair_ids``, ``bpar`` (a parent as the
back pass reads its λ: the node, ``-2 - rank`` for a core node, ``-1`` for
none), ``upar``, ``ucore`` (per unique parent the core rank it gathers
into when this is the last round that updates it, else ``-1``), in a
block run ``lelim``, ``lpar`` and ``lupar`` (the nodes as the run's local
slots, ``-1`` for no parent), in a grid round ``esrc`` and ``usrc`` (where
its children's and parents' current ``(d, r)`` are: a node ``v`` not updated
by an earlier round is read from the assembled system, one updated before
from the working copy, written ``B + v``) and ``fsrc`` and ``fpid`` (per
entry of the fold's first level the child's source and pair, ``-1`` at a
pad), an offset ``-1`` where the shape does not read the array, and its
fold descriptor (``ops.core_elim``'s: the level count, then per level the
indices' offset, rows, width and the work buffer's offset of its output,
``-1`` for the last level, which the parents' threads sum themselves).

A block run keeps its rounds in shared memory: its nodes' ``(d, r)`` (or
λ) in local slots, its children's conductances and saved values, its round
rows and its staged words ``[lo, hi)`` (every round's ``lelim``, ``lpar``,
``lupar`` and fold levels, laid out together), so that a round touches no
device memory; what later launches read (the saved stream, the ``(d, r)``
of slots it does not eliminate, their core gathers, λ) it writes at its
end.  Its entry names those words, its ``slots`` (the sorted nodes),
``bsrc`` (per slot where the back pass finds λ of a slot the run does not
eliminate: a node's λ, ``-2 - rank`` for the core's solution, ``-1`` for a
slot the run computes), ``wsrc`` (per child in run order its pair, ``-1``
without a parent), its shared-memory bytes and ``ssrc`` (its slots'
sources, as ``esrc``, when it starts); a run is cut where it would pass
:data:`RUN_SMEM`.

The work buffer of a solve (float64) holds the saved stream, three planes
of ``n_peeled`` (w, d, r at elimination), then the intermediate fold
levels (two channels a row).

A launch entry is ``(kind, first, last, level, blocks, duty)`` and, for a
block run, ``(lo, hi, slots, S, bsrc, wsrc, smem, ssrc)``: a
:data:`GRID` entry runs one fold level of one round (``first``) on
``blocks`` blocks of :data:`GRID_THREADS`; a :data:`BLOCK` entry the rounds
``[first, last)``, every level, in one block of :data:`BLOCK_THREADS`
(reversed in the back list); a :data:`DUTY` entry only the duty.  The duty
is the core's gather of the nodes no round updates (forward: ``dc``, ``rc``
from the assembled system) or the scatter of the core's solution into λ
(back); exactly one entry a direction has it, the first forward and the
last back unless it has its own entry.  A round of at least ``cut``
eliminated nodes gets a grid entry a fold level (the launch boundary is
its barrier); a run of narrower rounds one block entry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core_elim import FOLD_MAX, FOLD_WORDS

__all__ = [
    "BLOCK", "BLOCK_THREADS", "DUTY", "DUTY_IN_BLOCK", "ENTRY_WORDS", "GRID", "GRID_THREADS",
    "HEAD_WORDS", "PeelTable", "ROUND_WORDS", "check_peel_table", "entries", "pack_peel_table",
    "peel_table", "round_arrays",
]

(H_B, H_P, H_ROUNDS, H_NPEEL, H_NCORE, H_CORE, H_EARLY, H_NEARLY, H_WORK, H_NFWD, H_FWD, H_NBACK,
 H_BACK) = range(13)
HEAD_WORDS = 13
(R_N, R_U, R_OFF, R_ELIM, R_PAR, R_PID, R_BPAR, R_UPAR, R_UCORE, R_LELIM, R_LPAR, R_LUPAR, R_ESRC,
 R_USRC, R_FSRC, R_FPID) = range(16)
R_FOLD = 16
ROUND_WORDS = R_FOLD + FOLD_WORDS
(E_KIND, E_FIRST, E_LAST, E_LEVEL, E_BLOCKS, E_DUTY, E_LO, E_HI, E_SLOTS, E_S, E_BSRC, E_WSRC,
 E_SMEM, E_SSRC) = range(14)
ENTRY_WORDS = 14
GRID, BLOCK, DUTY = 0, 1, 2  # the kinds of a launch entry
GRID_THREADS = 256  # a grid entry's block (csrc/peel.cu)
BLOCK_THREADS = 1024  # a block entry's
DUTY_IN_BLOCK = 4096  # the most duty items a block entry takes; more get a grid entry
RUN_SMEM = 160 * 1024  # the most shared memory a block run takes (of an H100 block's 227 KB)


@dataclasses.dataclass(frozen=True)
class PeelTable:
    """A tree plan's peel rounds packed for K9 and checked once
    (:func:`check_peel_table`).

    Attributes:
        host: ``(words,)`` int32, the table (the launchers read its launch
            lists on the host).
        table: the same on the plan's device.
        rounds: the rounds.
        work_len: the work buffer's doubles.
        n_forward, n_back: the launch entries each way.
    """

    host: np.ndarray
    table: torch.Tensor
    rounds: int
    work_len: int
    n_forward: int
    n_back: int

    @property
    def launches(self) -> int:
        """K9's CUDA launches a solve: one an entry."""
        return self.n_forward + self.n_back


def _blocks(items: int) -> int:
    return max(1, -(-items // GRID_THREADS))


def _level_rows(fold) -> list:
    return [int(np.asarray(lv).shape[0]) for lv in fold]


def _forward_items(n: int, rows: list, l: int) -> int:
    """The items of round phase ``l``: its saved writes (level 0) and its rows."""
    return max(n if l == 0 else 0, rows[l] if rows else 0)


def _children(level0: np.ndarray, of: np.ndarray) -> np.ndarray:
    """``of`` at each entry of a round's first fold level, ``-1`` at a pad."""
    real = level0 < of.size
    if not of.size:
        return np.full(level0.shape, -1)
    return np.where(real, of[np.where(real, level0, 0)], -1)


def run_smem(S: int, n_run: int, rounds: int, staged: int) -> int:
    """A block run's shared-memory bytes: the ``(d, r)`` of its ``S`` slots
    (back: their λ) and its ``n_run`` children's saved ``(w, d, r)``; then
    its round rows and its ``staged`` words."""
    return 16 * S + 24 * n_run + 4 * (rounds * ROUND_WORDS + staged)


def pack_peel_table(rounds, core_nodes, B: int, P: int, cut: int = 1024) -> np.ndarray:
    """The table's words (int64) of ``rounds``: per round ``(elim, parents,
    pair_ids, upar, fold levels)`` in order, the core's nodes ``core_nodes``,
    ``B`` bifurcations and ``P`` pairs."""
    if cut < 1:
        raise ValueError("peel table: the cut width must be positive")
    R = len(rounds)
    core_nodes = np.asarray(core_nodes, np.int64)
    n_core = int(core_nodes.size)
    rank = np.full(B, -1, np.int64)
    rank[core_nodes] = np.arange(n_core)
    last_parent = np.full(B, -1, np.int64)  # the last round that updates a node
    for k, (_, _, _, upar, _) in enumerate(rounds):
        last_parent[np.asarray(upar, np.int64)] = k
    early = np.flatnonzero(last_parent[core_nodes] < 0)

    sizes = [int(np.asarray(rd[0]).size) for rd in rounds]
    rows = [_level_rows(rd[4]) for rd in rounds]
    nodes = [np.union1d(np.asarray(rd[0], np.int64), np.asarray(rd[3], np.int64)) for rd in rounds]
    staged = [2 * sizes[k] + len(upar) + sum(int(np.asarray(lv).size) for lv in fold)
              for k, (_, _, _, upar, fold) in enumerate(rounds)]
    elim_round = np.full(B, -1, np.int64)
    for k, rd in enumerate(rounds):
        elim_round[np.asarray(rd[0], np.int64)] = k

    def fits(a: int, b: int, slots) -> bool:
        return run_smem(len(slots), sum(sizes[a:b]), b - a, sum(staged[a:b])) <= RUN_SMEM

    segments = []  # (kind, first, last) of the rounds, in order
    k = 0
    while k < R:
        if sizes[k] >= cut or not fits(k, k + 1, nodes[k]):
            segments.append((GRID, k, k + 1))
            k += 1
            continue
        j, slots = k + 1, nodes[k]
        while j < R and sizes[j] < cut and fits(k, j + 1, np.union1d(slots, nodes[j])):
            slots = np.union1d(slots, nodes[j])
            j += 1
        segments.append((BLOCK, k, j))
        k = j
    fwd, back = [], []
    for kind, a, b in segments:
        if kind == GRID:
            for l in range(max(len(rows[a]), 1)):
                fwd.append([GRID, a, b, l, _blocks(_forward_items(sizes[a], rows[a], l)), 0])
        else:
            fwd.append([BLOCK, a, b, 0, 1, 0])
    for kind, a, b in reversed(segments):
        back.append([kind, a, b, 0, _blocks(sizes[a]) if kind == GRID else 1, 0])

    def give_duty(lst, at: int, items: int) -> None:
        """The duty of ``items`` on entry ``at`` (0 or -1), or its own entry."""
        if not items:
            return
        if lst and (lst[at][E_KIND] == GRID or items <= DUTY_IN_BLOCK):
            e = lst[at]
            e[E_DUTY] = 1
            if e[E_KIND] == GRID:
                e[E_BLOCKS] = max(e[E_BLOCKS], _blocks(items))
            return
        duty = [DUTY, 0, 0, 0, _blocks(items), 1]
        if at == 0:
            lst.insert(0, duty)
        else:
            lst.append(duty)

    give_duty(fwd, 0, int(early.size))
    give_duty(back, -1, n_core)

    head_words = HEAD_WORDS + R * ROUND_WORDS + ENTRY_WORDS * (len(fwd) + len(back))
    words = np.zeros(head_words, np.int64)
    arrays: list = []
    pos = [head_words]

    def put(a) -> int:
        a = np.asarray(a, np.int64).ravel()
        at = pos[0]
        arrays.append(a)
        pos[0] += a.size
        return at

    n_peeled = sum(sizes)
    scratch = [3 * n_peeled]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    def put_global(k: int) -> None:
        """Round k's row and the arrays every launch shape reads."""
        elim, parents, pair_ids, upar, _ = rounds[k]
        at = HEAD_WORDS + k * ROUND_WORDS
        parents = np.asarray(parents, np.int64)
        bpar = np.where(parents >= 0, parents, -1)
        core_par = (parents >= 0) & (rank[np.maximum(parents, 0)] >= 0)
        bpar[core_par] = -2 - rank[parents[core_par]]
        upar = np.asarray(upar, np.int64)
        ucore = np.where((last_parent[upar] == k) & (rank[upar] >= 0), rank[upar], -1)
        words[at: at + R_LELIM] = (sizes[k], upar.size, offs[k], put(elim), put(parents),
                                   put(pair_ids), put(bpar), put(upar), put(ucore))
        words[at + R_LELIM: at + R_FOLD] = -1

    updated = np.zeros(B, bool)  # the nodes earlier rounds updated: (d, r) in the working copy

    def source(v):
        v = np.asarray(v, np.int64)
        return np.where(updated[v], B + v, v)

    def put_staged(k: int, slots=None) -> None:
        """Round k's fold levels and its local slots (in a block run) or its
        sources and first fold level's children (in a grid round)."""
        elim, parents, pair_ids, upar, fold = rounds[k]
        at = HEAD_WORDS + k * ROUND_WORDS
        upar = np.asarray(upar, np.int64)
        parents = np.asarray(parents, np.int64)
        if slots is not None:
            words[at + R_LELIM] = put(np.searchsorted(slots, np.asarray(elim, np.int64)))
            words[at + R_LPAR] = put(np.where(parents >= 0, np.searchsorted(slots, parents), -1))
            words[at + R_LUPAR] = put(np.searchsorted(slots, upar))
        else:
            words[at + R_ESRC], words[at + R_USRC] = put(source(elim)), put(source(upar))
            if fold:
                words[at + R_FSRC], words[at + R_FPID] = (
                    put(_children(np.asarray(fold[0], np.int64), np.asarray(a, np.int64)))
                    for a in (source(elim), pair_ids))
        levels = tuple(np.asarray(lv) for lv in fold)
        if len(levels) > FOLD_MAX:
            raise ValueError(f"peel table: a fold of {len(levels)} > {FOLD_MAX} levels")
        words[at + R_FOLD] = len(levels)
        for l, lv in enumerate(levels):
            r, K = lv.shape
            out = -1
            if l < len(levels) - 1:
                out = scratch[0]
                scratch[0] += 2 * r
            words[at + R_FOLD + 1 + 4 * l: at + R_FOLD + 5 + 4 * l] = (put(lv), r, K, out)

    runs = {}
    for kind, a, b in segments:
        for k in range(a, b):
            put_global(k)
        if kind == GRID:
            put_staged(a)
            updated[np.asarray(rounds[a][3], np.int64)] = True
            continue
        slots = np.unique(np.concatenate([nodes[k] for k in range(a, b)]))
        lo = pos[0]
        for k in range(a, b):
            put_staged(k, slots)
        hi = pos[0]
        inside = (elim_round[slots] >= a) & (elim_round[slots] < b)
        bsrc = np.where(inside, -1, np.where(rank[slots] >= 0, -2 - rank[slots], slots))
        wsrc = np.concatenate([np.where(np.asarray(rounds[k][1]) >= 0, rounds[k][2], -1)
                               for k in range(a, b)])
        smem = run_smem(slots.size, int(offs[b] - offs[a]), b - a, hi - lo)
        runs[a, b] = [lo, hi, put(slots), slots.size, put(bsrc), put(wsrc), smem,
                      put(source(slots))]
        for k in range(a, b):
            updated[np.asarray(rounds[k][3], np.int64)] = True
    at = HEAD_WORDS + R * ROUND_WORDS
    for e in fwd + back:
        words[at: at + ENTRY_WORDS] = e + (runs[e[E_FIRST], e[E_LAST]] if e[E_KIND] == BLOCK
                                           else [0] * (ENTRY_WORDS - E_LO))
        at += ENTRY_WORDS
    first_entry = HEAD_WORDS + R * ROUND_WORDS
    words[:HEAD_WORDS] = (B, P, R, n_peeled, n_core, put(core_nodes), put(early), early.size,
                          scratch[0], len(fwd), first_entry, len(back),
                          first_entry + ENTRY_WORDS * len(fwd))
    out = np.concatenate([words] + arrays)
    if out.size and (out.max() > np.iinfo(np.int32).max or out.min() < np.iinfo(np.int32).min):
        raise ValueError("peel table: an entry does not fit in int32")
    return out


def _array(words: np.ndarray, off: int, size: int, name: str) -> np.ndarray:
    if size < 0 or off < 0 or off + size > words.size:
        raise ValueError(f"peel table: {name} lies outside the table")
    return words[off: off + size]


def round_arrays(words: np.ndarray, k: int) -> dict:
    """Round ``k``'s sizes, saved offset, index arrays (views of ``words``)
    and fold levels ``[(indices (rows, K), out), ...]``, as the kernels
    read them."""
    at = HEAD_WORDS + k * ROUND_WORDS
    n, U = int(words[at + R_N]), int(words[at + R_U])

    def arr(f, size, name):
        return _array(words, int(words[at + f]), size, f"round {k}'s {name}")

    fold = []
    nl = int(words[at + R_FOLD])
    if not 0 <= nl <= FOLD_MAX:
        raise ValueError(f"peel table: round {k}'s fold has {nl} levels")
    for l in range(nl):
        o, rows, K, out = (int(x) for x in words[at + R_FOLD + 1 + 4 * l: at + R_FOLD + 5 + 4 * l])
        lv = _array(words, o, rows * K, f"round {k}'s fold level {l}")
        fold.append((lv.reshape(rows, K), out))
    first = fold[0][0].size if fold else 0
    local = {f: (arr(f, size, name) if int(words[at + f]) >= 0 else None)
             for f, size, name in ((R_LELIM, n, "lelim"), (R_LPAR, n, "lpar"),
                                   (R_LUPAR, U, "lupar"), (R_ESRC, n, "esrc"),
                                   (R_USRC, U, "usrc"), (R_FSRC, first, "fsrc"),
                                   (R_FPID, first, "fpid"))}
    return dict(n=n, U=U, off=int(words[at + R_OFF]), elim=arr(R_ELIM, n, "elim"),
                parents=arr(R_PAR, n, "parents"), pair_ids=arr(R_PID, n, "pair ids"),
                bpar=arr(R_BPAR, n, "bpar"), upar=arr(R_UPAR, U, "upar"),
                ucore=arr(R_UCORE, U, "ucore"), lelim=local[R_LELIM], lpar=local[R_LPAR],
                lupar=local[R_LUPAR], esrc=local[R_ESRC], usrc=local[R_USRC], fsrc=local[R_FSRC],
                fpid=local[R_FPID], fold=fold)


def entries(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(forward, back)`` launch entries, rows of :data:`ENTRY_WORDS`."""
    nf, nb = int(words[H_NFWD]), int(words[H_NBACK])
    f = _array(words, int(words[H_FWD]), nf * ENTRY_WORDS, "the forward entries")
    b = _array(words, int(words[H_BACK]), nb * ENTRY_WORDS, "the back entries")
    return f.reshape(nf, ENTRY_WORDS), b.reshape(nb, ENTRY_WORDS)


def check_peel_table(words: np.ndarray, B: int, P: int) -> None:
    """Raise ``ValueError("peel table: ...")`` unless the table fits ``B``
    bifurcations and ``P`` pairs: every index in range (a fold level's pad
    one past its source, pair ids in ``[-1, P)`` and a pair wherever there
    is a parent); no node eliminated twice; no parent eliminated in its own
    round or an earlier one; each round's ``upar`` sorted and unique; each
    fold naming every child with a parent once, in the row of its parent,
    and each intermediate row once, its outputs in the work buffer apart;
    the core's nodes distinct and none of them peeled, and every node
    peeled or in the core; ``bpar``, ``ucore``, the early gather and the
    saved offsets as the rounds give them; and the launch lists walking
    every round and level once in order, the duty once each way, each grid
    entry with the threads for its items."""
    words = np.asarray(words, np.int64)
    if words.size < HEAD_WORDS:
        raise ValueError("peel table: shorter than its header")
    if int(words[H_B]) != B or int(words[H_P]) != P:
        raise ValueError(f"peel table: made for {int(words[H_B])} nodes and "
                         f"{int(words[H_P])} pairs, not {B} and {P}")
    R, n_peeled, n_core = (int(words[f]) for f in (H_ROUNDS, H_NPEEL, H_NCORE))
    if R < 0 or HEAD_WORDS + R * ROUND_WORDS > words.size:
        raise ValueError("peel table: the round rows lie outside the table")

    def within(name, a, lo, hi):
        if a.size and (int(a.min()) < lo or int(a.max()) >= hi):
            raise ValueError(f"peel table: {name} outside [{lo}, {hi})")

    core = _array(words, int(words[H_CORE]), n_core, "the core nodes")
    within("a core node", core, 0, B)
    if np.unique(core).size != core.size:
        raise ValueError("peel table: a core node twice")
    rank = np.full(B, -1, np.int64)
    rank[core] = np.arange(n_core)
    elim_round = np.full(B, -1, np.int64)
    last_parent = np.full(B, -1, np.int64)
    work = int(words[H_WORK])
    spans = []
    off = 0
    rds = []
    for k in range(R):
        rd = round_arrays(words, k)
        rds.append(rd)
        n, U, tag = rd["n"], rd["U"], f"round {k}"
        elim, par, pid, upar = rd["elim"], rd["parents"], rd["pair_ids"], rd["upar"]
        within(f"{tag}'s elim", elim, 0, B)
        within(f"{tag}'s parents", par, -1, B)
        within(f"{tag}'s pair ids", pid, -1, P)
        within(f"{tag}'s upar", upar, 0, B)
        if rd["off"] != off:
            raise ValueError(f"peel table: {tag}'s saved offset is {rd['off']}, not {off}")
        off += n
        if np.unique(elim).size != n or np.any(elim_round[elim] >= 0):
            raise ValueError(f"peel table: {tag} eliminates a node eliminated before")
        elim_round[elim] = k
        has = par >= 0
        if np.any(elim_round[par[has]] >= 0):
            raise ValueError(f"peel table: a parent of {tag} is eliminated in that round or before")
        if np.any(pid[has] < 0):
            raise ValueError(f"peel table: a child of {tag} has a parent and no pair")
        if U and np.any(np.diff(upar) <= 0):
            raise ValueError(f"peel table: {tag}'s upar is not sorted and unique")
        fold = rd["fold"]
        if bool(fold) != bool(U) or (fold and fold[-1][0].shape[0] != U):
            raise ValueError(f"peel table: {tag}'s fold does not give its {U} parents")
        # the last-level row each level-0 entry reaches, every entry named once
        reach = None
        prev = n
        for l, (lv, out) in enumerate(fold):
            within(f"{tag}'s fold level {l}", lv, 0, prev + 1)
            rows_of = np.repeat(np.arange(lv.shape[0]), lv.shape[1])
            flat = lv.ravel()
            real = flat < prev
            src, dst = flat[real], rows_of[real]
            if np.unique(src).size != src.size:
                raise ValueError(f"peel table: {tag}'s fold level {l} names an entry twice")
            step = np.full(prev, -1, np.int64)
            step[src] = dst
            reach = step if reach is None else np.where(reach >= 0, step[np.maximum(reach, 0)], -1)
            if l < len(fold) - 1:
                if out < 3 * n_peeled or out + 2 * lv.shape[0] > work:
                    raise ValueError(f"peel table: {tag}'s fold level {l} writes outside "
                                     "its scratch")
                spans.append((out, out + 2 * lv.shape[0]))
            elif out != -1:
                raise ValueError(f"peel table: {tag}'s last fold level has an output")
            prev = lv.shape[0]
        named = reach if reach is not None else np.full(n, -1, np.int64)
        if np.any((named >= 0) != has):
            raise ValueError(f"peel table: {tag}'s fold misses a child or names one without "
                             "a parent")
        if np.any(upar[named[has]] != par[has]):
            raise ValueError(f"peel table: {tag}'s fold names a child whose parent is another node")
        last_parent[upar] = k
    spans.sort()
    for (_, e0), (s1, _) in zip(spans, spans[1:]):
        if s1 < e0:
            raise ValueError("peel table: two fold levels write the same scratch")
    if off != n_peeled:
        raise ValueError(f"peel table: {off} nodes peeled, not {n_peeled}")
    if np.any(elim_round[core] >= 0):
        raise ValueError("peel table: a core node is also peeled")
    if n_peeled + n_core != B:
        raise ValueError("peel table: a node is neither peeled nor in the core")
    for k, rd in enumerate(rds):
        par, upar = rd["parents"], rd["upar"]
        bpar = np.where(par >= 0, par, -1)
        cp = (par >= 0) & (rank[np.maximum(par, 0)] >= 0)
        bpar[cp] = -2 - rank[par[cp]]
        if not np.array_equal(rd["bpar"], bpar):
            raise ValueError(f"peel table: round {k}'s bpar is not its parents'")
        ucore = np.where((last_parent[upar] == k) & (rank[upar] >= 0), rank[upar], -1)
        if not np.array_equal(rd["ucore"], ucore):
            raise ValueError(f"peel table: round {k}'s core gathers are not its last updates")
    early = _array(words, int(words[H_EARLY]), int(words[H_NEARLY]), "the early gather")
    if not np.array_equal(early, np.flatnonzero(last_parent[core] < 0)):
        raise ValueError("peel table: the early gather is not the core nodes no round updates")
    _check_entries(words, rds, int(early.size), n_core)
    fwd, back = (sorted(tuple(int(x) for x in e[[E_FIRST, E_LAST, *range(E_LO, ENTRY_WORDS)]])
                        for e in lst if e[E_KIND] == BLOCK) for lst in entries(words))
    if fwd != back:
        raise ValueError("peel table: the back entries' runs are not the forward ones'")
    runs = {a: (b, run) for a, b, *run in fwd}
    updated = np.zeros(B, bool)

    def source(v):
        return np.where(updated[v], B + v, v)

    k = 0
    while k < R:  # each read's source: the assembled system until a round updates the node
        if k in runs:
            b, run = runs[k]
            _check_run(words, rds, k, b, run, elim_round, rank)
            S = run[E_S - E_LO]
            if not np.array_equal(_array(words, run[E_SSRC - E_LO], S, "a run's ssrc"),
                                  source(_array(words, run[E_SLOTS - E_LO], S, "a run's slots"))):
                raise ValueError(f"peel table: the run of rounds [{k}, {b}) reads its slots "
                                 "from the wrong copy")
            for j in range(k, b):
                updated[rds[j]["upar"]] = True
            k = b
            continue
        rd = rds[k]
        if (rd["esrc"] is None or rd["usrc"] is None
                or not np.array_equal(rd["esrc"], source(rd["elim"]))
                or not np.array_equal(rd["usrc"], source(rd["upar"]))):
            raise ValueError(f"peel table: round {k} reads its nodes from the wrong copy")
        if rd["fold"] and (rd["fsrc"] is None or rd["fpid"] is None
                           or not np.array_equal(rd["fsrc"], _children(rd["fold"][0][0].ravel(),
                                                                       source(rd["elim"])))
                           or not np.array_equal(rd["fpid"], _children(rd["fold"][0][0].ravel(),
                                                                       rd["pair_ids"]))):
            raise ValueError(f"peel table: round {k}'s fold children are not its fold's")
        updated[rd["upar"]] = True
        k += 1


def _check_run(words, rds, a: int, b: int, run, elim_round, rank) -> None:
    """A block run's staged words hold every array its rounds read from
    shared memory, its slots are its rounds' nodes and its local arrays,
    ``bsrc``, ``wsrc`` and shared-memory bytes are the rounds'."""
    lo, hi, slots_at, S, bsrc_at, wsrc_at, smem, _ = run
    tag = f"the run of rounds [{a}, {b})"
    if not 0 <= lo <= hi <= words.size:
        raise ValueError(f"peel table: {tag}'s staged words lie outside the table")
    slots = _array(words, slots_at, S, f"{tag}'s slots")
    want = np.unique(np.concatenate([rds[k][f] for k in range(a, b) for f in ("elim", "upar")]))
    if not np.array_equal(slots, want):
        raise ValueError(f"peel table: {tag}'s slots are not its rounds' nodes")
    for k in range(a, b):
        rd, at = rds[k], HEAD_WORDS + k * ROUND_WORDS
        if rd["lelim"] is None or rd["lpar"] is None or rd["lupar"] is None:
            raise ValueError(f"peel table: round {k} of {tag} has no local slots")
        for f, size in ((R_LELIM, rd["n"]), (R_LPAR, rd["n"]), (R_LUPAR, rd["U"]),
                        *((R_FOLD + 1 + 4 * l, lv.size) for l, (lv, _) in enumerate(rd["fold"]))):
            if not lo <= int(words[at + f]) <= int(words[at + f]) + size <= hi:
                raise ValueError(f"peel table: round {k} reads outside {tag}'s staged words")
        par = rd["parents"]
        if (not np.array_equal(rd["lelim"], np.searchsorted(slots, rd["elim"]))
                or not np.array_equal(rd["lupar"], np.searchsorted(slots, rd["upar"]))
                or not np.array_equal(rd["lpar"],
                                      np.where(par >= 0, np.searchsorted(slots, par), -1))):
            raise ValueError(f"peel table: round {k}'s local slots are not its nodes'")
    inside = (elim_round[slots] >= a) & (elim_round[slots] < b)
    bsrc = np.where(inside, -1, np.where(rank[slots] >= 0, -2 - rank[slots], slots))
    if not np.array_equal(_array(words, bsrc_at, S, f"{tag}'s bsrc"), bsrc):
        raise ValueError(f"peel table: {tag}'s bsrc is not where its slots' λ comes from")
    n_run = sum(rds[k]["n"] for k in range(a, b))
    wsrc = np.concatenate([np.where(rds[k]["parents"] >= 0, rds[k]["pair_ids"], -1)
                           for k in range(a, b)])
    if not np.array_equal(_array(words, wsrc_at, n_run, f"{tag}'s wsrc"), wsrc):
        raise ValueError(f"peel table: {tag}'s wsrc is not its children's pairs")
    if not run_smem(S, n_run, b - a, hi - lo) <= smem <= RUN_SMEM:
        raise ValueError(f"peel table: {tag} takes {smem} bytes of shared memory")


def _check_entries(words: np.ndarray, rds: list, n_early: int, n_core: int) -> None:
    fwd, back = entries(words)
    R = len(rds)
    levels = [max(len(rd["fold"]), 1) for rd in rds]

    def grid_items(rd, l):
        return _forward_items(rd["n"], [lv.shape[0] for lv, _ in rd["fold"]], l)

    for name, lst, duty_items, want in (
            ("forward", fwd, n_early, [(k, l) for k in range(R) for l in range(levels[k])]),
            ("back", back, n_core, [(k, 0) for k in reversed(range(R))])):
        seen, duties = [], 0
        for kind, a, b, l, blocks, duty in (tuple(int(x) for x in e[:E_LO]) for e in lst):
            items = duty_items if duty else 0
            if kind == GRID:
                if not (0 <= a < R and b == a + 1 and 0 <= l < levels[a]) or (name == "back" and l):
                    raise ValueError(f"peel table: a {name} grid entry names round {a} level {l}")
                seen.append((a, l))
                items = max(items, grid_items(rds[a], l) if name == "forward" else rds[a]["n"])
            elif kind == BLOCK:
                if not 0 <= a < b <= R or blocks != 1 or items > DUTY_IN_BLOCK:
                    raise ValueError(f"peel table: a {name} block entry of rounds [{a}, {b})")
                ks = range(a, b) if name == "forward" else reversed(range(a, b))
                seen += [(k, l_) for k in ks
                         for l_ in (range(levels[k]) if name == "forward" else (0,))]
            elif kind != DUTY or not duty:
                raise ValueError(f"peel table: a {name} entry of kind {kind}")
            duties += duty != 0
            if kind != BLOCK and blocks * GRID_THREADS < items:
                raise ValueError(f"peel table: a {name} entry has {blocks} blocks for "
                                 f"{items} items")
        if seen != want:
            raise ValueError(f"peel table: the {name} entries do not walk every round once "
                             "in order")
        if duties != int(duty_items > 0):
            raise ValueError(f"peel table: the {name} duty is taken {duties} times")


def peel_table(rounds, core_nodes, B: int, P: int, device, cut: int = 1024) -> PeelTable:
    """Pack (:func:`pack_peel_table`), check and upload the peel rounds."""
    words = pack_peel_table(rounds, core_nodes, B, P, cut)
    check_peel_table(words, B, P)
    host = words.astype(np.int32)
    fwd, back = entries(words)
    return PeelTable(host=host, table=torch.as_tensor(host, device=device), rounds=len(rounds),
                     work_len=int(words[H_WORK]), n_forward=len(fwd), n_back=len(back))
