"""Bidirected assembly graph kernel (asmg_t analogue).

Semantics follow reference graph.c + graph.h: vertices carry a
syncmer list, consensus sequence, length and coverage; arcs are
directed (v = id<<1|orient) with a symmetric complement arc sharing a
link id; deletion is soft until :meth:`Asmg.finalize` compacts.

Representation is struct-of-arrays NumPy so whole-graph passes
(coverage filters, symmetric fixes) vectorize; the data-dependent
cleaning algorithms (tips/bubbles/crosslinks/unitigging) are host loops
-- post-filter organelle graphs are tiny, so this is never hot.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.trace import span

UINT64_MAX = 0xFFFFFFFFFFFFFFFF


def _packed_arc_keys(av: np.ndarray, aw: np.ndarray):
    """(v<<32|w) packed keys, or None when an endpoint overflows 32
    bits (then callers take their sequential fallback)."""
    if len(av) == 0:
        return np.zeros(0, np.uint64)
    if max(int(av.max()), int(aw.max())) >= 1 << 32:
        return None
    return (av << np.uint64(32)) | aw


def _match_complements(av: np.ndarray, aw: np.ndarray):
    """For each arc key (v,w), the index of the arc holding the
    complement key (w^1, v^1), or -1.  Returns None (caller falls back)
    on key overflow or duplicate keys."""
    key = _packed_arc_keys(av, aw)
    if key is None:
        return None
    from .. import native

    order = native.argsort_u64(key)
    if order is None:
        order = np.argsort(key, kind="stable")
    skey = key[order]
    if len(skey) > 1 and np.any(skey[1:] == skey[:-1]):
        return None
    q = ((aw ^ np.uint64(1)) << np.uint64(32)) | (av ^ np.uint64(1))
    pos = np.searchsorted(skey, q)
    pos_c = np.minimum(pos, max(len(skey) - 1, 0))
    found = (pos < len(skey)) & (skey[pos_c] == q)
    return np.where(found, order[pos_c], -1)


class LazyRows:
    """List-like per-vertex syncmer lists backed by one 2-D array
    (bulk builders create one single-syncmer vertex per row; a
    million-entry list of array views costs time and GC pressure at Gbp
    scale).  Reads
    materialize row views on demand; mutation sites (add_vtx) convert to
    a real list first."""

    __slots__ = ("a",)

    def __init__(self, a: np.ndarray):
        self.a = a

    def __len__(self):
        return len(self.a)

    def __getitem__(self, i):
        return self.a[i]

    def __iter__(self):
        return iter(self.a)


class Asmg:
    def __init__(self):
        self.vtx_a: list[np.ndarray | None] = []  # syncmer lists (id<<1|rev)
        self.vtx_seq: list[str | None] = []
        self.vtx_len: list[int] = []
        self.vtx_cov: list[int] = []
        self.vtx_del: list[bool] = []
        self.vtx_circ: list[bool] = []
        # arcs: python lists during construction; finalized into numpy
        self.av: np.ndarray = np.zeros(0, np.uint64)
        self.aw: np.ndarray = np.zeros(0, np.uint64)
        self.aln: np.ndarray = np.zeros(0, np.int64)
        self.als: np.ndarray = np.zeros(0, np.int64)
        self.acov: np.ndarray = np.zeros(0, np.int64)
        self.adel: np.ndarray = np.zeros(0, bool)
        self.acomp: np.ndarray = np.zeros(0, bool)
        self.alink: np.ndarray = np.zeros(0, np.uint64)
        self.idx_p: np.ndarray = np.zeros(0, np.int64)
        self.idx_n: np.ndarray = np.zeros(0, np.int64)
        self._pending: list[tuple] = []  # arcs appended since last index
        # flat concatenation of vtx_a (+ offsets) supplied by bulk
        # builders; lets flat consumers (consensus, inverted index) skip
        # the per-vertex listcomp+concat.  Invalidated on any vtx_a
        # mutation.
        self._va_flat: np.ndarray | None = None
        self._va_off: np.ndarray | None = None
        # complement-partner indices supplied by bulk builders (arc i's
        # complement arc is _arc_partner[i]; palindromes self-partner);
        # lets finalize skip the sorted-search complement matching.
        # Invalidated (None) by any incremental arc mutation.
        self._arc_partner: np.ndarray | None = None
        # bulk-builder promises, both invalidated by incremental arc
        # mutation: _arcs_sorted -- the arc arrays are already in
        # (v,w)-key order, so arc_sort skips its argsort + permutation;
        # _arc_symm_clean -- every complement is present and acomp /
        # aln / als already hold their post-fix_symm values, so
        # _arc_fix_symm only spot-verifies and returns.
        self._arcs_sorted: bool = False
        self._arc_symm_clean: bool = False

    # ---------- construction ----------
    @property
    def n_vtx(self) -> int:
        return len(self.vtx_len)

    @property
    def n_arc(self) -> int:
        return len(self.av) + len(self._pending)

    def add_vtx(self, a=None, seq=None, length=0, cov=0, circ=False, deleted=False) -> int:
        self._va_flat = None
        self._va_off = None
        if not isinstance(self.vtx_a, list):
            self.vtx_a = list(self.vtx_a)  # materialize LazyRows
        # scalar columns may be ndarray-backed (bulk builders /
        # post-cleanup); materialize python lists before appending
        if not isinstance(self.vtx_len, list):
            self.vtx_len = [int(x) for x in self.vtx_len]
            self.vtx_cov = [int(x) for x in self.vtx_cov]
            self.vtx_del = [bool(x) for x in self.vtx_del]
            self.vtx_circ = [bool(x) for x in self.vtx_circ]
        self.vtx_a.append(a)
        self.vtx_seq.append(seq)
        self.vtx_len.append(int(length))
        self.vtx_cov.append(int(cov))
        self.vtx_del.append(bool(deleted))
        self.vtx_circ.append(bool(circ))
        return len(self.vtx_len) - 1

    def add_arc(self, v, w, ln=0, ls=0, link_id=UINT64_MAX, cov=0, comp=0):
        self._pending.append((v, w, ln, ls, cov, False, bool(comp), link_id))
        self._arc_partner = None
        self._arcs_sorted = False
        self._arc_symm_clean = False

    def add_arc2(self, v, w, ln=0, ls=0, link_id=UINT64_MAX, cov=0, comp=0):
        """Add an arc and its complement (skips the palindromic duplicate)."""
        self.add_arc(v, w, ln, ls, link_id, cov, comp)
        if v != (w ^ 1) or w != (v ^ 1):
            self.add_arc(w ^ 1, v ^ 1, ln, ls, link_id, cov, comp ^ 1)

    def _flush_pending(self):
        if not self._pending:
            return
        p = self._pending
        self.av = np.concatenate([self.av, np.array([x[0] for x in p], np.uint64)])
        self.aw = np.concatenate([self.aw, np.array([x[1] for x in p], np.uint64)])
        self.aln = np.concatenate([self.aln, np.array([x[2] for x in p], np.int64)])
        self.als = np.concatenate([self.als, np.array([x[3] for x in p], np.int64)])
        self.acov = np.concatenate([self.acov, np.array([x[4] for x in p], np.int64)])
        self.adel = np.concatenate([self.adel, np.array([x[5] for x in p], bool)])
        self.acomp = np.concatenate([self.acomp, np.array([x[6] for x in p], bool)])
        self.alink = np.concatenate([self.alink, np.array([x[7] for x in p], np.uint64)])
        self._pending = []

    # ---------- finalize: cleanup + sort + index + symm + link ids ----------
    def arc_sort(self):
        self._flush_pending()
        if self._arcs_sorted:
            # builder constructed the arrays in key order (vertex
            # renumbering in _cleanup is monotone, so the promise
            # survives compaction)
            return
        key = _packed_arc_keys(self.av, self.aw)
        if key is not None and len(key):
            from .. import native

            order = native.argsort_u64(key)
            if order is None:
                order = np.argsort(key, kind="stable")
        else:
            order = np.lexsort((self.aw, self.av))
        if self._arc_partner is not None:
            inv = np.empty(len(order), np.int64)
            inv[order] = np.arange(len(order))
            self._arc_partner = inv[self._arc_partner[order]]
        for name in ("av", "aw", "aln", "als", "acov", "adel", "acomp", "alink"):
            setattr(self, name, getattr(self, name)[order])
        self._arcs_sorted = True

    def arc_index(self):
        self._flush_pending()
        n_dir = 2 * self.n_vtx
        self.idx_p = np.zeros(n_dir, np.int64)
        self.idx_n = np.zeros(n_dir, np.int64)
        if len(self.av) == 0:
            return
        v = self.av.astype(np.int64)
        starts = np.flatnonzero(np.concatenate([[True], v[1:] != v[:-1]]))
        counts = np.diff(np.concatenate([starts, [len(v)]]))
        self.idx_p[v[starts]] = starts
        self.idx_n[v[starts]] = counts

    def _cleanup(self):
        """Compact deleted vertices/arcs and renumber (asmg_cleanup)."""
        self._flush_pending()
        vdel = np.asarray(self.vtx_del, bool)
        if not vdel.any() and not self.adel.any():
            return  # nothing to compact
        self._va_flat = None
        self._va_off = None
        keep_v = ~vdel
        new_id = np.cumsum(keep_v) - 1
        self.vtx_a = [a for a, k in zip(self.vtx_a, keep_v) if k]
        self.vtx_seq = [a for a, k in zip(self.vtx_seq, keep_v) if k]
        # scalar columns compact as ndarrays (a multi-million-entry
        # listcomp is slow at Gbp scale; scalar reads/writes work the same)
        self.vtx_len = np.asarray(self.vtx_len, np.int64)[keep_v]
        self.vtx_cov = np.asarray(self.vtx_cov, np.int64)[keep_v]
        self.vtx_circ = np.asarray(self.vtx_circ, bool)[keep_v]
        self.vtx_del = np.zeros(int(keep_v.sum()), bool)
        vsrc = (self.av >> np.uint64(1)).astype(np.int64)
        vdst = (self.aw >> np.uint64(1)).astype(np.int64)
        keep_a = ~self.adel & keep_v[vsrc] & keep_v[vdst]
        if self._arc_partner is not None:
            part = self._arc_partner
            if np.array_equal(keep_a[part], keep_a):  # pairs kept together
                new_pos = np.cumsum(keep_a) - 1
                self._arc_partner = new_pos[part[keep_a]]
            else:
                self._arc_partner = None
                self._arc_symm_clean = False  # one-sided deletions
        for name in ("av", "aw", "aln", "als", "acov", "adel", "acomp", "alink"):
            setattr(self, name, getattr(self, name)[keep_a])
        self.av = (new_id[(self.av >> np.uint64(1)).astype(np.int64)].astype(np.uint64) << np.uint64(1)) | (
            self.av & np.uint64(1)
        )
        self.aw = (new_id[(self.aw >> np.uint64(1)).astype(np.int64)].astype(np.uint64) << np.uint64(1)) | (
            self.aw & np.uint64(1)
        )

    def _arc_fix_symm(self) -> int:
        """Ensure every live arc has its complement; fix comp flags and
        reconcile overlap lengths (asmg_arc_fix_symm).

        Vectorized complement matching via a sorted search over live
        (v,w) keys; falls back to the sequential dict walk when live
        keys are not unique (duplicate arcs make the loop's
        first-occurrence/overwrite order observable)."""
        if (
            self._arc_symm_clean
            and self._arc_partner is not None
            and not self.adel.any()
        ):
            # builder promises complements present and acomp/aln/als in
            # post-fix_symm state; spot-verify a stride of the partner
            # involution instead of materializing full-size gathers
            p = self._arc_partner
            n = len(p)
            if n == 0:
                return 0
            i = np.arange(0, n, max(1, n // 4096), dtype=np.int64)
            pi = p[i]
            if np.all(
                (self.av[pi] == (self.aw[i] ^ np.uint64(1)))
                & (self.aw[pi] == (self.av[i] ^ np.uint64(1)))
                & (p[pi] == i)
            ):
                return 0
            self._arc_symm_clean = False  # broken promise: full path
        live = np.flatnonzero(~self.adel)
        if len(live) == 0:
            self._flush_pending()
            return 0
        av, aw = self.av[live], self.aw[live]
        part = None
        if self._arc_partner is not None and len(live) == len(self.av):
            # builder-supplied complement pairing (unique keys by
            # construction): verify then skip the sorted-search match
            p = self._arc_partner
            if np.all(
                (self.av[p] == (self.aw ^ np.uint64(1)))
                & (self.aw[p] == (self.av ^ np.uint64(1)))
                & (p[p] == np.arange(len(p)))
            ):
                part = p
            else:
                self._arc_partner = None
        if part is None:
            part = _match_complements(av, aw)
        if part is None:
            return self._arc_fix_symm_slow()
        found = part >= 0
        # j: live-arc global index of the complement (valid where found)
        j = live[np.where(found, part, 0)]
        i = live
        selfm = found & (j == i)
        pairm = found & (j > i)
        missing = np.flatnonzero(~found)
        acomp_old = self.acomp.copy()
        # pair (i<j): acomp[j] = !acomp_old[i]; overlaps reconciled to min
        jj, ii = j[pairm], i[pairm]
        self.acomp[jj] = ~acomp_old[ii]
        mn = np.minimum(self.aln[ii], self.aln[jj])
        self.aln[ii] = mn
        self.aln[jj] = mn
        ms = np.minimum(self.als[ii], self.als[jj])
        self.als[ii] = ms
        self.als[jj] = ms
        # palindromic arc is its own complement: comp flag flips once
        self.acomp[i[selfm]] ^= True
        added = len(missing)
        if added:
            self._arc_partner = None  # arrays grow below; indices stale
            mi = i[missing]
            self.av = np.concatenate([self.av, self.aw[mi] ^ np.uint64(1)])
            self.aw = np.concatenate([self.aw, self.av[mi] ^ np.uint64(1)])
            self.aln = np.concatenate([self.aln, self.aln[mi]])
            self.als = np.concatenate([self.als, self.als[mi]])
            self.acov = np.concatenate([self.acov, self.acov[mi]])
            self.adel = np.concatenate([self.adel, np.zeros(added, bool)])
            self.acomp = np.concatenate([self.acomp, ~acomp_old[mi]])
            self.alink = np.concatenate([self.alink, self.alink[mi]])
        return added

    def _arc_fix_symm_slow(self) -> int:
        """Sequential reference walk (kept for duplicate-key graphs)."""
        added = 0
        live = np.flatnonzero(~self.adel)
        # map (v,w) -> arc index for live arcs
        amap = {}
        for i in live:
            amap.setdefault((int(self.av[i]), int(self.aw[i])), int(i))
        for i in live:
            v, w = int(self.av[i]), int(self.aw[i])
            j = amap.get((w ^ 1, v ^ 1))
            if j is None or self.adel[j]:
                self.add_arc(w ^ 1, v ^ 1, int(self.aln[i]), int(self.als[i]),
                             int(self.alink[i]), int(self.acov[i]), not self.acomp[i])
                added += 1
            else:
                self.acomp[j] = not self.acomp[i]
                if self.aln[i] != self.aln[j]:
                    m = min(self.aln[i], self.aln[j])
                    self.aln[i] = self.aln[j] = m
                if self.als[i] != self.als[j]:
                    m = min(self.als[i], self.als[j])
                    self.als[i] = self.als[j] = m
        self._flush_pending()
        return added

    def shrink_link_id(self):
        """Renumber link ids so each arc/complement pair shares one id.

        Vectorized: each arc's partner is the (unique) arc holding its
        complement key; a pair's link id is the rank of its smaller
        member index, matching the sequential counter order.  Falls back
        to the dict walk when keys are not unique."""
        n = len(self.av)
        self.alink = np.full(n, UINT64_MAX, np.uint64)
        if n == 0:
            return
        idx = np.arange(n)
        if self._arc_partner is not None and len(self._arc_partner) == n:
            partner = self._arc_partner
            # rep positions are exactly the i <= partner[i] indices, so
            # the link id (rank of the pair's smaller member) is a
            # prefix count -- no sort, no searchsorted
            rep = np.minimum(idx, partner)
            rank = np.cumsum(idx <= partner) - 1
            self.alink = rank[rep].astype(np.uint64)
            return
        part = _match_complements(self.av, self.aw)
        if part is None:
            return self._shrink_link_id_slow()
        partner = np.where(part >= 0, part, idx)
        rep = np.minimum(idx, partner)
        uniq = np.unique(rep)
        self.alink = np.searchsorted(uniq, rep).astype(np.uint64)

    def _shrink_link_id_slow(self):
        n = len(self.av)
        self.alink = np.full(n, UINT64_MAX, np.uint64)
        amap = {}
        for i in range(n):
            amap.setdefault((int(self.av[i]), int(self.aw[i])), i)
        link = 0
        for i in range(n):
            if self.alink[i] == np.uint64(UINT64_MAX):
                self.alink[i] = link
                j = amap.get((int(self.aw[i]) ^ 1, int(self.av[i]) ^ 1))
                if j is not None:
                    self.alink[j] = link
                link += 1

    def finalize(self, do_cleanup: bool):
        with span("finalize"):
            with span("cleanup"):
                if do_cleanup:
                    self._cleanup()
            with span("sort"):
                self.arc_sort()
            with span("index"):
                import os as _os

                fast = None
                if (
                    self._arcs_sorted
                    and self._arc_symm_clean
                    and self._arc_partner is not None
                    and len(self._arc_partner) == len(self.av)
                    and len(self.av)
                    and int(self.av.max()) < 2 * self.n_vtx
                    and _os.environ.get("OATK_TPU_GRAPH_NATIVE", "1") not in ("0", "")
                ):
                    # bulk-built graph: one threaded C pass builds the vertex
                    # arc index AND the pair link ids without the ~5 full-size
                    # NumPy temporaries (native/graph_build.c)
                    from .. import native

                    fast = native.graph_index_link(self.av, self._arc_partner, 2 * self.n_vtx)
                if fast is not None:
                    self.idx_p, self.idx_n, self.alink = fast
                else:
                    self.arc_index()
            with span("fix_symm"):
                added = self._arc_fix_symm()
            with span("resort"):
                if added:
                    self.arc_sort()
                    self.arc_index()
            with span("shrink"):
                if fast is None or added:
                    self.shrink_link_id()

    # ---------- accessors ----------
    def arc_range(self, v: int) -> range:
        if v >= len(self.idx_n):
            return range(0)
        p = int(self.idx_p[v])
        return range(p, p + int(self.idx_n[v]))

    def arc_n1(self, v: int) -> int:
        r = self.arc_range(v)
        return int((~self.adel[r.start : r.stop]).sum()) if len(r) else 0

    def arc_a1(self, v: int) -> int | None:
        for i in self.arc_range(v):
            if not self.adel[i]:
                return i
        return None

    def arc_idx(self, v: int, w: int, live_only=False) -> int | None:
        for i in self.arc_range(v):
            if int(self.aw[i]) == w and (not live_only or not self.adel[i]):
                return i
        return None

    def arc_exists1(self, v: int, w: int) -> bool:
        return self.arc_idx(v, w, live_only=True) is not None

    def comp_arc_idx(self, i: int, live_only=False) -> int | None:
        return self.arc_idx(int(self.aw[i]) ^ 1, int(self.av[i]) ^ 1, live_only)

    def arc_id(self, i: int) -> int:
        return int(self.alink[i]) << 1 | int(self.acomp[i])

    def comp_arc_id(self, i: int) -> int:
        v, w = int(self.av[i]), int(self.aw[i])
        if (v ^ 1) != w or (w ^ 1) != v:
            return self.arc_id(i) ^ 1
        return self.arc_id(i)

    # ---------- deletion ----------
    def arc_del(self, v: int, w: int, d: bool = True):
        for i in self.arc_range(v):
            if int(self.aw[i]) == w:
                self.adel[i] = d

    def arc_del_v(self, v: int, d: bool = True):
        for i in self.arc_range(v):
            self.adel[i] = d
            self.arc_del(int(self.aw[i]) ^ 1, v ^ 1, d)

    def vtx_delete(self, s: int, d: bool = True):
        self.vtx_del[s] = d
        self.arc_del_v(s << 1, d)
        self.arc_del_v(s << 1 | 1, d)

    def vtx_n1(self) -> int:
        return int(np.count_nonzero(~np.asarray(self.vtx_del, bool))) if self.n_vtx else 0

    def max_link_id(self) -> int:
        live = self.alink[self.alink != np.uint64(UINT64_MAX)]
        return int(live.max()) if len(live) else 0

    def arc_fix_cov(self):
        """Clamp live arc coverage by min endpoint vertex coverage."""
        cov = np.asarray(self.vtx_cov, np.int64)
        if len(self.av) == 0:
            return
        vs = (self.av >> np.uint64(1)).astype(np.int64)
        ws = (self.aw >> np.uint64(1)).astype(np.int64)
        lim = np.minimum(cov[vs], cov[ws])
        live = ~self.adel
        self.acov[live] = np.minimum(self.acov[live], lim[live])

    # ---------- arc head/tail syncmers (for end-syncmer keys) ----------
    def arc_head_e(self, i: int) -> int:
        v = int(self.av[i])
        a = self.vtx_a[v >> 1]
        return int(a[0]) ^ 1 if v & 1 else int(a[-1])

    def arc_tail_e(self, i: int) -> int:
        w = int(self.aw[i])
        a = self.vtx_a[w >> 1]
        return int(a[-1]) ^ 1 if w & 1 else int(a[0])

    def copy(self) -> "Asmg":
        g = Asmg()
        g.vtx_a = [None if a is None else a.copy() for a in self.vtx_a]
        g.vtx_seq = list(self.vtx_seq)
        # type-preserving copies (columns may be list- or ndarray-backed)
        def _ccopy(c):
            return c.copy() if isinstance(c, np.ndarray) else list(c)

        g.vtx_len = _ccopy(self.vtx_len)
        g.vtx_cov = _ccopy(self.vtx_cov)
        g.vtx_del = _ccopy(self.vtx_del)
        g.vtx_circ = _ccopy(self.vtx_circ)
        self._flush_pending()
        for name in ("av", "aw", "aln", "als", "acov", "adel", "acomp", "alink", "idx_p", "idx_n"):
            setattr(g, name, getattr(self, name).copy())
        return g

    def clean_consensus(self):
        self.als[:] = 0
        self._seq_buf = None  # invalidate the raw-emission cache
        self._seq_cuts = None
        self._seq_lazy = None
        for i in range(self.n_vtx):
            self.vtx_seq[i] = None
            self.vtx_len[i] = 0
