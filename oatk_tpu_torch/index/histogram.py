"""Count histograms and hom/het peak detection.

Port of the hifiasm-style peak finder used for automatic ``-c``
selection (reference syncmer.c:760-865) plus the smer/kmer/dist
statistics of sr_db_stat (reference syncmer.c:867-1028).
"""
from __future__ import annotations

import sys

import numpy as np

MAX_DEPTH = 1000
LOWEST_CUT = 5
MAX_RD_LEN_STAT = 0x7FFFFFFF  # m_pos>>1 of the EC splice sentinels


class _KhCtab:
    """Bit-exact replica of the reference's khashl count table
    (khashl.h: kh_hash_uint32 + fibonacci bucketing + linear probing +
    cuckoo-style kick-out resize).  Needed because kh_ctab_stat reads an
    uninitialized 'c' when no singleton group exists -- the printed
    value is whatever count sits in the highest occupied bucket, which
    depends on the exact table layout (syncmer.c:619-646)."""

    M32 = 0xFFFFFFFF

    def __init__(self):
        self.bits = 0
        self.slots: list | None = None  # [key, val] or None per bucket
        self.count = 0

    @staticmethod
    def _hash(key: int) -> int:
        M = _KhCtab.M32
        key &= M
        key = (key + (~(key << 15) & M)) & M
        key ^= key >> 10
        key = (key + ((key << 3) & M)) & M
        key ^= key >> 6
        key = (key + (~(key << 11) & M)) & M
        key ^= key >> 16
        return key

    @staticmethod
    def _h2b(h: int, bits: int) -> int:
        return ((h * 2654435769) & _KhCtab.M32) >> (32 - bits)

    def _resize(self, new_n: int):
        j, x = 0, new_n
        while x >> 1:
            x >>= 1
            j += 1
        if new_n & (new_n - 1):
            j += 1
        new_bits = max(j, 2)
        new_cap = 1 << new_bits
        old_cap = (1 << self.bits) if self.slots is not None else 0
        slots = (self.slots or []) + [None] * (new_cap - old_cap)
        old_used = [s is not None for s in slots]
        new_used = [False] * new_cap
        mask = new_cap - 1
        for b in range(old_cap):
            if not old_used[b]:
                continue
            kv = slots[b]
            slots[b] = None  # vacate (the C keeps a separate used bitmap)
            old_used[b] = False
            while True:  # kick-out relocation, khashl.h:168-181
                i = self._h2b(self._hash(kv[0]), new_bits)
                while new_used[i]:
                    i = (i + 1) & mask
                new_used[i] = True
                if i < old_cap and old_used[i]:
                    kv, slots[i] = slots[i], kv
                    old_used[i] = False
                else:
                    slots[i] = kv
                    break
        self.slots = slots
        self.bits = new_bits

    def put1(self, key: int):
        cap = (1 << self.bits) if self.slots is not None else 0
        if self.count >= (cap >> 1) + (cap >> 2):
            self._resize(cap + 1)
            cap = 1 << self.bits
        mask = cap - 1
        i = self._h2b(self._hash(key), self.bits)
        while self.slots[i] is not None and self.slots[i][0] != key:
            i = (i + 1) & mask
        if self.slots[i] is None:
            self.slots[i] = [key, 1]
            self.count += 1
        else:
            self.slots[i][1] += 1
        return self.slots[i]

    def put_many(self, key: int, times: int):
        """`times` sequential put1(key) calls: only the first insert of a
        key changes table structure (resize/probing); repeats increment
        the stored count in place, so they batch bit-identically."""
        kv = self.put1(key)
        if times > 1:
            kv[1] += times - 1

    def fill_from_counts(self, counts: np.ndarray):
        """Feed a count multiset in the same order a per-item put1 loop
        would (first-appearance order of each distinct value)."""
        if not len(counts):
            return
        uvals, first, times = np.unique(counts, return_index=True, return_counts=True)
        order = np.argsort(first, kind="stable")
        for v, t in zip(uvals[order].tolist(), times[order].tolist()):
            self.put_many(int(v), int(t))

    def stat(self):
        """(avg, uniq, singleton) with the reference's stale-c quirk."""
        s_sum = 0.0
        n = 0
        c = 0
        have_1 = None
        for kv in self.slots or []:
            if kv is None:
                continue
            s_sum += kv[0] * kv[1]
            n += kv[1]
            c = kv[1]
            if kv[0] == 1:
                have_1 = kv[1]
        if have_1 is not None:
            c = have_1
        return (s_sum / n if n else 0.0), n, c


def count_histogram(counts: np.ndarray, max_n: int = MAX_DEPTH) -> np.ndarray:
    """hist[c] = number of items seen exactly c times; c >= max_n pooled."""
    hist = np.zeros(max_n + 1, dtype=np.int64)
    c = np.minimum(counts.astype(np.int64), max_n)
    np.add.at(hist, c, 1)
    return hist


def _ha_hist_line(c, x: int, exceed: bool, cnt: int, fo):
    label = f"{c:5d}" if isinstance(c, int) else f"{c:>5s}"
    stars = "*" * x + (">" if exceed else "")
    print(f"[M::ha_hist_line] {label}: {stars} {cnt}", file=fo)


def analyze_count_peaks(cnt: np.ndarray, start_cnt: int = LOWEST_CUT, verbose: int = 0, fo=sys.stderr):
    """Return (peak_hom, peak_het); -1 when undetermined.

    Same decision procedure as ha_analyze_count: find the leftmost
    trough, the global peak right of it, then secondary peaks on either
    side with the 5%-height and 95%-dip significance rules and the
    2.5x-distance rule on the right.  verbose > 0 reproduces the
    reference's analysis/histogram stderr lines.
    """
    n_cnt = len(cnt)
    peak_het = -1
    start = 1 if cnt[1] > 0 else 2

    low_i = max(start, start_cnt)
    i = low_i + 1
    while i < n_cnt and cnt[i] <= cnt[i - 1]:
        i += 1
    low_i = i - 1
    if verbose > 0:
        print(f"[M::ha_analyze_count] lowest: count[{low_i}] = {int(cnt[low_i])}", file=fo)
    if low_i == n_cnt - 1:
        return -1, peak_het  # low coverage

    max_i = low_i + 1
    for i in range(low_i + 1, n_cnt):
        if cnt[i] > cnt[max_i]:
            max_i = i
    max_v = cnt[max_i]
    if verbose > 0:
        print(f"[M::ha_analyze_count] highest: count[{max_i}] = {int(max_v)}", file=fo)
        hist_max = 100
        i = start
        while i < n_cnt:
            x = int(hist_max * float(cnt[i]) / float(max_v) + 0.499)
            exceed = False
            if x > hist_max:
                exceed, x = True, hist_max
            if i > max_i and x == 0:
                break
            _ha_hist_line(int(i), x, exceed, int(cnt[i]), fo)
            i += 1
        rest = int(np.sum(cnt[i:]))
        x = int(hist_max * float(rest) / float(max_v) + 0.499)
        exceed = False
        if x > hist_max:
            exceed, x = True, hist_max
        _ha_hist_line("rest", x, exceed, rest, fo)

    # smaller peak on the low end
    max2_i, max2 = -1, -1
    for i in range(max_i - 1, low_i, -1):
        if cnt[i] >= cnt[i - 1] and cnt[i] >= cnt[i + 1] and cnt[i] > max2:
            max2, max2_i = cnt[i], i
    if low_i < max2_i < max_i:
        mn = min((cnt[j] for j in range(max2_i + 1, max_i)), default=max_v)
        if max2 < max_v * 0.05 or mn > max2 * 0.95:
            max2, max2_i = -1, -1
    if verbose > 0:
        if max2 > 0:
            print(f"[M::ha_analyze_count] left: count[{max2_i}] = {int(cnt[max2_i])}", file=fo)
        else:
            print("[M::ha_analyze_count] left: none", file=fo)

    # smaller peak on the high end
    max3_i, max3 = -1, -1
    for i in range(max_i + 1, n_cnt - 1):
        if cnt[i] >= cnt[i - 1] and cnt[i] >= cnt[i + 1] and cnt[i] > max3:
            max3, max3_i = cnt[i], i
    if max3_i > max_i:
        mn = min((cnt[j] for j in range(max_i + 1, max3_i)), default=max_v)
        if max3 < max_v * 0.05 or mn > max3 * 0.95 or max3_i > max_i * 2.5:
            max3, max3_i = -1, -1
    if verbose > 0:
        if max3 > 0:
            print(f"[M::ha_analyze_count] right: count[{max3_i}] = {int(cnt[max3_i])}", file=fo)
        else:
            print("[M::ha_analyze_count] right: none", file=fo)

    if max3_i > 0:
        return max3_i, max_i
    if max2_i > 0:
        peak_het = max2_i
    return max_i, peak_het


def hist_plot(hist_pairs, label: str, fo=sys.stderr):
    """ASCII histogram (hist_plot analogue, reference syncmer.c:669-734):
    hist_pairs = sorted [(count_value, frequency)]; bars of '*' scaled to
    the 99% mass, '+' suffix per extra decade."""
    n = len(hist_pairs)
    if n < 5:
        return
    # the first three entries are zeroed for the mass/scale computation
    # (but their raw counts still get bars), syncmer.c:676-696
    cnts = [0, 0, 0] + [freq for _, freq in hist_pairs[3:]]
    tot = sum(cnts) * 0.99
    acc = 0.0
    b = 0
    for i in range(n):
        acc += cnts[i]
        if acc >= tot:
            b = i + 1
            break
    p_cnt = max(cnts[:b], default=0)

    def n_digits(c: int) -> int:
        d = 0 if c > 0 else 1
        while True:
            c = int(c / 10)  # C truncation (toward zero)
            d += 1
            if c == 0:
                return d

    c_digits = max((n_digits(hist_pairs[i][0]) for i in range(b)), default=0)
    if b < n:
        c_digits += 1
    per_dot = max(1, p_cnt // 100)

    def bar_of(cnt: float) -> str:
        d = int(cnt / per_dot)
        s = "*" * min(d, 100)
        if cnt / per_dot > 100:
            s += "+" * int(np.log10(cnt / per_dot / 100))
        return s

    for i in range(b):
        v, c = hist_pairs[i]
        print(f"[M::hist_plot] [{label}] {str(v).rjust(c_digits)}: {bar_of(c)} {c}", file=fo)
    if b < n:
        rest = sum(freq for _, freq in hist_pairs[b:])
        v = hist_pairs[b - 1][0]
        print(
            f"[M::hist_plot] [{label}] >{str(v).rjust(c_digits - 1)}: {bar_of(rest)} {rest}",
            file=fo,
        )


def _sorted_group_counts(vals: np.ndarray) -> np.ndarray:
    """Group sizes in ascending value order -- np.unique's counts, via
    the threaded native radix sort (np.unique's 64-bit mergesort was
    the stat pass's wall at Gbp scale)."""
    a = np.array(vals, np.uint64, copy=True)
    from .. import native

    if not native.sort_u64(a):
        a.sort(kind="stable")
    if not len(a):
        return np.zeros(0, np.int64)
    new = np.concatenate([[True], a[1:] != a[:-1]])
    starts = np.flatnonzero(new)
    return np.diff(np.concatenate([starts, [len(a)]]))


def read_db_stat(read_db, fo=sys.stderr, verbose: int = 0) -> dict:
    """Collect syncmer statistics into read_db.stats; stderr lines match
    sr_db_stat (reference syncmer.c:867-1028) byte-for-byte,
    incl. its 'uniqe' typo, [M::sr_db_stat] framing, and the stale
    singleton count read from the khashl table when no singleton group
    exists (replicated via _KhCtab).  k-mers group by k_mer>>1 (drops
    the ec flag; post-EC corrected mers count under their corrected
    id)."""
    from ..asm.consensus import read_flats

    w = read_db.k
    rf = read_flats(read_db)
    m = int(rf.mc.sum())
    stats: dict = {}
    if m == 0:
        print("[M::sr_db_stat] empty syncmer collection", file=fo)
        read_db.stats = stats
        return stats
    smer = rf.smer(read_db.reads)
    kmer = rf.kflat >> np.uint64(1)
    # adjacent within-read distances, vectorized over the flat stream:
    # a pair (i, i+1) is valid unless i is the last syncmer of its read
    # or either position is the EC sentinel (syncmer.c:895-902)
    mflat = rf.mflat
    p = (mflat >> 1).astype(np.int64)
    last_of_read = np.cumsum(rf.mc[rf.mc > 0])[:-1] - 1
    ok = np.ones(m - 1, bool) if m > 1 else np.zeros(0, bool)
    if m > 1:
        ok[last_of_read] = False
        ok &= (p[1:] != MAX_RD_LEN_STAT) & (p[:-1] != MAX_RD_LEN_STAT)
    dist = (p[1:] - p[:-1] - w)[ok] if m > 1 else np.zeros(0, np.int64)

    s_counts = _sorted_group_counts(smer)
    kmax = int(kmer.max()) if len(kmer) else 0
    if kmax < 4 * len(kmer):
        # post-collection the values are dense syncmer ids (assigned in
        # hash order, so value order == the hash order np.unique gave):
        # O(n) bincount replaces the 64-bit sort
        bc = np.bincount(kmer.astype(np.int64), minlength=kmax + 1)
        k_counts = bc[bc > 0]
    else:
        k_counts = _sorted_group_counts(kmer)
    s_ctab = _KhCtab()
    s_ctab.fill_from_counts(s_counts)
    k_ctab = _KhCtab()
    k_ctab.fill_from_counts(k_counts)
    s_avg, s_uniq, s_single = s_ctab.stat()
    k_avg, k_uniq, k_single = k_ctab.stat()
    s_hist = count_histogram(s_counts)
    k_hist = count_histogram(k_counts)
    s_hom, s_het = analyze_count_peaks(s_hist, verbose=verbose - 1, fo=fo)
    k_hom, k_het = analyze_count_peaks(k_hist, verbose=verbose - 1, fo=fo)

    stats.update(
        syncmer_n=m,
        syncmer_per_read=m / max(1, read_db.n),
        syncmer_avg_dist=float(dist.mean()) if len(dist) else 0.0,
        smer_unique=s_uniq,
        smer_singleton=s_single,
        smer_avg_cnt=s_avg,
        smer_peak_hom=s_hom,
        smer_peak_het=s_het,
        kmer_unique=k_uniq,
        kmer_singleton=k_single,
        kmer_avg_cnt=k_avg,
        kmer_peak_hom=k_hom,
        kmer_peak_het=k_het,
    )
    if fo:
        p = lambda msg: print(f"[M::sr_db_stat] {msg}", file=fo)
        p(f"number syncmers collected: {m}")
        p(f"number syncmers per read: {stats['syncmer_per_read']:.3f}")
        p(f"average kmer space: {stats['syncmer_avg_dist']:.3f}")
        su, s1 = stats["smer_unique"], stats["smer_singleton"]
        p(f"number uniqe smer: {su}; singletons: {s1} ({s1 * 100 / su:.3f}%)")
        p(f"average smer count: {stats['smer_avg_cnt']:.3f}")
        p(f"smer peak_hom: {s_hom}; peak_het: {s_het}")
        ku, k1 = stats["kmer_unique"], stats["kmer_singleton"]
        p(f"number uniqe kmer: {ku}; singletons: {k1} ({k1 * 100 / ku:.3f}%)")
        p(f"average kmer count: {stats['kmer_avg_cnt']:.3f}")
        p(f"kmer peak_hom: {k_hom}; peak_het: {k_het}")
        if verbose > 1:
            dv, dc = np.unique(dist, return_counts=True) if len(dist) else ([], [])
            pairs = sorted(zip([int(x) for x in dv], [int(x) for x in dc]))
            hist_plot(pairs, "DIST", fo)
            _ctab_cnts(pairs, "DIST", fo, verbose - 1)
            sv, sc = np.unique(s_counts, return_counts=True)
            pairs = sorted(zip([int(x) for x in sv], [int(x) for x in sc]))
            hist_plot(pairs, "SMER", fo)
            _ctab_cnts(pairs, "SMER", fo, verbose - 1)
            kv, kc = np.unique(k_counts, return_counts=True)
            pairs = sorted(zip([int(x) for x in kv], [int(x) for x in kc]))
            hist_plot(pairs, "KMER", fo)
            _ctab_cnts(pairs, "KMER", fo, verbose - 1)
    read_db.stats = stats
    return stats


def _ctab_cnts(pairs, label: str, fo, more: int):
    """The '[label CNTS] size count' dump of kh_ctab_print
    (reference syncmer.c:753-756)."""
    if more > 0:
        for s, c in pairs:
            print(f"[M::kh_ctab_print] [{label} CNTS] {s} {c}", file=fo)
