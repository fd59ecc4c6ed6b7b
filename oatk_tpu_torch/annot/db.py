"""HMM annotation database: nhmmscan tblout parsing, sorting, queries,
BED6 projection (hmmannot.c analogue).

Annotations are parsed into parallel numpy arrays with interned
gene/segment name dictionaries; the sort orders and (gid/sid)->range
index mirror reference hmmannot.c:242-416.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

OG_UNCLASSIFIED = 0
OG_MITO = 1
OG_PLTD = 2
OG_MINI = 3
OG_TYPES = ["unclassified", "mito", "pltd", "mini"]
MAX_BED_SCORE = 1000

# canonical A. thaliana plastid gene order used for pltd rotation
# (reference hmmannot.h:36-46)
ATHALIANA_PLTD_G71 = [
    "psbA", "matK", "rps16", "psbK", "psbI", "atpA", "atpF", "atpH", "atpI", "rps2",
    "rpoC2", "rpoC1", "rpoB", "ycf6", "psbM", "psbD", "psbC", "ycf9", "rps14", "psaB",
    "psaA", "ycf3", "rps4", "ndhJ", "psbG", "ndhC", "atpE", "atpB", "rbcL", "accD",
    "psaI", "ycf4", "cemA", "petA", "psbJ", "psbL", "psbF", "psbE", "ORF31", "petG",
    "psaJ", "rpl33", "rps18", "rpl20", "clpP", "psbB", "psbT", "psbN", "psbH", "petB",
    "petD", "rpoA", "rps11", "rpl36", "rps8", "rpl14", "rpl16", "rps3", "rpl22", "rps19",
    "ndhF", "rpl32", "ycf5", "ndhD", "psaC", "ndhE", "ndhG", "ndhI", "ndhA", "ndhH",
    "rps15",
]

ORDER_UNSORTED = 0
ORDER_GNAME = 1  # gene name (strcmp)
ORDER_GID = 2  # gene id
ORDER_SNAME = 3  # segment name (strcmp)
ORDER_SID = 4  # segment id
ORDER_SID_OG = 5  # sid - og_type - gid - score(desc)
ORDER_SID_CO = 6  # sid - alifrom - alito


@dataclass
class AnnotDB:
    gname: list[str] = field(default_factory=list)  # per record
    sname: list[str] = field(default_factory=list)
    gid: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    sid: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    og_type: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    strand: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    hmmfrom: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    hmmto: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    alifrom: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    alito: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    modlen: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    evalue: np.ndarray = field(default_factory=lambda: np.zeros(0, float))
    score: np.ndarray = field(default_factory=lambda: np.zeros(0, float))
    bias: np.ndarray = field(default_factory=lambda: np.zeros(0, float))
    gnames: list[str] = field(default_factory=list)  # dictionaries
    snames: list[str] = field(default_factory=list)
    h_gnames: dict = field(default_factory=dict)
    h_snames: dict = field(default_factory=dict)
    so: int = ORDER_UNSORTED
    index: np.ndarray | None = None  # per first-key id: start<<32|count

    @property
    def n(self) -> int:
        return len(self.gid)

    @property
    def n_gene(self) -> int:
        return len(self.gnames)

    @property
    def n_seg(self) -> int:
        return len(self.snames)

    def gname2id(self, name: str) -> int:
        return self.h_gnames.get(name, 0xFFFFFFFF)

    def sname2id(self, name: str) -> int:
        return self.h_snames.get(name, 0xFFFFFFFF)

    # ---- sorting / indexing ----
    def sort(self, so: int):
        """All 6 reference sort orders (hmmannot.c:242-392); the pipeline
        uses ORDER_SID_OG / ORDER_SID_CO, the rest are API parity."""
        if so == self.so:
            return
        if so == ORDER_SID_OG:
            order = np.lexsort((-self.score, self.gid, self.og_type, self.sid))
        elif so == ORDER_SID_CO:
            order = np.lexsort((self.alito, self.alifrom, self.sid))
        elif so == ORDER_GNAME:
            order = sorted(range(self.n), key=lambda i: self.gname[i])
        elif so == ORDER_GID:
            order = np.argsort(self.gid, kind="stable")
        elif so == ORDER_SNAME:
            order = sorted(range(self.n), key=lambda i: self.sname[i])
        elif so == ORDER_SID:
            order = np.argsort(self.sid, kind="stable")
        else:
            raise ValueError(so)
        self._permute(order)
        self.so = so
        # name-keyed orders carry no range index (hmmannot.c:344-346)
        if so in (ORDER_GNAME, ORDER_SNAME):
            self.index = None
        elif so == ORDER_GID:
            self._build_index(self.gid, self.n_gene)
        else:
            self._build_index()

    def _permute(self, order):
        self.gname = [self.gname[i] for i in order]
        self.sname = [self.sname[i] for i in order]
        for f in (
            "gid", "sid", "og_type", "strand", "hmmfrom", "hmmto",
            "alifrom", "alito", "modlen", "evalue", "score", "bias",
        ):
            setattr(self, f, getattr(self, f)[order])

    def _build_index(self, key: np.ndarray | None = None, n_idx: int | None = None):
        key = self.sid if key is None else key
        n_idx = self.n_seg if n_idx is None else n_idx
        self.index = np.zeros(n_idx, np.int64)
        if self.n == 0:
            return
        starts = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
        counts = np.diff(np.concatenate([starts, [self.n]]))
        self.index[key[starts]] = (starts << 32) | counts

    def query_sid(self, sid: int) -> slice:
        if self.index is None or sid >= len(self.index) or sid < 0:
            return slice(0, 0)
        x = int(self.index[sid])
        return slice(x >> 32, (x >> 32) + (x & 0xFFFFFFFF))

    def query_sname(self, sname: str) -> slice:
        return self.query_sid(self.sname2id(sname))


def is_trn(gname: str) -> bool:
    return gname.startswith("trn")


def is_rrn(gname: str) -> bool:
    return gname.startswith("rrn")


def hmm_annot_read(path: str, db: AnnotDB | None, og_type: int) -> AnnotDB:
    """Parse an nhmmscan --tblout file, appending to ``db``."""
    if db is None:
        db = AnnotDB()
    rows = []
    with open(path) as fp:
        for line in fp:
            if not line.strip() or line.startswith("#"):
                continue
            f = line.split()
            rows.append(f)
    if not rows:
        return db

    def intern(name: str, names: list[str], h: dict) -> int:
        if name in h:
            return h[name]
        h[name] = len(names)
        names.append(name)
        return h[name]

    gid, sid, strand = [], [], []
    hmmfrom, hmmto, alifrom, alito, modlen = [], [], [], [], []
    evalue, score, bias = [], [], []
    gname_r, sname_r = [], []
    for f in rows:
        gn, sn = f[0], f[2]
        hf, ht, af, at = int(f[4]), int(f[5]), int(f[6]), int(f[7])
        ef, et, ml = int(f[8]), int(f[9]), int(f[10])
        st = 0 if f[11] == "+" else 1
        ev, sc, bi = float(f[12]), float(f[13]), float(f[14])
        if st:
            af, at = at, af
        gname_r.append(gn)
        sname_r.append(sn)
        sid.append(intern(sn, db.snames, db.h_snames))
        gid.append(intern(gn, db.gnames, db.h_gnames))
        strand.append(st)
        hmmfrom.append(hf)
        hmmto.append(ht)
        alifrom.append(af)
        alito.append(at)
        modlen.append(ml)
        evalue.append(ev)
        score.append(sc)
        bias.append(bi)

    db.gname += gname_r
    db.sname += sname_r
    cat = lambda a, b, dt: np.concatenate([a, np.array(b, dt)])
    db.gid = cat(db.gid, gid, np.int64)
    db.sid = cat(db.sid, sid, np.int64)
    db.og_type = cat(db.og_type, [og_type] * len(rows), np.int64)
    db.strand = cat(db.strand, strand, np.int64)
    db.hmmfrom = cat(db.hmmfrom, hmmfrom, np.int64)
    db.hmmto = cat(db.hmmto, hmmto, np.int64)
    db.alifrom = cat(db.alifrom, alifrom, np.int64)
    db.alito = cat(db.alito, alito, np.int64)
    db.modlen = cat(db.modlen, modlen, np.int64)
    db.evalue = cat(db.evalue, evalue, float)
    db.score = cat(db.score, score, float)
    db.bias = cat(db.bias, bias, float)
    db.so = ORDER_UNSORTED
    return db


# ---------------- BED6 output ----------------

@dataclass
class Bed6DB:
    rows: list[tuple] = field(default_factory=list)  # (cname, alifrom, alito, gname, score, strand)
    snames: list[str] = field(default_factory=list)


def _lround(x: float) -> int:
    return int(np.floor(x + 0.5)) if x >= 0 else -int(np.floor(-x + 0.5))


def bed6_sname_add(
    bed: Bed6DB,
    db: AnnotDB,
    cname: str,
    sname: str,
    seg_len: int,
    beg: int,
    rev: int,
    offset: int,
    og_type: int,
    max_evalue: float,
):
    """Project a segment's annotations onto assembled path coordinates
    (strand flip on reverse orientation, clip at ``beg``, keep only hits
    retaining >= 50% of their aligned span)."""
    db.sort(ORDER_SID_CO)
    sl = db.query_sname(sname)
    for i in range(sl.start, sl.stop):
        if db.og_type[i] != og_type or db.evalue[i] > max_evalue:
            continue
        af, at = int(db.alifrom[i]), int(db.alito[i])
        if af > at:
            continue
        alilen = at - af
        strand = int(db.strand[i])
        score = min(_lround(db.score[i]), MAX_BED_SCORE)
        if rev:
            af, at = seg_len - at, seg_len - af
            strand = 1 - strand
        af = max(af, beg) - beg
        at = max(at, beg) - beg
        if (at - af) < alilen * 0.5:
            continue
        bed.rows.append((cname, af + offset, at + offset, db.gname[i], score, "-" if strand else "+"))


def bed6_print(bed: Bed6DB, fo, header: bool = True):
    if not bed.rows:
        return
    if header:
        fo.write(f"#seq_name align_from align_to gene_name score_capped_at_{MAX_BED_SCORE} strand\n")
    for r in sorted(bed.rows, key=lambda r: (r[0], r[1], r[2])):
        fo.write(f"{r[0]}\t{r[1]}\t{r[2]}\t{r[3]}\t{r[4]}\t{r[5]}\n")


def formatted_print_sname_list(db: AnnotDB, sname_list, fo, og_type: int, max_evalue: float, header: bool = True):
    db.sort(ORDER_SID_CO)
    if header:
        fo.write(f"#seq_name align_from align_to gene_name score_capped_at_{MAX_BED_SCORE} strand\n")
    for sname in sname_list:
        sl = db.query_sname(sname)
        for i in range(sl.start, sl.stop):
            if db.og_type[i] != og_type or db.evalue[i] > max_evalue:
                continue
            score = min(_lround(db.score[i]), MAX_BED_SCORE)
            fo.write(
                f"{db.sname[i]}\t{int(db.alifrom[i])}\t{int(db.alito[i])}\t{db.gname[i]}\t"
                f"{score}\t{'-' if db.strand[i] else '+'}\n"
            )
