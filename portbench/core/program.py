"""The system under test: ``oatk_tpu_torch.asm.pipeline.syncasm``, called
in-process, one whole job per call.

What the benchmark takes from the program: the job's return value (its
``timings`` and state), ``wf_ed_lockstep.last`` (EC's device driver),
and, through a thin wrapper around the pipeline's ``collect_syncmer_db``
that keeps references and copies nothing, the count's arrays as the
count leaves them, before error correction replaces them.  In a traced
run each stage function that ``_syncasm_impl`` calls is wrapped in a
``torch.profiler.record_function`` span named after it."""
from __future__ import annotations

import functools
import importlib

# the stage functions _syncasm_impl calls, by the module it finds them in
STAGES = {
    "oatk_tpu_torch.asm.pipeline": (
        "load_reads", "collect_syncmer_db", "read_db_stat", "make_syncmer_graph",
        "scg_consensus", "process_mergeable_unitigs", "drop_tip", "pop_bubble",
        "remove_weak_crosslink", "scg_stat",
    ),
    "oatk_tpu_torch.asm.ec": ("read_error_correction",),
    "oatk_tpu_torch.asm.align": ("scg_read_alignment",),
    "oatk_tpu_torch.asm.coverage": (
        "scg_ra_arc_coverage", "scg_ra_utg_coverage", "scg_update_utg_cov",
    ),
    "oatk_tpu_torch.asm.unzip": ("scg_demultiplex", "scg_multiplex"),
}


class Snapshot:
    """The count as it left ``collect_syncmer_db``: the DB's hashes and
    counts and the reads' flat syncmer arrays (id << 1, pos << 1 | z),
    by reference."""

    def __init__(self, db, read_db):
        self.h = db.h
        self.cov = db.cov
        cache = getattr(read_db, "_rflats_cache", None)
        if cache is not None and cache[0] == getattr(read_db, "version", 0):
            rf = cache[1]
            self.mc, self.kflat, self.mflat = rf.mc, rf.kflat, rf.mflat
            self.per_read = None
        else:  # a route that registers no flats: the reads' own arrays
            self.per_read = [(r.m_pos, r.k_mer) for r in read_db.reads]


class Program:
    def __init__(self, syncasm_args: dict, threads: int, device: str):
        from oatk_tpu_torch.asm import pipeline
        from oatk_tpu_torch.kernels import wf_ed

        self.pipeline = pipeline
        self.wf_ed = wf_ed
        self.args = dict(syncasm_args, threads=threads)
        self.device = device
        self.snap = None
        self.last = None
        orig = pipeline.collect_syncmer_db

        @functools.wraps(orig)
        def collect(read_db):
            db = orig(read_db)
            self.snap = Snapshot(db, read_db) if db is not None else None
            return db

        pipeline.collect_syncmer_db = collect

    def job(self, fasta: str, out: str):
        """One whole job; returns (timings, EC driver split or None) and
        keeps the job's state in ``last`` and ``snap``."""
        self.last = self.snap = None
        self.wf_ed.wf_ed_lockstep.last = None
        res = self.pipeline.syncasm([fasta], out=out, device=self.device, **self.args)
        self.last = res
        return res.timings, self.wf_ed.wf_ed_lockstep.last

    def add_spans(self):
        """Wrap every stage function in a profiler span of its name."""
        import torch

        for modname, names in STAGES.items():
            mod = importlib.import_module(modname)
            for name in names:
                fn = getattr(mod, name)

                def spanned(*a, _fn=fn, _name=name, **kw):
                    with torch.profiler.record_function(_name):
                        return _fn(*a, **kw)

                setattr(mod, name, functools.wraps(fn)(spanned))
