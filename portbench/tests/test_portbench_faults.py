"""The comparison that decides ``correct``, driven through a whole run of
a test-sized cell (k=151, s=13, c=3; a 31 kbp mitochondrion, a 16 kbp
plastid, a nuclear background) on the CPU's plain versions, with the
harness's look for a chip skipped: a sound run is correct, and each
fault planted underneath the timed path, and the control, is not.

Run from the checkout's root: ``python -m pytest portbench/tests -q``.
The ``cuda`` case runs the sound cell on the card and skips without one."""
from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.core import cells, check, main  # noqa: E402
from portbench.data import gen  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEED = 2**33 + 5


def _load(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def _cell():
    return cells.Cell("tiny", "tiny", _load("tiny_config.json"), "tiny",
                      _load("tiny_traffic.json"), _load("tiny_limits.json"), 1,
                      [{"name": "mbp_per_s", "unit": "Mbp/s"}, {"name": "setup_s", "unit": "s"}],
                      [])


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """The sample cache the module's runs share."""
    return str(tmp_path_factory.mktemp("samples"))


def _run(samples, device="cpu"):
    result, _, _ = main.run_cell(_cell(), SEED, 0.5, False, device, time.perf_counter(),
                                 cache_dir=samples)
    return result


def test_a_sound_run_is_correct(samples):
    r = _run(samples)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["metrics"]["mbp_per_s"]["value"] > 0
    assert list(r)[-1] == "checks"


def test_a_state_left_unchanged_is_not_correct(monkeypatch, samples):
    import oatk_tpu_torch.asm.ec as ec

    monkeypatch.setattr(ec, "read_error_correction", lambda *a, **k: None)
    r = _run(samples)
    assert not r["correct"]
    assert r["checks"]["ec_residual_pct"]["value"] > r["checks"]["ec_residual_pct"]["limit"]


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch, tmp_path, samples):
    from oatk_tpu_torch.asm import pipeline

    real = pipeline.syncasm

    def half(files, **kw):
        flat, off = gen.read_fasta(files[0])
        reads = [flat[off[i]:off[i + 1]] for i in range(len(off) // 2)]
        path = str(tmp_path / "half.fa")
        gen.write_fasta(path, reads)
        return real([path], **kw)

    monkeypatch.setattr(pipeline, "syncasm", half)
    r = _run(samples)
    assert not r["correct"]
    assert r["checks"]["sel_mismatch"]["value"] > 0 and r["checks"]["count_mismatch"]["value"] > 0


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch, samples):
    from oatk_tpu_torch.asm import pipeline

    real = pipeline.collect_syncmer_db

    def altered(read_db):
        db = real(read_db)
        db.h[0] ^= np.uint64(1)  # one syncmer's hash, as the count hands it on
        return db

    monkeypatch.setattr(pipeline, "collect_syncmer_db", altered)
    r = _run(samples)
    assert not r["correct"]
    assert r["checks"]["count_mismatch"]["value"] >= 1


@pytest.mark.parametrize("fault", ["longest_segment_lost", "emptied"])
def test_a_final_gfa_cut_where_it_is_written_is_not_correct(monkeypatch, fault, samples):
    from oatk_tpu_torch.asm import pipeline

    real = pipeline.syncasm

    def cut(files, out, **kw):
        res = real(files, out=out, **kw)
        path = out + ".utg.final.gfa"
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")
        segs = [i for i, ln in enumerate(lines) if ln.startswith(b"S\t")]
        drop = set(segs) if fault == "emptied" else {
            max(segs, key=lambda i: len(lines[i].split(b"\t")[2]))}
        with open(path, "wb") as f:
            f.write(b"\n".join(ln for i, ln in enumerate(lines) if i not in drop))
        return res

    monkeypatch.setattr(pipeline, "syncasm", cut)
    r = _run(samples)
    assert not r["correct"]
    assert r["checks"]["gfa_missed"]["value"] > r["checks"]["gfa_missed"]["limit"]
    assert r["checks"]["gfa_foreign"]["value"] == 0


def test_the_control_is_not_correct(tmp_path):
    """The reference at a lower precision (s-mer hashes cut to 16 bits;
    the cell's own control cuts s=31's 62 bits to 32) put in the
    program's place."""
    from portbench.core.program import Program

    cell = _cell()
    cfg = cell.config
    sample, reads = gen.make_sample(cell.traffic, SEED)
    fasta = str(tmp_path / "reads.fa")
    gen.write_fasta(fasta, reads)
    p = Program(cfg["syncasm"], int(cfg["threads"]), "cpu")
    p.job(fasta, str(tmp_path / "out"))
    taken = check.take(p, sample, SEED, int(cfg["ec_sample_reads"]))
    p.last = p.snap = None
    gc.collect()
    k, s = cfg["syncasm"]["k"], cfg["syncasm"]["s"]
    gfa = str(tmp_path / "out.utg.final.gfa")
    sound = check.numbers(taken, fasta, gfa, sample, k, s, "cpu")
    assert check.judge(sound, cell.limits)[0]
    ctl = check.numbers(taken, fasta, gfa, sample, k, s, "cpu", hash_bits=16)
    ok, out = check.judge(ctl, cell.limits)
    assert not ok and out["sel_mismatch"]["value"] > 0


@pytest.mark.cuda
def test_a_sound_run_on_the_card_is_correct(samples):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = _run(samples, "cuda")
    assert r["correct"], r["checks"]
