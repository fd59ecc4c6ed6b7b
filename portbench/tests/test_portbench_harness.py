"""The benchmark's harness on the CPU: cells found by name, the generator,
the window's arithmetic, the roofline's byte count, the plain reference
against a hand-made case, and what the harness may import.

Run from the checkout's root: ``python -m pytest portbench/tests -q``."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.core import cells, roofline, window  # noqa: E402
from portbench.data import gen  # noqa: E402
from portbench.reference import syncmers as ref  # noqa: E402
from portbench.reference import truth  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _tiny_traffic():
    with open(os.path.join(DATA, "tiny_traffic.json")) as f:
        return json.load(f)


def test_every_cell_finds_its_files():
    b = cells.benchmark()
    for w in b["workloads"]:
        c = cells.find(w["name"])
        assert c.config["syncasm"]["k"] > c.config["syncasm"]["s"]
        assert c.traffic["genomes"]
        assert {"sel_mismatch", "count_mismatch", "gfa_foreign", "gfa_missed"} <= set(c.limits)
        names = {m["name"] for m in c.end_to_end} | {m["name"] for m in c.per_layer}
        for n in names:
            assert callable(cells.metric_reader(n))
    with pytest.raises(KeyError):
        cells.find("no-such-cell")


def test_cells_report_what_benchmark_json_says(tmp_path):
    c = cells.find("athal-syncasm.wgs-1G")
    names = {m["name"] for m in c.per_layer}
    assert "load_ms" in names and "ec_driver_ms" not in names
    assert [m["name"] for m in c.end_to_end] == ["mbp_per_s", "setup_s"]
    # the device-EC cell, kept out of BENCHMARK.json, comes back by its
    # entries alone: its configuration, traffic, limits and readers are files
    b = cells.benchmark()
    cell = "athal-syncasm-wfdev.q27-110M"
    b["configs"].append({"name": "athal-syncasm-wfdev", "source": "-", "reduced": ["threads"],
                         "file": "portbench/configs/athal-syncasm-wfdev.json", "why": "-"})
    b["workloads"].append({"name": cell, "config": "athal-syncasm-wfdev", "traffic": "q27-110M",
                           "chips": 1, "why": "-"})
    for m in b["per_layer"]:
        m["workloads"].append(cell)
    for n in ("ec_driver_ms", "k2_device_ms"):
        b["per_layer"].append({"name": n, "unit": "ms", "better": "lower", "source": "-",
                               "layer": "-", "moves": "mbp_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    os.symlink(cells.HERE, tmp_path / "portbench")
    w = cells.find(cell, root=str(tmp_path))
    assert w.config["env"] == {"OATK_TPU_WF_BACKEND": "device"}
    assert {"sel_mismatch", "count_mismatch", "gfa_foreign", "gfa_missed"} <= set(w.limits)
    assert {"ec_driver_ms", "k2_device_ms", "load_ms"} <= {m["name"] for m in w.per_layer}
    assert all(callable(cells.metric_reader(m["name"])) for m in w.per_layer)


def test_generator_repeats_for_a_seed():
    t = _tiny_traffic()
    s1, r1 = gen.make_sample(t, 2**40 + 3)
    s2, r2 = gen.make_sample(t, 2**40 + 3)
    s3, r3 = gen.make_sample(t, 2**40 + 4)
    assert len(r1) == len(r2) and all((a == b).all() for a, b in zip(r1, r2))
    assert (s1.start == s2.start).all() and (s1.rev == s2.rev).all()
    assert any(len(a) != len(b) or (a != b).any() for a, b in zip(r1, r3))
    # every seed has the same reads, in another order and some of them
    # reverse-complemented
    canon = lambda r: min(r.tobytes(), gen._COMP[r[::-1]].tobytes())  # noqa: E731
    assert sorted(map(canon, r1)) == sorted(map(canon, r3))


def test_cached_sample_is_the_generated_one(tmp_path):
    t = _tiny_traffic()
    seed = 2**41 + 1
    s0, r0 = gen.make_sample(t, seed)
    gen.write_fasta(str(tmp_path / "a.fa"), r0)
    cache = str(tmp_path / "cache")
    made = gen.prepare(t, seed, str(tmp_path / "b.fa"), cache)  # makes the cache
    assert os.listdir(cache) == [gen.cache_key(t)]
    read = gen.prepare(t, seed, str(tmp_path / "c.fa"), cache)  # reads it back
    a = (tmp_path / "a.fa").read_bytes()
    assert a == (tmp_path / "b.fa").read_bytes() == (tmp_path / "c.fa").read_bytes()
    for s in (made, read):
        for k in ("src", "start", "length", "rev", "seq_len"):
            assert (getattr(s, k) == getattr(s0, k)).all()
        assert s.n_bases == s0.n_bases and s.organelles == s0.organelles
        assert all((s.true_read(i) == s0.true_read(i)).all() for i in range(0, len(r0), 9))
    # another traffic file never reads this one's sample
    assert gen.cache_key(dict(t, err_rate=0.003)) != gen.cache_key(t)


def test_generator_reads_come_from_their_source():
    t = dict(_tiny_traffic(), err_rate=0.0)
    s, reads = gen.make_sample(t, 9)
    for i in range(0, len(reads), 7):
        assert (reads[i] == s.true_read(i)).all()
    assert s.n_bases == sum(len(r) for r in reads)
    assert s.organelles == {"mito", "plastid"}


def test_generator_errors_follow_the_rate(tmp_path):
    t = dict(_tiny_traffic(), err_rate=0.01, hp_frac=0.0)
    s, reads = gen.make_sample(t, 5)
    # length changes: insertions minus deletions, a third each of 1%
    d = np.array([len(r) for r in reads]) - s.length
    assert abs(d.mean()) < 0.002 * s.length.mean()
    path = str(tmp_path / "r.fa")
    gen.write_fasta(path, reads)
    flat, off = gen.read_fasta(path)
    assert off[-1] == s.n_bases
    assert all((flat[off[i]:off[i + 1]] == reads[i]).all() for i in range(len(reads)))


def test_window_divides_by_the_jobs_real_time():
    ticks = iter([0.0, 0.0, 2.0, 2.5, 5.0, 5.0, 7.5])  # t0, (start, end) x 3

    spans, res = window.run(lambda: "job", 5.0, clock=lambda: next(ticks))
    # the window closes at the end of the first job that ends at or after 5 s
    assert spans == [(0.0, 2.0), (2.5, 5.0)]
    assert res == ["job", "job"]
    # two whole jobs of 100 Mbp over 5.0 s, the gap between them counted
    assert window.rate(100.0, spans) == pytest.approx(40.0)


def test_window_counts_the_edge_job_whole():
    ticks = iter([0.0, 0.0, 3.0, 3.0, 6.5])
    spans, _ = window.run(lambda: None, 4.0, clock=lambda: next(ticks))
    assert spans == [(0.0, 3.0), (3.0, 6.5)]
    assert window.rate(10.0, spans) == pytest.approx(20.0 / 6.5)


def test_roofline_bytes_by_hand():
    # 1000 hoco bases at 2 bits, 2 N positions at 4 bytes, 3 syncmers at
    # 12 bytes (position with strand, 64-bit hash)
    assert roofline.chain_bytes(1000, 2, 3) == 250 + 8 + 36
    # k=1001: 251 packed bytes, 32 Murmur blocks, 32 words of 32 bases
    assert roofline.chain_ops32(10, 1, 1001) == 2 * (38 * 10 + 6 * 32 + 3 * 32)
    least, bound = roofline.least_seconds(10**9, 0, 10**6, 1001)
    assert bound == "operations" and least > 0


def test_reference_on_a_hand_made_read():
    # w=5, s=3 on "ACGTTA" -> hoco "ACGTA" (one k-mer, position 0)
    seq = np.frombuffer(b"ACGTTA", np.uint8)
    rd, mpos, kh, ties, hlen, n_n = ref.extract(seq, np.array([0, 6]), 5, 3)
    assert hlen.tolist() == [5] and n_n == 0
    # s-mers ACG, CGT, GTA: canonical ACG (fwd), ACG (rc of CGT), GTA (fwd)
    mask = (1 << 6) - 1
    acg = 0b000110
    gta = 0b101100
    h = [int(x) for x in ref.wang_hash(torch.tensor([acg, acg, gta]), mask)]
    # the first and last s-mers are ACG and GTA: closed if exactly one of
    # them is the least; ACG also sits in the middle (a tie there)
    m = min(h)
    want_open, want_close = h[0] == m, h[2] == m
    if want_open != want_close:
        assert len(rd) == 1 and mpos[0] >> 1 == 0
        z = 0 if want_open else 0  # ACG fwd (z 0) first; GTA fwd (z 0) last
        assert mpos[0] & 1 == z
        # the window packed (A C G T A -> 00 01 10 11 | 00 ...) and hashed
        assert kh[0] == np.uint64(ref.murmur64a(torch.tensor([[0b00011011, 0b00000000]],
                                                             dtype=torch.uint8))[0] & (2**64 - 1))
    else:
        assert len(rd) == 0
    assert ties == (1 if h[1] == m and (want_open or want_close) else 0)


def test_murmur_matches_the_published_algorithm():
    # MurmurHash64A(seed 1234) written out in Python integers
    def mm(data: bytes, seed=1234):
        m, r, mask = 0xC6A4A7935BD1E995, 47, 2**64 - 1
        h = (seed ^ (len(data) * m)) & mask
        nb = len(data) // 8
        for i in range(nb):
            k = int.from_bytes(data[8 * i:8 * i + 8], "little")
            k = (k * m) & mask
            k ^= k >> r
            k = (k * m) & mask
            h ^= k
            h = (h * m) & mask
        tail = data[8 * nb:]
        if tail:
            h ^= int.from_bytes(tail, "little")
            h = (h * m) & mask
        h ^= h >> r
        h = (h * m) & mask
        h ^= h >> r
        return h

    rng = np.random.default_rng(1)
    for n in (1, 7, 8, 9, 251):
        rows = rng.integers(0, 256, size=(4, n), dtype=np.uint8)
        got = ref.murmur64a(torch.from_numpy(rows)).numpy().view(np.uint64)
        assert [int(x) for x in got] == [mm(bytes(r)) for r in rows]


def test_truth_checks_by_hand():
    g = np.frombuffer(b"ACGTTGCAAGGCTTACGATCGGATCCATGCAATGCCGTAGCTAGGCATTA", np.uint8)
    kmers = truth.genome_kmers([g])
    # a segment that goes once round the circle from position 30, with
    # the k-1 bases where it closes, on the reverse strand
    seg = np.concatenate([g, g, g])[30:30 + len(g) + truth.K - 1]
    comp = np.frombuffer(bytes.maketrans(b"ACGT", b"TGCA"), np.uint8)
    rc = comp[seg[::-1]]
    assert truth.gfa_kmer_errors([rc], kmers) == (0, 0)
    bad = seg.copy()
    bad[25] = ord("A") if bad[25] != ord("A") else ord("C")
    foreign, missed = truth.gfa_kmer_errors([bad], kmers)
    assert foreign > 0 and missed > 0
    assert truth.multiset_diff(np.array([0, 0, 1]), np.array([5, 5, 7], np.uint64),
                               np.array([0, 1, 1]), np.array([5, 7, 8], np.uint64)) == 2


def test_the_harness_loads_no_jax_and_the_reference_no_port():
    """Import the harness, the generator and the reference (and the
    readers of every metric) in a fresh process and list the top-level
    names it loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.reference.syncmers, portbench.reference.truth\n"
        "ref = {m.split('.')[0] for m in sys.modules}\n"
        "import portbench.core.main, portbench.core.check, portbench.core.trace\n"
        "import portbench.data.gen, portbench.readings\n"
        "from portbench.core import cells\n"
        "for m in cells.benchmark()['per_layer'] + cells.benchmark()['end_to_end']:\n"
        "    cells.metric_reader(m['name'])\n"
        "import portbench.core.program as p; p.Program\n"
        "allm = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(ref)); print(sorted(allm))\n" % ROOT
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True).stdout.splitlines()
    ref_tops, all_tops = eval(out[0]), eval(out[1])
    for name in ("jax", "jaxlib", "flax", "oatk_tpu"):
        assert name not in all_tops
    assert "oatk_tpu_torch" not in ref_tops


def test_block_errors_are_genome_sims_per_read():
    """gen._inject over a block of reads places every error as
    ``tests/genome_sim.py:inject_errors``' np.repeat construction does, read by read,
    from the same draws."""
    reads = [np.frombuffer(("AACCGTTTAGGC" * r).encode(), np.uint8) for r in (50, 80, 120, 30)]
    a = np.concatenate(reads)
    off = np.zeros(len(reads) + 1, np.int64)
    off[1:] = np.cumsum([len(r) for r in reads])
    rate, hp_frac = 0.08, 0.6
    for seed in range(10):
        out, change = gen._inject(np.random.default_rng(seed), a, off, rate, hp_frac)
        r = np.random.default_rng(seed)
        n = len(a)
        want = int(n * rate * 1.2) + 64
        pos = np.cumsum(r.geometric(rate, size=want)) - 1
        while pos[-1] < n:
            pos = np.concatenate([pos, np.cumsum(r.geometric(rate, size=want)) + pos[-1]])
        idx = pos[pos < n]
        is_hp = r.random(len(idx)) < hp_frac
        hp_i = idx[is_hp]
        dup = r.random(len(hp_i)) < 0.5
        left_same = np.zeros(len(hp_i), bool)
        nz = ~np.isin(hp_i, off[:-1])
        left_same[nz] = a[hp_i[nz] - 1] == a[hp_i[nz]]
        rep = np.ones(n, np.int64)
        rep[hp_i] = np.where(dup | ~left_same, 2, 0)
        ot = idx[~is_hp]
        kind = r.integers(0, 3, size=len(ot))
        rnd = gen._NT[r.integers(0, 4, size=len(ot))]
        rep[ot[kind == 2]] = 0
        rep[ot[kind == 1]] = 2
        want_out = np.repeat(a, rep)
        cum = np.cumsum(rep)
        want_out[cum[ot[kind == 0]] - 1] = rnd[kind == 0]
        want_out[cum[ot[kind == 1]] - 1] = rnd[kind == 1]
        assert (out == want_out).all()
        csum = np.concatenate([[0], cum])
        assert (np.diff(off) + change == np.diff(csum[off])).all()
