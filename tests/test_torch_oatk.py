"""The port's ``oatk`` wrapper and its four standalone CLIs against the
JAX package's, on the same inputs, with the stub nhmmscan of
test_tools_parity.py (nhmmscan is an external program; the stub makes
both sides deterministic).  Tolerance: every output file byte-identical.

The port's assembly runs on the CPU (the kernels' plain versions) with
EC's wavefront on the ``device`` backend; the JAX package's runs at its
defaults (native batch EC)."""
import stat

import numpy as np
import pytest

from genome_sim import random_genome, sample_reads, write_reads
from test_tools_parity import FAKE_NHMMSCAN

import oatk_tpu_torch.kernels.wavefront as TW
from oatk_tpu_torch.asm import ec as TEC

ASM = (".utg.gfa", ".utg.final.gfa")
MITO = (".annot_mito.txt", ".mito.gfa", ".mito.bed", ".mito.ctg.fasta", ".mito.ctg.bed")
MINI = (".annot_mito.txt", ".mini.gfa", ".mini.bed", ".mini.ctg.fasta", ".mini.ctg.bed")


def _stub(d, gene):
    exe = d / "fake_nhmmscan"
    exe.write_text(FAKE_NHMMSCAN.replace("gene$i", gene))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    (d / "fake.hmm").write_text("dummy\n")
    return str(exe), str(d / "fake.hmm")


def _both(tmp_path, argv, monkeypatch):
    """Run oatk_tpu's and the port's oatk on argv; returns the two output
    prefixes."""
    from oatk_tpu.cli.oatk import main as j_main
    from oatk_tpu_torch.cli.oatk import main as t_main

    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    pj, pt = str(tmp_path / "jax" / "o.asm"), str(tmp_path / "torch" / "o.asm")
    assert j_main([*argv, "-o", pj]) == 0
    monkeypatch.setattr(TW, "WF_BACKEND", "device")
    monkeypatch.setattr(TEC.read_error_correction, "wf_calls", 0)
    assert t_main([*argv, "--device", "cpu", "-o", pt]) == 0
    return pj, pt


def _same_files(pj, pt, suffixes):
    for suf in suffixes:
        with open(pj + suf, "rb") as f:
            a = f.read()
        with open(pt + suf, "rb") as f:
            b = f.read()
        assert a, suf
        assert a == b, f"{suf} differs"


@pytest.fixture(scope="module")
def genome_reads(tmp_path_factory):
    """20 kbp circular genome at 15x of 3 kbp reads."""
    rng = np.random.default_rng(2020)
    d = tmp_path_factory.mktemp("oatk")
    genome = random_genome(rng, 20000)
    fa = d / "reads.fa"
    write_reads(str(fa), sample_reads(rng, genome, coverage=15, read_len=3000))
    return str(fa)


def test_oatk_ec_on_byte_identical(genome_reads, tmp_path, monkeypatch):
    """Reads -> assembly (EC on, 3 unzip rounds) -> annotation ->
    pathfinder, k=251/s=17/c=3."""
    exe, db = _stub(tmp_path, "nad$i")
    pj, pt = _both(tmp_path, ["-k", "251", "-s", "17", "-c", "3", "-m", db,
                              "--nhmmscan", exe, genome_reads], monkeypatch)
    _same_files(pj, pt, ASM + MITO)
    assert TEC.read_error_correction.wf_calls > 0  # EC ran through wf_ed_core_device
    with open(pt + ".mito.ctg.fasta") as f:
        assert f.read().startswith(">ctg000001")


def test_oatk_input_gfa_byte_identical(genome_reads, tmp_path, monkeypatch):
    """-G on a GFA that oatk_tpu's syncasm wrote."""
    import oatk_tpu.asm.pipeline as J

    pref = str(tmp_path / "asm")
    J.syncasm([genome_reads], k=251, s=17, min_k_cov=3, do_ec=False, do_unzip=0, out=pref)
    exe, db = _stub(tmp_path, "nad$i")
    pj, pt = _both(tmp_path, ["-G", "-m", db, "--nhmmscan", exe, pref + ".utg.final.gfa"],
                   monkeypatch)
    _same_files(pj, pt, MITO)


def test_oatk_minicircle_byte_identical(tmp_path, monkeypatch):
    """-M on rolling-circle reads of a 4 kbp minicircle (the reads of
    test_minicircle.py), k=101/s=13/c=3."""
    rng = np.random.default_rng(12345)
    genome = random_genome(rng, 4000)
    tandem = genome * 4
    reads = []
    for _ in range(60):
        start = int(rng.integers(len(genome)))
        L = int(rng.integers(6000, 11000))
        reads.append((tandem + tandem)[start : start + L])
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    exe, db = _stub(tmp_path, "mini$i")
    pj, pt = _both(tmp_path, ["-k", "101", "-s", "13", "-c", "3", "--no-read-ec",
                              "--unzip-round", "0", "-M", "-m", db, "--nhmmscan", exe,
                              str(fa)], monkeypatch)
    _same_files(pj, pt, ASM + MINI)


@pytest.fixture(scope="module")
def small_gfa(genome_reads, tmp_path_factory):
    import oatk_tpu.asm.pipeline as J

    pref = str(tmp_path_factory.mktemp("gfa") / "asm")
    J.syncasm([genome_reads], k=251, s=17, min_k_cov=3, do_ec=False, do_unzip=0, out=pref)
    return pref + ".utg.final.gfa"


def _cli_pair(name):
    import importlib

    return (importlib.import_module(f"oatk_tpu.cli.{name}").main,
            importlib.import_module(f"oatk_tpu_torch.cli.{name}").main)


def test_hmmannot_cli_byte_identical(small_gfa, tmp_path):
    exe, db = _stub(tmp_path, "nad$i")
    j, t = _cli_pair("hmmannot")
    for who, main in (("jax", j), ("torch", t)):
        assert main([db, small_gfa, "--nhmmscan", exe, "-t", "2", "-b", "5000",
                     "-o", str(tmp_path / f"{who}.txt")]) == 0
    assert (tmp_path / "jax.txt").read_bytes() == (tmp_path / "torch.txt").read_bytes()
    assert (tmp_path / "jax.txt").read_bytes()


def test_pathfinder_cli_byte_identical(small_gfa, tmp_path):
    exe, db = _stub(tmp_path, "nad$i")
    from oatk_tpu.cli.hmmannot import main as annot

    ann = str(tmp_path / "annot.txt")
    assert annot([db, small_gfa, "--nhmmscan", exe, "-o", ann]) == 0
    j, t = _cli_pair("pathfinder")
    for who, main in (("jax", j), ("torch", t)):
        assert main(["-m", ann, "-o", str(tmp_path / who), small_gfa]) == 0
    _same_files(str(tmp_path / "jax"), str(tmp_path / "torch"),
                (".mito.gfa", ".mito.bed", ".mito.ctg.fasta", ".mito.ctg.bed"))


def test_path_to_fasta_cli_byte_identical(small_gfa, tmp_path):
    segs = [ln.split("\t")[1] for ln in open(small_gfa) if ln.startswith("S\t")]
    pstr = ",".join(f"{s}+" for s in segs)
    j, t = _cli_pair("path_to_fasta")
    for flags in ([], ["--linear", "-l", "80", "-n", "10"]):
        outs = []
        for who, main in (("jax", j), ("torch", t)):
            out = tmp_path / f"{who}{len(flags)}.fa"
            assert main([*flags, small_gfa, pstr, "-o", str(out)]) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1] and outs[0].startswith(b">")


def test_rotate_cli_byte_identical(tmp_path):
    rng = np.random.default_rng(31)
    fa = tmp_path / "in.fa"
    with open(fa, "w") as f:
        for i in range(3):
            f.write(f">ctg{i}\n{random_genome(rng, int(rng.integers(500, 3000)))}\n")
    rot = tmp_path / "rot.txt"
    rot.write_text("ctg0 17 -\nctg2 250 +\n")
    j, t = _cli_pair("rotate")
    for flags in ([str(fa), "ctg1", "137"], ["-r", str(fa), "ctg2", "93"],
                  ["-s", str(rot), str(fa)]):
        outs = []
        for who, main in (("jax", j), ("torch", t)):
            out = tmp_path / f"{who}.fa"
            assert main([*flags, "-o", str(out)]) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1] and outs[0].startswith(b">")


def test_oatk_max_data_byte_identical(genome_reads, tmp_path, monkeypatch, capsys):
    """-D through both CLIs: the capped sequential loader keeps the read
    that crosses 200 KiB of raw bases; every output file byte-identical
    to the JAX package's capped loader (Pallas in interpret mode)."""
    monkeypatch.setenv("OATK_TPU_IMPL", "pallas")
    exe, db = _stub(tmp_path, "nad$i")
    pj, pt = _both(tmp_path, ["-k", "251", "-s", "17", "-c", "3", "-D", "200K", "-m", db,
                              "--nhmmscan", exe, genome_reads], monkeypatch)
    assert capsys.readouterr().err.count("data limit (204800) reached") == 2
    _same_files(pj, pt, ASM + MITO)


@pytest.mark.parametrize("flag", [["--shards", "2"]])
def test_oatk_unported_flags_refuse(tmp_path, monkeypatch, flag):
    """--shards is ported; through oatk, a mesh of more cards than are
    visible is refused before any read is loaded."""
    import torch

    from oatk_tpu_torch.cli.oatk import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    exe, db = _stub(tmp_path, "nad$i")
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        main(["-m", db, "--nhmmscan", exe, "--device", "cuda", "-o", str(tmp_path / "x"),
              "in.fa", *flag])
