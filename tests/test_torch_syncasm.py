"""Whole slice: oatk_tpu_torch syncasm (device "cpu", the kernels' plain
versions) against oatk_tpu syncasm (Pallas interpret mode, device
counting: OATK_TPU_IMPL=pallas OATK_TPU_COUNT=device) on the same
1.2 Mbp read set.  Tolerance: byte-identical .utg.gfa and
.utg.final.gfa."""
import numpy as np
import pytest

from genome_sim import random_genome, sample_reads, write_reads

K, S, C = 151, 13, 3


@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    """a(20 kbp) + rep(1.5 kbp) + b(16 kbp) + rep at 30x of 4 kbp reads
    (about 1.2 Mbp; assembles to a 3-segment graph)."""
    rng = np.random.default_rng(7)
    a = random_genome(rng, 20_000)
    rep = random_genome(rng, 1_500)
    b = random_genome(rng, 16_000)
    reads = sample_reads(rng, a + rep + b + rep, coverage=30, read_len=4000,
                         err_rate=0.002, hp_frac=0.85)
    path = tmp_path_factory.mktemp("syncasm") / "reads.fa"
    write_reads(str(path), reads)
    return str(path)


@pytest.mark.parametrize("do_ec,unzip", [(True, 3), (False, 0)], ids=["ec-unzip3", "noec-unzip0"])
def test_gfa_byte_identical(reads_fa, tmp_path, monkeypatch, do_ec, unzip):
    import oatk_tpu.asm.pipeline as J
    import oatk_tpu_torch.asm.pipeline as T

    monkeypatch.setenv("OATK_TPU_IMPL", "pallas")
    monkeypatch.setenv("OATK_TPU_COUNT", "device")
    oj, ot = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj = J.syncasm([reads_fa], k=K, s=S, min_k_cov=C, do_ec=do_ec, do_unzip=unzip, out=oj)
    rt = T.syncasm([reads_fa], k=K, s=S, min_k_cov=C, do_ec=do_ec, do_unzip=unzip,
                   out=ot, device="cpu")
    assert rj.scg is not None and rt.scg is not None
    for suf in (".utg.gfa", ".utg.final.gfa"):
        with open(oj + suf, "rb") as f:
            a = f.read()
        with open(ot + suf, "rb") as f:
            b = f.read()
        assert a.count(b"\nS\t") >= 1
        assert a == b, suf


def test_cuda_without_card_raises(reads_fa, tmp_path, monkeypatch):
    """--device cuda never falls back to the CPU."""
    import torch

    from oatk_tpu_torch.cli.syncasm import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([reads_fa, "-k", str(K), "-s", str(S), "-o", str(tmp_path / "x")])


def _same_gfas(oj, ot):
    for suf in (".utg.gfa", ".utg.final.gfa"):
        with open(oj + suf, "rb") as f:
            a = f.read()
        with open(ot + suf, "rb") as f:
            b = f.read()
        assert a.count(b"\nS\t") >= 1
        assert a == b, suf


def test_unported_cli_flags_refuse(reads_fa, tmp_path, monkeypatch):
    """--shards is ported; a mesh of more cards than are visible is
    refused before any read is loaded (no silent fallback to fewer
    cards or to the CPU)."""
    import torch

    from oatk_tpu_torch.cli.syncasm import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        main([reads_fa, "-k", str(K), "-s", str(S), "--device", "cuda",
              "-o", str(tmp_path / "x"), "--shards", "2"])


@pytest.mark.parametrize("flag", [["--cpu"], ["-D", "500K"]], ids=["--cpu", "-D"])
def test_cli_flag_gfa_byte_identical(reads_fa, tmp_path, monkeypatch, capsys, flag):
    """--cpu (host oracle extraction) and -D (the capped sequential
    loader, host counting) through both CLIs: GFAs byte-identical."""
    from oatk_tpu.cli.syncasm import main as j_main
    from oatk_tpu_torch.cli.syncasm import main as t_main

    monkeypatch.setenv("OATK_TPU_IMPL", "pallas")
    oj, ot = str(tmp_path / "jax"), str(tmp_path / "torch")
    common = [reads_fa, "-k", str(K), "-s", str(S), "-c", str(C), *flag]
    assert j_main([*common, "-o", oj]) == 0
    capsys.readouterr()
    assert t_main([*common, "--device", "cpu", "-o", ot]) == 0
    err = capsys.readouterr().err
    assert ("data limit (512000) reached" in err) == (flag[0] == "-D")
    _same_gfas(oj, ot)


@pytest.mark.parametrize(
    "env", ["OATK_TPU_DEVICE_CONSENSUS", "OATK_TPU_DEVICE_EM", "OATK_TPU_DEVICE_HOCO"]
)
def test_device_knob_gfa_byte_identical(reads_fa, tmp_path, monkeypatch, capsys, env):
    """The opt-in device stages against the JAX package with the same
    knob.  DEVICE_CONSENSUS is integer-exact and DEVICE_HOCO moves only
    where the hoco phase runs, so their GFAs must be byte-identical.
    DEVICE_EM sums in float64 with index_add_; on the CPU that is
    sequential, as JAX's segment_sum is there, so its GFAs are held
    byte-identical too (the card's atomics are held to 1e-9 by
    chip_smoke.py instead).  Each run goes through its device route."""
    import oatk_tpu.asm.pipeline as J
    import oatk_tpu_torch.asm.pipeline as T
    from oatk_tpu.asm import coverage as JC
    from oatk_tpu_torch.asm import consensus as TCS
    from oatk_tpu_torch.asm import coverage as TC
    from oatk_tpu_torch.asm import reads as TR

    monkeypatch.setenv("OATK_TPU_IMPL", "pallas")
    monkeypatch.setenv("OATK_TPU_COUNT", "device")
    monkeypatch.setenv(env, "1")
    monkeypatch.setattr(JC, "_device_em_warned", False)
    monkeypatch.setattr(TC, "_device_em_warned", False)
    monkeypatch.setattr(TC._em_device_run, "calls", 0)
    monkeypatch.setattr(TCS._runlen_reps_device, "calls", 0)
    hoco_calls = []
    real_hoco = TR._extract_device_hoco
    monkeypatch.setattr(TR, "_extract_device_hoco",
                        lambda *a: hoco_calls.append(1) or real_hoco(*a))
    oj, ot = str(tmp_path / "jax"), str(tmp_path / "torch")
    J.syncasm([reads_fa], k=K, s=S, min_k_cov=C, do_ec=True, do_unzip=3, out=oj)
    capsys.readouterr()
    T.syncasm([reads_fa], k=K, s=S, min_k_cov=C, do_ec=True, do_unzip=3, out=ot,
              device="cpu")
    err = capsys.readouterr().err
    if env == "OATK_TPU_DEVICE_EM":
        assert TC._em_device_run.calls > 0
        assert err.count("OATK_TPU_DEVICE_EM is experimental") == 1
    elif env == "OATK_TPU_DEVICE_CONSENSUS":
        assert TCS._runlen_reps_device.calls > 0
    else:
        assert hoco_calls == [1]
    _same_gfas(oj, ot)


def test_mixed_format_gfa_byte_identical(reads_fa, tmp_path, monkeypatch):
    """A FASTA file with every other record written as FASTQ: the native
    parser rejects it in both packages and both take the Python reader;
    GFAs byte-identical."""
    import oatk_tpu.asm.pipeline as J
    import oatk_tpu_torch.asm.pipeline as T

    mixed = tmp_path / "mixed.fa"
    lines = open(reads_fa).read().split("\n")
    with open(mixed, "w") as f:
        for i in range(0, len(lines) - 1, 2):
            name, seq = lines[i][1:], lines[i + 1]
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n" if i % 4 else f">{name}\n{seq}\n")
    calls = []
    real = T.extract_all_syncmers
    monkeypatch.setattr(T, "extract_all_syncmers", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("OATK_TPU_IMPL", "pallas")
    oj, ot = str(tmp_path / "jax"), str(tmp_path / "torch")
    J.syncasm([str(mixed)], k=K, s=S, min_k_cov=C, do_ec=True, do_unzip=3, out=oj)
    T.syncasm([str(mixed)], k=K, s=S, min_k_cov=C, do_ec=True, do_unzip=3, out=ot,
              device="cpu")
    assert calls == [1]
    _same_gfas(oj, ot)
