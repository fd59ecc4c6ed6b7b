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


@pytest.mark.parametrize("flag", [["--cpu"], ["--shards", "2"], ["-D", "1M"]])
def test_unported_cli_flags_refuse(reads_fa, tmp_path, flag):
    from oatk_tpu_torch.cli.syncasm import main

    with pytest.raises(NotImplementedError):
        main([reads_fa, "-k", str(K), "-s", str(S), "--device", "cpu",
              "-o", str(tmp_path / "x"), *flag])


@pytest.mark.parametrize(
    "env", ["OATK_TPU_DEVICE_CONSENSUS", "OATK_TPU_DEVICE_EM"]
)
def test_unported_device_knobs_refuse(reads_fa, tmp_path, monkeypatch, env):
    import oatk_tpu_torch.asm.pipeline as T

    monkeypatch.setenv(env, "1")
    with pytest.raises(NotImplementedError):
        T.syncasm([reads_fa], k=K, s=S, min_k_cov=C, do_ec=False, do_unzip=0,
                  out=str(tmp_path / "x"), device="cpu")
