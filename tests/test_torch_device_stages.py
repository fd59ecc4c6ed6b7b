"""The opt-in device stages of oatk_tpu_torch against the JAX package's,
on the same seeded inputs (device "cpu"):

- ``asm/consensus.py:_runlen_reps_device`` (OATK_TPU_DEVICE_CONSENSUS)
  against ``oatk_tpu``'s: exact (an int64 sum and one elementwise
  rounding);
- ``asm/coverage.py:_em_device_run`` (OATK_TPU_DEVICE_EM) against
  ``oatk_tpu``'s ``lax.while_loop``: coverage within
  ``|dev - ref| <= 1e-12 * max(1, |ref|)`` (relative, except that values
  the loop drives towards 0 are held absolutely: XLA flushes subnormals
  to zero and torch does not), and its iteration count equal to the
  host loop's on the same inputs (the loop stops at 1000); the
  warning text equal to the JAX package's and printed once."""
import numpy as np
import pytest


@pytest.mark.parametrize("m_seq,l", [(1, 1), (3, 40), (57, 1001), (200, 300)])
def test_runlen_reps_device_exact(m_seq, l):
    from oatk_tpu.asm.consensus import _runlen_reps_device as j_reps
    from oatk_tpu_torch.asm.consensus import _runlen_reps_device as t_reps

    rng = np.random.default_rng(m_seq * 7 + l)
    # run-length-minus-one rows as the consensus gathers them (int64;
    # mostly 0, long runs and saturated-overflow values on some rows);
    # two extra rows past m_seq that both must ignore
    rl = rng.geometric(0.6, (m_seq + 2, l)).astype(np.int64) - 1
    rl[rng.random(rl.shape) < 0.01] = 300
    if m_seq > 1:
        rl[:, 0] = np.arange(m_seq + 2) % 2  # ties at .5 round up
    got = t_reps(rl, m_seq, "cpu")
    ref = j_reps(rl, m_seq)
    assert got.dtype == ref.dtype == np.int64
    assert np.array_equal(got, ref)
    assert np.array_equal(got, 1 + np.floor(rl[:m_seq].sum(0) / m_seq + 0.5).astype(np.int64))


def _em_blocks(rng, n_vtx, n_blocks):
    """Multi-alignment blocks as scg_ra_utg_coverage builds them: each
    block lists 1-6 unitigs and a match count; a few unitigs start at
    coverage 0 so that some blocks sum to 0."""
    u, bid = [], []
    for b in range(n_blocks):
        k = int(rng.integers(1, 7))
        u += list(rng.choice(n_vtx, k, replace=False))
        bid += [b] * k
    nm_b = rng.integers(1, 5000, n_blocks).astype(np.float64)
    avg = rng.uniform(0.5, 80.0, n_vtx)
    avg[rng.random(n_vtx) < 0.1] = 0.0
    nlen = rng.integers(1, 60, n_vtx).astype(np.float64)
    return avg, np.asarray(u, np.int64), np.asarray(bid, np.int64), nm_b, nlen


@pytest.mark.parametrize("n_vtx,n_blocks,seed", [(5, 3, 1), (40, 120, 2), (300, 2000, 3)])
def test_em_device_run_matches_jax(n_vtx, n_blocks, seed):
    from oatk_tpu.asm.coverage import _em_device_run as j_em
    from oatk_tpu_torch.asm.coverage import _em_device_run as t_em
    from oatk_tpu_torch.asm.coverage import _em_host_run

    avg, u, bid, nm_b, nlen = _em_blocks(np.random.default_rng(seed), n_vtx, n_blocks)
    ref = j_em(avg.copy(), u, bid, nm_b, nlen, n_vtx)
    got, it = t_em(avg.copy(), u, bid, nm_b, nlen, n_vtx, "cpu")
    host = avg.copy()
    it_host = _em_host_run(host, u, bid, nm_b, nlen, n_vtx)
    assert got.dtype == np.float64 and got.shape == ref.shape
    for other in (ref, host):
        assert (np.abs(got - other) <= 1e-12 * np.maximum(1.0, np.abs(other))).all()
    assert 1 < it == it_host


def test_device_em_warns_once(monkeypatch, capsys):
    from oatk_tpu.asm import coverage as JC
    from oatk_tpu_torch.asm import coverage as TC

    monkeypatch.setattr(JC, "_device_em_warned", False)
    monkeypatch.setattr(TC, "_device_em_warned", False)
    JC._warn_device_em_once()
    ref = capsys.readouterr().err
    TC._warn_device_em_once()
    TC._warn_device_em_once()
    got = capsys.readouterr().err
    assert "OATK_TPU_DEVICE_EM is experimental" in ref
    assert got == ref
