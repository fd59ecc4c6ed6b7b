"""The banded wavefront core of oatk_tpu_torch (``kernels/wf_ed.py``):
the plain PyTorch version, through the port's single-state entry on the
CPU, against the JAX package's Pallas kernel in interpret mode on short
cases, and against the JAX package's host core (the ``wf_step`` loop the
Pallas kernel is equivalence-tested against) on long cases, which the
Pallas single-state entry refuses (tl or ql above 512).  Tolerance:
exact (integer state: score, ends and the full (wd, wk) wavefront).

The CUDA kernel runs only on a card: the ``cuda``-marked tests compare
it with the plain version there and skip elsewhere."""
import numpy as np
import pytest
import torch

import oatk_tpu_torch.kernels.wavefront as TW
from oatk_tpu_torch.kernels import wf_ed as WE


def _state(mod, ts, qs, is_ext, bw, device="cpu"):
    st = mod.WfState()
    st.reset(ts)
    st.qs = qs
    st.is_ext = is_ext
    st.bw = bw
    if device != "cpu":
        st.device = device
    return st


def _host_core(st, W=None):
    """The JAX package's host core (or the port's copy of it, ``W=TW``,
    where JAX is absent): wf_step until an end or the band."""
    if W is None:
        import oatk_tpu.kernels.wavefront as W

    t = q = -1
    while True:
        if W.wf_step(st) < 0:
            t, q = st.t_end, st.q_end
            break
        st.score += 1
        if st.bw >= 0 and st.score > st.bw:
            break
    st.t_end = t + 1
    st.q_end = q + 1


def _same(a, b):
    assert (a.score, a.t_end, a.q_end) == (b.score, b.t_end, b.q_end)
    assert np.array_equal(a.wd, b.wd) and np.array_equal(a.wk, b.wk)


def _short_pair(rng):
    """tl, ql < 120: random, or the query a copy of the target mutated at
    about 5% (the case mix of tests/test_wavefront.py)."""
    tl = int(rng.integers(1, 120))
    ql = int(rng.integers(1, 120))
    ts = rng.integers(0, 4, tl).astype(np.uint8)
    qs = rng.integers(0, 4, ql).astype(np.uint8)
    if rng.random() < 0.5:
        qs = ts.copy()[:ql] if ql <= tl else np.concatenate(
            [ts, rng.integers(0, 4, ql - tl).astype(np.uint8)])
        for p in rng.integers(0, len(qs), max(1, len(qs) // 20)):
            qs[p] = (qs[p] + 1) % 4
    return ts, qs


@pytest.mark.parametrize("bw", [-1, 3, 6, 10])
@pytest.mark.parametrize("is_ext", [False, True])
def test_plain_matches_pallas_short(is_ext, bw):
    from oatk_tpu.kernels import wavefront as W
    from oatk_tpu.kernels.wavefront_pallas import wf_ed_core_pallas

    rng = np.random.default_rng(100 + 10 * int(is_ext) + bw)
    for _ in range(12):
        ts, qs = _short_pair(rng)
        a = _state(W, ts, qs, is_ext, bw)
        b = _state(TW, ts, qs, is_ext, bw)
        assert wf_ed_core_pallas(a, interpret=True)
        WE.wf_ed_core_device(b)
        _same(a, b)


def test_plain_matches_pallas_stepwise_restart():
    """A growing query, restarting from the returned state (the EC DFS
    access pattern)."""
    from oatk_tpu.kernels import wavefront as W
    from oatk_tpu.kernels.wavefront_pallas import wf_ed_core_pallas

    rng = np.random.default_rng(7)
    for _ in range(20):
        tl = int(rng.integers(20, 110))
        ts = rng.integers(0, 4, tl).astype(np.uint8)
        full = ts.copy()
        for p in rng.integers(0, tl, 3):
            full[p] = (full[p] + 1) % 4
        a = _state(W, ts, full[:0], True, 8)
        b = _state(TW, ts, full[:0], True, 8)
        cut = int(rng.integers(5, tl))
        for piece in (full[:cut], full):
            a.qs = piece
            b.qs = piece
            assert wf_ed_core_pallas(a, interpret=True)
            WE.wf_ed_core_device(b)
            _same(a, b)


def _batch_inputs(rng, B, TL, QL, D_cap, max_len=100):
    ts = np.zeros((B, TL), np.uint8)
    qs = np.zeros((B, QL), np.uint8)
    meta = np.zeros((B, 8), np.int32)
    k = np.full((B, D_cap), -WE.BIG, np.int32)
    for b in range(B):
        tl = int(rng.integers(10, max_len))
        ql = int(np.clip(tl + rng.integers(-20, 21), 10, min(QL, max_len)))
        ts[b, :tl] = rng.integers(0, 4, tl)
        m = min(tl, ql)
        qs[b, :m] = ts[b, :m]
        qs[b, m:ql] = rng.integers(0, 4, ql - m)
        qs[b, rng.integers(0, ql, 3)] = rng.integers(0, 4, 3)
        meta[b, :7] = (tl, ql, int(rng.integers(2)), int(rng.choice([-1, 5, 9])), 0, 0, 1)
        k[b, 0] = -1
    return ts, qs, meta, k


def test_plain_batch_matches_pallas_batch():
    """B=6 alignments in one call, as test_pallas_batched runs them."""
    import jax.numpy as jnp

    from oatk_tpu.kernels.wavefront_pallas import wf_ed_core_pallas_batch

    rng = np.random.default_rng(6)
    B, TL, QL = 6, 128, 128
    D_cap = TL + QL + 4
    ts, qs, meta, k = _batch_inputs(rng, B, TL, QL, D_cap)
    om_j, ok_j = wf_ed_core_pallas_batch(
        jnp.asarray(ts), jnp.asarray(qs), jnp.asarray(meta), jnp.asarray(k),
        TL=TL, QL=QL, D_cap=D_cap, interpret=True,
    )
    om_j, ok_j = np.asarray(om_j), np.asarray(ok_j)
    om_t, ok_t = WE.wf_ed_core_batch_plain(*(torch.from_numpy(x) for x in (ts, qs, meta, k)))
    om_t, ok_t = om_t.numpy(), ok_t.numpy()
    # columns 0-5 are the Pallas contract; 6 (err) is 0 on both
    assert np.array_equal(om_t[:, :6], om_j[:, :6]) and not om_t[:, 6:].any()
    for b in range(B):
        n = om_t[b, 2]
        assert np.array_equal(ok_t[b, :n], ok_j[b, :n])
        assert (ok_t[b, n:] == -WE.BIG).all()


def _long_case(rng, tl, ql, mut, indel=False):
    ts = rng.integers(0, 4, tl).astype(np.uint8)
    q = list(ts[: min(tl, ql)])
    for p in sorted(rng.choice(len(q), max(1, int(len(q) * mut)), replace=False), reverse=True):
        r = rng.random() if indel else 0.0
        if r < 0.6:
            q[p] = (q[p] + 1) % 4
        elif r < 0.8:
            del q[p]
        else:
            q.insert(p, int(rng.integers(4)))
    while len(q) < ql:
        q.append(int(rng.integers(4)))
    return ts, np.asarray(q[:ql], np.uint8)


# (tl, ql, mutation rate, indels): up to tl 6,000 / ql 6,600 at EC's
# k=1001 block lengths; the last has ql > tl + bw, so max_d = max(bw, ql)
# (the reference's quirk) decides the right trim
LONG = [
    (738, 970, 0.01, True),
    (2500, 2400, 0.005, True),
    (5669, 6542, 0.001, False),
    (6000, 6600, 0.01, True),
    (3000, 3400, 0.003, True),
]


@pytest.mark.parametrize("tl,ql,mut,indel", LONG)
def test_plain_matches_host_core_long(tl, ql, mut, indel):
    from oatk_tpu.kernels import wavefront as W

    rng = np.random.default_rng(tl + ql)
    ts, qs = _long_case(rng, tl, ql, mut, indel)
    bw = max(int(np.ceil(tl * 0.02)), 6)  # EC's band (asm/ec.py)
    for is_ext in (True, False):
        a = _state(W, ts, qs, is_ext, bw)
        b = _state(TW, ts, qs, is_ext, bw)
        _host_core(a)
        WE.wf_ed_core_device(b)
        _same(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_host_core_restart(seed):
    """Restart from states with many diagonals: the query grows in
    pieces of up to 400 bases, the errors dense enough (2% with indels)
    that the wave reaches about 200 diagonals before a restart."""
    from oatk_tpu.kernels import wavefront as W

    rng = np.random.default_rng(50 + seed)
    tl = int(rng.integers(3000, 6000))
    ts, full = _long_case(rng, tl, tl + 300, 0.02, True)
    bw = max(int(np.ceil(tl * 0.02)), 6)
    a = _state(W, ts, full[:0], True, bw)
    b = _state(TW, ts, full[:0], True, bw)
    pos, n_max = 0, 0
    while pos < len(full) and a.score <= bw:
        pos = min(len(full), pos + int(rng.integers(50, 400)))
        a.qs = full[:pos]
        b.qs = full[:pos]
        n_max = max(n_max, len(a.wk))
        _host_core(a)
        WE.wf_ed_core_device(b)
        _same(a, b)
    assert n_max >= 100


def test_quirk_case_trims_right_at_ql():
    """ql > tl + bw with is_ext: the reference keeps diagonals up to
    max(bw, ql) = ql, not bw; the state after the band must hold a
    diagonal above bw."""
    from oatk_tpu.kernels import wavefront as W

    rng = np.random.default_rng(11)
    ts, qs = _long_case(rng, 400, 700, 0.05, True)
    a = _state(W, ts, qs, True, 8)
    b = _state(TW, ts, qs, True, 8)
    _host_core(a)
    WE.wf_ed_core_device(b)
    _same(a, b)
    assert b.wd.max() > 8


def test_device_backend_drives_wf_ed_core(monkeypatch):
    """OATK_TPU_WF_BACKEND=device (and its JAX spelling, pallas) sends
    wf_ed_core to wf_ed_core_device; a traceback state stays on the host
    core; on the CPU no kernel launches."""
    from oatk_tpu.kernels import wavefront as W

    calls = []
    real = WE.wf_ed_core_device
    monkeypatch.setattr(WE, "wf_ed_core_device", lambda st: (calls.append(1), real(st)))
    rng = np.random.default_rng(3)
    before = WE.wf_ed_core_batch.launches
    for backend in ("device", "pallas"):
        monkeypatch.setattr(TW, "WF_BACKEND", backend)
        ts, qs = _long_case(rng, 900, 950, 0.01, True)
        a = _state(W, ts, qs, True, 18)
        b = _state(TW, ts, qs, True, 18)
        _host_core(a)
        TW.wf_ed_core(b)
        _same(a, b)
        c = _state(TW, ts, qs, True, 18)
        c.tb = []
        TW.wf_ed_core(c)
        assert (c.score, c.t_end, c.q_end) == (a.score, a.t_end, a.q_end)
    assert len(calls) == 2
    assert WE.wf_ed_core_batch.launches == before


def test_wrapper_takes_plain_only_on_cpu():
    rng = np.random.default_rng(4)
    x = [torch.from_numpy(v) for v in _batch_inputs(rng, 3, 64, 64, 140, max_len=60)]
    before = WE.wf_ed_core_batch.launches
    om, ok = WE.wf_ed_core_batch(*x)
    om2, ok2 = WE.wf_ed_core_batch_plain(*x)
    assert torch.equal(om, om2) and torch.equal(ok, ok2)
    assert WE.wf_ed_core_batch.launches == before
    # a non-CPU, non-CUDA tensor is refused, never computed by the plain path
    with pytest.raises(ValueError):
        WE.wf_ed_core_batch(*(t.to("meta") for t in x))


def test_argument_checks_and_err_flag():
    ts = torch.zeros((2, 16), dtype=torch.uint8)
    meta = torch.zeros((2, 8), dtype=torch.int32)
    k = torch.full((2, 40), -WE.BIG, dtype=torch.int32)
    with pytest.raises(TypeError):
        WE.wf_ed_core_batch(ts, ts, meta, k.long())
    with pytest.raises(ValueError):
        WE.wf_ed_core_batch(ts, ts[:1], meta, k)
    # n above D_cap and tl above TL: err 1, out_k all -BIG, on both rows
    meta[0, :7] = torch.tensor([4, 4, 1, -1, 0, 0, 41])
    meta[1, :7] = torch.tensor([17, 4, 1, -1, 0, 0, 1])
    om, ok = WE.wf_ed_core_batch_plain(ts, ts, meta, k)
    assert om[:, 6].tolist() == [1, 1] and (ok == -WE.BIG).all()


def test_cuda_state_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(WE, "_bufs", {})
    st = _state(TW, np.zeros(20, np.uint8), np.zeros(20, np.uint8), True, 6, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WE.wf_ed_core_device(st)


def _mixed_round(rng):
    """One round as EC's lockstep scheduler hands it over, and more: fresh
    banded and unbanded states of very different lengths (tl 5 to 400),
    and restarts from the host core's state after a prefix of the query,
    with waves of up to ~60 diagonals.  Needs no JAX (the card's tests
    use it too)."""
    states = []
    for tl, ql, is_ext, bw in [(5, 7, True, 6), (400, 380, True, 8), (40, 120, False, -1),
                               (250, 260, False, 6), (120, 60, True, -1), (300, 330, True, 12),
                               (17, 16, False, 3)]:
        ts, qs = _long_case(rng, tl, ql, 0.03, True)
        states.append(_state(TW, ts, qs, is_ext, bw))
    for tl, bw, mut in [(300, -1, 0.2), (350, 40, 0.1), (200, 30, 0.15), (150, -1, 0.25)]:
        ts, full = _long_case(rng, tl, tl + 20, mut, True)
        st = _state(TW, ts, full[: tl // 2], True, bw)
        _host_core(st, TW)
        st.qs = full
        states.append(st)
    return states


def _plain_round(states, force_global):
    lay = WE.round_layout(states, 48 * 1024, force_global)
    h = np.zeros(lay.in_words, np.int32)
    WE.pack_round(h, lay, states)
    inp = torch.from_numpy(h)
    out = torch.zeros(lay.out_words, dtype=torch.int32)
    WE.wf_ed_core_ragged(inp, out, len(states), lay.smem)
    return lay, inp, out


def test_ragged_plain_matches_pallas_batch():
    """One mixed ragged round through the wrapper on the CPU (the ragged
    plain version; one item named for the global route) against the JAX
    package's padded Pallas kernel (interpret mode): exact over
    out_meta's six contract columns and out_k[:n]."""
    import jax.numpy as jnp

    from oatk_tpu.kernels.wavefront_pallas import wf_ed_core_pallas_batch

    rng = np.random.default_rng(31)
    states = _mixed_round(rng)
    B = len(states)
    glob = np.zeros(B, bool)
    glob[1] = True
    before = WE.wf_ed_core_batch.launches
    lay, _inp, out = _plain_round(states, glob)
    assert WE.wf_ed_core_batch.launches == before  # the plain version is no launch
    assert (lay.desc[:, 6] >= 0).tolist() == glob.tolist()
    assert max(len(s.wk) for s in states) >= 50

    TL = -(-(max(len(s.ts) for s in states) + 1) // 128) * 128
    QL = -(-(max(len(s.qs) for s in states) + 1) // 128) * 128
    D_cap = TL + QL + 4
    ts = np.zeros((B, TL), np.uint8)
    qs = np.zeros((B, QL), np.uint8)
    meta = np.zeros((B, 8), np.int32)
    k = np.full((B, D_cap), -WE.BIG, np.int32)
    for b, st in enumerate(states):
        ts[b, : len(st.ts)] = st.ts
        qs[b, : len(st.qs)] = st.qs
        meta[b] = lay.meta[b]
        k[b, : len(st.wk)] = st.wk
    om_j, ok_j = wf_ed_core_pallas_batch(
        jnp.asarray(ts), jnp.asarray(qs), jnp.asarray(meta), jnp.asarray(k),
        TL=TL, QL=QL, D_cap=D_cap, interpret=True,
    )
    om_j, ok_j = np.asarray(om_j), np.asarray(ok_j)
    o = out.numpy()
    for b in range(B):
        om = o[lay.desc[b, 4] : lay.desc[b, 4] + 8]
        n = om[2]
        assert np.array_equal(om[:6], om_j[b, :6]) and om[6] == 0, b
        ok = o[lay.desc[b, 5] : lay.desc[b, 5] + lay.desc[b, 7]]
        assert np.array_equal(ok[:n], ok_j[b, :n]) and (ok[n:] == -WE.BIG).all(), b
    assert om_j[:, 3].any() and not om_j[:, 3].all()  # hits and band exits both occur


def test_rounds_match_single_calls():
    """wf_ed_core_rounds advances every state of a round as one
    wf_ed_core_device call per state does, and counts one round."""
    rng = np.random.default_rng(32)
    a = _mixed_round(rng)
    b = [_state(TW, s.ts, s.qs, s.is_ext, s.bw) for s in a]
    for x, y in zip(a, b):
        y.score, y.t_end, y.q_end, y.wd, y.wk = x.score, x.t_end, x.q_end, x.wd.copy(), x.wk.copy()
    before = WE.wf_ed_core_rounds.rounds
    WE.wf_ed_core_rounds(a, "cpu")
    assert WE.wf_ed_core_rounds.rounds == before + 1
    for x, y in zip(a, b):
        WE.wf_ed_core_device(y)
        _same(x, y)


def test_slot_width_holds_every_wave():
    """The ragged slot S = min(d_cap, n + 2 max(1, bw - score + 1)) is
    never outgrown: a round whose every width is S reports no err, and S
    matches d_cap_for where unbanded."""
    rng = np.random.default_rng(33)
    states = _mixed_round(rng)
    lay, _inp, out = _plain_round(states, False)
    o = out.numpy()
    assert not o[lay.desc[:, 4] + 6].any()
    for st, S in zip(states, lay.desc[:, 7]):
        d = WE.d_cap_for(len(st.ts), len(st.qs), len(st.wk), st.bw, st.is_ext)
        assert S == (d if st.bw < 0 else min(d, len(st.wk) + 2 * max(1, st.bw - st.score + 1)))


def test_d_cap_bounds_every_wave():
    """d_cap_for holds the widest band: unbanded, a wave spans [-tl, ql]."""
    assert WE.d_cap_for(100, 200, 1, -1, True) >= 100 + 200 + 1
    assert WE.d_cap_for(100, 10, 1, 50, False) >= 100 + (90 + 50) + 1
    assert WE.d_cap_for(10, 10, 500, 3, True) >= 500


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("force_global", [False, True])
def test_cuda_kernel_matches_plain_batch(force_global):
    _cuda()
    rng = np.random.default_rng(21)
    B, TL, QL = 16, 6016, 6656
    D_cap = WE.d_cap_for(TL, QL, 1, 200, False)
    ts, qs, meta, k = _batch_inputs(rng, B, TL, QL, D_cap, max_len=5000)
    x = [torch.from_numpy(v).cuda() for v in (ts, qs, meta, k)]
    before = WE.wf_ed_core_batch.launches
    om, ok = WE.wf_ed_core_batch(*x, force_global=force_global)
    torch.cuda.synchronize()
    assert WE.wf_ed_core_batch.launches == before + 1
    om2, ok2 = WE.wf_ed_core_batch_plain(*x)
    assert torch.equal(om, om2) and torch.equal(ok, ok2)


@pytest.mark.cuda
@pytest.mark.parametrize("tl,ql,mut,indel", LONG)
def test_cuda_device_call_matches_cpu(tl, ql, mut, indel):
    """wf_ed_core_device on the card against the same call on the CPU
    (the plain version), from a fresh state and after a restart."""
    _cuda()
    rng = np.random.default_rng(tl * 3 + ql)
    ts, qs = _long_case(rng, tl, ql, mut, indel)
    bw = max(int(np.ceil(tl * 0.02)), 6)
    for is_ext in (True, False):
        a = _state(TW, ts, qs[: ql // 2], is_ext, bw, device="cuda")
        b = _state(TW, ts, qs[: ql // 2], is_ext, bw)
        for piece in (qs[: ql // 2], qs):
            a.qs = piece
            b.qs = piece
            before = WE.wf_ed_core_batch.launches
            WE.wf_ed_core_device(a)
            assert WE.wf_ed_core_batch.launches == before + 1
            WE.wf_ed_core_device(b)
            _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [128, 256])
@pytest.mark.parametrize("route", ["shared", "global", "mixed"])
def test_cuda_ragged_round_matches_plain(route, threads, monkeypatch):
    """One ragged round on the card against the ragged plain version on
    the same card buffer, exactly over the whole output, on each route
    and block width; and the round driver on the card against the CPU."""
    _cuda()
    monkeypatch.setattr(WE, "THREADS", threads)
    rng = np.random.default_rng(41)
    states = _mixed_round(rng)
    for tl, ql, mut, indel in LONG[:3]:
        ts, qs = _long_case(rng, tl, ql, mut, indel)
        states.append(_state(TW, ts, qs, True, max(int(np.ceil(tl * 0.02)), 6)))
    B = len(states)
    glob = {"shared": False, "global": True, "mixed": np.arange(B) % 2 == 1}[route]
    lim = WE._smem_limit_of(WE._load(), torch.device("cuda", torch.cuda.current_device()))
    lay = WE.round_layout(states, lim, glob)
    h = np.zeros(lay.in_words, np.int32)
    WE.pack_round(h, lay, states)
    inp = torch.from_numpy(h).cuda()
    out = torch.zeros(lay.out_words, dtype=torch.int32, device="cuda")
    scratch = torch.empty(max(1, lay.scratch_words), dtype=torch.int32, device="cuda")
    before = (WE.wf_ed_core_batch.launches, WE.wf_ed_core_batch.items)
    WE.wf_ed_core_ragged(inp, out, B, lay.smem, scratch)
    torch.cuda.synchronize()
    assert (WE.wf_ed_core_batch.launches, WE.wf_ed_core_batch.items) == (before[0] + 1, before[1] + B)
    out2 = WE.wf_ed_core_ragged_plain(inp, torch.zeros_like(out), B)
    assert torch.equal(out, out2)

    cpu = [_state(TW, s.ts, s.qs, s.is_ext, s.bw) for s in states]
    card = [_state(TW, s.ts, s.qs, s.is_ext, s.bw, device="cuda") for s in states]
    for x, y, z in zip(states, cpu, card):
        for t in (y, z):
            t.score, t.t_end, t.q_end, t.wd, t.wk = x.score, x.t_end, x.q_end, x.wd.copy(), x.wk.copy()
    WE.wf_ed_core_rounds(cpu, "cpu")
    WE.wf_ed_core_rounds(card, "cuda")
    for y, z in zip(cpu, card):
        _same(y, z)
