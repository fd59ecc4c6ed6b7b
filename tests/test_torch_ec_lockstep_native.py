"""Error correction's device wavefront backend with its DFS in C
(``csrc/ec_lockstep.c`` through ``asm/ec_lockstep.py`` and
``kernels/wf_ed.py:wf_ed_lockstep``), on the CPU, where each round runs
the kernel's plain version, on the 1.2 Mbp set of
``test_torch_ec_device.py`` (k=151, s=13).

Round for round the C driver gives the Python lockstep's rounds: the
same items in the same order and the same input words as
``round_layout`` + ``pack_round`` write them (into a zeroed buffer: the
C driver zeroes every padding byte), at EC_INFLIGHT 1, 7 and every read,
on either kernel route, from either vertex-sequence source and at any
thread count.  Its corrected reads, stats and extensions equal the
Python lockstep's and the JAX package's Pallas-backend EC (interpret
mode).  An item's ``err`` raises ``unpack_round``'s message; the routes
of ``read_error_correction`` are held.  The ``cuda`` cases run the C
driver's rounds on the card against the CPU run.  Tolerance: exact."""
import functools

import numpy as np
import pytest
import torch

import oatk_tpu_torch.kernels.wavefront as TW
import oatk_tpu_torch.native as native
from oatk_tpu_torch.asm import ec as TEC
from oatk_tpu_torch.asm import ec_lockstep as ECL
from oatk_tpu_torch.asm.consensus import ensure_vtx_seq
from oatk_tpu_torch.kernels import wf_ed as WE
from test_torch_ec_device import _port_ec, count_plain, ec_references, reads_1p2mbp  # noqa: F401

NO_LIMIT = WE._I32_MAX
# about the median item's shared-memory need on this set (160-1040 B):
# roughly half of the items take the global route
SMALL_SMEM = 368
INFLIGHT = [pytest.param(1, id="1"), pytest.param(7, id="7"), pytest.param(None, id="all")]


@pytest.fixture
def device_backend(monkeypatch):
    monkeypatch.setattr(TW, "WF_BACKEND", "device")
    monkeypatch.setattr(TEC.read_error_correction, "wf_calls", 0)
    monkeypatch.setattr(WE.wf_ed_core_rounds, "rounds", 0)


def _record_python(monkeypatch, settings=((NO_LIMIT, False),)):
    """Record, per round of the Python lockstep, the input words that
    ``round_layout(states, limit, force_global)`` + ``pack_round`` give
    for each setting, into a zeroed buffer."""
    got = {s: [] for s in settings}
    real = WE.wf_ed_core_rounds

    def rec(states, device=None):
        for lim, fg in settings:
            lay = WE.round_layout(states, lim, fg)
            h = np.zeros(lay.in_words, np.int32)
            WE.pack_round(h, lay, states)
            got[(lim, fg)].append(h.tobytes())
        return real(states, device)

    rec.rounds = 0  # the real function counts its rounds on its stand-in
    monkeypatch.setattr(WE, "wf_ed_core_rounds", rec)
    return got


def _record_launches(monkeypatch):
    """Record each ragged round's input words as the plain version gets them."""
    got = []
    real = WE.wf_ed_core_ragged_plain

    def rec(inp, out, B):
        got.append(inp.numpy().tobytes())
        return real(inp, out, B)

    monkeypatch.setattr(WE, "wf_ed_core_ragged_plain", rec)
    return got


def _c_route(monkeypatch, smem_limit=None, force_global=False):
    """Set the C driver's kernel routes for the EC runs that follow."""
    if smem_limit is not None or force_global:
        monkeypatch.setattr(TEC, "_correct_reads_lockstep_native", functools.partial(
            TEC._correct_reads_lockstep_native, smem_limit=smem_limit, force_global=force_global))


def _python_run(fa, monkeypatch, settings=((NO_LIMIT, False),)):
    """The Python lockstep's rounds (per setting), reads, stats, calls."""
    with monkeypatch.context() as mp:
        got = _record_python(mp, settings)
        monkeypatch.setattr(TEC.read_error_correction, "wf_calls", 0)
        reads, stats = _port_ec(fa, "python")
    return got, reads, stats, TEC.read_error_correction.wf_calls


def _c_run(fa, monkeypatch, **route):
    """The C driver's rounds, reads, stats, calls and split."""
    with monkeypatch.context() as mp:
        got = _record_launches(mp)
        _c_route(mp, **route)
        monkeypatch.setattr(TEC.read_error_correction, "wf_calls", 0)
        reads, stats = _port_ec(fa)
    return got, reads, stats, TEC.read_error_correction.wf_calls, WE.wf_ed_lockstep.last


def _same_reads(a, b) -> bool:
    return len(a) == len(b) > 0 and all(
        np.array_equal(k1, k2) and np.array_equal(m1, m2) for (k1, m1), (k2, m2) in zip(a, b))


@pytest.mark.parametrize("inflight", INFLIGHT)
def test_rounds_byte_identical_to_python_lockstep(reads_1p2mbp, ec_references, monkeypatch,
                                                  device_backend, count_plain, inflight):
    """Every round of the C driver has the Python lockstep's B and input
    words; the corrected reads, the 11 stats and the 1,159 extensions
    equal the Python lockstep's and the JAX package's; 16 rounds with
    every read in flight, one per extension at 1."""
    (j_reads, j_stats), _seq, _calls = ec_references
    monkeypatch.setattr(TEC, "EC_INFLIGHT", inflight)
    py, p_reads, p_stats, p_calls = _python_run(reads_1p2mbp, monkeypatch)
    c_rounds, c_reads, c_stats, c_calls, split = _c_run(reads_1p2mbp, monkeypatch)
    py = py[(NO_LIMIT, False)]

    assert len(c_rounds) == len(py) == split["rounds"]
    assert split["items"] == [_n_items(np.frombuffer(b, np.int32)) for b in py]
    for i, (a, b) in enumerate(zip(c_rounds, py)):
        assert a == b, f"round {i}"
    assert _same_reads(c_reads, p_reads) and _same_reads(c_reads, j_reads)
    assert np.array_equal(c_stats, p_stats) and np.array_equal(c_stats, j_stats)
    assert c_stats[2] + c_stats[7] > 0
    assert c_calls == p_calls == sum(split["items"]) == 1159
    assert split["rounds"] == {1: 1159, None: 16}.get(inflight, split["rounds"])
    assert split["in_bytes"] == sum(len(b) for b in py)


def _n_items(words: np.ndarray) -> int:
    """B of a packed round: the first descriptor's meta offset is 12 B."""
    return int(words[2]) // WE.DESC_WORDS


@pytest.mark.parametrize("smem_limit,force_global", [
    pytest.param(SMALL_SMEM, False, id="small-smem"), pytest.param(None, True, id="force-global"),
])
def test_global_route_same_bytes(reads_1p2mbp, monkeypatch, device_backend, smem_limit,
                                 force_global):
    """With a small shared-memory limit (a mix of both routes) or every
    item forced to the global route, the C driver's rounds equal
    ``round_layout`` + ``pack_round`` at the same setting, and the reads
    equal the unrouted run's."""
    key = (smem_limit or NO_LIMIT, force_global)
    py, p_reads, p_stats, _ = _python_run(reads_1p2mbp, monkeypatch, (key,))
    c_rounds, c_reads, c_stats, _, split = _c_run(reads_1p2mbp, monkeypatch,
                                                  smem_limit=smem_limit, force_global=force_global)
    assert c_rounds == py[key] and len(c_rounds) == 16
    n_items = sum(split["items"])
    assert 0 < split["n_global"] <= n_items
    assert (split["n_global"] == n_items) == force_global
    assert _same_reads(c_reads, p_reads) and np.array_equal(c_stats, p_stats)


def test_flat_vertex_sequences_same_rounds(reads_1p2mbp, monkeypatch, device_backend):
    """The vertex sequences as one flat buffer of strings (the route for a
    graph without the lazy consensus) give the lazy route's rounds."""
    lazy_rounds, lazy_reads, _, _, _ = _c_run(reads_1p2mbp, monkeypatch)
    real = TEC._ec_inputs
    flat_used = []

    def flat_inputs(read_db, scg):
        g = scg.utg
        ensure_vtx_seq(g)
        lz, g._seq_lazy = g._seq_lazy, None
        try:
            x = real(read_db, scg)
        finally:
            g._seq_lazy = lz
        flat_used.append(x.lazy["lazy_src"] is None and len(x.graph[5]) > 0)
        return x

    monkeypatch.setattr(TEC, "_ec_inputs", flat_inputs)
    flat_rounds, flat_reads, _, _, _ = _c_run(reads_1p2mbp, monkeypatch)
    assert flat_used == [True]
    assert flat_rounds == lazy_rounds and _same_reads(flat_reads, lazy_reads)


def test_thread_count_changes_no_byte(reads_1p2mbp, monkeypatch, device_backend):
    """One thread, eight and 32 (more than this host's cores) give
    identical rounds and reads: rounds of at least 64 items (the set's
    first six) are resumed, packed and unpacked over the threads, each
    with its own slabs."""
    runs = []
    for n in (1, 8, 32):
        monkeypatch.setattr(native, "n_threads_default", lambda n=n: n)
        runs.append(_c_run(reads_1p2mbp, monkeypatch))
    (r1, reads1, s1, c1, sp1), *more = runs
    assert sum(b >= 64 for b in sp1["items"]) >= 3
    for rn, readsn, sn, cn, _ in more:
        assert rn == r1 and _same_reads(readsn, reads1)
        assert np.array_equal(sn, s1) and cn == c1


def test_item_err_raises_unpack_rounds_message(reads_1p2mbp, monkeypatch, device_backend):
    """An item whose err is set (item 2 of the third round) raises the
    message that ``unpack_round`` raises for the same round."""
    real = WE.wf_ed_core_ragged_plain

    def failing(inp, out, B):
        res = real(inp, out, B)
        failing.calls += 1
        if failing.calls == 3:
            out[int(inp[2 * WE.DESC_WORDS + 4]) + 6] = 2
        return res

    msgs = []
    for route in ("python", "native"):
        failing.calls = 0
        with monkeypatch.context() as mp:
            mp.setattr(WE, "wf_ed_core_ragged_plain", failing)
            with pytest.raises(RuntimeError, match=r"wf_ed: item 2 of a round of \d+ failed \(err=2") as e:
                _port_ec(reads_1p2mbp, route)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("backend,native_there,expect", [
    pytest.param("device", True, "c", id="device-native"),
    pytest.param("device", False, "python", id="device-no-native"),
    pytest.param("numpy", True, "sequential", id="numpy"),
])
def test_routes(reads_1p2mbp, monkeypatch, device_backend, backend, native_there, expect):
    """The device backend goes to the C driver when the native library
    is there and to the Python lockstep when it is not; the numpy backend
    keeps its sequential loop."""
    seen = []
    for name, tag in (("_correct_reads_lockstep_native", "c"), ("_correct_reads_lockstep", "python")):
        real = getattr(TEC, name)

        def counted(*a, real=real, tag=tag, **kw):
            seen.append(tag)
            return real(*a, **kw)

        monkeypatch.setattr(TEC, name, counted)
    monkeypatch.setattr(TW, "WF_BACKEND", backend)
    reads, _ = _port_ec(reads_1p2mbp, "native" if native_there else "python")
    assert seen == ([] if expect == "sequential" else [expect])
    assert TEC.read_error_correction.wf_calls == 1159 and len(reads) > 0


def test_failed_build_raises_without_fallback(reads_1p2mbp, monkeypatch, device_backend, tmp_path):
    """A lockstep library that does not build raises with the compiler's
    message while the native library is there; the Python lockstep does
    not run in its place."""
    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\necho 'no compiler on this host' >&2\nexit 3\n")
    cc.chmod(0o755)
    monkeypatch.setenv("CC", str(cc))
    monkeypatch.setattr(ECL, "_lib", None)
    monkeypatch.setattr(ECL, "_SO", str(tmp_path / "libec_lockstep.so"))
    ran = []
    monkeypatch.setattr(TEC, "_correct_reads_lockstep", lambda *a, **kw: ran.append(1))
    with pytest.raises(RuntimeError, match="no compiler on this host"):
        _port_ec(reads_1p2mbp)
    assert ran == [] and TEC.read_error_correction.wf_calls == 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("inflight", [pytest.param(1, id="1"), pytest.param(None, id="all")])
def test_cuda_c_driver_matches_cpu(reads_1p2mbp, monkeypatch, device_backend, inflight):
    """On the card, the C driver's rounds (about half of the items on the
    global route) give the CPU run's reads, stats and extensions, one
    launch per round carrying every extension."""
    _cuda()
    monkeypatch.setattr(TEC, "EC_INFLIGHT", inflight)
    cpu_reads, cpu_stats = _port_ec(reads_1p2mbp)
    cpu_calls = TEC.read_error_correction.wf_calls
    monkeypatch.setattr(TEC.read_error_correction, "wf_calls", 0)
    monkeypatch.setattr(WE.wf_ed_core_batch, "launches", 0)
    monkeypatch.setattr(WE.wf_ed_core_batch, "items", 0)
    _c_route(monkeypatch, smem_limit=SMALL_SMEM)
    reads, stats = _port_ec(reads_1p2mbp, device="cuda")
    split = WE.wf_ed_lockstep.last
    assert _same_reads(reads, cpu_reads) and np.array_equal(stats, cpu_stats)
    assert TEC.read_error_correction.wf_calls == cpu_calls == 1159
    assert WE.wf_ed_core_batch.items == 1159 and WE.wf_ed_core_batch.launches == split["rounds"]
    assert 0 < split["n_global"] < 1159
