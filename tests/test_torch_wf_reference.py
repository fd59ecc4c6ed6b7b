"""The benchmark's plain wavefront reference (``portbench/reference/
wavefront.py``, written from the kernel's contract) against the port's
wavefront, and what error correction's device route records of its
rounds.

- Seeded random items (targets and queries up to ~2 kbp, banded and not,
  extending and global, a hit on the first wave, a stop by the band, a
  resumed wave, ``err`` 1 and 2) through ``wf_ed_core_batch`` and
  ``wf_ed_core_ragged`` (their plain versions on the CPU) and through the
  reference: every out_meta word and ``out_k[:n]`` equal.
- A whole ``syncasm`` on the 1.2 Mbp set of ``test_torch_ec_device.py``
  with ``OATK_TPU_WF_BACKEND=device``: every item of every round that
  ``csrc/ec_lockstep.c`` lays out, decoded from the round's input words,
  equals the reference; the ``ec.*`` keys of the stage recorder are there, sum to
  no more than ``ec`` and cover most of it; the split's counters of the
  kernel's work equal their sums over the captured items.

Tolerance: exact (integers)."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import oatk_tpu_torch.kernels.wavefront as TW  # noqa: E402
from oatk_tpu_torch.kernels import wf_ed as WE  # noqa: E402
from portbench.reference import wavefront as REF  # noqa: E402
from test_torch_ec_device import reads_1p2mbp  # noqa: E402,F401

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _edit(rng, s: np.ndarray, n: int) -> np.ndarray:
    """``s`` with ``n`` random substitutions, insertions and deletions."""
    s = s.copy()
    for _ in range(n):
        i = int(rng.integers(0, max(len(s), 1)))
        op = rng.integers(0, 3)
        if op == 0 and len(s):
            s[i] = ACGT[(np.flatnonzero(ACGT == s[i])[0] + rng.integers(1, 4)) % 4]
        elif op == 1:
            s = np.insert(s, i, ACGT[rng.integers(0, 4)])
        elif len(s) > 1:
            s = np.delete(s, i)
    return s


# kind -> (is_ext, bw range or None for -1, edits, target length range)
KINDS = {
    "ext-banded": (1, (4, 40), (0, 12), (50, 2000)),
    "ext-unbanded": (1, None, (0, 4), (50, 2000)),
    "global-banded": (0, (4, 40), (0, 12), (50, 1500)),
    "global-unbanded": (0, None, (0, 4), (50, 1500)),
    "first-wave-hit": (1, (0, 30), (0, 0), (20, 2000)),
    "band-stop": (1, (1, 4), (30, 60), (200, 2000)),
}


def _item(rng, kind: str) -> dict:
    """One item at the start of an alignment (score 0, the wave k = -1
    on diagonal 0), or for ``resumed`` one that goes on from a first
    call's output with a longer query, as error correction's stepwise
    restart does."""
    is_ext, bws, edits, lens = KINDS.get(kind, KINDS["ext-banded"])
    tl = int(rng.integers(*lens))
    ts = ACGT[rng.integers(0, 4, tl)]
    bw = -1 if bws is None else int(rng.integers(*bws))
    qs = _edit(rng, ts if not is_ext else ts[: int(rng.integers(tl // 2, tl + 1))],
               int(rng.integers(edits[0], edits[1] + 1)))
    if kind == "first-wave-hit":
        qs = ts[: int(rng.integers(1, tl + 1))].copy()
    return dict(ts=ts, qs=qs, is_ext=is_ext, bw=bw, score=0, d0=0, k=np.array([-1], np.int64))


def _batch(items: list, d_cap: int | None = None):
    """The padded batch of ``items`` as torch tensors; ``d_cap`` (default:
    wide enough for any wave) sets the width of k."""
    B = len(items)
    TL = max(len(it["ts"]) for it in items)
    QL = max(len(it["qs"]) for it in items)
    if d_cap is None:
        d_cap = max(WE.d_cap_for(len(it["ts"]), len(it["qs"]), len(it["k"]), it["bw"],
                                 bool(it["is_ext"])) for it in items)
    ts = np.zeros((B, TL), np.uint8)
    qs = np.zeros((B, QL), np.uint8)
    meta = np.zeros((B, 8), np.int32)
    k = np.full((B, d_cap), -WE.BIG, np.int32)
    for b, it in enumerate(items):
        ts[b, : len(it["ts"])] = it["ts"]
        qs[b, : len(it["qs"])] = it["qs"]
        n = len(it["k"])
        meta[b, :7] = (len(it["ts"]), len(it["qs"]), it["is_ext"], it["bw"], it["score"],
                       it["d0"], n)
        k[b, : min(n, d_cap)] = it["k"][:d_cap]
    return (torch.from_numpy(ts), torch.from_numpy(qs), torch.from_numpy(meta),
            torch.from_numpy(k))


def _resumed(rng, n: int) -> list:
    """Items that resume a first call's wave (it stopped at the end of a
    shorter query) on the whole query."""
    out = []
    while len(out) < n:
        it = _item(rng, "ext-banded")
        full = it["qs"]
        cut = int(rng.integers(1, max(len(full), 2)))
        first = dict(it, qs=full[:cut])
        om, ok = WE.wf_ed_core_batch(*_batch([first]))
        om = om[0].tolist()
        if om[6] or om[3] == 0 or cut == len(full):
            continue
        out.append(dict(it, score=om[0], d0=om[1], k=ok[0, : om[2]].numpy().astype(np.int64)))
    return out


def _items(kind: str, seed: int, n: int = 10) -> tuple[list, int | None]:
    rng = np.random.default_rng([seed, sorted(KINDS).index(kind) if kind in KINDS else 99])
    if kind == "resumed":
        return _resumed(rng, n), None
    if kind == "err2":  # an unbanded wave that outgrows a narrow k
        items = [dict(_item(rng, "ext-unbanded"), qs=_edit(rng, ACGT[rng.integers(0, 4, 300)], 0),
                      ts=ACGT[rng.integers(0, 4, 300)]) for _ in range(n)]
        return items, 32
    return [_item(rng, kind) for _ in range(n)], None


ALL_KINDS = sorted(KINDS) + ["resumed", "err2"]


@pytest.mark.parametrize("kind", ALL_KINDS)
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_equals_padded_batch(kind, seed):
    """The padded batch (``wf_ed_core_batch``) item by item."""
    items, d_cap = _items(kind, seed)
    ts, qs, meta, k = _batch(items, d_cap)
    om, ok = WE.wf_ed_core_batch(ts, qs, meta, k)
    seen = set()
    for b in range(len(items)):
        want_m, want_k = REF.align(ts[b].numpy(), qs[b].numpy(), meta[b].numpy(),
                                   k[b].numpy(), k.shape[1])
        got_m = om[b].numpy().astype(np.int64)
        assert np.array_equal(got_m, want_m), (kind, b, got_m, want_m)
        assert np.array_equal(ok[b].numpy(), want_k), (kind, b)
        seen.add(("hit" if want_m[3] else "err%d" % want_m[6] if want_m[6] else "band"))
        if kind == "first-wave-hit":
            assert want_m[0] == 0 and want_m[3] == 1
    assert seen == {"first-wave-hit": {"hit"}, "band-stop": {"band"}, "err2": {"err2"}}.get(
        kind, seen)


@pytest.mark.parametrize("case", ["n0", "n-above-S", "tl-above-TL", "ql-above-QL", "negative-tl"])
def test_reference_equals_batch_on_err1(case):
    """Inputs that do not fit: err 1, the input's score, d0 and n, ends
    -1, out_k all -BIG, in the batch and in the reference."""
    rng = np.random.default_rng(5)
    items = [_item(rng, "ext-banded") for _ in range(3)]
    ts, qs, meta, k = _batch(items)
    b = 1
    col, val = {"n0": (6, 0), "n-above-S": (6, k.shape[1] + 1), "tl-above-TL": (0, ts.shape[1] + 1),
                "ql-above-QL": (1, qs.shape[1] + 1), "negative-tl": (0, -1)}[case]
    meta[b, col] = val
    om, ok = WE.wf_ed_core_batch(ts, qs, meta, k)
    want_m, want_k = REF.align(ts[b].numpy(), qs[b].numpy(), meta[b].numpy(), k[b].numpy(),
                               k.shape[1])
    assert want_m[6] == 1
    assert np.array_equal(om[b].numpy().astype(np.int64), want_m)
    assert np.array_equal(ok[b].numpy(), want_k)


def _states(items: list) -> list:
    return [TW.WfState(ts=it["ts"], qs=it["qs"], is_ext=bool(it["is_ext"]), bw=it["bw"],
                       score=it["score"], wd=it["d0"] + np.arange(len(it["k"]), dtype=np.int64),
                       wk=it["k"].copy()) for it in items]


@pytest.mark.parametrize("kind", sorted(KINDS) + ["resumed"])
def test_reference_replays_a_ragged_round(kind):
    """A ragged round of every kind's items (``round_layout`` +
    ``pack_round``, both kernel routes) through ``wf_ed_core_ragged``:
    the reference, fed from the round's input words by ``decode_round``,
    gives each item's out_meta and out_k[:n]."""
    items, _ = _items(kind, 3, n=8)
    states = _states(items)
    lay = WE.round_layout(states, 600, force_global=np.arange(len(states)) % 3 == 0)
    h = np.zeros(lay.in_words, np.int32)
    WE.pack_round(h, lay, states)
    out = torch.zeros(lay.out_words, dtype=torch.int32)
    WE.wf_ed_core_ragged(torch.from_numpy(h), out, len(states), lay.smem)
    dec = REF.decode_round(h)
    assert len(dec) == len(states) == REF.n_items(h)
    for st, it in zip(states, dec):
        assert it.meta[0] == len(st.ts) and np.array_equal(it.k, st.wk)
        assert bytes(it.ts) == bytes(st.ts) and bytes(it.qs) == bytes(st.qs)
        assert REF.compare(it, out.numpy())


# ---- the C lockstep rounds inside a whole syncasm ----

@pytest.fixture(scope="module")
def device_ec_job(reads_1p2mbp, tmp_path_factory):
    """syncasm on the 1.2 Mbp set (k=151, s=13, c=3, EC, 3 unzip rounds)
    on the device wavefront backend, every ragged round's input and
    output words captured as the plain version runs them."""
    from oatk_tpu_torch.asm import pipeline

    rounds = []
    real = WE.wf_ed_core_ragged_plain

    def capture(inp, out, B):
        real(inp, out, B)
        rounds.append((inp.numpy().copy(), out.numpy().copy(), B))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TW, "WF_BACKEND", "device")
        mp.setattr(WE, "wf_ed_core_ragged_plain", capture)
        res = pipeline.syncasm([reads_1p2mbp], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3,
                               out=str(tmp_path_factory.mktemp("wfref") / "out"), device="cpu")
    return res.timings, WE.wf_ed_lockstep.last, rounds


def test_reference_equals_every_round_of_the_c_lockstep(device_ec_job):
    _timings, split, rounds = device_ec_job
    assert len(rounds) == split["rounds"] >= 10
    n = 0
    for inp, out, B in rounds:
        items = REF.decode_round(inp, B)
        assert REF.n_items(inp) == B
        for it in items:
            assert REF.compare(it, out), (n, it.meta)
            n += 1
    assert n == sum(split["items"]) == 1159


def test_ec_keys_of_the_device_route(device_ec_job):
    """The route's spans are recorded under ``ec``: the direct children
    sum to no more than ``ec`` and cover at least 95% of it; the rounds'
    split is booked under ``ec.wf`` as the split has it."""
    t, split, _ = device_ec_job
    parts = ("find", "inputs", "lockstep", "wf", "finish", "splice", "update")
    for p in parts:
        assert f"ec.{p}" in t, p
    kids = sum(v for key, v in t.items() if key.startswith("ec.") and key.count(".") == 1)
    assert kids == pytest.approx(sum(t[f"ec.{p}"] for p in parts))
    assert 0.95 * t["ec"] <= kids <= t["ec"]
    for p in ("layout", "pack", "trip", "unpack"):
        assert t[f"ec.wf.{p}"] == split[f"{p}_s"]
    assert sum(t[f"ec.wf.{p}"] for p in ("layout", "pack", "trip", "unpack")) <= t["ec.wf"]


def test_split_counts_the_kernels_work(device_ec_job):
    """seq_bytes, wave_in, wave_out and wave_cells equal their sums over
    the captured items, from each item's meta in and out_meta."""
    _, split, rounds = device_ec_job
    want = dict(seq_bytes=0, wave_in=0, wave_out=0, wave_cells=0)
    for inp, out, B in rounds:
        for it in REF.decode_round(inp, B):
            om = out[it.out_meta_off: it.out_meta_off + 8].astype(np.int64)
            want["seq_bytes"] += int(it.meta[0] + it.meta[1])
            want["wave_in"] += int(it.meta[6])
            want["wave_out"] += int(om[2])
            want["wave_cells"] += int((om[0] - it.meta[4]) * (it.meta[6] + om[2]))
    want["wave_cells"] /= 2
    for key, v in want.items():
        assert split[key] == v, key
    assert split["wave_cells"] > 0 and split["seq_bytes"] > 0
