"""oatk_tpu_torch._u64: unsigned 64-bit helpers on int64 bit patterns,
held exactly against numpy uint64 on values with the top bit set."""
import numpy as np
import pytest
import torch

from oatk_tpu_torch import _u64

EDGES = np.array(
    [0, 1, 2, (1 << 31), (1 << 32) - 1, (1 << 62), (1 << 63) - 1, 1 << 63,
     (1 << 63) + 1, (1 << 64) - 2, (1 << 64) - 1],
    dtype=np.uint64,
)


@pytest.fixture
def vals():
    rng = np.random.default_rng(64)
    r = rng.integers(0, np.iinfo(np.uint64).max, size=2000, dtype=np.uint64, endpoint=True)
    r[::3] |= np.uint64(1 << 63)  # plenty of top-bit values
    return np.concatenate([EDGES, r])


def test_numpy_roundtrip(vals):
    t = _u64.from_numpy_u64(vals, "cpu")
    assert t.dtype == torch.int64
    back = _u64.to_numpy_u64(t)
    assert back.dtype == np.uint64
    assert np.array_equal(back, vals)


@pytest.mark.parametrize("k", [1, 2, 21, 24, 32, 47, 63])
def test_srl_matches_numpy(vals, k):
    t = _u64.from_numpy_u64(vals, "cpu")
    got = _u64.to_numpy_u64(_u64.srl(t, k))
    assert np.array_equal(got, vals >> np.uint64(k))


def test_srl_zero_and_range(vals):
    t = _u64.from_numpy_u64(vals, "cpu")
    assert torch.equal(_u64.srl(t, 0), t)
    with pytest.raises(ValueError):
        _u64.srl(t, 64)


def test_unsigned_compare(vals):
    rng = np.random.default_rng(3)
    a = vals
    b = rng.permutation(vals)
    ta, tb = _u64.from_numpy_u64(a, "cpu"), _u64.from_numpy_u64(b, "cpu")
    assert np.array_equal(_u64.ult(ta, tb).numpy(), a < b)
    assert np.array_equal(_u64.ule(ta, tb).numpy(), a <= b)
    assert np.array_equal(_u64.ule(ta, ta).numpy(), np.ones(len(a), bool))


def test_unsigned_sort_key(vals):
    t = _u64.from_numpy_u64(vals, "cpu")
    s = _u64.ukey(torch.sort(_u64.ukey(t)).values)
    assert np.array_equal(_u64.to_numpy_u64(s), np.sort(vals))
    # ukey is an involution
    assert torch.equal(_u64.ukey(_u64.ukey(t)), t)


def test_wrapping_arithmetic_matches_uint64(vals):
    """+, *, ^ and << on int64 wrap exactly like uint64."""
    rng = np.random.default_rng(5)
    b = rng.permutation(vals)
    ta, tb = _u64.from_numpy_u64(vals, "cpu"), _u64.from_numpy_u64(b, "cpu")
    with np.errstate(over="ignore"):
        assert np.array_equal(_u64.to_numpy_u64(ta * tb), vals * b)
        assert np.array_equal(_u64.to_numpy_u64(ta + tb), vals + b)
    assert np.array_equal(_u64.to_numpy_u64(ta ^ tb), vals ^ b)
    assert np.array_equal(_u64.to_numpy_u64(ta << 21), vals << np.uint64(21))


def test_as_i64():
    for v in EDGES.tolist():
        x = _u64.as_i64(int(v))
        assert np.array([x], np.int64).view(np.uint64)[0] == v
