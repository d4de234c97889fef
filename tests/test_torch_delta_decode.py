"""The port's delta_decode (plain version on the CPU; CUDA kernel on the card)
against the JAX reference (the Pallas kernel in interpret mode).

Every comparison is exact: the decode is an integer scan. int32 inputs wrap
in two's complement on both sides; int64 inputs are exact in the port
(a tensor on the inputs' device) and in the reference (a numpy array, or a
host decode when the window spans more than int32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_decode import ops as jops
from repro.kernels.delta_decode import ref as jref
from repro_torch.core import events as ev
from repro_torch.kernels.delta_decode import ops as tops
from repro_torch.storage import columnar


def _port(deltas, bases):
    """The port's result on CPU tensors as numpy; asserts the CPU route
    launched nothing and the result stayed a CPU tensor."""
    launches = tops.delta_decode.launches
    out = tops.delta_decode(torch.from_numpy(deltas), torch.from_numpy(bases))
    assert tops.delta_decode.launches == launches     # CPU: plain version
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.shape == deltas.shape
    return out.numpy()


def _reference(deltas, bases):
    if deltas.dtype == np.int64 or bases.dtype == np.int64:
        return np.asarray(jops.delta_decode(deltas, bases))
    return np.asarray(jops.delta_decode(jnp.asarray(deltas),
                                        jnp.asarray(bases)))


@pytest.mark.parametrize("b,n", [(1, 16), (3, 100), (8, 128), (16, 384),
                                 (5, 7)])
def test_delta_decode_shapes(b, n):
    rng = np.random.default_rng(b * 1000 + n)
    deltas = rng.integers(0, 10_000, size=(b, n)).astype(np.int32)
    deltas[:, 0] = 0
    bases = rng.integers(0, 1 << 20, size=(b,)).astype(np.int32)
    got = _port(deltas, bases)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _reference(deltas, bases))
    np.testing.assert_array_equal(got, np.asarray(jref.delta_decode(
        jnp.asarray(deltas), jnp.asarray(bases))))


@pytest.mark.parametrize("i", range(12))
def test_delta_decode_seeded_sweep(i):
    """Draws of the reference property's sweep (b in 1..12, n in 1..300,
    deltas below 2^16, bases within 2^20 of zero)."""
    rng = np.random.default_rng(2000 + i)
    b, n = int(rng.integers(1, 13)), int(rng.integers(1, 301))
    deltas = rng.integers(0, 1 << 16, size=(b, n)).astype(np.int32)
    bases = rng.integers(-(1 << 20), 1 << 20, size=(b,)).astype(np.int32)
    np.testing.assert_array_equal(_port(deltas, bases),
                                  _reference(deltas, bases))


def test_delta_decode_matches_columnar_codec():
    """The decode restores what the port's storage codec encoded."""
    rng = np.random.default_rng(0)
    ts = np.sort(rng.integers(0, 1 << 30, size=200)).astype(np.int64)
    payload, meta = columnar.encode_column(ts, ev.DENSE_MONOTONE)
    inner = dict(meta)
    inner["codec"] = meta["inner"]
    deltas = columnar._unpack_unsigned(payload, inner, np.int64)
    d32 = deltas[None, :].astype(np.int32)
    got = _port(d32, np.zeros(1, np.int32))
    np.testing.assert_array_equal(got[0] + meta["base"], ts)
    np.testing.assert_array_equal(got, _reference(d32, np.zeros(1, np.int32)))
    got64 = _port(deltas[None, :], np.array([meta["base"]], np.int64))
    np.testing.assert_array_equal(got64[0], ts)


def test_delta_decode_int64_base_beyond_int32():
    """Epoch-millisecond bases above 2^31 come back exact as int64."""
    rng = np.random.default_rng(0)
    b, n = 4, 50
    deltas = rng.integers(0, 10_000, size=(b, n)).astype(np.int64)
    deltas[:, 0] = 0
    bases = 3_000_000_000 + rng.integers(0, 10**9, size=(b,)).astype(np.int64)
    got = _port(deltas, bases)
    want = np.cumsum(deltas, axis=1) + bases[:, None]
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _reference(deltas, bases))
    assert want.max() > np.iinfo(np.int32).max


def test_delta_decode_int64_wide_window_exact():
    """A window spanning 2^33 is exact: the reference decodes it on the
    host, the port's int64 scan carries it natively."""
    deltas = np.array([[0, 2**33, 5], [3, -(2**34), 2**40]], dtype=np.int64)
    bases = np.array([7, -9], dtype=np.int64)
    got = _port(deltas, bases)
    want = np.cumsum(deltas, axis=1) + bases[:, None]
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _reference(deltas, bases))


def test_delta_decode_int32_wraps_like_the_reference():
    """2^30 deltas over 300 columns overflow int32 many times: both wrap in
    two's complement, as numpy's int64 cumsum cast to int32 does."""
    rng = np.random.default_rng(4)
    deltas = np.full((3, 300), 2**30, np.int32)
    deltas[1] = rng.integers(-(2**31), 2**31 - 1, 300)
    bases = np.array([2**31 - 1, -(2**31), 12345], np.int32)
    got = _port(deltas, bases)
    want = (np.cumsum(deltas.astype(np.int64), axis=1)
            + bases.astype(np.int64)[:, None]).astype(np.int32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _reference(deltas, bases))


def test_delta_decode_int32_stays_int32():
    got = _port(np.array([[0, 1, 2]], np.int32), np.array([5], np.int32))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, [[5, 6, 8]])


@pytest.mark.parametrize("d_dtype,b_dtype,want_dtype", [
    (np.int32, np.int64, np.int64), (np.int64, np.int32, np.int64),
    (np.int16, np.int32, np.int32), (np.uint8, np.int16, np.int32),
])
def test_delta_decode_dtype_dispatch(d_dtype, b_dtype, want_dtype):
    """int64 if either input is int64, else int32, as the reference."""
    rng = np.random.default_rng(6)
    deltas = rng.integers(0, 100, size=(3, 9)).astype(d_dtype)
    bases = rng.integers(0, 100, size=3).astype(b_dtype)
    got = _port(deltas, bases)
    want = _reference(deltas, bases)
    assert got.dtype == want_dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(0, 8), (3, 0), (0, 0)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_delta_decode_empty_shapes(shape, dtype):
    got = _port(np.zeros(shape, dtype), np.zeros(shape[0], dtype))
    want = _reference(np.zeros(shape, dtype), np.zeros(shape[0], dtype))
    assert got.shape == want.shape == shape
    assert got.dtype == want.dtype == dtype


def test_delta_decode_rejects_bad_shapes():
    with pytest.raises(ValueError, match="bases"):
        tops.delta_decode(torch.zeros((3, 4), dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA or all on the CPU"):
        tops.delta_decode(torch.zeros((3, 4), dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32).to("meta"))


def test_kernel_source_is_in_the_package():
    src = tops.LIBRARY.source
    assert src.is_file() and src.suffix == ".cu"
    assert "delta_decode_launch" in src.read_text()
