"""The port's jagged_to_padded (plain version on the CPU; CUDA kernel on the
card) and padded_to_jagged_ref against the JAX reference (the Pallas kernel
in interpret mode, and ``jagged/ref.py``).

Every comparison is exact: the function is a copy with zero fill. The port
keeps int64 values exact; the reference wraps them to int32 (jax runs with
x64 off), so int64 cases compare after that wrap and, separately, against
an exact numpy oracle. bf16 inputs are made from the same float32 values on
both sides and compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.jagged import ops as jops
from repro.kernels.jagged import ref as jref
from repro_torch.dpp.featurize import pad_sequences
from repro_torch.kernels.jagged import ops as tops


def _offsets(lens, first=0):
    offs = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    return offs + first


def _case(b, max_len, d, seed, dtype=np.float32):
    """The reference's ``test_kernels._jagged_case``: lengths up to twice
    max_len, standard normal values cast to ``dtype``."""
    rng = np.random.default_rng(seed)
    offs = _offsets(rng.integers(0, 2 * max_len, size=b))
    values = rng.standard_normal((int(offs[-1]), d)).astype(dtype)
    return values, offs


def _port(values, offsets, max_len, dtype=None):
    """The port's result on CPU tensors; asserts the CPU route launched
    nothing."""
    v = torch.from_numpy(values)
    if dtype is not None:
        v = v.to(dtype)
    launches = tops.jagged_to_padded.launches
    out = tops.jagged_to_padded(v, torch.from_numpy(offsets), max_len)
    assert tops.jagged_to_padded.launches == launches    # CPU: plain version
    assert out.dtype == v.dtype
    assert out.shape == (len(offsets) - 1, max_len, values.shape[1])
    return out


def _reference(values, offsets, max_len, dtype=None):
    v = jnp.asarray(values) if dtype is None else jnp.asarray(values, dtype)
    return np.asarray(jops.jagged_to_padded(v, jnp.asarray(offsets),
                                            max_len))


def _oracle(values, offsets, max_len):
    """Exact numpy oracle: the last min(len, L) rows, right-aligned."""
    b, d = len(offsets) - 1, values.shape[1]
    out = np.zeros((b, max_len, d), values.dtype)
    for i in range(b):
        n = max(min(int(offsets[i + 1]) - int(offsets[i]), max_len), 0)
        if n:
            out[i, max_len - n:] = values[offsets[i + 1] - n:offsets[i + 1]]
    return out


@pytest.mark.parametrize("b,max_len,d", [(4, 8, 16), (2, 32, 128), (7, 5, 64),
                                         (1, 16, 200), (8, 64, 32)])
def test_jagged_to_padded_shapes(b, max_len, d):
    values, offs = _case(b, max_len, d, seed=b * 7 + d)
    got = _port(values, offs, max_len).numpy()
    np.testing.assert_array_equal(got, _reference(values, offs, max_len))
    np.testing.assert_array_equal(got, _oracle(values, offs, max_len))


def _draw(i):
    """Draw i of the reference property's sweep (b, max_len, d, seed,
    dtype), from its own seeded generator."""
    rng = np.random.default_rng(1000 + i)
    return (int(rng.integers(1, 11)), int(rng.integers(1, 49)),
            [1, 8, 64, 130][i % 4], int(rng.integers(0, 2**16)),
            [np.float32, np.int32][(i // 4) % 2])


@pytest.mark.parametrize("i", range(12))
def test_jagged_to_padded_seeded_sweep(i):
    b, max_len, d, seed, dtype = _draw(i)
    values, offs = _case(b, max_len, d, seed, dtype)
    got = _port(values, offs, max_len).numpy()
    np.testing.assert_array_equal(got, _reference(values, offs, max_len))


def test_jagged_matches_featurizer_contract():
    """jagged_to_padded == the port's host featurizer padding."""
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 100, size=n).astype(np.int64)
            for n in [3, 0, 12, 7]]
    offs = _offsets([len(s) for s in seqs])
    values = np.concatenate(seqs).astype(np.float32)[:, None]
    got = _port(values, offs, 8).numpy()[:, :, 0]
    np.testing.assert_array_equal(got, pad_sequences(seqs, 8).astype(
        np.float32))
    np.testing.assert_array_equal(got, _reference(values, offs, 8)[:, :, 0])
    ids = np.concatenate(seqs)[:, None]                 # int64, exact
    np.testing.assert_array_equal(_port(ids, offs, 8).numpy()[:, :, 0],
                                  pad_sequences(seqs, 8))


@pytest.mark.parametrize("dtype,d", [
    ("bfloat16", 1), ("bfloat16", 130), ("bfloat16", 64), ("float16", 5),
    ("int8", 3), ("int16", 7), ("uint8", 16), ("bool", 3), ("int32", 2),
])
def test_jagged_to_padded_dtypes(dtype, d):
    """Every dtype comes back in its own dtype, bit for bit; bf16 at D=1 and
    D=130 and int8 at D=3 are the widths the card's kernel moves in 1- or
    4-byte words."""
    rng = np.random.default_rng(d + len(dtype))
    offs = _offsets(rng.integers(0, 20, size=6), first=0)
    x = rng.standard_normal((int(offs[-1]), d)) * 50
    if dtype == "bfloat16":
        values = x.astype(np.float32)
        got = _port(values, offs, 12, torch.bfloat16)
        want = _reference(values, offs, 12, jnp.bfloat16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
        return
    values = (x > 0) if dtype == "bool" else x.astype(dtype)
    got = _port(values, offs, 12).numpy()
    want = _reference(values, offs, 12)
    assert got.dtype == want.dtype == values.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(values, offs, 12))


@pytest.mark.parametrize("offsets_dtype", [np.int32, np.int64])
def test_jagged_int64_values_beyond_int32(offsets_dtype):
    """int64 values stay exact int64 in the port; the reference wraps them
    to int32 (x64 off): values 2**40 + k come back from it as k. Offsets are
    read in their own width."""
    rng = np.random.default_rng(5)
    offs = _offsets([5, 0, 40, 17, 9]).astype(offsets_dtype)
    k = rng.integers(-1000, 1000, size=(int(offs[-1]), 2))
    values = (2**40 + k).astype(np.int64)
    got = _port(values, offs, 16).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, _oracle(values, offs, 16))
    want = _reference(values, offs, 16)
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got.astype(np.int32), want)
    assert got.max() > np.iinfo(np.int32).max


@pytest.mark.parametrize("b,max_len,d,n", [
    (0, 5, 4, 0),        # empty batch
    (3, 0, 4, 20),       # max_len 0
    (3, 6, 0, 20),       # D 0
    (4, 6, 3, 0),        # empty arena: every row empty
])
def test_jagged_empty_and_zero_length_shapes(b, max_len, d, n):
    rng = np.random.default_rng(b + max_len + d + n)
    lens = np.zeros(b, np.int64)
    if b and n:
        lens[:] = n // b
    offs = _offsets(lens)
    values = rng.standard_normal((n, d)).astype(np.float32)
    got = _port(values, offs, max_len).numpy()
    assert not got.any()
    if d:
        want = _reference(values, offs, max_len)
    else:   # a zero-width block is no valid pallas_call: the oracle
        want = np.asarray(jref.jagged_to_padded(jnp.asarray(values),
                                                jnp.asarray(offs), max_len))
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)


def test_jagged_all_empty_rows_and_over_length_rows():
    rng = np.random.default_rng(8)
    offs = _offsets([0, 0, 30, 0, 8, 9, 0])
    values = rng.standard_normal((int(offs[-1]), 4)).astype(np.float32)
    got = _port(values, offs, 8).numpy()
    np.testing.assert_array_equal(got, _reference(values, offs, 8))
    assert not got[[0, 1, 3, 6]].any()
    np.testing.assert_array_equal(got[2], values[offs[3] - 8:offs[3]])


def test_jagged_nonzero_first_offset():
    """offsets[0] > 0: the rows before it are never read."""
    rng = np.random.default_rng(9)
    offs = _offsets([3, 11, 0, 6], first=7)
    values = rng.standard_normal((int(offs[-1]) + 2, 5)).astype(np.float32)
    got = _port(values, offs, 8).numpy()
    np.testing.assert_array_equal(got, _reference(values, offs, 8))
    np.testing.assert_array_equal(got, _oracle(values, offs, 8))


def test_jagged_float32_bits_survive():
    """NaN, -0.0, infinities and denormals come back bit for bit."""
    special = np.array([-0.0, np.inf, -np.inf, np.nan, 1e-42, -1e-42, 3.14],
                       np.float32)
    values = np.resize(special, (21, 3)).copy()
    values.view(np.int32)[4, 1] = 0x7FC01234          # a NaN with a payload
    offs = _offsets([3, 7, 0, 11])
    got = _port(values, offs, 6).numpy()
    want = _reference(values, offs, 6)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32),
                                  _oracle(values, offs, 6).view(np.int32))


def test_jagged_malformed_offsets_read_inside_the_arena():
    """A negative length gives an all-zero row; ends past the arena clamp to
    its last row, as the reference oracle's clip does."""
    rng = np.random.default_rng(10)
    values = rng.standard_normal((12, 3)).astype(np.float32)
    offs = np.array([0, 5, 2, 12, 15], np.int32)   # row 1 negative, row 3 past
    got = _port(values, offs, 6).numpy()
    want = np.asarray(jref.jagged_to_padded(jnp.asarray(values),
                                            jnp.asarray(offs), 6))
    np.testing.assert_array_equal(got, want)
    assert not got[1].any()
    np.testing.assert_array_equal(got[3, 3:], values[[11, 11, 11]])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_padded_to_jagged_round_trip(dtype):
    """Rows no longer than L: padded_to_jagged_ref inverts jagged_to_padded,
    and equals the reference's ``padded_to_jagged``."""
    rng = np.random.default_rng(11)
    offs = _offsets([4, 0, 10, 1, 7])
    values = (rng.standard_normal((int(offs[-1]), 6)) * 9).astype(dtype)
    padded = _port(values, offs, 10)
    back = tops.padded_to_jagged_ref(padded, torch.from_numpy(offs),
                                     int(offs[-1]))
    assert back.dtype == padded.dtype
    np.testing.assert_array_equal(back.numpy(), values)
    want = jref.padded_to_jagged(jnp.asarray(padded.numpy()),
                                 jnp.asarray(offs), int(offs[-1]))
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


def test_padded_to_jagged_drops_positions_outside_rows():
    """Positions before a row's kept span and destinations past ``total``
    are dropped, as the reference's out-of-bounds slot drops them."""
    rng = np.random.default_rng(12)
    offs = _offsets([2, 5, 3])
    padded = rng.standard_normal((3, 5, 2)).astype(np.float32)
    for total in (int(offs[-1]), int(offs[-1]) - 4):
        got = tops.padded_to_jagged_ref(torch.from_numpy(padded),
                                        torch.from_numpy(offs), total)
        want = jref.padded_to_jagged(jnp.asarray(padded), jnp.asarray(offs),
                                     total)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_jagged_rejects_bad_arguments():
    v = torch.zeros((4, 2))
    with pytest.raises(TypeError, match="int32 or int64"):
        tops.jagged_to_padded(v, torch.zeros(3, dtype=torch.float32), 2)
    with pytest.raises(ValueError, match="offsets"):
        tops.jagged_to_padded(v[:, 0], torch.zeros(3, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="max_len"):
        tops.jagged_to_padded(v, torch.zeros(3, dtype=torch.int32), -1)
    with pytest.raises(ValueError, match="CUDA or all on the CPU"):
        tops.jagged_to_padded(v.to("meta"), torch.zeros(3, dtype=torch.int32),
                              2)


def test_kernel_source_is_in_the_package():
    src = tops.LIBRARY.source
    assert src.is_file() and src.suffix == ".cu"
    assert "jagged_to_padded_launch" in src.read_text()
