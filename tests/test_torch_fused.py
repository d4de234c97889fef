"""The port's fused densify (plain version on the CPU; CUDA kernel on the card)
against the JAX reference ``repro.kernels.fused.ops`` (Pallas, interpret mode).

Exact everywhere: the (B, L, T) int32 block equals the reference's; every
unpacked lane equals the reference's after jax's int32 canonicalization, and
equals the host values exactly where they fit (float32 bit-for-bit,
timestamps as exact int64 even past 2^31).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused import ops as jfu
from repro_torch.kernels.fused import ops as tfu


def _oracle(vals, offs, seq_len):
    """Host numpy scatter in host dtypes (no canonicalization)."""
    lens = np.minimum(np.diff(offs), seq_len)
    b = len(lens)
    j = np.arange(seq_len)
    out = {}
    for t, col in vals.items():
        col = np.asarray(col)
        dense = np.zeros((b, seq_len), col.dtype)
        kept = np.concatenate(
            [col[offs[i + 1] - lens[i]:offs[i + 1]] for i in range(b)]
        ) if b else col[:0]
        dense[j >= (seq_len - lens)[:, None]] = kept
        out[t] = dense
    return out


def _case(rng, b, seq_len, over_length=False, with_ts=True, ts0=0):
    hi = 3 * seq_len if over_length else seq_len
    lens = rng.integers(0, hi + 1, size=b)
    offs = np.zeros(b + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    n = int(offs[-1])
    vals = {
        "item_id": rng.integers(0, 10**12, n).astype(np.int64),
        "action": rng.integers(-5, 5, n).astype(np.int32),
        "flag": rng.integers(0, 2, n).astype(np.int8),
        "score": rng.standard_normal(n).astype(np.float32),
        "weight": rng.standard_normal(n).astype(np.float64),
    }
    if with_ts:
        ts = ts0 + np.sort(rng.integers(0, 10**6, n)).astype(np.int64)
        vals["timestamp"] = np.concatenate(
            [np.sort(ts[offs[i]:offs[i + 1]]) for i in range(b)]
        ) if n else ts
    return vals, offs


def _encode(fu, vals, offs, with_ts):
    """Delta-encode the timestamp column (if any) and pack the arena."""
    vals = dict(vals)
    bases, ts_col = None, -1
    if with_ts and "timestamp" in vals:
        vals["timestamp"], bases = fu.ts_delta_encode(vals["timestamp"], offs)
        ts_col = list(vals).index("timestamp")
    arena, metas = fu.pack_arena(vals)
    return arena, metas, bases, ts_col


def _port(vals, offs, seq_len, with_ts=False):
    arena, metas, bases, ts_col = _encode(tfu, vals, offs, with_ts)
    dense, ts = tfu.fused_densify(
        torch.from_numpy(arena), torch.from_numpy(offs.astype(np.int32)),
        seq_len, ts_bases=None if bases is None else torch.from_numpy(bases),
        ts_col=ts_col)
    return dense.numpy(), {k: v.numpy() for k, v in
                           tfu.unpack_dense(dense, metas, ts, ts_col).items()}


def _reference(vals, offs, seq_len, with_ts=False):
    arena, metas, bases, ts_col = _encode(jfu, vals, offs, with_ts)
    dense = jfu.fused_densify(
        jnp.asarray(arena), jnp.asarray(offs.astype(np.int32)), seq_len,
        ts_bases=None if bases is None else bases.astype(np.int32),
        ts_col=ts_col)
    return np.asarray(dense), {k: np.asarray(v) for k, v in
                               jfu.unpack_dense(dense, metas).items()}


def _assert_parity(vals, offs, seq_len, with_ts=False):
    got_block, got = _port(vals, offs, seq_len, with_ts)
    want_block, want = _reference(vals, offs, seq_len, with_ts)
    np.testing.assert_array_equal(got_block, want_block)
    host = _oracle(vals, offs, seq_len)
    assert list(got) == list(want) == list(host)
    for k in want:
        # the port keeps the host dtype; the reference canonicalizes (x64 off)
        assert got[k].dtype == host[k].dtype, k
        np.testing.assert_array_equal(got[k].astype(want[k].dtype), want[k],
                                      err_msg=k)
    return got, host


@pytest.mark.parametrize("b,seq_len", [(1, 4), (5, 16), (8, 7), (3, 130)])
def test_fused_densify_multi_trait_parity(b, seq_len):
    rng = np.random.default_rng(b * 31 + seq_len)
    vals, offs = _case(rng, b, seq_len, with_ts=False)
    got, host = _assert_parity(vals, offs, seq_len)
    for k in ("action", "flag"):
        np.testing.assert_array_equal(got[k], host[k], err_msg=k)
    np.testing.assert_array_equal(got["score"].view(np.int32),
                                  host["score"].view(np.int32))


def test_fused_densify_over_length_rows_keep_tail():
    """Rows longer than seq_len right-align their LAST seq_len elements."""
    rng = np.random.default_rng(2)
    vals, offs = _case(rng, 6, 8, over_length=True, with_ts=False)
    _assert_parity(vals, offs, 8)


@pytest.mark.parametrize("b", [0, 4])
def test_fused_densify_empty_batch_and_all_empty_rows(b):
    offs = np.zeros(b + 1, np.int64)
    vals = {"item_id": np.zeros(0, np.int64), "score": np.zeros(0, np.float32)}
    got, _ = _assert_parity(vals, offs, 5)
    for v in got.values():
        assert v.shape == (b, 5)
        np.testing.assert_array_equal(v, 0)


def test_fused_float32_bitcast_is_bit_exact():
    """-0.0, inf, nan and denormals survive the int32 arena bit-for-bit."""
    special = np.array([-0.0, np.inf, -np.inf, np.nan, np.float32(1e-42),
                        -np.float32(1e-42), 3.14], np.float32)
    offs = np.array([0, 3, 7], np.int64)
    got, host = _assert_parity({"score": special}, offs, 4)
    np.testing.assert_array_equal(got["score"].view(np.int32),
                                  host["score"].view(np.int32))


@pytest.mark.parametrize("ts0", [0, 3_000_000_000])
@pytest.mark.parametrize("b,seq_len", [(5, 16), (8, 7), (3, 130)])
def test_fused_timestamp_decode_exact_int64(ts0, b, seq_len):
    """In-window delta decode: the int32 block and lanes match the reference
    (which wraps to int32), and the port's timestamp lane is the exact int64
    host value, past 2^31 included. Rows are pre-clipped to seq_len, the
    featurizer's contract that makes a row's base its first KEPT element."""
    rng = np.random.default_rng(b * 7 + seq_len + (ts0 > 0))
    vals, offs = _case(rng, b, seq_len, ts0=ts0)
    got, host = _assert_parity(vals, offs, seq_len, with_ts=True)
    assert got["timestamp"].dtype == np.int64
    np.testing.assert_array_equal(got["timestamp"], host["timestamp"])


def test_ts_delta_encode_matches_reference_and_rejects_overflow():
    rng = np.random.default_rng(3)
    offs = np.array([0, 5, 5, 12], np.int64)
    ts = np.int64(3_000_000_000) + np.concatenate(
        [np.sort(rng.integers(0, 10**6, int(n))) for n in np.diff(offs)]
    ).astype(np.int64)
    got = tfu.ts_delta_encode(ts, offs)
    want = jfu.ts_delta_encode(ts, offs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="int32"):
        tfu.ts_delta_encode(np.array([0, 2**32], np.int64),
                            np.array([0, 2], np.int64))


def test_fused_densify_cpu_route_does_not_launch():
    """A CPU tensor runs the plain version: the launch count stays put."""
    before = tfu.fused_densify.launches
    tfu.fused_densify(torch.ones((3, 2), dtype=torch.int32),
                      torch.tensor([0, 1, 3], dtype=torch.int32), 2)
    assert tfu.fused_densify.launches == before


def _lanes(rng, lens, t, ts_at=None, ts0=0, float_lane=False):
    """``t`` traits over rows of ``lens``: int32 lanes over the full int32
    range, one float32 lane of -0.0/inf/NaN/denormals when ``float_lane``,
    and at index ``ts_at`` an int64 timestamp trait from ``ts0`` on."""
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    n = int(offs[-1])
    vals = {}
    for i in range(t):
        if i == ts_at:
            vals["timestamp"] = np.concatenate(
                [ts0 + np.sort(rng.integers(0, 10**9, int(k))) for k in lens]
            ).astype(np.int64) if n else np.zeros(0, np.int64)
        elif float_lane and i == t - 1:
            special = np.array([-0.0, np.inf, -np.inf, np.nan, 1e-42,
                                -1e-42, 2.5], np.float32)
            vals[f"f{i}"] = np.resize(special, n)
        else:
            vals[f"lane{i}"] = rng.integers(-2**31, 2**31, n).astype(np.int32)
    return vals, offs


# The kernel's boundary shapes on the card (tests/test_torch_gpu.py), here at
# small L: a row split over ranks of a cluster meets their boundaries, a
# block has more threads than L has positions, and a position's lanes move
# as 16-byte words (T a multiple of 4) or lane by lane (T = 1, 3, 5).
DENSIFY_BOUNDARIES = {
    # name: (lens, seq_len, t, ts_at, float_lane)
    "first valid position on a rank boundary": ([16, 32, 48, 64], 64, 4, 3,
                                                 False),
    "valid positions only in the last rank": ([1, 3, 0, 7], 64, 4, 0, False),
    "L not a multiple of the chunk": ([33, 17, 0, 32, 1], 33, 4, 3, False),
    "L smaller than a block's threads": ([5, 0, 2, 5], 5, 4, 3, False),
    "all-empty rows": ([0, 0, 0], 16, 4, 3, False),
    "T=1 timestamp lane alone": ([9, 0, 12, 1], 12, 1, 0, False),
    "T=1 drift trait, no timestamps": ([9, 0, 12, 1], 12, 1, None, False),
    "T=3": ([9, 0, 12, 11], 12, 3, 1, False),
    "T=5 with a float32 lane": ([9, 3, 12, 0], 12, 5, 0, True),
    "T=8, two 16-byte words": ([20, 7, 0, 19], 20, 8, 5, False),
}


@pytest.mark.parametrize("ts0", [0, 3_000_000_000])
@pytest.mark.parametrize("name", list(DENSIFY_BOUNDARIES))
def test_fused_densify_boundary_shapes_parity(name, ts0):
    """Each boundary shape of the card kernel, through the port's plain
    version and the reference's Pallas kernel (interpret mode): the int32
    block equals the reference's, every lane equals the host's exactly
    (timestamps as exact int64, above 2^31 included)."""
    lens, seq_len, t, ts_at, float_lane = DENSIFY_BOUNDARIES[name]
    rng = np.random.default_rng(len(name) + t)
    vals, offs = _lanes(rng, lens, t, ts_at, ts0, float_lane)
    got, host = _assert_parity(vals, offs, seq_len, with_ts=ts_at is not None)
    for k in host:
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      host[k].view(np.uint8), err_msg=k)
