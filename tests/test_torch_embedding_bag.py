"""The port's embedding_bag (plain version on the CPU; CUDA kernel on the card)
and late_materialize against the JAX reference (Pallas in interpret mode).

float32 bags agree within ``1e-6``: the port sums the bag in another order
than the interpreted kernel. bf16 within ``2e-2``: the reference kernel
accumulates in bf16, the port's plain version rounds each weighted row to
bf16 and sums in float32. The late_materialize traits are exact after the
reference's int32 wrap of timestamps (the port keeps them as exact int64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as jeb
from repro.kernels.fused import ops as jfu
from repro_torch.kernels.embedding_bag import ops as teb
from repro_torch.kernels.fused import ops as tfu

V, D = 97, 24


def _bag_case(rng, b, l, density=0.6, poison=False, masked_row=None,
              weights=False):
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, size=(b, l)).astype(np.int64)
    mask = rng.random((b, l)) < density
    if masked_row is not None:
        mask[masked_row] = False
    if poison:
        ids[~mask] = V + 1000                      # far past the table
        ids[mask.sum(1) < l, 0] = -7               # and below it
        ids[mask] = np.clip(ids[mask], 0, V - 1)
    if weights:
        mask = (mask * rng.random((b, l))).astype(np.float32)
    return table, ids, mask


def _both(table, ids, mask, combiner, dtype=np.float32):
    want = jeb.embedding_bag(jnp.asarray(table, dtype), jnp.asarray(ids),
                             jnp.asarray(mask), combiner)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    launches = teb.embedding_bag.launches
    got = teb.embedding_bag(torch.from_numpy(table).to(tdt),
                            torch.from_numpy(ids), torch.from_numpy(mask),
                            combiner)
    assert teb.embedding_bag.launches == launches    # CPU: plain version
    assert got.dtype == tdt and got.shape == (ids.shape[0], table.shape[1])
    return got.float().numpy(), np.asarray(want, np.float32)


CASES = {
    "dense": dict(b=6, l=9, density=1.0),
    "ragged": dict(b=7, l=13),
    "poisoned padded ids": dict(b=5, l=9, poison=True),
    "fully masked row": dict(b=5, l=9, masked_row=2, poison=True),
    "float weight mask": dict(b=4, l=11, weights=True),
    "one position": dict(b=3, l=1),
}


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("case", list(CASES))
def test_embedding_bag_matches_reference(case, combiner):
    rng = np.random.default_rng(len(case) * 7 + len(combiner))
    table, ids, mask = _bag_case(rng, **CASES[case])
    got, want = _both(table, ids, mask, combiner)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,l", [(0, 5), (4, 0), (0, 0)])
def test_embedding_bag_empty_matches_reference(b, l):
    rng = np.random.default_rng(b + 10 * l)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = np.zeros((b, l), np.int64)
    mask = np.ones((b, l), bool)
    for combiner in ("sum", "mean"):
        got, want = _both(table, ids, mask, combiner)
        assert got.shape == want.shape == (b, D)
        np.testing.assert_array_equal(got, want)


def test_embedding_bag_bf16_matches_reference():
    rng = np.random.default_rng(3)
    table, ids, mask = _bag_case(rng, 4, 6, density=1.0)
    got, want = _both(table, ids, mask, "sum", dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


# int64 ids the kernel reads in their own width: each keeps its low 32 bits
# as a signed int32 (ids.astype(int32) in the reference), then is clamped
WIDE_IDS = {2**32 + 5: 5, -(2**32) - 1: 0, 2**31 + 3: 0, -(2**31) - 5: V - 1,
            3 * 2**32 + V + 9: V - 1, 7: 7}


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("ids_dtype", [np.int64, np.int32])
def test_embedding_bag_ids_wrap_then_clamp(ids_dtype, combiner):
    """ids beyond +-2^31 wrap to int32 before the clamp, as the reference
    casts them; int32 ids past the table clamp."""
    rng = np.random.default_rng(ids_dtype(0).itemsize + len(combiner))
    table, ids, mask = _bag_case(rng, 6, 9, density=0.8)
    if ids_dtype == np.int64:
        ids[:, :len(WIDE_IDS)] = list(WIDE_IDS)
    else:
        ids[:, :3] = (V + 5, -3, 2**31 - 1)
    got, want = _both(table, ids.astype(ids_dtype), mask, combiner)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if ids_dtype == np.int64:
        for wide, row in WIDE_IDS.items():
            bag = teb.embedding_bag(torch.from_numpy(table),
                                    torch.tensor([[wide]]),
                                    torch.ones((1, 1), dtype=torch.bool))
            np.testing.assert_array_equal(bag[0].numpy(), table[row])


@pytest.mark.parametrize("l,counts,hits", [
    (300, [259, 300, 0], [1, 2, 3]),
    (2048, [1028, 1935, 2048, 259], [4, 8, 8, 1]),
])
def test_embedding_bag_bf16_mean_count_rounds(l, counts, hits):
    """A bool count above 256 rounds to bf16 before the mean divides (1028
    is 1024, 259 is 260), in the reference and the port alike. Each bag's
    numerator is exact (256 from each of ``hits`` positions), so the two
    agree exactly and give bf16(num / bf16(count)), where num / count would
    differ."""
    table = np.zeros((V, D), np.float32)
    table[1] = 256.0
    ids = np.zeros((len(counts), l), np.int64)
    mask = np.zeros((len(counts), l), bool)
    for b, (c, h) in enumerate(zip(counts, hits)):
        mask[b, l - c:] = True
        ids[b, l - h:] = 1
    got, want = _both(table, ids, mask, "mean", dtype=jnp.bfloat16)
    np.testing.assert_array_equal(got, want)
    num = torch.tensor([256.0 * h if c else 0.0
                        for c, h in zip(counts, hits)]).bfloat16().float()
    count = torch.tensor([max(c, 1) for c in counts], dtype=torch.float32)
    exact = (num / count.bfloat16().float()).bfloat16().float().numpy()
    np.testing.assert_array_equal(got[:, 0], exact)
    assert not np.array_equal(
        exact, (num / count).bfloat16().float().numpy())


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("mask_dtype", [np.float32, "bfloat16"])
def test_embedding_bag_float_mask_on_bf16_table(mask_dtype, combiner):
    """A float mask weighs a bf16 table's rows by the mask rounded to
    bf16, as the reference's ``mask.astype(table.dtype)``."""
    rng = np.random.default_rng(len(combiner) + 5)
    table, ids, mask = _bag_case(rng, 5, 11, weights=True)
    want = jeb.embedding_bag(jnp.asarray(table, jnp.bfloat16),
                             jnp.asarray(ids), jnp.asarray(mask), combiner)
    m = torch.from_numpy(mask)
    if mask_dtype == "bfloat16":
        m = m.to(torch.bfloat16)
    got = teb.embedding_bag(torch.from_numpy(table).to(torch.bfloat16),
                            torch.from_numpy(ids), m, combiner)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_embedding_bag_poisoned_ids_equal_benign_ids():
    """Poisoned lanes under mask 0 give the same bag as benign ones."""
    rng = np.random.default_rng(11)
    table, ids, mask = _bag_case(rng, 5, 9, masked_row=2)
    poisoned = ids.copy()
    poisoned[~mask] = V + 1000
    poisoned[0, ~mask[0]] = -7
    args = (torch.from_numpy(table), torch.from_numpy(mask))
    for combiner in ("sum", "mean"):
        a = teb.embedding_bag(args[0], torch.from_numpy(poisoned), args[1],
                              combiner)
        b = teb.embedding_bag(args[0], torch.from_numpy(ids), args[1],
                              combiner)
        assert torch.equal(a, b)
    assert not teb.embedding_bag(*args[:1], torch.from_numpy(poisoned),
                                 args[1]).numpy()[2].any()


def test_embedding_bag_rejects_an_unknown_combiner():
    t = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="combiner"):
        teb.embedding_bag(t, torch.zeros((1, 1), dtype=torch.int64),
                          torch.ones((1, 1), dtype=torch.bool), "max")


def test_kernel_source_is_in_the_package():
    src = teb.LIBRARY.source
    assert src.is_file() and src.suffix == ".cu"
    assert "embedding_bag_launch" in src.read_text()


def _history(rng, b, seq_len, ts0):
    """Flat clipped tails of b rows (lengths 0..seq_len) sharing offsets:
    int64 item ids, an int32 lane and absolute int64 timestamps."""
    lens = rng.integers(0, seq_len + 1, b)
    lens[:2] = (0, seq_len)
    offs = np.zeros(b + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    n = int(offs[-1])
    ts = np.concatenate([ts0 + np.sort(rng.integers(0, 10**8, int(k)))
                         for k in lens]).astype(np.int64)
    return {"item_id": rng.integers(0, V, n).astype(np.int64),
            "action": rng.integers(-3, 9, n).astype(np.int32),
            "timestamp": ts}, offs


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("ts0", [1_000, 3_000_000_000])
def test_late_materialize_matches_reference(combiner, ts0):
    rng = np.random.default_rng(ts0 % 97 + len(combiner))
    seq_len = 12
    vals, offs = _history(rng, 9, seq_len, ts0)
    table = rng.standard_normal((V, D)).astype(np.float32)
    kw = dict(ts_trait="timestamp", ids_trait="item_id", combiner=combiner)
    want = jfu.late_materialize(vals, offs, seq_len, table=table, **kw)
    before = (tfu.fused_densify.launches, teb.embedding_bag.launches)
    got = tfu.late_materialize(vals, offs, seq_len,
                               table=torch.from_numpy(table), device="cpu",
                               **kw)
    assert (tfu.fused_densify.launches, teb.embedding_bag.launches) == before
    np.testing.assert_array_equal(got["lens"].numpy(),
                                  np.asarray(want["lens"]))
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    assert list(got["traits"]) == list(want["traits"])
    for trait, w in want["traits"].items():
        g = got["traits"][trait].numpy()
        np.testing.assert_array_equal(g.astype(np.int32), np.asarray(w),
                                      err_msg=trait)
    # the port's timestamps are exact int64: the host values, right-aligned
    ts = got["traits"]["timestamp"].numpy()
    assert ts.dtype == np.int64
    lens = np.minimum(np.diff(offs), seq_len)
    for b in range(len(lens)):
        row = vals["timestamp"][offs[b + 1] - lens[b]:offs[b + 1]]
        np.testing.assert_array_equal(ts[b, seq_len - lens[b]:], row)
        assert not ts[b, :seq_len - lens[b]].any()
    np.testing.assert_allclose(got["pooled"].numpy(),
                               np.asarray(want["pooled"]), rtol=1e-6,
                               atol=1e-6)


def test_late_materialize_without_table_returns_no_bag():
    rng = np.random.default_rng(5)
    vals, offs = _history(rng, 4, 8, 0)
    out = tfu.late_materialize(vals, offs, 8, ts_trait="timestamp",
                               device="cpu")
    assert set(out) == {"lens", "mask", "traits"}
