"""The port's coarse scans K1/K2/K3 against the JAX package's Pallas kernels.

Both sides get the same numpy inputs. The JAX kernels run in interpret mode
on the CPU (as tests/test_pallas_scan.py runs them); the port's wrappers
take their plain PyTorch versions because the tensors lie on the CPU. The
hand-written CUDA kernels are compared with the plain versions on the card
by tests/test_torch_cuda.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valkey_search_tpu.ops import pallas_scan as ps
from valkey_search_tpu_torch.ops import bucket_scan as bs
from valkey_search_tpu_torch.runtime.device import set_device


@pytest.fixture(autouse=True)
def _cpu():
    set_device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.mark.parametrize("d", [128, 256, 512, 768])
@pytest.mark.parametrize("span", [1, 2, 4, 8])
def test_i8_packed_layout_matches(d, span):
    assert bs.i8_packed_layout(d, span) == ps.i8_packed_layout(d, span)
    assert bs.chunk_bits(span) == (span * (ps.GROUP // ps.BUCKET) - 1).bit_length()


def test_chunk_rows_match_the_tpu_layout():
    # the JAX chunk rows for one 16384-row group, block by block
    want = np.asarray(ps._chunk_rows(512, 32)).reshape(-1)
    got = bs.chunk_of_rows(2 * ps.GROUP).numpy()
    np.testing.assert_array_equal(got[:ps.GROUP], want)
    np.testing.assert_array_equal(got[ps.GROUP:], want)


def _masks(rng, n):
    invalid = rng.random(n) < 0.05
    allowed = rng.random(n) < 0.9
    return invalid, allowed


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("span", [1, 4])
def test_make_bias_i8_packed_bit_identical(rng, metric, span):
    n, d_pad = 3000, 128
    corpus_sq = (rng.random(n) * 4e6).astype(np.float32)
    inv_two = np.float32(1.0) / (np.float32(2.0) * np.float32(0.731)
                                 * np.float32(0.0123))
    invalid, allowed = _masks(rng, n)
    want = ps.make_bias_i8_packed(
        n, d_pad, span, metric, jnp.asarray(corpus_sq), jnp.asarray(inv_two),
        jnp.asarray(invalid), jnp.asarray(allowed))
    got = bs.make_bias_i8_packed(
        n, d_pad, span, metric, _t(corpus_sq), torch.tensor(inv_two),
        _t(invalid), _t(allowed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_make_bias_bit_identical(rng, metric):
    n = 3000
    corpus_sq = (rng.random(n) * 100).astype(np.float32)
    invalid, allowed = _masks(rng, n)
    want = ps.make_bias(n, metric, jnp.asarray(corpus_sq),
                        jnp.asarray(invalid), jnp.asarray(allowed))
    got = bs.make_bias(n, metric, _t(corpus_sq), _t(invalid), _t(allowed))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])


def _i8_case(rng, b, n, d, span, n_rows):
    q = rng.integers(-127, 128, (b, d)).astype(np.int8)
    c = np.zeros((n, d), np.int8)
    c[:n_rows] = rng.integers(-127, 128, (n_rows, d)).astype(np.int8)
    dotmax, clamp, sentinel, _, _ = ps.i8_packed_layout(d, span)
    bias = rng.integers(0, clamp, n).astype(np.int32) + dotmax
    bias[rng.random(n) < 0.05] = sentinel  # invalid / filtered rows
    bias[n_rows:] = sentinel               # padding
    bias[: span * ps.GROUP : 128] = sentinel  # lane 0 of group 0: all excluded
    return q, c, bias


@pytest.mark.parametrize("span", [1, 2, 4])
def test_k1_plain_bit_identical_to_pallas(rng, span):
    b, n, d = 8, 4 * ps.GROUP, 128
    n_rows = n - 777
    q, c, bias = _i8_case(rng, b, n, d, span, n_rows)
    want = ps.bucket_min_scan_i8_packed(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(bias)[None], span=span,
        block_b=8, interpret=True)
    # the port reads only the real rows; the bias carries the padding
    got = bs.bucket_min_scan_i8_packed(_t(q), _t(c[:n_rows]), _t(bias), span)
    assert got.shape == (b, n // (128 * span)) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, _, _, pre_shift, invalid_thresh = bs.i8_packed_layout(d, span)
    # the all-SENTINEL lane decodes to an excluded score
    score = (got.numpy()[:, 0] >> bs.chunk_bits(span)) << pre_shift
    assert (score > invalid_thresh).all()


def _pad128(x):
    """x zero-padded to a multiple of 128 columns, as the Pallas kernels
    take it: zero columns add nothing to an integer dot."""
    out = np.zeros((x.shape[0], bs.round_up(x.shape[1], 128)), x.dtype)
    out[:, :x.shape[1]] = x
    return out


@pytest.mark.parametrize("span", [1, 8])
def test_k1_plain_one_query_mostly_excluded_matches_pallas(rng, span):
    """B = 1 with 99% of the rows excluded, as a hybrid request runs K1:
    most buckets hold no qualified row and keep a SENTINEL score."""
    n, d = span * ps.GROUP, 128
    n_rows = n - 300
    q, c, bias = _i8_case(rng, 1, n, d, span, n_rows)
    _, _, sentinel, _, invalid_thresh = ps.i8_packed_layout(d, span)
    bias[rng.random(n) >= 0.01] = sentinel
    want = ps.bucket_min_scan_i8_packed(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(bias)[None], span=span,
        block_b=1, interpret=True)
    got = bs.bucket_min_scan_i8_packed(_t(q), _t(c[:n_rows]), _t(bias), span)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, _, _, pre_shift, _ = bs.i8_packed_layout(d, span)
    score = (got.numpy() >> bs.chunk_bits(span)) << pre_shift
    # span 1: a bucket of 128 rows keeps none ~28% of the time; span 8's
    # 1,024-row buckets almost always keep one (lane 0 never does)
    assert (score > invalid_thresh).mean() > (0.2 if span == 1 else 0.0)


@pytest.mark.parametrize("span", [1, 8])
def test_k1_plain_at_d48_matches_pallas(rng, span):
    """d 48 (not a multiple of 128): the port's plain version at d 48
    against the Pallas kernel on the inputs zero-padded to 128 columns; both
    take the layout constants from d padded to 128."""
    b, n, d = 5, span * ps.GROUP, 48
    n_rows = n - 999
    q, c, bias = _i8_case(rng, b, n, 128, span, n_rows)
    q, c = q[:, :d], c[:, :d]
    want = ps.bucket_min_scan_i8_packed(
        jnp.asarray(_pad128(q)), jnp.asarray(_pad128(c)),
        jnp.asarray(bias)[None], span=span, block_b=b, interpret=True)
    got = bs.bucket_min_scan_i8_packed(_t(q), _t(c[:n_rows]), _t(bias), span)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", [16, 128, 768])
def test_k1_query_tile(d):
    """BQ is a multiple of 8 in [8, 128] and its shared memory fits; it
    covers min(B, 128) wherever that fits, which at int8 is every d up to
    well past 768 (the query tile at d 768 and BQ 128 is 96 KiB)."""
    for b in range(1, 20001):
        bq = bs.k1_query_tile(b, d)
        assert bq % 8 == 0 and 8 <= bq <= 128
        assert bs.k1_smem_bytes(bq, d) <= bs.K1_MAX_SMEM
        want = min(bs.round_up(b, 8), 128)
        if bs.k1_smem_bytes(want, d) <= bs.K1_MAX_SMEM:
            assert bq == want >= min(b, 128)
        else:
            assert bq < want
            assert bs.k1_smem_bytes(bq + 8, d) > bs.K1_MAX_SMEM
    assert bs.k1_query_tile(1, d) == 8
    assert bs.k1_query_tile(20000, d) == 128
    # the kernel's layout: 1024 alignment + 4 x 16 KiB ring + d/128 boxes
    # of BQ rows x 128 bytes + 4 x 512 bytes of bias + 9 barriers
    assert bs.k1_smem_bytes(128, 768) == 1024 + 65536 + 6 * 16384 + 2048 + 72


def test_k1_query_tile_bounds_d():
    top = bs.k1_max_dim()
    assert top % 16 == 0 and top >= 16384
    assert bs.k1_query_tile(1, top) == 8
    assert bs.k1_query_tile(1000, top) < 128  # a wide d shrinks the tile
    with pytest.raises(ValueError):
        bs.k1_query_tile(1, top + 16)


@pytest.mark.parametrize("span", [1, 2, 4, 8, 16])
def test_k1_layouts_keep_pre_shift_within_chunk_bits(span):
    """The CUDA int8 scans build the key as ((bias - dot) << (chunk_bits -
    pre_shift)) with the low chunk_bits cleared, which needs pre_shift <=
    chunk_bits: true of K1's and K3's layouts for every d they take."""
    for d in range(128, bs.k1_max_dim() + 128, 128):
        assert bs.i8_packed_layout(d, span)[3] <= bs.chunk_bits(span)
        assert bs.i8_layout(d)[2] <= 7


@pytest.mark.parametrize("d,span", [(128, 1), (128, 8), (768, 8), (768, 1),
                                    (4096, 4)])
def test_k1_kernel_key_arithmetic_matches_the_shifts(rng, d, span):
    """The kernel's epilogue (csrc/bucket_scan_i8_packed.cu Epilogue):
    ((b * mult - dot * mult) & high) | m in uint32, mult = 2^(chunk_bits -
    pre_shift), equals K1's (((b - dot) >> pre_shift) << chunk_bits) | m and
    K3's (signed scores) bit for bit, over the scores these layouts give."""
    dotmax, _, sentinel, pre_shift, _ = bs.i8_packed_layout(d, span)
    cb = bs.chunk_bits(span)
    for ps, lo in ((pre_shift, 0), (bs.i8_layout(d)[2], -dotmax)):
        if span != 1 and lo < 0:
            continue  # K3 runs at span 1 only
        bias = rng.integers(lo + dotmax, sentinel + 1, 4000, dtype=np.int64)
        dot = rng.integers(-dotmax, dotmax + 1, 4000, dtype=np.int64)
        m = rng.integers(0, span * 128, 4000, dtype=np.int64)
        want = ((((bias - dot) >> ps) << cb) | m) & 0xFFFFFFFF
        mult = 1 << (cb - ps)
        high = ~((1 << cb) - 1) & 0xFFFFFFFF
        t = (bias * mult + dot * ((-mult) & 0xFFFFFFFF)) & 0xFFFFFFFF
        np.testing.assert_array_equal((t & high) | m, want)


@pytest.mark.parametrize("positive", [True, False])
def test_k2_plain_matches_pallas(rng, positive):
    b, n, d = 16, 2 * ps.GROUP, 128
    n_rows = n - 300
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = np.zeros((n, d), np.float32)
    c[:n_rows] = rng.standard_normal((n_rows, d))
    q_lp = np.asarray(jnp.asarray((-2.0 if positive else -1.0) * q,
                                  jnp.bfloat16).astype(jnp.float32))
    c_lp = np.asarray(jnp.asarray(c, jnp.bfloat16).astype(jnp.float32))
    qsq = (q ** 2).sum(1).astype(np.float32) if positive \
        else np.zeros(b, np.float32)
    bias = (c ** 2).sum(1).astype(np.float32) if positive \
        else np.zeros(n, np.float32)
    bias[rng.random(n) < 0.05] = np.inf
    bias[n_rows:] = np.inf
    vals, idx = ps.bucket_min_scan(
        jnp.asarray(q_lp, jnp.bfloat16), jnp.asarray(qsq)[:, None],
        jnp.asarray(c_lp, jnp.bfloat16), jnp.asarray(bias)[None],
        positive=positive, block_b=8, interpret=True)
    gv, gi = bs.bucket_min_scan(
        _t(q_lp).to(torch.bfloat16), _t(qsq),
        _t(c_lp[:n_rows]).to(torch.bfloat16), _t(bias), positive)
    vals, idx = np.asarray(vals), np.asarray(idx)
    agree = gi.numpy() == idx
    assert agree.mean() >= 0.99
    np.testing.assert_allclose(gv.numpy()[agree], vals[agree],
                               rtol=4e-5, atol=1e-2)


@pytest.mark.parametrize("positive", [True, False])
def test_k2_plain_matches_pallas_one_query_mostly_excluded(rng, positive):
    """B = 1 with 99% of the rows excluded, as a hybrid request runs K2:
    most buckets hold no qualified row and decode to +inf at their lowest
    chunk on both sides."""
    n, d = 2 * ps.GROUP, 128
    n_rows = n - 300
    q = rng.standard_normal((1, d)).astype(np.float32)
    c = np.zeros((n, d), np.float32)
    c[:n_rows] = rng.standard_normal((n_rows, d))
    q_lp = np.asarray(jnp.asarray((-2.0 if positive else -1.0) * q,
                                  jnp.bfloat16).astype(jnp.float32))
    c_lp = np.asarray(jnp.asarray(c, jnp.bfloat16).astype(jnp.float32))
    qsq = (q ** 2).sum(1).astype(np.float32) if positive \
        else np.zeros(1, np.float32)
    bias = (c ** 2).sum(1).astype(np.float32) if positive \
        else np.zeros(n, np.float32)
    bias[rng.random(n) >= 0.01] = np.inf
    bias[n_rows:] = np.inf
    vals, idx = ps.bucket_min_scan(
        jnp.asarray(q_lp, jnp.bfloat16), jnp.asarray(qsq)[:, None],
        jnp.asarray(c_lp, jnp.bfloat16), jnp.asarray(bias)[None],
        positive=positive, block_b=1, interpret=True)
    gv, gi = bs.bucket_min_scan(
        _t(q_lp).to(torch.bfloat16), _t(qsq),
        _t(c_lp[:n_rows]).to(torch.bfloat16), _t(bias), positive)
    vals, idx = np.asarray(vals), np.asarray(idx)
    dead = np.isinf(vals)
    assert dead.mean() > 0.2  # most buckets are empty under a 1% filter
    agree = gi.numpy() == idx
    assert agree.mean() >= 0.99
    np.testing.assert_array_equal(np.isinf(gv.numpy()), dead)
    np.testing.assert_allclose(gv.numpy()[agree & ~dead], vals[agree & ~dead],
                               rtol=4e-5, atol=1e-2)
    lowest = (np.arange(n // 128) // 128) * ps.GROUP + np.arange(n // 128) % 128
    np.testing.assert_array_equal(gi.numpy()[dead], np.broadcast_to(
        lowest, dead.shape)[dead])


@pytest.mark.parametrize("positive", [True, False])
def test_k2_plain_at_d48_matches_reference(rng, positive):
    """d 48 (not a multiple of 128, so no Pallas run): the plain version
    against the JAX oracle, which returns unquantized vals and the argmin."""
    b, n, d = 5, 2 * ps.GROUP, 48
    n_rows = n - 999
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = np.zeros((n, d), np.float32)
    c[:n_rows] = rng.standard_normal((n_rows, d))
    q_lp = jnp.asarray((-2.0 if positive else -1.0) * q, jnp.bfloat16)
    c_lp = jnp.asarray(c, jnp.bfloat16)
    qsq = (q ** 2).sum(1).astype(np.float32) if positive \
        else np.zeros(b, np.float32)
    bias = (c ** 2).sum(1).astype(np.float32) if positive \
        else np.zeros(n, np.float32)
    bias[rng.random(n) < 0.05] = np.inf
    bias[n_rows:] = np.inf
    rv, ri = ps.bucket_min_scan_reference(
        q_lp, jnp.asarray(qsq)[:, None], c_lp, jnp.asarray(bias)[None])
    gv, gi = bs.bucket_min_scan(
        _t(np.asarray(q_lp.astype(jnp.float32))).to(torch.bfloat16), _t(qsq),
        _t(np.asarray(c_lp.astype(jnp.float32))[:n_rows]).to(torch.bfloat16),
        _t(bias), positive)
    rv, ri = np.asarray(rv), np.asarray(ri)
    agree = gi.numpy() == ri
    assert agree.mean() >= 0.99
    np.testing.assert_allclose(gv.numpy()[agree], rv[agree],
                               rtol=4e-5, atol=1e-2)


@pytest.mark.parametrize("d", [8, 128, 768])
def test_k2_query_tile(d):
    """BQ is a multiple of 8 in [8, 128] and its shared memory fits; it
    covers min(B, 128) wherever that fits, and otherwise is the widest tile
    that does (104 at d 768)."""
    for b in range(1, 20001):
        bq = bs.k2_query_tile(b, d)
        assert bq % 8 == 0 and 8 <= bq <= 128
        assert bs.k2_smem_bytes(bq, d) <= bs.K2_MAX_SMEM
        want = min(bs.round_up(b, 8), 128)
        if bs.k2_smem_bytes(want, d) <= bs.K2_MAX_SMEM:
            assert bq == want >= min(b, 128)
        else:
            assert bq < want
            assert bs.k2_smem_bytes(bq + 8, d) > bs.K2_MAX_SMEM
    assert bs.k2_query_tile(1, d) == 8
    assert bs.k2_query_tile(20000, d) == (104 if d == 768 else 128)


def test_k2_query_tile_bounds_d():
    top = bs.k2_max_dim()
    assert top % 8 == 0 and top >= 1800  # at least the earlier kernel's range
    assert bs.k2_query_tile(1, top) == 8
    with pytest.raises(ValueError):
        bs.k2_query_tile(1, top + 8)


def test_wrappers_reject_bad_arguments():
    q = torch.zeros((4, 128), dtype=torch.int8)
    c = torch.zeros((10, 128), dtype=torch.int8)
    with pytest.raises(ValueError):  # bias not a multiple of span * GROUP
        bs.bucket_min_scan_i8_packed(q, c, torch.zeros(100, dtype=torch.int32), 1)
    with pytest.raises(ValueError):  # wrong bias dtype
        bs.bucket_min_scan_i8_packed(q, c, torch.zeros(ps.GROUP), 1)
    with pytest.raises(ValueError):  # corpus longer than the bias
        bs.bucket_min_scan(
            q.to(torch.bfloat16), torch.zeros(4),
            torch.zeros((ps.GROUP + 1, 128), dtype=torch.bfloat16),
            torch.zeros(ps.GROUP), True)
    with pytest.raises(ValueError):  # qsq shape
        bs.bucket_min_scan(
            q.to(torch.bfloat16), torch.zeros(3), c.to(torch.bfloat16),
            torch.zeros(ps.GROUP), True)


def test_cpu_wrapper_is_not_a_launch(rng):
    bs.reset_launches()
    q, c, bias = _i8_case(rng, 2, ps.GROUP, 128, 1, ps.GROUP)
    bs.bucket_min_scan_i8_packed(_t(q), _t(c), _t(bias), 1)
    assert sum(bs.launch_counts().values()) == 0


# -- K3: the int8 scan with (vals, idx) outputs -------------------------------


@pytest.mark.parametrize("d", [128, 256, 512, 768])
def test_i8_layout_matches(d):
    assert bs.i8_layout(d) == ps.i8_layout(d)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_make_bias_i8_bit_identical(rng, metric):
    n, d_pad = 3000, 768
    corpus_sq = (rng.random(n) * 4e6).astype(np.float32)
    inv_two = np.float32(1.0) / (np.float32(2.0) * np.float32(0.731)
                                 * np.float32(0.0123))
    invalid, allowed = _masks(rng, n)
    want = ps.make_bias_i8(
        n, d_pad, metric, jnp.asarray(corpus_sq), jnp.asarray(inv_two),
        jnp.asarray(invalid), jnp.asarray(allowed))
    got = bs.make_bias_i8(
        n, d_pad, metric, _t(corpus_sq), torch.tensor(inv_two),
        _t(invalid), _t(allowed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])


def _k3_case(rng, b, n, d, n_rows):
    q = rng.integers(-127, 128, (b, d)).astype(np.int8)
    c = np.zeros((n, d), np.int8)
    c[:n_rows] = rng.integers(-127, 128, (n_rows, d)).astype(np.int8)
    clamp, sentinel, _, _ = ps.i8_layout(d)
    # small biases make many scores negative (no +DOTMAX offset in K3)
    bias = rng.integers(0, clamp // 64, n).astype(np.int32)
    bias[rng.random(n) < 0.05] = sentinel  # invalid / filtered rows
    bias[n_rows:] = sentinel               # padding
    bias[: ps.GROUP : 128] = sentinel      # lane 0 of group 0: all excluded
    return q, c, bias


@pytest.mark.parametrize("groups,d", [(1, 128), (2, 128), (1, 768), (2, 768)])
def test_k3_plain_bit_identical_to_pallas(rng, groups, d):
    b, n = 16, groups * ps.GROUP
    n_rows = n - 555
    q, c, bias = _k3_case(rng, b, n, d, n_rows)
    jq, jc, jb = jnp.asarray(q), jnp.asarray(c), jnp.asarray(bias)[None]
    kv, ki = ps.bucket_min_scan_i8(jq, jc, jb, block_b=16, interpret=True)
    rv, ri = ps.bucket_min_scan_i8_reference(jq, jc, jb)
    # the port reads only the real rows; the bias carries the padding
    gv, gi = bs.bucket_min_scan_i8(_t(q), _t(c[:n_rows]), _t(bias))
    assert gv.shape == gi.shape == (b, n // 128)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    for vals, idx in ((kv, ki), (rv, ri)):
        np.testing.assert_array_equal(gv.numpy().view(np.int32),
                                      np.asarray(vals).view(np.int32))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(idx))
    assert (gv.numpy() < 0).any()  # negative scores were exercised
    _, _, _, invalid_thresh = bs.i8_layout(d)
    assert (gv.numpy()[:, 0] > invalid_thresh).all()  # the all-SENTINEL lane


def test_k3_plain_one_query_mostly_excluded_matches_pallas(rng):
    n, d = 2 * ps.GROUP, 128
    n_rows = n - 555
    q, c, bias = _k3_case(rng, 1, n, d, n_rows)
    _, sentinel, _, invalid_thresh = ps.i8_layout(d)
    bias[rng.random(n) >= 0.01] = sentinel
    kv, ki = ps.bucket_min_scan_i8(jnp.asarray(q), jnp.asarray(c),
                                   jnp.asarray(bias)[None], block_b=1,
                                   interpret=True)
    gv, gi = bs.bucket_min_scan_i8(_t(q), _t(c[:n_rows]), _t(bias))
    np.testing.assert_array_equal(gv.numpy().view(np.int32),
                                  np.asarray(kv).view(np.int32))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ki))
    assert (gv.numpy() > invalid_thresh).mean() > 0.2


def test_k3_plain_at_d48_matches_pallas(rng):
    b, n, d = 5, 2 * ps.GROUP, 48
    n_rows = n - 999
    q, c, bias = _k3_case(rng, b, n, 128, n_rows)
    q, c = q[:, :d], c[:, :d]
    kv, ki = ps.bucket_min_scan_i8(jnp.asarray(_pad128(q)),
                                   jnp.asarray(_pad128(c)),
                                   jnp.asarray(bias)[None], block_b=b,
                                   interpret=True)
    gv, gi = bs.bucket_min_scan_i8(_t(q), _t(c[:n_rows]), _t(bias))
    np.testing.assert_array_equal(gv.numpy().view(np.int32),
                                  np.asarray(kv).view(np.int32))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ki))
    assert (gv.numpy() < 0).any()


def test_k3_wrapper_checks_and_counts(rng):
    q = torch.zeros((4, 128), dtype=torch.int8)
    c = torch.zeros((10, 128), dtype=torch.int8)
    with pytest.raises(ValueError):  # bias not a multiple of GROUP
        bs.bucket_min_scan_i8(q, c, torch.zeros(100, dtype=torch.int32))
    with pytest.raises(ValueError):  # wrong bias dtype
        bs.bucket_min_scan_i8(q, c, torch.zeros(ps.GROUP))
    bs.reset_launches()
    q, c, bias = _k3_case(rng, 2, ps.GROUP, 128, ps.GROUP)
    bs.bucket_min_scan_i8(_t(q), _t(c), _t(bias))
    assert bs.launch_counts()["bucket_scan_i8"] == 0  # CPU: plain version


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header changes every source's library name, so
    the kernels rebuild (ops/_build.py)."""
    from valkey_search_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = _build._digest(str(tmp_path / "k.cu"))
    assert _build._digest(str(tmp_path / "k.cu")) == before
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build._digest(str(tmp_path / "k.cu")) != before
    # the port's real sources hash their headers too
    monkeypatch.undo()
    assert any(name.endswith(".cuh") for name in os.listdir(_build.CSRC_DIR))
