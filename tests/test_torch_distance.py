"""Parity of the port's NN search (tpusfm_torch.kernels.distance) with
tpusfm's XLA path and its Pallas kernel (interpret mode) on CPU. The CUDA
kernel is held against its plain version in test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpusfm.kernels import distance as jd
from tpusfm_torch.kernels import distance as td

torch.set_num_threads(2)

BIG = 1e30


def _close(got, ref):
    """idx equal; best and second within rtol 1e-5, atol 1e-4."""
    gi, gb, gs = (np.asarray(a) for a in got)
    ri, rb, rs = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gb, rb, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gs, rs, rtol=1e-5, atol=1e-4)


def _f32_case(seed=1, nq=256, ndb=512, d=128):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    db = rng.normal(size=(ndb, d)).astype(np.float32)
    mask = np.ones(ndb, np.float32)
    mask[400:] = 0.0
    mask[::7] = 0.0
    return q, db, mask


def _torch(q, db, mask, **kw):
    return td.nn_search_torch(torch.from_numpy(q), torch.from_numpy(db),
                              torch.from_numpy(mask), **kw)


def test_nn_search_torch_matches_xla_f32_masked():
    q, db, mask = _f32_case(nq=100, ndb=300, d=37)
    ref = jd.nn_search_xla(jnp.array(q), jnp.array(db), jnp.array(mask), block=64)
    _close(_torch(q, db, mask, block=64), ref)


def test_nn_search_torch_matches_pallas_interpret_f32_masked():
    q, db, mask = _f32_case()
    with pltpu.force_tpu_interpret_mode():
        ref = jd.nn_search_pallas(jnp.array(q), jnp.array(db), jnp.array(mask))
    _close(_torch(q, db, mask), ref)


@pytest.mark.parametrize("ref_path", ["xla", "pallas"])
def test_nn_search_torch_all_masked(ref_path):
    q, db, _ = _f32_case()
    mask = np.zeros(db.shape[0], np.float32)
    if ref_path == "xla":
        ref = jd.nn_search_xla(jnp.array(q), jnp.array(db), jnp.array(mask))
    else:
        with pltpu.force_tpu_interpret_mode():
            ref = jd.nn_search_pallas(jnp.array(q), jnp.array(db), jnp.array(mask))
    got = _torch(q, db, mask)
    assert (got[0].numpy() == -1).all()
    assert (got[1].numpy() == np.float32(BIG)).all() and (got[2].numpy() == np.float32(BIG)).all()
    _close(got, ref)


@pytest.mark.parametrize("ref_path", ["xla", "pallas"])
def test_nn_search_torch_hamming_exact(ref_path):
    rng = np.random.default_rng(2)
    q = rng.integers(0, 2**32, size=(256, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, size=(384, 8), dtype=np.uint32)
    mask = np.ones(384, np.float32)
    if ref_path == "xla":
        ri, rb, rs = jd.nn_search_xla(jnp.array(q), jnp.array(db), jnp.array(mask), metric="hamming")
    else:
        with pltpu.force_tpu_interpret_mode():
            ri, rb, rs = jd.nn_search_pallas(jnp.array(q), jnp.array(db), jnp.array(mask),
                                             metric="hamming")
    gi, gb, gs = td.nn_search_torch(torch.from_numpy(q), torch.from_numpy(db), metric="hamming")
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    # integer distances tie often: indices are compared where the best is unique
    unique = np.asarray(rb) < np.asarray(rs)
    np.testing.assert_array_equal(gi.numpy()[unique], np.asarray(ri)[unique])
    pop = np.vectorize(lambda x: bin(int(x)).count("1"))
    full = pop(q[:, None, :] ^ db[None, :, :]).sum(-1)
    np.testing.assert_array_equal(gi.numpy(), full.argmin(1))  # lowest index of the ties


def test_nn_search_torch_matches_xla_bf16():
    q, db, mask = _f32_case(seed=3, nq=120, ndb=260, d=64)
    qb, dbb = jnp.array(q, jnp.bfloat16), jnp.array(db, jnp.bfloat16)
    ref = jd.nn_search_xla(qb, dbb, jnp.array(mask))
    got = td.nn_search_torch(torch.from_numpy(q).bfloat16(), torch.from_numpy(db).bfloat16(),
                             torch.from_numpy(mask))
    _close(got, ref)


def test_nn_search_torch_duplicates_take_lowest_index():
    q, db, _ = _f32_case(seed=4, nq=16, ndb=300, d=32)
    db[150] = db[40]
    db[299] = db[40]
    q[:4] = db[40] + 1e-3
    mask = np.ones(300, np.float32)
    ref = jd.nn_search_xla(jnp.array(q), jnp.array(db), jnp.array(mask), block=128)
    got = _torch(q, db, mask, block=128)
    assert (got[0].numpy()[:4] == 40).all()
    np.testing.assert_allclose(got[1].numpy()[:4], got[2].numpy()[:4], rtol=1e-6)
    _close(got, ref)


def test_unpack_bits_matches_tpusfm():
    x = np.random.default_rng(5).integers(0, 2**32, size=(6, 8), dtype=np.uint32)
    ref = np.asarray(jd.unpack_bits(jnp.array(x)), np.float32)
    got = td.unpack_bits(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_nn_search_batch_axis_equals_per_pair():
    q, db, mask = _f32_case(seed=6, nq=50, ndb=90, d=20)
    q2, db2, mask2 = _f32_case(seed=7, nq=50, ndb=90, d=20)
    mask2[:30] = 0.0
    got = td.nn_search(torch.from_numpy(np.stack([q, q2])), torch.from_numpy(np.stack([db, db2])),
                       torch.from_numpy(np.stack([mask, mask2])))
    for b, args in enumerate(((q, db, mask), (q2, db2, mask2))):
        one = _torch(*args)
        for x, y in zip(got, one):
            torch.testing.assert_close(x[b], y)


def test_nn_search_dispatch_stays_on_cpu_without_launch():
    q, db, mask = _f32_case(seed=8, nq=10, ndb=20, d=8)
    before = td.launches
    got = td.nn_search(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(mask))
    assert td.launches == before
    _close(got, _torch(q, db, mask))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        td.nn_search_cuda(torch.from_numpy(q), torch.from_numpy(db))


def test_split_tf32_rounds_to_nearest_and_keeps_22_bits():
    """hi = rna(x) to TF32 (low 13 mantissa bits zero), lo = rna(x - hi):
    |x - hi - lo| <= 2^-21 |x|; ties round away from zero, as cvt.rna."""
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.normal(size=4096), rng.uniform(-1e3, 1e3, 4096),
                        rng.choice([-1.0, 1.0], 4096) * 10.0 ** rng.uniform(-30, 30, 4096)])
    x = x.astype(np.float32)
    hi, lo = td.split_tf32(torch.from_numpy(x))
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    x64, hi64, lo64 = x.astype(np.float64), hi.double().numpy(), lo.double().numpy()
    assert (np.abs(x64 - hi64) <= 2.0 ** -11 * np.abs(x64)).all()
    assert (np.abs(x64 - hi64 - lo64) <= 2.0 ** -21 * np.abs(x64)).all()
    halfway = torch.tensor([0x3F801000, -0x407FF000, 0x3F800FFF], dtype=torch.int32)
    got = td.split_tf32(halfway.view(torch.float32))[0].view(torch.int32)
    assert got.tolist() == [0x3F802000, -0x407FE000, 0x3F800000]


def _sift_rows(rng, *shape):
    x = np.abs(rng.normal(size=shape)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x = np.minimum(x, 0.2)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case", ["sift_2x2000x2000x128", "normal_f32_case"])
def test_3xtf32_distances_match_float64(case):
    """The CUDA kernel's f32 scheme, here in f32 on the CPU: hi.hi^T +
    hi.lo^T + lo.hi^T (small terms first) in the kernel's epilogue form gives
    best and second within rtol 1e-5, atol 1e-4 of float64 distances, and
    the same idx wherever the float64 gap is clear."""
    if case.startswith("sift"):
        rng = np.random.default_rng(10)
        q, db = _sift_rows(rng, 2, 2000, 128), _sift_rows(rng, 2, 2000, 128)
        mask = (rng.random((2, 2000)) > 0.1).astype(np.float32)
    else:
        q, db, mask = (a[None] for a in _f32_case())
    (qh, ql), (dh, dl) = td.split_tf32(torch.from_numpy(q)), td.split_tf32(torch.from_numpy(db))
    t = lambda a: a.transpose(-1, -2)
    cross = (qh @ t(dl) + ql @ t(dh)) + qh @ t(dh)
    qn = (torch.from_numpy(q) ** 2).sum(-1)
    pen = torch.where(torch.from_numpy(mask) != 0, (torch.from_numpy(db) ** 2).sum(-1), np.inf)
    dist = torch.clamp(qn[..., None] + pen[..., None, :] - 2.0 * cross, min=0.0)
    two = torch.topk(dist, 2, dim=-1, largest=False)
    idx, best, second = torch.argmin(dist, -1).numpy(), two.values[..., 0], two.values[..., 1]

    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    d64 = ((q64 ** 2).sum(-1)[..., None] + (db64 ** 2).sum(-1)[..., None, :]
           - 2.0 * q64 @ np.swapaxes(db64, -1, -2))
    d64 = np.where(mask[..., None, :] != 0, d64, np.inf)
    ref = np.sort(d64, -1)[..., :2]
    np.testing.assert_allclose(best.numpy(), ref[..., 0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(second.numpy(), ref[..., 1], rtol=1e-5, atol=1e-4)
    clear = ref[..., 1] - ref[..., 0] > 1e-4
    np.testing.assert_array_equal(idx[clear], d64.argmin(-1)[clear])


def _words_case(kind, words, B=3, nq=24, ndb=256, seed=11):
    """Random packed words (B, nq, words) and (B, ndb, words) with a 20%
    mask, then by kind: "ties" puts copies of query 0's row at db rows 127,
    128 and 255 (127 masked: 128 must win, at distance 0, second 0);
    "all_masked"; "one_valid" (only row ndb // 2 valid: second 1e30)."""
    rng = np.random.default_rng(seed + words)
    q = rng.integers(0, 2**32, size=(B, nq, words), dtype=np.uint32)
    db = rng.integers(0, 2**32, size=(B, ndb, words), dtype=np.uint32)
    mask = (rng.random((B, ndb)) > 0.2).astype(np.float32)
    if kind == "ties":
        db[:, [127, 128, 255]] = q[:, :1]
        mask[:, [128, 255]] = 1.0
        mask[:, 127] = 0.0
    elif kind == "all_masked":
        mask[:] = 0.0
    elif kind == "one_valid":
        mask[:] = 0.0
        mask[:, ndb // 2] = 1.0
    return q, db, mask


@pytest.mark.parametrize("kind", ["masked", "ties", "all_masked", "one_valid"])
@pytest.mark.parametrize("words", [1, 3, 8, 16])
def test_hamming_top2_keys_matches_plain_and_tpusfm(words, kind):
    """The kernel's integer epilogue (s32 dot, packed (distance, index)
    keys, a top-2 on keys, decode) in its plain version: bit-equal to
    nn_search_torch(metric="hamming") and to tpusfm's nn_search_xla (lowest
    index of the ties), and to nn_search_pallas in interpret mode in the
    distances (its indices where the best is unique)."""
    q, db, mask = _words_case(kind, words)
    qt, dbt, mt = torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(mask)
    got = td.hamming_top2_keys(td.unpack_bits(qt), td.unpack_bits(dbt), mt)
    plain = td.nn_search_torch(qt, dbt, mt, metric="hamming")
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    for b in range(q.shape[0]):
        args = (jnp.array(q[b]), jnp.array(db[b]), jnp.array(mask[b]))
        xi, xb, xs = jd.nn_search_xla(*args, metric="hamming")
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(xi))
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(xb))
        np.testing.assert_array_equal(got[2][b].numpy(), np.asarray(xs))
        with pltpu.force_tpu_interpret_mode():
            pi, pb, ps = jd.nn_search_pallas(*args, metric="hamming")
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(pb))
        np.testing.assert_array_equal(got[2][b].numpy(), np.asarray(ps))
        unique = np.asarray(pb) < np.asarray(ps)
        np.testing.assert_array_equal(got[0][b].numpy()[unique], np.asarray(pi)[unique])
    if kind == "ties":
        assert (got[0][:, 0] == 128).all() and (got[1][:, 0] == 0).all()
        assert (got[2][:, 0] == 0).all()
    elif kind == "all_masked":
        assert (got[0] == -1).all() and (got[1] == BIG).all() and (got[2] == BIG).all()
    elif kind == "one_valid":
        assert (got[0] == db.shape[1] // 2).all() and (got[2] == BIG).all()


@pytest.mark.parametrize("words", [1, 8, 16])
def test_hamming_top2_keys_64_bit_layout_equals_32_bit(words):
    """The 64-bit key layout (field above, column below) ranks and decodes
    as the 32-bit one on the same inputs, ties and masks included."""
    q, db, mask = _words_case("ties", words, B=2, nq=40, ndb=300, seed=12)
    args = (td.unpack_bits(torch.from_numpy(q)), td.unpack_bits(torch.from_numpy(db)),
            torch.from_numpy(mask))
    assert td.hamming_key_shift(words, 300) < 32
    narrow = td.hamming_top2_keys(*args)
    wide = td.hamming_top2_keys(*args, kshift=32)
    for n, w in zip(narrow, wide):
        assert torch.equal(n, w)


def test_hamming_key_shift_fits_field_and_index():
    """32-bit keys while the field (up to 64 W + 1) and the padded db's last
    index fit together, else 64-bit keys (shift 32)."""
    assert td.hamming_key_shift(8, 168_750) == 18       # the dense ORB cell
    assert td.hamming_key_shift(8, 500) == 9            # a sparse ORB cell
    assert td.hamming_key_shift(1, 1) == 7
    assert td.hamming_key_shift(8, 4_194_304) == 22     # 10 + 22 bits
    assert td.hamming_key_shift(8, 4_194_305) == 32
    assert td.hamming_key_shift(256, 140_000) == 32     # 15 + 18 bits
    for words in (1, 3, 8, 16, 64):
        for ndb in (1, 127, 129, 3000, 168_750, 2_000_000):
            s = td.hamming_key_shift(words, ndb)
            assert s == 32 or (64 * words + 1).bit_length() + s <= 32
            assert s == 32 or 2 ** s >= -(-ndb // 128) * 128
