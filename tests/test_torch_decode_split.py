"""The split-KV schedule of ``csrc/decode_attention.cu`` on the CPU: a plain
PyTorch emulation of how the kernel walks and folds the keys, held within
5e-6 (fp32) to the port's plain version (``ref.decode_attention``) and to
the JAX package's ``ops.decode_attention`` (its compiler route, Pallas in
interpret mode), on seeded numpy inputs.

The emulation follows the kernel: a (kv head, batch row) pair's 64-key
tiles are cut into ``splits(...)`` runs of whole tiles; each split's block
has eight warps, each of which keeps its own online-softmax state over 8
keys of every tile (scores in base 2), in steps of 16 / NI keys; a split
that starts past ``pos`` contributes an empty partial (m = NEG_INF, l =
0); the block folds its warps in warp order and the cluster folds the
splits in split order.  Transactions of 1, 2 or 4 tiles (the pump's mode
T) only group the walk, so they give identical bits.  ``splits`` is
checked against a table worked by hand."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.kernels import decode_attention as port_da  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

NEG_INF = ref.NEG_INF
LOG2E = 1.4426950408889634
BKV, WARPS = port_da.BKV, port_da.WARPS
KPW = BKV // WARPS
TOL = dict(rtol=5e-6, atol=5e-6)


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))


def split_schedule(q, k, v, pos, *, scale=None, tiles_per_tx=1, nsplit=None):
    """The kernel's walk and combine in fp32: returns (o in q's dtype, the
    per-row list of each split's (m, l, acc) partial, shaped (Hkv, G) and
    (Hkv, G, D))."""
    b, h, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    s_count = nsplit or port_da.splits(b, hkv, t, d, k.dtype)
    kb = 16 // (2 if port_da.lane_slots(g, d) <= 2 else 8)
    scale = d ** -0.5 if scale is None else scale
    qscale = np.float32(np.float32(scale) * np.float32(LOG2E))
    qs = q.reshape(b, hkv, g, d).float() * float(qscale)
    kf, vf = k.float(), v.float()
    tiles = -(-t // BKV)
    tps = -(-tiles // s_count)
    out = torch.empty(b, hkv, g, d)
    partials = []
    for bi in range(b):
        p = int(pos[bi])
        n_keys = t if (p < 0 or p >= t) else p + 1
        row = []
        for s in range(s_count):
            lo = s * tps
            hi = min(lo + tps, tiles, -(-n_keys // BKV))
            m = torch.full((WARPS, hkv, g), NEG_INF)
            l_ = torch.zeros(WARPS, hkv, g)
            acc = torch.zeros(WARPS, hkv, g, d)
            for x0 in range(lo, hi, tiles_per_tx):           # a transaction
                for tile in range(x0, min(x0 + tiles_per_tx, hi)):  # its beats
                    tb = tile * BKV
                    kn = min(BKV, n_keys - tb)
                    for w in range(WARPS):
                        nk = max(0, min(KPW, kn - w * KPW))
                        for k0 in range(0, nk, kb):
                            keys = tb + w * KPW + k0 + torch.arange(
                                min(kb, nk - k0))
                            sc = torch.einsum("kgd,ktd->kgt", qs[bi],
                                              kf[bi][:, keys])
                            sc = torch.where(keys <= p, sc, NEG_INF)
                            mn = torch.maximum(m[w], sc.amax(-1))
                            alpha = torch.exp2(m[w] - mn)
                            wts = torch.exp2(sc - mn[..., None])
                            l_[w] = l_[w] * alpha + wts.sum(-1)
                            acc[w] = acc[w] * alpha[..., None] + torch.einsum(
                                "kgt,ktd->kgd", wts, vf[bi][:, keys])
                            m[w] = mn
            mb = m.amax(0)                       # the block's fold
            f = torch.exp2(m - mb)
            row.append((mb, (l_ * f).sum(0), (acc * f[..., None]).sum(0)))
        mx = torch.stack([r[0] for r in row]).amax(0)    # the cluster's fold
        lsum = torch.zeros(hkv, g)
        a = torch.zeros(hkv, g, d)
        for ms, ls, accs in row:                 # in split order
            f = torch.exp2(ms - mx)
            lsum = lsum + ls * f
            a = a + accs * f[..., None]
        out[bi] = a / torch.where(lsum == 0, 1.0, lsum)[..., None]
        partials.append(row)
    return out.reshape(b, h, d).to(q.dtype), partials


def _inputs(seed, b, h, hkv, t, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, d), (b, hkv, t, d), (b, hkv, t, d))]


POS = (-1, 0, 63, 64)          # with T - 1 and >= T appended per T


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("t", [200, 577])
def test_schedule_matches_plain_version(g, t):
    """Every pos rule at T not a multiple of 64, G 1 / 2 / 4, the kernel's
    own splits and a forced 3-way split."""
    hkv, d = 2, 32
    pos = np.array(POS + (t - 1, t + 5), np.int32)
    q, k, v = (torch.from_numpy(a)
               for a in _inputs(g * t, len(pos), g * hkv, hkv, t, d))
    want = ref.decode_attention(q, k, v, torch.from_numpy(pos))
    for nsplit in (None, 3):
        got, _ = split_schedule(q, k, v, pos, nsplit=nsplit)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_schedule_matches_jax_package(g):
    from repro.kernels import ops as jax_ops
    hkv, t, d = 2, 200, 16
    pos = np.array(POS + (t - 1, t + 5), np.int32)
    q, k, v = _inputs(100 + g, len(pos), g * hkv, hkv, t, d)
    got, _ = split_schedule(*(torch.from_numpy(a) for a in (q, k, v)), pos)
    want = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos), bkv=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_splits_past_pos_are_empty():
    """qwen3's serving shape cut to two rows: S 2 splits of 5 tiles; at pos
    63 the second split loads nothing and leaves m = NEG_INF, l = 0, acc =
    0, which the fold weighs 0."""
    b, h, hkv, t, d = 2, 4, 2, 577, 128
    assert port_da.splits(8, 8, t, d, torch.float32) == 2
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, b, h, hkv, t, d))
    pos = np.array([63, 575], np.int32)
    got, parts = split_schedule(q, k, v, pos, nsplit=2)
    m1, l1, acc1 = parts[0][1]
    assert bool((m1 == NEG_INF).all()) and bool((l1 == 0).all()) \
        and bool((acc1 == 0).all())
    assert bool((parts[1][1][1] > 0).all())
    np.testing.assert_allclose(
        got.numpy(), ref.decode_attention(q, k, v, torch.from_numpy(pos))
        .numpy(), **TOL)


@pytest.mark.parametrize("g,d", [(2, 32), (4, 64), (8, 128)])
def test_transactions_give_identical_bits(g, d):
    """Mode T's transactions of 1, 2 or 4 tiles walk the same tiles in the
    same order: the same bits (NI 2 and NI 8 steps both covered)."""
    hkv, t = 1, 300
    q, k, v = (torch.from_numpy(a) for a in _inputs(g + d, 3, g * hkv, hkv,
                                                      t, d))
    pos = np.array([299, 130, 10], np.int32)
    base, _ = split_schedule(q, k, v, pos, nsplit=2)
    for tiles in (2, 4):
        got, _ = split_schedule(q, k, v, pos, tiles_per_tx=tiles, nsplit=2)
        assert torch.equal(got, base)


# (B, Hkv, T, D, cache dtype) -> splits, worked by hand.  T1's ring is two
# 64-key tiles of K and V: 2 * 64 * 2 * D * itemsize bytes, so an SM holds
# 227 KB // ring blocks; S = min(132 * that // (B * Hkv), 8, tiles), then
# evened to ceil(tiles / ceil(tiles / S)).
SPLITS = [
    ((8, 8, 577, 128, torch.float32), 2),     # 128 KB: 1 a SM; 132 // 64
    ((8, 8, 577, 128, torch.bfloat16), 5),    # 64 KB: 3; 396 // 64 = 6 -> 2 tiles
    ((4, 8, 577, 128, torch.float32), 4),     # 132 // 32 = 4 -> 3 tiles
    ((1, 1, 577, 128, torch.float32), 5),     # capped at 8 -> 2 tiles
    ((2, 2, 200, 32, torch.float32), 4),      # 32 KB: 7; one tile each
    ((16, 8, 577, 128, torch.float32), 1),    # 128 pairs fill the card
    ((64, 8, 4096, 128, torch.float32), 1),
    ((1, 1, 64, 8, torch.float32), 1),        # one tile
    ((1, 1, 65, 8, torch.float32), 2),
]


@pytest.mark.parametrize("shape,want", SPLITS)
def test_splits_by_hand(shape, want):
    b, hkv, t, d, dt = shape
    assert port_da.splits(b, hkv, t, d, dt) == want
    tiles = -(-t // BKV)
    tps = math.ceil(tiles / want)
    assert (want - 1) * tps < tiles <= want * tps   # no split left empty
