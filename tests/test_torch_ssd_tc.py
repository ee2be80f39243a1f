"""The rounding of the SSD scan's tensor-core body (``csrc/ssd_scan.cu``,
``ssd_scan_tc``) modelled on the CPU, and the scan wrapper's host side.

With x, B and C in bf16 (the serving path) the kernel takes each as it is,
exact as one bf16 term, and sums C.B^T in fp32.  Each fp32 operand of the
other products is split into bf16 terms (``ssd_scan.TERMS``: the state S
in C.S and G in G.x two, x * w in the state's update three), every product
accumulates in fp32, and the decay cumsum runs in fp64, rounded once to
fp32.  ``emulate`` repeats that arithmetic chunk by chunk, walking the
chunks in transactions of 1, 2 or 4 as mode T does, and the tests hold it
to the port's plain version and to the JAX package's compiled scan under
the tolerances ``chip_smoke.py`` holds the kernel to on the card: y within
``RTOL_SSD_BF16`` and the state within ``RTOL_SSD_FP32`` of their largest
values.  Any of x, B, C in fp32 takes the kernel's CUDA-core body (fp32
FMAs, no split), which ``emulate`` models as fp32 products.  One bf16 term
per fp32 operand misses the state's bound: that is why the split exists.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.kernels import ssd_scan as port_ss  # noqa: E402

RTOL_SSD_FP32 = 1e-5          # chip_smoke.py's RTOL_SSD_FP32 (the state)
RTOL_SSD_BF16 = 2.0 ** -7     # chip_smoke.py's RTOL_SSD_BF16 (a bf16 y)
ONE_TERM = {"C.B^T": 1, "C.S": 1, "G.x": 1, "state": 1}
# the serving widths, cut in batch, length and heads only
SERVING = dict(b=1, l=128, h=4, g=1, n=128, p=64, chunk=64)


def _split(v: torch.Tensor, k):
    """v as ``k`` bf16 terms (hi, then what is left, rounded again, ...);
    ``k`` None keeps v whole (an fp32 operand of the CUDA-core body)."""
    if k is None:
        return [v]
    terms, rest = [], v
    for _ in range(k):
        t = rest.to(torch.bfloat16).float()
        terms.append(t)
        rest = rest - t
    return terms


def _beat(xc, dtc, bc, cc, af, state, mask, terms):
    """One chunk of the recurrence as the kernel computes it."""
    f32 = torch.float32
    lp = torch.cumsum(af * dtc, -1, dtype=torch.float64).to(f32)
    last = lp[..., -1:]
    cb = cc @ bc.transpose(-1, -2)                     # exact products
    ratio = torch.where(mask, lp[..., :, None] - lp[..., None, :], 0.0)
    gm = torch.where(mask, cb * torch.exp(ratio) * dtc[..., None, :], 0.0)
    yc = sum(cc @ s for s in _split(state, terms.get("C.S")))
    y = torch.exp(lp)[..., None] * yc
    for gt in _split(gm, terms.get("G.x")):
        y = y + gt @ xc
    w = torch.exp(last - lp) * dtc
    if "state" in terms:    # the tensor-core body scales x
        ds = sum(bc.transpose(-1, -2) @ t
                 for t in _split(xc * w[..., None], terms["state"]))
    else:                   # the CUDA-core body scales B
        ds = (bc * w[..., None]).transpose(-1, -2) @ xc
    return y, state * torch.exp(last)[..., None] + ds


def emulate(x, dt, A, B, C, *, chunk, walk=1, terms=None):
    """The kernel's arithmetic on x (B, L, H, P), dt (B, L, H), A (H,), B /
    C (B, L, G, N), ``walk`` chunks a transaction: returns y in x's dtype
    and the fp32 (B, H, N, P) final state.  ``terms`` defaults to the
    kernel's split for bf16 x, B and C and to none otherwise."""
    if terms is None:
        tc = all(t.dtype == torch.bfloat16 for t in (x, B, C))
        terms = port_ss.TERMS if tc else {}
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    heads = torch.arange(h) // (h // g)
    nch = -(-l // chunk)
    pad = nch * chunk - l

    def prep(t):    # steps past L read as zeros and dt = 0
        t = t.float()
        return torch.nn.functional.pad(
            t, (0,) * (2 * (t.dim() - 2)) + (0, pad)) if pad else t

    xs, dts = prep(x).transpose(1, 2), prep(dt).transpose(1, 2)
    bs = prep(B)[:, :, heads].transpose(1, 2)
    cs = prep(C)[:, :, heads].transpose(1, 2)
    af = A.float()[None, :, None]
    idx = torch.arange(chunk)
    mask = idx[:, None] >= idx[None, :]
    state = torch.zeros((b, h, n, p))
    ys = []
    for c0 in range(0, nch, walk):          # one transaction: its panel ...
        panel = [tuple(t[:, :, ci * chunk:(ci + 1) * chunk]
                       for t in (xs, dts, bs, cs))
                 for ci in range(c0, min(c0 + walk, nch))]
        for xc, dtc, bc, cc in panel:       # ... then its dependent beats
            y, state = _beat(xc, dtc, bc, cc, af, state, mask, terms)
            ys.append(y)
    y = torch.cat(ys, 2)[:, :, :l].transpose(1, 2).to(x.dtype)
    return y, state


def _inputs(seed, b, l, h, g, n, p, dtype=torch.bfloat16, **_):
    """As ``chip_smoke.ssd_inputs`` makes them, from numpy: x, B and C
    strided views of one silu'd conv output, dt = softplus(.), A from -1 to
    -16."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    conv = torch.nn.functional.silu(torch.from_numpy(
        rng.standard_normal((b, l, h * p + 2 * g * n)).astype(f32)))
    conv = conv.to(dtype)
    x = conv[..., :h * p].reshape(b, l, h, p)
    bm = conv[..., h * p:h * p + g * n].reshape(b, l, g, n)
    cm = conv[..., h * p + g * n:].reshape(b, l, g, n)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, l, h)).astype(f32))).to(dtype)
    a = -torch.linspace(1.0, 16.0, h)
    return x, dt, a, bm, cm


def _rel(got, want):
    """max |got - want| over max(1, max |want|), as chip_smoke.rel_err."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


def _plain(x, dt, a, bm, cm, chunk):
    return port_ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk, final_state=True)


def _jax(x, dt, a, bm, cm, chunk):
    from repro.kernels import ops as jax_ops
    args = [jnp.asarray(t.float().numpy()) for t in (x, dt, a, bm, cm)]
    y, st = jax_ops.ssd_scan(*args, chunk=chunk, final_state=True)
    return (torch.from_numpy(np.array(y)), torch.from_numpy(np.array(st)))


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))


# ------------------------------------------------------ the kernel's rounding --
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serving_widths_within_the_card_bounds(seed):
    x, dt, a, bm, cm = _inputs(seed, **SERVING)
    y, st = emulate(x, dt, a, bm, cm, chunk=SERVING["chunk"])
    y_ref, st_ref = _plain(x, dt, a, bm, cm, SERVING["chunk"])
    assert y.dtype == torch.bfloat16 and st.shape == (1, 4, 128, 64)
    assert _rel(y, y_ref) <= RTOL_SSD_BF16
    assert _rel(st, st_ref) <= RTOL_SSD_FP32


def test_serving_widths_against_the_jax_package():
    x, dt, a, bm, cm = _inputs(3, **SERVING)
    y, st = emulate(x, dt, a, bm, cm, chunk=SERVING["chunk"])
    y_want, st_want = _jax(x, dt, a, bm, cm, SERVING["chunk"])
    assert _rel(y, y_want) <= RTOL_SSD_BF16
    assert _rel(st, st_want) <= RTOL_SSD_FP32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,chunk", [(100, 32), (37, 16), (130, 64)])
def test_odd_widths_and_ragged_length(dtype, l, chunk):
    """N 24, P 40, G 2 and an L that is not a chunk multiple: fp32 inputs
    (the CUDA-core body) hold y and the state to RTOL_SSD_FP32, bf16 ones
    (the tensor-core body, zero-padded to whole 16-wide tiles) y to
    RTOL_SSD_BF16 and the state to RTOL_SSD_FP32."""
    x, dt, a, bm, cm = _inputs(4, 2, l, 4, 2, 24, 40, dtype)
    y, st = emulate(x, dt, a, bm, cm, chunk=chunk)
    y_ref, st_ref = _plain(x, dt, a, bm, cm, chunk)
    y_bound = RTOL_SSD_FP32 if dtype == torch.float32 else RTOL_SSD_BF16
    assert y.shape == (2, l, 4, 40) and st.shape == (2, 4, 24, 40)
    assert _rel(y, y_ref) <= y_bound
    assert _rel(st, st_ref) <= RTOL_SSD_FP32


def test_fp32_ragged_against_the_jax_package():
    """The JAX package's compiled scan needs whole chunks; its sequential
    reference (no chunks at all) takes the ragged L."""
    from repro.compiler.registry import _ssd_scan_reference
    x, dt, a, bm, cm = _inputs(5, 1, 100, 4, 2, 24, 40, torch.float32)
    y, st = emulate(x, dt, a, bm, cm, chunk=32)
    y_want, st_want = (torch.from_numpy(np.array(t)) for t in
                       _ssd_scan_reference(*(jnp.asarray(t.numpy())
                                             for t in (x, dt, a, bm, cm))))
    assert _rel(y, y_want) <= RTOL_SSD_FP32
    assert _rel(st, st_want) <= RTOL_SSD_FP32


@pytest.mark.parametrize("walk", [2, 4])
def test_transactions_of_chunks_keep_the_bits(walk):
    """Mode T stages ``walk`` chunks, then runs their beats: the same terms
    in the same order as one chunk a transaction (L 300: 5 chunks, so the
    last transaction is short)."""
    x, dt, a, bm, cm = _inputs(6, 1, 300, 4, 1, 32, 16)
    y1, st1 = emulate(x, dt, a, bm, cm, chunk=64)
    y, st = emulate(x, dt, a, bm, cm, chunk=64, walk=walk)
    assert torch.equal(y, y1) and torch.equal(st, st1)


def test_one_term_per_fp32_operand_misses_the_state_bound():
    """The guard on the split: rounding S, G and x * w to one bf16 term
    each moves the state by more than ten times RTOL_SSD_FP32 of its
    largest value; the kernel's split keeps it under a tenth of it."""
    x, dt, a, bm, cm = _inputs(0, **SERVING)
    _, st_ref = _plain(x, dt, a, bm, cm, SERVING["chunk"])
    _, st_one = emulate(x, dt, a, bm, cm, chunk=SERVING["chunk"],
                        terms=ONE_TERM)
    _, st = emulate(x, dt, a, bm, cm, chunk=SERVING["chunk"])
    assert _rel(st_one, st_ref) > 10 * RTOL_SSD_FP32
    assert _rel(st, st_ref) < RTOL_SSD_FP32 / 10


def test_x_w_takes_a_third_term():
    """Why the state's product splits x * w into three terms: with two the
    state moves by more than a tenth of RTOL_SSD_FP32 (seed 1 at the
    serving widths), too little room for the card's own summation order;
    with three by under a fiftieth."""
    x, dt, a, bm, cm = _inputs(1, **SERVING)
    _, st_ref = _plain(x, dt, a, bm, cm, SERVING["chunk"])
    _, st2 = emulate(x, dt, a, bm, cm, chunk=SERVING["chunk"],
                     terms=dict(port_ss.TERMS, state=2))
    _, st3 = emulate(x, dt, a, bm, cm, chunk=SERVING["chunk"])
    assert _rel(st2, st_ref) > RTOL_SSD_FP32 / 10
    assert _rel(st3, st_ref) < RTOL_SSD_FP32 / 50


def test_the_split_terms():
    """Three bf16 terms hold an fp32 value exactly; two within 2^-16 of
    it (csrc/ssd_scan.cu's split3 and split2)."""
    rng = np.random.default_rng(7)
    v = torch.from_numpy((rng.standard_normal(4096)
                          * np.exp2(rng.integers(-20, 20, 4096)))
                         .astype(np.float32))
    assert torch.equal(sum(_split(v, 3)), v)
    two = sum(_split(v, 2))
    assert ((two - v).abs() <= v.abs() * 2.0 ** -16).all()
    assert not torch.equal(two, v)


# -------------------------------------------------------- the host side --
def test_smem_bytes_worked_by_hand():
    """Tensor-core body: G's two bf16 terms, 64 rows of 72 (18,432 B), and
    4 warps' logP, exp(logP), w in fp32 (3,072 B): 21,504 fixed; a chunk's
    slot is x 64 x 72 bf16 (9,216), B and C 64 x 136 bf16 (17,408 each)
    and dt 64 fp32 (256): 44,288; a ring of two transactions.  CUDA-core
    body: S 128 x 64, G 64 x 65 and 3 x 64 decay floats (12,544) plus a
    chunk's x 64 x 64, B and C 64 x 129 and dt 64 (20,672) a slot, no
    ring, all fp32."""
    fixed, slot = 18432 + 3072, 9216 + 2 * 17408 + 256
    assert slot == 44288
    for (f, m), tiles in (((1, "T"), 1), ((2, "T"), 2), ((4, "T"), 4),
                          ((2, "R"), 1), ((4, "R"), 1)):
        assert port_ss.smem_bytes(f, m) == fixed + 2 * tiles * slot
        assert port_ss.smem_bytes(f, m, tensor_cores=False) \
            == 4 * (12544 + tiles * 20672)
    assert port_ss.smem_bytes(1, "T") == 110080
    assert port_ss.smem_bytes(2, "T") == 198656
    assert port_ss.smem_bytes(4, "T") == 375808
    assert port_ss.smem_bytes(1, "T", tensor_cores=False) == 132864
    # two T1 blocks (and their 1 KB each the runtime keeps) fit an SM's
    # 228 KB, where one CUDA-core block did
    assert 2 * (port_ss.smem_bytes(1, "T") + 1024) <= 228 * 1024 \
        < 2 * (port_ss.smem_bytes(1, "T", tensor_cores=False) + 1024)


def test_built_set_fits_both_bodies():
    assert [c for c in port_ss.PUMPS if port_ss.built(*c)] == \
        [(1, "T"), (2, "T"), (2, "R"), (4, "R")]
    assert port_ss.smem_bytes(2, "T", False) <= port_ss.SMEM_BYTES \
        < port_ss.smem_bytes(4, "T")
    assert port_ss.built(1, "R")          # R1 is T1


def test_terms_are_the_emulated_split():
    assert port_ss.TERMS == {"C.B^T": 1, "C.S": 2, "G.x": 2, "state": 3}


def _z(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


def _args(b=1, l=8, h=4, g=1, n=16, p=8):
    return [_z(b, l, h, p), _z(b, l, h), _z(h, dtype=torch.float32),
            _z(b, l, g, n), _z(b, l, g, n)]


def _bad(case):
    x, dt, a, bm, cm = _args()
    chunk = 8
    if case == "x 3-D":
        x = x[0]
    elif case == "dt fp16":
        dt = dt.half()
    elif case == "A bf16":
        a = a.bfloat16()
    elif case == "dt shape":
        dt = _z(1, 8, 3)
    elif case == "C shape":
        cm = _z(1, 8, 1, 8)
    elif case == "B last dim strided":
        bm = _z(1, 8, 1, 32)[..., ::2]
    elif case == "A strided":
        a = _z(8, dtype=torch.float32)[::2]
    elif case == "G divides not H":
        x, dt, a, bm, cm = _args(h=4, g=3)
    elif case == "G 0":
        x, dt, a, bm, cm = _args(g=0)
    elif case == "chunk 0":
        chunk = 0
    elif case == "chunk 65":
        chunk = 65
    elif case == "N 129":
        x, dt, a, bm, cm = _args(n=129)
    elif case == "P 65":
        x, dt, a, bm, cm = _args(p=65)
    elif case == "devices differ":
        x = x.to("meta")
    return x, dt, a, bm, cm, chunk


@pytest.mark.parametrize("case,error", [
    ("x 3-D", ValueError), ("dt fp16", TypeError), ("A bf16", TypeError),
    ("dt shape", ValueError), ("C shape", ValueError),
    ("B last dim strided", ValueError), ("A strided", ValueError),
    ("G divides not H", ValueError), ("G 0", ValueError),
    ("chunk 0", ValueError), ("chunk 65", ValueError),
    ("N 129", ValueError), ("P 65", ValueError),
    ("devices differ", ValueError)])
def test_wrapper_still_refuses(case, error):
    """Each input the wrapper refused before is refused by its checks,
    whatever the device; a CPU tensor never reaches the kernel."""
    *args, chunk = _bad(case)
    with pytest.raises(error):
        port_ss.check_inputs(*args, chunk)
    before = port_ss.launches
    with pytest.raises((ValueError, TypeError)):
        port_ss.ssd_scan_cuda(*args, chunk=chunk)
    assert port_ss.launches == before


@pytest.mark.parametrize("shape", [
    (2, 37, 4, 1, 16, 32, 16), (1, 200, 4, 2, 24, 40, 32),
    (1, 100, 4, 2, 24, 36, 40), (8, 512, 64, 1, 128, 64, 64),
    (1, 1, 1, 1, 1, 1, 1)])
def test_wrapper_takes_every_shape_it_took(shape):
    """chunk <= 64, N <= 128, P <= 64, any G dividing H, any L, in
    either dtype: the checks pass (the launch itself needs the card)."""
    b, l, h, g, n, p, chunk = shape
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, a, bm, cm = _args(b, l, h, g, n, p)
        port_ss.check_inputs(x.to(dtype), dt, a, bm.to(dtype), cm, chunk)
