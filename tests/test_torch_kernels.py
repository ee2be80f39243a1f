"""The port's attention ops on the CPU (their plain PyTorch versions) against
the JAX package's kernels and references, on the same numpy inputs.

Tolerance 5e-6 in fp32, the bound ``tests/differential.py`` holds kernels
to: the two frameworks sum the dots in different orders, never more.
The flash kernel's top-left causal mask never masks a whole row (every
row sees key 0), so fully masked rows are exercised where they occur, in
``chunked_attention`` (``tests/test_torch_model.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.kernels import decode_attention as port_da  # noqa: E402
from repro_torch.kernels import flash_attention as port_fa  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402

TOL = dict(rtol=5e-6, atol=5e-6)


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _launch_counts():
    return port_fa.launches, port_da.launches


# (B, H, Hkv, S, T, D, causal)
FLASH_CASES = [
    (2, 4, 2, 16, 16, 32, True),
    (2, 4, 2, 16, 16, 32, False),
    (1, 4, 2, 37, 37, 32, True),        # ragged S
    (1, 4, 4, 37, 37, 64, False),
    (2, 4, 2, 5, 24, 32, False),        # S != T
    (1, 4, 2, 24, 8, 32, True),         # S > T: rows past T see every key
]


@pytest.mark.parametrize("b,h,hkv,s,t,d,causal", FLASH_CASES)
def test_flash_matches_pallas_kernel(b, h, hkv, s, t, d, causal):
    from repro.kernels import ops as jax_ops
    q, k, v = _inputs(0, (b, h, s, d), (b, hkv, t, d), (b, hkv, t, d))
    before = _launch_counts()
    got = port_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    assert _launch_counts() == before      # CPU tensors take the plain path
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   impl="pallas", interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,h,hkv,s,d,causal", [
    (2, 4, 2, 16, 32, True), (2, 4, 2, 16, 32, False),
    (1, 4, 2, 37, 32, True), (1, 4, 4, 9, 64, True)])
def test_flash_matches_reference_attention(b, h, hkv, s, d, causal):
    """S == T, where the reference's bottom-right causal mask equals the
    kernel's top-left one; kv repeated for GQA on the reference side."""
    from repro.kernels import ref as jax_ref
    q, k, v = _inputs(1, (b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))
    got = port_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    rep = h // hkv
    want = jax_ref.attention(jnp.asarray(q),
                             jnp.repeat(jnp.asarray(k), rep, axis=1),
                             jnp.repeat(jnp.asarray(v), rep, axis=1),
                             causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (B, H, Hkv, T, D, pos): scalar or per-row, with 0 and T-1 among the rows
DECODE_CASES = [
    (2, 4, 2, 32, 32, 0),
    (2, 4, 2, 32, 32, 17),
    (2, 4, 2, 32, 32, 31),
    (4, 4, 2, 64, 32, [0, 63, 9, 40]),
    (3, 4, 4, 16, 64, [15, 0, 7]),
]


@pytest.mark.parametrize("b,h,hkv,t,d,pos", DECODE_CASES)
def test_decode_matches_registry_reference(b, h, hkv, t, d, pos):
    from repro.compiler.registry import _decode_reference
    q, k, v = _inputs(2, (b, h, d), (b, hkv, t, d), (b, hkv, t, d))
    tpos = pos if isinstance(pos, int) else torch.tensor(pos,
                                                         dtype=torch.int32)
    before = _launch_counts()
    got = port_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), tpos)
    assert _launch_counts() == before
    want = _decode_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,h,hkv,t,d,pos", DECODE_CASES)
def test_decode_matches_compiled_decode_kernel(b, h, hkv, t, d, pos):
    """Against the compiler route's decode kernel (its CPU tiers)."""
    from repro.kernels import ops as jax_ops
    q, k, v = _inputs(3, (b, h, d), (b, hkv, t, d), (b, hkv, t, d))
    tpos = pos if isinstance(pos, int) else torch.tensor(pos,
                                                         dtype=torch.int32)
    got = port_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), tpos)
    want = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos, jnp.int32),
                                    bkv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers never run a plain version: a CPU tensor is an
    error there, and the launch counts stay put."""
    q = torch.zeros(1, 2, 4, 32)
    before = _launch_counts()
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        port_fa.flash_attention_cuda(q, q, q, causal=True)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        port_da.decode_attention_cuda(q[:, :, 0], q, q, 3)
    assert _launch_counts() == before
