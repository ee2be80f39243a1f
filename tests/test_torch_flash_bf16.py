"""The rounding of the bf16 flash kernel (``csrc/flash_attention.cu``,
``flash_fwd_bf16``) modelled on the CPU.

The kernel multiplies bf16 q and k on the tensor cores into fp32 scores,
scales them after the product, keeps the online softmax in fp32, rounds the
weights P to bf16 before O += P V (fp32 accumulation) and sums l over the
fp32 weights.  ``emulate`` repeats that arithmetic tile by tile (64 keys, as
the kernel walks them) in plain PyTorch, and the tests hold it to the
port's plain version and to the JAX package's Pallas kernel in interpret
mode, both in bf16, under the tolerance ``chip_smoke.py`` holds the kernel
to on the card (``ATOL_BF16``): the rounding of P costs at most 2^-9
relative on each weight, well inside the bf16 output's own rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.kernels import ref as port_ref  # noqa: E402

ATOL_BF16 = 2e-2              # chip_smoke.py's ATOL_BF16 (kernel vs plain)
BKV = 64                      # keys of one kernel tile
B, H, HKV, S, D = 1, 2, 1, 128, 128


def emulate(q, k, v, *, causal, scale=None):
    """The kernel's arithmetic on bf16 q (B, H, S, D) and k / v (B, Hkv, T,
    D): returns o (bf16) and the fp32 row max m and denominator l."""
    b, h, s, d = q.shape
    t = k.shape[2]
    g = h // k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    m = torch.full((b, h, s), -1e30)
    l_ = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, t, BKV):
        keys = torch.arange(k0, min(k0 + BKV, t))
        sc = torch.einsum("bhsd,bhtd->bhst", qf, kf[:, :, keys]) * scale
        if causal:
            sc = torch.where(rows >= keys[None, :], sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l_ = l_ * alpha + p.sum(-1)
        pb = p.to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bhst,bhtd->bhsd", pb, vf[:, :, keys])
        m = m_new
    o = acc / torch.where(l_ == 0, 1.0, l_)[..., None]
    return o.to(torch.bfloat16), m, l_


def _inputs(seed=17):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((B, H, S, D), (B, HKV, S, D), (B, HKV, S, D)))
    return [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]


def _pallas_bf16(q, k, v):
    from repro.kernels.flash_attention import flash_attention_pallas
    as_jax = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
              for x in (q, k, v)]
    out = flash_attention_pallas(*as_jax, causal=True, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("reference", ["port_plain", "pallas_interpret"])
def test_bf16_rounding_within_atol(reference):
    q, k, v = _inputs()
    got, _, _ = emulate(q, k, v, causal=True)
    want = (port_ref.flash_attention(q, k, v, causal=True)
            if reference == "port_plain" else _pallas_bf16(q, k, v))
    e = (got.float() - want.float()).abs().max().item()
    print(f"emulated bf16 kernel vs {reference}: max abs err {e:.3g}, "
          f"headroom {ATOL_BF16 / max(e, 1e-30):.1f}x under {ATOL_BF16}")
    assert e <= ATOL_BF16

