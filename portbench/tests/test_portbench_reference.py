"""Each family reference against the program's plain serving route (a
cached prefill) at SMOKE widths, on the same
seeded weights, in fp32: the reference is written
from the equations, so agreement here ties its reading of the weights to
the program's."""
import pytest
import torch

import small
from portbench.harness.cell import model_config
from portbench.harness.trace import load_module
from portbench.harness.weights import Draw, load_into


@pytest.mark.parametrize("conf", [small.DENSE, small.DENSE_QK_NORM,
                                  small.SSM], ids=lambda c: c["name"])
def test_reference_matches_plain_route(conf):
    from repro_torch.models import model as model_mod
    port = dict(conf["port"], attention_impl="xla_chunked", ssm_impl="xla")
    ref = load_module("reference", conf["reference"])
    draw = Draw(ref.leaves(port), 20260101, torch.device("cpu"),
                torch.float32)
    cfg = model_config(port)
    with torch.device("meta"):
        model = model_mod.build(cfg, torch.float32)
    load_into(model, draw)
    g = torch.Generator().manual_seed(3)
    tokens = [torch.randint(0, port["vocab_size"], (n,), generator=g)
              for n in (37, 64)]
    with torch.no_grad():
        want = ref.forward(port, draw.fp32, tokens, [0, 5])
        for t, w in zip(tokens, want):
            cache = model_mod.init_cache(cfg, 1, 64, torch.float32)
            got, _ = model_mod.decode_step(cfg, model, {"tokens": t[None]},
                                           cache)
            torch.testing.assert_close(got[0, -w.shape[0]:], w, rtol=1e-5,
                                       atol=1e-5)


def test_ssd_chunks_agree():
    """The reference's chunked SSD equals its plain recurrence."""
    from portbench.reference.ssm import ssd
    g = torch.Generator().manual_seed(0)
    L, H, P, N = 50, 3, 4, 5
    x = torch.randn(L, H, P, generator=g)
    dt = torch.rand(L, H, generator=g) * 0.2
    A = -torch.rand(H, generator=g) * 2
    B, C = torch.randn(L, N, generator=g), torch.randn(L, N, generator=g)
    s = torch.zeros(H, N, P)
    ys = []
    for t in range(L):
        s = s * torch.exp(A * dt[t])[:, None, None] \
            + dt[t][:, None, None] * B[t][None, :, None] * x[t][:, None, :]
        ys.append(torch.einsum("n,hnp->hp", C[t], s))
    for chunk in (8, 16, 128):
        torch.testing.assert_close(ssd(x, dt, A, B, C, chunk),
                                   torch.stack(ys), rtol=1e-5, atol=1e-5)
