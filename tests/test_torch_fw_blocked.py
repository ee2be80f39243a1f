"""The blocked Floyd-Warshall schedule of ``csrc/floyd_warshall.cu`` on the
CPU: a plain PyTorch emulation of its three phases, with the pivot panels
recorded as each stands before its step, held bit for bit to the port's
sequential plain version (``ref.floyd_warshall``) and to the JAX package's
Pallas kernel in interpret mode, on seeded inputs with ``inf``, negative
weights on a DAG and NaN, at sizes that leave a ragged last round.  The
textbook schedule, which reads the panels as they stand after the round,
is shown to differ in the last bits on a pinned input, so the recording is
what keeps the kernel exact.  Exact means: NaN at the same places and the
same bits everywhere else (NaN payloads are not compared)."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.kernels import floyd_warshall as port_fw  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import FW_KINDS, fw_graph  # noqa: E402

ROUNDS = (4, 16, 64)
SIZES = (37, 100, 130)


def recorded_blocked(d: torch.Tensor, b: int):
    """The kernel's schedule in rounds of ``b`` pivots: (result, launches).
    Phase 1 walks the diagonal tile through the round's steps, recording
    each pivot row and column as it stands before its step; phase 2 walks
    the row and column strips through the same steps from those records
    (one launch with phase 1); phase 3 folds min(d, C[:, k] + R[k]) over
    the round's pivots in k order into the whole matrix (one launch)."""
    n = d.shape[0]
    d = d.clone()
    launches = 0
    for k0 in range(0, n, b):
        kb = min(b, n - k0)
        ks = slice(k0, k0 + kb)
        t = d[ks, ks].clone()
        rkk, ckk = torch.empty(kb, kb), torch.empty(kb, kb)
        for k in range(kb):
            rkk[k], ckk[:, k] = t[k], t[:, k]
            t = torch.minimum(t, ckk[:, k:k + 1] + rkk[k:k + 1])
        rows, r = d[ks].clone(), torch.empty(kb, n)
        for k in range(kb):
            r[k] = rows[k]
            rows[k + 1:] = torch.minimum(rows[k + 1:],
                                         ckk[k + 1:, k:k + 1] + r[k:k + 1])
        cols, c = d[:, ks].clone(), torch.empty(n, kb)
        for k in range(kb):
            c[:, k] = cols[:, k]
            cols[:, k + 1:] = torch.minimum(cols[:, k + 1:],
                                            c[:, k:k + 1] + rkk[k:k + 1,
                                                                k + 1:])
        launches += 1
        for k in range(kb):
            d = torch.minimum(d, c[:, k:k + 1] + r[k:k + 1])
        launches += 1
    return d, launches


def textbook_blocked(d: torch.Tensor, b: int) -> torch.Tensor:
    """The textbook blocked schedule: the diagonal tile in place, then the
    panels from the finished diagonal tile, then every other tile from the
    finished panels."""
    n = d.shape[0]
    d = d.clone()
    for k0 in range(0, n, b):
        k1 = min(n, k0 + b)
        ks = slice(k0, k1)
        for k in range(k0, k1):
            d[ks, ks] = torch.minimum(d[ks, ks],
                                      d[ks, k:k + 1] + d[k:k + 1, ks])
        diag = d[ks, ks].clone()
        rest = torch.cat([torch.arange(k0), torch.arange(k1, n)])
        rows, cols = d[ks][:, rest], d[rest, ks]
        for k in range(k1 - k0):
            rows = torch.minimum(rows, diag[:, k:k + 1] + rows[k:k + 1])
            cols = torch.minimum(cols, cols[:, k:k + 1] + diag[k:k + 1])
        d[k0:k1, rest] = rows
        d[rest, k0:k1] = cols
        inner = d[rest[:, None], rest[None, :]]
        for k in range(k1 - k0):
            inner = torch.minimum(inner, cols[:, k:k + 1] + rows[k:k + 1])
        d[rest[:, None], rest[None, :]] = inner
    return d


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN at the same places, the same bits everywhere else."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = a.isnan()
    if not torch.equal(nan, b.isnan()):
        return False
    return torch.equal(a.masked_fill(nan, 0).view(torch.int32),
                       b.masked_fill(nan, 0).view(torch.int32))


@pytest.mark.parametrize("kind", FW_KINDS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("b", ROUNDS)
def test_recorded_schedule_matches_sequential(b, n, kind):
    d = fw_graph(n, kind, seed=n)
    got, launches = recorded_blocked(d, b)
    want = ref.floyd_warshall(d)
    assert same(got, want)
    assert launches == 2 * -(-n // b)
    # the inputs reach what they are for
    if kind == "nan":   # one node's row and column
        assert int(want.isnan().sum()) == 2 * n - 1
    if kind in ("missing", "negative_dag"):
        assert d.isinf().any()
    if kind == "negative_dag":
        assert want.isinf().any() and (want < 0).any()


@pytest.mark.parametrize("kind", FW_KINDS)
@pytest.mark.parametrize("n,m", [(37, 1), (100, 4), (130, 2)])
def test_recorded_schedule_matches_pallas_kernel(n, m, kind):
    from repro.kernels import ops as jax_ops
    d = fw_graph(n, kind, seed=n)
    want = torch.from_numpy(np.array(
        jax_ops.floyd_warshall(jnp.asarray(d.numpy()), pump=m)))
    for b in ROUNDS:
        assert same(recorded_blocked(d, b)[0], want), f"round of {b}"


def test_textbook_schedule_loses_the_sequential_bits():
    """On Table 6's weights the textbook schedule finds the same shortest
    paths summed in another order: equal within fp32 rounding, not in
    every bit; the recorded schedule keeps every bit."""
    d = fw_graph(100, "uniform", seed=0)
    want = ref.floyd_warshall(d)
    book = textbook_blocked(d, 16)
    assert not same(book, want)
    assert int((book != want).sum()) > 0
    torch.testing.assert_close(book, want, rtol=1e-5, atol=0)
    assert same(recorded_blocked(d, 16)[0], want)


@pytest.mark.parametrize("n", [1, 16, 37, 64, 65, 100, 130])
def test_launches_per_call_is_the_schedules_count(n):
    """The wrapper's count is the launches of its schedule at its round,
    for every pump that divides n."""
    _, launches = recorded_blocked(fw_graph(n, "uniform", seed=n),
                                   port_fw.ROUND)
    for m in port_fw.PUMPS:
        if n % m == 0:
            assert port_fw.launches_per_call(n, m) == launches
    assert port_fw.launches_per_call(4096, 2) == 2 * 4096 // port_fw.ROUND
