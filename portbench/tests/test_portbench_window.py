"""The window's arithmetic against hand counts."""
import pytest

from portbench.harness.loop import Req, Step
from portbench.harness.traffic import Item
from portbench.harness.window import Window, p95
from portbench.reference import dense


def _window():
    # two requests; the window is [10, 20] on the host clock
    r0 = Req(0, 0, Item(0, 100, 3), send_t=8.0, times=[9.0, 11.0, 12.0],
             done_t=12.0)
    r1 = Req(1, 0, Item(1, 50, 4), send_t=12.0, times=[13.5, 14.0, 16.0,
                                                      21.0])
    steps = [Step(10.0, 12.0, 0, 2, decode_keys=[101, 102]),
             Step(12.0, 14.0, 1, 2, prefills=[50], decode_keys=[51]),
             Step(14.0, 20.0, 0, 1, decode_keys=[52])]
    return Window(steps, {0: r0, 1: r1}, 10.0, {}, 2, lambda p, k, h: 0.0)


def test_tokens_and_rate():
    w = _window()
    # r0: first token before the window (its prompt does not count), 2
    # tokens inside; r1: prompt 50 + 3 tokens inside, one after
    assert w.tokens() == 2 + 50 + 3
    assert w.seconds == 10.0
    assert w.tok_s() == pytest.approx(5.5)


def test_tails():
    w = _window()
    assert w.ttft_ms() == [pytest.approx(1500.0)]
    assert sorted(w.itl_ms()) == pytest.approx([500.0, 1000.0, 2000.0,
                                                2000.0])
    assert p95([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(4.8)
    assert p95([]) is None


def test_per_layer():
    w = _window()
    assert w.occupancy_pct() == pytest.approx(100.0 * 5 / 6)
    assert w.decode_step_ms() == pytest.approx(4000.0)
    assert w.prefill_us_per_tok() is None
    w.steps[1].prefill_s = 0.005
    assert w.prefill_us_per_tok() == pytest.approx(100.0)
    assert [r.rid for r in w.completed()] == [0]
    assert w.attempted() == 2


def test_flops_sum_by_hand():
    port = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
            "d_ff": 16, "vocab_size": 10}
    steps = [Step(0.0, 1.0, 1, 1, prefills=[3], decode_keys=[7])]
    w = Window(steps, {}, 0.0, port, 1, dense.token_flops)
    f = dense.token_flops
    want = (f(port, 1, False) + f(port, 2, False) + f(port, 3, True)
            + f(port, 7, True))
    assert w.flops() == pytest.approx(want)
