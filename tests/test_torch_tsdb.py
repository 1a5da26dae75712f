"""The port's metrics time-series ring against the JAX package's.

The same counter, gauge and histogram samples, at the same injected
sample times, go through both packages' registries and ``MetricsTSDB``
rings; rates, per-label rates, quantiles, series, retention and the
history report's rows for the test's own metrics must be equal. Each test
starts from a clean ring in both packages and restores any knob it sets.
"""

import itertools

import pytest

from wukong_tpu.config import Global as JGlobal
from wukong_tpu.obs import tsdb as jtsdb
from wukong_tpu.obs.metrics import get_registry as jregistry
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.obs import tsdb
from wukong_tpu_torch.obs.metrics import get_registry

_SEQ = itertools.count()
BUCKETS = (1, 5, 10, 50, 100, 500)


@pytest.fixture(autouse=True)
def _clean_rings():
    tsdb.get_tsdb().reset()
    jtsdb.get_tsdb().reset()
    yield
    tsdb.get_tsdb().reset()
    jtsdb.get_tsdb().reset()


def _pair(prefix: str):
    """One counter (labelled), gauge and histogram of a fresh name in each
    package's registry."""
    n = next(_SEQ)
    out = []
    for reg in (get_registry(), jregistry()):
        out.append((
            reg.counter(f"{prefix}_c{n}_total", "test counter",
                        labels=("shard",)),
            reg.gauge(f"{prefix}_g{n}", "test gauge"),
            reg.histogram(f"{prefix}_h{n}_us", "test histogram",
                          buckets=BUCKETS),
        ))
    return n, out


def _feed(metrics, steps, rings, t0_us=10_000_000, dt_us=1_000_000):
    """Apply one step of samples to every package's metrics, then sample
    every ring at the same injected time."""
    for k, (incs, gval, obs) in enumerate(steps):
        for (c, g, h) in metrics:
            for shard, v in incs.items():
                c.labels(shard=shard).inc(v)
            g.set(gval)
            for x in obs:
                h.observe(x)
        for ring in rings:
            ring.sample_once(now_us=t0_us + k * dt_us)


STEPS = [({"0": 3, "1": 1}, 2.0, [0.5, 3, 7]),
         ({"0": 5}, 4.0, [12, 60, 60, 400]),
         ({"1": 9, "2": 2}, 1.0, [900, 2]),
         ({"0": 1, "2": 4}, 7.5, [45, 45, 45, 99, 101]),
         ({}, 3.0, [])]


@pytest.mark.parametrize("window_s", [None, 1.5, 2.5, 10.0])
def test_rates_quantiles_series_equal(window_s):
    n, metrics = _pair("wk_torch_tsdb")
    rings = (tsdb.MetricsTSDB(interval_s=1, retention_s=60),
             jtsdb.MetricsTSDB(interval_s=1, retention_s=60))
    _feed(metrics, STEPS, rings)
    port, jax = rings
    c, g, h = (f"wk_torch_tsdb_c{n}_total", f"wk_torch_tsdb_g{n}",
               f"wk_torch_tsdb_h{n}_us")
    assert port.rate(c, window_s) == jax.rate(c, window_s)
    assert port.rate(c, window_s, shard="0") == jax.rate(c, window_s,
                                                         shard="0")
    assert port.rate_by_label(c, "shard", window_s) == \
        jax.rate_by_label(c, "shard", window_s)
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert port.quantile(h, q, window_s) == jax.quantile(h, q, window_s)
    assert port.series(g, window_s) == jax.series(g, window_s)
    assert port.series(c, window_s, shard="2") == \
        jax.series(c, window_s, shard="2")
    assert port.latest(g) == jax.latest(g) == 3.0
    assert port.latest("no_such_metric") is jax.latest("no_such_metric")
    assert port.span_s() == jax.span_s() == 4.0
    assert len(port) == len(jax) == len(STEPS)


def test_retention_bounds_the_ring():
    """Age and count both bound the ring, the same way in both."""
    n, metrics = _pair("wk_torch_tsdb_ret")
    rings = (tsdb.MetricsTSDB(interval_s=1, retention_s=3),
             jtsdb.MetricsTSDB(interval_s=1, retention_s=3))
    steps = [({"0": k}, float(k), [k]) for k in range(1, 12)]
    _feed(metrics, steps, rings)
    port, jax = rings
    assert len(port) == len(jax) == 4  # 3 s of 1 s samples, inclusive
    # a burst faster than the interval: the count cap (retention/interval
    # + 8) holds, not the age
    _feed(metrics, [({"0": 1}, 1.0, [])] * 30, rings, t0_us=40_000_000,
          dt_us=1)
    assert len(port) == len(jax) == 3 + 8
    c = f"wk_torch_tsdb_ret_c{n}_total"
    assert port.rate(c) == jax.rate(c)
    assert port.retention_s == jax.retention_s == 3.0
    assert port.interval_s == jax.interval_s == 1.0


def test_counter_reset_clamps_and_empty_windows():
    n, metrics = _pair("wk_torch_tsdb_rst")
    rings = (tsdb.MetricsTSDB(interval_s=1, retention_s=60),
             jtsdb.MetricsTSDB(interval_s=1, retention_s=60))
    c = f"wk_torch_tsdb_rst_c{n}_total"
    h = f"wk_torch_tsdb_rst_h{n}_us"
    for ring in rings:
        assert ring.rate(c) is None and ring.quantile(h, 0.5) is None
        assert ring.rate_by_label(c, "shard") == {}
    _feed(metrics, STEPS[:1], rings)
    for ring in rings:  # one sample: no window yet
        assert ring.rate(c) is None and ring.span_s() == 0.0
    _feed(metrics, STEPS[1:3], rings, t0_us=11_000_000)
    assert rings[0].rate(c) == rings[1].rate(c) > 0


def test_report_rows_equal():
    """The history report's rows for this test's metrics: counter deltas
    and rates, histogram counts/means/p50/p99, gauge values."""
    n, metrics = _pair("wk_torch_tsdb_rep")
    rings = (tsdb.MetricsTSDB(interval_s=1, retention_s=60),
             jtsdb.MetricsTSDB(interval_s=1, retention_s=60))
    _feed(metrics, STEPS, rings)
    tag = f"wk_torch_tsdb_rep_"
    reps = [r.report(k=100000) for r in rings]
    for sec in ("counters", "histograms", "gauges"):
        mine = [[row for row in rep[sec] if row["name"].startswith(tag)]
                for rep in reps]
        assert mine[0] == mine[1] and mine[0], sec
    assert reps[0]["window_s"] == reps[1]["window_s"] == 4.0
    assert reps[0]["samples"] == reps[1]["samples"]


def test_process_ring_sampler_and_render(monkeypatch):
    """The process-wide ring, the sampler's knob gate and the history
    report's text, in both packages."""
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_tsdb", False)
    assert tsdb.maybe_start_tsdb() is None
    assert jtsdb.maybe_start_tsdb() is None
    text, js = tsdb.render_history()
    jtext, jjs = jtsdb.render_history()
    assert js["samples"] == jjs["samples"] == 0
    assert text == jtext  # the "need >=2 samples" form
    for G in (Global, JGlobal):
        monkeypatch.setattr(G, "enable_tsdb", True)
        monkeypatch.setattr(G, "tsdb_interval_s", 3600)
    try:
        s1 = tsdb.maybe_start_tsdb()
        assert s1 is not None and tsdb.maybe_start_tsdb() is s1
    finally:
        tsdb.stop_tsdb()
    n, metrics = _pair("wk_torch_tsdb_proc")
    _feed(metrics, STEPS, (tsdb.get_tsdb(), jtsdb.get_tsdb()))
    text, js = tsdb.render_history(k=1000)
    assert "COUNTER RATES over window" in text
    assert f"wk_torch_tsdb_proc_c{n}_total" in text
    assert js["samples"] == len(STEPS)


def test_history_verb(capsys):
    from wukong_tpu_torch.runtime.console import Console

    n, metrics = _pair("wk_torch_tsdb_verb")
    _feed(metrics, STEPS[:3], (tsdb.get_tsdb(),))
    Console(proxy=None).run_command("history -k 500 -w 100")
    out = capsys.readouterr().out
    assert out.startswith("wukong-history")
    assert f"wk_torch_tsdb_verb_h{n}_us" in out
    Console(proxy=None).run_command("history -j")
    assert '"samples": 3' in capsys.readouterr().out
