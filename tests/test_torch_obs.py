"""The port's exposition surfaces (``obs/export.py``, ``python -m
analytics_zoo_tpu_torch.obs``) against the JAX package's: the same
registry contents give byte-identical Prometheus text, the same spans give
equal ``trace_event`` documents, ``parse_exposition`` round-trips, and the
CLI's ``dump``/``perfetto`` run through ``main``. The ``ZOO_TRACE_PERFETTO``
writer runs in a subprocess. ``snapshot`` raises, naming ROADMAP A12.
"""

import json
import math
import os
import subprocess
import sys

import pytest

from analytics_zoo_tpu_torch.obs import export, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fill(obs_registry):
    """The same metrics into one package's fresh registry: counters and
    gauges with labels, a histogram, NaN/Inf values, and two collectors
    whose snapshot keys sanitize to one name."""
    reg = obs_registry.MetricsRegistry()
    c = reg.counter("zoo_demo_events_total", 'events "quoted"\nby kind',
                    labelnames=("inst", "event"))
    c.labels(inst="a", event="shed").inc(3)
    c.labels(inst='b\\"x', event="retry").inc(0.5)
    g = reg.gauge("zoo_demo_depth", "queue depth", labelnames=("stream",))
    g.labels(stream="s1").set(7)
    g.labels(stream="s2").set(float("nan"))
    reg.gauge("zoo_demo_inf", "infinite").set(math.inf)
    h = reg.histogram("zoo_demo_latency_seconds", "latency",
                      labelnames=("route",), buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.07):
        h.labels(route="/predict").observe(v)
    reg.register_collector("zoo_collect", lambda: {
        "h2d_s": 0.25, "h2d_bytes": 4096, "a-b": 1.0, "a_b": 2.0,
        "label": "not a number"})
    reg.register_collector("zoo_collect", lambda: {"h2d_s": 1.5})
    return reg


def test_prometheus_text_byte_identical_to_jax():
    from analytics_zoo_tpu.obs import export as jexport
    from analytics_zoo_tpu.obs import registry as jregistry

    from analytics_zoo_tpu_torch.obs import registry
    want = jexport.prometheus_text(_fill(jregistry))
    got = export.prometheus_text(_fill(registry))
    assert got == want
    assert "zoo_demo_latency_seconds_bucket" in got and "NaN" in got
    # parse_exposition round-trips: both parsers read the same samples
    parsed = export.parse_exposition(got)
    jparsed = jexport.parse_exposition(want)
    assert parsed.keys() == jparsed.keys()
    for k, v in jparsed.items():
        assert parsed[k] == v or (math.isnan(v) and math.isnan(parsed[k]))
    assert parsed['zoo_demo_events_total{event="shed",inst="a"}'] == 3.0
    assert parsed['zoo_demo_latency_seconds_count{route="/predict"}'] == 5.0
    with pytest.raises(ValueError, match="malformed"):
        export.parse_exposition("zoo bad line")


def _spans(Span):
    return [
        Span("fit", "t1", "s1", None, 100.0, 100.5, 11, "MainThread",
             {"epochs": 1}),
        Span("engine.dispatch", "t1", "s2", "s1", 100.1, 100.2, 11,
             "MainThread", {"step": 0, "obj": object.__name__}),
        Span("infeed.h2d", "t1", "s3", "s2", 100.05, 100.06, 12,
             "infeed-lane-0", {"bytes": 4096, "ok": True,
                               "shape": (2, 3)}),
    ]


def test_perfetto_trace_equal_to_jax(tmp_path):
    from analytics_zoo_tpu.obs import export as jexport
    from analytics_zoo_tpu.obs import trace as jtrace
    counters = {"h2d_s": 0.5, "flag": True, "name": "x"}
    want = jexport.perfetto_trace(_spans(jtrace.Span), counters)
    got = export.perfetto_trace(_spans(trace.Span), counters)
    assert got["traceEvents"] == want["traceEvents"]
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    path = export.write_perfetto(str(tmp_path / "sub" / "t.json"),
                                 _spans(trace.Span), counters)
    with open(path, encoding="utf-8") as f:
        assert json.load(f)["traceEvents"] == want["traceEvents"]


def test_demo_fit_exports_a_valid_timeline(tmp_path):
    """The CLI's demo fit (a one-layer module through ``TPUEstimator.fit``
    with a checkpoint trigger), here on the CPU: schema-valid
    trace_event JSON with one step-indexed dispatch segment per step."""
    with trace.tracing(capacity=4096):
        export._demo_fit(10, device="cpu")
        assert export.main(["perfetto", "--out",
                            str(tmp_path / "trace.json")]) == 0
    with open(tmp_path / "trace.json", encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    names = set()
    for e in events:
        assert e["ph"] in ("X", "M", "C")
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
            assert e["args"]["trace"] and e["args"]["span"]
            names.add(e["name"])
    assert {"fit", "epoch", "engine.dispatch", "ckpt.write"} <= names
    dispatch = [e for e in events
                if e["ph"] == "X" and e["name"] == "engine.dispatch"]
    assert sorted(e["args"]["step"] for e in dispatch) == list(range(10))
    tids = {e["tid"] for e in events if e["ph"] == "X"}
    assert tids <= {e["tid"] for e in events
                    if e["ph"] == "M" and e["name"] == "thread_name"}


def test_zoo_metrics_dump_cli(capsys):
    assert export.main(["dump"]) == 0
    export.parse_exposition(capsys.readouterr().out)
    assert export.main(["dump", "--json"]) == 0
    json.loads(capsys.readouterr().out)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        export.main(["snapshot", "serving"])
    with pytest.raises(SystemExit):
        export.main(["snapshot", "nope"])


def test_trace_perfetto_env_writes_at_exit(tmp_path):
    """``ZOO_TRACE_PERFETTO=<path>`` arms tracing at import and writes the
    ring at exit, once, also under ``python -m ...obs``."""
    out = tmp_path / "exit.json"
    env = dict(os.environ, PYTHONPATH=REPO, ZOO_TRACE_PERFETTO=str(out))
    code = ("from analytics_zoo_tpu_torch.obs import trace\n"
            "with trace.span('probe', k=1):\n"
            "    pass\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    with open(out, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert [e["args"]["k"] for e in events if e.get("name") == "probe"] \
        == [1]
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.obs", "dump"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    export.parse_exposition(proc.stdout)
    assert "could not write" not in proc.stderr
