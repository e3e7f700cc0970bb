"""Exposition surfaces for the observability plane (counterpart of
``analytics_zoo_tpu/obs/export.py``).

* :func:`prometheus_text` — the registry (typed families + collector
  adapters) as Prometheus text exposition format 0.0.4. Served by the
  serving frontend at ``GET /metrics.prom`` (next to the byte-compatible
  JSON ``/metrics``) and dumped by the ``zoo-metrics`` CLI.
* :func:`perfetto_trace` / :func:`write_perfetto` — the span ring as
  Chrome/Perfetto ``trace_event`` JSON: one complete ("ph": "X") event per
  span on its recording thread's track, per-step device-dispatch segments
  included (the engine's ``engine.dispatch`` spans carry the step index
  from its existing timers). Load the file at https://ui.perfetto.dev or
  chrome://tracing.
* the ``zoo-metrics`` CLI, run as ``python -m
  analytics_zoo_tpu_torch.obs`` (the package form, so the module body
  runs once):

  - ``dump [--json]`` — current registry exposition
  - ``perfetto --out FILE [--demo-steps N]`` — span-ring export
    (optionally generating an N-step traced demo fit first, on the
    card; it raises without one)
  - ``snapshot <plane>`` — the per-plane snapshot lines need
    ``obs/snapshots.py``, which drives the comms, sharding and analysis
    planes this package does not have yet (ROADMAP A12): it raises

``ZOO_TRACE_PERFETTO=<path>`` arms tracing at import and writes the ring
to ``<path>`` at process exit.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Dict, Iterable, List, Optional

from ..common import knobs
from . import trace as trace_mod
from .registry import REGISTRY, MetricsRegistry, _HistValue, sanitize

__all__ = ["prometheus_text", "perfetto_trace", "write_perfetto", "main"]


# --- Prometheus text exposition ---------------------------------------------

def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(labels: Dict[str, str], extra: Optional[Dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{sanitize(k)}="{_escape_label(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, float) and math.isnan(v):
        return "NaN"        # the text format's spelling; repr gives "nan"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """The whole registry in Prometheus text exposition format (0.0.4):
    ``# HELP`` / ``# TYPE`` headers, labeled samples, histograms with
    cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``. Collector
    adapters (PipelineStats, CkptStats, CompileStats instances) are
    exposed as untyped-but-gauge-shaped families under their registered
    prefix."""
    reg = registry if registry is not None else REGISTRY
    lines: List[str] = []
    for fam in reg.families():
        doc = fam.doc.replace("\\", r"\\").replace("\n", r"\n")
        lines.append(f"# HELP {fam.name} {doc}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for labels, child in fam.samples():
            if isinstance(child, _HistValue):
                # one locked snapshot: reading sum/count off the live child
                # after snapshotting the buckets could emit _count > the
                # +Inf bucket if an observe() lands in between
                snap = child.snapshot()
                for b, c in zip(child.buckets, snap["buckets"]):
                    # counts are already cumulative per bucket
                    le = "+Inf" if math.isinf(b) else _fmt_value(float(b))
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_fmt_labels(labels, {'le': le})} {c}")
                lines.append(f"{fam.name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(snap['sum'])}")
                lines.append(f"{fam.name}_count{_fmt_labels(labels)} "
                             f"{snap['count']}")
            else:
                lines.append(f"{fam.name}{_fmt_labels(labels)} "
                             f"{_fmt_value(child.value)}")
    # group collector samples by metric name first: two live instances
    # registered under one prefix (e.g. concurrent AutoML PipelineStats)
    # would otherwise interleave families, and the text format requires
    # all lines of a metric to form one contiguous group
    grouped: Dict[str, List[str]] = {}
    seen_series = set()
    for name, labels, value in reg.collector_samples():
        series = f"{name}{_fmt_labels(labels)}"
        # two snapshot keys can sanitize to one name ('a-b' and 'a_b');
        # emitting both would be a duplicate series, which makes a real
        # Prometheus server reject the whole scrape — keep the first
        if series in seen_series:
            continue
        seen_series.add(series)
        grouped.setdefault(name, []).append(
            f"{series} {_fmt_value(value)}")
    for name, samples in grouped.items():
        lines.append(f"# TYPE {name} gauge")
        lines.extend(samples)
    return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> Dict[str, float]:
    """Minimal strict parser for the text format — the bench/tests use it
    to prove the exposition is machine-readable, not just printable.
    Returns ``{name{labels}: value}``; raises ``ValueError`` on any
    malformed line."""
    import re
    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
        r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
        r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
        r' ([-+]?(?:[0-9.eE+-]+|Inf|NaN))$')
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = sample_re.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line: {line!r}")
        val = m.group(3)
        out[m.group(1) + (m.group(2) or "")] = float(
            val.replace("Inf", "inf"))
    return out


# --- Perfetto / Chrome trace_event ------------------------------------------

def perfetto_trace(span_list: Optional[Iterable] = None,
                   counters: Optional[Dict[str, float]] = None) -> Dict:
    """Span ring → Chrome ``trace_event`` JSON (the dict; dump with
    ``json.dump``). Every span becomes a complete event on its recording
    thread's track; thread-name metadata events label the tracks (training
    loop, infeed lanes, ckpt writer, serving workers). ``counters``
    optionally adds one counter event per entry at t=0 (e.g. a
    PipelineStats snapshot)."""
    spans = list(span_list) if span_list is not None else trace_mod.spans()
    pid = os.getpid()
    events: List[Dict] = []
    named = {}
    for s in spans:
        if s.thread not in named:
            named[s.thread] = s.thread_name
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": s.thread,
                           "args": {"name": s.thread_name}})
    t_base = min((s.t0 for s in spans), default=0.0)
    for s in spans:
        args = {"trace": s.trace_id, "span": s.span_id}
        if s.parent_id:
            args["parent"] = s.parent_id
        for k, v in s.attrs.items():
            args[str(k)] = v if isinstance(v, (int, float, bool, str)) \
                else repr(v)
        events.append({
            "ph": "X", "name": s.name, "cat": s.name.split(".")[0],
            "pid": pid, "tid": s.thread,
            "ts": round((s.t0 - t_base) * 1e6, 3),
            "dur": round(max(s.t1 - s.t0, 0.0) * 1e6, 3),
            "args": args})
    if counters:
        for name, value in counters.items():
            if isinstance(value, (int, float)) and not isinstance(value,
                                                                  bool):
                events.append({"ph": "C", "name": sanitize(name),
                               "pid": pid, "tid": 0, "ts": 0,
                               "args": {"value": value}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"producer": "analytics-zoo-tpu-torch obs plane"}}


def write_perfetto(path: str, span_list: Optional[Iterable] = None,
                   counters: Optional[Dict[str, float]] = None) -> str:
    doc = perfetto_trace(span_list, counters)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return path


# --- CLI ---------------------------------------------------------------------

def _demo_fit(steps: int, device=None):
    """A tiny traced fit so ``perfetto --demo-steps`` has a real timeline
    to export: fit → epoch → engine.dispatch through the production pump,
    plus a checkpoint write. ``device`` as the estimator takes it (None:
    the card)."""
    import tempfile

    import numpy as np
    from torch import nn

    from ..orca.learn.estimator import TPUEstimator
    from ..orca.learn.trigger import SeveralIteration

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = nn.Linear(8, 1)

        def forward(self, x):
            return self.dense(x)[:, 0]

    rng = np.random.RandomState(0)
    batch = 32
    with tempfile.TemporaryDirectory() as d:
        est = TPUEstimator(M(), loss="mse", optimizer="adam", model_dir=d,
                           seed=0, config={"steps_per_dispatch": 1},
                           device=device)
        est.fit({"x": rng.rand(batch * steps, 8).astype(np.float32),
                 "y": rng.rand(batch * steps).astype(np.float32)},
                epochs=1, batch_size=batch,
                checkpoint_trigger=SeveralIteration(max(steps // 2, 1)),
                verbose=False)
        est.shutdown()


# the planes the JAX package's ``zoo-metrics snapshot`` accepts
SNAPSHOT_PLANES = ("transfer", "ckpt", "comms", "sharding", "resilience",
                   "serving", "fleet", "streaming", "shm", "analysis", "obs")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.obs",
        description="observability-plane CLI: Prometheus dump, Perfetto "
                    "span export, per-plane snapshots")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("dump", help="print the registry as Prometheus text "
                                "exposition").add_argument(
        "--json", action="store_true", help="JSON snapshot instead")
    pp = sub.add_parser("perfetto", help="export the span ring as "
                                         "trace_event JSON")
    pp.add_argument("--out", required=True, help="output .json path")
    pp.add_argument("--demo-steps", type=int, default=0,
                    help="first run an N-step traced demo fit so the "
                         "export has a timeline")
    sp = sub.add_parser("snapshot",
                        help="print one plane's snapshot line (not ported "
                             "yet: ROADMAP A12)")
    sp.add_argument("plane", choices=SNAPSHOT_PLANES)
    args = ap.parse_args(argv)

    if args.cmd == "dump":
        if getattr(args, "json", False):
            print(json.dumps(REGISTRY.snapshot(), indent=1, sort_keys=True))
        else:
            print(prometheus_text(), end="")
        return 0
    if args.cmd == "perfetto":
        if args.demo_steps > 0:
            trace_mod.arm()
            _demo_fit(args.demo_steps)
        path = write_perfetto(args.out)
        print(f"wrote {len(trace_mod.spans())} span(s) to {path}")
        return 0
    if args.cmd == "snapshot":
        raise NotImplementedError(
            f"zoo-metrics snapshot {args.plane}: obs/snapshots.py drives "
            "the comms, sharding and analysis planes, which this package "
            "does not have yet (ROADMAP A12)")
    return 2


# ZOO_TRACE_PERFETTO: arm now, write the ring at exit — the zero-setup way
# to get a step timeline out of any run (bench, tests, production drills).
# The sentinel lives on the trace module (of which sys.modules holds
# exactly one copy) so a runpy ``__main__`` re-execution of THIS module
# cannot register a second atexit writer.
_perfetto_path = knobs.get("ZOO_TRACE_PERFETTO")
if _perfetto_path and not getattr(trace_mod, "_perfetto_atexit", False):
    import atexit

    trace_mod._perfetto_atexit = True
    trace_mod.arm()
    _perfetto_lock = threading.Lock()

    def _write_at_exit(path=_perfetto_path):
        with _perfetto_lock:    # atexit + explicit call must not interleave
            try:
                write_perfetto(path)
            except OSError as e:
                import logging
                logging.getLogger("analytics_zoo_tpu_torch").warning(
                    "ZOO_TRACE_PERFETTO: could not write %s: %s", path, e)

    atexit.register(_write_at_exit)


if __name__ == "__main__":
    raise SystemExit(main())
