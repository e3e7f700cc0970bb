"""Single registry for every ``ZOO_*`` environment knob.

Each plane used to document its own env vars in its own docstring; nothing
guaranteed the name in the docs matched the name the code read, and a typo'd
``os.environ.get("ZOO_H2D_LANE")`` failed silently back to the default. Every
knob now has exactly one row here — name, type, default, one-line doc — and
the repo lint (``analysis/repolint.py``) rejects ``os.environ`` reads of
``ZOO_*`` names that are not registered, so a new knob cannot ship without a
registry row and a doc line.

``knobs.get(name)`` is the typed accessor (env wins, else the registered
default). Reading a registered knob directly through ``os.environ`` stays
legal — many call sites need custom unset-vs-empty semantics — the contract
is only that the NAME is registered. ``python -m analytics_zoo_tpu_torch.common.knobs``
prints the registry as a markdown table (pasted into
``docs/performance_notes.md``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

__all__ = ["Knob", "REGISTRY", "get", "is_registered", "markdown_table"]

_FALSY = ("", "0", "false", "no", "off")


@dataclass(frozen=True)
class Knob:
    name: str
    type: str          # "int" | "float" | "bool" | "str"
    default: Any
    doc: str
    plane: str = ""    # which subsystem owns it (docs grouping)


def _k(name: str, type_: str, default: Any, plane: str, doc: str) -> Knob:
    return Knob(name=name, type=type_, default=default, doc=doc, plane=plane)


_KNOBS = [
    # --- infeed / transfer plane -------------------------------------------
    _k("ZOO_INFEED_WORKERS", "int", None, "infeed",
       "Assembly worker threads feeding the infeed pump (default: auto from "
       "CPU count)."),
    _k("ZOO_INFEED_BUDGET_MB", "int", 256, "infeed",
       "Host-memory budget bounding the pump's adaptive prefetch depth."),
    _k("ZOO_H2D_LANES", "int", 2, "transfer",
       "Parallel host-to-device transfer lanes behind the in-order FIFO "
       "window (cap 8)."),
    _k("ZOO_HOST_STAGING", "bool", None, "transfer",
       "Force the reusable host staging-buffer pool on/off (default: auto — "
       "on for non-CPU backends)."),
    # --- compile plane ------------------------------------------------------
    _k("ZOO_COMPILE_CACHE", "str", None, "compile",
       "Directory for the persistent executable cache (also enables JAX's "
       "own compilation cache under <dir>/xla)."),
    _k("ZOO_COMPILE_CACHE_DISABLE", "bool", False, "compile",
       "Disable the shared executable cache entirely (every consumer "
       "degrades to private jax.jit)."),
    # --- comms plane --------------------------------------------------------
    _k("ZOO_COMMS_PLANE", "bool", None, "comms",
       "Enter the comms plane with the flat per-leaf-psum reference wire "
       "(buckets/sharding off)."),
    _k("ZOO_GRAD_BUCKET_MB", "float", 0.0, "comms",
       "Target gradient bucket size for the reduce-scatter wire; 0 keeps "
       "the flat per-leaf wire."),
    _k("ZOO_SHARDED_UPDATE", "bool", False, "comms",
       "ZeRO-1: shard the optimizer update over the dp axis (each replica "
       "updates padded/N elements, then all-gathers params)."),
    _k("ZOO_ALLREDUCE_DTYPE", "str", "f32", "comms",
       "Gradient wire dtype: f32 | bf16 (real bf16 collective) | int8 "
       "(block-scaled; simulated wire by default, a real ppermute ring "
       "with ZOO_COMMS_NATIVE_INT8=1)."),
    _k("ZOO_ALLREDUCE_BLOCK", "int", 256, "comms",
       "Elements per int8 quantization scale block."),
    _k("ZOO_COMMS_OVERLAP", "bool", False, "comms",
       "Overlapped backward-comms pipeline: assemble each gradient bucket "
       "from its own leaf slices so its reduce-scatter launches as soon "
       "as those grads exist, hiding wire time behind backward compute."),
    _k("ZOO_COMMS_SEGMENTS", "int", 0, "comms",
       "Dependency-island override for the overlapped pipeline: 0 = one "
       "segment per bucket (max overlap), 1 = classic post-backward wire, "
       "N = buckets coalesced into N contiguous groups."),
    _k("ZOO_COMMS_HIERARCHY", "bool", False, "comms",
       "Two-level ICI x DCN gradient wire: reduce-scatter inside each "
       "host group, exchange only the already-reduced 1/ici chunks "
       "across hosts — DCN moves 1/ici of the flat wire's bytes."),
    _k("ZOO_COMMS_DCN_AXIS", "int", 0, "comms",
       "Host-group count for the hierarchical wire: 0 = probe process "
       "locality (mesh.dp_topology), N = force an N-host factorization "
       "of the dp axis (the simulated mesh's stand-in for a pod)."),
    _k("ZOO_COMMS_QUANTIZE_DCN", "bool", True, "comms",
       "With the hierarchical wire and a non-f32 allreduce dtype, "
       "quantize only the cross-host (DCN) leg — the ICI leg reduces "
       "exact f32. 0 = quantize the whole wire as the classic path does."),
    _k("ZOO_COMMS_NATIVE_INT8", "bool", False, "comms",
       "Native int8 collectives: replace the simulated int8 wire "
       "(dequantize, then f32 reduce) with a shard_map ppermute ring "
       "reduce-scatter whose hops really move int8 payloads + f32 block "
       "scales — the full dp axis on the classic bucketed wire, each DCN "
       "group on the hierarchical wire (ICI stays exact f32). Requires "
       "ZOO_ALLREDUCE_DTYPE=int8."),
    _k("ZOO_EMBED_GRAD_MODE", "str", "auto", "comms",
       "Embedding gradient exchange: auto | dense | sparse."),
    # --- sharding plane -----------------------------------------------------
    _k("ZOO_MESH_AXES", "str", None, "sharding",
       "Default mesh factorization for init_orca_context when no mesh_axes "
       "are passed, e.g. 'dp=1,fsdp=4,tp=2' (one axis may be -1 to absorb "
       "the remaining devices)."),
    _k("ZOO_SHARDING_PLANE", "bool", None, "sharding",
       "Enter the sharding plane with the default SpecLayout: fsdp "
       "param sharding (bucketed gathers) for unmatched big f32 leaves "
       "plus the canonical tp/embedding rules."),
    _k("ZOO_FSDP_BUCKET_MB", "float", None, "sharding",
       "Target fsdp gather-bucket size; overrides SpecLayout.bucket_mb "
       "(default 4.0). One all-gather per bucket fires inside the "
       "forward, so fewer/larger buckets trade launch count for HBM "
       "high-water."),
    # --- checkpoint plane ---------------------------------------------------
    _k("ZOO_CKPT_IO_RETRIES", "int", 2, "ckpt",
       "Retries for a failed checkpoint blob write before the writer "
       "records the error (exp backoff)."),
    # --- resilience plane ---------------------------------------------------
    _k("ZOO_FAULTS", "str", None, "resilience",
       "Fault-injection spec armed at import, e.g. "
       "'engine.dispatch:prob=0.01,kind=crash'."),
    _k("ZOO_FAULT_SEED", "int", 0, "resilience",
       "Seed for the per-site fault RNG streams (a fixed seed replays the "
       "exact fire pattern)."),
    _k("ZOO_DISPATCH_TIMEOUT_S", "float", None, "resilience",
       "Watchdog bound on one device dispatch / H2D placement; unset "
       "disables hang detection."),
    _k("ZOO_SUPERVISOR_REINIT_BACKEND", "bool", False, "resilience",
       "On classified device loss, additionally clear JAX backends before "
       "the supervisor rebuilds."),
    _k("ZOO_BROKER_RECONNECT_RETRIES", "int", 4, "serving",
       "Redis broker reconnect attempts before giving up."),
    _k("ZOO_BROKER_RECONNECT_BACKOFF_S", "float", 0.2, "serving",
       "Base backoff between broker reconnect attempts."),
    # --- serving scheduler --------------------------------------------------
    _k("ZOO_SERVING_BATCH_SIZE", "int", 32, "serving",
       "Max records per dispatched batch (the shape-bucket cap the "
       "continuous former fills toward; the fixed policy's claim size)."),
    _k("ZOO_SERVING_BATCH_TIMEOUT_MS", "float", 5.0, "serving",
       "Broker idle-claim poll (and the legacy fixed policy's batch "
       "formation stall). The continuous former never stalls on it."),
    _k("ZOO_SERVING_MAX_INFLIGHT", "int", 256, "serving",
       "Bound on admitted (decoded, queued or dispatching) requests across "
       "all models; the claim pump stops claiming at the bound so memory "
       "stays bounded ahead of the deadline shedder."),
    _k("ZOO_SERVING_SLACK_MS", "float", 5.0, "serving",
       "Dispatch-now threshold: a formed batch is dispatched immediately "
       "once its head request's deadline slack drops to this."),
    # --- serving fleet (scale-out tier) -------------------------------------
    _k("ZOO_FLEET_WORKERS", "int", 1, "fleet",
       "Initial worker-process count a ServingFleet spawns (the floor the "
       "autoscaler never drops below)."),
    _k("ZOO_FLEET_MAX_WORKERS", "int", 4, "fleet",
       "Ceiling on worker processes — shared-nothing fan-out stops here "
       "even under sustained saturation (one worker per chip set)."),
    _k("ZOO_FLEET_SCALE_OCCUPANCY", "float", 0.75, "fleet",
       "Scale-up threshold on mean worker occupancy (busy-seconds rate); "
       "sustained occupancy at or above it adds a worker."),
    _k("ZOO_FLEET_IDLE_OCCUPANCY", "float", 0.15, "fleet",
       "Scale-down threshold: mean occupancy at or below it with an empty "
       "backlog, sustained, retires a worker."),
    _k("ZOO_FLEET_SCALE_UP_SUSTAIN_S", "float", 1.0, "fleet",
       "How long saturation must persist before a scale-up (rejects "
       "one-tick spikes)."),
    _k("ZOO_FLEET_SCALE_DOWN_SUSTAIN_S", "float", 5.0, "fleet",
       "How long idleness must persist before a scale-down (longer than "
       "the up-sustain: capacity is cheap to keep, misses are not)."),
    _k("ZOO_FLEET_SCALE_COOLDOWN_S", "float", 5.0, "fleet",
       "Dead time after any scale action during which the autoscaler "
       "holds — the hysteresis that stops worker-count flapping."),
    _k("ZOO_FLEET_QUEUE_AGE_SHED_MS", "float", 0.0, "fleet",
       "Frontend queue-age shed: when the broker's head-of-line entry is "
       "older than this, /predict replies 429 + Retry-After BEFORE "
       "enqueueing. 0 disables."),
    _k("ZOO_FLEET_HEARTBEAT_S", "float", 0.5, "fleet",
       "Worker heartbeat period through the broker (liveness + occupancy "
       "stats for the autoscaler and /readyz)."),
    _k("ZOO_FLEET_WORKER_TTL_S", "float", 3.0, "fleet",
       "A worker whose last heartbeat is older than this is presumed "
       "dead: dropped from live_workers, its pending claims left to "
       "idle-reclaim."),
    # --- streaming plane ----------------------------------------------------
    _k("ZOO_STREAM_WINDOW_RECORDS", "int", 1024, "streaming",
       "Records per training window (rounded up to a whole number of "
       "batches so every window reuses one warm executable)."),
    _k("ZOO_STREAM_WINDOW_AGE_S", "float", 2.0, "streaming",
       "Close an under-filled window after this many seconds, training "
       "the largest whole-batch prefix (the freshness bound under low "
       "traffic)."),
    _k("ZOO_STREAM_WATERMARK_S", "float", 30.0, "streaming",
       "Allowed event-time lateness: the watermark trails the max event "
       "time seen by this many seconds; older records are late."),
    _k("ZOO_STREAM_LATE_POLICY", "str", "drop", "streaming",
       "What to do with late records: drop (ack + count) | include "
       "(train anyway)."),
    _k("ZOO_STREAM_MAX_BACKLOG", "int", 100000, "streaming",
       "Broker backlog bound: past it, claimed records are shed (acked "
       "unseen) until the consumer catches up — freshness over "
       "completeness; shedding breaks bit-exact replay."),
    _k("ZOO_STREAM_POLL_TIMEOUT_S", "float", 0.2, "streaming",
       "Blocking-claim timeout per broker poll while a window "
       "accumulates."),
    _k("ZOO_STREAM_CONSUMERS", "int", 1, "streaming",
       "Trainer-process count a StreamingFleet spawns — one shared-"
       "nothing consumer per stream partition, each committing into its "
       "own per-partition checkpoint namespace."),
    _k("ZOO_STREAM_PARTITION_BY", "str", "key", "streaming",
       "What routes a record to its partition at the fan-out broker: "
       "key (the producer-stamped record key, falling back to the id "
       "for keyless records) | id (always the record id — uniform "
       "spread, but one logical key may straddle partitions)."),
    _k("ZOO_STREAM_GUARD_HOLDOUT", "int", 256, "streaming",
       "Sliding holdout-window capacity (records) the online guardrail "
       "scores every streaming commit against before serving adopts "
       "it."),
    _k("ZOO_STREAM_GUARD_MIN_HOLDOUT", "int", 64, "streaming",
       "Below this many holdout records the guardrail verdict is "
       "'insufficient': the commit is adopted (bootstrap must not "
       "stall) but counted."),
    _k("ZOO_STREAM_GUARD_REGRESSION", "float", 0.2, "streaming",
       "Relative score regression vs the baseline (best recently-"
       "accepted score) that REJECTS adoption: reject when score > "
       "baseline * (1 + this)."),
    _k("ZOO_STREAM_GUARD_BASELINE_WINDOW", "int", 8, "streaming",
       "Accepted-commit scores retained for the guardrail baseline "
       "(best-of window; rejected scores never enter it, so one bad "
       "window cannot ratchet the bar down)."),
    # --- shm object plane ---------------------------------------------------
    _k("ZOO_SHM", "bool", False, "shm",
       "Zero-copy shared-memory object plane: broker messages on local "
       "transports (memory/file, plus redis on localhost) carry slab "
       "descriptors instead of payload bytes; consumers map the slab "
       "read-only. 0 = today's inline wire, byte for byte."),
    _k("ZOO_SHM_SLAB_MB", "float", 1.0, "shm",
       "Slab granularity of the shared-memory arena (allocation unit; an "
       "object takes a contiguous run of slabs). Size it near the typical "
       "payload: much larger wastes arena, much smaller fragments it."),
    _k("ZOO_SHM_ARENA_MB", "int", 64, "shm",
       "Bytes per shared-memory segment; the arena grows segment by "
       "segment on demand (bounded), and payloads that do not fit fall "
       "back to the inline wire."),
    _k("ZOO_SHM_MIN_BYTES", "int", 65536, "shm",
       "Payloads smaller than this ride the inline wire even with "
       "ZOO_SHM=1: below it the descriptor overhead (slab burn, index "
       "lock, lease writes) exceeds the copy savings. 0 = every payload "
       "takes the descriptor path."),
    # --- multihost ----------------------------------------------------------
    _k("ZOO_COORDINATOR", "str", None, "multihost",
       "host:port of the jax.distributed coordinator for multi-process "
       "runs."),
    _k("ZOO_NUM_PROCS", "int", None, "multihost",
       "Total process count for jax.distributed initialization."),
    _k("ZOO_PROC_ID", "int", None, "multihost",
       "This process's index for jax.distributed initialization."),
    _k("ZOO_COORDINATOR_PORT", "int", 8476, "multihost",
       "Coordinator port scripts/launch_multihost.sh binds when deriving "
       "ZOO_COORDINATOR from the host list."),
    # --- bench --------------------------------------------------------------
    _k("ZOO_BENCH_FORCED_CPU", "bool", False, "bench",
       "Internal marker set by bench.py's guarded re-exec after TPU init "
       "failure (prevents a retry loop)."),
    # --- observability plane ------------------------------------------------
    _k("ZOO_OBS", "bool", True, "obs",
       "Register plane stats objects (PipelineStats, CkptStats) as "
       "collector adapters on the unified registry; 0 decouples them "
       "from the exposition. Registry-native counters (serving, "
       "resilience) ARE those planes' own store and stay on."),
    _k("ZOO_TRACE", "bool", False, "obs",
       "Arm structured span tracing at import (one trace id across "
       "fit/infeed/ckpt/supervisor/serving; export via zoo-metrics)."),
    _k("ZOO_TRACE_RING", "int", 4096, "obs",
       "Span ring-buffer capacity; the oldest spans are evicted, never "
       "the process."),
    _k("ZOO_TRACE_PERFETTO", "str", None, "obs",
       "Path to write the span ring as Chrome/Perfetto trace_event JSON "
       "at process exit (implies arming, like ZOO_TRACE=1)."),
    # --- analysis plane -----------------------------------------------------
    _k("ZOO_HLO_LINT", "str", "warn", "analysis",
       "StableHLO linter on every compile-plane lowering: warn (log + "
       "report) | strict (raise on error-severity) | 0 (off)."),
    _k("ZOO_LINT_DONATION_MB", "float", 64.0, "analysis",
       "hlo-lint threshold: an undonated input buffer at least this large "
       "in a donating program is flagged."),
    _k("ZOO_RACE_DETECT", "bool", False, "analysis",
       "Enable the runtime race detector (traced locks + lock-order graph) "
       "for the whole test session."),
]

REGISTRY: Dict[str, Knob] = {k.name: k for k in _KNOBS}

_UNSET = object()


def is_registered(name: str) -> bool:
    return name in REGISTRY


def _coerce(knob: Knob, raw: str):
    if knob.type == "bool":
        return raw.strip().lower() not in _FALSY
    if knob.type == "int":
        return int(raw)
    if knob.type == "float":
        return float(raw)
    return raw


def get(name: str, default: Any = _UNSET) -> Any:
    """Typed read of a registered knob: the environment wins, else
    ``default`` (when given), else the registered default. Unset or
    empty-string env values mean "not set". Raises ``KeyError`` for an
    unregistered name — the point of the registry is that those don't
    exist."""
    knob = REGISTRY.get(name)
    if knob is None:
        raise KeyError(
            f"{name} is not a registered ZOO_* knob; add it to "
            f"analytics_zoo_tpu_torch/common/knobs.py (the repo lint enforces "
            f"this)")
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return knob.default if default is _UNSET else default
    try:
        return _coerce(knob, raw)
    except ValueError as e:
        raise ValueError(
            f"{name}={raw!r} is not a valid {knob.type}: {e}") from e


def markdown_table(plane: Optional[str] = None) -> str:
    """The registry as a markdown table (docs/performance_notes.md pastes
    this; regenerate with ``python -m analytics_zoo_tpu_torch.common.knobs``)."""
    rows = ["| knob | type | default | plane | what it does |",
            "|---|---|---|---|---|"]
    for k in _KNOBS:
        if plane is not None and k.plane != plane:
            continue
        default = "auto/unset" if k.default is None else repr(k.default)
        doc = k.doc.replace("|", "\\|")     # literal pipes break the table
        rows.append(f"| `{k.name}` | {k.type} | {default} | {k.plane} "
                    f"| {doc} |")
    return "\n".join(rows)


def main() -> int:
    print(markdown_table())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
