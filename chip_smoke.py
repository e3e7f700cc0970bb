"""Chip smoke for the PyTorch/CUDA port (analytics_zoo_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``analytics_zoo_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, then
serves a BERT-Base classifier (google-research/bert's BERT-Base, Uncased
widths: vocab 30522, hidden 768, 12 layers, 12 heads, intermediate 3072,
512 positions; seeded random weights) through ``InferenceModel`` and
``ClusterServing`` and checks that the served answers went through the
kernels and match the same weights run on the CPU. Each phase prints one
JSON line; any failure raises and exits non-zero. The last line is
``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEQ = 128                   # request length: token ids, no input mask
N_REQUESTS = 256
BATCH = 32
N_CPU_CHECK = 8             # requests re-run on the CPU for the logits check
# Kernel vs plain tolerances. f32: both sum in f32 in a different order;
# measured errors are ~1e-6 on outputs of magnitude <= 4. bf16: the output
# is rounded to bf16 on both sides, so one ulp (2^-8 relative, 1.6e-2 at 4)
# may separate them. lse2 is f32 on both sides.
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
TOL_LSE = 1e-5
# Served (card) vs CPU logits, both f32 with TF32 off: the two differ by
# the summation order of every matmul and of the attention through 12
# layers (measured ~6e-7 on logits of magnitude ~0.6).
TOL_SERVED = 1e-4
# Peaks of one H100 SXM (NVIDIA data sheet, dense): FP32 outside the tensor
# cores, BF16 on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


def device_phase():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return card


def build_phase():
    from analytics_zoo_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    libs = _kernels.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": {k: os.path.relpath(v) for k, v in libs.items()}})


def _qkv_views(b, s_q, s_k, h, d, dtype, gen):
    """q, k, v as the main path gives them: (B, S, H, D) strided views of
    one fused projection output (q from its own tensor when s_q != s_k)."""
    qkv = torch.randn(b, s_k, 3 * h * d, device="cuda", generator=gen)
    qkv = qkv.to(dtype)
    k = qkv[..., h * d:2 * h * d].view(b, s_k, h, d)
    v = qkv[..., 2 * h * d:].view(b, s_k, h, d)
    if s_q == s_k:
        q = qkv[..., :h * d].view(b, s_q, h, d)
    else:
        q = torch.randn(b, s_q, h, d, device="cuda", generator=gen).to(dtype)
    return q, k, v


def kernel_phase():
    from analytics_zoo_tpu_torch.ops.attention import (flash_attention_plain,
                                                       flash_fwd)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("f32", torch.float32, 128, 128, False),
             ("f32_causal", torch.float32, 128, 128, True),
             ("bf16", torch.bfloat16, 128, 128, False),
             ("bf16_causal", torch.bfloat16, 128, 128, True),
             ("f32_causal_decode", torch.float32, 128, 512, True),
             ("bf16_causal_decode", torch.bfloat16, 128, 512, True)]
    errs = {}
    for name, dtype, s_q, s_k, causal in cases:
        q, k, v = _qkv_views(BATCH, s_q, s_k, 12, 64, dtype, gen)
        out, lse = flash_fwd(q, k, v, causal=causal, with_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        ok = (err <= tol and lse_err <= TOL_LSE
              and bool(torch.isfinite(out).all()))
        emit({"phase": "kernel_vs_plain", "kernel": "flash_fwd",
              "case": name, "shape": [BATCH, s_q, s_k, 12, 64],
              "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
              "lse_tol": TOL_LSE, "ok": ok})
        if not ok:
            fail(f"flash_fwd disagrees with its plain version ({name})")
        errs[name] = err
    return errs


def _bert_state(module, seed):
    """Seeded random weights from numpy for every entry of the state
    dict: N(0, 0.02) for matrices, tables and biases, 1 + N(0, 0.02) for
    LayerNorm scales."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, t in module.state_dict().items():
        w = rng.standard_normal(tuple(t.shape), dtype=np.float32) * 0.02
        if "norm" in key and key.endswith("weight"):
            w += 1.0
        state[key] = torch.from_numpy(w)
    return state


def serve_phase(card):
    from analytics_zoo_tpu_torch.ops.attention import flash_fwd
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 InMemoryBroker, InputQueue,
                                                 OutputQueue)
    from analytics_zoo_tpu_torch.tfpark.text.estimator import (BERT_BASE,
                                                               _BertWithHead)

    t0 = time.perf_counter()
    cfg = tuple(sorted(BERT_BASE.items()))
    torch.manual_seed(0)
    card_module = _BertWithHead(cfg, num_out=2)
    state = _bert_state(card_module, seed=0)
    model = InferenceModel(device="cuda").load_module(card_module, state)
    n_layers = BERT_BASE["n_block"]
    ids = np.random.default_rng(1).integers(
        0, BERT_BASE["vocab"], (N_REQUESTS, SEQ)).astype(np.int32)

    broker = InMemoryBroker()
    serving = ClusterServing(model, queue=broker, batch_size=BATCH)
    t_pre = time.perf_counter()
    serving.start(example=ids[:1])     # precompile: warms every bucket
    precompile_s = time.perf_counter() - t_pre
    inq, outq = InputQueue(broker), OutputQueue(broker)
    try:
        entry = serving.mux.default
        batches0 = entry.batches
        flash_fwd.launches = 0          # the main path starts here
        t_enq = {}
        t_start = time.time()
        for i in range(N_REQUESTS):
            uri = f"req-{i}"
            t_enq[uri] = time.time()
            inq.enqueue(uri, t=ids[i])
        # answers are fetched in enqueue order; a request's latency runs
        # from its enqueue to the moment the client holds its answer
        answers, t_done = {}, {}
        for uri in t_enq:
            data = outq.query(uri, timeout_s=120.0)
            if not isinstance(data, np.ndarray):
                fail(f"no answer for {uri}: {data!r}")
            answers[uri], t_done[uri] = data, time.time()
    finally:
        serving.stop()      # joins the workers: their counters are final
    torch.cuda.synchronize()
    launches = flash_fwd.launches       # the main path ends here
    batches = entry.batches - batches0
    stages = serving.metrics()["stages"]
    served = np.stack([answers[f"req-{i}"] for i in range(N_REQUESTS)])
    if served.shape != (N_REQUESTS, 2) or not np.isfinite(served).all():
        fail(f"served logits malformed: shape {served.shape}")
    if launches != n_layers * batches:
        fail(f"flash_fwd launched {launches} times for {batches} batches "
             f"of a {n_layers}-layer model")
    lat = sorted((t_done[u] - t_enq[u]) * 1e3 for u in t_enq)
    wall = max(t_done.values()) - t_start

    cpu_module = _BertWithHead(cfg, num_out=2)
    cpu_model = InferenceModel(device="cpu").load_module(cpu_module, state)
    cpu_logits = cpu_model.predict(ids[:N_CPU_CHECK])
    err = float(np.abs(served[:N_CPU_CHECK] - cpu_logits).max())
    if not err <= TOL_SERVED:
        fail(f"served logits differ from the CPU forward by {err}")
    emit({"phase": "serve", "model": "BERT-Base (uncased widths), 2 classes",
          "requests": N_REQUESTS, "answered": len(answers),
          "seq_len": SEQ, "batch_size": BATCH, "batches": batches,
          "flash_fwd_launches": launches, "layers": n_layers,
          "precompile_s": precompile_s,
          "records_per_s": N_REQUESTS / wall,
          "latency_ms_p50": float(np.percentile(lat, 50)),
          "latency_ms_p99": float(np.percentile(lat, 99)),
          "served_vs_cpu_max_abs_err": err, "tol": TOL_SERVED,
          "logit_abs_max": float(np.abs(served).max()),
          "stages_ms": {k: {m: v[m] for m in ("count", "mean_ms", "p50_ms")}
                        for k, v in stages.items()},
          "card": card, "setup_s": t_pre - t0})
    return launches, model, ids


def profile_phase(model, ids, card):
    """Where one full served batch spends device time: torch.profiler
    over one ``predict`` of BATCH x SEQ, kernel time summed by class."""
    from torch.profiler import ProfilerActivity, profile
    batch = ids[:BATCH]
    model.predict(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class = {"flash_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        name = evt.name.lower()
        cls = ("flash_fwd" if "flash_fwd" in name else
               "gemm" if ("gemm" in name or "xmma" in name
                          or "cutlass" in name) else "other")
        by_class[cls] += evt.time_range.elapsed_us() / 1e3
    device_ms = sum(by_class.values())
    emit({"phase": "profile", "batch": [BATCH, SEQ], "wall_ms": wall_ms,
          "device_ms": device_ms, "device_ms_by_class": by_class,
          "kernels": n_kernels,
          "device_idle_share": (1.0 - device_ms / wall_ms) if device_ms
          else None, "card": card})


def _time_ms(fn, reps=50, rounds=7):
    """Median over rounds of the mean time of ``reps`` back-to-back calls,
    from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernels_line(errs, launches):
    from analytics_zoo_tpu_torch.ops.attention import (flash_attention_plain,
                                                       flash_fwd)
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, s, h, d = BATCH, SEQ, 12, 64
    dtype = torch.float32
    q, k, v = _qkv_views(b, s, s, h, d, dtype, gen)
    kept = flash_fwd.launches
    ms = _time_ms(lambda: flash_fwd(q, k, v))
    plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v), reps=10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _time_ms(lambda: sdpa(qt, kt, vt))
    flash_fwd.launches = kept       # timing launches are not the main path's
    flops = 4.0 * b * h * s * s * d
    nbytes = 4.0 * b * s * h * d * q.element_size()   # q, k, v read; o written
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "analytics_zoo_tpu/ops/attention.py:136",
        "launches": launches, "max_abs_err": errs["f32"],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": [b, s, h, d], "dtype": "float32",
        "flops": flops, "bytes": nbytes}]})


def main():
    card = device_phase()
    import analytics_zoo_tpu_torch  # noqa: F401  (fails outside the repo)
    build_phase()
    errs = kernel_phase()
    launches, model, ids = serve_phase(card)
    profile_phase(model, ids, card)
    kernels_line(errs, launches)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
