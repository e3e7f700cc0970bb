"""The port's native host runtime (``analytics_zoo_tpu_torch/native``)
against the JAX package's, on the CPU: the cases of tests/
test_native_runtime.py and tests/test_infeed_crossover.py run on the port,
and where both packages compute the same thing (shuffle, gather, padding,
bf16 rounding, the library's version) the answers are equal bit for bit.

The port's ``InfeedPump`` takes zero-argument assembly tasks and a
``device_put`` (the JAX one also takes plain batches and defaults its
``device_put``); the pump cases hand it tasks and the identity.
"""

import gc
import logging
import threading
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import native as jnative
from analytics_zoo_tpu_torch import native as tnative
from analytics_zoo_tpu_torch.native import transfer as ttransfer
from analytics_zoo_tpu_torch.native.infeed_sim import (FakeDevice, measure,
                                                       simulate_crossover)


def _pump(batches, **kw):
    def factory():
        return iter([lambda b=b: b for b in batches])
    return tnative.InfeedPump(factory, device_put=lambda b: b, **kw)


def test_native_library_builds_and_versions_match():
    assert tnative.available(), "g++ is in the image; the library builds"
    assert "native" in tnative.version()
    assert tnative.version() == jnative.version()


def test_arena_alloc_reset():
    a = tnative.Arena(1 << 16)
    x = a.alloc_array((8, 8), np.float32)
    x[:] = 3.0
    assert a.used >= 8 * 8 * 4
    y = a.alloc_array((4,), np.int64)
    y[:] = 7
    assert x.sum() == 192.0          # distinct buffers
    a.reset()
    assert a.used == 0
    with pytest.raises(MemoryError):
        tnative.Arena(1 << 16).alloc_array((1 << 20,), np.float64)
    a.close()


def test_arena_views_pin_native_memory():
    """A returned array keeps the Arena and its native block alive: the
    Arena's collection, and even ``close()``, free nothing while a view
    exists (close defers to the last view's death)."""
    a = tnative.Arena(1 << 16)
    arr = a.alloc_array((16,), np.float32)
    arr[:] = 5.0
    ref = weakref.ref(a)
    a.close()                      # deferred: the view is alive
    del a
    gc.collect()
    assert ref() is not None       # pinned through arr.base
    assert arr.sum() == 80.0       # the memory is still valid
    del arr
    gc.collect()
    assert ref() is None           # freed with the last view


def test_arena_rejects_alloc_after_close():
    a = tnative.Arena(1 << 16)
    a.close()
    assert a._lib is not None
    with pytest.raises(RuntimeError, match="closed"):
        a.alloc_array((4,), np.float32)


def test_shuffled_indices_and_gather_equal_jax():
    a = tnative.shuffled_indices(1000, seed=42)
    assert (a == tnative.shuffled_indices(1000, seed=42)).all()
    assert not (a == tnative.shuffled_indices(1000, seed=43)).all()
    assert sorted(a.tolist()) == list(range(1000))
    np.testing.assert_array_equal(a, jnative.shuffled_indices(1000, seed=42))
    rng = np.random.RandomState(0)
    src = rng.randn(512, 17).astype(np.float32)
    idx = rng.randint(0, 512, 2048).astype(np.int64)
    np.testing.assert_array_equal(tnative.gather_rows(src, idx), src[idx])
    src3 = rng.randn(64, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(tnative.gather_rows(src3, idx % 64),
                                  jnative.gather_rows(src3, idx % 64))


def test_pad_sequences_semantics():
    out, mask = tnative.pad_sequences([[1, 2, 3, 4, 5], [9], []], max_len=3)
    assert out.tolist() == [[1, 2, 3], [9, 0, 0], [0, 0, 0]]
    assert mask.tolist() == [[1, 1, 1], [1, 0, 0], [0, 0, 0]]
    out2 = tnative.pad_sequences([[7]], max_len=2, pad_value=-1,
                                 return_mask=False)
    assert out2.tolist() == [[7, -1]]


@pytest.mark.parametrize("max_len,pad_value", [(1, 0), (7, 0), (20, -3)])
def test_pad_sequences_bit_identical_to_jax(max_len, pad_value):
    rng = np.random.RandomState(max_len)
    seqs = [list(rng.randint(-50, 50, rng.randint(0, 15)))
            for _ in range(40)] + [[]]
    got = tnative.pad_sequences(seqs, max_len, pad_value)
    want = jnative.pad_sequences(seqs, max_len, pad_value)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert tnative.pad_sequences(seqs, max_len, pad_value,
                                 return_mask=False).tobytes() == \
        want[0].tobytes()


def test_bf16_bits_identical_to_jax():
    """Round to nearest even, on ties, subnormals, infinities and NaN as
    well as random values: the JAX package's bits and jnp's bfloat16."""
    rng = np.random.RandomState(0)
    special = np.array([0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8,
                        np.float32(1e-40), np.inf, -np.inf, np.nan,
                        np.finfo(np.float32).max], np.float32)
    x = np.concatenate([rng.randn(1000).astype(np.float32) * 100, special])
    got = tnative.f32_to_bf16_bits(x)
    assert got.dtype == np.uint16
    assert got.tobytes() == jnative.f32_to_bf16_bits(x).tobytes()
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(got[finite], ref[finite])


def test_native_queue_fifo_and_close():
    q = tnative.NativeQueue(capacity=2)
    assert q.put("a") and q.put("b")
    assert not q.put("c", timeout_ms=50)      # full
    assert q.qsize() == 2
    assert q.get() == "a"
    assert q.get() == "b"
    assert q.get(timeout_ms=50) is None       # empty
    q.close()
    q.destroy()


def test_native_queue_threads():
    q = tnative.NativeQueue(capacity=4)
    got = []

    def consumer():
        while True:
            item = q.get()
            if item is None or item == "stop":
                break
            got.append(item)

    t = threading.Thread(target=consumer)
    t.start()
    for i in range(100):
        q.put(i)
    q.put("stop")
    t.join(timeout=10)
    assert not t.is_alive()
    assert got == list(range(100))
    q.destroy()


def test_staging_enabled_keys_on_the_device(monkeypatch):
    """``ZOO_HOST_STAGING`` decides when set, as in the JAX package; else
    staging is on for a ``cuda`` device and off for the CPU (the JAX
    package keys it on its default backend, which is the CPU here)."""
    monkeypatch.delenv("ZOO_HOST_STAGING", raising=False)
    assert ttransfer.staging_enabled("cuda") is True
    assert ttransfer.staging_enabled("cpu") is False
    assert jnative.staging_enabled() is False
    for env, want in (("1", True), ("0", False)):
        monkeypatch.setenv("ZOO_HOST_STAGING", env)
        assert jnative.staging_enabled() is want
        for dev in ("cpu", "cuda", None):
            assert tnative.staging_enabled(dev) is want


def test_staging_override_turns_the_card_ring_off(monkeypatch):
    """A feed to the card builds its pinned ring unless
    ``ZOO_HOST_STAGING=0``; a feed to the CPU never does (building the
    pool allocates nothing, so no card is needed here)."""
    from analytics_zoo_tpu_torch.orca.learn.utils import DeviceFeed
    monkeypatch.delenv("ZOO_HOST_STAGING", raising=False)
    assert DeviceFeed(device=torch.device("cuda"))._staging_pool() \
        is not None
    for env in ("1", "0"):
        monkeypatch.setenv("ZOO_HOST_STAGING", env)
        assert DeviceFeed(device=torch.device("cpu"))._staging_pool() \
            is None
    assert DeviceFeed(device=torch.device("cuda"))._staging_pool() is None


def test_infeed_pump_prefetches_in_order():
    batches = [np.full((2, 2), i, np.float32) for i in range(10)]
    assert [b[0, 0] for b in _pump(batches, depth=3)] == list(range(10))


def test_infeed_pump_propagates_errors():
    def factory():
        yield lambda: np.ones(2)
        raise RuntimeError("loader exploded")

    pump = tnative.InfeedPump(factory, device_put=lambda b: b)
    with pytest.raises(RuntimeError, match="loader exploded"):
        list(pump)


def test_infeed_pump_slow_consumer_gets_sentinel():
    """The stop sentinel survives a full queue: with depth 2 and a
    consumer that stalls on the first item, the producer finishes while
    both slots are full, and the pump still delivers every batch and
    ends."""
    seen = []
    for b in _pump([np.full((2,), i, np.float32) for i in range(3)],
                   depth=2):
        if not seen:
            time.sleep(0.5)
        seen.append(float(b[0]))
    assert seen == [0.0, 1.0, 2.0]


def test_infeed_pump_abandoned_consumer_does_not_hang(caplog):
    it = iter(_pump([np.full((2,), i, np.float32) for i in range(50)],
                    depth=2))
    next(it)
    with caplog.at_level(logging.WARNING, logger="analytics_zoo_tpu_torch"):
        it.close()
    assert "infeed producer did not stop" not in caplog.text


# --- pump-vs-direct crossover (tests/test_infeed_crossover.py) ---------------

def test_pump_hides_transfer_at_dma_bandwidth():
    """At 4 GB/s a 38.5 MB batch costs ~9.6 ms next to a 60 ms step: the
    pumped steady state sits near the compute time while direct pays
    compute + transfer."""
    n = int(38.5e6)
    batches = [np.zeros(n, np.uint8) for _ in range(3)]
    dev = FakeDevice(bandwidth_gbps=4.0, step_time_s=0.060)
    direct = measure(dev, batches, steps=15, use_pump=False)
    pumped = measure(dev, batches, steps=15, use_pump=True)
    transfer = n / 4e9
    assert direct > 0.060 + transfer * 0.8
    assert pumped < 0.060 + transfer * 0.5, (pumped, direct)
    assert pumped < direct


def test_pump_cannot_help_at_tunnel_bandwidth():
    n = int(4e6)
    dev = FakeDevice(bandwidth_gbps=0.01, step_time_s=0.020)
    pumped = measure(dev, [np.zeros(n, np.uint8)], steps=5, use_pump=True)
    assert pumped > n / 0.01e9 * 0.9                # still transfer-bound


def test_crossover_sweep_shape():
    res = simulate_crossover(batch_mb=20.0, step_time_ms=15.0,
                             bandwidths_gbps=(0.05, 1.0), steps=8)
    slow, fast = res[0.05], res[1.0]
    assert fast["pumped_s_per_step"] < fast["ideal_overlap_s"] * 1.35
    assert slow["pumped_s_per_step"] >= slow["transfer_s"] * 0.9
    assert fast["pump_speedup"] > 1.3
