"""The port's serving path on the CPU: InferenceModel bucketing, Cluster
Serving of a tiny BERT against the JAX package's InferenceModel on the
same weights, the import boundary, and the device rule.

Tolerance f32 rtol/atol 2e-4 (as tests/test_attention.py), for the
summation-order and LayerNorm-variance differences of the two frameworks
through two BERT layers.

Object-detection serving (BASELINE #5): a trained ``ssd_tiny`` detector
served through ``ObjectDetector.as_inference_model`` -> ``ClusterServing``
over the in-memory and Redis brokers against JAX's ``predict_image_set``;
``quantize`` (int8 bytes and scales identical to JAX's), the uint8
prologue, ``save``/``load``, checkpoints, hot-reload counters (JAX's for
the same sequence), adopting a JAX-written serving checkpoint, and a
tampered encrypted file. Detections: labels identical, scores and pixel
boxes within 6.4e-3 (1e-4 of the 64 px frame).
"""

import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    _bucket
from analytics_zoo_tpu_torch.serving import (ClusterServing, InMemoryBroker,
                                             InputQueue, OutputQueue)
from analytics_zoo_tpu_torch.tfpark.text.estimator import _BertWithHead

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(vocab=100, hidden_size=32, n_block=2, n_head=2, seq_len=32,
            intermediate_size=64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ids(n, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, 100, (n, s)).astype(
        np.int32)


def _flax_bert(num_out=2):
    from analytics_zoo_tpu.tfpark.text.estimator import \
        _BertWithHead as JBert
    module = JBert(bert_kwargs=tuple(sorted(TINY.items())), num_out=num_out)
    params = module.init(jax.random.PRNGKey(0), _ids(1))["params"]
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), jax.device_get(params))
    return module, params


def _torch_model(params, num_out=2):
    module = _BertWithHead(tuple(sorted(TINY.items())), num_out=num_out)
    interop.load_flax_params(module, params)
    return InferenceModel(device="cpu").load_module(module)


@pytest.mark.parametrize("n", [1, 5, 16, 37])
def test_bucketed_predict_matches_module(n):
    _, params = _flax_bert()
    model = _torch_model(params)
    ids = _ids(n, seed=n)
    out = model.predict(ids)
    with torch.inference_mode():
        ref = model.module(torch.from_numpy(ids)).numpy()
    assert out.shape == (n, 2)
    np.testing.assert_allclose(out, ref, **TOL)
    assert list(model._cache) == [(_bucket(n, model.buckets),
                                   ((16,), "int32"))]
    assert model.device_count == 1


def test_precompile_warms_buckets_up_to_max():
    _, params = _flax_bert()
    model = _torch_model(params)
    model.precompile(_ids(1), max_bucket=12)
    assert sorted(k[0] for k in model._cache) == [1, 2, 4, 8, 16]


def test_cluster_serving_matches_jax_inference_model(orca_context):
    from analytics_zoo_tpu.pipeline.inference import \
        InferenceModel as JInferenceModel
    module, params = _flax_bert()
    ids = _ids(21, seed=7)
    ref = JInferenceModel().load_jax(module, {"params": params}).predict(ids)

    model = _torch_model(params)
    broker = InMemoryBroker()
    serving = ClusterServing(model, queue=broker, batch_size=8)
    serving.start(example=ids[:1])
    try:
        inq, outq = InputQueue(broker), OutputQueue(broker)
        uris = [inq.enqueue(f"req-{i}", t=ids[i]) for i in range(len(ids))]
        res = outq.dequeue(uris, timeout_s=30)
    finally:
        serving.stop()
    out = np.stack([res[u] for u in uris])
    assert out.shape == (21, 2)
    np.testing.assert_allclose(out, ref, **TOL)
    assert serving.metrics()["records_out"] == 21


def _user_mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 4))


def test_load_torch_matches_jax(orca_context):
    """A user's torch module through both packages' ``load_torch``: the JAX
    package converts it to flax, the port serves it as it is (f32, TF32
    off)."""
    from analytics_zoo_tpu.pipeline.inference import \
        InferenceModel as JInferenceModel
    x = np.random.RandomState(3).randn(21, 8).astype(np.float32)
    ref = JInferenceModel().load_torch(_user_mlp()).predict(x)
    module = _user_mlp()
    model = InferenceModel(device="cpu").load_torch(module)
    assert model.module is module
    np.testing.assert_allclose(model.predict(x), ref, rtol=1e-5, atol=1e-5)


def test_distributed_predict_matches_jax(orca_context):
    from analytics_zoo_tpu.orca.data import XShards as JXShards
    from analytics_zoo_tpu.pipeline.inference import \
        InferenceModel as JInferenceModel

    from analytics_zoo_tpu_torch.orca.data import XShards
    x = np.random.RandomState(4).randn(30, 8).astype(np.float32)
    want = JInferenceModel().load_torch(_user_mlp()).distributed_predict(
        JXShards.partition({"x": x}, num_shards=3)).collect()
    model = InferenceModel(device="cpu").load_torch(_user_mlp())
    shards = XShards.partition({"x": x}, num_shards=3)
    got = model.distributed_predict(shards).collect()
    assert len(got) == len(want) == 3
    for g, w, part in zip(got, want, shards.collect()):
        np.testing.assert_allclose(g["prediction"], w["prediction"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(g["prediction"],
                                      model.predict(part["x"]))


def test_transfer_stats_keys_and_bytes_match_jax(orca_context):
    """``transfer_stats()`` has the JAX snapshot's keys and counts the
    bytes ``predict`` sent: the padded batch, as JAX's does; ClusterServing's
    ``metrics()`` shows it as ``"transfer"``."""
    from analytics_zoo_tpu.pipeline.inference import \
        InferenceModel as JInferenceModel
    x = np.random.RandomState(5).randn(16, 8).astype(np.float32)
    jmodel = JInferenceModel().load_torch(_user_mlp())
    jmodel.predict(x)
    jmodel.predict(x[:5])
    model = InferenceModel(device="cpu").load_torch(_user_mlp())
    assert model.transfer_stats()["h2d_n"] == 0
    model.predict(x)
    model.predict(x[:5])                # padded to the bucket of 8
    want, got = jmodel.transfer_stats(), model.transfer_stats()
    assert set(got) == set(want)
    assert got["h2d_n"] == want["h2d_n"] == 2
    assert got["h2d_bytes"] == want["h2d_bytes"] == x.nbytes + 8 * 8 * 4
    broker = InMemoryBroker()
    serving = ClusterServing(model, queue=broker, batch_size=8).start()
    try:
        inq, outq = InputQueue(broker), OutputQueue(broker)
        outq.dequeue([inq.enqueue(f"r{i}", t=x[i]) for i in range(4)],
                     timeout_s=30)
        transfer = serving.metrics()["transfer"]
    finally:
        serving.stop()
    assert transfer["h2d_bytes"] > got["h2d_bytes"]


# the modules each slice added, named so that a missing one fails here
PORTED_MODULES = ["analytics_zoo_tpu_torch." + m for m in (
    "models", "models.common", "models.common.zoo_model",
    "models.common.ranker", "models.recommendation",
    "models.recommendation.neuralcf",
    "ckpt", "ckpt.format", "ckpt.store", "ckpt.stats", "ckpt.plane",
    "native", "native.runtime", "native.transfer", "native.infeed",
    "utils", "utils.crypto", "orca.learn.prologue", "interop",
    "ops.embedding", "orca.learn.estimator", "orca.learn.utils",
    "models.common.initializers", "models.image", "models.image.resnet",
    "orca.data", "orca.data.image", "orca.data.image.imagenet",
    "orca.learn.optimizers.schedule",
    "utils.nest", "orca.data.chunked", "orca.data.shard",
    "orca.learn.pytorch", "orca.learn.pytorch.estimator",
    "orca.learn.pytorch.training_operator",
    "pipeline.api.keras", "pipeline.api.keras.activations",
    "pipeline.api.keras.objectives", "pipeline.api.keras.engine",
    "pipeline.api.keras.engine.graph", "pipeline.api.keras.engine.topology",
    "pipeline.api.keras.layers.core",
    "pipeline.api.keras.layers.normalization",
    "pipeline.api.keras.layers.advanced_activations",
    "pipeline.api.keras.layers.noise", "pipeline.api.autograd",
    "pipeline.nnframes", "pipeline.nnframes.nn_classifier",
    "orca.data.pandas", "orca.data.pandas.preprocessing",
    "utils.tensorboard", "utils.protostream",
    "automl", "automl.hp", "automl.model_builder", "automl.auto_estimator",
    "automl.search", "automl.search.bayes", "automl.search.search_engine",
    "automl.scheduler", "automl.scheduler.lease",
    "automl.scheduler.asha", "automl.scheduler.events",
    "automl.scheduler.runtime", "orca.learn.preemption",
    "automl.xgboost", "automl.xgboost.hist_gbt", "automl.xgboost.auto_xgb",
    "zouwu", "zouwu.config", "zouwu.config.recipe", "zouwu.feature",
    "zouwu.feature.time_sequence", "zouwu.preprocessing",
    "zouwu.preprocessing.impute", "zouwu.model", "zouwu.model.nets",
    "zouwu.model.forecast", "zouwu.model.anomaly", "zouwu.autots",
    "zouwu.autots.forecast",
    "streaming", "streaming.records", "streaming.stats",
    "streaming.source", "streaming.trainer", "streaming.guardrail",
    "streaming.serve", "streaming.fleet", "resilience.watchdog",
    "resilience.supervisor", "serving.redis_protocol",
    "ckpt.watch", "models.image.objectdetection",
    "models.image.objectdetection.priors",
    "models.image.objectdetection.bbox", "models.image.objectdetection.ssd",
    "models.image.objectdetection.postprocess",
    "models.image.objectdetection.loss",
    "models.image.objectdetection.evaluation",
    "models.image.objectdetection.detector",
    "models.image.objectdetection.interop",
    "obs.export", "obs.__main__", "serving.fleet", "serving.http_frontend",
    "shm.cli", "orca.learn.graphs",
    "zouwu.model.tcmf", "feature", "feature.feature_set",
    "orca.data.tfrecord",
    "feature.text", "feature.text.text_set",
    "pipeline.api.keras.layers.recurrent",
    "pipeline.api.keras.layers.convolutional",
    "pipeline.api.keras.layers.pooling",
    "pipeline.api.keras.layers.embeddings",
    "models.textclassification", "models.textclassification.text_classifier",
    "models.textmatching", "models.textmatching.knrm", "models.seq2seq",
    "models.seq2seq.seq2seq", "models.anomalydetection",
    "models.anomalydetection.anomaly_detector",
    "models.recommendation.wide_and_deep",
    "models.recommendation.session_recommender", "tfpark.text.keras",
    "feature.image", "feature.image.codecs", "feature.image.preprocessing",
    "feature.image.imageset", "feature.image3d",
    "feature.image3d.transformation",
    "models.image.imageclassification",
    "models.image.imageclassification.families",
    "models.image.imageclassification.inception",
    "models.image.imageclassification.classifier",
    "pipeline.nnframes.nn_image_reader", "ops", "orca", "orca.learn",
    "pipeline.api.keras2", "pipeline.api.keras2.layers",
    "pipeline.api.keras2.layers.core",
    "pipeline.api.keras2.layers.convolutional",
    "pipeline.api.keras2.layers.pooling", "pipeline.api.keras2.layers.merge",
    "pipeline.api.keras2.layers.embeddings",
    "pipeline.api.keras2.layers.normalization",
    "pipeline.api.keras2.layers.advanced_activations",
    "pipeline.api.keras2.layers.noise",
    "pipeline.api.keras2.layers.recurrent",
    "pipeline.api.keras2.layers.local",
    "pipeline.api.keras2.layers.wrappers",
    "pipeline.api.keras2.layers.convolutional_recurrent",
    "orca.learn.gan_estimator", "tfpark", "pipeline.estimator",
    "pipeline.estimator.estimator",
    "orca.data.image.parquet_dataset", "friesian", "friesian.feature",
    "friesian.feature.table", "native.infeed_sim")]


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports without JAX,
    flax, optax, aiohttp or the JAX package, without pandas (which the
    port imports only inside the functions that take DataFrames), and
    without cv2 or PIL (the image decoders and transforms are the port's
    own: the card's machine is not held to have either)."""
    code = (
        "import sys, json, pkgutil, importlib\n"
        "import analytics_zoo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               pkg.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'analytics_zoo_tpu',\n"
        "        'pandas', 'aiohttp', 'cv2', 'PIL')]\n"
        "print(json.dumps([len(names), bad, names]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules, bad, names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bad == []
    assert set(PORTED_MODULES) <= set(names), \
        sorted(set(PORTED_MODULES) - set(names))
    # every .py file of the package but its top __init__ was imported
    files = glob.glob(os.path.join(REPO, "analytics_zoo_tpu_torch", "**",
                                   "*.py"), recursive=True)
    assert n_modules == len(files) - 1


def test_no_gpu_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tctx, "_current", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tctx.init_orca_context()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceModel()
    ctx = tctx.init_orca_context(device="cpu")
    try:
        assert ctx.devices == [torch.device("cpu")]
        assert (ctx.num_devices, ctx.process_id, ctx.num_processes) == \
            (1, 0, 1)
        assert tctx.get_context() is ctx
    finally:
        tctx.stop_orca_context()
    assert tctx._current is None


# --- object-detection serving (BASELINE #5) ----------------------------------
# A JAX ``ssd_tiny`` detector trained two epochs on the toy squares, and
# the port's detector holding its weights (bridged through interop).
# Detections: labels identical, scores and pixel boxes within TOL_DET.

TOL_DET = dict(atol=1e-4 * 64, rtol=0)


@pytest.fixture(scope="module")
def od_pair():
    from analytics_zoo_tpu import init_orca_context
    from analytics_zoo_tpu.common import context as jctx
    from analytics_zoo_tpu.models.image import objectdetection as jod
    from analytics_zoo_tpu_torch.models.image import objectdetection as tod
    from test_torch_objectdetection import _toy_detection_data
    live = jctx._current
    if live is None or live._stopped:
        init_orca_context("cpu-sim", mesh_axes={"dp": -1})
    imgs, boxes, labels = _toy_detection_data(n=16)
    jdet = jod.ObjectDetector(class_names=("square",), image_size=64,
                              model_type="ssd_tiny", max_gt=4)
    jdet.compile(optimizer="adam")
    jdet.fit({"x": imgs, "y": jdet.pack_targets(boxes, labels, 4)},
             batch_size=8, epochs=2, shuffle=False, verbose=False)
    tdet = tod.ObjectDetector(class_names=("square",), image_size=64,
                              model_type="ssd_tiny", max_gt=4, device="cpu")
    eng = jdet.estimator.engine
    tod.load_flax_ssd(tdet.module, {"params": eng.params,
                                    "batch_stats":
                                        eng.extra_vars["batch_stats"]})
    return jdet, tdet, imgs


def _assert_dets(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], **TOL_DET)


def _serve(model, broker, imgs, example=None, **client):
    serving = ClusterServing(model, queue=broker, batch_size=4,
                             batch_timeout_ms=5).start(example=example)
    try:
        iq = InputQueue(broker, **client) if not client else \
            InputQueue(**client)
        oq = OutputQueue(broker, **client) if not client else \
            OutputQueue(**client)
        uris = [iq.enqueue(f"img-{i}", t=imgs[i]) for i in range(len(imgs))]
        res = oq.dequeue(uris, timeout_s=60)
    finally:
        serving.stop()
    return np.stack([res[u] for u in uris]), serving


@pytest.mark.parametrize("transport", ["memory", "redis"])
def test_od_serving_matches_jax_predict_image_set(od_pair, transport):
    """ObjectDetector.as_inference_model -> ClusterServing answers
    ``[max_detections, 6]`` per image, JAX's ``predict_image_set``
    detections (normalized here, pixels there)."""
    from analytics_zoo_tpu_torch.serving import MiniRedisServer, RedisBroker
    jdet, tdet, imgs = od_pair
    want = jdet.predict_image_set(imgs[:8], max_detections=10)
    model = tdet.as_inference_model(max_detections=10)
    assert model.device.type == "cpu"
    srv = None
    if transport == "redis":
        srv = MiniRedisServer(port=0).start()
        broker = RedisBroker(srv.host, srv.port, stream="od")
        client = dict(host=srv.host, port=srv.port, name="od")
    else:
        broker, client = InMemoryBroker(), {}
    try:
        got, serving = _serve(model, broker, imgs[:8], imgs[:1], **client)
    finally:
        if srv is not None:
            srv.stop()
    assert got.shape == (8, 10, 6)
    assert (got[..., 0] > 0).sum() >= 8            # a square per image
    _assert_dets(got * np.array([1, 1, 64, 64, 64, 64], np.float32), want)
    assert serving.metrics()["records_out"] == 8


def _jax_quant_parts(jim):
    """The JAX InferenceModel.quantize closure's scales and the int8
    leaves, by flax path."""
    fn = jim._apply_fn
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.device_get(jim._variables))[0]
    return {jax.tree_util.keystr(p): (np.asarray(q), s)
            for (p, q), s in zip(leaves, cells["scales"]) if s is not None}


def test_quantize_matches_jax(od_pair):
    """Weight-only int8: the same int8 bytes and scales (the port's output
    axis 0 is flax's last), so the dequantized weights are bit-identical;
    detections then match JAX's quantized ones, and f32's in count and
    (sorted) scores within 0.02."""
    jdet, tdet, imgs = od_pair
    jim = jdet.as_inference_model(max_detections=10).quantize(
        min_elements=1024)
    tim = tdet.as_inference_model(max_detections=10)
    f32 = tim.predict(imgs[:8])
    tim.quantize(min_elements=1024)
    parts = _jax_quant_parts(jim)
    n = 0
    for name, mod in tim.module.named_modules():
        if "weight_int8" not in dict(mod.named_buffers()):
            continue
        q, s = parts[f"['params']['{name}']['kernel']"]
        assert np.array_equal(mod.weight_int8.numpy(),
                              q.transpose(3, 2, 0, 1))
        assert np.array_equal(mod.weight_scale.numpy()[:, 0, 0, 0],
                              s.reshape(-1))
        deq = (mod.weight_int8.float() * mod.weight_scale).numpy()
        assert deq.tobytes() == np.ascontiguousarray(
            (q.astype(np.float32) * s).transpose(3, 2, 0, 1)).tobytes()
        n += 1
    assert n == len(parts) >= 4
    got = tim.predict(imgs[:8])
    _assert_dets(got * np.array([1, 1, 64, 64, 64, 64], np.float32),
                 np.asarray(jim.predict(imgs[:8])) *
                 np.array([1, 1, 64, 64, 64, 64], np.float32))
    # against f32: the same detections per image, scores within 0.02
    # (near-tied rows may trade places, so compare the sorted scores)
    assert np.array_equal((got[..., 0] > 0).sum(1), (f32[..., 0] > 0).sum(1))
    np.testing.assert_allclose(np.sort(got[..., 1], 1),
                               np.sort(f32[..., 1], 1), atol=0.02)


def test_uint8_prologue_matches_jax(od_pair):
    from analytics_zoo_tpu.orca.learn import prologue as jpro
    from analytics_zoo_tpu_torch.orca.learn import prologue as tpro
    jdet, tdet, imgs = od_pair
    raw = (imgs[:8] * 255).astype(np.uint8)
    jim = jdet.as_inference_model(max_detections=10).set_prologue(
        jpro.rescale(1 / 255))
    tim = tdet.as_inference_model(max_detections=10).set_prologue(
        tpro.rescale(1 / 255))
    got = tim.predict(raw)
    _assert_dets(got, np.asarray(jim.predict(raw)))
    # the prologue ran: the same images as f32 on the host give the same
    np.testing.assert_array_equal(
        tdet.as_inference_model(max_detections=10).predict(
            tpro.rescale(1 / 255).host(raw)), got)


def test_od_save_load_checkpoints_and_hot_reload(od_pair, tmp_path):
    """``save``/``load`` and ``save_checkpoint``/``load_checkpoint``
    rebuild the servable from plain values; a live server hot-swaps a
    trained checkpoint (``hot_reloads == 1``, ``full_reloads == 0``) and a
    structure change from a checkpoint with a module reloads in full. The
    same-shape swap and a skipped mismatch give JAX's counters."""
    from analytics_zoo_tpu.ckpt import CheckpointPlane as JPlane
    from analytics_zoo_tpu.pipeline.inference import \
        InferenceModel as JIM
    from analytics_zoo_tpu_torch.ckpt import CheckpointPlane
    from analytics_zoo_tpu_torch.models.image import objectdetection as tod
    jdet, tdet, imgs = od_pair
    trained = tdet.as_inference_model(max_detections=10)
    want = trained.predict(imgs[:4])
    path = str(tmp_path / "od.pt")
    trained.save(None, path)
    np.testing.assert_array_equal(
        InferenceModel(device="cpu").load(path).predict(imgs[:4]), want)
    root = str(tmp_path / "root")
    trained.save_checkpoint(None, root, step=2)
    boot = InferenceModel(device="cpu").load_checkpoint(root)
    np.testing.assert_array_equal(boot.predict(imgs[:4]), want)
    assert not boot.enable_hot_reload(root, poll_s=60).poll_now()
    boot.disable_hot_reload()
    assert boot.ckpt_stats() == {}

    # a live server of the untrained detector swaps in the trained weights
    fresh = tod.ObjectDetector(class_names=("square",), image_size=64,
                               model_type="ssd_tiny", device="cpu")
    live = fresh.as_inference_model(max_detections=10)
    before = live.predict(imgs[:4])
    w = live.enable_hot_reload(root, poll_s=60)
    assert w.poll_now()
    np.testing.assert_array_equal(live.predict(imgs[:4]), want)
    assert not np.array_equal(before, want)
    stats = live.ckpt_stats()
    assert stats == {"hot_reloads": 1, "full_reloads": 0,
                     "reload_skips": 0, "last_reload_step": 2}
    # an estimator checkpoint of another structure (2 classes) and no
    # module is skipped
    other = tod.ObjectDetector(class_names=("a", "b"), image_size=64,
                               model_type="ssd_tiny", device="cpu")
    other.compile()
    CheckpointPlane(root, async_save=False).save(
        other.estimator.engine.get_state(), 3, blocking=True)
    assert w.poll_now()                 # delivered, and skipped
    live.disable_hot_reload()
    port_counters = live.ckpt_stats()
    assert port_counters["reload_skips"] == 1

    # JAX: the same sequence gives the same counters
    jroot = str(tmp_path / "jroot")
    jtrained = jdet.as_inference_model(max_detections=10)
    jtrained.save_checkpoint(jdet.module, jroot, step=2)
    jlive = _jax_fresh_inference_model()
    jw = jlive.enable_hot_reload(jroot, poll_s=60)
    assert jw.poll_now()
    JPlane(jroot, async_save=False).save(
        _jax_two_class_estimator().engine.get_state(), 3, blocking=True)
    assert jw.poll_now()
    jlive.disable_hot_reload()
    assert jlive.ckpt_stats() == port_counters
    assert isinstance(jlive, JIM)

    # a checkpoint carrying a module of the port with another structure
    root2 = str(tmp_path / "root2")
    other.as_inference_model(max_detections=10).save_checkpoint(
        None, root2, step=5)
    live2 = fresh.as_inference_model(max_detections=10)
    w2 = live2.enable_hot_reload(root2, poll_s=60)
    assert w2.poll_now()
    live2.disable_hot_reload()
    assert live2.ckpt_stats() == {"hot_reloads": 1, "full_reloads": 1,
                                  "reload_skips": 0, "last_reload_step": 5}
    assert live2.module.num_classes == 3


def _jax_fresh_inference_model():
    from analytics_zoo_tpu.models.image import objectdetection as jod
    det = jod.ObjectDetector(class_names=("square",), image_size=64,
                             model_type="ssd_tiny", max_gt=4)
    det.compile()
    return det.as_inference_model(max_detections=10)


def _jax_two_class_estimator():
    from analytics_zoo_tpu.models.image import objectdetection as jod
    det = jod.ObjectDetector(class_names=("a", "b"), image_size=64,
                             model_type="ssd_tiny", max_gt=4)
    det.compile()
    det.estimator.engine.build((np.zeros((1, 64, 64, 3), np.float32),))
    return det.estimator


def test_adopts_jax_serving_checkpoint(od_pair, tmp_path):
    """A serving checkpoint the JAX package wrote (its pickled flax module
    included) loads into the port's servable and hot-swaps into a live
    one, without running or importing the flax module."""
    from analytics_zoo_tpu_torch.models.image import objectdetection as tod
    jdet, tdet, imgs = od_pair
    jim = jdet.as_inference_model(max_detections=10)
    root = str(tmp_path / "j")
    jim.save_checkpoint(jdet.module, root, step=4)
    want = np.asarray(jim.predict(imgs[:8]))
    fresh = tod.ObjectDetector(class_names=("square",), image_size=64,
                               model_type="ssd_tiny", device="cpu")
    with pytest.raises(ValueError, match="load one first"):
        InferenceModel(device="cpu").load_checkpoint(root)
    model = fresh.as_inference_model(max_detections=10).load_checkpoint(root)
    _assert_dets(model.predict(imgs[:8]), want)
    live = fresh.as_inference_model(max_detections=10)
    assert live.enable_hot_reload(root, poll_s=60).poll_now()
    live.disable_hot_reload()
    assert live.ckpt_stats()["hot_reloads"] == 1
    _assert_dets(live.predict(imgs[:8]), want)


def test_encrypted_round_trip_and_tamper(od_pair, tmp_path, monkeypatch):
    jdet, tdet, imgs = od_pair
    model = tdet.as_inference_model(max_detections=10)
    path = str(tmp_path / "od.enc")
    model.save_encrypted(None, path, "s3cret")
    back = InferenceModel(device="cpu").load_encrypted(path, "s3cret")
    np.testing.assert_array_equal(back.predict(imgs[:4]),
                                  model.predict(imgs[:4]))
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 1
    open(path, "wb").write(bytes(blob))
    # the tag is checked before anything is deserialized
    monkeypatch.setattr(torch, "load", lambda *a, **k: pytest.fail(
        "deserialized a tampered file"))
    with pytest.raises(ValueError, match="integrity"):
        InferenceModel(device="cpu").load_encrypted(path, "s3cret")
    with pytest.raises(ValueError, match="integrity"):
        InferenceModel(device="cpu").load_encrypted(path, "wrong")
