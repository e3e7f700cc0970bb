"""The port's serving path on the CPU: InferenceModel bucketing, Cluster
Serving of a tiny BERT against the JAX package's InferenceModel on the
same weights, the import boundary, and the device rule.

Tolerance f32 rtol/atol 2e-4 (as tests/test_attention.py), for the
summation-order and LayerNorm-variance differences of the two frameworks
through two BERT layers.
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
    "zouwu", "zouwu.config", "zouwu.config.recipe", "zouwu.feature",
    "zouwu.feature.time_sequence", "zouwu.preprocessing",
    "zouwu.preprocessing.impute", "zouwu.model", "zouwu.model.nets",
    "zouwu.model.forecast", "zouwu.model.anomaly", "zouwu.autots",
    "zouwu.autots.forecast")]


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports without JAX,
    flax or the JAX package, and without pandas (which the port imports
    only inside the functions that take DataFrames)."""
    code = (
        "import sys, json, pkgutil, importlib\n"
        "import analytics_zoo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               pkg.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'analytics_zoo_tpu',\n"
        "        'pandas')]\n"
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
