"""The port's checkpoint plane (analytics_zoo_tpu_torch/ckpt and the
estimator's ``model_dir``) against the JAX package's, on the CPU.

* A checkpoint the JAX estimator wrote (NCF, one epoch, Adam or SGD)
  restores into the port, and both continue one epoch with the same
  losses; the reverse goes through the JAX package's
  ``load_checkpoint_dir`` and the port's ``interop.state_to_jax``.
* The same numpy leaves give the same blobs (digests and bytes) in both
  packages, and each package reads the other's directory.
* An uncommitted or corrupt checkpoint is skipped for the previous one.

Tolerance: the continued epoch's per-step losses within 1e-5 (f32, as in
tests/test_torch_ncf.py).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import ckpt as jckpt
from analytics_zoo_tpu.ckpt import format as jfmt
from analytics_zoo_tpu.orca.learn import utils as jutils
from analytics_zoo_tpu.orca.learn.trigger import EveryEpoch as JEveryEpoch
from analytics_zoo_tpu_torch import ckpt as tckpt
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.ckpt import format as tfmt
from analytics_zoo_tpu_torch.orca.learn import utils as tutils
from analytics_zoo_tpu_torch.orca.learn.trigger import EveryEpoch

from test_torch_ncf import _data, _fit_both, ncf_pair

TOL = dict(rtol=1e-5, atol=1e-5)


def _latest(model_dir):
    path, step = tutils.find_latest_checkpoint(model_dir)
    assert (path, step) == jutils.find_latest_checkpoint(model_dir)
    return path, step


@pytest.mark.parametrize("opt_name", ["Adam", "SGD"])
def test_jax_checkpoint_restores_into_the_port(orca_context, tmp_path,
                                               opt_name):
    model_dir = str(tmp_path / "jax")
    jm, tm = ncf_pair(opt_name, model_dir=model_dir)
    pairs, labels = _data()
    jm.fit({"x": pairs, "y": labels}, epochs=1, batch_size=64,
           verbose=False, checkpoint_trigger=JEveryEpoch())
    path, step = _latest(model_dir)
    assert step == 5
    with torch.no_grad():       # the port's weights differ before the load
        tm.module.user_embed_table.add_(1.0)
    tm.estimator.model_dir = None
    assert tm.estimator.load_checkpoint(model_dir) == path
    assert tm.estimator.engine.step == 5
    _, _, jl, tl = _fit_both(jm, tm, epochs=1)
    assert len(tl) == len(jl) == 5
    np.testing.assert_allclose(tl, jl, **TOL)


@pytest.mark.parametrize("opt_name", ["Adam", "SGD"])
def test_port_checkpoint_reads_into_jax(orca_context, tmp_path, opt_name):
    model_dir = str(tmp_path / "port")
    jm, tm = ncf_pair(opt_name)
    tm.estimator.model_dir = model_dir
    pairs, labels = _data()
    tm.fit({"x": pairs, "y": labels}, epochs=1, batch_size=64,
           verbose=False, checkpoint_trigger=EveryEpoch())
    tm.estimator.model_dir = None
    path, step = _latest(model_dir)
    assert step == 5
    state = jckpt.load_checkpoint_dir(path)
    jeng = jm.estimator.engine
    jeng.set_state(interop.state_to_jax(state, jax.device_get(
        jeng.opt_state)))
    assert jeng.step == 5
    _, _, jl, tl = _fit_both(jm, tm, epochs=1)
    assert len(tl) == len(jl) == 5
    np.testing.assert_allclose(tl, jl, **TOL)


def _leaves():
    rng = np.random.RandomState(0)
    return {"params": {"kernel": rng.randn(3, 4).astype(np.float32),
                       "ids": rng.randint(0, 9, 5).astype(np.int32)},
            "opt_state": ({"count": np.asarray(3, np.int32)},
                          [np.zeros(2, np.float64)]),
            "step": 3}


@pytest.mark.parametrize("passphrase", [None, "pw"])
def test_same_leaves_same_blobs_and_cross_reads(tmp_path, passphrase):
    tree = _leaves()
    roots = {"jax": str(tmp_path / "j"), "port": str(tmp_path / "t")}
    jplane = jckpt.CheckpointPlane(roots["jax"], passphrase=passphrase)
    tplane = tckpt.CheckpointPlane(roots["port"], passphrase=passphrase)
    jpath = jplane.save(tree, 3, blocking=True)
    tpath = tplane.save(tree, 3, blocking=True)
    jdoc, tdoc = jfmt.read_manifest(jpath), tfmt.read_manifest(tpath)
    assert set(jdoc) == set(tdoc)
    assert jdoc["leaves"] == tdoc["leaves"]
    assert (jdoc["format"], jdoc["encrypted"]) == \
        (tdoc["format"], tdoc["encrypted"])
    suffix = ".enc" if passphrase else ""
    for rec in tdoc["leaves"]:
        names = [os.path.join(r, "blobs", rec["digest"] + suffix)
                 for r in roots.values()]
        data = [open(n, "rb").read() for n in names]
        if passphrase is None:
            assert data[0] == data[1]
    # each package reads the other's directory back to the same leaves
    for got in (jfmt.load_checkpoint_dir(tpath, passphrase),
                tfmt.load_checkpoint_dir(jpath, passphrase)):
        assert got["step"] == 3
        np.testing.assert_array_equal(got["params"]["kernel"],
                                      tree["params"]["kernel"])
        assert got["params"]["ids"].dtype == np.int32
        assert int(got["opt_state"][0]["count"]) == 3
        assert got["opt_state"][1][0].dtype == np.float64
    jplane.close()
    tplane.close()


def test_jax_optax_state_reads_as_stand_ins(orca_context, tmp_path):
    """A JAX-written optax state comes back as namedtuples with optax's
    field names, without importing optax."""
    jm, _ = ncf_pair("Adam")
    jest = jm.estimator
    path = jest.save_checkpoint(str(tmp_path), blocking=True)
    state = tfmt.load_checkpoint_dir(path)
    inject = state["opt_state"]
    assert type(inject).__name__ == "InjectStatefulHyperparamsState"
    adam = inject.inner_state[0]
    assert adam._fields == ("count", "mu", "nu")
    np.testing.assert_array_equal(adam.mu["user_embed_table"],
                                  np.zeros((51, 16), np.float32))
    assert "optax" not in type(adam).__module__


def test_uncommitted_and_corrupt_checkpoints_fall_back(tmp_path):
    root = str(tmp_path)
    plane = tckpt.CheckpointPlane(root)
    first = {"w": np.ones(4, np.float32), "step": 1}
    second = {"w": np.full(4, 2.0, np.float32), "step": 2}
    p1 = plane.save(first, 1, blocking=True)
    p2 = plane.save(second, 2, blocking=True)
    assert plane.restore()[0] == p2
    # an uncommitted dir (COMMIT missing) is no candidate
    commit = os.path.join(p2, tfmt.COMMIT_NAME)
    os.rename(commit, commit + ".away")
    assert _latest(root) == (p1, 1)
    path, state = plane.restore()
    assert path == p1 and state["step"] == 1
    os.rename(commit + ".away", commit)
    # a corrupt blob of the newer dir: restore falls back past it
    doc = tfmt.read_manifest(p2)
    blob = os.path.join(root, "blobs", doc["leaves"][0]["digest"])
    with open(blob, "r+b") as f:
        f.write(b"\x00\x00\x00\x00")
    path, state = plane.restore()
    assert path == p1
    np.testing.assert_array_equal(state["w"], first["w"])
    assert plane.stats.snapshot()["fallbacks"] == 1
    # a torn tmp dir left behind by a crash is ignored
    os.makedirs(os.path.join(root, ".tmp-ckpt-3-0000"))
    assert _latest(root)[1] == 2
    plane.close()


def test_estimator_retries_from_the_latest_checkpoint(tmp_path):
    """A step that fails mid-fit is retried from the latest committed
    checkpoint (the JAX estimator's max_failure_retries loop)."""
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    pairs, labels = _data()
    tm = NeuralCF(device="cpu", user_count=50, item_count=30, class_num=2,
                  user_embed=8, item_embed=8, hidden_layers=(16, 8),
                  mf_embed=8)
    # one step a dispatch: the failure is injected into train_batch
    # (tests/test_torch_fused_dispatch.py fails a fused group)
    tm.compile(loss="sparse_categorical_crossentropy", optimizer="adam",
               model_dir=str(tmp_path), config={"steps_per_dispatch": 1})
    eng = tm.estimator.engine
    inner, fired = eng.train_batch, []

    def flaky(batch):
        if eng.step == 7 and not fired:
            fired.append(eng.step)
            raise RuntimeError("injected step failure")
        return inner(batch)

    eng.train_batch = flaky
    stats = tm.fit({"x": pairs, "y": labels}, epochs=2, batch_size=64,
                   verbose=False, checkpoint_trigger=EveryEpoch(),
                   max_failure_retries=1)
    assert fired == [7]
    assert [s["epoch"] for s in stats] == [1, 2]
    assert eng.step == 10
    snap = tm.estimator.data_pipeline_stats()
    assert snap["ckpt"]["restores"] == 1
    assert json.dumps(snap)
