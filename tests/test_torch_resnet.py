"""The port's ResNet (analytics_zoo_tpu_torch/models/image/resnet.py), its
schedules and its state against the JAX package's, on the CPU.

Narrow models (a ResNet-18-shaped stack of ``BasicBlock``s and a
``BottleneckBlock`` stack with projections, ``num_filters`` 8, crop 32),
f32 with TF32 off, weights bridged through ``interop``:

* logits and loss within 1e-5 relative, first-step gradients within 1e-4
  of each parameter's largest, BatchNorm running statistics after a train
  step within 1e-5 of each leaf's largest. Two controls must miss: torch's
  symmetric ``padding=1`` on the stride-2 3x3 convs (flax pads those (0,
  1)), and ``torch.nn.BatchNorm2d``'s update (unbiased variance);
* the ``s2d`` stem equals the conv7 stem and JAX's ``s2d`` (1e-5);
* a Warmup -> Poly SGD-momentum fit over ``ImageNetPipeline`` gives
  JAX's batches, losses and parameters (1e-5), and ``evaluate`` over an
  eval pipeline JAX's loss;
* checkpoints cross both ways with their BatchNorm statistics, and the
  restored runs continue like JAX's (losses 1e-5).

Init statistics (a wrong init is invisible to bridged weights): the port's
``resnet(18)`` against flax's, per layer kind, and ``MXUEmbed``'s (fault
R3) in tests/test_torch_embedding.py.
"""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import ckpt as jckpt
from analytics_zoo_tpu.orca.data.image import imagenet as jimagenet
from analytics_zoo_tpu.orca.learn import losses as jlosses
from analytics_zoo_tpu.orca.learn.estimator import \
    TPUEstimator as JEstimator
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu.orca.learn.optimizers import schedule as jsched
from analytics_zoo_tpu.orca.learn.trigger import EveryEpoch as JEveryEpoch
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.data.image import imagenet as timagenet
from analytics_zoo_tpu_torch.orca.learn import losses as tlosses
from analytics_zoo_tpu_torch.orca.learn.estimator import TPUEstimator
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt
from analytics_zoo_tpu_torch.orca.learn.optimizers import schedule as tsched
from analytics_zoo_tpu_torch.orca.learn.trigger import EveryEpoch

from test_torch_ncf import native_runtimes_built

# the packages' ``resnet`` function shadows the module on the package
jr = importlib.import_module("analytics_zoo_tpu.models.image.resnet")
tr = importlib.import_module("analytics_zoo_tpu_torch.models.image.resnet")

TOL_LOGITS = 1e-5           # relative to the largest logit; loss relative
TOL_GRAD = 1e-4             # relative to each parameter's largest gradient
TOL_STATS = 1e-5            # relative to each statistic's largest
TOL_FIT = dict(rtol=1e-5, atol=1e-5)
TOL_INIT = 0.03             # init std, port against flax
CROP, SIZE = 32, 40
NARROW = {     # kind: (stage sizes, block)
    "basic": ((2, 2, 2, 2), "BasicBlock"),
    "bottleneck": ((1, 2), "BottleneckBlock"),
}


def _models(kind, dtype="float32", **kw):
    stages, name = NARROW[kind]
    common = dict(stage_sizes=stages, num_classes=10, num_filters=8, **kw)
    jm = jr.ResNet(block_cls=getattr(jr, name),
                   compute_dtype=getattr(jnp, dtype), **common)
    tm = tr.ResNet(block_cls=getattr(tr, name),
                   compute_dtype=getattr(torch, dtype), **common)
    return jm, tm


def _images(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, CROP, CROP, 3)).astype(np.uint8),
            rng.randint(0, 10, n).astype(np.int32))


def _variables(jm, seed=1):
    """flax variables with every leaf moved off its init (the last
    BatchNorms' zero scales would hide their branch)."""
    v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        _images(1)[0]))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.abs(rng.normal(0, 0.05, a.shape)
                                         ).astype(np.float32), v)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_step(jm, v, x, y):
    def loss_of(params):
        logits, new = jm.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, x,
                               train=True, mutable=["batch_stats"])
        loss = jlosses.sparse_categorical_crossentropy(
            y, logits, from_logits=True).mean()
        return loss, (logits, new["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(v["params"])
    return jax.device_get((float(loss), logits, grads, stats))


def _port_step(tm, x, y):
    tm.train()
    tm.zero_grad(set_to_none=True)
    logits = tm(torch.from_numpy(x))
    loss = tlosses.sparse_categorical_crossentropy(
        torch.from_numpy(y).long(), logits, from_logits=True).mean()
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    return (float(loss.detach()), logits.detach().numpy(), grads,
            interop.state_dict_to_batch_stats(tm.state_dict()))


def _readings(want, tm, v, x, y):
    """The port's step against ``want``, JAX's (``_jax_step``)."""
    interop.load_flax_params(tm, v)
    jl, jlog, jg, jstats = want
    tl, tlog, tg, tstats = _port_step(tm, x, y)
    jg = interop.flax_to_state_dict(jg)
    grad = max(_rel(tg[n], jg[n].numpy()) for n in tg)
    stats = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        _rel, tstats, jstats)))
    return {"logits": _rel(tlog, jlog), "loss": abs(tl - jl) / abs(jl),
            "grad": grad, "stats": stats}


def _symmetric_pads(size, kernel, stride):
    return kernel // 2, kernel // 2           # torch's padding=k//2


def _torch_bn_forward(self, x):
    """torch.nn.BatchNorm2d's update: momentum 0.1, unbiased variance."""
    return torch.nn.functional.batch_norm(
        x, self.running_mean, self.running_var, self.weight, self.bias,
        self.training, 1.0 - tr.BN_MOMENTUM, tr.BN_EPSILON)


@pytest.mark.parametrize("kind", sorted(NARROW))
def test_narrow_resnet_matches_jax(kind, monkeypatch):
    jm, tm = _models(kind)
    v = _variables(jm)
    x, y = _images()
    want = _jax_step(jm, v, x, y)
    got = _readings(want, tm, v, x, y)
    print(kind, got)
    assert got["logits"] <= TOL_LOGITS and got["loss"] <= TOL_LOGITS
    assert got["grad"] <= TOL_GRAD
    assert got["stats"] <= TOL_STATS
    # controls: each must miss its limit
    with monkeypatch.context() as m:
        m.setattr(tr, "same_pads", _symmetric_pads)
        pad = _readings(want, tm, v, x, y)
    with monkeypatch.context() as m:
        m.setattr(tr.BatchNorm, "forward", _torch_bn_forward)
        bn = _readings(want, tm, v, x, y)
    print(kind, "controls", pad, bn)
    assert pad["logits"] > TOL_LOGITS and pad["grad"] > TOL_GRAD
    assert bn["stats"] > TOL_STATS


def test_s2d_stem_matches_conv7_and_jax():
    jm, tm = _models("basic")
    v = _variables(jm)
    x, _ = _images()
    interop.load_flax_params(tm, v)
    tm.eval()
    conv7 = tm(torch.from_numpy(x)).detach().numpy()
    tm.stem = "s2d"
    s2d = tm(torch.from_numpy(x)).detach().numpy()
    s2d_apply = jax.jit(partial(jm.clone(stem="s2d").apply, train=False))
    want = jax.device_get(s2d_apply(v, x))
    assert _rel(s2d, conv7) <= TOL_LOGITS
    assert _rel(s2d, want) <= TOL_LOGITS
    # the stem module alone, on the stem's channels-last input
    stem = tr.SpaceToDepthStem(3, 8, dtype=torch.float32)
    stem.load_state_dict(tm.conv_init.state_dict())
    xin = torch.from_numpy(x).float().permute(0, 3, 1, 2)
    with torch.no_grad():
        assert _rel(stem(xin).numpy(), tm.conv_init(xin).numpy()) \
            <= TOL_LOGITS
    # an odd crop: s2d falls back to conv7
    odd = np.ascontiguousarray(x[:, :31, :31])
    assert _rel(tm(torch.from_numpy(odd)).detach().numpy(),
                jax.device_get(s2d_apply(v, odd))) <= TOL_LOGITS


def test_uint8_normalisation_constants_match_jax():
    """``(x - mean) * (1 / std)`` with the constants rounded to the
    compute dtype as the JAX model rounds them."""
    for dt in ("float32", "bfloat16"):
        _, tm = _models("basic", dtype=dt)
        want_mean = np.asarray(jnp.asarray(jimagenet.IMAGENET_MEAN,
                                           getattr(jnp, dt)), np.float32)
        want_inv = np.asarray(jnp.asarray(
            1.0 / np.asarray(jimagenet.IMAGENET_STD), getattr(jnp, dt)),
            np.float32)
        tdt = getattr(torch, dt)
        np.testing.assert_array_equal(
            tm._mean.to(tdt).float().numpy(), want_mean)
        np.testing.assert_array_equal(
            tm._inv_std.to(tdt).float().numpy(), want_inv)


def test_resnet50_structure_and_interop_round_trip():
    """resnet(50): 25,557,032 parameters, 53,120 BatchNorm statistics; the
    JAX init tree (161 parameter leaves) loads with no missing, extra or
    mis-shaped key and comes back byte for byte."""
    jm = jr.resnet(50, 1000)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3), jnp.uint8))
    rng = np.random.RandomState(0)
    v = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(s.dtype), shapes)
    assert len(jax.tree_util.tree_leaves(v["params"])) == 161
    tm = tr.resnet(50, 1000)
    assert sum(p.numel() for p in tm.parameters()) == 25_557_032
    assert sum(b.numel() for n, b in tm.named_buffers()
               if n.endswith(("running_mean", "running_var"))) == 53_120
    assert sum(a.size for a in jax.tree_util.tree_leaves(
        v["batch_stats"])) == 53_120
    interop.load_flax_params(tm, v)
    sd = tm.state_dict()
    for tree, back in ((v["params"], interop.state_dict_to_flax(sd)),
                       (v["batch_stats"],
                        interop.state_dict_to_batch_stats(sd))):
        flat_w = jax.tree_util.tree_leaves_with_path(tree)
        flat_g = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (_, a), (_, b) in zip(flat_w, flat_g):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    bad = jax.tree_util.tree_map(lambda a: a, v)
    bad["params"]["conv_init"]["kernel"] = np.zeros((7, 7, 3, 32),
                                                    np.float32)
    with pytest.raises(ValueError, match="conv_init.weight"):
        interop.load_flax_params(tm, bad)
    with pytest.raises(ValueError, match="missing"):
        interop.load_flax_params(tm, v["params"])    # no batch_stats


def _z(w, fan_in):
    return np.asarray(w, np.float64).ravel() * np.sqrt(fan_in)


def test_resnet_init_statistics_match_flax():
    """resnet(18)'s init, per layer kind, against flax's: conv and Dense
    kernels lecun-normal (their values times sqrt(fan_in) have std 1 and
    lie within 2 / 0.8796), Dense bias zero, BatchNorm scale 1 and bias 0,
    each block's last BatchNorm scale 0. Control: torch's default conv
    init (std 1/sqrt(3 fan_in)) misses."""
    jm = jr.resnet(18, 1000)
    v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        np.zeros((1, 32, 32, 3), np.uint8)))
    torch.manual_seed(0)
    tm = tr.resnet(18, 1000)
    jsd = interop.flax_to_state_dict(v)
    tsd = tm.state_dict()
    assert set(jsd) == set(tsd)

    def pooled(sd, dims):
        return np.concatenate([_z(w, np.prod(w.shape[1:]))
                               for w in sd.values() if w.dim() == dims])

    for dims in (4, 2):                         # conv, Dense kernels
        jz, tz = pooled(jsd, dims), pooled(tsd, dims)
        assert jz.size == tz.size >= 500_000
        assert abs(tz.std() / jz.std() - 1) <= TOL_INIT
        assert abs(jz.std() - 1) <= TOL_INIT
        assert abs(tz.mean()) <= 0.01 and abs(jz.mean()) <= 0.01
        assert np.abs(tz).max() <= 2 / 0.8796 + 1e-4
    for name, want in jsd.items():
        if want.dim() == 1:                     # BN scale/bias, Dense bias
            np.testing.assert_array_equal(tsd[name].numpy(), want.numpy())
    last = [n for n in tsd if n.endswith("BatchNorm_1.weight")]
    assert len(last) == 8 and all(not tsd[n].any() for n in last)
    control = torch.nn.Conv2d(64, 64, 3, bias=False).weight.detach()
    cz = _z(control, 64 * 9)
    assert abs(cz.std() - 1) > TOL_INIT


# --- schedules -----------------------------------------------------------

def _bench_schedule(mod, peak=0.1, warm=40, decay=680):
    return (mod.SequentialSchedule()
            .add(mod.Warmup(delta=peak / warm), warm)
            .add(mod.Poly(2.0, decay), decay))


def test_warmup_poly_lr_matches_optax():
    """Every step of bench_resnet50's schedule (warmup 40, poly 680) and
    past its end. JAX evaluates optax's formulas in f32, which carry a
    relative 6e-8 on the step fraction: the port's lr is held to 1e-6 of
    the peak. Control: the port's lr one step ahead (an off-by-one of
    LambdaLR's kind) misses."""
    peak, total = 0.1, 720
    cases = [(_bench_schedule(jsched), _bench_schedule(tsched), 0.0),
             (jsched.Poly(0.5, 10), tsched.Poly(0.5, 10), 0.2),
             (jsched.Warmup(0.01), tsched.Warmup(0.01), 0.3),
             (jsched.SequentialSchedule(), tsched.SequentialSchedule(), 0.4),
             (jsched.Default(), tsched.Default(), 0.5)]
    for jsch, tsch, base in cases:
        fn = jsch.to_optax(base)
        steps = range(total + 6)
        want = np.asarray([float(fn(k)) for k in steps])
        got = np.asarray([tsch.lr_at(k, base) for k in steps])
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= 1e-6 * scale, type(tsch)
    fn = _bench_schedule(jsched).to_optax(0.0)
    sched = _bench_schedule(tsched)
    assert sched.lr_at(0, 0.0) == 0.0
    assert abs(sched.lr_at(40, 0.0) - peak) <= 1e-6 * peak
    ahead = np.asarray([sched.lr_at(k + 1, 0.0) for k in range(total)])
    want = np.asarray([float(fn(k)) for k in range(total)])
    assert np.abs(ahead - want).max() > 1e-6 * peak
    opt = topt.SGD(learningrate=0.0, momentum=0.9,
                   leaningrate_schedule=sched)
    assert opt.to_torch().lr_at(40) == sched.lr_at(40, 0.0)
    assert topt.SGD(learningrate=0.1).to_torch().lr_at is None
    with pytest.raises(ValueError, match="schedule"):
        topt.SGD(leaningrate_schedule=fn)


# --- the slice as a whole: fit over the pipeline, evaluate, checkpoints --

def _schedule(mod):
    """A short Warmup -> Poly: lr 0, 0.05, then the peak 0.1 decaying."""
    return (mod.SequentialSchedule().add(mod.Warmup(delta=0.05), 2)
            .add(mod.Poly(2.0, 6), 6))


def _jax_estimator(jm, **kw):
    est = JEstimator(
        jm, loss=partial(jlosses.sparse_categorical_crossentropy,
                         from_logits=True),
        optimizer=jopt.SGD(learningrate=0.0, momentum=0.9,
                           leaningrate_schedule=_schedule(jsched)),
        config={"steps_per_dispatch": 1}, **kw)
    est.engine.build((_images(1)[0],))
    return est


def _port_estimator(tm, jest, **kw):
    interop.load_flax_params(tm, {"params": jest.engine.params,
                                  "batch_stats": jest.engine.extra_vars[
                                      "batch_stats"]})
    return TPUEstimator(
        tm, loss=partial(tlosses.sparse_categorical_crossentropy,
                         from_logits=True),
        optimizer=topt.SGD(learningrate=0.0, momentum=0.9,
                           leaningrate_schedule=_schedule(tsched)),
        device="cpu", **kw)


def _record(engine, into):
    """Wrap ``engine.train_batch`` to keep each step's images and loss."""
    inner = engine.train_batch

    def train_batch(batch):
        into.append((np.asarray(batch.x[0]).copy(), inner(batch)))
        return into[-1][1]

    engine.train_batch = train_batch


def _pipes(root, mesh, n_train=True):
    kw = dict(crop_size=CROP, train=n_train, seed=4)
    return (jimagenet.ImageNetPipeline(root, 8, mesh, **kw),
            timagenet.ImageNetPipeline(root, 8, **kw))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagenet"))
    return timagenet.write_synthetic_imagenet(root, 24, image_size=SIZE,
                                              num_classes=10,
                                              shard_size=16, seed=2)


def _params_rel(jest, tm) -> float:
    want = interop.flax_to_state_dict(
        {"params": jax.device_get(jest.engine.params),
         "batch_stats": jax.device_get(
             jest.engine.extra_vars["batch_stats"])})
    got = tm.state_dict()
    return max(_rel(got[n].numpy(), want[n].numpy()) for n in want)


def test_scheduled_fit_over_pipeline_matches_jax(orca_context, shards):
    """Two epochs of 3 steps, SGD momentum 0.9 under Warmup -> Poly: each
    epoch trains on JAX's batches (crops drawn with seed + epoch + 1: the
    build sample advanced the counter), every step's loss and the final
    parameters and statistics within 1e-5; evaluate over an eval
    pipeline gives JAX's loss. Control: the batches the fit would have
    trained on without the sample draw differ from JAX's."""
    assert native_runtimes_built()
    jm, tm = _models("basic")
    jest = _jax_estimator(jm)
    test = _port_estimator(tm, jest)
    jpipe, tpipe = _pipes(shards, orca_context.mesh)
    jsteps, tsteps = [], []
    _record(jest.engine, jsteps)
    _record(test.engine, tsteps)
    jest.fit(jpipe, epochs=2, verbose=False)
    test.fit(tpipe, epochs=2, verbose=False)
    assert len(tsteps) == len(jsteps) == 6
    for (tx, _), (jx, _) in zip(tsteps, jsteps):
        np.testing.assert_array_equal(tx, jx)
    np.testing.assert_allclose([float(v) for _, v in tsteps],
                               [float(v) for _, v in jax.device_get(jsteps)],
                               **TOL_FIT)
    assert test.engine.step == 6
    assert test.engine.opt.param_groups[0]["lr"] == \
        _schedule(tsched).lr_at(5, 0.0)
    assert _params_rel(jest, tm) <= TOL_FIT["rtol"]
    # evaluate over an eval-mode pipeline (center crops, running stats)
    jeval, teval = _pipes(shards, orca_context.mesh, n_train=False)
    jres = jest.evaluate(jeval, verbose=False)
    tres = test.evaluate(teval, verbose=False)
    assert tres["num_samples"] == jres["num_samples"] == 24
    np.testing.assert_allclose(tres["loss"], jres["loss"], **TOL_FIT)
    # control: epoch 0 without the build sample's draw
    _, fresh = _pipes(shards, orca_context.mesh)
    undrawn = [b.x[0] for b in fresh._host_batches(True)]
    assert not np.array_equal(undrawn[0], jsteps[0][0])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_carry_batch_stats(orca_context, shards, tmp_path,
                                       direction):
    """A checkpoint with BatchNorm statistics, momentum and the schedule's
    count written by one package restores into the other; both then
    continue 2 steps alike (losses 1e-5)."""
    assert native_runtimes_built()
    jm, tm = _models("bottleneck")
    jest = _jax_estimator(jm)
    test = _port_estimator(tm, jest)
    model_dir = str(tmp_path)
    writer = jest if direction == "jax_to_port" else test
    writer.model_dir = model_dir
    pipe = _pipes(shards, orca_context.mesh)[
        0 if writer is jest else 1]
    writer.fit(pipe, epochs=1, verbose=False,
               checkpoint_trigger=(JEveryEpoch() if writer is jest
                                   else EveryEpoch()))
    writer.model_dir = None
    if writer is jest:
        with torch.no_grad():       # the port's statistics differ before
            for name, b in tm.named_buffers():
                if name.endswith(("running_mean", "running_var")):
                    b.add_(1.0)
        test.load_checkpoint(model_dir)
    else:
        state = jckpt.load_checkpoint_dir(test.latest_checkpoint(model_dir))
        assert "BottleneckBlock_0.proj_bn.running_var" in state["params"]
        jeng = jest.engine
        converted = interop.state_to_jax(state,
                                         jax.device_get(jeng.opt_state))
        assert "batch_stats" in converted["extra_vars"]
        jeng.set_state(converted)
    assert test.engine.step == jest.engine.step == 3
    assert _params_rel(jest, tm) == 0.0
    momentum = interop.flax_to_state_dict(
        jax.device_get(jest.engine.opt_state[0].trace))
    for i, (name, _) in enumerate(tm.named_parameters()):
        buf = test.engine.opt.state[test.engine.opt.param_groups[0][
            "params"][i]]["momentum_buffer"]
        np.testing.assert_array_equal(buf.numpy(), momentum[name].numpy())
    jsteps, tsteps = [], []
    _record(jest.engine, jsteps)
    _record(test.engine, tsteps)
    jp, tp = _pipes(shards, orca_context.mesh)
    jest.fit(jp, epochs=1, verbose=False, steps_per_epoch=2)
    test.fit(tp, epochs=1, verbose=False, steps_per_epoch=2)
    np.testing.assert_allclose([float(v) for _, v in tsteps],
                               [float(v) for _, v in jax.device_get(jsteps)],
                               **TOL_FIT)
    assert len(tsteps) == 2
