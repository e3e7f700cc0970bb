"""The port's ``Estimator.from_torch`` (analytics_zoo_tpu_torch/orca/learn/
pytorch) against the JAX package's, on the CPU: the same creator functions,
the same numpy-seeded data, ``shuffle=True``.

The JAX package converts the creators' torch module to flax (the fx path
for a module with its own ``forward``, the Sequential path with ``op_i``
names otherwise) and their optimizer to optax; the port trains the module
and the optimizer as they are. Tolerances, each with the reason:

* losses 1e-5 relative, parameters 1e-4 of each tensor's largest magnitude
  on the bottleneck ResNet (f32 with TF32 off on both sides; 6 steps of
  SGD with momentum, whose rounding differences grow through BatchNorm),
  1e-5 on the Sequential models;
* ``running_mean`` 1e-5 of its largest; ``running_var`` 1e-5 of its
  largest through the relation of the bridge's deviation: flax updates the
  running variance with the biased batch variance, torch with the unbiased
  one, so from var0 = 1 at momentum m over k steps
  ``port - (1-m)^k = n/(n-1) * (jax - (1-m)^k)``, n the batch x H x W
  elements a channel sees. The plain equality is the control, and misses.

Adagrad and RMSprop are not held to JAX: the bridge converts them to
optax formulas that differ from torch's (an accumulator that starts at 0.1
with eps 1e-7; eps inside the square root, momentum and ``centered``
dropped). The port equals ``torch.optim`` applied by hand, and the JAX
bridge is shown to miss it.
"""

import os
import sys
from functools import partial

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch
import torch.utils.data as tud
from torch import nn

from analytics_zoo_tpu.orca.learn import losses as jlosses
from analytics_zoo_tpu.orca.learn.pytorch import Estimator as JEstimator
from analytics_zoo_tpu.orca.learn.pytorch import \
    TrainingOperator as JOperator
from analytics_zoo_tpu.orca.learn.pytorch.torch_bridge import \
    convert_torch_loss as jconvert_torch_loss
from analytics_zoo_tpu_torch.orca.learn.pytorch import Estimator
from analytics_zoo_tpu_torch.orca.learn.pytorch import \
    TrainingOperator as TOperator
from analytics_zoo_tpu_torch.orca.learn.pytorch.estimator import \
    convert_torch_loss
from analytics_zoo_tpu_torch.orca.learn.trigger import EveryEpoch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import TorchResNet  # noqa: E402  (the smoke's user model)

LOSS_RTOL = 1e-5
RESNET_PARAM_TOL = 1e-4
SEQ_TOL = 1e-5
STATS_TOL = 1e-5


def _rel(a, b):
    """Largest difference relative to the reference's largest magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _data(n, shape, classes, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, *shape).astype(np.float32),
            rng.randint(0, classes, n).astype(np.int64))


def _seeded(make):
    """A model creator that draws the same torch weights on every call, so
    the JAX package's and the port's ``from_torch`` start alike."""
    def model_creator(cfg):
        torch.manual_seed(0)
        return make()
    return model_creator


def _both(model_creator, optimizer_creator, loss_creator=nn.CrossEntropyLoss,
          **kwargs):
    jest = JEstimator.from_torch(model_creator=model_creator,
                                 optimizer_creator=optimizer_creator,
                                 loss_creator=loss_creator, **kwargs)
    test = Estimator.from_torch(model_creator=model_creator,
                                optimizer_creator=optimizer_creator,
                                loss_creator=loss_creator, device="cpu",
                                **kwargs)
    return jest, test


def _losses(stats):
    return np.array([s["train_loss"] for s in stats])


# --- the narrow torchvision-style bottleneck ResNet (the fx path) ----------

RESNET_ROWS, RESNET_BATCH, RESNET_EPOCHS = 40, 16, 2     # 3 steps an epoch
BN_MOMENTUM = 0.1


def _fx_ref(jparams, jstats, name, value):
    """The JAX tree's counterpart of the port's state_dict entry ``name``:
    the fx path names a module by its torch path with '.' -> '_', keeps
    conv kernels OIHW and Dense kernels (in, out)."""
    mod, leaf = name.rsplit(".", 1)
    nm = mod.replace(".", "_")
    if leaf == "running_mean":
        return jstats[nm]["mean"]
    if leaf == "running_var":
        return jstats[nm]["var"]
    if value.dim() == 4:
        return jparams[nm + "_kernel"]
    if isinstance(jparams[nm], dict) and "kernel" in jparams[nm]:
        return (np.asarray(jparams[nm]["kernel"]).T if leaf == "weight"
                else jparams[nm]["bias"])
    return jparams[nm]["scale" if leaf == "weight" else "bias"]


@pytest.fixture(scope="module")
def resnet_runs():
    """One fit of each package: 2 epochs of 40 rows at batch 16 (the last
    batch of each padded), SGD with momentum 0.9, CrossEntropyLoss as a
    class. Also each BatchNorm's n (batch x H x W) from a forward hook."""
    from analytics_zoo_tpu import init_orca_context
    from analytics_zoo_tpu.common import context as ctx_mod
    if ctx_mod._current is None or ctx_mod._current._stopped:
        init_orca_context("cpu-sim", mesh_axes={"dp": -1})
    x, y = _data(RESNET_ROWS, (3, 32, 32), 10)
    creator = _seeded(lambda: TorchResNet((1, 1, 1, 1), width=4,
                                          num_classes=10))
    # one step a dispatch: the JAX estimator then compiles no fused
    # program (the port never fuses; the steps are the same either way)
    jest, test = _both(creator, lambda m, cfg: torch.optim.SGD(
        m.parameters(), lr=0.01, momentum=0.9),
        config={"steps_per_dispatch": 1})
    jstats = jest.fit({"x": x, "y": y}, epochs=RESNET_EPOCHS,
                      batch_size=RESNET_BATCH, verbose=False)
    tstats = test.fit({"x": x, "y": y}, epochs=RESNET_EPOCHS,
                      batch_size=RESNET_BATCH, verbose=False)
    elems = {}

    def count(name, module, inputs):
        elems[name] = inputs[0].numel() // inputs[0].shape[1]
    hooks = [m.register_forward_pre_hook(partial(count, name))
             for name, m in test.module.named_modules()
             if isinstance(m, nn.BatchNorm2d)]
    test.module.eval()          # counts without updating the statistics
    with torch.no_grad():
        test.module(torch.zeros(RESNET_BATCH, 3, 32, 32))
    for h in hooks:
        h.remove()
    steps = RESNET_EPOCHS * -(-RESNET_ROWS // RESNET_BATCH)
    return {"jax_losses": _losses(jstats), "port_losses": _losses(tstats),
            "jparams": jax.device_get(jest.engine.params),
            "jstats": jax.device_get(jest.engine.extra_vars)["batch_stats"],
            "state": {k: v for k, v in test.module.state_dict().items()
                      if not k.endswith("num_batches_tracked")},
            "elems": elems, "steps": steps}


def test_resnet_epoch_losses_match_jax(resnet_runs):
    r = resnet_runs
    np.testing.assert_allclose(r["port_losses"], r["jax_losses"],
                               rtol=LOSS_RTOL)


def test_resnet_parameters_match_jax(resnet_runs):
    r = resnet_runs
    errs = {k: _rel(v.numpy(), _fx_ref(r["jparams"], r["jstats"], k, v))
            for k, v in r["state"].items() if not k.endswith(
                ("running_mean", "running_var"))}
    assert max(errs.values()) <= RESNET_PARAM_TOL, \
        max(errs.items(), key=lambda kv: kv[1])


def test_resnet_running_mean_matches_jax(resnet_runs):
    r = resnet_runs
    for k, v in r["state"].items():
        if k.endswith("running_mean"):
            assert _rel(v.numpy(), _fx_ref(r["jparams"], r["jstats"], k,
                                           v)) <= STATS_TOL, k


def test_resnet_running_var_is_jax_unbiased(resnet_runs):
    """port - (1-m)^k = n/(n-1) (jax - (1-m)^k) within 1e-5 for every
    BatchNorm; the plain equality misses 1e-5 on every one."""
    r = resnet_runs
    decay = (1.0 - BN_MOMENTUM) ** r["steps"]
    checked = 0
    for k, v in r["state"].items():
        if not k.endswith("running_var"):
            continue
        n = r["elems"][k[:-len(".running_var")]]
        jvar = np.asarray(_fx_ref(r["jparams"], r["jstats"], k, v),
                          np.float64)
        want = decay + n / (n - 1.0) * (jvar - decay)
        assert _rel(v.numpy(), want) <= STATS_TOL, (k, n)
        assert _rel(v.numpy(), jvar) > STATS_TOL, (k, "control passed")
        checked += 1
    assert checked == 17


# --- Sequential models (the JAX bridge's fast path, op_i names) -------------

def _mlp():
    return nn.Sequential(nn.Linear(12, 16), nn.ReLU(), nn.Linear(16, 8),
                         nn.Tanh(), nn.Linear(8, 4))


def _conv_stack():
    return nn.Sequential(nn.Conv2d(3, 4, 3, padding=1, bias=False),
                         nn.BatchNorm2d(4),
                         nn.ReLU(), nn.MaxPool2d(2), nn.Flatten(),
                         nn.Linear(4 * 4 * 4, 4))


def _seq_ref(jparams, model, name, value):
    """The Sequential path's counterpart: module i is ``op_i``; Dense
    kernels (in, out), conv kernels HWIO, BatchNorm scale/bias."""
    idx, leaf = name.split(".")
    p = jparams[f"op_{idx}"]
    layer = model[int(idx)]
    if isinstance(layer, nn.Linear):
        return np.asarray(p["kernel"]).T if leaf == "weight" else p["bias"]
    if isinstance(layer, nn.Conv2d):
        return (np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
                if leaf == "weight" else p["bias"])
    return p["scale" if leaf == "weight" else "bias"]


OPTIMIZERS = {
    "sgd_momentum_wd": lambda ps: torch.optim.SGD(
        ps, lr=0.05, momentum=0.9, weight_decay=1e-3),
    "sgd_nesterov": lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9,
                                               nesterov=True),
    "adam_l2": lambda ps: torch.optim.Adam(ps, lr=1e-2, weight_decay=1e-3),
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=0.05),
}
SEQ_CASES = [("mlp", o) for o in OPTIMIZERS] + [
    ("conv", "sgd_momentum_wd"), ("conv", "adamw")]


def _seq_data(kind):
    if kind == "mlp":
        return _data(75, (12,), 4, seed=1)
    return _data(50, (3, 8, 8), 4, seed=2)


@pytest.mark.parametrize("kind,opt", SEQ_CASES)
def test_sequential_fit_matches_jax(orca_context, kind, opt):
    """3 epochs at batch 16 (a padded last batch each): losses and every
    parameter (and the conv stack's BatchNorm running mean) at 1e-5."""
    make = _mlp if kind == "mlp" else _conv_stack
    x, y = _seq_data(kind)
    jest, test = _both(_seeded(make),
                       lambda m, cfg: OPTIMIZERS[opt](m.parameters()))
    jl = _losses(jest.fit({"x": x, "y": y}, epochs=3, batch_size=16,
                          verbose=False))
    tl = _losses(test.fit({"x": x, "y": y}, epochs=3, batch_size=16,
                          verbose=False))
    np.testing.assert_allclose(tl, jl, rtol=SEQ_TOL)
    jparams = jax.device_get(jest.engine.params)
    for name, value in test.module.named_parameters():
        ref = _seq_ref(jparams, test.module, name, value)
        assert _rel(value.detach().numpy(), ref) <= SEQ_TOL, name
    if kind == "conv":
        jmean = jax.device_get(jest.engine.extra_vars)[
            "batch_stats"]["op_1"]["mean"]
        assert _rel(test.module[1].running_mean.numpy(), jmean) <= STATS_TOL


def _by_hand(make, opt_factory, x, y, batch_size, epochs):
    """``torch.optim`` applied by hand to the batches the port's fit draws
    (the same xoshiro order, epoch e at seed e + 1), the per-example
    cross-entropy averaged over each batch's real rows."""
    from analytics_zoo_tpu_torch.orca.learn import utils as tutils
    torch.manual_seed(0)
    model = make()
    opt = opt_factory(model.parameters())
    it = tutils.BatchIterator({"x": (x,), "y": (y,)}, batch_size,
                              shuffle=True)
    losses = []
    for ep in range(epochs):
        it._epoch = ep + 1
        for b in it.epoch():
            opt.zero_grad()
            per = nn.functional.cross_entropy(
                model(torch.from_numpy(b.x[0])),
                torch.from_numpy(b.y[0]).long(), reduction="none")
            w = (torch.ones(len(per)) if b.w is None
                 else torch.from_numpy(b.w))
            loss = (per * w).sum() / w.sum()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
    return model, losses


@pytest.mark.parametrize("opt", ["adagrad", "rmsprop_momentum_centered"])
def test_adagrad_rmsprop_are_torch_not_the_bridge(orca_context, opt):
    """The port trains with the creator's own optimizer: its parameters
    equal torch.optim's applied by hand (1e-6). The JAX bridge's optax
    conversion misses them by more than 1e-3: a documented deviation of
    the bridge, not held against the port."""
    factory = {
        "adagrad": lambda ps: torch.optim.Adagrad(ps, lr=0.05),
        "rmsprop_momentum_centered": lambda ps: torch.optim.RMSprop(
            ps, lr=0.01, momentum=0.5, centered=True)}[opt]
    x, y = _seq_data("mlp")
    jest, test = _both(_seeded(_mlp), lambda m, cfg: factory(m.parameters()))
    tl = _losses(test.fit({"x": x, "y": y}, epochs=2, batch_size=16,
                          verbose=False))
    jest.fit({"x": x, "y": y}, epochs=2, batch_size=16, verbose=False)
    model, hand = _by_hand(_mlp, factory, x, y, 16, 2)
    np.testing.assert_allclose(tl, [np.mean(hand[:5]), np.mean(hand[5:])],
                               rtol=1e-6)
    jparams = jax.device_get(jest.engine.params)
    bridge_miss = 0.0
    for (name, value), want in zip(test.module.named_parameters(),
                                   model.parameters()):
        assert _rel(value.detach().numpy(), want.detach().numpy()) <= 1e-6
        ref = _seq_ref(jparams, test.module, name, value)
        bridge_miss = max(bridge_miss, _rel(ref, want.detach().numpy()))
    assert bridge_miss > 1e-3


# --- losses ------------------------------------------------------------------

def _loss_inputs(name, rng):
    n = 6
    if name in ("CrossEntropyLoss", "NLLLoss"):
        logits = rng.randn(n, 5).astype(np.float32)
        if name == "NLLLoss":
            logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        return rng.randint(0, 5, n).astype(np.int64), logits
    if name == "BCELoss":
        return (rng.randint(0, 2, (n, 1)).astype(np.float32),
                rng.uniform(0.01, 0.99, (n, 1)).astype(np.float32))
    if name == "KLDivLoss":
        p = np.exp(rng.randn(n, 5))
        q = np.exp(rng.randn(n, 5))
        return ((p / p.sum(-1, keepdims=True)).astype(np.float32),
                (q / q.sum(-1, keepdims=True)).astype(np.float32))
    if name == "HingeEmbeddingLoss":
        return (np.sign(rng.randn(n, 3)).astype(np.float32),
                rng.randn(n, 3).astype(np.float32))
    return rng.randn(n, 3).astype(np.float32), \
        rng.randn(n, 3).astype(np.float32)


TORCH_LOSSES = ["MSELoss", "L1Loss", "BCELoss", "BCEWithLogitsLoss",
                "CrossEntropyLoss", "NLLLoss", "SmoothL1Loss",
                "HingeEmbeddingLoss", "KLDivLoss"]


@pytest.mark.parametrize("name", TORCH_LOSSES)
def test_torch_loss_table_matches_jax(name):
    """Each torch loss class maps onto the per-example loss JAX maps it
    onto (rtol/atol 1e-6: the same f32 formula)."""
    y_true, y_pred = _loss_inputs(name, np.random.RandomState(3))
    cls = getattr(nn, name)
    want = jconvert_torch_loss(cls())(y_true, y_pred)
    got = convert_torch_loss(cls())(torch.from_numpy(y_true),
                                    torch.from_numpy(y_pred))
    assert got.shape == (len(y_true),)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_torch_loss_classes_and_unsupported_losses():
    """A class maps like its instance; a loss outside the table raises, as
    in the JAX package; any other callable passes through."""
    assert convert_torch_loss(nn.MSELoss) is convert_torch_loss(nn.MSELoss())
    fn = lambda y_true, y_pred: y_pred     # noqa: E731
    assert convert_torch_loss(fn) is fn and convert_torch_loss(None) is None
    with pytest.raises(ValueError, match="unsupported torch loss"):
        convert_torch_loss(nn.CosineEmbeddingLoss())


def test_padded_batch_loss_is_masked_like_jax(orca_context):
    """37 rows at batch 16: the last batch has 11 padded rows, which the
    epoch loss leaves out as JAX's does (rtol 1e-5). The control, torch's
    own mean reduction over the whole padded batch, misses it."""
    x, y = _data(37, (12,), 4, seed=4)
    sgd = lambda m, cfg: torch.optim.SGD(m.parameters(), lr=0.05)  # noqa
    jest, test = _both(_seeded(_mlp), sgd)
    jl = _losses(jest.fit({"x": x, "y": y}, epochs=1, batch_size=16,
                          verbose=False))
    tl = _losses(test.fit({"x": x, "y": y}, epochs=1, batch_size=16,
                          verbose=False))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)

    def torch_mean(cfg):
        ce = nn.CrossEntropyLoss()
        return lambda y_true, y_pred: ce(y_pred, y_true.long()).expand(
            len(y_true))
    control = Estimator.from_torch(model_creator=_seeded(_mlp),
                                   optimizer_creator=sgd,
                                   loss_creator=torch_mean, device="cpu")
    cl = _losses(control.fit({"x": x, "y": y}, epochs=1, batch_size=16,
                             verbose=False))
    assert abs(cl[0] - jl[0]) / jl[0] > 1e-3


# --- forms --------------------------------------------------------------------

def _port_fit_losses(data, loss_creator=nn.CrossEntropyLoss, epochs=2,
                     batch_size=16):
    est = Estimator.from_torch(
        model_creator=_seeded(_mlp),
        optimizer_creator=lambda m, cfg: torch.optim.SGD(m.parameters(),
                                                         lr=0.05),
        loss_creator=loss_creator, device="cpu")
    return _losses(est.fit(data, epochs=epochs, batch_size=batch_size,
                           verbose=False))


@pytest.mark.parametrize("form", ["class", "function"])
def test_loss_creator_forms(form):
    """A class is instantiated; a function is called with the config:
    both give the arrays-fed run's losses exactly."""
    seen = []

    def creator(cfg):
        seen.append(cfg)
        return nn.CrossEntropyLoss()
    x, y = _seq_data("mlp")
    want = _port_fit_losses({"x": x, "y": y})
    got = _port_fit_losses({"x": x, "y": y}, loss_creator=(
        nn.CrossEntropyLoss if form == "class" else creator))
    np.testing.assert_array_equal(got, want)
    assert seen == ([] if form == "class" else [{}])


@pytest.mark.parametrize("form", ["dataloader", "dataset"])
def test_data_creator_forms(orca_context, form):
    """A data creator returning an unshuffled DataLoader or a Dataset is
    read into arrays: the losses equal the arrays-fed run's exactly, and
    JAX's from the same creator at 1e-5."""
    x, y = _seq_data("mlp")
    ds = tud.TensorDataset(torch.from_numpy(x), torch.from_numpy(y))

    def creator(cfg, batch_size):
        if form == "dataset":
            return ds
        return tud.DataLoader(ds, batch_size=batch_size, shuffle=False)
    got = _port_fit_losses(creator)
    np.testing.assert_array_equal(got, _port_fit_losses({"x": x, "y": y}))
    jest = JEstimator.from_torch(
        model_creator=_seeded(_mlp),
        optimizer_creator=lambda m, cfg: torch.optim.SGD(m.parameters(),
                                                         lr=0.05),
        loss_creator=nn.CrossEntropyLoss)
    jl = _losses(jest.fit(creator, epochs=2, batch_size=16, verbose=False))
    np.testing.assert_allclose(got, jl, rtol=1e-5)


class _FlaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(4)(x)


@pytest.mark.parametrize("which", ["model", "optimizer", "loss"])
def test_jax_creators_raise(which):
    kwargs = {"model_creator": _seeded(_mlp),
              "optimizer_creator": lambda m, cfg: torch.optim.SGD(
                  m.parameters(), lr=0.1),
              "loss_creator": nn.MSELoss}
    kwargs[f"{which}_creator"] = {
        "model": lambda cfg: _FlaxNet(),
        "optimizer": lambda m, cfg: optax.sgd(0.1),
        "loss": lambda cfg: jlosses.mean_squared_error}[which]
    with pytest.raises(TypeError, match="takes torch objects"):
        Estimator.from_torch(device="cpu", **kwargs)


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Estimator.from_torch(model_creator=_seeded(_mlp),
                             loss_creator=nn.CrossEntropyLoss)


def test_optimizer_holds_the_module_parameters_and_defaults_to_adam():
    seen = []

    def opt_creator(model, cfg):
        seen.append(next(model.parameters()))
        return torch.optim.SGD(model.parameters(), lr=0.1)
    est = Estimator.from_torch(model_creator=_seeded(_mlp),
                               optimizer_creator=opt_creator,
                               loss_creator=nn.CrossEntropyLoss,
                               device="cpu")
    est.engine.build()
    assert seen[0] is next(est.module.parameters())
    assert est.engine.opt.param_groups[0]["params"][0] is seen[0]
    plain = Estimator.from_torch(model_creator=_seeded(_mlp),
                                 loss_creator=nn.CrossEntropyLoss,
                                 device="cpu")
    plain.engine.build()
    assert isinstance(plain.engine.opt, torch.optim.Adam)
    assert plain.engine.opt.param_groups[0]["lr"] == 1e-3


# --- training operator and the epochs' shuffle seeds ------------------------

def _recording(base):
    class Recording(base):
        def setup(self, config):
            self.seen = []

        def train_batch(self, batch, batch_info):
            out = super().train_batch(batch, batch_info)
            self.seen.append((batch_info["batch_idx"],
                              np.asarray(batch.x[0]).copy(),
                              out["num_samples"]))
            return out
    return Recording


def test_operator_batch_stream_matches_jax(orca_context):
    """With ``training_operator_cls`` both packages feed the operator the
    same batches (epoch e shuffled with seed + e, no build draw) and count
    the same real rows; the losses agree at 1e-5."""
    x, y = _data(37, (12,), 4, seed=5)
    kwargs = dict(loss_creator=nn.CrossEntropyLoss)
    sgd = lambda m, cfg: torch.optim.SGD(m.parameters(), lr=0.05)  # noqa
    jest = JEstimator.from_torch(model_creator=_seeded(_mlp),
                                 optimizer_creator=sgd,
                                 training_operator_cls=_recording(JOperator),
                                 **kwargs)
    test = Estimator.from_torch(model_creator=_seeded(_mlp),
                                optimizer_creator=sgd,
                                training_operator_cls=_recording(TOperator),
                                device="cpu", **kwargs)
    js = jest.fit({"x": x, "y": y}, epochs=2, batch_size=16)
    ts = test.fit({"x": x, "y": y}, epochs=2, batch_size=16)
    jseen, tseen = jest._operator.seen, test._operator.seen
    assert len(tseen) == len(jseen) == 6
    for (ti, tx, tn), (ji, jx, jn) in zip(tseen, jseen):
        assert (ti, tn) == (ji, jn)
        np.testing.assert_array_equal(tx, jx)
    from analytics_zoo_tpu.native import shuffled_indices
    for ep in range(2):
        rows = np.concatenate([b for _, b, _ in tseen[3 * ep:3 * ep + 3]])
        np.testing.assert_array_equal(
            rows[:37], x[shuffled_indices(37, seed=ep)])
    assert [s["num_samples"] for s in ts] == [37, 37]
    np.testing.assert_allclose(_losses(ts), _losses(js), rtol=1e-5)
    assert test._operator.optimizer is test.engine.opt
    assert test._operator.model is test.module


def test_plain_fit_epochs_shuffle_with_seed_plus_one(orca_context):
    """The plain ``fit`` draws a build sample first, so epoch e shuffles
    with seed + e + 1, in both packages: the batches the engine trains on
    are the same arrays."""
    x, y = _data(37, (12,), 4, seed=6)
    jest, test = _both(_seeded(_mlp), lambda m, cfg: torch.optim.SGD(
        m.parameters(), lr=0.05))
    seen = {"jax": [], "port": []}
    for key, eng in (("jax", jest.engine), ("port", test.engine)):
        inner = eng.train_batch

        def record(batch, inner=inner, key=key):
            seen[key].append(np.asarray(batch.x[0]).copy())
            return inner(batch)
        eng.train_batch = record
    jest.fit({"x": x, "y": y}, epochs=2, batch_size=16, verbose=False)
    test.fit({"x": x, "y": y}, epochs=2, batch_size=16, verbose=False)
    assert len(seen["port"]) == len(seen["jax"]) == 6
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    from analytics_zoo_tpu.native import shuffled_indices
    for ep in range(2):
        rows = np.concatenate(seen["port"][3 * ep:3 * ep + 3])[:37]
        np.testing.assert_array_equal(rows,
                                      x[shuffled_indices(37, seed=ep + 1)])


# --- checkpoints ---------------------------------------------------------------

def test_checkpoint_restores_and_continues(tmp_path):
    """A fit with ``model_dir`` and an every-epoch trigger writes the
    module's state_dict names and the optimizer's state; a fresh
    ``from_torch`` estimator restores it and continues 2 steps of the next
    epoch as the uninterrupted run does (losses 1e-6)."""
    from analytics_zoo_tpu_torch.ckpt import load_checkpoint_dir
    x, y = _data(48, (12,), 4, seed=7)
    kwargs = dict(model_creator=_seeded(_mlp),
                  optimizer_creator=lambda m, cfg: torch.optim.SGD(
                      m.parameters(), lr=0.05, momentum=0.9),
                  loss_creator=nn.CrossEntropyLoss, device="cpu")
    d = str(tmp_path / "ckpt")
    run = Estimator.from_torch(model_dir=d, **kwargs)
    run.fit({"x": x, "y": y}, epochs=1, batch_size=16, verbose=False,
            checkpoint_trigger=EveryEpoch())
    path = Estimator.latest_checkpoint(d)
    assert path is not None and path.endswith("ckpt-3")
    state = load_checkpoint_dir(path)
    assert set(state["params"]) == set(run.module.state_dict())
    assert state["opt_state"]["state"][0]["momentum_buffer"].shape == (16, 12)
    cont = dict(epochs=1, batch_size=16, verbose=False, steps_per_epoch=2,
                initial_epoch=1)
    want = run.fit({"x": x, "y": y}, **cont)
    fresh = Estimator.from_torch(**kwargs)
    fresh.load_checkpoint(d)
    got = fresh.fit({"x": x, "y": y}, **cont)
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-6)
    for a, b in zip(fresh.module.parameters(), run.module.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    run.shutdown()
    fresh.shutdown()
