"""The port's TCMF (``analytics_zoo_tpu_torch/zouwu/model/tcmf.py``) on the
CPU against the JAX package's: the three nets against flax on the same
parameters, ``_loss`` and its gradients against ``jax.value_and_grad``,
the global and the hybrid ``fit`` (seasonal channels on) from carried
initial weights, ``predict`` and ``_predict_hybrid``, ``evaluate``,
``fit_incremental``, the ``"auto"`` gate, the initial draws' statistics
against flax's (torch's default init the control), the save blob in both
directions, and the refusals that name ROADMAP A10.

Sizes are small (n 6, T 80, rank 4, channels (8, 8)); f32 on both sides,
JAX at "highest" matmul precision (``tests/conftest.py``). Tolerances are
relative to the largest magnitude compared (per leaf for the nets): TOL
for one forward or one backward, TOL_FIT for what EPOCHS Adam epochs leave
of F, X, the TCN, the losses and the predictions, TOL_LOCAL for the local
net. The local net's head starts at zero, so its TCN's first gradient is
exactly zero and the next ones are of the order of the head's first step;
Adam divides each by its running root mean square, which amplifies the
f32 rounding the two packages differ in (readings here: forward and
gradients <= 1e-6; F, X, TCN, losses, predictions <= 2.4e-5; the local net
6.7e-6 after 1 epoch, 2.0e-5 after 4, 5.3e-4 after 8). Each fit is held
against a control, the port's fit with one more epoch, that must miss
its limits (the local net's by 1.0e-2 at least)."""

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.zouwu.model import tcmf as jt
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.models.common.initializers import TRUNC_STD
from analytics_zoo_tpu_torch.zouwu.model import tcmf as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Every test here runs torch on one intra-op thread, the old count
    restored after the module. Beside other busy processes (the suite's
    other workers) torch's default of one OpenMP thread a core
    oversubscribes the cores: beside six busy loops the hybrid fit's
    fixture took 68.8 s on the default threads and 7.6 s on one."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


TOL = 1e-5
TOL_FIT = 1e-4
TOL_LOCAL = 2e-3
EPOCHS = 8
N, T, T_NEW, HORIZON = 6, 80, 10, 8
KW = dict(rank=4, tcn_channels=(8, 8), kernel_size=3, window=8,
          local_window=6, local_channels=(8, 8), seasonal_period=12,
          rollout_steps=4, lr=1e-2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tree_rel(port_tree, jax_tree):
    a = interop._flatten(port_tree)
    b = interop._flatten(jax.device_get(jax_tree))
    assert sorted(a) == sorted(b)
    return max(_rel(a[k], b[k]) for k in a)


def _flax(module):
    return interop.state_dict_to_flax(module.state_dict())


def _panel(n=N, length=T + T_NEW, seed=0):
    """Low-rank seasonal structure plus noise; a fit takes the first T
    columns, ``fit_incremental`` the next T_NEW."""
    rng = np.random.RandomState(seed)
    t = np.arange(length)
    basis = np.stack([np.sin(2 * np.pi * t / 12), np.cos(2 * np.pi * t / 7),
                      t / length])
    return (rng.randn(n, 3) @ basis
            + 0.3 * rng.randn(n, length)).astype(np.float32)


Y_ALL = _panel()
Y, Y_NEW = Y_ALL[:, :T], Y_ALL[:, T:]


def _jax_init(jm, n, length):
    """The JAX fit's initial draws (``tcmf.py:204-210`` and ``:294-296``)."""
    kF, kX, kN = jax.random.split(jax.random.PRNGKey(jm.seed), 3)
    F = np.asarray(jax.random.normal(kF, (n, jm.rank)) * 0.1)
    X = np.asarray(jax.random.normal(kX, (jm.rank, length)) * 0.1)
    net = jax.device_get(jm.net.init(
        {"params": kN}, jnp.zeros((1, jm.window, jm.rank)))["params"])
    n_ch = 4 if jm.seasonal_period else 2
    local = (jax.device_get(jm.ynet.init(
        {"params": jax.random.PRNGKey(jm.seed + 7)},
        jnp.zeros((1, jm.local_window, n_ch)))["params"])
        if jm.ynet is not None else None)
    return F, X, net, local


def _carry(tm, init):
    """Start the port's fit from the JAX fit's initial draws."""
    F, X, net, local = init
    tm._init_global = lambda n, length: (
        torch.from_numpy(F.copy()), torch.from_numpy(X.copy()),
        interop.load_flax_params(
            tt._XSeqModel(tm.rank, tm.tcn_channels, tm.kernel_size), net))
    tm._init_local = lambda n_ch: interop.load_flax_params(
        tt._LocalYModel(n_ch, tm.local_channels, tm.local_kernel_size),
        local)
    return tm


def _fit_both(local_model):
    """Both packages' fits from the same initial weights, and the port's
    control fit with one more epoch."""
    jm = jt.TCMF(local_model=local_model, **KW)
    jout = jm.fit(Y, epochs=EPOCHS)
    init = _jax_init(jm, N, T)
    tm = _carry(tt.TCMF(local_model=local_model, device="cpu", **KW), init)
    tout = tm.fit(Y, epochs=EPOCHS)
    ctl = _carry(tt.TCMF(local_model=local_model, device="cpu", **KW), init)
    ctl.fit(Y, epochs=EPOCHS + 1)
    return jm, jout, tm, tout, ctl


@pytest.fixture(scope="module")
def hybrid():
    """The local hybrid (seasonal channels on), fitted by both packages."""
    return _fit_both(True)


def _global_readings(jm, tm):
    return {"F": _rel(tm.F, jm.F), "X": _rel(tm.X, jm.X),
            "net": _tree_rel(_flax(tm.net), jm.net_params)}


# --- the nets ---------------------------------------------------------------

def _net_pair(kind):
    """A flax net with random parameters (the local head made non-zero),
    the port's net over the same parameters, and an input (B, W, C)."""
    rng = np.random.RandomState(3)
    if kind == "tcn":      # widths 4 -> 8 -> 6: both layers have res_i
        jnet, tnet = jt._TemporalConvNet((8, 6), 3), None
        x = rng.randn(5, 10, 4).astype(np.float32)
    elif kind == "xseq":
        jnet = jt._XSeqModel(rank=4, channels=(8, 8), kernel_size=3)
        x = rng.randn(5, 8, 4).astype(np.float32)
    else:
        jnet = jt._LocalYModel(channels=(8, 8), kernel_size=3)
        x = rng.randn(5, 6, 4).astype(np.float32)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(1),
                                      jnp.asarray(x))["params"])
    if kind == "tcn":
        tnet = tt._TemporalConvNet(4, (8, 6), 3)
    elif kind == "xseq":
        tnet = tt._XSeqModel(4, (8, 8), 3)
    else:
        params["head"]["kernel"] = rng.randn(8, 1).astype(np.float32)
        params["head"]["bias"] = rng.randn(1).astype(np.float32)
        tnet = tt._LocalYModel(4, (8, 8), 3)
    return jnet, params, interop.load_flax_params(tnet, params), x


@pytest.mark.parametrize("kind", ["tcn", "xseq", "local"])
def test_net_matches_flax(kind):
    """Forward and parameter gradients of each net against flax's on the
    same parameters, the port in NCW, flax in NWC."""
    jnet, params, tnet, x = _net_pair(kind)
    jout = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))
    cot = np.random.RandomState(4).randn(*jout.shape).astype(np.float32)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(
        jnet.apply({"params": p}, jnp.asarray(x)) * cot)))(params)
    tout = tnet(torch.from_numpy(x).transpose(1, 2))
    if kind == "tcn":
        tout = tout.transpose(1, 2)
    assert _rel(tout.detach(), jout) <= TOL
    (tout * torch.from_numpy(cot)).sum().backward()
    grads = interop.state_dict_to_flax(
        {name: p.grad for name, p in tnet.named_parameters()})
    assert _tree_rel(grads, jgrad) <= TOL


def test_init_statistics_match_flax():
    """The port's draws have flax's statistics: conv and Dense kernels
    lecun_normal (std 1/sqrt(fan_in), truncated at two of its standard
    deviations), zero biases, the local head all zero; F and X N(0,
    0.1^2). torch's default init, the control, misses the std by ~42 %
    and has non-zero biases."""
    rank, ch, k = 64, (64, 64), 5
    tm = tt.TCMF(rank=rank, tcn_channels=ch, kernel_size=k, device="cpu")
    F, X, tnet = tm._init_global(512, 256)
    jnet = jt._XSeqModel(rank=rank, channels=ch, kernel_size=k)
    jparams = interop._flatten(jax.device_get(jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, rank)))["params"]))
    tparams = interop._flatten(_flax(tnet))
    assert sorted(tparams) == sorted(jparams)
    for name, arr in tparams.items():
        if name.endswith("bias"):
            assert not arr.any() and not jparams[name].any(), name
            continue
        fan_in = int(np.prod(arr.shape[:-1]))
        assert abs(arr.std() / jparams[name].std() - 1) < 0.05, name
        assert abs(arr.std() * np.sqrt(fan_in) - 1) < 0.05, name
        assert np.abs(arr).max() <= 2 / (TRUNC_STD * np.sqrt(fan_in)) + 1e-6
    torch.manual_seed(0)
    default = torch.nn.Conv1d(rank, ch[0], k)
    w = default.weight.detach().numpy()
    assert abs(w.std() / jparams["_TemporalConvNet_0.conv_0.kernel"].std()
               - 1) > 0.3
    assert default.bias.detach().abs().max() > 0
    for draw in (F, X):
        assert abs(float(draw.std()) / 0.1 - 1) < 0.02
        assert abs(float(draw.mean())) < 0.005
    local = _flax(tm._init_local(4))
    assert not local["head"]["kernel"].any()
    assert not local["head"]["bias"].any()


# --- the loss ----------------------------------------------------------------

@pytest.mark.parametrize("rollout_steps", [4, T - 8])
def test_loss_and_gradients_match_jax(rollout_steps):
    """``_loss`` and its gradients with respect to F, X and the TCN's
    parameters against ``jax.value_and_grad``: with the closed-loop term
    (h = 4) and without it (T - w - h = 0, the term 0.0)."""
    kw = dict(KW, rollout_steps=rollout_steps, local_model=False)
    jm = jt.TCMF(**kw)
    F, X, net, _ = _jax_init(jm, N, T)
    yn = (Y - Y.mean(1, keepdims=True)) / (Y.std(1, keepdims=True) + 1e-6)
    jloss, (gF, gX, gnet) = jax.jit(jax.value_and_grad(
        lambda f, x, p: jm._loss(f, x, p, jnp.asarray(yn)),
        argnums=(0, 1, 2)))(jnp.asarray(F), jnp.asarray(X), net)
    tm = tt.TCMF(device="cpu", **kw)
    tm.net = interop.load_flax_params(tt._XSeqModel(4, (8, 8), 3), net)
    tF = torch.from_numpy(F.copy()).requires_grad_(True)
    tX = torch.from_numpy(X.copy()).requires_grad_(True)
    loss = tm._loss(tF, tX, torch.from_numpy(yn))
    loss.backward()
    assert _rel(loss.detach(), jloss) <= TOL
    assert _rel(tF.grad, gF) <= TOL
    assert _rel(tX.grad, gX) <= TOL
    grads = interop.state_dict_to_flax(
        {name: p.grad for name, p in tm.net.named_parameters()})
    assert _tree_rel(grads, gnet) <= TOL


# --- fit, predict, evaluate, fit_incremental ----------------------------------

def test_global_fit_matches_jax():
    """``local_model="auto"`` on this small panel (6 x (80 - 6) windows <
    20,000) keeps the hybrid off in both packages: F, X, the TCN, the loss
    and ``predict`` after EPOCHS epochs, with the one-more-epoch control."""
    jm, jout, tm, tout, ctl = _fit_both("auto")
    assert jm.ynet_params is None and tm.ynet is None
    assert set(tout) == set(jout) == {"train_loss"}
    assert _rel(tout["train_loss"], jout["train_loss"]) <= TOL_FIT
    got = _global_readings(jm, tm)
    assert max(got.values()) <= TOL_FIT, got
    assert max(_global_readings(jm, ctl).values()) > TOL_FIT
    assert _rel(tm.predict(HORIZON), jm.predict(HORIZON)) <= TOL_FIT


def test_hybrid_fit_matches_jax(hybrid):
    """The hybrid with the seasonal channels: the global phase, the local
    net, both losses and the tails ``predict`` starts from."""
    jm, jout, tm, tout, ctl = hybrid
    assert set(tout) == set(jout) == {"train_loss", "local_loss"}
    for key in jout:
        assert _rel(tout[key], jout[key]) <= TOL_FIT, key
    limits = {"F": TOL_FIT, "X": TOL_FIT, "net": TOL_FIT,
              "ynet": TOL_LOCAL}
    for name, model in (("got", tm), ("control", ctl)):
        readings = _global_readings(jm, model)
        readings["ynet"] = _tree_rel(_flax(model.ynet), jm.ynet_params)
        if name == "got":
            assert all(readings[k] <= limits[k] for k in limits), readings
        else:
            assert all(readings[k] > limits[k] for k in limits), readings
    assert tm._T_fit == jm._T_fit == T
    assert _rel(tm._yn_tail, jm._yn_tail) <= TOL_FIT
    assert _rel(tm._recon_tail, jm._recon_tail) <= TOL_FIT


def test_predict_and_evaluate_match_jax(hybrid):
    """``predict`` (global rollout plus the hybrid's), ``_predict_hybrid``
    on the same global forecast, and ``evaluate``'s three metrics; an
    unknown metric raises in both."""
    jm, _, tm, _, _ = hybrid
    assert _rel(tm.predict(HORIZON), jm.predict(HORIZON)) <= TOL_FIT
    recon = np.asarray(jm.F @ jm._roll(HORIZON))
    assert _rel(tm._predict_hybrid(torch.from_numpy(recon), HORIZON),
                jm._predict_hybrid(jnp.asarray(recon), HORIZON)) <= TOL_FIT
    metrics = ("mae", "mse", "smape")
    got = tm.evaluate(Y_NEW[:, :HORIZON], metrics)
    want = jm.evaluate(Y_NEW[:, :HORIZON], metrics)
    assert len(got) == 3 and _rel(got, want) <= TOL_FIT
    for m in (tm, jm):
        with pytest.raises(ValueError, match="unknown metric rmse"):
            m.evaluate(Y_NEW[:, :HORIZON], ("rmse",))


def test_fit_incremental_matches_jax(hybrid):
    """``fit_incremental`` on the next T_NEW columns: X extended by the
    TCN's rollout and fitted with F and the TCN frozen, the tails and the
    seasonal clock moved on, and ``predict`` after it."""
    jm, _, tm, _, _ = (copy.copy(m) for m in hybrid)
    jout = jm.fit_incremental(Y_NEW, epochs=5)
    tout = tm.fit_incremental(Y_NEW, epochs=5)
    assert _rel(tout["train_loss"], jout["train_loss"]) <= TOL_FIT
    assert tm.X.shape == jm.X.shape == (KW["rank"], T + T_NEW)
    assert _rel(tm.X, jm.X) <= TOL_FIT
    assert tm._T_fit == jm._T_fit == T + T_NEW
    assert _rel(tm._yn_tail, jm._yn_tail) <= TOL_FIT
    assert _rel(tm._recon_tail, jm._recon_tail) <= TOL_FIT
    assert _rel(tm.predict(4), jm.predict(4)) <= TOL_FIT
    assert hybrid[2].X.shape[1] == T        # the fixture's model is intact


@pytest.mark.parametrize("local_model", ["auto", True, False, None])
def test_auto_gate_matches_jax(local_model):
    """The hybrid's gate, ``n * (T - local_window) >= local_min_windows``
    under ``"auto"``, decides as the JAX package's on either side of the
    threshold."""
    jm = jt.TCMF(local_model=local_model)
    tm = tt.TCMF(local_model=local_model, device="cpu")
    for n, length in ((6, 80), (100, 214), (100, 213), (1, 14), (370, 25968)):
        assert tm._local_enabled(n, length) == jm._local_enabled(n, length)
    if local_model == "auto":
        assert tm._local_enabled(100, 214) and not tm._local_enabled(100, 213)


# --- the save blob -------------------------------------------------------------

def _load_naming(path):
    """Unpickle ``path`` and return it with the modules of the classes it
    names."""
    modules = set()

    class Recording(pickle.Unpickler):
        def find_class(self, module, name):
            modules.add(module)
            return super().find_class(module, name)

    with open(path, "rb") as f:
        return Recording(f).load(), modules


def _wrap(cls, model):
    fc = cls.__new__(cls)
    fc.model = model
    return fc


def test_save_blob_crosses_packages(hybrid, tmp_path):
    """A blob either package writes names only numpy's and the builtins'
    classes, holds the same keys, shapes and dtypes, and loads in the other
    package, whose ``predict`` equals the writer's (the same weights: one
    forward's TOL). The port's own round trip predicts bit for bit."""
    jm, _, tm, _, _ = hybrid
    jpath, tpath = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    _wrap(jt.TCMFForecaster, jm).save(jpath)
    _wrap(tt.TCMFForecaster, tm).save(tpath)
    (jblob, jmods), (tblob, tmods) = map(_load_naming, (jpath, tpath))
    for modules in (jmods, tmods):
        assert {m.split(".")[0] for m in modules} <= {"numpy", "builtins"}
    flat_j, flat_t = interop._flatten(jblob), interop._flatten(tblob)
    assert sorted(flat_j) == sorted(flat_t)
    for key, val in flat_j.items():
        assert type(flat_t[key]) is type(val), key
        if isinstance(val, np.ndarray):
            assert (flat_t[key].shape, flat_t[key].dtype) == (val.shape,
                                                              val.dtype)
        elif not isinstance(val, float):
            assert flat_t[key] == val, key
    port_of_jax = tt.TCMFForecaster.load(jpath, device="cpu")
    assert _rel(port_of_jax.predict(HORIZON), jm.predict(HORIZON)) <= TOL
    jax_of_port = jt.TCMFForecaster.load(tpath)
    assert _rel(jax_of_port.predict(HORIZON), tm.predict(HORIZON)) <= TOL
    again = tt.TCMFForecaster.load(tpath, device="cpu")
    assert np.array_equal(again.predict(HORIZON), tm.predict(HORIZON))


def test_load_reads_local_kernel_size(tmp_path):
    """The blob does not name the local net's kernel size; the port reads
    it off the parameters, so a hybrid with local kernel 5 (the
    forecaster's default kernel_size_Y 7, clamped) round-trips bit for
    bit. The JAX package's load builds the local net with kernel 3 and
    fails on the same blob at ``predict`` (ROADMAP queue C)."""
    tm = tt.TCMF(local_model=True, device="cpu",
                 **dict(KW, local_kernel_size=5))
    tm.fit(Y, epochs=2)
    path = str(tmp_path / "k5.pkl")
    _wrap(tt.TCMFForecaster, tm).save(path)
    back = tt.TCMFForecaster.load(path, device="cpu")
    assert back.model.ynet.kernel_size == 5
    assert np.array_equal(back.predict(HORIZON), tm.predict(HORIZON))
    with pytest.raises(Exception, match="expected to generate shape"):
        jt.TCMFForecaster.load(path).predict(HORIZON)


# --- the forecaster's surface ---------------------------------------------------

def test_forecaster_clamps_match_jax():
    """The constructor's clamps (rank <= 64, kernel sizes <= 5, lr >=
    1e-3, seasonal_period only under use_time) and the ignored knobs."""
    for kw in (dict(rank=100, kernel_size=9, kernel_size_Y=9,
                    learning_rate=1e-4, seasonal_period=24, use_time=False,
                    vbsize=7, dropout=0.3),
               dict(seasonal_period=24), dict()):
        jm = jt.TCMFForecaster(**kw).model
        tm = tt.TCMFForecaster(device="cpu", **kw).model
        assert (tm.rank, tm.kernel_size, tm.local_kernel_size, tm.lr,
                tm.seasonal_period, tm.tcn_channels, tm.local_channels,
                tm.local_model) == (
            jm.rank, jm.net.kernel_size, jm.ynet.kernel_size, jm.lr,
            jm.seasonal_period, tuple(jm.net.channels),
            tuple(jm.ynet.channels), jm.local_model)


def test_sharded_fit_raises_naming_a10():
    """``mesh`` or ``num_workers > 1`` needs the port's process groups."""
    with pytest.raises(NotImplementedError, match="A10"):
        tt.TCMF(device="cpu").fit(Y, mesh=object())
    for kw in (dict(mesh=object()), dict(num_workers=2)):
        with pytest.raises(NotImplementedError, match="A10"):
            tt.TCMFForecaster(device="cpu").fit({"y": Y}, **kw)


def test_no_gpu_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tt.TCMF, tt.TCMFForecaster):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_cpu_epochs_run_eagerly():
    """On the CPU ``_train_epochs`` calls the step once an epoch and
    returns the last loss; fewer than one epoch raises."""
    calls = []

    def step():
        calls.append(len(calls))
        return torch.tensor(float(len(calls)))
    assert float(tt._train_epochs(step, 5, torch.device("cpu"))) == 5.0
    assert len(calls) == 5
    with pytest.raises(ValueError):
        tt._train_epochs(step, 0, torch.device("cpu"))
