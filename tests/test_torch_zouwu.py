"""The port's Zouwu (``analytics_zoo_tpu_torch/zouwu``) on the CPU against
the JAX package's: recipes, the feature transformer and imputers (equal
values, arrays bit for bit), the four nets against flax with bridged
weights (forward and gradients, 1e-5 of the largest value), the LSTM's
one-bias-per-gate step and flax's init statistics (each with a control
that misses), the forecasters' fits (losses, predictions and all eight
metrics at 1e-5 relative, Adam moments through interop), the detectors,
and AutoTS as a whole, with the device rule.

f32 on both sides, TF32 off (the port's ``__init__``), JAX at "highest"
matmul precision (``tests/conftest.py``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu.zouwu.autots import forecast as jautots
from analytics_zoo_tpu.zouwu.config import recipe as jrecipe
from analytics_zoo_tpu.zouwu.feature import time_sequence as jts
from analytics_zoo_tpu.zouwu.model import anomaly as janomaly
from analytics_zoo_tpu.zouwu.model import forecast as jforecast
from analytics_zoo_tpu.zouwu.model import nets as jnets
from analytics_zoo_tpu.zouwu.preprocessing import impute as jimpute
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.zouwu.autots import forecast as tautots
from analytics_zoo_tpu_torch.zouwu.config import recipe as trecipe
from analytics_zoo_tpu_torch.zouwu.feature import time_sequence as tts
from analytics_zoo_tpu_torch.zouwu.model import anomaly as tanomaly
from analytics_zoo_tpu_torch.zouwu.model import forecast as tforecast
from analytics_zoo_tpu_torch.zouwu.model import nets as tnets
from analytics_zoo_tpu_torch.zouwu.preprocessing import impute as timpute

TOL = 1e-5          # relative to the largest magnitude compared
METRICS = ("mse", "mean_squared_error", "rmse", "mae", "mean_absolute_error",
           "mape", "smape", "r2")


def make_series(n=400, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    value = np.sin(t / 10.0) + 0.05 * rng.randn(n)
    return pd.DataFrame({
        "datetime": pd.date_range("2020-01-01", periods=n, freq="h"),
        "value": value.astype(np.float32)})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --- recipes, feature transformer, imputers ---------------------------------

RECIPES = [("SmokeRecipe", {}), ("TCNSmokeRecipe", {}),
           ("MTNetSmokeRecipe", {}),
           ("LSTMGridRandomRecipe", dict(num_rand_samples=3)),
           ("TCNGridRandomRecipe", dict(num_rand_samples=2)),
           ("MTNetGridRandomRecipe", dict(num_rand_samples=2)),
           ("Seq2SeqRandomRecipe", dict(num_rand_samples=2)),
           ("RandomRecipe", dict(num_rand_samples=3)),
           ("BayesRecipe", dict(num_samples=2, look_back=(4, 12))),
           ("XgbRegressorGridRandomRecipe", dict(num_rand_samples=2))]


@pytest.mark.parametrize("name,kwargs", RECIPES, ids=[r[0] for r in RECIPES])
def test_recipe_configs_equal_jax(name, kwargs):
    """Each recipe's grid expansion and sampled configs, for three seeds,
    equal the JAX package's value for value."""
    from analytics_zoo_tpu.automl import hp as jhp
    from analytics_zoo_tpu_torch.automl import hp as thp
    jr, tr = getattr(jrecipe, name)(**kwargs), getattr(trecipe, name)(**kwargs)
    assert tr.model_type() == jr.model_type()
    assert tr.num_samples == jr.num_samples
    js, ts = jr.search_space([]), tr.search_space([])
    for seed in (0, 1, 42):
        jrng, trng = np.random.RandomState(seed), np.random.RandomState(seed)
        want = [jhp.sample_config(g, jrng) for g in jhp.grid_configs(js)
                for _ in range(jr.num_samples)]
        got = [thp.sample_config(g, trng) for g in thp.grid_configs(ts)
               for _ in range(tr.num_samples)]
        assert got == want
        assert [trecipe.convert_bayes_config(c) for c in got] == \
            [jrecipe.convert_bayes_config(c) for c in want]


@pytest.mark.parametrize("horizon,past,extra", [(1, 12, False), (3, 20, True)])
def test_feature_transformer_bit_equal_jax(horizon, past, extra):
    df = make_series(150)
    df["extra"] = np.cos(np.arange(150) / 7.0).astype(np.float32)
    df = df.sample(frac=1.0, random_state=0)         # unsorted rows
    kw = dict(horizon=horizon, dt_col="datetime", target_col="value",
              extra_features_col=["extra"] if extra else None)
    jt, tt = jts.TimeSequenceFeatureTransformer(**kw), \
        tts.TimeSequenceFeatureTransformer(**kw)
    for a, b in zip(jt.fit_transform(df, past_seq_len=past),
                    tt.fit_transform(df, past_seq_len=past)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tt.feature_num == jt.feature_num
    other = make_series(90, seed=4)
    other["extra"] = np.float32(0.5)
    for is_train in (True, False):
        for a, b in zip(jt.transform(other, is_train=is_train),
                        tt.transform(other, is_train=is_train)):
            assert a.tobytes() == b.tobytes()
    tail = other.tail(past)                  # the single inference window
    (xa, ya), (xb, yb) = (jt.transform(tail), tt.transform(tail))
    assert ya is None and yb is None and xa.tobytes() == xb.tobytes()
    y = np.linspace(-2, 2, 7).astype(np.float32)
    assert tt.inverse_transform_y(y).tobytes() == \
        jt.inverse_transform_y(y).tobytes()
    assert tt.scale_y(y).tobytes() == jt.scale_y(y).tobytes()
    back = tts.TimeSequenceFeatureTransformer.from_state(tt.get_state())
    assert back.transform(other)[0].tobytes() == \
        tt.transform(other)[0].tobytes()
    arr = np.arange(30, dtype=np.float32).reshape(15, 2)
    for a, b in zip(jts.roll_windows(arr, 4, 2), tts.roll_windows(arr, 4, 2)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["LastFillImpute", "FillZeroImpute",
                                  "MeanImpute", "LinearImpute",
                                  "TimeMergeImputor"])
def test_imputers_equal_jax(name):
    df = make_series(60)
    rng = np.random.RandomState(3)
    df.loc[rng.rand(60) < 0.2, "value"] = np.nan
    df = pd.concat([df, df.iloc[[5, 9]]]).sort_values("datetime")
    args = (("1h", "datetime", "max") if name == "TimeMergeImputor" else ())
    ji, ti = getattr(jimpute, name)(*args), getattr(timpute, name)(*args)
    pd.testing.assert_frame_equal(ti.impute(df), ji.impute(df))
    if name != "TimeMergeImputor":
        clean = make_series(60)[["value"]]
        assert ti.evaluate(clean, seed=1) == ji.evaluate(clean, seed=1)


# --- nets against flax --------------------------------------------------------

F_IN = 6


def _net_pair(kind):
    """The flax net and the port's at narrow widths, dropout off."""
    if kind == "lstm":
        return (jnets.LSTMNet(lstm_units=(8, 4), dropouts=(0.0, 0.0)),
                tnets.LSTMNet(F_IN, lstm_units=(8, 4), dropouts=(0.0, 0.0)))
    if kind == "tcn":       # 6 -> 8 in block 0: a downsample Dense
        kw = dict(past_seq_len=12, future_seq_len=2, num_channels=(8, 8, 8),
                  kernel_size=3, dropout=0.0)
        return jnets.TCNNet(**kw), tnets.TCNNet(input_dim=F_IN, **kw)
    if kind == "seq2seq":
        return (jnets.Seq2SeqNet(future_seq_len=3, latent_dim=8),
                tnets.Seq2SeqNet(F_IN, future_seq_len=3, latent_dim=8))
    kw = dict(ar_window=4, cnn_kernel=3, cnn_channels=8, dropout=0.0)
    return jnets.MTNetLite(**kw), tnets.MTNetLite(F_IN, **kw)


def _flax_params(jm, x, seed=0, jitter=0.1):
    """flax's init, jittered so that zero biases are not zero."""
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), x)["params"])
    rng = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, jitter, a.shape).astype(
            np.float32), params)


NETS = ["lstm", "tcn", "seq2seq", "mtnet"]


@pytest.mark.parametrize("kind", NETS)
def test_net_matches_flax(kind):
    """Eval-mode forward and the gradients of a squared loss, flax vs the
    port on the same weights, to 1e-5 of the largest value; the flax tree
    comes back from the port's state_dict byte for byte."""
    jm, tm = _net_pair(kind)
    x = np.random.RandomState(2).randn(5, 12, F_IN).astype(np.float32)
    params = _flax_params(jm, x)
    interop.load_flax_params(tm, params)
    back = interop.state_dict_to_flax(tm.state_dict())
    flat_w = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_b]
    assert all(a.tobytes() == b.tobytes()
               for (_, a), (_, b) in zip(flat_w, flat_b))
    want = np.asarray(jm.apply({"params": params}, x))
    tm.eval()
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL
    # training mode on both sides (Seq2SeqNet's dropout field is unused
    # in both; the other nets' rates are 0 here)
    grads = interop.flax_to_state_dict(jax.device_get(jax.grad(
        lambda p: jnp.sum(jm.apply({"params": p}, x, train=True) ** 2))(
        params)))
    tm.train()
    (tm(torch.from_numpy(x)) ** 2).sum().backward()
    # MTNetLite's attention bias has a zero gradient in exact arithmetic
    # (softmax over time does not see it): each gradient is held relative
    # to its own largest entry, floored at 1e-3 of the largest of all
    floor = 1e-3 * max(float(g.abs().max()) for g in grads.values())
    for name, p in tm.named_parameters():
        err = float((p.grad - grads[name]).abs().max())
        assert err <= TOL * max(float(grads[name].abs().max()), floor), name


def test_lstm_bias_one_sgd_step_matches_flax():
    """flax adds one bias per gate. One SGD step at lr 0.5 leaves the
    port's gate biases where optax's SGD leaves flax's (1e-5). The
    control, torch's ``nn.LSTM`` with both its biases trained (b_ih the
    bias, b_hh zero), moves the sum b_ih + b_hh twice as far and misses."""
    lr = 0.5
    jm = jnets.LSTMNet(lstm_units=(8,), dropouts=(0.0,))
    tm = tnets.LSTMNet(F_IN, lstm_units=(8,), dropouts=(0.0,))
    rng = np.random.RandomState(5)
    x = rng.randn(16, 10, F_IN).astype(np.float32)
    y = rng.randn(16, 1).astype(np.float32)
    params = _flax_params(jm, x)
    interop.load_flax_params(tm, params)

    def loss(p):
        return jnp.mean((jm.apply({"params": p}, x) - y) ** 2)
    g = jax.grad(loss)(params)
    cell = "OptimizedLSTMCell_0"
    want = np.concatenate([params[cell][f"h{k}"]["bias"]
                           - lr * np.asarray(g[cell][f"h{k}"]["bias"])
                           for k in "ifgo"])
    ty = torch.from_numpy(y)
    opt = torch.optim.SGD(tm.parameters(), lr=lr)
    ((tm(torch.from_numpy(x)) - ty) ** 2).mean().backward()
    opt.step()
    got = tm.OptimizedLSTMCell_0.fused_weights()[2].detach().numpy()
    assert _rel(got, want) <= TOL

    # control: nn.LSTM, both biases trained, from the same weights
    ref = tnets.LSTMNet(F_IN, lstm_units=(8,), dropouts=(0.0,))
    interop.load_flax_params(ref, params)
    w_ih, w_hh, b_ih, _ = (t.detach().clone() for t in
                           ref.OptimizedLSTMCell_0.fused_weights())
    lstm = torch.nn.LSTM(F_IN, 8, batch_first=True)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih)
        lstm.weight_hh_l0.copy_(w_hh)
        lstm.bias_ih_l0.copy_(b_ih)
        lstm.bias_hh_l0.zero_()
    head = ref.head
    opt = torch.optim.SGD(list(lstm.parameters()) + list(head.parameters()),
                          lr=lr)
    out, _ = lstm(torch.from_numpy(x))
    # before the step the two forwards agree: only the bias step differs
    assert _rel(head(out[:, -1]).detach().numpy(),
                ref(torch.from_numpy(x)).detach().numpy()) <= TOL
    ((head(out[:, -1]) - ty) ** 2).mean().backward()
    opt.step()
    control = (lstm.bias_ih_l0 + lstm.bias_hh_l0).detach().numpy()
    assert _rel(control, want) > 100 * TOL


def _std_ratio(w, fan_in):
    return float(np.asarray(w, np.float64).std() * math.sqrt(fan_in))


def test_init_statistics_match_flax():
    """Wide nets, the port's init against flax's: every input, Dense and
    Conv kernel has std 1/sqrt(fan_in) (flax's lecun_normal; a conv's
    fan_in is K * in) within 5 %, as flax's own draws have; every hidden
    gate kernel is orthogonal per gate (W W^T = I to 1e-5), biases are
    zero. Controls: torch's defaults (``nn.LSTM``'s U(+-1/sqrt(h)),
    ``Conv1d``'s kaiming-uniform) miss both."""
    torch.manual_seed(0)
    h, f_in, k, ch = 128, 64, 5, 96
    tl = tnets.LSTMNet(f_in, lstm_units=(h,), dropouts=(0.0,))
    tc = tnets.TCNNet(8, 1, f_in, num_channels=(ch,), kernel_size=k)
    x = np.zeros((1, 8, f_in), np.float32)
    jl = jax.device_get(jnets.LSTMNet(lstm_units=(h,), dropouts=(0.0,)).init(
        jax.random.PRNGKey(0), x)["params"])
    jc = jax.device_get(jnets.TCNNet(8, 1, num_channels=(ch,),
                                     kernel_size=k).init(
        jax.random.PRNGKey(0), x)["params"])
    cell = tl.OptimizedLSTMCell_0
    checks = []
    for g in "ifgo":
        checks.append((getattr(cell, f"i{g}").weight,
                       jl["OptimizedLSTMCell_0"][f"i{g}"]["kernel"], f_in))
        w = getattr(cell, f"h{g}").weight.detach().numpy()
        assert np.abs(w @ w.T - np.eye(h)).max() < 1e-5
        jw = jl["OptimizedLSTMCell_0"][f"h{g}"]["kernel"]
        assert np.abs(jw @ jw.T - np.eye(h)).max() < 1e-5
        assert not getattr(cell, f"h{g}").bias.detach().any()
    conv = tc.block_0.CausalConv1D_0.Conv_0
    checks.append((conv.weight,
                   jc["block_0"]["CausalConv1D_0"]["Conv_0"]["kernel"],
                   k * f_in))
    checks.append((tc.block_0.downsample.weight,
                   jc["block_0"]["downsample"]["kernel"], f_in))
    for w, jw, fan_in in checks:
        assert abs(_std_ratio(w.detach().numpy(), fan_in) - 1) < 0.05
        assert abs(_std_ratio(jw, fan_in) - 1) < 0.05
    assert not conv.bias.detach().any()
    # controls: torch's default inits
    lstm = torch.nn.LSTM(f_in, h)
    w_ih = lstm.weight_ih_l0.detach().numpy()[:h]
    assert abs(_std_ratio(w_ih, f_in) - 1) > 0.2
    w_hf = lstm.weight_hh_l0.detach().numpy()[h:2 * h]
    assert np.abs(w_hf @ w_hf.T - np.eye(h)).max() > 0.5
    default = torch.nn.Conv1d(f_in, ch, k)
    assert abs(_std_ratio(default.weight.detach().numpy(), k * f_in)
               - 1) > 0.2


def test_causal_conv_is_causal():
    """An input change at step t moves outputs at t and later only."""
    conv = tnets.CausalConv1D(3, 4, kernel_size=3, dilation=2)
    x = torch.randn(2, 16, 3)
    y = conv(x)
    x2 = x.clone()
    x2[:, 9] += 1.0
    d = (conv(x2) - y).abs().sum(dim=(0, 2))
    assert y.shape == (2, 16, 4)
    assert d[:9].max() == 0 and d[9] > 0


# --- forecasters against JAX's -----------------------------------------------

def _windows(past, horizon, n=200):
    tsft = jts.TimeSequenceFeatureTransformer(horizon=horizon)
    x, y = tsft.fit_transform(make_series(n), past_seq_len=past)
    return x, y


def _forecaster_pair(kind, feat, lr=1e-3):
    if kind == "lstm":
        kw = dict(target_dim=1, feature_dim=feat, lstm_units=(8, 4),
                  dropouts=0.0, lr=lr)
        return (jforecast.LSTMForecaster(**kw),
                tforecast.LSTMForecaster(device="cpu", **kw))
    if kind == "tcn":
        kw = dict(past_seq_len=12, future_seq_len=2, input_feature_num=feat,
                  output_feature_num=1, num_channels=(8, 8, 8),
                  kernel_size=3, dropout=0.0, lr=lr)
        return (jforecast.TCNForecaster(**kw),
                tforecast.TCNForecaster(device="cpu", **kw))
    if kind == "seq2seq":
        kw = dict(past_seq_len=12, future_seq_len=2, input_feature_num=feat,
                  output_feature_num=1, lstm_hidden_dim=8, lr=lr)
        return (jforecast.Seq2SeqForecaster(**kw),
                tforecast.Seq2SeqForecaster(device="cpu", **kw))
    # MTNetForecaster's net always has dropout 0.2: the same net at 0
    kw = dict(ar_window=4, cnn_kernel=3, cnn_channels=8, dropout=0.0)
    return (jforecast.Forecaster(jnets.MTNetLite(**kw), loss="mae", lr=lr),
            tforecast.Forecaster(tforecast.build_net(
                ("MTNetLite", dict(input_dim=feat, **kw))), loss="mae",
                lr=lr, device="cpu"))


@pytest.mark.parametrize("kind", NETS)
def test_forecaster_fit_matches_jax(orca_context, kind):
    """From bridged weights, 2 shuffled epochs of Adam at batch 32 and the
    forecasters' default lr 1e-3 (the batch streams are the same for the
    seed): per-epoch losses, ``predict`` and all eight metrics of
    ``evaluate`` at 1e-5 relative; Adam's moments after the fit agree with
    optax's through interop, and cross back byte for byte. (At lr 1e-2
    Adam's normalised steps carry the two sides' f32 rounding further: the
    predictions read 1.0e-5 apart after two epochs, 1.5e-6 at 1e-3.)"""
    horizon = 1 if kind in ("lstm", "mtnet") else 2
    x, y = _windows(12, horizon)
    target = y if kind in ("lstm", "mtnet") else y[..., None]
    jf, tf = _forecaster_pair(kind, x.shape[-1])
    jf.estimator.engine.build((x[:1],))
    interop.load_flax_params(tf.module,
                             jax.device_get(jf.estimator.engine.params))
    jstats = jf.fit(x, target, epochs=2, batch_size=32)
    tstats = tf.fit(x, target, epochs=2, batch_size=32)
    assert [s["epoch"] for s in tstats] == [1, 2]
    for a, b in zip(tstats, jstats):
        assert _rel(a["train_loss"], b["train_loss"]) <= TOL
    assert _rel(tf.predict(x[:40]), jf.predict(x[:40])) <= TOL
    jm, tm = (f.evaluate(x[:60], target[:60], metrics=METRICS)
              for f in (jf, tf))
    assert set(tm) == set(METRICS)
    for m in METRICS:
        # r2 = 1 - SSE/SST: held through SSE/SST, which it is computed from
        # (near r2 = 0 its own relative error is SSE's times (1 - r2)/r2)
        got, want = (1 - tm[m], 1 - jm[m]) if m == "r2" else (tm[m], jm[m])
        assert _rel(got, want) <= TOL, m
    raw_j = jf.evaluate(x[:60], target[:60], multioutput="raw_values")
    raw_t = tf.evaluate(x[:60], target[:60], multioutput="raw_values")
    assert _rel(raw_t["mse"], raw_j["mse"]) <= TOL
    # Adam's moments through interop
    template = jax.device_get(jf.estimator.engine.opt_state)
    state = tf.estimator.engine.get_state()
    as_jax = interop.state_to_jax(state, template)
    jadam = interop._find(template, ("ScaleByAdamState",))
    tadam = interop._find(as_jax["opt_state"], ("ScaleByAdamState",))
    assert int(tadam.count) == int(jadam.count) == tf.estimator.engine.step
    for field in ("mu", "nu"):
        want = interop.flax_to_state_dict(getattr(jadam, field))
        got = interop.flax_to_state_dict(getattr(tadam, field))
        # floored as in test_net_matches_flax (MTNetLite's attention bias
        # has a zero gradient in exact arithmetic)
        floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
        for name in want:
            err = float((got[name] - want[name]).abs().max())
            assert err <= 1e-4 * max(float(want[name].abs().max()),
                                     floor), (field, name)
    back = interop.state_from_jax(as_jax, tf.module, tf.estimator.engine.opt)
    for name, t in state["params"].items():
        assert back["params"][name].numpy().tobytes() == t.numpy().tobytes()
    for i, s in state["opt_state"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert back["opt_state"]["state"][i][key].numpy().tobytes() == \
                s[key].numpy().tobytes()


def test_sgd_ignores_lr_like_jax(orca_context):
    """A reference caveat kept by the port: ``optimizer="sgd"`` builds
    ``SGD(lr=lr)``, SGD takes ``learningrate``, so the step uses 1e-3
    whatever ``lr`` says. Both packages' first-epoch losses agree (1e-5),
    and differ from an SGD at the lr asked for (0.5)."""
    x, y = _windows(12, 1)
    kw = dict(target_dim=1, feature_dim=x.shape[-1], lstm_units=(8,),
              dropouts=0.0, lr=0.5, optimizer="sgd")
    jf, tf = jforecast.LSTMForecaster(**kw), \
        tforecast.LSTMForecaster(device="cpu", **kw)
    jf.estimator.engine.build((x[:1],))
    params = jax.device_get(jf.estimator.engine.params)
    interop.load_flax_params(tf.module, params)
    jl = jf.fit(x, y, epochs=2, batch_size=32)
    tl = tf.fit(x, y, epochs=2, batch_size=32)
    assert tf.estimator.engine.opt.param_groups[0]["lr"] == 1e-3
    for a, b in zip(tl, jl):
        assert _rel(a["train_loss"], b["train_loss"]) <= TOL
    asked = tforecast.Forecaster(
        tforecast.build_net(tf.net_spec), loss="mse", device="cpu",
        optimizer=lambda ps: torch.optim.SGD(ps, lr=0.5))
    interop.load_flax_params(asked.module, params)
    al = asked.fit(x, y, epochs=2, batch_size=32)
    assert _rel(al[1]["train_loss"], jl[1]["train_loss"]) > 1e-3


def test_tcn_check_data():
    x, y = _windows(12, 2)
    f = tforecast.TCNForecaster(12, 2, x.shape[-1], 1, num_channels=(4,),
                                kernel_size=3, device="cpu")
    with pytest.raises(AssertionError):
        f._check_data(x[:, :5], y[..., None])
    with pytest.raises(RuntimeError, match="fitted"):
        f.predict(x)


def test_forecaster_save_restore(tmp_path):
    x, y = _windows(12, 1, n=120)
    f = tforecast.LSTMForecaster(feature_dim=x.shape[-1], lstm_units=(4,),
                                 device="cpu")
    f.fit(x, y, epochs=1)
    path = str(tmp_path / "f.pt")
    f.save(path)
    g = tforecast.LSTMForecaster(feature_dim=x.shape[-1], lstm_units=(4,),
                                 device="cpu")
    g.restore(path)
    np.testing.assert_array_equal(g.predict(x), f.predict(x))
    # the net draws from seed 0, whatever torch's global RNG holds
    torch.manual_seed(123)
    h = tforecast.LSTMForecaster(feature_dim=x.shape[-1], lstm_units=(4,),
                                 device="cpu")
    torch.manual_seed(7)
    k = tforecast.LSTMForecaster(feature_dim=x.shape[-1], lstm_units=(4,),
                                 device="cpu")
    for a, b in zip(h.module.parameters(), k.module.parameters()):
        assert torch.equal(a, b)


# --- detectors ---------------------------------------------------------------

def test_threshold_detector_equals_jax():
    rng = np.random.RandomState(0)
    y = rng.randn(200).astype(np.float32) * 0.1
    y[50], y[120] = 5.0, -4.0
    pred = y + rng.randn(200).astype(np.float32) * 0.05
    found = [tanomaly.ThresholdDetector().set_params(ratio=0.02).detect(*a)
             for a in ((y,), (y, pred))]
    for args, got in zip(((y,), (y, pred)), found):
        want = janomaly.ThresholdDetector().set_params(ratio=0.02).detect(
            *args)
        np.testing.assert_array_equal(got, want)
    assert 50 in found[0] and 120 in found[0]
    bounded = tanomaly.ThresholdDetector().set_params(threshold=(-1.0, 1.0))
    np.testing.assert_array_equal(bounded.detect(y), [50, 120])


def test_ae_and_dbscan_detectors():
    """The autoencoder finds the injected anomaly, as the JAX package's
    test asks; DBSCAN's outliers equal the JAX package's."""
    t = np.arange(300)
    y = np.sin(t / 5.0).astype(np.float32)
    y[150:153] += 4.0
    idx = tanomaly.AEDetector(roll_len=10, ratio=0.05, epochs=10,
                              device="cpu").detect(y)
    assert any(145 <= i <= 160 for i in idx), idx
    pts = np.concatenate([np.random.RandomState(1).randn(60, 2) * 0.1,
                          [[3.0, 3.0], [-3.0, 2.0]]]).astype(np.float32)
    np.testing.assert_array_equal(
        tanomaly.DBScanDetector(eps=0.3).detect(pts),
        janomaly.DBScanDetector(eps=0.3).detect(pts))


# --- AutoTS as a whole --------------------------------------------------------

AUTOTS_RECIPES = [("SmokeRecipe", {}), ("TCNSmokeRecipe", {}),
                  ("MTNetSmokeRecipe", {}),
                  ("Seq2SeqRandomRecipe",
                   dict(num_rand_samples=1, past_seq_len=(12,),
                        latent_dim=(16,), batch_size=(32,)))]


@pytest.mark.parametrize("name,kwargs", AUTOTS_RECIPES,
                         ids=[r[0] for r in AUTOTS_RECIPES])
def test_autots_matches_jax(orca_context, tmp_path, name, kwargs):
    """``AutoTSTrainer(device="cpu").fit`` next to the JAX package's on the
    same frames: the same trials (configs and states), ``predict`` frames
    with the same columns and timestamps, and a saved pipeline that loads
    to the same evaluation. The two packages draw their initial weights
    differently, so the MSEs are held to a band: finite, and below the
    mean predictor's (the mean of y^2 in scaled units)."""
    df, val, ev = make_series(1000), make_series(120, 1), make_series(120, 2)
    trainers = (jautots.AutoTSTrainer(horizon=1),
                tautots.AutoTSTrainer(horizon=1, device="cpu"))
    mods = (jrecipe, trecipe)
    pipes = [tr.fit(df, validation_df=val,
                    recipe=getattr(m, name)(**kwargs))
             for tr, m in zip(trainers, mods)]
    jt, tt = (tr.engine._trials for tr in trainers)
    assert [t.config for t in tt] == [t.config for t in jt]
    assert [t.state for t in tt] == [t.state for t in jt] == \
        ["done"] * len(jt)
    assert all(t.device == "cpu" for t in tt)
    assert pipes[1].config == pipes[0].config
    _, y = pipes[1].tsft.transform(ev, is_train=True)
    mean_predictor = float(np.mean(y[:, :1] ** 2))
    mses = [p.evaluate(ev, metrics=["mse"])["mse"] for p in pipes]
    assert all(math.isfinite(m) and m < mean_predictor for m in mses), \
        (mses, mean_predictor)
    frames = [p.predict(make_series(60, seed=3)) for p in pipes]
    assert list(frames[1].columns) == list(frames[0].columns)
    assert frames[1].shape == frames[0].shape
    assert (frames[1]["datetime"] == frames[0]["datetime"]).all()
    assert np.isfinite(frames[1]["value"].to_numpy()).all()
    path = str(tmp_path / "ts.pipeline")
    pipes[1].save(path)
    loaded = tautots.TSPipeline.load(path, device="cpu")
    assert loaded.evaluate(ev, metrics=["mse"])["mse"] == mses[1]
    assert loaded.config == pipes[1].config
    # incremental fit keeps training the loaded forecaster
    loaded.fit(make_series(200, seed=5), epochs=1)
    assert loaded.forecaster.estimator.engine.step > \
        pipes[1].forecaster.estimator.engine.step


def test_autots_asha_not_ported():
    """``AutoTSTrainer(scheduler="asha")`` runs a smoke recipe's search
    through the rung scheduler and yields a pipeline. (The name is kept
    from when this test held the raise of the unported scheduler; the
    end-to-end test is in tests/test_torch_scheduler.py.)"""
    tr = tautots.AutoTSTrainer(horizon=1, device="cpu", scheduler="asha")
    pipe = tr.fit(make_series(100), recipe=trecipe.SmokeRecipe())
    summary = tr.engine.summary()
    assert summary["status"] == "completed"
    assert summary["trials"]["done"] == len(tr.engine._trials)
    assert np.isfinite(pipe.evaluate(make_series(100),
                                     metrics=["mse"])["mse"])


def test_device_rule(monkeypatch):
    """Without a card, the entry points raise unless given the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tctx, "_current", None)
    for make in (lambda: tforecast.LSTMForecaster(),
                 lambda: tforecast.TCNForecaster(12, 1, 1, 1),
                 lambda: tforecast.Seq2SeqForecaster(12, 1, 1, 1),
                 lambda: tforecast.MTNetForecaster(),
                 lambda: tanomaly.AEDetector(),
                 lambda: tautots.AutoTSTrainer(),
                 lambda: tautots.TSPipeline.load("unused")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert tforecast.LSTMForecaster(device="cpu").device.type == "cpu"
