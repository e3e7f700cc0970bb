"""The NYC-taxi MTNetLite gate of ``tests/test_zouwu_real_data.py`` on the
CPU, over initial draws, from the JAX package and from the PyTorch port.

The gate: the bundled NAB NYC-taxi subset (``tests/resources/
nyc_taxi_subset.csv``), standardised; windows of 48 half-hours -> the
next; the first 3,000 windows train, the rest are held out.
``MTNetForecaster(target_dim=1, feature_dim=1, ar_window_size=8,
cnn_height=6, lr=5e-3)`` trains 60 epochs at batch 256 and must beat
persistence and the day-seasonal naive forecast;
``LSTMForecaster(target_dim=1, feature_dim=1, lr=5e-3)`` trains 30 epochs,
and MTNetLite's MSE must stay under 1.3 x the LSTM's + 1e-3.

    JAX_PLATFORMS=cpu python scripts/nyc_taxi_gate_reference.py \\
        [--jax-seeds 0,1] [--port-seeds 0,1]

A JAX run with seed s is the forecasters' run with their estimators built
with ``seed=s`` (``PRNGKey(s)`` draws the weights and the dropout masks).
A port run with seed s draws the nets' initial weights from seed s
(``forecast.build_net(spec, s)``), as ``chip_smoke.py``'s
``zouwu_real_data`` phase does on the card. Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import pandas as pd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PAST, N_TRAIN = 48, 3000


def windows():
    v = pd.read_csv(os.path.join(ROOT, "tests", "resources",
                                 "nyc_taxi_subset.csv"))["value"].to_numpy(
        np.float32)
    series = (v - v.mean()) / v.std()
    n = len(series) - PAST - 1
    x = np.stack([series[i:i + PAST] for i in range(n)])[..., None]
    y = np.stack([series[i + PAST:i + PAST + 1] for i in range(n)])
    return x, y


def jax_run(seed, x, y):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from analytics_zoo_tpu import init_orca_context
    from analytics_zoo_tpu.orca.learn.estimator import TPUEstimator
    from analytics_zoo_tpu.zouwu.model.forecast import (
        LSTMForecaster, MTNetForecaster, _make_optimizer)
    init_orca_context("cpu-sim", mesh_axes={"dp": -1})
    mt = MTNetForecaster(target_dim=1, feature_dim=1, ar_window_size=8,
                         cnn_height=6, lr=5e-3)
    mt.estimator = TPUEstimator(mt.module, loss="mae", seed=seed,
                                optimizer=_make_optimizer("Adam", 5e-3))
    lstm = LSTMForecaster(target_dim=1, feature_dim=1, lr=5e-3)
    lstm.estimator = TPUEstimator(lstm.module, loss="mse", seed=seed,
                                  optimizer=_make_optimizer("Adam", 5e-3))
    return mt, lstm


def port_run(seed, x, y):
    from analytics_zoo_tpu_torch.zouwu.model import forecast as F
    mt = F.Forecaster(F.build_net(("MTNetLite", dict(
        input_dim=1, ar_window=8, cnn_kernel=6, cnn_channels=32)), seed),
        loss="mae", lr=5e-3, device="cpu")
    lstm = F.Forecaster(F.build_net(("LSTMNet", dict(
        input_dim=1, lstm_units=(16, 8), dropouts=(0.2, 0.2))), seed),
        loss="mse", lr=5e-3, device="cpu")
    return mt, lstm


def gate(make, seed, x, y):
    t0 = time.perf_counter()
    mt, lstm = make(seed, x, y)
    truth = y[N_TRAIN:].reshape(-1)
    mt.fit(x[:N_TRAIN], y[:N_TRAIN], epochs=60, batch_size=256)
    lstm.fit(x[:N_TRAIN], y[:N_TRAIN], epochs=30, batch_size=256)
    m = float(np.mean((np.asarray(mt.predict(x[N_TRAIN:])).reshape(-1)
                       - truth) ** 2))
    lm = float(np.mean((np.asarray(lstm.predict(x[N_TRAIN:])).reshape(-1)
                        - truth) ** 2))
    return {"seed": seed, "mtnet_mse": m, "lstm_mse": lm,
            "within_band": m < 1.3 * lm + 1e-3,
            "seconds": time.perf_counter() - t0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax-seeds", default="0")
    ap.add_argument("--port-seeds", default="")
    args = ap.parse_args()
    x, y = windows()
    truth = y[N_TRAIN:].reshape(-1)
    out = {"persistence_mse": float(np.mean((x[N_TRAIN:, -1, 0] - truth)
                                            ** 2)),
           "seasonal_mse": float(np.mean((x[N_TRAIN:, -PAST, 0] - truth)
                                         ** 2)),
           "jax": [], "port": []}
    for key, make, seeds in (("jax", jax_run, args.jax_seeds),
                             ("port", port_run, args.port_seeds)):
        for s in filter(None, seeds.split(",")):
            out[key].append(gate(make, int(s), x, y))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
