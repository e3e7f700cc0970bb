"""Holdout AUC of the fraud-detection MLP (BASELINE #3) on the CPU, from
the JAX package and, optionally, from the PyTorch port.

The configuration of ``chip_smoke.py``'s ``fraud_nnframes_train`` phase:
``examples/nnframes/fraud_detection_mlp.py``'s ``synthetic_fraud`` (100,000
rows from seed 0, 2 % fraud, +1.5 on five features), a 10 % holdout drawn
as the example draws it, the Keras MLP 256 -> 128 -> 64 -> 1 (ReLU,
sigmoid) through ``NNEstimator(..., "binary_crossentropy")`` with its
default Adam, batch 16,384, 3 epochs, and the example's rank AUC.

    JAX_PLATFORMS=cpu python scripts/fraud_auc_reference.py \
        [--jax-seeds 0,1] [--port-seeds 0,1]

A JAX run with seed s is ``NNEstimator.fit``'s run with its estimator's
seed set to s (``NNEstimator`` itself builds it with seed 0): its
``TPUEstimator(seed=s)`` fits the same arrays. A port run with seed s
draws its initial weights from ``torch.manual_seed(s)`` on the CPU, as
``chip_smoke.py`` draws them before the module goes to the card. Prints
one JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ROWS, BATCH, EPOCHS, WIDTHS = 100_000, 16384, 3, (256, 128, 64)


def synthetic_fraud(n=ROWS, n_features=29, fraud_rate=0.02, seed=0):
    """examples/nnframes/fraud_detection_mlp.py's synthetic_fraud."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) < fraud_rate).astype(np.float32)
    x = rng.randn(n, n_features).astype(np.float32)
    x[y == 1, :5] += 1.5
    return x, y


def frames():
    x, y = synthetic_fraud()
    df = pd.DataFrame({"features": list(x), "label": y})
    holdout = df.sample(frac=0.1, random_state=0)
    return df.drop(holdout.index), holdout


def rank_auc(pred, label):
    """The example's rank-based AUC."""
    order = np.argsort(pred)
    rank = np.empty_like(order, np.float64)
    rank[order] = np.arange(1, len(pred) + 1)
    pos, neg = label.sum(), (1 - label).sum()
    return float((rank[label == 1].sum() - pos * (pos + 1) / 2) /
                 max(pos * neg, 1))


def score(model, holdout):
    scored = model.transform(holdout)
    pred = np.asarray(list(scored["prediction"]), np.float32).reshape(-1)
    return rank_auc(pred, holdout["label"].to_numpy(np.float32))


def jax_auc(train, holdout, seed):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from analytics_zoo_tpu.orca.learn.estimator import TPUEstimator
    from analytics_zoo_tpu.pipeline.api.keras import Sequential
    from analytics_zoo_tpu.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu.pipeline.nnframes import NNEstimator, NNModel
    net = Sequential([Dense(w, activation="relu") for w in WIDTHS] +
                     [Dense(1, activation="sigmoid")])
    nn_est = (NNEstimator(net.to_module(), "binary_crossentropy")
              .setBatchSize(BATCH).setMaxEpoch(EPOCHS))
    if seed == 0:
        return score(nn_est.fit(train), holdout)
    from analytics_zoo_tpu.pipeline.nnframes.nn_classifier import \
        _col_to_array
    est = TPUEstimator(nn_est.model, loss="binary_crossentropy",
                       optimizer="adam", seed=seed)
    est.fit({"x": _col_to_array(train, "features"),
             "y": _col_to_array(train, "label")}, epochs=EPOCHS,
            batch_size=BATCH, verbose=False)
    return score(NNModel(nn_est.model, estimator=est).setBatchSize(BATCH),
                 holdout)


def port_auc(train, holdout, seed):
    import torch
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNEstimator
    torch.manual_seed(seed)
    net = Sequential([Dense(w, activation="relu") for w in WIDTHS] +
                     [Dense(1, activation="sigmoid")])
    module = net.to_module()
    module(torch.zeros(1, 29))          # the initial draws, on the CPU
    model = (NNEstimator(module, "binary_crossentropy", device="cpu")
             .setBatchSize(BATCH).setMaxEpoch(EPOCHS).fit(train))
    return score(model, holdout)


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--jax-seeds", default="0",
                   help="comma-separated estimator seeds for JAX runs")
    p.add_argument("--port-seeds", default="",
                   help="comma-separated torch seeds for port runs")
    args = p.parse_args()
    train, holdout = frames()
    out = {"rows": ROWS, "holdout": len(holdout),
           "holdout_fraud": int(holdout["label"].sum()), "batch": BATCH,
           "epochs": EPOCHS, "device": "cpu"}
    t0 = time.perf_counter()
    out["jax_auc"] = {s: jax_auc(train, holdout, s)
                      for s in _seeds(args.jax_seeds)}
    out["port_auc"] = {s: port_auc(train, holdout, s)
                       for s in _seeds(args.port_seeds)}
    out["run_s"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
