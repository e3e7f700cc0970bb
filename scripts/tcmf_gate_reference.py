"""The two TCMF gates of ``tests/test_zouwu_real_data.py`` on the CPU, over
initial draws, from the JAX package and from the PyTorch port.

* The NYC-taxi panel (``:75``): the bundled NAB subset, standardised, as
  a (half-hour of day, day) panel of 48 x ~76; the last 7 days are held
  out. ``TCMFForecaster(rank=16)`` fits 400 epochs (the hybrid stays off
  under ``"auto"``) and must beat the per-series mean and persistence
  and stay within 1.25 x the last week's copy.
* The long panel (``:109``): 16 series x 600 of four seasonal periods
  plus AR(0.8) noise, the last 4 steps held out. ``TCMF(rank=8,
  window=28, local_window=14, rollout_steps=4)`` fits 80 epochs with the
  hybrid off and on; the hybrid must beat global-only and half the
  mean's MSE.

    JAX_PLATFORMS=cpu python scripts/tcmf_gate_reference.py \\
        [--jax-seeds 0,1] [--port-seeds 0,1]

A run with seed s sets the model's ``seed`` (``PRNGKey(s)`` in the JAX
package; torch's generator in the port, as ``chip_smoke.py``'s
``tcmf_real_data`` phase does on the card) and holds the gates as that
phase does, on that phase's panels. Prints one JSON line.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def gates(seed, tcmf, **device):
    """``chip_smoke._tcmf_gates`` for either package: ``tcmf`` is a
    package's ``zouwu/model/tcmf.py``."""
    from chip_smoke import _long_panel, _nyc_taxi_panel
    panel = _nyc_taxi_panel()
    h = 7
    train, truth = panel[:, :-h], panel[:, -h:]
    fc = tcmf.TCMFForecaster(rank=16, **device)
    fc.model.seed = seed
    fc.fit({"y": train}, epochs=400)
    pred = np.asarray(fc.predict(horizon=h))
    # the fitted local net: the JAX model's ynet_params, the port's ynet
    g1 = {"hybrid_off": getattr(fc.model, "ynet_params",
                                fc.model.ynet) is None,
          "model": float(np.mean((pred - truth) ** 2)),
          "mean": float(np.mean((train.mean(1, keepdims=True) - truth)
                                ** 2)),
          "persistence": float(np.mean((train[:, -1:] - truth) ** 2)),
          "last_week": float(np.mean((train[:, -h:] - truth) ** 2))}
    g1["pass"] = (g1["hybrid_off"] and g1["model"] < g1["mean"]
                  and g1["model"] < g1["persistence"]
                  and g1["model"] < 1.25 * g1["last_week"])
    y = _long_panel()
    h = 4
    train, truth = y[:, :-h], y[:, -h:]
    g2 = {"mean": float(np.mean((train.mean(1, keepdims=True) - truth)
                                ** 2))}
    for local in (False, True):
        m = tcmf.TCMF(rank=8, window=28, local_model=local, local_window=14,
                      rollout_steps=h, seed=seed, **device)
        m.fit(train, epochs=80)
        g2["hybrid" if local else "global_only"] = float(
            np.mean((np.asarray(m.predict(h)) - truth) ** 2))
    g2["pass"] = (g2["hybrid"] < g2["global_only"]
                  and g2["hybrid"] < 0.5 * g2["mean"])
    return {"seed": seed, "nyc_taxi": g1, "long_panel": g2}


def summary(draws):
    return {"draws": draws,
            "nyc_taxi_passing": sum(d["nyc_taxi"]["pass"] for d in draws),
            "long_panel_passing": sum(d["long_panel"]["pass"]
                                      for d in draws),
            "nyc_taxi_median": statistics.median(
                d["nyc_taxi"]["model"] for d in draws),
            "long_panel_hybrid_median": statistics.median(
                d["long_panel"]["hybrid"] for d in draws)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax-seeds", default="0,1,2,3,4")
    ap.add_argument("--port-seeds", default="0,1,2,3,4")
    args = ap.parse_args()
    seeds = {k: [int(s) for s in v.split(",") if s]
             for k, v in (("jax", args.jax_seeds),
                          ("port", args.port_seeds))}
    out = {}
    t0 = time.perf_counter()
    if seeds["port"]:
        from analytics_zoo_tpu_torch.zouwu.model import tcmf as port
        out["port"] = summary([gates(s, port, device="cpu")
                               for s in seeds["port"]])
    if seeds["jax"]:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "highest")
        from analytics_zoo_tpu.zouwu.model import tcmf as ref
        out["jax"] = summary([gates(s, ref) for s in seeds["jax"]])
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
