"""TCMF, temporal convolutional matrix factorization (counterpart of
``analytics_zoo_tpu/zouwu/model/tcmf.py``; the reference's
tcmf_forecaster.py and DeepGLO.py:904, "Think Globally, Act Locally",
arXiv:1905.03806).

A high-dimensional panel Y (n, T) factorizes as F @ X, with a dilated
causal TCN as the prior on the temporal basis X. F, X and the TCN train
jointly on one device; ``predict`` rolls X forward with the TCN. Where the
corpus is large enough (the ``"auto"`` gate), DeepGLO's local hybrid
follows: one weight-shared TCN over each series' own history and the
global reconstruction (plus sin/cos seasonal channels) learns a residual
correction to the global forecast.

The nets work in NCW (``(batch, channels, time)``): the teacher-forced
windows come out of ``unfold`` in that layout. They carry flax's names
(``_TemporalConvNet_0.conv_i`` / ``res_i``, ``head``), so
``interop.load_flax_params`` and ``interop.state_dict_to_flax`` carry
their weights across packages in flax's layout.

**Epochs.** The JAX package runs all epochs of a phase as one ``lax.scan``
in one jitted program. On the card an epoch (forward, backward and a
``capturable`` Adam) is captured once as a CUDA graph
(``orca/learn/graphs.py``, kind ``"tcmf"``) after a first eager epoch on
a side stream, then replayed for the others; the last loss is read once.
On the CPU the same step runs eagerly.

**Save blob.** ``TCMFForecaster.save`` writes the JAX package's blob: a
pickle of numpy arrays, plain dicts and builtins, with the net parameters
in flax's layout, so either package loads the other's file.

The sharded fit (``mesh``, ``num_workers > 1``) needs the port's process
groups: it raises, naming ROADMAP A10.
"""

from __future__ import annotations

import contextlib
import math
import pickle
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F_
from torch import nn

from ... import interop
from ...common.context import resolve_device
from ...models.common.initializers import lecun_normal_
from ...orca.learn import graphs

_NO_MESH = ("TCMF's sharded fit (mesh, num_workers > 1) is not ported "
            "yet: it needs the port's process groups (ROADMAP A10)")

_EAGER = threading.local()


@contextlib.contextmanager
def _eager_epochs():
    """Inside the block, epochs on the card run eagerly instead of by graph
    replay (the graph-vs-eager check of ``chip_smoke.py``)."""
    _EAGER.on = True
    try:
        yield
    finally:
        _EAGER.on = False


def _train_epochs(step, epochs: int, device: torch.device) -> torch.Tensor:
    """Run ``step`` (one epoch: forward, backward, the optimizer's update;
    returns the detached loss) ``epochs`` times and return the last loss.
    On the card the first epoch runs eagerly on a side stream (Adam's state
    and cuDNN's plans exist before the capture), the step is captured, and
    each later epoch is one replay."""
    if epochs < 1:
        raise ValueError(f"epochs must be >= 1, got {epochs}")
    if device.type != "cuda" or getattr(_EAGER, "on", False):
        for _ in range(epochs):
            loss = step()
        return loss
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        loss = step()
    if epochs == 1:
        torch.cuda.current_stream(device).wait_stream(stream)
        return loss
    graph = graphs.capture("tcmf", step, [], stream)
    for _ in range(epochs - 1):
        loss = graph.replay(())
    return loss


class _TemporalConvNet(nn.Module):
    """Dilated causal conv stack over ``(batch, channels, time)``: layer i
    left-pads by ``(k - 1) * 2**i``, convolves, and adds ``relu(h)`` to its
    input (through the 1x1 conv ``res_i`` where the widths differ)."""

    def __init__(self, in_channels: int, channels: Tuple[int, ...],
                 kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.n_layers = len(channels)
        c_in = in_channels
        for i, ch in enumerate(channels):
            conv = nn.Conv1d(c_in, ch, kernel_size, dilation=2 ** i)
            lecun_normal_(conv.weight, kernel_size * c_in)
            nn.init.zeros_(conv.bias)
            self.add_module(f"conv_{i}", conv)
            if c_in != ch:
                res = nn.Conv1d(c_in, ch, 1)
                lecun_normal_(res.weight, c_in)
                nn.init.zeros_(res.bias)
                self.add_module(f"res_{i}", res)
            c_in = ch

    def forward(self, x):
        for i in range(self.n_layers):
            pad = (self.kernel_size - 1) * 2 ** i
            h = getattr(self, f"conv_{i}")(F_.pad(x, (pad, 0)))
            res = getattr(self, f"res_{i}", None)
            x = torch.relu(h) + (x if res is None else res(x))
        return x


def _dense(in_features: int, out_features: int) -> nn.Linear:
    """flax's ``Dense``: lecun normal kernel, zero bias."""
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight, in_features)
    nn.init.zeros_(layer.bias)
    return layer


class _XSeqModel(nn.Module):
    """Predict X[:, t] from the previous ``window`` steps of X: input
    ``(batch, rank, window)``, output ``(batch, rank)``."""

    def __init__(self, rank: int, channels: Tuple[int, ...] = (32, 32),
                 kernel_size: int = 3):
        super().__init__()
        self.channels = tuple(channels)
        self.kernel_size = kernel_size
        self._TemporalConvNet_0 = _TemporalConvNet(rank, self.channels,
                                                   kernel_size)
        self.head = _dense(self.channels[-1], rank)

    def forward(self, x_window):
        return self.head(self._TemporalConvNet_0(x_window)[:, :, -1])


class _LocalYModel(nn.Module):
    """DeepGLO's per-series hybrid (reference DeepGLO.py:904): input
    ``(batch, C, w)`` with channels ``[y_history, global_recon(, sin,
    cos)]``, output the residual correction ``(batch,)``. The head starts
    at zero, so training starts at the global forecast."""

    def __init__(self, in_channels: int, channels: Tuple[int, ...] = (16, 16),
                 kernel_size: int = 3):
        super().__init__()
        self.channels = tuple(channels)
        self.kernel_size = kernel_size
        self._TemporalConvNet_0 = _TemporalConvNet(in_channels,
                                                   self.channels,
                                                   kernel_size)
        self.head = nn.Linear(self.channels[-1], 1)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, yw):
        return self.head(self._TemporalConvNet_0(yw)[:, :, -1])[..., 0]


def _windows(mat: torch.Tensor, starts: torch.Tensor, length: int
             ) -> torch.Tensor:
    """``mat[:, s:s + length]`` for each start: ``(len(starts), rows,
    length)``."""
    return mat.unfold(1, length, 1)[:, starts].transpose(0, 1)


def _adam(params, lr: float, device: torch.device) -> torch.optim.Adam:
    """optax's ``adam(lr)`` defaults (torch's formula is the same);
    ``capturable`` on the card, so its step is a device operation."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=device.type == "cuda")


class TCMF:
    """Core model: ``fit(Y)`` learns F, X and the TCN (and the local
    hybrid where enabled); ``predict(horizon)`` rolls forward."""

    def __init__(self, rank: int = 16,
                 tcn_channels: Tuple[int, ...] = (32, 32),
                 kernel_size: int = 3, window: int = 16, lam: float = 1.0,
                 lr: float = 1e-2, seed: int = 0, rollout_steps: int = 8,
                 local_model="auto", local_window: int = 14,
                 local_channels: Tuple[int, ...] = (16, 16),
                 local_kernel_size: int = 3,
                 seasonal_period: Optional[int] = None,
                 local_min_windows: int = 20_000, device=None):
        self.device = resolve_device(device)
        self.rank = rank
        self.tcn_channels = tuple(tcn_channels)
        self.kernel_size = kernel_size
        self.window = window
        self.lam = lam
        self.lr = lr
        self.seed = seed
        self.rollout_steps = rollout_steps
        # "auto": the hybrid engages only where the corpus offers enough
        # (series x window) samples (the JAX package's measured rule)
        self.local_model = local_model
        self.local_min_windows = local_min_windows
        self.local_window = local_window
        self.local_channels = tuple(local_channels)
        self.local_kernel_size = int(local_kernel_size)
        self.seasonal_period = seasonal_period
        self.net: Optional[_XSeqModel] = None
        self.ynet: Optional[_LocalYModel] = None
        self.F = None
        self.X = None
        self.y_mean = None
        self.y_scale = None

    # --- initial draws (seeded, on the CPU, then moved) ---------------------
    def _init_global(self, n: int, T: int):
        """F, X drawn N(0, 0.1^2) and the TCN (flax's init), from
        ``seed``, leaving torch's global RNG as it was."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            F = torch.randn(n, self.rank) * 0.1
            X = torch.randn(self.rank, T) * 0.1
            net = _XSeqModel(self.rank, self.tcn_channels, self.kernel_size)
        return F, X, net

    def _init_local(self, n_ch: int) -> _LocalYModel:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed + 7)
            return _LocalYModel(n_ch, self.local_channels,
                                self.local_kernel_size)

    # --- the global model ---------------------------------------------------
    def _loss(self, F, X, y):
        """Reconstruction MSE of ``F @ X``, plus ``lam`` times the TCN's
        teacher-forced one-step loss on X and its closed-loop rollout loss
        over ``rollout_steps`` (targets detached), as in the JAX package."""
        mse = torch.mean((F @ X - y) ** 2)
        T = X.shape[1]
        w = self.window
        # T - w windows (X.T unfolds to (T - w + 1, rank, w); the last has
        # no target); the targets X[:, w:] are not detached
        windows = X.t().unfold(0, w, 1)
        preds = self.net(windows[:T - w])
        temporal = torch.mean((preds - X[:, w:].t()) ** 2)
        h = self.rollout_steps
        if h > 0 and T - w - h > 0:
            starts = torch.arange(0, T - w - h, max(1, (T - w - h) // 16),
                                  device=X.device)
            win = windows[starts]                         # (S, rank, w)
            rolled = []
            for _ in range(h):
                nxt = self.net(win)
                win = torch.cat([win[:, :, 1:], nxt[:, :, None]], dim=2)
                rolled.append(nxt)
            rolled = torch.stack(rolled)                  # (h, S, rank)
            cols = starts[:, None] + w + torch.arange(h, device=X.device)
            tgt = X[:, cols].permute(2, 1, 0).detach()    # (h, S, rank)
            closed = torch.mean((rolled - tgt) ** 2)
        else:
            closed = 0.0
        return mse + self.lam * (temporal + closed)

    def fit(self, y: np.ndarray, epochs: int = 100, val_len: int = 0,
            mesh=None) -> Dict[str, float]:
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        y = np.asarray(y, np.float32)
        n, T = y.shape
        if T <= self.window + 1:
            raise ValueError(f"series length {T} too short for window "
                             f"{self.window}")
        self.y_mean = y.mean(axis=1, keepdims=True)
        self.y_scale = y.std(axis=1, keepdims=True) + 1e-6
        yn_host = ((y - self.y_mean) / self.y_scale).astype(np.float32)
        self._n = n
        dev = self.device
        yn = torch.from_numpy(yn_host).to(dev)
        F, X, net = self._init_global(n, T)
        self.F = F.to(dev).requires_grad_(True)
        self.X = X.to(dev).requires_grad_(True)
        self.net = net.to(dev)
        opt = _adam([self.F, self.X, *self.net.parameters()], self.lr, dev)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = self._loss(self.F, self.X, yn)
            loss.backward()
            opt.step()
            return loss.detach()

        loss = _train_epochs(step, epochs, dev)
        out = {"train_loss": float(loss)}
        self.F = self.F.detach()
        self.X = self.X.detach()
        self.net.requires_grad_(False)
        if self._local_enabled(n, T):
            out["local_loss"] = self._fit_local(yn, epochs)
        else:
            self.ynet = None
        return out

    # --- the local hybrid -------------------------------------------------
    def _local_enabled(self, n: int, T: int) -> bool:
        if not self.local_model:
            return False
        if self.local_model == "auto":
            return (n * max(T - self.local_window, 0)
                    >= self.local_min_windows)
        return True

    def _time_cov(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """Seasonal phase covariates ``[sin, cos]`` of the float time
        indices ``t``: ``(len(t), 2)``, or None without a period."""
        if not self.seasonal_period:
            return None
        ang = 2 * math.pi * t / self.seasonal_period
        return torch.stack([torch.sin(ang), torch.cos(ang)], -1)

    def _fit_local(self, yn: torch.Tensor, epochs: int) -> float:
        """Train the weight-shared local TCN on [own history, global
        reconstruction (, sin, cos)] windows against the residual of the
        global reconstruction, one-step and over a closed-loop rollout in
        residual form (the JAX package's ``_fit_local``)."""
        w = self.local_window
        n, T = yn.shape
        if T <= w + 1:
            return float("nan")
        self._T_fit = T
        dev = yn.device
        recon = self.F @ self.X                           # (n, T)
        # at most 200,000 windows: stride the starts on large panels
        stride = max(1, (T - w) * n // 200_000)
        starts = torch.arange(0, T - w, stride, device=dev)
        S = len(starts)
        cov = self._time_cov(torch.arange(T, device=dev,
                                          dtype=torch.float32))
        n_ch = 2 if cov is None else 4
        inp = torch.stack([_windows(yn, starts, w),
                           _windows(recon, starts, w)], dim=2)  # (S,n,2,w)
        if cov is not None:
            covwin = _windows(cov.t(), starts, w)         # (S, 2, w)
            inp = torch.cat([inp, covwin[:, None].expand(S, n, 2, w)], 2)
        flat_in = inp.reshape(-1, n_ch, w).contiguous()
        flat_tgt = (yn[:, starts + w] - recon[:, starts + w]).t().reshape(-1)

        h = min(self.rollout_steps, max(1, (T - w) // 4))
        roll_starts = torch.arange(0, T - w - h, max(1, (T - w - h) // 16),
                                   device=dev)
        roll_y0 = _windows(yn, roll_starts, w).contiguous()      # (S, n, w)
        roll_r = _windows(recon, roll_starts, w + h).contiguous()
        roll_tgt = _windows(yn, roll_starts, w + h)[:, :, w:].contiguous()
        roll_cov = (None if cov is None else
                    _windows(cov.t(), roll_starts, w + h).contiguous())
        Sr = len(roll_starts)

        self.ynet = self._init_local(n_ch).to(dev)
        opt = _adam(list(self.ynet.parameters()), self.lr, dev)

        def loss_of():
            pred = self.ynet(flat_in)
            one_step = (torch.sum((pred - flat_tgt) ** 2)
                        / max(flat_tgt.numel(), 1))
            ybuf, rolled = roll_y0, []
            for k in range(h):
                # ybuf covers positions k..k+w-1 and predicts k+w
                step_in = torch.stack([ybuf, roll_r[:, :, k:k + w]], dim=2)
                if roll_cov is not None:
                    cwin = roll_cov[:, :, k:k + w]
                    step_in = torch.cat(
                        [step_in, cwin[:, None].expand(Sr, n, 2, w)], 2)
                resid = self.ynet(step_in.reshape(-1, n_ch, w)).reshape(
                    Sr, n)
                yk = roll_r[:, :, k + w] + resid          # residual form
                ybuf = torch.cat([ybuf[:, :, 1:], yk[:, :, None]], dim=2)
                rolled.append(yk)
            closed = torch.mean((torch.stack(rolled, -1) - roll_tgt) ** 2)
            return one_step + closed

        def step():
            opt.zero_grad(set_to_none=True)
            loss = loss_of()
            loss.backward()
            opt.step()
            return loss.detach()

        loss = _train_epochs(step, epochs, dev)
        self.ynet.requires_grad_(False)
        # history buffers for predict(), copied out of the full panels
        self._yn_tail = yn[:, -w:].clone()
        self._recon_tail = recon[:, -w:].clone()
        return float(loss)

    # --- incremental fit, prediction, evaluation --------------------------
    def fit_incremental(self, y_new: np.ndarray, epochs: int = 30):
        """Extend X by the TCN's rollout over the new columns and fit them
        with F and the TCN frozen (the reference's fit_incremental)."""
        if self.F is None:
            raise RuntimeError("call fit before fit_incremental")
        y_new = np.asarray(y_new, np.float32)
        yn_new = torch.from_numpy(
            ((y_new - self.y_mean) / self.y_scale).astype(np.float32)).to(
            self.device)
        T_new = y_new.shape[1]
        T_old = self.X.shape[1]
        X_full = torch.cat([self.X, self._roll(T_new)], dim=1
                           ).requires_grad_(True)
        opt = _adam([X_full], self.lr, self.device)
        F = self.F

        def step():
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((F @ X_full[:, T_old:] - yn_new) ** 2)
            loss.backward()
            opt.step()
            return loss.detach()

        loss = _train_epochs(step, epochs, self.device)
        self.X = X_full.detach()
        if self.local_model and self.ynet is not None:
            w = self.local_window
            self._yn_tail = torch.cat([self._yn_tail, yn_new], dim=1)[:, -w:]
            self._recon_tail = (self.F @ self.X)[:, -w:]
            # the seasonal clock follows the extended series
            self._T_fit = getattr(self, "_T_fit", T_old) + T_new
        return {"train_loss": float(loss)}

    @torch.no_grad()
    def _roll(self, horizon: int) -> torch.Tensor:
        """Roll X forward ``horizon`` steps with the TCN: ``(rank,
        horizon)``."""
        window = self.X[None, :, -self.window:]           # (1, rank, w)
        xs = []
        for _ in range(horizon):
            nxt = self.net(window)
            window = torch.cat([window[:, :, 1:], nxt[:, :, None]], dim=2)
            xs.append(nxt[0])
        return torch.stack(xs, dim=1)

    @torch.no_grad()
    def predict(self, horizon: int = 24) -> np.ndarray:
        if self.F is None:
            raise RuntimeError("fit first")
        yn = self.F @ self._roll(horizon)                 # global forecast
        if self.local_model and self.ynet is not None:
            yn = self._predict_hybrid(yn, horizon)
        yn = yn.cpu().numpy()[:getattr(self, "_n", self.F.shape[0])]
        return yn * self.y_scale + self.y_mean

    @torch.no_grad()
    def _predict_hybrid(self, recon_future: torch.Tensor, horizon: int):
        """Roll the local hybrid forward: the y channel runs on its own
        predictions, the recon channel takes the global forecast, and the
        seasonal channels are known for the future."""
        w = self.local_window
        T = getattr(self, "_T_fit", self._yn_tail.shape[1])
        ybuf, rbuf = self._yn_tail, self._recon_tail
        n = ybuf.shape[0]
        ys = []
        for k in range(horizon):
            rk = recon_future[:, k]
            inp = torch.stack([ybuf, rbuf], dim=1)       # (n, 2, w)
            cov = self._time_cov(torch.arange(
                (T - w) + k, (T - w) + k + w, device=ybuf.device,
                dtype=torch.float32))
            if cov is not None:
                inp = torch.cat([inp, cov.t()[None].expand(n, 2, w)], 1)
            yk = rk + self.ynet(inp)
            ybuf = torch.cat([ybuf[:, 1:], yk[:, None]], dim=1)
            rbuf = torch.cat([rbuf[:, 1:], rk[:, None]], dim=1)
            ys.append(yk)
        return torch.stack(ys, dim=1)                     # (n, horizon)

    def evaluate(self, y_true: np.ndarray, metrics=("mae",)) -> list:
        pred = self.predict(np.asarray(y_true).shape[1])
        out = []
        for m in metrics:
            if m == "mae":
                out.append(float(np.mean(np.abs(pred - y_true))))
            elif m == "mse":
                out.append(float(np.mean((pred - y_true) ** 2)))
            elif m == "smape":
                out.append(float(np.mean(
                    200 * np.abs(pred - y_true) /
                    (np.abs(pred) + np.abs(y_true) + 1e-8))))
            else:
                raise ValueError(f"unknown metric {m}")
        return out


class TCMFForecaster:
    """User-facing wrapper with the reference constructor surface
    (tcmf_forecaster.py ``TCMFForecaster(vbsize, hbsize, num_channels_X,
    ...)``): rank at most 64, kernel sizes at most 5, lr at least 1e-3,
    ``seasonal_period`` only under ``use_time``. Knobs that only tuned the
    reference's torch batching are accepted and ignored."""

    def __init__(self, vbsize: int = 128, hbsize: int = 256,
                 num_channels_X=(32, 32), num_channels_Y=(16, 16),
                 kernel_size: int = 7, dropout: float = 0.1, rank: int = 64,
                 kernel_size_Y: int = 7, learning_rate: float = 0.0005,
                 normalize: bool = False, use_time: bool = True,
                 svd: bool = True, seasonal_period: Optional[int] = None,
                 device=None, **_):
        self.model = TCMF(rank=min(rank, 64),
                          tcn_channels=tuple(num_channels_X),
                          kernel_size=min(kernel_size, 5),
                          lr=max(learning_rate, 1e-3),
                          local_model="auto",
                          local_channels=tuple(num_channels_Y),
                          local_kernel_size=min(int(kernel_size_Y), 5),
                          seasonal_period=(seasonal_period
                                           if use_time else None),
                          device=device)

    def fit(self, x, val_len: int = 24, incremental: bool = False,
            num_workers: Optional[int] = None, epochs: int = 100,
            mesh=None, **_):
        y = x["y"] if isinstance(x, dict) else x
        if incremental and self.model.F is not None:
            return self.model.fit_incremental(y, epochs=epochs)
        if mesh is not None or (num_workers and num_workers > 1):
            raise NotImplementedError(_NO_MESH)
        return self.model.fit(y, epochs=epochs, val_len=val_len)

    def fit_incremental(self, x_incr, **kwargs):
        y = x_incr["y"] if isinstance(x_incr, dict) else x_incr
        return self.model.fit_incremental(y)

    def predict(self, horizon: int = 24, num_workers: Optional[int] = None):
        return self.model.predict(horizon)

    def evaluate(self, target_value, metric=("mae",),
                 num_workers: Optional[int] = None):
        y = (target_value["y"] if isinstance(target_value, dict)
             else target_value)
        return self.model.evaluate(y, metric)

    def save(self, path: str):
        """The JAX package's blob: numpy arrays, plain dicts, builtins; the
        nets' parameters as flax trees."""
        m = self.model
        n = getattr(m, "_n", m.F.shape[0])
        blob = {
            "rank": m.rank, "window": m.window,
            "channels": tuple(m.net.channels),
            "kernel_size": m.net.kernel_size, "lr": m.lr,
            "F": m.F.cpu().numpy()[:n],
            "X": m.X.cpu().numpy(),
            "net": interop.state_dict_to_flax(m.net.state_dict()),
            "mean": m.y_mean, "scale": m.y_scale,
        }
        if m.local_model and m.ynet is not None:
            blob["local"] = {
                "window": m.local_window,
                "channels": tuple(m.ynet.channels),
                "params": interop.state_dict_to_flax(m.ynet.state_dict()),
                "yn_tail": m._yn_tail.cpu().numpy()[:n],
                "recon_tail": m._recon_tail.cpu().numpy()[:n],
                "T_fit": getattr(m, "_T_fit", None),
                "seasonal_period": m.seasonal_period,
            }
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    @classmethod
    def load(cls, path: str, device=None) -> "TCMFForecaster":
        """A forecaster from a blob either package wrote, on ``device``.
        The local net's kernel size is read off its parameters (the blob
        does not name it)."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        loc = blob.get("local")
        fc = cls.__new__(cls)
        fc.model = m = TCMF(
            rank=blob["rank"], tcn_channels=blob["channels"],
            kernel_size=blob["kernel_size"], lr=blob["lr"],
            window=blob["window"], local_model=loc is not None,
            local_window=loc["window"] if loc else 14,
            local_channels=tuple(loc["channels"]) if loc else (16, 16),
            local_kernel_size=(np.shape(loc["params"]["_TemporalConvNet_0"]
                                        ["conv_0"]["kernel"])[0]
                               if loc else 3),
            seasonal_period=(loc or {}).get("seasonal_period"),
            device=device)
        dev = m.device
        m.F = torch.from_numpy(np.asarray(blob["F"], np.float32)).to(dev)
        m.X = torch.from_numpy(np.asarray(blob["X"], np.float32)).to(dev)
        m.net = interop.load_flax_params(
            _XSeqModel(m.rank, m.tcn_channels, m.kernel_size),
            blob["net"]).to(dev).requires_grad_(False)
        m.y_mean, m.y_scale = blob["mean"], blob["scale"]
        if loc is not None:
            n_ch = np.shape(loc["params"]["_TemporalConvNet_0"]["conv_0"]
                            ["kernel"])[1]
            m.ynet = interop.load_flax_params(
                _LocalYModel(n_ch, m.local_channels, m.local_kernel_size),
                loc["params"]).to(dev).requires_grad_(False)
            m._yn_tail = torch.from_numpy(
                np.asarray(loc["yn_tail"], np.float32)).to(dev)
            m._recon_tail = torch.from_numpy(
                np.asarray(loc["recon_tail"], np.float32)).to(dev)
            if loc.get("T_fit") is not None:
                m._T_fit = loc["T_fit"]
        return fc
