"""The port's Friesian feature tables (``analytics_zoo_tpu_torch/friesian``)
against the JAX package's, on the CPU.

Every ``Table``/``FeatureTable``/``StringIndex`` method runs on the same
seeded click log in both packages, on one installed pandas: frames must
be equal with ``check_exact=True`` (dtypes, index and values), string
indices equal frame for frame, ``to_shards`` equal partition for
partition, ``show`` the same text. Then the pipeline of
``examples/friesian/recsys_feature_engineering.py`` engineers a log in
both packages and Wide & Deep (the example's widths) trains 3 Adam steps
on each side from the JAX estimator's initial weights, bridged through
``interop``: losses, parameters and predictions within rtol/atol 1e-4
(f32, a few steps of two frameworks' rounding; the zoo models' fit
tolerance in tests/test_torch_model_zoo.py).
"""

import types

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from pandas.testing import assert_frame_equal

from analytics_zoo_tpu.friesian import feature as jfeat
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.friesian import feature as tfeat
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.orca.data.shard import HostXShards
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt

FIT_TOL = dict(rtol=1e-4, atol=1e-4)
ONE_STEP = {"steps_per_dispatch": 1}
CITIES = ["nyc", "sf", "chi", "la", "sea", "bos", "atx", "den"]
DEVICES = ["ios", "android", "web"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread for the module (the suite runs beside
    other busy workers), the old count restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def click_log(n, users=40, items=25, seed=0):
    """The example's click log, drawn with vectorised numpy: string users,
    items, cities and devices, prices with 5 % missing, dwell times, a
    time column and a click label tied to device and price."""
    rng = np.random.RandomState(seed)
    df = pd.DataFrame({
        "user": np.char.add("u", rng.randint(users, size=n).astype(str)),
        "item": np.char.add("i", rng.randint(items, size=n).astype(str)),
        "city": np.array(CITIES)[rng.randint(len(CITIES), size=n)],
        "device": np.array(DEVICES)[rng.randint(len(DEVICES), size=n)],
        "price": np.where(rng.rand(n) < 0.05, np.nan,
                          np.exp(rng.randn(n) * 1.2 + 3)),
        "dwell_ms": rng.exponential(3000, n),
        "time": rng.permutation(n).astype(np.int64),
    })
    click_p = (0.15 + 0.25 * (df["device"] == "ios")
               - 0.1 * (df["price"].fillna(df["price"].median()) > 40))
    df["label"] = (rng.rand(n) < click_p).astype(np.int32)
    return df


def _pkg(mod):
    return types.SimpleNamespace(FeatureTable=mod.FeatureTable,
                                 StringIndex=mod.StringIndex, Table=mod.Table)


J, T = _pkg(jfeat), _pkg(tfeat)


def _same(got, want):
    """One package's result vs the other's, by kind."""
    if isinstance(want, (jfeat.Table, tfeat.Table)):
        assert type(got).__name__ == type(want).__name__
        assert_frame_equal(got.df, want.df, check_exact=True)
        if type(want).__name__ == "StringIndex":
            assert got.col_name == want.col_name
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, pd.DataFrame):
        assert_frame_equal(got, want, check_exact=True)
    elif type(want).__name__ == "HostXShards":
        assert isinstance(got, HostXShards)
        _same(got.collect(), want.collect())
    else:
        assert got == want


def _indexed(p, tbl):
    """The log with string indices built and applied (the example's
    encode step)."""
    idx = tbl.gen_string_idx(["user", "item", "city", "device"],
                             freq_limit=2)
    return tbl.encode_string(["user", "item", "city", "device"], idx)


def _sessions(p, tbl):
    """The session pipeline: encoded items, labels, histories."""
    enc = _indexed(p, tbl)
    return enc.add_negative_samples(30, neg_num=1).add_hist_seq(
        "user", ["item"], max_len=4)


CASES = {
    "to_pandas": lambda p, t, d: t.to_pandas(),
    "size": lambda p, t, d: (t.size(), len(t)),
    "schema": lambda p, t, d: {k: str(v) for k, v in t.schema.items()},
    "col_names": lambda p, t, d: t.col_names(),
    "compute": lambda p, t, d: t.compute(),
    "drop": lambda p, t, d: t.drop("price", "time"),
    "distinct": lambda p, t, d: t.drop("price", "dwell_ms", "time",
                                       "label", "user", "item").distinct(),
    "filter_mask": lambda p, t, d: t.filter(t.df["label"] == 1),
    "filter_callable": lambda p, t, d: t.filter(lambda df: df["price"] > 20),
    "rename": lambda p, t, d: t.rename({"city": "town"}),
    "fillna": lambda p, t, d: t.fillna(0.0, ["price"]),
    "dropna": lambda p, t, d: t.dropna(["price"]),
    "dropna_thresh": lambda p, t, d: t.dropna(thresh=8),
    "clip": lambda p, t, d: t.clip(["dwell_ms", "price"], min=100, max=4000),
    "log": lambda p, t, d: t.log(["price", "dwell_ms"]),
    "log_unclipped": lambda p, t, d: t.clip("dwell_ms", min=-5).log(
        "dwell_ms", clipping=False),
    "median": lambda p, t, d: t.median(["price", "dwell_ms"]),
    "fill_median": lambda p, t, d: t.fill_median(["price"]),
    # lists holding NaN never compare equal, so the prices are filled first
    "merge_cols": lambda p, t, d: t.fill_median("price").merge_cols(
        ["price", "dwell_ms"], "pd"),
    "join": lambda p, t, d: t.join(p.FeatureTable.from_pandas(
        pd.DataFrame({"city": CITIES[:5], "rank": np.arange(5)})), on="city"),
    "join_left": lambda p, t, d: t.join(p.FeatureTable.from_pandas(
        pd.DataFrame({"city": CITIES[:5], "rank": np.arange(5)})),
        on="city", how="left"),
    "gen_string_idx": lambda p, t, d: t.gen_string_idx(["user", "city"]),
    "gen_string_idx_freq": lambda p, t, d: t.gen_string_idx(
        ["user", "item"], freq_limit=3),
    "encode_string": lambda p, t, d: _indexed(p, t),
    "gen_ind2ind": lambda p, t, d: t.gen_ind2ind(
        ["city", "device"], t.gen_string_idx(["city", "device"])),
    "cross_columns": lambda p, t, d: t.cross_columns(
        [["city", "device"], ["user", "city", "device"]], [32, 100]),
    "normalize": lambda p, t, d: t.normalize(["price", "dwell_ms"]),
    "normalize_constant": lambda p, t, d: t.fillna(1.0, "price").clip(
        "price", min=5, max=5).normalize("price"),
    "add_negative_samples": lambda p, t, d: _indexed(p, t)
    .add_negative_samples(30, neg_num=2),
    "add_hist_seq": lambda p, t, d: _sessions(p, t),
    "add_hist_seq_min_len": lambda p, t, d: _indexed(p, t).add_hist_seq(
        "user", ["item", "city"], min_len=2, max_len=3),
    "add_neg_hist_seq": lambda p, t, d: _sessions(p, t).add_neg_hist_seq(
        30, "item_hist_seq", 2),
    "pad": lambda p, t, d: _sessions(p, t).pad("item_hist_seq", seq_len=3),
    "mask": lambda p, t, d: _sessions(p, t).mask("item_hist_seq", 3),
    "mask_pad": lambda p, t, d: _sessions(p, t).add_neg_hist_seq(
        30, "item_hist_seq", 1).mask_pad(
        ["item_hist_seq", "neg_item_hist_seq"], ["item_hist_seq"], 5),
    "add_length": lambda p, t, d: _sessions(p, t).add_length(
        "item_hist_seq"),
    "transform_python_udf": lambda p, t, d: t.transform_python_udf(
        "city", "city_len", len),
    "add_feature": lambda p, t, d: t.add_feature(
        ["item"], p.FeatureTable.from_pandas(pd.DataFrame(
            {"item": ["i1", "i2", "i3"], "cat": [7, 8, 9]})), 0),
    "to_shards": lambda p, t, d: t.to_shards(),
    "to_shards_3": lambda p, t, d: t.to_shards(3),
    "write_read_parquet": lambda p, t, d: (
        t.write_parquet(str(d / "t.parquet")),
        p.FeatureTable.read_parquet(str(d / "t.parquet")))[1],
    "read_parquet_many": lambda p, t, d: (
        t.filter(t.df["label"] == 0).write_parquet(str(d / "a.parquet")),
        t.filter(t.df["label"] == 1).write_parquet(str(d / "b.parquet")),
        p.FeatureTable.read_parquet([str(d / "a.parquet"),
                                     str(d / "b.parquet")]))[2],
    "read_csv": lambda p, t, d: (
        t.df.to_csv(str(d / "t.csv"), index=False),
        p.FeatureTable.read_csv(str(d / "t.csv")))[1],
    "read_json": lambda p, t, d: (
        t.df.to_json(str(d / "t.jsonl"), orient="records", lines=True),
        p.FeatureTable.read_json(str(d / "t.jsonl"), cols=["user", "price"])
    )[1],
    "string_index_io": lambda p, t, d: (
        t.gen_string_idx("item")[0].write_parquet(str(d / "si.parquet")),
        p.StringIndex.read_parquet(str(d / "si.parquet")))[1],
    "string_index_ops": lambda p, t, d: (
        lambda si: (si.to_mapping(), si.size(),
                    si.filter(si.df["id"] < 4), si.rename({"id": "rid"})))(
        t.gen_string_idx("city")[0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_feature_table_op_equals_jax(name, tmp_path):
    df = click_log(300)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = CASES[name](J, J.FeatureTable.from_pandas(df), tmp_path / "jax")
    got = CASES[name](T, T.FeatureTable.from_pandas(df), tmp_path / "port")
    _same(got, want)


def test_show_prints_what_jax_prints(capsys):
    df = click_log(30)
    J.FeatureTable.from_pandas(df).show(7)
    want = capsys.readouterr().out
    T.FeatureTable.from_pandas(df).show(7)
    assert capsys.readouterr().out == want and want


def test_parquet_written_by_either_package_reads_in_the_other(tmp_path):
    """An engineered table and a string index written by one package read
    back equal in the other."""
    pkgs = {"jax": J, "port": T}
    tbl = {k: _indexed(p, p.FeatureTable.from_pandas(click_log(200)))
           for k, p in pkgs.items()}
    idx = {k: p.FeatureTable.from_pandas(click_log(200)).gen_string_idx(
        "user")[0] for k, p in pkgs.items()}
    for src, dst in (("jax", "port"), ("port", "jax")):
        path = str(tmp_path / f"{src}.parquet")
        tbl[src].write_parquet(path)
        _same(pkgs[dst].FeatureTable.read_parquet(path).df, tbl[dst].df)
        ipath = str(tmp_path / f"{src}-idx.parquet")
        idx[src].write_parquet(ipath)
        _same(pkgs[dst].StringIndex.read_parquet(ipath), idx[dst])
        with pytest.raises(FileExistsError):
            tbl[src].write_parquet(path, mode="error")


# --- the example's pipeline into Wide & Deep --------------------------------------

def engineer(p, df):
    """examples/friesian/recsys_feature_engineering.py's pipeline and W&D
    feature rows, for package ``p``'s FeatureTable and recommendation
    module ``rec``."""
    tbl = p.FeatureTable.from_pandas(df)
    user_idx, item_idx = tbl.gen_string_idx(["user", "item"], freq_limit=2)
    city_idx, dev_idx = tbl.gen_string_idx(["city", "device"])
    tbl = (tbl.fill_median(["price"])
              .clip(["dwell_ms"], min=0, max=60_000)
              .log(["price", "dwell_ms"])
              .normalize(["price", "dwell_ms"])
              .encode_string(["user", "item", "city", "device"],
                             [user_idx, item_idx, city_idx, dev_idx])
              .cross_columns([["city", "device"]], [32]))
    return tbl, (user_idx, item_idx, city_idx, dev_idx)


def wnd_rows(df, sizes, rec):
    user_n, item_n, city_n, dev_n = sizes
    n = len(df)
    dev_dim, city_dim = dev_n + 1, city_n + 1
    wide = np.zeros((n, dev_dim + 32), np.float32)
    wide[np.arange(n), df["device"]] = 1.0
    wide[np.arange(n), dev_dim + df["city_device"]] = 1.0
    indicator = np.zeros((n, city_dim), np.float32)
    indicator[np.arange(n), df["city"]] = 1.0
    ci = rec.ColumnFeatureInfo(
        wide_base_cols=["device", "city_device"],
        wide_base_dims=[dev_dim, 32],
        indicator_cols=["city"], indicator_dims=[city_dim],
        embed_cols=["user", "item"],
        embed_in_dims=[user_n + 1, item_n + 1], embed_out_dims=[16, 16],
        continuous_cols=["price", "dwell_ms"])
    x = np.concatenate(
        [wide, indicator, df[["user", "item"]].to_numpy(np.float32),
         df[["price", "dwell_ms"]].to_numpy(np.float32)], axis=1)
    assert x.shape[1] == ci.feature_width()
    return x, df["label"].to_numpy(np.int32), ci


def test_wide_and_deep_on_friesian_features_matches_jax(orca_context):
    """The example's pipeline on 600 rows in both packages (equal frames),
    then Wide & Deep (hidden 40/20/10, embeddings 16) 3 Adam steps of 64
    rows on each side from the same weights."""
    df = click_log(600, users=60, items=30, seed=3)
    (jt, jidx), (tt, tidx) = engineer(J, df), engineer(T, df)
    _same(tt, jt)
    _same(list(tidx), list(jidx))
    sizes = [i.size() for i in tidx]
    jx, jy, jci = wnd_rows(jt.to_pandas(), sizes, jrec)
    x, y, tci = wnd_rows(tt.to_pandas(), sizes, trec)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    jm = jrec.WideAndDeep(2, jci, "wide_n_deep", hidden_layers=(40, 20, 10))
    tm = trec.WideAndDeep(2, tci, "wide_n_deep", hidden_layers=(40, 20, 10),
                          device="cpu")
    jm.compile(loss="sparse_categorical_crossentropy",
               optimizer=jopt.Adam(lr=1e-2), config=dict(ONE_STEP))
    tm.compile(loss="sparse_categorical_crossentropy",
               optimizer=topt.Adam(lr=1e-2), config=dict(ONE_STEP))
    jm.estimator.engine.build((x[:1],))
    interop.load_flax_params(tm.module,
                             jax.device_get(jm.estimator.engine.params))
    data = {"x": x[:192], "y": y[:192]}
    kw = dict(epochs=1, batch_size=64, shuffle=False, verbose=False)
    js, ts = jm.fit(data, **kw), tm.fit(data, **kw)
    assert tm.estimator.engine.step == 3
    np.testing.assert_allclose(ts[0]["train_loss"], js[0]["train_loss"],
                               **FIT_TOL)
    want = interop.flax_to_state_dict(
        jax.device_get(jm.estimator.engine.params))
    got = tm.module.state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **FIT_TOL)
    np.testing.assert_allclose(tm.predict(x[192:256]),
                               np.asarray(jm.predict(x[192:256])),
                               **FIT_TOL)
