"""TensorBoard summaries of the port (``utils/tensorboard.py``,
``utils/protostream.py`` and the estimator's ``set_tensorboard`` /
``get_train_summary`` / ``get_validation_summary``) against the JAX
package's, on the CPU. Event bytes and files are compared exactly; the
scalar values of two bridged fits at rtol/atol 2e-4 (as
tests/test_torch_estimator.py).
"""

import os

import numpy as np
import pytest

from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.utils import protostream as jproto
from analytics_zoo_tpu.utils import tensorboard as jtb
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.pipeline.api.keras import \
    Sequential as TSequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.utils import protostream as tproto
from analytics_zoo_tpu_torch.utils import tensorboard as ttb

TOL = dict(rtol=2e-4, atol=2e-4)


def test_crc32c_known_answer():
    """CRC-32C (Castagnoli) of "123456789" is 0xE3069283 (RFC 3720)."""
    for tb in (ttb, jtb):
        assert tb.crc32c(b"123456789") == 0xE3069283
        assert tb.crc32c(b"") == 0


def test_event_bytes_match_jax():
    args = ("Loss", 0.3125, 7, 1700000000.5)
    assert ttb.encode_scalar_event(*args) == jtb.encode_scalar_event(*args)
    rec = ttb.encode_scalar_event(*args)
    assert ttb._frame(rec) == jtb._frame(rec)
    for v in (0, 1, 127, 128, 300, 2 ** 40):
        assert tproto.varint(v) == jproto.varint(v)
    assert list(tproto.decode_fields(rec)) == list(jproto.decode_fields(rec))


@pytest.mark.parametrize("writer,reader", [(ttb, jtb), (jtb, ttb)])
def test_files_read_by_both_readers(tmp_path, writer, reader):
    w = writer.FileWriter(str(tmp_path))
    for step in range(1, 6):
        w.add_scalar("Loss", 1.0 / step, step)
        w.add_scalar("Top1Accuracy", step / 10.0, step)
    w.close()
    got = reader.read_scalars(str(tmp_path))
    want = writer.read_scalars(str(tmp_path))
    assert got == want
    assert [s for s, _ in got["Loss"]] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([v for _, v in got["Loss"]],
                               [1.0 / s for s in range(1, 6)], rtol=1e-7)
    assert reader.read_scalars(w.path) == want


def _nets(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(64, 5).astype(np.float32)
    y = (x[:, :1] > 0).astype(np.float32)
    layers = lambda L: [L.Dense(8, activation="relu"),  # noqa: E731
                        L.Dense(1, activation="sigmoid")]
    jnet = JSequential(layers(JL)).compile("sgd", "binary_crossentropy")
    tnet = TSequential(layers(TL), device="cpu").compile(
        "sgd", "binary_crossentropy")
    jnet.set_tensorboard(str(tmp_path / "jax"), "app")
    tnet.set_tensorboard(str(tmp_path / "port"), "app")
    jnet.estimator.engine.build((x[:1],))
    interop.load_flax_params(tnet.to_module(), jnet.get_weights())
    return jnet, tnet, x, y


def test_estimator_scalars_match_jax(tmp_path, orca_context):
    """2 epochs x 2 steps with validation: 4 train ``Loss`` scalars at
    iterations 1-4, 2 validation ``loss`` scalars at iterations 2 and 4,
    on both sides, with the same values."""
    jnet, tnet, x, y = _nets(tmp_path)
    kw = dict(batch_size=32, nb_epoch=2, validation_data=(x[:16], y[:16]),
              verbose=False, steps_per_epoch=2)
    jnet.fit(x, y, **kw)
    tnet.fit(x, y, **kw)
    got, want = tnet.get_train_summary("Loss"), jnet.get_train_summary("Loss")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               **TOL)
    got = tnet.get_validation_summary("loss")
    want = jnet.get_validation_summary("loss")
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               **TOL)
    assert [s for s, _ in tnet.get_validation_summary("num_samples")] == \
        [2, 4]
    assert tnet.get_train_summary("Missing") == []
    files = os.listdir(tmp_path / "port" / "app" / "train")
    assert len(files) == 1 and files[0].startswith("events.out.tfevents.")
    # the JAX reader reads the port's files, and the other way round
    assert jtb.read_scalars(str(tmp_path / "port" / "app" / "train")) == \
        ttb.read_scalars(str(tmp_path / "port" / "app" / "train"))


def test_no_tensorboard_no_summary(tmp_path):
    net = TSequential([TL.Dense(1)], device="cpu").compile("sgd", "mse")
    assert net.get_train_summary("Loss") == []
    assert net.get_validation_summary("loss") == []
    net.fit(np.ones((4, 2), np.float32), np.ones((4, 1), np.float32),
            batch_size=2, nb_epoch=1, verbose=False)
    net.set_tensorboard(str(tmp_path), "late")
    net.fit(np.ones((4, 2), np.float32), np.ones((4, 1), np.float32),
            batch_size=2, nb_epoch=1, verbose=False)
    assert [s for s, _ in net.get_train_summary()] == [3, 4]
