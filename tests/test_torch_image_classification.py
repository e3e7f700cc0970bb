"""The port's image-classification families, Inception-V1, SSD-MobileNetV2
and ``ImageClassifier`` (analytics_zoo_tpu_torch/models/image/
imageclassification, objectdetection/ssd.py) against the JAX package's,
on the CPU, TF32 off and weights bridged through ``interop``.

* Each module (AlexNet, VGG-16, VGG-19, MobileNet-V1, MobileNet-V2,
  SqueezeNet, DenseNet-121, Inception-V1 at 32-64 px and 3 classes, the
  port's weights with every bias, scale and statistic moved off its init)
  against flax's f32: the evaluation forward within ``TOL_OUT``, a
  train-mode forward (loss, output, BatchNorm statistics, dropout at rate
  0 on both sides) within ``TOL_TRAIN_F32``, the f32 gradients of the nets
  without BatchNorm; the state maps onto the flax tree that flax applied.
  f32 gradients through train-mode BatchNorm at 4 images are decided by
  rounding (flax's own stray from its float64 ones by up to 54 % on this
  host), so the BatchNorm blocks (DenseNet's dense block, MobileNet-V2's
  inverted residuals, Inception-V1's block) take a train step in float64
  on both sides, gradients included, within ``TOL_F64``.
  SSD-MobileNetV2: the evaluation forward and its multibox loss.
* The slice as a whole: ``ImageSet.read`` of a PNG directory ->
  transforms -> ``to_dataset`` -> ``ImageClassifier("mobilenet-v2",
  compute_dtype=f32).fit``, 2 epochs of Adam in both packages from the
  same weights (``test_imageset_to_classifier_fit_matches_jax`` states
  its limits and control), then ``predict_image_set(..., top_k=2)``.
* ``ObjectDetector(model_type="ssd_mobilenet_v2")`` on an ImageSet;
  ``ImageClassifier`` config errors, save/load round trip,
  ``LabelOutput`` and the reference caveat (an ``ImageSet`` raises
  ``TypeError``).
* Init statistics of every family against flax's ``lecun_normal``, with
  torch's default init as the control (R3).
"""

import dataclasses
import importlib
from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature import image as jimage
from analytics_zoo_tpu.orca.learn import losses as jlosses
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.feature import image as timage
from analytics_zoo_tpu_torch.orca.learn import losses as tlosses

jfam = importlib.import_module(
    "analytics_zoo_tpu.models.image.imageclassification.families")
tfam = importlib.import_module(
    "analytics_zoo_tpu_torch.models.image.imageclassification.families")
jinc = importlib.import_module(
    "analytics_zoo_tpu.models.image.imageclassification.inception")
tinc = importlib.import_module(
    "analytics_zoo_tpu_torch.models.image.imageclassification.inception")
jcls = importlib.import_module(
    "analytics_zoo_tpu.models.image.imageclassification.classifier")
tcls = importlib.import_module(
    "analytics_zoo_tpu_torch.models.image.imageclassification.classifier")
jssd = importlib.import_module(
    "analytics_zoo_tpu.models.image.objectdetection.ssd")
tssd = importlib.import_module(
    "analytics_zoo_tpu_torch.models.image.objectdetection.ssd")

TOL_OUT = 1e-5          # relative to the largest output (loss relative)
# a train-mode forward in f32 (loss, output, new BatchNorm statistics),
# each relative; the f32 gradients of the nets without BatchNorm relative
# to each parameter's largest. Readings on this sandbox, which move
# between runs with the threads' reduction order: loss <= 2.2e-5, output
# <= 1.3e-4, statistics <= 2.9e-5 (MobileNet-V1/V2, Inception-V1, the
# SSD), gradients <= 1.9e-6 (AlexNet, SqueezeNet)
TOL_TRAIN_F32 = {"out": 5e-4, "stats": 1e-4, "grad": 1e-4}
# a block's train step, the port in float64 against flax in float64
TOL_F64 = {"out": 2e-6, "grad": 2e-6, "stats": 2e-7}
# the Adam fit of MobileNet-V2 (test_imageset_to_classifier_fit_matches_jax)
# at lr FIT_LR: readings (this sandbox) losses <= 1.24e-2, parameters
# 2.1e-2, top-2 confidences 1.5e-4 apart, the top-2 labels equal; the
# control (another init) >= 0.068 on the losses
FIT_LR = 1e-4
TOL_FIT = {"loss": 3e-2, "param": 5e-2, "confidence": 1e-3}
TOL_INIT = 0.05         # init std of a layer kind, port against flax
CLASSES = 3

# name: (JAX constructor, port constructor, input size). A train-mode
# BatchNorm over 4 images of 1x1 maps is ill-conditioned (both f32 runs
# then stray from a float64 run's gradients by more than 100 %), so the
# nets whose last BatchNorms would see 1x1 maps at 32 px run at 64 px.
MODELS = {
    "alexnet": (jfam.AlexNet, tfam.AlexNet, 64),
    "vgg16": (jfam.VGG16, tfam.VGG16, 32),
    "vgg19": (jfam.VGG19, tfam.VGG19, 32),
    "mobilenet": (jfam.MobileNetV1, tfam.MobileNetV1, 64),
    "mobilenet_v2": (jfam.MobileNetV2, tfam.MobileNetV2, 64),
    "squeezenet": (jfam.SqueezeNet, tfam.SqueezeNet, 32),
    "densenet121": (jfam.DenseNet121, tfam.DenseNet121, 64),
    "inception_v1": (jinc.InceptionV1, tinc.InceptionV1, 64),
}
# f32 gradients are held for the nets without BatchNorm; train-mode
# BatchNorm over 4 images makes the others' rounding-decided (flax's own
# f32 gradients stray from its float64 ones by up to 54 % on this host),
# so their layers' gradients are held in float64 on single blocks
# (test_block_train_step_matches_flax), where XLA's float64 convolutions
# (depthwise ones above all) stay cheap
NO_BATCHNORM = {"alexnet", "squeezenet"}
# the whole nets that also take an f32 train step here: the two without
# BatchNorm, and MobileNet-V2 (train-mode forward and statistics; its fit
# is the slice test's too). The others' train-mode layers are held on
# their blocks, which XLA compiles in a fraction of a whole net's time
TRAIN_STEP = NO_BATCHNORM | {"mobilenet_v2"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The port's side on two threads: the tier-1 run shares the CPU among
    six workers, and this file's convolutions are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def no_dropout(monkeypatch):
    """flax's ``Dropout`` at rate 0 for the test (the JAX families fix
    their rates in the code)."""
    real = fnn.Dropout
    monkeypatch.setattr(fnn, "Dropout",
                        lambda rate, *a, **kw: real(0.0, *a, **kw))


def _zero_dropout(module):
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


def _pair(name):
    jcls_, tcls_, size = MODELS[name]
    return (jcls_(num_classes=CLASSES, compute_dtype=jnp.float32),
            tcls_(num_classes=CLASSES, compute_dtype=torch.float32), size)


def _images(n, size, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (n, size, size, 3)).astype(np.float32),
            rng.randint(0, CLASSES, n).astype(np.int32))


def _variables(tm, x, seed=1):
    """The port module's weights as flax variables, every leaf but the
    (random) kernels moved off its init so that zero biases, unit scales
    and the initial statistics hide nothing; ``tm`` takes the moved
    values too. (Built from the port's init, not flax's: flax's jitted
    init of the deep nets costs as much as their train step.)"""
    with torch.no_grad():
        tm.eval()(torch.from_numpy(x[:1]))      # lazy widths
    rng = np.random.RandomState(seed)
    sd = {}
    for n, t in tm.state_dict().items():
        a = t.numpy().copy()
        if not n.endswith("weight") or a.ndim == 1:
            step = rng.normal(0, 0.05, a.shape).astype(np.float32)
            scaled = n.endswith(("running_var", "weight"))
            a = a + (np.abs(step) if scaled else step)
        sd[n] = torch.from_numpy(a)
    tm.load_state_dict(sd)
    v = {"params": interop.state_dict_to_flax(sd, tm)}
    stats = interop.state_dict_to_batch_stats(sd)
    return {**v, "batch_stats": stats} if stats else v


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _bridge(tm, v):
    tm.eval()
    with torch.no_grad():       # lazy widths (AlexNet, VGG) take theirs
        interop.load_flax_params(tm, {"params": v["params"],
                                      **({"batch_stats": v["batch_stats"]}
                                         if "batch_stats" in v else {})})
    return tm


def _jax_f32(jm, v, xs, y, train=False):
    """flax in f32, in one jitted call: the evaluation output of each of
    ``xs``; and (``train``) a train-mode forward on ``xs[0]`` with the
    loss's gradients: (loss, output, new statistics, gradients)."""
    stats = v.get("batch_stats", {})

    def loss_of(params):
        out, new = jm.apply({"params": params, "batch_stats": stats}, xs[0],
                            train=True, mutable=["batch_stats"])
        loss = jlosses.sparse_categorical_crossentropy(
            y, out, from_logits=True).mean()
        return loss, (out, new.get("batch_stats", {}))

    def run(v):
        evaluated = [jm.apply(v, x) for x in xs]
        if not train:
            return evaluated, (0.0, None, None, None)
        (loss, (out, new)), g = jax.value_and_grad(
            loss_of, has_aux=True)(v["params"])
        return evaluated, (loss, out, new, g)

    evaluated, (loss, out, new, g) = jax.device_get(jax.jit(run)(v))
    return [np.asarray(e) for e in evaluated], float(loss), out, new, g


def _port_step(tm, x, y):
    tm.train()
    tm.zero_grad(set_to_none=True)
    out = tm(torch.from_numpy(x))
    loss = tlosses.sparse_categorical_crossentropy(
        torch.from_numpy(y).long(), out, from_logits=True).mean()
    loss.backward()
    return float(loss.detach()), out.detach().numpy()


def _grad_rel(tm, jgrads) -> float:
    """Each parameter's gradient error relative to its largest entry, or
    to 1e-3 of the model's largest gradient where that is larger: a
    gradient that is 0 in exact arithmetic (a BatchNorm bias whose shift
    the next train-mode BatchNorm takes out again) holds rounding only."""
    want = interop.flax_to_state_dict(jgrads)
    got = {n: p.grad.double().numpy() for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    return max(float(np.abs(got[n] - want[n].numpy()).max()
                     / max(np.abs(want[n].numpy()).max(), 1e-3 * top))
               for n in want)


def _stats_rel(tm, jstats) -> float:
    stats = _flat(interop.state_dict_to_batch_stats(tm.state_dict()))
    want = _flat(jstats)
    assert set(stats) == set(want)
    return max([_rel(stats[k], want[k]) for k in want] or [0.0])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_family_matches_flax(name, no_dropout):
    """The f32 evaluation forward (Inception-V1 on a uint8 batch too,
    normalised inside the model) against flax's f32; for ``TRAIN_STEP``'s
    nets a train step (loss, output, BatchNorm statistics; the gradients
    of the nets without BatchNorm); the state maps onto the flax tree that
    flax applied."""
    jm, tm, size = _pair(name)
    x, y = _images(4, size)
    v = _variables(tm, x)
    _zero_dropout(tm)
    xs = [x]
    if name == "inception_v1":
        xs.append(np.random.RandomState(2).randint(
            0, 256, x.shape).astype(np.uint8))
    train = name in TRAIN_STEP
    evaluated, jloss, jout, jstats, jgrads = _jax_f32(jm, v, xs, y, train)
    for xe, want in zip(xs, evaluated):
        with torch.no_grad():
            got = tm.eval()(torch.from_numpy(xe)).numpy()
        assert got.shape == want.shape == (4, CLASSES)
        assert _rel(got, want) <= TOL_OUT
    if train:
        tloss, tout = _port_step(tm, x, y)
        assert abs(tloss - jloss) <= TOL_TRAIN_F32["out"] * abs(jloss)
        assert _rel(tout, jout) <= TOL_TRAIN_F32["out"]
        if jstats:
            assert _stats_rel(tm, jstats) <= TOL_TRAIN_F32["stats"]
        if name in NO_BATCHNORM:
            assert _grad_rel(tm, jgrads) <= TOL_TRAIN_F32["grad"]
    # the state maps back onto the flax tree flax applied, leaf for leaf
    sd = tm.state_dict()
    assert {k: a.shape for k, a in _flat(
        interop.state_dict_to_flax(sd, tm)).items()} == \
        {k: a.shape for k, a in _flat(v["params"]).items()}


def _blocks():
    """name -> (flax block computing in float64, port block in float64,
    input channels, output channels); small widths, 8 px maps."""
    f64 = jnp.float64
    conv = partial(fnn.Conv, dtype=f64, param_dtype=jnp.float32)
    norm = partial(fnn.BatchNorm, use_running_average=False, momentum=0.9,
                   epsilon=1e-3, dtype=f64, param_dtype=jnp.float32)
    t64 = torch.float64
    return {
        "dense_block": (lambda: jfam._DenseBlock(3, 8, f64),
                        lambda: tfam._DenseBlock(16, 3, 8, t64), 16, 40),
        "inverted_residual_s2": (
            lambda: jfam._InvertedResidual(24, 2, 6, f64),
            lambda: tfam._InvertedResidual(16, 24, 2, 6, t64), 16, 24),
        "inverted_residual_s1": (
            lambda: jfam._InvertedResidual(16, 1, 6, f64),
            lambda: tfam._InvertedResidual(16, 16, 1, 6, t64), 16, 16),
        "inception_block": (
            lambda: jinc.InceptionBlock(8, (8, 12), (4, 6), 4, conv=conv,
                                        norm=norm),
            lambda: tinc.InceptionBlock(16, 8, (8, 12), (4, 6), 4, t64),
            16, 30),
    }


@pytest.mark.parametrize("block", ["dense_block", "inverted_residual_s2",
                                   "inverted_residual_s1",
                                   "inception_block"])
def test_block_train_step_matches_flax(block):
    """A train step of the families' BatchNorm blocks in float64 on both
    sides: DenseNet's dense block (BatchNorm at flax's default momentum
    0.99, pre-activation convs, concatenation), MobileNet-V2's inverted
    residual (1x1 expand, 3x3 depthwise, strided and residual, relu6) and
    Inception-V1's block (SAME -inf max pool): output, every gradient,
    the new statistics."""
    jctor, tctor, cin, cout = _blocks()[block]
    x = np.random.RandomState(4).normal(0, 1, (4, 8, 8, cin)).astype(
        np.float32)
    tm = tctor()
    with torch.no_grad():
        sd = {n: t + (torch.rand_like(t) * 0.1 if t.dim() == 1 else 0)
              for n, t in tm.state_dict().items()}
    tm.load_state_dict(sd)
    v = {"params": interop.state_dict_to_flax(sd, tm),
         "batch_stats": interop.state_dict_to_batch_stats(sd)}
    with jax.enable_x64(True):
        jm = jctor()
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        x64 = x.astype(np.float64)
        kw = {} if block == "inception_block" else {"train": True}
        out_shape = jax.eval_shape(
            lambda: jm.apply(v64, x64, mutable=["batch_stats"], **kw)[0])
        g = np.random.RandomState(5).normal(0, 1, out_shape.shape)
        assert out_shape.shape[-1] == cout

        def loss_of(params):
            out, new = jm.apply({"params": params,
                                 "batch_stats": v64["batch_stats"]}, x64,
                                mutable=["batch_stats"], **kw)
            return (out * g).sum(), (out, new["batch_stats"])

        (_, (jout, jstats)), jgrads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_of, has_aux=True))(v64["params"]))
    tm = tm.double().train()
    out = tm(torch.from_numpy(x64).permute(0, 3, 1, 2))
    (out.permute(0, 2, 3, 1) * torch.from_numpy(g)).sum().backward()
    assert _rel(out.detach().permute(0, 2, 3, 1).numpy(), jout) <= \
        TOL_F64["out"]
    assert _grad_rel(tm, jgrads) <= TOL_F64["grad"]
    assert _stats_rel(tm, jstats) <= TOL_F64["stats"]


def test_ssd_mobilenet_v2_matches_flax():
    """The f32 evaluation forward, and a train-mode forward through each
    package's multibox loss (loss, new BatchNorm statistics), against
    flax's f32 (its backbone's gradients: the block test)."""
    from analytics_zoo_tpu.models.image.objectdetection import loss as jl
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        loss as tl
    jm = jssd.SSDMobileNetV2(num_classes=CLASSES, image_size=64)
    tm = tssd.SSDMobileNetV2(num_classes=CLASSES, image_size=64)
    x, _ = _images(8, 64, seed=3)
    v = _variables(tm, x)
    np.testing.assert_array_equal(tm.priors(), jm.priors())
    assert [s.fm_size for s in tssd.ssd_mobilenet_specs(300)] == \
        [19, 10, 5, 3, 2, 1]
    assert [dataclasses.astuple(s) for s in tssd.ssd_mobilenet_specs(300)] \
        == [dataclasses.astuple(s) for s in jssd.ssd_mobilenet_specs(300)]
    boxes = np.array([[[0.1, 0.1, 0.6, 0.5, 1], [0.5, 0.4, 0.9, 0.95, 2]]] *
                     8, np.float32)
    priors = jm.priors()

    def run(v):
        out, new = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return jm.apply(v, x), jl.multibox_loss(priors)(
            jnp.asarray(boxes), out).mean(), new["batch_stats"]

    (jloc, jconf), jloss, jstats = jax.device_get(jax.jit(run)(v))
    with torch.no_grad():
        tloc, tconf = tm.eval()(torch.from_numpy(x))
        assert _rel(tloc, jloc) <= TOL_OUT and _rel(tconf, jconf) <= TOL_OUT
        tloss = tl.multibox_loss(priors)(torch.from_numpy(boxes),
                                         tm.train()(torch.from_numpy(x)))
    assert abs(float(tloss.mean()) - float(jloss)) <= \
        TOL_TRAIN_F32["out"] * abs(float(jloss))
    assert _stats_rel(tm, jstats) <= TOL_TRAIN_F32["stats"]


def test_object_detector_mobilenet_predicts_an_image_set(tmp_path):
    """``model_type="ssd_mobilenet_v2"`` builds the model, and
    ``predict_image_set`` takes an ImageSet as it takes the stacked
    array (JAX ``detector.py:117-121``)."""
    import cv2

    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        ObjectDetector
    rng = np.random.RandomState(6)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i}.png"),
                    rng.randint(0, 255, (128, 128, 3), dtype=np.uint8))
    iset = timage.ImageSet.read(str(tmp_path), device="cpu").transform(
        timage.ImageMatToTensor())
    det = ObjectDetector(("a", "b"), image_size=128,
                         model_type="ssd_mobilenet_v2", device="cpu")
    assert isinstance(det.module, tssd.SSDMobileNetV2)
    np.testing.assert_array_equal(
        det.priors, jssd.SSDMobileNetV2(num_classes=3,
                                        image_size=128).priors())
    got = det.predict_image_set(iset, max_detections=10)
    want = det.predict_image_set(np.stack(iset.get_image()),
                                 max_detections=10)
    assert got.shape == (3, 10, 6)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="A9"):
        det.as_inference_model()


# --- the slice as a whole ------------------------------------------------------
@pytest.fixture
def png_dir(tmp_path):
    import cv2
    rng = np.random.RandomState(0)
    for ci, cls in enumerate(("cat", "dog")):
        d = tmp_path / cls
        d.mkdir()
        for i in range(8):
            img = np.full((40, 50, 3), 60 * ci, np.uint8) + rng.randint(
                0, 90, (40, 50, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"{i}.png"), img)
    return str(tmp_path)


def _record(engine, into):
    """Wrap ``engine.train_batch`` to keep each step's images, labels and
    loss."""
    inner = engine.train_batch

    def train_batch(batch):
        loss = inner(batch)
        into.append((np.asarray(batch.x[0]).copy(),
                     np.asarray(batch.y[0]).copy(), float(loss)))
        return loss

    engine.train_batch = train_batch


def _fit_pair(png_dir, bridge=True, seed=0):
    """The port's fit (its init drawn from ``seed``) and, with ``bridge``,
    the JAX package's fit from the same weights."""
    from analytics_zoo_tpu.orca.learn.optimizers import \
        optimizers_impl as jopt
    from analytics_zoo_tpu_torch.orca.learn.optimizers import \
        optimizers_impl as topt
    pipe = [mod.ImageResize(64, 64) | mod.ImageChannelNormalize(
        127.5, 127.5, 127.5, 64.0, 64.0, 64.0) for mod in (jimage, timage)]
    tset = timage.ImageSet.read(png_dir, with_label=True,
                                one_based_label=False,
                                device="cpu").transform(pipe[1])
    torch.manual_seed(seed)
    tclf = tcls.ImageClassifier("mobilenet-v2", num_classes=CLASSES,
                                compute_dtype=torch.float32, device="cpu")
    tclf.compile(optimizer=topt.Adam(lr=FIT_LR),
                 config={"steps_per_dispatch": 1})
    steps = {"port": []}
    _record(tclf.estimator.engine, steps["port"])
    jclf = None
    if bridge:
        jds = jimage.ImageSet.read(png_dir, with_label=True,
                                   one_based_label=False).transform(
            pipe[0]).to_dataset()
        jclf = jcls.ImageClassifier("mobilenet-v2", num_classes=CLASSES,
                                    compute_dtype=jnp.float32)
        jclf.compile(optimizer=jopt.Adam(lr=FIT_LR),
                     config={"steps_per_dispatch": 1})
        jeng = jclf.estimator.engine
        # the JAX engine starts from the port's weights: its build takes
        # them in place of flax's init (whose compile costs ~11 s here)
        sd = tclf.module.state_dict()
        start = {"params": interop.state_dict_to_flax(sd, tclf.module),
                 "batch_stats": interop.state_dict_to_batch_stats(sd)}
        jeng._init_vars = lambda rng, small: start
        jeng.build((np.zeros((1, 64, 64, 3), np.float32),))
        steps["jax"] = []
        _record(jeng, steps["jax"])
        # batch 8: the JAX batch divides over its 8-device test mesh
        jclf.fit(jds, epochs=2, batch_size=8, verbose=False)
    tclf.fit(tset.to_dataset(), epochs=2, batch_size=8, verbose=False)
    return tset, tclf, jclf, steps


def test_imageset_to_classifier_fit_matches_jax(orca_context, png_dir,
                                                tmp_path):
    """ImageSet.read -> transforms -> to_dataset -> ImageClassifier(
    "mobilenet-v2").fit, 2 epochs of Adam at 64 px in both packages from
    the same weights: every step's batch bit for bit, the first step's loss
    within TOL_OUT, every loss within TOL_FIT["loss"], the final
    parameters and statistics within TOL_FIT["param"] (``_param_rel``),
    the same top-2 labels from ``predict_image_set``. The later steps
    differ by more than rounding: f32 train-mode BatchNorm over 8 images
    makes the gradients rounding-sensitive (see the family test) and Adam
    takes a step of size ~lr on any gradient, however small, so BatchNorm
    biases that the next train-mode BatchNorm cancels (gradient 0 in exact
    arithmetic) move by rounding. Control: the port's fit from another
    draw of its init misses the loss limit."""
    tset, tclf, jclf, steps = _fit_pair(png_dir)
    assert len(steps["port"]) == len(steps["jax"]) == 4
    for (tx, ty, _), (jx, jy, _) in zip(steps["port"], steps["jax"]):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty.reshape(-1), jy.reshape(-1))
    tl = np.array([loss for _, _, loss in steps["port"]])
    jl = np.array([loss for _, _, loss in steps["jax"]])
    assert abs(tl[0] - jl[0]) <= TOL_OUT * abs(jl[0])
    assert np.abs(tl / jl - 1).max() <= TOL_FIT["loss"]
    jeng = jclf.estimator.engine
    assert _param_rel(tclf.module.state_dict(), interop.flax_to_state_dict(
        jax.device_get({"params": jeng.params, **jeng.extra_vars}))) <= \
        TOL_FIT["param"]
    # Adam's state through interop: the port's in the JAX form (count,
    # shapes of mu and nu) and back bit for bit
    template = jax.device_get(jeng.opt_state)
    state = tclf.estimator.engine.get_state()
    as_jax = interop.state_to_jax(state, template)
    jadam = interop._find(template, ("ScaleByAdamState",))
    tadam = interop._find(as_jax["opt_state"], ("ScaleByAdamState",))
    assert int(tadam.count) == int(jadam.count) == 4
    for field in ("mu", "nu"):
        assert {k: np.shape(a) for k, a in _flat(getattr(tadam, field)
                                                  ).items()} == \
            {k: np.shape(a) for k, a in _flat(getattr(jadam, field)).items()}
    back = interop.state_from_jax(as_jax, tclf.module,
                                  tclf.estimator.engine.opt)
    for name, t in state["params"].items():
        assert back["params"][name].numpy().tobytes() == t.numpy().tobytes()
    for i, st in state["opt_state"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert back["opt_state"]["state"][i][key].numpy().tobytes() == \
                st[key].numpy().tobytes()
    # predict: the same top-2 labels from the same images
    imgs = np.stack(tset.get_image())
    jtop = jclf.predict_image_set(imgs, top_k=2)
    ttop = tclf.predict_image_set(imgs, top_k=2)
    assert [[lab for lab, _ in row] for row in ttop] == \
        [[lab for lab, _ in row] for row in jtop]
    np.testing.assert_allclose([[c for _, c in row] for row in ttop],
                               [[c for _, c in row] for row in jtop],
                               atol=TOL_FIT["confidence"])
    with pytest.raises(TypeError, match="ImageSet"):
        tclf.predict_image_set(tset)
    # save/load round trip
    path = str(tmp_path / "clf.pt")
    tclf.save_model(path)
    with pytest.raises(FileExistsError):
        tclf.save_model(path)
    loaded = tcls.ImageClassifier.load_model(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict_image_set(imgs),
                                  tclf.predict_image_set(imgs))
    assert loaded.estimator.engine.step == 4
    # control: another draw of the port's init, the same batches
    _, _, _, own = _fit_pair(png_dir, bridge=False, seed=1)
    own_l = np.array([loss for _, _, loss in own["port"]])
    assert np.abs(own_l / jl - 1).max() > TOL_FIT["loss"]


def _param_rel(got, want) -> float:
    """Each leaf's error relative to its largest entry, or to 1e-2 of the
    model's largest where that is larger (leaves that rounding moves from
    0, as the fit test says)."""
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    return max(float(np.abs(got[n].numpy() - want[n].numpy()).max()
                     / max(np.abs(want[n].numpy()).max(), 1e-2 * top))
               for n in want)


def test_classifier_config_surface():
    assert sorted(tcls.IMAGENET_TOP_CONFIGS) == \
        sorted(jcls.IMAGENET_TOP_CONFIGS)
    with pytest.raises(ValueError, match="unknown model config"):
        tcls.ImageClassifier("resnet-7", device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        tcls.ImageClassifier("squeezenet", num_classes=4,
                             device="cpu").load_caffe_weights("x.caffemodel")
    for name in ("resnet-18", "alexnet", "densenet-121"):
        clf = tcls.ImageClassifier(name, num_classes=7, device="cpu",
                                   compute_dtype=torch.float32)
        assert clf.num_classes == 7
    probs = np.array([[0.1, 0.7, 0.2], [0.5, 0.2, 0.3]], np.float32)
    for lm in ({1: "cat", 0: "dog"}, None):
        assert tcls.LabelOutput(lm, top_k=2)(probs) == \
            jcls.LabelOutput(lm, top_k=2)(probs)


# --- init statistics (R3) ------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_statistics_as_flax(name):
    """Every kernel of 4096 entries or more has the std of flax's default
    kernel initializer (``lecun_normal``) drawn for its flax shape, every
    bias is 0 and every BatchNorm scale 1; torch's default init of the
    same kernels (kaiming-uniform, a = sqrt(5)) is the control that must
    miss."""
    _, tm, size = _pair(name)
    torch.manual_seed(0)
    with torch.no_grad():
        tm.eval()(torch.from_numpy(_images(1, size)[0]))     # lazy widths
    worst, misses, kernels = 0.0, [], []
    for (n, p), (k, a) in zip(tm.named_parameters(), _flat(
            interop.state_dict_to_flax(tm.state_dict(), tm)).items()):
        if n.endswith("bias"):
            assert not p.any(), n
        elif p.dim() == 1:
            assert bool((p == 1).all()), n
        elif p.numel() >= 4096:
            # lecun_normal: a normal truncated at 2 std, rescaled to the
            # variance 1 / fan_in of the flax kernel (kh, kw, in, out)
            want = (1.0 / np.prod(a.shape[:-1])) ** 0.5
            kernels.append((a.shape, want))
            worst = max(worst, abs(float(p.std()) / want - 1))
            w = torch.empty_like(p)
            torch.nn.init.kaiming_uniform_(w, a=5 ** 0.5)
            misses.append(abs(float(w.std()) / want - 1))
    n_kernels = len(kernels)
    # the formula is flax's: one draw of its initializer for the largest
    shape, want = max(kernels, key=lambda kw: np.prod(kw[0]))
    drawn = float(np.std(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), shape, jnp.float32)))
    assert abs(drawn / want - 1) <= TOL_INIT
    assert n_kernels and worst <= TOL_INIT, worst
    assert min(misses) > TOL_INIT
