"""The port's object-detection family (analytics_zoo_tpu_torch/models/image/
objectdetection) against the JAX package's, on the CPU, f32 (the port turns
TF32 off on import), weights carried through ``objectdetection.interop``:

* priors bit-identical; ``iou_matrix``/``encode_boxes``/``decode_boxes``
  within 1e-6;
* the SSD forward (``ssd_tiny`` at 64 px, ``ssd_300(base_width=8)`` at
  300 px: the whole 8,732-prior ladder) within 1e-5 of the largest output
  in eval mode and 1e-4 in train mode (batch statistics of 2 images), the
  BatchNorm running statistics after the train step within 1e-5. Control:
  torch's symmetric ``padding=1`` on the stride-2 convs must miss;
* ``decode_detections`` on seeded loc/conf, near-tied and exactly tied
  scores: labels identical, scores and boxes within 1e-4; padded (zero)
  candidates never reach the output, in whatever order they come;
* ``multibox_loss`` value within 1e-6 relative and gradients within 1e-6 of
  each one's largest, with GTs that share a best prior (the later GT
  wins, as JAX's scatter on the CPU);
* two ``ObjectDetector.fit`` steps (Adam) against the JAX detector's:
  epoch loss within 1e-5 relative, parameters within 1e-5 relative plus
  1e-5 absolute (1% of one Adam step); ``predict_image_set`` after it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.image import objectdetection as jod
from analytics_zoo_tpu.models.image.objectdetection import ssd as jssd
from analytics_zoo_tpu_torch.models.image import objectdetection as tod
from analytics_zoo_tpu_torch.models.image.objectdetection import ssd as tssd

TOL_EVAL = 1e-5        # relative to the largest |loc| / |conf|
TOL_TRAIN = 1e-4       # train mode: batch statistics over 2 images
TOL_STATS = 1e-5       # relative to each statistic's largest
TOL_DET = 1e-4         # scores and normalized box coordinates


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _images(n, size, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def _toy_detection_data(n=16, size=64, seed=0):
    """Images with one bright square; gt box around it, label 1 (the JAX
    package's tests/test_objectdetection.py data)."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(n, size, size, 3).astype(np.float32) * 0.1
    boxes, labels = [], []
    for i in range(n):
        s = rng.randint(size // 4, size // 2)
        x = rng.randint(0, size - s)
        y = rng.randint(0, size - s)
        imgs[i, y:y + s, x:x + s] += 0.8
        boxes.append(np.asarray([[x / size, y / size,
                                  (x + s) / size, (y + s) / size]]))
        labels.append(np.asarray([1]))
    return imgs, boxes, labels


# --- priors and boxes --------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.ssd_tiny(3, 64), lambda m: m.ssd_tiny(4, 128),
    lambda m: m.ssd_300(21)], ids=["tiny64", "tiny128", "ssd300"])
def test_priors_bit_identical(make):
    jp, tp = make(jssd).priors(), make(tssd).priors()
    assert jp.dtype == tp.dtype == np.float32
    assert jp.tobytes() == tp.tobytes()
    assert tp.shape[0] in (320, 1280, 8732)


def test_box_ops_match_jax():
    rng = np.random.RandomState(1)
    priors = jod.generate_priors(64, jod.tiny_specs(64))
    gt = rng.rand(priors.shape[0], 4).astype(np.float32)
    gt = np.sort(gt.reshape(-1, 2, 2), axis=1).reshape(-1, 4)
    gt[:, 2:] = np.maximum(gt[:, 2:], gt[:, :2] + 0.05)
    jpc = np.asarray(jod.center_to_corner(jnp.asarray(priors)))
    tpc = tod.center_to_corner(_t(priors)).numpy()
    np.testing.assert_allclose(tpc, jpc, atol=1e-7)
    np.testing.assert_allclose(tod.corner_to_center(_t(gt)).numpy(),
                               np.asarray(jod.corner_to_center(gt)),
                               atol=1e-7)
    np.testing.assert_allclose(
        tod.iou_matrix(_t(gt[:7]), _t(jpc)).numpy(),
        np.asarray(jod.iou_matrix(jnp.asarray(gt[:7]), jnp.asarray(jpc))),
        atol=1e-6)
    jenc = np.asarray(jod.encode_boxes(jnp.asarray(gt), jnp.asarray(priors)))
    tenc = tod.encode_boxes(_t(gt), _t(priors)).numpy()
    np.testing.assert_allclose(tenc, jenc, atol=1e-5, rtol=1e-6)
    loc = rng.randn(3, priors.shape[0], 4).astype(np.float32)
    np.testing.assert_allclose(
        tod.decode_boxes(_t(loc), _t(priors)).numpy(),
        np.asarray(jod.decode_boxes(jnp.asarray(loc), jnp.asarray(priors))),
        atol=1e-6)


# --- the SSD forward ---------------------------------------------------------

_NETS = {"tiny64": (lambda m: m.ssd_tiny(3, 64), 64),
         "ssd300_w8": (lambda m: m.ssd_300(21, base_width=8), 300)}
_VARS = {}


def _bridged(name):
    """(flax module, its variables with perturbed statistics, the port's
    SSD holding them), built once per net (flax's init of the 300 px
    ladder takes seconds)."""
    make, size = _NETS[name]
    jm, tm = make(jssd), make(tssd)
    if name not in _VARS:
        v = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                   _images(1, size)))
        rng = np.random.RandomState(5)
        stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + rng.rand(*np.shape(a)).astype(
                np.float32) * 0.5, v["batch_stats"])
        _VARS[name] = {"params": v["params"], "batch_stats": stats}
    tod.load_flax_ssd(tm, _VARS[name])
    return jm, _VARS[name], tm


@pytest.mark.parametrize("name", list(_NETS))
def test_ssd_forward_matches_flax(name, monkeypatch):
    jm, v, tm = _bridged(name)
    size = _NETS[name][1]
    x = _images(2, size, seed=3)
    # eval: running statistics
    jl, jc = jm.apply(v, x)
    tm.eval()
    with torch.no_grad():
        tl, tc = tm(_t(x))
    assert tl.shape == (2, tm.priors().shape[0], 4) and tl.dtype == \
        torch.float32
    assert _rel(tl, jl) <= TOL_EVAL and _rel(tc, jc) <= TOL_EVAL
    # train: batch statistics, and the running-statistics update
    (jl2, jc2), upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
    tm.train()
    tl2, tc2 = tm(_t(x))
    assert _rel(tl2.detach(), jl2) <= TOL_TRAIN
    assert _rel(tc2.detach(), jc2) <= TOL_TRAIN
    got = tod.ssd_to_flax(tm)["batch_stats"]
    want = jax.device_get(upd["batch_stats"])
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert _rel(a, b) <= TOL_STATS
    # control: torch's symmetric padding=1 (flax pads 300->150, 150->75,
    # 64->32 ... as (0, 1)) misses the limit
    monkeypatch.setattr(tssd, "same_pads", lambda n, k, s: (k // 2,
                                                            k // 2))
    tm.eval()
    with torch.no_grad():
        cl, cc = tm(_t(x))
    assert cl.shape == tl.shape
    assert _rel(cl, jl) > 10 * TOL_EVAL and _rel(cc, jc) > 10 * TOL_EVAL


def test_ssd_interop_round_trip_and_names():
    jm, v, tm = _bridged("ssd300_w8")
    back = tod.ssd_to_flax(tm)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    names = {k.split(".")[0] for k in tm.state_dict()}
    assert {"stem", "BatchNorm_0", "down8", "BatchNorm_9", "loc38",
            "conf1"} <= names
    # the 3 -> 2 conv runs though no head taps it
    assert "down7" in names and "loc2" not in names


def test_ssd_bf16_input_runs_bf16_trunk():
    tm = tssd.ssd_tiny(3, 64)
    seen = []
    tm.down0.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    loc, conf = tm.eval()(_t(_images(1, 64)).to(torch.bfloat16))
    assert seen == [torch.bfloat16]
    assert loc.dtype == conf.dtype == torch.float32


# --- decode + NMS -------------------------------------------------------------

def _decode_both(loc, conf, priors, **kw):
    j = np.asarray(jod.decode_detections(jnp.asarray(loc), jnp.asarray(conf),
                                         priors, **kw))
    t = tod.decode_detections(_t(loc), _t(conf), priors, **kw).numpy()
    return j, t


def _assert_dets_equal(t, j):
    assert t.shape == j.shape
    np.testing.assert_array_equal(t[..., 0], j[..., 0])
    np.testing.assert_allclose(t[..., 1:], j[..., 1:], atol=TOL_DET)


@pytest.mark.parametrize("case", ["random", "near_tied", "exact_tied"])
def test_decode_detections_matches_jax(case):
    priors = jod.generate_priors(64, jod.tiny_specs(64))
    a = priors.shape[0]
    rng = np.random.RandomState(2)
    loc = rng.randn(4, a, 4).astype(np.float32) * 0.5
    conf = rng.randn(4, a, 4).astype(np.float32) * 2
    if case == "near_tied":
        # pairs of candidates 1e-4 apart in logit, overlapping boxes
        conf[:, 1::2] = conf[:, 0::2] + 1e-4
        loc[:, 1::2] = loc[:, 0::2]
    elif case == "exact_tied":
        conf = np.zeros_like(conf)
        conf[..., 0] = 3.0
        conf[:, ::7, 1] = 5.0
        conf[:, ::11, 3] = 5.0
    j, t = _decode_both(loc, conf, priors, max_detections=50)
    assert (t[..., 0] > 0).sum() > 40
    _assert_dets_equal(t, j)
    # padded rows: label -1, score 0
    pad = t[..., 0] < 0
    assert np.all(t[pad][:, 1:] == 0)


def test_padded_candidates_never_reach_output():
    """Zero scores tie; whatever order they come in (torch.topk promises
    none on CUDA), NMS starts from ``keep = score > 0``, so the output is
    the same for every permutation of the zero-score candidates."""
    rng = np.random.RandomState(4)
    k = 64
    boxes = np.sort(rng.rand(k, 2, 2).astype(np.float32), 1).reshape(k, 4)
    scores = np.zeros(k, np.float32)
    scores[:10] = np.sort(rng.rand(10).astype(np.float32))[::-1] + 0.1
    keep0, order0 = tod.nms(_t(boxes), _t(scores), 0.45, 20)
    kept0 = set(order0[keep0].tolist())
    assert kept0 <= set(range(10)) and kept0
    for seed in range(5):
        perm = np.concatenate([np.arange(10), 10 + np.random.RandomState(
            seed).permutation(k - 10)])
        keep, order = tod.nms(_t(boxes[perm]), _t(scores[perm]), 0.45, 20)
        assert set(perm[order[keep].numpy()].tolist()) == kept0
    # and JAX's nms keeps the same boxes
    jkeep, jorder = jod.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                            20)
    assert set(np.asarray(jorder)[np.asarray(jkeep)].tolist()) == kept0


# --- multibox loss -----------------------------------------------------------

def _targets(b, m, num_classes, seed):
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, m, 5), np.float32)
    for i in range(b):
        for j in range(rng.randint(1, m)):
            x1, y1 = rng.rand(2) * 0.6
            w, h = rng.rand(2) * 0.3 + 0.05
            gt[i, j] = [x1, y1, x1 + w, y1 + h, rng.randint(1, num_classes)]
    return gt


def test_match_priors_shared_best_prior_matches_jax():
    priors = jod.generate_priors(64, jod.tiny_specs(64))
    pc = np.asarray(jod.center_to_corner(jnp.asarray(priors)))
    gt = np.zeros((4, 4), np.float32)
    labels = np.array([1, 2, 3, 0], np.int32)
    gt[0] = gt[1] = pc[5]
    gt[2] = pc[5] * 0.98 + 0.001          # a third claimant of prior 5
    jl, jb = jod.match_priors(jnp.asarray(gt), jnp.asarray(labels),
                              jnp.asarray(pc))
    tl, tb = tod.match_priors(_t(gt), _t(labels), _t(pc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert int(tl[5]) == 3                # the last claimant wins


def test_multibox_loss_and_grads_match_jax():
    priors = jod.generate_priors(64, jod.tiny_specs(64))
    a, c = priors.shape[0], 4
    rng = np.random.RandomState(6)
    loc = rng.randn(4, a, 4).astype(np.float32) * 0.5
    conf = rng.randn(4, a, c).astype(np.float32) * 2
    gt = _targets(4, 5, c, seed=7)
    gt[0, 1] = gt[0, 0]                   # two GTs share a best prior
    gt[0, 1, 4] = 1 + gt[0, 0, 4] % (c - 1)
    jfn = jod.multibox_loss(priors)

    def jloss(l, cf):
        return jfn(jnp.asarray(gt), (l, cf)).sum()

    jv, (jgl, jgc) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(loc), jnp.asarray(conf))
    tl, tc = _t(loc).requires_grad_(), _t(conf).requires_grad_()
    per = tod.multibox_loss(priors)(_t(gt), (tl, tc))
    assert per.shape == (4,)
    per.sum().backward()
    assert abs(float(per.sum().detach()) - float(jv)) <= \
        1e-6 * abs(float(jv))
    assert _rel(tl.grad, jgl) <= 1e-6 and _rel(tc.grad, jgc) <= 1e-6
    # the (boxes, labels) tuple form gives the packed form's value
    per2 = tod.multibox_loss(priors)((_t(gt[..., :4]), _t(gt[..., 4])),
                                     (tl, tc))
    np.testing.assert_array_equal(per2.detach().numpy(),
                                  per.detach().numpy())


# --- the detector ------------------------------------------------------------

def _jax_detector(**kw):
    det = jod.ObjectDetector(class_names=("square",), image_size=64,
                             model_type="ssd_tiny", max_gt=4, **kw)
    det.compile(optimizer="adam")
    det.estimator.engine.build((np.zeros((1, 64, 64, 3), np.float32),))
    return det


def _port_detector(jdet):
    det = tod.ObjectDetector(class_names=("square",), image_size=64,
                             model_type="ssd_tiny", max_gt=4, device="cpu")
    eng = jdet.estimator.engine
    tod.load_flax_ssd(det.module, {"params": eng.params,
                                   "batch_stats":
                                       eng.extra_vars["batch_stats"]})
    det.compile(optimizer="adam")
    return det


def test_detector_fit_two_steps_matches_jax(orca_context):
    imgs, boxes, labels = _toy_detection_data(n=16)
    y = jod.ObjectDetector.pack_targets(boxes, labels, max_gt=4)
    np.testing.assert_array_equal(
        tod.ObjectDetector.pack_targets(boxes, labels, max_gt=4), y)
    jdet = _jax_detector()
    tdet = _port_detector(jdet)
    jst = jdet.fit({"x": imgs, "y": y}, batch_size=8, epochs=1,
                   shuffle=False, verbose=False)
    tst = tdet.fit({"x": imgs, "y": y}, batch_size=8, epochs=1,
                   shuffle=False, verbose=False)
    assert tdet.estimator.engine.step == 2
    np.testing.assert_allclose(tst[-1]["train_loss"], jst[-1]["train_loss"],
                               rtol=1e-5)
    eng = jdet.estimator.engine
    want = tod.ObjectDetector(class_names=("square",), image_size=64,
                              model_type="ssd_tiny", device="cpu")
    tod.load_flax_ssd(want.module, {"params": eng.params,
                                    "batch_stats":
                                        eng.extra_vars["batch_stats"]})
    got_sd, want_sd = tdet.module.state_dict(), want.module.state_dict()
    for k in want_sd:
        # atol: 1% of one Adam step (lr 1e-3): an entry whose gradient is
        # near 0 moves by about sign(grad) * lr, and its gradient's
        # rounding decides how far
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # predictions after training: the JAX detector's
    j = jdet.predict_image_set(imgs[:4], max_detections=10)
    t = tdet.predict_image_set(imgs[:4], max_detections=10)
    assert t.shape == (4, 10, 6)
    np.testing.assert_array_equal(t[..., 0], j[..., 0])
    np.testing.assert_allclose(t[..., 1:], j[..., 1:], atol=TOL_DET * 64)


def test_detector_save_load_and_surface(tmp_path):
    imgs, boxes, labels = _toy_detection_data(n=8)
    det = tod.ObjectDetector(class_names=("square",), image_size=64,
                             model_type="ssd_tiny", max_gt=4, device="cpu")
    det.compile()
    y = det.pack_targets(boxes, labels, max_gt=4)
    det.fit({"x": imgs, "y": y}, batch_size=8, epochs=1, verbose=False)
    p1 = det.predict_image_set(imgs[:2], max_detections=5)
    path = str(tmp_path / "det.pt")
    det.save_model(path)
    with pytest.raises(FileExistsError):
        det.save_model(path)
    det2 = tod.ObjectDetector.load_model(path, device="cpu")
    np.testing.assert_array_equal(
        det2.predict_image_set(imgs[:2], max_detections=5), p1)
    res = det.evaluate_map(imgs, boxes, labels)
    assert 0.0 <= res["mAP"] <= 1.0
    with pytest.raises(NotImplementedError, match="A8"):
        det.predict_image_set(object())
    with pytest.raises(NotImplementedError):
        tod.ObjectDetector(model_type="ssd_mobilenet_v2", device="cpu")
    assert tod.read_pascal_label_map() == jod.read_pascal_label_map()
    assert tod.read_coco_label_map() == jod.read_coco_label_map()
    img = np.zeros((32, 32, 3), np.uint8)
    dets = np.asarray([[1, 0.9, 4, 4, 20, 20], [-1, 0.0, 0, 0, 0, 0]])
    np.testing.assert_array_equal(
        tod.Visualizer(("square",), thresh=0.5).visualize(img, dets),
        jod.Visualizer(("square",), thresh=0.5).visualize(img, dets))


def test_voc_map_matches_jax():
    rng = np.random.RandomState(9)
    gts = [rng.rand(3, 4).astype(np.float32) * 50 for _ in range(4)]
    gts = [np.concatenate([g[:, :2], g[:, :2] + 10], 1) for g in gts]
    gl = [rng.randint(1, 3, 3) for _ in range(4)]
    dets = [np.concatenate([rng.randint(1, 3, (5, 1)), rng.rand(5, 1),
                            np.concatenate([g[:, :2] + rng.rand(3, 2),
                                            g[:, 2:]], 1).repeat(2, 0)[:5]],
                           1).astype(np.float32) for g in gts]
    for m07 in (False, True):
        assert tod.voc_detection_map(dets, gts, gl, 3, use_07_metric=m07) \
            == jod.voc_detection_map(dets, gts, gl, 3, use_07_metric=m07)
