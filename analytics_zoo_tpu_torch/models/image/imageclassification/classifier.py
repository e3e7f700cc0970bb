"""ImageClassifier — the reference's image-classification model family
(counterpart of ``analytics_zoo_tpu/models/image/imageclassification/
classifier.py``; reference: pyzoo/zoo/models/image/imageclassification/
image_classifier.py: ImageClassifier.load_model(model_path) +
predict_image_set + LabelOutput, with a published config family
"<model>-<dataset>-<version>").

The config family maps names to the port's modules (inception-v1,
resnet-18/34/50/101/152, alexnet, vgg-16/19, mobilenet, mobilenet-v2,
squeezenet, densenet-121); training, evaluation and prediction run on the
port's ``TPUEstimator`` through ``ZooModel``, on ``cuda`` unless
``device="cpu"`` is given.

Two differences from the JAX class, both about what it cannot do:
``predict_image_set`` takes an array of images, as JAX's does in effect
(JAX's fails on an ``ImageSet``, which has no ``to_array``); given an
``ImageSet`` the port raises a ``TypeError`` that says so. And
``load_caffe_weights`` raises: the Caffe loader is ROADMAP queue A9's.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...common.zoo_model import ZooModel
from .inception import InceptionV1


def _resnet_factory(depth):
    def make(num_classes, **kw):
        from ..resnet import resnet
        return resnet(depth=depth, num_classes=num_classes, **kw)
    return make


def _family_factory(cls, **fixed):
    def make(num_classes, **kw):
        from . import families
        return getattr(families, cls)(num_classes=num_classes,
                                      **{**fixed, **kw})
    return make


# the reference's model-definition family ("imageclassification" configs):
# Alexnet, Inception-V1, VGG, Resnet, Densenet, Mobilenet, Squeezenet
# (docs/docs/ProgrammingGuide/image-classification.md:5)
IMAGENET_TOP_CONFIGS: Dict[str, Callable] = {
    "inception-v1": lambda num_classes, **kw: InceptionV1(
        num_classes=num_classes, **kw),
    "resnet-18": _resnet_factory(18),
    "resnet-34": _resnet_factory(34),
    "resnet-50": _resnet_factory(50),
    "resnet-101": _resnet_factory(101),
    "resnet-152": _resnet_factory(152),
    "alexnet": _family_factory("AlexNet"),
    "vgg-16": _family_factory("VGG16"),
    "vgg-19": _family_factory("VGG19"),
    "mobilenet": _family_factory("MobileNetV1"),
    "mobilenet-v2": _family_factory("MobileNetV2"),
    "squeezenet": _family_factory("SqueezeNet"),
    "densenet-121": _family_factory("DenseNet121"),
}


class LabelOutput:
    """Turn class probabilities into (label, confidence) pairs (reference
    LabelOutput transform over label_map)."""

    def __init__(self, label_map: Optional[Dict[int, str]] = None,
                 top_k: int = 5):
        self.label_map = label_map or {}
        self.top_k = top_k

    def __call__(self, probs: np.ndarray):
        probs = np.asarray(probs)
        idx = np.argsort(-probs, axis=-1)[..., :self.top_k]
        conf = np.take_along_axis(probs, idx, axis=-1)
        labels = np.vectorize(
            lambda i: self.label_map.get(int(i), str(int(i))))(idx)
        return [list(zip(labels[i], conf[i].tolist()))
                for i in range(len(probs))]


class ImageClassifier(ZooModel):
    """Config-family image classifier (reference image_classifier.py)."""

    def __init__(self, model_name: str = "inception-v1",
                 num_classes: int = 1000,
                 label_map: Optional[Dict[int, str]] = None, device=None,
                 **net_kwargs):
        if model_name not in IMAGENET_TOP_CONFIGS:
            raise ValueError(
                f"unknown model config {model_name!r}; known: "
                f"{sorted(IMAGENET_TOP_CONFIGS)}")
        self.model_name = model_name
        self.num_classes = num_classes
        self.label_map = label_map or {}
        self._net_kwargs = dict(net_kwargs)
        super().__init__(IMAGENET_TOP_CONFIGS[model_name](num_classes,
                                                          **net_kwargs),
                         device=device)

    def compile(self, loss="sparse_categorical_crossentropy_from_logits",
                optimizer="adam", metrics=("sparse_categorical_accuracy",),
                **kwargs):
        if loss == "sparse_categorical_crossentropy_from_logits":
            from ....orca.learn.losses import sparse_categorical_crossentropy
            loss = partial(
                sparse_categorical_crossentropy,
                from_logits=self._net_kwargs.get("return_logits", True))
        return super().compile(loss=loss, optimizer=optimizer,
                               metrics=list(metrics or []), **kwargs)

    # --- inference surface --------------------------------------------------
    def predict_image_set(self, images, top_k: Optional[int] = None,
                          batch_size: int = 256):
        """images: an (n, h, w, 3) array; returns probabilities, or top-k
        (label, confidence) lists when top_k is given (reference
        predict_image_set + LabelOutput pipeline). An ``ImageSet`` raises
        ``TypeError``: pass ``np.stack(image_set.get_image())``."""
        from ....feature.image.imageset import ImageSet
        if isinstance(images, ImageSet):
            raise TypeError(
                "ImageClassifier.predict_image_set takes an array of "
                "images, not an ImageSet (the JAX package's fails on one: "
                "ImageSet has no to_array); pass "
                "np.stack(image_set.get_image())")
        out = np.asarray(self.predict(np.asarray(images),
                                      batch_size=batch_size))
        # nets built with return_logits=False already emit probabilities;
        # re-softmaxing would flatten confidences toward uniform
        probs = (out if self._net_kwargs.get("return_logits") is False
                 else _softmax_np(out))
        if top_k:
            return LabelOutput(self.label_map, top_k)(probs)
        return probs

    def load_caffe_weights(self, caffemodel_path: str,
                           name_map: Optional[Dict[str, str]] = None):
        """Raises: the Caffe loader (``models/caffe``) is not ported yet
        (ROADMAP queue A9)."""
        raise NotImplementedError(
            "load_caffe_weights needs models/caffe's loader, which waits "
            "in ROADMAP queue A9")

    # --- persistence --------------------------------------------------------
    def save_model(self, path: str, over_write: bool = False):
        """The config and the engine state, as plain values with
        ``torch.save``."""
        if os.path.exists(path) and not over_write:
            raise FileExistsError(path)
        torch.save({"model_name": self.model_name,
                    "num_classes": self.num_classes,
                    "label_map": self.label_map,
                    "net_kwargs": {k: (str(v).replace("torch.", "")
                                       if isinstance(v, torch.dtype) else v)
                                   for k, v in self._net_kwargs.items()},
                    "state": self.estimator.engine.get_state()}, path)
        return path

    @classmethod
    def load_model(cls, path: str, device=None):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        obj = cls(model_name=blob["model_name"],
                  num_classes=blob["num_classes"],
                  label_map=blob["label_map"], device=device,
                  **blob["net_kwargs"])
        obj.compile()
        obj.estimator.engine.set_state(blob["state"])
        return obj


def _softmax_np(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)
