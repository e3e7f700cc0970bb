"""Checkpoint wire format: per-leaf content-addressed blobs + JSON manifest
(counterpart of ``analytics_zoo_tpu/ckpt/format.py``: the same on-disk
format ``zoo-ckpt-v1``, so either package reads what the other wrote).

A committed checkpoint is a directory::

    ckpt-<step>/
        MANIFEST.json     # pytree metadata: step, per-leaf digest/dtype/shape
        COMMIT            # commit marker — written LAST, after fsync+rename

with the actual tensor bytes living in a shared, content-addressed blob
store (``<root>/blobs/<sha256>[.enc]``, see :mod:`.store`). The state
pytree is split into:

* **array leaves** (every ``np.ndarray`` / ``torch.Tensor``) — one raw-bytes
  blob each, addressed by the sha256 of the *plaintext* bytes, so leaves
  unchanged across steps or shared across trials (an ASHA rung's frozen
  embeddings) are stored once regardless of how many manifests reference
  them;
* the **skeleton** — the original tree with each array leaf replaced by a
  positional :class:`_LeafRef`, pickled into one (usually tiny) blob.
  Optimizer namedtuples, ``PartitionSpec``s, step counters and — for
  serving checkpoints — the flax module itself ride in the skeleton, so
  any state the old ``pickle.dump`` path accepted round-trips here too.

Atomicity protocol (the loader's contract):

1. blobs land via write-tmp → fsync → ``os.replace`` (atomic, idempotent);
2. the manifest is written into a hidden tmp dir, fsynced, and the tmp
   dir is renamed to ``ckpt-<step>``;
3. the ``COMMIT`` marker is written (and fsynced) only after the rename.

A crash anywhere before step 3 leaves either a ``.tmp-*`` dir or a
``ckpt-<step>`` without ``COMMIT`` — both are skipped by the loader, which
falls back to the previous committed checkpoint. Checksum verification on
load (digest of the decrypted blob bytes vs the manifest) catches torn or
bit-rotted blobs the same way.

Encryption at rest rides ``utils/crypto`` per blob: digests address the
plaintext (dedup still works), files hold the sealed bytes, and the
``.enc`` filename suffix keeps plain and sealed stores from colliding.
"""

from __future__ import annotations

import collections
import hashlib
import io
import json
import logging
import os
import pickle
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("analytics_zoo_tpu_torch")

FORMAT = "zoo-ckpt-v1"
MANIFEST_NAME = "MANIFEST.json"
COMMIT_NAME = "COMMIT"
BLOB_DIR = "blobs"


class _LeafRef:
    """Placeholder for an extracted array leaf (position in the manifest's
    ``leaves`` list). Pickled under the JAX package's name
    (:data:`_JAX_LEAFREF`), so the JAX package's ``join_state`` resolves it
    to its own ``_LeafRef``; this package's reader maps that name back."""

    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx

    def __reduce__(self):
        return (_LeafRef, (self.idx,))


# the global a skeleton names for a leaf placeholder, in either package
_JAX_LEAFREF = ("analytics_zoo_tpu.ckpt.format", "_LeafRef")


class _SkeletonPickler(pickle._Pickler):
    """The pure-Python pickler with one change: :class:`_LeafRef` is
    written as the global ``analytics_zoo_tpu.ckpt.format._LeafRef``
    without importing that module (the port never imports the JAX
    package, and the card's machine does not have it)."""

    def save_global(self, obj, name=None):
        if obj is not _LeafRef:
            return super().save_global(obj, name)
        module, qualname = _JAX_LEAFREF      # protocol 4, as dumped below
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


# fields of the optax states of the ported optimizers; an unknown class
# from optax, flax, jax or the JAX package becomes a tuple of its
# constructor arguments (a JAX serving checkpoint's pickled flax module
# among them: the port adopts its weights and never runs the module)
_KNOWN_FIELDS = {
    "InjectStatefulHyperparamsState": ("count", "hyperparams",
                                       "hyperparams_states", "inner_state"),
    "ScaleByAdamState": ("count", "mu", "nu"),
    "TraceState": ("trace",),
    "EmptyState": (),
}
_FOREIGN_ROOTS = ("optax", "flax", "jax", "analytics_zoo_tpu")
_stand_ins: Dict[Tuple[str, str], type] = {}


class _Opaque(tuple):
    """Stand-in for a foreign class whose fields are not known: the
    positional arguments it was rebuilt from."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)


def stand_in(module: str, name: str) -> type:
    """A plain class for the foreign ``module.name``: a namedtuple with
    the optax state's fields when they are known, else an :class:`_Opaque`
    tuple. Its ``__name__`` is ``name``, so code can dispatch on it."""
    key = (module, name)
    if key not in _stand_ins:
        fields = _KNOWN_FIELDS.get(name)
        if fields is not None:
            cls = collections.namedtuple(name, fields)
        else:
            cls = type(name, (_Opaque,), {})
        cls.__module__ = "analytics_zoo_tpu_torch.ckpt.format.foreign"
        cls.foreign = module + "." + name
        _stand_ins[key] = cls
    return _stand_ins[key]


class _SkeletonUnpickler(pickle.Unpickler):
    """Resolves a skeleton's globals without importing the JAX stack: the
    leaf placeholder of either package to :class:`_LeafRef`, classes of
    optax, flax, jax and the JAX package to :func:`stand_in` classes."""

    def find_class(self, module, name):
        if name == "_LeafRef" and module in (
                _JAX_LEAFREF[0], "analytics_zoo_tpu_torch.ckpt.format"):
            return _LeafRef
        if module.split(".", 1)[0] in _FOREIGN_ROOTS:
            return stand_in(module, name)
        return super().find_class(module, name)


def _np_dtype(name: str) -> np.dtype:
    """dtype from its manifest name, including the ml_dtypes extension
    types (bfloat16 & friends) numpy's constructor may not know."""
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, name))


def _map_tree(fn, tree):
    """``fn`` over the leaves of nested dicts, lists, tuples and
    namedtuples (a namedtuple keeps its class). Dict keys are visited in
    sorted order, as ``jax.tree_util`` visits them, so a tree's leaves come
    out in the JAX package's order."""
    if isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError:
            keys = list(tree)
        return {k: _map_tree(fn, tree[k]) for k in keys}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    if isinstance(tree, _Opaque):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _to_numpy(leaf) -> Optional[np.ndarray]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        try:
            return t.numpy()
        except TypeError as e:
            raise TypeError(f"a {t.dtype} tensor has no numpy dtype to "
                            "checkpoint it as") from e
    if isinstance(leaf, np.ndarray):
        return leaf
    return None


def split_state(state) -> Tuple[bytes, List[np.ndarray]]:
    """State tree -> (pickled skeleton bytes, array leaves in ref order).

    Every ``torch.Tensor`` and ``np.ndarray`` leaf becomes a copied numpy
    array (the copy freezes the state: the async writer hashes and writes
    the leaves later, while training goes on updating the tensors in
    place); everything else stays in the skeleton.
    """
    leaves: List[np.ndarray] = []

    def repl(leaf):
        arr = _to_numpy(leaf)
        if arr is None:
            return leaf
        # copy(), not ascontiguousarray, which promotes 0-d to 1-d
        leaves.append(arr.copy())
        return _LeafRef(len(leaves) - 1)

    skeleton = _map_tree(repl, state)
    buf = io.BytesIO()
    _SkeletonPickler(buf, protocol=4).dump(skeleton)
    return buf.getvalue(), leaves


def join_state(skeleton_bytes: bytes, leaves: List[np.ndarray]):
    """Inverse of :func:`split_state`, also for a JAX-written skeleton:
    array leaves come back as numpy arrays, optax states as
    :func:`stand_in` namedtuples."""
    skeleton = _SkeletonUnpickler(io.BytesIO(skeleton_bytes)).load()
    return _map_tree(
        lambda l: leaves[l.idx] if isinstance(l, _LeafRef) else l, skeleton)


def digest_of(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def leaf_record(arr: np.ndarray, digest: str) -> Dict[str, Any]:
    return {"digest": digest, "dtype": str(arr.dtype),
            "shape": list(arr.shape), "nbytes": int(arr.nbytes)}


def decode_leaf(raw, rec: Dict[str, Any],
                writable: bool = True) -> np.ndarray:
    if digest_of(raw) != rec["digest"]:
        raise ValueError(f"blob {rec['digest'][:12]} checksum mismatch")
    if not writable:
        # zero-copy view straight over ``raw`` (a mapped blob on the
        # hot-reload path): the adopting engine only reads — predict
        # feeds the leaves to XLA, which copies at device transfer
        arr = np.frombuffer(raw, dtype=_np_dtype(rec["dtype"]))
        arr = arr.reshape(tuple(rec["shape"]))
        arr.flags.writeable = False
        return arr
    # frombuffer over a bytearray copy: bytes-backed views are READ-ONLY,
    # and the pickle path this format replaces returned writable arrays —
    # fit_eval state consumers may update restored leaves in place
    arr = np.frombuffer(bytearray(raw), dtype=_np_dtype(rec["dtype"]))
    return arr.reshape(tuple(rec["shape"]))


def build_manifest(step: int, skeleton_rec: Dict, leaf_recs: List[Dict],
                   blob_dir_rel: str, encrypted: bool,
                   score: Optional[float] = None,
                   meta: Optional[Dict] = None) -> Dict:
    return {"format": FORMAT, "step": int(step),
            "created": round(time.time(), 3),
            "score": None if score is None else float(score),
            "encrypted": bool(encrypted),
            "blob_dir": blob_dir_rel,
            "skeleton": skeleton_rec, "leaves": leaf_recs,
            "logical_bytes": skeleton_rec["nbytes"]
            + sum(r["nbytes"] for r in leaf_recs),
            "meta": meta or {}}


# --- fsync helpers ----------------------------------------------------------
def fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                 # pragma: no cover - non-POSIX
        return
    try:
        os.fsync(fd)
    except OSError:                 # pragma: no cover - e.g. NFS quirks
        pass
    finally:
        os.close(fd)


# --- directory-level readers ------------------------------------------------
_STEP_RE = re.compile(r"(?:ckpt-|step_)?(\d+)$")


def parse_step(dirname: str) -> Optional[int]:
    """Step number of a versioned checkpoint dir name, None if not one."""
    m = _STEP_RE.fullmatch(dirname)
    return int(m.group(1)) if m else None


def loadable_step_dirs(base: str, bare_ok: bool = False
                       ) -> List[Tuple[int, str]]:
    """The ONE scanner deciding which checkpoint dirs under ``base`` are
    resume candidates — shared by ``CheckpointPlane._committed``,
    ``CheckpointWatcher`` and ``find_latest_checkpoint``, so a format
    tweak (new prefix, commit rule) cannot make them disagree.

    Returns (step, path) sorted by step ascending. Plane dirs count only
    when COMMITTED (manifest + COMMIT marker); non-plane dirs need a
    legacy ``state.pkl`` unless ``bare_ok`` (the estimator scanner's
    historical acceptance of bare step dirs from pre-plane layouts).
    """
    out: List[Tuple[int, str]] = []
    if not os.path.isdir(base):
        return out
    for entry in os.listdir(base):
        step = parse_step(entry)
        if step is None:
            continue
        path = os.path.join(base, entry)
        if not os.path.isdir(path):
            continue
        if is_plane_dir(path):
            if not is_committed(path):
                continue            # torn write: never a candidate
        elif not bare_ok and not os.path.exists(
                os.path.join(path, "state.pkl")):
            continue
        out.append((step, path))
    out.sort()
    return out


def is_committed(ckpt_dir: str) -> bool:
    """A checkpoint-plane dir the loader may trust: manifest + COMMIT."""
    return (os.path.exists(os.path.join(ckpt_dir, MANIFEST_NAME))
            and os.path.exists(os.path.join(ckpt_dir, COMMIT_NAME)))


def is_plane_dir(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, MANIFEST_NAME))


def read_manifest(ckpt_dir: str) -> Dict:
    with open(os.path.join(ckpt_dir, MANIFEST_NAME), encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("format") != FORMAT:
        raise ValueError(f"{ckpt_dir}: unknown checkpoint format "
                         f"{doc.get('format')!r}")
    return doc


def manifest_meta(ckpt_dir: str) -> Dict:
    """The caller-supplied ``meta`` dict a checkpoint's manifest carries —
    provenance readable WITHOUT loading any blob. The estimator records the
    writing run's comms plane here (``meta["comms"]``: sharded_update,
    wire_dtype, bucket layout signature), the training supervisor its epoch
    boundary — a reader can tell how a checkpoint was produced before
    deciding to adopt it."""
    return read_manifest(ckpt_dir).get("meta", {}) or {}


def load_checkpoint_dir(ckpt_dir: str, passphrase: Optional[str] = None,
                        map_blobs: bool = False):
    """Read one checkpoint directory back into its state pytree.

    Handles both formats: a checkpoint-plane dir (manifest + blobs,
    digest-verified leaf by leaf) and a legacy ``state.pkl`` dir — old
    checkpoints written by the pickle path stay readable forever.

    ``map_blobs=True`` (the hot-reload path) mmaps each unencrypted leaf
    blob instead of reading it into a heap copy: leaves come back as
    READ-ONLY views over the page cache, so N adopting processes share
    one physical copy and adoption never doubles the model's host RSS.
    Training restore keeps the default (writable copies) — state
    consumers may update restored leaves in place. Encrypted checkpoints
    always copy (decrypt-to-heap).
    """
    from .store import BlobStore

    legacy = os.path.join(ckpt_dir, "state.pkl")
    if not is_plane_dir(ckpt_dir):
        if os.path.exists(legacy):
            with open(legacy, "rb") as f:
                return _SkeletonUnpickler(f).load()
        raise FileNotFoundError(f"{ckpt_dir}: no MANIFEST.json or state.pkl")
    doc = read_manifest(ckpt_dir)
    if not os.path.exists(os.path.join(ckpt_dir, COMMIT_NAME)):
        raise ValueError(f"{ckpt_dir}: uncommitted checkpoint (no COMMIT)")
    if doc["encrypted"] and passphrase is None:
        raise ValueError(f"{ckpt_dir}: checkpoint is encrypted at rest; "
                         "a passphrase is required")
    store = BlobStore(os.path.normpath(
        os.path.join(ckpt_dir, doc["blob_dir"])))
    sk = doc["skeleton"]
    raw = store.get(sk["digest"], encrypted=doc["encrypted"],
                    passphrase=passphrase)
    if digest_of(raw) != sk["digest"]:
        raise ValueError(f"{ckpt_dir}: skeleton blob checksum mismatch")
    mapped = bool(map_blobs) and not doc["encrypted"]
    if mapped:
        leaves = [decode_leaf(store.map(rec["digest"]), rec,
                              writable=False)
                  for rec in doc["leaves"]]
    else:
        leaves = [decode_leaf(
            store.get(rec["digest"], encrypted=doc["encrypted"],
                      passphrase=passphrase), rec)
            for rec in doc["leaves"]]
    return join_state(raw, leaves)
