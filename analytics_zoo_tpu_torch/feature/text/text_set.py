"""TextSet, the text preprocessing pipeline (a host-only copy of
``analytics_zoo_tpu/feature/text/text_set.py``; parity: pyzoo/zoo/feature/
text/text_set.py TextSet/LocalTextSet/DistributedTextSet).

A TextSet holds host-side records, and the chainable stages produce padded
int sequences for the estimator: tokenize -> normalize -> word2idx ->
shape_sequence -> generate_sample. Every stage computes what the JAX
package's does, so the same texts give the same tokens, word index and
index arrays: tokens are runs of word characters and apostrophes, lower
cased with ``string.punctuation`` removed; ids are 1-based in
``Counter.most_common`` order after ``remove_topN``, ``max_words_num``
and ``min_freq``, 0 for an unknown word; ``shape_sequence`` pads at the
end and truncates by ``trunc_mode``; ``random_split`` and
``from_relation_pairs`` draw from ``RandomState(0)``.

``read_csv`` reads the two-column ``uri,text`` file with the ``csv``
module (every field a string; the JAX package reads it with pandas).
``read_parquet`` reads a ``uri``/``text`` table with pandas, imported
inside the call as in the JAX package."""

from __future__ import annotations

import csv
import os
import pickle
import re
import string
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[\w']+")


class TextFeature:
    """One text record (reference feature/text/text_feature.py:27)."""

    def __init__(self, text: Optional[str] = None, label: Optional[int] = None,
                 uri: Optional[str] = None):
        self.text = text
        self.label = label
        self.uri = uri
        self.tokens: Optional[List[str]] = None
        self.indices: Optional[np.ndarray] = None
        self.predict = None

    def get_text(self):
        return self.text

    def get_label(self):
        return self.label

    def get_tokens(self):
        return self.tokens

    def get_sample(self):
        return {"x": self.indices, "y": self.label}

    def keys(self):
        out = ["text"]
        if self.label is not None:
            out.append("label")
        if self.tokens is not None:
            out.append("tokens")
        if self.indices is not None:
            out.append("indices")
        return out


class TextSet:
    """Chainable text pipeline over a list of TextFeature."""

    def __init__(self, features: Sequence[TextFeature]):
        self.features = list(features)
        self._word_index: Optional[Dict[str, int]] = None

    # --- construction -------------------------------------------------------
    @classmethod
    def from_texts(cls, texts: Sequence[str],
                   labels: Optional[Sequence[int]] = None) -> "TextSet":
        labels = labels if labels is not None else [None] * len(texts)
        return cls([TextFeature(t, l) for t, l in zip(texts, labels)])

    @classmethod
    def read(cls, path: str, min_partitions: int = 1) -> "TextSet":
        """Directory layout: path/<category>/ *.txt, category dirs map to
        labels 0..n-1 sorted (reference TextSet.read)."""
        feats = []
        for li, cat in enumerate(sorted(os.listdir(path))):
            cat_dir = os.path.join(path, cat)
            if not os.path.isdir(cat_dir):
                continue
            for fname in sorted(os.listdir(cat_dir)):
                with open(os.path.join(cat_dir, fname), encoding="utf-8",
                          errors="ignore") as f:
                    feats.append(TextFeature(f.read(), li,
                                             uri=os.path.join(cat, fname)))
        return cls(feats)

    @classmethod
    def read_csv(cls, path: str, **kwargs) -> "TextSet":
        """CSV of uri,text rows without a header (reference read_csv);
        ``kwargs`` go to ``csv.reader``."""
        with open(path, newline="", encoding="utf-8") as f:
            rows = [r for r in csv.reader(f, **kwargs) if r]
        return cls([TextFeature(text, uri=uri) for uri, text in rows])

    @classmethod
    def read_parquet(cls, path: str) -> "TextSet":
        """A parquet table with ``uri`` and ``text`` columns (reference
        read_parquet)."""
        import pandas as pd
        df = pd.read_parquet(path)
        return cls([TextFeature(t, uri=u)
                    for u, t in zip(df["uri"], df["text"])])

    @classmethod
    def from_relation_pairs(cls, relations, corpus1: "TextSet",
                            corpus2: "TextSet") -> "TextSet":
        """Build pairwise ranking samples: each relation (id1, id2, label);
        positive pairs with a sampled negative (reference
        from_relation_pairs). Texts must already be word2idx'd."""
        c1 = {f.uri: f for f in corpus1.features}
        c2 = {f.uri: f for f in corpus2.features}
        pos = [r for r in relations if int(r[2]) > 0]
        neg_by_q: Dict[str, List] = {}
        for r in relations:
            if int(r[2]) == 0:
                neg_by_q.setdefault(r[0], []).append(r)
        feats = []
        rng = np.random.RandomState(0)
        for q, d, _ in pos:
            negs = neg_by_q.get(q)
            if not negs:
                continue
            nd = negs[rng.randint(len(negs))][1]
            f = TextFeature(uri=f"{q}//{d}//{nd}")
            f.indices = np.concatenate([
                np.concatenate([c1[q].indices, c2[d].indices]),
                np.concatenate([c1[q].indices, c2[nd].indices])])
            f.label = 1
            feats.append(f)
        return cls(feats)

    @classmethod
    def from_relation_lists(cls, relations, corpus1: "TextSet",
                            corpus2: "TextSet") -> "TextSet":
        """Per-query listwise samples (reference from_relation_lists)."""
        c1 = {f.uri: f for f in corpus1.features}
        c2 = {f.uri: f for f in corpus2.features}
        by_q: Dict[str, List] = {}
        for r in relations:
            by_q.setdefault(r[0], []).append(r)
        feats = []
        for q, rs in by_q.items():
            f = TextFeature(uri=q)
            f.indices = np.stack([
                np.concatenate([c1[q].indices, c2[d].indices])
                for _, d, _ in rs])
            f.label = np.asarray([int(l) for _, _, l in rs])
            feats.append(f)
        return cls(feats)

    # --- properties ---------------------------------------------------------
    def is_local(self) -> bool:
        return True

    def is_distributed(self) -> bool:
        return False

    def to_distributed(self, partition_num: int = 4):
        from ...orca.data.shard import HostXShards
        bounds = np.linspace(0, len(self.features), partition_num + 1,
                             dtype=int)
        return HostXShards([self.features[a:b]
                            for a, b in zip(bounds[:-1], bounds[1:])])

    def to_local(self) -> "TextSet":
        return self

    def get_texts(self) -> List[str]:
        return [f.text for f in self.features]

    def get_uris(self) -> List[str]:
        return [f.uri for f in self.features]

    def get_labels(self) -> List:
        return [f.label for f in self.features]

    def get_predicts(self) -> List:
        return [(f.uri, f.predict) for f in self.features]

    def get_samples(self) -> List[dict]:
        return [f.get_sample() for f in self.features]

    def get_word_index(self) -> Optional[Dict[str, int]]:
        return self._word_index

    def set_word_index(self, vocab: Dict[str, int]) -> "TextSet":
        self._word_index = dict(vocab)
        return self

    def save_word_index(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self._word_index, f)

    def load_word_index(self, path: str) -> "TextSet":
        with open(path, "rb") as f:
            self._word_index = pickle.load(f)
        return self

    def random_split(self, weights: Sequence[float]) -> List["TextSet"]:
        rng = np.random.RandomState(0)
        idx = rng.permutation(len(self.features))
        w = np.asarray(weights, float)
        bounds = np.concatenate([[0], np.cumsum(w / w.sum())])
        out = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            sel = idx[int(a * len(idx)):int(b * len(idx))]
            sub = TextSet([self.features[i] for i in sel])
            sub._word_index = self._word_index
            out.append(sub)
        return out

    # --- pipeline stages ----------------------------------------------------
    def tokenize(self) -> "TextSet":
        for f in self.features:
            f.tokens = _TOKEN_RE.findall(f.text or "")
        return self

    def normalize(self) -> "TextSet":
        """Lower-case, strip punctuation-only tokens (reference Normalizer)."""
        table = str.maketrans("", "", string.punctuation)
        for f in self.features:
            toks = [t.lower().translate(table) for t in (f.tokens or [])]
            f.tokens = [t for t in toks if t]
        return self

    def generate_word_index_map(self, remove_topN: int = 0,
                                max_words_num: int = -1, min_freq: int = 1,
                                existing_map: Optional[dict] = None
                                ) -> Dict[str, int]:
        counts = Counter()
        for f in self.features:
            counts.update(f.tokens or [])
        ordered = [w for w, c in counts.most_common() if c >= min_freq]
        ordered = ordered[remove_topN:]
        if max_words_num > 0:
            ordered = ordered[:max_words_num]
        vocab = dict(existing_map or {})
        nxt = max(vocab.values(), default=0) + 1
        for w in ordered:
            if w not in vocab:
                vocab[w] = nxt
                nxt += 1
        self._word_index = vocab
        return vocab

    def word2idx(self, remove_topN: int = 0, max_words_num: int = -1,
                 min_freq: int = 1, existing_map: Optional[dict] = None
                 ) -> "TextSet":
        """Index tokens 1-based by frequency; 0 = unknown (reference
        word2idx semantics)."""
        if existing_map is not None:
            self._word_index = dict(existing_map)
        elif self._word_index is None:
            self.generate_word_index_map(remove_topN, max_words_num,
                                         min_freq)
        vocab = self._word_index
        for f in self.features:
            f.indices = np.asarray([vocab.get(t, 0)
                                    for t in (f.tokens or [])], np.int32)
        return self

    def shape_sequence(self, len: int, trunc_mode: str = "pre",
                       pad_element: int = 0) -> "TextSet":
        L = len
        for f in self.features:
            idx = f.indices if f.indices is not None else np.zeros(
                0, np.int32)
            if idx.shape[0] > L:
                idx = idx[-L:] if trunc_mode == "pre" else idx[:L]
            elif idx.shape[0] < L:
                pad = np.full(L - idx.shape[0], pad_element, np.int32)
                idx = np.concatenate([idx, pad])
            f.indices = idx
        return self

    def generate_sample(self) -> "TextSet":
        return self

    def transform(self, transformer) -> "TextSet":
        for f in self.features:
            transformer(f)
        return self

    # --- bridge -------------------------------------------------------------
    def to_arrays(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        x = np.stack([f.indices for f in self.features])
        labels = [f.label for f in self.features]
        y = (np.asarray(labels) if all(l is not None for l in labels)
             else None)
        return x, y


class LocalTextSet(TextSet):
    def __init__(self, texts=None, labels=None):
        labels = labels if labels is not None else [None] * len(texts)
        super().__init__([TextFeature(t, l)
                          for t, l in zip(texts, labels)])


DistributedTextSet = LocalTextSet  # single-runtime: one implementation
