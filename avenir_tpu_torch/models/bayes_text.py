"""Text-mode Naive Bayes: the port of ``avenir_tpu/models/bayes_text.py``
(the reference's Lucene-analyzed text path of BayesianDistribution: with
no schema file configured the input is ``text,classLabel`` lines and the
single feature is the token stream, bayesian/BayesianDistribution.java).

Tokens become vocabulary codes on the host; the (class, token) counts are
one ``bincount`` over the flat key on the device.  Classification gathers
each token's float64 class log-probabilities (computed on the host as the
JAX package computes them), rounds them to float32 as its device gather
does, and sums them per document in token order: one row of the (doc,
token) matrix a document, added left to right — the order of the JAX
package's float32 segment sum on the CPU, and the same on a GPU, where a
float atomic scatter would add in any order and move near ties.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..runtime import resolve_device
from ..text.wordcount import STANDARD_STOPWORDS, tokenize
from ..utils.tracing import fetch, note_dispatch, note_h2d

TEXT_FEATURE_ORDINAL = 1  # featureAttrOrdinal in text mode


@dataclass
class TextBayesModel:
    class_values: List[str]
    vocab: List[str]                 # token id -> token
    token_counts: np.ndarray         # (C, V) float
    class_counts: np.ndarray         # (C,) docs per class

    # ---- model CSV (the tabular layout: class, ord, bin, count with the
    #      token as the bin label) ----
    def to_lines(self, delim: str = ",") -> List[str]:
        lines = []
        for ci, cv in enumerate(self.class_values):
            lines.append(f"{cv}{delim}{delim}{delim}"
                         f"{int(self.class_counts[ci])}")
        for ci, cv in enumerate(self.class_values):
            for ti, tok in enumerate(self.vocab):
                c = int(self.token_counts[ci, ti])
                if c > 0:
                    lines.append(f"{cv}{delim}{TEXT_FEATURE_ORDINAL}{delim}"
                                 f"{tok}{delim}{c}")
        return lines

    @classmethod
    def from_lines(cls, lines: Sequence[str], delim: str = ","
                   ) -> "TextBayesModel":
        class_counts: Dict[str, int] = {}
        token_counts: Dict[Tuple[str, str], int] = {}
        vocab_set: Dict[str, int] = {}
        for line in lines:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            items = line.split(delim)
            if items[1] == "" and items[2] == "":
                class_counts[items[0]] = int(items[3])
            elif items[0] != "":
                tok = items[2]
                token_counts[(items[0], tok)] = int(items[3])
                vocab_set.setdefault(tok, len(vocab_set))
        class_values = sorted(class_counts)
        vocab = sorted(vocab_set, key=vocab_set.get)
        tc = np.zeros((len(class_values), len(vocab)))
        for (cv, tok), n in token_counts.items():
            tc[class_values.index(cv), vocab_set[tok]] = n
        return cls(class_values=class_values, vocab=vocab, token_counts=tc,
                   class_counts=np.array([class_counts[c]
                                          for c in class_values],
                                         dtype=float))


def _flatten(docs_tokens: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
    """(token_codes, doc_ids) flattened over all documents."""
    codes = np.fromiter((t for doc in docs_tokens for t in doc),
                        dtype=np.int64)
    doc_ids = np.fromiter((i for i, doc in enumerate(docs_tokens)
                           for _ in doc), dtype=np.int64)
    return codes, doc_ids


def train_text(lines: Sequence[str], delim: str = ",",
               stopwords: frozenset = STANDARD_STOPWORDS,
               device=None) -> TextBayesModel:
    """Count (class, token) occurrences over ``text<delim>class`` lines on
    ``device`` (default: the process device)."""
    dev = resolve_device(device)
    texts, labels = [], []
    for line in lines:
        line = line.rstrip("\n")
        if not line.strip():
            continue
        text, _, label = line.rpartition(delim)
        texts.append(text)
        labels.append(label.strip())
    class_values = sorted(set(labels))
    cls_index = {c: i for i, c in enumerate(class_values)}
    vocab: Dict[str, int] = {}
    docs_tokens: List[List[int]] = []
    for t in texts:
        docs_tokens.append([vocab.setdefault(tok, len(vocab))
                            for tok in tokenize(t, stopwords)])
    V, C = max(len(vocab), 1), len(class_values)
    codes, doc_ids = _flatten(docs_tokens)
    doc_cls = np.array([cls_index[l] for l in labels], dtype=np.int64)
    key = doc_cls[doc_ids] * V + codes
    note_h2d(key.nbytes)
    counts = torch.bincount(torch.from_numpy(key).to(dev), minlength=C * V)
    note_dispatch(site="bayes.text.train")
    class_counts = np.bincount(doc_cls, minlength=C)
    inv = [""] * len(vocab)
    for tok, i in vocab.items():
        inv[i] = tok
    return TextBayesModel(
        class_values=class_values, vocab=inv,
        token_counts=fetch(counts).reshape(C, V).astype(np.float32),
        class_counts=class_counts.astype(float))


def classify_text(model: TextBayesModel, texts: Sequence[str],
                  laplace: float = 1.0,
                  stopwords: frozenset = STANDARD_STOPWORDS, device=None
                  ) -> Tuple[List[str], np.ndarray]:
    """(predicted labels, (n, C) class log-posteriors): the Laplace-smoothed
    per-token class log-probabilities summed per document, plus the class
    log-prior."""
    dev = resolve_device(device)
    C, V = model.token_counts.shape
    vocab_index = {t: i for i, t in enumerate(model.vocab)}
    docs_tokens = [[vocab_index[t] for t in tokenize(x, stopwords)
                    if t in vocab_index] for x in texts]
    totals = model.token_counts.sum(axis=1, keepdims=True)
    log_post = np.log((model.token_counts + laplace)
                      / (totals + laplace * V))             # (C, V) float64
    log_prior = np.log(np.maximum(model.class_counts, 1e-12)
                       / max(model.class_counts.sum(), 1.0))
    n = len(texts)
    L = max((len(d) for d in docs_tokens), default=0)
    if L:
        # (n, L) token matrix padded with a code whose log-prob is 0 (a
        # float32 zero added changes no sum), one row a document
        mat = np.full((n, L), V, dtype=np.int64)
        for i, d in enumerate(docs_tokens):
            mat[i, :len(d)] = d
        table = np.concatenate([log_post, np.zeros((C, 1))], axis=1) \
            .astype(np.float32)                             # (C, V + 1)
        note_h2d(mat.nbytes + table.nbytes, transfers=2)
        tab_d = torch.from_numpy(table).to(dev)
        mat_d = torch.from_numpy(mat).to(dev)
        acc = torch.zeros((C, n), dtype=torch.float32, device=dev)
        for j in range(L):
            acc = acc + tab_d[:, mat_d[:, j]]
        note_dispatch(site="bayes.text.classify")
        scores = fetch(acc).T + log_prior[None, :]
    else:
        scores = np.tile(log_prior, (n, 1))
    pred = [model.class_values[i] for i in np.argmax(scores, axis=1)]
    return pred, scores
