"""fastText-family analyzers: ``classification`` and ``nearest_neighbors``.

Reference: core/analysis/classification_stream.hpp:37 and
nearest_neighbors_stream.hpp:38 run fastText model inference over the
input text — classification emits the model's top-k predicted labels as
tokens; nearest_neighbors replaces each token with its k nearest
neighbour words. Both are configured by JSON
``{"model_location": ..., "top_k": ..., ["threshold": ...]}``
(classification_stream.cpp parameter names).

This is NOT a fastText port: the model here is a minimal embedding
classifier with the same *shape* of capability —

* words + hashed character-ngram buckets share one input embedding table
  (the fastText subword trick; FNV-1a bucket hashing, a public scheme);
* a document embeds as the mean of its token vectors;
* supervised training (``train_supervised``) optimizes a softmax label
  head with full-batch gradient descent under ``torch.autograd`` on a
  torch device (the card unless the caller names another): the gather of
  every doc's rows, the masked mean and two matmuls per step;
* models persist as a single ``.npz`` (vocab blob + embeddings + labels).

The reference loads pretrained fastText ``.bin`` models; this module
trains and loads its own format (no fastText binaries exist in-image).

A copy of ``iresearch_tpu/analysis/embed.py``: the hashes, the model, its
persistence and the ``.bin`` loader are host numpy as there, and the
``.npz`` files cross between the two packages. Only the training step
changed (``jax.value_and_grad`` under ``jax.jit`` there), and the doc row
matrices are built once per distinct word (the same matrices).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from iresearch_tpu_torch.analysis.analyzers import Analyzer
from iresearch_tpu_torch.analysis.token import Token

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def _fnv1a(data: bytes) -> int:
    """FNV-1a 64-bit (the public hash fastText uses for ngram buckets)."""
    h = _FNV_OFFSET
    with np.errstate(over="ignore"):
        for b in data:
            h = (h ^ np.uint64(b)) * _FNV_PRIME
    return int(h)


def _ft_hash(data: bytes) -> int:
    """fastText's FNV-1a 32-bit with SIGNED char extension (fastText
    Dictionary::hash — the quirk matters for bytes >= 0x80)."""
    h = 2166136261
    for b in data:
        if b >= 0x80:
            b -= 256  # int8_t cast
        h = (h ^ (b & 0xFFFFFFFF)) & 0xFFFFFFFF
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def _ft_subword_hashes(
    word: bytes, minn: int, maxn: int, bucket: int
) -> List[int]:
    """fastText Dictionary::computeSubwords: character-boundary ngrams of
    "<word>" hashed into [0, bucket) — byte-exact with the reference's
    vendored fastText (external/fastText)."""
    w = b"<" + word + b">"
    out = []
    size = len(w)
    i = 0
    while i < size:
        if (w[i] & 0xC0) == 0x80:
            i += 1
            continue
        ngram = bytearray()
        j, n = i, 1
        while j < size and n <= maxn:
            ngram.append(w[j])
            j += 1
            while j < size and (w[j] & 0xC0) == 0x80:
                ngram.append(w[j])
                j += 1
            if n >= minn and not (n == 1 and (i == 0 or j == size)):
                out.append(_ft_hash(bytes(ngram)) % bucket)
            n += 1
        i += 1
    return out


def _subword_ngrams(word: bytes, minn: int, maxn: int) -> List[bytes]:
    """Character ngrams of <word> with boundary markers, fastText-style."""
    w = b"<" + word + b">"
    out = []
    for n in range(minn, maxn + 1):
        for i in range(0, len(w) - n + 1):
            g = w[i : i + n]
            if g != w:  # the full token is handled by the word table
                out.append(g)
    return out


class EmbeddingModel:
    """Word + subword-bucket embeddings with an optional label head."""

    def __init__(
        self,
        vocab: List[bytes],
        input_vectors: np.ndarray,  # f32 [V + buckets, dim]
        labels: List[bytes],
        label_vectors: Optional[np.ndarray],  # f32 [L, dim] or None
        minn: int = 3,
        maxn: int = 5,
        buckets: int = 1 << 17,
        hash_kind: str = "fnv64",  # "fnv64" (native) | "ft32" (.bin models)
    ) -> None:
        self.vocab = vocab
        self.index: Dict[bytes, int] = {w: i for i, w in enumerate(vocab)}
        self.input_vectors = input_vectors.astype(np.float32)
        self.labels = labels
        self.label_vectors = (
            None if label_vectors is None else label_vectors.astype(np.float32)
        )
        self.minn = minn
        self.maxn = maxn
        self.buckets = buckets
        self.hash_kind = hash_kind
        self.dim = input_vectors.shape[1]
        # row ids per word: the hashes are pure Python per byte, and a
        # corpus repeats its words
        self._rows_memo: Dict[bytes, List[int]] = {}
        # unit-normalized word vectors for nearest-neighbour queries
        v = self.input_vectors[: len(vocab)]
        n = np.linalg.norm(v, axis=1, keepdims=True)
        self._unit = v / np.maximum(n, 1e-9)

    # --- embedding ----------------------------------------------------

    def _row_ids(self, word: bytes) -> List[int]:
        memo = self._rows_memo
        ids = memo.get(word)
        if ids is None:
            if len(memo) >= 1 << 17:  # bound host memory on open vocabularies
                memo.clear()
            ids = memo[word] = self._compute_row_ids(word)
        return ids

    def _compute_row_ids(self, word: bytes) -> List[int]:
        ids = []
        wi = self.index.get(word)
        if wi is not None:
            ids.append(wi)
        V = len(self.vocab)
        if self.minn > 0:
            if self.hash_kind == "ft32":
                # pretrained fastText .bin: the model's own hash/subword
                # scheme must be used or bucket rows are garbage
                for h in _ft_subword_hashes(
                    word, self.minn, self.maxn, self.buckets
                ):
                    ids.append(V + h)
            else:
                for g in _subword_ngrams(word, self.minn, self.maxn):
                    ids.append(V + _fnv1a(g) % self.buckets)
        return ids

    def word_vector(self, word: bytes) -> np.ndarray:
        ids = self._row_ids(word)
        if not ids:
            return np.zeros(self.dim, np.float32)
        return self.input_vectors[ids].mean(axis=0)

    def text_vector(self, words: Sequence[bytes]) -> np.ndarray:
        if not words:
            return np.zeros(self.dim, np.float32)
        return np.mean([self.word_vector(w) for w in words], axis=0)

    # --- inference ----------------------------------------------------

    def predict(
        self, words: Sequence[bytes], k: int = 1, threshold: float = 0.0
    ) -> List[Tuple[bytes, float]]:
        """Top-k (label, probability) for a token sequence."""
        assert self.label_vectors is not None, "model has no label head"
        v = self.text_vector(words)
        logits = self.label_vectors @ v
        e = np.exp(logits - logits.max())
        probs = e / e.sum()
        order = np.argsort(-probs)[:k]
        return [
            (self.labels[i], float(probs[i]))
            for i in order
            if probs[i] >= threshold
        ]

    def nearest(self, word: bytes, k: int = 1) -> List[Tuple[bytes, float]]:
        """k nearest vocabulary words by cosine similarity (self excluded)."""
        v = self.word_vector(word)
        n = np.linalg.norm(v)
        if n == 0:
            return []
        sims = self._unit @ (v / n)
        wi = self.index.get(word)
        if wi is not None:
            sims[wi] = -np.inf
        order = np.argsort(-sims)[:k]
        return [(self.vocab[i], float(sims[i])) for i in order]

    # --- persistence --------------------------------------------------

    def save(self, path: str) -> None:
        vocab_blob = b"\x00".join(self.vocab)
        label_blob = b"\x00".join(self.labels)
        np.savez_compressed(
            path,
            vocab=np.frombuffer(vocab_blob, np.uint8),
            labels=np.frombuffer(label_blob, np.uint8),
            input_vectors=self.input_vectors,
            label_vectors=(
                self.label_vectors
                if self.label_vectors is not None
                else np.zeros((0, self.dim), np.float32)
            ),
            config=np.asarray(
                [
                    self.minn,
                    self.maxn,
                    self.buckets,
                    1 if self.hash_kind == "ft32" else 0,
                ],
                np.int64,
            ),
        )

    @staticmethod
    def load(path: str) -> "EmbeddingModel":
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path)
        vocab = bytes(z["vocab"]).split(b"\x00") if z["vocab"].size else []
        labels = bytes(z["labels"]).split(b"\x00") if z["labels"].size else []
        cfg = [int(x) for x in z["config"]]
        minn, maxn, buckets = cfg[:3]
        hash_kind = "ft32" if len(cfg) > 3 and cfg[3] else "fnv64"
        lv = z["label_vectors"]
        return EmbeddingModel(
            vocab,
            z["input_vectors"],
            labels,
            lv if lv.size else None,
            minn=minn,
            maxn=maxn,
            buckets=buckets,
            hash_kind=hash_kind,
        )


_FT_MAGIC = 793712314  # fastText FASTTEXT_FILEFORMAT_MAGIC_INT32


def load_fasttext_bin(path: str) -> EmbeddingModel:
    """Load a pretrained fastText ``.bin`` model (the format the
    reference's classification/nearest_neighbors analyzers consume,
    classification_stream.hpp:37 via vendored external/fastText).

    Layout (fastText FastText::saveModel, format version 11/12):
    magic i32, version i32; Args (12 x i32 + f64 t); Dictionary (size,
    nwords, nlabels i32; ntokens, pruneidx_size i64; entries of
    null-terminated word + count i64 + type i8; pruneidx pairs);
    quant flag i8; input matrix (rows i64, cols i64, f32 data);
    qout flag i8; output matrix. Quantized models are rejected.
    Predictions use the softmax head; hierarchical-softmax /
    negative-sampling outputs load but score approximately.
    """
    import struct

    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _FT_MAGIC:
            raise ValueError(f"{path}: not a fastText .bin model")
        if version > 12:
            raise ValueError(f"unsupported fastText format version {version}")
        (dim, _ws, _epoch, _minc, _neg, _wng, _loss, model_kind, bucket,
         minn, maxn, _lru) = struct.unpack("<12i", f.read(48))
        (_t,) = struct.unpack("<d", f.read(8))
        size, nwords, nlabels = struct.unpack("<3i", f.read(12))
        _ntokens, pruneidx_size = struct.unpack("<2q", f.read(16))
        words: List[bytes] = []
        labels: List[bytes] = []
        buf = f.read()  # the rest; parse with a cursor (faster than 1-byte reads)
        pos = 0
        for _ in range(size):
            end = buf.index(b"\x00", pos)
            w = buf[pos:end]
            pos = end + 1
            _count, etype = struct.unpack_from("<qb", buf, pos)
            pos += 9
            if etype == 0:
                words.append(w)
            else:
                labels.append(w)
        if pruneidx_size > 0:
            pos += 8 * pruneidx_size  # (i32, i32) pairs
        quant = buf[pos]
        pos += 1
        if quant:
            raise ValueError("quantized fastText models are not supported")
        m, n = struct.unpack_from("<2q", buf, pos)
        pos += 16
        inp = np.frombuffer(buf, np.float32, count=m * n, offset=pos).reshape(
            m, n
        )
        pos += 4 * m * n
        qout = buf[pos]
        pos += 1
        out_vec = None
        if not qout:
            m2, n2 = struct.unpack_from("<2q", buf, pos)
            pos += 16
            out_vec = np.frombuffer(
                buf, np.float32, count=m2 * n2, offset=pos
            ).reshape(m2, n2)
        assert len(words) == nwords and len(labels) == nlabels
        assert n == dim and m == nwords + bucket
        label_vectors = (
            out_vec if (model_kind == 3 and out_vec is not None) else None
        )
        return EmbeddingModel(
            words,
            inp,
            labels,
            label_vectors,
            minn=minn,
            maxn=maxn,
            buckets=bucket,
            hash_kind="ft32",
        )


_MODEL_CACHE: Dict[str, EmbeddingModel] = {}


def load_model(path: str) -> EmbeddingModel:
    m = _MODEL_CACHE.get(path)
    if m is None:
        is_bin = path.endswith(".bin")
        if not is_bin and os.path.exists(path):
            with open(path, "rb") as f:
                import struct

                head = f.read(4)
                is_bin = (
                    len(head) == 4
                    and struct.unpack("<i", head)[0] == _FT_MAGIC
                )
        m = load_fasttext_bin(path) if is_bin else EmbeddingModel.load(path)
        _MODEL_CACHE[path] = m
    return m


def doc_rows(
    model: EmbeddingModel, texts: Sequence[Sequence[bytes]]
) -> Tuple[np.ndarray, np.ndarray]:
    """(R i32 [N, maxr], M f32 [N, maxr]): each doc's embedding rows, its
    tokens' rows in order, padded with row 0 under mask 0; a doc with no
    row holds row 0 under mask 1. The JAX package's matrices, built from
    each distinct word's rows once and gathered with numpy."""
    words: Dict[bytes, int] = {}
    tok = np.fromiter(
        (words.setdefault(w, len(words)) for t in texts for w in t),
        np.int64,
    )
    ntok = np.fromiter((len(t) for t in texts), np.int64, len(texts))
    per_word = [model._row_ids(w) for w in words]
    wlen = np.fromiter((len(r) for r in per_word), np.int64, len(per_word))
    wrows = np.fromiter(
        (rid for r in per_word for rid in r), np.int64, int(wlen.sum())
    )
    wstart = np.cumsum(wlen) - wlen
    tlen = wlen[tok]  # rows of each token
    doc_of_tok = np.repeat(np.arange(len(texts)), ntok)
    nrows = np.bincount(doc_of_tok, weights=tlen, minlength=len(texts)).astype(
        np.int64
    )
    flat_tok = np.repeat(np.arange(len(tok)), tlen)
    tstart = np.cumsum(tlen) - tlen
    flat = wrows[wstart[tok][flat_tok] + np.arange(len(flat_tok)) - tstart[flat_tok]]
    dstart = np.cumsum(nrows) - nrows
    doc = doc_of_tok[flat_tok]
    pos = np.arange(len(flat)) - dstart[doc]
    maxr = max(1, int(nrows.max(initial=0)))
    R = np.zeros((len(texts), maxr), np.int32)
    M = np.zeros((len(texts), maxr), np.float32)
    R[doc, pos] = flat
    M[doc, pos] = 1.0
    M[nrows == 0, 0] = 1.0  # the JAX package's ``or [0]``
    return R, M


def train_supervised(
    texts: Sequence[Sequence[bytes]],
    labels: Sequence[bytes],
    dim: int = 16,
    epochs: int = 120,
    lr: float = 0.5,
    minn: int = 3,
    maxn: int = 5,
    buckets: int = 1 << 15,
    min_count: int = 1,
    seed: int = 0,
    *,
    device=None,
) -> EmbeddingModel:
    """Train the label head + embeddings with full-batch softmax GD under
    ``torch.autograd`` on ``device`` (the card when None).

    The doc embedding is mean(input_vectors[rows of its tokens]) and the
    loss is cross-entropy over ``label_vectors @ doc_vec`` — the fastText
    supervised objective, as two matmuls per step instead of the
    reference's per-token SGD loop. Each step is ``p -= lr * grad``, from
    the JAX package's initial values. The gather is ``index_select`` over
    the flattened row ids: its backward is one ``index_add_`` (atomic adds
    on the card, in no fixed order), 3x faster on the card than
    ``F.embedding``'s sorted backward and 70x faster than ``emb[R]``'s
    ``index_put_`` with ``accumulate`` at phase 15's size (``PERF.md``).
    The sums run in another order than the CPU's and the JAX package's, so
    the vectors agree to a float tolerance (``tests/test_torch_embed.py``).
    The model's ``losses`` hold each step's loss (before its update)."""
    import torch

    from iresearch_tpu_torch.device import require_cuda
    from iresearch_tpu_torch.utils.timer import scoped_timer

    dev = require_cuda() if device is None else torch.device(device)
    # vocabulary
    counts: Dict[bytes, int] = {}
    for t in texts:
        for w in t:
            counts[w] = counts.get(w, 0) + 1
    vocab = sorted(w for w, c in counts.items() if c >= min_count)
    label_list = sorted(set(labels))
    lab_idx = {l: i for i, l in enumerate(label_list)}
    model = EmbeddingModel(
        vocab,
        np.zeros((len(vocab) + buckets, dim), np.float32),
        label_list,
        np.zeros((len(label_list), dim), np.float32),
        minn=minn,
        maxn=maxn,
        buckets=buckets,
    )
    with scoped_timer("embed.rows"):
        R, M = doc_rows(model, texts)
    y = np.asarray([lab_idx[l] for l in labels], np.int32)

    rng = np.random.default_rng(seed)
    emb0 = (rng.standard_normal((len(vocab) + buckets, dim)) / dim).astype(
        np.float32
    )
    out0 = np.zeros((len(label_list), dim), np.float32)

    with scoped_timer("embed.train"):
        Rt = torch.from_numpy(R).to(dev)
        Mt = torch.from_numpy(M).to(dev)
        yt = torch.from_numpy(y).to(dev, torch.int64)
        denom = Mt.sum(dim=1).clamp_min(1.0)[:, None]
        emb = torch.from_numpy(emb0).to(dev).requires_grad_()
        out = torch.from_numpy(out0).to(dev).requires_grad_()
        losses = []
        for _ in range(epochs):
            # emb[R]: one index_select, whose backward is one index_add_
            rows = emb.index_select(0, Rt.reshape(-1)).reshape(*Rt.shape, -1)
            tok = rows * Mt[:, :, None]  # [N, maxr, dim]
            doc = tok.sum(dim=1) / denom
            logits = doc @ out.T  # [N, L]
            lse = torch.logsumexp(logits, dim=1)
            loss = (lse - logits.gather(1, yt[:, None])[:, 0]).mean()
            g_emb, g_out = torch.autograd.grad(loss, (emb, out))
            with torch.no_grad():
                emb -= lr * g_emb
                out -= lr * g_out
            losses.append(loss.detach())
            del rows, tok, doc, logits, lse, loss, g_emb, g_out
        model.input_vectors = emb.detach().cpu().numpy()
        model.label_vectors = out.detach().cpu().numpy()
        model.losses = (
            torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
        )
    v = model.input_vectors[: len(vocab)]
    n = np.linalg.norm(v, axis=1, keepdims=True)
    model._unit = v / np.maximum(n, 1e-9)
    return model


# --- analyzers --------------------------------------------------------------


class ClassificationAnalyzer(Analyzer):
    """Emit the model's top-k predicted labels for the whole input as
    tokens (reference: classification_stream.hpp:37; JSON args
    model_location / top_k / threshold)."""

    name = "classification"

    def __init__(
        self,
        model: EmbeddingModel,
        inner,
        top_k: int = 1,
        threshold: float = 0.0,
    ) -> None:
        self._model = model
        self._inner = inner
        self._k = top_k
        self._threshold = threshold

    def tokenize(self, text: str) -> List[Token]:
        words = [t.term for t in self._inner.tokenize(text)]
        preds = self._model.predict(words, k=self._k, threshold=self._threshold)
        # all labels at position 0 (the reference emits them at one pos)
        return [Token(lbl, 0, 0, len(text)) for lbl, _p in preds]

    def terms(self, text: str) -> List[bytes]:
        return [t.term for t in self.tokenize(text)]


class NearestNeighborsAnalyzer(Analyzer):
    """Replace every token with its k nearest neighbour words
    (reference: nearest_neighbors_stream.hpp:38)."""

    name = "nearest_neighbors"

    def __init__(self, model: EmbeddingModel, inner, top_k: int = 1) -> None:
        self._model = model
        self._inner = inner
        self._k = top_k

    def tokenize(self, text: str) -> List[Token]:
        out: List[Token] = []
        for tok in self._inner.tokenize(text):
            for w, _s in self._model.nearest(tok.term, k=self._k):
                out.append(Token(w, tok.position, tok.start, tok.end))
        return out

    def terms(self, text: str) -> List[bytes]:
        return [t.term for t in self.tokenize(text)]
