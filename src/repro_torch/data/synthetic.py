"""Deterministic synthetic data (numpy), copied from src/repro/data/synthetic.py.

Each generator makes the same numpy RNG calls in the same order as the JAX
package's, so both give the same numbers for the same arguments:

  * `synthetic_images`, `noisy_version`, `patch_dataset`: piecewise-smooth
    scenes and their patches (the denoising experiment);
  * `sparse_stream`: the planted sparse-code sample stream (the serving and
    learner workload).  The JAX version draws the planted dictionary as one
    float64 normal array and casts it, which at the production width
    (M = 8192, K = 262144) is 17 GB on the host before the cast.  Here it is
    drawn in row chunks into a preallocated float32 array from the same
    Generator: numpy's stream is sequential, so the values are bit for bit
    the same, and the host holds one float32 copy;
  * `topic_documents`: topic-mixture documents with novel topics arriving
    by step, the stand-in for TDT2 (the novel-document experiment);
  * `TokenStream`, `lm_batches`: the Markov-bigram token stream of the LM
    training path;
  * `audio_batches`: HuBERT-style masked-prediction batches (frame
    features tied to cluster targets, masked frames zeroed);
  * `vlm_batches`: the token stream with precomputed image embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

_CHUNK_VALUES = 1 << 24  # float64 values drawn per chunk (128 MiB)


def synthetic_images(n: int, size: int = 64, seed: int = 0) -> np.ndarray:
    """(n, size, size) piecewise-smooth images in [0, 1]."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    out = np.zeros((n, size, size), np.float32)
    for i in range(n):
        img = np.zeros((size, size), np.float32)
        # smooth background gradient
        gx, gy = rng.normal(size=2) / size
        img += gx * xs + gy * ys + rng.uniform(0.2, 0.8)
        # a few random oriented half-plane edges with intensity steps
        for _ in range(rng.integers(2, 6)):
            theta = rng.uniform(0, np.pi)
            c = rng.uniform(0.2, 0.8) * size
            halfplane = (np.cos(theta) * xs + np.sin(theta) * ys) > c
            img += rng.uniform(-0.5, 0.5) * halfplane
        # a rectangle or two
        for _ in range(rng.integers(1, 3)):
            x0, y0 = rng.integers(0, size - 8, size=2)
            w, h = rng.integers(4, size // 2, size=2)
            img[x0 : x0 + w, y0 : y0 + h] += rng.uniform(-0.4, 0.4)
        img -= img.min()
        img /= max(img.max(), 1e-6)
        out[i] = img
    return out


def noisy_version(images: np.ndarray, sigma: float = 0.2, seed: int = 1) -> np.ndarray:
    """images plus white Gaussian noise of standard deviation sigma."""
    rng = np.random.default_rng(seed)
    return (images + sigma * rng.standard_normal(images.shape)).astype(np.float32)


def patch_dataset(
    images: np.ndarray, patch: int = 10, n_patches: int = 20000, seed: int = 2,
    remove_dc: bool = True,
) -> np.ndarray:
    """(n_patches, patch*patch) random patches, column-major stacked like the
    paper, optionally DC-removed."""
    rng = np.random.default_rng(seed)
    n, h, w = images.shape
    idx_img = rng.integers(0, n, n_patches)
    idx_i = rng.integers(0, h - patch + 1, n_patches)
    idx_j = rng.integers(0, w - patch + 1, n_patches)
    out = np.empty((n_patches, patch * patch), np.float32)
    for t in range(n_patches):
        p = images[idx_img[t], idx_i[t] : idx_i[t] + patch, idx_j[t] : idx_j[t] + patch]
        out[t] = p.T.reshape(-1)  # column-major
    if remove_dc:
        out -= out.mean(axis=1, keepdims=True)
    return out


def planted_dictionary(rng: np.random.Generator, m: int, k: int, nonneg: bool) -> np.ndarray:
    """(m, k) float32 unit-norm columns: rng.normal(size=(m, k)) drawn in
    row chunks, cast, optionally made nonnegative, then column-normalised."""
    W0 = np.empty((m, k), np.float32)
    rows = max(1, _CHUNK_VALUES // max(k, 1))
    for r in range(0, m, rows):
        W0[r:r + rows] = rng.normal(size=(min(rows, m - r), k))
    if nonneg:
        np.abs(W0, out=W0)
    W0 /= np.linalg.norm(W0, axis=0, keepdims=True)
    return W0


def sparse_stream(
    n: int,
    m: int = 32,
    k_true: int = 48,
    sparsity: int = 3,
    noise: float = 0.01,
    nonneg: bool = False,
    seed: int = 0,
    return_dictionary: bool = False,
):
    """(n, m) stream of samples x = W0 y + noise with y `sparsity`-sparse;
    with `return_dictionary=True` also the planted W0 (m, k_true)."""
    rng = np.random.default_rng(seed)
    W0 = planted_dictionary(rng, m, k_true, nonneg)
    Y = np.zeros((n, k_true), np.float32)
    for i in range(n):
        idx = rng.choice(k_true, sparsity, replace=False)
        sign = 1.0 if nonneg else rng.choice([-1.0, 1.0], sparsity)
        Y[i, idx] = rng.uniform(0.5, 1.5, sparsity) * sign
    X = (Y @ W0.T + noise * rng.standard_normal((n, m)).astype(np.float32)).astype(
        np.float32
    )
    if nonneg:
        X = np.abs(X)
    if return_dictionary:
        return X, W0
    return X


@dataclasses.dataclass
class TopicStream:
    docs: np.ndarray  # (T, M) unit-norm nonneg tf-idf-like vectors
    labels: np.ndarray  # (T,) topic id per document
    novel_steps: dict  # step -> set of topic ids first seen at that step


def topic_documents(
    m_vocab: int = 500,
    n_topics: int = 30,
    docs_per_step: int = 500,
    n_steps: int = 8,
    topics_per_step: int = 3,
    words_per_topic: int = 40,
    seed: int = 0,
) -> TopicStream:
    """Documents arrive in blocks; each block may introduce novel topics.

    Topic k has a sparse word distribution; a document mixes 1-2 topics with
    Dirichlet weights + word noise, then is normalized to unit l2 norm
    (matching the paper's preprocessing).
    """
    rng = np.random.default_rng(seed)
    topics = np.zeros((n_topics, m_vocab), np.float32)
    for k in range(n_topics):
        words = rng.choice(m_vocab, words_per_topic, replace=False)
        topics[k, words] = rng.gamma(2.0, 1.0, words_per_topic)
        topics[k] /= topics[k].sum()

    # Topic schedule: steps introduce new topics progressively.
    introduced: list[int] = []
    novel_steps: dict[int, set] = {}
    docs, labels = [], []
    for s in range(n_steps + 1):  # step 0 = the initialization block
        new = list(range(len(introduced), min(len(introduced) + topics_per_step, n_topics)))
        if s == 0:
            new = list(range(0, max(topics_per_step * 2, 4)))
        novel_steps[s] = set(new) if s > 0 else set()
        introduced.extend(new)
        for _ in range(docs_per_step):
            # novel docs appear with prob ~ share of new topics
            if s > 0 and new and rng.random() < 0.3:
                k = int(rng.choice(new))
            else:
                old = introduced[: len(introduced) - len(new)] or introduced
                k = int(rng.choice(old))
            mix = topics[k].copy()
            if rng.random() < 0.3 and len(introduced) > 1:
                k2 = int(rng.choice(introduced))
                w = rng.uniform(0.2, 0.5)
                mix = (1 - w) * mix + w * topics[k2]
            counts = rng.poisson(mix * 200)
            v = counts.astype(np.float32) + 0.01 * rng.random(m_vocab).astype(np.float32)
            v /= max(np.linalg.norm(v), 1e-6)
            docs.append(v)
            labels.append(k)
    return TopicStream(
        docs=np.stack(docs).reshape(n_steps + 1, docs_per_step, m_vocab),
        labels=np.array(labels).reshape(n_steps + 1, docs_per_step),
        novel_steps=novel_steps,
    )


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TokenStream:
    """Deterministic Markov-bigram token stream, shardable by host.

    The transition structure gives each token `branching` likely successors,
    so a model that learns it drops from ln(V) to about ln(branching) nats."""

    vocab: int
    seed: int = 0
    branching: int = 32

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(0, self.vocab, (self.vocab, self.branching))

    def batches(
        self,
        batch: int,
        seq: int,
        n_batches: int,
        host_index: int = 0,
        host_count: int = 1,
    ) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed + 1 + host_index)
        for _ in range(n_batches):
            toks = np.empty((batch, seq), np.int64)
            state = rng.integers(0, self.vocab, batch)
            for t in range(seq):
                toks[:, t] = state
                choice = rng.integers(0, self.branching, batch)
                state = self._succ[state, choice]
            yield toks.astype(np.int32)


def lm_batches(vocab: int, batch: int, seq: int, n_batches: int, seed: int = 0):
    return TokenStream(vocab, seed).batches(batch, seq, n_batches)


def audio_batches(frame_dim: int, vocab: int, batch: int, seq: int, n_batches: int,
                  mask_frac: float = 0.08, seed: int = 0):
    """HuBERT-style masked-prediction batches: {"features" (B, T, frame_dim)
    float32, "targets" (B, T) int32, "mask" (B, T) bool}."""
    rng = np.random.default_rng(seed)
    # cluster centroids tie features to targets so the task is learnable
    centroids = rng.standard_normal((vocab, frame_dim)).astype(np.float32)
    for _ in range(n_batches):
        targets = rng.integers(0, vocab, (batch, seq))
        feats = centroids[targets] + 0.3 * rng.standard_normal((batch, seq, frame_dim)).astype(np.float32)
        mask = rng.random((batch, seq)) < mask_frac
        feats = feats.copy()
        feats[mask] = 0.0  # masked frames are zeroed (stub for the learned mask emb)
        yield {
            "features": feats.astype(np.float32),
            "targets": targets.astype(np.int32),
            "mask": mask,
        }


def vlm_batches(vocab: int, n_img_tokens: int, vision_dim: int, batch: int,
                seq_text: int, n_batches: int, seed: int = 0):
    """{"tokens" (B, seq_text) int32 from the token stream, "img_embeds"
    (B, n_img_tokens, vision_dim) float32 standard normal}."""
    rng = np.random.default_rng(seed)
    stream = TokenStream(vocab, seed)
    for toks in stream.batches(batch, seq_text, n_batches):
        yield {
            "tokens": toks,
            "img_embeds": rng.standard_normal((batch, n_img_tokens, vision_dim)).astype(np.float32),
        }
