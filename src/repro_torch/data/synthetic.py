"""Synthetic datasets.

CIFAR-scale image classification cannot ship in this offline container, so
the accuracy experiments use a controllable synthetic image task with the
same *statistical structure* the paper exploits: many classes, per-class
visual templates, label-skewed non-IID partitions.  Personalization helps
exactly as in the paper because each client sees a narrow label slice.

``make_image_classification`` draws one smooth random template per class and
adds i.i.d. Gaussian pixel noise; difficulty is controlled by the
noise/template ratio.  ``make_lm_corpus`` builds an order-1 Markov token
stream per latent "domain" for the LM training loop (a line-for-line copy
of the reference's, so the streams are equal bit for bit).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dataset:
    x: np.ndarray          # (N, H, W, C) float32 or (N, S) int32 for LM
    y: np.ndarray          # (N,) int labels or (N, S) next tokens
    n_classes: int


def _smooth_template(rng, hw: int, c: int) -> np.ndarray:
    """Low-frequency random image in [-1, 1]."""
    base = rng.normal(size=(4, 4, c))
    # bilinear upsample to (hw, hw)
    idx = np.linspace(0, 3, hw)
    x0 = np.floor(idx).astype(int)
    x1 = np.minimum(x0 + 1, 3)
    f = (idx - x0)[:, None]
    rows = base[x0] * (1 - f)[..., None] + base[x1] * f[..., None]
    g = (idx - x0)[None, :, None]
    out = rows[:, x0] * (1 - g) + rows[:, x1] * g
    return out / (np.abs(out).max() + 1e-8)


def make_image_classification(
    seed: int,
    n_classes: int = 10,
    n_train_per_class: int = 100,
    n_test_per_class: int = 40,
    hw: int = 16,
    channels: int = 3,
    noise: float = 0.8,
) -> tuple[Dataset, Dataset]:
    rng = np.random.default_rng(seed)
    templates = np.stack([_smooth_template(rng, hw, channels)
                          for _ in range(n_classes)])

    def draw(n_per):
        xs, ys = [], []
        for c in range(n_classes):
            imgs = templates[c][None] + noise * rng.normal(
                size=(n_per, hw, hw, channels))
            xs.append(imgs.astype(np.float32))
            ys.append(np.full((n_per,), c, np.int32))
        return Dataset(np.concatenate(xs), np.concatenate(ys), n_classes)

    return draw(n_train_per_class), draw(n_test_per_class)


def make_lm_corpus(
    seed: int,
    vocab: int = 256,
    n_domains: int = 4,
    tokens_per_domain: int = 65536,
    temperature: float = 1.5,
) -> list[np.ndarray]:
    """One Markov-chain token stream per domain (per-client domains make the
    LM task non-IID)."""
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(n_domains):
        logits = rng.normal(size=(vocab, vocab)) * temperature
        probs = np.exp(logits - logits.max(1, keepdims=True))
        probs /= probs.sum(1, keepdims=True)
        toks = np.empty((tokens_per_domain,), np.int32)
        t = rng.integers(vocab)
        for i in range(tokens_per_domain):
            t = rng.choice(vocab, p=probs[t])
            toks[i] = t
        streams.append(toks)
    return streams
