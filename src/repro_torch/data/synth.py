"""Synthetic dataset builders (offline container: no real MNIST/CIFAR/corpus;
dataset layout DESIGN.md §4, streamed through the §11 ingest plane).

* ``make_token_dataset`` — Zipfian token documents packed to fixed length,
  written as a RaDataset (uint32 tokens). Used by the e2e LM example.
* ``make_image_dataset`` — MNIST-like (28x28x1) or CIFAR-like (36x36x3)
  uint8 images with enough spatial structure that PNG compresses
  realistically (~2-3x), for the paper's Fig-3 benchmark.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .dataset import RaDatasetWriter


def make_token_dataset(
    root: str,
    *,
    n_docs: int = 4096,
    seq_len: int = 1024,
    vocab: int = 8192,
    seed: int = 0,
    shard_rows: int = 1024,
) -> str:
    """Zipf-distributed tokens with local repetition structure (so the tiny
    LM has something learnable: token t+1 correlates with token t)."""
    rng = np.random.default_rng(seed)
    w = RaDatasetWriter(root, {"tokens": ((seq_len,), "uint32")}, shard_rows=shard_rows)
    # markov-ish: next token = f(current) with noise
    perm = rng.permutation(vocab)
    for lo in range(0, n_docs, 256):
        n = min(256, n_docs - lo)
        toks = np.empty((n, seq_len), dtype=np.uint32)
        cur = rng.zipf(1.3, size=n).clip(1, vocab - 1)
        for t in range(seq_len):
            toks[:, t] = cur
            follow = perm[cur]  # deterministic successor
            noise = rng.zipf(1.3, size=n).clip(1, vocab - 1)
            take_follow = rng.random(n) < 0.7
            cur = np.where(take_follow, follow, noise) % vocab
        w.append(tokens=toks)
    w.finish({"vocab": vocab, "seq_len": seq_len, "seed": seed})
    return root


def _structured_images(rng, n: int, h: int, w: int, c: int) -> np.ndarray:
    """Images with smooth gradients + shapes: PNG-compressible like real data."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.empty((n, h, w, c), dtype=np.uint8)
    for i in range(n):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(h / 8, h / 2)
        base = 127 + 120 * np.sin(xx / w * rng.uniform(1, 6) + rng.uniform(0, 6)) * np.cos(
            yy / h * rng.uniform(1, 6)
        )
        blob = (((xx - cx) ** 2 + (yy - cy) ** 2) < r * r) * rng.uniform(40, 120)
        img = np.clip(base + blob, 0, 255)
        for ch in range(c):
            imgs[i, :, :, ch] = np.clip(img * rng.uniform(0.7, 1.0), 0, 255).astype(np.uint8)
    return imgs


def make_image_dataset(
    root: str,
    *,
    kind: str = "mnist",  # 'mnist' (28x28x1) | 'cifar' (36x36x3)
    n: int = 4096,
    seed: int = 0,
    shard_rows: int = 4096,
) -> str:
    h, w, c = (28, 28, 1) if kind == "mnist" else (36, 36, 3)
    rng = np.random.default_rng(seed)
    wri = RaDatasetWriter(
        root,
        {"image": ((h, w, c), "uint8"), "label": ((), "int32")},
        shard_rows=shard_rows,
    )
    for lo in range(0, n, 1024):
        k = min(1024, n - lo)
        wri.append(
            image=_structured_images(rng, k, h, w, c),
            label=rng.integers(0, 10, size=k).astype(np.int32),
        )
    wri.finish({"kind": kind, "n": n})
    return root
