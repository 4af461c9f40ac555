"""Deterministic, host-shardable synthetic LM data pipeline (own copy of
the reference's ``repro.data.pipeline``: ``SyntheticLMStream`` and
``make_batch_for``).

Generates a structured token stream (a Zipf-ish unigram mix with short-range
Markov structure so the LM has something learnable), deterministically keyed
by (seed, step, host_shard): every host can produce exactly its shard of the
global batch with no coordination, and restarts resume bit-identically --
the property that matters for checkpoint/restart and elastic rescaling.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticLMStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    markov_order: int = 2

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        rng = np.random.RandomState(self.seed)
        # fixed unigram (Zipf) and a sparse bigram successor table
        ranks = np.arange(1, self.vocab + 1)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._succ = rng.randint(0, self.vocab, size=(self.vocab, 4))

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch(self, step: int) -> np.ndarray:
        """(host_batch, seq_len + 1) int32, deterministic in (seed, step, host)."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 65_537 + self.host_id) % 2 ** 31)
        b, s = self.host_batch, self.seq_len + 1
        out = np.empty((b, s), np.int32)
        out[:, 0] = rng.choice(self.vocab, size=b, p=self._unigram)
        for t in range(1, s):
            use_markov = rng.random(b) < 0.7
            succ_pick = self._succ[out[:, t - 1], rng.randint(0, 4, b)]
            fresh = rng.choice(self.vocab, size=b, p=self._unigram)
            out[:, t] = np.where(use_markov, succ_pick, fresh)
        return out



def make_batch_for(cfg, shape, step: int = 0, seed: int = 0,
                   n_hosts: int = 1, host_id: int = 0) -> dict:
    """Concrete numpy batch matching ``ModelAPI.input_specs(shape)``."""
    rng = np.random.RandomState(seed * 7919 + step)
    gb, s = shape.global_batch, shape.seq_len
    f = cfg.family
    if shape.kind == "train":
        if f == "encdec":
            stream = SyntheticLMStream(cfg.vocab, s, gb, seed, n_hosts,
                                       host_id)
            return {"frames": rng.randn(gb // n_hosts, s, cfg.d_model)
                    .astype(np.float32), "tokens": stream.batch(step)}
        if f == "vlm":
            n_txt = s - cfg.n_img_tokens
            stream = SyntheticLMStream(cfg.vocab, n_txt, gb, seed, n_hosts,
                                       host_id)
            return {"patches": rng.randn(gb // n_hosts, cfg.n_img_tokens,
                                         cfg.d_model).astype(np.float32),
                    "tokens": stream.batch(step)}
        stream = SyntheticLMStream(cfg.vocab, s, gb, seed, n_hosts, host_id)
        return {"tokens": stream.batch(step)}
    raise ValueError("make_batch_for is a training-data helper; serving "
                     "inputs come from ModelAPI.input_specs")
