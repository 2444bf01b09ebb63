"""Deterministic synthetic data pipeline: the port's own copy of
``repro.data.pipeline`` (numpy only; the reference package is never
imported).

A seeded mixture of Markov chains over the vocabulary — learnable structure
(a transformer drives the loss well below the unigram entropy), fully
offline, and reproducible across restarts: batch ``i`` is a pure function of
(seed, i), which is what makes checkpoint-resume exactly replayable and
elastic rescaling deterministic (the stream is indexed by *global step*,
not by host).  Host-sharding: each host materializes only its slice.

:meth:`TokenStream.batch` gives the reference's numpy arrays bit for bit,
whisper's ``frames`` and the vlm's ``patch_embeds`` stubs included;
:meth:`TokenStream.tensors` puts them on a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class TokenStream:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    order: int = 1            # markov order
    num_chains: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.cfg.vocab_size, 4096)
        self.v = v
        # sparse-ish row-stochastic transitions, peaked for learnability
        self.trans = np.zeros((self.num_chains, v, 8), np.int64)
        for c in range(self.num_chains):
            self.trans[c] = rng.integers(0, v, (v, 8))

    def batch(self, step: int, *, host_id: int = 0, num_hosts: int = 1):
        """Global batch slice for this host: dict(tokens, labels[, stubs])
        of numpy arrays."""
        b = self.shape.global_batch // num_hosts
        s = self.shape.seq_len
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + host_id)
        chain = rng.integers(0, self.num_chains, b)
        toks = np.zeros((b, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.v, b)
        for t in range(s):
            nxt = self.trans[chain, toks[:, t],
                             rng.integers(0, 8, b)]
            # occasional uniform noise keeps entropy positive
            noise = rng.random(b) < 0.1
            toks[:, t + 1] = np.where(noise, rng.integers(0, self.v, b), nxt)
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        out = {"tokens": tokens, "labels": labels}
        d = self.cfg.d_model
        if self.cfg.encoder_layers:
            out["frames"] = rng.standard_normal(
                (b, self.cfg.encoder_seq, d)).astype(np.float32)
        elif self.cfg.frontend == "patch":
            f = self.cfg.frontend_seq
            out["patch_embeds"] = rng.standard_normal(
                (b, f, d)).astype(np.float32)
            out["tokens"] = tokens[:, :s - f]
            out["labels"] = labels
        return out

    def tensors(self, step: int, *, host_id: int = 0, num_hosts: int = 1,
                device="cuda") -> dict[str, torch.Tensor]:
        """:meth:`batch` as tensors on ``device`` (same dtypes)."""
        device = resolve_device(device)
        return {k: torch.from_numpy(a).to(device) for k, a in
                self.batch(step, host_id=host_id,
                           num_hosts=num_hosts).items()}
