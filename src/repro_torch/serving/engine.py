"""Batched on-device serving engine, static batching (port of
``repro.serving.engine``).

The standard prefill-then-decode loop over ``transformer.decode_step``:
the non-offloaded comparison point, with every weight resident on the
device. The prompt is fed token by token through ``decode_step``, as in
the JAX package. The JAX engine ``jit``s the step; the port runs it
eagerly.

Greedy output equals the JAX engine's token for token. At temperature
> 0 step j draws with a generator seeded from (seed, j) on the logits'
device (``sampler.request_generator``), so parity with the JAX engine's
threefry draws is statistical only.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.serving.sampler import request_generator, sample_token


class ServingEngine:
    def __init__(self, params, cfg, *, cache_len: int = 512,
                 eos_id: Optional[int] = None, moe_path: str = "auto",
                 window: Optional[int] = None, device="cuda"):
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.cfg = cfg
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.window = window
        self.moe_path = moe_path

    def _step(self, state, tokens, pos: int):
        return tf.decode_step(self.params, self.cfg, state, tokens, pos,
                              window=self.window, moe_path=self.moe_path)

    def generate_batch(self, prompts: Sequence[Sequence[int]], *,
                       max_new: int, temperature: float = 0.0,
                       top_p: float = 1.0, seed: int = 0, enc=None
                       ) -> List[List[int]]:
        """Left-aligned static batch; all prompts padded to equal length
        with token 0 (as in the JAX package: the prompts are synthetic; a
        real deployment would left-pad and mask). ``enc`` [B, T, d]: the
        encoder states (encdec) or patch embeddings (vlm) that the cross
        layers attend to."""
        B = len(prompts)
        plen = max(len(p) for p in prompts)
        rows = [list(p) + [0] * (plen - len(p)) for p in prompts]
        toks = torch.tensor(rows, dtype=torch.long, device=self.device)

        state = tf.init_decode_state(self.params, self.cfg, B,
                                     self.cache_len, enc=enc,
                                     device=self.device)
        logits = None
        for i in range(plen):
            logits, state = self._step(state, toks[:, i:i + 1], i)
        outs: List[List[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        for j in range(max_new):
            gen = request_generator(seed, j, device=logits.device) \
                if temperature > 0.0 else None
            nxt = sample_token(gen, logits, temperature=temperature,
                               top_p=top_p)
            for b, t in enumerate(nxt.tolist()):
                if not done[b]:
                    outs[b].append(t)
                    if self.eos_id is not None and t == self.eos_id:
                        done[b] = True
            if done.all():
                break
            logits, state = self._step(state, nxt[:, None], plen + j)
        return outs
