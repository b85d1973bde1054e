"""Batched LM serving engine: prefill + decode with a shared KV pool.

A port of `repro.serving.engine`, quirks included.  Requests carry
prompts; the engine prefills each into a slot of a fixed-slot KV cache
and decodes all active slots in lockstep (continuous batching at the
step level).  The capacity model in `repro_torch.core.planner` sizes how
many of these engines a fleet needs.

On the card the prefill runs the hand-written flash-attention kernel and
each decode step the decode-attention kernel, once per layer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.configs.base import LMConfig
from repro_torch.models import transformer as T

__all__ = ["LMServer"]


@dataclasses.dataclass
class _Slot:
    req_id: int = -1
    remaining: int = 0
    tokens: list = dataclasses.field(default_factory=list)


class LMServer:
    """Fixed-slot continuous-batching decode server (greedy sampling).

    ``params`` is a `repro_torch.models.transformer.Transformer` on
    ``device``; the cache is allocated there.
    """

    def __init__(self, cfg: LMConfig, params: T.Transformer, *,
                 slots: int = 4, max_seq: int = 256,
                 device: DeviceLike = DEFAULT_DEVICE):
        self.device = torch.device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"the weights are on {params.embed.device}, the "
                             f"server on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.slots = [_Slot() for _ in range(slots)]
        self.cache = T.init_kv_cache(cfg, slots, max_seq, device=self.device)
        self.completed: List[dict] = []

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.remaining <= 0:
                return i
        return None

    def admit(self, req_id: int, prompt: np.ndarray, max_new: int) -> bool:
        """Prefill a prompt into a free slot; False if server full."""
        i = self._free_slot()
        if i is None:
            return False
        # per-slot prefill (single-row) seeds that slot's cache lines
        tokens = torch.as_tensor(np.asarray(prompt)[None, :],
                                 dtype=torch.int64, device=self.device)
        logits, cache = T.prefill(self.params, self.cfg, tokens,
                                  chunk=min(len(prompt), 8))
        s = len(prompt)
        self.cache["k"][:, i, :s] = cache["k"][:, 0]
        self.cache["v"][:, i, :s] = cache["v"][:, 0]
        nxt = int(torch.argmax(logits[0, -1]))
        self.slots[i] = _Slot(req_id=req_id, remaining=max_new,
                              tokens=list(prompt) + [nxt])
        return True

    def decode_inputs(self) -> tuple[torch.Tensor, int]:
        """What the next `step` feeds `decode_step`: each slot's last token
        (0 for a free slot), (slots, 1), and the shared cache length."""
        active = [s for s in self.slots if s.remaining > 0]
        cur = torch.tensor([[s.tokens[-1] if s.remaining > 0 else 0]
                            for s in self.slots], dtype=torch.int64,
                           device=self.device)
        # lockstep cache_len: the longest prompt+generated history so far
        # less one; slots use causal masking via cache length (a single
        # shared len keeps the engine simple; a per-slot length mask is
        # the production variant)
        return cur, max(len(s.tokens) for s in active) - 1

    def step(self) -> int:
        """One lockstep decode over all active slots; returns #active."""
        active = [i for i, s in enumerate(self.slots) if s.remaining > 0]
        if not active:
            return 0
        cur, self.cache["len"] = self.decode_inputs()
        logits, self.cache = T.decode_step(self.params, self.cfg, cur,
                                           self.cache)
        nxt = torch.argmax(logits[:, 0], dim=-1).tolist()
        for i in active:
            s = self.slots[i]
            s.tokens.append(int(nxt[i]))
            s.remaining -= 1
            if s.remaining == 0:
                self.completed.append(
                    dict(req_id=s.req_id, tokens=s.tokens))
        return len(active)
