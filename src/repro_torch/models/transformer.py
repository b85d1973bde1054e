"""Decoder-only LM for serving: prefill and decode over a KV cache.

PyTorch port of the serving half of `repro.models.transformer`.  A
`Transformer` module holds the weights: the embedding, a ``ModuleList``
of per-layer `Block`s (the reference stacks them on a leading L axis),
the final norm and an untied LM head (None when the embeddings are
tied).  The reference's functions keep their names and signatures over
it: `init_params`, `init_kv_cache`, `prefill`, `decode_step`.  The layer
loop is a Python loop; each layer's attention goes through the
hand-written CUDA kernels when the tensors are on the card (see
`repro_torch.models.layers`).

The cache is {"k", "v": (L, B, S, KV, D) tensors, "len": host int}; it
is updated **in place** by `decode_step` (the reference returns updated
copies).  Training (`forward_train`, `train_step_loss`) and the MoE
branch are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L

Tensor = torch.Tensor

__all__ = ["Block", "Transformer", "init_params", "init_kv_cache",
           "prefill", "decode_step"]


def _dims(cfg: LMConfig) -> L.AttnDims:
    return L.AttnDims(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Block(nn.Module):
    """One pre-norm decoder layer: attention, then the SwiGLU MLP."""

    def __init__(self, cfg: LMConfig, *,
                 device: DeviceLike = DEFAULT_DEVICE,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln_attn = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ln_mlp = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = L.Attention(_dims(cfg), device=device, dtype=dtype)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, device=device, dtype=dtype)


class Transformer(nn.Module):
    """The weights of one dense LM; uninitialized until `init_params` or
    `repro_torch.interop.lm_params_from_numpy` fills them."""

    def __init__(self, cfg: LMConfig, *, device: DeviceLike = DEFAULT_DEVICE,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: the MoE branch is not ported yet (ROADMAP "
                "queue 1 item 13)")
        dtype = dtype if dtype is not None else _dtype(cfg)
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_padded, cfg.d_model), device=device,
                        dtype=dtype), requires_grad=False)
        self.final_norm = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            Block(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))
        self.lm_head = (None if cfg.tie_embeddings
                        else L._linear(cfg.d_model, cfg.vocab_padded, device,
                                       dtype))


# -------------------------------------------------------------------------
# init
# -------------------------------------------------------------------------

def init_params(seed: Union[int, torch.Generator], cfg: LMConfig, *,
                device: DeviceLike = DEFAULT_DEVICE) -> Transformer:
    """Random weights as the reference draws them: dense matrices normal x
    fan_in^-0.5, the embedding normal x 0.02, norm scales 1; each drawn
    in float32 and cast to ``cfg.dtype``.  ``seed`` is an int or a
    `torch.Generator` on ``device`` (the values are not the reference's:
    Philox is not threefry; tests carry weights across with interop)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(seed)
    model = Transformer(cfg, device=device)
    L._dense_init_(model.embed, gen, scale=0.02)
    if model.lm_head is not None:
        L._dense_init_(model.lm_head.weight, gen)
    for blk in model.layers:
        L.init_attention(blk.attn, generator=gen)
        L.init_mlp(blk.mlp, generator=gen)
    return model


# -------------------------------------------------------------------------
# blocks
# -------------------------------------------------------------------------

def _embed(params: Transformer, cfg: LMConfig, tokens: Tensor) -> Tensor:
    return F.embedding(tokens, params.embed)


def _logits(params: Transformer, cfg: LMConfig, x: Tensor) -> Tensor:
    x = L.rmsnorm(params.final_norm, x)
    head = params.embed if params.lm_head is None else params.lm_head.weight
    return F.linear(x, head)


def _mlp_residual(blk: Block, x: Tensor) -> Tensor:
    return x + L.mlp_swiglu(blk.mlp, L.rmsnorm(blk.ln_mlp, x))


# -------------------------------------------------------------------------
# serving: prefill + decode
# -------------------------------------------------------------------------

def init_kv_cache(cfg: LMConfig, batch: int, max_seq: int, *,
                  device: DeviceLike = DEFAULT_DEVICE) -> dict:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "len": 0}


@torch.no_grad()
def prefill(params: Transformer, cfg: LMConfig, tokens: Tensor, *,
            chunk: int = 2048, impl: str = "auto") -> tuple[Tensor, dict]:
    """tokens (B, S) -> (last-position logits (B, 1, Vp), caches).

    The caches hold the prompt only: (L, B, S, KV, D), "len" = S.
    ``chunk`` has no effect on the computation (see
    `repro_torch.models.layers.attention_prefill_chunked`); S must be a
    multiple of it, as in the reference.
    """
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    dims = _dims(cfg)
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
    ks = torch.empty(shape, dtype=x.dtype, device=x.device)
    vs = torch.empty(shape, dtype=x.dtype, device=x.device)
    for i, blk in enumerate(params.layers):
        h, ks[i], vs[i] = L.attention_prefill_chunked(
            blk.attn, dims, L.rmsnorm(blk.ln_attn, x), chunk=chunk,
            impl=impl)
        x = _mlp_residual(blk, x + h)
    logits = _logits(params, cfg, x[:, -1:, :])
    return logits, {"k": ks, "v": vs, "len": s}


@torch.no_grad()
def decode_step(params: Transformer, cfg: LMConfig, tokens: Tensor,
                cache: dict, *, impl: str = "auto") -> tuple[Tensor, dict]:
    """tokens (B, 1) + caches -> (logits (B, 1, Vp), caches).

    Every row's new K/V is written at ``cache["len"]``, in place in
    ``cache["k"]`` / ``cache["v"]``; the returned dict holds the same
    tensors and ``"len" + 1`` (the dict passed in keeps its "len").
    """
    cache_len = int(cache["len"])
    x = _embed(params, cfg, tokens)
    dims = _dims(cfg)
    for i, blk in enumerate(params.layers):
        h, _, _ = L.attention_decode(
            blk.attn, dims, L.rmsnorm(blk.ln_attn, x), cache["k"][i],
            cache["v"][i], cache_len, impl=impl)
        x = _mlp_residual(blk, x + h)
    logits = _logits(params, cfg, x)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cache_len + 1}
