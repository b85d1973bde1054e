"""Decoder-only LM: training, and serving (prefill and decode over a KV
cache).

PyTorch port of `repro.models.transformer`.  A
`Transformer` module holds the weights: the embedding, a ``ModuleList``
of per-layer `Block`s (the reference stacks them on a leading L axis),
the final norm and an untied LM head (None when the embeddings are
tied).  The reference's functions keep their names and signatures over
it: `init_params`, `init_kv_cache`, `prefill`, `decode_step`, and for
training `forward_train`, `forward_hidden`, `cross_entropy_sharded`,
`chunked_lm_loss` and `train_step_loss`.  The layer loop is a Python
loop.  At serving each layer's attention goes through the hand-written
CUDA kernels when the tensors are on the card (see
`repro_torch.models.layers`); `prefill` and `decode_step` run under
``torch.no_grad()``.  Training runs the reference's plain attention
(`layers.attention_train`, ``cfg.attn_chunk`` choosing the full or the
blockwise path) under autograd, each layer rematerialised under
``remat`` (`torch.utils.checkpoint`, the reference's
``nothing_saveable`` policy), and the LM head and loss a sequence chunk
at a time, so the whole (B, S, Vp) logits never exist.

A layer's FFN is the SwiGLU `layers.MLP`, or for a config with
``cfg.moe`` the experts of `repro_torch.models.moe` (its aux loss is
dropped at serving, as the reference drops it; training adds its mean
over layers to the loss).  The cache is {"k", "v": (L, B, S, KV, D)
tensors, "len": host int}; it is updated **in place** by `decode_step`
(the reference returns updated copies).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib

Tensor = torch.Tensor

__all__ = ["Block", "Transformer", "init_params", "forward_train",
           "forward_hidden", "cross_entropy_sharded", "chunked_lm_loss",
           "train_step_loss", "init_kv_cache", "prefill", "decode_step"]


def _dims(cfg: LMConfig) -> L.AttnDims:
    return L.AttnDims(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Block(nn.Module):
    """One pre-norm decoder layer: attention, then the SwiGLU MLP
    (``mlp``) or, for an MoE config, the experts (``moe``); the other
    is None."""

    def __init__(self, cfg: LMConfig, *,
                 device: DeviceLike = DEFAULT_DEVICE,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln_attn = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ln_mlp = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = L.Attention(_dims(cfg), device=device, dtype=dtype)
        if cfg.moe is not None:
            self.mlp = None
            self.moe = moe_lib.MoE(cfg.d_model, cfg.moe, device=device,
                                   dtype=dtype)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, device=device,
                             dtype=dtype)
            self.moe = None


class Transformer(nn.Module):
    """The weights of one dense or MoE LM; uninitialized until
    `init_params` or `repro_torch.interop.lm_params_from_numpy` fills
    them."""

    def __init__(self, cfg: LMConfig, *, device: DeviceLike = DEFAULT_DEVICE,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
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
    fan_in^-0.5, the embedding normal x 0.02, norm scales 1, the experts
    as `moe.init_moe`; each drawn in float32 and cast to ``cfg.dtype``.  ``seed`` is an int or a
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
        if blk.moe is not None:
            moe_lib.init_moe(blk.moe, generator=gen)
        else:
            L.init_mlp(blk.mlp, generator=gen)
    return model


# -------------------------------------------------------------------------
# blocks
# -------------------------------------------------------------------------

def _embed(params: Transformer, cfg: LMConfig, tokens: Tensor) -> Tensor:
    return F.embedding(tokens, params.embed)


def _head(params: Transformer) -> Tensor:
    return params.embed if params.lm_head is None else params.lm_head.weight


def _logits(params: Transformer, cfg: LMConfig, x: Tensor) -> Tensor:
    return F.linear(L.rmsnorm(params.final_norm, x), _head(params))


def _mlp_residual(blk: Block, cfg: LMConfig, x: Tensor) -> Tensor:
    y = L.rmsnorm(blk.ln_mlp, x)
    if blk.moe is not None:
        f, _ = moe_lib.moe_ffn(blk.moe, cfg.moe, y)
    else:
        f = L.mlp_swiglu(blk.mlp, y)
    return x + f


def _block_train(blk: Block, cfg: LMConfig, x: Tensor
                 ) -> tuple[Tensor, Tensor]:
    h = L.attention_train(blk.attn, _dims(cfg), L.rmsnorm(blk.ln_attn, x),
                          chunk=cfg.attn_chunk)
    x = x + h
    y = L.rmsnorm(blk.ln_mlp, x)
    if blk.moe is not None:
        f, aux = moe_lib.moe_ffn(blk.moe, cfg.moe, y)
    else:
        f = L.mlp_swiglu(blk.mlp, y)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux


# -------------------------------------------------------------------------
# train
# -------------------------------------------------------------------------

def _layers_train(params: Transformer, cfg: LMConfig, tokens: Tensor,
                  remat: bool) -> tuple[Tensor, Tensor]:
    """The embedding and every layer: (x (B, S, d), the mean aux loss)."""
    x = _embed(params, cfg, tokens)
    auxes = []
    for blk in params.layers:
        if remat:
            x, aux = ckpt.checkpoint(_block_train, blk, cfg, x,
                                     use_reentrant=False)
        else:
            x, aux = _block_train(blk, cfg, x)
        auxes.append(aux)
    return x, torch.stack(auxes).mean()


def forward_train(params: Transformer, cfg: LMConfig, tokens: Tensor,
                  remat: bool = True) -> tuple[Tensor, Tensor]:
    """tokens (B, S) -> (logits (B, S, Vp), aux loss (0-dim float32))."""
    x, aux = _layers_train(params, cfg, tokens, remat)
    return _logits(params, cfg, x), aux


def forward_hidden(params: Transformer, cfg: LMConfig, tokens: Tensor,
                   remat: bool = True) -> tuple[Tensor, Tensor]:
    """Like `forward_train` but stops before the LM head: (the final
    norm's output (B, S, d), aux)."""
    x, aux = _layers_train(params, cfg, tokens, remat)
    return L.rmsnorm(params.final_norm, x), aux


def _nll_sum(logits: Tensor, labels: Tensor) -> tuple[Tensor, Tensor]:
    """(sum of the token NLLs over labels >= 0, their count), float32.
    The log-normaliser's max is a constant to autograd, as the
    reference's ``stop_gradient``."""
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]
    mask = labels >= 0
    correct = x.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    return ((lse - correct) * mask).sum(), mask.sum().float()


def cross_entropy_sharded(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean token cross-entropy of logits (..., V) against labels (...);
    labels < 0 are masked."""
    total, count = _nll_sum(logits, labels)
    return total / torch.clamp_min(count, 1)


def _loss_piece(xc: Tensor, head: Tensor, lc: Tensor
                ) -> tuple[Tensor, Tensor]:
    return _nll_sum(F.linear(xc, head), lc)


def chunked_lm_loss(params: Transformer, cfg: LMConfig, x: Tensor,
                    labels: Tensor, chunk: int = 2048) -> Tensor:
    """LM head + cross-entropy in sequence chunks, each rematerialised:
    a chunk's logits are made, reduced to its NLL sum and freed, and
    backward recomputes them; the sums are normalised at the end, so
    chunking is exact.  S must be a multiple of min(chunk, S)."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    head = _head(params)
    total = count = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, c = ckpt.checkpoint(_loss_piece, x[:, sl], head, labels[:, sl],
                               use_reentrant=False)
        total = total + t
        count = count + c
    return total / torch.clamp_min(count, 1)


def train_step_loss(params: Transformer, cfg: LMConfig, tokens: Tensor,
                    labels: Tensor, *, aux_weight: float = 0.01) -> Tensor:
    """Causal LM cross-entropy (+ the MoE aux loss), mean over tokens;
    labels < 0 are masked."""
    x, aux = forward_hidden(params, cfg, tokens)
    return chunked_lm_loss(params, cfg, x, labels) + aux_weight * aux


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
        x = _mlp_residual(blk, cfg, x + h)
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
        x = _mlp_residual(blk, cfg, x + h)
    logits = _logits(params, cfg, x)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cache_len + 1}
