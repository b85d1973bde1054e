"""Transformer building blocks: RMSNorm, RoPE, GQA attention, SwiGLU.

PyTorch port of `repro.models.layers`.  Modules hold the weights
(`RMSNorm`, `Attention`, `MLP`, created with ``requires_grad`` off:
serving runs without autograd, and `repro_torch.train.trainer.TrainStep`
turns gradients on for what it trains); the reference's functions keep
their names and take a module where the reference takes a parameter
dict (``rmsnorm(params, x)`` reads ``params.scale``).  Projections are
`torch.nn.Linear` (weight (out, in)); `repro_torch.interop
.lm_params_from_numpy` transposes the reference's (in, out) matrices
into them.

The two attention calls of the serving path go through the hand-written
kernels: `attention_prefill_chunked` through
`repro_torch.kernels.flash_attention` and `attention_decode` through
`repro_torch.kernels.decode_attention`.  ``impl="auto"`` takes the kernel
for CUDA tensors and the plain version for CPU tensors.  Both keep the
softmax's running max, sum and accumulator in float32, as the Pallas
kernels do; the reference's plain-JAX attention keeps the accumulator
and the probabilities in the model's dtype (ROADMAP queue 3), so in
bfloat16 the two differ by more than output rounding.

Training's attention, `attention_train`, is the reference's plain
attention, differentiated by autograd (no TPU kernel of the reference
has a backward): the full causal softmax, or the blockwise recurrence
with each block pair rematerialised (`torch.utils.checkpoint`, where
the reference applies ``jax.checkpoint``).  It keeps the reference's
dtypes: scores and softmax statistics in float32, probabilities and the
accumulator in the model's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops

Tensor = torch.Tensor

__all__ = ["RMSNorm", "init_rmsnorm", "rmsnorm", "rope_frequencies",
           "apply_rope", "AttnDims", "Attention", "init_attention",
           "attention_train", "attention_prefill_chunked",
           "attention_decode", "MLP", "init_mlp", "mlp_swiglu"]


# -------------------------------------------------------------------------
# init helpers
# -------------------------------------------------------------------------

def _frozen(t: Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _linear(d_in: int, d_out: int, device: DeviceLike,
            dtype: Optional[torch.dtype]) -> nn.Linear:
    """An uninitialized bias-free projection (filled by `_dense_init_` or
    by interop)."""
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=False,
                             device=device, dtype=dtype)
    lin.weight.requires_grad_(False)
    return lin


@torch.no_grad()
def _dense_init_(weight: Tensor, generator: torch.Generator,
                 scale: Optional[float] = None) -> None:
    """The reference's ``_dense_init``: normal x fan_in^-0.5 (or
    ``scale``), drawn in float32 and cast.  ``weight`` is (out, in) as in
    `nn.Linear`, or (rows, d) for the embedding (``scale`` given)."""
    scale = scale if scale is not None else weight.shape[1] ** -0.5
    draw = torch.randn(weight.shape, generator=generator,
                       dtype=torch.float32, device=weight.device)
    weight.copy_(draw.mul_(scale))       # one float32 temporary, not two


# -------------------------------------------------------------------------
# RMSNorm
# -------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, *,
                 device: DeviceLike = DEFAULT_DEVICE,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale = _frozen(torch.ones(d, device=device, dtype=dtype))


def init_rmsnorm(d: int, dtype: Optional[torch.dtype] = None, *,
                 device: DeviceLike = DEFAULT_DEVICE) -> RMSNorm:
    """The reference's ``init_rmsnorm``: a norm of width ``d`` whose scale
    is ones in ``dtype`` (an `RMSNorm`, the port's holder of that
    scale)."""
    return RMSNorm(d, device=device, dtype=dtype)


def rmsnorm(params: RMSNorm, x: Tensor, eps: float = 1e-6) -> Tensor:
    """Normalize the last axis in float32, scale, cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params.scale.float()).to(x.dtype)


# -------------------------------------------------------------------------
# RoPE
# -------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float, *,
                     device: DeviceLike = DEFAULT_DEVICE) -> Tensor:
    return theta ** (-torch.arange(0, d_head, 2, dtype=torch.float32,
                                   device=device) / d_head)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq).

    Split halves (not interleaved): the first and second halves of d_head
    are the real and imaginary parts.
    """
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------------
# GQA attention
# -------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool
    rope_theta: float


class Attention(nn.Module):
    """wq, wk, wv, wo (bias-free), and per-head q/k norms under qk-norm."""

    def __init__(self, dims: AttnDims, *,
                 device: DeviceLike = DEFAULT_DEVICE,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, h, kvh, dh = dims.d_model, dims.n_heads, dims.n_kv_heads, \
            dims.d_head
        self.wq = _linear(d, h * dh, device, dtype)
        self.wk = _linear(d, kvh * dh, device, dtype)
        self.wv = _linear(d, kvh * dh, device, dtype)
        self.wo = _linear(h * dh, d, device, dtype)
        self.q_norm = (RMSNorm(dh, device=device, dtype=dtype)
                       if dims.qk_norm else None)
        self.k_norm = (RMSNorm(dh, device=device, dtype=dtype)
                       if dims.qk_norm else None)


def init_attention(params: Attention, *,
                   generator: torch.Generator) -> Attention:
    """Draw ``params``' projections in place (`_dense_init_`), on the
    device and in the dtype they were allocated with; returns them."""
    for lin in (params.wq, params.wk, params.wv, params.wo):
        _dense_init_(lin.weight, generator)
    return params


def _project_qkv(params: Attention, dims: AttnDims, x: Tensor,
                 positions: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(B, S, d_model) -> q (B, S, H, Dh), k and v (B, S, KV, Dh); q and k
    normed per head (qk-norm) before RoPE."""
    b, s, _ = x.shape
    h, kvh, dh = dims.n_heads, dims.n_kv_heads, dims.d_head
    q = params.wq(x).view(b, s, h, dh)
    k = params.wk(x).view(b, s, kvh, dh)
    v = params.wv(x).view(b, s, kvh, dh)
    if dims.qk_norm:
        q = rmsnorm(params.q_norm, q)
        k = rmsnorm(params.k_norm, k)
    q = apply_rope(q, positions, dims.rope_theta)
    k = apply_rope(k, positions, dims.rope_theta)
    return q, k, v


def _gqa_scores(q: Tensor, k: Tensor, groups: int) -> Tensor:
    """(B, Sq, H, D) x (B, Sk, KV, D) -> (B, KV, G, Sq, Sk), H = KV * G,
    scaled by D^-1/2, in the inputs' dtype."""
    b, sq, h, dh = q.shape
    qg = q.reshape(b, sq, k.shape[2], groups, dh)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k) * (dh ** -0.5)


def _gqa_output(probs: Tensor, v: Tensor) -> Tensor:
    """(B, KV, G, Sq, Sk) x (B, Sk, KV, D) -> (B, Sq, H, D)."""
    b, kvh, g, sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, kvh * g, v.shape[-1])


def _chunk_step(qi: Tensor, kj: Tensor, vj: Tensor, m: Tensor, l: Tensor,
                acc: Tensor, diagonal: bool, chunk: int, g: int,
                dtype: torch.dtype) -> tuple[Tensor, Tensor, Tensor]:
    """One flash block: update the running (max, sum, acc) with the block
    (qi, kj).  Only a diagonal block needs the causal mask: the blocks
    below it are wholly causal (the reference masks them too, with an
    all-true mask), the blocks above are skipped."""
    sc = _gqa_scores(qi, kj, g).float()                  # (B, KV, G, C, C)
    if diagonal:
        causal = torch.ones(chunk, chunk, dtype=torch.bool,
                            device=sc.device).tril()
        sc = sc.masked_fill(~causal, -torch.inf)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    pr = torch.exp(sc - m_new[..., None])
    l_new = l * alpha + pr.sum(dim=-1)
    acc_new = (acc * alpha[..., None].to(dtype)
               + torch.einsum("bkgqs,bskd->bkgqd", pr.to(dtype), vj))
    return m_new, l_new, acc_new


def _chunked_causal_attention(qc: Tensor, kc: Tensor, vc: Tensor,
                              dims: AttnDims, chunk: int,
                              dtype: torch.dtype) -> Tensor:
    """qc (B, N, C, H, D), kc / vc (B, N, C, KV, D) -> out (B, N*C, H*D).

    The flash recurrence in plain torch, as the reference's unrolled path:
    static loops that skip the acausal block pairs, each pair
    rematerialised, so backward recomputes a pair's (C x C) probabilities
    instead of holding every pair's float32 tile.
    """
    b, n_chunks, _, _, dh = qc.shape
    g = dims.n_heads // dims.n_kv_heads
    kvh = dims.n_kv_heads
    outs = []
    for qi_idx in range(n_chunks):
        qi = qc[:, qi_idx]
        m = torch.full((b, kvh, g, chunk), -torch.inf, dtype=torch.float32,
                       device=qc.device)
        l = torch.zeros((b, kvh, g, chunk), dtype=torch.float32,
                        device=qc.device)
        acc = torch.zeros((b, kvh, g, chunk, dh), dtype=dtype,
                          device=qc.device)
        for kj_idx in range(qi_idx + 1):        # causal: skip kj > qi
            m, l, acc = ckpt.checkpoint(
                _chunk_step, qi, kc[:, kj_idx], vc[:, kj_idx], m, l, acc,
                kj_idx == qi_idx, chunk, g, dtype, use_reentrant=False)
        out = acc / torch.clamp_min(l, 1e-30)[..., None].to(dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, chunk, -1))
    return torch.cat(outs, dim=1)


def attention_train(params: Attention, dims: AttnDims, x: Tensor, *,
                    chunk: int = 0) -> Tensor:
    """Causal self-attention for training, differentiable.

    ``chunk == 0`` (or ``chunk >= S``): the full-softmax path (scores (B,
    KV, G, S, S) in float32).  Otherwise the blockwise path, S a multiple
    of ``chunk``.
    """
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, dims, x, positions)
    g = dims.n_heads // dims.n_kv_heads
    if chunk and chunk < s:
        if s % chunk:
            raise ValueError(f"sequence length {s} is not a multiple of "
                             f"the chunk {chunk}")
        n = s // chunk
        out = _chunked_causal_attention(
            q.reshape(b, n, chunk, dims.n_heads, dims.d_head),
            k.reshape(b, n, chunk, dims.n_kv_heads, dims.d_head),
            v.reshape(b, n, chunk, dims.n_kv_heads, dims.d_head),
            dims, chunk, x.dtype)
    else:
        scores = _gqa_scores(q, k, g).float()
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, -torch.inf)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = _gqa_output(probs, v).reshape(b, s, -1)
    return params.wo(out)


def attention_prefill_chunked(params: Attention, dims: AttnDims, x: Tensor,
                              chunk: int = 2048, *, impl: str = "auto"
                              ) -> tuple[Tensor, Tensor, Tensor]:
    """Causal attention over a prompt from position 0, returning
    (out, K, V) to seed the cache; K after qk-norm and RoPE.

    The flash kernel tiles the sequence itself: ``chunk`` has no effect on
    the computation.  It is the reference's block length, kept for its
    signature and its contract (the prompt length must be a multiple of
    it).
    """
    b, s, _ = x.shape
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, dims, x, positions)
    out = flash_ops.flash_attention(q, k, v, causal=True, impl=impl)
    return params.wo(out.reshape(b, s, -1)), k, v


def attention_decode(params: Attention, dims: AttnDims, x: Tensor,
                     k_cache: Tensor, v_cache: Tensor, cache_len: int, *,
                     impl: str = "auto") -> tuple[Tensor, Tensor, Tensor]:
    """One decode step: x (B, 1, d_model) against caches (B, S, KV, Dh).

    Writes the new K/V at ``cache_len`` **in place** (the reference
    returns updated copies), then attends positions 0..``cache_len``.
    Returns (out, k_cache, v_cache), the caches being the tensors passed
    in.  ``cache_len`` must index the cache (the reference's XLA update
    clamps it instead).
    """
    b = x.shape[0]
    if not 0 <= cache_len < k_cache.shape[1]:
        raise ValueError(f"cache_len {cache_len} is outside the cache's "
                         f"{k_cache.shape[1]} positions")
    positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(params, dims, x, positions)
    k_cache[:, cache_len] = k_new[:, 0]
    v_cache[:, cache_len] = v_new[:, 0]
    out = decode_ops.decode_attention(q, k_cache, v_cache, cache_len,
                                      impl=impl)
    return params.wo(out.reshape(b, 1, -1)), k_cache, v_cache


# -------------------------------------------------------------------------
# SwiGLU MLP
# -------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *,
                 device: DeviceLike = DEFAULT_DEVICE,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.w_gate = _linear(d_model, d_ff, device, dtype)
        self.w_up = _linear(d_model, d_ff, device, dtype)
        self.w_down = _linear(d_ff, d_model, device, dtype)


def init_mlp(params: MLP, *, generator: torch.Generator) -> MLP:
    """Draw ``params``' projections in place; returns them."""
    for lin in (params.w_gate, params.w_up, params.w_down):
        _dense_init_(lin.weight, generator)
    return params


def mlp_swiglu(params: MLP, x: Tensor) -> Tensor:
    return params.w_down(F.silu(params.w_gate(x)) * params.w_up(x))
