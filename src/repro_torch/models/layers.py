"""Transformer building blocks for serving: RMSNorm, RoPE, GQA attention,
SwiGLU.

PyTorch port of the serving half of `repro.models.layers`.  Modules hold
the weights (`RMSNorm`, `Attention`, `MLP`, each with ``requires_grad``
off); the reference's functions keep their names and take a module where
the reference takes a parameter dict (``rmsnorm(params, x)`` reads
``params.scale``).  Projections are `torch.nn.Linear` (weight (out, in));
`repro_torch.interop.lm_params_from_numpy` transposes the reference's
(in, out) matrices into them.

The two attention calls of the serving path go through the hand-written
kernels: `attention_prefill_chunked` through
`repro_torch.kernels.flash_attention` and `attention_decode` through
`repro_torch.kernels.decode_attention`.  ``impl="auto"`` takes the kernel
for CUDA tensors and the plain version for CPU tensors.  Both keep the
softmax's running max, sum and accumulator in float32, as the Pallas
kernels do; the reference's plain-JAX attention keeps the accumulator
and the probabilities in the model's dtype (ROADMAP queue 3), so in
bfloat16 the two differ by more than output rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops

Tensor = torch.Tensor

__all__ = ["RMSNorm", "rmsnorm", "rope_frequencies",
           "apply_rope", "AttnDims", "Attention", "init_attention",
           "attention_prefill_chunked", "attention_decode", "MLP",
           "init_mlp", "mlp_swiglu"]


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
    weight.copy_(draw * scale)


# -------------------------------------------------------------------------
# RMSNorm
# -------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, *,
                 device: DeviceLike = DEFAULT_DEVICE,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale = _frozen(torch.ones(d, device=device, dtype=dtype))


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
