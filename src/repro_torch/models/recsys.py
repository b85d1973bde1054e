"""CTR recommenders the port serves: DeepFM, xDeepFM (CIN), AutoInt.

PyTorch port of the CTR half of `repro.models.recsys` (MIND, the losses
and training are not ported).  The shared substrate is one stacked
embedding table (total_rows, D) with per-field offsets (DLRM layout);
a request is a (F, M) bag of globalized ids with a mask, and a batch of
requests (B, F, M) goes through ``*_logits`` as the reference's serving
function does (`repro.launch.specs`, ``serve_p99`` / ``serve_bulk``).

Parameters are plain dicts of tensors in the reference's layout:
``{"embedding": {"table", "wide"}, "mlp": [{"w", "b"}, ...], ...}``, MLP
weights (in, out) applied as ``x @ w + b``, CIN weights (Hk*m, O).
`repro_torch.interop.recsys_params_from_numpy` carries the reference's
weights across.

Two calls go through hand-written kernels: `embedding_bag` through
`repro_torch.kernels.embedding_bag` (two launches a logits call: the
table and the wide table) and each CIN layer through
`repro_torch.kernels.cin_fuse` (xDeepFM: one launch a layer).  Both sum in
float32, as the Pallas kernels do; the reference's plain-JAX embedding bag
sums in the model's dtype (ROADMAP queue 3), so in bfloat16 the two differ
by more than output rounding.  ``impl="auto"`` takes the kernels for CUDA
tensors and the plain versions for CPU tensors; ``impl="torch"`` forces
the plain versions.  The MLPs, the FM term and AutoInt's field attention
are plain torch, as the reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.cin_fuse import ops as cin_ops
from repro_torch.kernels.embedding_bag import ops as bag_ops

Tensor = torch.Tensor
Seed = Union[int, torch.Generator]

__all__ = ["field_offsets", "padded_rows", "init_embedding", "embedding_bag",
           "init_deepfm", "fm_interaction", "deepfm_logits", "init_xdeepfm",
           "cin_interaction", "xdeepfm_logits", "init_autoint",
           "autoint_logits"]


# -------------------------------------------------------------------------
# Embedding substrate
# -------------------------------------------------------------------------

def field_offsets(cfg: RecsysConfig) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(cfg.field_vocabs)]).astype(np.int64)


def padded_rows(n: int) -> int:
    """Round table rows up to a multiple of 2048 (the reference shards
    rows)."""
    return n + (-n) % 2048


def _generator(seed: Seed, device: DeviceLike) -> torch.Generator:
    return seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(seed)


def _dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
                scale: Optional[float] = None) -> Tensor:
    """The reference's ``_dense_init``: normal x fan_in^-0.5 (fan_in =
    shape[0]) or x ``scale``, drawn in float32 on the generator's device
    and cast."""
    scale = scale if scale is not None else shape[0] ** -0.5
    draw = torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
    return draw.mul_(scale).to(dtype)


def _dtype(cfg: RecsysConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_embedding(gen: torch.Generator, cfg: RecsysConfig) -> dict:
    dt = _dtype(cfg)
    rows = padded_rows(int(sum(cfg.field_vocabs)))
    return {"table": _dense_init(gen, (rows, cfg.embed_dim), dt, scale=0.01),
            "wide": _dense_init(gen, (rows, 1), dt, scale=0.01)}


def embedding_bag(table: Tensor, ids: Tensor, mask: Tensor, *,
                  impl: str = "auto") -> Tensor:
    """(rows, D) x (B, F, M) multi-hot ids -> (B, F, D) mean-pooled.

    ids are already globalized (field offset added).  Masked mean over the
    bag axis M, any mask — torch.nn.EmbeddingBag(mode='mean') semantics.
    """
    return bag_ops.embedding_bag(table, ids, mask, impl=impl)


def _mlp_init(gen: torch.Generator, sizes, dt: torch.dtype) -> list:
    return [{"w": _dense_init(gen, (a, b), dt),
             "b": torch.zeros((b,), dtype=dt, device=gen.device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _mlp_apply(ws: list, x: Tensor) -> Tensor:
    """ReLU between layers, none after the last."""
    for i, layer in enumerate(ws):
        x = x @ layer["w"] + layer["b"]
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def _wide(params: dict, ids: Tensor, mask: Tensor, impl: str) -> Tensor:
    return embedding_bag(params["embedding"]["wide"], ids, mask,
                         impl=impl).sum(dim=(1, 2))


# -------------------------------------------------------------------------
# DeepFM
# -------------------------------------------------------------------------

def init_deepfm(seed: Seed, cfg: RecsysConfig, *,
                device: DeviceLike = DEFAULT_DEVICE) -> dict:
    gen = _generator(seed, device)
    sizes = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp + (1,)
    return {"embedding": init_embedding(gen, cfg),
            "mlp": _mlp_init(gen, sizes, _dtype(cfg))}


def fm_interaction(v: Tensor) -> Tensor:
    """(B, F, D) -> (B,) second-order FM term."""
    s = v.sum(dim=1)
    sq = (v * v).sum(dim=1)
    return 0.5 * (s * s - sq).sum(dim=-1)


def deepfm_logits(params: dict, cfg: RecsysConfig, ids: Tensor,
                  mask: Tensor, *, impl: str = "auto") -> Tensor:
    v = embedding_bag(params["embedding"]["table"], ids, mask, impl=impl)
    wide = _wide(params, ids, mask, impl)
    fm = fm_interaction(v)
    deep = _mlp_apply(params["mlp"], v.reshape(v.shape[0], -1))[:, 0]
    return (wide + fm + deep).float()


# -------------------------------------------------------------------------
# xDeepFM (CIN)
# -------------------------------------------------------------------------

def init_xdeepfm(seed: Seed, cfg: RecsysConfig, *,
                 device: DeviceLike = DEFAULT_DEVICE) -> dict:
    gen = _generator(seed, device)
    dt = _dtype(cfg)
    embedding = init_embedding(gen, cfg)
    sizes = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp + (1,)
    mlp = _mlp_init(gen, sizes, dt)
    cin, h_prev = [], cfg.n_sparse
    for h in cfg.cin_layers:
        cin.append(_dense_init(gen, (h_prev * cfg.n_sparse, h), dt))
        h_prev = h
    return {"embedding": embedding, "mlp": mlp, "cin": cin,
            "cin_out": _dense_init(gen, (sum(cfg.cin_layers), 1), dt)}


def cin_interaction(params: dict, cfg: RecsysConfig, v: Tensor, *,
                    impl: str = "auto") -> Tensor:
    """Compressed Interaction Network: (B, F, D) -> (B,).  Each layer is
    one fused kernel call: the (B, Hk, m, D) outer product is never
    materialized on the card."""
    xk, pooled = v, []
    for w in params["cin"]:
        xk = cin_ops.cin_layer(xk, v, w, impl=impl)      # (B, Hk+1, D)
        pooled.append(xk.sum(dim=-1))                    # (B, Hk+1)
    p = torch.cat(pooled, dim=-1)
    return (p @ params["cin_out"])[:, 0]


def xdeepfm_logits(params: dict, cfg: RecsysConfig, ids: Tensor,
                   mask: Tensor, *, impl: str = "auto") -> Tensor:
    v = embedding_bag(params["embedding"]["table"], ids, mask, impl=impl)
    wide = _wide(params, ids, mask, impl)
    cin = cin_interaction(params, cfg, v, impl=impl)
    deep = _mlp_apply(params["mlp"], v.reshape(v.shape[0], -1))[:, 0]
    return (wide + cin + deep).float()


# -------------------------------------------------------------------------
# AutoInt
# -------------------------------------------------------------------------

def init_autoint(seed: Seed, cfg: RecsysConfig, *,
                 device: DeviceLike = DEFAULT_DEVICE) -> dict:
    gen = _generator(seed, device)
    dt = _dtype(cfg)
    embedding = init_embedding(gen, cfg)
    d_attn_total = cfg.n_heads * cfg.d_attn
    layers, d_in = [], cfg.embed_dim
    for _ in range(cfg.n_attn_layers):
        layers.append({name: _dense_init(gen, (d_in, d_attn_total), dt)
                       for name in ("wq", "wk", "wv", "w_res")})
        d_in = d_attn_total
    return {"embedding": embedding, "layers": layers,
            "out": _dense_init(gen, (cfg.n_sparse * d_in, 1), dt)}


def autoint_logits(params: dict, cfg: RecsysConfig, ids: Tensor,
                   mask: Tensor, *, impl: str = "auto") -> Tensor:
    x = embedding_bag(params["embedding"]["table"], ids, mask, impl=impl)
    for lp in params["layers"]:
        b, f, _ = x.shape
        q, k, vv = ((x @ lp[name]).reshape(b, f, cfg.n_heads, cfg.d_attn)
                    for name in ("wq", "wk", "wv"))
        att = torch.softmax(torch.einsum("bfhd,bghd->bhfg", q, k)
                            / np.sqrt(cfg.d_attn), dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", att, vv).reshape(b, f, -1)
        x = torch.relu(o + x @ lp["w_res"])
    wide = _wide(params, ids, mask, impl)
    return (wide + (x.reshape(x.shape[0], -1) @ params["out"])[:, 0]
            ).float()
