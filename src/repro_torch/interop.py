"""Carry parameters, load, random numbers and weights across from numpy.

A simulator has no weights; what a run is made of is its server
parameters, its arrival process and its random draws.  A language model
is its weights.  These functions build the port's objects from numpy
arrays — never from a `repro` object — so that a test can hand both
packages the same parameters, the same load, the same random numbers and
the same weights (a language model's or a CTR recommender's); and back
to numpy, so that a test can hold a language model's gradients and
updated weights against the reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike, from_host
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.queueing import ServerParams
from repro_torch.models.transformer import Transformer
from repro_torch.train.optimizer import AdamWState, named_tensors

__all__ = ["server_params_from_numpy", "arrival_process_from_numpy",
           "draws_from_numpy", "lm_params_from_numpy", "lm_params_to_numpy",
           "adamw_state_from_numpy", "recsys_params_from_numpy"]


def server_params_from_numpy(fields: dict, *,
                             device: DeviceLike = DEFAULT_DEVICE,
                             dtype: torch.dtype = torch.float32
                             ) -> ServerParams:
    """ServerParams from a dict of numpy arrays (or numbers) by field name.

    Floating fields become ``dtype``; an integer ``p`` stays integer.
    """
    return ServerParams(**{k: from_host(v, device, dtype)
                           for k, v in fields.items()})


def arrival_process_from_numpy(rates, bin_seconds,
                               trace_gaps: Optional[np.ndarray] = None, *,
                               device: DeviceLike = DEFAULT_DEVICE,
                               dtype: torch.dtype = torch.float32
                               ) -> ArrivalProcess:
    """ArrivalProcess from its three arrays (rates (..., n_bins), the bin
    width, and optional trace gaps)."""
    return ArrivalProcess(
        rates=from_host(rates, device, dtype),
        bin_seconds=from_host(bin_seconds, device, dtype),
        trace_gaps=(None if trace_gaps is None
                    else from_host(trace_gaps, device, dtype)))


def draws_from_numpy(per_chunk: Sequence[tuple], *,
                     device: DeviceLike = DEFAULT_DEVICE,
                     dtype: torch.dtype = torch.float32):
    """A ``draws=`` callable serving precomputed per-chunk draws.

    ``per_chunk[c]`` is (u_gaps (S, chunk) or None, u_broker (S, chunk),
    services (S, p, chunk)) for chunk c, as numpy arrays, optionally
    followed by a dict of side streams (``"route"`` int replica indices,
    ``"cache_hit"`` bool, ``"cache_unit"``, ``"tap"``, ``"route_u"``, each
    (S, chunk); ``"fault_u"`` (S, chunk, r); ``"hedge"`` (attempts, S, p,
    chunk); see `repro_torch.core.simulator.chunk_side_draws`).
    Everything is moved to ``device`` once, up front: floating arrays in
    ``dtype``, integer and bool arrays as they are.
    """
    def move(x):
        return None if x is None else from_host(x, device, dtype)

    chunks = []
    for entry in per_chunk:
        base = tuple(move(x) for x in entry[:3])
        if len(entry) > 3:
            base += ({k: move(v) for k, v in entry[3].items()},)
        chunks.append(base)

    def draws(chunk_idx: int):
        return chunks[chunk_idx]
    return draws


def _ref_place(name: str) -> tuple[tuple, Optional[int], bool]:
    """Where a `Transformer` parameter lives in the reference's pytree:
    (path of keys, layer index on the leading L axis or None, whether
    the matrix is transposed: an `nn.Linear` weight is (out, in), the
    reference's (in, out))."""
    parts = name.split(".")
    transpose = parts[-1] == "weight"
    if transpose:
        parts = parts[:-1]
    if parts[0] == "layers":
        return ("layers", *parts[2:]), int(parts[1]), transpose
    return tuple(parts), None, transpose


def _ref_array(tree: dict, name: str) -> np.ndarray:
    """The reference's array for the port's parameter ``name``, in the
    port's layout (bfloat16 arrays come back as float32)."""
    path, layer, transpose = _ref_place(name)
    a = tree
    for key in path:
        a = a[key]
    a = np.asarray(a if layer is None else a[layer])
    if a.dtype.name == "bfloat16":      # numpy has no bfloat16 of its own
        a = a.astype(np.float32)
    return a.T if transpose else a


def lm_params_from_numpy(tree: dict, cfg, *,
                         device: DeviceLike = DEFAULT_DEVICE,
                         dtype: Optional[torch.dtype] = None) -> Transformer:
    """The port's `Transformer` from the reference's parameter pytree.

    ``tree`` is `repro.models.transformer.init_params`'s layout as nested
    dicts of numpy arrays (bfloat16 arrays are accepted): "embed"
    (Vp, d), "final_norm", optional "lm_head" (d, Vp), and "layers" with
    a leading L axis on every tensor, holding "mlp" or, for an MoE
    config, "moe".  This is the one place a layout changes: the
    reference's (in, out) matrices become `nn.Linear`'s (out, in); the
    MoE router and expert stacks keep the reference's layout (the router
    stays float32).  ``dtype`` defaults to ``cfg.dtype``.
    """
    model = Transformer(cfg, device=device, dtype=dtype)
    if (model.lm_head is None) != ("lm_head" not in tree):
        raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} "
                         f"but the tree {'has' if 'lm_head' in tree else 'lacks'}"
                         " an lm_head")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.tensor(_ref_array(tree, name)))
    return model


def lm_params_to_numpy(model_or_grads, cfg) -> dict:
    """The inverse of `lm_params_from_numpy`: the reference's pytree
    layout (stacked over L, (in, out) matrices) as nested dicts of numpy
    arrays, from a `Transformer` or from a map of its parameter names to
    tensors (gradients, optimizer moments).  bfloat16 comes back as
    float32."""
    layers: dict = {}
    tree: dict = {}

    def put(path, a):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a

    for name, t in named_tensors(model_or_grads).items():
        path, layer, transpose = _ref_place(name)
        t = t.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        a = a.T if transpose else a
        if layer is None:
            put(path, a)
        else:
            layers.setdefault(path, [None] * cfg.n_layers)[layer] = a
    for path, per_layer in layers.items():
        put(path, np.stack(per_layer))
    return tree


def adamw_state_from_numpy(state, model: Transformer) -> AdamWState:
    """The port's `AdamWState` for ``model`` from the reference's
    (step, m, v), the moments in its pytree layout as numpy arrays;
    float32 moments on the model's device."""
    step, m, v = state
    named = dict(model.named_parameters())
    device = next(iter(named.values())).device

    def moments(tree):
        return {name: torch.tensor(_ref_array(tree, name),
                                   dtype=torch.float32, device=device)
                for name in named}
    return AdamWState(step=torch.as_tensor(np.asarray(step),
                                           dtype=torch.int32, device=device),
                      m=moments(m), v=moments(v))


def recsys_params_from_numpy(tree, cfg, *,
                             device: DeviceLike = DEFAULT_DEVICE):
    """The port's parameters of a recommender from the reference's
    pytree (`repro.models.recsys.init_deepfm` / `init_xdeepfm` /
    `init_autoint` / `init_mind`) as nested dicts and lists of numpy
    arrays (bfloat16 arrays are accepted).  The layout stays the
    reference's: MLP weights (in, out), CIN weights (Hk*m, O), MIND's
    ``item_table`` (rows, D), ``bilinear_s`` (D, D) and ``out_mlp``
    layers, in ``cfg.dtype``."""
    dtype = getattr(torch, cfg.dtype)

    def put(node):
        if isinstance(node, dict):
            return {k: put(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [put(v) for v in node]
        a = np.asarray(node)
        if a.dtype.name == "bfloat16":      # numpy has no bfloat16 of its own
            a = a.astype(np.float32)
        return torch.tensor(a, device=device).to(dtype)
    return put(tree)
