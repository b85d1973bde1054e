"""Bind and launch the hand-written CUDA flash-attention kernel.

``csrc/flash_attention.cu`` replaces the Pallas TPU kernel
`repro.kernels.flash_attention.kernel.flash_attention_pallas`.  It takes
the model's layout with strides: q (B, S, H, D) and k, v (B, S, KV, D),
so no transposed copy is made.  Built by
`repro_torch.kernels._cuda.CudaLibrary` at first use; ``launches`` counts
the launches this process made.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels._cuda import (CudaLibrary, check_rows16,
                                       int64_array, ptr)

Tensor = torch.Tensor

_HERE = pathlib.Path(__file__).resolve().parent
_P = ctypes.c_void_p
_I = ctypes.c_int64

LIB = CudaLibrary(
    _HERE / "csrc" / "flash_attention.cu",
    {name: [_P] * 4 + [ctypes.POINTER(_I)] + [_I] * 7 + [_P]
     for name in ("flash_attention_f32", "flash_attention_bf16")},
    headers=(_HERE.parent / "csrc" / "attention_io.cuh",))
HEAD_DIMS = (16, 32, 64, 128)      # the D instantiated in the source
ROWS = 64                          # kRows: query rows (positions x G) a block

__all__ = ["LIB", "HEAD_DIMS", "ROWS", "flash_attention_cuda"]

launches = 0          # kernel launches in this process

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True) -> Tensor:
    """Launch the kernel: q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D).

    Any strides with a contiguous, 16-byte aligned last axis.  Raises on
    anything the kernel does not take: no conversion, no fallback.
    """
    global launches
    tensors = {"q": q, "k": k, "v": v}
    if any(t.device.type != "cuda" or t.device != q.device
           for t in tensors.values()):
        raise ValueError("the CUDA flash attention needs CUDA tensors on one "
                         f"device; got {[str(t.device) for t in tensors.values()]}")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the CUDA flash attention takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, KV, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         "share B and D, or H is not a multiple of KV")
    groups = h // kv
    if d not in HEAD_DIMS or ROWS % groups:
        raise ValueError(f"the CUDA flash attention takes D in {HEAD_DIMS} "
                         f"and H / KV dividing {ROWS}; got D={d}, "
                         f"H / KV={groups}")
    if max(sq, sk) >= 2 ** 31 or b > 65535 or kv > 65535:
        raise ValueError(f"shape {tuple(q.shape)} / {tuple(k.shape)} is past "
                         "the kernel's grid")
    for name, t in tensors.items():
        check_rows16(name, t)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("no key positions to attend to (Sk = 0)")
    strides = int64_array([*q.stride()[:3], *k.stride()[:3],
                           *v.stride()[:3], *out.stride()[:3]])
    LIB.call(f"flash_attention_{_SUFFIX[q.dtype]}", q.device, ptr(q), ptr(k),
             ptr(v), ptr(out), strides, b, sq, sk, kv, groups, d, int(causal))
    launches += 1
    return out
