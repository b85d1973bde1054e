"""Bind and launch the hand-written CUDA decode-attention kernel.

``csrc/decode_attention.cu`` replaces the Pallas TPU kernel
`repro.kernels.decode_attention.kernel.decode_attention_pallas`.  It takes
the model's layout with strides: q (B, 1, H, D) and one layer's cache
k, v (B, S, KV, D).  Positions split across blocks (flash-decoding): the
entry point launches the split kernel into a float32 scratch allocated
here, then the combine kernel, on PyTorch's current stream.  Built by
`repro_torch.kernels._cuda.CudaLibrary` at first use; ``launches`` counts
the calls this process made (one per call: the split and combine pair).
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels._cuda import (CudaLibrary, check_rows16,
                                       int64_array, ptr)

Tensor = torch.Tensor

_HERE = pathlib.Path(__file__).resolve().parent
_P = ctypes.c_void_p
_I = ctypes.c_int64

LIB = CudaLibrary(
    _HERE / "csrc" / "decode_attention.cu",
    {name: [_P] * 5 + [ctypes.POINTER(_I)] + [_I] * 7 + [_P]
     for name in ("decode_attention_f32", "decode_attention_bf16")},
    headers=(_HERE.parent / "csrc" / "attention_io.cuh",))
HEAD_DIMS = (16, 32, 64, 128)      # the D instantiated in the source
GROUPS = (1, 2, 4, 8)              # the H / KV instantiated in the source
BLOCKS_PER_SM = 4                  # split target: blocks per SM in flight
MAX_CHUNK = 1024                   # positions a block walks at most
MIN_CHUNK = 64                     # ... and at least

__all__ = ["LIB", "HEAD_DIMS", "GROUPS", "decode_attention_cuda",
           "split_plan"]

launches = 0          # calls (split + combine launches) in this process

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(n: int, rows: int, sms: int) -> tuple[int, int]:
    """(chunk, splits) for ``n`` positions over ``rows`` = B x KV: enough
    blocks to give every SM ``BLOCKS_PER_SM``, a block walking between
    ``MIN_CHUNK`` and ``MAX_CHUNK`` positions (fewer only if n is)."""
    splits = max(-(-BLOCKS_PER_SM * sms // rows), -(-n // MAX_CHUNK))
    chunk = max(MIN_CHUNK, -(-n // splits))
    return chunk, -(-n // chunk)


def decode_attention_cuda(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                          length: int) -> Tensor:
    """Launch the kernel: q (B, 1, H, D) against k/v (B, S, KV, D), cache
    positions 0..``length`` (inclusive) -> (B, 1, H, D).

    Any strides with a contiguous, 16-byte aligned last axis.  Raises on
    anything the kernel does not take: no conversion, no fallback.
    """
    global launches
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    if any(t.device.type != "cuda" or t.device != q.device
           for t in tensors.values()):
        raise ValueError("the CUDA decode attention needs CUDA tensors on "
                         "one device; got "
                         f"{[str(t.device) for t in tensors.values()]}")
    if (q.dtype not in _SUFFIX or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError("the CUDA decode attention takes float32 or bfloat16 "
                        f"q and caches of one dtype; got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if (q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"q must be (B, 1, H, D) and the caches (B, S, KV, "
                         f"D); got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, _, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and the caches "
                         f"{tuple(k_cache.shape)} do not share B and D, or H "
                         "is not a multiple of KV")
    groups = h // kv
    if d not in HEAD_DIMS or groups not in GROUPS:
        raise ValueError(f"the CUDA decode attention takes D in {HEAD_DIMS} "
                         f"and H / KV in {GROUPS}; got D={d}, "
                         f"H / KV={groups}")
    length = int(length)
    if not 0 <= length < s or s >= 2 ** 31 or b > 65535 or kv > 65535:
        raise ValueError(f"length {length} must index the cache's {s} "
                         f"positions (shape {tuple(k_cache.shape)})")
    for name, t in tensors.items():
        check_rows16(name, t)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    n = length + 1
    index = (q.device.index if q.device.index is not None
             else torch.cuda.current_device())
    chunk, splits = split_plan(n, b * kv, _sm_count(index))
    part = torch.empty(b * kv * splits * groups * (d + 2),
                       dtype=torch.float32, device=q.device)
    strides = int64_array([q.stride(0), q.stride(2), *k_cache.stride()[:3],
                           *v_cache.stride()[:3], out.stride(0),
                           out.stride(2)])
    LIB.call(f"decode_attention_{_SUFFIX[q.dtype]}", q.device, ptr(q),
             ptr(k_cache), ptr(v_cache), ptr(out), ptr(part), strides, b, kv,
             groups, d, n, chunk, splits)
    launches += 1
    return out
