"""Bind and launch the hand-written CUDA CIN-layer kernel.

``csrc/cin_fuse.cu`` replaces the Pallas TPU kernel
`repro.kernels.cin_fuse.kernel.cin_layer_pallas`: one xDeepFM CIN layer as
an implicit GEMM whose A operand, the (B, Hk, m, D) outer product, is
built tile by tile in shared memory and never written to device memory.
bfloat16 runs on the tensor cores (mma.sync), float32 on FMAs.  Built by
`repro_torch.kernels._cuda.CudaLibrary` at first use; ``launches`` counts
the launches this process made.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels._cuda import CudaLibrary, ptr

Tensor = torch.Tensor

_HERE = pathlib.Path(__file__).resolve().parent
_P = ctypes.c_void_p
_I = ctypes.c_int64

LIB = CudaLibrary(
    _HERE / "csrc" / "cin_fuse.cu",
    {name: [_P] * 4 + [_I] * 5 + [_P]
     for name in ("cin_layer_f32", "cin_layer_bf16")})
MAX_ROW_VALUES = 768    # Hk + m: a block stages 64 rows of them (<= 227 KB)
MAX_FIELDS = 64         # m on the tensor cores: x0 rows held in registers

__all__ = ["LIB", "cin_layer_cuda"]

launches = 0          # kernel launches in this process

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def cin_layer_cuda(xk: Tensor, x0: Tensor, w: Tensor) -> Tensor:
    """Launch the kernel: xk (B, Hk, D), x0 (B, m, D), w (Hk*m, O) ->
    (B, O, D) in xk's dtype.

    float32 or bfloat16, one dtype, contiguous, on one CUDA device; in
    bfloat16 at most MAX_FIELDS fields.  Raises on anything else: no
    conversion, no fallback.
    """
    global launches
    tensors = {"xk": xk, "x0": x0, "w": w}
    if any(t.device.type != "cuda" or t.device != xk.device
           for t in tensors.values()):
        raise ValueError("the CUDA CIN layer needs CUDA tensors on one "
                         "device; got "
                         f"{[str(t.device) for t in tensors.values()]}")
    if xk.dtype not in _SUFFIX or x0.dtype != xk.dtype or w.dtype != xk.dtype:
        raise TypeError("the CUDA CIN layer takes float32 or bfloat16 "
                        "inputs of one dtype; got "
                        f"{xk.dtype}, {x0.dtype}, {w.dtype}")
    if xk.ndim != 3 or x0.ndim != 3 or w.ndim != 2:
        raise ValueError(f"xk must be (B, Hk, D), x0 (B, m, D) and w "
                         f"(Hk*m, O); got {tuple(xk.shape)}, "
                         f"{tuple(x0.shape)}, {tuple(w.shape)}")
    b, hk, d = xk.shape
    m = x0.shape[1]
    if x0.shape[0] != b or x0.shape[2] != d or w.shape[0] != hk * m:
        raise ValueError(f"xk {tuple(xk.shape)}, x0 {tuple(x0.shape)} and w "
                         f"{tuple(w.shape)} do not agree on B, D and Hk*m")
    if hk + m > MAX_ROW_VALUES:
        raise ValueError(f"Hk + m = {hk + m} exceeds {MAX_ROW_VALUES}")
    if xk.dtype == torch.bfloat16 and m > MAX_FIELDS:
        raise ValueError(f"the tensor-core CIN layer takes m <= {MAX_FIELDS} "
                         f"fields; got {m}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"the CUDA CIN layer needs a contiguous {name} "
                             f"(strides {t.stride()})")
    o = w.shape[1]
    y = torch.empty((b, o, d), dtype=xk.dtype, device=xk.device)
    if y.numel() == 0:
        return y
    LIB.call(f"cin_layer_{_SUFFIX[xk.dtype]}", xk.device, ptr(xk), ptr(x0),
             ptr(w), ptr(y), b, hk, m, d, o)
    launches += 1
    return y
