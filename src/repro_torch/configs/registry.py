"""``arch id -> ArchSpec`` over the architectures the port can run.

The reference's registry (`repro.configs.registry`) lists ten; the port
lists the dense, qk-norm GQA language models its serving path runs and
the three CTR recommenders whose logits it serves (MIND is not ported).  Any
other id raises `KeyError`, as the reference does for an unknown one.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec

__all__ = ["get_arch", "list_archs"]

_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "deepfm": "repro_torch.configs.deepfm",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "autoint": "repro_torch.configs.autoint",
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).SPEC


def list_archs() -> list[str]:
    return sorted(_MODULES)
