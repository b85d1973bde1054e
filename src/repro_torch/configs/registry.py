"""``arch id -> ArchSpec`` over the architectures the port runs: all ten
of the reference's registry (`repro.configs.registry`): the dense and
MoE GQA language models (Qwen3, Command-R, Qwen3-MoE, Granite-MoE), the
three CTR recommenders, MIND and DimeNet.  An unknown id raises
`KeyError`, as the reference's does.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec

__all__ = ["get_arch", "list_archs", "all_cells"]

_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepfm": "repro_torch.configs.deepfm",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "autoint": "repro_torch.configs.autoint",
    "mind": "repro_torch.configs.mind",
    "dimenet": "repro_torch.configs.dimenet",
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).SPEC


def list_archs() -> list[str]:
    return sorted(_MODULES)


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) pair, the 40 dry-run cells, in the
    reference's order (archs sorted, each arch's shapes as listed)."""
    return [(a, s.name) for a in list_archs() for s in get_arch(a).shapes]
