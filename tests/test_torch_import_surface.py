"""The port's import surface: every ``__all__`` export exists, the
reference's package-level re-exports have their counterparts, and no
module of the port imports JAX or the reference (mirrors
`tests/test_import_surface.py`)."""

import importlib
import os
import pathlib
import pkgutil
import subprocess
import sys
import textwrap

import pytest

import repro_torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    root = pathlib.Path(repro_torch.__file__).parent
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(root)], "repro_torch."))


@pytest.mark.parametrize("modname", _modules())
def test_all_exports_exist(modname):
    mod = importlib.import_module(modname)
    exported = getattr(mod, "__all__", None)
    if exported is None:
        pytest.skip(f"{modname} declares no __all__")
    assert len(set(exported)) == len(exported), (
        f"{modname}.__all__ has duplicates")
    missing = [name for name in exported if not hasattr(mod, name)]
    assert not missing, (
        f"{modname}.__all__ exports names that do not exist: {missing}")


def test_core_reexports_match_reference():
    import repro.core as j_core
    import repro_torch.core as t_core
    names = ["ServerParams", "harmonic_number", "service_time_server",
             "mm1_residence_time", "utilization", "fork_join_lower_bound",
             "fork_join_upper_bound", "response_time_bounds",
             "response_time_with_result_cache", "saturation_rate"]
    assert t_core.__all__ == names
    for name in names:
        assert hasattr(j_core, name)
        assert getattr(t_core, name) is getattr(
            importlib.import_module("repro_torch.core.queueing"), name)
    from repro_torch.core import ServerParams  # noqa: F401
    from repro_torch.models.layers import init_rmsnorm
    norm = init_rmsnorm(6, device="cpu")
    assert norm.scale.shape == (6,) and bool((norm.scale == 1).all())


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import importlib, pathlib, pkgutil, sys
        import repro_torch
        root = pathlib.Path(repro_torch.__file__).parent
        for m in pkgutil.walk_packages([str(root)], "repro_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith(("jax.", "jaxlib"))
                     or n == "repro" or n.startswith("repro."))
        print("BAD", bad)
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
