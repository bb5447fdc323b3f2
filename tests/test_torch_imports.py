"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py`` and the
port's example ``examples/cifar_optorch_torch.py`` import neither JAX nor
any module of the JAX package ``repro``, at run time or in their
sources."""
from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PKG.rglob("*.py"))
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert len(MODULES) > 20


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_sources_do_not_import_jax_or_repro(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_chip_smoke_imports_no_jax():
    assert not FORBIDDEN.search((ROOT / "chip_smoke.py").read_text())


EXAMPLE = ROOT / "examples" / "cifar_optorch_torch.py"


def test_torch_example_imports_no_jax_or_repro():
    assert not FORBIDDEN.search(EXAMPLE.read_text())
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('ex', {str(EXAMPLE)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules['ex'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("pkg", ["core", "data", "optim", "distributed"])
def test_packages_export_what_the_reference_exports(pkg):
    """``repro_torch.<pkg>`` exports every name ``repro.<pkg>`` does (its
    ``__all__``, or the submodules its ``__init__`` imports), as the
    same kind of object (module or not)."""
    import importlib
    import types
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")

    def public(mod):
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n, v in vars(mod).items()
                     if isinstance(v, types.ModuleType)
                     and v.__name__.startswith(mod.__name__ + ".")]
        return sorted(names)

    assert public(port) == public(ref)
    for name in public(ref):
        assert isinstance(getattr(port, name), types.ModuleType) == \
            isinstance(getattr(ref, name), types.ModuleType), name
