"""Edited copies of a kernel source, built side by side: the shared part of
``tools/decode_phases.py`` and ``tools/ssd_phases.py``.

Each variant is a directory under ``out`` that holds edited copies of
files from ``src/repro_torch/kernels/csrc`` (the ``.cu`` and any header it
edits).  ``nvcc`` compiles the variant's ``.cu`` with the kernels' own
flags and ``csrc`` on the include path, so a quoted include finds an
edited header in the variant's directory first and every other header in
``csrc``.  One ``nvcc`` for each variant, all started together.  Needs
nvcc.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess


def edit(text: str, edits, tool: str) -> str:
    """``text`` with each (old, new) of ``edits`` replaced; fails loudly if
    the text no longer holds ``old``."""
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{tool}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(out: pathlib.Path, variants: dict[str, dict[str, str]],
                   source: str, tool: str) -> dict:
    """Build each variant's ``source`` (``{name: {file name: text}}``, the
    files holding ``source`` and the headers it edits) into
    ``out/<name>/lib.so``.  Returns ``{name: (ctypes.CDLL, ptxas registers
    of each kernel)}``."""
    from repro_torch.kernels import build
    procs = {}
    for name, files in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{tool}: nvcc failed on {name}:\n{log}")
        regs = [ln.split("Used ")[1].split(" ")[0] for ln in log.splitlines()
                if "Used " in ln]
        libs[name] = (ctypes.CDLL(str(out / name / "lib.so")), regs)
    return libs
