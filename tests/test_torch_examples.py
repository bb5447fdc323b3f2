"""The reference's three examples on PyTorch (``examples/quickstart_torch.py``,
``serve_llm_torch.py``, ``train_llm_torch.py``), run as their users run
them, with ``--device cpu`` and small sizes: each exits 0 and prints
what its JAX original prints; none imports JAX or the JAX package
(``test_examples_import_no_jax``), and without ``--device cpu`` they
need a card."""
from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import pytest

import tp_ranks

EXAMPLES = tp_ranks.ROOT / "examples"


def _run(name, *args):
    proc = subprocess.run([sys.executable, str(EXAMPLES / name), *args],
                          env=tp_ranks.env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_composes_the_pipelines():
    out = _run("quickstart_torch.py", "--device", "cpu", "--batch", "2",
               "--seq", "64")
    saved = {m.group(1).strip(): float(m.group(2)) for m in re.finditer(
        r"^(standard \(B\)|M-P|S-C \+ M-P|S-C)\s+([\d.]+)$", out, re.M)}
    assert sorted(saved) == ["M-P", "S-C", "S-C + M-P", "standard (B)"]
    # sequential checkpoints keep the least for the backward
    assert saved["S-C"] < saved["standard (B)"]
    assert saved["S-C + M-P"] <= saved["S-C"]
    assert "(identical: True)" in out
    assert "sc_mp(model) logits: (2, 64, 256) torch.float32" in out


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m",
                                  "whisper-base"])
def test_serve_llm_generates(arch):
    out = _run("serve_llm_torch.py", "--device", "cpu", "--arch", arch,
               "--batch", "2", "--prompt-len", "8", "--gen", "4")
    assert f"arch={arch} quantized_cache=True device=cpu" in out
    first = re.search(r"generated \(first row\): \[([\d, ]+)\]", out)
    assert first and len(first.group(1).split(",")) == 4


def test_train_llm_trains_and_resumes(tmp_path):
    ckpt = tmp_path / "ck"
    out = _run("train_llm_torch.py", "--tiny", "--steps", "2", "--device",
               "cpu", "--ckpt-dir", str(ckpt))
    losses = re.findall(r"step\s+(\d+) loss (\S+)", out)
    assert [s for s, _ in losses] == ["0", "1"]
    assert out.rstrip().endswith("done")
    out = _run("train_llm_torch.py", "--tiny", "--steps", "3", "--device",
               "cpu", "--ckpt-dir", str(ckpt))
    assert "resumed from step 2" in out


def test_examples_need_a_card_without_device_cpu():
    """The default device is the card: with none, an example exits
    non-zero instead of running on the CPU."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / "serve_llm_torch.py"), "--gen", "2"],
        env=tp_ranks.env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0


def test_examples_import_no_jax():
    for path in sorted(pathlib.Path(EXAMPLES).glob("*_torch.py")):
        text = path.read_text()
        assert not re.search(r"^\s*(import jax|from jax|from repro\.|"
                             r"import repro$)", text, re.M), path.name
