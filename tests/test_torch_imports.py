"""The port stands alone: it imports neither JAX nor the JAX package, and
it never moves to the CPU unless the caller asks for it."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (the reference is importable beside the port)
from repro_torch import state_from_numpy
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.serving.server import AsyncRetrievalServer, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")   # "repro_torch" is fine


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_package_is_found():
    assert len(PORT_FILES) > 15
    assert not _forbidden("repro_torch.core.scan")
    assert _forbidden("repro.core.scan") and _forbidden("jax.numpy")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


def test_entry_points_refuse_the_cpu_unless_asked():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.make_retrieval_corpus(synthetic.CorpusSpec(n_docs=8),
                                        seed=0)
    arrays = {"codebook": np.zeros((4, 2), np.float32),
              "codes": np.zeros((3, 2), np.uint8),
              "mask": np.ones((3, 2), bool),
              "doc_ids": np.arange(3, dtype=np.int32),
              "rerank_codes": np.zeros((3, 2), np.uint8),
              "rerank_mask": np.ones((3, 2), bool)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy(arrays)
    assert state_from_numpy(arrays, device="cpu").codebook.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncRetrievalServer(lambda q, qm, qs: None, ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--n-docs", "8", "--queries", "2"])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card (or no checkout around the script): non-zero exit, no
    result line."""
    _no_card()
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
