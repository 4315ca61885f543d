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
from repro_torch.configs import colpali_hpc
from repro_torch.core import rag
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import colpali, transformer
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
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"core/binary.py", "kernels/hamming.py", "kernels/maxsim.py",
            "retrieval/float_flat.py", "retrieval/hamming.py",
            "retrieval/cascade.py", "retrieval/ivf.py", "retrieval/hnsw.py",
            "core/graph.py", "convert.py", "models/layers.py",
            "models/transformer.py", "models/colpali.py", "core/rag.py",
            "core/pipeline.py", "configs/colpali_hpc.py",
            "kernels/ref.py", "models/recsys.py", "models/gnn.py",
            "configs/recsys_archs.py", "configs/gnn_archs.py",
            "data/sampler.py", "launch/mesh.py", "dist/sharding.py",
            "dist/collectives.py", "core/distributed.py",
            "train/elastic.py", "kernels/vmem.py", "launch/cells.py",
            "launch/dryrun.py", "analysis/astchecks.py",
            "analysis/cost_model.py", "analysis/jaxpr_budget.py",
            "analysis/lintcore.py", "analysis/manifests.py",
            "analysis/pallas_check.py", "analysis/__main__.py"} <= names
    assert not _forbidden("repro_torch.core.scan")
    assert _forbidden("repro.core.scan") and _forbidden("jax.numpy")


def test_every_reference_module_has_its_counterpart():
    """The port's file list closes over the reference's: no module of
    src/repro is missing from src/repro_torch."""
    def modules(pkg):
        base = ROOT / "src" / pkg
        return {str(p.relative_to(base)) for p in base.rglob("*.py")}
    assert modules("repro") - modules("repro_torch") == set()


def test_dry_run_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.launch import dryrun
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell("dcn-v2", "serve_p99", smoke=True)
    assert dryrun.run_cell("dcn-v2", "serve_p99", smoke=True,
                           device="cpu")["status"] == "ok"


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
    enc_cfg = colpali_hpc.COLPALI_HPC.smoke_config.encoder
    for make in (lambda: transformer.Transformer(enc_cfg.backbone),
                 lambda: transformer.init_cache(enc_cfg.backbone, 1, 4),
                 lambda: colpali.ColPaliEncoder(enc_cfg),
                 lambda: colpali.init(enc_cfg, generator=torch.Generator()),
                 lambda: synthetic.make_fact_corpus(seed=0, n_docs=8),
                 lambda: rag.rag_pipeline(None, None, None, rag.RAGConfig(),
                                          8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    enc = colpali.ColPaliEncoder(enc_cfg, device="cpu")
    assert enc.backbone.embed.device.type == "cpu"
    for make in (mesh_mod.make_host_mesh, mesh_mod.make_production_mesh,
                 mesh_mod.open_local_group):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


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


def test_trainer_refuses_the_cpu_unless_asked(tmp_path):
    _no_card()
    for arch in ("qwen2-1.5b", "colpali-hpc", "pna", "dlrm-mlperf",
                 "dcn-v2", "din", "dien"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", arch, "--smoke", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_family_models_refuse_the_cpu_unless_asked():
    _no_card()
    from repro_torch.configs import gnn_archs, recsys_archs
    from repro_torch.models import gnn, recsys
    for spec, mod in ((recsys_archs.DIEN, recsys), (gnn_archs.PNA, gnn)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.init(spec.smoke_config, generator=torch.Generator())
        model = mod.init(spec.smoke_config, generator=torch.Generator(),
                         device="cpu")
        assert all(p.device.type == "cpu" for p in model.parameters())
