"""The port stands alone: no module of ``src/repro_torch/``, no
``benchmarks/torch_*.py`` and not ``chip_smoke.py`` imports JAX or anything
of the JAX package ``repro``, and its entry points refuse to run on a
machine without a GPU unless the caller asks for the CPU."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "benchmarks").glob("torch_*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", getattr(node.func, "attr", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    assert path.exists()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"
        assert not mod.startswith("repro.")
        assert not mod.startswith("repro_torch.") or \
            (ROOT / "src" / Path(*mod.split("."))).with_suffix(".py") \
            .exists() or (ROOT / "src" / Path(*mod.split("."))).is_dir(), \
            f"{path.relative_to(ROOT)} imports missing {mod}"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without a GPU, PagedEngine, init_params and the launcher raise
    unless given device='cpu'."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, seed=0)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedEngine(cfg, params, EngineConfig(num_pages=8, page_size=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])
    eng = PagedEngine(cfg, params, EngineConfig(num_pages=8, page_size=8),
                      device="cpu")
    assert eng.k_pages.device.type == "cpu"
