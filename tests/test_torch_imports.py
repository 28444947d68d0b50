"""Import hygiene of the port: no module of ``src/repro_torch``, no
example of the port (``examples/torch_*.py``) and none of
``chip_smoke.py``, ``chip_sweep.py`` and ``chip_spans.py`` imports JAX
or the JAX package (``repro``), and the whole package imports on a
machine without triton, nvcc or CUDA."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return (sorted(PORT.rglob("*.py"))
            + sorted((ROOT / "examples").glob("torch_*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "chip_sweep.py",
               ROOT / "chip_spans.py"])


def _imported_roots(path: Path) -> set[str]:
    """Top-level package names a file imports (absolute imports only:
    relative imports stay inside the port)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_exist():
    files = _port_files()
    assert len(files) > 20
    for src in ("scan_lookback.cuh", "bucket_rank.cuh", "flash_attention.cu",
                "decode_attention.cu", "shard_rank.cu"):
        assert (PORT / "csrc" / src).exists(), src
    # the scan below covers the modules of every slice
    for rel in ("streaming/state.py", "streaming/ingest.py",
                "streaming/standing.py", "core/estimate.py",
                "models/config.py", "models/params.py", "models/layers.py",
                "models/lm.py", "configs/__init__.py",
                "configs/starcoder2_3b.py", "training/data.py",
                "serving/scheduler.py", "serving/engine.py",
                "launch/serve.py", "kernels/flash_attention/ops.py",
                "kernels/decode_attention/ops.py", "sharding/data.py",
                "kernels/partition/ops.py", "kernels/partition_cases.py",
                "training/optimizer.py", "training/train_step.py",
                "training/checkpoint.py", "training/backend.py",
                "launch/train.py", "launch/mesh.py", "sharding/policy.py",
                "sharding/model.py"):
        assert PORT / rel in files, rel
    for example in ("torch_train_backend.py",
                    "torch_serve_semantic_queries.py"):
        assert ROOT / "examples" / example in files, example


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_package_imports_without_triton_nvcc_or_cuda():
    modules = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("")
                 .parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"  # any import of triton fails
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._LIB is None  # nothing built at import\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Run without a card it prints no result and exits non-zero; so
    does a copy of the script alone, without the program."""
    import torch

    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    scripts = [alone]
    if not torch.cuda.is_available():
        scripts.append(ROOT / "chip_smoke.py")
    for script in scripts:
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=300,
                             cwd=str(script.parent))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
