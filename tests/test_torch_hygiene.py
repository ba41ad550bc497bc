"""The port stands alone: it imports nothing of JAX, of dpmn_tpu or of the
repository's tools/, nor cv2, yaml or pygame (it has its own YUV conversion
and YAML reader; PIL decodes and resizes, as in dpmn_tpu); its entry points
refuse to fall back to the CPU; nothing builds a kernel at import."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dpmn_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dpmn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dpmn_tpu", "tools", "yaml", "cv2", "pygame")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)], prefix="dpmn_tpu_torch."))


def _top_level(name: str) -> str:
    return name.split(".")[0]


def test_import_every_module_with_jax_blocked():
    code = f"""
import importlib, importlib.abc, sys
BLOCKED = {FORBIDDEN!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
for m in {_port_modules()!r}:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not leaked, leaked
print('ok', len({_port_modules()!r}))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_source_imports(path):
    """AST scan: no forbidden import anywhere; the atlas generator may import
    pygame, inside a function only."""
    tree = ast.parse((ROOT / path).read_text())
    lazy_ok = path.endswith("build_atlas.py")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = _top_level(name)
            if top == "pygame" and lazy_ok and node.col_offset > 0:
                continue
            assert top not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from dpmn_tpu_torch.config import TrainCfg, flagship_args
    from dpmn_tpu_torch.system import DPMNSystem

    with pytest.raises(RuntimeError, match="CUDA"):
        DPMNSystem(TrainCfg(batch_size=2), flagship_args())
    with pytest.raises(RuntimeError, match="CUDA"):
        dpmn_tpu_torch.resolve_device("cuda")
    assert dpmn_tpu_torch.resolve_device("cpu").type == "cpu"


def test_float32_is_strict_on_the_card():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_sources_and_assets_ship():
    from dpmn_tpu_torch.ops import kernels

    for name in kernels.SOURCES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
    for name in ("window_attention_train.cu", "window_attention_core.cu", "window_attention_full.cu",
                 "window_tile_attention.cu", "grouped_window_attention.cu", "mlp_convs.cu", "dropout_mask.cu",
                 "window_common.cuh", "window_train_common.cuh", "tc_common.cuh", "attn_tile.cuh",
                 "lmdb_reader.cpp"):
        assert (kernels.CSRC / name).is_file(), name
    assert (PORT / "assets" / "glyph_atlas_32x128.npz").is_file()
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert "csrc/*.cu" in pyproject and "csrc/*.cuh" in pyproject and "assets/*.npz" in pyproject
    assert "csrc/*.cpp" in pyproject
