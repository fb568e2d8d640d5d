"""The port stands alone: no JAX, no ``deepspeed_tpu``, no silent CPU path.

``deepspeed_tpu_torch`` imports torch and numpy only. These tests import
the slice's modules in a fresh interpreter and check that neither ``jax``
nor ``deepspeed_tpu`` got loaded, scan every source file of the port (and
``chip_smoke.py``) for an import of either, and check that the entry
points refuse a missing card instead of running on the CPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "deepspeed_tpu_torch"
SLICE_MODULES = [
    "deepspeed_tpu_torch",
    "deepspeed_tpu_torch.inference.config",
    "deepspeed_tpu_torch.inference.sampling",
    "deepspeed_tpu_torch.inference.v2",
    "deepspeed_tpu_torch.inference.v2.engine_v2",
    "deepspeed_tpu_torch.inference.v2.host_tier",
    "deepspeed_tpu_torch.inference.v2.kv_pool",
    "deepspeed_tpu_torch.models.convert",
    "deepspeed_tpu_torch.models.transformer",
    "deepspeed_tpu_torch.ops.attention.core",
    "deepspeed_tpu_torch.ops.attention.paged",
    "deepspeed_tpu_torch.ops.kernels",
    "deepspeed_tpu_torch.ops.normalization",
    "deepspeed_tpu_torch.runtime.config_utils",
    "deepspeed_tpu_torch.utils.logging",
]


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m == 'jax' or m.startswith('jax.') or m == 'deepspeed_tpu'\n"
        "      or m.startswith('deepspeed_tpu.'))))\n"
    )
    # -S: no site customization, which may import jax at interpreter start
    out = subprocess.run(
        [sys.executable, "-S", "-c", f"import sys; sys.path[:0] = {sys.path!r}\n" + code],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [
        (str(f.relative_to(ROOT)), root)
        for f in files
        for root in _imported_roots(f)
        if root in ("jax", "jaxlib", "deepspeed_tpu", "flax", "optax")
    ]
    assert bad == []


def test_kernel_sources_ship_with_the_package():
    from deepspeed_tpu_torch.ops.kernels import KERNELS

    for k in KERNELS.values():
        assert k.source_path.is_file()
        assert "extern \"C\" int " + k.symbol in k.source_path.read_text()


def test_engine_refuses_a_missing_card(monkeypatch):
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.get_config("tiny", dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(cfg, {}, RaggedInferenceEngineConfig())  # default device: cuda


def test_engine_auto_refuses_an_unported_head_dim_on_a_card(monkeypatch):
    """With a card, "auto" decode attention is the kernel or an error: a
    head_dim the kernel lacks (96 here) raises before anything is placed,
    instead of running the plain gather on the card."""
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = T.get_config("tiny", hidden_size=192, n_heads=2, dtype="float32")
    assert cfg.head_dim == 96
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2, item 3"):
        InferenceEngineV2(cfg, {}, RaggedInferenceEngineConfig())  # default device: cuda


def test_kernel_wrappers_never_fall_back_for_device_tensors():
    """A wrapper takes its plain version only for a CPU tensor; anything
    else is refused, never moved to the CPU."""
    from deepspeed_tpu_torch.ops.attention.paged import paged_decode
    from deepspeed_tpu_torch.ops.normalization.fused_norm import rms_norm, rms_norm_cuda

    x = torch.randn(3, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rms_norm(x, torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        rms_norm_cuda(torch.randn(3, 8), torch.ones(8))
    q = torch.randn(2, 4, 64, device="meta")
    pool = torch.randn(3, 8, 2, 64, device="meta")
    tables = torch.zeros(2, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        paged_decode(q, pool, pool, tables, tables[:, 0], 2)


@pytest.mark.cuda
def test_build_and_launch_counts_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from deepspeed_tpu_torch.ops import kernels as K
    from deepspeed_tpu_torch.ops.normalization import rms_norm

    K.build()
    K.reset_counts()
    rms_norm(torch.randn(4, 64, device="cuda"), torch.ones(64, device="cuda"))
    assert K.counts()["rms_norm_fwd"] == 1
