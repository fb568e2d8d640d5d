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


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "deepspeed_tpu_torch"
SLICE_MODULES = [
    "deepspeed_tpu_torch",
    "deepspeed_tpu_torch.accelerator",
    "deepspeed_tpu_torch.accelerator.abstract_accelerator",
    "deepspeed_tpu_torch.accelerator.cuda_accelerator",
    "deepspeed_tpu_torch.accelerator.real_accelerator",
    "deepspeed_tpu_torch.checkpoint",
    "deepspeed_tpu_torch.checkpoint.engine",
    "deepspeed_tpu_torch.checkpoint.zero_to_fp32",
    "deepspeed_tpu_torch.comm",
    "deepspeed_tpu_torch.comm.comm",
    "deepspeed_tpu_torch.compression",
    "deepspeed_tpu_torch.compression.compress",
    "deepspeed_tpu_torch.compression.scheduler",
    "deepspeed_tpu_torch.compression.transforms",
    "deepspeed_tpu_torch.env_report",
    "deepspeed_tpu_torch.graft_entry",
    "deepspeed_tpu_torch.inference",
    "deepspeed_tpu_torch.inference.cli",
    "deepspeed_tpu_torch.inference.config",
    "deepspeed_tpu_torch.inference.engine",
    "deepspeed_tpu_torch.inference.quantization",
    "deepspeed_tpu_torch.inference.quantization.quantize",
    "deepspeed_tpu_torch.inference.sampling",
    "deepspeed_tpu_torch.inference.v2",
    "deepspeed_tpu_torch.inference.v2.blocked_allocator",
    "deepspeed_tpu_torch.inference.v2.engine_factory",
    "deepspeed_tpu_torch.inference.v2.engine_v2",
    "deepspeed_tpu_torch.inference.v2.host_tier",
    "deepspeed_tpu_torch.inference.v2.kv_pool",
    "deepspeed_tpu_torch.inference.v2.prefix_cache",
    "deepspeed_tpu_torch.inference.v2.ragged_manager",
    "deepspeed_tpu_torch.inference.v2.scheduler",
    "deepspeed_tpu_torch.linear",
    "deepspeed_tpu_torch.linear.optimized_linear",
    "deepspeed_tpu_torch.models",
    "deepspeed_tpu_torch.models.adapters",
    "deepspeed_tpu_torch.models.convert",
    "deepspeed_tpu_torch.models.hf",
    "deepspeed_tpu_torch.models.safetensors_io",
    "deepspeed_tpu_torch.models.transformer",
    "deepspeed_tpu_torch.models.weight_stream",
    "deepspeed_tpu_torch.monitor",
    "deepspeed_tpu_torch.monitor.monitor",
    "deepspeed_tpu_torch.observability",
    "deepspeed_tpu_torch.observability.cli",
    "deepspeed_tpu_torch.observability.events",
    "deepspeed_tpu_torch.observability.export",
    "deepspeed_tpu_torch.observability.tracing",
    "deepspeed_tpu_torch.ops",
    "deepspeed_tpu_torch.ops.adam",
    "deepspeed_tpu_torch.ops.adam.cpu_adam",
    "deepspeed_tpu_torch.ops.adam.fused_adam",
    "deepspeed_tpu_torch.ops.aio",
    "deepspeed_tpu_torch.ops.attention",
    "deepspeed_tpu_torch.ops.attention.core",
    "deepspeed_tpu_torch.ops.attention.flash",
    "deepspeed_tpu_torch.ops.attention.paged",
    "deepspeed_tpu_torch.ops.attention.sharded",
    "deepspeed_tpu_torch.ops.deepspeed4science",
    "deepspeed_tpu_torch.ops.deepspeed4science.evoformer_attn",
    "deepspeed_tpu_torch.ops.fused_ce",
    "deepspeed_tpu_torch.ops.kernels",
    "deepspeed_tpu_torch.ops.moe_gemm",
    "deepspeed_tpu_torch.ops.muon",
    "deepspeed_tpu_torch.ops.normalization",
    "deepspeed_tpu_torch.ops.normalization.fused_norm",
    "deepspeed_tpu_torch.ops.op_builder",
    "deepspeed_tpu_torch.ops.qmatmul",
    "deepspeed_tpu_torch.ops.quantizer",
    "deepspeed_tpu_torch.ops.quantizer.block_quant",
    "deepspeed_tpu_torch.ops.random_ltd",
    "deepspeed_tpu_torch.ops.sparse_attention",
    "deepspeed_tpu_torch.ops.sparse_attention.config",
    "deepspeed_tpu_torch.ops.sparse_attention.mask",
    "deepspeed_tpu_torch.ops.sparse_attention.schedule",
    "deepspeed_tpu_torch.ops.sparse_attention.sparse",
    "deepspeed_tpu_torch.ops.sparse_attention.splash",
    "deepspeed_tpu_torch.ops.spatial",
    "deepspeed_tpu_torch.parallel",
    "deepspeed_tpu_torch.parallel.moe",
    "deepspeed_tpu_torch.parallel.moe.mappings",
    "deepspeed_tpu_torch.parallel.moe.sharded_moe",
    "deepspeed_tpu_torch.parallel.sequence",
    "deepspeed_tpu_torch.parallel.sequence.tiled",
    "deepspeed_tpu_torch.parallel.topology",
    "deepspeed_tpu_torch.runtime",
    "deepspeed_tpu_torch.runtime.checkpoint_engine",
    "deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine",
    "deepspeed_tpu_torch.runtime.config",
    "deepspeed_tpu_torch.runtime.config_utils",
    "deepspeed_tpu_torch.runtime.dataloader",
    "deepspeed_tpu_torch.runtime.eigenvalue",
    "deepspeed_tpu_torch.runtime.engine",
    "deepspeed_tpu_torch.runtime.fp16",
    "deepspeed_tpu_torch.runtime.fp16.loss_scaler",
    "deepspeed_tpu_torch.runtime.lr_schedules",
    "deepspeed_tpu_torch.runtime.optimizers",
    "deepspeed_tpu_torch.runtime.quantize",
    "deepspeed_tpu_torch.runtime.streamed_adam",
    "deepspeed_tpu_torch.runtime.superoffload",
    "deepspeed_tpu_torch.runtime.swap_tensor",
    "deepspeed_tpu_torch.runtime.zero",
    "deepspeed_tpu_torch.runtime.zero.config",
    "deepspeed_tpu_torch.runtime.zenflow",
    "deepspeed_tpu_torch.serving",
    "deepspeed_tpu_torch.serving.cluster",
    "deepspeed_tpu_torch.serving.cluster.agent",
    "deepspeed_tpu_torch.serving.cluster.core",
    "deepspeed_tpu_torch.serving.cluster.handoff",
    "deepspeed_tpu_torch.serving.cluster.placement",
    "deepspeed_tpu_torch.serving.cluster.prefix_directory",
    "deepspeed_tpu_torch.serving.cluster.remote_core",
    "deepspeed_tpu_torch.serving.cluster.router",
    "deepspeed_tpu_torch.serving.driver",
    "deepspeed_tpu_torch.serving.elastic",
    "deepspeed_tpu_torch.serving.elastic.config",
    "deepspeed_tpu_torch.serving.elastic.controller",
    "deepspeed_tpu_torch.serving.elastic.preemption",
    "deepspeed_tpu_torch.serving.elastic.shedding",
    "deepspeed_tpu_torch.serving.elastic.spares",
    "deepspeed_tpu_torch.serving.metrics",
    "deepspeed_tpu_torch.serving.net",
    "deepspeed_tpu_torch.serving.net.control",
    "deepspeed_tpu_torch.serving.net.endpoint",
    "deepspeed_tpu_torch.serving.net.flow",
    "deepspeed_tpu_torch.serving.net.transport",
    "deepspeed_tpu_torch.serving.net.wire",
    "deepspeed_tpu_torch.serving.request",
    "deepspeed_tpu_torch.serving.resilience",
    "deepspeed_tpu_torch.serving.resilience.faults",
    "deepspeed_tpu_torch.serving.resilience.health",
    "deepspeed_tpu_torch.serving.resilience.recovery",
    "deepspeed_tpu_torch.serving.resilience.retry",
    "deepspeed_tpu_torch.serving.server",
    "deepspeed_tpu_torch.serving.spec",
    "deepspeed_tpu_torch.serving.spec.controller",
    "deepspeed_tpu_torch.serving.spec.proposer",
    "deepspeed_tpu_torch.serving.streaming",
    "deepspeed_tpu_torch.tokenizer",
    "deepspeed_tpu_torch.utils",
    "deepspeed_tpu_torch.utils.counter_hash",
    "deepspeed_tpu_torch.utils.groups",
    "deepspeed_tpu_torch.utils.io_bench",
    "deepspeed_tpu_torch.utils.logging",
    "deepspeed_tpu_torch.utils.pytree",
    "deepspeed_tpu_torch.utils.timer",
    "deepspeed_tpu_torch.utils.tree",
    "deepspeed_tpu_torch.version",
]


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'deepspeed_tpu', 'optax', 'orbax',\n"
        "                             'ml_dtypes', 'flax'))))\n"
    )
    # -S: no site customization, which may import jax at interpreter start
    out = subprocess.run(
        [sys.executable, "-S", "-c", f"import sys; sys.path[:0] = {sys.path!r}\n" + code],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("root", ["deepspeed_tpu_torch.serving",
                                  "deepspeed_tpu_torch.observability",
                                  "deepspeed_tpu_torch.monitor.monitor",
                                  "deepspeed_tpu_torch.serving.net",
                                  "deepspeed_tpu_torch.serving.cluster.agent",
                                  "deepspeed_tpu_torch.serving.cluster.remote_core",
                                  "deepspeed_tpu_torch.inference.cli"])
def test_serving_stack_imports_alone_without_jax(root):
    """The serving stack, the tracer and the monitors, the cross-process
    wire, the agent, the remote core and the CLI, each imported alone in a
    fresh interpreter, load neither JAX, ml_dtypes nor the JAX package
    (their JAX counterparts are stdlib-only, the copies too)."""
    code = (
        f"import importlib, json, sys\nimportlib.import_module({root!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'deepspeed_tpu', 'ml_dtypes'))))\n"
    )
    out = subprocess.run(
        [sys.executable, "-S", "-c", f"import sys; sys.path[:0] = {sys.path!r}\n" + code],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_importing_the_port_loads_no_hf_package():
    """The card's machine has no ``transformers``, ``safetensors`` or
    ``tokenizers``: importing every module of the port loads none of them
    (the tokenizer imports ``tokenizers`` when one is built)."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('transformers', 'safetensors', 'tokenizers'))))\n"
    )
    out = subprocess.run(
        [sys.executable, "-S", "-c", f"import sys; sys.path[:0] = {sys.path!r}\n" + code],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_card_path_sources_import_no_hf_package():
    """No source of the port or ``chip_smoke.py`` names ``transformers`` or
    ``safetensors`` in an import; ``tokenizers`` only inside the tokenizer's
    constructor."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(str(f.relative_to(ROOT)), root) for f in files for root in _imported_roots(f)
           if root in ("transformers", "safetensors")
           or (root == "tokenizers" and f.name != "tokenizer.py")]
    assert bad == []


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_every_module_of_the_port_is_in_the_import_list():
    """Every file of the package (packages by their ``__init__``) is either
    imported by name above or is the ``__init__`` of a package whose modules
    are: a file a slice adds cannot stay outside the check."""
    listed = set(SLICE_MODULES)
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(ROOT).with_suffix("")
        name = ".".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts)
        covered = name in listed or any(m.startswith(name + ".") for m in listed)
        assert covered, f"{name} is missing from SLICE_MODULES"


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [
        (str(f.relative_to(ROOT)), root)
        for f in files
        for root in _imported_roots(f)
        if root in ("jax", "jaxlib", "deepspeed_tpu", "flax", "optax", "orbax", "ml_dtypes")
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
    codes = torch.zeros(3, 8, 2, 64, device="meta", dtype=torch.int8)
    planes = torch.ones(3, 8, 2, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        paged_decode(q, codes, codes, tables, tables[:, 0], 2, k_scale=planes, v_scale=planes)
    from deepspeed_tpu_torch.ops.quantizer.block_quant import block_quant, quantize_kv

    with pytest.raises(ValueError, match="CPU or CUDA"):
        block_quant(torch.zeros(4, 64, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        quantize_kv(torch.zeros(2, 2, 64, device="meta"))


def test_training_wrappers_never_fall_back_for_device_tensors(monkeypatch):
    """The flash and RMSNorm-backward wrappers, and the autograd Functions
    over them, launch their kernel or raise for a tensor that is not on the
    CPU: the plain versions are poisoned here, and a meta tensor (standing
    in for a CUDA one) must reach the kernels' own checks."""
    from deepspeed_tpu_torch.ops.attention import flash as pf
    from deepspeed_tpu_torch.ops.normalization import fused_norm as fn

    def poisoned(*a, **k):
        raise AssertionError("a plain version ran for a device tensor")

    for mod, name in ((pf, "flash_fwd_reference"), (pf, "flash_bwd_reference"),
                      (fn, "rms_norm_reference"), (fn, "rms_norm_bwd_reference")):
        monkeypatch.setattr(mod, name, poisoned)
    q = torch.randn(1, 4, 64, 128, device="meta", dtype=torch.bfloat16)
    k = torch.randn(1, 2, 64, 128, device="meta", dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 64, device="meta")
    for call in (lambda: pf.flash_attention(q, k, k),
                 lambda: pf.flash_fwd_cuda(q, k, k),
                 lambda: pf.flash_bwd_dq_cuda(q, k, k, q, q, lse),
                 lambda: pf.flash_bwd_dkv_cuda(q, k, k, q, q, lse)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    x = torch.randn(3, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fn.fused_rms_norm(x, torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        fn.rms_norm_bwd_cuda(x, torch.ones(8, device="meta"), x)
    with pytest.raises(ValueError, match="CUDA"):
        fn.rms_norm_bwd_cuda(torch.randn(3, 8), torch.ones(8), torch.randn(3, 8))


def test_carry_wrappers_never_fall_back_for_device_tensors(monkeypatch):
    """The ring's chunk entries launch their kernel or raise for a tensor
    that is not on the CPU: their plain versions are poisoned, and meta
    tensors (standing in for CUDA ones) must reach the kernels' checks,
    also through the loopback ring."""
    from deepspeed_tpu_torch.ops.attention import flash as pf
    from deepspeed_tpu_torch.ops.attention.core import attention
    from deepspeed_tpu_torch.parallel.topology import Topology, reset_topology, set_topology

    def poisoned(*a, **k):
        raise AssertionError("a plain version ran for a device tensor")

    for name in ("flash_fwd_chunk_reference", "flash_dq_chunk_reference",
                 "flash_dkv_chunk_reference", "flash_fwd_reference"):
        monkeypatch.setattr(pf, name, poisoned)
    q = torch.randn(1, 4, 128, 128, device="meta", dtype=torch.bfloat16)
    k = torch.randn(1, 2, 128, 128, device="meta", dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 128, device="meta")
    set_topology(Topology(context=2, loopback=True))
    try:
        for call in (lambda: pf.flash_fwd_chunk(q, k, k),
                     lambda: pf.flash_dq_chunk(q, k, k, q, q, lse),
                     lambda: pf.flash_dkv_chunk(q, k, k, q, q, lse, final=True),
                     lambda: attention(q, k, k, impl="flash_ring")):
            with pytest.raises(ValueError, match="CUDA"):
                call()
    finally:
        reset_topology()


def test_auto_attention_refuses_an_unported_head_dim_on_a_device():
    """Off the CPU, "auto" attention is the kernel or an error: head_dim 96
    (and an fp32 input) raise instead of running ``mha_reference``."""
    from deepspeed_tpu_torch.ops.attention.core import attention

    q = torch.randn(1, 2, 64, 96, device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        attention(q, q, q, impl="auto")
    q = torch.randn(1, 2, 64, 128, device="meta")
    with pytest.raises(NotImplementedError, match="bf16"):
        attention(q, q, q)


def test_engine_runs_where_its_params_live():
    """initialize() follows the params: CPU params train on the CPU, and
    ``init_params`` puts them on the card unless asked otherwise."""
    import inspect

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as T

    assert inspect.signature(T.init_params).parameters["device"].default == "cuda"
    cfg = T.get_config("tiny", dtype="float32", remat=False, n_layers=1)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=T.make_loss_fn(cfg), model_parameters=params,
        config={"train_micro_batch_size_per_gpu": 1,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    assert eng.device.type == "cpu"
    loss = eng.train_batch(batch={"input_ids": torch.zeros(1, 9, dtype=torch.long)})
    assert bool(torch.isfinite(loss))


@pytest.mark.cuda
def test_build_and_launch_counts_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from deepspeed_tpu_torch.ops import kernels as K
    from deepspeed_tpu_torch.ops.normalization import rms_norm

    K.build()
    K.reset_counts()
    x = torch.randn(4, 64, device="cuda", requires_grad=True)
    rms_norm(x, torch.ones(64, device="cuda")).sum().backward()
    assert K.counts()["rms_norm_fwd"] == 1 and K.counts()["rms_norm_bwd"] == 1
