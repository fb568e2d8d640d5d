"""The port's op-registry entry point against the JAX package's.

``get_accelerator().create_op_builder(name).load()``: every op name the JAX
package registers is registered; the ported ones load the port's code (the
kernels' plain versions on the CPU accelerator), the others are not
compatible and raise naming their ROADMAP item. ``get_accelerator()``
honours ``DS_ACCELERATOR`` and, with no override, is the CUDA accelerator,
which refuses a missing card instead of running on the host.
``env_report`` (``ds_report``) prints the stack and the op table.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deepspeed_tpu.ops as jops
import deepspeed_tpu_torch
import deepspeed_tpu_torch.ops as pops
from deepspeed_tpu_torch import env_report
from deepspeed_tpu_torch.accelerator import real_accelerator
from deepspeed_tpu_torch.accelerator.cuda_accelerator import CPU_Accelerator, CUDA_Accelerator
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.op_builder import ALL_OPS, CUDAOpBuilder, build_all_ops


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
# the ops with kernels (CUDAOpBuilder) and those that are plain torch (OpBuilder)
CUDA_OPS = ("flash_attn", "fused_adam", "quantizer", "rms_norm", "sparse_attn", "fp_quantizer",
            "evoformer_attn")
PLAIN_OPS = ("spatial_inference", "random_ltd")
PORTED = CUDA_OPS + PLAIN_OPS
UNPORTED = ("async_io", "cpu_adam")


@pytest.fixture
def accelerator(monkeypatch):
    """A fresh accelerator singleton under the DS_ACCELERATOR the test sets
    (the suite runs with ``cpu``)."""
    monkeypatch.setattr(real_accelerator, "_accelerator", None)

    def use(value):
        if value is None:
            monkeypatch.delenv("DS_ACCELERATOR", raising=False)
        else:
            monkeypatch.setenv("DS_ACCELERATOR", value)
        monkeypatch.setattr(real_accelerator, "_accelerator", None)
        return deepspeed_tpu_torch.get_accelerator()

    return use


def test_every_jax_op_is_registered():
    assert set(ALL_OPS) == set(jops.ALL_OPS)
    assert set(PORTED) | set(UNPORTED) == set(ALL_OPS)
    assert {n for n, ok in pops.__compatible_ops__.items() if ok} == set(PORTED)


def _expected(name):
    from deepspeed_tpu_torch.ops.adam import FusedAdam
    from deepspeed_tpu_torch.ops.attention.core import attention
    from deepspeed_tpu_torch.ops.deepspeed4science import DS4Sci_EvoformerAttention
    from deepspeed_tpu_torch.ops.normalization import rms_norm

    return {
        "flash_attn": attention,
        "fused_adam": FusedAdam,
        "quantizer": importlib.import_module("deepspeed_tpu_torch.ops.quantizer"),
        "rms_norm": rms_norm,
        "sparse_attn": importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention"),
        "fp_quantizer": importlib.import_module("deepspeed_tpu_torch.ops.quantizer.block_quant"),
        "evoformer_attn": DS4Sci_EvoformerAttention,
        "spatial_inference": importlib.import_module("deepspeed_tpu_torch.ops.spatial"),
        "random_ltd": importlib.import_module("deepspeed_tpu_torch.ops.random_ltd"),
    }[name]


@pytest.mark.parametrize("name", PORTED)
def test_ported_builders_load_the_ported_code(accelerator, monkeypatch, name):
    """On the CPU accelerator a ported op loads without building anything
    (its wrappers take their plain versions for CPU tensors)."""
    def no_build(*a, **k):
        raise AssertionError("the CPU accelerator built a kernel")

    monkeypatch.setattr(K, "build", no_build)
    accel = accelerator("cpu")
    builder = accel.create_op_builder(name)
    assert isinstance(builder, CUDAOpBuilder) == (name in CUDA_OPS) and builder.is_compatible()
    assert builder.load(verbose=False) is _expected(name)
    assert builder.load(verbose=False) is _expected(name)  # loaded once
    if name in CUDA_OPS:
        assert all(k in K.KERNELS for k in builder.KERNELS) and builder.KERNELS


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_builders_raise(accelerator, name):
    builder = accelerator("cpu").create_op_builder(name)
    assert not builder.is_compatible()
    with pytest.raises(NotImplementedError, match=f"{name}.*ROADMAP queue"):
        builder.load()
    assert accelerator("cpu").create_op_builder("no_such_op") is None


def test_sparse_attn_module_runs_the_layout_path_on_the_cpu(accelerator):
    """The op the slice's path takes: the module handed out runs
    ``SparseSelfAttention(use_splash=False)``, and the package exports the
    function under the module's name, as the JAX package does."""
    sa = accelerator("cpu").create_op_builder("sparse_attn").load(verbose=False)
    assert pops.sparse_attention is sa.sparse_attention and callable(pops.sparse_attention)
    assert pops.SparseSelfAttention is sa.SparseSelfAttention
    cfg = sa.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2,
                                 attention="unidirectional")
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, h, 64, 16, generator=gen) for h in (2, 1, 1))
    out = sa.SparseSelfAttention(cfg, use_splash=False)(q, k, v)
    ref = sa.sparse_attention_reference(q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1),
                                        cfg.make_layout(64), 16, causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("value,name,backend", [("cpu", "cpu", "gloo"), ("cuda", "cuda", "nccl"),
                                                (None, "cuda", "nccl")])
def test_get_accelerator_honours_ds_accelerator(accelerator, value, name, backend):
    accel = accelerator(value)
    assert accel._name == name and accel.communication_backend_name() == backend
    assert isinstance(accel, CPU_Accelerator if name == "cpu" else CUDA_Accelerator)
    assert deepspeed_tpu_torch.get_accelerator() is accel


def test_get_accelerator_refuses_an_unknown_override(accelerator):
    with pytest.raises(ValueError, match="cuda|cpu"):
        accelerator("tpu")


def test_cpu_accelerator_is_the_host(accelerator):
    accel = accelerator("cpu")
    assert accel.device() == torch.device("cpu") and accel.device_count() == 1
    assert accel.is_available() and accel.is_bf16_supported()
    assert accel.supported_dtypes() == [torch.float32, torch.float16, torch.bfloat16]
    accel.synchronize()
    ev0, ev1 = accel.Event(enable_timing=True), accel.Event(enable_timing=True)
    ev0.record()
    ev1.record()
    assert ev0.elapsed_time(ev1) >= 0
    assert accel.create_graph() is None and accel.on_accelerator(torch.zeros(1))


def test_cuda_accelerator_refuses_a_missing_card(accelerator, monkeypatch):
    """With no card, the first device call raises and names the way to the
    CPU accelerator; the op builders refuse to load; nothing is handed the
    CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    accel = accelerator(None)
    assert isinstance(accel, CUDA_Accelerator) and not accel.is_available()
    for call in (accel.device, accel.device_count, accel.current_device, accel.synchronize,
                 accel.memory_allocated, accel.memory_stats, accel.empty_cache,
                 accel.create_graph, accel.is_bf16_supported, lambda: accel.Event,
                 lambda: accel.manual_seed(0)):
        with pytest.raises(RuntimeError, match="DS_ACCELERATOR=cpu"):
            call()
    builder = accel.create_op_builder("sparse_attn")
    assert not builder.is_compatible()
    with pytest.raises(RuntimeError, match="DS_ACCELERATOR=cpu"):
        builder.load()


def test_cuda_builder_load_builds_its_sources_and_raises_on_a_failed_build(accelerator,
                                                                         monkeypatch):
    """On the CUDA accelerator, ``load()`` builds exactly the op's kernels
    first, and a build that fails raises (no return-None fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(CUDA_Accelerator, "device", lambda self, i=None: torch.device("cuda"))
    built = []
    monkeypatch.setattr(K, "build", lambda ks: built.append(sorted(k.name for k in ks)))
    accel = accelerator("cuda")
    assert accel.create_op_builder("sparse_attn").load(verbose=False) is _expected("sparse_attn")
    assert built == [sorted(pops.SparseAttnBuilder.KERNELS)]

    def failing(ks):
        raise RuntimeError("CUDA kernel build failed: sparse_fwd.cu")

    monkeypatch.setattr(K, "build", failing)
    with pytest.raises(RuntimeError, match="build failed"):
        accel.create_op_builder("rms_norm").load(verbose=False)


def test_build_all_ops_on_the_cpu_accelerator(accelerator):
    accelerator("cpu")
    results = build_all_ops(verbose=False)
    assert results == {name: name in PORTED for name in ALL_OPS}


def test_env_report_returns_zero_on_the_cpu_accelerator(accelerator, capsys):
    accelerator("cpu")
    assert env_report.main() == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert any(r.startswith("torch ") and r.endswith(f" {torch.__version__}") for r in lines)
    assert "accelerator" in out and "gloo" in out
    rows = dict(env_report.op_report())
    assert rows == {name: name in PORTED for name in ALL_OPS}
    for name, ok in rows.items():
        assert f"{name:<28} {env_report.GREEN_OK if ok else env_report.RED_NO}" in out


def test_env_report_runs_as_a_module():
    env = dict(os.environ, DS_ACCELERATOR="cpu", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.env_report"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "op availability:" in out.stdout and "sparse_attn" in out.stdout


@pytest.mark.cuda
def test_sparse_attn_op_on_the_card(monkeypatch):
    """Through the registry on a card: the sparse sources build, and
    ``SparseSelfAttention(use_splash=False)`` launches each sparse kernel
    once per forward and backward, and no splash or flash kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    monkeypatch.delenv("DS_ACCELERATOR", raising=False)
    sa = deepspeed_tpu_torch.get_accelerator().create_op_builder("sparse_attn").load()
    cfg = sa.FixedSparsityConfig(num_heads=4, block=64, num_local_blocks=2,
                                 attention="unidirectional")
    q = torch.randn(1, 4, 512, 128, device="cuda").bfloat16().requires_grad_(True)
    k, v = (torch.randn(1, 2, 512, 128, device="cuda").bfloat16().requires_grad_(True)
            for _ in range(2))
    K.reset_counts()
    sa.SparseSelfAttention(cfg, use_splash=False)(q, k, v).sum().backward()
    torch.cuda.synchronize()
    assert K.counts() == {n: int(n in ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv"))
                          for n in K.KERNELS}
