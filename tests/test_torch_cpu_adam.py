"""The port's host optimizers against the JAX package's.

``deepspeed_tpu_torch.ops.adam.cpu_adam`` and ``deepspeed_tpu.ops.adam.
cpu_adam`` build the same ``csrc/adam/cpu_adam.cpp`` with the same flags on
this host, so on the same seeded inputs their native steps and casts are
equal bit for bit. Each native entry point is held against its plain
version (the JAX module's numpy math) as ||native - plain|| / ||plain||:
params and casts within 1e-6; a moment updated by (1 - beta) g within
2e-5, because the library rounds 1 - beta to fp32 from the fp32 beta and
the numpy math from the double 1 - beta (1 - 0.999f is 1.2e-5 off 0.001).
The library runs on one OpenMP thread here (``set_num_threads``), as the
tests of the suite run side by side.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam import cpu_adam as J
from deepspeed_tpu_torch import get_accelerator
from deepspeed_tpu_torch.accelerator import real_accelerator
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.adam import cpu_adam as P

PARAM_RTOL = 1e-6
MOMENT_RTOL = 2e-5
N = 4099  # not a multiple of any vector width


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op torch thread and one OpenMP thread for the library."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = P.set_num_threads(1)
    yield
    P.set_num_threads(prev)
    torch.set_num_threads(n)


def _inputs(seed=0, n=N):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    m = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    v = np.abs(rng.standard_normal(n) * 1e-6).astype(np.float32)
    return p, g, m, v


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) or 1.0))


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("adamw,wd", [(True, 0.01), (False, 0.01), (True, 0.0)])
def test_adam_equals_jax_native_and_its_plain_version(adamw, wd):
    """Three steps: the port's native CPU-Adam equals the JAX package's
    native build bit for bit; the plain version is within the stated
    bounds, and the step counts agree."""
    arrays = _inputs()
    jp = [a.copy() for a in arrays]
    pp, ref = _t(arrays), _t(arrays)
    jopt = J.DeepSpeedCPUAdam(lr=1e-3, weight_decay=wd, adamw_mode=adamw)
    assert jopt.is_native
    popt = P.DeepSpeedCPUAdam(lr=1e-3, weight_decay=wd, adamw_mode=adamw)
    plain = P.DeepSpeedCPUAdam(lr=1e-3, weight_decay=wd, adamw_mode=adamw)
    for step in range(3):
        assert jopt.step(*jp, lr=1e-3) == popt.step(*pp, lr=1e-3) == step + 1
        plain.step_reference(*ref, lr=1e-3)
    for j, p in zip(jp, pp):
        assert np.array_equal(j.view(np.uint32), p.numpy().view(np.uint32))
    assert _rel(pp[0], ref[0]) < PARAM_RTOL
    assert _rel(pp[2], ref[2]) < MOMENT_RTOL and _rel(pp[3], ref[3]) < MOMENT_RTOL


def test_adam_takes_an_explicit_step_and_refuses_bad_buffers():
    p, g, m, v = _t(_inputs())
    opt = P.DeepSpeedCPUAdam()
    assert opt.step(p, g, m, v, step=7) == 7 and opt.steps == 7
    with pytest.raises(ValueError, match="size"):
        opt.step(p, g[:-1], m, v)
    with pytest.raises(ValueError, match="float32"):
        opt.step(p.double(), g, m, v)
    with pytest.raises(ValueError, match="strided"):
        opt.step(torch.zeros(2 * N)[::2], g, m, v)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adagrad_equals_jax_native_and_its_plain_version(wd):
    p, g, _, v = _inputs(1)
    jp, jv = p.copy(), v.copy()
    tp, tg, tv = _t((p, g, v))
    rp, rv = _t((p, v))
    for _ in range(3):
        J.cpu_adagrad_step(jp, g, jv, 1e-2, weight_decay=wd)
        P.cpu_adagrad_step(tp, tg, tv, 1e-2, weight_decay=wd)
        P.cpu_adagrad_step_reference(rp, tg, rv, 1e-2, weight_decay=wd)
    assert np.array_equal(jp, tp.numpy()) and np.array_equal(jv, tv.numpy())
    assert _rel(tp, rp) < PARAM_RTOL and _rel(tv, rv) < PARAM_RTOL


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_lion_equals_jax_native_and_its_plain_version(wd):
    p, g, m, _ = _inputs(2)
    jp, jm = p.copy(), m.copy()
    tp, tg, tm = _t((p, g, m))
    rp, rm = _t((p, m))
    for _ in range(3):
        J.cpu_lion_step(jp, g, jm, 1e-4, weight_decay=wd)
        P.cpu_lion_step(tp, tg, tm, 1e-4, weight_decay=wd)
        P.cpu_lion_step_reference(rp, tg, rm, 1e-4, weight_decay=wd)
    assert np.array_equal(jp, tp.numpy()) and np.array_equal(jm, tm.numpy())
    assert _rel(tp, rp) < PARAM_RTOL and _rel(tm, rm) < MOMENT_RTOL


def test_bf16_casts_equal_jax_and_their_plain_versions():
    """fp32 -> bf16 rounds to nearest even, bf16 -> fp32 widens: the bits
    equal the JAX package's native casts, the plain versions and torch's
    own cast, for bfloat16, int16 and uint16 views of the bits."""
    x = np.concatenate([_inputs(3)[0], np.float32([0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8,
                                                   np.inf, -np.inf, 3e38])])
    t = torch.from_numpy(x.copy())
    j16 = J.fp32_to_bf16(x)
    p16 = P.fp32_to_bf16(t)
    assert p16.dtype == torch.bfloat16
    bits = p16.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(bits, j16)
    assert np.array_equal(bits, P.fp32_to_bf16_reference(t).view(torch.int16).numpy()
                          .view(np.uint16))
    assert torch.equal(p16, t.bfloat16())
    for dst in (torch.empty(x.size, dtype=torch.int16), torch.empty(x.size, dtype=torch.uint16)):
        P.fp32_to_bf16(t, dst)
        assert np.array_equal(dst.view(torch.int16).numpy().view(np.uint16), j16)
    wide = P.bf16_to_fp32(p16)
    assert np.array_equal(wide.numpy().view(np.uint32), J.bf16_to_fp32(j16).view(np.uint32))
    assert torch.equal(wide, P.bf16_to_fp32_reference(p16))
    assert torch.equal(wide, p16.float())


def test_native_ops_refuse_a_device_or_dtype_they_cannot_take():
    with pytest.raises(ValueError, match="CPU"):
        P.cpu_adagrad_step(np.zeros(4, np.float32), torch.zeros(4), torch.zeros(4), 1e-2)
    with pytest.raises(ValueError, match="float32"):
        P.fp32_to_bf16(torch.zeros(4, dtype=torch.float64))


@pytest.fixture
def cpu_accelerator(monkeypatch):
    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    yield get_accelerator()
    monkeypatch.setattr(real_accelerator, "_accelerator", None)


def test_builder_hands_out_the_library_built_under_build(cpu_accelerator):
    """``create_op_builder("cpu_adam").load()`` is the ctypes library,
    built from csrc/ into build/torch_kernels/host/ (a name keyed by the
    source's bytes, the flags and the host)."""
    builder = cpu_accelerator.create_op_builder("cpu_adam")
    assert builder.is_compatible()
    lib = builder.load(verbose=False)
    assert lib is P.CPUAdamBuilder.lib()
    path = op_builder.host_library_path(
        "cpu_adam", [op_builder.CSRC_DIR / "adam/cpu_adam.cpp"])
    assert path.parent == op_builder.HOST_BUILD_DIR and path.exists()
    assert op_builder.HOST_BUILD_DIR.parts[-3:] == ("build", "torch_kernels", "host")
    assert lib._name == str(path)


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises, naming g++'s
    complaint, and nothing is cached for the op."""
    bad = tmp_path / "csrc"
    (bad / "adam").mkdir(parents=True)
    (bad / "adam" / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(op_builder, "CSRC_DIR", bad)
    monkeypatch.setattr(op_builder, "HOST_BUILD_DIR", tmp_path / "build")

    class Broken(op_builder.NativeOpBuilder):
        NAME = "broken_host_op"
        SOURCES = ("adam/broken.cpp",)

        @staticmethod
        def _bind(lib):
            pass

    with pytest.raises(RuntimeError, match=r"(?s)native build of broken_host_op failed.*error"):
        Broken().load(verbose=False)
    assert "broken_host_op" not in op_builder.NativeOpBuilder._libs
    assert not list((tmp_path / "build").glob("*.so"))
