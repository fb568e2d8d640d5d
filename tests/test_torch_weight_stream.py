"""Weight streaming and the chunk-streamed AdamW against the JAX package.

* ``streamed_adamw_leaf`` / ``streamed_adamw_leaf_q8`` with host state and
  a window small enough to cut each leaf into several windows (and clamp
  the tail) equal the JAX functions on device leaves (its whole-leaf path,
  as the CPU takes it): fp32 within 1e-6 of each tensor's largest element;
  int8 moment codes at most one code apart where a value sits on a
  rounding boundary (XLA and torch compute the same fp32 expression in
  another order of rounding), in at most 1e-3 of the codes.
* ``StreamedAdamW`` over a tree and three steps equals the JAX class.
* The engine's weight-streaming tier (``weight_stream`` with
  ``offload_param``) runs on the CPU through the same staging code, host
  and device the same: its losses equal the port's unstreamed run bit for
  bit, two layers' slots hold every layer under remat, and the JAX
  engine's guards raise with the JAX engine's messages.
"""

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.runtime import engine as jengine
from deepspeed_tpu.runtime import streamed_adam as JS
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.weight_stream import streamed_leaf
from deepspeed_tpu_torch.ops.adam import cpu_adam
from deepspeed_tpu_torch.runtime import streamed_adam as PS
from deepspeed_tpu_torch.runtime.optimizers import _leaves

CPU = torch.device("cpu")
HP = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
F32_RTOL = 1e-6
CODE_FLIPS = 1e-3  # share of int8 codes allowed one step apart


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = cpu_adam.set_num_threads(1)
    yield
    cpu_adam.set_num_threads(prev)
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _bias(count):
    c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(count))
    c2 = float(np.float32(1) - np.float32(0.999) ** np.float32(count))
    return c1, c2


def _state(shape, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    m = rng.standard_normal(shape).astype(np.float32)
    mu = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    nu = np.abs(rng.standard_normal(shape) * 1e-5).astype(np.float32)
    return g, m, mu, nu


# leading dims that a 3-row window cuts into windows with a clamped tail
SHAPES = [(7, 512), (5, 3, 256), (300,)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("double_buffer", [True, False])
def test_windowed_leaf_equals_jax(shape, double_buffer):
    g, m, mu, nu = _state(shape, 0)
    c1, c2 = _bias(2)
    row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    chunk = 3 * row  # 3 leading rows a window: the tail is clamped
    jm, jmu, jnu, jp = JS.streamed_adamw_leaf(
        jnp.asarray(g), jnp.asarray(m), jnp.asarray(mu), jnp.asarray(nu),
        jnp.asarray(m, jnp.bfloat16), jnp.float32(1e-3), c1=jnp.float32(c1),
        c2=jnp.float32(c2), chunk=chunk, **HP)
    tg, tm, tmu, tnu = (torch.from_numpy(x.copy()) for x in (g, m, mu, nu))
    tp = tm.to(torch.bfloat16)
    PS.streamed_adamw_leaf(tg, tm, tmu, tnu, tp, 1e-3, c1=c1, c2=c2, chunk=chunk,
                           double_buffer=double_buffer, device=CPU, **HP)
    assert _rel(tm, jm) < F32_RTOL and _rel(tmu, jmu) < F32_RTOL and _rel(tnu, jnu) < F32_RTOL
    assert torch.equal(tp, tm.to(torch.bfloat16))
    # the same leaf whole (no device given: it updates where it is)
    wm = torch.from_numpy(m.copy())
    wmu, wnu = torch.from_numpy(mu.copy()), torch.from_numpy(nu.copy())
    PS.streamed_adamw_leaf(torch.from_numpy(g), wm, wmu, wnu, wm.to(torch.bfloat16), 1e-3,
                           c1=c1, c2=c2, **HP)
    assert torch.equal(wm, tm) and torch.equal(wmu, tmu) and torch.equal(wnu, tnu)


@pytest.mark.parametrize("shape", [(7, 512), (5, 3, 256)])
def test_windowed_q8_leaf_equals_jax(shape):
    g, m, mu, nu = _state(shape, 1)
    c1, c2 = _bias(3)
    chunk = 3 * int(np.prod(shape[1:]))
    # int8 moments from the same fp32 values, quantized by each package
    jmu_q, jmu_s = JS._q8_mu(jnp.asarray(mu))
    jnu_q, jnu_s = JS._q8_nu(jnp.asarray(nu))
    pmu = dict(zip(("q", "s"), PS._q8_mu(torch.from_numpy(mu))))
    pnu = dict(zip(("q", "s"), PS._q8_nu(torch.from_numpy(nu))))
    flips0 = int((pmu["q"].numpy() != np.asarray(jmu_q)).sum()
                 + (pnu["q"].numpy() != np.asarray(jnu_q)).sum())
    assert flips0 <= CODE_FLIPS * 2 * mu.size
    # hand the port the JAX codes: the update itself is compared
    pmu = {"q": torch.from_numpy(np.asarray(jmu_q).copy()),
           "s": torch.from_numpy(np.asarray(jmu_s).copy())}
    pnu = {"q": torch.from_numpy(np.asarray(jnu_q).copy()),
           "s": torch.from_numpy(np.asarray(jnu_s).copy())}
    jm, jmu, jnu, jp = JS.streamed_adamw_leaf_q8(
        jnp.asarray(g), jnp.asarray(m), {"q": jmu_q, "s": jmu_s}, {"q": jnu_q, "s": jnu_s},
        jnp.asarray(m, jnp.bfloat16), jnp.float32(1e-3), c1=jnp.float32(c1),
        c2=jnp.float32(c2), chunk=chunk, **HP)
    tm = torch.from_numpy(m.copy())
    tp = tm.to(torch.bfloat16)
    PS.streamed_adamw_leaf_q8(torch.from_numpy(g), tm, pmu, pnu, tp, 1e-3, c1=c1, c2=c2,
                              chunk=chunk, device=CPU, **HP)
    assert _rel(tm, jm) < F32_RTOL
    for got, want in ((pmu, jmu), (pnu, jnu)):
        assert _rel(got["s"], want["s"]) < F32_RTOL
        d = np.abs(got["q"].numpy().astype(np.int32) - np.asarray(want["q"]).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= CODE_FLIPS
    assert pmu["s"].shape == tuple(shape[:-1]) + (shape[-1] // 256,)


def test_streamed_adamw_three_steps_equal_jax():
    """Over a tree (a q8-eligible matrix, a stacked leaf, a vector) and three
    steps, host state streamed through windows: the port's state and
    params against the JAX class's."""
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((9, 256)).astype(np.float32),
            "layers": {"a": rng.standard_normal((4, 2, 256)).astype(np.float32)},
            "b": rng.standard_normal(40).astype(np.float32)}
    for bits in (0, 8):
        jo = JS.StreamedAdamW(lr=1e-3, weight_decay=0.01, chunk_elems=512, quant_bits=bits)
        po = PS.StreamedAdamW(lr=1e-3, weight_decay=0.01, chunk_elems=512, quant_bits=bits,
                              device=CPU)
        jparams = jax.tree.map(jnp.asarray, tree)
        jstate = jo.init(jparams)
        pparams = {"w": torch.from_numpy(tree["w"].copy()),
                   "layers": {"a": torch.from_numpy(tree["layers"]["a"].copy())},
                   "b": torch.from_numpy(tree["b"].copy())}
        pstate = po.init(pparams)
        for step in range(3):
            grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-2)
                                 .astype(np.float32), tree)
            jparams, jstate = jo.step(jax.tree.map(jnp.asarray, grads), jstate, jparams,
                                      jnp.float32(1e-3))
            pstate = po.step({"w": torch.from_numpy(grads["w"]),
                              "layers": {"a": torch.from_numpy(grads["layers"]["a"])},
                              "b": torch.from_numpy(grads["b"])}, pstate, pparams, 1e-3)
        assert pstate.inner["count"] == int(jstate.inner.count) == 3
        jflat = dict(_leaves(jax.tree.map(np.asarray, {"p": jparams,
                                                       "m": jstate.master})))
        for name, t in _leaves({"p": pparams, "m": pstate.master}):
            assert _rel(t, jflat[name]) < 1e-5, (bits, name)
        if bits == 8:
            assert isinstance(pstate.inner["mu"]["w"], dict)
            assert isinstance(pstate.inner["mu"]["b"], torch.Tensor)  # not eligible


# ---------------------------------------------------------------------------
# the engine's weight-streaming tier
# ---------------------------------------------------------------------------
BASE = dict(vocab_size=256, hidden_size=64, n_layers=3, n_heads=4, n_kv_heads=2,
            max_seq_len=64, dtype="float32")
STREAM_ZERO = {"stage": 3, "offload_param": {"device": "cpu"},
               "offload_optimizer": {"device": "cpu", "stream_quant_bits": 0}}


def _ds(zero=None, **extra):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "steps_per_print": 1000, "zero_optimization": copy.deepcopy(zero or {"stage": 3}),
            **extra}


def _port(cfg, **model):
    pc = PT.get_config("tiny", **dict(BASE, **model))
    jc = JT.get_config("tiny", **dict(BASE, **model))
    tp = params_from_numpy(jax.tree.map(np.asarray, JT.init_params(jc, jax.random.key(0))))
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=copy.deepcopy(cfg))
    return pe


def _batches(n=3):
    rng = np.random.default_rng(4)
    return [{"input_ids": rng.integers(0, 256, size=(2, 33)).astype(np.int32)}
            for _ in range(n)]


def test_streamed_leaves_follow_the_jax_rule():
    assert streamed_leaf((2, 64, 64), torch.bfloat16)
    assert not streamed_leaf((2, 64), torch.float32)
    assert streamed_leaf((2048, 2048), torch.float32)  # 16 MiB
    assert not streamed_leaf((2048, 1024), torch.float16)  # 4 MiB
    assert not streamed_leaf((64,), torch.float32)


@pytest.mark.parametrize("remat", [("nothing", True), ("dots", True), (None, False)])
def test_streamed_engine_equals_the_unstreamed_run(remat):
    """Losses bit for bit against the same config without weight_stream
    (fp32 moments: StreamedAdamW's math is AdamW's), the params too; under
    remat two slots hold every layer, without it each layer gets buffers of
    its own (autograd keeps them for the backward)."""
    policy, on = remat
    over = dict(remat=on, **({"remat_policy": policy} if policy else {}))
    a = _port(_ds(STREAM_ZERO), weight_stream=True, **over)
    b = _port(_ds(STREAM_ZERO), weight_stream=False, **over)
    st = a._streamer
    assert a._weight_stream and not b._weight_stream and st is not None
    assert a.optimizer.name == "streamed_adamw" and b.optimizer.name == "adamw"
    assert set(st.layers) == {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    assert "attn_norm" not in st.layers  # small leaves stay on the device
    for batch in _batches():
        st.reset_counts()
        assert float(a.train_batch(batch=batch)) == float(b.train_batch(batch=batch))
        L = st.n_layers
        assert st.stages == (2 * L if on else L)
        if on:
            assert st.extra_stages == 0 and st.peak_bytes == 2 * st.layer_bytes
        else:
            assert st.extra_stages == L and st.peak_bytes == L * st.layer_bytes
        assert st.d2h_bytes >= L * st.layer_bytes
    for (name, x), (_, y) in zip(_leaves(a.params), _leaves(b.params)):
        assert torch.equal(x, y), name
    assert float(a.eval_batch(_batches(1)[0])) == float(b.eval_batch(_batches(1)[0]))


def test_streamed_q8_engine_equals_the_same_engine_on_one_device():
    """int8 moments: the streamed engine against itself with the streamer
    dropped (every leaf where it was made, StreamedAdamW's whole-leaf
    path): losses and params bit for bit."""
    zero = copy.deepcopy(STREAM_ZERO)
    zero["offload_optimizer"]["stream_quant_bits"] = 8
    a = _port(_ds(zero), weight_stream=True, hidden_size=256, n_heads=4, n_kv_heads=4,
              ffn_hidden_size=512, remat=True, remat_policy="nothing")
    b = _port(_ds(zero), weight_stream=True, hidden_size=256, n_heads=4, n_kv_heads=4,
              ffn_hidden_size=512, remat=True, remat_policy="nothing")
    b._streamer = None
    a.optimizer.chunk_elems = b.optimizer.chunk_elems = 1 << 14  # several windows a leaf
    assert isinstance(a.opt_state.inner["mu"]["layers"]["wq"], dict)
    for batch in _batches():
        assert float(a.train_batch(batch=batch)) == float(b.train_batch(batch=batch))
    for (name, x), (_, y) in zip(_leaves(a.params), _leaves(b.params)):
        assert torch.equal(x, y), name


def test_streamed_engine_first_loss_equals_the_jax_engines():
    """On the CPU the JAX model's weight_stream is a no-op (its staging is
    TPU-only): the same config's first loss agrees to fp32 rounding."""
    jc = JT.get_config("tiny", **dict(BASE, weight_stream=True))
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc),
                                      model_parameters=JT.init_params(jc, jax.random.key(0)),
                                      config=_ds(STREAM_ZERO))
    pe = _port(_ds(STREAM_ZERO), weight_stream=True)
    b = _batches(1)[0]
    np.testing.assert_allclose(float(pe.train_batch(batch=b)), float(je.train_batch(batch=b)),
                               rtol=1e-5)


GUARDS = {
    "gas": ({"gradient_accumulation_steps": 2, "train_batch_size": 4},
            "weight_stream requires gradient_accumulation_steps == 1"),
    "clipping": ({"gradient_clipping": 1.0}, "gradient_clipping is unsupported with"),
    "fp16": ({"fp16": {"enabled": True}}, "fp16 dynamic loss scaling is unsupported"),
    "lamb": ({"optimizer": {"type": "Lamb", "params": {}}}, "weight_stream supports Adam/AdamW"),
    "adam_wd": ({"optimizer": {"type": "Adam", "params": {"weight_decay": 0.1,
                                                          "adam_w_mode": False}}},
                r"implements decoupled \(AdamW\) weight decay only"),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_jax_guards_raise_with_the_jax_messages(name):
    """The JAX engine raises these only on a TPU (its streaming is TPU-only);
    the port raises them wherever it streams, each message the JAX
    engine's own sentence."""
    over, match = GUARDS[name]
    cfg = _ds(STREAM_ZERO)
    cfg.update(over)
    with pytest.raises(NotImplementedError, match=match) as ei:
        _port(cfg, weight_stream=True)
    src = " ".join(inspect.getsource(jengine).split())
    for piece in str(ei.value).replace("(got lamb)", "(got {self.optimizer.name})").split(": "):
        assert piece[:60] in src.replace('" "', ""), piece


def test_imperative_step_refuses_the_streamed_tier():
    pe = _port(_ds(STREAM_ZERO), weight_stream=True)
    b = _batches(1)[0]
    pe.forward(b)
    pe.backward()
    with pytest.raises(AssertionError, match="train_batch streamed path"):
        pe.step()
