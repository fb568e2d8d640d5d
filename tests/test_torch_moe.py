"""Top-k MoE in the PyTorch port against the JAX package, on the CPU.

  * gating: ``top1gating`` (no noise), ``top2gating`` and ``topkgating``
    under each drop policy with ``normalize`` both ways, on logits with
    tied rows and tied entries: dispatch and counts exact; combine and
    l_aux within a few fp32 units in the last place (XLA's CPU ``exp`` and
    ATen's differ in the last bit on some inputs, so the softmax gates
    cannot be bit-equal; the drops they decide are);
  * ``moe_mlp`` with residual and shared experts, on [b, s, h] and the
    serving engine's [t, h];
  * ``ops.moe_gemm``: ``grouped_gemm``, ``moe_mlp_dropless`` and its
    reference;
  * the MoE model: its leaves through ``params_from_numpy``, loss (the aux
    loss included) and every leaf's gradient against ``jax.value_and_grad``;
  * the serving engine: greedy ``InferenceEngineV2`` streams of a tiny MoE
    model equal to the JAX engine's token for token at
    ``moe_capacity_factor`` 1.25 (tokens are dropped), through the split
    step, ``decode_round`` and ``spec_round``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.config import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import moe_gemm as jgemm
from deepspeed_tpu.parallel.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig as EngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops import moe_gemm as pgemm
from deepspeed_tpu_torch.parallel import moe as pmoe_pkg
from deepspeed_tpu_torch.parallel.moe import sharded_moe as pmoe
from deepspeed_tpu_torch.runtime.optimizers import _leaves

from tests import test_torch_spec_decode as spec


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# combine weights and l_aux: fp32 softmax gates whose exp differs in the
# last bit between XLA and ATen on some inputs -> a few units of 2^-24
GATE_RTOL = 4 * 2.0 ** -23
GATE_ATOL = 1e-7
# fp32 model outputs and gradients: the same function summed in another order
FP32_ATOL = FP32_RTOL = 2e-5
LOSS_RTOL = 1e-5


def _logits(s, e, seed):
    """Router logits with two equal rows and an entry tied within a row."""
    x = np.random.default_rng(seed).standard_normal((s, e)).astype(np.float32)
    x[3] = x[5]
    x[7, 1] = x[7, 2]
    return x


def _gatings():
    cases = {"top1": lambda m, x: m.top1gating(x, 1.0),
             "top1_nodrop": lambda m, x: m.top1gating(x, 1.0, drop_tokens=False),
             "top2": lambda m, x: m.top2gating(x, 1.0)}
    for pol in ("probs", "position", "choice_priority"):
        for norm in (True, False):
            cases[f"top3_{pol}_norm{int(norm)}"] = (
                lambda m, x, pol=pol, norm=norm: m.topkgating(x, 3, 1.0, drop_policy=pol,
                                                             normalize=norm))
    return cases


@pytest.mark.parametrize("shape", [(64, 8), (37, 4)])
@pytest.mark.parametrize("gating", sorted(_gatings()))
def test_gating_matches_jax(gating, shape):
    """Dispatch masks and expert counts exact, combine weights and l_aux to
    GATE_RTOL; tokens are dropped (the capacity binds) in the dropping
    forms."""
    x = _logits(*shape, seed=shape[0])
    fn = _gatings()[gating]
    jl, jc, jd, jn = (np.asarray(a) for a in fn(jmoe, jnp.asarray(x)))
    pl, pc, pd, pn = (a.numpy() for a in fn(pmoe, torch.from_numpy(x)))
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pn, jn)
    np.testing.assert_allclose(pc, jc, atol=GATE_ATOL, rtol=GATE_RTOL)
    np.testing.assert_allclose(pl, jl, atol=GATE_ATOL, rtol=GATE_RTOL)
    if "nodrop" not in gating:
        assert pd.sum() < pn.sum()  # some choices were dropped


def test_top_k_breaks_ties_by_index_as_jax():
    g = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = pmoe._top_k(g, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(g.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_gate_object_and_unknown_policy():
    x = torch.from_numpy(_logits(32, 4, seed=1))
    gate = pmoe.TopKGate(k=2, capacity_factor=1.0, eval_capacity_factor=2.0)
    jgate = jmoe.TopKGate(k=2, capacity_factor=1.0, eval_capacity_factor=2.0)
    for train in (True, False):
        got = gate(x, train=train)
        want = jgate(jnp.asarray(x.numpy()), train=train)
        assert got[1].shape == want[1].shape  # capacity from the train / eval factor
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # RSample noise draws from a torch.Generator: seeded, it repeats
    noisy = pmoe.TopKGate(k=1, noisy_gate_policy="RSample")
    a = noisy(x, rng=torch.Generator().manual_seed(3))[2]
    b = noisy(x, rng=torch.Generator().manual_seed(3))[2]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="drop_policy"):
        pmoe.topkgating(x, 2, drop_policy="nope")


def _moe_config(**over):
    kw = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
              max_seq_len=64, remat=False, dtype="float32", n_experts=4, moe_top_k=2,
              moe_capacity_factor=1.25, **over)
    return JT.TransformerConfig(**kw), PT.TransformerConfig(**kw)


def _layer0(jc, seed=0):
    jp = JT.init_params(jc, jax.random.key(seed))
    lp = jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"])
    return lp, params_from_numpy(lp)


@pytest.mark.parametrize("over", [
    {}, {"moe_residual": True}, {"moe_shared_expert_dim": 48, "moe_norm_topk_prob": False},
    {"activation": "gelu"},
], ids=["plain", "residual", "shared", "gelu"])
def test_moe_mlp_matches_jax(over):
    jc, pc = _moe_config(**over)
    jlp, plp = _layer0(jc)
    x = np.random.default_rng(5).standard_normal((2, 24, 64)).astype(np.float32)
    jo, jaux = jmoe.moe_mlp(jc, jax.tree.map(jnp.asarray, jlp), jnp.asarray(x))
    po, paux = pmoe.moe_mlp(pc, plp, torch.from_numpy(x))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=FP32_ATOL, rtol=FP32_RTOL)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=GATE_RTOL)
    # the engine's packed [t, h] rows: the same call as [1, t, h]
    flat, _ = pmoe.moe_mlp(pc, plp, torch.from_numpy(x.reshape(48, 64)))
    one, _ = pmoe.moe_mlp(pc, plp, torch.from_numpy(x.reshape(1, 48, 64)))
    torch.testing.assert_close(flat, one[0], atol=0, rtol=0)
    layer = pmoe_pkg.MoE(pc, plp)(torch.from_numpy(x))
    torch.testing.assert_close(layer[0], po, atol=0, rtol=0)


def test_mappings_and_expert_parallel_refusal(monkeypatch):
    x = torch.ones(2, 3)
    assert pmoe_pkg.gather_tokens(x) is x and pmoe_pkg.drop_tokens(x) is x
    jc, pc = _moe_config(comm_quant="int8")
    _, plp = _layer0(jc)
    from deepspeed_tpu_torch.parallel import topology

    class Topo:
        expert_parallel_size = 2
        model_parallel_size = 1

        def axis_size(self, axis):
            return 2

    monkeypatch.setattr(topology, "get_topology", lambda: Topo())
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        pmoe.moe_mlp(pc, plp, torch.zeros(1, 4, 64))


@pytest.mark.parametrize("gated", [True, False])
def test_grouped_gemm_and_dropless_match_jax(gated):
    rng = np.random.default_rng(int(gated))
    t, h, f, E = 40, 16, 24, 4
    tokens = rng.standard_normal((t, h)).astype(np.float32)
    logits = rng.standard_normal((t, E)).astype(np.float32)
    w_up = rng.standard_normal((E, h, f)).astype(np.float32)
    w_down = rng.standard_normal((E, f, h)).astype(np.float32)
    w_gate = rng.standard_normal((E, h, f)).astype(np.float32) if gated else None
    sizes = np.array([10, 0, 17, 9], np.int32)  # 36 of 40 rows: the last 4 are zeros
    jg = jgemm.grouped_gemm(jnp.asarray(tokens), jnp.asarray(w_up), jnp.asarray(sizes))
    pg = pgemm.grouped_gemm(torch.from_numpy(tokens), torch.from_numpy(w_up),
                            torch.from_numpy(sizes))
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=FP32_ATOL, rtol=FP32_RTOL)
    assert not pg[36:].any()
    act = (jax.nn.silu, torch.nn.functional.silu) if gated else (
        jax.nn.gelu, lambda u: torch.nn.functional.gelu(u, approximate="tanh"))
    ja = [jnp.asarray(a) if a is not None else None for a in (tokens, logits, w_up, w_down, w_gate)]
    pa = [torch.from_numpy(a) if a is not None else None
          for a in (tokens, logits, w_up, w_down, w_gate)]
    jo, jsizes = jgemm.moe_mlp_dropless(*ja, top_k=2, activation=act[0])
    po, psizes = pgemm.moe_mlp_dropless(*pa, top_k=2, activation=act[1])
    np.testing.assert_array_equal(psizes.numpy(), np.asarray(jsizes))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4, rtol=FP32_RTOL)
    ref = pgemm.moe_mlp_dropless_reference(*pa, top_k=2, activation=act[1])
    jref = jgemm.moe_mlp_dropless_reference(*ja, top_k=2, activation=act[0])
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=1e-4, rtol=FP32_RTOL)
    np.testing.assert_allclose(po.numpy(), ref.numpy(), atol=1e-4, rtol=FP32_RTOL)


FAMILIES = {
    "mixtral": dict(),
    "residual": dict(moe_residual=True),
    "qwen2_moe": dict(moe_shared_expert_dim=48, moe_norm_topk_prob=False, attn_qkv_bias=True),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_moe_leaves_cross_with_params_from_numpy(family):
    """The JAX package's MoE parameters move over as they are: the same
    leaves (router, [L, E, h, f] experts, residual and shared experts) and
    shapes as the port's own ``init_params``."""
    jc, pc = _moe_config(**FAMILIES[family])
    jp = JT.init_params(jc, jax.random.key(0))
    moved = dict(_leaves(params_from_numpy(jax.tree.map(np.asarray, jp))))
    own = dict(_leaves(PT.init_params(pc, torch.Generator().manual_seed(0), "cpu")))
    assert {k: tuple(v.shape) for k, v in moved.items()} == {
        k: tuple(v.shape) for k, v in own.items()}
    assert moved["layers/w_up"].shape == (2, 4, 64, pc.ffn_dim)
    for name, leaf in _leaves(jax.tree.map(np.asarray, jp)):
        np.testing.assert_array_equal(moved[name].numpy(), leaf)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_moe_loss_and_grads_match_jax(family):
    """make_loss_fn (the aux loss times its coefficient included) and every
    leaf's gradient against jax.value_and_grad, in fp32; the aux loss moves
    the loss."""
    jc, pc = _moe_config(**FAMILIES[family])
    jp = JT.init_params(jc, jax.random.key(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(2).integers(0, 256, size=(2, 33)).astype(np.int32)
    jl, jg = jax.value_and_grad(JT.make_loss_fn(jc))(jp, {"input_ids": jnp.asarray(toks)})
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    loss = PT.make_loss_fn(pc)(tp, {"input_ids": torch.from_numpy(toks)})
    leaves = dict(_leaves(tp))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    jg = dict(_leaves(jax.tree.map(np.asarray, jg)))
    assert sorted(leaves) == sorted(jg)
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], atol=FP32_ATOL, rtol=FP32_RTOL,
                                   err_msg=name)
    logits, aux = PT.forward(jax.tree.map(lambda t: t.detach(), tp), torch.from_numpy(toks[:, :-1]),
                             pc)
    assert float(aux) > 0
    _, jaux = JT.forward(jp, jnp.asarray(toks[:, :-1]), jc)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
MOE_MODEL = dict(spec.MODEL, n_experts=4, moe_top_k=2, moe_capacity_factor=1.25)


def _engines(decode_steps=1):
    jc = JT.TransformerConfig(**MOE_MODEL)
    jp = JT.init_params(jc, jax.random.key(0))
    cfg = spec.engine_config(decode_steps=decode_steps)
    return (JaxEngine(jc, jp, JaxEngineConfig.from_dict(cfg)),
            InferenceEngineV2(PT.TransformerConfig(**MOE_MODEL),
                              params_from_numpy(jax.tree.map(np.asarray, jp)),
                              EngineConfig.from_dict(cfg), device="cpu"))


@pytest.fixture
def drops(monkeypatch):
    """Counts the port's gating calls that dropped a token choice."""
    seen = {"calls": 0, "dropping": 0}
    real = pmoe.topkgating

    def spy(logits, k, *a, **kw):
        res = real(logits, k, *a, **kw)
        seen["calls"] += 1
        seen["dropping"] += int(res[2].sum()) < logits.shape[0] * k
        return res

    monkeypatch.setattr(pmoe, "topkgating", spy)
    return seen


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_greedy_moe_streams_match_jax(decode_steps, drops):
    """The split step (decode_steps 1) and decode_round (4): the port's
    greedy streams equal the JAX engine's token for token, with choices
    dropped at capacity factor 1.25."""
    je, pe = _engines(decode_steps)
    ps = spec.prompts()
    for a, b in zip(je.generate(ps, max_new_tokens=16), pe.generate(ps, max_new_tokens=16)):
        np.testing.assert_array_equal(b, a)
    assert drops["dropping"] > 0


def test_greedy_moe_spec_streams_match_jax(drops):
    """spec_round with n-gram, oracle and junk drafts: the port's streams
    equal the JAX engine's (the verify step's capacity counts its own
    rows, so with drops they may leave the plain stream, in both
    packages alike)."""
    je, pe = _engines()
    ps = spec.prompts()
    plain = je.generate(ps, max_new_tokens=16)
    for name, draft in spec.drafters(plain, ps).items():
        jo, jr = spec.spec_generate(je, ps, 16, drafter=draft)
        po, pr = spec.spec_generate(pe, ps, 16, drafter=draft)
        for a, b in zip(jo, po):
            np.testing.assert_array_equal(b, a, err_msg=name)
        assert [r[0] for r in pr] == [r[0] for r in jr]
    assert drops["dropping"] > 0


def test_moe_relu_experts_take_tanh_gelu_as_jax():
    """The JAX package's experts take tanh GELU for every non-gated
    activation but "gelu_exact" (ROADMAP section 3): a relu MoE layer
    computes GELU in its experts there, and the port keeps that function."""
    jc, pc = _moe_config(activation="relu", moe_residual=True)
    jlp, plp = _layer0(jc)
    x = np.random.default_rng(6).standard_normal((1, 16, 64)).astype(np.float32)
    jo, _ = jmoe.moe_mlp(jc, jax.tree.map(jnp.asarray, jlp), jnp.asarray(x))
    po, _ = pmoe.moe_mlp(pc, plp, torch.from_numpy(x))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=FP32_ATOL, rtol=FP32_RTOL)
    gelu_cfg = _moe_config(activation="gelu", moe_residual=True)[1]
    torch.testing.assert_close(po, pmoe.moe_mlp(gelu_cfg, plp, torch.from_numpy(x))[0],
                               atol=0, rtol=0)
