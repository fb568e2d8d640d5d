"""Weight-only quantized inference in the port against the JAX package,
on the CPU.

Mirrors ``tests/unit/test_inference_quant.py``. The port's seeded wide
params cross into the JAX package as numpy; both packages'
``quantize_inference_params`` then give the same int8 / packed int4
payloads, fp32 scales and ``model_memory_bytes`` bit for bit, and
``dequantize_leaf`` the same wide values. The model's forward on the
quantized params matches JAX's quantized forward in fp32, and the greedy
streams of both quantized engines (v1 and v2) equal the JAX engines'
token for token. JAX's ``QuantizedWeight`` also crosses as it is. The
JAX package quantizes stacked biases (``wq_b``, ``w_up_b``, ...) that its
docstring says stay wide; the port follows it, and a test pins that.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.config import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngineV2
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.inference import quantization as pq
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.utils.tree import leaves


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# with biases: the JAX package quantizes them too (the pinned fault below)
MODEL = dict(vocab_size=128, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
             max_seq_len=64, dtype="float32", attn_qkv_bias=True, mlp_bias=True)
# fp32 logits of the same dequantized weights, summed in another order
LOGIT_ATOL = LOGIT_RTOL = 1e-4


@functools.lru_cache(maxsize=1)
def _models():
    """One model for the file (the JAX package's eager ops compile per
    shape), drawn by the port and carried into JAX as numpy; nothing
    mutates its params."""
    pc = PT.TransformerConfig(**MODEL)
    tp = PT.init_params(pc, torch.Generator().manual_seed(0), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    return JT.TransformerConfig(**MODEL), jp, pc, tp


# JAX's widening, compiled: the JAX model widens inside its compiled step,
# and one compile a weight shape replaces the eager ops' one a shape each
_jax_widen = jax.jit(functools.partial(jq.dequantize_leaf, dtype=jnp.float32))


def _flat_jax(tree):
    """path -> leaf of a JAX tree with QuantizedWeight leaves kept whole."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jq.is_quantized_leaf)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("bits", [8, 4])
def test_payloads_scales_and_bytes_equal_jax(bits):
    _, jp, _, tp = _models()
    jqp = _flat_jax(jq.quantize_inference_params(jp, bits=bits, group_size=32))
    tqp = dict(leaves(pq.quantize_inference_params(tp, bits=bits, group_size=32)))
    assert sorted(jqp) == sorted(tqp)
    n_quant = 0
    for name, j in jqp.items():
        t = tqp[name]
        if jq.is_quantized_leaf(j):
            n_quant += 1
            assert pq.is_quantized_leaf(t) and (t.bits, t.group) == (j.bits, j.group)
            assert t.q.dtype == torch.int8 and tuple(t.shape) == tuple(j.shape)
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q), err_msg=name)
            np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s), err_msg=name)
            assert t.nbytes == j.nbytes
            np.testing.assert_array_equal(
                pq.dequantize_leaf(t, torch.float32).numpy(),
                np.asarray(_jax_widen(j)), err_msg=name)
        else:
            assert not pq.is_quantized_leaf(t)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert n_quant == 14  # wq wk wv wo w_up w_gate w_down, their six biases, lm_head
    assert pq.model_memory_bytes(pq.quantize_inference_params(tp, bits=bits, group_size=32)) \
        == jq.model_memory_bytes(jq.quantize_inference_params(jp, bits=bits, group_size=32))
    assert pq.model_memory_bytes(tp) == jq.model_memory_bytes(jp)


def test_int4_payload_bits_equal_jax_at_every_nibble_pair():
    """Every (lo, hi) code pair in -7..7: the port's packed byte (uint8
    built, viewed as int8) equals JAX's (uint8 built, cast to int8 with
    wraparound), and both unpack through uint8 to the same codes."""
    lo, hi = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8))
    w = np.stack([lo.ravel(), hi.ravel()], -1).reshape(1, -1).astype(np.float32) / 7.0
    w = np.concatenate([w, w[:, :2] * 0 + 1.0], axis=1)[:, : 2 * 225]  # absmax 1 a block
    j = jq.quantize_inference_params({"w": jnp.asarray(w)}, bits=4, group_size=2 * 225)["w"]
    t = pq.quantize_inference_params({"w": torch.from_numpy(w)}, bits=4, group_size=2 * 225)["w"]
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    assert (t.q.numpy() < 0).any()  # bytes above 127 wrap to negative int8
    np.testing.assert_array_equal(pq.dequantize_leaf(t, torch.float32).numpy(),
                                  np.asarray(_jax_widen(j)))


def test_bias_fault_quantizes_stacked_biases_as_jax_does():
    """Pinned JAX fault: the exclusion list matches "bias" in a leaf's last
    path segment, and the model names its biases ``wq_b``, ``w_up_b``;
    stacked [L, n] they have two dims, so they are quantized, against
    ``quantize_inference_params``' docstring. The port quantizes them
    exactly as JAX does."""
    _, jp, _, tp = _models()
    jqp = jq.quantize_inference_params(jp, bits=8, group_size=32)
    tqp = pq.quantize_inference_params(tp, bits=8, group_size=32)
    for name in ("wq_b", "wk_b", "wv_b", "w_up_b", "w_gate_b", "w_down_b"):
        j, t = jqp["layers"][name], tqp["layers"][name]
        assert jq.is_quantized_leaf(j) and pq.is_quantized_leaf(t), name
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q), err_msg=name)
        np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s), err_msg=name)


def test_norms_and_embed_stay_wide_and_int4_is_smaller():
    _, _, _, tp = _models()
    q8 = pq.quantize_inference_params(tp, bits=8, group_size=32)
    assert not pq.is_quantized_leaf(q8["embed"])
    assert not pq.is_quantized_leaf(q8["layers"]["attn_norm"])
    assert pq.is_quantized_leaf(q8["layers"]["wq"]) and q8["layers"]["wq"][1].shape == (64, 64)
    wide = pq.model_memory_bytes(tp)
    q4 = pq.model_memory_bytes(pq.quantize_inference_params(tp, bits=4, group_size=32))
    assert pq.model_memory_bytes(q8) < wide * 0.55 and q4 < pq.model_memory_bytes(q8)
    with pytest.raises(ValueError, match="bits"):
        pq.quantize_inference_params(tp, bits=2)


@pytest.mark.parametrize("bits", [8, 4])
def test_forward_on_quantized_params_matches_jax(bits):
    jc, jp, pc, tp = _models()
    toks = np.random.default_rng(0).integers(0, 128, size=(2, 16)).astype(np.int32)
    jl, _ = jax.jit(lambda p, t: JT.forward(p, t, jc))(
        jq.quantize_inference_params(jp, bits=bits, group_size=32), jnp.asarray(toks))
    tqp = pq.quantize_inference_params(tp, bits=bits, group_size=32)
    with torch.no_grad():
        pl, _ = PT.forward(tqp, torch.from_numpy(toks).long(), pc)
        rl, _ = PT.forward_reference(tqp, torch.from_numpy(toks).long(), pc)
        wide, _ = PT.forward(tp, torch.from_numpy(toks).long(), pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    np.testing.assert_allclose(rl.numpy(), pl.numpy(), atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    # the JAX suite's bound on the distance from the wide model (int8)
    if bits == 8:
        assert float((pl - wide).abs().max()) < 0.1
        assert np.corrcoef(pl.numpy().ravel(), wide.numpy().ravel())[0, 1] > 0.999
    assert not torch.equal(pl, wide)


def test_jax_quantized_weights_cross_as_they_are():
    _, jp, _, _ = _models()
    jqp = jq.quantize_inference_params(jp, bits=4, group_size=32)
    moved = params_from_numpy(jax.tree.map(np.asarray, jqp))
    t = moved["layers"]["w_up"]
    assert pq.is_quantized_leaf(t) and (t.bits, t.group) == (4, 32)
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(jqp["layers"]["w_up"].q))
    np.testing.assert_array_equal(t.s.numpy(), np.asarray(jqp["layers"]["w_up"].s))
    assert moved["embed"].dtype == torch.float32


def _prompts(seed=1, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=int(k)).astype(np.int32) for k in rng.integers(5, 20, n)]


@pytest.mark.parametrize("bits", [8, 4])
def test_v2_engine_greedy_streams_equal_jax(bits):
    jc, jp, pc, tp = _models()
    cfg = {"dtype": "float32", "quant": {"enabled": True, "bits": bits, "group_size": 32},
           "kv_cache": {"block_size": 16, "num_blocks": 32, "max_blocks_per_seq": 4}}
    je = JaxEngineV2(jc, jp, JaxEngineConfig.from_dict(cfg))
    pe = InferenceEngineV2(pc, tp, RaggedInferenceEngineConfig.from_dict(cfg), device="cpu")
    assert pq.is_quantized_leaf(pe.params["layers"]["wq"])
    assert pq.is_quantized_leaf(pe.params["lm_head"])
    prompts = _prompts()
    want = je.generate(prompts, max_new_tokens=8)
    got = pe.generate(prompts, max_new_tokens=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the fused round and a spec round on the quantized weights
    pe2 = InferenceEngineV2(pc, tp, RaggedInferenceEngineConfig.from_dict(
        dict(cfg, decode_steps=4)), device="cpu")
    got = pe2.generate(prompts, max_new_tokens=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_v2_engine_int8_pool_and_quantized_weights():
    """Weight-only int8 beside an int8 KV pool: the pools move K/V, not
    weights; the stream equals the JAX engine's with both."""
    jc, jp, pc, tp = _models()
    cfg = {"dtype": "float32", "quant": {"enabled": True, "bits": 8, "group_size": 32},
           "kv_cache": {"block_size": 16, "num_blocks": 32, "max_blocks_per_seq": 4,
                        "kv_cache_dtype": "int8"}}
    je = JaxEngineV2(jc, jp, JaxEngineConfig.from_dict(cfg))
    pe = InferenceEngineV2(pc, tp, RaggedInferenceEngineConfig.from_dict(cfg), device="cpu")
    prompts = _prompts(2, 2)
    for g, w in zip(pe.generate(prompts, max_new_tokens=6), je.generate(prompts, max_new_tokens=6)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("bits", [8, 4])
def test_v1_engine_greedy_stream_equals_jax(bits):
    jc, jp, pc, tp = _models()
    cfg = {"dtype": "float32", "max_tokens": 64,
           "quant": {"enabled": True, "bits": bits, "group_size": 32}}
    je = JaxInferenceEngine((jc, jp), JaxInferenceConfig.from_dict(cfg))
    pe = InferenceEngine((pc, tp), DeepSpeedInferenceConfig.from_dict(cfg), device="cpu")
    assert pq.is_quantized_leaf(pe.params["layers"]["w_down"])
    toks = np.random.default_rng(3).integers(0, 128, size=(2, 9)).astype(np.int32)
    np.testing.assert_array_equal(pe.generate(toks, max_new_tokens=8),
                                  je.generate(toks, max_new_tokens=8))


def test_v1_refuses_quant_with_tensor_parallelism():
    _, _, pc, tp = _models()
    cfg = DeepSpeedInferenceConfig.from_dict(
        {"dtype": "float32", "quant": {"enabled": True}, "tensor_parallel": {"tp_size": 2}})
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        InferenceEngine((pc, tp), cfg, device="cpu")


def test_build_hf_engine_passes_quant_through(monkeypatch):
    from deepspeed_tpu_torch.inference.v2 import engine_factory

    _, _, pc, tp = _models()
    monkeypatch.setattr(engine_factory, "load_model_implementation",
                        lambda path, dtype="bfloat16", device="cuda": (pc, tp))
    cfg = RaggedInferenceEngineConfig.from_dict(
        {"dtype": "float32", "quant": {"enabled": True, "bits": 4, "group_size": 32},
         "kv_cache": {"block_size": 16, "num_blocks": 16, "max_blocks_per_seq": 4}})
    eng = engine_factory.build_hf_engine("unused", cfg, device="cpu")
    assert eng.params["layers"]["wo"].bits == 4
    v1 = engine_factory.build_engine_v1("unused", DeepSpeedInferenceConfig.from_dict(
        {"dtype": "float32", "quant": {"enabled": True, "group_size": 32}}), device="cpu")
    assert v1.params["layers"]["wo"].bits == 8
