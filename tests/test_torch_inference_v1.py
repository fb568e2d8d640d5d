"""The port's v1 ``InferenceEngine`` and its cached decode against the JAX
package's, on the CPU.

A tiny fp32 model (2 layers, h 128, 4 query heads over 2 kv heads, vocab
256) on identical weights: the JAX package's ``init_params`` from a seed,
moved into the port with ``params_from_numpy``; prompts from a seeded
numpy generator.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.attention import core as pcore


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and tiny models gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL = dict(vocab_size=256, hidden_size=128, n_layers=2, n_heads=4, n_kv_heads=2,
             max_seq_len=256, dtype="float32")
# fp32 logits of a 2-layer model summed in another order (XLA against ATen)
LOGIT_ATOL = LOGIT_RTOL = 1e-4


@functools.lru_cache(maxsize=4)
def _models(window=0, pattern=None):
    over = dict(MODEL, sliding_window=window, attn_layer_pattern=pattern)
    jcfg = JT.TransformerConfig(**over)
    jp = JT.init_params(jcfg, jax.random.key(1))
    return jcfg, jp, PT.TransformerConfig(**over), params_from_numpy(jax.tree.map(np.asarray, jp))


def engines(window=0, **over):
    jcfg, jp, pcfg, pp = _models(window)
    cfg = dict({"dtype": "float32", "max_tokens": 128}, **over)
    return (JaxInferenceEngine((jcfg, jp), JaxInferenceConfig.from_dict(cfg)),
            InferenceEngine((pcfg, pp), DeepSpeedInferenceConfig.from_dict(cfg), device="cpu"))


def batch(seed=0, b=3, s=11):
    return np.random.default_rng(seed).integers(0, MODEL["vocab_size"], size=(b, s)).astype(
        np.int32)


@pytest.mark.parametrize("window,pattern", [(0, None), (6, None), (6, (1, 0))])
def test_decode_step_logits_match_jax_over_two_steps(window, pattern):
    """A prompt of 11 tokens, then two one-token steps on one cache of 32
    slots: each step's logits equal JAX's, and the caches' fill lengths
    advance alike."""
    jcfg, jp, pcfg, pp = _models(window, pattern)
    toks = batch(1, b=2)
    jc, pc = JT.init_kv_cache(jcfg, 2, 32), PT.init_kv_cache(pcfg, 2, 32, device="cpu")
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    steps = [(toks, pos)]
    rng = np.random.default_rng(2)
    for i in range(2):
        steps.append((rng.integers(0, 256, size=(2, 1)).astype(np.int32),
                      np.full((2, 1), 11 + i, np.int32)))
    for t, p in steps:
        jl, jc = JT.decode_step(jp, jnp.asarray(t), jcfg, jc, jnp.asarray(p))
        pl, pc = PT.decode_step(pp, torch.from_numpy(t), pcfg, pc, torch.from_numpy(p))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        np.testing.assert_array_equal(pc[2].numpy(), np.asarray(jc[2]))
    np.testing.assert_allclose(pc[0].numpy(), np.asarray(jc[0]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("window", [0, 6])
def test_generate_greedy_matches_jax(decode_steps, window):
    je, pe = engines(window, decode_steps=decode_steps)
    toks = batch(3)
    want = je.generate(toks, max_new_tokens=10)
    got = pe.generate(toks, max_new_tokens=10)
    assert got.shape == (3, 21)
    np.testing.assert_array_equal(got, want)


def test_generate_eos_masking_matches_jax():
    """After a row's EOS its columns are EOS; generation stops once every
    row has one (the EOS is the first token row 0 generates)."""
    je, pe = engines()
    toks = batch(4)
    eos = int(pe.generate(toks, max_new_tokens=2)[0, 11])
    want = je.generate(toks, max_new_tokens=12, eos_token_id=eos)
    got = pe.generate(toks, max_new_tokens=12, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 11:] == eos).all()


def test_fused_rounds_give_the_per_step_stream():
    """decode_steps 4 (with an overshooting last round) gives the per-step
    loop's tokens, greedy and sampled: the draw after step i is keyed by
    (seed, i, row) in both."""
    toks = batch(5)
    for greedy in (True, False):
        outs = []
        for ds in (1, 4):
            _, pe = engines(decode_steps=ds, greedy=greedy, temperature=0.9)
            outs.append(pe.generate(toks, max_new_tokens=11, seed=3))
        np.testing.assert_array_equal(outs[1], outs[0])
    _, pe = engines(greedy=False)
    assert (pe.generate(toks, max_new_tokens=11, seed=4) != outs[0]).any()


def test_generate_logits_match_the_plain_forward():
    """Every greedy token is the argmax of the plain forward over prompt +
    generated tokens."""
    _, pe = engines(6)
    out = pe.generate(batch(6), max_new_tokens=8)
    ref = PT.forward_reference(pe.params, torch.from_numpy(out.astype(np.int64)), pe._mc)[0]
    np.testing.assert_array_equal(out[:, 11:], ref[:, 10:-1].argmax(dim=-1).numpy())


def test_max_tokens_guard_and_forward():
    je, pe = engines(max_tokens=20)
    with pytest.raises(ValueError, match="max_tokens"):
        pe.generate(batch(7), max_new_tokens=10)
    toks = batch(8)
    np.testing.assert_allclose(pe(toks).numpy(), np.asarray(je.forward(toks)),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_init_inference_returns_the_v1_engine():
    _, _, pcfg, pp = _models()
    eng = deepspeed_tpu_torch.init_inference((pcfg, pp), {"dtype": "float32", "decode_steps": 2},
                                             device="cpu")
    assert isinstance(eng, InferenceEngine) and eng._decode_steps == 2
    eng = deepspeed_tpu_torch.init_inference((pcfg, pp), device="cpu", dtype="float32",
                                             max_tokens=64)
    assert eng._config.max_tokens == 64 and eng.module is pcfg
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        deepspeed_tpu_torch.init_inference((pcfg, pp), {"tensor_parallel": 2}, device="cpu")
    # weight-only quantization is served (tests/test_torch_inference_quant.py);
    # with tensor parallelism it is refused, as in the JAX package
    eng = deepspeed_tpu_torch.init_inference(
        (pcfg, pp), {"dtype": "float32", "quant": {"enabled": True, "group_size": 32}},
        device="cpu")
    assert eng.params["layers"]["wq"].bits == 8
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        deepspeed_tpu_torch.init_inference(
            (pcfg, pp), {"tensor_parallel": 2, "quant": {"enabled": True}}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            deepspeed_tpu_torch.init_inference((pcfg, pp))


def test_auto_attention_with_a_bias_on_the_cpu_is_the_reference():
    """On the CPU "auto" with a dense bias runs mha_reference; the flash
    path refuses a bias."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, 4, 3, 32), (1, 2, 16, 32), (1, 2, 16, 32)))
    bias = torch.from_numpy(rng.normal(size=(1, 1, 3, 16)).astype(np.float32))
    want = pcore.mha_reference(q, k, v, causal=False, bias=bias)
    for impl in (None, "auto"):
        torch.testing.assert_close(pcore.attention(q, k, v, causal=False, bias=bias, impl=impl),
                                   want)
    with pytest.raises(NotImplementedError, match="bias"):
        pcore.attention(q, k, v, causal=False, bias=bias, impl="flash")


@pytest.mark.cuda
def test_cuda_attention_with_a_bias_raises_and_decode_takes_the_reference():
    """On a card a biased ``attention`` call raises on "auto" and on
    "flash" (nothing there runs the plain version unless asked for); the v1
    cached decode calls mha_reference itself and launches no attention
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 32, 1, 128, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(2, 8, 256, 128, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(2, 8, 256, 128, generator=g, device=dev).to(torch.bfloat16)
    bias = torch.where(torch.arange(256, device=dev) < 200, 0.0, -1e30)[None, None, None]
    for impl in (None, "auto", "flash"):
        with pytest.raises(NotImplementedError, match="bias"):
            pcore.attention(q, k, v, causal=False, bias=bias, impl=impl)
    cfg = PT.TransformerConfig(vocab_size=64, hidden_size=128, n_layers=1, n_heads=4,
                               n_kv_heads=2, max_seq_len=64, dtype="bfloat16")
    params = PT.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    caches = PT.init_kv_cache(cfg, 2, 64, device=dev)
    toks = torch.randint(0, 64, (2, 8), device=dev)
    K.reset_counts()
    logits, _ = PT.decode_step(params, toks, cfg, caches,
                               torch.arange(8, device=dev)[None].expand(2, 8))
    assert torch.isfinite(logits.float()).all()
    assert {n for n, c in K.counts().items() if c} == {"rms_norm_fwd"}


@pytest.mark.cuda
def test_cuda_generate_launches_rms_norm_and_no_attention_kernel():
    """init_inference on a card: the greedy stream of decode_steps 4 equals
    decode_steps 1's, RMSNorm launches 2L + 1 a step and no attention
    kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from deepspeed_tpu_torch.ops import kernels as K

    cfg = PT.TransformerConfig(**dict(MODEL, dtype="bfloat16", hidden_size=256, n_heads=2,
                                      n_kv_heads=1))
    params = PT.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    toks = batch(10)
    outs = []
    for ds in (1, 4):
        eng = deepspeed_tpu_torch.init_inference((cfg, params), {"dtype": "bfloat16",
                                                                 "decode_steps": ds,
                                                                 "max_tokens": 64})
        K.reset_counts()
        outs.append(eng.generate(toks, max_new_tokens=9))
        n = K.counts()
        steps = 1 + 8  # the prefill and 8 decode steps (two whole rounds of 4)
        assert n["rms_norm_fwd"] == (2 * cfg.n_layers + 1) * steps
        assert sum(v for k, v in n.items() if k != "rms_norm_fwd") == 0
    np.testing.assert_array_equal(outs[1], outs[0])
