"""The port's serving engine against the JAX package's, on the CPU.

Both ``InferenceEngineV2``s run a tiny fp32 model (2 layers, h 128, 4 query
heads over 2 kv heads) on identical weights: the JAX package's
``init_params`` from a seed, moved into the port with
``params_from_numpy``. Prompts come from a seeded numpy generator.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import sampling as jsampling
from deepspeed_tpu.inference.config import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.inference import sampling as psampling
from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig as EngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL = dict(vocab_size=256, hidden_size=128, n_layers=2, n_heads=4, n_kv_heads=2,
             max_seq_len=256, dtype="float32")
# fp32 logits of a 2-layer model: matmuls and softmaxes summed in another
# order (XLA vs ATen, one-shot vs chunked shapes) differ by ~1e-6 of logits
# of magnitude ~1
LOGIT_ATOL = LOGIT_RTOL = 1e-4


def engine_config(**over):
    cfg = {
        "dtype": "float32", "decode_steps": 1, "prompt_chunk": 32, "max_prompt_chunks": 2,
        "kv_cache": {"block_size": 8, "num_blocks": 64, "max_blocks_per_seq": 12},
        "state_manager": {"max_tracked_sequences": 8, "max_ragged_batch_size": 96,
                          "max_ragged_sequence_count": 4, "max_context": 96},
    }
    cfg.update(over)
    return cfg


@functools.lru_cache(maxsize=4)
def _jax_params(window):
    cfg = JT.TransformerConfig(**MODEL, sliding_window=window)
    return cfg, JT.init_params(cfg, jax.random.key(0))


def engines(window=0, **over):
    """(jax engine, port engine) on the same weights and engine config."""
    jcfg, jp = _jax_params(window)
    pcfg = PT.TransformerConfig(**MODEL, sliding_window=window)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    ec = engine_config(**over)
    return (JaxEngine(jcfg, jp, JaxEngineConfig.from_dict(ec)),
            InferenceEngineV2(pcfg, pp, EngineConfig.from_dict(ec), device="cpu"))


def prompts(seed=0, lens=(5, 40, 17)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL["vocab_size"], size=n).astype(np.int32) for n in lens]


def _prefill(eng, ps):
    for uid, p in enumerate(ps):
        eng.scheduler.submit(uid, p)
    out = {}
    while eng.scheduler.has_pending():
        out.update(eng.step())
    return out


def test_prefill_and_decode_logits_match_jax():
    je, pe = engines()
    ps = prompts()
    jl, pl = _prefill(je, ps), _prefill(pe, ps)
    assert sorted(jl) == sorted(pl) == [0, 1, 2]
    for uid in jl:
        np.testing.assert_allclose(pl[uid], jl[uid], atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    for uid in jl:
        tok = int(np.argmax(jl[uid]))
        je.scheduler.feedback(uid, tok)
        pe.scheduler.feedback(uid, tok)
    jd, pd = je.step(), pe.step()
    assert sorted(jd) == sorted(pd) == [0, 1, 2]
    for uid in jd:
        np.testing.assert_allclose(pd[uid], jd[uid], atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("window", [0, 12])
def test_greedy_streams_match_jax(decode_steps, window):
    """Token for token; window 12 is shorter than every context here past
    the first prompt, so the band masks pool blocks and extras alike."""
    je, pe = engines(window=window, decode_steps=decode_steps)
    ps = prompts(1, lens=(9, 40, 23))
    jo = je.generate(ps, max_new_tokens=10)
    po = pe.generate(ps, max_new_tokens=10)
    for a, b in zip(jo, po):
        np.testing.assert_array_equal(b, a)


def test_in_place_round_matches_jax_round_start_snapshot():
    """The JAX round reads the pool at its round-start state and scatters
    into a donated copy; the port writes the pool in place inside the
    round. The pool limit (the round start) masks every position the round
    writes, so tokens and log-probabilities agree."""
    je, pe = engines(window=12)
    ps = prompts(2, lens=(30, 11))
    jl, pl = _prefill(je, ps), _prefill(pe, ps)
    for uid in jl:
        tok = int(np.argmax(jl[uid]))
        je.scheduler.feedback(uid, tok)
        pe.scheduler.feedback(uid, tok)
    jr, pr = je.decode_round(6), pe.decode_round(6)
    for uid in jr:
        np.testing.assert_array_equal(pr[uid], jr[uid])
        np.testing.assert_allclose(pe.last_logprobs[uid], je.last_logprobs[uid],
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_engine_logits_match_plain_forward():
    """Prefill logits and a fused round's tokens and log-probabilities
    against the port's plain forward on prompt + generated tokens."""
    _, pe = engines(window=12)
    ps = prompts(3, lens=(20, 33))
    pl = _prefill(pe, ps)
    firsts = {}
    for uid, lg in pl.items():
        firsts[uid] = int(np.argmax(lg))
        pe.scheduler.feedback(uid, firsts[uid])
    rounds = pe.decode_round(5)
    for uid, p in enumerate(ps):
        seq = list(p) + [firsts[uid]] + [int(t) for t in rounds[uid]]
        ref = PT.forward_reference(pe.params, torch.as_tensor([seq]), pe._mc)[0][0]
        n = len(p)
        np.testing.assert_allclose(pl[uid], ref[n - 1].numpy(), atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        logp = torch.log_softmax(ref[n : n + 5], dim=-1)
        want_tok = logp.argmax(dim=-1).numpy()
        np.testing.assert_array_equal(rounds[uid], want_tok)
        np.testing.assert_allclose(
            pe.last_logprobs[uid], logp[torch.arange(5), torch.as_tensor(want_tok)].numpy(),
            atol=LOGIT_ATOL, rtol=LOGIT_RTOL,
        )


def test_sampled_streams_invariant_to_decode_steps_and_chunking():
    """Sampled draws depend only on (seed, uid, position): the stream is
    the same under any decode_steps partitioning and prompt chunking."""
    streams = []
    for decode_steps, chunk in ((1, 32), (4, 32), (3, 16)):
        _, pe = engines(decode_steps=decode_steps, prompt_chunk=chunk, greedy=False,
                        temperature=0.8, top_k=40, seed=7)
        streams.append(pe.generate(prompts(4, lens=(12, 37)), max_new_tokens=9))
    for other in streams[1:]:
        for a, b in zip(streams[0], other):
            np.testing.assert_array_equal(b, a)
    _, pe = engines(greedy=False, temperature=0.8, top_k=40, seed=8)
    reseeded = pe.generate(prompts(4, lens=(12, 37)), max_new_tokens=9)
    assert any((a != b).any() for a, b in zip(streams[0], reseeded))


def test_filter_logits_and_greedy_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 64)).astype(np.float32) * 3
    for top_k, top_p in ((0, 0.0), (5, 0.0), (0, 0.7), (9, 0.5)):
        want = np.asarray(jsampling.filter_logits(jnp.asarray(logits), top_k, top_p))
        got = psampling.filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(logits), jax.random.key(0)))
    got = psampling.sample_tokens(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_draws_follow_the_distribution():
    """Gumbel-max over the counter-based bits: empirical token frequencies
    over many (uid, position) keys match softmax(logits / T)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).expand(4000, 4)
    keys = psampling.row_keys(3, torch.arange(4000), torch.arange(4000) % 97)
    toks = psampling.sample_tokens(logits, keys, temperature=1.0, greedy=False)
    freq = torch.bincount(toks.long(), minlength=4).float() / 4000
    # 4000 draws: 3 standard errors of the largest frequency are ~0.02
    torch.testing.assert_close(freq, torch.softmax(logits[0], -1), atol=0.03, rtol=0)


def test_forward_matches_jax_forward():
    jcfg, jp = _jax_params(12)
    pcfg = PT.TransformerConfig(**MODEL, sliding_window=12)
    toks = np.random.default_rng(6).integers(0, 256, size=(2, 30)).astype(np.int32)
    want = np.asarray(JT.forward(jp, jnp.asarray(toks), jcfg)[0])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    got = PT.forward_reference(tp, torch.from_numpy(toks), pcfg)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    # the training forward, "auto", "flash" (the flash Function's plain
    # versions on CPU tensors) and "splash" (the splash Function's plain
    # versions over the window's block schedule), computes the same logits
    for impl in ("auto", "flash", "splash"):
        cfg = PT.TransformerConfig(**MODEL, sliding_window=12, attention_impl=impl, remat=False)
        got = PT.forward(tp, torch.from_numpy(toks), cfg)[0]
        np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


@pytest.mark.parametrize("over,model_over,call,match", [
    ({"tp_size": 2}, {}, None, "queue 1, item 6"),
    # weight-only quantization is served (tests/test_torch_inference_quant.py);
    # with tensor parallelism it stays refused
    ({"tp_size": 2, "quant": {"enabled": True}}, {}, None, "queue 1, item 6"),
    # speculative decoding, the host tier and the tracing spans are ported
    # (tests/test_torch_tracing.py); what stays refused beside them: serving
    # a sparsity layout
    ({"spec_k": 2}, {"attn_sparsity": ("fixed", (("num_local_blocks", 2),))}, None,
     "ROADMAP section 3"),
])
def test_unported_engine_features_raise(over, model_over, call, match):
    _, jp = _jax_params(0)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    cfg = EngineConfig.from_dict(engine_config(**over))
    with pytest.raises(NotImplementedError, match=match):
        eng = InferenceEngineV2(PT.TransformerConfig(**MODEL, **model_over), pp, cfg,
                                device="cpu")
        getattr(eng, call)()


@pytest.mark.parametrize("model_over", [
    {"n_experts": 2}, {"matmul_precision": "fp8"}, {"position": "alibi"},
])
def test_unported_model_features_raise(model_over):
    """ALiBi (the paged kernel takes no bias, as in the JAX engine) still
    raises. MoE and fp8 projections are served: the engine builds on the JAX
    package's weights and its greedy stream equals the JAX engine's
    (tests/test_torch_moe.py holds MoE's step kinds)."""
    cfg = PT.TransformerConfig(**{**MODEL, **model_over})
    if model_over.get("position") == "alibi":
        with pytest.raises(NotImplementedError):
            InferenceEngineV2(cfg, {}, EngineConfig.from_dict(engine_config()), device="cpu")
        return
    jcfg = JT.TransformerConfig(**{**MODEL, **model_over})
    jp = JT.init_params(jcfg, jax.random.key(0))
    eng = InferenceEngineV2(cfg, params_from_numpy(jax.tree.map(np.asarray, jp)),
                            EngineConfig.from_dict(engine_config()), device="cpu")
    prompt = [np.arange(1, 12, dtype=np.int32)]
    want = JaxEngine(jcfg, jp, JaxEngineConfig.from_dict(engine_config())).generate(
        prompt, max_new_tokens=4)
    np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=4)[0], want[0])


def test_engine_rejects_an_unknown_attention_impl():
    _, jp = _jax_params(0)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    cfg = EngineConfig.from_dict(engine_config(paged_attention_impl="pallas"))
    with pytest.raises(ValueError, match="paged_attention_impl"):
        InferenceEngineV2(PT.TransformerConfig(**MODEL), pp, cfg, device="cpu")
    eng = InferenceEngineV2(PT.TransformerConfig(**MODEL), pp,
                            EngineConfig.from_dict(engine_config()), device="cpu")
    assert eng.paged_attention_impl == "dense"
    # the window transport is ported: one window of host_tier_chunk_blocks
    # columns, the tail padded with the trash block
    wins, chunk = eng.export_kv_blocks_windows([0])
    assert chunk == 8 and len(wins) == 1 and wins[0]["k"].shape[1] == 8


@pytest.mark.parametrize("scaling,seq_len", [
    ({"rope_type": "linear", "factor": 4.0}, None),
    ({"rope_type": "dynamic", "factor": 2.0}, 300),
    ({"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64}, None),
    ({"rope_type": "longrope", "short_factor": [1.0 + i / 16 for i in range(16)],
      "long_factor": [2.0 + i / 8 for i in range(16)]}, 1000),
    ({"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
      "original_max_position_embeddings": 64}, None),
])
def test_rope_params_match_jax(scaling, seq_len):
    """Every scaling kind's frequencies and attention factor (fp32 numpy on
    both sides: equal up to the last bit of the power and exp functions)."""
    kw = dict(MODEL, rope_scaling=JT.rope_scaling_from_hf(scaling, 128))
    want_f, want_a = JT.rope_params(JT.TransformerConfig(**kw), 32, seq_len)
    got_f, got_a = PT.rope_params(PT.TransformerConfig(**kw), 32, seq_len)
    np.testing.assert_allclose(got_f, np.asarray(want_f), rtol=1e-6, atol=0)
    assert got_a == pytest.approx(float(want_a), rel=1e-7)


def test_rope_frequencies_are_built_once_per_device(monkeypatch):
    """``_rope`` keeps its inverse frequencies on the device per (config,
    rot, seq_len, device): two calls build them once and give the bits of
    the per-call copy they replace."""
    cfg = PT.TransformerConfig(**MODEL)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 4, 7, 32)).astype(np.float32))
    pos = torch.arange(5, 12)
    built = []
    real = PT.rope_params

    def counting(*a, **k):
        built.append(a[1:])
        return real(*a, **k)

    monkeypatch.setattr(PT, "rope_params", counting)
    PT._rope_freqs_cached.cache_clear()
    first, second = PT._rope(x, pos, cfg), PT._rope(x, pos, cfg)
    assert torch.equal(first, second) and len(built) == 1
    inv_freq, attn = real(cfg, 32, None)
    angles = pos[None, :, None].float() * torch.as_tensor(inv_freq)
    cos, sin = torch.cos(angles)[:, None] * attn, torch.sin(angles)[:, None] * attn
    x1, x2 = torch.chunk(x, 2, dim=-1)
    assert torch.equal(first, torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1))
    # a scaling that depends on the live length keys the cache by it
    dyn = PT.TransformerConfig(**MODEL, rope_scaling=(("rope_type", "dynamic"), ("factor", 2.0)))
    PT._rope(x, pos, dyn, 300), PT._rope(x, pos, dyn, 300), PT._rope(x, pos, dyn, 400)
    assert len(built) == 3


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefix_cache_hits_and_streams_match_jax(kv_dtype):
    """Automatic prefix caching: a second prompt that shares a 32-token
    prefix (4 blocks of 8) with the first hits those 4 blocks in both
    engines, and the greedy streams agree token for token."""
    kv = dict(engine_config()["kv_cache"], prefix_cache=True, kv_cache_dtype=kv_dtype)
    je, pe = engines(kv_cache=kv)
    rng = np.random.default_rng(17)
    prefix = rng.integers(0, MODEL["vocab_size"], size=32).astype(np.int32)
    ps = [np.concatenate([prefix, rng.integers(0, MODEL["vocab_size"], size=n)]).astype(np.int32)
          for n in (5, 9)]
    for p in ps:
        np.testing.assert_array_equal(pe.generate([p], max_new_tokens=6)[0],
                                      je.generate([p], max_new_tokens=6)[0])
    jc, pc = je.prefix_cache, pe.state_manager.prefix_cache
    assert jc.hits == pc.hits == 1
    assert jc.hit_blocks == pc.hit_blocks == 4


# ---------------------------------------------------------------------------
# the per-row step, with and without splash
# ---------------------------------------------------------------------------
def _per_row(eng, ps, n_new):
    """Greedy streams through ``_step_per_row`` alone, and every row's
    logits in order."""
    for uid, p in enumerate(ps):
        eng.scheduler.submit(uid, p)
    out = {uid: [] for uid in range(len(ps))}
    logits = []
    while eng.scheduler.has_work():
        for uid, lg in eng._step_per_row().items():
            logits.append(np.asarray(lg))
            out[uid].append(int(np.argmax(lg)))
            if len(out[uid]) >= n_new:
                eng.scheduler.finish(uid)
            else:
                eng.scheduler.feedback(uid, out[uid][-1])
    return out, logits


def _splash_engines(window, impl, **over):
    """(jax engine, port engine) with ``attention_impl=impl``."""
    jcfg, jp = _jax_params(window)
    jcfg = JT.TransformerConfig(**MODEL, sliding_window=window, attention_impl=impl)
    pcfg = PT.TransformerConfig(**MODEL, sliding_window=window, attention_impl=impl)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    ec = engine_config(**over)
    return (JaxEngine(jcfg, jp, JaxEngineConfig.from_dict(ec)),
            InferenceEngineV2(pcfg, pp, EngineConfig.from_dict(ec), device="cpu"))


@pytest.mark.parametrize("window,impl", [(12, "splash"), (12, "auto"), (0, "splash")])
def test_per_row_streams_match_jax(window, impl, monkeypatch):
    """``_step_per_row`` greedy streams token for token against the JAX
    engine's, with every row's logits. A spy on each package's
    ``splash_prefill_attention`` shows which rows took it: with splash and a
    window every row step does (the JAX side traces it once per chunk
    bucket), otherwise none (the dense masked attention)."""
    import importlib

    from deepspeed_tpu_torch.inference.v2 import engine_v2 as pe_mod

    # the package (deepspeed_tpu.ops exports a function under its name)
    jsa = importlib.import_module("deepspeed_tpu.ops.sparse_attention")

    counts = {"jax": 0, "port": 0}

    def spy(side, real):
        def call(*a, **k):
            counts[side] += 1
            return real(*a, **k)
        return call

    monkeypatch.setattr(jsa, "splash_prefill_attention",
                        spy("jax", jsa.splash_prefill_attention))
    monkeypatch.setattr(pe_mod, "splash_prefill_attention",
                        spy("port", pe_mod.splash_prefill_attention))
    je, pe = _splash_engines(window, impl)
    ps = prompts(5, lens=(9, 40, 23))
    jo, jl = _per_row(je, ps, 8)
    po, pl = _per_row(pe, ps, 8)
    assert po == jo
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    taken = impl == "splash" and window > 0
    # 3 prompts in chunks of at most 32 (2, 1, 1 chunks) + 7 decode tokens
    # each, one row step apiece, every layer
    assert counts["port"] == (MODEL["n_layers"] * (4 + 3 * 7) if taken else 0)
    assert (counts["jax"] > 0) == taken


def test_per_row_logits_match_plain_forward_and_the_batched_step():
    """The splash per-row path's prefill logits against the port's plain
    forward, and its greedy stream against ``generate`` (the batched step
    and fused rounds, which no attention_impl changes)."""
    _, pe = _splash_engines(12, "splash")
    ps = prompts(6, lens=(30, 17))
    po, pl = _per_row(pe, ps, 6)
    for uid, p in enumerate(ps):
        seq = list(p) + po[uid][:-1]
        ref = PT.forward_reference(pe.params, torch.as_tensor([seq]), pe._mc)[0][0]
        np.testing.assert_allclose(pl[uid], ref[len(p) - 1].numpy(), atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL)
    _, batched = _splash_engines(12, "splash")
    gen = batched.generate(ps, max_new_tokens=6)
    for uid, p in enumerate(ps):
        np.testing.assert_array_equal(gen[uid][len(p):], po[uid])


def test_per_row_refuses_layer_patterns_and_serving_a_sparsity_layout():
    _, jp = _jax_params(0)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    cfg = EngineConfig.from_dict(engine_config())
    eng = InferenceEngineV2(PT.TransformerConfig(**MODEL, sliding_window=8,
                                                 attn_layer_pattern=(1, 0)), pp, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="layer patterns"):
        eng._step_per_row()
    with pytest.raises(NotImplementedError, match="dense causal mask.*ROADMAP section 3"):
        InferenceEngineV2(PT.TransformerConfig(**MODEL, attn_sparsity=("bigbird",)), pp, cfg,
                          device="cpu")
