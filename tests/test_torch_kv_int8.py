"""int8 KV pools in the port against the JAX package, on the CPU.

Paged attention over int8 pools: the same codes and scale planes (the JAX
package's ``quantize_kv`` of seeded fp32 K/V), tables and queries go
through the port's plain functions (the kernels' plain versions on CPU
tensors, which the CUDA kernel is held to on the card) and the JAX
package's, its Pallas ``_paged_kernel`` in interpret mode included. Then
both ``InferenceEngineV2``s serve a tiny fp32 model (2 layers, d 64, the
JAX package's own int8 test model) with ``kv_cache_dtype="int8"`` on the
same weights, and the port's int8 engine against itself: bf16 pools, the
per-row step, and a JAX engine's exported blocks.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.config import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops.attention import paged_pallas as jx
from deepspeed_tpu.ops.quantizer.block_quant import quantize_kv as jax_quantize_kv
from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig as EngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.attention import paged as pt


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 everywhere: the same dequantized values (code * scale, one product
# on both sides), then fp32 scores and softmaxes summed in another order
ATOL = RTOL = 1e-5


def _int8_world(seed, T, nh, nkv, d, bs, NB, B, E=0):
    """An int8 pool of NB blocks + the trash block (id NB) with its planes,
    per-token tables of distinct blocks, fp32 queries and E extras."""
    rng = np.random.default_rng(seed)
    w = {"q": rng.normal(size=(T, nh, d)).astype(np.float32), "trash": NB}
    for name in ("k", "v"):
        x = rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32)
        x *= rng.uniform(0.1, 3.0, size=(NB + 1, bs, nkv, 1)).astype(np.float32)
        codes, scales = jax.jit(jax_quantize_kv)(jnp.asarray(x))
        w[name], w[name + "s"] = np.asarray(codes), np.asarray(scales)
    tables = np.full((T, B), NB, np.int32)
    pos = rng.integers(0, B * bs, size=T).astype(np.int32)
    for t in range(T):
        n = pos[t] // bs + 1
        tables[t, :n] = rng.permutation(NB)[:n]
    w["tables"], w["pos"] = tables, pos
    if E:
        w["ke"] = rng.normal(size=(T, E, nkv, d)).astype(np.float32)
        w["ve"] = rng.normal(size=(T, E, nkv, d)).astype(np.float32)
    return w, rng


_ARGS = ("q", "k", "v", "tables", "pos")


def _jax_args(w):
    return [jnp.asarray(w[a]) for a in _ARGS] + [w["trash"]], dict(
        k_scale=jnp.asarray(w["ks"]), v_scale=jnp.asarray(w["vs"]))


def _port_args(w):
    return [torch.from_numpy(w[a].copy()) for a in _ARGS] + [w["trash"]], dict(
        k_scale=torch.from_numpy(w["ks"].copy()), v_scale=torch.from_numpy(w["vs"].copy()))


def _extras(w, epos, lib):
    if lib is jnp:
        return (jnp.asarray(w["ke"]), jnp.asarray(w["ve"]), jnp.asarray(epos))
    return (torch.from_numpy(w["ke"]), torch.from_numpy(w["ve"]), torch.from_numpy(epos))


@pytest.mark.parametrize("nh,nkv,d", [(4, 2, 16), (8, 2, 64), (4, 4, 32)])
def test_reference_matches_jax_reference_and_kernel(nh, nkv, d):
    """The plain per-token reference against JAX's, and the port's kernel
    path (its plain version on the CPU) against the Pallas kernel in
    interpret mode, causal form, with an all-trash row."""
    w, _ = _int8_world(nh + d, T=5, nh=nh, nkv=nkv, d=d, bs=8, NB=12, B=3)
    w["tables"][3] = w["trash"]
    ja, jkw = _jax_args(w)
    pa, pkw = _port_args(w)
    want = jx.paged_attention_reference(*ja, window=6, scale=0.3, **jkw)
    got = pt.paged_attention_reference(*pa, window=6, scale=0.3, **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    want = jx.paged_attention(*ja, impl="kernel", interpret=True, **jkw)
    got = pt.paged_attention(*pa, impl="kernel", **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert not got[3].any(), "an all-trash row must give exactly 0"


@pytest.mark.parametrize("window", [0, 7])
def test_dense_decode_with_extras_and_limit_matches_jax(window):
    """The engine's write-after-read form over an int8 pool: pool below the
    limit, fp32 extras at their positions (some -1), against JAX's dense
    gather and its Pallas kernel in interpret mode."""
    w, rng = _int8_world(20 + window, T=6, nh=4, nkv=2, d=16, bs=8, NB=16, B=3, E=3)
    limit = (w["pos"] - rng.integers(0, 3, size=6)).clip(0).astype(np.int32)
    epos = (limit[:, None] + np.arange(3)[None]).astype(np.int32)
    epos[:, -1] = -1
    w["pos"] = np.maximum(w["pos"], epos.max(axis=1)).astype(np.int32)
    ja, jkw = _jax_args(w)
    pa, pkw = _port_args(w)
    kw = dict(window=window, scale=0.25)
    want = jx.paged_decode_attention_dense(*ja, extra_kv=_extras(w, epos, jnp),
                                           pool_limit=jnp.asarray(limit), **kw, **jkw)
    got = pt.paged_decode_attention_dense(*pa, extra_kv=_extras(w, epos, torch),
                                          pool_limit=torch.from_numpy(limit), **kw, **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    want_k = jx.paged_attention(*ja, impl="kernel", interpret=True,
                                extra_kv=_extras(w, epos, jnp), pool_limit=jnp.asarray(limit),
                                **kw, **jkw)
    got_k = pt.paged_attention(*pa, impl="kernel", extra_kv=_extras(w, epos, torch),
                               pool_limit=torch.from_numpy(limit), **kw, **pkw)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [0, 5])
def test_chunk_attention_matches_jax(window):
    """Prefill chunks over an int8 pool: the pool below the chunk start,
    the chunk's own fp32 K/V causally, a padded tail."""
    rng = np.random.default_rng(30 + window)
    Rc, tq, nh, nkv, d, bs, NB, B = 2, 8, 4, 2, 16, 8, 12, 3
    q = rng.normal(size=(Rc, tq, nh, d)).astype(np.float32)
    pools = {}
    for name in ("k", "v"):
        codes, scales = jax.jit(jax_quantize_kv)(
            jnp.asarray(rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32)))
        pools[name] = (np.asarray(codes), np.asarray(scales))
    ke = rng.normal(size=(Rc, tq, nkv, d)).astype(np.float32)
    ve = rng.normal(size=(Rc, tq, nkv, d)).astype(np.float32)
    tables = np.stack([rng.permutation(NB)[:B] for _ in range(Rc)]).astype(np.int32)
    tables[1, 2] = NB
    start = np.array([5, 9], np.int32)
    pos = (start[:, None] + np.arange(tq)[None]).astype(np.int32)
    pos[1, 6:] = -1
    want = jx.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(pools["k"][0]), jnp.asarray(pools["v"][0]),
        jnp.asarray(tables), jnp.asarray(pos), NB, window=window,
        new_kv=(jnp.asarray(ke), jnp.asarray(ve)), pool_limit=jnp.asarray(start),
        k_scale=jnp.asarray(pools["k"][1]), v_scale=jnp.asarray(pools["v"][1]),
    )
    got = pt.paged_chunk_attention(
        torch.from_numpy(q), torch.from_numpy(pools["k"][0]), torch.from_numpy(pools["v"][0]),
        torch.from_numpy(tables), torch.from_numpy(pos), NB, window=window,
        new_kv=(torch.from_numpy(ke), torch.from_numpy(ve)),
        pool_limit=torch.from_numpy(start), k_scale=torch.from_numpy(pools["k"][1]),
        v_scale=torch.from_numpy(pools["v"][1]),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert not got[1, 6:].any()


@pytest.mark.parametrize("fn", ["paged_attention", "paged_attention_reference",
                                "paged_decode_attention_dense", "paged_chunk_attention",
                                "paged_decode"])
def test_scale_planes_contract(fn):
    """Planes iff the pool is int8, at every entry point (the JAX contract)."""
    w, _ = _int8_world(40, T=2, nh=4, nkv=2, d=16, bs=8, NB=4, B=2)
    pa, pkw = _port_args(w)
    if fn == "paged_chunk_attention":
        pa[0], pa[3], pa[4] = pa[0][None], pa[3][:1], pa[4][None]  # one row of 2 tokens
    call = getattr(pt, fn)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        call(*pa)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        call(*pa, k_scale=pkw["k_scale"])
    fp = [pa[0], pa[1].float(), pa[2].float()] + pa[3:]
    with pytest.raises(ValueError, match="not int8"):
        call(*fp, **pkw)
    assert torch.isfinite(call(*pa, **pkw)).all()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
# the JAX package's int8 test model (tests/unit/test_kv_int8.py): d = 64
MODEL = dict(vocab_size=128, hidden_size=128, n_layers=2, n_heads=2, n_kv_heads=1,
             max_seq_len=256, dtype="float32")
# fp32 logits of a 2-layer model, summed in another order (XLA vs ATen).
# The quantizers agree bit for bit on the same K/V, but K/V that differ in
# their last fp32 bit can land on both sides of a rounding boundary: one
# code then differs by 1 (a change of absmax/127 in one element), which
# moves the logits of the steps that read it by up to ~3e-4 here (one V
# code under the test session's XLA flags); rows are compared at 1e-3
LOGIT_ATOL = LOGIT_RTOL = 1e-3


def _assert_codes_close(port_pool, jax_pool):
    """Pools of two engines: codes off by at most 1, in at most 0.1% of
    the elements (rounding-boundary flips, never a different scheme)."""
    a, b = port_pool.numpy().astype(np.int32), np.asarray(jax_pool).astype(np.int32)
    assert int(np.abs(a - b).max()) <= 1
    assert (a != b).mean() <= 1e-3


def engine_config(kv_dtype="int8", **over):
    cfg = {
        "dtype": "float32", "decode_steps": 1,
        "kv_cache": {"block_size": 16, "num_blocks": 64, "max_blocks_per_seq": 8,
                     "kv_cache_dtype": kv_dtype},
        "state_manager": {"max_tracked_sequences": 16, "max_ragged_batch_size": 256,
                          "max_ragged_sequence_count": 4, "max_context": 256},
    }
    cfg.update(over)
    return cfg


@functools.lru_cache(maxsize=1)
def _jax_params():
    cfg = JT.TransformerConfig(**MODEL)
    return cfg, JT.init_params(cfg, jax.random.key(0))


def jax_engine(**over):
    jcfg, jp = _jax_params()
    return JaxEngine(jcfg, jp, JaxEngineConfig.from_dict(engine_config(**over)))


def port_engine(**over):
    _, jp = _jax_params()
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return InferenceEngineV2(PT.TransformerConfig(**MODEL), pp,
                             EngineConfig.from_dict(engine_config(**over)), device="cpu")


def _prompts(n=3, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    lens = lens or [12] * n
    return [rng.integers(1, MODEL["vocab_size"], size=(m,)).astype(np.int32) for m in lens]


def _prefill(eng, ps):
    for uid, p in enumerate(ps):
        eng.scheduler.submit(uid, p)
    out = {}
    while eng.scheduler.has_pending():
        out.update(eng.step())
    return out


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_int8_greedy_streams_match_jax(decode_steps):
    """Token for token through step()/generate and the fused rounds; the
    pools end holding the same codes."""
    ps = _prompts(seed=1, lens=[12, 30, 7])
    je, pe = jax_engine(decode_steps=decode_steps), port_engine(decode_steps=decode_steps)
    assert pe.kv_cache_dtype == je.kv_cache_dtype == "int8"
    jo = je.generate(ps, max_new_tokens=10)
    po = pe.generate(ps, max_new_tokens=10)
    for a, b in zip(jo, po):
        np.testing.assert_array_equal(b, a)
    _assert_codes_close(pe._k_cache, je._k_cache)
    _assert_codes_close(pe._v_cache, je._v_cache)


def test_int8_prefill_decode_and_round_logits_match_jax():
    ps = _prompts(seed=2, lens=[20, 9])
    je, pe = jax_engine(), port_engine()
    jl, pl = _prefill(je, ps), _prefill(pe, ps)
    for uid in jl:
        np.testing.assert_allclose(pl[uid], jl[uid], atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        tok = int(np.argmax(jl[uid]))
        je.scheduler.feedback(uid, tok)
        pe.scheduler.feedback(uid, tok)
    jd, pd = je.step(), pe.step()
    for uid in jd:
        np.testing.assert_allclose(pd[uid], jd[uid], atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        tok = int(np.argmax(jd[uid]))
        je.scheduler.feedback(uid, tok)
        pe.scheduler.feedback(uid, tok)
    jr, pr = je.decode_round(5), pe.decode_round(5)
    for uid in jr:
        np.testing.assert_array_equal(pr[uid], jr[uid])
        np.testing.assert_allclose(pe.last_logprobs[uid], je.last_logprobs[uid],
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_int8_stream_matches_bf16_on_tiny_model():
    """On this tiny fp32 model the argmax stream survives int8 KV
    quantization unchanged, as in the JAX package's own test."""
    ps = _prompts()
    out_a = port_engine(kv_dtype="bf16").generate(ps, max_new_tokens=6)
    out_b = port_engine().generate(ps, max_new_tokens=6)
    for a, b in zip(out_a, out_b):
        np.testing.assert_array_equal(a, b)


def _per_row(eng, ps, n_new):
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


def test_int8_per_row_streams_match_jax_and_the_batched_step():
    """``_step_per_row`` over the int8 pool (attend before the write, then
    quantize and write) streams the JAX engine's per-row tokens with its
    logits, and the batched int8 step's tokens."""
    ps = _prompts(seed=3, lens=[12, 40, 5])
    jo, jl = _per_row(jax_engine(prompt_chunk=32), ps, 6)
    po, pl = _per_row(port_engine(prompt_chunk=32), ps, 6)
    assert po == jo
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    gen = port_engine(prompt_chunk=32).generate(ps, max_new_tokens=6)
    for uid, p in enumerate(ps):
        np.testing.assert_array_equal(gen[uid][len(p):], po[uid])


def test_int8_per_row_skips_splash_with_a_window(monkeypatch):
    """attention_impl="splash" with a window: the int8 per-row step still
    attends through paged_attention, as the JAX engine's does."""
    from deepspeed_tpu_torch.inference.v2 import engine_v2 as pe_mod

    calls = {"splash": 0, "paged": 0}
    real = pe_mod.paged_attention

    def paged(*a, **k):
        calls["paged"] += 1
        return real(*a, **k)

    monkeypatch.setattr(pe_mod, "paged_attention", paged)
    monkeypatch.setattr(pe_mod, "splash_prefill_attention",
                        lambda *a, **k: calls.__setitem__("splash", calls["splash"] + 1))
    _, jp = _jax_params()
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    eng = InferenceEngineV2(PT.TransformerConfig(**MODEL, attention_impl="splash",
                                                 sliding_window=10), pp,
                            EngineConfig.from_dict(engine_config()), device="cpu")
    _per_row(eng, _prompts(seed=4, lens=[25]), 3)
    assert calls["splash"] == 0 and calls["paged"] == MODEL["n_layers"] * 3


def test_kv_pool_info_matches_jax():
    assert port_engine().kv_pool_info() == jax_engine().kv_pool_info()
    assert port_engine(kv_dtype="bf16").kv_pool_info() == jax_engine(
        kv_dtype="bf16").kv_pool_info()


def test_jax_export_imports_into_the_port():
    """A JAX int8 engine's ``export_kv_blocks`` payload (codes and planes)
    imports into the port's engine bit for bit, and both continue the
    sequence with the same tokens."""
    ps = _prompts(seed=5, lens=[37])
    je = jax_engine()
    jl = _prefill(je, ps)
    seq = je.state_manager.get_sequence(0)
    blocks = list(seq.block_table)
    payload = je.export_kv_blocks(blocks)
    assert sorted(payload) == ["k", "k_scale", "v", "v_scale"]
    assert payload["k"].dtype == np.int8 and payload["k_scale"].dtype == np.float32

    pe = port_engine()
    with pytest.raises(ValueError, match="dtype"):
        pe.import_kv_blocks(blocks, dict(payload, k=payload["k"].astype(np.float32)))
    with pytest.raises(ValueError, match="missing"):
        pe.import_kv_blocks(blocks, {k: v for k, v in payload.items() if k != "v_scale"})
    # the port's sequence: its blocks allocated by a prefill of the same
    # prompt, then overwritten by the imported payload
    pl = _prefill(pe, ps)
    np.testing.assert_allclose(pl[0], jl[0], atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    mine = list(pe.state_manager.get_sequence(0).block_table)
    pe.import_kv_blocks(mine, payload)
    back = pe.export_kv_blocks(mine)
    for name in payload:
        assert back[name].dtype == payload[name].dtype
        assert back[name].tobytes() == payload[name].tobytes()
    tok = int(np.argmax(jl[0]))
    je.scheduler.feedback(0, tok)
    pe.scheduler.feedback(0, tok)
    jr, pr = je.decode_round(6), pe.decode_round(6)
    np.testing.assert_array_equal(pr[0], jr[0])


def test_bf16_pool_export_carries_bits():
    """numpy has no bfloat16: a bf16 pool's planes travel as uint16 bits,
    and import restores them."""
    _, jp = _jax_params()
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    cfg = EngineConfig.from_dict(engine_config(kv_dtype="bf16", dtype="bfloat16"))
    eng = InferenceEngineV2(PT.TransformerConfig(**dict(MODEL, dtype="bfloat16")), pp, cfg,
                            device="cpu")
    _prefill(eng, _prompts(seed=6, lens=[20]))
    blocks = list(eng.state_manager.get_sequence(0).block_table)
    payload = eng.export_kv_blocks(blocks)
    assert sorted(payload) == ["k", "v"] and payload["k"].dtype == np.uint16
    eng.import_kv_blocks([10, 11], payload)
    assert torch.equal(eng._k_cache[:, [10, 11]], eng._k_cache[:, blocks])
    assert payload["k"].any()


def test_bad_kv_cache_dtype_raises():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        port_engine(kv_dtype="fp8")


def test_unported_transports_still_raise():
    """The chunked, device and window transports are ported (they raised
    before): on an int8 pool they move the codes and both scale planes
    verbatim, as ``import_kv_blocks`` does, and a malformed payload still
    raises before any write."""
    pe = port_engine()
    ids, dst = [1, 2, 3], [7, 8, 9]
    for name, pool in pe._kv_pool_planes().items():
        g = torch.Generator().manual_seed(len(name))
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=g, dtype=torch.int8))
        else:
            pool.copy_(torch.rand(pool.shape, generator=g) + 0.5)
    payload = pe.export_kv_blocks(ids)
    assert set(payload) == {"k", "v", "k_scale", "v_scale"}
    pe.import_kv_blocks_chunked(dst, payload, chunk_blocks=2)
    for name, plane in pe.export_kv_blocks(dst).items():
        np.testing.assert_array_equal(plane, payload[name])
    wins, chunk = pe.export_kv_blocks_windows(ids, chunk_blocks=2)
    assert pe.import_kv_blocks_device([10, 11, 12], wins, chunk) == 3
    dev = pe.export_kv_blocks_device([10, 11, 12])
    for name, plane in dev.items():
        np.testing.assert_array_equal(plane.numpy(), payload[name])
    with pytest.raises(ValueError, match="missing"):
        pe.import_kv_blocks_chunked(dst, {"k": payload["k"], "v": payload["v"]},
                                    chunk_blocks=2)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_int8_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    for d in pt.KERNEL_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            w, rng = _int8_world(d, T=6, nh=8, nkv=2, d=d, bs=16, NB=12, B=3, E=3)
            epos = np.stack([w["pos"] - 1, w["pos"], -np.ones(6, np.int32)], 1).astype(np.int32)
            limit = np.maximum(w["pos"] - 1, 0).astype(np.int32)
            cu = {k: torch.as_tensor(np.array(v)).cuda() for k, v in w.items() if k != "trash"}
            for k in ("q", "ke", "ve"):
                cu[k] = cu[k].to(dtype)
            kw = dict(extra_kv=(cu["ke"], cu["ve"], torch.as_tensor(epos).cuda()),
                      pool_limit=torch.as_tensor(limit).cuda(), window=10,
                      k_scale=cu["ks"], v_scale=cu["vs"])
            args = [cu[a] for a in _ARGS] + [w["trash"]]
            before = pt.PAGED_INT8_KERNEL.launches
            got = pt.paged_decode(*args, **kw)
            assert pt.PAGED_INT8_KERNEL.launches == before + 1
            tol = 2e-5 if dtype == torch.float32 else 2 ** -6
            torch.testing.assert_close(got, pt.paged_decode_attention_dense(*args, **kw),
                                       atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_int8_engine_matches_dense_impl():
    """The tiny model's int8 engine on the card: the kernels path (int8
    paged decode, block_quant on every write) streams the tokens of the same
    engine forced to the plain gathers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from deepspeed_tpu_torch.ops import kernels as K

    _, jp = _jax_params()
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    outs = {}
    for impl in ("auto", "dense"):
        eng = InferenceEngineV2(PT.TransformerConfig(**MODEL), pp,
                                EngineConfig.from_dict(engine_config(
                                    paged_attention_impl=impl, decode_steps=4)))
        K.reset_counts()
        outs[impl] = eng.generate(_prompts(), max_new_tokens=8)
        counts = K.counts()
        assert counts["block_quant"] > 0
        assert (counts["paged_decode_int8"] > 0) == (impl == "auto")
    for a, b in zip(outs["auto"], outs["dense"]):
        np.testing.assert_array_equal(a, b)


def test_serve_ab_tool_needs_a_card(monkeypatch):
    """``tools/torch_serve_ab.py``: without a card it refuses (exit 2)
    before it builds an engine or starts a process, also when it is given
    other checkouts to run in turns."""
    import subprocess
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import torch_serve_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail("ran"))
    assert torch_serve_ab.main([]) == 2
    assert torch_serve_ab.main(["../other", "--pairs", "1"]) == 2
