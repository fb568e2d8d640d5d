"""The port's speculative decoding against the JAX package's, on the CPU.

Both ``InferenceEngineV2``s run the tiny fp32 model of
``tests/test_torch_engine.py`` (2 layers, h 128, 4 query heads over 2 kv
heads, vocab 256) on identical weights: the JAX package's ``init_params``
from a seed, moved into the port with ``params_from_numpy``. Decode runs
through ``spec_round`` alone, with drafts the test makes: an n-gram
drafter over the sequence's own history, the plain-decode stream itself
(every draft accepted) and junk (every draft rejected).
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
from deepspeed_tpu.ops.attention import paged_pallas as jpaged
from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig as EngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.attention import paged as ppaged
from deepspeed_tpu_torch.ops.quantizer.block_quant import quantize_kv


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
# fp32 logits of a 2-layer model, summed in another order (XLA against ATen,
# the chunk form against the verify form): ~1e-6 apart (tests/test_torch_engine.py)
LOGIT_ATOL = LOGIT_RTOL = 1e-4
K = 4


def engine_config(**over):
    cfg = {
        "dtype": "float32", "decode_steps": 1, "prompt_chunk": 32, "max_prompt_chunks": 2,
        "greedy": True, "temperature": 0.9, "seed": 7,
        "kv_cache": {"block_size": 8, "num_blocks": 64, "max_blocks_per_seq": 12},
        "state_manager": {"max_tracked_sequences": 8, "max_ragged_batch_size": 96,
                          "max_ragged_sequence_count": 4, "max_context": 96},
    }
    cfg.update(over)
    return cfg


@functools.lru_cache(maxsize=2)
def _jax_params(window):
    cfg = JT.TransformerConfig(**MODEL, sliding_window=window)
    return cfg, JT.init_params(cfg, jax.random.key(0))


def port_engine(window=0, **over):
    _, jp = _jax_params(window)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return InferenceEngineV2(PT.TransformerConfig(**MODEL, sliding_window=window), pp,
                             EngineConfig.from_dict(engine_config(**over)), device="cpu")


def jax_engine(window=0, **over):
    jcfg, jp = _jax_params(window)
    return JaxEngine(jcfg, jp, JaxEngineConfig.from_dict(engine_config(**over)))


def prompts():
    rng = np.random.default_rng(3)
    motif = rng.integers(1, 256, size=6).astype(np.int32)
    return [np.tile(motif, 5),  # repetitive: the n-gram drafter scores here
            rng.integers(1, 256, size=17).astype(np.int32),
            np.concatenate([rng.integers(1, 256, size=8), motif, motif]).astype(np.int32)]


def ngram_draft(history, k, max_n=3):
    """The longest (up to ``max_n``) suffix of ``history`` seen earlier:
    the k tokens that followed its most recent occurrence."""
    h = [int(t) for t in history]
    for n in range(min(max_n, len(h) - 1), 0, -1):
        tail = h[-n:]
        for s in range(len(h) - n - 1, -1, -1):
            if h[s : s + n] == tail:
                return h[s + n : s + n + k]
    return []


def spec_generate(eng, ps, max_new, k=K, drafter=ngram_draft):
    """Prefill through step_tokens, then decode through spec_round alone
    with ``drafter(uid, history, k)``'s drafts (the per-step path when a
    round serves nobody). Returns (prompt + generated per row, the rounds'
    (results, last_spec) in order)."""
    sched = eng.scheduler
    uids = list(range(len(ps)))
    for uid, p in zip(uids, ps):
        sched.submit(uid, p)
    out = {u: [] for u in uids}
    remaining = {u: max_new for u in uids}

    def land(uid, tok):
        out[uid].append(int(tok))
        remaining[uid] -= 1
        if remaining[uid] <= 0:
            sched.finish(uid)
        else:
            sched.feedback(uid, int(tok))

    while sched.has_pending():
        for uid, tok in eng.step_tokens().items():
            land(uid, tok)
    rounds = []
    while sched.has_work():
        drafts = {}
        for uid in sched.running_uids():
            seq = eng.state_manager.get_sequence(uid)
            drafts[uid] = drafter(uid, list(seq.tokens), k)
        res = eng.spec_round(k, drafts=drafts)
        if not res:
            for uid, tok in eng.step_tokens().items():
                land(uid, tok)
            continue
        rounds.append(({u: [int(t) for t in g] for u, g in res.items()},
                       {"drafted": eng.last_spec["drafted"],
                        "accepted": eng.last_spec["accepted"],
                        "per_uid": dict(eng.last_spec["per_uid"])},
                       {u: np.asarray(lp) for u, lp in eng.last_logprobs.items()}))
        for uid, gen in res.items():
            take = [int(t) for t in gen][: remaining[uid]]
            out[uid].extend(take)
            remaining[uid] -= len(take)
            if remaining[uid] <= 0:
                sched.finish(uid)
    return [np.asarray(list(p) + out[u], np.int32) for u, p in zip(uids, ps)], rounds


def drafters(plain, ps):
    """The test's three drafters: n-gram, oracle (the plain stream's next
    tokens) and junk (the oracle's tokens shifted by one: all rejected)."""
    def oracle(uid, hist, k):
        n = len(hist)
        return [int(t) for t in plain[uid][n : n + k]]

    def junk(uid, hist, k):
        return [(t + 1) % MODEL["vocab_size"] for t in oracle(uid, hist, k)] or [1]

    return {"ngram": lambda uid, hist, k: ngram_draft(hist, k), "oracle": oracle,
            "junk": junk}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_greedy_spec_streams_match_jax_and_spec_off(kv_dtype):
    """Greedy streams with spec_round equal plain decode's in both
    packages, and the port's rounds equal JAX's round by round: the same
    emitted tokens, drafted and accepted counts, and log-probabilities
    within the engine tolerance. Oracle drafts are all accepted, junk ones
    all rejected (n_emit 1)."""
    kv = dict(engine_config()["kv_cache"], kv_cache_dtype=kv_dtype)
    je, pe = jax_engine(kv_cache=kv), port_engine(kv_cache=kv)
    ps = prompts()
    plain = je.generate(ps, max_new_tokens=24)
    for a, b in zip(plain, pe.generate(ps, max_new_tokens=24)):
        np.testing.assert_array_equal(b, a)
    accepted = {}
    for name, draft in drafters(plain, ps).items():
        jo, jr = spec_generate(je, ps, 24, drafter=draft)
        po, pr = spec_generate(pe, ps, 24, drafter=draft)
        for a, b, c in zip(plain, jo, po):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(c, a)
        assert len(pr) == len(jr)
        for (pres, pspec, plogp), (jres, jspec, jlogp) in zip(pr, jr):
            assert pres == jres and pspec == jspec
            for uid in jlogp:
                np.testing.assert_allclose(plogp[uid], jlogp[uid], atol=LOGIT_ATOL,
                                           rtol=LOGIT_RTOL)
        accepted[name] = (sum(s["accepted"] for _, s, _ in pr), sum(s["drafted"] for _, s, _ in pr))
        acct = pe.state_manager.kv_block_accounting()
        assert acct["free"] == acct["total"], f"leaked KV blocks: {acct}"
    assert accepted["oracle"][0] == accepted["oracle"][1] > 0
    assert accepted["junk"][0] == 0 < accepted["junk"][1]
    assert 0 < accepted["ngram"][0] < accepted["ngram"][1]


def test_sampled_spec_streams_equal_spec_off():
    """Sampled targets are drawn with the keys plain decode uses (seed, uid,
    position), so spec-on streams equal spec-off ones bit for bit, under
    heavy rejection."""
    pe = port_engine(greedy=False, top_k=40)
    ps = prompts()
    plain = pe.generate(ps, max_new_tokens=20)
    for name, draft in drafters(plain, ps).items():
        got, rounds = spec_generate(pe, ps, 20, drafter=draft)
        for a, b in zip(plain, got):
            np.testing.assert_array_equal(b, a)
        assert sum(s["drafted"] for _, s, _ in rounds) > 0


def test_spec_round_refusals_match_jax():
    """The pending-prefill and k < 1 errors of the JAX engine
    (tests/unit/test_spec_decode.py)."""
    for eng in (jax_engine(), port_engine()):
        with pytest.raises(ValueError):
            eng.spec_round(0, drafts={})
        eng.scheduler.submit(0, np.arange(1, 9, dtype=np.int32))
        with pytest.raises(RuntimeError, match="pending"):
            eng.spec_round(K, drafts={})


def test_budget_capped_rounds_rotate_like_jax():
    """A token budget of 10 at k 4 caps a round at 2 of 4 rows; the start
    rotates, so consecutive rounds serve the same uids as JAX's."""
    over = dict(state_manager=dict(engine_config()["state_manager"], max_ragged_batch_size=10),
                prompt_chunk=8, max_prompt_chunks=1)
    je, pe = jax_engine(**over), port_engine(**over)
    ps = [p[:9] for p in prompts()] + [np.arange(3, 12, dtype=np.int32)]
    served = []
    for eng in (je, pe):
        for uid, p in enumerate(ps):
            eng.scheduler.submit(uid, p)
        while eng.scheduler.has_pending():
            for uid, tok in eng.step_tokens().items():
                eng.scheduler.feedback(uid, tok)
        rounds = []
        for _ in range(4):
            res = eng.spec_round(K, drafts={u: [5, 6, 7, 8] for u in range(4)})
            rounds.append({u: [int(t) for t in g] for u, g in res.items()})
        served.append(rounds)
    assert served[1] == served[0]
    assert all(len(r) == 2 for r in served[1])
    assert set(served[1][0]) != set(served[1][1])


def _verify_inputs(rng, R=5, K1=5, nh=4, nkv=2, d=32, NB=20, bs=8, B=6, int8=False):
    """A pool, R rows of K1 tokens (row 1 with a padded tail, row 4
    inactive on all-trash tables), their fresh K/V and queries."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    k_pool, v_pool = f(NB + 1, bs, nkv, d), f(NB + 1, bs, nkv, d)
    pos0 = rng.integers(5, B * bs - K1, size=R)
    n_in = np.full(R, K1)
    n_in[1] = 2
    active = np.arange(R) != 4
    tables = np.full((R, B), NB, np.int32)
    for r in range(R):
        if active[r]:
            need = -(-int(pos0[r] + K1) // bs)
            tables[r, :need] = rng.choice(NB, size=need, replace=False)
    j = np.arange(K1)
    qpos = np.where((j[None] < n_in[:, None]) & active[:, None], pos0[:, None] + j, -1)
    lim = np.where(active, pos0, 0)
    planes = {}
    if int8:
        kq, ks = quantize_kv(torch.from_numpy(k_pool))
        vq, vs = quantize_kv(torch.from_numpy(v_pool))
        k_pool, v_pool = kq.numpy(), vq.numpy()
        planes = dict(k_scale=ks.numpy(), v_scale=vs.numpy())
    return dict(q=f(R * K1, nh, d), k=f(R * K1, nkv, d), v=f(R * K1, nkv, d), k_pool=k_pool,
                v_pool=v_pool, tables=tables, qpos=qpos.astype(np.int32),
                lim=lim.astype(np.int32), trash=NB, **planes)


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("int8", [False, True])
def test_verify_form_matches_jax_chunk_attention(window, int8):
    """The port's verify-form call of the plain ``paged_decode``
    (``paged.verify_kwargs``) against the JAX package's
    ``paged_chunk_attention`` (the JAX engine's CPU verify) on the same
    inputs, padded slots and an inactive row included (both emit 0)."""
    x = _verify_inputs(np.random.default_rng(11), int8=int8)
    R, K1 = x["qpos"].shape
    t = {k: torch.from_numpy(v) for k, v in x.items() if isinstance(v, np.ndarray)}
    scales = dict(k_scale=t["k_scale"], v_scale=t["v_scale"]) if int8 else {}
    kw = ppaged.verify_kwargs(t["q"], t["k"], t["v"], t["tables"], t["qpos"], t["lim"],
                              x["trash"])
    got = ppaged.paged_decode(k_cache=t["k_pool"], v_cache=t["v_pool"], window=window,
                              **scales, **kw)
    jscales = dict(k_scale=jnp.asarray(x["k_scale"]), v_scale=jnp.asarray(x["v_scale"])) \
        if int8 else {}
    want = jpaged.paged_chunk_attention(
        jnp.asarray(x["q"]).reshape(R, K1, 4, 32), jnp.asarray(x["k_pool"]),
        jnp.asarray(x["v_pool"]), jnp.asarray(x["tables"]), jnp.asarray(x["qpos"]),
        x["trash"], window=window,
        new_kv=(jnp.asarray(x["k"]).reshape(R, K1, 2, 32),
                jnp.asarray(x["v"]).reshape(R, K1, 2, 32)),
        pool_limit=jnp.asarray(x["lim"]), **jscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(R * K1, 4, 32),
                               atol=1e-5, rtol=1e-5)
    flat = x["qpos"].reshape(-1)
    assert (got[flat < 0] == 0).all()
    # the split-and-merge model of the kernel gives the same function
    split = ppaged.paged_decode_split_merge(k_cache=t["k_pool"], v_cache=t["v_pool"],
                                            window=window, split_keys=8, **scales, **kw)
    torch.testing.assert_close(split, got, atol=1e-5, rtol=1e-5)


def test_verify_engine_logits_match_plain_forward():
    """The verify step's emitted tokens and log-probabilities against the
    port's plain forward over prompt + emitted tokens (oracle drafts)."""
    pe = port_engine(window=12)
    ps = prompts()[:2]
    plain = port_engine(window=12).generate(ps, max_new_tokens=8)
    for uid, p in enumerate(ps):
        pe.scheduler.submit(uid, p)
    first = {}
    while pe.scheduler.has_pending():
        first.update(pe.step_tokens())
    for uid, tok in first.items():
        pe.scheduler.feedback(uid, tok)
    drafts = {uid: [int(t) for t in plain[uid][len(ps[uid]) + 1 : len(ps[uid]) + 1 + K]]
              for uid in first}
    res = pe.spec_round(K, drafts=drafts)
    for uid, p in enumerate(ps):
        assert len(res[uid]) == K + 1
        seq = list(p) + [first[uid]] + [int(t) for t in res[uid]]
        ref = PT.forward_reference(pe.params, torch.as_tensor([seq]), pe._mc)[0][0]
        n = len(p) + 1
        logp = torch.log_softmax(ref[n - 1 : n + K], dim=-1)
        np.testing.assert_array_equal(res[uid], logp.argmax(dim=-1).numpy())
        np.testing.assert_allclose(pe.last_logprobs[uid],
                                   logp.max(dim=-1).values.numpy(), atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_verify_form_matches_plain(int8):
    """The paged-decode kernel (and its int8 form) in the verify form
    against its plain version, per (row, head) relative Frobenius <= 1e-2
    in bf16: extras fewer than a tile (5 against 64 keys), padded slots
    with a pool limit, an inactive row on trash tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    x = _verify_inputs(np.random.default_rng(12), R=8, nh=8, nkv=2, d=128, NB=40, bs=16, B=8,
                       int8=int8)
    dev = torch.device("cuda")
    t = {}
    for k, v in x.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v).to(dev)
            t[k] = v.to(torch.bfloat16) if v.dtype == torch.float32 and "scale" not in k else v
    scales = dict(k_scale=t["k_scale"], v_scale=t["v_scale"]) if int8 else {}
    kw = ppaged.verify_kwargs(t["q"], t["k"], t["v"], t["tables"], t["qpos"], t["lim"],
                              x["trash"])
    for window in (0, 9):
        got = ppaged.paged_decode(k_cache=t["k_pool"], v_cache=t["v_pool"], window=window,
                                  **scales, **kw)
        want = ppaged.paged_decode_attention_dense(k_cache=t["k_pool"], v_cache=t["v_pool"],
                                                   window=window, **scales, **kw)
        g, w = got.float(), want.float()
        den = w.norm(dim=-1)
        assert bool((g[den == 0] == 0).all())
        rel = (g - w).norm(dim=-1)[den > 0] / den[den > 0]
        assert float(rel.max()) <= 1e-2
