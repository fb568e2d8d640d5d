"""The port's host block tier and KV transports against the JAX package's,
on the CPU.

Both engines serve the JAX package's ``tiny`` preset at 2 layers in fp32
(the weights of ``tests/unit/test_host_tier.py``, moved into the port with
``params_from_numpy``) from a 24-block pool with the prefix cache on. A hot
prompt is served, a flood of other prompts evicts its cached blocks (tier
on: spills them to the host store), then the hot prefix returns (tier on:
readmits them through ``import_kv_blocks_chunked``).
"""

import functools

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference.config import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig as EngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.serving.resilience import FaultSpec, inject


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and tiny models gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _jax_model():
    cfg = JT.get_config("tiny", n_layers=2, dtype="float32", max_seq_len=512)
    return cfg, JT.init_params(cfg, jax.random.key(0))


def _rc(host_tier_bytes, greedy=True, kv_dtype="bf16", num_blocks=24, seed=7, **kv_over):
    kv = {"block_size": 4, "num_blocks": num_blocks, "max_blocks_per_seq": 16,
          "prefix_cache": True, "kv_cache_dtype": kv_dtype,
          "host_tier_bytes": host_tier_bytes, "host_tier_chunk_blocks": 2}
    kv.update(kv_over)
    return {"dtype": "float32", "greedy": greedy, "temperature": 0.9, "seed": seed,
            "kv_cache": kv,
            "state_manager": {"max_tracked_sequences": 16, "max_ragged_batch_size": 256,
                              "max_ragged_sequence_count": 8, "max_context": 256}}


def port_engine(host_tier_bytes, **kw):
    cfg, jp = _jax_model()
    pcfg = PT.get_config("tiny", n_layers=2, dtype="float32", max_seq_len=512)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return InferenceEngineV2(pcfg, pp, EngineConfig.from_dict(_rc(host_tier_bytes, **kw)),
                             device="cpu")


def jax_engine(host_tier_bytes, **kw):
    cfg, jp = _jax_model()
    return JaxEngine(cfg, jp, JaxEngineConfig.from_dict(_rc(host_tier_bytes, **kw)))


def _cycle_prompts():
    rng = np.random.default_rng(0)
    hot = rng.integers(0, 128, size=13).tolist()  # 3 full blocks + tail
    floods = [rng.integers(0, 128, size=17).tolist() for _ in range(6)]
    return hot, floods


def evict_cycle(engine, max_new=8):
    """Seed a hot prefix, flood the 24-block pool until the trie evicts it,
    then revisit it (tests/unit/test_host_tier.py's cycle)."""
    hot, floods = _cycle_prompts()
    outs = [np.asarray(o) for o in engine.generate([list(hot) + [5, 6]], max_new_tokens=max_new)]
    for f in floods:
        outs += [np.asarray(o) for o in engine.generate([f], max_new_tokens=max_new)]
    outs += [np.asarray(o)
             for o in engine.generate([list(hot) + [9, 9, 2]], max_new_tokens=max_new)]
    return outs


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_tier_streams_match_tier_off_and_jax(kv_dtype, greedy):
    """Streams with the tier on equal streams with it off (greedy and
    sampled) and, greedy, the JAX engine's tier-on streams; the store's
    spill, readmit and block counts equal JAX's on the same trace."""
    off = evict_cycle(port_engine(0, greedy=greedy, kv_dtype=kv_dtype))
    pe = port_engine(1 << 20, greedy=greedy, kv_dtype=kv_dtype)
    on = evict_cycle(pe)
    st = pe.host_tier.stats()
    assert st["spills"] > 0 and st["readmits"] > 0
    for a, b in zip(off, on):
        np.testing.assert_array_equal(b, a)
    if not greedy:
        return  # sampled draws agree within the port only (ROADMAP queue 1, item 4)
    je = jax_engine(1 << 20, kv_dtype=kv_dtype)
    jo = evict_cycle(je)
    for a, b in zip(jo, on):
        np.testing.assert_array_equal(b, a)
    js = je.host_tier.stats()
    for key in ("spills", "readmits", "blocks", "bytes"):
        assert st[key] == js[key], key


def test_readmit_fault_degrades_to_a_reprefill():
    """A ``host_tier.readmit`` fault (at every arrival) leaves the pool
    untouched and the sequence re-prefills: the same stream, no readmit."""
    off = evict_cycle(port_engine(0))
    pe = port_engine(1 << 20)
    with inject(*[FaultSpec("host_tier.readmit", nth=i) for i in range(1, 65)]) as inj:
        on = evict_cycle(pe)
    assert inj.fired() and pe.host_tier.stats()["spills"] > 0
    assert pe.host_tier.stats()["readmits"] == 0
    for a, b in zip(off, on):
        np.testing.assert_array_equal(b, a)


def test_readmit_charges_only_the_tail():
    """The revisit's prefill schedules only the tokens the trie and the
    tier do not cover."""
    pe = port_engine(1 << 20)
    hot, floods = _cycle_prompts()
    pe.generate([list(hot) + [5, 6]], max_new_tokens=2)
    for f in floods:
        pe.generate([f], max_new_tokens=2)
    before = pe.host_tier.stats()["readmits"]
    prompt = list(hot) + [9, 9, 2]  # 16 tokens: 3 blocks stored, the 4th new
    pe.scheduler.submit(0, np.asarray(prompt, np.int32))
    pe._step_device()
    assert pe.host_tier.stats()["readmits"] - before == 3
    assert pe.last_scheduled_tokens == len(prompt) - 12
    pe.scheduler.finish(0)


def test_tier_requires_the_prefix_cache():
    with pytest.raises(ValueError, match="prefix_cache"):
        port_engine(1 << 20, prefix_cache=False)


# ---------------------------------------------------------------------------
# import validation (tests/unit/test_host_tier.py's engine-level cases)
# ---------------------------------------------------------------------------
def _payload_case(case, eng):
    payload = eng.export_kv_blocks([1, 2])
    ids = [1, 2]
    if case == "missing_plane":
        del payload["v"]
        return ids, payload, "missing"
    if case == "unexpected_scale":
        payload["k_scale"] = np.zeros((2, 2, 4, 2), np.float32)
        return ids, payload, "unexpected"
    if case == "wrong_block_count":
        return [1, 2, 3], payload, "shape"
    if case == "wrong_trailing_shape":
        payload["k"] = payload["k"][..., :-1]
        return ids, payload, "shape"
    if case == "wrong_dtype":
        payload["k"] = np.asarray(payload["k"], np.float16)
        return ids, payload, "dtype"
    if case == "int8_missing_scales":
        assert set(payload) == {"k", "v", "k_scale", "v_scale"}
        return ids, {k: v for k, v in payload.items() if not k.endswith("_scale")}, "missing"
    payload["k_scale"] = payload["k_scale"].astype(np.float64)  # int8_wrong_scale_dtype
    return ids, payload, "dtype"


@pytest.mark.parametrize("case", ["missing_plane", "unexpected_scale", "wrong_block_count",
                                  "wrong_trailing_shape", "wrong_dtype", "int8_missing_scales",
                                  "int8_wrong_scale_dtype"])
def test_import_validation(case):
    eng = port_engine(0, kv_dtype="int8" if case.startswith("int8") else "bf16")
    ids, payload, match = _payload_case(case, eng)
    with pytest.raises(ValueError, match=match):
        eng.import_kv_blocks(ids, payload)
    with pytest.raises(ValueError, match=match):
        eng.import_kv_blocks_chunked(ids, payload, chunk_blocks=1)


def test_chunked_roundtrip_and_tier_entry_validation():
    eng = port_engine(1 << 20)
    payload = eng.export_kv_blocks([1, 2, 3])
    eng.import_kv_blocks_chunked([4, 5, 6], payload, chunk_blocks=2)
    back = eng.export_kv_blocks([4, 5, 6])
    for name in payload:
        np.testing.assert_array_equal(payload[name], back[name])
    bad = {name: p[:, 0] for name, p in payload.items()}
    bad["k"] = bad["k"].astype(np.float16)
    with pytest.raises(ValueError, match="host_tier.put"):
        eng.host_tier.put(b"x", bad)


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------
def _filled(eng, seed=1):
    """Fill every pool plane (trash block included) with seeded values."""
    g = torch.Generator().manual_seed(seed)
    for pool in eng._kv_pool_planes().values():
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=g, dtype=torch.int8))
        else:
            pool.copy_(torch.rand(pool.shape, generator=g, dtype=pool.dtype) + 0.5)
    return eng


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n", [2, 3, 6])
def test_chunked_import_equals_plain_import(kv_dtype, n):
    """At chunk 2: n <= chunk, chunk + 1 and 3 x chunk blocks leave the pool
    bit-identical to ``import_kv_blocks``; only the trash block differs
    (the padded tail writes zeros there)."""
    src = _filled(port_engine(0, kv_dtype=kv_dtype), seed=1)
    payload = src.export_kv_blocks(list(range(n)))
    dst = list(range(10, 10 + n))
    plain = _filled(port_engine(0, kv_dtype=kv_dtype), seed=2)
    chunked = _filled(port_engine(0, kv_dtype=kv_dtype), seed=2)
    plain.import_kv_blocks(dst, payload)
    chunked.import_kv_blocks_chunked(dst, payload, chunk_blocks=2 if n > 2 else 0)
    trash = plain.config.kv_cache.num_blocks
    for name, a in plain._kv_pool_planes().items():
        b = chunked._kv_pool_planes()[name]
        assert torch.equal(a[:, :trash], b[:, :trash]), name
        if n % 2:  # a padded tail: zeros in the trash block
            assert (b[:, trash] == 0).all()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n,skip", [(5, 0), (5, 2), (7, 4), (2, 3)])
def test_window_export_import_matches_jax(kv_dtype, n, skip):
    """The windowed device export and import with ``skip_blocks``: the
    copied count equals the JAX engine's, the destination blocks past the
    skip hold the source's planes, and the skipped ones are untouched."""
    src = _filled(port_engine(0, kv_dtype=kv_dtype), seed=3)
    ids, dst_ids = list(range(1, 1 + n)), list(range(12, 12 + n))
    wins, chunk = src.export_kv_blocks_windows(ids, chunk_blocks=2)
    assert chunk == 2 and len(wins) == -(-n // 2)
    assert all(w["k"].shape[1] == 2 for w in wins)
    dst = _filled(port_engine(0, kv_dtype=kv_dtype), seed=4)
    before = dst.export_kv_blocks(dst_ids)
    copied = dst.import_kv_blocks_device(dst_ids, wins, chunk, skip_blocks=skip)

    je = jax_engine(0, kv_dtype=kv_dtype)
    jw, jc = je.export_kv_blocks_windows(ids, chunk_blocks=2)
    assert copied == je.import_kv_blocks_device(dst_ids, jw, jc, skip_blocks=skip)
    assert copied == max(0, n - skip)
    want, got = src.export_kv_blocks(ids), dst.export_kv_blocks(dst_ids)
    dev = src.export_kv_blocks_device(ids)
    for name in want:
        np.testing.assert_array_equal(got[name][:, skip:], want[name][:, skip:])
        np.testing.assert_array_equal(got[name][:, :skip], before[name][:, :skip])
        assert torch.equal(dev[name], src._kv_pool_planes()[name][:, ids])
    with pytest.raises(ValueError, match="windows"):
        dst.import_kv_blocks_device(dst_ids, wins[:-1] or [wins[0], wins[0]], chunk)
    bad = [dict(w, k=w["k"].double()) for w in wins]
    with pytest.raises(ValueError, match="payload"):
        dst.import_kv_blocks_device(dst_ids, bad, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cuda_chunked_import_equals_plain_import(kv_dtype):
    """On a card the chunked import stages the payload in pinned memory and
    copies its windows on a side stream into two buffers that the scatters
    take in turn: at chunk 1 over 9 blocks each buffer is reused four
    times, and the pool must still equal ``import_kv_blocks``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # head_dim 64: the paged kernel's smallest, which the engine asks of a card
    pcfg = PT.get_config("tiny", n_layers=2, dtype="float32", max_seq_len=512, n_heads=2,
                         n_kv_heads=1)
    pp = PT.init_params(pcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")

    def engine(seed):
        eng = InferenceEngineV2(pcfg, pp, EngineConfig.from_dict(_rc(0, kv_dtype=kv_dtype)),
                                device="cuda")
        g = torch.Generator(device="cuda").manual_seed(seed)
        for pool in eng._kv_pool_planes().values():
            if pool.dtype == torch.int8:
                pool.copy_(torch.randint(-127, 128, pool.shape, generator=g, device="cuda",
                                         dtype=torch.int8))
            else:
                pool.copy_(torch.rand(pool.shape, generator=g, device="cuda",
                                      dtype=pool.dtype) + 0.5)
        return eng

    payload = engine(1).export_kv_blocks(list(range(9)))
    dst = list(range(12, 21))
    plain, chunked = engine(2), engine(2)
    plain.import_kv_blocks(dst, payload)
    chunked.import_kv_blocks_chunked(dst, payload, chunk_blocks=1)
    trash = plain.config.kv_cache.num_blocks
    for name, a in plain._kv_pool_planes().items():
        assert torch.equal(a[:, :trash], chunked._kv_pool_planes()[name][:, :trash]), name
