"""The port's ``warm_trace`` / ``trace_signature`` and ``set_sampling``, on
the CPU.

The port compiles no programs; its signature is the set of kernel
libraries a process has built or loaded (empty on the CPU, where no kernel
loads). ``warm_trace`` drives the JAX engine's step kinds; after it serving
adds no entry, the prefix trie holds no warm prefix, and the streams are a
cold engine's. The model is ``tests/test_torch_spec_decode.py``'s, on the
JAX package's weights.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_spec_decode import jax_engine, ngram_draft, port_engine, prompts


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and tiny models gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KV = {"block_size": 8, "num_blocks": 64, "max_blocks_per_seq": 12, "prefix_cache": True,
      "host_tier_bytes": 1 << 20, "host_tier_chunk_blocks": 2}


def serve(eng, ps, k=2):
    """generate() (fused rounds of decode_steps), then speculative decode
    of the same prompts with n-gram drafts."""
    from tests.test_torch_spec_decode import spec_generate

    outs = eng.generate(ps, max_new_tokens=9)
    spec, _ = spec_generate(eng, ps, 9, k=k,
                            drafter=lambda uid, hist, kk: ngram_draft(hist, kk))
    return outs + spec


@pytest.mark.parametrize("prompt_chunk,max_context", [(32, 96), (256, 320)])
def test_serving_after_warm_trace_grows_no_signature(prompt_chunk, max_context):
    kv = dict(KV, max_blocks_per_seq=max_context // 8)
    over = dict(decode_steps=4, prompt_chunk=prompt_chunk, kv_cache=kv,
                state_manager={"max_tracked_sequences": 8, "max_ragged_batch_size": 512,
                               "max_ragged_sequence_count": 4, "max_context": max_context})
    ps = prompts() + ([np.arange(1, 200, dtype=np.int32)] if prompt_chunk > 128 else [])
    cold = serve(port_engine(**over), ps)
    eng = port_engine(**over)
    sig = eng.warm_trace(decode_steps=4, spec_k=2)
    assert sig == eng.trace_signature()
    assert eng.prefix_cache.prefix_hashes() == set()
    assert eng.host_tier.stats()["spills"] == 0
    warm = serve(eng, ps)
    assert eng.trace_signature() == sig
    for a, b in zip(cold, warm):
        np.testing.assert_array_equal(b, a)


def test_warm_trace_drives_the_step_kinds_of_jax():
    """The JAX engine's warm_trace compiles the split step at its chunk
    buckets, the round, the verify k and the readmit and export windows;
    the port's drives the same step kinds, with the same prompt lengths."""
    over = dict(decode_steps=4, prompt_chunk=256, kv_cache=dict(KV, max_blocks_per_seq=40),
                state_manager={"max_tracked_sequences": 8, "max_ragged_batch_size": 512,
                               "max_ragged_sequence_count": 4, "max_context": 320})
    jsig = jax_engine(**over).warm_trace(decode_steps=4, spec_k=2)
    assert {k.split("[")[0] for k in jsig} == {
        "_split_jit", "_multistep_jit", "_verify_jit", "_kv_readmit_jit", "_kv_export_jit"}
    eng = port_engine(**over)
    calls = []

    def spy(name):
        fn = getattr(eng, name)

        def wrapped(*a, **kw):
            calls.append((name, a[0] if name in ("decode_round", "spec_round") else None))
            return fn(*a, **kw)
        setattr(eng, name, wrapped)

    for name in ("decode_round", "spec_round", "import_kv_blocks_chunked",
                 "export_kv_blocks_windows", "import_kv_blocks_device"):
        spy(name)
    submit = eng.scheduler.submit
    lengths = []
    eng.scheduler.submit = lambda uid, toks, *a, **kw: (lengths.append(len(toks)),
                                                         submit(uid, toks, *a, **kw))[1]
    assert eng.warm_trace(decode_steps=4, spec_k=2) == eng.trace_signature()
    assert lengths == [8, 256]  # the 128 bucket and prompt_chunk
    assert calls == [("decode_round", 4), ("spec_round", 2), ("import_kv_blocks_chunked", None),
                     ("export_kv_blocks_windows", None), ("import_kv_blocks_device", None)]


def test_trace_signature_is_the_loaded_kernel_libraries(monkeypatch):
    """Each kernel library built or loaded in the process is one entry;
    nothing else is, and set_sampling changes nothing."""
    from deepspeed_tpu_torch.ops import kernels as K

    eng = port_engine()
    eng.generate(prompts(), max_new_tokens=4)
    assert eng.trace_signature() == {}  # no kernel loads on the CPU
    monkeypatch.setattr(type(K.KERNELS["rms_norm_fwd"]), "loaded",
                        property(lambda k: k.name in ("rms_norm_fwd", "paged_decode")))
    assert eng.trace_signature() == {"kernel[rms_norm_fwd]": 1, "kernel[paged_decode]": 1}
    eng.set_sampling(greedy=False, temperature=0.7, seed=5)
    assert eng.trace_signature() == {"kernel[rms_norm_fwd]": 1, "kernel[paged_decode]": 1}


def test_set_sampling_takes_effect_and_a_seed_reset_restarts_streams():
    ps = prompts()
    greedy = port_engine().generate(ps, max_new_tokens=8)
    eng = port_engine()
    eng.set_sampling(greedy=False, temperature=0.9, top_k=40, seed=3)
    assert eng._sampling_kw() == {"greedy": False, "top_k": 40, "top_p": 0.0}
    first = eng.generate(ps, max_new_tokens=8)
    assert any((a != b).any() for a, b in zip(first, greedy))
    configured = port_engine(greedy=False, temperature=0.9, top_k=40, seed=3)
    for a, b in zip(first, configured.generate(ps, max_new_tokens=8)):
        np.testing.assert_array_equal(b, a)
    eng.set_sampling(seed=4)
    other = eng.generate(ps, max_new_tokens=8)
    assert any((a != b).any() for a, b in zip(first, other))
    eng.set_sampling(seed=3)
    for a, b in zip(first, eng.generate(ps, max_new_tokens=8)):
        np.testing.assert_array_equal(b, a)
    eng.set_sampling(greedy=True)
    for a, b in zip(greedy, eng.generate(ps, max_new_tokens=8)):
        np.testing.assert_array_equal(b, a)
