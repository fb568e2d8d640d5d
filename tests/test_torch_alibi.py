"""ALiBi (BLOOM) in the PyTorch port against the JAX package.

  * the flash kernels' plain versions with the ALiBi term
    (``flash_fwd_reference`` / ``flash_bwd_reference``, the versions the
    CUDA kernels' ALiBi forms are held to on the card) and the autograd
    ``flash_attention`` on CPU tensors, against the JAX package's
    ``flash_attention(..., interpret=True, alibi_slopes=,
    alibi_positions=)`` and its ``jax.vjp``: causal and non-causal, GQA,
    custom per-row positions and packed segments whose positions restart,
    as ``tests/unit/ops/test_flash_attention.py`` runs them;
  * the attention seam: ALiBi on a CPU tensor is ``mha_reference``'s dense
    term (as the JAX seam builds it), on impl "flash" the Function; splash,
    the ring and the head-sharded form refuse it;
  * the model: a BLOOM-shaped tiny model's logits, loss and gradients, and
    the v1 engine's ``decode_step`` logits, against the JAX model's;
  * on a card (``cuda`` marker; they skip here): the three ALiBi kernels
    against their plain versions.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.models import transformer as JT  # noqa: E402
from deepspeed_tpu.ops.attention import core as jcore  # noqa: E402
from deepspeed_tpu.ops.attention import flash_pallas as jf  # noqa: E402
from deepspeed_tpu_torch.models import transformer as PT  # noqa: E402
from deepspeed_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from deepspeed_tpu_torch.ops.attention import core as pcore  # noqa: E402
from deepspeed_tpu_torch.ops.attention import flash as pf  # noqa: E402
from deepspeed_tpu_torch.runtime.optimizers import _leaves  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and tiny models gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# fp32 on both sides: the same products summed in another order, the term
# slope * position (up to ~100 here) added in fp32 on both
FP32_ATOL = FP32_RTOL = 1e-5
# bf16 inputs: both round p and ds to bf16 (against other maxima) and the
# outputs once (2^-8 relative)
BF16_ATOL = BF16_RTOL = 2.0 ** -6
# model logits and gradients in fp32 (tests/test_torch_train.py's)
GRAD_ATOL = GRAD_RTOL = 2e-5


def _inputs(b, h, h_kv, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=sh).astype(np.float32)
                 for sh in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d), (b, h, s, d)))


def _positions(kind, b, s):
    """None (arange), per-row offsets [b, s], or packed: two segments per
    row whose positions restart at the cut (with the segment ids)."""
    if kind == "arange":
        return None, None
    if kind == "offset":
        return (np.arange(s, dtype=np.int32)[None] + 5 + 7 * np.arange(b, dtype=np.int32)[:, None],
                None)
    seg = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    for i in range(b):
        cut = s // 3 + 17 * i
        seg[i, cut:] = 1
        pos[i] = np.concatenate([np.arange(cut), np.arange(s - cut)])
    return pos, seg


def _jax(q, k, v, do, causal, slopes, pos, seg):
    """(out, lse, dq, dk, dv) from the Pallas bodies in interpret mode."""
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jseg = None if seg is None else jnp.asarray(seg)
    jpos = None if pos is None else jnp.asarray(pos)
    alibi = jf.build_alibi_operand(jnp.asarray(slopes), jpos, q.shape[0], q.shape[2])
    _, lse = jf._flash_call(jq, jk, jv, jseg, alibi, None, causal, None, 0, True)

    def f(q_, k_, v_):
        return jf.flash_attention(q_, k_, v_, causal, jseg, None, True,
                                  alibi_slopes=jnp.asarray(slopes), alibi_positions=jpos)

    out, vjp = jax.vjp(f, jq, jk, jv)
    return tuple(np.asarray(a).astype(np.float32) for a in (out, lse[..., 0]) + vjp(jdo))


def _np(t):
    return t.detach().float().numpy()


CASES = {
    # name: (b, h, h_kv, causal, positions)
    "causal": (2, 4, 4, True, "arange"),
    "non_causal": (1, 4, 4, False, "arange"),
    "gqa_8_2_offset": (2, 8, 2, True, "offset"),
    "non_causal_gqa_offset": (2, 4, 2, False, "offset"),
    "packed_restart": (2, 4, 2, True, "packed"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp32_matches_pallas_bodies(name, monkeypatch):
    """Plain fwd (out and LSE), plain bwd and the autograd Function with
    ALiBi, each against the interpret-mode Pallas bodies with their ALiBi
    operand. 128-row blocks: the Pallas grid streams two kv blocks at s =
    256, so the term's per-block key positions run."""
    monkeypatch.setenv("DSTPU_FLASH_BLOCK", "128")
    b, h, h_kv, causal, kind = CASES[name]
    s, d = 256, 64
    q, k, v, do = _inputs(b, h, h_kv, s, d, seed=len(name))
    pos, seg = _positions(kind, b, s)
    slopes = PT.alibi_slopes(h)
    want = _jax(q, k, v, do, causal, slopes, pos, seg)

    t = params_from_numpy({"q": q, "k": k, "v": v, "do": do})
    tpos = None if pos is None else torch.from_numpy(pos)
    tseg = None if seg is None else torch.from_numpy(seg)
    alibi = pf.alibi_operand(torch.from_numpy(slopes), tpos, b, h, s, "cpu")
    kw = dict(causal=causal, segment_ids=tseg, alibi=alibi)
    out, lse = pf.flash_fwd_reference(t["q"], t["k"], t["v"], **kw)
    grads = pf.flash_bwd_reference(t["q"], t["k"], t["v"], out, t["do"], lse, **kw)
    for got, w, what in zip((out, lse) + grads, want, ("out", "lse", "dq", "dk", "dv")):
        np.testing.assert_allclose(_np(got), w, atol=FP32_ATOL, rtol=FP32_RTOL, err_msg=what)

    leaves = [t[n].clone().requires_grad_(True) for n in ("q", "k", "v")]
    out2 = pf.flash_attention(*leaves, causal=causal, segment_ids=tseg,
                              alibi_slopes=torch.from_numpy(slopes), alibi_positions=tpos)
    out2.backward(t["do"])
    np.testing.assert_allclose(_np(out2), want[0], atol=FP32_ATOL, rtol=FP32_RTOL)
    for leaf, w, what in zip(leaves, want[2:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(leaf.grad), w, atol=FP32_ATOL, rtol=FP32_RTOL,
                                   err_msg=what)


def test_bf16_matches_pallas_bodies(monkeypatch):
    monkeypatch.setenv("DSTPU_FLASH_BLOCK", "128")
    b, h, h_kv, s, d = 2, 8, 2, 256, 64
    q, k, v, do = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in _inputs(b, h, h_kv, s, d, 9))
    pos, seg = _positions("packed", b, s)
    slopes = PT.alibi_slopes(h)
    want = _jax(q, k, v, do, True, slopes, pos, seg)
    t = params_from_numpy({"q": q, "k": k, "v": v, "do": do})
    alibi = pf.alibi_operand(torch.from_numpy(slopes), torch.from_numpy(pos), b, h, s, "cpu")
    kw = dict(causal=True, segment_ids=torch.from_numpy(seg), alibi=alibi)
    out, lse = pf.flash_fwd_reference(t["q"], t["k"], t["v"], **kw)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = pf.flash_bwd_reference(t["q"], t["k"], t["v"], out, t["do"], lse, **kw)
    np.testing.assert_allclose(_np(lse), want[1], atol=FP32_ATOL * 10, rtol=FP32_RTOL * 10)
    for got, w, what in zip((out,) + grads, want[:1] + want[2:], ("out", "dq", "dk", "dv")):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_np(got), w, atol=BF16_ATOL * scale, rtol=BF16_RTOL,
                                   err_msg=what)


def test_operand_shapes_and_refusals():
    slopes = torch.ones(4)
    sl, pos = pf.alibi_operand(slopes, None, 2, 4, 8, "cpu")
    assert pos.dtype == torch.int32 and tuple(pos.shape) == (2, 8)
    assert torch.equal(pos[1], torch.arange(8, dtype=torch.int32))
    _, pos = pf.alibi_operand(slopes, torch.arange(8) + 3, 2, 4, 8, "cpu")
    assert tuple(pos.shape) == (2, 8) and int(pos[0, 0]) == 3
    with pytest.raises(ValueError, match="alibi_slopes"):
        pf.alibi_operand(torch.ones(3), None, 2, 4, 8, "cpu")
    with pytest.raises(ValueError, match="alibi_positions"):
        pf.alibi_operand(slopes, torch.zeros(3, 8), 2, 4, 8, "cpu")
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="without alibi_slopes"):
        pf.flash_attention(q, q, q, alibi_positions=torch.arange(8))


def test_seam_routes_alibi():
    """On a CPU tensor "auto" is mha_reference with the dense term, as the
    JAX seam's reference (its mha_reference with alibi_slopes); "flash" is
    the Function's plain versions, the same function; splash, the ring and
    the head-sharded form refuse it."""
    q, k, v, _ = _inputs(2, 4, 2, 64, 32, seed=3)
    slopes = PT.alibi_slopes(4)
    pos = np.arange(64, dtype=np.int32)[None].repeat(2, 0) + 11
    t = params_from_numpy({"q": q, "k": k, "v": v})
    kw = dict(alibi_slopes=torch.from_numpy(slopes), alibi_positions=torch.from_numpy(pos))
    want = np.asarray(jcore.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=True, alibi_slopes=jnp.asarray(slopes),
                                          alibi_positions=jnp.asarray(pos)))
    for impl in (None, "auto", "reference", "flash"):
        got = pcore.attention(t["q"], t["k"], t["v"], impl=impl, **kw)
        np.testing.assert_allclose(_np(got), want, atol=FP32_ATOL, rtol=FP32_RTOL,
                                   err_msg=str(impl))
    with pytest.raises(ValueError, match="splash"):
        pcore.attention(t["q"], t["k"], t["v"], impl="splash", **kw)
    for impl in ("flash_ring", "flash_head_sharded"):
        with pytest.raises(NotImplementedError, match="queue 2, item 1"):
            pcore.attention(t["q"], t["k"], t["v"], impl=impl, **kw)


BLOOM = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, max_seq_len=64,
             remat=False, dtype="float32", position="alibi", norm="layernorm",
             activation="gelu", tie_embeddings=True, embed_norm=True, attn_qkv_bias=True,
             attn_out_bias=True, mlp_bias=True)


def _bloom(**over):
    kw = dict(BLOOM, **over)
    jc, pc = JT.TransformerConfig(**kw), PT.TransformerConfig(**kw)
    jp = JT.init_params(jc, jax.random.key(0))
    # non-zero biases and norm offsets, so every leaf's gradient is exercised
    jp = jax.tree.map(lambda a: a + 0.01 * jnp.sin(jnp.arange(a.size, dtype=a.dtype)
                                                   ).reshape(a.shape), jp)
    return jc, pc, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("attention_impl", ["auto", "flash"])
@pytest.mark.parametrize("packed", [False, True])
def test_bloom_loss_and_grads_match_jax(packed, attention_impl):
    """The BLOOM-shaped model's loss and every leaf's gradient against
    jax.value_and_grad (fp32), on a plain and a packed batch (segment ids,
    positions restarting per segment: ALiBi's key positions); "flash" runs
    the flash Function's plain ALiBi versions."""
    jc, pc, jp, tp = _bloom(attention_impl=attention_impl)
    rng = np.random.default_rng(1)
    batch = {"input_ids": rng.integers(0, 256, size=(2, 33)).astype(np.int32)}
    if packed:
        batch["positions"], batch["segment_ids"] = _positions("packed", 2, 32)
    jl, jg = jax.value_and_grad(JT.make_loss_fn(jc))(
        jp, {key: jnp.asarray(a) for key, a in batch.items()})
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    loss = PT.make_loss_fn(pc)(tp, {key: torch.from_numpy(a) for key, a in batch.items()})
    leaves = dict(_leaves(tp))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jg = dict(_leaves(jax.tree.map(np.asarray, jg)))
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_bloom_logits_and_reference_match_jax():
    jc, pc, jp, tp = _bloom()
    toks = np.random.default_rng(4).integers(0, 256, size=(2, 40)).astype(np.int32)
    want = np.asarray(JT.forward(jp, jnp.asarray(toks), jc)[0])
    for fn in (PT.forward, PT.forward_reference):
        got = fn(tp, torch.from_numpy(toks), pc)[0]
        np.testing.assert_allclose(_np(got), want, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_bloom_decode_step_matches_jax():
    """The cached decode (the v1 engine's path): a prompt of 12 tokens,
    then 4 single-token steps, logits against the JAX decode_step's at
    every step (ALiBi's dense term over the cache's positions), and the v1
    engine's greedy stream against the JAX engine's."""
    jc, pc, jp, tp = _bloom()
    toks = np.random.default_rng(5).integers(0, 256, size=(2, 16)).astype(np.int32)
    jcache = JT.init_kv_cache(jc, 2, 32)
    pcache = PT.init_kv_cache(pc, 2, 32, device="cpu")
    spans = [(0, 12)] + [(i, i + 1) for i in range(12, 16)]
    for lo, hi in spans:
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32), (2, hi - lo))
        jl, jcache = JT.decode_step(jp, jnp.asarray(toks[:, lo:hi]), jc, jcache, jnp.asarray(pos))
        pl, pcache = PT.decode_step(tp, torch.from_numpy(toks[:, lo:hi]), pc, pcache,
                                    torch.from_numpy(np.ascontiguousarray(pos)))
        np.testing.assert_allclose(_np(pl), np.asarray(jl), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"step {lo}:{hi}")
    import deepspeed_tpu

    jeng = deepspeed_tpu.init_inference((jc, jp), {"dtype": "float32", "max_tokens": 32})
    peng = deepspeed_tpu_torch.init_inference((pc, tp), {"dtype": "float32", "max_tokens": 32},
                                              device="cpu")
    np.testing.assert_array_equal(
        np.asarray(peng.generate(toks[:, :8], max_new_tokens=6)),
        np.asarray(jeng.generate(jnp.asarray(toks[:, :8]), max_new_tokens=6)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal_gqa", "packed_restart", "non_causal_tail", "d256",
                                  "d64"])
def test_cuda_alibi_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    b, h, h_kv, s, d, causal, kind = {
        "causal_gqa": (1, 8, 2, 512, 128, True, "arange"),
        "packed_restart": (2, 4, 2, 320, 128, True, "packed"),
        "non_causal_tail": (2, 4, 4, 200, 128, False, "offset"),
        "d256": (1, 4, 2, 256, 256, True, "offset"),
        "d64": (2, 4, 1, 256, 64, True, "packed"),
    }[case]
    dev = torch.device("cuda")
    q, k, v, do = chip_smoke.flash_inputs(torch, dev, b, h, h_kv, s, d, seed=s + d)
    pos, seg = _positions(kind, b, s)
    alibi = pf.alibi_operand(torch.from_numpy(PT.alibi_slopes(h)),
                             None if pos is None else torch.from_numpy(pos), b, h, s, dev)
    kw = dict(causal=causal, alibi=alibi,
              segment_ids=None if seg is None else torch.from_numpy(seg).to(dev))
    before = {n: pf.KERNELS[n].launches for n in chip_smoke.FLASH_ALIBI_KERNELS}
    out, lse = pf.flash_fwd_cuda(q, k, v, **kw)
    ref_out, ref_lse = pf.flash_fwd_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=BF16_ATOL, rtol=BF16_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=2e-5)
    dq = pf.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
    dk, dv = pf.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw)
    want = pf.flash_bwd_reference(q, k, v, out, do, lse, **kw)
    for got, w, what in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(got.float(), w.float(), atol=BF16_ATOL * scale,
                                   rtol=BF16_RTOL)
        chip_smoke.tile_rel_err(torch, what, got, w)
    assert {n: pf.KERNELS[n].launches - before[n] for n in before} == {
        n: 1 for n in chip_smoke.FLASH_ALIBI_KERNELS}
