"""Flash attention of the PyTorch port against the JAX package's Pallas bodies.

The same inputs, made from a seed with numpy, go through the port's plain
forward and backward (``flash_fwd_reference``/``flash_bwd_reference``, the
versions the CUDA kernels are held to on the card), through the port's
autograd ``flash_attention`` on CPU tensors, and through the JAX package's
``flash_attention(..., interpret=True)`` and its ``jax.vjp``, as
``tests/unit/ops/test_flash_attention.py`` runs them. The JAX side's LSE
comes from ``_flash_call``, the forward ``pallas_call`` itself.
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
from deepspeed_tpu.ops.attention import flash_pallas as jf  # noqa: E402
from deepspeed_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from deepspeed_tpu_torch.ops.attention import core as pcore  # noqa: E402
from deepspeed_tpu_torch.ops.attention import flash as pf  # noqa: E402

# fp32 on both sides: the same products, summed in another order (the
# Pallas body streams kv blocks with an online max; the plain version
# takes one softmax over the row)
FP32_ATOL = FP32_RTOL = 1e-5
# bf16 inputs: both round p (and ds) to bf16 before their products, but
# the Pallas body rounds p against its running max and the plain version
# against the row max, and the outputs round once to bf16 (2^-8 relative)
BF16_ATOL = BF16_RTOL = 2.0 ** -6


def _inputs(b, h, h_kv, s, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=sh).astype(np.float32)
                   for sh in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d), (b, h, s, d)))
    if dtype != np.float32:
        q, k, v, do = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v, do))
    return q, k, v, do


def _packed(b, s, n_seg, seed):
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(16, s - 16), n_seg - 1, replace=False))
        for j, c in enumerate(cuts):
            seg[i, c:] = j + 1
    return seg


def _jax(q, k, v, do, causal, seg, window, flag):
    """(out, lse, dq, dk, dv) from the Pallas bodies in interpret mode."""
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jseg = None if seg is None else jnp.asarray(seg)
    wflag = None
    if window and flag is not None:
        wflag = jnp.broadcast_to(jnp.asarray(flag, jnp.int32).reshape(1, 1), (1, jf.LANES))
    _, lse = jf._flash_call(jq, jk, jv, jseg, None, wflag, causal, None, window, True)

    def f(q_, k_, v_):
        return jf.flash_attention(q_, k_, v_, causal, jseg, None, True, window=window,
                                  window_flag=flag)

    out, vjp = jax.vjp(f, jq, jk, jv)
    dq, dk, dv = vjp(jdo)
    return tuple(np.asarray(a).astype(np.float32) for a in (out, lse[..., 0], dq, dk, dv))


def _np(t):
    return t.detach().float().numpy()


CASES = {
    # name: (b, h, h_kv, causal, n_seg, window, flag)
    "causal": (2, 4, 4, True, 0, 0, None),
    "non_causal": (1, 4, 4, False, 0, 0, None),
    "gqa_4_2": (2, 4, 2, True, 0, 0, None),
    "segments_causal": (2, 4, 2, True, 3, 0, None),
    "segments_non_causal": (1, 4, 4, False, 2, 0, None),
    "static_window": (1, 4, 2, True, 0, 100, None),
    "window_flag_1": (1, 4, 2, True, 0, 100, 1),
    "window_flag_0": (1, 4, 2, True, 0, 100, 0),
    "window_segments": (2, 4, 2, True, 2, 60, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp32_matches_pallas_bodies(name, monkeypatch):
    """Plain fwd (out and LSE), plain bwd, and the autograd Function on
    CPU tensors, each against the interpret-mode Pallas bodies. 128-row
    blocks give the Pallas grid two kv blocks at s = 256, so its clamped
    index maps, pruning and carried softmax state all run."""
    monkeypatch.setenv("DSTPU_FLASH_BLOCK", "128")
    b, h, h_kv, causal, n_seg, window, flag = CASES[name]
    s, d = 256, 64
    q, k, v, do = _inputs(b, h, h_kv, s, d, seed=len(name))
    seg = _packed(b, s, n_seg, seed=b) if n_seg else None
    want = _jax(q, k, v, do, causal, seg, window, flag)

    t = params_from_numpy({"q": q, "k": k, "v": v, "do": do})
    tseg = None if seg is None else torch.from_numpy(seg)
    kw = dict(causal=causal, segment_ids=tseg, window=window, window_flag=flag)
    out, lse = pf.flash_fwd_reference(t["q"], t["k"], t["v"], **kw)
    grads = pf.flash_bwd_reference(t["q"], t["k"], t["v"], out, t["do"], lse, **kw)
    for got, w, what in zip((out, lse) + grads, want, ("out", "lse", "dq", "dk", "dv")):
        np.testing.assert_allclose(_np(got), w, atol=FP32_ATOL, rtol=FP32_RTOL, err_msg=what)

    leaves = [t[n].clone().requires_grad_(True) for n in ("q", "k", "v")]
    out2 = pf.flash_attention(*leaves, **kw)
    out2.backward(t["do"])
    np.testing.assert_allclose(_np(out2), want[0], atol=FP32_ATOL, rtol=FP32_RTOL)
    for leaf, w, what in zip(leaves, want[2:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(leaf.grad), w, atol=FP32_ATOL, rtol=FP32_RTOL,
                                   err_msg=what)


@pytest.mark.parametrize("name", ["gqa_4_2", "window_segments"])
def test_bf16_matches_pallas_bodies(name, monkeypatch):
    monkeypatch.setenv("DSTPU_FLASH_BLOCK", "128")
    b, h, h_kv, causal, n_seg, window, flag = CASES[name]
    q, k, v, do = _inputs(b, h, h_kv, 256, 64, seed=5, dtype="bf16")
    seg = _packed(b, 256, n_seg, seed=3) if n_seg else None
    want = _jax(q, k, v, do, causal, seg, window, flag)
    t = params_from_numpy({"q": q, "k": k, "v": v, "do": do})
    kw = dict(causal=causal, segment_ids=None if seg is None else torch.from_numpy(seg),
              window=window, window_flag=flag)
    out, lse = pf.flash_fwd_reference(t["q"], t["k"], t["v"], **kw)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = pf.flash_bwd_reference(t["q"], t["k"], t["v"], out, t["do"], lse, **kw)
    np.testing.assert_allclose(_np(lse), want[1], atol=FP32_ATOL * 10, rtol=FP32_RTOL * 10)
    for got, w, what in zip((out,) + grads, want[:1] + want[2:], ("out", "dq", "dk", "dv")):
        # dk/dv sum bf16-rounded per-head partials on the Pallas side: a few
        # bf16 units of the largest element
        atol = BF16_ATOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_np(got), w, atol=atol, rtol=BF16_RTOL, err_msg=what)


def test_window_requires_causal():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="requires causal"):
        pf.flash_fwd_reference(q, q, q, causal=False, window=4)


def test_attention_dispatch_on_cpu():
    """On a CPU tensor "auto" is the reference (as the JAX package's auto
    off the TPU), "flash" the Function's plain versions; both agree."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 64, 64, seed=1))
    seg = torch.from_numpy(_packed(1, 64, 2, seed=2))
    ref = pcore.attention(q, k, v, segment_ids=seg, window=20, impl="reference")
    for impl in (None, "auto", "flash"):
        got = pcore.attention(q, k, v, segment_ids=seg, window=20, impl=impl)
        torch.testing.assert_close(got, ref, atol=FP32_ATOL, rtol=FP32_RTOL)
    # "splash" is ported: over the (causal, window) pair's block schedule it
    # is the same function; a schedule with "reference" is ignored, as in JAX
    for kw in ({"impl": "splash"}, {"impl": "reference", "schedule": object()}):
        got = pcore.attention(q, k, v, segment_ids=seg, window=20, **kw)
        torch.testing.assert_close(got, ref, atol=FP32_ATOL, rtol=FP32_RTOL)
    # "flash_ring" is ported: with no context axis it is the flash call;
    # what the ring cannot do raises
    got = pcore.attention(q, k, v, segment_ids=seg, impl="flash_ring")
    torch.testing.assert_close(got, pcore.attention(q, k, v, segment_ids=seg, impl="reference"),
                               atol=FP32_ATOL, rtol=FP32_RTOL)
    for kw, match in (({"impl": "flash_ring", "causal": False}, "causal=False"),
                      ({"impl": "flash_ring", "alibi_slopes": torch.ones(4)}, "ALiBi"),
                      ({"impl": "flash", "bias": torch.zeros(1, 4, 64, 64)}, "bias")):
        with pytest.raises(NotImplementedError, match=match):
            pcore.attention(q, k, v, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal_gqa", "window_flag_0", "window_flag_1", "segments",
                                  "non_causal_tail", "d256", "d64"])
def test_cuda_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    b, h, h_kv, s, d, causal, window, flag, n_seg = {
        "causal_gqa": (1, 8, 2, 512, 128, True, 0, None, 0),
        "window_flag_0": (1, 4, 2, 384, 128, True, 96, 0, 0),
        "window_flag_1": (1, 4, 2, 384, 128, True, 96, 1, 0),
        "segments": (2, 4, 2, 320, 128, True, 0, None, 3),
        "non_causal_tail": (1, 4, 4, 200, 128, False, 0, None, 0),
        "d256": (1, 4, 2, 256, 256, True, 64, None, 0),
        "d64": (2, 4, 1, 256, 64, True, 0, None, 2),
    }[case]
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, h_kv, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, h_kv, s, d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    seg = torch.from_numpy(_packed(b, s, n_seg, seed=1)).cuda() if n_seg else None
    kw = dict(causal=causal, segment_ids=seg, window=window, window_flag=flag)
    out, lse = pf.flash_fwd_cuda(q, k, v, **kw)
    ref_out, ref_lse = pf.flash_fwd_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=BF16_ATOL, rtol=BF16_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    dq = pf.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
    dk, dv = pf.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw)
    want = pf.flash_bwd_reference(q, k, v, out, do, lse, **kw)
    for got, w, what in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(got.float(), w.float(), atol=BF16_ATOL * scale,
                                   rtol=BF16_RTOL)
        # the max-scaled atol is loose for the small late rows: each 64-row
        # tile is also held to its own relative Frobenius error
        chip_smoke.tile_rel_err(torch, what, got, w)


@pytest.mark.cuda
def test_cuda_kernels_launch_from_a_fresh_thread():
    """The flash kernels launched first on this thread, then from a new
    thread that has made no CUDA call yet (as PyTorch's autograd thread is
    when a flash backward is its first work): the TMA maps need a current
    context there, and every launch gives the main thread's bits."""
    import threading

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, do = (torch.randn(1, 8, 512, 128, generator=gen, device="cuda").bfloat16() for _ in "qd")
    k, v = (torch.randn(1, 2, 512, 128, generator=gen, device="cuda").bfloat16() for _ in "kv")

    def run():
        out, lse = pf.flash_fwd_cuda(q, k, v)
        dq = pf.flash_bwd_dq_cuda(q, k, v, out, do, lse)
        dk, dv = pf.flash_bwd_dkv_cuda(q, k, v, out, do, lse)
        carry = pf.flash_fwd_chunk_cuda(q, k, v)
        dq_acc = pf.flash_dq_chunk_cuda(q, k, v, out, do, lse)
        dkv_acc = pf.flash_dkv_chunk_cuda(q, k, v, out, do, lse)
        torch.cuda.synchronize()
        return (out, lse, dq, dk, dv, *carry, dq_acc, *dkv_acc)

    main = run()
    got = []
    th = threading.Thread(target=lambda: got.append(run()))
    th.start()
    th.join()
    assert len(got) == 1, "a launch from the new thread raised"
    assert all(torch.equal(a, b) for a, b in zip(main, got[0]))
    # and through autograd, whose backward runs on the device's own thread
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(pf.flash_attention(*leaves), leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(grads, main[2:5]))
