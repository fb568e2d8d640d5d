"""OptimizedLinear / LoRA in the port against the JAX package, on the CPU.

Mirrors the LoRA half of ``tests/unit/test_compression.py``. The same
numpy-seeded base, adapters and inputs go through both packages'
``optimized_linear`` and ``merge_lora`` in fp32 (sums in another order:
1e-5); the int8 base's payload and scales equal JAX's
``quantize_blockwise`` under ``jit`` bit for bit (the port's block
quantizer follows XLA's compiled form of ``absmax / qmax``), and so does
its dequantized weight. Gradients reach the adapters only, equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import linear as jl
from deepspeed_tpu_torch import linear as pl


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = ATOL = 1e-5
LORA = dict(lora_r=4, lora_alpha=8.0)


def _inputs(seed, in_f=64, out_f=48, r=4):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(in_f, out_f)) * 0.1).astype(np.float32),
            "a": (rng.normal(size=(in_f, r)) * in_f ** -0.5).astype(np.float32),
            "b": (rng.normal(size=(r, out_f)) * 0.1).astype(np.float32),
            "x": rng.normal(size=(3, 5, in_f)).astype(np.float32)}


def _pair(v, quant):
    """Both packages' params over the same base and adapters."""
    in_f, out_f = v["w"].shape
    jq = jl.QuantizationConfig(q_bits=8, group_size=128) if quant else None
    pq = pl.QuantizationConfig(q_bits=8, group_size=128) if quant else None
    jp = jax.jit(lambda w: jl.init_optimized_linear(
        jax.random.key(0), in_f, out_f, jl.LoRAConfig(**LORA), jq, base_weight=w))(
        jnp.asarray(v["w"]))
    tp = pl.init_optimized_linear(torch.Generator().manual_seed(0), in_f, out_f,
                                  pl.LoRAConfig(**LORA), pq, base_weight=torch.from_numpy(v["w"]))
    jp = dict(jp, lora_a=jnp.asarray(v["a"]), lora_b=jnp.asarray(v["b"]))
    tp = dict(tp, lora_a=torch.from_numpy(v["a"]), lora_b=torch.from_numpy(v["b"]))
    return jp, tp, jq, pq


@pytest.mark.parametrize("quant", [False, True])
def test_forward_merge_and_base_equal_jax(quant):
    v = _inputs(int(quant))
    jp, tp, jq, pq = _pair(v, quant)
    if quant:
        assert tp["base"]["values"].dtype == torch.int8
        np.testing.assert_array_equal(tp["base"]["values"].numpy(), np.asarray(jp["base"]["values"]))
        np.testing.assert_array_equal(tp["base"]["scales"].numpy(), np.asarray(jp["base"]["scales"]))
    else:
        np.testing.assert_array_equal(tp["base"]["weight"].numpy(), v["w"])
    y = pl.optimized_linear(tp, torch.from_numpy(v["x"]), pl.LoRAConfig(**LORA), pq)
    want = jl.optimized_linear(jp, jnp.asarray(v["x"]), jl.LoRAConfig(**LORA), jq)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    merged = pl.merge_lora(tp, pl.LoRAConfig(**LORA), pq)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jl.merge_lora(jp, jl.LoRAConfig(**LORA), jq)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose((torch.from_numpy(v["x"]) @ merged).numpy(), y.numpy(),
                               rtol=RTOL, atol=ATOL)
    # the int8 base is close to the wide one (the JAX suite's bound)
    np.testing.assert_allclose(y.numpy(), pl.optimized_linear(
        dict(tp, base={"weight": torch.from_numpy(v["w"])}), torch.from_numpy(v["x"]),
        pl.LoRAConfig(**LORA)).numpy(), atol=0.05)


@pytest.mark.parametrize("quant", [False, True])
def test_gradients_reach_only_the_adapters_and_equal_jax(quant):
    v = _inputs(2 + int(quant))
    jp, tp, jq, pq = _pair(v, quant)
    g = np.random.default_rng(9).normal(size=(3, 5, v["w"].shape[1])).astype(np.float32)

    def jloss(adapters):
        p = dict(jp, **adapters)
        return jnp.sum(jl.optimized_linear(p, jnp.asarray(v["x"]), jl.LoRAConfig(**LORA), jq)
                       * jnp.asarray(g))

    jg = jax.grad(jloss)({"lora_a": jp["lora_a"], "lora_b": jp["lora_b"]})
    tp = {"base": {k: t.clone().requires_grad_(t.is_floating_point())
                   for k, t in tp["base"].items()},
          "lora_a": tp["lora_a"].clone().requires_grad_(True),
          "lora_b": tp["lora_b"].clone().requires_grad_(True)}
    out = pl.optimized_linear(tp, torch.from_numpy(v["x"]), pl.LoRAConfig(**LORA), pq)
    (out * torch.from_numpy(g)).sum().backward()
    for name in ("lora_a", "lora_b"):
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(jg[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for t in tp["base"].values():
        assert t.grad is None  # frozen: detached before the product
    mask = pl.lora_trainable_mask(tp)
    assert mask["lora_a"] is True and mask["lora_b"] is True
    assert all(m is False for m in mask["base"].values())
    assert mask == jax.tree.map(bool, jl.lora_trainable_mask(jp))


def test_init_draws_and_adapters_start_as_identity():
    g = torch.Generator().manual_seed(3)
    p = pl.init_optimized_linear(g, 32, 16, pl.LoRAConfig(lora_r=8))
    assert p["lora_a"].shape == (32, 8) and not p["lora_b"].any()
    assert abs(float(p["base"]["weight"].std()) - 32 ** -0.5) < 0.05
    x = torch.ones(4, 32)
    np.testing.assert_allclose(pl.optimized_linear(p, x, pl.LoRAConfig(lora_r=8)).numpy(),
                               (x @ p["base"]["weight"]).numpy(), atol=1e-6)
    q = pl.init_optimized_linear(torch.Generator().manual_seed(3), 32, 16,
                                 pl.LoRAConfig(lora_r=8), pl.QuantizationConfig(group_size=64),
                                 dtype=torch.bfloat16)
    assert q["base"]["values"].dtype == torch.int8 and q["lora_a"].dtype == torch.bfloat16
    assert q["base"]["scales"].numel() == 32 * 16 // 64
