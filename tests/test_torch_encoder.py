"""BERT's encoder heads in the PyTorch port against the JAX package.

A BERT-shaped tiny model (``models/hf.py``'s BERT mapping at small widths:
post-norm, bidirectional attention, learned positions, exact GELU, two
token types, the embedding LayerNorm, no final norm, the masked-LM head
over tied embeddings) on identical weights in both packages: logits with
token types, the MLM loss and every leaf's gradient, the leaves through
``params_from_numpy``, and the engine's ``train_batch`` trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime.optimizers import _leaves


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and tiny models gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

BERT = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, max_seq_len=64,
            remat=False, dtype="float32", position="learned", norm="layernorm",
            activation="gelu_exact", attn_causal=False, norm_scheme="post", type_vocab_size=2,
            final_norm=False, mlm_head=True, tie_embeddings=True, attn_qkv_bias=True,
            attn_out_bias=True, mlp_bias=True, embed_norm=True, norm_eps=1e-12)
# fp32 on both sides: the same function summed in another order
ATOL = RTOL = 2e-5


def _bert(**over):
    kw = dict(BERT, **over)
    jc, pc = JT.TransformerConfig(**kw), PT.TransformerConfig(**kw)
    jp = JT.init_params(jc, jax.random.key(0))
    # non-zero biases, norm offsets and type embeddings: every leaf moves
    jp = jax.tree.map(lambda a: a + 0.01 * jnp.cos(jnp.arange(a.size, dtype=a.dtype)
                                                   ).reshape(a.shape), jp)
    return jc, pc, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _mlm_batch(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.3).astype(np.float32)
    return {"input_ids": toks, "labels": toks, "loss_mask": mask}


def test_leaves_cross_with_params_from_numpy():
    """type_embed and the mlm_* leaves move over as they are, the same
    leaves and shapes as the port's own init_params."""
    jc, pc, jp, tp = _bert()
    own = dict(_leaves(PT.init_params(pc, torch.Generator().manual_seed(0), "cpu")))
    moved = dict(_leaves(tp))
    assert {k: tuple(v.shape) for k, v in moved.items()} == {
        k: tuple(v.shape) for k, v in own.items()}
    for name in ("type_embed", "mlm_dense", "mlm_dense_b", "mlm_norm", "mlm_norm_b", "mlm_bias"):
        assert name in moved
    for name, leaf in _leaves(jax.tree.map(np.asarray, jp)):
        np.testing.assert_array_equal(moved[name].numpy(), leaf)


@pytest.mark.parametrize("types", ["default", "given"])
def test_logits_with_token_types_match_jax(types):
    jc, pc, jp, tp = _bert()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, size=(2, 24)).astype(np.int32)
    tt = None if types == "default" else rng.integers(0, 2, size=(2, 24)).astype(np.int32)
    want = np.asarray(JT.forward(jp, jnp.asarray(toks), jc,
                                 token_type_ids=None if tt is None else jnp.asarray(tt))[0])
    ptt = None if tt is None else torch.from_numpy(tt)
    for fn in (PT.forward, PT.forward_reference):
        got = fn(tp, torch.from_numpy(toks), pc, token_type_ids=ptt)[0]
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=ATOL)
    if tt is not None:  # control: the types move the logits
        zero = PT.forward(tp, torch.from_numpy(toks), pc)[0].detach().numpy()
        assert np.abs(zero - want).max() > 1e-3


@pytest.mark.parametrize("attention_impl", ["auto", "flash"])
def test_mlm_loss_and_grads_match_jax(attention_impl):
    """The masked-LM loss (labels at the masked positions) and every
    leaf's gradient against jax.value_and_grad; "flash" runs the flash
    Function's non-causal plain versions. ``fused_ce`` and ``loss_tiles``
    do not apply to the MLM head (its transform is in no fused kernel):
    the loss is the dense one, as in the JAX package."""
    batch = _mlm_batch(3)
    jc, pc, jp, tp = _bert(attention_impl=attention_impl)
    jl, jg = jax.value_and_grad(JT.make_loss_fn(jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = dict(_leaves(jax.tree.map(np.asarray, jg)))
    for over in ({}, {"fused_ce": True}, {"loss_tiles": 2}):
        pc_over = PT.TransformerConfig(**dict(BERT, attention_impl=attention_impl, **over))
        tq = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
        loss = PT.make_loss_fn(pc_over)(tq, {k: torch.from_numpy(v) for k, v in batch.items()})
        leaves = dict(_leaves(tq))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        for name, g in zip(leaves, grads):
            np.testing.assert_allclose(g.numpy(), jg[name], atol=ATOL, rtol=ATOL,
                                       err_msg=f"{over} {name}")


def test_mlm_train_batch_matches_jax():
    """Three train_batch steps of both engines (AdamW, gradient
    accumulation 2) on the same MLM micro-batches: the same losses."""
    jc, pc, jp, tp = _bert()
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "gradient_clipping": 1.0}
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp, config=ds)
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=ds)
    for step in range(3):
        batch = _mlm_batch(10 + step, b=4)
        jl = je.train_batch(batch={k: jnp.asarray(v) for k, v in batch.items()})
        pl = pe.train_batch(batch={k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-4, err_msg=f"step {step}")
