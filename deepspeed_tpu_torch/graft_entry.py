"""A forward step of the model family, for a quick compile-and-run check.

Counterpart of the JAX package's ``__graft_entry__.entry()``: the ``tiny``
preset at 2 layers, seeded random params and ``[2, 128]`` tokens from
``np.random.default_rng(0)``, on the card unless ``device="cpu"``. The
preset's 4 heads of 32 become 2 heads of 64 (``ENTRY_OVERRIDES``): the
card's flash kernels take head dims 64, 128 and 256 (ROADMAP queue 2, item
1), and the widths (hidden 128, vocab 512) stay the preset's.

    fn, (params, tokens) = entry()
    logits = fn(params, tokens)        # [2, 128, vocab]
"""

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import forward, get_config, init_params


ENTRY_OVERRIDES = dict(n_layers=2, max_seq_len=256, n_heads=2)


def entry(device="cuda", dtype: str = "bfloat16"):
    """Returns (fn, (params, tokens)): ``fn(params, tokens) -> logits``
    through ``forward`` (the kernels on a card); ``fn.config`` is the
    model's config."""
    cfg = get_config("tiny", dtype=dtype, **ENTRY_OVERRIDES)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 128)), dtype=torch.int32,
        device=device)

    def fn(params, tokens):
        logits, _aux = forward(params, tokens, cfg)
        return logits

    fn.config = cfg
    return fn, (params, tokens)


__all__ = ["entry"]
