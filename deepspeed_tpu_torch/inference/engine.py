"""Inference engine v1 (reference ``InferenceEngine`` inference/engine.py:40).

Counterpart of ``deepspeed_tpu/inference/engine.py``, eager PyTorch:

  * ``forward`` is the model's forward (the flash and RMSNorm kernels on a
    card);
  * ``generate`` prefills the batch's prompts, padded to a bucket, into a
    contiguous KV cache (``models.transformer.init_kv_cache``) sized to the
    prompt, the new tokens and a fused round's overshoot, then decodes one
    token per step (``decode_step``), or ``decode_steps`` tokens per round
    with the sampled token fed back on the device and one host copy per
    round. The cached decode attends with a dense bias, which the flash
    kernels do not take, so it calls ``mha_reference`` on a card too (the
    JAX package's auto rule sends such a call to its reference); its norms
    are the RMSNorm kernel;
  * draws: ``sampling.sample_step``, keyed by (seed, absolute decode step,
    row), so a fused round draws what the per-step loop draws. Sampled
    streams agree within the port, not with the JAX package's threefry
    draws (ROADMAP queue 1, item 4); greedy streams agree with it.

The engine runs on ``device`` ("cuda" unless the caller passes "cpu") and
raises when asked for a card that is not there. ``quant.enabled`` stores
the matmul weights int8 / int4 (``inference/quantization``), quantized
after the dtype cast; each layer widens as it runs. Tensor parallelism
raises ``NotImplementedError`` naming its ROADMAP item (with ``quant`` too,
which the JAX package refuses with tensor parallelism).
"""

from typing import Any, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.sampling import sample_step
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.utils.logging import log_dist


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def _later(what: str, item: str):
    return NotImplementedError(f"InferenceEngine: {what} is not ported yet ({item})")


class InferenceEngine:
    """Generate-capable wrapper around a model config and its parameters.

    model: a TransformerConfig (params passed separately) or a tuple
    (config, params)."""

    def __init__(self, model, config: DeepSpeedInferenceConfig, params: Any = None,
                 topology=None, cast_params: bool = True, device="cuda"):
        if isinstance(model, tuple):
            self.model_config, params = model
        else:
            self.model_config = model
        if params is None:
            raise ValueError("InferenceEngine needs model params")
        self._config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InferenceEngine: no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"InferenceEngine: device {device!r} (expected cuda or cpu)")
        tp = config.tensor_parallel.tp_size if config.tensor_parallel else 1
        if tp > 1 or (topology is not None and topology.model_parallel_size > 1):
            if getattr(config, "quant", None) is not None and config.quant.enabled:
                # as the JAX engine: its placement specs describe the wide tree
                raise NotImplementedError(
                    "quantized inference with tensor parallelism is unsupported")
            raise _later("tensor_parallel.tp_size > 1", "ROADMAP queue 1, item 6: multi-GPU")
        dtype = T.DTYPES.get(config.dtype, torch.bfloat16)

        def place(tree):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k] = place(v)
                    continue
                v = torch.as_tensor(v)
                dt = dtype if (cast_params and v.is_floating_point()) else v.dtype
                out[k] = v.to(device=self.device, dtype=dt)
            return out

        self.params = place(params)
        if getattr(config, "quant", None) is not None and config.quant.enabled:
            from deepspeed_tpu_torch.inference.quantization import quantize_inference_params

            self.params = quantize_inference_params(self.params, bits=config.quant.bits,
                                                    group_size=config.quant.group_size)
        self._mc = self.model_config
        self._decode_steps = int(getattr(config, "decode_steps", 1) or 1)
        log_dist(f"InferenceEngine: dtype={config.dtype} max_tokens={config.max_tokens} "
                 f"device={self.device}", ranks=[0])

    # -- reference API surface ------------------------------------------------
    def forward(self, tokens):
        """Plain forward -> logits (reference engine.forward :556)."""
        with torch.no_grad():
            toks = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
            return T.forward(self.params, toks, self._mc)[0]

    __call__ = forward

    @property
    def module(self):
        return self._mc

    def _decode(self, cur, caches, pos: int):
        """One cached decode step of the batch's tokens cur [b, 1] at
        position ``pos``: (last logits [b, vocab] fp32, caches)."""
        b = cur.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=self.device)
        logits, caches = T.decode_step(self.params, cur, self._mc, caches, positions)
        return logits[:, -1].float(), caches

    def _multi_decode(self, cur, caches, pos0: int, i0: int, seed: int, temperature, greedy):
        """A round of ``decode_steps`` decode iterations, the sampled token fed
        back on the device: the draw after step i0 + i is keyed by that
        absolute index, so the tokens equal the per-step loop's. Returns
        (tokens [k, b] on the device, caches)."""
        b = cur.shape[0]
        out = []
        for i in range(self._decode_steps):
            logits, caches = self._decode(cur, caches, pos0 + i)
            nxt = sample_step(logits, seed, i0 + i, temperature, greedy)
            out.append(nxt)
            cur = nxt.reshape(b, 1)
        return torch.stack(out), caches

    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None, greedy: Optional[bool] = None,
                 eos_token_id: Optional[int] = None, seed: int = 0):
        """Batched autoregressive generation (reference generate :585).

        input_ids: [b, s] (equal-length prompts; [s] is one row). Returns
        np.ndarray [b, s + new]; after a row's EOS its further tokens are
        EOS."""
        mc = self._mc
        cfg = self._config
        max_new = max_new_tokens or cfg.max_out_tokens
        temperature = cfg.temperature if temperature is None else temperature
        greedy = cfg.greedy if greedy is None else greedy
        greedy = bool(greedy)

        toks = np.asarray(input_ids, np.int32)
        if toks.ndim == 1:
            toks = toks[None]
        b, s = toks.shape
        total = s + max_new
        if total > cfg.max_tokens:
            raise ValueError(
                f"prompt {s} + max_new {max_new} exceeds max_tokens {cfg.max_tokens} "
                "(reference engine guard)"
            )
        # fused rounds run in whole multiples of decode_steps: when k does
        # not divide max_new - 1 the final round writes K/V for its
        # overshoot tokens, so the cache holds real slots for them
        k = self._decode_steps
        overshoot = (k - ((max_new - 1) % k)) % k
        cache_len = _bucket(total + overshoot)
        caches = T.init_kv_cache(mc, b, cache_len, device=self.device)

        sb = _bucket(s)
        prompt = torch.as_tensor(np.pad(toks, ((0, 0), (0, sb - s))).astype(np.int64),
                                 device=self.device)
        positions = torch.arange(sb, device=self.device)[None].expand(b, sb)
        with torch.no_grad():
            logits, caches = T.decode_step(self.params, prompt, mc, caches, positions)
            cur = sample_step(logits[:, s - 1].float(), seed, -1, temperature, greedy)
            # the padded positions [s, sb) were written but stay masked; the
            # fill restarts at s so decode overwrites them
            caches = (caches[0], caches[1], torch.full_like(caches[2], s))

            out = [toks]
            done = np.zeros((b,), bool)

            def emit(tok_np):
                """EOS masking and bookkeeping for one generated column."""
                nonlocal done
                if eos_token_id is not None:
                    tok_np = np.where(done[:, None], eos_token_id, tok_np)
                    done |= tok_np[:, 0] == eos_token_id
                out.append(tok_np)
                return tok_np

            cur_np = emit(cur.cpu().numpy().reshape(b, 1).astype(np.int32))
            i = 0  # decode steps completed
            n_decode = max_new - 1
            while i < n_decode and not (eos_token_id is not None and done.all()):
                cur_d = torch.as_tensor(cur_np.astype(np.int64), device=self.device)
                # a round of k decode steps: one host copy per k tokens (k = 1
                # is the per-step loop); a round past max_new or EOS
                # overshoots and its extra columns are not emitted
                toks_out, caches = self._multi_decode(cur_d, caches, s + i, i, seed,
                                                      temperature, greedy)
                for row in toks_out.cpu().numpy():  # [k, b]
                    if i >= n_decode or (eos_token_id is not None and done.all()):
                        break
                    cur_np = emit(row.reshape(b, 1).astype(np.int32))
                    i += 1
        return np.concatenate(out, axis=1)
