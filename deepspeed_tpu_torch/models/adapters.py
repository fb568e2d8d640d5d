"""User-model adapters: a ``torch.nn.Module`` to the engine's
``loss_fn(params, batch[, rng])`` contract.

Counterpart of ``deepspeed_tpu/models/adapters.py``, which adapts a flax
module. The port's engine trains a loss function over a nested dict of
tensors, so a module is called through ``torch.func.functional_call``
with the engine's tensors in place of its own: pass
``dict(module.named_parameters())`` (detached copies, or the module's
own) as ``model_parameters`` and ``module_loss_fn(module)`` as ``model``.
"""

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F


def _default_loss(outputs: torch.Tensor, batch: dict) -> torch.Tensor:
    """The loss when the user gives none (the JAX package's ``_default_loss``):
    * [b, s, vocab] outputs and integer 'labels' -> next-token cross-entropy
      (shifted as HF causal-LM heads shift; label -100 is ignored, and an
      optional 'loss_mask' in the batch also masks positions)
    * 'labels'/'y' of the outputs' shape -> MSE
    """
    labels = batch.get("labels", batch.get("y"))
    if labels is None:
        raise ValueError(
            "default loss needs 'labels' (or 'y') in the batch; pass loss=... for custom objectives"
        )
    labels = torch.as_tensor(labels, device=outputs.device)
    if outputs.dim() == 3 and not labels.is_floating_point():
        logits = outputs[:, :-1].float()
        targets = labels[:, 1:]
        mask = (targets != -100).float()
        if "loss_mask" in batch:
            mask = mask * torch.as_tensor(batch["loss_mask"], device=outputs.device)[:, 1:].float()
        safe = targets.clamp_min(0).long()
        ll = F.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
        return (-ll * mask).sum() / mask.sum().clamp_min(1.0)
    return (outputs.float() - labels.float()).square().mean()


def module_loss_fn(
    module: torch.nn.Module,
    loss: Optional[Callable[[torch.Tensor, dict], torch.Tensor]] = None,
    inputs_key: str = "inputs",
    train: Optional[bool] = None,
):
    """Adapt an ``nn.Module`` to the engine contract.

    module:     the module; its parameters and buffers are replaced, per call,
                by the tensors the engine passes (names as in
                ``named_parameters``)
    loss:       ``loss(outputs, batch) -> scalar`` (default: causal-LM CE for
                [b, s, vocab] integer labels, MSE otherwise)
    inputs_key: batch key holding the module's positional input (falls back
                to 'input_ids' then 'x')
    train:      ``module.train(train)`` before each call (dropout etc.);
                None leaves the module's mode as it is
    """
    loss = loss or _default_loss

    def _inputs(batch):
        for k in (inputs_key, "input_ids", "x"):
            if k in batch:
                return batch[k]
        raise KeyError(f"none of ({inputs_key!r}, 'input_ids', 'x') found in batch")

    def loss_fn(params: Any, batch: dict):
        if train is not None:
            module.train(train)
        outputs = torch.func.functional_call(module, params, (_inputs(batch),))
        if isinstance(outputs, tuple):
            outputs = outputs[0]
        if hasattr(outputs, "logits"):  # HF model outputs
            outputs = outputs.logits
        return loss(outputs, batch)

    return loss_fn


__all__ = ["module_loss_fn"]
