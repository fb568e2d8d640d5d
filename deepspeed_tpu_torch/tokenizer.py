"""Tokenizer loading for HF checkpoint directories, in the port.

Copy of ``deepspeed_tpu/tokenizer.py`` for the ``generate`` command of
``inference/cli.py``: read ``tokenizer.json`` (the fast-tokenizer format
every modern release ships) from the model directory through the
``tokenizers`` runtime, which is imported only when a tokenizer is built;
no network, no ``transformers``.

SentencePiece-only checkpoints (``tokenizer.model`` without a
``tokenizer.json``) are rejected with a clear message — the environment
has no sentencepiece runtime; re-export the tokenizer with
``AutoTokenizer(...).save_pretrained`` (writes tokenizer.json) first.
"""

import json
import os
from typing import Sequence

import numpy as np


class HFTokenizer:
    """Thin wrapper: encode/decode + special-token ids from the model dir."""

    def __init__(self, model_dir: str):
        tok_path = os.path.join(model_dir, "tokenizer.json")
        if not os.path.isfile(tok_path):
            if os.path.isfile(os.path.join(model_dir, "tokenizer.model")):
                raise FileNotFoundError(
                    f"{model_dir} ships only a sentencepiece tokenizer.model; "
                    "this environment has no sentencepiece runtime — save the "
                    "fast-tokenizer form (tokenizer.json) into the dir first"
                )
            raise FileNotFoundError(f"no tokenizer.json under {model_dir}")
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(tok_path)
        self.bos_token_id = None
        self.eos_token_id = None
        self._read_special_ids(model_dir)

    def _read_special_ids(self, model_dir: str):
        """bos/eos resolution order: generation_config.json, config.json,
        tokenizer_config.json token strings mapped through the vocab."""
        for fname, bos_key, eos_key in (
            ("generation_config.json", "bos_token_id", "eos_token_id"),
            ("config.json", "bos_token_id", "eos_token_id"),
        ):
            path = os.path.join(model_dir, fname)
            if not os.path.isfile(path):
                continue
            cfg = json.load(open(path))
            if self.bos_token_id is None and cfg.get(bos_key) is not None:
                self.bos_token_id = int(
                    cfg[bos_key][0] if isinstance(cfg[bos_key], list) else cfg[bos_key]
                )
            if self.eos_token_id is None and cfg.get(eos_key) is not None:
                self.eos_token_id = int(
                    cfg[eos_key][0] if isinstance(cfg[eos_key], list) else cfg[eos_key]
                )
        tc_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.isfile(tc_path) and (self.bos_token_id is None or self.eos_token_id is None):
            tc = json.load(open(tc_path))

            def to_id(entry):
                if entry is None:
                    return None
                s = entry["content"] if isinstance(entry, dict) else str(entry)
                return self._tok.token_to_id(s)

            if self.bos_token_id is None:
                self.bos_token_id = to_id(tc.get("bos_token"))
            if self.eos_token_id is None:
                self.eos_token_id = to_id(tc.get("eos_token"))

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        ids = self._tok.encode(text).ids
        if add_bos and self.bos_token_id is not None and (
            not ids or ids[0] != self.bos_token_id
        ):
            ids = [self.bos_token_id] + ids
        return np.asarray(ids, np.int32)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=skip_special_tokens)


def load_tokenizer(model_dir: str) -> HFTokenizer:
    return HFTokenizer(model_dir)
