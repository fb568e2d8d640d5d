"""The port's ``generate`` command and tokenizer against the JAX package's.

A real-format checkpoint directory (safetensors, ``config.json`` and a
``tokenizer.json`` trained with the local ``tokenizers`` runtime: the
fixture of ``tests/unit/test_generate_cli.py``) goes through both
packages' tokenizer and ``generate_main``: the same ids, specials and
text, and the same greedy tokens printed by the v1 and v2 engines (fp32,
on the CPU). The module entry ``python -m deepspeed_tpu_torch.inference.cli
generate`` prints them too, and the commands the port does not run raise
naming their ROADMAP items.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("transformers")

from deepspeed_tpu.inference import cli as jcli  # noqa: E402
from deepspeed_tpu.tokenizer import load_tokenizer as jax_tokenizer  # noqa: E402
from deepspeed_tpu_torch.inference import cli as pcli  # noqa: E402
from deepspeed_tpu_torch.tokenizer import load_tokenizer as port_tokenizer  # noqa: E402
from tests.unit.test_generate_cli import real_format_dir  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
TEXTS = ["the quick brown fox", "sphinx of black quartz judge my vow", "jugs", ""]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tokenizer_matches_jax(real_format_dir):
    path, _ = real_format_dir
    jt, pt = jax_tokenizer(path), port_tokenizer(path)
    assert (pt.bos_token_id, pt.eos_token_id, pt.vocab_size) == (
        jt.bos_token_id, jt.eos_token_id, jt.vocab_size) == (1, 2, jt.vocab_size)
    for text in TEXTS:
        for bos in (True, False):
            ids = pt.encode(text, add_bos=bos)
            assert ids.dtype == jt.encode(text, add_bos=bos).dtype
            assert ids.tolist() == jt.encode(text, add_bos=bos).tolist()
            for skip in (True, False):
                assert pt.decode(ids, skip_special_tokens=skip) == jt.decode(
                    ids, skip_special_tokens=skip)


def test_tokenizer_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        port_tokenizer(str(tmp_path))
    (tmp_path / "tokenizer.model").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="sentencepiece"):
        port_tokenizer(str(tmp_path))


def _argv(path, engine, prompt, n=8):
    return ["--model", path, "--prompt", prompt, "--max-new-tokens", str(n),
            "--dtype", "float32", "--no-eos", "--tokens-only", "--engine", engine]


@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_generate_prints_the_jax_tokens(real_format_dir, capsys, engine):
    """Greedy ids printed by the port equal the JAX package's, on two
    prompts of different lengths."""
    path, _ = real_format_dir
    for prompt in ("the quick brown fox", "sphinx of black quartz"):
        assert jcli.generate_main(_argv(path, engine, prompt)) == 0
        want = capsys.readouterr().out.split()
        assert pcli.main(["generate", "--device", "cpu"] + _argv(path, engine, prompt)) == 0
        got = capsys.readouterr().out.split()
        assert len(got) == 8 and got == want


def test_generate_text_and_eos_match_jax(real_format_dir, capsys):
    """Decoded text (eos honoured) for a batch of two prompts through v2."""
    path, _ = real_format_dir
    argv = ["--model", path, "--prompt", "the five boxing", "--prompt", "pack my box",
            "--max-new-tokens", "6", "--dtype", "float32", "--engine", "v2"]
    assert jcli.generate_main(argv) == 0
    want = capsys.readouterr().out
    assert pcli.generate_main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


def test_module_entry_runs_generate(real_format_dir):
    path, _ = real_format_dir
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.inference.cli", "generate", "--device",
         "cpu"] + _argv(path, "v1", "the quick brown fox", n=4),
        cwd=ROOT, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.strip().splitlines()[-1].split()) == 4  # logs go to stdout too


def test_unported_commands_raise(real_format_dir):
    path, _ = real_format_dir
    for cmd in ("serve", "serve-agent"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 5"):
            pcli.main([cmd, "--model", path])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 6"):
        pcli.main(["generate", "--device", "cpu", "--tp", "2"] + _argv(path, "v1", "jugs"))
    assert pcli.generate_main(["--model", path, "--device", "cpu"]) == 2  # no prompt
