"""The port's ``generate`` command and tokenizer against the JAX package's.

A real-format checkpoint directory (safetensors, ``config.json`` and a
``tokenizer.json`` trained with the local ``tokenizers`` runtime: the
fixture of ``tests/unit/test_generate_cli.py``) goes through both
packages' tokenizer and ``generate_main``: the same ids, specials and
text, and the same greedy tokens printed by the v1 and v2 engines (fp32,
on the CPU). The module entry ``python -m deepspeed_tpu_torch.inference.cli
generate`` prints them too, ``... serve`` answers ``/generate`` over HTTP
with them, and the forms the port does not run raise naming their ROADMAP
items.
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
    """``serve`` runs (test_module_entry_serves_the_jax_tokens); its
    cross-process forms build the router on the directory (the control
    plane bound by ``serve_main``, the remote wire's endpoint registered),
    and ``serve-agent`` builds its engine there and dials its ``--join``
    (nothing listens at port 1: the bounded dial's last refusal raises).
    Only tensor parallelism still raises, naming item 6."""
    from deepspeed_tpu_torch.serving import Router
    from deepspeed_tpu_torch.serving.resilience.retry import RetryPolicy

    path, _ = real_format_dir
    for argv in (["--model", path, "--num-decode-replicas", "2", "--control-port", "0"],
                 ["--model", path, "--num-prefill-workers", "1", "--kv-transport", "remote"]):
        front, _ = pcli.build_serving_stack(pcli.serve_parse_args(argv + ["--device", "cpu"]))
        try:
            assert isinstance(front, Router) and front.serve_control("127.0.0.1", 0)[1] > 0
        finally:
            front.shutdown(drain=False)
    args = pcli.serve_agent_parse_args(["--model", path, "--device", "cpu", "--join",
                                        "127.0.0.1:1", "--name", "a1"])
    core, _ = pcli.build_agent_core(args)
    assert core.name == "a1" and core.role == "decode"
    from deepspeed_tpu_torch.serving.cluster.agent import ReplicaAgent

    agent = ReplicaAgent(core, ("127.0.0.1", 1), name="a1",
                         dial_retry=RetryPolicy(attempts=2, backoff_s=0.01))
    try:
        with pytest.raises(OSError):
            agent.connect()
    finally:
        agent.close()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 6"):
        pcli.main(["generate", "--device", "cpu", "--tp", "2"] + _argv(path, "v1", "jugs"))
    assert pcli.generate_main(["--model", path, "--device", "cpu"]) == 2  # no prompt


def test_module_entry_serves_the_jax_tokens(real_format_dir):
    """``python -m deepspeed_tpu_torch.inference.cli serve --port 0``: the
    process prints its address, and ``/generate`` (tokens and text prompts)
    answers the JAX package's ``generate`` ids. The process is killed in a
    ``finally``; every read has a timeout."""
    import json
    import queue
    import re
    import threading
    import urllib.request

    path, _ = real_format_dir
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepspeed_tpu_torch.inference.cli", "serve", "--model", path,
         "--port", "0", "--device", "cpu", "--dtype", "float32", "--num-blocks", "32",
         "--max-context", "96", "--max-blocks-per-seq", "8", "--block-size", "16"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stderr],
                     daemon=True).start()
    try:
        base = None
        while base is None:
            line = lines.get(timeout=180)
            m = re.search(r"listening on (http://[0-9.]+:[0-9]+)", line)
            base = m.group(1) if m else None
        outs = []
        for body in ({"tokens": [1, 17, 45, 9], "max_new_tokens": 6, "ignore_eos": True},
                     {"prompt": "the quick brown fox", "max_new_tokens": 6,
                      "ignore_eos": True}):
            req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                outs.append(json.loads(r.read()))
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert [o["finish_reason"] for o in outs] == ["max_tokens"] * 2
    tok = jax_tokenizer(path)
    from deepspeed_tpu.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu.models import load_hf_model

    cfg, params = load_hf_model(path, dtype="float32")
    rc = RaggedInferenceEngineConfig.from_dict({
        "dtype": "float32", "kv_cache": {"block_size": 16, "num_blocks": 32,
                                         "max_blocks_per_seq": 8},
        "state_manager": {"max_tracked_sequences": 8, "max_ragged_batch_size": 1024,
                          "max_ragged_sequence_count": 8, "max_context": 96}})
    prompts = [[1, 17, 45, 9], list(tok.encode("the quick brown fox"))]
    want = InferenceEngineV2(cfg, params, rc).generate(prompts, max_new_tokens=6)
    for o, w, p in zip(outs, want, prompts):
        assert o["tokens"] == [int(t) for t in w[len(p):]]
    assert outs[1]["text"] == tok.decode(outs[1]["tokens"])
