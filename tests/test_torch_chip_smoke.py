"""``chip_smoke.py`` rehearsed on the CPU.

The script runs on a card; here its phases run at a tiny size with the
kernels' plain versions, so a wrong path, argument or shape shows up before
a run on the card. Without a card the script itself must exit non-zero and
print no result line.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from deepspeed_tpu_torch.ops import kernels as K  # noqa: E402


def _run_script(cwd):
    # no visible card, whatever the machine has
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, str(Path(cwd) / "chip_smoke.py")],
        cwd=cwd, capture_output=True, text=True, timeout=120, env=env,
    )


def test_exits_nonzero_without_a_card():
    out = _run_script(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_script(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_paged_cases_and_byte_count():
    """The kernel phase's call forms on a small pool: padded slots and
    all-trash rows give 0, and the bound's byte count covers exactly the
    valid keys."""
    from deepspeed_tpu_torch.ops.attention.paged import paged_decode

    world = chip_smoke.PagedWorld(torch, torch.device("cpu"), torch.float32, 2, 24, 16, 2, 64, 1)
    rng = np.random.default_rng(0)
    cases = dict(chip_smoke.paged_cases(torch, world, rng, 6, 8, 4, 1, 8))
    assert set(cases) == {"split_E1_limit", "round_E8_limit", "round_E8_limit_window",
                          "causal_window_scale"}
    out = paged_decode(k_cache=world.k, v_cache=world.v, **cases["split_E1_limit"])
    assert not out[-4:].any()
    out = paged_decode(k_cache=world.k, v_cache=world.v, **cases["causal_window_scale"])
    assert not out[0].any()
    kw = cases["causal_window_scale"]
    moved, ops = chip_smoke.paged_bytes_ops(world, kw)
    pos = kw["q_pos"].numpy()
    keys = sum(min(100, int(p) + 1) for p in pos[1:])  # row 0 is all trash
    per_key = 2 * world.nkv * world.d * 4
    assert moved - keys * per_key == 2 * kw["q"].numel() * 4 + kw["block_tables"].numel() * 4 + 6 * 8
    assert ops == keys * 8 * 4 * world.d


@pytest.fixture
def one_thread():
    """Tiny ops: a single intra-op thread avoids thread-pool hand-offs that
    dominate at this size (and contention with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_engine_phase_runs_end_to_end_on_cpu(one_thread):
    widths = dict(n_layers=2, hidden_size=128, n_heads=4, n_kv_heads=2, ffn_hidden_size=256,
                  vocab_size=512, dtype="float32")
    engine_config = {
        "dtype": "float32", "decode_steps": 64, "prompt_chunk": 256, "max_prompt_chunks": 4,
        "kv_cache": {"block_size": 16, "num_blocks": 1024, "max_blocks_per_seq": 40},
        "state_manager": {"max_tracked_sequences": 64, "max_ragged_batch_size": 1024,
                          "max_ragged_sequence_count": 32, "max_context": 640},
    }
    rec, launches = chip_smoke.engine_phase(
        torch, torch.device("cpu"), K, widths=widths, engine_config=engine_config
    )
    json.dumps(rec)
    assert launches == {"rms_norm_fwd": 0, "paged_decode": 0}  # the CPU runs no kernel
    assert rec["forward_steps"]["round"] == 64
    # every slot: its prefill row, two decode steps, 64 round steps
    assert rec["logit_rows_checked"] == {"prefill": 32, "decode": 64, "round": 32 * 64,
                                         "shifted": 32}
    # fp32 on both sides: sums in another order only
    for k in ("prefill", "decode", "round"):
        assert rec["logit_rel_err"][k] < 1e-4, (k, rec["logit_rel_err"])
    assert rec["logit_rel_err"]["shifted"] > chip_smoke.LOGIT_RTOL
    assert rec["gen_tok_s"] > 0
