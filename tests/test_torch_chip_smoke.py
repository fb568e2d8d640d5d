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
                          "causal_window_scale", "shared_prefix", "per_row_t16", "verify_k4"}
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


def test_paged_shared_prefix_and_per_row_cases():
    """The forms the split kernel makes risky: rows whose tables share
    their first blocks, and the per-row step's chunk of queries over one
    table with the chunk's K/V as stride-0 extras (the wrapper passes their
    row stride, 0, and copies nothing); both agree with the split-and-merge
    model, and the per-(row, head) check passes them."""
    from deepspeed_tpu_torch.ops.attention import paged as pt

    for int8 in (False, True):
        world = chip_smoke.PagedWorld(torch, torch.device("cpu"), torch.float32, 2, 24, 16, 2, 64,
                                      1, int8=int8)
        rng = np.random.default_rng(0)
        cases = dict(chip_smoke.paged_cases(torch, world, rng, 6, 8, 4, 1, 8))
        kw = cases["shared_prefix"]
        tables = kw["block_tables"]
        assert bool((tables[:, :2] == tables[0, :2]).all()) and len(set(tables[:, 2:].flatten()
                                                                         .tolist())) > 4
        kw = cases["per_row_t16"]
        ke, ve, epos = kw["extra_kv"]
        assert ke.stride(0) == 0 and epos.stride(0) == 0 and ke.shape[:2] == (16, 16)
        assert bool((kw["block_tables"] == kw["block_tables"][0]).all())
        a = pt.paged_decode_args(**world.pool(), **kw)
        assert (a.x_stride, a.e_stride) == (0, 0) and a.ke.data_ptr() == ke.data_ptr()
        for name in ("shared_prefix", "per_row_t16"):
            want = pt.paged_decode(**world.pool(), **cases[name])
            got = pt.paged_decode_split_merge(**world.pool(), **cases[name], split_keys=8)
            err = chip_smoke.check_rows(torch, name, got, want, chip_smoke.PAGED_ROW_RTOL["fp32"])
            assert err < 1e-5


def test_paged_record_fields_and_row_check():
    """The kernel record's plan fields at the timed shape (2 pool splits of
    320 keys and 1 extras split: 768 CTAs, two launches a call), computed
    on the CPU from the same arguments; and the per-(row, head) check
    rejects a row that is off or one that should be exactly 0."""
    world = chip_smoke.PagedWorld(torch, torch.device("cpu"), torch.bfloat16, 1, 160, 128, 8, 128,
                                  1)
    rng = np.random.default_rng(0)
    cases = dict(chip_smoke.paged_cases(torch, world, rng, 32, 32, 5, 0, 64))
    plan = chip_smoke.paged_plan(world, cases["round_E64_limit"])
    assert plan == {"splits": 3, "pool_splits": 2, "extra_splits": 1, "split_keys": 320,
                    "launches_per_call": 2}
    assert chip_smoke.paged_plan(world, cases["split_E1_limit"])["splits"] == 3
    assert "cp.async" in chip_smoke.PAGED_DESIGN and "mma.sync" in chip_smoke.PAGED_DESIGN
    want = torch.randn(4, 8, 16)
    want[1, 3] = 0
    assert chip_smoke.check_rows(torch, "ok", want.clone(), want, 1e-4) == 0.0
    off = want.clone()
    off[2, 5] *= 1.05
    with pytest.raises(AssertionError, match="relative"):
        chip_smoke.check_rows(torch, "off", off, want, 1e-2)
    nonzero = want.clone()
    nonzero[1, 3, 0] = 1e-6
    with pytest.raises(AssertionError, match="exactly 0"):
        chip_smoke.check_rows(torch, "zero", nonzero, want, 1e-2)


def test_int8_paged_cases_and_byte_count():
    """The int8 kernel group's world on a small pool: the pool holds
    ``quantize_kv`` codes and planes, padded slots and all-trash rows give
    0, and the bound counts d + 4 bytes per head vector of the pool (codes
    and a scale) and q's dtype for the extras."""
    from deepspeed_tpu_torch.ops.attention.paged import paged_decode

    world = chip_smoke.PagedWorld(torch, torch.device("cpu"), torch.float32, 2, 24, 16, 2, 64, 1,
                                  int8=True)
    assert world.k.dtype == torch.int8 and tuple(world.ks.shape) == (50, 16, 2)
    rng = np.random.default_rng(0)
    cases = dict(chip_smoke.paged_cases(torch, world, rng, 6, 8, 4, 1, 8))
    out = paged_decode(**world.pool(), **cases["split_E1_limit"])
    assert not out[-4:].any() and out[:-4].abs().sum() > 0
    kw = cases["causal_window_scale"]
    assert not paged_decode(**world.pool(), **kw)[0].any()
    moved, ops = chip_smoke.paged_bytes_ops(world, kw)
    pos = kw["q_pos"].numpy()
    keys = sum(min(100, int(p) + 1) for p in pos[1:])  # row 0 is all trash
    per_key = 2 * world.nkv * (world.d + 4)
    assert moved - keys * per_key == 2 * kw["q"].numel() * 4 + kw["block_tables"].numel() * 4 + 6 * 8
    # extras in q's dtype
    kw = cases["split_E1_limit"]
    moved_e, _ = chip_smoke.paged_bytes_ops(world, kw)
    no_extra = dict(kw, extra_kv=None)
    moved_n, _ = chip_smoke.paged_bytes_ops(world, no_extra)
    assert moved_e - moved_n == 2 * 2 * 64 * 4 * 2  # 2 valid extras, K and V, nkv 2, fp32


def test_block_quant_checks_on_plain_inputs():
    """The kernel group's bitwise checks at a small size: on CPU tensors the
    wrappers are their plain versions, so every case agrees, the zero head
    vector gives scale 0, and a flipped code would be counted."""
    x_kv, x_big = chip_smoke.block_quant_inputs(torch, torch.device("cpu"), rows=64, d=128,
                                                shape=(16, 512))
    mismatches = chip_smoke.block_quant_mismatches(torch, x_kv, x_big, 256)
    assert set(mismatches) == {
        "kv_write_d128_deterministic", "kv_write_d128_stochastic",
        "blockwise_256_deterministic", "blockwise_256_stochastic",
        "kv_write_d128_fp32_deterministic", "kv_write_d128_fp32_stochastic",
        "pair_d128_deterministic", "pair_d128_stochastic",
        "pair_d128_fp32_deterministic", "pair_d128_fp32_stochastic",
        "quantize_kv", "quantize_kv_pair", "blockwise_int4"}
    assert not any(mismatches.values())
    from deepspeed_tpu_torch.ops.quantizer.block_quant import quantize_kv

    q, s = quantize_kv(x_kv[0])
    assert float(s[0]) == 0.0 and not q[0].any() and bool((s[1:] > 0).all())


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny ops: a single intra-op thread avoids thread-pool hand-offs that
    dominate at this size (and contention with the other test workers), for
    every test of the file."""
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
    assert launches == {name: 0 for name in K.KERNELS}  # the CPU runs no kernel
    assert rec["forward_steps"]["round"] == 64
    # every slot: its prefill row, two decode steps, 64 round steps
    assert rec["logit_rows_checked"] == {"prefill": 32, "decode": 64, "round": 32 * 64,
                                         "shifted": 32}
    # fp32 on both sides: sums in another order only
    for k in ("prefill", "decode", "round"):
        assert rec["logit_rel_err"][k] < 1e-4, (k, rec["logit_rel_err"])
    assert rec["logit_rel_err"]["shifted"] > chip_smoke.LOGIT_RTOL
    assert rec["gen_tok_s"] > 0


def test_train_phase_runs_end_to_end_on_cpu(one_thread):
    """The train phase at 2 tiny layers: on CPU tensors the kernel path is
    the kernels' plain versions ("flash" makes the model go through the
    flash Function), so the parity leg agrees to fp32 rounding and the
    control does not."""
    widths = dict(hidden_size=128, n_heads=4, n_kv_heads=2, ffn_hidden_size=256,
                  vocab_size=512, dtype="float32", attention_impl="flash")
    rec, launches = chip_smoke.train_phase(torch, torch.device("cpu"), K, widths=widths,
                                           seq=64, layers=2, parity_layers=2)
    json.dumps(rec)
    assert launches == {name: 0 for name in K.KERNELS}
    par = rec["parity"]
    assert par["loss_abs_diff"] < 1e-5
    assert max(par["grad_rel_frobenius"].values()) < 1e-4
    assert par["control_rel_frobenius_min"] > chip_smoke.PARITY_CONTROL_MIN
    assert par["fixed_batch_losses"][-1] < par["fixed_batch_losses"][0]
    assert len(rec["losses"]) == 5 and rec["tok_s"] > 0
    # exact per-step counts the card run checks: gas 2, L layers
    assert rec["launches_per_optimizer_step"] == {
        "flash_fwd": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4, "rms_norm_fwd": 10,
        "rms_norm_bwd": 10}
    assert rec["phase"] == "train" and "checkpoint" not in rec
    assert (set(chip_smoke.SERVE_KERNELS) | set(chip_smoke.TRAIN_KERNELS)
            | set(chip_smoke.FUSED_KERNELS) | set(chip_smoke.SPLASH_KERNELS)
            | set(chip_smoke.INT8_KERNELS) | set(chip_smoke.SPARSE_KERNELS)
            | set(chip_smoke.EVOFORMER_KERNELS) | set(chip_smoke.CARRY_KERNELS)
            | set(chip_smoke.FLASH_ALIBI_KERNELS)) == set(K.KERNELS)


def test_train_fused_phase_runs_end_to_end_on_cpu(one_thread):
    """The fused leg at 2 tiny layers: ``fused_ce=True`` and FusedAdam take
    their plain versions on CPU tensors, so the parity leg (against the
    dense head's autograd) agrees to fp32 rounding, the optimizer step is
    the plain math, and the checkpoint reload continues bit for bit."""
    widths = dict(hidden_size=128, n_heads=4, n_kv_heads=2, ffn_hidden_size=256,
                  vocab_size=520, dtype="float32", attention_impl="flash")
    rec, launches = chip_smoke.train_phase(torch, torch.device("cpu"), K, widths=widths,
                                           seq=64, layers=2, parity_layers=2, fused=True,
                                           timed_steps=2)
    json.dumps(rec)
    assert rec["phase"] == "train_fused"
    assert launches == {name: 0 for name in K.KERNELS}
    par = rec["parity"]
    assert par["loss_abs_diff"] < 1e-5
    assert max(par["grad_rel_frobenius"].values()) < 1e-4
    assert par["control_rel_frobenius_min"] > chip_smoke.PARITY_CONTROL_MIN
    assert par["adam_step_max_abs_err"] == 0.0  # the same plain math on both sides
    assert par["fixed_batch_losses"][-1] < par["fixed_batch_losses"][0]
    ck = rec["checkpoint"]
    assert ck["loss_after_reload"] == ck["loss_uninterrupted"] and ck["global_steps"] == 9
    assert len(rec["losses"]) == 3
    # gas 2, 2 layers; five leaves have at least 65536 elements: the
    # embedding and the head (520 x 128) and the three stacked MLP weights
    # (2 x 128 x 256)
    assert rec["launches_per_optimizer_step"] == {
        "flash_fwd": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4, "rms_norm_fwd": 10,
        "rms_norm_bwd": 10, "fused_ce_fwd": 2, "fused_ce_dx": 2, "fused_ce_dw": 2,
        "fused_adam": 5}


def test_fused_kernel_checks_run_on_plain_inputs():
    """The kernels phase's fused-CE inputs and its tile measure: the plain
    backward against autograd of the dense loss passes the tile check, and a
    3% error on a late tile of dW does not."""
    from deepspeed_tpu_torch.ops import fused_ce as C

    x, w, labels, g = chip_smoke.ce_inputs(torch, torch.device("cpu"), 200, 64, 300, seed=0)
    assert x.dtype == w.dtype == torch.bfloat16 and float(g[-1]) == 0.0 and bool((g == 0).any())
    xf, wf = x.float().requires_grad_(True), w.float().requires_grad_(True)
    want = torch.autograd.grad(C.fused_ce_reference(xf, wf, labels), (xf, wf), g)
    _, lse = C.fused_ce_fwd_reference(x, w, labels)
    got = C.fused_ce_bwd_reference(x, w, labels, lse, g)
    for a, b in zip(got, want):
        chip_smoke.tile_rel_err(torch, "plain", a[None, None], b[None, None],
                                limit=chip_smoke.CE_TILE_RTOL)
    bad = got[1].float().clone()
    bad[-8:] *= 1.5
    with pytest.raises(AssertionError, match="tile"):
        chip_smoke.tile_rel_err(torch, "dW", bad[None, None], want[1][None, None],
                                limit=chip_smoke.CE_TILE_RTOL)


def test_fused_ce_head_record_and_backward_fields_on_cpu():
    """The fused_ce_head record at a tiny size on CPU tensors (the fused
    form takes the plain versions): both forms give the same loss and
    gradients, each form's call is timed and its memory asked for, the
    summed kernel and library times add up; and the dx / dW records' new
    fields count what the kernels add into their planes."""
    x, w, labels, g = chip_smoke.ce_inputs(torch, torch.device("cpu"), 40, 24, 300, seed=1)
    x, w = x.float(), w.float()
    forms = chip_smoke.ce_head_forms(torch)
    fused = forms["fused"](x.requires_grad_(True), w.requires_grad_(True), labels, g)
    library = forms["library"](x, w, labels, g)
    for a, b in zip(fused, library):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    calls = []
    kernel_ms = {"fused_ce_fwd": 1.0, "fused_ce_dx": 2.0, "fused_ce_dw": 3.0}
    library_ms = {"fused_ce_fwd": 0.5, "fused_ce_dx": 0.75, "fused_ce_dw": 0.75}
    rec = chip_smoke.fused_ce_head(torch, x, w, labels, g, kernel_ms, library_ms,
                                   lambda fn: calls.append(fn()) or 7.0,
                                   lambda fn: calls.append(fn()) or 123)
    json.dumps(rec)
    assert rec["name"] == "fused_ce_head" and rec["shape"] == {"n": 40, "h": 24, "V": 300}
    assert rec["kernels_ms"]["sum"] == 6.0 and rec["library_ms"]["sum"] == 1.25
    assert rec["call_ms"] == {"fused": 7.0, "library": 7.0}
    assert rec["peak_bytes_above_inputs"] == {"fused": 123, "library": 123}
    assert len(calls) == 4 and all(len(c) == 3 for c in calls)  # (loss, dx, dW) each
    f = chip_smoke.ce_bwd_fields(4096, 4096, 32000)
    assert f["fused_ce_dx"]["reduced_elements"] == 4096 * 4096 * 63  # 1.06e9: a span of 512
    assert f["fused_ce_dw"]["reduced_elements"] == 4096 * 32000 * 8  # 1.05e9: 8 row spans
    assert f["fused_ce_dx"]["span"] == {"Vs": 512} and f["fused_ce_dw"]["span"] == {"Rs": 512}
    assert "wgmma" in f["fused_ce_dx"]["design"] and "TMA" in f["fused_ce_dw"]["design"]
    # the padded widths: h 1000 -> 1000, V 3001 -> 3008; n 777 -> 2 row spans
    f = chip_smoke.ce_bwd_fields(777, 1000, 3001)
    assert f["fused_ce_dx"]["reduced_elements"] == 777 * 1000 * 6
    assert f["fused_ce_dw"]["reduced_elements"] == 1000 * 3008 * 2


def test_fused_ce_forward_fields_count_its_spans():
    """The forward record's fields: its span, its CTAs (row tiles x spans)
    and the fp32 partials the merge folds (m and l per row and span), at the
    train step's shape and at one that divides no span."""
    from deepspeed_tpu_torch.ops import fused_ce as C

    f = chip_smoke.ce_fwd_fields(4096, 32000, 1024)
    assert f["span"] == {"Vs": 1024} and f["ctas"] == 32 * 32
    assert f["partials"] == 2 * 32 * 4096
    assert "wgmma" in f["design"] and "no atomics" in f["design"]
    f = chip_smoke.ce_fwd_fields(777, 3001, C.FWD_SPAN)
    spans = -(-3001 // C.FWD_SPAN)
    assert f["ctas"] == 7 * spans and f["partials"] == 2 * spans * 777
    json.dumps(f)


def test_tile_check_rejects_late_tiles_the_max_scaled_check_passes():
    """A 3% error on the later half of the keys' dk (the smallest
    gradients under a causal mask) stays inside the elementwise check whose
    atol is scaled by the largest element; the per-tile relative Frobenius
    check rejects it, and passes the plain version against itself."""
    from deepspeed_tpu_torch.ops.attention import flash as F

    q, k, v, do = chip_smoke.flash_inputs(torch, torch.device("cpu"), 1, 2, 1, 1024, 64, seed=3)
    out, lse = F.flash_fwd_reference(q, k, v, causal=True)
    _, dk, _ = F.flash_bwd_reference(q, k, v, out, do, lse, causal=True)
    bad = dk.float().clone()
    bad[:, :, 512:] *= 1.03
    bad = bad.to(dk.dtype)
    scale = max(1.0, float(dk.float().abs().max()))
    chip_smoke.check_close(torch, "dk", bad, dk, chip_smoke.BF16_ATOL * scale,
                           chip_smoke.BF16_RTOL)
    assert chip_smoke.tile_rel_err(torch, "dk", dk, dk) == 0
    with pytest.raises(AssertionError, match="tile is off"):
        chip_smoke.tile_rel_err(torch, "dk", bad, dk)
    # a partial tail tile, and an all-zero reference tile that must stay zero
    z = torch.zeros(1, 1, 70, 8)
    assert chip_smoke.tile_rel_err(torch, "z", z, z) == 0
    with pytest.raises(AssertionError, match="inf"):
        chip_smoke.tile_rel_err(torch, "z", z + 1e-3, z)


def test_flash_pairs_counts_the_visible_pairs():
    seg = torch.tensor([[0] * 5 + [1] * 3])
    assert chip_smoke.flash_pairs(8, True, 0, None, None) == 36
    assert chip_smoke.flash_pairs(8, False, 0, None, None) == 64
    assert chip_smoke.flash_pairs(8, True, 2, None, None) == 15
    assert chip_smoke.flash_pairs(8, True, 2, 0, None) == 36
    assert chip_smoke.flash_pairs(8, True, 0, None, seg) == 15 + 6


def test_train_splash_phase_runs_end_to_end_on_cpu(one_thread):
    """The splash leg at 2 tiny layers: attention_impl="splash" takes the
    splash Function's plain versions on CPU tensors, so the parity leg
    (window 16 over 128 tokens, two packed segments) agrees with autograd
    through forward_reference to fp32 rounding; the timed leg runs under
    remat, so the forward and the norms count twice per layer."""
    widths = dict(hidden_size=128, n_heads=4, n_kv_heads=2, ffn_hidden_size=256,
                  vocab_size=512, dtype="float32")
    rec, launches = chip_smoke.train_phase(torch, torch.device("cpu"), K, widths=widths,
                                           seq=128, layers=2, parity_layers=2, splash=True,
                                           parity_window=16, timed_seq=256, timed_steps=2)
    json.dumps(rec)
    assert rec["phase"] == "train_splash" and rec["parity_window"] == 16
    assert rec["seq"] == 256 and rec["window"] == 4096 and rec["remat"] is True
    assert launches == {name: 0 for name in K.KERNELS}
    par = rec["parity"]
    assert par["loss_abs_diff"] < 1e-5
    assert max(par["grad_rel_frobenius"].values()) < 1e-4
    assert par["control_rel_frobenius_min"] > chip_smoke.PARITY_CONTROL_MIN
    assert par["fixed_batch_losses"][-1] < par["fixed_batch_losses"][0]
    assert rec["launches_per_optimizer_step"] == {
        "splash_fwd": 8, "splash_bwd_dq": 4, "splash_bwd_dkv": 4, "rms_norm_fwd": 18,
        "rms_norm_bwd": 10}
    assert set(chip_smoke.SPLASH_KERNELS) | set(chip_smoke.SERVE_KERNELS) | set(
        chip_smoke.TRAIN_KERNELS) | set(chip_smoke.FUSED_KERNELS) | set(
        chip_smoke.INT8_KERNELS) | set(chip_smoke.SPARSE_KERNELS) | set(
        chip_smoke.EVOFORMER_KERNELS) | set(chip_smoke.CARRY_KERNELS) | set(
        chip_smoke.FLASH_ALIBI_KERNELS) == set(K.KERNELS)


def test_engine_per_row_phase_runs_end_to_end_on_cpu(one_thread):
    """The per-row leg at 2 tiny layers with a window of 96 over a 256-key
    context in 16-key blocks: every row step takes the splash prefill, its
    schedule visits fewer blocks than the context holds, and the logits
    agree with the plain forward and the dense per-row path."""
    widths = dict(n_layers=2, hidden_size=128, n_heads=4, n_kv_heads=2, ffn_hidden_size=256,
                  vocab_size=512, dtype="float32", sliding_window=96)
    engine_config = {
        "dtype": "float32", "decode_steps": 1, "prompt_chunk": 32, "max_prompt_chunks": 2,
        "kv_cache": {"block_size": 16, "num_blocks": 64, "max_blocks_per_seq": 16},
        "state_manager": {"max_tracked_sequences": 8, "max_ragged_batch_size": 96,
                          "max_ragged_sequence_count": 4, "max_context": 256},
    }
    rec, launches = chip_smoke.engine_per_row_phase(
        torch, torch.device("cpu"), K, widths=widths, engine_config=engine_config,
        prompt_lens=(3, 150, 240), new_tokens=5)
    json.dumps(rec)
    assert launches == {name: 0 for name in K.KERNELS}
    assert rec["launches_expected"]["splash_fwd"] == 2 * rec["row_steps"] > 0
    assert rec["logit_rows_checked"] == 15
    assert rec["logit_rel_err"] < 1e-4 and rec["dense_logit_rel_err"] < 1e-4
    assert rec["logit_rel_err_shifted"] > chip_smoke.LOGIT_RTOL
    assert rec["dense_token_agreement"] == 1.0
    # a 32-token chunk's band of 96 + 32 keys touches at most 9 of 16 blocks
    assert rec["blocks_in_context"] == 16
    assert 0 < rec["blocks_visited"]["chunk"]["max"] <= 9
    assert rec["blocks_visited"]["decode"]["max"] <= 7


def test_splash_kernel_cases_on_plain_inputs():
    """The kernels phase's cases at s 4096 with 2 heads: the schedules are
    the ones the card checks (the 1024-window band prunes, the Fixed layouts
    differ by head, query blocks 2 and 3 of (d) are dead, (f) to (h) take
    64-key blocks, (h) over one kv head), and the plain forward gives 0 with
    lse -1e30 on the dead rows."""
    from deepspeed_tpu_torch.ops.sparse_attention import splash as SP

    cases = chip_smoke.splash_cases(torch, torch.device("cpu"), s=4096, h=2)
    assert [c[0][:2] for c in cases] == ["a_", "b_", "c_", "d_", "f_", "g_", "h_"]
    assert cases[4][1].block_kv == cases[5][1].block_kv == 64 and cases[5][1].num_heads == 2
    # (h): (g)'s schedule over one kv head, the other cases over 8
    assert cases[6][1] is cases[5][1] and cases[6][3] == 1 and {c[3] for c in cases[:6]} == {8}
    assert SP.dkv_walk_rows(cases[6][1], 2, 1, 128) == 4
    local, fixed, dead = cases[0][1], cases[1][1], cases[3][1]
    assert local.block_q == 512 and local.grid_width == 3 and local.density < 0.5
    assert cases[2][1] is local and cases[2][2] is not None
    assert fixed.num_heads == 2 and not (fixed.kv_index[0] == fixed.kv_index[1]).all()
    assert (dead.step_kind[0, 2:4] == 0).all() and (dead.step_kind[0, 4] > 0).any()
    q, k, v, _ = (t.float() for t in chip_smoke.flash_inputs(
        torch, torch.device("cpu"), 1, 2, 1, 4096, 64, seed=1))
    out, lse = SP.splash_fwd_reference(q, k, v, dead)
    assert not out[:, :, 1024:2048].any() and bool((lse[:, :, 1024:2048] == -1e30).all())
    assert bool(out[:, :, 2048:].abs().sum(-1).gt(0).all())


def test_flash_kernel_cases_on_plain_inputs(monkeypatch):
    """The kernels phase's flash cases at a small size: every forward tile
    shape (head dims 64, 128 and 256), s 200 non-causal (no whole tile at
    any width), packed segments with and without the window; with the CUDA
    wrappers standing in for their plain versions, every comparison of each
    case holds and each case gets its records."""
    from deepspeed_tpu_torch.ops.attention import flash as F

    monkeypatch.setattr(F, "flash_fwd_cuda", F.flash_fwd_reference)
    monkeypatch.setattr(F, "flash_bwd_dq_cuda",
                        lambda *a, **kw: F.flash_bwd_reference(*a, **kw)[0])
    monkeypatch.setattr(F, "flash_bwd_dkv_cuda",
                        lambda *a, **kw: F.flash_bwd_reference(*a, **kw)[1:])
    cpu = torch.device("cpu")
    cases = chip_smoke.flash_cases(torch, cpu, h=2, h_kv=1, s=512, window=512, short=256)
    assert {c["d"] for c in cases.values()} == set(F.FWD_TILES)
    tail = cases["s200_noncausal"]
    assert not tail["causal"] and all(tail["s"] % t["bk"] for t in F.FWD_TILES.values())
    assert all(tail["s"] % t[key] for t in F.BWD_TILES.values() for key in ("bk", "kv_bq"))
    assert [c["window"] for c in cases.values() if c["seg"] is not None] == [256, 0]
    errs = {name: {} for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    tile_errs = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for i, (name, c) in enumerate(cases.items()):
        chip_smoke.check_flash_case(torch, cpu, errs, tile_errs, name, c, seed=i)
    assert len(errs["flash_fwd"]) == 2 * len(cases) and len(errs["flash_bwd_dkv"]) == 2 * len(cases)
    assert max(v for e in errs.values() for v in e.values()) == 0.0


def test_engine_int8_phase_runs_end_to_end_on_cpu(one_thread):
    """The engine_int8 phase at 2 tiny layers after the bf16 phase whose
    rows it is held against: the exact counts the card checks (paged decode
    int8 L and block_quant L per forward step, the bf16 paged kernel 0),
    logits against the plain forward within the int8 limit, the dense
    rerun on the same engine equal to the main path (both plain on the
    CPU), and the pool's capacity multiplier."""
    widths = dict(n_layers=2, hidden_size=128, n_heads=4, n_kv_heads=2, ffn_hidden_size=256,
                  vocab_size=512, dtype="float32")
    engine_config = {
        "dtype": "float32", "decode_steps": 64, "prompt_chunk": 256, "max_prompt_chunks": 4,
        "kv_cache": {"block_size": 16, "num_blocks": 1024, "max_blocks_per_seq": 40},
        "state_manager": {"max_tracked_sequences": 64, "max_ragged_batch_size": 1024,
                          "max_ragged_sequence_count": 32, "max_context": 640},
    }
    cpu = torch.device("cpu")
    keep = {}
    bf16, _ = chip_smoke.engine_phase(torch, cpu, K, widths=widths, engine_config=engine_config,
                                      keep=keep)
    assert len(keep) == 33 and keep[0][0].shape == (67, 512)
    rec, launches = chip_smoke.engine_phase(torch, cpu, K, widths=widths,
                                            engine_config=engine_config,
                                            kv_cache_dtype="int8", bf16_rows=keep)
    json.dumps(rec)
    assert rec["phase"] == "engine_int8" and launches == {name: 0 for name in K.KERNELS}
    fwd = rec["forward_steps"]["split"] + 64
    assert rec["launches_expected"]["paged_decode_int8"] == 2 * fwd
    assert rec["launches_expected"]["block_quant"] == 2 * fwd
    assert rec["launches_expected"]["paged_decode"] == 0
    assert max(rec["logit_rel_err"][k] for k in ("prefill", "decode", "round")) < (
        chip_smoke.INT8_LOGIT_RTOL)
    assert rec["logit_rel_err"]["shifted"] > chip_smoke.INT8_LOGIT_RTOL
    assert rec["dense_logit_rel_err"] == 0.0 and rec["dense_rows_compared"] >= 32 * 64
    assert rec["bf16_rows_compared"] >= 32 and rec["bf16_logit_rel_err"] < (
        chip_smoke.INT8_LOGIT_RTOL)
    assert rec["kv_pool_info"]["kv_cache_dtype"] == "int8"
    assert rec["kv_pool_info"]["kv_capacity_multiplier"] == pytest.approx(2 * 32 / (32 + 4))
    assert bf16["kv_pool_info"]["kv_capacity_multiplier"] == 1.0
    assert rec["gen_tok_s"] > 0


def test_engine_per_row_int8_phase_runs_end_to_end_on_cpu(one_thread):
    """The int8 per-row check at 2 tiny layers: exact per-row-step counts,
    logits equal to the batched int8 step's fed the same tokens (both plain
    on the CPU), and the export -> import round trip of a sequence's
    blocks."""
    widths = dict(n_layers=2, hidden_size=128, n_heads=4, n_kv_heads=2, ffn_hidden_size=256,
                  vocab_size=512, dtype="float32")
    engine_config = {
        "dtype": "float32", "decode_steps": 1, "prompt_chunk": 32, "max_prompt_chunks": 2,
        "kv_cache": {"block_size": 16, "num_blocks": 64, "max_blocks_per_seq": 16,
                     "kv_cache_dtype": "int8"},
        "state_manager": {"max_tracked_sequences": 8, "max_ragged_batch_size": 96,
                          "max_ragged_sequence_count": 4, "max_context": 256},
    }
    rec, launches = chip_smoke.engine_per_row_int8_phase(
        torch, torch.device("cpu"), K, widths=widths, engine_config=engine_config,
        prompt_lens=(2, 100, 150), new_tokens=5)
    json.dumps(rec)
    assert launches == {name: 0 for name in K.KERNELS}
    steps = rec["row_steps"]
    assert steps > 2 * 4 and rec["launches_expected"]["paged_decode_int8"] == 2 * steps
    assert rec["launches_expected"]["block_quant"] == 2 * steps
    assert rec["batched_token_agreement"] == 1.0 and rec["batched_logit_rel_err"] < 1e-4
    assert rec["logit_rows_checked"] == 10
    assert rec["export_blocks"] >= 7 and rec["export_bytes"] > 0


def test_sparse_attn_phase_runs_end_to_end_on_cpu(one_thread, monkeypatch):
    """The sparse_attn phase at 4 query heads over 2, s 512: through the
    registry on the CPU accelerator, ``SparseSelfAttention(use_splash=False)``
    takes the plain versions (nothing launches), its output and gradients
    equal the plain versions', and the key_padding_mask call equals the
    biased form built by hand."""
    from deepspeed_tpu_torch.accelerator import real_accelerator

    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    rec, launches = chip_smoke.sparse_attn_phase(torch, torch.device("cpu"), K, h=4, h_kv=2,
                                                 d=64, s=512, mask_s=256, dtype=torch.float32)
    json.dumps(rec)
    assert launches == {name: 0 for name in K.KERNELS}
    assert rec["accelerator"] == "cpu" and rec["phase"] == "sparse_attn"
    assert set(rec["max_abs_err"]) == {"out", "dq", "dk", "dv", "key_padding_mask_out"}
    assert max(rec["max_abs_err"].values()) < 1e-5
    assert max(rec["tile_rel_frobenius"].values()) < 1e-5
    # Fixed(4 local, 1 global) over 4 blocks of 128: one window, causal
    assert rec["density"] == 10 / 16
    assert rec["key_padding_mask"] == {"s": 256, "padded_keys": 32, "launches": 0}


def _plain_sparse_kernels(monkeypatch):
    """chip_smoke's sparse checks on the CPU: the sparse, splash and flash
    kernel wrappers replaced by their plain versions, the CUDA stream calls
    by no-ops."""
    from deepspeed_tpu_torch.ops.attention import flash as F
    from deepspeed_tpu_torch.ops.sparse_attention import sparse as SA
    from deepspeed_tpu_torch.ops.sparse_attention import splash as SP

    for mod, fwd, bwd in ((SA, "sparse_fwd", "sparse_bwd"), (SP, "splash_fwd", "splash_bwd"),
                          (F, "flash_fwd", "flash_bwd")):
        ref_bwd = getattr(mod, bwd + "_reference")
        monkeypatch.setattr(mod, fwd + "_cuda", getattr(mod, fwd + "_reference"))
        monkeypatch.setattr(mod, bwd + "_dq_cuda", lambda *a, r=ref_bwd, **kw: r(*a, **kw)[0])
        monkeypatch.setattr(mod, bwd + "_dkv_cuda", lambda *a, r=ref_bwd, **kw: r(*a, **kw)[1:])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)


def test_sparse_kernel_cases_on_plain_inputs(monkeypatch):
    """The kernels group's cases with 2 heads at s 512, on the plain
    versions: the layouts are the ones the card checks (16-blocks, BigBird
    per head, dead rows, dense, Fixed, the causal triangle), the dead rows
    give 0, the dense and triangle cases are held against flash (equal as
    values only on a card: the plain versions' arithmetic differs) and the
    Fixed and BigBird cases against splash, the forward also per tile."""
    cases = chip_smoke.sparse_cases(h=2, s=512)
    assert [c[0][:2] for c in cases] == ["a_", "b_", "c_", "d_", "e_", "f_"]
    assert [c[2] for c in cases] == [16, 64, 64, 128, 128, 128]
    assert [c[3] for c in cases] == [True, False, True, False, True, True]
    assert (cases[5][1] == np.tril(np.ones((4, 4), np.int32))).all()
    bigbird, dead = cases[1][1], cases[2][1]
    assert not (bigbird[0] == bigbird[1]).all() and bigbird[0][0, -1] == 1  # not causal
    assert not dead[:, 5].any() and dead[:, 1].sum() == 2 and dead[0, 1, 2] == 1
    assert cases[3][1].all()
    _plain_sparse_kernels(monkeypatch)
    errs, tile_errs, oracle = chip_smoke.sparse_case_checks(torch, torch.device("cpu"), h=2,
                                                            d=64, s=512)
    assert oracle == {"splash": ["b_bigbird_b64_per_head", "e_fixed_b128_causal"],
                      "flash": ["d_dense_b128", "f_tril_b128_causal"], "fwd_equal_flash": []}
    assert "d_dense_b128_flash_dk" in errs["sparse_bwd_dkv"]
    assert "f_tril_b128_causal_flash_out" in errs["sparse_fwd"]
    assert "e_fixed_b128_causal_splash_out" in errs["sparse_fwd"]
    assert set(tile_errs["sparse_bwd_dq"]) == {c[0] for c in cases}
    assert set(tile_errs["sparse_fwd"]) == {c[0] for c in cases}


def test_sparse_work_counts_kept_pairs():
    """The bound's pair count against the layout's token mask, causal and
    not."""
    import numpy as np

    for block, causal in ((16, True), (64, False), (128, True)):
        layout = chip_smoke.sparse_fixed(2, block, 2, 1).make_layout(512)
        tok = np.repeat(np.repeat(layout != 0, block, 1), block, 2)
        if causal:
            tok &= np.tril(np.ones((512, 512), bool))
        pairs, flops, moved = chip_smoke.sparse_work(layout, block, causal, 3, 2, 512, 64)
        assert pairs == 3 * int(tok.sum())
        assert flops["sparse_bwd_dkv"] == 2 * flops["sparse_fwd"] == 8 * pairs * 64
        t = 3 * 2 * 512 * 64 * 2
        assert moved["sparse_fwd"] == 4 * t + 3 * 2 * 512 * 4 + layout.size * 4


def test_evoformer_phase_runs_end_to_end_on_cpu(one_thread, monkeypatch):
    """The evoformer phase at n 8 / 6, s 40, 2 heads of 16 in fp32: through
    the registry on the CPU accelerator, ``DS4Sci_EvoformerAttention`` takes
    the plain versions (nothing launches), its output and the gradients of
    Q, K, V and both biases equal the plain versions', and the call whose
    biases need no gradient does not ask for dS."""
    from deepspeed_tpu_torch.accelerator import real_accelerator
    from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as E

    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    shapes = {"msa_row": dict(n=8, s=40, h=2, d=16), "triangle": dict(n=6, s=40, h=2, d=16)}
    rec, launches = chip_smoke.evoformer_phase(torch, torch.device("cpu"), K, shapes=shapes,
                                               dtype=torch.float32)
    json.dumps(rec)
    assert launches == {name: 0 for name in K.KERNELS}
    assert rec["accelerator"] == "cpu" and set(rec["calls"]) == {"msa_row", "triangle"}
    for c in rec["calls"].values():
        assert set(c["max_abs_err"]) == {"out", "dq", "dk", "dv", "db1", "db2"}
        assert max(c["max_abs_err"].values()) < 1e-5
        assert max(c["rel_frobenius"].values()) < 1e-5
    assert rec["calls"]["msa_row"]["shape"] == {"q": [1, 8, 40, 2, 16],
                                                "bias1": [1, 8, 1, 1, 40],
                                                "bias2": [1, 1, 2, 40, 40]}
    assert [c["padded"] for c in rec["calls"].values()] == [{"rows": 2, "keys": 5},
                                                            {"rows": 1, "keys": 5}]
    assert rec["no_bias_grad_call"]["dS_asked"] is False
    assert E.evoformer_bwd_reference.__name__ == "evoformer_bwd_reference"  # spy removed


def _plain_evoformer_kernels(monkeypatch, E):
    """The evoformer wrappers replaced by plain models on CPU tensors: the
    partials are the plain dS plane summed over each group of batch rows
    (``rows_per_cta``: dq's) or over the queries (dk/dv's), and the merge is
    its plain version, so a reduced case checks the chain partials -> merge
    -> bias gradient."""

    def dq(q, k, v, out, do, lse, ops, want_ds=False, rows=False, **kw):
        r = E.evoformer_bwd_reference(q, k, v, out, do, lse, ops, want_ds=True)
        ds = r[3]
        B, h, s, _ = ds.shape
        g = E.rows_per_cta(B, h, s)
        rp = (torch.stack([ds[b0:b0 + g].sum(0) for b0 in range(0, B, g)]) if rows else None)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        return r[0], delta, ds if want_ds else None, rp

    def dkv(q, k, v, do, lse, delta, ops, cols=False, **kw):
        out, _ = E.evoformer_fwd_reference(q, k, v, ops)
        r = E.evoformer_bwd_reference(q, k, v, out, do, lse, ops, want_ds=True)
        return r[1], r[2], r[3].sum(2, keepdim=True) if cols else None

    monkeypatch.setattr(E, "evoformer_fwd_cuda", E.evoformer_fwd_reference)
    monkeypatch.setattr(E, "evoformer_bwd_dq_cuda", dq)
    monkeypatch.setattr(E, "evoformer_bwd_dkv_cuda", dkv)
    monkeypatch.setattr(E, "evoformer_bias_grad_merge_cuda", lambda jobs: [
        E.evoformer_bias_grad_merge_reference(src, flags) for src, flags in jobs])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)


def test_evoformer_kernel_cases_on_plain_inputs(monkeypatch):
    """The kernels group's small cases on the plain versions: the shapes
    the card checks (d 16 to 128, s 100, no bias, one bias, a materialized
    pair bias, a dead row), the dead row exactly 0 and every check
    recorded; the cases with a mask or a pair bias [1, 1, h, s, s] also in
    the reduced form, the materialized one only in the plane form."""
    from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as E

    _plain_evoformer_kernels(monkeypatch, E)
    errs = {n: {} for n in chip_smoke.EVOFORMER_KERNELS}
    tiles = {n: {} for n in chip_smoke.EVOFORMER_KERNELS}
    names, forms = [], {}
    for name, q, k, v, do, ops, dead, plan in chip_smoke.evoformer_cases(
            torch, torch.device("cpu")):
        chip_smoke.check_evoformer(torch, errs, tiles, name, q, k, v, do, ops, dead_row=dead,
                                   plan=plan)
        names.append(name)
        forms[name] = plan.form
        assert (dead is not None) == (name == "dead_row_bf16")
        assert len(ops) == {"no_bias_bf16": 0, "one_bias_fp32": 1, "d128_fp32": 1}.get(name, 2)
    assert {q_.shape[-1] for _, q_, *rest in chip_smoke.evoformer_cases(
        torch, torch.device("cpu"))} == {16, 32, 64, 128}
    assert forms == {n: {"no_bias_bf16": "none", "bias2_materialized_bf16": "plane"}.get(
        n, "reduced") for n in names}
    assert "dead_row_bf16_dS" in errs["evoformer_bwd_dq"]
    assert "no_bias_bf16_dS" not in errs["evoformer_bwd_dq"]
    assert {"d16_bf16_db2", "d128_fp32_db1", "one_bias_fp32_db1"} <= set(errs["evoformer_bwd_dq"])
    assert "bias2_materialized_bf16_db1" not in errs["evoformer_bwd_dq"]
    assert set(errs["evoformer_bias_grad_merge"]) == {
        f"{n}_{i}" for n in names if forms[n] == "reduced"
        for i in range(1, 2 + (n not in ("one_bias_fp32", "d128_fp32")))}
    assert set(tiles["evoformer_bwd_dkv"]) == {n for name in names for n in (name, name + "_dv")}
    # the kernels' plain models are the plain versions: equal, but for the
    # bias gradients, summed from the partials in another order
    assert max(v for e in errs.values() for key, v in e.items() if "_db" not in key) == 0
    assert max(v for key, v in errs["evoformer_bwd_dq"].items() if "_db" in key) < 1e-5


def test_evoformer_work_counts_the_msa_row_bytes():
    """The bounds' counts at msa_row: 4d / 6d / 8d FLOPs per pair; each
    backward kernel's bytes hold what it writes of the bias gradient: in
    bf16 dq's dS plane (2.42 GB) sets them, the reduced form's partials are
    a small part, dq's row partials counted in dq and the column partials in
    dk/dv, the merge reading both; dk/dv reads dq's delta, not o."""
    sh = chip_smoke.EVOFORMER_SHAPES["msa_row"]
    n, s, h, d = sh["n"], sh["s"], sh["h"], sh["d"]
    bias_bytes = (n * s + h * s * s) * 4
    pairs = n * h * s * s
    flops, moved = chip_smoke.evoformer_work(n, s, h, d, 2, bias_bytes, pairs * 4)
    assert flops["evoformer_fwd"] == 4 * d * pairs and flops["evoformer_bwd_dkv"] == 8 * d * pairs
    t = n * s * h * d * 2
    assert t == 100663296
    assert moved["evoformer_fwd"] == 4 * t + bias_bytes + n * h * s * 4 == 414449664
    assert moved["evoformer_bwd_dq"] - moved["evoformer_bwd_dkv"] == pairs * 4
    assert moved["evoformer_bwd_dkv"] == 6 * t + 2 * n * h * s * 4 + bias_bytes
    groups = -(-n // 16)
    rows, cols = groups * h * s * s * 4, n * h * s * 4
    _, reduced = chip_smoke.evoformer_work(n, s, h, d, 2, bias_bytes, rows, col_bytes=cols,
                                           merged_bytes=bias_bytes)
    assert moved["evoformer_bwd_dq"] - reduced["evoformer_bwd_dq"] == pairs * 4 - rows
    assert reduced["evoformer_bwd_dkv"] - moved["evoformer_bwd_dkv"] == cols
    assert reduced["evoformer_bias_grad_merge"] == rows + cols + bias_bytes
    assert rows + cols < pairs * 4 / 10


def test_ring_attn_phase_runs_end_to_end_on_cpu(one_thread):
    """The ring_attn phase at a tiny width (fp32, N 4, chunks of 64): the
    loopback ring through ``attention(impl="flash_ring")`` and the single
    flash Function both run their plain versions here, so they agree to
    fp32 rounding (the card holds them to bits, GQA dk/dv too); the CPU
    launches nothing."""
    cases = {"mha": dict(h=4, h_kv=4), "gqa": dict(h=4, h_kv=2)}
    rec, launches = chip_smoke.ring_attn_phase(torch, torch.device("cpu"), K, cases=cases,
                                               seq=256, d=64)
    json.dumps(rec)
    assert rec["phase"] == "ring_attn" and rec["n"] == 4 and set(rec["cases"]) == set(cases)
    assert launches == {name: 0 for name in chip_smoke.CARRY_KERNELS}
    for case in rec["cases"].values():
        assert all(case[f"{what}_max_abs_err"] < 1e-5 for what in ("out", "dq", "dk", "dv"))
        assert not any(key.endswith("_tile_rel_frobenius") for key in case)


def test_train_ring_phase_runs_end_to_end_on_cpu(one_thread):
    """The train_ring leg at 2 tiny MHA layers, fp32, seq 256 over 4
    loopback context ranks: the ring engine's first step agrees with the
    flash engine's (plain versions on both sides), the optimizer steps
    run, and the per-step launch counts the card checks are those of the
    ring under remat (N(N + 1) / 2 = 10 hops of each carry kernel per
    layer and micro-batch, the forward twice)."""
    widths = dict(hidden_size=128, n_heads=4, ffn_hidden_size=256, vocab_size=512,
                  dtype="float32")
    rec, launches = chip_smoke.train_ring_phase(torch, torch.device("cpu"), K, widths=widths,
                                                seq=256, layers=2, timed_steps=2)
    json.dumps(rec)
    assert rec["phase"] == "train_ring" and rec["n"] == 4
    assert launches == {name: 0 for name in K.KERNELS}
    par = rec["parity"]
    assert abs(par["loss_ring"] - par["loss_flash"]) < 1e-5 and par["grad_leaves"] > 0
    assert len(rec["losses"]) == 3 and all(np.isfinite(rec["losses"])) and rec["tok_s"] > 0
    assert rec["launches_per_optimizer_step"] == {
        "flash_fwd_chunk": 80, "flash_dq_chunk": 40, "flash_dkv_chunk": 40,
        "rms_norm_fwd": 18, "rms_norm_bwd": 10}


def test_carry_kernel_checks_on_plain_inputs(monkeypatch):
    """The flash_carry group's per-hop check at a small size: with the CUDA
    wrappers standing in for their plain versions (the CPU has no kernel),
    every comparison of the hop holds and each kernel gets its raw and
    finalized records."""
    from deepspeed_tpu_torch.ops.attention import flash as F

    def plain_fwd(q, k, v, carry=None, segment_ids=None, causal=False, scale=None, final=False):
        return F.flash_fwd_chunk(q, k, v, carry, segment_ids, causal, scale, final)

    def plain_dq(q, k, v, out, do, lse, dq_acc=None, segment_ids=None, causal=False, scale=None,
                 final=False):
        return F.flash_dq_chunk(q, k, v, out, do, lse, dq_acc, segment_ids, causal, scale, final)

    def plain_dkv(q, k, v, out, do, lse, carry=None, segment_ids=None, causal=False, scale=None,
                  final=False):
        return F.flash_dkv_chunk(q, k, v, out, do, lse, carry, segment_ids, causal, scale, final)

    monkeypatch.setattr(F, "flash_fwd_chunk_cuda", plain_fwd)
    monkeypatch.setattr(F, "flash_dq_chunk_cuda", plain_dq)
    monkeypatch.setattr(F, "flash_dkv_chunk_cuda", plain_dkv)
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(*sh, generator=gen) for sh in
                   ((1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64), (1, 4, 128, 64)))
    seg = (torch.zeros(1, 128, dtype=torch.int32), torch.zeros(1, 128, dtype=torch.int32))
    seg[0][:, 50:] = 1
    seg[1][:, 90:] = 1
    for causal in (False, True):
        errs = chip_smoke.carry_case(torch, q, k, v, do, dict(causal=causal, segment_ids=seg))
        assert len(errs) == 11 and max(errs.values()) < 1e-5


def _flash_stands_in_for_splash(monkeypatch, sched, skew=None):
    """The flash and splash kernel wrappers replaced by the splash plain
    versions over ``sched`` (the flash ones with the same window see the
    same pairs); ``skew(name, tensor)`` may alter a splash output."""
    from deepspeed_tpu_torch.ops.attention import flash as F
    from deepspeed_tpu_torch.ops.sparse_attention import splash as SP

    skew = skew or (lambda name, t: t)
    fwd = lambda q, k, v, *a, **kw: SP.splash_fwd_reference(q, k, v, sched)  # noqa: E731
    bwd = lambda q, k, v, o, do, lse, *a, **kw: SP.splash_bwd_reference(  # noqa: E731
        q, k, v, o, do, lse, sched)
    monkeypatch.setattr(F, "flash_fwd_cuda", fwd)
    monkeypatch.setattr(F, "flash_bwd_dq_cuda", lambda *a, **kw: bwd(*a)[0])
    monkeypatch.setattr(F, "flash_bwd_dkv_cuda", lambda *a, **kw: bwd(*a)[1:])
    monkeypatch.setattr(SP, "splash_bwd_dq_cuda", lambda *a, **kw: skew("dq", bwd(*a)[0]))
    monkeypatch.setattr(SP, "splash_bwd_dkv_cuda", lambda *a, **kw: tuple(
        skew(n, t) for n, t in zip(("dk", "dv"), bwd(*a)[1:])))
    return fwd


def _one_ulp(t):
    t = t.clone()
    flat = t.view(-1).view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    flat[flat.numel() // 3] += 1  # the next representable value of one element
    return t


@pytest.mark.parametrize("ulp", [0, 1])
def test_chip_smoke_splash_dkv_against_flash_holds_every_bit(monkeypatch, ulp):
    """splash_against_flash (the kernels phase's gate at both timed
    LocalMask shapes, which holds dk/dv as it holds out, lse and dq):
    splash dk/dv must equal flash dk/dv with the same window on the same
    out, lse and dO; with the wrappers standing in for their plain versions
    both sides agree, and one element of dk one bf16 ulp off fails the
    gate."""
    from deepspeed_tpu_torch.ops.sparse_attention import LocalMask, schedule_from_mask

    s, window = 256, 96
    sched = schedule_from_mask(LocalMask((s, s), window), 64)
    fwd = _flash_stands_in_for_splash(
        monkeypatch, sched, lambda name, t: _one_ulp(t) if ulp and name == "dk" else t)
    q, k, v, do = chip_smoke.flash_inputs(torch, torch.device("cpu"), 1, 4, 2, s, 64, seed=5)
    out, lse = fwd(q, k, v)
    if ulp:
        with pytest.raises(AssertionError, match="splash_bwd_dkv dk: 1 elements differ"):
            chip_smoke.splash_against_flash(torch, q, k, v, out, do, lse, sched, window)
        return
    rec = chip_smoke.splash_against_flash(torch, q, k, v, out, do, lse, sched, window)
    assert rec == {"out": "equal", "lse": "equal", "dq": "equal", "dk": "equal",
                   "dv": "equal", "window": window}


@pytest.mark.parametrize("which", ["out", "lse", "dq", "dv"])
def test_chip_smoke_splash_against_flash_holds_out_lse_and_dq(monkeypatch, which):
    """The same gate on the forward's out and lse and on dq (and dv): one
    element one ulp off in any of them fails it, naming the kernel."""
    from deepspeed_tpu_torch.ops.sparse_attention import LocalMask, schedule_from_mask

    s, window = 256, 96
    sched = schedule_from_mask(LocalMask((s, s), window), 64)
    fwd = _flash_stands_in_for_splash(
        monkeypatch, sched, lambda name, t: _one_ulp(t) if name == which else t)
    q, k, v, do = chip_smoke.flash_inputs(torch, torch.device("cpu"), 1, 4, 2, s, 64, seed=5)
    out, lse = fwd(q, k, v)
    if which == "out":
        out = _one_ulp(out)
    elif which == "lse":
        lse = _one_ulp(lse)
    kname = {"out": "splash_fwd", "lse": "splash_fwd", "dq": "splash_bwd_dq",
             "dv": "splash_bwd_dkv"}[which]
    with pytest.raises(AssertionError, match=f"{kname} {which}: 1 elements differ"):
        chip_smoke.splash_against_flash(torch, q, k, v, out, do, lse, sched, window)


def test_chip_smoke_records_the_flash_digests():
    """The flash kernels' recorded digests (``FLASH_DIGESTS``, held by the
    kernels phase) name every case of ``FLASH_DIGEST_CASES``; the splash
    tests pin the same bits."""
    names = {f"d{d}_s{s}_causal{int(c)}_w{w}_seg{cut}"
             for d, s, c, w, cut in chip_smoke.FLASH_DIGEST_CASES}
    assert set(chip_smoke.FLASH_DIGESTS) == names
    assert all(len(v) == 16 for v in chip_smoke.FLASH_DIGESTS.values())

def test_paged_verify_case_and_its_two_bounds():
    """The verify form (R 6, k 4: 30 query rows): each row's table and
    limit repeated over its 5 query rows, the extras a contiguous [30, 5]
    copy with the in-chunk causal positions; row 1's padded slots and row
    2 (inactive, all trash) give exactly 0; the bytes as the kernel reads
    them exceed the once-per-table count by about the pool bytes x (K1 -
    1), and the operations are the same."""
    from deepspeed_tpu_torch.ops.attention import paged as pt

    for int8 in (False, True):
        world = chip_smoke.PagedWorld(torch, torch.device("cpu"), torch.float32, 2, 24, 16, 2, 64,
                                      1, int8=int8)
        name, kw = chip_smoke.paged_cases(torch, world, np.random.default_rng(0), 6, 8, 4, 1,
                                          8)[-1]
        assert name == "verify_k4" and kw["q"].shape[0] == 30
        ke, ve, epos = kw["extra_kv"]
        assert ke.shape == (30, 5, 2, 64) and ke.is_contiguous()
        qpos = kw["q_pos"].reshape(6, 5)
        assert bool((epos.reshape(6, 5, 5) == qpos[:, None, :]).all())
        assert int((qpos[1] >= 0).sum()) == 2 and bool((qpos[2] < 0).all())
        assert bool((kw["block_tables"].reshape(6, 5, -1) == kw["block_tables"][::5, None]).all())
        out = pt.paged_decode(**world.pool(), **kw)
        assert not out[kw["q_pos"] < 0].any()
        read, ops = chip_smoke.paged_bytes_ops(world, kw)
        once = chip_smoke.verify_bytes_once(world, kw, 5)
        pool_row = 64 + 4 if int8 else 64 * 4
        limit = kw["pool_limit"][::5].numpy()
        keys = int(limit.sum())
        assert once < read
        assert read - once >= keys * 2 * 2 * pool_row * 4 - 30 * 5 * 2 * 2 * 64 * 4
        assert ops > 0


def _tiny_engine_run(kv_cache_dtype):
    widths = dict(n_layers=2, hidden_size=128, n_heads=4, n_kv_heads=2, ffn_hidden_size=256,
                  vocab_size=512, dtype="float32")
    engine_config = {
        "dtype": "float32", "decode_steps": 64, "prompt_chunk": 256, "max_prompt_chunks": 4,
        "kv_cache": {"block_size": 16, "num_blocks": 1024, "max_blocks_per_seq": 40},
        "state_manager": {"max_tracked_sequences": 64, "max_ragged_batch_size": 1024,
                          "max_ragged_sequence_count": 32, "max_context": 640},
    }
    held = {}
    chip_smoke.engine_phase(torch, torch.device("cpu"), K, widths=widths,
                            engine_config=engine_config, kv_cache_dtype=kv_cache_dtype, hold=held)
    return held


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_engine_spec_phase_runs_end_to_end_on_cpu(one_thread, kv_cache_dtype):
    """engine_spec on the engine phase's engine at 2 tiny layers: oracle
    drafts (the engine phase's own stream) all accepted, junk all rejected,
    no drafts one token a row; verify logits against the plain forward
    (fp32: sums in another order only), the exact counts the card checks."""
    held = _tiny_engine_run(kv_cache_dtype)
    assert len(held["plain"][0]) == 3 + 64
    int8 = kv_cache_dtype == "int8"
    rec, launches = chip_smoke.engine_spec_phase(torch, torch.device("cpu"), K, held["engine"],
                                                 held["prompts"], held["plain"], int8=int8)
    json.dumps(rec)
    assert launches == {name: 0 for name in K.KERNELS}
    assert rec["launches_expected"] == chip_smoke.spec_expected(K.KERNELS, 2, int8)
    assert rec["launches_expected"]["rms_norm_fwd"] == 5
    # an int8 pool's plain stream came from a fused round, whose own tokens
    # are attended unquantized (side buffers) where the verify step reads
    # earlier rounds' tokens from the quantized pool: a near-tie may differ
    assert rec["oracle_acceptance"] >= (0.9 if int8 else 1.0)
    assert rec["oracle_drafted"] >= 2 * 32 * 4 * (0.9 if int8 else 1.0)
    kinds = [r["kind"] for r in rec["rounds"]]
    assert kinds == ["oracle", "junk", "none", "oracle"]
    assert rec["rounds"][1]["accepted"] == 0 and rec["rounds"][1]["emitted"] == 32
    assert rec["rounds"][0]["emitted"] == 32 + rec["rounds"][0]["accepted"]
    assert rec["rounds"][0]["rows_checked"] == 32
    for r in rec["rounds"]:
        # fp32 sums in another order; int8 pools also carry their rounding
        assert r["logit_rel_err"] < (rec["logit_rtol"] if int8 else 1e-4)
        assert r["logit_rel_err_shifted"] > rec["logit_rtol"]
    n = chip_smoke.SPEC_TIMED_ROUNDS
    assert rec["plain_round_tokens"] == [32 * 5] * n and rec["timed_oracle_accepted"] > 0
    for key in ("verify_ms", "spec_tok_s", "plain_round_ms", "plain_round_tok_s"):
        d = rec[key]
        assert d["n"] == n and 0 < d["min"] <= d["median"] <= d["max"]
    assert held["engine"].scheduler.running_uids() == []


def test_host_tier_and_inference_v1_phases_run_end_to_end_on_cpu(one_thread):
    """The host_tier phase (16-token blocks, prompts of five blocks and a
    7-token tail) spills, readmits every resubmitted block bit for bit and
    prefills only the tails; the inference_v1 phase gives one stream at
    decode_steps 1 and 4 and counts 16 and 17 forward steps."""
    held = _tiny_engine_run("bf16")
    cfg = dict(chip_smoke.HOST_TIER_CONFIG, dtype="float32")
    cfg["kv_cache"] = dict(cfg["kv_cache"], block_size=16)
    rec = chip_smoke.host_tier_phase(torch, torch.device("cpu"), K, held["cfg"],
                                     held["engine"].params, engine_config=cfg, shape=(8, 5, 7))
    json.dumps(rec)
    assert rec["spills_before_resubmit"] > 0 and rec["readmits"] == rec["blocks_checked_bitwise"]
    assert rec["readmits"] > 0 and rec["prefill_tokens"] == rec["prefill_tokens_tails"] == 8 * 7
    assert rec["chunked_import"]["blocks"] == rec["readmits"]
    assert 0 < rec["chunked_import"]["stage_share"] <= 1
    assert rec["logit_rel_err"] < 1e-4
    rec = chip_smoke.inference_v1_phase(torch, torch.device("cpu"), K, held["cfg"],
                                        held["engine"].params, shape=(4, 64), new=16)
    json.dumps(rec)
    assert [rec["runs"][ds]["forward_steps"] for ds in (1, 4)] == [16, 17]
    assert rec["runs"][4]["launches_expected"]["rms_norm_fwd"] == 5 * 17
    assert rec["logit_rel_err"] < 1e-4 and rec["first_token_agreement"] == 1.0


def test_alibi_kernel_cases_on_plain_inputs(monkeypatch, one_thread):
    """The kernels phase's ALiBi cases at a small size (every head dim,
    packed segments with restarting positions, s 200 non-causal over rows
    with positions of their own, train_alibi's MHA form packed as
    ``packed_batch`` packs it): with the CUDA wrappers standing in for
    their plain versions every comparison holds, and each case gets its
    records."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes
    from deepspeed_tpu_torch.ops.attention import flash as F

    monkeypatch.setattr(F, "flash_fwd_cuda", F.flash_fwd_reference)
    monkeypatch.setattr(F, "flash_bwd_dq_cuda",
                        lambda *a, **kw: F.flash_bwd_reference(*a, **kw)[0])
    monkeypatch.setattr(F, "flash_bwd_dkv_cuda",
                        lambda *a, **kw: F.flash_bwd_reference(*a, **kw)[1:])
    cpu = torch.device("cpu")
    cases = chip_smoke.alibi_cases(torch, cpu, h=4, h_kv=2, s=256, short=256, train_s=128)
    assert {c["d"] for c in cases.values()} == set(F.FWD_TILES)
    packed = cases["s256_segments2_positions_restart"]
    assert int(packed["pos"][0, 0]) == 0 and int(packed["pos"][0, 97]) == 0
    mha = cases["train_alibi_mha_s128_packed"]
    assert mha["h_kv"] == mha["h"] == 4 and mha["causal"]
    assert int(mha["pos"][0, 48]) == 0 and int(mha["seg"][0, 48]) == 1
    assert not cases["s200_noncausal"]["causal"]
    slopes = torch.from_numpy(alibi_slopes(4))
    errs = {name: {} for name in chip_smoke.FLASH_ALIBI_KERNELS}
    tile_errs = {"flash_bwd_dq_alibi": {}, "flash_bwd_dkv_alibi": {}}
    for i, (name, c) in enumerate(cases.items()):
        chip_smoke.check_alibi_case(torch, cpu, errs, tile_errs, name, c, slopes, seed=i)
    assert len(errs["flash_fwd_alibi"]) == 2 * len(cases)
    assert max(v for e in errs.values() for v in e.values()) == 0.0


TINY = dict(hidden_size=128, n_heads=4, ffn_hidden_size=256, vocab_size=512, dtype="float32",
            max_seq_len=256)


def test_train_alibi_phase_runs_end_to_end_on_cpu(one_thread):
    """BLOOM's configuration at tiny widths through the flash Function's
    plain ALiBi versions: the parity leg agrees to fp32 rounding, the
    decode check holds and its control does not, the per-step counts are
    the ALiBi kernels' alone."""
    rec, launches = chip_smoke.train_alibi_phase(
        torch, torch.device("cpu"), K, widths=dict(TINY, attention_impl="flash"), seq=64,
        timed_steps=1)
    json.dumps(rec)
    assert launches == {name: 0 for name in K.KERNELS}
    assert rec["parity"]["loss_abs_diff"] < 1e-5
    assert max(rec["parity"]["grad_rel_frobenius"].values()) < 1e-4
    assert rec["decode"]["logit_rel_err"] < 1e-4
    assert rec["decode"]["logit_rel_err_shifted"] > chip_smoke.LOGIT_RTOL
    assert rec["launches_per_optimizer_step"] == {name: 4 for name in
                                                  chip_smoke.FLASH_ALIBI_KERNELS}
    assert len(rec["losses"]) == 2 and rec["tok_s"] > 0


def test_remat_check_counts_the_flash_forward_on_cpu(one_thread, monkeypatch):
    """The on-card remat check, with the flash Function's plain versions
    counted as launches: every policy gives remat=False's loss and
    gradients bit for bit, the forward runs 2L times under "nothing" and
    the dots policies and L times under the rest."""
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops.attention import flash as F

    real = F.flash_fwd_reference

    def counted(*a, **kw):
        K.KERNELS["flash_fwd_alibi"].launches += 1
        return real(*a, **kw)

    monkeypatch.setattr(F, "flash_fwd_reference", counted)
    cfg = T.get_config(chip_smoke.ALIBI_MODEL, n_layers=2, attention_impl="flash",
                       **dict(TINY))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = chip_smoke.packed_batch(torch, torch.device("cpu"), rng, 1, 64, cfg.vocab_size)
    out = chip_smoke.remat_check(torch, K, cfg, params, batch, "flash_fwd_alibi")
    assert out["remat_false_launches"] == 2 and out["embed_rel_between_plain_runs"] == 0.0
    assert {p: r["launches"] for p, r in out["policies"].items()} == {
        "nothing": 4, "flash": 2, "flash_qkv": 2, "dots_with_no_batch_dims": 4, "dots": 4,
        "everything": 2}
    assert all(r["embed_rel"] == 0.0 and not r["leaves_unequal"]
               for r in out["policies"].values())


def test_train_moe_phase_runs_end_to_end_on_cpu(one_thread):
    """Mixtral's configuration at tiny widths: the routing of both paths is
    recorded (equal in fp32 on the CPU: no flip), the parity leg agrees to
    fp32 rounding with the aux loss in both losses."""
    rec, launches = chip_smoke.train_moe_phase(
        torch, torch.device("cpu"), K, widths=dict(TINY, n_kv_heads=2, n_experts=4), layers=2,
        seq=64, timed_steps=1)
    json.dumps(rec)
    assert launches == {name: 0 for name in K.KERNELS}
    assert rec["parity"]["routing_flips"] == 0 and rec["parity"]["rows_held"] == 64
    assert rec["parity"]["loss_abs_diff"] < 1e-5
    assert max(rec["parity"]["grad_rel_frobenius"].values()) < 1e-4
    assert rec["launches_per_optimizer_step"]["rms_norm_fwd"] == 10


def test_engine_moe_phase_runs_end_to_end_on_cpu(one_thread):
    """The MoE engine at tiny widths: every logits row routed as in
    forward_reference (fp32), held against the reference under the
    engine's routing and under its own (sums in another order), the
    control off; the capacity-factor-1.25 engine drops choices."""
    engine_config = {
        "dtype": "float32", "decode_steps": 64, "prompt_chunk": 256, "max_prompt_chunks": 4,
        "kv_cache": {"block_size": 16, "num_blocks": 512, "max_blocks_per_seq": 40},
        "state_manager": {"max_tracked_sequences": 16, "max_ragged_batch_size": 1024,
                          "max_ragged_sequence_count": 8, "max_context": 640},
    }
    rec, launches = chip_smoke.engine_moe_phase(
        torch, torch.device("cpu"), K, widths=dict(TINY, n_kv_heads=2, n_experts=4),
        engine_config=engine_config, layers=2, n_prompts=4)
    json.dumps(rec)
    assert launches == {name: 0 for name in K.KERNELS}
    assert rec["routing_flips"] == 0 and rec["rows"] == 4 * 67
    assert rec["logit_rel_err"] < 1e-4 < chip_smoke.LOGIT_RTOL < rec["logit_rel_err_shifted"]
    assert rec["logit_rel_err_own_routing"] < 1e-4 and rec["rows_route_unknown"] == 0
    assert rec["drop_run"]["calls_dropping"] > 0


def test_route_flip_gate_holds_first_flips_to_the_margin():
    """engine_moe's routing gate: a flip with the same experts upstream
    passes only within the margin bound; a flip below or after another
    (a later row, a later layer) is counted and not held."""
    top = np.array([[0, 1]] * 4)
    other = np.array([0, 2])
    low = chip_smoke.ROUTE_MARGIN_RTOL / 2
    margins = [np.full(4, 0.4), np.full(4, 0.4)]

    def routes(*flips):
        eng = [top.copy(), top.copy()]
        for li, p in flips:
            eng[li][p] = other
        return eng

    assert chip_smoke.route_flip_gate([top, top], routes(), margins) == (0, 0, 0.0, 0.0)
    near = [np.array([0.4, low, 0.4, 0.4]), np.full(4, 0.4)]
    # a rounding-sized first flip at layer 0, row 1; then layer 1 at rows
    # 1 and 3 and layer 0 at row 2 follow it or sit beside it
    got = chip_smoke.route_flip_gate([top, top], routes((0, 1), (1, 1), (1, 3)), near)
    assert got == (1, 2, low, 0.4)
    with pytest.raises(AssertionError, match="gate margin"):
        chip_smoke.route_flip_gate([top, top], routes((0, 1), (0, 2)), near)
    with pytest.raises(AssertionError, match="layer 1"):
        chip_smoke.route_flip_gate([top, top], routes((1, 0)), margins)


def test_train_mlm_phase_runs_end_to_end_on_cpu(one_thread):
    """BERT's configuration at tiny widths through the flash Function's
    non-causal plain versions: the MLM parity leg agrees to fp32 rounding;
    the per-step counts are the flash kernels' alone."""
    rec, launches = chip_smoke.train_mlm_phase(
        torch, torch.device("cpu"), K, widths=dict(TINY, attention_impl="flash"), layers=2,
        seq=64, micro=2, timed_steps=1)
    json.dumps(rec)
    assert launches == {name: 0 for name in K.KERNELS}
    assert rec["parity"]["loss_abs_diff"] < 1e-5
    assert max(rec["parity"]["grad_rel_frobenius"].values()) < 1e-4
    assert rec["launches_per_optimizer_step"] == {"flash_fwd": 4, "flash_bwd_dq": 4,
                                                  "flash_bwd_dkv": 4}
    # fp32 weights: the witness's three paths are one function to rounding
    witness = rec["rounding_witness"]
    assert list(witness) == [2] and max(witness[2]["max_vs_fp32"].values()) < 1e-4


# the new phases' HF checkpoint at tiny widths (Mistral's layout and names)
HF_TINY = dict(chip_smoke.HF_CONFIG, hidden_size=128, intermediate_size=256,
               num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
               vocab_size=512)
HF_TINY_ENGINE = {
    "dtype": "bfloat16", "decode_steps": 64, "prompt_chunk": 32, "max_prompt_chunks": 4,
    "kv_cache": {"block_size": 16, "num_blocks": 64, "max_blocks_per_seq": 8},
    "state_manager": {"max_tracked_sequences": 8, "max_ragged_batch_size": 256,
                      "max_ragged_sequence_count": 4, "max_context": 128},
}


def test_hf_layout_writer_and_the_bit_check(tmp_path, one_thread):
    """The phase's checkpoint is an HF checkpoint: ``transformers`` loads
    it as MistralForCausalLM with the written tensors; ``load_hf_model``
    gives the expected leaves bit for bit, and one flipped bit is caught."""
    transformers = pytest.importorskip("transformers")
    from deepspeed_tpu_torch.models import load_hf_model

    cpu = torch.device("cpu")
    hf = chip_smoke.hf_layout_weights(torch, HF_TINY, cpu)
    seconds, size = chip_smoke.write_hf_checkpoint(torch, tmp_path / "hf", HF_TINY, hf)
    assert size > sum(t.numel() * 2 for t in hf.values()) and seconds > 0
    assert len(list((tmp_path / "hf").glob("*.safetensors"))) == chip_smoke.HF_SHARDS
    model = transformers.MistralForCausalLM.from_pretrained(str(tmp_path / "hf"),
                                                            torch_dtype=torch.bfloat16)
    sd = model.state_dict()
    for name, t in hf.items():
        assert torch.equal(sd[name], t), name
    cfg, params = load_hf_model(str(tmp_path / "hf"), dtype="bfloat16", device="cpu")
    assert cfg.n_layers == 2 and cfg.sliding_window == 4096
    want = chip_smoke.expected_hf_params(torch, hf, 2)
    assert chip_smoke.bits_mismatches(torch, params, want) == []
    flipped = params["layers"]["wk"].clone()
    flipped.view(torch.int16)[1, 3, 5] ^= 1
    params["layers"]["wk"] = flipped
    assert chip_smoke.bits_mismatches(torch, params, want) == ["layers/wk"]


def test_import_phases_run_end_to_end_on_cpu(tmp_path, one_thread, capsys):
    """hf_import, serve_cli (``dstpu serve`` as a subprocess on the
    directory), train_import (the default-store round trip and
    zero_to_fp32 included) and graft_entry at tiny widths: through
    ``import_phases`` (its records printed, its directory removed), then
    each phase's record."""
    cpu = torch.device("cpu")
    hf_kw = dict(hf_config=HF_TINY, engine_config=HF_TINY_ENGINE, prompt_lens=(8, 40))
    train_kw = dict(layers=1, seq=32, lr=1e-2)
    launches = chip_smoke.import_phases(torch, cpu, K, tmp_path, "cpu", hf_kw, train_kw)
    assert sorted(launches) == ["graft_entry", "hf_import", "train_import"]
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [r["phase"] for r in lines] == ["hf_import", "serve_cli", "train_import",
                                           "graft_entry"]
    # dstpu serve in a subprocess on hf_import's directory answered generate()'s tokens
    assert lines[1]["equal"] and lines[1]["new_tokens"] == chip_smoke.SERVE_CLI_NEW
    assert all(r["seconds"] > 0 and r["card"] == "cpu" for r in lines)
    assert lines[0]["disk_free_gb"] > 0 and list((tmp_path / "build").iterdir()) == []
    rec, launches = chip_smoke.hf_import_phase(torch, cpu, K, tmp_path, **hf_kw)
    assert rec["shards"] == 2 and rec["leaves_checked"] == 12
    assert rec["prefill_logit_rel_err"] <= rec["logit_rtol"] < rec["shifted_logit_rel_err"]
    assert rec["launches_expected"]["paged_decode"] == 2 * (rec["forward_steps"]["split"] + 64)
    rec, launches = chip_smoke.train_import_phase(torch, cpu, K, tmp_path, **train_kw)
    assert rec["losses"][1] < rec["losses"][0] and rec["zero_to_fp32_tensors"] == 12
    assert rec["launches_expected"]["flash_fwd"] == 2 * 2 and rec["n_layers"] == 1
    assert os.path.islink(tmp_path / "hf_cut" / "model.safetensors.index.json")
    assert (tmp_path / "ckpt" / "zero_to_fp32.py").is_file()
    rec, launches = chip_smoke.graft_entry_phase(torch, cpu, K)
    assert rec["shape"] == [2, 128, 512] and rec["heads"] == [2, 64]
    assert rec["logit_rel_err"] <= rec["logit_rtol"]


QUANT_WIDTHS = dict(n_layers=2, hidden_size=128, n_heads=4, n_kv_heads=2, ffn_hidden_size=256,
                    vocab_size=512, dtype="float32")
QUANT_ENGINE = {
    "dtype": "float32", "decode_steps": 64, "prompt_chunk": 256, "max_prompt_chunks": 4,
    "kv_cache": {"block_size": 16, "num_blocks": 1024, "max_blocks_per_seq": 40},
    "state_manager": {"max_tracked_sequences": 64, "max_ragged_batch_size": 1024,
                      "max_ragged_sequence_count": 32, "max_context": 640},
}


def test_quant_phases_run_end_to_end_on_cpu(one_thread, capsys, monkeypatch):
    """qmatmul, train_qmm, serve_wq8, serve_wq4, fp_quantizer and lora at
    tiny widths through ``quant_phases`` (each record printed with its
    seconds). The bf16 engine's prefill rows are stood in for by the
    plain forward over the same wide weights and prompts; the throughput
    runs are cut to 4 sequences of 8 tokens."""
    from deepspeed_tpu_torch.inference.v2 import engine_v2
    from deepspeed_tpu_torch.models import transformer as T

    cpu = torch.device("cpu")
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    from deepspeed_tpu_torch.accelerator import real_accelerator

    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    bench = engine_v2.serving_benchmark
    monkeypatch.setattr(engine_v2, "serving_benchmark",
                        lambda eng, **kw: bench(eng, **dict(kw, n_seq=4, max_new=8)))
    cfg = T.get_config(chip_smoke.MODEL, **QUANT_WIDTHS)
    params = T.init_params(cfg, torch.Generator().manual_seed(chip_smoke.SEED), "cpu")
    rng = np.random.default_rng(chip_smoke.SEED)
    lens = rng.integers(64, 512, size=32)
    prefill = {}
    with torch.no_grad():
        for uid, n in enumerate(lens):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=int(n)))[None]
            prefill[uid] = T.forward_reference(params, toks, cfg)[0][0, -1]
    bf16 = {"gen_tok_s": 1.0, "round_tok_s": 1.0, "prefill": prefill}
    launches = chip_smoke.quant_phases(
        torch, cpu, K, "cpu", bf16=bf16,
        serve_kw=dict(widths=QUANT_WIDTHS, engine_config=QUANT_ENGINE),
        qmm_kw=dict(shapes={"train": (64, 128, 96), "decode": (8, 128, 96)}),
        train_kw=dict(widths={k: v for k, v in QUANT_WIDTHS.items() if k != "n_layers"},
                      layers=2, seq=32),
        fpq_kw=dict(shape=(64, 96)), lora_kw=dict(in_f=64, out_f=96, r=8, tokens=16))
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    names = ["qmatmul", "train_qmm", "serve_wq8", "serve_wq4", "serve_wq8_int8", "fp_quantizer",
             "lora"]
    assert [r["phase"] for r in lines[-7:]] == names and sorted(launches) == sorted(names)
    assert all(r["seconds"] > 0 and r["card"] == "cpu" for r in lines[-7:])
    rec = {r["phase"]: r for r in lines[-7:]}
    q = rec["qmatmul"]["shapes"]["decode"]
    assert q["int8_rows_padded_to"] == 24 and q["fp8_rows_padded_to"] == 16
    for mode in ("int8", "int8_tensor"):
        assert q["modes"][mode]["mismatches"] == 0 and q["modes"][mode]["dx_mismatches"] == 0
    assert q["modes"]["fp8"]["rel_frobenius"] <= chip_smoke.QMM_FP8_RTOL
    assert q["modes"]["fp8"]["bf16_out_max_abs_err"] <= q["modes"]["fp8"]["bf16_out_bound"]
    t = rec["train_qmm"]
    assert sorted(t["modes"]) == sorted(chip_smoke.QMM_TRAIN_MODES)
    assert max(t["first_loss_diff"].values()) <= chip_smoke.QMM_LOSS_ATOL
    assert t["first_loss_diff"]["int8"] > 0  # the quantized forward ran
    assert launches["train_qmm"]["default"] == {name: 0 for name in K.KERNELS}
    # FusedAdam launches a kernel per leaf of at least 65536 elements (5 here)
    big = sum(w.numel() >= 1 << 16 for w in chip_smoke.leaves(params).values())
    assert t["modes"]["int8"]["launches_per_optimizer_step"]["fused_adam"] == big == 5
    for bits, ratio in ((8, 0.55), (4, 0.4)):
        s = rec[f"serve_wq{bits}"]
        assert s["quant"]["bits"] == bits and s["memory_over_wide"] < ratio
        assert s["logit_rel_err"]["prefill"] <= s["logit_rtol"] < s["logit_rel_err"]["shifted"]
        assert s["bf16_prefill_corr"] >= chip_smoke.QUANT_CORR_MIN[bits]
        wc = s["weight_check"]
        # wk and wv stay wide at this width: their 64 columns are not a group
        assert {"wq", "wo", "w_up", "w_gate", "w_down", "lm_head"} == set(wc["leaves"])
        assert all(r["mismatches"] == 0 for r in wc["leaves"].values())
        assert wc["max_rel_frobenius"] <= chip_smoke.QUANT_WEIGHT_RTOL[bits]
        assert s["gen_tok_s_over_bf16"] > 0
    assert rec["serve_wq4"]["bf16_prefill_rel_err"] > rec["serve_wq8"]["bf16_prefill_rel_err"]
    # weight-only int8 over the int8 pool: at 2 layers, held to the int8 engine's bounds
    p = rec["serve_wq8_int8"]
    assert p["n_layers"] == 2 and p["kv_cache_dtype"] == "int8" and p["quant"]["bits"] == 8
    assert p["logit_rel_err"]["prefill"] <= p["logit_rtol"] == chip_smoke.INT8_LOGIT_RTOL
    assert p["dense_logit_rel_err"] <= chip_smoke.LOGIT_RTOL
    assert p["launches_expected"]["block_quant"] == 2 * sum(p["forward_steps"].values())
    f = rec["fp_quantizer"]
    assert f["fp8_cast"]["mismatches"] == 0 and f["formats"]["fp6"]["bytes"] == 64 * 96 // 4 * 3
    lo = rec["lora"]
    assert lo["base_grad"] is False and lo["merge_max_abs_err"] <= lo["merge_bound"]
    assert lo["base_rel_frobenius"] < 0.01


# ---------------------------------------------------------------------------
# the serving phase: the driver, the HTTP server, tracing and spec over the
# engine phase's engine (here a tiny one), and its helpers
# ---------------------------------------------------------------------------
SERVE_TINY_WIDTHS = dict(n_layers=2, hidden_size=128, n_heads=4, n_kv_heads=2,
                         ffn_hidden_size=256, vocab_size=512, dtype="float32")


def _serve_tiny_engine(kv_cache_dtype="bf16"):
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as T

    cfg = T.get_config(chip_smoke.MODEL, **SERVE_TINY_WIDTHS)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    rc = RaggedInferenceEngineConfig.from_dict({
        "dtype": "float32", "decode_steps": 8, "prompt_chunk": 64, "max_prompt_chunks": 4,
        "kv_cache": {"block_size": 16, "num_blocks": 128, "max_blocks_per_seq": 12,
                     "kv_cache_dtype": kv_cache_dtype},
        "state_manager": {"max_tracked_sequences": 16, "max_ragged_batch_size": 256,
                          "max_ragged_sequence_count": 8, "max_context": 192}})
    return InferenceEngineV2(cfg, params, rc, device="cpu")


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_serving_phase_runs_end_to_end_on_cpu(one_thread, kv_cache_dtype):
    """8 clients (4 streamed) over HTTP: every stream equals generate()'s
    and the engine's steps replayed on the driver's schedule, /health and
    /metrics answer, the traced pass holds the engine's dispatch /
    device-wait spans and 8 request trees, the spec pass verifies, the
    planted feedback fault is caught by the replay and by the margin; on
    the CPU the plain versions run and no kernel launches."""
    eng = _serve_tiny_engine(kv_cache_dtype)
    int8 = kv_cache_dtype == "int8"
    prompts = chip_smoke.serve_prompts(512, n=8, lens=(20, 150))
    rec, launches = chip_smoke.serving_phase(torch, torch.device("cpu"), K, eng, int8=int8,
                                             prompts=prompts, new_tokens=8)
    json.dumps(rec)
    passes = ["timed", "profiled"] + ([] if int8 else ["traced", "spec"])
    assert [k for k in passes if k in rec] == passes
    for name in passes:
        st = rec[name]["streams"]
        assert (st["equal"], st["near_tie_flips"], st["tokens_checked"]) == (8, [], 64), name
        if name in ("timed", "spec"):
            assert rec[name]["replay"]["equal"] == 8 and rec[name]["replay"]["diverged"] == []
        # fp32: the served tokens are the plain forward's argmax; an int8 pool's
        # codes carry absmax / 254 of rounding against its unquantized K/V
        assert st["max_margin"] < (1e-2 if int8 else 1e-4)
        assert set(rec[name]["launches"].values()) == {0}
        plain = rec[name]["plain_calls"]
        assert plain["rms_norm_reference"] > 0 and plain["paged_decode_attention_dense"] > 0
        assert (plain["block_quant_reference"] > 0) == int8
    planted = rec["planted"]
    assert planted["caught"] == {"replay": True, "margin": True}
    assert planted["replay"]["equal"] < 8 and planted["streams"]["max_margin"] > rec["logit_rtol"]
    t = rec["timed"]
    assert t["generated"] == 8 * 8 and t["tok_s"] > 0
    assert 0 < t["ttft_s"]["p50"] <= t["ttft_s"]["p99"]
    assert rec["profiled"]["idle_share"] is None  # no card: not measured
    assert launches == {name: 0 for name in K.KERNELS}
    if not int8:
        tr = rec["traced"]["trace"]
        assert tr["request_trees"] == 8 and tr["engine.dispatch"]["count"] > 0
        assert tr["engine.dispatch"]["count"] == tr["engine.device_wait"]["count"]
        assert rec["spec"]["spec"]["spec_rounds_total"] > 0
    line = chip_smoke.serving_note(rec, "cpu")
    assert "TTFT" in line and "not measured" in line and line.endswith("on cpu")
    # nothing of the passes keeps the engine alive: the phases after this one
    # need its card memory back once the caller lets go of it
    import weakref

    ref = weakref.ref(eng)
    del eng
    assert ref() is None


def test_serving_helpers():
    """The request mix, the percentile and idle-share arithmetic, the
    stream comparison's divergence index and the /metrics parser."""
    ps = chip_smoke.serve_prompts(1000)
    assert len(ps) == chip_smoke.SERVE_CLIENTS
    lo, hi = chip_smoke.SERVE_PROMPT_LENS
    assert all(lo <= len(p) <= hi and p.dtype == np.int32 for p in ps)
    assert np.array_equal(ps[0][:16], ps[0][16:32])  # a motif prompt repeats
    assert [len(p) for p in ps] == [len(p) for p in chip_smoke.serve_prompts(1000)]
    assert chip_smoke.percentiles(range(1, 101)) == {"p50": 50.5, "p99": 99.01}
    assert chip_smoke.percentiles([None]) == {"p50": None, "p99": None}
    assert chip_smoke.idle_share(30.0, 100.0) == pytest.approx(0.7)
    assert chip_smoke.idle_share(None, 100.0) is None
    assert chip_smoke.idle_share(120.0, 100.0) == 0.0
    assert chip_smoke.first_divergence([1, 2, 3], [1, 2, 3]) is None
    assert chip_smoke.first_divergence([1, 5, 3], [1, 2, 3]) == 1
    assert chip_smoke.first_divergence([1, 2], [1, 2, 3]) == 2
    got = chip_smoke.parse_prometheus('# TYPE a counter\na 3\nb{le="+Inf"} 1.5\n')
    assert got == {"a": 3.0, 'b{le="+Inf"}': 1.5}
    with pytest.raises(AssertionError, match="Prometheus"):
        chip_smoke.parse_prometheus("not a sample line\n")


def test_compare_streams_holds_each_token_to_the_reference_margin(one_thread):
    """Every served token must be a greedy pick of the plain forward up to
    the limit: a stream that takes the runner-up passes only when the two
    are within it (reported as a near-tie flip), a token far below the
    largest logit fails, and so does a stream of another length."""
    from deepspeed_tpu_torch.models import transformer as T

    eng = _serve_tiny_engine()
    prompt = np.arange(1, 30, dtype=np.int32)
    with torch.no_grad():
        row = T.forward_reference(eng.params, torch.as_tensor(prompt[None].astype(np.int64)),
                                  eng._mc)[0][0, -1].float()
    order = torch.argsort(row, descending=True).tolist()
    margin = float((row[order[0]] - row[order[1]]) / row.abs().max())
    want, got = [[order[0]]], [[order[1]]]
    out = chip_smoke.compare_streams(torch, eng, [prompt], got, want, rtol=margin * 1.01)
    assert out["equal"] == 0 and out["near_tie_flips"][0]["at"] == 0
    assert out["near_tie_flips"][0]["margin"] == pytest.approx(margin)
    assert out["tokens_checked"] == 1 and out["max_margin"] == pytest.approx(margin)
    with pytest.raises(AssertionError, match="largest logit"):
        chip_smoke.compare_streams(torch, eng, [prompt], got, want, rtol=margin * 0.99)
    with pytest.raises(AssertionError, match="largest logit"):
        chip_smoke.compare_streams(torch, eng, [prompt], [[order[-1]]], [[order[-1]]], rtol=0.05)
    with pytest.raises(AssertionError, match="tokens"):
        chip_smoke.compare_streams(torch, eng, [prompt], [[order[0]]], [order[:2]], rtol=1.0)
    assert chip_smoke.compare_streams(torch, eng, [prompt], want, want, rtol=0.0) == {
        "equal": 1, "near_tie_flips": [], "tokens_checked": 1, "max_margin": 0.0}


def test_trace_summary_counts_engine_spans_and_trees():
    """The traced pass's checks on a hand-made document: spans counted on
    the engine track, request trees by their roots, an invalid document or
    a missing tree fails."""
    ev = lambda name, pid, tid, ts, dur: {"ph": "X", "name": name, "pid": pid,  # noqa: E731
                                          "tid": tid, "ts": ts, "dur": dur}
    doc = {"traceEvents": [ev("engine.dispatch", 2, 1, 0.0, 3000.0),
                           ev("engine.device_wait", 2, 1, 3000.0, 1000.0),
                           ev("step.split", 2, 1, 0.0, 4000.0),
                           ev("request", 1, 0, 0.0, 5000.0), ev("queued", 1, 0, 0.0, 10.0),
                           ev("request", 1, 1, 0.0, 5000.0)], "displayTimeUnit": "ms"}
    out = chip_smoke.trace_summary(doc, 2)
    assert out["request_trees"] == 2 and out["engine.dispatch"] == {"count": 1, "ms": 3.0}
    assert out["device_wait_share"] == pytest.approx(0.25)
    with pytest.raises(AssertionError, match="request trees"):
        chip_smoke.trace_summary(doc, 3)
    with pytest.raises(AssertionError, match="Chrome"):
        chip_smoke.trace_summary({"traceEvents": [{"ph": "X"}]}, 0)
