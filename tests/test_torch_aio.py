"""The port's async file I/O against the JAX package's.

``deepspeed_tpu_torch.ops.aio.AioHandle`` and ``deepspeed_tpu.ops.aio.
AioHandle`` drive the same ``csrc/aio/dstpu_aio.cpp``; the port's buffers
are CPU tensors, the JAX package's numpy arrays. On the same seeded bytes
the files either writes are equal byte for byte, at offsets too, and each
reads the other's files back. Writes never truncate (the engine's offset
rule), a missing file raises, and the plain versions (``_py_pread`` /
``_py_pwrite``) agree with the engine. ``io_bench`` runs over the port's
handle with the JAX tool's CLI and output.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import aio as JA
from deepspeed_tpu.utils import io_bench as jio
from deepspeed_tpu_torch.ops import aio as PA
from deepspeed_tpu_torch.utils import io_bench as pio


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_files_equal_the_jax_handles_byte_for_byte(tmp_path, dtype):
    """Sync and async writes at offsets 0 and 4096 + 3 of the same bytes:
    the port's files equal the JAX handle's; each reads the other's back."""
    raw = _bytes(3 * (1 << 20) + 12)  # not a multiple of the block size
    t = torch.from_numpy(raw.copy()).view(dtype)
    a = raw.copy()
    ph = PA.AioHandle(block_size=1 << 16, intra_op_parallelism=3)
    jh = JA.AioHandle(block_size=1 << 16, intra_op_parallelism=3)
    assert JA.is_native()
    for off in (0, 4096 + 3):
        pf, jf = tmp_path / f"p{off}.bin", tmp_path / f"j{off}.bin"
        assert ph.sync_pwrite(t, str(pf), off) == raw.size
        jh.sync_pwrite(a, str(jf), off)
        assert _read(pf) == _read(jf) and len(_read(pf)) == off + raw.size
        af, bf = tmp_path / f"pa{off}.bin", tmp_path / f"ja{off}.bin"
        assert ph.async_pwrite(t, str(af), off) > 0
        jh.async_pwrite(a, str(bf), off)
        assert ph.wait() == 1 and jh.wait() == 1 and ph.pending() == 0
        assert _read(af) == _read(bf) == _read(pf)
        back = torch.empty_like(t)
        ph.sync_pread(back, str(jf), off)
        assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))
        jback = np.empty_like(a)
        jh.sync_pread(jback, str(pf), off)
        assert np.array_equal(jback, a)
        back.zero_()
        ph.async_pread(back, str(bf), off)
        ph.wait()
        assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))
    ph.close()


def test_writes_do_not_truncate_and_short_reads_zero_fill(tmp_path):
    """A shorter rewrite leaves the old tail (as the engine documents), and a
    read past the end zero-fills, in the engine and the plain versions."""
    h = PA.AioHandle()
    f = str(tmp_path / "x.bin")
    long, short = torch.arange(1000, dtype=torch.int32), torch.full((10,), -1, dtype=torch.int32)
    h.sync_pwrite(long, f)
    h.sync_pwrite(short, f)
    assert os.path.getsize(f) == 4000
    back = torch.empty(1000, dtype=torch.int32)
    h.sync_pread(back, f)
    assert torch.equal(back[:10], short) and torch.equal(back[10:], long[10:])
    plain = torch.empty(1000, dtype=torch.int32)
    PA.AioHandle._py_pread(plain, f, 0)
    assert torch.equal(plain, back)
    over = torch.full((20,), 7, dtype=torch.int32)
    h.sync_pread(over, f, 3960)
    plain = torch.full((20,), 7, dtype=torch.int32)
    PA.AioHandle._py_pread(plain, f, 3960)
    assert torch.equal(over, plain) and torch.equal(over[10:], torch.zeros(10, dtype=torch.int32))
    g = str(tmp_path / "plain.bin")
    PA.AioHandle._py_pwrite(long, g, 0)
    PA.AioHandle._py_pwrite(short, g, 0)
    assert _read(g) == _read(f)
    h.close()


def test_a_missing_file_raises_in_both_packages(tmp_path):
    missing = str(tmp_path / "nope.bin")
    buf = torch.zeros(16)
    h = PA.AioHandle()
    for call in (h.sync_pread, h.async_pread):
        with pytest.raises(FileNotFoundError):
            call(buf, missing)
    with pytest.raises(FileNotFoundError):
        JA.AioHandle().sync_pread(np.zeros(16, np.float32), missing)
    with pytest.raises(FileNotFoundError):
        PA.AioHandle._py_pread(buf, missing, 0)
    with pytest.raises(ValueError, match="contiguous CPU"):
        h.sync_pwrite(torch.zeros(8, 2).t(), str(tmp_path / "x"))
    h.close()


def test_locked_tensors_are_page_aligned_and_freed(tmp_path):
    """Without a card the handle hands out the library's page-aligned
    buffers as tensors of the asked dtype; a write and a read through them
    round-trip, and freeing forgets them."""
    h = PA.AioHandle()
    t = h.new_cpu_locked_tensor(1000, torch.bfloat16)
    assert t.dtype == torch.bfloat16 and t.numel() == 1000 and t.data_ptr() % 4096 == 0
    assert not t.is_pinned()
    t.copy_(torch.linspace(-3, 3, 1000))
    f = str(tmp_path / "l.bin")
    h.sync_pwrite(t, f)
    u = h.new_cpu_locked_tensor(1000, torch.bfloat16)
    h.sync_pread(u, f)
    assert torch.equal(t, u)
    h.free_cpu_locked_tensor(t)
    h.free_cpu_locked_tensor(u)
    assert not h._pinned
    assert (h.get_block_size(), h.get_queue_depth(), h.get_intra_op_parallelism()) == (
        1 << 20, 8, 4)
    h.close()
    assert h._h is None


def test_the_builder_hands_out_the_library():
    from deepspeed_tpu_torch.ops.op_builder import ALL_OPS

    assert ALL_OPS["async_io"] is PA.AsyncIOBuilder
    assert PA.AsyncIOBuilder().load(verbose=False) is PA.AsyncIOBuilder.lib()
    assert PA.AsyncIOBuilder().is_compatible()


@pytest.mark.parametrize("argv", [[], ["--read"]])
def test_io_bench_prints_the_jax_tools_record(tmp_path, argv):
    """The port's ``io_bench`` takes the JAX tool's flags and prints the
    same keys (bandwidth is this host's, never compared)."""
    out = {}
    for name, mod in (("port", pio), ("jax", jio)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main(["--path", str(tmp_path), "--size_mb", "1", "--block_size",
                             str(1 << 16), "--parallelism", "2", *argv]) == 0
        out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["port"].keys() == out["jax"].keys()
    assert {k: v for k, v in out["port"].items() if k != "GB_per_s"} == \
        {k: v for k, v in out["jax"].items() if k != "GB_per_s"}
    assert out["port"]["GB_per_s"] > 0
    assert not list(tmp_path.iterdir())  # the bench file is removed


def test_io_bench_tune_reports_the_best(tmp_path, monkeypatch):
    rows = []
    monkeypatch.setattr(pio, "_bench_one",
                        lambda path, mb, bs, par, read: rows.append((bs, par)) or bs * par)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pio.main(["--path", str(tmp_path), "--tune", "--size_mb", "1"])
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    assert len(rows) == 16 and len(lines) == 17
    assert lines[-1]["best"] == {"block_size": 16 << 20, "parallelism": 8,
                                 "GB_per_s": float(16 << 20) * 8}
