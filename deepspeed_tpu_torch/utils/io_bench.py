"""dstpu_io: the AIO engine's bandwidth benchmark.

Counterpart of ``deepspeed_tpu/utils/io_bench.py`` (reference ``bin/ds_io``
and ``bin/ds_nvme_tune``) over the port's ``AioHandle``: sustained read or
write bandwidth of the native engine into a directory, for one
(block_size, intra_op_parallelism) or, with ``--tune``, a sweep that
reports the best. One JSON object a line, as the JAX tool prints them.

    python -m deepspeed_tpu_torch.utils.io_bench [--path DIR] [--size_mb N]
        [--block_size B] [--parallelism P] [--read] [--tune]
"""

import argparse
import json
import os
import tempfile
import time

import torch

from deepspeed_tpu_torch.utils.logging import logger


def _bench_one(path, size_mb, block_size, parallelism, read):
    from deepspeed_tpu_torch.ops.aio import AioHandle

    h = AioHandle(block_size=block_size, intra_op_parallelism=parallelism)
    buf = h.new_cpu_locked_tensor(size_mb * (1 << 20) // 4, torch.float32)
    buf.fill_(1.0)
    try:
        if read:
            h.sync_pwrite(buf, path)  # seed the file
            # drop the file's pages so the read measures the device, not
            # the page cache
            try:
                fd = os.open(path, os.O_RDONLY)
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                os.close(fd)
            except (OSError, AttributeError):
                logger.warning("could not drop page cache; read bandwidth may be cache-bound")
        t0 = time.perf_counter()
        if read:
            h.sync_pread(buf, path)
        else:
            h.sync_pwrite(buf, path)
        dt = time.perf_counter() - t0
    finally:
        h.free_cpu_locked_tensor(buf)
        h.close()
    return size_mb / 1024 / dt  # GB/s


def main(argv=None) -> int:
    p = argparse.ArgumentParser("dstpu_io", description=__doc__.split("\n\n")[0])
    p.add_argument("--path", default=None, help="target dir (default: tmp)")
    p.add_argument("--size_mb", type=int, default=256)
    p.add_argument("--block_size", type=int, default=1 << 20)
    p.add_argument("--parallelism", type=int, default=4)
    p.add_argument("--read", action="store_true", help="bench reads (default writes)")
    p.add_argument("--tune", action="store_true", help="sweep block/parallelism")
    args = p.parse_args(argv)

    target_dir = args.path or tempfile.gettempdir()
    path = os.path.join(target_dir, "dstpu_io_bench.bin")
    try:
        if args.tune:
            best = None
            for bs in (256 << 10, 1 << 20, 4 << 20, 16 << 20):
                for par in (1, 2, 4, 8):
                    gbs = _bench_one(path, args.size_mb, bs, par, args.read)
                    row = {"block_size": bs, "parallelism": par, "GB_per_s": round(gbs, 3)}
                    print(json.dumps(row))
                    if best is None or gbs > best["GB_per_s"]:
                        best = row
            print(json.dumps({"best": best}))
        else:
            gbs = _bench_one(path, args.size_mb, args.block_size, args.parallelism, args.read)
            print(json.dumps({
                "op": "read" if args.read else "write",
                "size_mb": args.size_mb,
                "block_size": args.block_size,
                "parallelism": args.parallelism,
                "GB_per_s": round(gbs, 3),
            }))
    finally:
        if os.path.exists(path):
            os.remove(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
