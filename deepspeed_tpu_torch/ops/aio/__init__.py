"""Async host file I/O, the NVMe tier's engine.

Counterpart of ``deepspeed_tpu/ops/aio``: the native engine is
``csrc/aio/dstpu_aio.cpp`` (shared with the JAX package, read-only), a pool
of worker threads that slices each read or write in ``block_size`` chunks,
built by ``AsyncIOBuilder`` at first use and bound with ctypes. Buffers are
contiguous CPU tensors of any dtype, passed by ``data_ptr()``.

``new_cpu_locked_tensor`` hands out a page-locked tensor: CUDA-pinned when
the process has a card (so a swap buffer can feed a ``non_blocking`` copy
to the device), the library's page-aligned buffer otherwise. Writes are
positional and never truncate (``dstpu_aio.cpp``'s offset-write rule): a
shorter rewrite leaves the old tail. ``_py_pread`` / ``_py_pwrite`` are the
plain versions the tests hold the engine against; no entry point takes
them.
"""

import ctypes
import os

import numpy as np
import torch

from deepspeed_tpu_torch.ops.op_builder import NativeOpBuilder


class AsyncIOBuilder(NativeOpBuilder):
    NAME = "async_io"
    SOURCES = ("aio/dstpu_aio.cpp",)

    @staticmethod
    def _bind(lib):
        p, i32, i64, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p
        lib.dstpu_aio_handle_new.restype = p
        lib.dstpu_aio_handle_new.argtypes = [i64, i32, i32, i32, i32]
        lib.dstpu_aio_handle_free.restype = None
        lib.dstpu_aio_handle_free.argtypes = [p]
        for fn in ("dstpu_aio_async_pread", "dstpu_aio_async_pwrite",
                   "dstpu_aio_sync_pread", "dstpu_aio_sync_pwrite"):
            f = getattr(lib, fn)
            f.restype = i64
            f.argtypes = [p, p, i64, cp, i64]
        lib.dstpu_aio_wait.restype = i64
        lib.dstpu_aio_wait.argtypes = [p]
        lib.dstpu_aio_pending.restype = i64
        lib.dstpu_aio_pending.argtypes = [p]
        lib.dstpu_aio_block_size.restype = i64
        lib.dstpu_aio_block_size.argtypes = [p]
        lib.dstpu_aio_alloc_pinned.restype = p
        lib.dstpu_aio_alloc_pinned.argtypes = [i64]
        lib.dstpu_aio_free_pinned.restype = None
        lib.dstpu_aio_free_pinned.argtypes = [p]
        lib.dstpu_aio_file_size.restype = i64
        lib.dstpu_aio_file_size.argtypes = [cp]


def _check(buf):
    if not (isinstance(buf, torch.Tensor) and buf.device.type == "cpu" and buf.is_contiguous()):
        raise ValueError("aio buffers must be contiguous CPU tensors")
    return buf.data_ptr(), buf.numel() * buf.element_size()


def _raise_for(rc, filename=None):
    if rc < 0:
        if filename is None:
            raise OSError(-rc, os.strerror(-rc))
        raise OSError(-rc, os.strerror(-rc), filename)
    return rc


class AioHandle:
    """The reference ``aio_handle`` (csrc/aio/py_lib/py_ds_aio.cpp): one
    handle owns ``intra_op_parallelism`` worker threads; ``wait()`` blocks
    until every async op retires and returns how many it retired."""

    def __init__(self, block_size=1 << 20, queue_depth=8, single_submit=False,
                 overlap_events=True, intra_op_parallelism=4):
        self._lib = AsyncIOBuilder.lib()
        self._block_size = block_size
        self._queue_depth = queue_depth
        self._parallelism = intra_op_parallelism
        self._pinned = {}  # data_ptr -> library base pointer, or None (CUDA-pinned)
        self._h = self._lib.dstpu_aio_handle_new(block_size, queue_depth, int(single_submit),
                                                 int(overlap_events), intra_op_parallelism)

    def get_block_size(self):
        return self._block_size

    def get_queue_depth(self):
        return self._queue_depth

    def get_intra_op_parallelism(self):
        return self._parallelism

    def _call(self, fn, buffer, filename, file_offset):
        ptr, n = _check(buffer)
        return _raise_for(fn(self._h, ptr, n, os.fsencode(filename), file_offset), filename), n

    def sync_pread(self, buffer, filename, file_offset=0):
        return self._call(self._lib.dstpu_aio_sync_pread, buffer, filename, file_offset)[1]

    def sync_pwrite(self, buffer, filename, file_offset=0):
        return self._call(self._lib.dstpu_aio_sync_pwrite, buffer, filename, file_offset)[1]

    def async_pread(self, buffer, filename, file_offset=0):
        """Submit a read; the buffer must stay alive until ``wait()``."""
        return self._call(self._lib.dstpu_aio_async_pread, buffer, filename, file_offset)[0]

    def async_pwrite(self, buffer, filename, file_offset=0):
        """Submit a write; the buffer must stay alive until ``wait()``."""
        return self._call(self._lib.dstpu_aio_async_pwrite, buffer, filename, file_offset)[0]

    def wait(self):
        return _raise_for(self._lib.dstpu_aio_wait(self._h))

    def pending(self):
        return self._lib.dstpu_aio_pending(self._h)

    def new_cpu_locked_tensor(self, num_elem, dtype=torch.float32):
        """A 1-D page-locked tensor of ``num_elem`` elements (see the module
        docstring); free it with ``free_cpu_locked_tensor``."""
        num_elem = int(num_elem)
        if torch.cuda.is_available():
            t = torch.empty(num_elem, dtype=dtype, pin_memory=True)
            self._pinned[t.data_ptr()] = None
            return t
        nbytes = num_elem * torch.empty((), dtype=dtype).element_size()
        base = self._lib.dstpu_aio_alloc_pinned(max(nbytes, 1))
        if not base:
            raise MemoryError(f"page-aligned alloc of {nbytes} bytes failed")
        raw = torch.frombuffer((ctypes.c_char * max(nbytes, 1)).from_address(base),
                               dtype=torch.uint8)
        t = raw[:nbytes].view(dtype)
        self._pinned[t.data_ptr()] = base
        return t

    def free_cpu_locked_tensor(self, t):
        base = self._pinned.pop(t.data_ptr(), None)
        if base is not None:
            self._lib.dstpu_aio_free_pinned(base)

    # -- the plain versions --
    @staticmethod
    def _py_pread(buffer, filename, offset):
        nbytes = buffer.numel() * buffer.element_size()
        with open(filename, "rb") as f:
            f.seek(offset)
            data = f.read(nbytes)
        flat = buffer.reshape(-1).view(torch.uint8).numpy()
        flat[: len(data)] = np.frombuffer(data, dtype=np.uint8)
        flat[len(data):] = 0
        return nbytes

    @staticmethod
    def _py_pwrite(buffer, filename, offset):
        fd = os.open(filename, os.O_WRONLY | os.O_CREAT, 0o644)
        try:
            os.pwrite(fd, buffer.reshape(-1).view(torch.uint8).numpy().tobytes(), offset)
        finally:
            os.close(fd)
        return buffer.numel() * buffer.element_size()

    def close(self):
        """Join the workers and free the library's buffers."""
        if self._h is not None:
            self._lib.dstpu_aio_handle_free(self._h)
            self._h = None
            for base in self._pinned.values():
                if base is not None:
                    self._lib.dstpu_aio_free_pinned(base)
            self._pinned.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown
            pass


def aio_handle(*args, **kwargs):
    """Factory under the reference's module-level constructor name."""
    return AioHandle(*args, **kwargs)


__all__ = ["AioHandle", "AsyncIOBuilder", "aio_handle"]
