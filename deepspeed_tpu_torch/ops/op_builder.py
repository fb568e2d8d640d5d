"""Op registry (counterpart of ``deepspeed_tpu/ops/op_builder.py``).

``get_accelerator().create_op_builder(name).load()`` hands out an op: the
port's module or function for it. ``CUDAOpBuilder`` takes the place of the
JAX package's ``PallasOpBuilder``: its ``load()`` builds the op's kernel
sources (``ops.kernels.build``, one ``nvcc`` per source, all together) when
the accelerator is the CUDA one, and raises if a build fails or there is no
card; on the CPU accelerator it hands out the op, whose wrappers take their
plain versions for CPU tensors. An op the port does not have yet is
registered all the same (``UnportedOpBuilder``): it is not compatible and
its ``load()`` raises, naming its ROADMAP item.

Host ops (the CPU optimizers of the offload tiers and the async file I/O
of the NVMe tier) are C++ under ``csrc/``, shared with the JAX package and
built read-only: ``NativeOpBuilder`` compiles its sources with ``g++`` at
first use into ``build/torch_kernels/host/`` (``jit_native``) and binds the
library's plain C ABI with ctypes, as the CUDA libraries are bound. A build
that fails raises with the compiler's message: there is no switch that
turns a native op off and no fallback on an entry point.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

from deepspeed_tpu_torch.utils.logging import logger

REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC_DIR = REPO_ROOT / "csrc"
HOST_BUILD_DIR = REPO_ROOT / "build" / "torch_kernels" / "host"
HOST_FLAGS = ("-fopenmp", "-march=native", "-funroll-loops")
_HOST_BUILD_LOCK = threading.Lock()


class OpBuilder:
    """Base class: a named, lazily-loaded op implementation."""

    NAME = "base_op"

    def __init__(self):
        self._loaded = None

    def is_compatible(self, verbose=False):
        return True

    def load(self, verbose=True):
        if self._loaded is None:
            self._loaded = self._build()
            if verbose:
                logger.info(f"Loaded op: {self.NAME}")
        return self._loaded

    def _build(self):
        raise NotImplementedError


class CUDAOpBuilder(OpBuilder):
    """An op backed by hand-written CUDA kernels, named in ``KERNELS`` (keys
    of ``ops.kernels.KERNELS``)."""

    KERNELS = ()

    def kernels(self):
        from deepspeed_tpu_torch.ops.kernels import KERNELS

        return [KERNELS[name] for name in self.KERNELS]

    def is_compatible(self, verbose=False):
        # a probe that compiles nothing: the CPU accelerator runs the plain
        # versions; the CUDA one needs a card and nvcc
        import torch

        from deepspeed_tpu_torch.accelerator import get_accelerator
        from deepspeed_tpu_torch.ops.kernels import nvcc_path

        if get_accelerator()._name == "cpu":
            return True
        if not torch.cuda.is_available():
            return False
        try:
            nvcc_path()
        except RuntimeError:
            return False
        return True

    def load(self, verbose=True):
        if self._loaded is None:
            from deepspeed_tpu_torch.accelerator import get_accelerator
            from deepspeed_tpu_torch.ops.kernels import build

            accel = get_accelerator()
            if accel._name != "cpu" and self.KERNELS:
                accel.device()  # raises without a card
                build(self.kernels())  # raises if a source does not build
        return super().load(verbose)


class UnportedOpBuilder(OpBuilder):
    """An op of the JAX package the port does not have yet."""

    ROADMAP = ""

    def is_compatible(self, verbose=False):
        return False

    def _build(self):
        raise NotImplementedError(f"op {self.NAME!r} is not ported yet ({self.ROADMAP})")


def host_library_path(name: str, sources) -> Path:
    """Where ``jit_native`` puts a library: named by the sources' bytes,
    the flags and, since ``-march=native`` bakes in the host's ISA, the
    machine and host name."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    h.update(platform.machine().encode())
    h.update(platform.node().encode())  # -march=native
    return HOST_BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def jit_native(name: str, sources) -> Path:
    """Compile ``csrc/`` sources (paths relative to it) into one shared
    library with ``g++ -O3 -shared``, unless it is built already, and return
    its path. The compile writes a file of its own and renames it into
    place, so processes that build at once never load half a library.
    Raises RuntimeError with the compiler's message when it fails."""
    srcs = [CSRC_DIR / s for s in sources]
    out = host_library_path(name, srcs)
    with _HOST_BUILD_LOCK:
        if out.exists():
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"native build of {name}: g++ not found on PATH")
        HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", *HOST_FLAGS,
               *map(str, srcs), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"native build of {name} failed (g++ exit {proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        logger.info(f"built native op {name} -> {out}")
        return out


class NativeOpBuilder(OpBuilder):
    """An op backed by a g++-built library of ``csrc/`` sources, bound with
    ctypes. Subclasses set ``SOURCES`` (relative to ``csrc/``) and declare
    the entry points' signatures in ``_bind(lib)``. ``cls.lib()`` is the
    one library of the process; ``load()`` hands it out. It builds on
    either accelerator: host code needs no card."""

    SOURCES = ()
    _libs = {}
    _lock = threading.Lock()

    def is_compatible(self, verbose=False):
        # a probe that compiles nothing
        return self.NAME in self._libs or shutil.which("g++") is not None

    @classmethod
    def lib(cls):
        if cls.NAME not in NativeOpBuilder._libs:
            with NativeOpBuilder._lock:
                if cls.NAME not in NativeOpBuilder._libs:
                    lib = ctypes.CDLL(str(jit_native(cls.NAME, cls.SOURCES)))
                    cls._bind(lib)
                    NativeOpBuilder._libs[cls.NAME] = lib
        return NativeOpBuilder._libs[cls.NAME]

    def _build(self):
        return self.lib()

    @staticmethod
    def _bind(lib):
        raise NotImplementedError


# Populated by the @register_op decorators in deepspeed_tpu_torch/ops/__init__.py.
ALL_OPS = {}


def register_op(builder_cls):
    ALL_OPS[builder_cls.NAME] = builder_cls
    return builder_cls


def build_all_ops(verbose=True):
    """Load every registered op now (kernels built up front instead of at
    first use). Returns {name: ok}; an op that is not ported, or whose
    kernels do not build, is False."""
    import deepspeed_tpu_torch.ops  # noqa: F401  (populates the registry)

    results = {}
    for name, cls in sorted(ALL_OPS.items()):
        try:
            cls().load(verbose=False)
            results[name] = True
        except Exception as e:
            logger.warning(f"build_all_ops: {name} failed: {e!r}")
            results[name] = False
        if verbose:
            logger.info(f"build_all_ops: {name} -> {'ok' if results[name] else 'FAILED'}")
    return results
