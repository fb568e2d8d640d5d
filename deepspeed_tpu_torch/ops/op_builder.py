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
"""

from deepspeed_tpu_torch.utils.logging import logger


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
