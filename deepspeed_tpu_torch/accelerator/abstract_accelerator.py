"""Accelerator abstraction (counterpart of
``deepspeed_tpu/accelerator/abstract_accelerator.py``).

The ``DeepSpeedAccelerator`` interface of the reference: devices, RNG,
synchronization, streams and events, memory statistics, dtype support, the
communication backend's name, graphs and the op builders. Under PyTorch the
stream, event and graph methods are real (``cuda_accelerator.py`` maps them
onto ``torch.cuda``); the defaults here are the host's: no streams, events
on the host clock, no graphs.
"""

import abc
import contextlib
import time
from abc import ABC


class DeepSpeedAccelerator(ABC):
    def __init__(self):
        self._name = None
        self._communication_backend_name = None

    # ---- device APIs ----
    @abc.abstractmethod
    def device_name(self, device_index=None):
        ...

    @abc.abstractmethod
    def device(self, device_index=None):
        ...

    @abc.abstractmethod
    def device_count(self):
        ...

    @abc.abstractmethod
    def current_device(self):
        ...

    def set_device(self, device_index):
        pass

    def current_device_name(self):
        return self.device_name(self.current_device())

    @abc.abstractmethod
    def is_available(self):
        ...

    # ---- RNG APIs ----
    def manual_seed(self, seed):
        import torch

        torch.manual_seed(seed)

    def initial_seed(self):
        import torch

        return torch.initial_seed()

    # ---- synchronization ----
    @abc.abstractmethod
    def synchronize(self, device_index=None):
        ...

    def stream(self, stream):
        return contextlib.nullcontext()

    def current_stream(self, device_index=None):
        return None

    def default_stream(self, device_index=None):
        return None

    class Event:
        """Host-clock event (an accelerator without device events)."""

        def __init__(self, enable_timing=False):
            self.t0 = None

        def record(self, stream=None):
            self.t0 = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t0 - self.t0) * 1000.0

    # ---- memory APIs ----
    @abc.abstractmethod
    def memory_stats(self, device_index=None):
        ...

    def memory_allocated(self, device_index=None):
        return self.memory_stats(device_index).get("bytes_in_use", 0)

    def max_memory_allocated(self, device_index=None):
        return self.memory_stats(device_index).get("peak_bytes_in_use", 0)

    def memory_reserved(self, device_index=None):
        return self.memory_stats(device_index).get("bytes_reserved",
                                                   self.memory_allocated(device_index))

    def max_memory_reserved(self, device_index=None):
        return self.max_memory_allocated(device_index)

    def total_memory(self, device_index=None):
        return self.memory_stats(device_index).get("bytes_limit", 0)

    def available_memory(self, device_index=None):
        return self.total_memory(device_index) - self.memory_allocated(device_index)

    def empty_cache(self):
        pass

    def reset_peak_memory_stats(self, device_index=None):
        pass

    # ---- dtype support ----
    @abc.abstractmethod
    def is_bf16_supported(self):
        ...

    @abc.abstractmethod
    def is_fp16_supported(self):
        ...

    def supported_dtypes(self):
        import torch

        dtypes = [torch.float32]
        if self.is_fp16_supported():
            dtypes.append(torch.float16)
        if self.is_bf16_supported():
            dtypes.append(torch.bfloat16)
        return dtypes

    def preferred_dtype(self):
        import torch

        return torch.bfloat16 if self.is_bf16_supported() else torch.float32

    # ---- comm backend ----
    @abc.abstractmethod
    def communication_backend_name(self):
        ...

    # ---- graphs ----
    def is_triton_supported(self):
        return False

    def create_graph(self):
        return None

    def capture_to_graph(self, graph, pool=None, stream=None):
        return contextlib.nullcontext()

    def replay_graph(self, graph):
        pass

    # ---- op builder (the kernel registry, ops/op_builder.py) ----
    def get_op_builder(self, op_name):
        """The registered builder class of ``op_name``, or None."""
        import deepspeed_tpu_torch.ops  # noqa: F401  (registers the builders)
        from deepspeed_tpu_torch.ops.op_builder import ALL_OPS

        return ALL_OPS.get(op_name)

    def create_op_builder(self, op_name):
        builder = self.get_op_builder(op_name)
        return builder() if builder else None

    def on_accelerator(self, tensor):
        return True
