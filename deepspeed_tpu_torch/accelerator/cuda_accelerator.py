"""CUDA accelerator (counterpart of ``deepspeed_tpu/accelerator/tpu_accelerator.py``).

``CUDA_Accelerator`` maps the interface onto ``torch.cuda``: devices,
streams, events, memory statistics, bf16/fp16 support and graphs through
``torch.cuda.CUDAGraph``; its communication backend is ``"nccl"``. Without a
card every device call raises and names the way to the CPU accelerator
(``DS_ACCELERATOR=cpu``): nothing quietly runs on the host.

``CPU_Accelerator`` is the host (the tests' accelerator): one device, no
streams, host-clock events, the ``"gloo"`` backend.
"""

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator


class CUDA_Accelerator(DeepSpeedAccelerator):
    def __init__(self):
        super().__init__()
        self._name = "cuda"
        self._communication_backend_name = "nccl"

    def _require(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the CUDA accelerator found no CUDA card (torch.cuda.is_available() is "
                "false); set DS_ACCELERATOR=cpu to ask for the CPU accelerator")

    # ---- device APIs ----
    def device_name(self, device_index=None):
        return "cuda" if device_index is None else f"cuda:{device_index}"

    def device(self, device_index=None):
        self._require()
        return torch.device("cuda", torch.cuda.current_device() if device_index is None
                            else device_index)

    def device_count(self):
        self._require()
        return torch.cuda.device_count()

    def current_device(self):
        self._require()
        return torch.cuda.current_device()

    def set_device(self, device_index):
        self._require()
        torch.cuda.set_device(device_index)

    def is_available(self):
        return torch.cuda.is_available()

    # ---- RNG APIs ----
    def manual_seed(self, seed):
        self._require()
        torch.cuda.manual_seed(seed)

    def initial_seed(self):
        self._require()
        return torch.cuda.initial_seed()

    # ---- synchronization, streams, events ----
    def synchronize(self, device_index=None):
        self._require()
        torch.cuda.synchronize(device_index)

    def stream(self, stream):
        self._require()
        return torch.cuda.stream(stream)

    def current_stream(self, device_index=None):
        self._require()
        return torch.cuda.current_stream(device_index)

    def default_stream(self, device_index=None):
        self._require()
        return torch.cuda.default_stream(device_index)

    @property
    def Event(self):
        self._require()
        return torch.cuda.Event

    # ---- memory APIs ----
    def memory_stats(self, device_index=None):
        self._require()
        return torch.cuda.memory_stats(device_index)

    def memory_allocated(self, device_index=None):
        self._require()
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index=None):
        self._require()
        return torch.cuda.max_memory_allocated(device_index)

    def memory_reserved(self, device_index=None):
        self._require()
        return torch.cuda.memory_reserved(device_index)

    def max_memory_reserved(self, device_index=None):
        self._require()
        return torch.cuda.max_memory_reserved(device_index)

    def total_memory(self, device_index=None):
        self._require()
        return torch.cuda.get_device_properties(
            torch.cuda.current_device() if device_index is None else device_index).total_memory

    def available_memory(self, device_index=None):
        self._require()
        free, _ = torch.cuda.mem_get_info(device_index)
        return free

    def empty_cache(self):
        self._require()
        torch.cuda.empty_cache()

    def reset_peak_memory_stats(self, device_index=None):
        self._require()
        torch.cuda.reset_peak_memory_stats(device_index)

    # ---- dtype support ----
    def is_bf16_supported(self):
        self._require()
        return torch.cuda.is_bf16_supported()

    def is_fp16_supported(self):
        self._require()
        return True

    def communication_backend_name(self):
        return self._communication_backend_name

    # ---- graphs ----
    def is_triton_supported(self):
        return False  # the port's kernels are CUDA C++ built with nvcc

    def create_graph(self):
        self._require()
        return torch.cuda.CUDAGraph()

    def capture_to_graph(self, graph, pool=None, stream=None):
        self._require()
        return torch.cuda.graph(graph, pool=pool, stream=stream)

    def replay_graph(self, graph):
        self._require()
        graph.replay()

    def on_accelerator(self, tensor):
        return tensor.device.type == "cuda"


class CPU_Accelerator(DeepSpeedAccelerator):
    """The host as an accelerator: the tests' (``DS_ACCELERATOR=cpu``). The
    port's kernels take their plain versions on CPU tensors."""

    def __init__(self):
        super().__init__()
        self._name = "cpu"
        self._communication_backend_name = "gloo"

    def device_name(self, device_index=None):
        return "cpu" if device_index is None else f"cpu:{device_index}"

    def device(self, device_index=None):
        return torch.device("cpu")

    def device_count(self):
        return 1

    def current_device(self):
        return 0

    def is_available(self):
        return True

    def synchronize(self, device_index=None):
        pass

    def memory_stats(self, device_index=None):
        return {}

    def is_bf16_supported(self):
        return True

    def is_fp16_supported(self):
        return True

    def communication_backend_name(self):
        return self._communication_backend_name

    def on_accelerator(self, tensor):
        return tensor.device.type == "cpu"
