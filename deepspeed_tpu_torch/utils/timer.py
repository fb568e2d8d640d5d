"""Wall-clock and throughput timers, in the port.

Counterpart of ``deepspeed_tpu/utils/timer.py`` (``SynchronizedWallClockTimer``,
``NoopTimer``, ``ThroughputTimer``, ``trim_mean``). A timer reads the host
clock after ``torch.cuda.synchronize()``, so a span covers the device work
enqueued inside it; on the CPU there is nothing to wait for.
"""

import time

from deepspeed_tpu_torch.utils.logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
BACKWARD_INNER_MICRO_TIMER = "bwd_inner_microstep"
BACKWARD_INNER_GLOBAL_TIMER = "bwd_inner"
BACKWARD_REDUCE_MICRO_TIMER = "bwd_allreduce_microstep"
BACKWARD_REDUCE_GLOBAL_TIMER = "bwd_allreduce"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


def device_synchronize(tree=None):
    """Wait for the card: every kernel enqueued so far has finished when
    this returns (``torch.cuda.synchronize``). Without a card there is
    nothing to wait for: CPU tensors are computed when the call returns.
    ``tree`` is accepted for the JAX package's signature and ignored."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


_device_synchronize = device_synchronize


class SynchronizedWallClockTimer:
    """Group of named timers, each synchronizing the device before reading the clock."""

    class Timer:
        def __init__(self, name):
            self.name_ = name
            self.started_ = False
            self.start_time = time.time()
            self.elapsed_records = []

        def start(self):
            if self.started_:
                raise RuntimeError(f"{self.name_} timer has already been started")
            _device_synchronize()
            self.start_time = time.time()
            self.started_ = True

        def stop(self, reset=False, record=True):
            if not self.started_:
                raise RuntimeError("timer is not started")
            _device_synchronize()
            elapsed = time.time() - self.start_time
            if record:
                self.elapsed_records.append(elapsed)
            self.started_ = False
            return elapsed

        def _get_elapsed_msec(self):
            return sum(self.elapsed_records) * 1000.0

        def reset(self):
            self.started_ = False
            self.elapsed_records = []

        def elapsed(self, reset=True):
            started = self.started_
            if started:
                self.stop()
            elapsed = self._get_elapsed_msec()
            if reset:
                self.reset()
            if started:
                self.start()
            return elapsed

        def mean(self):
            if not self.elapsed_records:
                return 0.0
            return sum(self.elapsed_records) / len(self.elapsed_records) * 1000.0

    def __init__(self):
        self.timers = {}

    def get_timers(self):
        return self.timers

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name)
        return self.timers[name]

    @staticmethod
    def memory_usage():
        import torch

        if not torch.cuda.is_available():
            return "DeviceMem stats unavailable"
        in_use = torch.cuda.memory_allocated()
        peak = torch.cuda.max_memory_allocated()
        return f"DeviceMem in-use: {in_use / 2**30:.2f} GB | peak: {peak / 2**30:.2f} GB"

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        if normalizer <= 0.0:
            raise ValueError(f"normalizer must be positive, got {normalizer}")
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        log_dist(string, ranks=ranks or [0])


class NoopTimer:
    class Timer:
        def start(self):
            ...

        def reset(self):
            ...

        def stop(self, **kwargs):
            ...

        def elapsed(self, **kwargs):
            return 0

        def mean(self):
            return 0

    def __init__(self):
        self.timer = self.Timer()

    def __call__(self, name):
        return self.timer

    def get_timers(self):
        return {}

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        ...


class ThroughputTimer:
    """Samples per second over windows of optimizer steps."""

    def __init__(self, config, batch_size, start_step=2, steps_per_output=None, monitor_memory=False, logging_fn=None):
        self.config = config
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = batch_size or 1
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.step_elapsed_time = 0
        self._window_start = 0
        self._window_steps = 0
        self._timed_steps = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or log_dist

    @property
    def enabled(self):
        return getattr(self.config, "enabled", True)

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        """A synchronize per step would stall the host against the card and
        serialize the step's tail against the next step's enqueue, so the
        timer synchronizes only at reporting boundaries and attributes the
        window's wall time to the steps inside it (as the JAX package
        does)."""
        if not self.enabled:
            return
        self.started = True
        if self.global_step_count >= self.start_step and self._window_start == 0:
            _device_synchronize()
            self._window_start = time.time()
            self._window_steps = 0

    def stop(self, global_step=False, report_speed=True):
        if not self.enabled or not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if not global_step:
            # micro-steps never close a window (or sync): only gradient
            # boundaries count toward throughput, matching the reference's
            # per-global-step accounting
            return
        self.global_step_count += 1
        if self._window_start > 0:
            self._window_steps += 1
            boundary = not self.steps_per_output or self.global_step_count % self.steps_per_output == 0
            if not boundary:
                return
            _device_synchronize()
            self.end_time = time.time()
            duration = self.end_time - self._window_start
            self.total_elapsed_time += duration
            self._timed_steps += self._window_steps
            self.step_elapsed_time = duration / max(self._window_steps, 1)
            self._window_start = 0
            if global_step and report_speed and self.steps_per_output:
                self.logging(
                    f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                    f"global_step={self.global_step_count}, RunningAvgSamplesPerSec="
                    f"{self.avg_samples_per_sec():.2f}, CurrSamplesPerSec="
                    f"{self.batch_size / self.step_elapsed_time if self.step_elapsed_time else 0:.2f}"
                )

    def avg_samples_per_sec(self):
        if self._timed_steps > 0 and self.total_elapsed_time > 0:
            avg_time_per_step = self.total_elapsed_time / self._timed_steps
            return self.batch_size / avg_time_per_step
        return float("-inf")


def trim_mean(data, trim_percent):
    """The trimmed mean of a list of numbers."""
    if not 0.0 <= trim_percent <= 1.0:
        raise ValueError(f"trim_percent must be in [0, 1], got {trim_percent}")
    n = len(data)
    if n == 0:
        return 0
    data = sorted(data)
    trim_count = int(trim_percent * n)
    trimmed = data[trim_count : n - trim_count] or data
    return sum(trimmed) / len(trimmed)
