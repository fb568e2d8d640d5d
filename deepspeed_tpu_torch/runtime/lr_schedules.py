"""Learning-rate schedules for the port.

A copy of ``deepspeed_tpu/runtime/lr_schedules.py`` (it imports only
``math``): WarmupLR, WarmupDecayLR, WarmupCosineLR, OneCycle and
LRRangeTest with the reference's config names and imperative API
(``step()``/``get_lr()``/``state_dict()``). The engine reads the scalar each
step and hands it to the optimizer.
"""

import math

WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
ONE_CYCLE = "OneCycle"
LR_RANGE_TEST = "LRRangeTest"

VALID_LR_SCHEDULES = [WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR, ONE_CYCLE, LR_RANGE_TEST]


class _Schedule:
    """Base with the torch-style scheduler API the reference exposes."""

    def __init__(self, optimizer=None, last_batch_iteration=-1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        raise NotImplementedError

    def get_last_lr(self):
        if getattr(self, "_last_lr", None) is None:
            raise RuntimeError("need to call step() first")
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        lrs = self.get_lr()
        self._last_lr = lrs
        if self.optimizer is not None and hasattr(self.optimizer, "set_lr"):
            self.optimizer.set_lr(lrs[0])
        return lrs

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(_Schedule):
    """Linear warmup then constant (reference WarmupLR)."""

    def __init__(
        self,
        optimizer=None,
        warmup_min_lr=0.0,
        warmup_max_lr=0.001,
        warmup_num_steps=1000,
        warmup_type="log",
        last_batch_iteration=-1,
    ):
        super().__init__(optimizer, last_batch_iteration)
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _warmup_factor(self):
        step = self.last_batch_iteration + 1
        if step < self.warmup_num_steps:
            if self.warmup_type == "log":
                return self.inverse_log_warm_up * math.log(step + 1)
            return step / self.warmup_num_steps
        return 1.0

    def get_lr(self):
        gamma = self._warmup_factor()
        return [self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * gamma]


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to 0 over total_num_steps (reference WarmupDecayLR)."""

    def __init__(
        self,
        optimizer=None,
        total_num_steps=10000,
        warmup_min_lr=0.0,
        warmup_max_lr=0.001,
        warmup_num_steps=1000,
        warmup_type="log",
        last_batch_iteration=-1,
    ):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type, last_batch_iteration)

    def _warmup_factor(self):
        step = self.last_batch_iteration + 1
        if step < self.warmup_num_steps:
            return super()._warmup_factor()
        return max(
            0.0,
            (self.total_num_steps - step) / max(1.0, self.total_num_steps - self.warmup_num_steps),
        )


class WarmupCosineLR(_Schedule):
    """Warmup then cosine decay (reference WarmupCosineLR)."""

    def __init__(
        self,
        optimizer=None,
        total_num_steps=10000,
        warmup_min_ratio=0.0,
        warmup_num_steps=1000,
        cos_min_ratio=0.0001,
        warmup_type="log",
        last_batch_iteration=-1,
    ):
        super().__init__(optimizer, last_batch_iteration)
        self.total_num_steps = total_num_steps
        self.warmup_min_ratio = warmup_min_ratio
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.cos_min_ratio = cos_min_ratio
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        self.org_lrs = [0.001]

    def set_base_lr(self, lr):
        self.org_lrs = [lr]

    def get_lr_ratio(self):
        step = self.last_batch_iteration + 1
        if step < self.warmup_num_steps:
            if self.warmup_type == "log":
                f = self.inverse_log_warm_up * math.log(step + 1)
            else:
                f = step / self.warmup_num_steps
            return self.warmup_min_ratio + (1.0 - self.warmup_min_ratio) * f
        progress = (step - self.warmup_num_steps) / max(1, self.total_num_steps - self.warmup_num_steps)
        progress = min(1.0, progress)
        cosine = 0.5 * (1 + math.cos(math.pi * progress))
        return self.cos_min_ratio + (1 - self.cos_min_ratio) * cosine

    def get_lr(self):
        return [lr * self.get_lr_ratio() for lr in self.org_lrs]


class OneCycle(_Schedule):
    """1-cycle policy (reference OneCycle): cycle LR up/down then decay."""

    def __init__(
        self,
        optimizer=None,
        cycle_min_lr=1e-5,
        cycle_max_lr=1e-3,
        decay_lr_rate=0.0,
        cycle_first_step_size=2000,
        cycle_second_step_size=None,
        cycle_first_stair_count=0,
        cycle_second_stair_count=None,
        decay_step_size=0,
        cycle_momentum=True,
        cycle_min_mom=0.85,
        cycle_max_mom=0.99,
        decay_mom_rate=0.0,
        last_batch_iteration=-1,
    ):
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.cycle_first_step_size = cycle_first_step_size
        self.cycle_second_step_size = cycle_second_step_size or cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.total_size = self.cycle_first_step_size + self.cycle_second_step_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def get_lr(self):
        step = self.last_batch_iteration + 1
        if step < self.total_size:
            if step < self.cycle_first_step_size:
                x = step / self.cycle_first_step_size
                lr = self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * x
            else:
                x = (step - self.cycle_first_step_size) / self.cycle_second_step_size
                lr = self.cycle_max_lr - (self.cycle_max_lr - self.cycle_min_lr) * x
            return [lr]
        # decay phase
        if self.decay_step_size > 0:
            decay_steps = (step - self.total_size) / self.decay_step_size
        else:
            decay_steps = step - self.total_size
        lr = self.cycle_min_lr * (1.0 / (1.0 + self.decay_lr_rate * decay_steps))
        return [lr]

    def get_mom(self):
        step = self.last_batch_iteration + 1
        if not self.cycle_momentum:
            return [self.cycle_max_mom]
        if step < self.total_size:
            if step < self.cycle_first_step_size:
                x = step / self.cycle_first_step_size
                mom = self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * x
            else:
                x = (step - self.cycle_first_step_size) / self.cycle_second_step_size
                mom = self.cycle_min_mom + (self.cycle_max_mom - self.cycle_min_mom) * x
            return [mom]
        return [self.cycle_max_mom]


class LRRangeTest(_Schedule):
    """LR range test (reference LRRangeTest)."""

    def __init__(
        self,
        optimizer=None,
        lr_range_test_min_lr=1e-3,
        lr_range_test_step_size=2000,
        lr_range_test_step_rate=1.0,
        lr_range_test_staircase=False,
        last_batch_iteration=-1,
    ):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def get_lr(self):
        step = self.last_batch_iteration + 1
        if self.staircase:
            interval = float(step // self.step_size)
        else:
            interval = step / self.step_size
        return [self.min_lr * (1 + self.step_rate * interval)]


SCHEDULES = {
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    WARMUP_COSINE_LR: WarmupCosineLR,
    ONE_CYCLE: OneCycle,
    LR_RANGE_TEST: LRRangeTest,
}


def get_lr_scheduler(name, optimizer=None, **params):
    if name not in SCHEDULES:
        raise ValueError(f"Unknown LR schedule {name}; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULES[name](optimizer=optimizer, **params)


def add_tuning_arguments(parser):
    """Reference ``add_tuning_arguments`` (exported __init__.py:36) — CLI knobs
    for OneCycle/LRRangeTest convergence tuning."""
    group = parser.add_argument_group("Convergence Tuning", "Convergence tuning configurations")
    group.add_argument("--seed", type=int, default=1138, help="random seed")
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001)
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0)
    group.add_argument("--lr_range_test_step_size", type=int, default=1000)
    group.add_argument("--lr_range_test_staircase", type=bool, default=False)
    group.add_argument("--cycle_first_step_size", type=int, default=1000)
    group.add_argument("--cycle_first_stair_count", type=int, default=-1)
    group.add_argument("--cycle_second_step_size", type=int, default=-1)
    group.add_argument("--cycle_second_stair_count", type=int, default=-1)
    group.add_argument("--decay_step_size", type=int, default=1000)
    group.add_argument("--cycle_min_lr", type=float, default=0.01)
    group.add_argument("--cycle_max_lr", type=float, default=0.1)
    group.add_argument("--decay_lr_rate", type=float, default=0.0)
    group.add_argument("--cycle_min_mom", type=float, default=0.8)
    group.add_argument("--cycle_max_mom", type=float, default=0.9)
    group.add_argument("--decay_mom_rate", type=float, default=0.0)
    group.add_argument("--warmup_min_lr", type=float, default=0)
    group.add_argument("--warmup_max_lr", type=float, default=0.001)
    group.add_argument("--warmup_num_steps", type=int, default=1000)
    group.add_argument("--warmup_type", type=str, default="log")
    return parser
