"""Block-granular credit flow control for the remote KV wire.

Copy of ``deepspeed_tpu/serving/net/flow.py`` (stdlib only).

The importer grants the exporter a window of block credits (FETCH carries
the initial grant, CREDIT frames replenish it as scatters land). The
exporter takes credits before sending each chunk window and blocks when
the window is empty — so a slow decoder backpressures the wire instead of
the exporter buffering unboundedly. The same window object tracks the
peak number of chunk windows in flight, which is what feeds the existing
``kv_handoff_inflight_windows`` gauge in :mod:`serving.metrics`.

Both sides unwind through :meth:`CreditWindow.reset`, which returns the
outstanding (taken-but-unsettled) credit so an aborted transfer can prove
it leaked nothing — the gauge-conservation audit the resilience suite
asserts.
"""

import threading

__all__ = ["CreditWindow", "CreditError"]


class CreditError(RuntimeError):
    """The credit window was failed (peer died) or a take timed out."""


class CreditWindow:
    """Thread-safe block-credit window shared between the socket thread
    and the scatter thread on each side of a transfer.

    exporter side: ``take(n)`` before each chunk send, ``grant(n)`` when a
    CREDIT frame arrives. importer side: ``take(n)`` when a chunk arrives
    (policing the peer: an exporter overrunning its grant is a protocol
    violation), ``settle(n)`` once the scatter for that window is
    dispatched and the CREDIT replenishment goes out.
    """

    def __init__(self, initial_blocks: int = 0):
        if initial_blocks < 0:
            raise ValueError(f"initial_blocks {initial_blocks} < 0")
        self._cond = threading.Condition()
        self._available = int(initial_blocks)
        self._outstanding = 0      # taken but not yet settled
        self._granted = int(initial_blocks)
        self._settled = 0
        self._failure = None
        self._inflight_windows = 0
        self._max_inflight_windows = 0

    # -- introspection -------------------------------------------------------
    @property
    def available(self) -> int:
        with self._cond:
            return self._available

    @property
    def outstanding(self) -> int:
        with self._cond:
            return self._outstanding

    @property
    def granted(self) -> int:
        with self._cond:
            return self._granted

    @property
    def max_inflight_windows(self) -> int:
        with self._cond:
            return self._max_inflight_windows

    def snapshot(self) -> dict:
        with self._cond:
            return {
                "available": self._available,
                "outstanding": self._outstanding,
                "granted": self._granted,
                "settled": self._settled,
                "max_inflight_windows": self._max_inflight_windows,
            }

    # -- flow ----------------------------------------------------------------
    def grant(self, blocks: int) -> None:
        """Add ``blocks`` credits to the window (CREDIT frame arrived)."""
        if blocks <= 0:
            raise ValueError(f"grant of {blocks} blocks")
        with self._cond:
            self._available += blocks
            self._granted += blocks
            self._cond.notify_all()

    def take(self, blocks: int, timeout: float = None) -> None:
        """Consume ``blocks`` credits, blocking until available. Raises
        :class:`CreditError` on timeout (credit stall — the peer stopped
        replenishing) or if the window was failed."""
        if blocks <= 0:
            raise ValueError(f"take of {blocks} blocks")
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._failure is not None or self._available >= blocks,
                timeout=timeout)
            if self._failure is not None:
                raise CreditError(self._failure)
            if not ok:
                raise CreditError(
                    f"credit stall: waited {timeout}s for {blocks} blocks, "
                    f"{self._available} available — peer stopped granting")
            self._take_locked(blocks)

    def try_take(self, blocks: int) -> bool:
        """Non-blocking :meth:`take`; returns False if short of credit."""
        if blocks <= 0:
            raise ValueError(f"try_take of {blocks} blocks")
        with self._cond:
            if self._failure is not None:
                raise CreditError(self._failure)
            if self._available < blocks:
                return False
            self._take_locked(blocks)
            return True

    def _take_locked(self, blocks: int) -> None:
        self._available -= blocks
        self._outstanding += blocks
        self._inflight_windows += 1
        if self._inflight_windows > self._max_inflight_windows:
            self._max_inflight_windows = self._inflight_windows

    def settle(self, blocks: int) -> None:
        """Mark ``blocks`` taken credits as done (scatter dispatched /
        chunk acknowledged). Over-settling is a accounting bug and raises."""
        if blocks <= 0:
            raise ValueError(f"settle of {blocks} blocks")
        with self._cond:
            if blocks > self._outstanding:
                raise CreditError(
                    f"settle({blocks}) exceeds outstanding "
                    f"{self._outstanding} — double settle")
            self._outstanding -= blocks
            self._settled += blocks
            if self._inflight_windows > 0:
                self._inflight_windows -= 1
            self._cond.notify_all()

    def fail(self, message: str) -> None:
        """Poison the window: blocked takers wake with :class:`CreditError`
        carrying ``message``. Used when the peer connection dies."""
        with self._cond:
            if self._failure is None:
                self._failure = str(message)
            self._cond.notify_all()

    def reset(self) -> int:
        """Unwind after an abort: zero everything and return how much
        credit was outstanding (taken, never settled). A clean transfer
        returns 0 — this is the leak audit the resilience tests assert."""
        with self._cond:
            leaked = self._outstanding
            self._available = 0
            self._outstanding = 0
            self._inflight_windows = 0
            self._cond.notify_all()
            return leaked
