"""Per-request token streaming + incremental detokenization.

The driver appends tokens to a ``TokenStream`` as decode rounds complete;
any number of consumer threads (HTTP handlers, bench clients) iterate it
concurrently with generation. ``IncrementalDetokenizer`` turns the id
stream into text pieces without re-emitting earlier text and without
splitting multi-token UTF-8 sequences (the classic streaming-detok bug:
byte-level BPE tokens are not codepoint-aligned, so a naive per-token
decode emits U+FFFD replacement chars mid-character).

Copy of ``deepspeed_tpu/serving/streaming.py``.
"""

import threading
from collections import deque
from typing import Iterator, Optional


class StreamClosed(Exception):
    """Raised by ``get()`` when the stream ended and no tokens remain."""


class TokenStream:
    """Thread-safe token queue with an end-of-stream marker.

    Producer: ``put(token)`` then ``close(reason)``. Consumer: iterate, or
    ``get(timeout)``. Iteration ends when the stream is closed and drained;
    ``finish_reason`` is readable afterwards.
    """

    def __init__(self, uid: int):
        self.uid = uid
        self._q = deque()
        self._cond = threading.Condition()
        self._closed = False
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None

    # -- producer (driver thread) ---------------------------------------
    def put(self, token: int) -> None:
        with self._cond:
            if self._closed:
                return  # late tokens after close (e.g. cancel) are dropped
            self._q.append(int(token))
            self._cond.notify_all()

    def put_many(self, tokens) -> None:
        """Append a burst (e.g. one speculative verify round's accepted run)
        under ONE lock acquisition/notify — consumers wake once per burst,
        not once per token."""
        with self._cond:
            if self._closed:
                return
            self._q.extend(int(t) for t in tokens)
            self._cond.notify_all()

    def close(self, finish_reason: str, error: Optional[str] = None) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self.finish_reason = finish_reason
            self.error = error
            self._cond.notify_all()

    # -- consumer --------------------------------------------------------
    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed and not self._q

    def get(self, timeout: Optional[float] = None) -> int:
        """Next token; raises ``StreamClosed`` at end-of-stream, ``TimeoutError``
        if ``timeout`` elapses with the stream still open."""
        with self._cond:
            while not self._q:
                if self._closed:
                    raise StreamClosed(self.finish_reason)
                if not self._cond.wait(timeout):
                    raise TimeoutError(f"no token within {timeout}s (uid={self.uid})")
            return self._q.popleft()

    def __iter__(self) -> Iterator[int]:
        while True:
            try:
                yield self.get()
            except StreamClosed:
                return


class IncrementalDetokenizer:
    """Turn a token-id stream into text pieces, emitting only complete
    codepoints: decode the full generated prefix each push and emit the
    STABLE suffix past what was already emitted — everything up to (but not
    including) any trailing U+FFFD run, which marks a partial UTF-8
    sequence awaiting its next token. Emitting the stable prefix rather
    than withholding the whole piece matters for multi-token bursts
    (speculative decoding delivers several tokens per round): one
    incomplete trailing codepoint must not hold back the completed text in
    front of it."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids = []
        self._emitted = 0  # chars already handed out

    def _emit_stable(self) -> str:
        text = self._tok.decode(self._ids)
        stable = len(text)
        while stable > self._emitted and text[stable - 1] == "�":
            stable -= 1  # mid-codepoint tail: wait for the completing token
        piece = text[self._emitted:stable]
        self._emitted = stable
        return piece

    def push(self, token_id: int) -> str:
        self._ids.append(int(token_id))
        return self._emit_stable()

    def push_many(self, token_ids) -> str:
        """Burst entry point: fold several tokens, ONE decode of the prefix
        (vs one per token via repeated push) — the streaming-side analogue
        of the engine's multi-token verify rounds."""
        self._ids.extend(int(t) for t in token_ids)
        return self._emit_stable()

    def flush(self) -> str:
        """Emit whatever remains (end of stream: a trailing U+FFFD is real)."""
        text = self._tok.decode(self._ids)
        piece = text[self._emitted:]
        self._emitted = len(text)
        return piece


def stream_text(stream: TokenStream, tokenizer) -> Iterator[str]:
    """Iterate a ``TokenStream`` as incremental text pieces."""
    detok = IncrementalDetokenizer(tokenizer)
    for tok in stream:
        piece = detok.push(tok)
        if piece:
            yield piece
    tail = detok.flush()
    if tail:
        yield tail
