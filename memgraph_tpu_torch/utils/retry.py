"""Retry and backoff policy of the supervised kernel client, the routed
Bolt client (``server/client.py:RoutedClient``) and the snapshot download
of ``RECOVER SNAPSHOT FROM`` (``storage/durability/recovery.py``).

Copy of what the kernel server's client uses of memgraph_tpu/utils/
retry.py's ``RetryPolicy``: exponential backoff with a cap and seedable
jitter, a retry budget, ``attempt_timeout`` (the per-attempt budget,
each call's socket timeout) and ``deadline`` (the wall-clock budget
across all attempts, backoff sleeps included: ``attempts()`` stops once
the next backoff would cross it, and the caller sees the last real
exception), and ``call`` (retry a function on ``retry_on``).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator


class RetryPolicy:
    """Backoff ``base_delay * factor^n``, capped at ``max_delay``, times
    (1 + jitter * U[0, 1)).  ``max_retries`` is the retry budget (the
    attempts are ``max_retries + 1``); ``seed`` fixes the jitter."""

    def __init__(self, base_delay: float = 0.05, factor: float = 2.0,
                 max_delay: float = 2.0, max_retries: int = 5,
                 jitter: float = 0.2, seed: int | None = None,
                 attempt_timeout: float | None = None,
                 deadline: float | None = None) -> None:
        self.base_delay = base_delay
        self.factor = factor
        self.max_delay = max_delay
        self.max_retries = max_retries
        self.jitter = jitter
        self.attempt_timeout = attempt_timeout
        self.deadline = deadline
        self._rng = random.Random(seed)

    def delay_for(self, attempt: int) -> float:
        """The backoff after the (attempt + 1)-th failure."""
        delay = min(self.max_delay,
                    self.base_delay * (self.factor ** attempt))
        if self.jitter:
            delay *= 1.0 + self.jitter * self._rng.random()
        return delay

    def remaining(self, t0: float) -> float | None:
        """Seconds left of the overall deadline started at monotonic
        ``t0`` (at least 0), or None without a deadline."""
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - (time.monotonic() - t0))

    def attempts(self) -> Iterator[int]:
        """Attempt numbers 0..max_retries, the backoff slept between
        them; ends early, without sleeping, once the next backoff would
        cross the deadline."""
        t0 = time.monotonic()
        for attempt in range(self.max_retries + 1):
            yield attempt
            if attempt >= self.max_retries:
                return
            delay = self.delay_for(attempt)
            left = self.remaining(t0)
            if left is not None and delay >= left:
                return
            time.sleep(delay)

    def call(self, fn: Callable, *, retry_on=(ConnectionError, OSError),
             on_retry: Callable | None = None):
        """Run fn(), retrying on `retry_on` with backoff; re-raises the
        last exception once the retry budget OR the overall deadline is
        exhausted."""
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as e:
                if attempt >= self.max_retries:
                    raise
                delay = self.delay_for(attempt)
                left = self.remaining(t0)
                if left is not None and delay >= left:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(delay)
                attempt += 1
