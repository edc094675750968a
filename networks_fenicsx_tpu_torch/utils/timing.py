"""Named wall-clock timing registry.

Counterpart of ``networks_fenicsx_tpu/utils/timing.py``: the same registry
and the same queries (``timing``, ``timing_seconds``, ``list_timings``), the
replacement for ``dolfinx.common.timed`` that the reference uses.  Each key
accumulates a call count and a total wall-clock duration.

Device work is asynchronous: with :func:`timed(..., block=True)` the clock
stops only after ``torch.cuda.synchronize()``, so kernels launched by the
call are inside the measurement.
"""

from __future__ import annotations

import datetime
import functools
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, TypeVar

import torch

__all__ = [
    "timed",
    "timing",
    "timing_seconds",
    "reset_timings",
    "list_timings",
    "Timer",
]

F = TypeVar("F", bound=Callable[..., Any])

_lock = threading.Lock()
_registry: dict[str, tuple[int, float]] = {}


def _record(key: str, elapsed: float) -> None:
    with _lock:
        count, total = _registry.get(key, (0, 0.0))
        _registry[key] = (count + 1, total + elapsed)


def timed(key: str, block: bool = False) -> Callable[[F], F]:
    """Decorator mirroring ``dolfinx.common.timed``.

    Args:
        key: Registry key, conventionally ``"nxfx:<Class>:<method>"``.
        block: If True, run ``torch.cuda.synchronize()`` (when CUDA is
            initialised) before stopping the clock.
    """

    def decorator(fn: F) -> F:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            t0 = time.perf_counter()
            try:
                result = fn(*args, **kwargs)
                if block and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                return result
            finally:
                _record(key, time.perf_counter() - t0)

        return wrapper  # type: ignore[return-value]

    return decorator


@contextmanager
def Timer(key: str) -> Iterator[None]:
    """Context-manager form of :func:`timed`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(key, time.perf_counter() - t0)


def timing(key: str) -> tuple[int, datetime.timedelta]:
    """``(call_count, total_wall_clock)`` for ``key``, mirroring
    ``dolfinx.common.timing``; unknown keys give ``(0, timedelta(0))``."""
    with _lock:
        count, total = _registry.get(key, (0, 0.0))
    return count, datetime.timedelta(seconds=total)


def timing_seconds(key: str) -> float:
    """Total seconds accumulated for ``key``."""
    with _lock:
        return _registry.get(key, (0, 0.0))[1]


def reset_timings() -> None:
    """Clear the registry."""
    with _lock:
        _registry.clear()


def list_timings() -> dict[str, tuple[int, float]]:
    """Snapshot of the registry: ``{key: (count, total_seconds)}``."""
    with _lock:
        return dict(_registry)
