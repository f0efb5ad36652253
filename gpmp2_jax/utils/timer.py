"""Wall-clock timer with tic/toc + accumulation.

Port of gpmp2::Timer (utils/Timer.h:84-140) on time.perf_counter_ns, plus a
device-aware `block` hook (JAX dispatch is async; call with the arrays the
timed section produced so the measurement includes device work —
the accelerator analog of the reference's synchronous CPU timing).
"""

from __future__ import annotations

import time

import jax

__all__ = ["Timer"]


class Timer:
    def __init__(self, name: str = ""):
        self.name = name
        self._t0 = None
        self._acc_us = 0
        self._last_us = 0

    def tic(self):
        self._t0 = time.perf_counter_ns()

    def toc(self, *block_on) -> float:
        """Stop; returns microseconds. Pass device arrays to block on."""
        for x in block_on:
            jax.block_until_ready(x)
        self._last_us = (time.perf_counter_ns() - self._t0) // 1000
        self._acc_us += self._last_us
        return self._last_us

    def acc_us(self) -> int:
        return self._acc_us

    def reset(self):
        self._acc_us = 0
        self._last_us = 0

    def print(self):
        print(f"{self.name}: {self._last_us} us (acc {self._acc_us} us)")
