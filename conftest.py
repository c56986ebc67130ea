"""Repository-wide pytest hook: keep a test process under the kernel's limit
on memory maps.

Every XLA:CPU executable that JAX compiles or loads holds three memory maps of
JIT-loaded code (text, read-only data, data), and JAX keeps the executables in
its in-process caches for the life of the process.  A pytest-xdist worker that
runs many of the JAX package's tests in a row therefore only gains maps:
``tests/test_hybrid_events.py`` alone adds about 44,000, and on top of a
worker's earlier tests that reaches Linux's default ``vm.max_map_count`` of
65,530, where the JIT's next ``mmap`` fails and the worker aborts.

After each test, while the process holds more than ``MAP_BUDGET`` maps, JAX's
in-process caches are dropped.  Later tests compile again (or load from the
persistent compilation cache); what they compute does not change.
"""

import gc
import sys

MAP_BUDGET = 32_000  # the largest single test seen adds ~12,600


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:  # no procfs: nothing to guard
        return 0


def pytest_runtest_teardown(item, nextitem):
    jax = sys.modules.get("jax")
    if jax is not None and _map_count() > MAP_BUDGET:
        jax.clear_caches()
        gc.collect()
