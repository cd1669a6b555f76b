import os
import sys

# NOTE: deliberately NOT setting --xla_force_host_platform_device_count
# here — the dry-run (and only the dry-run) uses 512 fake devices; tests
# and benchmarks must see the host's real single device.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
except ImportError:  # container has no hypothesis: deterministic stub
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-device decode equivalence tests — CI "
        "(scripts/ci.sh, 8 forced host devices) runs them; skip "
        "locally with -m 'not slow' or scripts/ci.sh --fast",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's hand-written "
        "kernels); skips on a host without one",
    )


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    """Per-file test-time report: cumulative call-phase seconds by test
    file, slowest first — so a new (especially multidevice) test file
    ballooning the suite is visible in every run, not discovered by
    bisecting a slow CI."""
    times: dict[str, list] = {}
    for reports in terminalreporter.stats.values():
        for rep in reports:
            if getattr(rep, "when", None) != "call":
                continue
            # nodeid, not location[0]: wrapped tests (hypothesis stub)
            # report their wrapper's code location, which would lump
            # every property test under tests/_hypothesis_stub.py
            entry = times.setdefault(
                rep.nodeid.split("::")[0], [0.0, 0]
            )
            entry[0] += rep.duration
            entry[1] += 1
    if not times:
        return
    terminalreporter.write_sep("-", "per-file test time (call phase)")
    for f, (t, n) in sorted(times.items(), key=lambda kv: -kv[1][0]):
        terminalreporter.write_line(f"{t:8.1f}s  {n:4d} tests  {f}")
