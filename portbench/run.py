"""Run one benchmark cell of the PyTorch / CUDA port once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the numbers compared with the
reference and their limits on standard error, then one JSON line on
standard output (see `portbench/harness.py`).  Needs the CUDA cards the
cell asks for; without them it exits 2 and prints no result."""
import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        boot_s = time.clock_gettime(time.CLOCK_BOOTTIME)
        return max(0.0, boot_s - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


STARTED = time.perf_counter() - _process_age_s()
# the checkout root, in place of this folder: its modules are the
# package `portbench`, and none of them may shadow a library's name
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    from portbench import harness
    harness.cache_env()
    sys.exit(harness.main(sys.argv[1:], STARTED))
