"""step_mfu: the reference algorithm's operations a step
(counts/work.py:step_flops) over the device's busy time a step in the
traced steps, as a share of the H100's 67 TFLOP/s in float32
(counts/peaks.py): the whole step's share of the peak while the device
works, so it bounds every kernel's share and moves with
``device_ms_per_step``; times (1 - device_idle_share) it is the share
over the wall.  Layer: the model step."""

from tipbench.counts.peaks import PEAK_F32_FLOP_PER_S
from tipbench.counts.work import step_flops

PATTERNS = ()


def read(summary):
    steps, busy = summary.get("steps"), summary.get("busy_s")
    if not steps or not busy:
        return None
    return 100.0 * step_flops(summary["shape"]) / (busy / steps) \
        / PEAK_F32_FLOP_PER_S
