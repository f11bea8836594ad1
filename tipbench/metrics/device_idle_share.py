"""device_idle_share: 1 - device busy time / window time over the traced
steps, in %.  Layer: the device."""

PATTERNS = ()


def read(summary):
    wall = summary.get("wall_s")
    if not wall or not summary.get("launches"):
        return None
    return 100.0 * (1.0 - summary["busy_s"] / wall)
