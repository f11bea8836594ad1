"""launches_per_step: device operations (kernels, copies, sets) a training
step in the traced window.  Layer: the train loop on the host; what the
host must issue a step, whatever the kernels do."""

PATTERNS = ()  # every device operation counts


def read(summary):
    if not summary.get("steps") or not summary.get("launches"):
        return None
    return summary["launches"] / summary["steps"]
