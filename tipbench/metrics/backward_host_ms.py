"""backward_host_ms: host milliseconds of the autograd engine's backward
(the ``backward`` span on its thread, from the loss's root node to the
last gradient) a step, over the traced steps.  Layer: the train loop on
the host."""

from tipbench.lib import spans

PATTERNS = ()


def read(summary):
    return spans.session_mean_ms(spans.program_report(), "backward")
