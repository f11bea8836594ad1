"""forward_host_ms: host milliseconds of the model's forward (its
``forward`` span: encoder, loss, their launches) a step, over the traced
steps.  Layer: the train loop on the host."""

from tipbench.lib import spans

PATTERNS = ()


def read(summary):
    return spans.session_mean_ms(spans.program_report(), "forward")
