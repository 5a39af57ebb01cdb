"""Host-side helpers of the training CLIs: seeding, the stdout tee, the
config echo, and the profiler trace with the program's spans."""

from cervical_tpu_torch.utils.logging import Logger, show_config  # noqa: F401
from cervical_tpu_torch.utils.profiling import span, span_totals, trace  # noqa: F401
from cervical_tpu_torch.utils.seeding import seed_everything  # noqa: F401
