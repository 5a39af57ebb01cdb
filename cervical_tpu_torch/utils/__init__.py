"""Host-side helpers of the training CLIs: seeding, the stdout tee, the
config echo, and the profiler trace and throughput meter."""

from cervical_tpu_torch.utils.logging import Logger, show_config  # noqa: F401
from cervical_tpu_torch.utils.profiling import ThroughputMeter, trace  # noqa: F401
from cervical_tpu_torch.utils.seeding import seed_everything  # noqa: F401
