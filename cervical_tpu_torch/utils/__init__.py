"""Host-side helpers of the training CLIs: seeding, the stdout tee and the
config echo."""

from cervical_tpu_torch.utils.logging import Logger, show_config  # noqa: F401
from cervical_tpu_torch.utils.seeding import seed_everything  # noqa: F401
