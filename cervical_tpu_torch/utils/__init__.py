"""Host-side helpers of the training CLI: seeding and the config echo."""

from cervical_tpu_torch.utils.logging import show_config  # noqa: F401
from cervical_tpu_torch.utils.seeding import seed_everything  # noqa: F401
