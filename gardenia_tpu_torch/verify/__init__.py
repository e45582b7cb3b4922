from gardenia_tpu_torch.verify import oracles
from gardenia_tpu_torch.verify.compare import (
    maximum_relative_error, l2_error, check,
)

__all__ = ["oracles", "maximum_relative_error", "l2_error", "check"]
