"""Process-level plumbing of the port: flags, checks, device choice."""

from paddle_tpu_torch.platform.device import init, resolve_device
from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that
from paddle_tpu_torch.platform.flags import FLAGS

__all__ = ["FLAGS", "EnforceError", "enforce_that", "init",
           "resolve_device"]
