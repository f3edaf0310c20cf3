"""ray_tpu_torch.serve: so far only the retriable shed the serving routers
raise (``OverloadError``).  The serve runtime comes with a later slice."""

from .api import OverloadError

__all__ = ["OverloadError"]
