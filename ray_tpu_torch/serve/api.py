"""The serve API (counterpart of ray_tpu/serve/api.py): so far only
``OverloadError``, the retriable shed that admission control raises.  The
deployment runtime around it comes with a later slice of the port."""

from __future__ import annotations


class OverloadError(RuntimeError):
    """A request was shed by admission control (deployment queue bound or
    SLO router).  Retriable: the service is healthy but saturated; back off
    and resend instead of treating it as a failure."""

    retriable = True
