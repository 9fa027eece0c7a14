"""Schedulers.  ``Dynamic`` and ``HGuided`` come with co-execution across
device groups (ROADMAP.md item A4)."""
from repro_torch.core.scheduler.base import Scheduler  # noqa: F401
from repro_torch.core.scheduler.static import Static  # noqa: F401
