from repro_torch.core.scheduler.base import Scheduler  # noqa: F401
from repro_torch.core.scheduler.dynamic import Dynamic  # noqa: F401
from repro_torch.core.scheduler.hguided import HGuided  # noqa: F401
from repro_torch.core.scheduler.static import Static  # noqa: F401
