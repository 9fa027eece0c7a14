"""EngineCL core: the paper's runtime, ported from the JAX package.

Tier-1: EngineCL, Program.  Tier-2: DeviceGroup, DeviceMask, discover,
Runtime, RunHandle, the Static, Dynamic and HGuided schedulers.  Tier-3:
Introspector, ThroughputRater, Scheduler base, GroupExecutor, the span
tracer and the observability layer.
"""
from repro_torch.core.device import DeviceGroup  # noqa: F401
from repro_torch.core.engine import DeviceMask, EngineCL, discover  # noqa: F401
from repro_torch.core.introspector import (  # noqa: F401
    Introspector,
    coexec_metrics,
    live_efficiency,
)
from repro_torch.core.obs import (  # noqa: F401
    DecisionJournal,
    EngineObs,
    FlightRecorder,
    UtilizationMeter,
    validate_bundle,
)
from repro_torch.core.obs import bus as obs_bus  # noqa: F401
from repro_torch.core.program import Program  # noqa: F401
from repro_torch.core.rating import ThroughputRater  # noqa: F401
from repro_torch.core.runtime import (  # noqa: F401
    GroupExecutor,
    RunError,
    RunHandle,
    Runtime,
)
from repro_torch.core.scheduler.base import Scheduler  # noqa: F401
from repro_torch.core.scheduler.dynamic import Dynamic  # noqa: F401
from repro_torch.core.scheduler.hguided import HGuided  # noqa: F401
from repro_torch.core.scheduler.static import Static  # noqa: F401
from repro_torch.core.trace import (  # noqa: F401
    Tracer,
    phase_totals,
    set_tracer,
    tracer,
    validate_chrome,
)
