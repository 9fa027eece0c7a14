"""Serving: prefill/decode steps, decode chains, one-shot generate, the
continuous-batching server (contiguous and paged KV, whole-prompt or
chunked prefill, speculative decoding, one DeviceGroup or several with
slot migration between them) on the EngineCL runtime, and its live
observability endpoints (``ObsHTTP``)."""
from repro_torch.serve.admission import (  # noqa: F401
    DeadlineAdmission,
    PoolAdmission,
    ServiceModel,
    SpecGate,
    edf_key,
)
from repro_torch.serve.batcher import (  # noqa: F401
    BatchGroup,
    Buckets,
    ModelKernels,
    chunks_for,
    segments_for,
    spec_segments_for,
)
from repro_torch.serve.http import ObsHTTP  # noqa: F401
from repro_torch.serve.multigroup import (  # noqa: F401
    ForceMigrate,
    MigrationPolicy,
    RateBalancer,
    plan_wave,
    proportional_split,
)
from repro_torch.serve.paged import (  # noqa: F401
    BlockPool,
    PagedBatchGroup,
    PagedSpec,
    blocks_needed,
    validate_paged,
)
from repro_torch.serve.server import (  # noqa: F401
    AdmissionError,
    InferenceServer,
    RequestHandle,
    ServeError,
    validate_chunked,
    validate_draft,
    validate_family,
)
from repro_torch.serve.step import (  # noqa: F401
    DraftSpec,
    cache_batch_axes,
    cast_params_cached,
    make_chunk_step,
    make_decode_chain,
    make_decode_step,
    make_draft_verify_step,
    make_generate,
    make_prefill_step,
    zeros_cache,
)
from repro_torch.serve.telemetry import (  # noqa: F401
    Ema,
    RollingStat,
    Telemetry,
    parse_exposition,
    quantile,
)
