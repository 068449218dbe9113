"""The port's transfer plane: the sim engines and their dispatcher, the
executor with its breaker, chaos scenarios and reports, and the gateway
that moves real bytes (copies of the reference package's ``transfer/``,
plus the device-resident ``torch`` sim engine).

The fleet controller (``FleetController``, ``FleetReport``,
``TenantReport``, ``TenantSpec``) is not ported yet, and the reference's
deprecated per-engine shims ``simulate_multi`` and
``simulate_multi_reference`` are not copied: ``simulate(engine=...)`` is
the one entry to every engine.
"""

from .chunk import Chunk, chunk_manifest, chunk_object, checksum  # noqa: F401
from .simconfig import SimConfig  # noqa: F401
from .sim import simulate  # noqa: F401
from .flowsim import SimResult, simulate_transfer  # noqa: F401
from .flowsim_ref import simulate_transfer_reference  # noqa: F401
from .events import (  # noqa: F401
    GrayFailure,
    JobSimResult,
    LinkDegrade,
    LinkRestore,
    MultiSimResult,
    TransferJob,
    VMFailure,
)
from .breaker import (  # noqa: F401
    BreakerConfig,
    BreakerTransition,
    LinkBreaker,
)
from .chaos import (  # noqa: F401
    ChaosScenario,
    FlappingLink,
    GrayLink,
    ProviderBrownout,
    RegionOutage,
    compile_archetypes,
)
from .reports import Report  # noqa: F401
from .executor import (  # noqa: F401
    BackoffLadder,
    DegradationLadder,
    ExecutionReport,
    JobReport,
    ReplanRecord,
    ServiceReport,
    TransferRequest,
    TransferService,
    execute_plan,
    execute_service_model,
)
from .gateway import (  # noqa: F401
    BlobStore,
    DirStore,
    FaultInjector,
    GatewayReport,
    MulticastGatewayReport,
    ObjectStore,
    transfer_objects,
    transfer_objects_multicast,
)

__all__ = [
    "BackoffLadder",
    "BlobStore",
    "BreakerConfig",
    "BreakerTransition",
    "ChaosScenario",
    "Chunk",
    "DegradationLadder",
    "DirStore",
    "ExecutionReport",
    "FaultInjector",
    "FlappingLink",
    "GatewayReport",
    "GrayFailure",
    "GrayLink",
    "JobReport",
    "JobSimResult",
    "LinkBreaker",
    "LinkDegrade",
    "LinkRestore",
    "MultiSimResult",
    "MulticastGatewayReport",
    "ObjectStore",
    "ProviderBrownout",
    "RegionOutage",
    "ReplanRecord",
    "Report",
    "ServiceReport",
    "SimConfig",
    "SimResult",
    "TransferJob",
    "TransferRequest",
    "TransferService",
    "VMFailure",
    "checksum",
    "chunk_manifest",
    "chunk_object",
    "compile_archetypes",
    "execute_plan",
    "execute_service_model",
    "simulate",
    "simulate_transfer",
    "simulate_transfer_reference",
    "transfer_objects",
    "transfer_objects_multicast",
]
