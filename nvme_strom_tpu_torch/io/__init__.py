from nvme_strom_tpu_torch.io.arena import (
    PinnedArena,
    Slab,
    get_arena,
)
from nvme_strom_tpu_torch.io.engine import (
    PendingRead,
    PendingWrite,
    StromEngine,
    check_file,
    wait_exact,
)
from nvme_strom_tpu_torch.io.faults import (
    FaultPlan,
    FaultSpec,
    FaultyEngine,
    build_engine,
    crash_point,
    set_ring_stall,
)
from nvme_strom_tpu_torch.io.flightrec import FlightRecorder, flight_of
from nvme_strom_tpu_torch.io.health import (
    DegradedRead,
    EngineSupervisor,
)
from nvme_strom_tpu_torch.io.hostcache import (
    CacheHitRead,
    HostCache,
    get_cache,
)
from nvme_strom_tpu_torch.io.plan import (
    ExtentPlan,
    SpanView,
    plan_and_submit,
    plan_extents,
    split_spans,
    submit_spans,
    submit_spans_tiered,
)
from nvme_strom_tpu_torch.io.resilient import (
    ReadError,
    ResilientEngine,
    ResilientRead,
    ResilientWrite,
    WriteError,
)
from nvme_strom_tpu_torch.io.sched import (
    CLASS_ORDER,
    DEFAULT_CLASS,
    ClassPolicy,
    QoSScheduler,
    default_policies,
)
from nvme_strom_tpu_torch.io.tenants import (
    Tenant,
    TenantRegistry,
    TokenBucket,
    current_tenant,
    tenant_context,
    tenants_enabled,
)

__all__ = ["PinnedArena", "Slab", "get_arena",
           "StromEngine", "PendingRead", "PendingWrite", "check_file",
           "wait_exact",
           "FaultPlan", "FaultSpec", "FaultyEngine", "build_engine",
           "crash_point", "set_ring_stall", "FlightRecorder", "flight_of",
           "DegradedRead", "EngineSupervisor",
           "CacheHitRead", "HostCache", "get_cache",
           "ExtentPlan", "SpanView", "plan_and_submit", "plan_extents",
           "split_spans", "submit_spans", "submit_spans_tiered",
           "ReadError", "ResilientEngine", "ResilientRead",
           "ResilientWrite", "WriteError",
           "CLASS_ORDER", "DEFAULT_CLASS", "ClassPolicy", "QoSScheduler",
           "default_policies",
           "Tenant", "TenantRegistry", "TokenBucket", "current_tenant",
           "tenant_context", "tenants_enabled"]
