"""repro_torch.pool — composable resource-disaggregation orchestrator
(port of ``repro.pool``, pure Python).

Composes disaggregated accelerators (XLink pods stitched by the
hierarchical CXL fabric) and tier-2 memory nodes into per-job
allocations, schedules multi-job workloads over them, and binds grants
to devices + tiering policies for the runtime.

    inventory   — the static estate (pods, CXL tiers, memory nodes)
    allocator   — topology-aware composable allocation + pool metrics
    scheduler   — discrete-event multi-job admit/preempt/elastic engine
    lease       — allocation → devices, mesh shape and TieringPolicy
"""

from repro_torch.pool.allocator import (Allocation, AllocationError,
                                        Allocator, FreeList, JobRequest,
                                        PoolMetrics)
from repro_torch.pool.inventory import (Inventory, MemoryNodeSpec, PodSpec,
                                        build_inventory)
from repro_torch.pool.lease import (Lease, LeaseBinding, ResourcePool,
                                    smoke_pool)
from repro_torch.pool.scheduler import (JobRecord, PoolJob, ScheduleResult,
                                        Scheduler, offload_bw, offload_bytes)

__all__ = [
    "Allocation", "AllocationError", "Allocator", "FreeList", "Inventory",
    "JobRecord", "JobRequest", "Lease", "LeaseBinding", "MemoryNodeSpec",
    "PodSpec", "PoolJob", "PoolMetrics", "ResourcePool", "ScheduleResult",
    "Scheduler", "build_inventory", "offload_bw", "offload_bytes",
    "smoke_pool",
]
