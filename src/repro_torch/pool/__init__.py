"""repro_torch.pool — composable resource-disaggregation orchestrator
(port of ``repro.pool``, pure Python).

Composes disaggregated accelerators (XLink pods stitched by the
hierarchical CXL fabric) and tier-2 memory nodes into per-job
allocations, and binds grants to devices + tiering policies for the
runtime.

    inventory   — the static estate (pods, CXL tiers, memory nodes)
    allocator   — topology-aware composable allocation + pool metrics
    lease       — allocation → devices, mesh shape and TieringPolicy

The multi-job scheduler (``repro.pool.scheduler``) is not ported yet.
"""

from repro_torch.pool.allocator import (Allocation, AllocationError,
                                        Allocator, FreeList, JobRequest,
                                        PoolMetrics)
from repro_torch.pool.inventory import (Inventory, MemoryNodeSpec, PodSpec,
                                        build_inventory)
from repro_torch.pool.lease import (Lease, LeaseBinding, ResourcePool,
                                    smoke_pool)

__all__ = [
    "Allocation", "AllocationError", "Allocator", "FreeList", "Inventory",
    "JobRequest", "Lease", "LeaseBinding", "MemoryNodeSpec", "PodSpec",
    "PoolMetrics", "ResourcePool", "build_inventory", "smoke_pool",
]
