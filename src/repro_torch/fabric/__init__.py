"""repro_torch.fabric — routed transport over the XLink-CXL estate.

The single source of modeled transfer seconds (the API redesign that
retired the scattered per-layer cost models):

    topology  — Link / Route / Topology: the estate graph (accels,
                XLink pods, CXL switch tiers, tier-2 memory nodes)
                with min-hop routing; built from ``pool.inventory``
    transport — Transport: interval-based max-min fair sharing of
                link bandwidth among concurrently in-flight transfers

Quickstart::

    from repro_torch.fabric import Topology, Transport
    from repro_torch.pool import build_inventory

    topo = Topology.from_inventory(build_inventory())
    tx = Transport(topo)
    route = topo.route("pod:0", "mem:0")
    done = tx.begin_transfer(route, 64 << 20, t=0.0)   # modeled seconds

Consumers:

* ``repro_torch.serve.Engine`` charges KV spill/fetch through a transport
  (pass ``transport=``/``route=``; defaults to a private degenerate
  1-link topology that reproduces the legacy ``ServeCostModel.swap_s``
  numbers bit-exactly);
* ``repro_torch.pool.Allocator`` admission-controls ``tier2_bw``
  reservations against the topology's shared link capacities;
* ``repro_torch.core.costmodel`` collectives accept a ``Route`` anywhere a
  ``FabricSpec`` is expected (``Route.transfer_time`` implements the
  same contract).
"""

from repro_torch.fabric.topology import (ACCEL, ENDPOINT, MEMORY, POD, SWITCH,
                                   Link, Route, Topology)
from repro_torch.fabric.transport import Transport

__all__ = [
    "ACCEL", "ENDPOINT", "MEMORY", "POD", "SWITCH",
    "Link", "Route", "Topology", "Transport",
]
