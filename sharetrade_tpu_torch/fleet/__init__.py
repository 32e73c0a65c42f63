"""Fleet serving tier: the port's counterpart of the JAX package's
``fleet/``, on the same wire protocol, so a router of either package fronts
engines of the other.

- **proto.py** — the sans-IO HTTP/1.1 parser/renderer (bytes in, events
  out, zero I/O) every party on the wire frames through;
- **wire.py** — the protocol every hop speaks (deadline and session-clock
  headers, distinct statuses per serving outcome, persistent-connection
  client);
- **frontend.py / evloop.py** — the network front-end serving any
  ``serve_request`` backend (a local engine, or the router) on either wire
  backend: the selector event loop (``fleet.wire_backend = "evloop"``,
  default) or the threaded differential oracle (``"threaded"``);
- **pool.py** — :class:`EnginePool`: whole ``cli serve --listen`` worker
  processes under the supervision ladder (distrib/ladder.py);
- **router.py** — :class:`FleetRouter`: telemetry-driven balancing on the
  engines' own exported signals, session affinity with migration through
  the shared spill arena or the prefill, exact fleet quantiles from
  bucket-wise histogram merges, loud degrade when nothing is left;
- **autoscale.py / loadgen.py** — membership driven by the router's
  telemetry history, and the wire adapter that lets serve/driver.py's
  harnesses drive a fleet.

- **flywheel.py** — served sessions that journal their transitions for
  the learner's feed ingest (``cli fleet --learner``).

``cli fleet`` boots the whole tier. Not ported: trace spans and the native
wire rung (ROADMAP item 13).
"""

from sharetrade_tpu_torch.fleet.evloop import EvloopFrontend
from sharetrade_tpu_torch.fleet.frontend import (
    EngineBackend,
    ServeFrontend,
    ThreadedServeFrontend,
)
from sharetrade_tpu_torch.fleet.loadgen import WireEngine
from sharetrade_tpu_torch.fleet.pool import EnginePool
from sharetrade_tpu_torch.fleet.router import FleetRouter, StaticEndpoints
from sharetrade_tpu_torch.fleet.wire import FleetClient

__all__ = [
    "EngineBackend",
    "EnginePool",
    "EvloopFrontend",
    "FleetClient",
    "FleetRouter",
    "ServeFrontend",
    "StaticEndpoints",
    "ThreadedServeFrontend",
    "WireEngine",
]
