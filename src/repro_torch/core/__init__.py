"""Core of the port: the paper's contribution, exponential-graph
decentralized training.

Subsystems: topology (realization IR and weight matrices), spectral
(Prop. 1 analysis), flatbuf (one flat buffer per dtype), gossip (partial
averaging), transforms (composable optimizer algebra), optim (DmSGD and
variants as chains, Alg. 1), plan (GossipPlan: realization resolution and
the executable cache), schedule (learning-rate protocol), cache.
"""
from . import flatbuf, gossip, optim, plan, schedule, spectral, topology, transforms  # noqa: F401
from .cache import CompileCache  # noqa: F401
from .optim import make_optimizer  # noqa: F401
from .plan import GossipPlan  # noqa: F401
from .topology import Topology, get_topology  # noqa: F401
