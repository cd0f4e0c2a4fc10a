"""The reference's ``Cluster`` for the fleet parity tests, compiled once a
geometry: its replicas adopt the jitted entry points of the first engine
built with the same slots, max_len and n_sessions, as the replicas of one
reference fleet adopt replica 0's (``Engine.adopt_jits``)."""
from repro.serve.cluster import Cluster

_DONORS = {}


def ref_cluster(cfg, params, **kw):
    cl = Cluster(cfg, params, **kw)
    e0 = cl.replicas[0]
    donor = _DONORS.setdefault((id(cfg), e0.slots, e0.max_len,
                                e0.n_sessions), e0)
    for eng in cl.replicas:
        eng.adopt_jits(donor)
    return cl

