# Port of src/repro/sched/__init__.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Cost-aware continuous-batching scheduler: the controller layer that turns
the serving engine into a traffic-serving system.

Public surface::

    from repro_torch import sched

    arrivals = sched.generate_workload(sched.WorkloadConfig(...), seed=0,
                                       vocab_size=cfg.vocab_size)
    s = sched.Scheduler(engine, policy="cost_aware", arrivals=arrivals)
    summary = s.run()          # per-class p50/p99, SLO attainment, movement

Multi-replica serving drives a :class:`~repro_torch.serve.cluster.Cluster`
through :class:`ClusterScheduler` — same tick loop, plus placement as a
third decision axis and cost-priced live session migration::

    cluster = Cluster(cfg, params, n_replicas=4, slots=2)
    s = sched.ClusterScheduler(cluster, arrivals=arrivals)  # migrate=True

Modules:
  queue      — admission queue: priority classes, deadlines, aging
  policy     — fifo / lru / cost_aware / cost_aware_cluster policies
               (registry; admit, victim AND place orderings)
  scheduler  — the tick loops: fused waves, decode-overlapped wave prep,
               cluster placement + migration lanes
  workload   — synthetic traffic (Poisson/bursty, Zipf re-use, think time)
  metrics    — per-class latency, SLO attainment, MovementCost accounting,
               per-replica utilization + migration split

See DESIGN.md Sec. 9 (scheduler) and Sec. 10 (cluster) for the paper
mapping.
"""
from repro_torch.sched.metrics import Decision, JobRecord, Metrics
from repro_torch.sched.policy import (
    AdmitCand,
    CostAwareClusterPolicy,
    CostAwarePolicy,
    FifoPolicy,
    LruPolicy,
    PlaceCand,
    SchedContext,
    SchedPolicy,
    VictimCand,
    get_policy,
    policies,
    register_policy,
)
from repro_torch.sched.queue import AdmissionQueue, QueueEntry
from repro_torch.sched.scheduler import (Job, SchedConfig, Scheduler, Wave,
                                   ClusterScheduler, ClusterWave)
from repro_torch.sched.workload import (
    Arrival,
    WorkloadConfig,
    generate_workload,
    n_sessions_for,
    skewed_residence_burst,
)

__all__ = [
    "AdmissionQueue", "QueueEntry",
    "SchedPolicy", "FifoPolicy", "LruPolicy", "CostAwarePolicy",
    "CostAwareClusterPolicy",
    "AdmitCand", "VictimCand", "PlaceCand", "SchedContext",
    "register_policy", "get_policy", "policies",
    "Scheduler", "SchedConfig", "Job", "Wave",
    "ClusterScheduler", "ClusterWave",
    "Arrival", "WorkloadConfig", "generate_workload", "n_sessions_for",
    "skewed_residence_burst",
    "Metrics", "JobRecord", "Decision",
]
