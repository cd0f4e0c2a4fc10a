# Port of src/repro/sched/__init__.py: the single-replica scheduler.
# ClusterScheduler and ClusterWave arrive with the cluster slice; the
# policies (cost_aware_cluster included) and workload tools are all here.
"""Cost-aware continuous-batching scheduler: the controller layer that turns
the serving engine into a traffic-serving system.

Public surface::

    from repro_torch import sched

    arrivals = sched.generate_workload(sched.WorkloadConfig(...), seed=0,
                                       vocab_size=cfg.vocab_size)
    s = sched.Scheduler(engine, policy="cost_aware", arrivals=arrivals)
    summary = s.run()          # per-class p50/p99, SLO attainment, movement

Modules:
  queue      — admission queue: priority classes, deadlines, aging
  policy     — fifo / lru / cost_aware / cost_aware_cluster policies
               (registry; admit, victim AND place orderings)
  scheduler  — the tick loop: fused waves, decode-overlapped wave prep
  workload   — synthetic traffic (Poisson/bursty, Zipf re-use, think time)
  metrics    — per-class latency, SLO attainment, MovementCost accounting
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
from repro_torch.sched.scheduler import Job, SchedConfig, Scheduler, Wave
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
    "Arrival", "WorkloadConfig", "generate_workload", "n_sessions_for",
    "skewed_residence_burst",
    "Metrics", "JobRecord", "Decision",
]
