# Port of src/repro/launch/serve.py:77-313.  The output JSON has no
# ``decode_compile_count``: the port runs eagerly and compiles nothing per
# shape.  ``--device`` takes the place of JAX_PLATFORMS.
"""Serving launcher: the cost-aware scheduler serving synthetic traffic on
one engine or a multi-replica cluster with live session migration.

Quickstart::

  # on the card
  python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 16 --followups 32 --bursty

  # on the CPU, at the reduced width
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch tinyllama-1.1b --reduced --requests 12 --followups 24
  # four replicas on a mesh ring: placement + cost-priced live migration
  # (--no-migrate pins resumes to their home replica, the A/B arm)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch tinyllama-1.1b --reduced --replicas 4 --slots 1 \
      --requests 8 --followups 16 --bursty --mean-gap-ns 700 --seed 2
  # chaos: seeded faults, checksummed migration with retries, snapshots
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch tinyllama-1.1b --reduced --replicas 2 --slots 2 \
      --requests 4 --followups 6 --fault-rate 0.25 --fault-seed 7
  # sliding-window layers (ring caches): prompts and decode past the window
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch gemma3-27b --reduced --max-new 24
  # MoE layers (olmoe), MLA over MoE (deepseek-v2)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch olmoe-1b-7b --reduced --requests 4 --resumes 6
  # recurrent layers: mamba + attention + MoE (jamba), RWKV-6 (rwkv6)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch rwkv6-7b --reduced --requests 4 --resumes 6
  # M-RoPE (qwen2-vl): exact-length prefills at (3, 1, n) positions
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch qwen2-vl-72b --reduced --requests 4 --resumes 6

An enc-dec config (seamless-m4t-medium) is refused by the Engine, as the
reference's Engine cannot prefill one; its path is ``lm.prefill`` with
``enc_embeds``, then ``lm.decode_step``.

This module drives no engine loop of its own: every submit, suspend,
resume — and with ``--replicas > 1`` every placement and migration — is a
:class:`repro_torch.sched.Scheduler` /
:class:`repro_torch.sched.ClusterScheduler` decision.  Admission overflow
QUEUES (never EngineFull), suspend/resume traffic drains as fused waves
(one per replica per wave), and migrations run as priced ``hop_chain``
movement plans (a page gather and a page scatter per route).
``--policy fifo`` is the A/B arm of the default ``cost_aware``
(``cost_aware_cluster`` with ``--replicas > 1``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import movement as MV
from repro_torch import resolve_device, sched
from repro_torch.configs import get_config, get_reduced
from repro_torch.faults import FaultInjector, FaultSpec
from repro_torch.models import lm
from repro_torch.obs import Tracer, write_chrome_trace
from repro_torch.serve.cluster import Cluster
from repro_torch.serve.engine import Engine, Request

QUICKSTART = """examples:
  %(prog)s --arch tinyllama-1.1b --requests 16 --followups 32 --bursty
  %(prog)s --device cpu --arch tinyllama-1.1b --reduced --requests 12 \
--followups 24 --policy fifo
  %(prog)s --arch tinyllama-1.1b --replicas 4 --slots 2
  %(prog)s --arch tinyllama-1.1b --replicas 4 --no-migrate --policy fifo

With --replicas N the engines sit on a mesh ring: placement scores each
replica by free slots, VILLA fast-tier occupancy and the modeled hop cost
from the session's residence; a resume placed off its home replica
live-migrates the suspended pages as one fused plan per route.
--no-migrate pins every resume to its home replica (the SLO A/B arm).

Chaos: --fault-rate R injects seeded at-rest bit rot and migration-leg
corruption at per-event probability R.  Every corruption is caught by the
per-page checksum sidecar; with recovery on (default) the scheduler retries
corrupted movement legs (priced, backoff on the virtual clock) and restores
corrupt sessions from periodic snapshots; --no-recovery turns the run into
a detection-only audit.  --fault-seed picks the chaos RNG stream; the same
(rate, seed) replays the same faults bit-for-bit:

  %(prog)s --arch tinyllama-1.1b --replicas 2 --slots 2 --fault-rate 0.25 \
--fault-seed 7

Shared-prefix forking: --fork-prefix N prefills one N-token system prompt
ONCE, then admits every fresh session as a zero-copy FORK of that template
(refcounted page alias, RowClone FPM pricing); each session diverges at its
first decode and copies-on-write at its first suspend.  --no-fork is the A/B
arm: the same shared prefix is prepended to every prompt and prefilled per
session.  The prefix must leave room for the decode budget: --fork-prefix +
--max-new <= --max-len.

  %(prog)s --arch tinyllama-1.1b --requests 12 --fork-prefix 24"""


def run(argv=None):
    """Parse ``argv``, serve the workload and print the output JSON.
    Returns ``(out, scheduler)``: the JSON as a dict and the
    :class:`repro_torch.sched.Scheduler` (or ``ClusterScheduler``) that ran
    it (its ``eng`` is the Engine or the Cluster), for callers that check
    the run beyond its JSON."""
    p = argparse.ArgumentParser(
        epilog=QUICKSTART,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda; the CPU "
                        "only with --device cpu)")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas on the mesh ring (default 1; >1 "
                        "enables placement + live session migration)")
    p.add_argument("--no-migrate", action="store_true",
                   help="pin resumes to their home replica (A/B arm; only "
                        "meaningful with --replicas > 1)")
    p.add_argument("--slots", type=int, default=4,
                   help="decode slots PER replica")
    p.add_argument("--max-len", type=int, default=96)
    p.add_argument("--requests", type=int, default=8,
                   help="fresh sessions (may exceed the slot count: "
                        "overflow queues)")
    p.add_argument("--followups", "--resumes", type=int, default=16,
                   dest="followups", help="follow-up (resume) arrivals")
    p.add_argument("--policy", default=None, choices=sched.policies(),
                   help="scheduling policy (default: cost_aware, or "
                        "cost_aware_cluster with --replicas > 1)")
    p.add_argument("--mean-gap-ns", type=float, default=2000.0)
    p.add_argument("--bursty", action="store_true")
    p.add_argument("--zipf-s", type=float, default=1.3)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fault-rate", type=float, default=0.0,
                   help="seeded chaos: per-event probability of injecting "
                        "a fault (at-rest bit rot, migration-leg "
                        "corruption); 0 disables injection (default)")
    p.add_argument("--fault-seed", type=int, default=None,
                   help="chaos RNG stream (default: --seed); the same "
                        "(rate, seed) pair replays identical faults")
    p.add_argument("--no-recovery", action="store_true",
                   help="detection-only chaos: count checksum detections "
                        "but never retry or restore (audit arm)")
    p.add_argument("--snapshot-every", type=int, default=4,
                   help="ticks between session-snapshot refreshes backing "
                        "chaos recovery (0 disables snapshots)")
    p.add_argument("--fork-prefix", type=int, default=None, metavar="N",
                   help="serve every fresh session as a zero-copy fork of "
                        "ONE N-token shared system prompt (prefilled once; "
                        "children alias its snapshot and copy-on-write at "
                        "divergence)")
    p.add_argument("--no-fork", action="store_true",
                   help="A/B arm for --fork-prefix: prepend the same shared "
                        "prefix to every prompt and prefill it per session "
                        "(no aliasing)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="record the run's virtual-clock span trace and "
                        "write it as Chrome trace_events JSON (open in "
                        "Perfetto); composes with every chaos/fork flag — "
                        "fault incidents, retries, snapshots, forks and "
                        "CoW breaks all appear as spans")
    args = p.parse_args(argv)

    wl_prompt_lens = (6, 8, 10, 12)
    if args.replicas < 1:
        p.error(f"--replicas must be >= 1 (got {args.replicas})")
    if args.max_new < 1:
        p.error(f"--max-new must be >= 1 (got {args.max_new})")
    if args.max_len < max(wl_prompt_lens) + args.max_new:
        p.error(f"--max-len {args.max_len} cannot hold the synthetic "
                f"workload: prompts run up to {max(wl_prompt_lens)} tokens "
                f"plus --max-new {args.max_new} decode positions")
    if not 0.0 <= args.fault_rate <= 1.0:
        p.error(f"--fault-rate must be a probability in [0, 1] "
                f"(got {args.fault_rate})")
    if args.snapshot_every < 0:
        p.error(f"--snapshot-every must be >= 0 (got {args.snapshot_every})")
    if args.fault_rate > 0 and args.replicas < 2:
        p.error("--fault-rate needs --replicas >= 2: chaos injection "
                "targets the cluster scheduler (migration legs, replica "
                "storage)")
    if (args.no_recovery or args.fault_seed is not None) \
            and args.fault_rate == 0:
        p.error("--no-recovery / --fault-seed are chaos flags: set "
                "--fault-rate > 0 to enable injection first")
    if args.no_fork and args.fork_prefix is None:
        p.error("--no-fork is the A/B arm of --fork-prefix: set "
                "--fork-prefix N to define the shared prefix first")
    if args.fork_prefix is not None:
        if args.fork_prefix < 1:
            p.error(f"--fork-prefix must be >= 1 (got {args.fork_prefix})")
        # the envelope: a forked child resumes at position N and must fit
        # its whole decode budget before max_len (the engine refuses
        # out-of-envelope resumes — fail fast at the CLI instead)
        if args.fork_prefix + args.max_new > args.max_len:
            p.error(f"--fork-prefix {args.fork_prefix} + --max-new "
                    f"{args.max_new} exceeds --max-len {args.max_len}: the "
                    f"shared prefix must leave room for the decode budget")
        if args.no_fork and (args.fork_prefix + max(wl_prompt_lens)
                             + args.max_new > args.max_len):
            p.error(f"--no-fork prefills the prefix plus each prompt (up "
                    f"to {max(wl_prompt_lens)} tokens): --max-len "
                    f"{args.max_len} is too small for --fork-prefix "
                    f"{args.fork_prefix} + --max-new {args.max_new}")
    policy = args.policy or ("cost_aware_cluster" if args.replicas > 1
                             else "cost_aware")
    device = resolve_device(args.device)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = lm.init_lm(cfg, torch.Generator(device).manual_seed(args.seed),
                        device=device)

    wl = sched.WorkloadConfig(
        n_fresh=args.requests, n_followups=args.followups,
        mean_gap_ns=args.mean_gap_ns,
        arrival="bursty" if args.bursty else "poisson",
        zipf_s=args.zipf_s, prompt_lens=wl_prompt_lens,
        new_tokens=tuple(sorted({max(args.max_new // 2, 1), args.max_new})))
    arrivals = sched.generate_workload(wl, seed=args.seed,
                                       vocab_size=cfg.vocab_size)
    # the store holds one snapshot per session — admission pressure is the
    # QUEUE's problem (a burst beyond the slot count waits, it never raises
    # EngineFull), store pressure would be silent eviction, so size it out
    n_sessions = sched.n_sessions_for(wl)
    fork_template_uid, fork_seeds, prefix = None, {}, None
    if args.fork_prefix is not None:
        frng = np.random.default_rng(args.seed + 1)
        prefix = frng.integers(0, cfg.vocab_size,
                               args.fork_prefix).astype(np.int32)
        if args.no_fork:
            # A/B arm: the same shared prefix, prefilled per session
            arrivals = [a._replace(prompt=np.concatenate([prefix, a.prompt]))
                        if a.kind == "fresh" else a for a in arrivals]
        else:
            # template homes at row n_sessions (no workload uid maps there);
            # each fresh arrival becomes a RESUME of its forked child, which
            # diverges at the first token of its original prompt
            fork_template_uid = n_sessions
            n_sessions += 1
            fork_seeds = {a.uid: int(a.prompt[0]) for a in arrivals
                          if a.kind == "fresh"}
            arrivals = [a._replace(kind="resume", prompt=None)
                        if a.kind == "fresh" else a for a in arrivals]

    injector = None
    if args.fault_rate > 0:
        injector = FaultInjector(FaultSpec(
            rate=args.fault_rate,
            seed=args.seed if args.fault_seed is None else args.fault_seed,
            recover=not args.no_recovery))
    tracer = Tracer() if args.trace_out else None
    if tracer is not None:
        MV.set_tracer(tracer)       # host-side plan executes -> exec marks
    try:
        if args.replicas > 1:
            eng = Cluster(cfg, params, n_replicas=args.replicas,
                          slots=args.slots, max_len=args.max_len,
                          n_sessions=n_sessions, faults=injector,
                          device=device)
            s = sched.ClusterScheduler(eng, policy=policy,
                                       arrivals=arrivals,
                                       migrate=not args.no_migrate,
                                       snapshot_every=(args.snapshot_every
                                                       if injector else 0),
                                       tracer=tracer)
        else:
            eng = Engine(cfg, params, slots=args.slots,
                         max_len=args.max_len, n_sessions=n_sessions,
                         device=device)
            s = sched.Scheduler(eng, policy=policy, arrivals=arrivals,
                                tracer=tracer)
        if fork_template_uid is not None:
            # prefill the shared prefix ONCE (max_new=1 auto-suspends at the
            # prefill token) and alias every workload session off its
            # snapshot — zero device launches for the whole fan-out (a
            # cluster fork off replica 0 onto replica 0 is an alias too)
            uids = sorted(fork_seeds)
            if args.replicas > 1:
                eng.submit(Request(uid=fork_template_uid, prompt=prefix,
                                   max_new=1), replica=0)
                for uid in uids:
                    eng.fork(fork_template_uid, uid,
                             seed_token=fork_seeds[uid])
            else:
                eng.submit(Request(uid=fork_template_uid, prompt=prefix,
                                   max_new=1))
                eng.fork_many(fork_template_uid, uids,
                              seed_tokens=[fork_seeds[u] for u in uids])
        t0 = time.time()
        summary = s.run()
        dt = time.time() - t0
    finally:
        if tracer is not None:
            MV.set_tracer(None)     # don't leak into later runs in-process
    eng_stats = eng.stats

    out = {
        "policy": policy,
        "replicas": args.replicas,
        **summary,
        **{k: eng_stats[k] for k in ("decoded_tokens", "suspends", "resumes",
                                     "decode_dispatches", "host_transfers")},
        "villa_hit_rate": round(eng.hit_rate(), 3),
        "ticks": s.tick_count,
        "tokens_per_s": round(eng_stats["decoded_tokens"] / max(dt, 1e-9),
                              1),
        "seconds": round(dt, 1),
    }
    if args.fork_prefix is not None:
        out["fork"] = {
            "enabled": not args.no_fork,
            "prefix_len": args.fork_prefix,
            "prefills": eng_stats["prefills"],
            "forks": eng_stats["forks"],
            "bytes_not_copied": eng_stats["bytes_not_copied"],
            "demotions": eng_stats["demotions"],
            "evictions": eng_stats["evictions"],
        }
    if args.replicas > 1:
        out["migrations"] = eng_stats["migrations"]
        out["migrated_bytes"] = eng_stats["migrated_bytes"]
    if injector is not None:
        out["fault_ledger"] = injector.summary()
        out["verify_failed"] = eng.verify_failure_count()
        out["at_rest_corrupt"] = int(eng.scrub())
    if tracer is not None:
        write_chrome_trace(tracer, args.trace_out)
        roll = tracer.rollup()
        # replaces the summary's rollup-only "trace" key with the launcher
        # digest: per-phase span counts, per-leg ns split, top-5 spans
        out["trace"] = {
            "spans": roll["spans"],
            "per_phase": {k: v["count"]
                          for k, v in roll["per_phase"].items()},
            "legs": roll["legs"],
            "top_spans_ns": tracer.top_spans(5),
            "chrome_trace": args.trace_out,
        }
    print(json.dumps(out, allow_nan=False))
    return out, s


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
