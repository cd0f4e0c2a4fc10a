# Port of src/repro/launch/serve.py:77-313, single replica.  Left out until
# the cluster slice (ROADMAP Queue 1 items 11-12): --replicas above 1 and the
# chaos flags, which the parser refuses.  The output JSON has no
# ``decode_compile_count``: the port runs eagerly and compiles nothing per
# shape.  ``--device`` takes the place of JAX_PLATFORMS.
"""Serving launcher: the cost-aware scheduler serving synthetic traffic on
one engine.

Quickstart::

  # on the card
  python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 16 --followups 32 --bursty

  # on the CPU, at the reduced width
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch tinyllama-1.1b --reduced --requests 12 --followups 24

This module drives no engine loop of its own: every submit, suspend and
resume is a :class:`repro_torch.sched.Scheduler` decision.  Admission
overflow QUEUES (never EngineFull), suspend/resume traffic drains as fused
waves, and ``--policy fifo`` is the A/B arm of the default ``cost_aware``.
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
from repro_torch.models import lm
from repro_torch.obs import Tracer, write_chrome_trace
from repro_torch.serve.engine import Engine, Request

CLUSTER_SLICE = ("the port's cluster and faults slice (ROADMAP Queue 1 "
                 "items 11-12), not ported yet: this launcher serves one "
                 "replica")

QUICKSTART = """examples:
  %(prog)s --arch tinyllama-1.1b --requests 16 --followups 32 --bursty
  %(prog)s --device cpu --arch tinyllama-1.1b --reduced --requests 12 \
--followups 24 --policy fifo

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
    :class:`repro_torch.sched.Scheduler` that ran it (its ``eng`` is the
    Engine), for callers that check the run beyond its JSON."""
    p = argparse.ArgumentParser(
        epilog=QUICKSTART,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda; the CPU "
                        "only with --device cpu)")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas (1; more need the cluster slice)")
    p.add_argument("--no-migrate", action="store_true",
                   help="cluster only (refused)")
    p.add_argument("--slots", type=int, default=4, help="decode slots")
    p.add_argument("--max-len", type=int, default=96)
    p.add_argument("--requests", type=int, default=8,
                   help="fresh sessions (may exceed the slot count: "
                        "overflow queues)")
    p.add_argument("--followups", "--resumes", type=int, default=16,
                   dest="followups", help="follow-up (resume) arrivals")
    p.add_argument("--policy", default="cost_aware",
                   choices=sched.policies(), help="scheduling policy")
    p.add_argument("--mean-gap-ns", type=float, default=2000.0)
    p.add_argument("--bursty", action="store_true")
    p.add_argument("--zipf-s", type=float, default=1.3)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    for flag in ("--fault-rate", "--fault-seed", "--snapshot-every"):
        p.add_argument(flag, default=None, help="chaos, cluster only "
                                                "(refused)")
    p.add_argument("--no-recovery", action="store_true",
                   help="chaos, cluster only (refused)")
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
                        "Perfetto)")
    args = p.parse_args(argv)

    wl_prompt_lens = (6, 8, 10, 12)
    if args.replicas < 1:
        p.error(f"--replicas must be >= 1 (got {args.replicas})")
    if args.replicas > 1:
        p.error(f"--replicas {args.replicas} needs {CLUSTER_SLICE}")
    refused = [f for f, on in (("--no-migrate", args.no_migrate),
                               ("--fault-rate", args.fault_rate is not None),
                               ("--fault-seed", args.fault_seed is not None),
                               ("--no-recovery", args.no_recovery),
                               ("--snapshot-every",
                                args.snapshot_every is not None)) if on]
    if refused:
        p.error(f"{', '.join(refused)} need {CLUSTER_SLICE}")
    if args.max_new < 1:
        p.error(f"--max-new must be >= 1 (got {args.max_new})")
    if args.max_len < max(wl_prompt_lens) + args.max_new:
        p.error(f"--max-len {args.max_len} cannot hold the synthetic "
                f"workload: prompts run up to {max(wl_prompt_lens)} tokens "
                f"plus --max-new {args.max_new} decode positions")
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

    engine = Engine(cfg, params, slots=args.slots, max_len=args.max_len,
                    n_sessions=n_sessions, device=device)
    tracer = Tracer() if args.trace_out else None
    if tracer is not None:
        MV.set_tracer(tracer)       # host-side plan executes -> exec marks
    try:
        s = sched.Scheduler(engine, policy=args.policy, arrivals=arrivals,
                            tracer=tracer)
        if fork_template_uid is not None:
            # prefill the shared prefix ONCE (max_new=1 auto-suspends at the
            # prefill token) and alias every workload session off its
            # snapshot — zero device launches for the whole fan-out
            uids = sorted(fork_seeds)
            engine.submit(Request(uid=fork_template_uid, prompt=prefix,
                                  max_new=1))
            engine.fork_many(fork_template_uid, uids,
                             seed_tokens=[fork_seeds[u] for u in uids])
        t0 = time.time()
        summary = s.run()
        dt = time.time() - t0
    finally:
        if tracer is not None:
            MV.set_tracer(None)     # don't leak into later runs in-process
    eng_stats = engine.stats

    out = {
        "policy": args.policy,
        "replicas": args.replicas,
        **summary,
        **{k: eng_stats[k] for k in ("decoded_tokens", "suspends", "resumes",
                                     "decode_dispatches", "host_transfers")},
        "villa_hit_rate": round(engine.hit_rate(), 3),
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
