# Port of src/repro/analysis/entrypoints.py in torch: the same targets and
# contracts, registered on the port's callables.
"""The registry of audited entry points.

``default_targets()`` builds the serving stack at audit geometry and pairs
each hot-path entry point with the contract the reference's promises
(:mod:`repro_torch.analysis.dispatch` says how each field is checked):

========================  ============================================
entry point               contract
========================  ============================================
``decode``                ``Engine.step_begin``: cache in place; no
                          sync; K3 once an attention layer
``prefill[bucket=k]``     ``Engine._prefill_insert``, one a bucket:
                          cache in place; no sync; K3 once a layer
``suspend``               ``Engine._suspend_fn``: store and sums in
                          place; uint8-preserving; two K1
``suspend_many``          ``Engine._suspend_many_fn``: as ``suspend``,
                          the same launches however wide the wave
``resume``                ``Engine._resume_fn``: cache, store and the
                          failure counter in place; uint8-preserving;
                          two K2 and one K1
``resume_many``           ``Engine._resume_many_fn``: as ``resume``,
                          the same launches however wide the wave
``migrate``               ``Cluster._run_route``, the route behind
                          ``migrate_many``: destination pool in place;
                          uint8-preserving; one K2 and one K1
``simulate_params``       the DRAM controller simulator: no state, no
                          sync, no kernel of ours
========================  ============================================

The launches are those ``chip_smoke.py`` phase 3 holds the Engine to: a
suspend writes the slow row and its fast copy (two K1), a resume reads the
slow row and the fast slot (two K2) and may insert into the fast tier (one
K1, launched with skip entries when it does not).  The reference promises
ONE dispatch a wave, so a wave's launches are a single call's.

The device bodies are called directly, as the reference audits its jitted
bodies (no scheduler runs).  The CPU geometry is deliberately tiny (2
slots, max_len 32): the contracts do not depend on the shapes.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis.dispatch import AuditTarget, EntryContract
from repro_torch.faults.spec import NULL_FAULT

AUDIT_SLOTS = 2
AUDIT_MAX_LEN = 32
AUDIT_SESSIONS = 4
AUDIT_WAVE = 2          # wave width audited for *_many / migrate

SUSPEND_LAUNCHES = {"villa_scatter": 2}
RESUME_LAUNCHES = {"villa_gather": 2, "villa_scatter": 1}
ROUTE_LAUNCHES = {"villa_gather": 1, "villa_scatter": 1}


def prefill_buckets(engine) -> List[int]:
    """The declared prefill shape set, as the Engine documents it and
    independently of its ``_bucket_len``: the powers of two from 16 below
    ``max_len``, then ``max_len`` itself; every length its own shape where
    the Engine cannot bucket (an encoder-decoder or M-RoPE config)."""
    if not engine._can_bucket:
        return list(range(1, engine.max_len + 1))
    out, b = [], 16
    while b < engine.max_len:
        out.append(b)
        b *= 2
    return out + [engine.max_len]


def attention_launches(cfg) -> Dict[str, int]:
    """K3's launches a prefill and a decode step: once an attention layer
    (an MLA layer decodes through its absorbed einsums, without K3; a mamba
    or rwkv layer runs none)."""
    kinds = cfg.layer_kinds()
    return {"prefill": sum(k in ("attn_full", "attn_local", "mla")
                           for k in kinds),
            "decode": sum(k in ("attn_full", "attn_local") for k in kinds)}


def engine_targets(engine, wave: int = AUDIT_WAVE) -> List[AuditTarget]:
    """Audit targets for one :class:`~repro_torch.serve.engine.Engine`
    whose slots all serve a request (a decode step then decodes every
    slot).  Waves take slots and store rows ``0 .. wave-1``."""
    wave = min(wave, engine.slots)
    k3 = attention_launches(engine.cfg)
    slots = list(range(wave))

    def serving():
        return {"cache": engine.cache, "store": engine.sessions,
                "sums": engine.session_sums, "fail": engine.verify_failed}

    pages = frozenset({"store", "sums"})
    resumed = frozenset({"cache", "store", "fail"})
    targets = [
        AuditTarget("decode", engine.step_begin, (),
                    EntryContract(inplace=frozenset({"cache"}),
                                  launches={"flash_attention": k3["decode"]}),
                    state=serving),
        AuditTarget("suspend", engine._suspend_fn, (0, 0),
                    EntryContract(inplace=pages, uint8_preserving=True,
                                  launches=SUSPEND_LAUNCHES),
                    state=serving),
        AuditTarget("suspend_many", engine._suspend_many_fn, (slots, slots),
                    EntryContract(inplace=pages, uint8_preserving=True,
                                  launches=SUSPEND_LAUNCHES),
                    state=serving),
        AuditTarget("resume", engine._resume_fn, (0, 0),
                    EntryContract(inplace=resumed, uint8_preserving=True,
                                  launches=RESUME_LAUNCHES),
                    state=serving),
        AuditTarget("resume_many", engine._resume_many_fn, (slots, slots),
                    EntryContract(inplace=resumed, uint8_preserving=True,
                                  launches=RESUME_LAUNCHES),
                    state=serving),
    ]
    for lb in prefill_buckets(engine):
        targets.append(AuditTarget(
            f"prefill[bucket={lb}]", engine._prefill_insert,
            (np.zeros(lb, np.int32), np.arange(lb, dtype=np.int32), lb, 0),
            EntryContract(inplace=frozenset({"cache"}),
                          launches={"flash_attention": k3["prefill"]}),
            state=serving))
    return targets


def cluster_targets(cluster, wave: int = AUDIT_WAVE) -> List[AuditTarget]:
    """The migration route of a cluster of two replicas or more, replica
    0's store rows ``0 .. wave-1`` into replica 1's."""
    if cluster.n_replicas < 2:
        return []
    src, dst = cluster.replicas[0], cluster.replicas[1]
    table = cluster._row_table(range(min(wave, cluster.n_sessions)))
    return [AuditTarget(
        "migrate", cluster._run_route,
        (src, dst, table, table, NULL_FAULT),
        EntryContract(inplace=frozenset({"dst_pool"}),
                      uint8_preserving=True, launches=ROUTE_LAUNCHES),
        state=lambda: {"dst_pool": dst.sessions.slow})]


def controller_targets(device) -> List[AuditTarget]:
    """The DRAM controller simulator: every copy mechanism's parameters
    are data, so one target covers them."""
    from repro_torch.core.dram import controller as DC
    from repro_torch.core.dram import traces as DT
    from repro_torch.core.dram.spec import DDR3_1600

    tcfg = DT.TraceConfig(n_requests=64)
    trace = DT.generate(torch.Generator().manual_seed(0), tcfg,
                        device=device)
    mcfg = DC.MechanismConfig()
    p = DC.mechanism_params(mcfg, DDR3_1600, device=device)
    return [AuditTarget(
        "simulate_params", DC.simulate_params, (trace, p),
        EntryContract(),
        kwargs=dict(n_banks=tcfg.n_banks, n_cores=tcfg.n_cores,
                    villa_cfg=mcfg.villa))]


def serving_stack(cfg, params, *, device, slots: int, max_len: int,
                  n_sessions: int, prompt_len: int = 5, seed: int = 0):
    """(engine, two-replica cluster) over ``params``, every engine slot
    serving a request of a ``prompt_len``-token random prompt (its budget
    past ``max_len``, so no decode step completes one)."""
    from repro_torch.serve.cluster import Cluster
    from repro_torch.serve.engine import Engine, Request

    engine = Engine(cfg, params, slots=slots, max_len=max_len,
                    n_sessions=n_sessions, device=device)
    rng = np.random.default_rng(seed)
    for uid in range(slots):
        engine.submit(Request(uid, rng.integers(
            0, cfg.vocab_size, prompt_len).astype(np.int32), max_len + 1))
    cluster = Cluster(cfg, params, n_replicas=2, slots=1, max_len=max_len,
                      n_sessions=n_sessions, device=device)
    return engine, cluster


def default_targets(arch: str = "tinyllama-1.1b", *, device=None,
                    params=None, reduced: bool = True,
                    slots: int = AUDIT_SLOTS, max_len: int = AUDIT_MAX_LEN,
                    n_sessions: int = AUDIT_SESSIONS,
                    wave: int = AUDIT_WAVE, seed: int = 0):
    """(targets, engine): every registered entry point of the serving
    stack plus the controller simulator, at audit geometry (the reduced
    config unless ``reduced=False``; random weights from ``seed`` unless
    ``params`` are given) on ``device`` (default: cuda)."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import lm

    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if params is None:
        params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(
            seed), device=dev)
    engine, cluster = serving_stack(cfg, params, device=dev, slots=slots,
                                    max_len=max_len, n_sessions=n_sessions,
                                    seed=seed)
    targets = (engine_targets(engine, wave) + cluster_targets(cluster, wave)
               + controller_targets(dev))
    return targets, engine
