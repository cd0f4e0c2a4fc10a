#!/usr/bin/env python3
"""K3's f32 prefill in each of its layouts, at the serving paths' buckets.

    python3 prefill_forms.py

Needs one CUDA card.  For each shape of :data:`SHAPES` (f32 q, K and V,
the Engine's padded buckets), times the device ms of the mma route's full
form (``prefill_plan`` without the card's SM count), the form the wrapper
picks (``auto``), the short form at each of 16, 32 and 64 rows a CTA
(``prefill_plan``'s ``short_rows``), and SDPA beside them (boolean mask,
``enable_gqa``), each by ``chip_smoke.timed(device=True)`` after an L2
flush; the forms are forced by replacing ``flash_attention.launch_plan``
in this process.  First it
holds the picked form of each shape to its plain version
(``ref.attention_bar``, two calls bit-equal), and prints the short form's
occupancy (CTAs an SM at 64, 32 and 16 rows) as the card gives it.
Prints the card's name and power limit, a line a shape, and last one
JSON object.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# name: (B, S, T, H, K, Dk, Dv, valid tokens): gemma-7b's, MLA's,
# tinyllama's, olmoe's and gemma3's f32 buckets, the short ones and those
# between half a wave and one, or past 512 keys; MLA's bucket 64 also at
# B 2, 4 and 8, where its half-empty full-form rows take more than a wave
SHAPES = {
    "gemma7b_64": (1, 64, 64, 16, 16, 256, 256, 40),
    "gemma7b_128": (1, 128, 128, 16, 16, 256, 256, 100),
    "gemma7b_256": (1, 256, 256, 16, 16, 256, 256, 200),
    "gemma7b_512": (1, 512, 512, 16, 16, 256, 256, 333),
    "mla_64": (1, 64, 64, 128, 128, 192, 128, 40),
    **{f"mla_64_b{B}": (B, 64, 64, 128, 128, 192, 128, 40) for B in (2, 4, 8)},
    **{f"tinyllama_{S}": (1, S, S, 32, 4, 64, 64, S)
       for S in (16, 32, 64, 128, 256, 512)},
    "olmoe_64": (1, 64, 64, 16, 16, 128, 128, 40),
    "olmoe_512": (1, 512, 512, 16, 16, 128, 128, 380),
    "olmoe_1024": (1, 1024, 1024, 16, 16, 128, 128, 700),
    "gemma3_128": (1, 128, 128, 32, 16, 128, 128, 96),
    "gemma3_512": (1, 512, 512, 32, 16, 128, 128, 400),
}
FORMS = ("full", "auto", 16, 32, 64)


def case(dev, gen, B, S, T, H, K, dk, dv, n):
    """Random q/k/v; the first ``n`` slots of the last batch row hold
    tokens (of the others 7 fewer a row), the rest pads at 2**30; the
    queries are the last S slots."""
    import torch
    q = torch.randn((B, S, H, dk), device=dev, generator=gen)
    k = torch.randn((B, T, K, dk), device=dev, generator=gen)
    v = torch.randn((B, T, K, dv), device=dev, generator=gen)
    pos = torch.full((B, T), 2**30, dtype=torch.int32)
    for b in range(B):
        m = n if b == B - 1 else max(1, n - 7 * (B - 1 - b))
        pos[b, :m] = torch.arange(m)
    return q, k, v, pos[:, T - S:].contiguous().to(dev), pos.to(dev)


def forced(FA, form):
    """``launch_plan`` laid out in ``form``: "full", "auto" (the wrapper's
    own), or a short form at that many rows a CTA."""
    real = FA.launch_plan

    def plan(q, k, v, *, lse=False):
        if form == "auto":
            return real(q, k, v, lse=lse)
        B, S, H, D = q.shape
        return FA.prefill_plan(B, S, H, k.shape[2], D, True, v.shape[-1],
                               T=k.shape[1],
                               short_rows=None if form == "full" else form)
    return plan


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("prefill_forms.py needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    tag = cs.card()
    print(f"card: {tag}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.fill_(1)         # noqa: E731  (evict L2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    launch_plan = FA.launch_plan
    out = {"card": tag, "per_sm": {}, "shapes": {}}
    for dk, dv in FA.SHORT_DIMS:
        per = FA._short_per_sm(0, dk, dv, 1)
        out["per_sm"][f"{dk}/{dv}"] = per
        print(f"short form, CTAs an SM at {FA.SHORT_ROWS} rows: Dk {dk} / "
              f"Dv {dv}: {per}")
    ok = True
    for name, spec in SHAPES.items():
        q, k, v, qp, kp = case(dev, gen, *spec)
        plan = launch_plan(q, k, v)
        got = ops.chunked_attention(q, k, v, qp, kp)
        again = ops.chunked_attention(q, k, v, qp, kp)
        want = ref.chunked_attention_ref(q, k, v, qp, kp)
        bar = ref.attention_bar(got, want, q, k, v, qp, kp)
        held = bool(((got.float() - want.float()).abs() < bar).all()) and \
            torch.equal(got, again)
        ok &= held
        row = out["shapes"][name] = {"form": plan.form, "rows": plan.rows,
                                     "grid": plan.grid, "held": held}
        G = spec[3] // spec[4]
        for form in FORMS:
            if form != "full" and form != "auto" and form < G:
                continue
            FA.launch_plan = forced(FA, form)
            try:
                row[str(form)] = cs.timed(
                    lambda: ops.chunked_attention(q, k, v, qp, kp), 20,
                    flush, device=True)
            finally:
                FA.launch_plan = launch_plan
        mask = kp[:, None, None, :] <= qp[:, None, :, None]
        lq, lk, lv = (x.float().transpose(1, 2) for x in (q, k, v))
        row["sdpa"] = cs.timed(
            lambda: sdpa(lq, lk, lv, attn_mask=mask, enable_gqa=True), 20,
            flush, device=True)
        print(f"{name}: picks {plan.form} ({plan.rows} rows, grid "
              f"{plan.grid}), held {held}; device ms "
              + ", ".join(f"{f} {row[str(f)]:.4f}" for f in FORMS
                          if str(f) in row)
              + f", SDPA {row['sdpa']:.4f} [{tag}]", flush=True)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
