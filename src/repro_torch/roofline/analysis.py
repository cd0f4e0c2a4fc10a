# Port of src/repro/roofline/analysis.py: the same three-term roofline at the
# H100's peaks.  The reference's TPU constants (197e12 FLOP/s, 819e9 B/s of
# HBM, 50e9 B/s a link) do not apply to the port.
"""Three-term roofline of one step on an NVIDIA H100 (SXM, 80 GB).

    compute    = FLOPs / peak FLOP/s            (per device)
    memory     = bytes / HBM bandwidth
    collective = collective link bytes / link bandwidth

FLOPs and bytes come from the port's cost model
(:mod:`repro_torch.roofline.cost`, the counterpart of the reference's
loop-aware HLO walk).  This module is the one home of the card's peaks:
``chip_smoke.py`` and the cost model read them from here.

The peak a FLOP is charged at depends on where it runs.  The port's f32
GEMMs run outside the tensor cores (TF32 stays off, as in the reference),
at :data:`PEAK_F32_FLOPS`; bf16 GEMMs on the tensor cores at
:data:`PEAK_BF16_FLOPS`; K3's f32 prefill on the tensor cores as three TF32
products (:data:`PEAK_TF32_FLOPS`).

The collective term: on one card a mesh is a ``StackedAxis`` whose hop is
one K2 launch, an HBM to HBM copy, so its bytes are read and written at
the HBM rate (``collective_bw``'s default); across cards it is NVLink's.
The reference's split of the memory term into an XLA and a Pallas-kernel
reading (``memory_s_kernel``, ``dominant_kernel``,
``roofline_fraction_kernel``) is dropped: every path of the port is one
program of hand-written kernels and library calls.  Those keys are kept,
equal to the plain ones, only so that the reference's report renderer
(``roofline/report.py``, a pinned copy) reads the port's artifacts.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig, param_count

HBM_BW = 3.35e12             # bytes/s, H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # tensor cores, dense TF32
PEAK_BF16_FLOPS = 989e12     # tensor cores, dense bf16
NVLINK_BW = 450e9            # bytes/s one way per H100 SXM (NVLink 4)
HBM_BYTES = 80e9             # the card's memory


def peak_flops(dtype_name: str) -> float:
    """The GEMM peak of a compute dtype as the port runs it: ``float32``
    outside the tensor cores, ``bfloat16`` on them."""
    return PEAK_BF16_FLOPS if dtype_name == "bfloat16" else PEAK_F32_FLOPS


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D (train) / 2*N_active*D (inference), D = tokens processed."""
    n_active = param_count(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # one decode step


def roofline_terms(cost: Dict, n_chips: int, cfg: ModelConfig,
                   shape: ShapeConfig, *, peak: float = PEAK_BF16_FLOPS,
                   collective_bw: float = HBM_BW) -> Dict:
    """The three terms (seconds, per device) of ``cost`` (one device's
    ``flops``, ``bytes`` and ``link_bytes_total``), the dominant one, and
    how much of the program's compute is the model's (``model_flops`` over
    the flops of all ``n_chips`` devices)."""
    flops = float(cost["flops"])
    byts = float(cost["bytes"])
    coll_bytes = float(cost["link_bytes_total"])

    compute_s = flops / peak
    memory_s = byts / HBM_BW
    collective_s = coll_bytes / collective_bw

    mf = model_flops(cfg, shape)
    flops_global = flops * n_chips
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bound = max(terms.values())
    frac = mf / (bound * n_chips * peak) if bound > 0 else 0.0
    dominant = max(terms, key=terms.get)
    return {
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        "flops_global": flops_global,
        "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
        "collective_link_bytes": coll_bytes,
        # useful global FLOPs over what the binding term allows at peak
        "roofline_fraction": frac,
        "peak_flops": peak,
        # the reference's kernel-adjusted keys, equal to the plain ones
        "memory_s_kernel": memory_s,
        "dominant_kernel": dominant,
        "roofline_fraction_kernel": frac,
    }
