# Port of src/repro/roofline/ (a namespace package there, with no exports):
# the roofline of the port on an NVIDIA H100.
"""The roofline layer of the port.

* :mod:`repro_torch.roofline.analysis` — the H100's peaks (the one home of
  them), ``model_flops`` and the three-term ``roofline_terms``;
* :mod:`repro_torch.roofline.cost` — one call's flops (``FlopCounterMode``
  over the plain path), useful flops, bytes and collective bytes: the
  counterpart of the reference's ``roofline/hlo.py``;
* :mod:`repro_torch.roofline.attribution` — device time by kernel from a
  ``torch.profiler`` trace;
* :mod:`repro_torch.roofline.report` — the reference's renderer of dry-run
  artifacts (a pinned copy).
"""
