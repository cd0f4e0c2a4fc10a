# Port of src/repro/core/dram/__init__.py.  Only ``spec`` (copied) and
# ``villa`` (torch) are ported so far; the substrate, controller, bank and
# traces modules belong to a later slice.
"""The DRAM device model: ``spec`` (DramSpec, presets, CopyMechanism
registry) and ``villa`` (the VILLA hot-row caching policy)."""
