# Port of src/repro/core/lisa/__init__.py.  Submodules are imported where
# they are used: ``villa_cache`` registers the tier movement backends.
"""LISA substrate on the device: ``topology`` (hop-distance cost model,
copied) and ``villa_cache`` (the tiered store driven by the VILLA policy)."""
