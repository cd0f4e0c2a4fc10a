# Port of src/repro/core/__init__.py (only the modules the serving path needs).
"""Core: the DRAM device model (``core.dram``) and the LISA substrate adapted
to the device (``core.lisa``)."""
