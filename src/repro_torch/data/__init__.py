# The reference's src/repro/data has no __init__; the port's packages all
# have one, so setuptools finds them.
"""Data of the port: ``pipeline`` (the deterministic synthetic stream)."""
