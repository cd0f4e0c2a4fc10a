# The reference's src/repro/train has no __init__; the port's packages all
# have one, so setuptools finds them.
"""Training of the port: ``step`` (the single-device train step)."""
