# The reference's src/repro/optim has no __init__; the port's packages all
# have one, so setuptools finds them.
"""Optimisers of the port: ``adamw``."""
