# The port's counterparts of the reference's examples/ (which belongs to the
# reference), run as ``python -m repro_torch.examples.<name>``.
"""Runnable examples of the port: the DRAM evaluation, a quickstart and an
end-to-end training run."""
