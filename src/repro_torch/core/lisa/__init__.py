# Port of src/repro/core/lisa/__init__.py.  Submodules are imported where
# they are used: ``villa_cache`` registers the tier movement backends.
"""LISA substrate on the device (DESIGN.md Sec. 2).

  rbm             — hop primitives over a mesh axis: lisa_copy,
                    lisa_broadcast, ring collectives with per-hop compute
                    overlap (axes: ``repro_torch.launch.mesh``)
  ring_attention  — context parallelism as a hop chain over ``rbm.ring_scan``
  villa_cache     — tiered hot/cold store driven by the paper's exact policy
  topology        — linear-in-hops cost model (copied)
  compression     — int8 error-feedback gradient compression for the DP axis
"""
