"""Hand-written Hopper kernels (csrc/*.cu), their plain PyTorch versions
(ref.py) and the dispatch between them (ops.py).  Port of src/repro/kernels/."""
