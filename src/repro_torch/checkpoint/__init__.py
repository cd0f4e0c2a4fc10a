# Port of src/repro/checkpoint (a namespace package there): the checkpoint
# manager, in checkpoint/manager.py.
