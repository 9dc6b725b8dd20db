"""Data parallelism over ``torch.distributed``; counterpart of ``bts_tpu/parallel``."""
