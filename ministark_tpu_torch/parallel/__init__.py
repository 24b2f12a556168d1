"""Multi-process proving on ``torch.distributed`` (mirrors
``ministark_tpu.parallel``): one process a rank, one device a process."""
