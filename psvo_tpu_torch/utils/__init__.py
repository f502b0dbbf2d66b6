"""Run utilities (counterpart of `psvo_tpu/utils`)."""
