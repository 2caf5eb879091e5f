"""Test-support toolkit: the port's fault injectors for the resilience
contract (counterpart of luminaai_tpu/testing/; driven by the port's
`faults` tests)."""

from luminaai_tpu_torch.testing.faults import (  # noqa: F401
    corrupt_checkpoint,
    fail_step_at,
    preempt_at_step,
    sigterm_at_step,
    slow_decode,
    truncated_checkpoint_writes,
)
