"""``prefill_mfu_pct`` where the cell reports ``output_tokens_per_s``
(an open loop offered more than it sustains)."""

from perfbench.metrics.prefill_mfu_pct import read  # noqa: F401
