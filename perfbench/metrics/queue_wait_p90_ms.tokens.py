"""``queue_wait_p90_ms`` where the cell reports ``output_tokens_per_s``
(an open loop offered more than it sustains, where the queue grows all
through the window and the tails follow it)."""

from perfbench.metrics.queue_wait_p90_ms import read  # noqa: F401
