"""device_idle.search (%): the share of the traced window in which no
operation ran on the card, averaged over the run's cards (`trace.py`)."""

from portbench.trace import idle_share as read  # noqa: F401
