"""device_idle.batch (%): the share of the traced window in which no
operation ran on the card (`trace.py`)."""

from portbench.trace import idle_share as read  # noqa: F401
