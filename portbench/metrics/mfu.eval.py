"""The whole window's share of the card's peak in the eval cells: model FLOP
of every step and evaluation draw (`lib/work.py`) over the window's host
seconds and the peak of the configuration's type (`lib/peaks.json`)."""
from portbench.lib.readers import mfu as read  # noqa: F401
