"""The share of the eval cells' traced window in which no operation runs on
the card: 1 minus the union of the device operations' intervals."""
from portbench.lib.readers import device_idle as read  # noqa: F401
