"""The edge-attention op's share of its roofline in the eval cells: the least
time of its work (counted from shapes, `lib/work.py`) over the device time
of the kernels in `kernels/edge_attention.txt`."""
from portbench.lib.readers import edge_attn_roofline as read  # noqa: F401
