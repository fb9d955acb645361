"""Device ms a training step in operations that are neither edge attention
(`kernels/edge_attention.txt`) nor GEMMs (`kernels/gemm.txt`): AMPConv's
torch glue, the tokenizer, the GCN head's gathers and the optimizer."""
from portbench.lib.readers import torch_glue_ms as read  # noqa: F401
