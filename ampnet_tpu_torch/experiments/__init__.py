"""The port's experiment drivers (``experiments/`` of the JAX package), each
run as ``python -m ampnet_tpu_torch.experiments.<name>``:

* ``cora_benchmark_full``: full-batch Cora training (``--raw-residual``:
  the recommended recipe);
* ``cora_benchmark_graphsaint``: GraphSAINT subgraph training;
* ``cora_benchmark_graphsaint_distributed``: the same over the ranks of a
  process group (data parallel, each rank its own sampler);
* ``ssl_transfer``: SSL pretraining, then fine-tuning and a linear probe;
* ``contrastive_ssl_AMPNet``, ``predictive_ssl_AMPNet``: SSL pretraining
  on the duplicated-feature XOR graphs;
* ``visualize_cora_attn_coeffs``: attention heatmaps per class pair from a
  checkpoint;
* ``visualize_attention_coefficients``: the XOR model's attention entries
  by truth-table quadrant pair.

Each ``main`` runs on the card unless given ``device="cpu"``; where the
JAX driver trains and then plots, a function of its own (``train``)
trains and returns the result, and ``main`` calls it and plots.
"""
