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
  by truth-table quadrant pair;
* ``eval_checkpoint``: a run's (or a file's) checkpoint evaluated on the
  full graph with the ensemble protocol (``--fused``: the fused kernels);
* ``seed_robustness``, ``seed_ensemble``: the recipe over seeds (mean and
  spread; the ensemble of the seeds' mean log-probs);
* ``raw_residual_tuning``, ``token_scale_tuning``, ``transformer_tuning``:
  recipe sweeps over ``train_full_batch``;
* ``synthetic_training_modular`` (``ARGS``, ``train_model``),
  ``synthetic_training_modular_graphsaint``, ``grid_search`` (``--workers
  N``: a spawn pool on the card), ``synthetic_training`` (the early MSE
  trainer), ``synthetic_rgb_generate``: the synthetic XOR / RPG family;
* ``ampnet_freeze_check``, ``cora_overfit_one_subgraph``,
  ``cora_linear_layer_baseline``, ``cosine_lr_scheduler_test``: sanity
  harnesses and baselines;
* ``partitioned_graph1_timing``, ``scaling_bench``,
  ``halo_comm_accounting``, ``halo_budget_run``: the partitioned step's
  timing and halo accounting over ``parallel/*`` (ranks started by
  ``parallel.launch.spawn``; on one card they share it).

Only ``experiments/reference_baseline.py`` of the JAX package's drivers has
no counterpart: it runs the original PyTorch reference, which is not in the
repository.

Each ``main`` runs on the card unless given ``device="cpu"`` (``--device
cpu``); where the JAX driver trains and then plots, a function of its own
(``train`` or ``run``) trains and returns the numbers, and ``main`` calls
it and plots. A driver writes its CSV or JSON whether or not matplotlib is
installed (``common.can_draw``); the card machine has none.
"""
