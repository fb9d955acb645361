"""Config dataclasses for the PyTorch port.

Field-for-field copies of the attention, tokenizer, model, GraphSAINT
sampler and training configs of the JAX package (``ampnet_tpu/core/config.py``), kept here so the port
imports nothing of that package. Defaults and validation are identical,
so one config value means the same model in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class AttentionConfig:
    """Per-edge multi-head cross-attention settings."""

    embed_dim: int = 128
    num_heads: int = 4
    softmax: bool = True
    dropout_rate: float = 0.0
    bias: bool = True
    use_pallas: bool = False   # fused Hopper kernels vs plain torch path


@dataclass(frozen=True)
class TokenizerConfig:
    """Feature tokenization frontend (reference: amp_gcn.py:120-237)."""

    num_node_features: int = 1433
    feat_emb_dim: int = 127
    val_emb_dim: int = 1
    num_sampled_vectors: int = 20
    downsample: bool = True
    frontend: str = "table"          # 'table' | 'pca'
    scaler: str = "batch"            # 'batch' | 'precomputed' | 'none'
    balanced_sampling: bool = False
    sampling: str = "uniform"        # 'uniform' | 'tfidf'
    feature_repeats: int = 5

    @property
    def embed_dim(self) -> int:
        return self.feat_emb_dim + self.val_emb_dim


@dataclass(frozen=True)
class AMPGCNConfig:
    """Flagship model config (reference: src/ampnet/module/amp_gcn.py:21-35).

    ``use_pallas`` keeps the JAX package's name: here it selects the fused
    Hopper kernels instead of the plain torch path."""

    embedding_dim: int = 128
    num_heads: int = 4
    num_node_features: int = 1433
    num_sampled_vectors: int = 20
    output_dim: int = 7
    softmax_out: bool = True
    feat_emb_dim: int = 127
    val_emb_dim: int = 1
    downsample_feature_vectors: bool = True
    average_pooling: bool = True
    token_sampling: str = "uniform"   # 'uniform' | 'tfidf'
    dropout_rate: float = 0.1
    dropout_adj_rate: float = 0.1
    feature_repeats: int = 5
    attn_softmax: bool = True
    use_pallas: bool = False
    frontend: str = "table"
    scaler: str = "batch"
    compute_dtype: str = "float32"
    transformer_block: bool = False
    raw_residual: Any = False         # False | 'mlp' | 'gcn' | 'gcn2' (True = 'mlp')

    def __post_init__(self):
        if self.embedding_dim != self.feat_emb_dim + self.val_emb_dim:
            raise ValueError(
                "Feature and value dimensions do not add up to total embedding dimension"
            )

    def tokenizer(self) -> TokenizerConfig:
        return TokenizerConfig(
            num_node_features=self.num_node_features,
            feat_emb_dim=self.feat_emb_dim,
            val_emb_dim=self.val_emb_dim,
            num_sampled_vectors=self.num_sampled_vectors,
            downsample=self.downsample_feature_vectors,
            frontend=self.frontend,
            scaler=self.scaler,
            sampling=self.token_sampling,
            feature_repeats=self.feature_repeats,
        )

    def attention(self) -> AttentionConfig:
        return AttentionConfig(
            embed_dim=self.embedding_dim,
            num_heads=self.num_heads,
            softmax=self.attn_softmax,
            use_pallas=self.use_pallas,
        )


@dataclass(frozen=True)
class SaintConfig:
    """GraphSAINT random-walk sampler settings."""

    batch_size: int = 8         # number of walk roots
    walk_length: int = 150
    num_steps: int = 200        # iterations per epoch
    sample_coverage: int = 100  # normalization pre-pass coverage
    pad_nodes_to: Optional[int] = None
    pad_edges_to: Optional[int] = None


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / loop settings (reference: cora_benchmark_graphsaint.py:84-92,
    cora_benchmark_full.py:50-58)."""

    learning_rate: float = 0.1
    weight_decay: float = 1e-4
    epochs: int = 50
    seed: int = 1
    grad_clip: Optional[float] = None
    # CosineAnnealingWarmRestarts, stepped per iteration; None disables.
    cosine_t0: Optional[int] = 400
    cosine_t_mult: int = 2
    eta_min: float = 0.0
    checkpoint_every: int = 10   # epochs
    log_every: int = 1
    run_dir: Optional[str] = None
    # final-eval ensemble size over token-sampling draws
    num_eval_samples: int = 1
    # evaluate every K epochs and report final metrics from the
    # best-validation-accuracy params; 0 disables.
    select_best_every: int = 0
    # SAINT loop: log every K sampler steps; 0 = last step only.
    log_every_steps: int = 0
    # SAINT subgraph loss: 'sum' | 'mean' (node_norm-weighted).
    saint_loss: str = "sum"
    # full-batch loop: run K epochs per dispatch (one K-step CUDA graph on
    # the card) and read their metrics back once; K is clipped (gcd) to
    # divide select_best_every / checkpoint_every so those land on chunk
    # boundaries. Same math as K single steps.
    epochs_per_dispatch: int = 1
    # torch.profiler capture of this many steps after the first (the
    # capture) into <run_dir>/profile/trace.json; needs run_dir; forces
    # epochs_per_dispatch to 1.
    profile_steps: int = 0
