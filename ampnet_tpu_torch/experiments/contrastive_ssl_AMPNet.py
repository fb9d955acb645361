"""Contrastive SSL pretraining (``experiments/contrastive_ssl_AMPNet.py`` in
the port): the GraphSAGE skip-gram objective of ``train/ssl.py`` on the
duplicated-feature XOR graphs (400 training nodes, 10 features), AMPGCN at
D=32, H=2, S=8 without dropout, Adam 1e-3 with clip 1.0, one step an epoch.

    python -m ampnet_tpu_torch.experiments.contrastive_ssl_AMPNet --epochs 100
"""
from __future__ import annotations

import argparse

from ampnet_tpu_torch.core.config import AMPGCNConfig
from ampnet_tpu_torch.data.synthetic import get_duplicated_xor_graphs
from ampnet_tpu_torch.models import AMPGCN
from ampnet_tpu_torch.train import TrainState, create_train_state, make_optimizer
from ampnet_tpu_torch.train.ssl import SSLPretrainer, make_ssl_train_step

MODE = "contrastive"


def train_model(epochs: int = 100, mode: str = MODE, num_features: int = 10,
                device="cuda") -> TrainState:
    """Pretrain ``epochs`` steps on the XOR training graph; the loss is
    printed every 10. Returns the state (its model the SSLPretrainer)."""
    train_g, _ = get_duplicated_xor_graphs(400, 64, 0.3, 10, 5, seed=0)
    backbone = AMPGCN(AMPGCNConfig(
        embedding_dim=32, num_heads=2, num_node_features=num_features,
        num_sampled_vectors=8, output_dim=2, feat_emb_dim=31, val_emb_dim=1,
        dropout_rate=0.0, dropout_adj_rate=0.0,
    ), device=device)
    model = SSLPretrainer(backbone, mode=mode, num_features=num_features)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3, grad_clip=1.0),
                               seed=1)
    step = make_ssl_train_step(model)
    train_g = train_g.to(device)
    for epoch in range(epochs):
        state, metrics = step(state, train_g)
        if epoch % 10 == 0:
            print(f"epoch {epoch:4d} | ssl loss {float(metrics['loss']):.4f}")
    return state


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--mode", default=MODE, choices=["contrastive", "predictive"])
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    train_model(a.epochs, a.mode, device=a.device)
