"""Predictive SSL pretraining (``experiments/predictive_ssl_AMPNet.py`` in
the port): ``contrastive_ssl_AMPNet.train_model`` with the masked-feature
predictive head.

    python -m ampnet_tpu_torch.experiments.predictive_ssl_AMPNet --epochs 100
"""
from __future__ import annotations

import argparse

from ampnet_tpu_torch.experiments.contrastive_ssl_AMPNet import train_model

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    train_model(a.epochs, mode="predictive", device=a.device)
