"""Checkpoint / resume (``ampnet_tpu/train/checkpoint.py`` in torch).

A checkpoint carries the model's parameters, the optimizer's moments and
schedule, the training generator's state and the step count, so a resumed
run continues exactly. The names and the cadence are the JAX package's
(``checkpoint_ep<N>.pkl``, ``checkpoint_best.pkl``, ``checkpoint_final.pkl``);
``save_params``/``load_params`` write and read a params-only file;
the file format is the port's own: ``torch.save`` of plain tensors,
numbers and containers, read back with ``weights_only=True``, so loading a
checkpoint cannot execute code.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from ampnet_tpu_torch.train.state import TrainState


def clone_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of the model's state_dict."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def save_checkpoint(
    path: str,
    state: TrainState,
    epoch: int,
    validation_loss: Optional[float] = None,
    extra: Optional[Dict[str, Any]] = None,
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> str:
    """Serialize a TrainState + metadata; ``params`` (default: the model's
    own) is what a params-only reload or ``restore_best`` reads."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    model_sd = state.model.state_dict()
    payload = {
        "epoch": int(epoch),
        "validation_loss": -1.0 if validation_loss is None else float(validation_loss),
        "state": {"model": model_sd, "optimizer": state.optimizer.state_dict(),
                  "generator": state.generator.get_state(), "step": int(state.step)},
        "params": model_sd if params is None else params,
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _read_payload(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, state: TrainState) -> Dict[str, Any]:
    """Restore INTO a freshly created TrainState of the same structure."""
    payload = _read_payload(path)
    saved = payload["state"]
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.generator.set_state(saved["generator"])
    state.step = int(saved["step"])
    vl = payload["validation_loss"]
    return {"state": state, "epoch": int(payload["epoch"]),
            "validation_loss": None if vl == -1.0 else vl,
            "extra": payload.get("extra", {})}


def load_checkpoint_params(path: str) -> Dict[str, torch.Tensor]:
    """Only the params of a checkpoint (for eval-time reload)."""
    return _read_payload(path)["params"]


def save_params(path: str, params) -> str:
    """A params-only file: ``params`` (a module's state_dict, or the module)
    in the port's format, ``torch.save`` of plain tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: v.detach() for k, v in params.items()}, tmp)
    os.replace(tmp, path)
    return path


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Read a ``save_params`` file (``weights_only=True``) INTO ``model``:
    every parameter is copied into the model's existing tensor in place
    (``load_state_dict`` without ``assign``: ``copy_`` under no_grad; the
    names and shapes must match), so a CUDA graph captured over the model
    replays on the new values."""
    model.load_state_dict(_read_payload(path), strict=True)
    return model


def find_latest_checkpoint(run_dir: str) -> Optional[str]:
    """Latest checkpoint in a run dir by EPOCH NUMBER parsed from the
    basename (checkpoint_final outranks every epoch), mtime only as the
    tie-breaker; checkpoint_best.pkl is the model-selection artifact and
    never the resume point."""
    def order(p):
        base = os.path.basename(p)
        if base == "checkpoint_final.pkl":
            return (2, 0, os.path.getmtime(p))
        m = re.search(r"ep(\d+)", base)
        if m:
            return (1, int(m.group(1)), os.path.getmtime(p))
        return (0, 0, os.path.getmtime(p))

    cands = [p for p in glob.glob(os.path.join(run_dir, "checkpoint_*.pkl"))
             if not p.endswith("checkpoint_best.pkl")]
    return max(cands, key=order) if cands else None


def restore_best(run_dir: str) -> Tuple[float, Optional[Dict[str, torch.Tensor]]]:
    """(best_val_acc, best_params) banked by the selection loop, or
    (-1.0, None) if absent, so that a worse validation after a resume
    cannot overwrite the best from before it."""
    path = os.path.join(run_dir, "checkpoint_best.pkl")
    if not os.path.exists(path):
        return -1.0, None
    payload = _read_payload(path)
    return float(payload.get("extra", {}).get("best_val_acc", -1.0)), payload["params"]


def resume_or_create(run_dir: Optional[str], state: TrainState) -> Tuple[TrainState, int]:
    """Restore the latest checkpoint if one exists, else keep the fresh
    state. Returns (state, start_epoch)."""
    if run_dir:
        path = find_latest_checkpoint(run_dir)
        if path:
            restored = load_checkpoint(path, state)
            return restored["state"], restored["epoch"] + 1
    return state, 0
