from ampnet_tpu_torch.train.state import make_eval_step

__all__ = ["make_eval_step"]
