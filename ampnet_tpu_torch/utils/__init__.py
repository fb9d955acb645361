from ampnet_tpu_torch.utils.preprocess import embed_features_old

__all__ = ["embed_features_old"]
