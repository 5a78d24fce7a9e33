from escgnn_tpu_torch.featurize.layout import EncodingLayout
from escgnn_tpu_torch.featurize.escgnn import esc_encode, EscConfig
from escgnn_tpu_torch.featurize.transform import esc_transform, featurize_many

__all__ = [
    "EncodingLayout", "esc_encode", "EscConfig", "esc_transform",
    "featurize_many",
]
