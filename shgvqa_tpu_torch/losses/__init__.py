from shgvqa_tpu_torch.losses.set_prediction import (  # noqa: F401
    empty_weight,
    hungarian_set_loss,
    matched_top1_accuracy,
    weighted_cross_entropy,
)
from shgvqa_tpu_torch.losses.vqa import bce_vqa_loss, mce_vqa_loss  # noqa: F401
