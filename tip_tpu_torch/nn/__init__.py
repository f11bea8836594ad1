from tip_tpu_torch.nn.decoders import distmult_apply, distmult_init
from tip_tpu_torch.nn.encoders import fm_encoder_apply, fm_encoder_init

__all__ = [
    "distmult_apply",
    "distmult_init",
    "fm_encoder_apply",
    "fm_encoder_init",
]
