from tip_tpu_torch.sampling.negative import (
    bitmap_tensor,
    typed_negative_sampling,
    typed_negative_sampling_chunked,
)

__all__ = ["bitmap_tensor", "typed_negative_sampling",
           "typed_negative_sampling_chunked"]
