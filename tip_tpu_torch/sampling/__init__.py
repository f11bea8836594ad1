from tip_tpu_torch.sampling.negative import bitmap_tensor, typed_negative_sampling

__all__ = ["bitmap_tensor", "typed_negative_sampling"]
