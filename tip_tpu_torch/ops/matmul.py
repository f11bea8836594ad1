"""Dense products with bf16 operands and float32 accumulation.

The JAX path contracts its dense adjacency products with bf16 inputs and
an f32 result (``preferred_element_type=float32`` on the accelerator; on
the CPU, bf16-rounded inputs in an f32 product).  ``torch.matmul`` on bf16
CUDA tensors returns a bf16 result, which is not that contract.  The port
therefore rounds each operand to bf16 and multiplies the float32 values:
every bf16 x bf16 product is exact in float32, and the sum accumulates in
float32 on either device.  This needs TF32 off on the card
(:func:`set_matmul_precision`), or the rounded operands would lose bits
again.  int8 operands (the 0/1 and count matrices) upcast exactly.

Where these helpers feed a matmul an int8 operand, its upcast copy is
materialised (torch has no int8 x bf16 product): the sharded dense P-P
rows (parallel/ring.py) and the ``backend="xla"`` routes.  The M-first
R-GCN over the int8 strips takes kernel B15 (ops/rgcn_contract.py) and
the dense P-P GCN kernel B12 (ops/pp_aggregate.py), which read their int8
operands where they lie.
"""

from __future__ import annotations

import torch


def set_matmul_precision() -> None:
    """Full float32 matmuls and convolutions, no TF32, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, as float32 (exact for int8 inputs)."""
    if x.dtype in (torch.int8, torch.uint8):
        return x.float()
    return x.to(torch.bfloat16).float()


def is_bf16(compute_dtype) -> bool:
    """Whether a kernel ``compute_dtype`` ('float32' | 'bfloat16', or the
    torch dtype) asks for bf16 inputs."""
    if compute_dtype in (torch.bfloat16, "bfloat16"):
        return True
    if compute_dtype in (torch.float32, "float32"):
        return False
    raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")


def compute_round(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x as float32, rounded to bf16 first where ``compute_dtype`` says so:
    the inputs the chunked kernels take (they accumulate in float32)."""
    return bf16_round(x) if is_bf16(compute_dtype) else x.float()


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over bf16-rounded operands, float32 accumulate and result."""
    return bf16_round(a) @ bf16_round(b)
