"""The non-TIP model families of the reference (port of tip_tpu/models/):

  * :mod:`tip_tpu_torch.models.dd` -- D-D-only R-GCN with the DistMult
    (DR-DF) or NN (DR-NN) decoder;
  * :mod:`tip_tpu_torch.models.pd` -- P-D-only hierarchy encoder + NN
    decoder (PR-HMP-NN);
  * :mod:`tip_tpu_torch.models.pp` -- P-P GAE, GCN encoder + inner-product
    decoder;
  * :mod:`tip_tpu_torch.models.decagon` -- Decagon: multi-type graph
    convolution over the tri-graph + DEDICOM decoder;
  * :mod:`tip_tpu_torch.models.compgcn` -- CompGCN: composition-based
    multi-relational GCN over the tri-graph as one KG + DistMult;
  * :mod:`tip_tpu_torch.models.runner` -- ``build_variant`` /
    ``train_variant``, driven by ``python -m tip_tpu_torch.models``.

TIP itself lives in tip_tpu_torch.train.model.
"""

from tip_tpu_torch.models.compgcn import CompGCNConfig, CompGCNModel
from tip_tpu_torch.models.dd import DDConfig, DDModel
from tip_tpu_torch.models.decagon import DecagonConfig, DecagonModel
from tip_tpu_torch.models.pd import PDConfig, PDModel
from tip_tpu_torch.models.pp import PPConfig, PPModel

__all__ = ["CompGCNConfig", "CompGCNModel", "DDConfig", "DDModel",
           "DecagonConfig", "DecagonModel", "PDConfig", "PDModel", "PPConfig",
           "PPModel"]
