from synthesis_in_style_tpu_torch.training_builder.base import BaseTrainBuilder
from synthesis_in_style_tpu_torch.training_builder.doc_ufcn_builder import DocUFCNTrainBuilder
from synthesis_in_style_tpu_torch.training_builder.ema_net_builder import EMANetTrainBuilder
from synthesis_in_style_tpu_torch.training_builder.pixel_ensemble_builder import (
    PixelEnsembleTrainBuilder,
)
from synthesis_in_style_tpu_torch.training_builder.trans_u_net_builder import TransUNetTrainBuilder


def get_train_builder_class(config):
    """The builder of `config["network"]`: DocUFCN, TransUNet, EMANet or
    PixelEnsemble."""
    network = config["network"]
    if network in ("DocUFCN", "base"):  # "base": legacy configs
        return DocUFCNTrainBuilder
    if network == "TransUNet":
        return TransUNetTrainBuilder
    if network == "EMANet":
        return EMANetTrainBuilder
    if network == "PixelEnsemble":
        return PixelEnsembleTrainBuilder
    raise NotImplementedError(f"unknown network {network!r}")


__all__ = ["BaseTrainBuilder", "DocUFCNTrainBuilder", "EMANetTrainBuilder",
           "PixelEnsembleTrainBuilder", "TransUNetTrainBuilder", "get_train_builder_class"]
