from synthesis_in_style_tpu_torch.training_builder.base import BaseTrainBuilder
from synthesis_in_style_tpu_torch.training_builder.doc_ufcn_builder import DocUFCNTrainBuilder
from synthesis_in_style_tpu_torch.training_builder.ema_net_builder import EMANetTrainBuilder
from synthesis_in_style_tpu_torch.training_builder.trans_u_net_builder import TransUNetTrainBuilder


def get_train_builder_class(config):
    """The builder of `config["network"]`; DocUFCN, TransUNet and EMANet are
    ported."""
    network = config["network"]
    if network in ("DocUFCN", "base"):  # "base": legacy configs
        return DocUFCNTrainBuilder
    if network == "TransUNet":
        return TransUNetTrainBuilder
    if network == "EMANet":
        return EMANetTrainBuilder
    raise NotImplementedError(
        f"network {network!r} is not ported to synthesis_in_style_tpu_torch yet "
        "(see ROADMAP.md)"
    )


__all__ = ["BaseTrainBuilder", "DocUFCNTrainBuilder", "EMANetTrainBuilder",
           "TransUNetTrainBuilder", "get_train_builder_class"]
