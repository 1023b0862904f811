from synthesis_in_style_tpu_torch.training_builder.base import BaseTrainBuilder
from synthesis_in_style_tpu_torch.training_builder.doc_ufcn_builder import DocUFCNTrainBuilder
from synthesis_in_style_tpu_torch.training_builder.trans_u_net_builder import TransUNetTrainBuilder


def get_train_builder_class(config):
    """The builder of `config["network"]`; DocUFCN and TransUNet are ported."""
    network = config["network"]
    if network in ("DocUFCN", "base"):  # "base": legacy configs
        return DocUFCNTrainBuilder
    if network == "TransUNet":
        return TransUNetTrainBuilder
    raise NotImplementedError(
        f"network {network!r} is not ported to synthesis_in_style_tpu_torch yet "
        "(see ROADMAP.md)"
    )


__all__ = ["BaseTrainBuilder", "DocUFCNTrainBuilder", "TransUNetTrainBuilder",
           "get_train_builder_class"]
