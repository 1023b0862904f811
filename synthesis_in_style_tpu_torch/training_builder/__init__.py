from synthesis_in_style_tpu_torch.training_builder.base import BaseTrainBuilder
from synthesis_in_style_tpu_torch.training_builder.doc_ufcn_builder import DocUFCNTrainBuilder


def get_train_builder_class(config):
    """The builder of `config["network"]`; only DocUFCN is ported."""
    network = config["network"]
    if network in ("DocUFCN", "base"):  # "base": legacy configs
        return DocUFCNTrainBuilder
    raise NotImplementedError(
        f"network {network!r} is not ported to synthesis_in_style_tpu_torch yet "
        "(see ROADMAP.md)"
    )


__all__ = ["BaseTrainBuilder", "DocUFCNTrainBuilder", "get_train_builder_class"]
