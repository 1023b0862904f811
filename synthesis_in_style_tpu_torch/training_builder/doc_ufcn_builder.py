"""DocUFCN train builder (counterpart of
synthesis_in_style_tpu/training_builder/doc_ufcn_builder.py): global-norm
clip, coupled L2 weight decay and Adam with betas, weight decay and the
learning-rate schedule from the config."""

from __future__ import annotations

from synthesis_in_style_tpu_torch.models.doc_ufcn import get_doc_ufcn
from synthesis_in_style_tpu_torch.training_builder.base import BaseTrainBuilder
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import GANOptimizer


class DocUFCNTrainBuilder(BaseTrainBuilder):
    def _build_network(self):
        network_class = get_doc_ufcn(self.config.get("network_version", "base"))
        return network_class(
            num_classes=self.config.get("num_classes", 3),
            input_channels=self.config.get("input_dim", 3),
            remat=bool(self.config.get("remat", False)),
            s2d_stem=int(self.config.get("s2d_stem", 0)),
            s2d_tail=bool(self.config.get("s2d_tail", False)),
        )

    def _build_optimizer(self) -> GANOptimizer:
        config = self.config
        return GANOptimizer(self.network.parameters(), self.lr_schedule(),
                            (float(config.get("beta1", 0.9)), float(config.get("beta2", 0.999))),
                            weight_decay=float(config.get("weight_decay", 0.0)))
